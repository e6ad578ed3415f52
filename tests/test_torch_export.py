"""The port's `torch.export` serving artifacts (facesr_torch.ckpt.export,
facesr_torch.cli.export_serving, ``test_model --exported``) and the group
kernel's custom op, on the CPU. On the CPU the op runs the kernel's plain
version, so an artifact equals the eager forward bitwise."""

import numpy as np
import pytest
import torch

from facesr_torch.ckpt import export as ex
from facesr_torch.cli import export_serving as export_cli
from facesr_torch.cli import test_model as port_test
from facesr_torch.data import png
from facesr_torch.models import blocks
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.ops import rcab_group as rg
from facesr_torch.parallel.serving import Predictor

torch.set_num_threads(1)

SIZE = 64  # the artifacts' LR input size: the served one


def _model(c):
    """2 groups x 2 RCABs; C=64 takes the group kernel's trunk in bf16,
    C=16 the plain one. conv_last non-zero so the trunk shows."""
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=c, num_groups=2,
                                                blocks_per_group=2), seed=3, device="cpu")
    with torch.no_grad():
        g = torch.Generator().manual_seed(4)
        model.conv_last.weight.copy_(torch.randn(model.conv_last.weight.shape, generator=g) * 0.05)
    return model.eval()


# f32 (the plain trunk), bf16 off the kernel (C=16: the plain trunk in
# bf16) and bf16 on it (C=64: the custom op)
CASES = [(16, "f32"), (16, "bf16"), (64, "bf16")]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A saved .pt2 of every case, with its model."""
    root = tmp_path_factory.mktemp("pt2")
    out = {}
    for c, name in CASES:
        model = _model(c)
        dtype = torch.bfloat16 if name == "bf16" else None
        path = root / f"c{c}_{name}.pt2"
        path.write_bytes(ex.export_serving(model, dtype, input_size=SIZE))
        out[(c, name)] = (path, model, dtype)
    return out


@pytest.mark.parametrize("c,name", CASES)
def test_artifact_equals_the_eager_forward(artifacts, c, name):
    path, model, dtype = artifacts[(c, name)]
    fn = ex.load_exported(str(path), device="cpu")
    pred = Predictor(model, dtype=dtype, max_batch=8, device="cpu")
    for batch in (1, 3):  # one symbolic-batch artifact serves both
        x = np.random.default_rng(batch).random((batch, SIZE, SIZE, 3), dtype=np.float32)
        got = fn(x)
        assert got.shape == (batch, 4 * SIZE, 4 * SIZE, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, pred(x))
    ops = [n for n in fn.exported.graph.nodes if n.target is torch.ops.facesr_torch.rcab_group.default]
    # the bf16 trunk of a C=64 config is the custom op, one node a group
    assert len(ops) == (2 if (c, name) == (64, "bf16") else 0)
    b, h, w, _ = ex.input_shape(fn.exported)
    assert isinstance(b, torch.SymInt) and (h, w) == (SIZE, SIZE)


def test_load_time_checks(artifacts, tmp_path):
    path = artifacts[(16, "f32")][0]
    with pytest.raises(ValueError, match="expects 64x64 inputs.*--input-size 32"):
        ex.load_exported_many(str(path), spatial=32, device="cpu")
    assert list(ex.load_exported_many(str(path), spatial=SIZE, device="cpu")) == ["c16_f32"]
    pinned = tmp_path / "pinned.pt2"
    pinned.write_bytes(ex.export_serving(artifacts[(16, "f32")][1], None, batch=2,
                                         input_size=SIZE))
    with pytest.raises(ValueError, match="pinned to 2"):
        ex.load_exported_many(str(pinned), device="cpu")
    (tmp_path / "sub").mkdir()
    dup = tmp_path / "sub" / "c16_f32.pt2"
    dup.write_bytes(path.read_bytes())
    with pytest.raises(ValueError, match="duplicate artifact name"):
        ex.load_exported_many(f"{path},{dup}", device="cpu")
    # the int8 .pt2 is ported (this asserted its refusal before): an int8
    # artifact keeps a symbolic batch and serves the live forward
    model = artifacts[(16, "f32")][1]
    fn = ex.load_exported(ex.export_serving(model, "int8", input_size=SIZE), device="cpu")
    assert isinstance(ex.input_shape(fn.exported)[0], torch.SymInt)
    x = np.random.default_rng(4).random((2, SIZE, SIZE, 3), dtype=np.float32)
    np.testing.assert_array_equal(fn(x), Predictor(model, dtype="int8", device="cpu")(x))


def test_custom_op_passes_opcheck():
    gen = torch.Generator().manual_seed(0)
    group = blocks.make_residual_groups(1, 2, 64, 3, 4, gen)[0]
    gw = rg.prepare_group_weights(group)
    x = torch.rand((2, 6, 10, 64), generator=gen).to(torch.bfloat16)
    args = (x, *rg.group_weight_args(gw), 0.2)
    result = torch.library.opcheck(torch.ops.facesr_torch.rcab_group.default, args)
    assert all(v == "SUCCESS" for v in result.values()), result
    assert torch.equal(torch.ops.facesr_torch.rcab_group(*args),
                       rg.rcab_group_reference(x, gw, 0.2))


def test_export_cli_and_test_model_exported(tmp_path, capsys):
    """The export CLI with --verify, then test_model on the artifact gives
    the rows test_model gives on the checkpoint (f32: the same forward)."""
    model = _model(16)
    torch.save({"model_state_dict": model.state_dict(),
                "config": {"num_channels": 16, "num_groups": 2, "blocks_per_group": 2}},
                tmp_path / "m.pth")
    art = tmp_path / "serve" / "m.pt2"
    assert export_cli.main(["--checkpoint", str(tmp_path / "m.pth"), "--output", str(art),
                            "--dtype", "f32", "--input-size", "8", "--verify",
                            "--device", "cpu"]) == 0
    assert "verify: max |exported - live| = 0.00e+00" in capsys.readouterr().out
    (tmp_path / "hr").mkdir()
    rng = np.random.default_rng(7)
    for i in range(3):
        png.write_png(tmp_path / "hr" / f"f{i}.png",
                      (rng.random((32, 32, 3)) * 255).astype(np.uint8))
    common = ["--input", str(tmp_path / "hr"), "--device", "cpu", "--no-save"]
    got = port_test.run(["--exported", str(art)] + common)
    want = port_test.run(["--checkpoint", str(tmp_path / "m.pth")] + common)
    assert [r["model"] for r in got] == [r["model"] for r in want]
    # the int8 .pt2 is ported (this asserted its refusal before)
    assert export_cli.main(["--checkpoint", str(tmp_path / "m.pth"), "--output", str(art),
                            "--dtype", "int8", "--input-size", "8", "--verify",
                            "--device", "cpu"]) == 0
    assert "verify: max |exported - live| = 0.00e+00" in capsys.readouterr().out
