"""The port's headless demo (facesr_torch.app.demo) and what it stands on,
against the JAX package and cv2: `resize_area` against cv2's
``INTER_AREA`` (exact), `prepare_inputs` against app/demo.py's,
`load_any_model` on a JAX ``.fckpt`` and on a ``.pth`` from
`facesr/ckpt/export_torch.py`, and `process_image` / ``main --image``."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facesr.ckpt import checkpoint as jckpt
from facesr.ckpt.export_torch import export_pth
from facesr.models import face_enhance_net as fen
from facesr_torch.app import demo as port_demo
from facesr_torch.data import png
from facesr_torch.data.cv_compat import resize_area
from facesr_torch.models.load import load_any_model

torch.set_num_threads(1)

SMALL = fen.FaceEnhanceNetConfig(num_channels=16, num_groups=2, blocks_per_group=2)
# the packages' f32 forwards agree to float rounding (test_torch_face_enhance_net)
FORWARD_ATOL = 1e-5
# prepare_inputs: HR through resize_area (exact); LR through each
# package's f32 bicubic matmuls, which sum in other orders
LR_ATOL = 1e-6
PREPARE_SHAPES = [(64, 64), (100, 90), (128, 128), (200, 200), (256, 256), (300, 400),
                  (513, 257)]
# (source h, w) -> (dst w, h) as cv2 takes it: x1/2, x1/4, fractional
# downscales, upscales, non-square and mixed (one axis up, one down)
AREA_CASES = [((128, 128), (64, 64)), ((256, 256), (64, 64)), ((300, 300), (256, 256)),
              ((100, 100), (64, 64)), ((200, 200), (256, 256)), ((50, 50), (64, 64)),
              ((90, 100), (64, 64)), ((400, 300), (256, 256)), ((257, 513), (256, 256)),
              ((130, 70), (64, 40)), ((66, 130), (33, 65)), ((100, 300), (256, 256)),
              ((192, 192), (64, 64)), ((13, 17), (64, 64))]


def _image(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed + 1000 * h + w)
    lo = (rng.random((5, 5, c)) * 255).astype(np.uint8)
    base = np.kron(lo, np.ones((h // 5 + 1, w // 5 + 1, 1), np.uint8))[:h, :w]
    return np.clip(base.astype(int) + rng.integers(-25, 26, (h, w, c)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_area_matches_cv2_exactly(dtype, channels):
    mismatches = total = 0
    for (h, w), size in AREA_CASES:
        img = _image(h, w, channels)
        if channels == 1:
            img = img[:, :, 0]
        if dtype == np.float32:
            img = img.astype(np.float32) / 255
        want = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
        got = resize_area(img, size)
        assert got.shape == want.shape and got.dtype == want.dtype, ((h, w), size)
        mismatches += int((got != want).sum())
        total += want.size
    print(f"resize_area {np.dtype(dtype).name} C={channels}: {mismatches} of {total} values "
          "differ from cv2")
    assert mismatches == 0


def test_resize_area_takes_a_single_channel_axis_and_rejects_others():
    img = _image(40, 30, 1)
    np.testing.assert_array_equal(resize_area(img, (20, 15)),
                                  cv2.resize(img, (20, 15), interpolation=cv2.INTER_AREA))
    with pytest.raises(ValueError):
        resize_area(_image(8, 8, 3).astype(np.int32), (4, 4))
    with pytest.raises(ValueError):
        resize_area(_image(8, 8, 3), (0, 4))


@pytest.mark.parametrize("shape", PREPARE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_prepare_inputs_matches_jax(shape):
    from app.demo import prepare_inputs as jax_prepare

    img = _image(*shape, seed=3)
    lr, hr = port_demo.prepare_inputs(img)
    jlr, jhr = jax_prepare(img)
    assert lr.dtype == np.float32 and lr.shape == jlr.shape == (64, 64, 3)
    assert (hr is None) == (jhr is None) == (max(shape) <= 128)
    if hr is not None:
        np.testing.assert_array_equal(hr, jhr)
    np.testing.assert_allclose(lr, jlr, atol=LR_ATOL, rtol=0)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A JAX-written model `.fckpt` (every leaf off its init) and the same
    weights as a reference `.pth` from `export_pth`, with the JAX model."""
    root = tmp_path_factory.mktemp("demo_ckpt")
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(9), SMALL))
    rng = np.random.default_rng(9)
    params = jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32),
                          params)
    jckpt.save_model(str(root / "best_model.fckpt"), params, SMALL)
    (root / "pth").mkdir()
    export_pth(str(root / "best_model.fckpt"), str(root / "pth" / "exported.pth"))
    return root, params


@pytest.mark.parametrize("kind", ["fckpt", "pth"])
def test_load_any_model_matches_jax(checkpoints, kind):
    root, params = checkpoints
    path = root / "best_model.fckpt" if kind == "fckpt" else root / "pth" / "exported.pth"
    model = load_any_model(path, device="cpu")
    assert model.config.num_groups == 2 and not model.training
    x = np.random.default_rng(2).random((2, 16, 16, 3), dtype=np.float32)
    want = np.asarray(fen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), SMALL))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL, rtol=0)


def test_port_written_fckpt_loads_in_both_packages(checkpoints, tmp_path):
    """`fckpt.save_model` writes what the JAX loaders read: the same
    weights back (bitwise) and the same f32 forward."""
    from facesr.models.load import load_any_model as jax_load
    from facesr_torch.ckpt import fckpt

    root, params = checkpoints
    model = load_any_model(root / "best_model.fckpt", device="cpu")
    fckpt.save_model(str(tmp_path / "port.fckpt"), model)
    again = load_any_model(tmp_path / "port.fckpt", device="cpu")
    assert again.config == model.config
    assert all(torch.equal(again.state_dict()[k], v) for k, v in model.state_dict().items())
    jmodel = jax_load(str(tmp_path / "port.fckpt"))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(jmodel.params),
                                                     jax.tree.leaves(params)))


def test_load_any_model_refuses_what_is_not_ported(tmp_path):
    """The model zoo loads (tests/test_torch_zoo_cli.py); a zoo checkpoint
    without its weights is refused and the error names the file."""
    from facesr_torch.ckpt import fckpt

    torch.save({"model_state_dict": {}, "model_type": "transfer"}, tmp_path / "t.pth")
    with pytest.raises(ValueError, match="t.pth"):
        load_any_model(tmp_path / "t.pth")
    fckpt.save_checkpoint(str(tmp_path / "e.fckpt"), {"params": {"w": np.zeros(2)}},
                          {"model_type": "esrgan"})
    with pytest.raises(ValueError, match="e.fckpt"):
        load_any_model(tmp_path / "e.fckpt")
    (tmp_path / "x.bin").write_bytes(b"nope")
    with pytest.raises(ValueError, match="neither"):
        load_any_model(tmp_path / "x.bin")


def test_process_image_matches_jax(checkpoints):
    """The SR within one uint8 level of JAX's (f32 forwards in other
    summation orders); the baselines equal (the port's cubic and Lanczos
    copies are exact on these LRs); both packages' metric rows."""
    from app.demo import process_image as jax_process
    from facesr.models.load import load_any_model as jax_load

    root, _ = checkpoints
    img = _image(200, 200, seed=4)
    got = port_demo.process_image(img, load_any_model(root / "best_model.fckpt", device="cpu"))
    want = jax_process(img, jax_load(str(root / "best_model.fckpt")))
    for key in ("lr", "hr", "bicubic", "lanczos"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert np.abs(got["sr"].astype(int) - want["sr"].astype(int)).max() <= 1
    print(got["metrics_text"], want["metrics_text"], sep="\n")
    assert got["metrics_text"].splitlines()[:2] == want["metrics_text"].splitlines()[:2]


def test_headless_main_writes_the_panels(checkpoints, tmp_path, capsys):
    root, _ = checkpoints
    png.write_png(tmp_path / "face.png", _image(300, 260, seed=5))
    out = tmp_path / "out"
    rc = port_demo.main(["--checkpoint-dir", str(root), "--image", str(tmp_path / "face.png"),
                         "--output", str(out), "--device", "cpu", "--dtype", "bf16"])
    text = capsys.readouterr().out
    assert rc == 0 and "[Best Model]" in text and "Model: PSNR" in text
    for key, shape in (("lr", (64, 64, 3)), ("sr", (256, 256, 3)), ("hr", (256, 256, 3)),
                       ("bicubic", (256, 256, 3)), ("lanczos", (256, 256, 3))):
        assert png.read_rgb(out / f"{key}.png").shape == shape
    assert port_demo.main([]) == 0 and "gradio is not installed" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="gradio"):
        port_demo.create_demo(str(root))
    (tmp_path / "face.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a png")
    assert port_demo.main(["--checkpoint-dir", str(root), "--image", str(tmp_path / "face.jpg"),
                           "--device", "cpu"]) == 1


def test_checkpoint_stem_in_both_formats_raises(checkpoints, tmp_path):
    root, _ = checkpoints
    for name in ("best_model.fckpt", "pth/exported.pth"):
        (tmp_path / name.split("/")[-1]).write_bytes((root / name).read_bytes())
    models = port_demo.load_models_from_checkpoints(str(tmp_path), device="cpu")
    assert sorted(models) == ["Best Model", "Exported"]
    (tmp_path / "best_model.pth").write_bytes((root / "pth" / "exported.pth").read_bytes())
    with pytest.raises(ValueError, match="best_model.fckpt.*best_model.pth"):
        port_demo.load_models_from_checkpoints(str(tmp_path), device="cpu")
    # the int8 dtypes (once refused) wrap every model in a Predictor
    wrapped = port_demo.wrap_predictors(models, "int8")
    assert sorted(wrapped) == sorted(models)
    lr = np.random.default_rng(3).random((1, 8, 8, 3), dtype=np.float32)
    assert wrapped["Best Model"](lr).shape == (1, 32, 32, 3)
