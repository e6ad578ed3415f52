"""The port's converter CLI (facesr_torch.cli.convert) against the JAX
package's (``python -m facesr.ckpt.convert``, run in this process through
runpy), on the CPU.

- Forward: for every kind the port's ``.fckpt`` is byte-identical to the
  JAX CLI's for the same ``.pth`` and output path (the meta names the
  input path); a float16 FaceEnhanceNet ``.pth`` keeps its dtype.
- ``--reverse`` (auto, custom with and without ``--no-ema``, transfer,
  rrdbnet): the same keys in the same order, the same tensors and the same
  other entries as JAX's ``export_pth``.
- The refusals: ``--kind auto`` without ``--reverse``, an unexportable
  kind, lpips without ``--extra``, a state dict with a gap.

Sizes: FaceEnhanceNet G=2, B=2, C=16; RRDBNet 8 features, 2 blocks, growth
4; the transfer model with 5 RRDB blocks and 2 head RCABs at 16 channels;
VGG19 and AlexNet convs at 4 channels; InceptionV3 at its real shapes.
"""

import runpy
import sys

import numpy as np
import pytest
import torch

from facesr.ckpt.export_torch import export_pth as jax_export_pth
from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt.weights import jax_params_from, save_reference_pth
from facesr_torch.cli import convert
from facesr_torch.models.esrgan import RRDBNet, RRDBNetConfig
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.models.inception import CONV_SPECS
from facesr_torch.models.transfer import TransferModelConfig, TransferSRModel

torch.set_num_threads(1)

VGG_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]


def _perturbed(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def _models():
    return {
        "custom": _perturbed(FaceEnhanceNet(FaceEnhanceNetConfig(
            num_channels=16, num_groups=2, blocks_per_group=2), seed=1, device="cpu"), 1),
        "rrdbnet": _perturbed(RRDBNet(RRDBNetConfig(num_feat=8, num_blocks=2, num_grow_ch=4),
                                      seed=2, device="cpu"), 2),
        "transfer": _perturbed(TransferSRModel(TransferModelConfig(
            backbone_blocks=5, head_blocks=2, head_channels=16), seed=3, device="cpu"), 3),
    }


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.fixture(scope="module")
def pths(tmp_path_factory):
    root = tmp_path_factory.mktemp("pths")
    rng = np.random.default_rng(0)
    out = {}
    for kind, model in _models().items():
        out[kind] = root / f"{kind}.pth"
        save_reference_pth(str(out[kind]), model)
    # a half-precision reference file: the converters keep its dtype
    out["custom_fp16"] = root / "custom_fp16.pth"
    half = torch.load(out["custom"], weights_only=True)
    half["model_state_dict"] = {k: v.half() for k, v in half["model_state_dict"].items()}
    torch.save(half, out["custom_fp16"])
    vgg = {}
    cin = 3
    for idx in VGG_IDX:
        vgg[f"features.{idx}.weight"] = _rand(rng, 4, cin, 3, 3)
        vgg[f"features.{idx}.bias"] = _rand(rng, 4)
        cin = 4
    torch.save(vgg, root / "vgg19.pth")
    torch.save({k: v for k, v in vgg.items() if int(k.split(".")[1]) < 7},
               root / "vgg19_prefix.pth")
    torch.save({k: v for k, v in vgg.items() if not k.startswith("features.5.")},
               root / "vgg19_gap.pth")
    alex = {}
    cin = 3
    for idx in (0, 3, 6, 8, 10):
        alex[f"features.{idx}.weight"] = _rand(rng, 4, cin, 3, 3)
        alex[f"features.{idx}.bias"] = _rand(rng, 4)
        cin = 4
    torch.save(alex, root / "alexnet.pth")
    torch.save({f"lin{i}.model.1.weight": _rand(rng, 1, 4, 1, 1).abs() for i in range(5)},
               root / "lins.pth")
    inc = {}
    for name, (ic, oc, (kh, kw), _, _) in CONV_SPECS.items():
        inc[f"{name}.conv.weight"] = _rand(rng, oc, ic, kh, kw) * 0.1
        inc[f"{name}.bn.weight"] = _rand(rng, oc) * 0.1 + 1
        inc[f"{name}.bn.bias"] = _rand(rng, oc) * 0.1
        inc[f"{name}.bn.running_mean"] = _rand(rng, oc) * 0.1
        inc[f"{name}.bn.running_var"] = _rand(rng, oc).abs() + 0.5
    torch.save(inc, root / "inception.pth")
    out.update(vgg19=root / "vgg19.pth", vgg19_prefix=root / "vgg19_prefix.pth",
               vgg19_gap=root / "vgg19_gap.pth", alexnet=root / "alexnet.pth",
               lins=root / "lins.pth", inception=root / "inception.pth")
    return out


def run_jax(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["convert.py"] + argv)
    runpy.run_module("facesr.ckpt.convert", run_name="__main__")


FORWARD = {
    "custom": ("custom", "custom", None),
    "custom_fp16": ("custom_fp16", "custom", None),
    "rrdbnet": ("rrdbnet", "rrdbnet", None),
    "transfer": ("transfer", "transfer", None),
    "vgg19": ("vgg19", "vgg19", None),
    "vgg19_prefix": ("vgg19_prefix", "vgg19", None),
    "lpips": ("alexnet", "lpips", "lins"),
    "inception": ("inception", "inception", None),
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_fckpt_is_byte_identical_to_the_jax_clis(pths, tmp_path, monkeypatch, case):
    src, kind, extra = FORWARD[case]
    out = tmp_path / f"{case}.fckpt"
    argv = ["--input", str(pths[src]), "--output", str(out), "--kind", kind]
    if extra:
        argv += ["--extra", str(pths[extra])]
    run_jax(argv, monkeypatch)
    want = out.read_bytes()
    out.unlink()
    assert convert.main(argv) == 0
    got = out.read_bytes()
    assert len(got) == len(want) and got == want


def test_the_default_kind_is_custom(pths, tmp_path, monkeypatch):
    out = tmp_path / "default.fckpt"
    run_jax(["--input", str(pths["custom"]), "--output", str(out)], monkeypatch)
    want = out.read_bytes()
    convert.main(["--input", str(pths["custom"]), "--output", str(out)])
    assert out.read_bytes() == want


@pytest.fixture(scope="module")
def fckpts(pths, tmp_path_factory):
    """Model .fckpt files to export: the converted three, and a trainer-like
    file with EMA weights and training meta."""
    root = tmp_path_factory.mktemp("fckpts")
    out = {}
    for kind in ("custom", "rrdbnet", "transfer"):
        out[kind] = root / f"{kind}.fckpt"
        convert.main(["--input", str(pths[kind]), "--output", str(out[kind]), "--kind", kind])
    models = _models()
    params = jax_params_from(models["custom"])
    ema = jax_params_from(_perturbed(models["custom"], 9))
    cfg = {"num_channels": 16, "num_groups": 2, "blocks_per_group": 2, "res_scale": 0.2,
           "num_rcab_blocks": 4}
    out["trainer"] = root / "trainer.fckpt"
    fckpt.save_checkpoint(str(out["trainer"]),
                          {"step": np.asarray(7, np.int32), "params": params,
                           "ema_params": ema},
                          {"model_type": "custom", "model_config": cfg, "epoch": 3,
                           "global_step": 7, "best_metric": 30.5})
    return out


REVERSE = {
    "auto": ("custom", []),
    "custom_ema": ("trainer", ["--kind", "custom"]),
    "custom_no_ema": ("trainer", ["--kind", "custom", "--no-ema"]),
    "transfer": ("transfer", ["--kind", "transfer"]),
    "rrdbnet": ("rrdbnet", ["--kind", "rrdbnet"]),
    "rrdbnet_auto": ("rrdbnet", []),
}


@pytest.mark.parametrize("case", sorted(REVERSE))
def test_reverse_pth_matches_jax_export_pth(fckpts, tmp_path, monkeypatch, case):
    src, flags = REVERSE[case]
    jax_out, port_out = tmp_path / "jax.pth", tmp_path / "port.pth"
    run_jax(["--reverse", "--input", str(fckpts[src]), "--output", str(jax_out)] + flags,
            monkeypatch)
    convert.main(["--reverse", "--input", str(fckpts[src]), "--output", str(port_out)] + flags)
    want = torch.load(jax_out, weights_only=True)
    got = torch.load(port_out, weights_only=True)
    assert list(got) == list(want)
    for key in want:
        if isinstance(want[key], dict) and want[key] and isinstance(
                next(iter(want[key].values())), torch.Tensor):
            assert list(got[key]) == list(want[key]), key
            for name, t in want[key].items():
                assert got[key][name].dtype == t.dtype and torch.equal(got[key][name], t), name
        else:
            assert got[key] == want[key], key
    if case == "custom_no_ema":
        ema = torch.load(tmp_path / "jax.pth", weights_only=True)
        jax_export_pth(str(fckpts[src]), str(tmp_path / "ema.pth"), "custom", prefer_ema=True)
        with_ema = torch.load(tmp_path / "ema.pth", weights_only=True)
        assert not torch.equal(ema["model_state_dict"]["conv_first.weight"],
                               with_ema["model_state_dict"]["conv_first.weight"])


def test_refusals_match_the_jax_cli(pths, fckpts, tmp_path, monkeypatch, capsys):
    argv = ["--input", str(pths["custom"]), "--output", str(tmp_path / "x.fckpt"),
            "--kind", "auto"]
    with pytest.raises(SystemExit) as jax_exit:
        run_jax(argv, monkeypatch)
    jerr = capsys.readouterr().err
    with pytest.raises(SystemExit) as port_exit:
        convert.main(argv)
    assert port_exit.value.code == jax_exit.value.code == 2
    assert "--kind auto is only for --reverse" in capsys.readouterr().err
    assert "--kind auto is only for --reverse" in jerr
    cases = [
        (["--reverse", "--input", str(fckpts["custom"]), "--output",
          str(tmp_path / "y.pth"), "--kind", "vgg19"], "Cannot export model_type 'vgg19'"),
        (["--input", str(pths["alexnet"]), "--output", str(tmp_path / "l.fckpt"),
          "--kind", "lpips"], "lpips conversion needs extra_pth"),
        (["--input", str(pths["vgg19_gap"]), "--output", str(tmp_path / "g.fckpt"),
          "--kind", "vgg19"], "vgg19 state dict missing 'features.5.weight'"),
        (["--input", str(pths["vgg19"]), "--output", str(tmp_path / "c.fckpt"),
          "--kind", "custom"], "Unrecognized FaceEnhanceNet state dict"),
    ]
    for argv, message in cases:
        with pytest.raises(ValueError) as jax_err:
            run_jax(argv, monkeypatch)
        with pytest.raises(ValueError) as port_err:
            convert.main(argv)
        assert str(port_err.value) == str(jax_err.value) and message in str(port_err.value)
