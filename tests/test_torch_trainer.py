"""The port's Trainer, its checkpoints and config helpers on the CPU: two
epochs on a tiny synthetic set, full and weights-only resume, and the
checkpoint read back by the JAX package's converter."""

from pathlib import Path

import numpy as np
import pytest
import torch

from facesr.ckpt.convert import convert_face_enhance_net_state_dict, load_torch_state_dict
from facesr.config import config as jconfig
from facesr_torch import config as tconfig
from facesr_torch.ckpt.weights import load_reference_pth, state_dict_from_jax_params
from facesr_torch.losses.combined import CombinedLoss
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.training import trainer as trainer_mod
from facesr_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

HISTORY = {"train_loss", "val_loss", "val_psnr", "val_ssim", "learning_rate"}


def _batches(n, seed, size=32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lo = rng.random((2, size // 4, size // 4, 3), dtype=np.float32)
        out.append({"hr": np.kron(lo, np.ones((1, 4, 4, 1), np.float32))})
    return out


def _trainer(tmp_path, epochs=2, ema_decay=0.9, seed=0, **kw):
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=2,
                                                blocks_per_group=2), seed=seed, device="cpu")
    loss = CombinedLoss(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1, device="cpu")
    cfg = TrainerConfig(epochs=epochs, learning_rate=1e-3, weight_decay=0.0,
                        gradient_clip=0.5, use_amp=False, scheduler_T_max=4, save_every=1,
                        checkpoint_dir=str(tmp_path), ema_decay=ema_decay,
                        early_stopping_metric="val_loss", early_stopping_mode="min", **kw)
    return Trainer(model, _batches(2, 1), _batches(1, 2), loss, cfg, device="cpu")


def _state_equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_state_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_two_epochs_then_a_full_resume_continues(tmp_path):
    tr = _trainer(tmp_path)
    history = tr.train()
    assert set(history) == HISTORY and all(len(v) == 2 for v in history.values())
    assert all(np.isfinite(v).all() for v in history.values())
    assert history["val_psnr"][1] > 10
    assert tr.global_step == 4 and tr.state.step == 4
    for name in ("epoch_1.pth", "epoch_2.pth", "best_model.pth", "final_model.pth"):
        assert (tmp_path / name).exists(), name
    assert not list(tmp_path.glob("*.tmp"))
    assert history["learning_rate"][1] < history["learning_rate"][0]  # cosine, T_max 4

    resumed = _trainer(tmp_path, epochs=3, seed=5)
    resumed.load_checkpoint(str(tmp_path / "final_model.pth"))
    assert resumed.current_epoch == 2 and resumed.global_step == 4
    assert resumed.current_lr is None and resumed.best_metric == tr.best_metric
    assert _state_equal(resumed.model.state_dict(), tr.model.state_dict())
    assert _state_equal(resumed.state.opt_state, tr.state.opt_state)
    assert _state_equal(resumed.state.ema_params, tr.state.ema_params)
    resumed.train()
    assert resumed.global_step == 6 and resumed.state.step == 6
    assert all(len(v) == 3 for v in resumed.training_history.values())
    assert int(resumed.state.opt_state["count"]) == 6


def test_weights_only_load_resets_ema_and_keeps_a_fresh_optimiser(tmp_path):
    tr = _trainer(tmp_path, epochs=1)
    tr.train()
    fresh = _trainer(tmp_path / "b", seed=7)
    fresh.load_checkpoint(str(tmp_path / "final_model.pth"), weights_only=True)
    assert _state_equal(fresh.model.state_dict(), tr.model.state_dict())
    assert _state_equal(fresh.state.ema_params, dict(tr.model.state_dict()))
    assert not _state_equal(fresh.state.ema_params, tr.state.ema_params)
    assert fresh.current_epoch == 0 and fresh.global_step == 0
    assert int(fresh.state.opt_state["count"]) == 0


def test_resume_rejects_another_optimiser_layout(tmp_path):
    tr = _trainer(tmp_path, epochs=1)
    tr.train()
    other = _trainer(tmp_path / "b", accumulation_steps=2)
    with pytest.raises(ValueError, match="optimizer_state"):
        other.load_checkpoint(str(tmp_path / "final_model.pth"))


def test_checkpoint_reads_back_through_the_jax_converter(tmp_path):
    tr = _trainer(tmp_path, epochs=1, ema_decay=0.0)
    tr.train()
    path = str(tmp_path / "final_model.pth")
    params = convert_face_enhance_net_state_dict(load_torch_state_dict(path))
    back = state_dict_from_jax_params(params)
    want = tr.model.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        assert torch.equal(back[k], v), k
    model = load_reference_pth(path, device="cpu")
    assert model.config == tr.model.config
    assert _state_equal(model.state_dict(), want)
    ckpt = torch.load(path, weights_only=True)
    assert "remat" not in ckpt["config"] and ckpt["model_config"]["remat"] == "save_ca"
    assert ckpt["trainer_config"]["epochs"] == 1 and ckpt["ema_state_dict"] is None


def test_a_failed_async_write_is_reported(tmp_path, monkeypatch):
    tr = _trainer(tmp_path, epochs=1)

    def fail(path, payload):
        raise OSError("disk full")

    monkeypatch.setattr(trainer_mod, "_write", fail)
    with pytest.raises(RuntimeError, match="disk full"):
        tr.save_checkpoint("x.pth")  # raises here if the write already failed,
        tr.flush_checkpoints()       # else here
    tr.flush_checkpoints()  # reported once, then cleared
    assert tr._ckpt_pool is None


def test_config_helpers_match_jax():
    bad = {"model": {"type": "unet"}, "training": {"scheduler": {"type": "linear"}},
           "loss": {"gan": {"type": "hinge"}}, "data": {"scale_factor": 3}, "extra": {}}
    assert tconfig.validate_config(bad) == jconfig.validate_config(bad)
    assert tconfig.validate_config({"data": {"scale_factor": 2.0}}) == \
        jconfig.validate_config({"data": {"scale_factor": 2.0}})
    path = str(Path(__file__).resolve().parent.parent / "configs/stages/stage1_psnr_config.yaml")
    assert tconfig.load_config(path) == jconfig.load_config(path)
    tconfig.set_seed(3)
    a = (torch.rand(3), np.random.rand())
    tconfig.set_seed(3)
    assert torch.equal(a[0], torch.rand(3)) and a[1] == np.random.rand()
