"""The port's validation grid (`training.trainer.save_validation_grid`, the
LR|SR|HR PNG the Trainer writes after each validation) against the JAX
package's `facesr.training.trainer.save_validation_grid` on the CPU.

Tolerances: none. The grids are compared bitwise after decoding: the
function on the same inputs, and the Trainer's file against the JAX
function on the port eval step's own (lr, sr, hr) of the first validation
batch. Only the writer writes it, and a failure to write is a printed
warning.
"""

import cv2
import numpy as np
import pytest
import torch

from facesr.training.trainer import save_validation_grid as jax_grid
from facesr_torch.data import png
from facesr_torch.losses.combined import CombinedLoss
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.training import trainer as trainer_mod
from facesr_torch.training.trainer import Trainer, TrainerConfig, save_validation_grid

torch.set_num_threads(1)


def _read(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("n,hr,scale", [(2, 32, 4), (6, 48, 4), (3, 40, 2), (1, 16, 4)])
def test_the_grid_is_the_jax_grid_bitwise(tmp_path, n, hr, scale):
    """Values outside [0, 1] are clipped; at most 4 rows; the uint8 cast
    truncates (values placed a hair under a level boundary)."""
    rng = np.random.default_rng(n * 100 + hr)
    lr = rng.uniform(-0.2, 1.2, (n, hr // scale, hr // scale, 3)).astype(np.float32)
    sr = rng.uniform(-0.2, 1.2, (n, hr, hr, 3)).astype(np.float32)
    hrs = (np.floor(rng.uniform(0, 255, (n, hr, hr, 3))) / 255 - 1e-7).astype(np.float32)
    save_validation_grid(lr, sr, hrs, epoch=3, save_dir=str(tmp_path / "port"))
    jax_grid(lr, sr, hrs, epoch=3, save_dir=str(tmp_path / "jax"))
    got, want = _read(tmp_path / "port" / "epoch_0003.png"), _read(tmp_path / "jax" /
                                                                    "epoch_0003.png")
    rows = min(4, n)
    assert got.shape == (rows * (hr + 2) + 2, 3 * (hr + 2) + 2, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.read_rgb(tmp_path / "port" / "epoch_0003.png"), want)


def _batches(n, seed, size=32, rows=2):
    rng = np.random.default_rng(seed)
    return [{"hr": np.kron(rng.random((rows, size // 4, size // 4, 3), dtype=np.float32),
                           np.ones((1, 4, 4, 1), np.float32))} for _ in range(n)]


def _trainer(tmp_path, epochs=1):
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                blocks_per_group=2), seed=3, device="cpu")
    loss = CombinedLoss(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.0, device="cpu")
    cfg = TrainerConfig(epochs=epochs, learning_rate=1e-3, weight_decay=0.0, use_amp=False,
                        save_every=100, checkpoint_dir=str(tmp_path / "ckpt"),
                        log_dir=str(tmp_path / "logs"), ema_decay=0.0)
    return Trainer(model, _batches(1, 1), _batches(2, 2, rows=6), loss, cfg, device="cpu")


def test_the_trainer_writes_the_jax_grid_of_its_first_validation_batch(tmp_path):
    tr = _trainer(tmp_path, epochs=2)
    seen = []
    step = tr._eval_step

    def spy(state, hr, **kw):
        out = step(state, hr, **kw)
        seen.append(tuple(t.float().numpy() for t in (out[2], out[1], hr)))
        return out

    spy.row_shard = None
    tr._eval_step = spy
    tr.train()
    assert sorted(p.name for p in (tmp_path / "logs").iterdir()) == ["epoch_0000.png",
                                                                     "epoch_0001.png"]
    # the last validation's first batch (each epoch validates two batches)
    jax_grid(*(a[:8] for a in seen[2]), epoch=1, save_dir=str(tmp_path / "jax"))
    np.testing.assert_array_equal(_read(tmp_path / "logs" / "epoch_0001.png"),
                                  _read(tmp_path / "jax" / "epoch_0001.png"))
    assert _read(tmp_path / "logs" / "epoch_0001.png").shape == (4 * 34 + 2, 3 * 34 + 2, 3)


def test_only_the_writer_writes_and_a_failure_is_a_warning(tmp_path, monkeypatch, capsys):
    tr = _trainer(tmp_path)
    tr.is_writer = False
    tr.train()
    assert not (tmp_path / "logs").exists()

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(trainer_mod, "write_png", broken)
    tr = _trainer(tmp_path / "b")
    history = tr.train()
    assert len(history["val_psnr"]) == 1
    assert "Warning: failed to save validation grid: disk full" in capsys.readouterr().out
