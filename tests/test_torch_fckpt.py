"""The port's `.fckpt` reader (facesr_torch.ckpt.fckpt) against the JAX
package's checkpoints: a `save_model` file and a small JAX Trainer's file
read into the same tree, `load_model` forwards, and the port's Trainer
loading a JAX checkpoint weights-only."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facesr.ckpt import checkpoint as jckpt
from facesr.losses import combined as jcombined
from facesr.models import face_enhance_net as fen
from facesr.training import Trainer as JaxTrainer
from facesr.training import TrainerConfig as JaxTrainerConfig
from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt.weights import state_dict_from_jax_params
from facesr_torch.losses.combined import CombinedLoss
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

SMALL = fen.FaceEnhanceNetConfig(num_channels=16, num_groups=1, blocks_per_group=2)


class _Loader:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.batches = [{"hr": rng.random((8, 32, 32, 3), dtype=np.float32)} for _ in range(n)]

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _perturbed_params(seed=0):
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(seed), SMALL))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32),
                        params)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A `save_model` file, one without config metadata, and the final
    checkpoint of one epoch of a small JAX Trainer with EMA."""
    root = tmp_path_factory.mktemp("fckpt")
    params = _perturbed_params()
    jckpt.save_model(str(root / "model.fckpt"), params, SMALL,
                     extra_meta={"note": "x", "epoch": 3})
    jckpt.save_checkpoint(str(root / "bare.fckpt"), {"params": params}, {})
    cfg = JaxTrainerConfig(epochs=1, learning_rate=1e-3, use_amp=False, use_wandb=False,
                           ema_decay=0.9, checkpoint_dir=str(root / "run"),
                           log_dir=str(root / "logs"), save_every=100, scheduler_T_max=2)
    trainer = JaxTrainer(fen.FaceEnhanceNet(SMALL), _Loader(2, 0), _Loader(1, 1),
                         jcombined.create_loss_function(l1_weight=1.0, perceptual_weight=0.0,
                                                        ssim_weight=0.1), config=cfg)
    trainer.train()
    return {"model": root / "model.fckpt", "bare": root / "bare.fckpt",
            "trainer": root / "run" / "final_model.fckpt", "params": params}


def _same_tree(a, b, where="tree"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert type(a) is type(b) and a == b, where


@pytest.mark.parametrize("name", ["model", "bare", "trainer"])
def test_tree_and_meta_read_bitwise(files, name):
    want_tree, want_meta = jckpt.load_checkpoint(str(files[name]))
    tree, meta = fckpt.load_checkpoint(str(files[name]))
    _same_tree(want_tree, tree)
    assert meta == want_meta
    if name == "trainer":
        assert {"step", "params", "opt_state", "ema_params"} <= set(tree)
        assert meta["model_config"]["num_groups"] == 1 and meta["epoch"] == 0


def test_bfloat16_and_scalars(tmp_path):
    path = tmp_path / "bf.fckpt"
    jckpt.save_checkpoint(str(path), {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
                                      "s": np.float32(2.5)}, {"k": [1, 2]})
    tree, meta = fckpt.load_checkpoint(str(path))
    assert tree["w"].dtype == torch.bfloat16 and tree["w"].shape == (2, 3)
    assert torch.equal(tree["w"].float(), torch.arange(6.0).reshape(2, 3))
    assert tree["s"].dtype == np.float32 and tree["s"] == 2.5 and meta == {"k": [1, 2]}


def _forward_equal(cfg, sd, params):
    model = FaceEnhanceNet(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(1).random((2, 16, 16, 3), dtype=np.float32)
    want = np.asarray(fen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), SMALL))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["model", "bare"])
def test_load_model_forward_equals_jax(files, name):
    cfg, sd = fckpt.load_model(str(files[name]))
    jcfg, jparams = jckpt.load_model(str(files[name]))
    assert (cfg.num_channels, cfg.num_groups, cfg.blocks_per_group, cfg.reduction_ratio,
            cfg.scale_factor) == (jcfg.num_channels, jcfg.num_groups, jcfg.blocks_per_group,
                                  jcfg.reduction_ratio, jcfg.scale_factor)
    _forward_equal(cfg, sd, files["params"])


@pytest.mark.parametrize("prefer_ema", [True, False])
def test_load_model_takes_ema_or_params_of_a_trainer_file(files, prefer_ema):
    cfg, sd = fckpt.load_model(str(files["trainer"]), prefer_ema=prefer_ema)
    _, jparams = jckpt.load_model(str(files["trainer"]), prefer_ema=prefer_ema)
    tree, _ = jckpt.load_checkpoint(str(files["trainer"]))
    assert not np.array_equal(tree["params"]["conv_first"]["w"],
                              tree["ema_params"]["conv_first"]["w"])
    want = state_dict_from_jax_params(jparams)
    assert set(sd) == set(want) and all(torch.equal(sd[k], want[k]) for k in want)
    _forward_equal(cfg, sd, jparams)


def _port_trainer(tmp_path, ema_decay):
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                blocks_per_group=2), seed=5, device="cpu")
    cfg = TrainerConfig(epochs=1, use_amp=False, checkpoint_dir=str(tmp_path),
                        ema_decay=ema_decay)
    loss = CombinedLoss(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1, device="cpu")
    return Trainer(model, _Loader(1, 0), _Loader(1, 1), loss, cfg, device="cpu")


def test_port_trainer_chains_from_a_jax_trainer_file_weights_only(files, tmp_path):
    tr = _port_trainer(tmp_path, ema_decay=0.5)
    tr.load_checkpoint(str(files["trainer"]), weights_only=True)
    tree, _ = jckpt.load_checkpoint(str(files["trainer"]))
    params = jckpt._restore_list_nodes(tree["params"])
    want = state_dict_from_jax_params(params)
    got = tr.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(tr.state.ema_params[k], got[k]) for k in tr.state.ema_params)
    assert int(tr.state.opt_state["count"]) == 0 and tr.current_epoch == 0
    _forward_equal(tr.model.config, got, params)
    # a full resume from the same file takes its optimiser state too
    tr.load_checkpoint(str(files["trainer"]))
    assert int(tr.state.opt_state["count"]) == 2 and tr.current_epoch == 1


def test_format_is_told_by_content(files, tmp_path):
    tr = _port_trainer(tmp_path, ema_decay=0.0)
    odd = tmp_path / "model.pth"  # a .fckpt under another name still reads
    odd.write_bytes(files["model"].read_bytes())
    tr.load_checkpoint(str(odd), weights_only=True)
    (tmp_path / "junk.pth").write_bytes(b"\x00junk")
    with pytest.raises(ValueError, match="neither a torch checkpoint nor a JAX .fckpt"):
        tr.load_checkpoint(str(tmp_path / "junk.pth"), weights_only=True)
    with pytest.raises(fckpt.FckptError, match="truncated"):
        fckpt.unpackb(files["model"].read_bytes()[:100], "cut")
    assert json.loads(fckpt.unpackb(files["model"].read_bytes())["meta"])["note"] == "x"
