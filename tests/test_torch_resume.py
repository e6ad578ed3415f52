"""Full resumes across the two packages' Trainers through `.fckpt` files,
and the optax state mapping (facesr_torch.ckpt.optax_state), on the CPU.

- JAX file -> port: a small JAX Trainer (EMA, accumulation over 2 steps,
  the non-finite guard) trains one epoch of three batches and writes its
  file mid-accumulation; the port's Trainer resumes from it and trains the
  next epoch, the JAX Trainer resumes from the same file for the same
  epoch. Restored state exact; after the epoch params, EMA, mu and nu
  within 1e-5 relative L2 (f32 steps of two frameworks), every count and
  the LR exact, the new history entries within rtol 1e-4.
- Port file -> JAX: the port's Trainer writes its `.fckpt`; the JAX
  Trainer of the same settings fully resumes from it, and the tree equals
  the JAX Trainer's own file in structure, dtypes and shapes. Cases:
  FaceEnhanceNet with EMA and the perceptual loss (its VGG in
  ``loss_params``), the GAN trainer, transfer stage 2, and a non-GAN file
  into a GAN trainer.
- Wrapper states (no Trainer): ``make_optimizer(...).init`` and three
  updates with accumulation 2, with the non-finite guard (one step fed a
  NaN) and with param labels, against the port's AdamW stepping the same
  gradients; the states are mapped both ways (JAX -> port -> JAX bitwise;
  the port's stepped moments within 2e-5 relative L2 of optax's, counts
  exact), and the transfer model's stage optimiser's tree against
  ``make_stage_optimizer``'s.

Sizes: FaceEnhanceNet G=2, B=2, C=16; batches of 8 32x32 crops; the
discriminator at input 32 with 8 base channels; the transfer model with 5
RRDB blocks and 2 head RCABs at 16 channels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from facesr.losses import combined as jcombined
from facesr.models import discriminator as jdisc
from facesr.models import face_enhance_net as fen
from facesr.models import transfer as jtr
from facesr.training import steps as jsteps
from facesr.training.trainer import Trainer as JaxTrainer
from facesr.training.trainer import TrainerConfig as JaxTrainerConfig
from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt import optax_state as ox
from facesr_torch.ckpt.weights import (discriminator_state_dict_from_jax,
                                       jax_discriminator_from_state_dict, jax_params_from,
                                       jax_params_from_transfer_state_dict,
                                       state_dict_from_jax_params)
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models import discriminator as tdisc
from facesr_torch.models import transfer as ttr
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.training.optim import AdamW
from facesr_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

G, B, C = 2, 2, 16
RESUME_RTOL = 1e-5
D_SIZE, D_BASE = 32, 8
TRANSFER = dict(backbone_blocks=5, head_blocks=2, head_channels=16)


class _Loader:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        lo = rng.random((n, 8, 8, 8, 3), dtype=np.float32)
        self.batches = [{"hr": np.clip(np.kron(b, np.ones((1, 4, 4, 1), np.float32))
                                       + rng.normal(0, 0.02, (8, 32, 32, 3)), 0, 1
                                       ).astype(np.float32)} for b in lo]

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _g_params(seed):
    """(JAX config, JAX params as numpy) of a seeded port FaceEnhanceNet,
    every leaf moved off its init and conv_last redrawn non-zero (JAX's
    eager init costs seconds a tree)."""
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=C, num_groups=G,
                                                blocks_per_group=B), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
        model.conv_last.weight.normal_(0, 0.05, generator=gen)
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    return cfg, jax_params_from(model)


def _port_g(params):
    m = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B),
                       device="cpu")
    m.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return m


def _cfg(root, **kw):
    base = dict(epochs=1, learning_rate=1e-4, weight_decay=1e-4, gradient_clip=0.5,
                use_amp=False, scheduler_type="cosine", scheduler_T_max=4, save_every=100,
                checkpoint_dir=str(root), step_log_every=0, async_checkpoint=False)
    base.update(kw)
    return base


def _jax_cfg(root, **kw):
    return JaxTrainerConfig(**_cfg(root, use_wandb=False, log_dir=str(root) + "_logs", **kw))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif tree is not None:
        yield path, tree


def _same_structure(a, b, where="tree"):
    """Two trees alike in keys, empty maps, None, shapes and dtypes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, sorted(a), sorted(b)
                                                          if isinstance(b, dict) else b)
        for k in a:
            _same_structure(a[k], b[k], f"{where}/{k}")
    elif a is None:
        assert b is None, where
    else:
        assert not isinstance(b, dict) and b is not None, where
        assert np.asarray(a).dtype == np.asarray(b).dtype, (where, np.asarray(a).dtype,
                                                            np.asarray(b).dtype)
        assert np.shape(a) == np.shape(b), (where, np.shape(a), np.shape(b))


def _host_tree(state):
    return serialization.to_state_dict(jax.tree.map(np.asarray, state))


def _assert_tree_values(got, want, where="tree"):
    for (pa, a), (pb, b) in zip(_leaves(got, where), _leaves(want, where)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=pa)


# ---------------------------------------------------------------------------
# JAX file -> port


RESUME_KW = dict(ema_decay=0.9, accumulation_steps=2, skip_nonfinite_updates=1)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One epoch of the JAX Trainer (3 batches: the file is written
    mid-accumulation), then the same Trainer resumed from its file for the
    next epoch."""
    root = tmp_path_factory.mktemp("jax_run")
    cfg, params = _g_params(seed=21)
    loss = lambda: jcombined.create_loss_function(l1_weight=1.0, perceptual_weight=0.0,  # noqa: E731
                                                  ssim_weight=0.1)
    trainer = JaxTrainer(fen.FaceEnhanceNet(cfg, params=jax.tree.map(jnp.asarray, params)),
                         _Loader(3, 0), _Loader(1, 1), loss(),
                         config=_jax_cfg(root / "ckpt", **RESUME_KW))
    trainer.train()
    path = root / "epoch1.fckpt"  # the resumed run writes final_model.fckpt again
    path.write_bytes((root / "ckpt" / "final_model.fckpt").read_bytes())
    trainer.config.epochs = 2
    trainer.load_checkpoint(str(path))
    restored = {"history": {k: list(v) for k, v in trainer.training_history.items()},
                "best": trainer.best_metric, "epoch": trainer.current_epoch,
                "global_step": trainer.global_step}
    trainer.train()
    return {"path": path, "trainer": trainer, "restored": restored}


def _port_resume_trainer(root, loader_seed=0):
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=C, num_groups=G,
                                                blocks_per_group=B), seed=99, device="cpu")
    loss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1),
                        device="cpu")
    return Trainer(model, _Loader(3, loader_seed), _Loader(1, 1), loss,
                   TrainerConfig(**{**_cfg(root, **RESUME_KW), "epochs": 2}), device="cpu")


def test_a_jax_trainer_file_resumes_fully_in_the_port(jax_run, tmp_path):
    jt = jax_run["trainer"]
    tr = _port_resume_trainer(tmp_path)
    tr.load_checkpoint(str(jax_run["path"]))
    restored = jax_run["restored"]
    assert tr.current_epoch == restored["epoch"] == 1
    assert tr.global_step == restored["global_step"] == 3
    assert tr.best_metric == restored["best"]
    assert tr.training_history == restored["history"]
    assert tr.current_lr is None
    state = tr.state.opt_state
    # three batches at accumulation 2: one update, one gradient pending
    assert (int(state["count"]), int(state["mini_step"]), int(state["gradient_step"])) == (1, 1, 1)
    assert float(state["acc"]["conv_last.weight"].abs().sum()) > 0
    file_tree, _ = fckpt.load_checkpoint(str(jax_run["path"]))
    want_params = state_dict_from_jax_params(fckpt.restore_list_nodes(file_tree["params"]))
    assert all(torch.equal(v, want_params[k]) for k, v in tr.model.state_dict().items())

    tr.train()
    assert tr.current_epoch == jt.current_epoch == 1
    assert tr.global_step == jt.global_step == 6
    want = _host_tree(jt.state)
    got = fckpt.train_state_tree("custom", tr.model.state_dict(), tr.optimizer,
                                 tr.state.opt_state, tr.state.step, {},
                                 ema=tr.state.ema_params)
    _same_structure(got, want)
    worst = {}
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        if np.asarray(b).dtype.kind == "f" and np.ndim(b) > 0:
            worst[path.split("/")[1]] = max(worst.get(path.split("/")[1], 0.0), _rel(a, b))
            assert _rel(a, b) <= RESUME_RTOL, (path, _rel(a, b))
        else:  # counts, the LR and the hyperparameters, the guard's flags
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    print(f"after the resumed epoch, worst relative L2 per field {worst}")
    assert tr.training_history.keys() == jt.training_history.keys()
    for k, v in jt.training_history.items():
        assert tr.training_history[k][0] == v[0], k
        np.testing.assert_allclose(tr.training_history[k][1], v[1], rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# port file -> JAX


def _jax_disc(seed):
    """(JAX config, params, stats as numpy) of a seeded port discriminator."""
    d = tdisc.create_discriminator(input_size=D_SIZE, base_channels=D_BASE, seed=seed,
                                   device="cpu")
    params, stats = jax_discriminator_from_state_dict(d.state_dict())
    return jdisc.DiscriminatorConfig(input_size=D_SIZE, base_channels=D_BASE), params, stats


def _port_disc(params, stats):
    d = tdisc.create_discriminator(input_size=D_SIZE, base_channels=D_BASE, device="cpu")
    d.load_state_dict(discriminator_state_dict_from_jax(params, stats), strict=True)
    return d


def _jax_file(trainer):
    trainer.save_checkpoint("jax_own.fckpt")
    trainer.flush_checkpoints()
    return fckpt.load_checkpoint(str(trainer.checkpoint_dir / "jax_own.fckpt"))


def _check_jax_resume(jtrainer, port_path, port_trainer, gan_file):
    """The JAX Trainer resumes from the port's file: same tree structure as
    its own file, and its state holds the port's values."""
    own, _ = _jax_file(jtrainer)
    tree, meta = fckpt.load_checkpoint(str(port_path))
    _same_structure(tree, own)
    jtrainer.load_checkpoint(str(port_path))
    host = _host_tree(jtrainer.state)
    assert jtrainer.current_epoch == port_trainer.current_epoch + 1
    assert jtrainer.global_step == port_trainer.global_step
    assert jtrainer.training_history == port_trainer.training_history
    keep = ["step", "params", "opt_state", "ema_params"]
    if gan_file or not port_trainer.use_gan and not jtrainer.use_gan:
        keep.append("loss_params")
    if gan_file:
        keep += ["d_params", "d_stats", "d_opt_state"]
    for k in keep:
        _assert_tree_values(host[k], tree[k], k)
    assert meta["model_type"] == port_trainer.model_type
    return host


@pytest.fixture(scope="module")
def gan_pair(tmp_path_factory):
    """A JAX GAN Trainer and the G/D weights both packages start from."""
    root = tmp_path_factory.mktemp("gan")
    cfg, params = _g_params(seed=31)
    dcfg, dparams, dstats = _jax_disc(seed=32)
    kw = dict(gan_weight=0.5, d_learning_rate=1e-4, ema_decay=0.9, skip_nonfinite_updates=2)
    jt = JaxTrainer(fen.FaceEnhanceNet(cfg, params=jax.tree.map(jnp.asarray, params)),
                    _Loader(1, 0), _Loader(1, 1),
                    jcombined.create_loss_function(l1_weight=1.0, perceptual_weight=0.0,
                                                   ssim_weight=0.0),
                    config=_jax_cfg(root / "jax", **kw),
                    discriminator=(dcfg, jax.tree.map(jnp.asarray, dparams),
                                   jax.tree.map(jnp.asarray, dstats)))
    return {"jax": jt, "params": params, "dparams": dparams, "dstats": dstats, "kw": kw,
            "root": root}


def _port_gan_trainer(pair, root, gan=True):
    loss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.0),
                        device="cpu")
    kw = dict(pair["kw"])
    if not gan:
        kw["gan_weight"] = 0.0
    return Trainer(_port_g(pair["params"]), _Loader(2, 5), _Loader(1, 1), loss,
                   TrainerConfig(**_cfg(root, **kw)), device="cpu",
                   discriminator=_port_disc(pair["dparams"], pair["dstats"]) if gan else None)


@pytest.mark.parametrize("gan_file", [True, False], ids=["gan_file", "content_file"])
def test_a_port_gan_trainer_file_resumes_in_the_jax_trainer(gan_pair, tmp_path, gan_file,
                                                             capsys):
    tr = _port_gan_trainer(gan_pair, tmp_path / "port", gan=gan_file)
    tr.train()
    path = tmp_path / "port" / "final_model.fckpt"
    jt = gan_pair["jax"]
    fresh_d = _host_tree(jt.state)["d_params"]
    if not gan_file:  # the JAX GAN trainer's own tree has D; the file has none
        tree, _ = fckpt.load_checkpoint(str(path))
        assert tree["d_params"] is None and tree["d_opt_state"] is None
        jt.load_checkpoint(str(path))
        assert "D starts fresh" in capsys.readouterr().out
        host = _host_tree(jt.state)
        for k in ("params", "opt_state", "ema_params"):
            _assert_tree_values(host[k], tree[k], k)
        _assert_tree_values(host["d_params"], fresh_d, "d_params")
        # and the port's GAN trainer takes the same file the same way
        gan = _port_gan_trainer(gan_pair, tmp_path / "port_gan")
        before = {k: v.clone() for k, v in gan.disc.state_dict().items()}
        gan.load_checkpoint(str(path))
        assert all(torch.equal(v, before[k]) for k, v in gan.disc.state_dict().items())
        assert int(gan.state.opt_state["count"]) == int(tr.state.opt_state["count"]) == 2
        return
    host = _check_jax_resume(jt, path, tr, gan_file=True)
    assert int(host["d_opt_state"]["inner_state"]["0"]["count"]) == 2
    # port -> port: the port's own file restores D, its stats and both optimisers
    back = _port_gan_trainer(gan_pair, tmp_path / "back")
    back.load_checkpoint(str(path))
    assert all(torch.equal(v, tr.disc.state_dict()[k]) for k, v in back.disc.state_dict().items())
    for k, v in tr.state.d_opt_state.items():
        want = v if isinstance(v, dict) else {"_": v}
        got = back.state.d_opt_state[k] if isinstance(v, dict) else {"_": back.state.d_opt_state[k]}
        assert all(torch.equal(got[n], want[n]) for n in want), k


def test_a_port_file_with_ema_and_vgg_resumes_in_the_jax_trainer(tmp_path):
    cfg, params = _g_params(seed=41)
    kw = dict(ema_decay=0.9)
    loss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=0.1, ssim_weight=0.0,
                                   perceptual_layers=["conv1_2", "conv2_2"]), seed=3,
                        device="cpu")
    tr = Trainer(_port_g(params), _Loader(1, 0), _Loader(1, 1), loss,
                 TrainerConfig(**_cfg(tmp_path / "port", **kw)), device="cpu")
    tr.train()
    path = tmp_path / "port" / "final_model.fckpt"
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(
        l1_weight=1.0, perceptual_weight=0.1, ssim_weight=0.0,
        perceptual_layers=["conv1_2", "conv2_2"]), seed=4)
    jt = JaxTrainer(fen.FaceEnhanceNet(cfg, params=jax.tree.map(jnp.asarray, params)),
                    _Loader(1, 0), _Loader(1, 1), jloss, config=_jax_cfg(tmp_path / "jax", **kw))
    host = _check_jax_resume(jt, path, tr, gan_file=False)
    assert len(host["loss_params"]["vgg"]) == 4 and host["ema_params"] is not None
    # the port resumes its own file: state, EMA and the VGG it came with
    other = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=0.1, ssim_weight=0.0,
                                    perceptual_layers=["conv1_2", "conv2_2"]), seed=9,
                         device="cpu")
    back = Trainer(_port_g(_g_params(seed=42)[1]), _Loader(1, 0), _Loader(1, 1), other,
                   TrainerConfig(**_cfg(tmp_path / "back", **kw)), device="cpu")
    back.load_checkpoint(str(path))
    for a, b in zip(back.loss_fn.params["vgg"], tr.loss_fn.params["vgg"]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    for k in ("mu", "nu"):
        assert all(torch.equal(v, tr.state.opt_state[k][n])
                   for n, v in back.state.opt_state[k].items())
    assert all(torch.equal(v, tr.state.ema_params[n]) for n, v in back.state.ema_params.items())
    assert back.state.step == tr.state.step == 1 and back.current_epoch == 1
    # a loss without the perceptual term cannot take the file's loss params
    plain = Trainer(_port_g(params), [], [], CombinedLoss(
        LossConfig(l1_weight=1.0, perceptual_weight=0.0), device="cpu"),
        TrainerConfig(**_cfg(tmp_path / "plain", **kw)), device="cpu")
    with pytest.raises(ValueError, match="loss_params"):
        plain.load_checkpoint(str(path))


def test_a_port_transfer_stage2_file_resumes_in_the_jax_trainer(tmp_path):
    model = ttr.TransferSRModel(ttr.TransferModelConfig(**TRANSFER), seed=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    params = jax_params_from_transfer_state_dict(model.state_dict())
    model.set_training_stage(ttr.TrainingStage.STAGE2_PARTIAL_FINETUNE)

    class _L1:
        params: dict = {}

        def to(self, device):
            return self

        def apply(self, loss_params, sr, hr, **kw):
            loss = (sr - hr).abs().mean()
            return loss, {"l1": loss}

    kw = dict(skip_nonfinite_updates=1)
    tr = Trainer(model, _Loader(1, 0), [], _L1(), TrainerConfig(**_cfg(tmp_path / "port", **kw)),
                 device="cpu")
    tr.train()
    path = tmp_path / "port" / "final_model.fckpt"
    jmodel = jtr.TransferSRModel(jtr.TransferModelConfig(**TRANSFER),
                                 params=jax.tree.map(jnp.asarray, params))
    jmodel.set_training_stage(jtr.TrainingStage.STAGE2_PARTIAL_FINETUNE)
    jt = JaxTrainer(jmodel, _Loader(1, 0), [], jcombined.create_loss_function(
        l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.0),
        config=_jax_cfg(tmp_path / "jax", **kw))
    host = _check_jax_resume(jt, path, tr, gan_file=False)
    train = host["opt_state"]["inner_state"]["inner_states"]["train"]["inner_state"]["1"]
    mu = train["inner_state"]["0"]["mu"]
    # frozen leaves are optax's MaskedNode: empty maps
    assert mu["backbone"]["body_main"]["rdb1"]["conv1_w"] == {}
    assert mu["backbone"]["conv_first"] == {"w": {}, "b": {}}
    assert np.abs(mu["backbone"]["body_tail"]["rdb1"]["conv1_w"]).sum() > 0
    fresh = ttr.TransferSRModel(ttr.TransferModelConfig(**TRANSFER), device="cpu")
    fresh.set_training_stage(ttr.TrainingStage.STAGE2_PARTIAL_FINETUNE)
    back = Trainer(fresh, [], [], _L1(), TrainerConfig(**_cfg(tmp_path / "back", **kw)),
                   device="cpu")
    back.load_checkpoint(str(path))
    assert set(back.state.opt_state["mu"]) == set(tr.state.opt_state["mu"])
    assert all(torch.equal(v, tr.state.opt_state["nu"][n])
               for n, v in back.state.opt_state["nu"].items())


def test_an_unknown_tree_is_refused_naming_its_path(jax_run, tmp_path):
    """A JAX file written with accumulation, read by a trainer without."""
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=C, num_groups=G,
                                                blocks_per_group=B), device="cpu")
    tr = Trainer(model, [], [], CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=0.0),
                                             device="cpu"),
                 TrainerConfig(**_cfg(tmp_path, ema_decay=0.9, skip_nonfinite_updates=1)),
                 device="cpu")
    with pytest.raises(ValueError, match=r"opt_state/inner_state: the file has a map of "
                                         r"\['acc_grads'"):
        tr.load_checkpoint(str(jax_run["path"]))


def test_a_file_of_other_hyperparameters_is_refused_naming_them(jax_run, tmp_path):
    """optax reads weight_decay from the state: a trainer of another
    setting must not continue silently otherwise than the JAX resume."""
    tr = _port_resume_trainer(tmp_path)
    tr.optimizer.weight_decay = 1e-3
    with pytest.raises(ValueError, match=r"opt_state: the file's weight_decay is "
                                         r"9\.99\d*e-05, this trainer's optimiser uses 0\.001"):
        tr.load_checkpoint(str(jax_run["path"]))


# ---------------------------------------------------------------------------
# wrapper states, no Trainer


def _small_model():
    m = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=8, num_groups=1, blocks_per_group=1),
                       seed=2, device="cpu")
    return m


def _grads(model, n, seed, nan_at=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = {k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
             for k, p in model.named_parameters()}
        if i == nan_at:
            g["conv_last.weight"][0, 0, 0, 0] = float("nan")
        out.append(g)
    return out


# the port's stepped moments against optax's: the port takes 1 - b2 in
# float64, optax's injected hyperparameters in float32 (nu 1.3e-5 relative
# apart, measured); the mapping itself is held bitwise (JAX -> port -> JAX)
STEP_MOMENT_RTOL = 2e-5

WRAPPERS = {
    "accumulation_2": dict(accumulation_steps=2),
    "skip_nonfinite_2": dict(skip_nonfinite=2),
    "param_labels": dict(labels=True),
}


@pytest.mark.parametrize("case", sorted(WRAPPERS))
def test_wrapper_states_map_both_ways_against_optax(case):
    kw = dict(WRAPPERS[case])
    labelled = kw.pop("labels", False)
    model = _small_model()
    named = dict(model.named_parameters())
    frozen = {"conv_first.weight", "conv_first.bias"} if labelled else set()
    labels = {n: "frozen" if n in frozen else "train" for n in named} if labelled else None
    grads = _grads(model, 3, seed=7, nan_at=1 if "skip_nonfinite" in kw else None)

    jparams = jax.tree.map(jnp.asarray, jax_params_from(model))
    label_tree = None
    if labelled:
        codes = {n: torch.full(p.shape, 0.0 if n in frozen else 1.0) for n, p in named.items()}
        label_tree = jax.tree.map(lambda a: "frozen" if np.all(a == 0) else "train",
                                  jax_params_from_state_dict_like(codes))
    # a clip above the gradients' norm: its state is in the tree, and no
    # step rescales by a norm the two frameworks sum in other orders
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=1e3, param_labels=label_tree,
                               **kw)
    jstate = jsteps.set_learning_rate(tx.init(jparams), 1e-3)
    update = jax.jit(tx.update)

    opt = AdamW(weight_decay=1e-2, gradient_clip=1e3, **kw)
    params = {n: p.detach().clone() for n, p in named.items() if n not in frozen}
    state = opt.init(params, 1e-3)
    for g in grads:
        jg = jax.tree.map(jnp.asarray, jax_params_from_state_dict_like(g))
        updates, jstate = update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update({n: g[n] for n in params}, state, params)

    want = _host_tree(jstate)
    full = {n: p.detach() for n, p in named.items()}
    got = ox.optax_state_dict(opt, state, "custom", full, labels)
    _same_structure(got, want)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        if np.asarray(b).dtype.kind == "f" and np.ndim(b) > 0:
            assert _rel(a, b) <= STEP_MOMENT_RTOL, (path, _rel(a, b))
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    back = ox.port_state_from_optax(opt, want, state, "custom", full, labels)
    # JAX -> port -> JAX is the JAX state bitwise
    _assert_tree_values(ox.optax_state_dict(opt, back, "custom", full, labels), want)
    assert back.keys() == state.keys()
    for k, v in state.items():
        if isinstance(v, dict):
            assert v.keys() == back[k].keys()
            assert max(_rel(back[k][n], v[n]) for n in v) <= STEP_MOMENT_RTOL, k
        else:
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    if "skip_nonfinite" in kw:
        assert int(state["total_notfinite"]) == 1 and bool(state["last_finite"])
    if "accumulation_steps" in kw:
        assert (int(state["mini_step"]), int(state["gradient_step"])) == (1, 1)


def jax_params_from_state_dict_like(named):
    """A {port name: tensor} dict of the small model as the JAX tree."""
    from facesr_torch.ckpt.weights import jax_params_from_state_dict

    return jax_params_from_state_dict(named)


@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["no_clip", "clip"])
def test_the_stage_optimizer_tree_is_make_stage_optimizers(clip):
    model = ttr.TransferSRModel(ttr.TransferModelConfig(**TRANSFER), seed=6, device="cpu")
    stage = ttr.TrainingStage.STAGE2_PARTIAL_FINETUNE
    model.set_training_stage(stage)
    opt = ttr.make_stage_optimizer(model, stage, weight_decay=1e-2, gradient_clip=clip)
    opt.skip_nonfinite = 1
    named = {n: p.detach() for n, p in model.named_parameters()}
    state = opt.init({n: p for n, p in named.items()
                      if clip > 0 or opt.labels[n] != "frozen"})
    gen = torch.Generator().manual_seed(1)
    for k in ("mu", "nu"):
        for n in state[k]:
            if opt.labels[n] != "frozen":
                state[k][n] = torch.rand(state[k][n].shape, generator=gen)
    state["count"] = torch.tensor(3, dtype=torch.int32)
    params = jax_params_from_transfer_state_dict(model.state_dict())
    jcfg = jtr.TransferModelConfig(**TRANSFER)
    jstage = jtr.TrainingStage.STAGE2_PARTIAL_FINETUNE
    tx = optax.apply_if_finite(jtr.make_stage_optimizer(params, jcfg, jstage, weight_decay=1e-2,
                                                        gradient_clip=clip), 1)
    want = serialization.to_state_dict(jax.eval_shape(tx.init, jax.tree.map(jnp.asarray,
                                                                            params)))
    labels = ox.stage_labels(opt, state, named, "transfer")
    got = ox.optax_state_dict(opt, state, "transfer", named, labels)
    _same_structure(got, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), want))
    back = ox.port_state_from_optax(opt, got, state, "transfer", named, labels)
    for k in ("mu", "nu"):
        assert all(torch.equal(back[k][n], state[k][n]) for n in state[k])
    assert int(back["count"]) == 3


def test_a_trainer_folder_serves_each_save_once(tmp_path):
    """The Trainer writes each save as .pth and .fckpt: the demo, the API
    and compare_two_models load the .fckpt of the pair; a .pth of another
    model under the same stem still raises in the demo."""
    from facesr_torch.app import demo
    from facesr_torch.cli.compare_two_models import find_checkpoints

    _, params = _g_params(seed=51)
    loss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=0.0), device="cpu")
    tr = Trainer(_port_g(params), _Loader(1, 0), _Loader(1, 1), loss,
                 TrainerConfig(**_cfg(tmp_path, ema_decay=0.5)), device="cpu")
    tr.train()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best_model.fckpt", "best_model.pth", "final_model.fckpt", "final_model.pth"]
    path = tmp_path / "final_model.fckpt"
    assert fckpt.read_meta(str(path)) == fckpt.load_checkpoint(str(path))[1]
    assert {k: v.name for k, v in find_checkpoints(str(tmp_path)).items()} == {
        "Best Model": "best_model.fckpt", "Final Model": "final_model.fckpt"}
    models = demo.load_models_from_checkpoints(str(tmp_path), device="cpu")
    assert sorted(models) == ["Best Model", "Final Model"]
    ema = {k: v for k, v in tr.state.ema_params.items()}
    assert all(torch.equal(v, ema[k]) for k, v in models["Final Model"].state_dict().items())
    save = torch.load(tmp_path / "best_model.pth", weights_only=True)
    save["global_step"] += 1  # another save under the same stem
    torch.save(save, tmp_path / "best_model.pth")
    with pytest.raises(ValueError, match="best_model.fckpt.*best_model.pth"):
        demo.load_models_from_checkpoints(str(tmp_path), device="cpu")
