"""The port's TransferSRModel (facesr_torch.models.transfer) against the JAX
package's on the same weights, carried over as numpy, on the CPU: the
forward in f32 and bf16, the head on the group kernel's plain version
against the Pallas kernel in interpret mode, the weight functions, the
stage labels and learning rates, one training step of each stage against
the JAX multi-transform step and against `make_stage_optimizer`, and
`load_pretrained_backbone`.

Tolerances: f32 forward max abs <= 1e-5 * max|ref|; bf16 forward (plain
head in both) max <= 2^-5 and mean <= 2^-8 of max|ref| (JAX's weakly
typed ``x + 0.2 * x5`` may fuse and round once where torch rounds twice,
over the 15 RDBs); the kernel head against Pallas within one bf16 ulp
(2e-2 + 2^-7 |ref|, the kernel tests' limit); a training step's updated
parameters within 1e-5 relative L2, frozen ones bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facesr.ckpt import checkpoint as jckpt
from facesr.ckpt.convert import convert_pth
from facesr.models import esrgan as esr
from facesr.models import transfer as tr
from facesr.models.load import load_any_model as jax_load_any_model
from facesr.ops import bicubic_down as jbicubic_down
from facesr.ops.pallas import rcab_group as jgroup
from facesr.training import steps as jsteps
from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt.weights import (esrgan_state_dict_from_jax_params,
                                       jax_params_from_esrgan_state_dict,
                                       jax_params_from_transfer_state_dict, save_reference_pth,
                                       transfer_state_dict_from_jax_params)
from facesr_torch.models import esrgan as tesr
from facesr_torch.models import transfer as ttr
from facesr_torch.models.load import load_any_model
from facesr_torch.ops import rcab_group as tgroup
from facesr_torch.ops.resize import bicubic_down
from facesr_torch.training import optim
from facesr_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

# the JAX tests' SMALL_TR: body_main 1 block, body_tail 4, head 2, 16 channels
SMALL = dict(backbone_blocks=5, head_blocks=2, head_channels=16)
STAGES = list(tr.TrainingStage)


def _stage(stage):
    """The port's stage of a JAX one."""
    return ttr.TrainingStage[stage.name]


def _params(seed=0, **cfg_kw):
    """(JAX config, JAX params as numpy) of a seeded port model, every
    parameter moved off its init by seeded noise (so the zero biases
    count). The JAX tree comes through the port's weight function, held
    to JAX's own layout by `test_param_tree_has_the_jax_layout` and to
    JAX's exporter by `test_state_dict_keys_are_the_reference_layout`
    (the JAX package's eager init of these trees takes ~10 s)."""
    cfg = cfg_kw or SMALL
    model = ttr.TransferSRModel(ttr.TransferModelConfig(**cfg), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    return (tr.TransferModelConfig(**cfg),
            jax_params_from_transfer_state_dict(model.state_dict()))


@pytest.mark.parametrize("cfg", [SMALL, dict(backbone_blocks=3, head_blocks=1,
                                             head_channels=8)], ids=["small", "no_body_main"])
def test_param_tree_has_the_jax_layout(cfg):
    """The port's JAX-layout tree has the structure, shapes and dtypes of
    JAX's init (fewer blocks than the tail: ``body_main`` None in both)."""
    want = jax.eval_shape(lambda k: tr.init(k, tr.TransferModelConfig(**cfg)),
                          jax.random.PRNGKey(0))
    _, got = _params(**cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(got)] == [
        (b.shape, b.dtype) for b in jax.tree.leaves(want)]


def _port(params, **cfg_kw):
    model = ttr.TransferSRModel(ttr.TransferModelConfig(**(cfg_kw or SMALL)), device="cpu")
    model.load_state_dict(transfer_state_dict_from_jax_params(params), strict=True)
    return model.eval()


def _x(seed=1, n=2, size=16):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


def test_f32_forward_matches_jax():
    cfg, params = _params()
    x = _x()
    want = np.asarray(tr.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 64, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_bf16_forward_matches_jax():
    cfg, params = _params(seed=2)
    x = _x(seed=3)
    want = np.asarray(tr.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg,
                               dtype=jnp.bfloat16))
    model = _port(params)
    assert not model.kernel_head  # 16 channels: the plain head, as JAX
    with torch.no_grad():
        got = model(torch.from_numpy(x), dtype=torch.bfloat16).numpy()
    d = np.abs(got - want)
    assert d.max() <= 2.0 ** -5 * np.abs(want).max()
    assert d.mean() <= 2.0 ** -8 * np.abs(want).max()


# the kernel's width, cut everywhere else: 1 backbone block, 2 head blocks
KC = dict(backbone_blocks=1, head_blocks=2, head_channels=tgroup.KERNEL_CHANNELS)


def test_head_on_the_kernel_matches_the_pallas_kernel():
    """The head's residual group through `fused_residual_group` (its plain
    version on a CPU tensor) against the Pallas kernel in interpret mode,
    on the same bf16 features and the head's weights."""
    cfg, params = _params(seed=4, **KC)
    model = _port(params, **KC)
    assert model.kernel_head
    feat = torch.randn((2, 8, 8, 64), generator=torch.Generator().manual_seed(5)).to(
        torch.bfloat16)
    hd = params["face_head"]
    jgw = jgroup.prepare_group_weights({"rcab": hd["rcabs"], "conv_w": hd["conv_after"]["w"],
                                        "conv_b": hd["conv_after"]["b"]})
    want = np.asarray(jgroup.fused_residual_group(
        jnp.asarray(feat.float().numpy(), jnp.bfloat16), jgw, res_scale=0.2,
        interpret=True).astype(jnp.float32))
    with torch.no_grad():
        got = tgroup.fused_residual_group(feat, model.kernel_head_weights(), 0.2).float().numpy()
    assert np.all(np.abs(got - want) <= 2e-2 + 2.0 ** -7 * np.abs(want))


def test_bf16_eval_runs_the_head_on_the_kernel_once(monkeypatch):
    """One group call a forward, the rest of the model unchanged: the
    kernel head's forward against the plain head's within the model
    limits of `chip_smoke.py` phase 4 (2^-5 of the head-free distance)."""
    _, params = _params(seed=6, **KC)
    model = _port(params, **KC)
    calls = []
    real = tgroup.rcab_group_reference
    monkeypatch.setattr(tgroup, "rcab_group_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(_x(seed=7, size=8))
    with torch.inference_mode():
        k = model(x, dtype=torch.bfloat16)
        assert len(calls) == 1
        p = model(x, dtype=torch.bfloat16, head_fn=ttr.plain_head)
        none = model(x, dtype=torch.bfloat16, head_fn=lambda head, f: f)
        assert len(calls) == 1  # the plain head and training forwards take no kernel
    ref = (p - none).abs()
    d = (k - p).abs()
    assert d.max() <= 2.0 ** -5 * ref.max() and d.mean() <= 2.0 ** -5 * ref.mean()


def test_weight_functions_round_trip_bitwise():
    _, params = _params(seed=8)
    sd = transfer_state_dict_from_jax_params(params)
    back = jax_params_from_transfer_state_dict(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back),
                                                    jax.tree.leaves(params)))
    again = transfer_state_dict_from_jax_params(back)
    assert sd.keys() == again.keys() and all(torch.equal(sd[k], again[k]) for k in sd)
    # fewer blocks than the tail: body_main is None
    _, small = _params(seed=9, backbone_blocks=3, head_blocks=1, head_channels=8)
    assert small["backbone"]["body_main"] is None
    back = jax_params_from_transfer_state_dict(transfer_state_dict_from_jax_params(small))
    assert back["backbone"]["body_main"] is None
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back),
                                                    jax.tree.leaves(small)))


def test_state_dict_keys_are_the_reference_layout():
    from facesr.ckpt.export_torch import export_transfer_state_dict

    _, params = _params()
    want = export_transfer_state_dict(params)
    got = _port(params).state_dict()
    assert set(got) == set(want)
    assert all(np.array_equal(got[k].numpy(), v) for k, v in want.items())


def test_port_pth_and_fckpt_read_by_jax(tmp_path):
    cfg, params = _params(seed=10)
    model = _port(params)
    x = _x(seed=11)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    save_reference_pth(str(tmp_path / "m.pth"), model)
    convert_pth(str(tmp_path / "m.pth"), str(tmp_path / "conv.fckpt"), kind="transfer")
    fckpt.save_model(str(tmp_path / "port.fckpt"), model)
    for name in ("conv.fckpt", "port.fckpt"):
        jm = jax_load_any_model(str(tmp_path / name))
        assert isinstance(jm, tr.TransferSRModel)
        assert (jm.config.backbone_blocks, jm.config.head_blocks,
                jm.config.head_channels) == (5, 2, 16)
        got = np.asarray(jm(jnp.asarray(x)))
        assert np.abs(got - ours).max() <= 1e-5 * np.abs(ours).max()
    # and back: the JAX-written files load in the port
    from facesr.ckpt.export_torch import export_pth

    jckpt.save_model(str(tmp_path / "j.fckpt"), params, cfg, "transfer")
    export_pth(str(tmp_path / "j.fckpt"), str(tmp_path / "j.pth"))
    for name in ("j.fckpt", "j.pth"):
        again = load_any_model(tmp_path / name, device="cpu")
        assert type(again) is ttr.TransferSRModel and again.config == model.config
        assert all(torch.equal(again.state_dict()[k], v) for k, v in model.state_dict().items())


def _label_codes(params, stage):
    """JAX's per-leaf labels for ``stage`` as arrays of the leaf's shape
    (0 frozen, 1 backbone, 2 head), carried into the port's names."""
    codes = {"frozen": 0, "backbone": 1, "head": 2}
    labels = tr.param_labels(params, stage)
    tree = jax.tree.map(lambda p, lab: np.full(np.shape(p), codes[lab], np.float32),
                        params, labels)
    return {k: int(v.flatten()[0]) for k, v in transfer_state_dict_from_jax_params(tree).items()}


@pytest.mark.parametrize("stage", STAGES, ids=lambda s: s.name)
def test_stage_labels_counts_and_rates_match_jax(stage):
    cfg, params = _params()
    model = _port(params)
    codes = {"frozen": 0, "backbone": 1, "head": 2}
    want = _label_codes(params, stage)
    got = ttr.param_labels(model, _stage(stage))
    assert {k: codes[v] for k, v in got.items()} == want
    assert ttr.trainable_param_count(model, _stage(stage)) == tr.trainable_param_count(params,
                                                                                       stage)
    assert ttr.stage_learning_rates(model.config, _stage(stage)) == tr.stage_learning_rates(
        cfg, stage)
    model.set_training_stage(_stage(stage))
    info, jinfo = model.get_model_info(), tr.TransferSRModel(cfg, params=params)
    jinfo.set_training_stage(stage)
    assert info == jinfo.get_model_info()
    assert {n for n, p in model.named_parameters() if p.requires_grad} == {
        n for n, c in want.items() if c}
    assert model.get_trainable_params() == jinfo.get_trainable_params()


class _L1Loss:
    """The Trainer's loss interface around a plain L1 (JAX's step loss)."""

    params: dict = {}

    def to(self, device):
        return self

    def apply(self, loss_params, sr, hr, **kw):
        loss = (sr - hr).abs().mean()
        return loss, {"l1": loss}


STEP_SEED, STEP_HR = 13, 12  # one set of weights and batch for every step test


@functools.lru_cache(maxsize=None)
def _jax_grads():
    """JAX's gradient of the L1 step loss at the step tests' weights and
    batch (a stage changes the update, not the gradient)."""
    cfg, params = _params(seed=STEP_SEED)
    hr = _hr(STEP_HR)

    def loss_fn(p):
        sr = tr.apply(p, jbicubic_down(jnp.asarray(hr), 4), cfg, train=True)
        return jnp.mean(jnp.abs(sr - hr))

    return jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, params))


def _jax_step(params, tx, lr=None):
    """One update of ``tx`` from its fresh state on `_jax_grads`, jitted
    (optax's multi-transform runs ~10 s eagerly over these leaves)."""
    def step(p, grads):
        state = tx.init(p)
        if lr is not None:
            state = jsteps.set_learning_rate(state, lr)
        updates, _ = tx.update(grads, state, p)
        return optax.apply_updates(p, updates)

    return jax.tree.map(np.asarray, jax.jit(step)(jax.tree.map(jnp.asarray, params),
                                                  _jax_grads()))


def _check_step(model, before, want_params, labels):
    want = transfer_state_dict_from_jax_params(want_params)
    for k, v in model.state_dict().items():
        if labels[k] == "frozen":
            assert torch.equal(v, before[k]), f"frozen {k} moved"
            continue
        rel = (v - want[k]).norm() / want[k].norm()
        assert rel <= 1e-5, f"{k}: relative L2 {rel:.3g}"
        assert not torch.equal(v, before[k]), f"{k} did not train"


def _hr(seed):
    return np.random.default_rng(seed).random((2, 32, 32, 3), dtype=np.float32)


@pytest.mark.parametrize("stage", STAGES, ids=lambda s: s.name)
def test_a_train_step_matches_the_jax_multi_transform_step(stage, tmp_path):
    """A Trainer step with its default optimiser on a staged model against
    JAX's ``make_optimizer(param_labels=...)`` step: the clip (active
    here), the decay and the moments over the trained leaves only."""
    cfg, params = _params(seed=STEP_SEED)
    hr, lr, kw = _hr(STEP_HR), 1e-3, dict(weight_decay=1e-2, gradient_clip=0.05)
    labels = jax.tree.map(lambda lab: "frozen" if lab == "frozen" else "train",
                          tr.param_labels(params, stage))
    want = _jax_step(params, jsteps.make_optimizer(param_labels=labels, **kw), lr)

    model = _port(params)
    model.set_training_stage(_stage(stage))
    trainer = Trainer(model, [], [], _L1Loss(), TrainerConfig(
        use_amp=False, checkpoint_dir=str(tmp_path), learning_rate=lr, **kw), device="cpu")
    assert set(trainer.state.opt_state["mu"]) == {
        n for n, lab in ttr.param_labels(model, _stage(stage)).items() if lab != "frozen"}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer._train_step(trainer.state, torch.from_numpy(hr))
    _check_step(model, before, want, ttr.param_labels(model, _stage(stage)))


@pytest.mark.parametrize("stage,clip", [(STAGES[0], 0.0), (STAGES[1], 0.05),
                                        (STAGES[2], 0.0)], ids=["stage1", "stage2_clip",
                                                                "stage3"])
def test_a_trainer_step_matches_make_stage_optimizer(stage, clip, tmp_path):
    """`make_stage_optimizer` through the Trainer: per-group rates, and
    with a clip the global norm over every leaf, frozen ones included."""
    cfg, params = _params(seed=STEP_SEED)  # the config's own stage rates (2e-4, 2e-5, 1e-5)
    hr = _hr(STEP_HR)
    want = _jax_step(params, tr.make_stage_optimizer(params, cfg, stage, weight_decay=1e-2,
                                                     gradient_clip=clip))

    model = _port(params)
    model.set_training_stage(_stage(stage))
    opt = ttr.make_stage_optimizer(model, _stage(stage), weight_decay=1e-2, gradient_clip=clip)
    trainer = Trainer(model, [], [], _L1Loss(),
                      TrainerConfig(use_amp=False, checkpoint_dir=str(tmp_path)), device="cpu",
                      optimizer=opt)
    # a clip over every leaf needs the frozen gradients (stage 3 freezes none)
    assert all(p.requires_grad for p in model.parameters()) == (clip > 0 or stage == STAGES[2])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer._train_step(trainer.state, torch.from_numpy(hr))
    _check_step(model, before, want, opt.labels)
    optim.set_learning_rate(trainer.state.opt_state, 5.0)  # fixed rates: no injected lr
    assert "lr" not in trainer.state.opt_state


def test_load_pretrained_backbone(tmp_path, capsys):
    cfg, params = _params(seed=16)
    rcfg = esr.RRDBNetConfig(num_feat=16, num_blocks=7, num_grow_ch=32)
    rparams = jax_params_from_esrgan_state_dict(tesr.RRDBNet(
        tesr.RRDBNetConfig(num_feat=16, num_blocks=7, num_grow_ch=32), seed=17,
        device="cpu").state_dict())
    jckpt.save_model(str(tmp_path / "rrdb.fckpt"), rparams, rcfg, "esrgan")
    model = _port(params)
    model.load_pretrained_backbone(str(tmp_path / "rrdb.fckpt"))
    assert "Using the first 5 of 7 source RRDB blocks" in capsys.readouterr().out
    src = esrgan_state_dict_from_jax_params(rparams)
    got = model.state_dict()
    for k, v in src.items():
        if k.split(".")[0] in ("conv_first", "conv_body") or (
                k.startswith("body.") and int(k.split(".")[1]) < 5):
            assert torch.equal(got[f"backbone.{k}"], v), k
    # the JAX model loads the same backbone
    jm = tr.TransferSRModel(cfg, params=params)
    jm.load_pretrained_backbone(str(tmp_path / "rrdb.fckpt"))
    jsd = transfer_state_dict_from_jax_params(jax.tree.map(np.asarray, jm.params))
    assert all(torch.equal(got[k], v) for k, v in jsd.items())
    # a port .pth of an RRDBNet works too; too few blocks raise
    short = tesr.RRDBNet(tesr.RRDBNetConfig(num_feat=16, num_blocks=3, num_grow_ch=32),
                         device="cpu")
    save_reference_pth(str(tmp_path / "short.pth"), short)
    with pytest.raises(ValueError, match="only 3 RRDB blocks"):
        model.load_pretrained_backbone(str(tmp_path / "short.pth"))
    model.config.backbone_blocks = 3
    model.backbone.body = model.backbone.body[:3]
    model.load_pretrained_backbone(str(tmp_path / "short.pth"))
    assert torch.equal(model.backbone.body[2].rdb3.conv5.weight, short.body[2].rdb3.conv5.weight)


def test_int8_and_export_of_the_transfer_model_raise():
    """Ported since the zoo's int8 and .pt2 (this test asserted their
    refusal before): the serving and QAT transforms select the same sites
    (5 RRDBs x 15, the head's 2 x 2 RCAB convs, conv_after, conv_last, the
    2 upsample convs, conv_first and conv_body), and the export module
    serves the live bf16 forward. tests/test_torch_zoo_int8.py and
    tests/test_torch_zoo_export.py hold them against JAX and the artifacts."""
    from facesr_torch.ckpt.export import build_serving_fn as export_fn
    from facesr_torch.ops.quant import fake_quant_params, quantize_conv_kernels

    _, params = _params()
    model = _port(params)
    sites = quantize_conv_kernels(model)
    assert list(sites) == list(fake_quant_params(model)) and len(sites) == 5 * 15 + 4 + 6
    x = torch.from_numpy(_x(seed=5, size=8))
    with torch.no_grad():
        want = model(x, dtype=torch.bfloat16).clamp(0, 1)
        assert torch.equal(export_fn(model)(x), want)
