"""The three-axis mesh of the port on the CPU: `data,space,model` grids of
gloo ranks started by `facesr_torch.parallel.launch` (the batch over
`data`, each batch shard's image rows over `space`, the conv output
channels and the whole training state over `model`): the grid's
coordinates and groups in both axis orders, `shard_batch` on three axes,
the content, VGG + clip, GAN, QAT and eval steps against the port's
single-process steps and JAX's three-axis steps, the Trainer (its
checkpoints and resumes both ways), the overfit helper and the train CLI;
and JAX's own three-axis content and GAN steps (the state placed by its
`tp_param_shardings`, the batch by its `grid_sharding`) against JAX's
single-device steps on the conftest's 8 CPU devices, which decides the
reference of each comparison.

Sizes: FaceEnhanceNet G=2, B=2, C=16 (every weight perturbed off its init
from numpy, conv_last redrawn non-zero); HR 32 (LR 8: 4 LR rows a shard),
a global batch of 4; the GAN step at HR 64 with D at 64 (8 base channels,
BatchNorm, every parameter and running stat perturbed). Grids [1, 2, 2]
(4 ranks) and [2, 2, 2] (8 ranks), one launch each, one after the other
in a background thread that the parent's single-process and JAX runs
overlap; the children import torch and the port only, never JAX.

Tolerances (float32): a conv with half the output channels of half the
rows is not bitwise the whole conv's slice, and the clip's norm, the SE
and loss means and D's BatchNorm sums add in other orders, so each
quantity is held to max(1e-4, 10 x its rounding floor): how far the
single-process run moves with its input times (1 + 2^-23 N(0, 1)) (two
draws) or its convs summed in another order (oneDNN off), the largest
draw. Losses and metrics relatively, gradients and moments by relative L2
a tensor, parameters a tensor off their Adam ties (elements whose gradient
is within 10 x its rounding noise of zero: Adam's first step moves them by
~lr x a sign that rounding decides); GAN runs by part, as the tp and pp
GAN tests hold them. QAT runs pinned at fake-quant ties to the
single-process run's record (`step_numerics.grid_shard_levels`: cut to a
rank's rows and output channels), none off a tie. The port against JAX's
three-axis run: each quantity's gap at most the single-process port run's
gap to JAX's single-device run plus its limit, where JAX's three-axis run
holds to its own single device (JAX's own floor: two input draws): only
the content step on [2, 2, 2] (`JAX_HOLDS`). JAX's content step on [1, 2,
2] computes another forward (XLA's partition of rows and channels with
the batch whole) and its GAN step is off on both grids, so there the
port is held to JAX's single-device run. The ranks against each other
bitwise. The planted controls: the gradient mean over the whole group in
place of the `data` x `space` plane (the `model` ranks' different channel
slices of a split leaf added together), D's BatchNorm summed over the
whole group (every row t times: its running variance takes the wrong
unbiased factor) and a zero-filled halo on the gathered channels of every
split conv.
"""

import contextlib
import dataclasses
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr_torch.cli.step_numerics import RecordingAdamW
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models import discriminator as dmod
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.parallel import launch, tensor
from facesr_torch.parallel import mesh as pmesh
from facesr_torch.training import optim, steps

torch.set_num_threads(1)

G, B, C, HR, BATCH = 2, 2, 16, 32, 4
GAN_HR, D_BASE = 64, 8
LR, D_LR, GAN_WEIGHT, CLIP = 1e-4, 1e-4, 0.5, 0.5
QAT_LR = 1e-3
LOSS = dict(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1)
VGG_LOSS = dict(l1_weight=1.0, perceptual_weight=0.1, ssim_weight=0.1)
AXES = ("data", "space", "model")
GRIDS = {"1x2x2": (1, 2, 2), "2x2x2": (2, 2, 2)}
SEEDS = (10, 11)
GAN_SEEDS = (30, 31)
METRICS = ("loss", "d_loss", "g_adv", "d_real", "d_fake")
CONTROLS = ("grad_mean_over_the_whole_group", "bn_sum_over_the_whole_group",
            "zero_halo_on_the_gathered_channels")
BASE = 1e-4
FLOOR_FACTOR = 10
FLOOR_NOISE = 2.0 ** -23
FLOOR_DRAWS = (11, 12, "conv_order")
# where JAX's three-axis step holds to its single-device step (the port's
# reference there); elsewhere it is off and the port is held to JAX's single
# device: the content step at [1, 2, 2] computes another forward (its first
# loss 1.0075 against 0.5496), at [2, 2, 2] it holds off the Adam ties; the
# GAN step's losses are 0.45 apart on both grids
JAX_HOLDS = {("content", "2x2x2")}
ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# what the ranks and the parent both build (torch and numpy only)


def _model() -> FaceEnhanceNet:
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=C, num_groups=G,
                                                blocks_per_group=B), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            p.copy_(noise * 0.05 if name == "conv_last.weight" else p + noise * 0.02)
    return model


def _disc() -> dmod.Discriminator:
    """D at GAN_HR with every parameter and running stat moved off its init."""
    d = dmod.create_discriminator(input_size=GAN_HR, base_channels=D_BASE, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in d.parameters():
            p.add_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) * 0.05)
        for b in d.buffers():
            b.add_(torch.from_numpy(rng.random(b.shape).astype(np.float32)) * 0.1)
    return d


def _hr(seed, n=BATCH, size=HR) -> np.ndarray:
    """Smooth HR images in [0, 1]."""
    rng = np.random.default_rng(seed)
    lo = rng.random((n, size // 4, size // 4, 3), dtype=np.float32)
    return np.clip(np.kron(lo, np.ones((1, 4, 4, 1), np.float32))
                   + rng.normal(0, 0.02, (n, size, size, 3)), 0, 1).astype(np.float32)


def _np(named) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named}


def _rows(x: np.ndarray, mesh=None) -> torch.Tensor:
    """This rank's batch rows of a global batch (whole images: the steps
    take their image rows; all of it without a mesh)."""
    return torch.from_numpy(np.ascontiguousarray(x if mesh is None
                                                 else pmesh.shard_batch(x, mesh)))


def _noisy(x: torch.Tensor, noise, seed: int) -> torch.Tensor:
    if not isinstance(noise, int):
        return x
    gen = torch.Generator().manual_seed(noise + seed)
    return x * (1 + FLOOR_NOISE * torch.randn(x.shape, generator=gen))


def _order(noise):
    """oneDNN off for the "conv_order" draw (the convs summed otherwise)."""
    return (torch.backends.mkldnn.flags(enabled=False) if noise == "conv_order"
            else contextlib.nullcontext())


def _split_state(state, mesh):
    """Keep this rank's `model` slices of ``state``; returns the specs."""
    if mesh is None:
        return None
    specs = pmesh.tp_param_shardings(state, mesh)
    tensor.shard_state(state, mesh.model_shard(), specs)
    return specs


@contextlib.contextmanager
def _whole(state, mesh, specs):
    """The block sees ``state`` whole (a collective; no-op unsharded)."""
    if mesh is None:
        yield
        return
    shard = mesh.model_shard()
    tensor.unshard_state(state, shard, specs)
    try:
        yield
    finally:
        tensor.shard_state(state, shard, specs)


def _content_step(mesh=None, loss_cfg=LOSS):
    model = _model()
    loss = CombinedLoss(LossConfig(**loss_cfg), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=CLIP)
    state = steps.TrainState(model=model, opt_state=opt.init(steps.trainable_parameters(model),
                                                             LR),
                             loss_params=loss.params)
    apply = lambda lp, p, t: loss.apply(lp, p, t)  # noqa: E731
    step = steps.make_train_step(apply, opt, mesh=mesh)
    return state, opt, step, apply, _split_state(state, mesh)


def _run(mesh=None, loss_cfg=LOSS, seeds=SEEDS, noise=None):
    """Content steps on ``seeds`` (a rounding draw ``noise``): each step's
    loss and gradients (whole: `RecordingAdamW` gathers a rank's slices),
    then the whole parameters and moments."""
    state, opt, step, _, specs = _content_step(mesh, loss_cfg)
    out = {"losses": [], "grads": []}
    with _order(noise):
        for seed in seeds:
            _, m = step(state, _noisy(_rows(_hr(seed), mesh), noise, seed))
            out["losses"].append(float(m["loss"]))
            out["grads"].append({k: v.numpy() for k, v in opt.grads.items()})
            if mesh is not None and "exchanges" not in out:
                out["exchanges"] = {"space": dict(step.row_shard.counts),
                                    "model": dict(step.model_shard.counts)}
    with _whole(state, mesh, specs):
        out.update(params=_np(state.model.state_dict().items()),
                   mu=_np(state.opt_state["mu"].items()))
    return out


def _gan_run(mesh=None, noise=None, seeds=GAN_SEEDS):
    """GAN steps: each step's metrics, the first step's G and D gradients
    and the whole state after."""
    model, disc = _model(), _disc()
    loss = CombinedLoss(LossConfig(**LOSS), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=CLIP)
    d_opt = RecordingAdamW(weight_decay=1e-3, gradient_clip=0.0)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), LR),
                             loss_params=loss.params, disc=disc,
                             d_opt_state=d_opt.init(dict(disc.named_parameters()), D_LR))
    step = steps.make_gan_train_step(lambda lp, p, t: loss.apply(lp, p, t), opt, d_opt,
                                     gan_weight=GAN_WEIGHT, mesh=mesh)
    specs = _split_state(state, mesh)
    out = {"metrics": []}
    with _order(noise):
        for i, seed in enumerate(seeds):
            _, m = step(state, _noisy(_rows(_hr(seed, size=GAN_HR), mesh), noise, seed))
            out["metrics"].append({k: float(m[k]) for k in METRICS})
            if i == 0:
                out["g_grads"] = {k: v.numpy() for k, v in opt.grads.items()}
                out["d_grads"] = {k: v.numpy() for k, v in d_opt.grads.items()}
    with _whole(state, mesh, specs):
        out.update({"g": _np(state.model.state_dict().items()),
                    "d": _np(state.disc.state_dict().items()),
                    **{f"{who}_{m}": _np((st[m]).items())
                       for who, st in (("g", state.opt_state), ("d", state.d_opt_state))
                       for m in ("mu", "nu")}})
    return out


def _qat_step(mesh=None):
    from facesr_torch.ops.quant import fake_quant_params

    model = _model()
    sites = fake_quant_params(model)
    loss = CombinedLoss(LossConfig(**LOSS), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=CLIP)
    state = steps.TrainState(model=model,
                             opt_state=opt.init(dict(model.named_parameters()), QAT_LR),
                             loss_params=loss.params)
    apply = lambda lp, p, t: loss.apply(lp, p, t)  # noqa: E731
    specs = _split_state(state, mesh)
    return (state, opt, steps.make_train_step(apply, opt, quant_fn=lambda: sites, mesh=mesh),
            steps.make_eval_step(apply, quant_fn=lambda: sites, mesh=mesh), specs)


def _qat_run(ref=None, mesh=None, noise=None):
    """Two QAT steps and the eval step on fresh weights, each pinned at
    fake-quant ties to ``ref`` (the single-process run's record, cut to
    this rank's rows and output channels) or, without one, recorded."""
    from facesr_torch.cli.step_numerics import fake_quant_levels, grid_shard_levels

    state, opt, step, _, specs = _qat_step(mesh)
    batch = slice(None)
    if mesh is not None:
        per = BATCH // mesh.data_size
        batch = slice(mesh.axis_index("data") * per, (mesh.axis_index("data") + 1) * per)

    def pin(record, fn):
        if record is None:
            return None
        if mesh is None:
            return lambda i, w: (record["weights"][i], record["levels"][i], record["outputs"][i])
        return grid_shard_levels(record, fn.row_shard, fn.model_shard, batch)

    out = {"losses": [], "grads": []}
    with fake_quant_levels(pin(None if ref is None else ref["steps"], step)) as rec:
        for seed in SEEDS:
            _, m = step(state, _noisy(_rows(_hr(seed), mesh), noise, seed))
            out["losses"].append(float(m["loss"]))
            out["grads"].append({k: v.numpy() for k, v in opt.grads.items()})
    with _whole(state, mesh, specs):
        out.update(params=_np(state.model.state_dict().items()),
                   mu=_np(state.opt_state["mu"].items()))
    fresh, _, _, eval_step, _ = _qat_step(mesh)
    with fake_quant_levels(pin(None if ref is None else ref["eval"], eval_step)) as rec_eval:
        metrics, _, _ = eval_step(fresh, _rows(_hr(20), mesh))
    out["eval"] = {k: float(v) for k, v in metrics.items()}
    out["ties"] = rec["ties"] + rec_eval["ties"]
    out["off_tie"] = rec["off_tie"] + rec_eval["off_tie"]
    out["levels"] = sum(lv.numel() for r in (rec, rec_eval) for lv in r["levels"])
    if ref is None:
        out["record"] = {part: {"weights": [t.to(torch.int8) for t in r["weights"]],
                                "levels": [t.to(torch.int8) for t in r["levels"]],
                                "outputs": r["outputs"]}
                         for part, r in (("steps", rec), ("eval", rec_eval))}
    return out


@contextlib.contextmanager
def _planted(control):
    """A fault in the three-axis path, each still in its exchanges' graph
    (every rank runs the same collectives): the gradient mean over the
    whole group in place of the plane, D's BatchNorm summed over the whole
    group while its map is split, or every split conv's halo rows zeroed
    (the rows its whole-channel input takes over `space`)."""
    import torch.distributed as dist

    from facesr_torch.ops import conv as conv_ops
    from facesr_torch.ops.quant import FakeQuantWeight

    if control == "grad_mean_over_the_whole_group":
        owner, attr, real = steps, "_reduced", steps._reduced

        def value(grads, mesh):
            if mesh is None:
                return grads
            out = [g.to(memory_format=torch.contiguous_format, copy=True) for g in grads]
            for g in out:
                dist.all_reduce(g, group=mesh.group)
                g.div_(mesh.world_size)
            return out
    elif control == "bn_sum_over_the_whole_group":
        owner, attr, real = dmod, "_bn_sum", dmod._bn_sum

        def value(train, mesh, shard):
            if train and shard is not None and mesh is not None and mesh.distributed:
                return lambda t: pmesh._AllReduceSum.apply(t, mesh.group)
            return real(train, mesh, shard)
    else:
        owner, attr, real = conv_ops, "_halo_rows", conv_ops._halo_rows

        def value(shard, x, w, padding, stride):
            xh, pad = real(shard, x, w, padding, stride)
            extra = xh.shape[1] - x.shape[1]
            if not extra or not tensor.is_split(w.w if isinstance(w, FakeQuantWeight) else w):
                return xh, pad
            top = extra - extra // 2 if stride == 1 else extra  # 3x3: (1, 1), at stride 2 (1, 0)
            keep = torch.zeros(xh.shape[1], dtype=xh.dtype)
            keep[top:top + x.shape[1]] = 1
            return xh * keep.view(1, -1, 1, 1), pad

    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, real)


def _trainer(ckpt_dir, train, val, mesh=None, epochs=1, **cfg):
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    config = TrainerConfig(epochs=epochs, learning_rate=LR, weight_decay=1e-2,
                           gradient_clip=CLIP, use_amp=False, save_every=1,
                           checkpoint_dir=str(ckpt_dir), ema_decay=0.9, step_log_every=0,
                           scheduler_T_max=4, async_checkpoint=False, **cfg)
    return Trainer(_model(), train, val, CombinedLoss(LossConfig(**VGG_LOSS), device="cpu"),
                   config, device="cpu", mesh=mesh)


def _trainer_state(tr) -> dict:
    """A Trainer's parameters, moments, EMA and VGG, whole (a collective
    under `model`)."""
    with tr.whole_state():
        return {"params": _np(tr.model.state_dict().items()),
                "mu": _np(tr.state.opt_state["mu"].items()),
                "nu": _np(tr.state.opt_state["nu"].items()),
                "ema": _np(tr.state.ema_params.items()),
                "vgg": _np((f"{i}.{k}", v) for i, p in enumerate(tr.loss_fn.params["vgg"])
                           for k, v in p.items())}


TRAIN_BATCHES = [_hr(40 + i) for i in range(2)]
VAL_BATCHES = [_hr(50)]


def _trainers(mesh, tmp):
    """A three-axis Trainer epoch (rank 0 writes); a single-process file
    resumed fully by a 2-epoch three-axis Trainer, which trains epoch 2;
    the memory report; the overfit helper."""
    from facesr_torch.training.trainer import overfit_test
    from facesr_torch.utils.profiling import tensor_bytes

    own = Path(tmp) / f"rank{mesh.rank}"
    train = [{"hr": pmesh.shard_batch(b, mesh)} for b in TRAIN_BATCHES]
    val = [{"hr": pmesh.shard_batch(b, mesh)} for b in VAL_BATCHES]
    grid = dict(mesh_axes=",".join(AXES), mesh_shape=mesh.shape)
    out = {}
    tr = _trainer(own / "grid", train, val, mesh, **grid)
    out["history"] = tr.train()
    out["writer"] = tr.is_writer
    out["stops_at_step_boundary"] = tr.stops_at_step_boundary
    out["trainer_state"] = _trainer_state(tr)
    tr._restore_payload(tr._checkpoint_payload())  # memory_report's snapshot and restore
    out["revalidated"] = tr._validate_epoch()
    out["report"] = tr.memory_report(BATCH, HR, echo=False)
    out["model_bytes"] = tensor_bytes(tr.model)
    single = _trainer(own / "single", [{"hr": b} for b in TRAIN_BATCHES],
                      [{"hr": b} for b in VAL_BATCHES], mesh=pmesh.Mesh((torch.device("cpu"),)))
    single.train()
    resumed = _trainer(own / "resumed", train, val, mesh, epochs=2, **grid)
    resumed.load_checkpoint(str(own / "single" / "final_model.fckpt"))
    got, want = _trainer_state(resumed), _trainer_state(single)
    out["restored"] = all(np.array_equal(got[p][k], v) for p in want for k, v in want[p].items())
    out["resumed_history"] = resumed.train()
    out["resumed_state"] = _trainer_state(resumed)
    out["overfit"] = overfit_test(_model(), [{"hr": TRAIN_BATCHES[0]}], num_images=BATCH,
                                  num_iterations=2, mesh=mesh)["loss_history"]
    return out


def _groups(mesh) -> dict:
    """The ranks of this rank's group along each axis and of its plane."""
    import torch.distributed as dist

    return {k: sorted(dist.get_process_group_ranks(g)) for k, g in mesh.axis_groups.items()}


def _other_order(mesh):
    """The same ranks as a `data,model,space` grid (shape (d, t, s)): its
    coordinates, groups and two content steps."""
    d, s, t = mesh.shape
    flat = dataclasses.replace(mesh, axis_names=("data",), shape=None, axis_groups=None)
    other = pmesh._grid(flat, ("data", "model", "space"), (d, t, s), pmesh.DEFAULT_TIMEOUT_S)
    return {"coords": tuple(other.axis_index(a) for a in AXES), "groups": _groups(other),
            "content": _run(other)}


def _worker(mesh, tmp, extras, qat_ref):
    """Everything a rank of one grid runs, in one launch."""
    torch.set_num_threads(1)
    out = {"rank": mesh.rank, "coords": tuple(mesh.axis_index(a) for a in AXES),
           "groups": _groups(mesh), "sum_size": mesh.sum_size}
    out["content"] = _run(mesh)
    state, _, _, apply, _ = _content_step(mesh)
    metrics, sr, _ = steps.make_eval_step(apply, mesh=mesh)(state, _rows(_hr(20), mesh))
    out["eval"] = {k: float(v) for k, v in metrics.items()}
    out["eval_rows"] = tuple(sr.shape)
    out["vgg"] = _run(mesh, VGG_LOSS, seeds=SEEDS[:1])
    out["gan"] = _gan_run(mesh)
    out["qat"] = _qat_run(qat_ref, mesh)
    if "controls" in extras:
        out["controls"] = {}
        for control in CONTROLS:
            with _planted(control):
                out["controls"][control] = (_gan_run(mesh) if control.startswith("bn") else
                                            _run(mesh, VGG_LOSS, seeds=SEEDS[:1]))
        out["other_order"] = _other_order(mesh)
        out.update(_trainers(mesh, tmp))
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both grids' ranks, one grid after the other in a background thread,
    so that the parent's single-process and JAX runs overlap them: a future
    of (each grid's results, the launch directory), and the single-process
    QAT run the ranks are pinned to."""
    tmp = tmp_path_factory.mktemp("sp_tp")
    qat = _qat_run()
    sent = qat.pop("record")

    def run():
        out = {}
        for name, shape in GRIDS.items():
            n = math.prod(shape)
            extras = ("controls",) if name == "1x2x2" else ()
            out[name] = launch.run_ranks(_worker, n, args=(str(tmp / name), extras, sent),
                                         devices=["cpu"] * n, timeout=120, run_timeout=500,
                                         axis_names=AXES, shape=shape)
        return out, tmp

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run), (qat, sent)


# ---------------------------------------------------------------------------
# errors and limits


def _rel_l2(got, want, base=None) -> float:
    """||got - want|| / ||want - base|| over every tensor of two same-keyed
    dicts together (``base`` None: / ||want||); arrays for one tensor."""
    if not isinstance(want, dict):
        got, want, base = {"": got}, {"": want}, None if base is None else {"": base}
    num = sum(float(((np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)) ** 2)
                    .sum()) for k in want)
    den = sum(float(((np.asarray(want[k], np.float64)
                      - (0 if base is None else np.asarray(base[k], np.float64))) ** 2).sum())
              for k in want)
    return math.sqrt(num / max(den, 1e-300))


def _ties(want, draws, grads="grads") -> dict:
    """Per parameter, the elements whose gradient (any step's) lies within
    FLOOR_FACTOR x its rounding noise (the largest |draw - want|) of zero."""
    out = {}
    for i, g in enumerate(want[grads] if grads == "grads" else [want[grads]]):
        for k, v in g.items():
            noise = np.max([np.abs((d[grads][i] if grads == "grads" else d[grads])[k] - v)
                            for d in draws], axis=0)
            out[k] = (np.abs(v) <= FLOOR_FACTOR * noise) | out.get(k, False)
    return out


def _off(a, tie):
    return np.asarray(a)[~tie] if tie is not None else a


def _errors(got, want, ties=None) -> dict:
    """Each quantity's error of a content record against another: the
    losses relatively, the gradients and moments by relative L2 a tensor,
    the parameters a tensor off their ties (and the eval metrics
    relatively, where recorded)."""
    ties = ties or {}
    out = {f"loss{i}": abs(a - b) / abs(b) for i, (a, b) in
           enumerate(zip(got["losses"], want["losses"]))}
    for i, grads in enumerate(want.get("grads", [])):
        out.update({f"grads{i}.{k}": _rel_l2(got["grads"][i][k], v) for k, v in grads.items()})
    out.update({f"params.{k}": _rel_l2(_off(got["params"][k], ties.get(k)),
                                       _off(v, ties.get(k))) for k, v in want["params"].items()})
    if "mu" in want:
        out.update({f"mu.{k}": _rel_l2(got["mu"][k], v) for k, v in want["mu"].items()})
    if "eval" in want:
        out.update({f"eval.{k}": abs(got["eval"][k] - v) / abs(v)
                    for k, v in want["eval"].items()})
    return out


def _split(sd):
    """A D state dict's parameters and running stats apart."""
    return ({k: v for k, v in sd.items() if "running" not in k},
            {k: v for k, v in sd.items() if "running" in k})


def _gan_errors(got, want, ties=None, grads=True) -> dict:
    """How far a GAN run is from another: each step's metrics (the largest
    relative error), the first step's gradients a tensor (``grads``), G's
    and D's parameters over their update off their ties, D's running
    stats and the four moments by relative L2 over a part."""
    ties = ties or {}
    g0 = _np(_model().state_dict().items())
    d0 = _split(_np(_disc().state_dict().items()))[0]
    (d_got, s_got), (d_want, s_want) = _split(got["d"]), _split(want["d"])
    errs = {f"step {i}": max(abs(a[k] - b[k]) / abs(b[k]) for k in METRICS)
            for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"]))}
    if grads:
        for part in ("g_grads", "d_grads"):
            errs.update({f"{part}.{k}": _rel_l2(got[part][k], v)
                         for k, v in want[part].items()})
    off = lambda sd, part: {k: _off(v, ties.get((part, k))) for k, v in sd.items()}  # noqa: E731
    errs.update({"G": _rel_l2(off(got["g"], "g"), off(want["g"], "g"), off(g0, "g")),
                 "D": _rel_l2(off(d_got, "d"), off(d_want, "d"), off(d0, "d")),
                 "BN stats": _rel_l2(s_got, s_want),
                 **{k: _rel_l2(got[k], want[k]) for k in ("g_mu", "g_nu", "d_mu", "d_nu")
                    if k in want}})
    return errs


def _limits(errors_of_draws) -> dict:
    return {k: max(BASE, FLOOR_FACTOR * max(e[k] for e in errors_of_draws))
            for k in errors_of_draws[0]}


def _over(errors, limits) -> dict:
    return {k: (e, limits[k]) for k, e in errors.items() if e > limits[k]}


@pytest.fixture(scope="module")
def single(launched):
    """The single-process runs, their Adam ties and each quantity's limit:
    the content step (two steps), the VGG step (one), the GAN step (two)
    and the QAT steps pinned to their own record (two, and the eval)."""
    out = {}
    for key, kw in (("content", {}), ("vgg", dict(loss_cfg=VGG_LOSS, seeds=SEEDS[:1]))):
        want = _run(**kw)
        draws = [_run(noise=n, **kw) for n in FLOOR_DRAWS]
        ties = _ties(want, draws)
        out[key] = (want, _limits([_errors(d, want, ties) for d in draws]), ties)
    want = _gan_run()
    draws = [_gan_run(noise=n) for n in FLOOR_DRAWS]
    ties = {**{("g", k): v for k, v in _ties(want, draws, "g_grads").items()},
            **{("d", k): v for k, v in _ties(want, draws, "d_grads").items()}}
    out["gan"] = (want, _limits([_gan_errors(d, want, ties) for d in draws]), ties)
    want, record = launched[1]
    draws = [_qat_run(record, noise=n) for n in FLOOR_DRAWS[:2]]
    ties = _ties(want, draws)
    out["qat"] = (want, _limits([_errors(d, want, ties) for d in draws]), ties)
    return out


def _jax_runs():
    """JAX's content steps (two, L1 + SSIM, HR 32) and GAN steps (two, D at
    64): single-device (with two input-noise draws each) and on the
    ("data", "space", "model") grids of the conftest's CPU devices, the
    whole state placed by JAX's `tp_param_shardings` over `model` and the
    batch by its `grid_sharding`, each run in the port's layouts."""
    import jax
    import jax.numpy as jnp

    from facesr.losses import combined as jcombined
    from facesr.models import discriminator as jdisc
    from facesr.models import face_enhance_net as fen
    from facesr.parallel import get_mesh, grid_sharding
    from facesr.parallel import tp_param_shardings as jax_tp
    from facesr.training import steps as jsteps
    from facesr_torch.ckpt.weights import (discriminator_state_dict_from_jax,
                                           jax_discriminator_from_state_dict, jax_params_from,
                                           state_dict_from_jax_params)

    tree_np = lambda tree: jax.tree.map(np.asarray, jax.device_get(tree))  # noqa: E731
    g_sd = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                         state_dict_from_jax_params(tree_np(tree)).items()}
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    apply = lambda p, x, train, dtype: fen.apply(p, x, cfg, train=train, dtype=dtype)  # noqa
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**LOSS), seed=0)
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=CLIP)
    tx_d = jsteps.make_optimizer(weight_decay=1e-3, gradient_clip=0.0)
    dcfg = jdisc.DiscriminatorConfig(in_channels=3, base_channels=D_BASE, input_size=GAN_HR)
    params = jax.tree.map(jnp.asarray, jax_params_from(_model()))
    dparams, dstats = jax.tree.map(jnp.asarray,
                                   jax_discriminator_from_state_dict(_disc().state_dict()))

    def content_record(state, metrics):
        return {"losses": [m["loss"] for m in metrics], "params": g_sd(state.params)}

    def gan_record(state, metrics):
        stats = tree_np(state.d_stats)
        d = lambda tree: {k: v.numpy() for k, v in discriminator_state_dict_from_jax(  # noqa
            tree_np(tree), stats).items()}
        adam = lambda tree: next(t for t in jax.tree.leaves(  # noqa: E731
            tree, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(t, "mu"))
        strip = lambda sd: {k: v for k, v in sd.items() if "running" not in k}  # noqa: E731
        g_adam, d_adam = adam(state.opt_state), adam(state.d_opt_state)
        return {"metrics": [{k: m[k] for k in METRICS} for m in metrics], "g": g_sd(state.params),
                "d": d(state.d_params), "g_mu": g_sd(g_adam.mu), "g_nu": g_sd(g_adam.nu),
                "d_mu": strip(d(d_adam.mu)), "d_nu": strip(d(d_adam.nu))}

    kinds = {
        "content": (jsteps.make_train_step(apply, jloss.apply, tx, scale_factor=4),
                    lambda: jsteps.TrainState(
                        step=jnp.asarray(0), params=params,
                        opt_state=jsteps.set_learning_rate(tx.init(params), LR),
                        loss_params=jloss.params),
                    SEEDS, HR, content_record),
        "gan": (jsteps.make_gan_train_step(
                    apply, jloss.apply,
                    lambda p, st, x, train: jdisc.apply(p, st, x, dcfg, train=train),
                    tx, tx_d, gan_weight=GAN_WEIGHT),
                lambda: jsteps.TrainState(
                    step=jnp.asarray(0), params=params,
                    opt_state=jsteps.set_learning_rate(tx.init(params), LR),
                    loss_params=jloss.params, d_params=dparams, d_stats=dstats,
                    d_opt_state=jsteps.set_learning_rate(tx_d.init(dparams), D_LR)),
                GAN_SEEDS, GAN_HR, gan_record),
    }
    out = {}
    for kind, (fn, fresh, seeds, size, record) in kinds.items():
        for grid in (None,) + tuple(GRIDS):
            step, put, state = jax.jit(fn), jnp.asarray, fresh()
            if grid is not None:
                shape = GRIDS[grid]
                mesh = get_mesh(jax.devices()[:math.prod(shape)], axis_names=AXES, shape=shape)
                sh, batch = jax_tp(state, mesh, axis="model"), grid_sharding(mesh)
                step = jax.jit(fn, in_shardings=(sh, batch), out_shardings=(sh, None))
                state = jax.device_put(state, sh)
                put = lambda x, batch=batch: jax.device_put(x, batch)  # noqa: E731
            for noise in ((None,) if grid is not None else (None, 11, 12)):
                st, metrics = state, []
                for seed in seeds:
                    x = _hr(seed, size=size)
                    if noise is not None:
                        x = (x * (1 + FLOOR_NOISE * np.random.default_rng(noise + seed)
                                  .standard_normal(x.shape))).astype(np.float32)
                    st, m = step(st, put(x))
                    metrics.append({k: float(v) for k, v in m.items()})
                out[kind, grid, noise] = record(st, metrics)
    return out


@pytest.fixture(scope="module")
def jax_runs(launched):
    return _jax_runs()


def _cli_files(tmp):
    """4 train PNGs at 40, 2 val pairs at 32 and 8, and the stage-1 YAML at
    G=1, B=2, C=16, batch 2, HR 32 (``tmp/s1.yaml``) under ``tmp``."""
    from facesr_torch.data import png
    from facesr_torch.data.cv_compat import resize_cubic

    rng = np.random.default_rng(0)
    for split, n, size in (("train", 4, 40), ("val", 2, 32)):
        (tmp / "data" / split / "HR").mkdir(parents=True)
        if split == "val":
            (tmp / "data" / split / "LR").mkdir()
        for i in range(n):
            img = resize_cubic((rng.random((5, 5, 3)) * 255).astype(np.uint8), (size, size))
            png.write_png(tmp / "data" / split / "HR" / f"{i:03d}.png", img)
            if split == "val":
                png.write_png(tmp / "data" / split / "LR" / f"{i:03d}.png",
                              resize_cubic(img, (8, 8)))
    text = (ROOT / "configs" / "stages" / "stage1_psnr_config.yaml").read_text()
    for old, new in (("num_channels: 64", "num_channels: 16"), ("num_groups: 6", "num_groups: 1"),
                     ("blocks_per_group: 10", "blocks_per_group: 2"),
                     ("batch_size: 48", "batch_size: 2"), ("num_workers: 16", "num_workers: 1"),
                     ("hr_patch_size: 256", "hr_patch_size: 32")):
        assert old in text, old
        text = text.replace(old, new)
    (tmp / "s1.yaml").write_text(text)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The train CLI on data,space,model [1, 2, 2] with --print-memory,
    started before the launches are awaited (a plain launch starts its 4
    ranks)."""
    tmp = tmp_path_factory.mktemp("sp_tp_cli")
    _cli_files(tmp)
    proc = subprocess.Popen(
        [sys.executable, "-m", "facesr_torch.cli.train", "--config", str(tmp / "s1.yaml"),
         "--data-root", str(tmp / "data"), "--device", "cpu", "--epochs", "1",
         "--mesh-axes", "data,space,model", "--mesh-shape", "1,2,2", "--print-memory", "--yes"],
        cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp), "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT)})
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()


HISTORY = ("train_loss", "val_loss", "val_psnr", "val_ssim")


def _single_trainer_run(tmp, resume=None, noise=None):
    """The single-process Trainer (inputs times (1 + 2^-23 N(0, 1)) with a
    ``noise`` seed): one epoch, or with ``resume`` a full resume of that
    file and its second epoch."""
    def batches(arrays, k):
        if noise is None:
            return [{"hr": b} for b in arrays]
        rng = np.random.default_rng(noise + k)
        return [{"hr": (b * (1 + FLOOR_NOISE * rng.standard_normal(b.shape))).astype(np.float32)}
                for b in arrays]

    tr = _trainer(tmp, batches(TRAIN_BATCHES, 0), batches(VAL_BATCHES, 100),
                  epochs=1 if resume is None else 2)
    if resume is not None:
        tr.load_checkpoint(str(resume))
    return tr.train(), _trainer_state(tr)


def _trainer_limits(tmp, resume=None):
    history, state = _single_trainer_run(tmp / "clean", resume)
    draws = [_single_trainer_run(tmp / f"noise{n}", resume, n) for n in FLOOR_DRAWS[:2]]
    limits = {k: max(BASE, FLOOR_FACTOR * max(
        float(np.max(np.abs(np.subtract(h[k], history[k])) / np.abs(history[k])))
        for h, _ in draws)) for k in HISTORY}
    for part, tensors in state.items():
        for k, v in tensors.items():
            limits[part, k] = max(BASE, FLOOR_FACTOR * max(_rel_l2(st[part][k], v)
                                                           for _, st in draws))
    return history, state, limits


@pytest.fixture(scope="module")
def single_trainer(launched, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_tp_single")
    epoch = _trainer_limits(tmp / "epoch")
    resumed = _trainer_limits(tmp / "resumed", resume=tmp / "epoch" / "clean" / "final_model.fckpt")
    return {"epoch": epoch, "resumed": resumed}


@pytest.fixture(scope="module")
def ranks(launched, single, jax_runs, cli_run, single_trainer):
    """`launched`'s results, awaited once the parent's runs are done."""
    return launched[0].result()


def _check_run(history, state, want_history, want_state, limits):
    for k in HISTORY:
        np.testing.assert_allclose(history[k], want_history[k], rtol=limits[k], err_msg=k)
    for part, tensors in want_state.items():
        for k, v in tensors.items():
            assert _rel_l2(state[part][k], v) <= limits[part, k], (part, k)


# ---------------------------------------------------------------------------
# the grid


def _fake(shape, rank, axes=AXES):
    return pmesh.Mesh((torch.device("cpu"),), group=object(), rank=rank,
                      world_size=math.prod(shape), axis_names=axes, shape=shape,
                      axis_groups={a: object() for a in axes + ("plane",)})


@pytest.mark.parametrize("axes", [AXES, ("data", "model", "space")])
def test_a_three_axis_grid_places_rank_r_at_its_row_major_coordinates(axes):
    """Rank r of a (d, k, l) grid sits at np.unravel_index(r, shape), as
    JAX's `get_mesh` reshapes its devices; the lines along each axis and
    the `data` x `space` planes hold the ranks that share the other
    coordinates; the sums run over the plane (d * s ranks)."""
    shape = (2, 2, 2) if axes == AXES else (2, 3, 2)
    n = math.prod(shape)
    for r in range(n):
        mesh = _fake(shape, r, axes)
        want = np.unravel_index(r, shape)
        assert tuple(mesh.axis_index(a) for a in axes) == tuple(int(v) for v in want)
        assert mesh.data_size == shape[0] and mesh.axis_size(axes[2]) == shape[2]
        assert mesh.sum_size == shape[0] * mesh.axis_size("space")
        assert mesh.sum_group is mesh.axis_groups["plane"]
    for axis in range(3):
        lines = pmesh._lines(shape, axis)
        assert sorted(r for line in lines for r in line) == list(range(n))
        for line in lines:
            coords = [np.unravel_index(r, shape) for r in line]
            assert [c[axis] for c in coords] == list(range(shape[axis]))
            assert len({tuple(np.delete(c, axis)) for c in coords}) == 1


def test_shard_batch_and_grid_sharding_split_the_batch_and_the_rows_on_three_axes():
    x = np.arange(4 * 8 * 2, dtype=np.float32).reshape(4, 8, 2, 1)
    for r in range(8):
        mesh = _fake((2, 2, 2), r)
        i, j, _ = np.unravel_index(r, (2, 2, 2))
        assert np.array_equal(pmesh.shard_batch(x, mesh), x[2 * i:2 * i + 2])
        got = pmesh.shard_batch({"hr": x}, pmesh.grid_sharding(mesh))["hr"]
        assert pmesh.grid_sharding(mesh).spec == ("data", "space")
        assert np.array_equal(got, x[2 * i:2 * i + 2, 4 * j:4 * j + 4])  # whole over model
    with pytest.raises(ValueError, match="image height 7 must divide over the 2-way"):
        pmesh.shard_batch(x[:, :7], pmesh.grid_sharding(mesh))
    serving = pmesh.get_mesh(["cpu"] * 8, axis_names=AXES, shape=(2, 2, 2))
    assert serving.shape == (2, 2, 2) and serving.data_size == 2 and not serving.distributed
    assert pmesh.get_mesh(["cpu"] * 4, axis_names=AXES).shape == (4, 1, 1)
    with pytest.raises(ValueError, match="needs 8 devices"):
        pmesh.get_mesh(["cpu"] * 4, axis_names=AXES, shape=(2, 2, 2))


@pytest.mark.parametrize("axes", [("data", "space", "model", "pp"), ("data", "model", "pp"),
                                  ("data", "space", "pp"), ("data", "space", "model", "model")])
def test_pp_with_space_or_model_and_a_repeated_axis_are_refused(axes):
    with pytest.raises(ValueError, match="cannot combine|name an axis twice"):
        pmesh.check_mesh_axes(axes)
    pmesh.check_mesh_axes(AXES, (1, 2, 2))
    pmesh.check_mesh_axes(("data", "model", "space"), (1, 2, 2))
    assert "compositions" not in pmesh.ROADMAP_ITEMS


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_each_rank_joins_the_lines_and_the_plane_of_its_coordinates(ranks, grid):
    shape = GRIDS[grid]
    n = math.prod(shape)
    for r in ranks[0][grid]:
        coords = np.unravel_index(r["rank"], shape)
        assert r["coords"] == tuple(int(c) for c in coords)
        for axis, name in enumerate(AXES):
            want = [q for q in range(n) if all(np.unravel_index(q, shape)[a] == coords[a]
                                               for a in range(3) if a != axis)]
            assert r["groups"][name] == want, name
        plane = [q for q in range(n) if np.unravel_index(q, shape)[2] == coords[2]]
        assert r["groups"]["plane"] == plane and r["sum_size"] == shape[0] * shape[1]


def test_the_data_model_space_order_builds_its_grid_and_trains_as_one_process(ranks, single):
    """The same four ranks as a `data,model,space` [1, 2, 2] grid: rank r at
    (0, r // 2, r % 2) in that order, so its `space` index is r % 2; its
    groups by those coordinates; two content steps within the limits."""
    want, limits, ties = single["content"]
    for r in ranks[0]["1x2x2"]:
        other = r["other_order"]
        d, t, s = np.unravel_index(r["rank"], (1, 2, 2))
        assert other["coords"] == (d, s, t)
        assert other["groups"]["model"] == [q for q in range(4) if q % 2 == s]
        assert other["groups"]["space"] == [q for q in range(4) if q // 2 == t]
        assert other["groups"]["plane"] == other["groups"]["space"]
        errors = _errors(other["content"], want, ties)
        assert not _over(errors, limits), _over(errors, limits)


# ---------------------------------------------------------------------------
# JAX's own three-axis steps


def _jax_limits(jax_runs, kind, ties):
    """JAX's single-device run and each quantity's limit: max(BASE, 10 x its
    own floor of two input draws), parameters off the port's Adam ties."""
    want = jax_runs[kind, None, None]
    errs = [(_gan_errors(jax_runs[kind, None, n], want, ties, grads=False) if kind == "gan"
             else _errors(jax_runs[kind, None, n], want, ties)) for n in (11, 12)]
    return want, _limits(errs)


@pytest.mark.parametrize("kind,grid", [(k, g) for k in ("content", "gan") for g in sorted(GRIDS)])
def test_jaxs_three_axis_step_is_a_reference_where_it_matches_its_single_device_step(
        jax_runs, single, kind, grid):
    """JAX's step with the whole state (G, and for the GAN step D, D's stats
    and both optimisers) placed by its `tp_param_shardings` and the batch
    by its `grid_sharding`, against its single-device step, parameters off
    the port's Adam ties: within its limits exactly where `JAX_HOLDS`
    says, so each port comparison below takes the reference stated
    there."""
    ties = single[kind][2]
    want, limits = _jax_limits(jax_runs, kind, ties)
    got = jax_runs[kind, grid, None]
    errors = (_gan_errors(got, want, ties, grads=False) if kind == "gan"
              else _errors(got, want, ties))
    over = _over(errors, limits)
    assert bool(over) == ((kind, grid) not in JAX_HOLDS), over


# ---------------------------------------------------------------------------
# the port's steps on the three axes


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_three_axis_content_steps_match_the_single_process_steps(ranks, single, grid):
    want, limits, ties = single["content"]
    for r in ranks[0][grid]:
        errors = _errors(r["content"], want, ties)
        assert not _over(errors, limits), _over(errors, limits)
        assert len(errors) == len(limits) > 100
        # a step: every split conv's output gathered over `model` and its
        # halo rows taken over `space`; the SE and loss means summed over `space`
        space, model = r["content"]["exchanges"]["space"], r["content"]["exchanges"]["model"]
        assert space["halo"] > 0 and space["sum"] > 0 and model["gather"] > 0
        assert model["copy"] > 0 and model["mean"] == 1


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_the_three_axis_step_with_the_vgg_loss_and_the_clip_matches_the_single_process_step(
        ranks, single, grid):
    want, limits, ties = single["vgg"]
    assert float(optim.global_norm({k: torch.from_numpy(v) for k, v in want["grads"][0].items()},
                                   {})) > CLIP  # the clip is active
    for r in ranks[0][grid]:
        errors = _errors(r["vgg"], want, ties)
        assert not _over(errors, limits), _over(errors, limits)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_three_axis_content_steps_match_jaxs_reference(ranks, single, jax_runs, grid):
    """Each quantity's gap to JAX's reference run (`JAX_HOLDS`: its
    three-axis run, or its single-device run where that is off) at most
    the single-process port run's gap to JAX's single-device run plus its
    limit."""
    want, limits, ties = single["content"]
    own_gap = _errors(want, jax_runs["content", None, None], ties)
    ref = jax_runs["content", grid if ("content", grid) in JAX_HOLDS else None, None]
    for r in ranks[0][grid]:
        gap = _errors(r["content"], ref, ties)
        over = {k: (v, own_gap[k] + limits[k]) for k, v in gap.items()
                if v > own_gap[k] + limits[k]}
        assert not over, over


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_three_axis_gan_steps_match_the_single_process_steps(ranks, single, grid):
    want, limits, ties = single["gan"]
    for r in ranks[0][grid]:
        errors = _gan_errors(r["gan"], want, ties)
        assert not _over(errors, limits), _over(errors, limits)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_three_axis_gan_steps_match_jaxs_reference(ranks, single, jax_runs, grid):
    """Each quantity's gap to JAX's reference GAN run (`JAX_HOLDS`: its
    single-device run on both grids) at most the single-process port run's
    gap to JAX's single-device run plus its limit."""
    want, limits, ties = single["gan"]
    own_gap = _gan_errors(want, jax_runs["gan", None, None], ties, grads=False)
    ref = jax_runs["gan", grid if ("gan", grid) in JAX_HOLDS else None, None]
    for r in ranks[0][grid]:
        gap = _gan_errors(r["gan"], ref, ties, grads=False)
        over = {k: (v, own_gap[k] + limits[k]) for k, v in gap.items()
                if v > own_gap[k] + limits[k]}
        assert not over, over


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_three_axis_qat_steps_pinned_at_ties_match_the_single_process_steps(ranks, single,
                                                                           grid):
    """Two QAT steps and the eval step on each rank, pinned at ties to the
    single-process run (cut to the rank's rows and output channels): no
    level or sign off a tie, ties at most 1e-4 of the levels; each
    quantity within its limit."""
    want, limits, ties = single["qat"]
    for r in ranks[0][grid]:
        got = r["qat"]
        assert got["off_tie"] == 0 and got["ties"] <= 1e-4 * got["levels"], \
            (got["ties"], got["off_tie"], got["levels"])
        errors = _errors(got, want, ties)
        assert not _over(errors, limits), _over(errors, limits)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_the_three_axis_eval_step_matches_the_single_process_eval_step(ranks, grid):
    d, s, _ = GRIDS[grid]
    state, _, _, apply, _ = _content_step()
    want, _, _ = steps.make_eval_step(apply)(state, torch.from_numpy(_hr(20)))
    for r in ranks[0][grid]:
        assert r["eval_rows"] == (BATCH // d, HR // s, HR, 3)  # this rank's image rows
        for k, v in want.items():
            np.testing.assert_allclose(r["eval"][k], float(v), rtol=BASE, err_msg=k)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_every_rank_of_the_grid_holds_bitwise_the_same_gathered_state(ranks, grid):
    out = ranks[0][grid]
    for key in ("content", "vgg", "gan", "qat"):
        for r in out[1:]:
            for part in ("params", "mu", "g", "d", "g_mu", "d_mu", "d_nu"):
                if part in out[0][key]:
                    assert all(np.array_equal(r[key][part][k], v)
                               for k, v in out[0][key][part].items()), (key, part)


@pytest.mark.parametrize("control", CONTROLS)
def test_each_planted_control_is_rejected(ranks, single, control):
    """The gradient mean over the whole group and the zero halo put many of
    G's gradients or moments over their limits. D's BatchNorm summed over
    the whole group counts every row t times in its sums and in its count,
    so its mean and variance, and the gradients, come out right; its count
    t times too large gives the running variance another unbiased factor
    (at D's last split BatchNorm, 2 rows a rank: 32/31 in place of 16/15),
    which puts D's running stats over ten times their limit."""
    r = ranks[0]["1x2x2"][0]["controls"][control]
    if control.startswith("bn"):
        want, limits, ties = single["gan"]
        over = _over(_gan_errors(r, want, ties), limits)
        assert "BN stats" in over and over["BN stats"][0] > 10 * limits["BN stats"], over
        return
    want, limits, ties = single["vgg"]
    over = _over(_errors(r, want, ties), limits)
    assert sum(k.startswith(("grads0.", "mu.")) for k in over) > 10, (control, len(over))


# ---------------------------------------------------------------------------
# the Trainer, its checkpoints, the overfit helper and the CLI


def test_a_three_axis_trainer_epoch_writes_on_rank0_only_and_equals_the_single_process_one(
        ranks, single_trainer):
    from facesr_torch.ckpt.weights import read_state_dict

    out, tmp = ranks[0]["1x2x2"], ranks[1] / "1x2x2"
    assert [r["writer"] for r in out] == [True, False, False, False]
    assert all(r["stops_at_step_boundary"] for r in out)
    assert not any((tmp / f"rank{q}" / "grid").exists() for q in (1, 2, 3))
    files = {p.name for p in (tmp / "rank0" / "grid").iterdir()}
    assert {"final_model.fckpt", "final_model.pth", "best_model.fckpt"} <= files
    for r in out:
        _check_run(r["history"], r["trainer_state"], *single_trainer["epoch"])
        assert r["revalidated"] == {k: r["history"][f"val_{k}"][-1]
                                    for k in ("loss", "psnr", "ssim")}
        for part, tensors in out[0]["trainer_state"].items():
            assert all(np.array_equal(v, r["trainer_state"][part][k])
                       for k, v in tensors.items()), part
    model = _model()
    model.load_state_dict(read_state_dict(str(tmp / "rank0" / "grid" / "final_model.pth")),
                          strict=True)
    assert all(np.array_equal(v.numpy(), out[0]["trainer_state"]["params"][k])
               for k, v in model.state_dict().items())


def test_a_three_axis_trainer_file_resumes_in_one_process_and_in_the_jax_trainer(ranks,
                                                                                tmp_path):
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from facesr.losses import combined as jcombined
    from facesr.models import face_enhance_net as fen
    from facesr.training.trainer import Trainer as JaxTrainer
    from facesr.training.trainer import TrainerConfig as JaxTrainerConfig
    from facesr_torch.ckpt import fckpt
    from facesr_torch.ckpt.weights import jax_params_from, state_dict_from_jax_params

    out, tmp = ranks[0]["1x2x2"], ranks[1] / "1x2x2"
    path = tmp / "rank0" / "grid" / "final_model.fckpt"
    back = _trainer(tmp_path / "back", [{"hr": TRAIN_BATCHES[0]}], [])
    back.load_checkpoint(str(path))
    got, want = _trainer_state(back), out[0]["trainer_state"]
    for part, tensors in want.items():
        assert all(np.array_equal(got[part][k], v) for k, v in tensors.items()), part
    assert back.current_epoch == 1 and back.state.step == len(TRAIN_BATCHES)
    back.config.epochs = 2
    history = back.train()  # and trains
    assert back.state.step == len(TRAIN_BATCHES) + 1 and math.isfinite(history["train_loss"][-1])

    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    jt = JaxTrainer(fen.FaceEnhanceNet(cfg, params=jax.tree.map(jnp.asarray,
                                                                jax_params_from(_model()))),
                    [], [], jcombined.CombinedLoss(jcombined.LossConfig(**VGG_LOSS), seed=1),
                    config=JaxTrainerConfig(epochs=1, learning_rate=LR, weight_decay=1e-2,
                                            gradient_clip=CLIP, use_amp=False, ema_decay=0.9,
                                            checkpoint_dir=str(tmp_path / "jax"),
                                            log_dir=str(tmp_path / "jax_logs"),
                                            use_wandb=False, step_log_every=0))
    jt.load_checkpoint(str(path))
    host = serialization.to_state_dict(jax.tree.map(np.asarray, jt.state))
    tree, _ = fckpt.load_checkpoint(str(path))
    for k, v in state_dict_from_jax_params(fckpt.restore_list_nodes(host["params"])).items():
        assert np.array_equal(v.numpy(), want["params"][k]), k
    assert int(host["step"]) == len(TRAIN_BATCHES) == int(tree["step"])
    assert jt.current_epoch == 1


def test_a_single_process_file_resumes_on_the_grid_and_trains_as_one_process(
        ranks, single_trainer):
    out = ranks[0]["1x2x2"]
    assert all(r["restored"] for r in out)  # each rank's whole state is the file's
    for r in out:
        _check_run(r["resumed_history"], r["resumed_state"], *single_trainer["resumed"])


def test_a_three_axis_trainers_memory_report_counts_a_ranks_slices(ranks):
    from facesr_torch.utils.profiling import tensor_bytes

    whole = tensor_bytes(_model())
    for r in ranks[0]["1x2x2"]:
        assert r["report"]["params_bytes"] == r["model_bytes"]
        assert 0.5 * whole < r["model_bytes"] < 0.56 * whole  # t = 2: conv_last, the SE whole
        assert r["report"]["peak_step_bytes"] is None  # measured on a card only


def test_the_overfit_helper_on_the_grid_follows_the_single_process_one(ranks):
    from facesr_torch.training.trainer import overfit_test

    want = overfit_test(_model(), [{"hr": TRAIN_BATCHES[0]}], num_images=BATCH,
                        num_iterations=2, device="cpu")["loss_history"]
    for r in ranks[0]["1x2x2"]:
        np.testing.assert_allclose(r["overfit"], want, rtol=BASE)


def test_the_train_cli_trains_on_data_space_model_over_four_ranks(cli_run, ranks):
    """A plain launch with --mesh-axes data,space,model --mesh-shape 1,2,2
    starts its four ranks; all load the same rows, split the image rows and
    the channels; rank 0 writes the whole checkpoints."""
    from facesr_torch.ckpt import fckpt
    from facesr_torch.ckpt.weights import read_state_dict

    proc, tmp = cli_run
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-4000:]
    assert "Starting 4 ranks" in log
    for r in range(4):
        at = tuple(int(c) for c in np.unravel_index(r, (1, 2, 2)))
        assert f"rank {r} of 4 on cpu, at {at} of the data,space,model grid (1, 2, 2)" in log
    assert "Batch size: 2 global, 2 a rank over 1 rank(s) of the data axis" in log
    assert len(re.findall(r"rank \d of 4, device memory", log)) == 4
    psnr = [float(v) for v in re.findall(r"Val PSNR:\s+([-\d.]+) dB", log)]
    assert psnr and all(math.isfinite(v) for v in psnr)
    _, meta = fckpt.load_checkpoint(str(tmp / "checkpoints" / "final_model.fckpt"))
    assert meta["global_step"] == 2 and meta["config"]["mesh_axes"] == "data,space,model"
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                blocks_per_group=2), device="cpu")
    model.load_state_dict(read_state_dict(str(tmp / "checkpoints" / "final_model.pth")),
                          strict=True)
    assert all(math.isfinite(float(v.abs().sum())) for v in model.state_dict().values())
