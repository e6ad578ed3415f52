"""Train and eval steps (port of `facesr/training/steps.py`).

One content step: the HR batch in f32 -> LR made on the device by
`bicubic_down` -> forward with ``train=True`` in the compute dtype -> loss
-> autograd -> `AdamW.update` -> EMA. The GAN step (`make_gan_train_step`)
adds the discriminator updates and the adversarial term around one
generator forward. The whole step, backward included, runs under
`full_f32()`, so every f32 conv and matmul runs without TF32. Metrics stay
device tensors: a step adds no host sync. ``quant_fn`` (QAT) returns the
fake-quant sites each forward runs with (`ops.quant.fake_quant_params`).
A step differentiates and updates the parameters that require grad
(`trainable_parameters`): all of them, except the frozen ones of the
transfer model's stages.

Data parallelism (``mesh``, a `parallel.mesh.Mesh` with a process group):
each rank steps on its own rows, and the gradients are averaged over the
ranks (`all_reduce_mean`, one flat bucket) between autograd and the
optimiser, where XLA inserts its psum in the JAX package; the clip's
global norm and the non-finite guard then see the global gradients and
every rank applies the same update. Frozen tensors have no gradient and
are not reduced. The step's metrics are means over the ranks (one more
all-reduce), the discriminator's BatchNorm is global, and the eval step
takes PSNR from the all-reduced squared-error sum. With one rank the
reduced values are bitwise the local ones.

On a `data,space` grid (`Mesh.row_shard`) every rank of a `space` group
holds its batch rows' whole HR images: it makes the whole LR images, takes
its own rows of both (`RowShard.slab`) and runs the forward and the loss
on them under `parallel.spatial.rows` (halo rows for every conv, global
means, the bicubic skip from the gathered LR). The loss is then the same
on every rank of the group, and each rank's gradients are its share of
the group's, times S: the sums' backward adds the S ranks' upstream
gradients. So the one reduction over all d * s ranks is their mean, as
for dp: (1/d) sum over the data groups of (1/S) x (S x the group's
gradient). The GAN step runs the same way: the generator on the LR rows,
the discriminator's updates on the shard's rows of ``hr`` and of the
detached ``sr``, the G head on the ``sr`` rows. D's convs take halo rows,
its BatchNorm sums over the grid and its dense head sums partial products
over the shards (`models.discriminator`), so its logits and the GAN loss
are replicated over the group too, and both gradient sets take the one
mean over d * s ranks. Where D gathers a small map and runs it whole on
every rank, those layers' gradients are the group's own on each rank (no
sum lies between them and the loss), and the mean over the S equal ranks
keeps them. QAT runs the fake-quant convs over the rows (`ops.conv`: the
float halo rows, the image's activation scale over the shards).

On a `data,model` grid (`Mesh.model_shard`) the state is split over the
`model` group (`parallel.tensor.shard_state`; each rank holds its slice
of every split leaf, the moments and the EMA included) and every forward
runs under `parallel.tensor.split`: each split conv computes its output
channels and gathers the group's. Every replicated tensor, the loss
included, then has the same value and gradient on the group's ranks, and
each rank's gradient of a split leaf is its slice of the whole one, so
the gradients are averaged over the `data` group only (`Mesh.sum_group`;
the metrics and the eval sums too), and the whole leaves' over `model`
as well, which only keeps rounding on the card from setting the replicas
apart. The optimiser takes the shard: the clip's global norm sums the
split leaves' squares over the group and counts each replicated leaf
once, and the non-finite guard decides once for the group. The EMA, the
weight decay and the moments stay per leaf.

On a `data,space,model` grid (d x s x t ranks, both shards at once) the
state is split over `model` as on `data,model`, and every forward runs
under both contexts: each split conv computes its output channels of the
shard's rows from the whole-channel input, which takes its halo rows over
`space`. The loss is then replicated over the s x t ranks of a batch
shard; a `space` rank's gradient is its share of its data group's times S
(as on `data,space`) and a `model` rank's is its slice (as on
`data,model`). So the gradients and the metrics are averaged over the `data`
x `space` plane of the rank's `model` index (`Mesh.sum_group`, d * s
ranks): not over `data` alone (the space ranks hold other rows), and not
over the whole group (its model ranks hold other channel slices of every
split leaf). The whole leaves are
averaged over `model` too, as on `data,model`; the eval sums add over the
plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from facesr_torch.losses.gan import gan_loss
from facesr_torch.losses.ssim import ssim
from facesr_torch.ops.conv import full_f32
from facesr_torch.ops.resize import bicubic_down
from facesr_torch.parallel import pipeline, spatial, tensor
from facesr_torch.parallel.mesh import Mesh, all_reduce_mean, all_reduce_sum
from facesr_torch.training.optim import AdamW

__all__ = ["TrainState", "init_ema", "ema_update", "trainable_parameters", "make_train_step",
           "make_gan_train_step", "make_eval_step", "eval_metrics_from_sums", "leaf_norms"]

LossApply = Callable[[Dict[str, Any], torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
Metrics = Dict[str, torch.Tensor]
QuantFn = Optional[Callable[[], Dict[str, Any]]]


def _quant(quant_fn: QuantFn):
    return None if quant_fn is None else quant_fn()


def _dp(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when it carries a process group to reduce over, else None."""
    return mesh if mesh is not None and mesh.distributed else None


def _row_shard(mesh: Optional[Mesh]):
    """This rank's row shard on a grid with `space` (None otherwise)."""
    return None if mesh is None else mesh.row_shard()


def _model_shard(mesh: Optional[Mesh]):
    """This rank's `model` shard on a grid with `model` (None otherwise)."""
    return None if mesh is None else mesh.model_shard()


def _pipe(mesh: Optional[Mesh]):
    """This rank's stage on a `data,pp` grid (None otherwise)."""
    return None if mesh is None else mesh.pp_shard()


def _trunk(state: "TrainState", pipe, n_micro: int, train: bool, dtype=None):
    """The forward's ``trunk_fn`` keyword: the pipelined trunk on a stage
    (``n_micro`` 0: one microbatch a stage), none otherwise."""
    if pipe is None:
        return {}
    return {"trunk_fn": pipeline.stage_trunk(state.model, pipe, n_micro or pipe.size, train,
                                             dtype)}


def _grad(loss: torch.Tensor, params: Dict[str, torch.Tensor], pipe):
    """The gradients of ``loss`` for ``params``; on a stage, the other
    stages' groups (empty leaves the forward does not read) get empty
    ones."""
    staged = pipe is not None
    return torch.autograd.grad(loss, list(params.values()), allow_unused=staged,
                               materialize_grads=staged)


def _slabs(shard, *images: torch.Tensor):
    """The shard's rows of each of ``images`` (unchanged without a shard)."""
    return images if shard is None else tuple(shard.slab(x) for x in images)


def _update(optimizer: AdamW, grads, state, params, tp) -> None:
    """``optimizer.update`` with the `model` shard or the `pp` stage (None
    off tp and pp). There the whole leaves' gradients are first averaged
    over the group, so that rounding apart on the card (atomics) cannot
    make the replicas differ (`parallel.tensor`)."""
    if tp is not None:
        whole = [n for n in grads if not tensor.is_split(params[n])]
        if whole:
            grads = {**grads, **dict(zip(whole, tp.mean([grads[n] for n in whole])))}
    optimizer.update(grads, state, params, shard=tp)


def leaf_norms(grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               shard=None) -> Dict[str, torch.Tensor]:
    """Each gradient's L2 norm in f32, on its device (0-d tensors, no host
    read). With the `model` shard or the `pp` stage, a split leaf's norm is
    the whole leaf's: its parts' squares summed over the group (one
    all-reduce), an empty part (a stage's other groups) adding 0."""
    sq = {n: torch.sum(g.float() * g.float()) for n, g in grads.items()}
    split = [] if shard is None else [n for n in grads if tensor.is_split(params[n])]
    if split:
        sq.update(zip(split, shard.sum(torch.stack([sq[n] for n in split])).unbind()))
    return {n: torch.sqrt(v) for n, v in sq.items()}


def _reduced(grads, mesh: Optional[Mesh]):
    return grads if mesh is None else all_reduce_mean(grads, mesh)


def _mean_metrics(metrics: Metrics, mesh: Optional[Mesh]) -> Metrics:
    """Each metric's mean over the ranks of `Mesh.sum_group` (one
    all-reduce)."""
    if mesh is None:
        return metrics
    keys = list(metrics)
    reduced = all_reduce_mean([torch.stack([metrics[k].float() for k in keys])], mesh)[0]
    return dict(zip(keys, reduced.unbind()))


@dataclass
class TrainState:
    """What a step reads and updates: the model (its parameters are the
    trained weights), the optimiser state, the frozen loss params (VGG),
    the step count and the EMA of the parameters (None when off); for GAN
    training the discriminator (its parameters, and its BatchNorm running
    stats as buffers) and its optimiser state."""

    model: nn.Module
    opt_state: Dict[str, Any]
    loss_params: Dict[str, Any]
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    disc: Optional[nn.Module] = None
    d_opt_state: Optional[Dict[str, Any]] = None


def trainable_parameters(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters a step trains, by name: those that require grad."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def init_ema(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A fresh EMA: a copy of every parameter, by name."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place."""
    for n, p in model.named_parameters():
        ema[n].copy_(ema[n] * decay + p.to(ema[n].dtype) * (1.0 - decay))


def make_train_step(loss_apply: LossApply, optimizer: AdamW, scale_factor: int = 4,
                    compute_dtype: Optional[torch.dtype] = None,
                    ema_decay: float = 0.0, quant_fn: QuantFn = None,
                    mesh: Optional[Mesh] = None, pp_microbatches: int = 0,
                    grad_norms: bool = False,
                    ) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, Metrics]]:
    """Content-only (no GAN) step: ``train_step(state, hr) -> (state,
    metrics)``, ``hr`` an NHWC batch in [0, 1] on the model's device (this
    rank's batch rows under ``mesh``, whole images on a grid). The state is updated in place and
    returned; metrics are the loss components, ``loss`` and, with the
    non-finite guard, the running count ``opt_notfinite``. On `data,pp`
    the trunk runs in ``pp_microbatches`` (0: S) microbatches.
    ``grad_norms``: metrics also hold ``grad_norms``, each trained
    parameter's gradient norm (`leaf_norms`: after the mean over the
    ranks, before the clip; the whole leaf's on every mesh)."""
    mesh = _dp(mesh)
    shard, tp, pipe = _row_shard(mesh), _model_shard(mesh), _pipe(mesh)

    def train_step(state: TrainState, hr: torch.Tensor) -> Tuple[TrainState, Metrics]:
        params = trainable_parameters(state.model)
        with full_f32():
            hr = hr.float()
            lr_img, hr = _slabs(shard, bicubic_down(hr, scale_factor), hr)
            with spatial.rows(shard), tensor.split(tp):
                sr = state.model(lr_img, train=True, dtype=compute_dtype,
                                 quant=_quant(quant_fn),
                                 **_trunk(state, pipe, pp_microbatches, True, compute_dtype))
                loss, comps = loss_apply(state.loss_params, sr, hr)
                grads = _grad(loss, params, pipe)
            grads = dict(zip(params, _reduced(grads, mesh)))
            norms = leaf_norms(grads, params, tp or pipe) if grad_norms else None
        _update(optimizer, grads, state.opt_state, params, tp or pipe)
        if ema_decay > 0:
            ema_update(state.ema_params, state.model, ema_decay)
        state.step += 1
        metrics = {k: v.detach() for k, v in comps.items()}
        metrics["loss"] = loss.detach()
        metrics = _mean_metrics(metrics, mesh)
        if "total_notfinite" in state.opt_state:
            metrics["opt_notfinite"] = state.opt_state["total_notfinite"]
        if norms is not None:
            metrics["grad_norms"] = norms
        return state, metrics

    train_step.row_shard = shard  # its exchange counts (None unsharded)
    train_step.model_shard = tp
    train_step.pp_shard = pipe
    return train_step


def make_gan_train_step(loss_apply: LossApply, optimizer: AdamW, d_optimizer: AdamW,
                        scale_factor: int = 4, gan_weight: float = 0.005,
                        gan_type: str = "vanilla", d_updates_per_g: int = 1,
                        compute_dtype: Optional[torch.dtype] = None, ema_decay: float = 0.0,
                        guard_stats: bool = False, quant_fn: QuantFn = None,
                        mesh: Optional[Mesh] = None, pp_microbatches: int = 0,
                        grad_norms: bool = False,
                        ) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, Metrics]]:
    """Adversarial step: ``d_updates_per_g`` discriminator updates on
    (hr, detached sr), then one generator update with content +
    ``gan_weight`` * adversarial loss. ``state.disc`` runs in train mode
    throughout (each call updates its BatchNorm running stats) and in
    ``compute_dtype``, as the generator does.

    One generator forward serves both roles: its detached output is the
    fake batch of the D updates and its graph carries the G update. The G
    head runs the already-updated D on sr and takes gradients for the
    generator's parameters only, so D keeps no gradient and no update from
    it. ``guard_stats`` (with skip_nonfinite optimisers): when the G or D
    loss is not finite the running stats go back to the step's input
    values (``torch.where``, no host sync). Metrics: the content
    components, ``g_adv``, ``loss``, ``d_loss``, ``d_real`` and ``d_fake``
    (mean sigmoid of the last D update's logits), and the guards' running
    counts ``opt_notfinite`` and ``d_opt_notfinite``. Under ``mesh`` D's
    BatchNorm takes global statistics, both gradient sets are reduced, and
    the stats guard reads the global losses; on a `data,space` grid every
    forward runs on the shard's image rows (the module docstring); on a
    `data,model` grid every forward on the rank's channel slices; on a
    `data,space,model` grid on both; on a `data,pp` grid G's trunk runs as
    the pipeline, D replicated. ``grad_norms``: G's gradient norms, as in
    `make_train_step`."""
    mesh = _dp(mesh)
    shard, tp, pipe = _row_shard(mesh), _model_shard(mesh), _pipe(mesh)

    def train_step(state: TrainState, hr: torch.Tensor) -> Tuple[TrainState, Metrics]:
        params = trainable_parameters(state.model)
        disc = state.disc
        d_params = dict(disc.named_parameters())
        stats_in = {k: v.clone() for k, v in disc.named_buffers()} if guard_stats else None
        zero = torch.zeros((), device=hr.device)
        d_loss = d_real_score = d_fake_score = zero
        with full_f32():
            hr = hr.float()
            lr_img, hr = _slabs(shard, bicubic_down(hr, scale_factor), hr)
            with spatial.rows(shard), tensor.split(tp):
                sr = state.model(lr_img, train=True, dtype=compute_dtype,
                                 quant=_quant(quant_fn),
                                 **_trunk(state, pipe, pp_microbatches, True, compute_dtype))
                sr_for_d = sr.detach()
                for _ in range(d_updates_per_g):
                    d_real = disc(hr, train=True, dtype=compute_dtype, mesh=mesh)
                    d_fake = disc(sr_for_d, train=True, dtype=compute_dtype, mesh=mesh)
                    d_loss = (gan_loss(d_real, True, gan_type)
                              + gan_loss(d_fake, False, gan_type)) / 2
                    d_grads = _reduced(torch.autograd.grad(d_loss, list(d_params.values())),
                                       mesh)
                    _update(d_optimizer, dict(zip(d_params, d_grads)), state.d_opt_state,
                            d_params, tp or pipe)
                    d_loss = d_loss.detach()
                    d_real_score = torch.sigmoid(d_real.detach()).mean()
                    d_fake_score = torch.sigmoid(d_fake.detach()).mean()
                content, comps = loss_apply(state.loss_params, sr, hr)
                g_adv = gan_loss(disc(sr, train=True, dtype=compute_dtype, mesh=mesh), True,
                                 gan_type)
                loss = content + gan_weight * g_adv
                grads = _grad(loss, params, pipe)
            grads = dict(zip(params, _reduced(grads, mesh)))
            norms = leaf_norms(grads, params, tp or pipe) if grad_norms else None
        _update(optimizer, grads, state.opt_state, params, tp or pipe)
        metrics = {k: v.detach() for k, v in comps.items()}
        metrics.update(g_adv=g_adv.detach(), loss=loss.detach(), d_loss=d_loss,
                       d_real=d_real_score, d_fake=d_fake_score)
        metrics = _mean_metrics(metrics, mesh)
        if guard_stats:
            disc.load_stats(stats_in, keep=torch.isfinite(metrics["loss"])
                            & torch.isfinite(metrics["d_loss"]))
        if ema_decay > 0:
            ema_update(state.ema_params, state.model, ema_decay)
        state.step += 1
        if "total_notfinite" in state.opt_state:
            metrics["opt_notfinite"] = state.opt_state["total_notfinite"]
        if "total_notfinite" in state.d_opt_state:
            metrics["d_opt_notfinite"] = state.d_opt_state["total_notfinite"]
        if norms is not None:
            metrics["grad_norms"] = norms
        return state, metrics

    train_step.row_shard = shard  # its exchange counts (None unsharded)
    train_step.model_shard = tp
    train_step.pp_shard = pipe
    return train_step


def make_eval_step(loss_apply: LossApply, scale_factor: int = 4, use_ema: bool = False,
                   quant_fn: QuantFn = None, mesh: Optional[Mesh] = None,
                   pp_microbatches: int = 0,
                   ) -> Callable[..., Tuple[Metrics, torch.Tensor, torch.Tensor]]:
    """Validation step: the f32 eval forward (clamped), the f32 loss, batch
    PSNR ``10*log10(1/max(mse, 1e-12))`` and SSIM. ``use_ema`` validates
    the EMA weights. Returns (metrics, sr, lr).

    Under ``mesh`` the batch is the union of the ranks' rows, as in the
    JAX package: the squared-error sum and its element count are
    all-reduced before the log (a mean of the ranks' PSNRs would be
    another number), and the loss and SSIM are row-weighted means, so a
    rank may hold any number of rows. ``eval_step(state, hr,
    reduce=False)`` returns this rank's sums instead (``{"sums": [sq_err,
    elements, loss * rows, ssim * rows, rows]}``, no collective), which
    the Trainer reduces for a whole epoch at once
    (`eval_metrics_from_sums`). On a grid each rank takes its image rows
    (sr and lr are returned as those rows), the loss and SSIM are global
    over the rows, and the sums add over every rank: each space rank
    counts its batch rows too, so the row-weighted means are unchanged. On
    a `data,model` grid the forward runs on the rank's channel slices (the
    EMA's too) and the sums add over the `data` group; on a
    `data,space,model` grid the forward runs on the rank's rows and
    channel slices and the sums add over the `data` x `space` plane; on a
    `data,pp` grid the trunk runs as the pipeline and the sums add over
    `data` too."""
    mesh = _dp(mesh)
    shard, tp, pipe = _row_shard(mesh), _model_shard(mesh), _pipe(mesh)

    def eval_step(state: TrainState, hr: torch.Tensor, reduce: bool = True):
        if use_ema and state.ema_params is None:
            raise ValueError(
                "make_eval_step(use_ema=True) on a TrainState without EMA "
                "weights (ema_params is None); build the step with use_ema=False")
        with torch.no_grad(), full_f32(), spatial.rows(shard), tensor.split(tp):
            hr = hr.float()
            lr_img, hr = _slabs(shard, bicubic_down(hr, scale_factor), hr)
            quant = _quant(quant_fn)
            trunk = _trunk(state, pipe, pp_microbatches, False)
            if use_ema:
                sr = functional_call(state.model, state.ema_params, (lr_img,),
                                     {"train": False, "quant": quant, **trunk})
            else:
                sr = state.model(lr_img, train=False, quant=quant, **trunk)
            loss, _ = loss_apply(state.loss_params, sr, hr)
            ssim_val = ssim(sr, hr)
            if mesh is not None:
                rows = float(hr.shape[0])
                sums = torch.stack([((sr - hr) ** 2).sum(), hr.new_tensor(rows * hr[0].numel()),
                                    loss * rows, ssim_val * rows, hr.new_tensor(rows)])
                if not reduce:
                    return {"sums": sums}, sr, lr_img
                return eval_metrics_from_sums(all_reduce_sum(sums, mesh)), sr, lr_img
            mse = ((sr - hr) ** 2).mean()
            psnr = 10.0 * torch.log10(1.0 / mse.clamp_min(1e-12))
        return {"loss": loss, "psnr": psnr, "ssim": ssim_val}, sr, lr_img

    eval_step.row_shard = shard  # its exchange counts (None unsharded)
    eval_step.model_shard = tp
    eval_step.pp_shard = pipe
    return eval_step


def eval_metrics_from_sums(sums: torch.Tensor) -> Metrics:
    """The eval step's metrics from summed ``[..., 5]`` rows of
    ``[sq_err, elements, loss * rows, ssim * rows, rows]``: PSNR of the
    global MSE, row-weighted loss and SSIM."""
    mse = sums[..., 0] / sums[..., 1]
    return {"loss": sums[..., 2] / sums[..., 4],
            "psnr": 10.0 * torch.log10(1.0 / mse.clamp_min(1e-12)),
            "ssim": sums[..., 3] / sums[..., 4]}
