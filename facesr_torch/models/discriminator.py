"""VGG-style discriminator for adversarial training (256x256 -> one logit).

Port of `facesr/models/discriminator.py`: 10 conv blocks 64 -> 512 with
stride-2 downsampling (256 -> 8), BatchNorm + LeakyReLU(0.2), then flatten
-> Linear(512*8*8 -> 1024) -> LeakyReLU -> Linear(1024 -> 1). Kaiming
fan_in leaky_relu(0.2) init from an explicit `torch.Generator`.

``forward`` takes NHWC and returns f32 logits [N, 1]. The dtype policy is
the JAX ``apply``'s, by explicit casts: convs and dense layers run in the
compute dtype, each BatchNorm on an f32 copy cast back, the logits in f32.
BatchNorm has torch semantics (`F.batch_norm`): in train mode the biased
batch variance normalises and the running stats take the batch mean and
the unbiased variance with momentum 0.1, on every train-mode call; eval
mode normalises by the running stats. The running stats are the module's
buffers, so a step can snapshot and restore them (`load_stats`).

Under data parallelism (``mesh`` a group of more than one rank) a
train-mode BatchNorm is global, as XLA makes it under the JAX package's
sharded batch: the mean and the biased variance are taken over every
rank's rows, from per-channel sums all-reduced through a differentiable
all-reduce (its backward sums the ranks' gradients, so D's gradients are
those of the global statistics), and ``running_var`` takes the unbiased
factor of the global count. The variance is the all-reduced sum of
squared deviations from the global mean (a second all-reduce; a raw sum
of squares would cancel). With one rank it is `F.batch_norm`. The flatten
is in NCHW order, so converted classifier weights drop in. f32 convs and
matmuls run without TF32 (`full_f32`), as the JAX package's HIGHEST.

Under a row shard (`parallel.spatial.rows`: the GAN step on a
`data,space` grid) the input is the shard's rows of each image. The convs
take their halo rows (a stride-2 conv one row from above), so each map
stays split, its rows halved at every stride-2 conv. Where a map's rows
no longer split by the next conv's stride (a shard of one row, D at 32
over 2 shards or at 64 over 4), the shards gather the whole map and every
rank runs the rest unsharded, as XLA does. A train-mode BatchNorm's
statistics cover every rank's rows of the grid (the sums over ``mesh``'s
whole group, each rank counting its own rows; over a thread group,
`RowShard.sum`) while the map is split, and the ranks of the `data` axis
once it is whole. The first dense layer reads the NCHW flatten, so a
shard's rows h are the columns c * H * W + h * W + w: the shard takes the
partial product with its columns, the partials are summed over the
shards (differentiable, `RowShard.sum`) and the bias is added once; the
logits are then the same on every shard.

Under a `model` shard (`parallel.tensor`: the GAN step on `data,model`)
every conv computes its slice of the output channels and the ranks'
slices are gathered (`ops.conv.conv2d`), so each BatchNorm runs on the
whole map: its affine and running stats, split like the conv, are
gathered for the use (the affine's gradient is this rank's slice), its
statistics sum over the `data` group, and each rank writes its slice of
the updated running stats back. The dense layers are whole on every
rank, as JAX keeps ``fc1``/``fc2``, and read the gathered map.

On a `data,space,model` grid both hold at once: each conv computes its
channel slice of the shard's rows (its halo rows taken over `space` from
the whole-channel input), the BatchNorm runs on the gathered channels and
sums its statistics over the `data` x `space` plane while the map is
split, over `data` once it is whole. (The whole group's sums would count
every row t times, its `model` ranks being copies: the mean, the
variance and the gradients would come out the same, the count t times
too large, and the running variance would take the wrong unbiased
factor.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.ops.conv import conv2d, full_f32, leaky_relu
from facesr_torch.ops.init import kaiming_normal
from facesr_torch.parallel import spatial, tensor

__all__ = ["DiscriminatorConfig", "Discriminator", "create_discriminator", "param_count",
           "get_model_info", "BN_EPS", "BN_MOMENTUM"]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# (out_channels multiplier, stride, use_bn) per conv block; the first block
# has no BatchNorm (and a conv bias in its place)
_BLOCKS = [
    (1, 1, False),
    (1, 2, True),
    (2, 1, True),
    (2, 2, True),
    (4, 1, True),
    (4, 2, True),
    (8, 1, True),
    (8, 2, True),
    (8, 1, True),
    (8, 2, True),
]


@dataclass
class DiscriminatorConfig:
    in_channels: int = 3
    base_channels: int = 64
    input_size: int = 256
    use_bn: bool = True
    use_sigmoid: bool = False  # False for logits (BCE-with-logits training)


class _BatchNorm(nn.Module):
    """BatchNorm2d's parameters and running stats; `Discriminator.forward`
    applies them."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, use_bn: bool):
        super().__init__()
        self.stride = stride
        self.conv = skip_init(nn.Conv2d, cin, cout, 3, stride=stride, padding=1,
                              bias=not use_bn)
        self.bn = _BatchNorm(cout) if use_bn else None


class Discriminator(nn.Module):
    """The VGG-style discriminator on NHWC tensors, weights drawn from a CPU
    generator seeded with ``seed`` and placed on ``device`` (CUDA unless
    the caller names one)."""

    def __init__(self, config: Optional[DiscriminatorConfig] = None, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        cfg = self.config = config or DiscriminatorConfig()
        if cfg.input_size % 32:
            # five stride-2 convs take ceil(s/2) each: any other size makes
            # the flatten disagree with the dense layer
            raise ValueError(f"Discriminator input_size must be a multiple of 32, got "
                             f"{cfg.input_size}")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        blocks, cin = [], cfg.in_channels
        for mult, stride, bn in _BLOCKS:
            blocks.append(_Block(cin, cfg.base_channels * mult, stride, bn and cfg.use_bn))
            cin = cfg.base_channels * mult
        self.blocks = nn.ModuleList(blocks)
        feat = cfg.input_size // 32
        self.fc1 = skip_init(nn.Linear, cfg.base_channels * 8 * feat * feat, 1024)
        self.fc2 = skip_init(nn.Linear, 1024, 1)
        # drawn in the JAX init's order: the convs, then fc1 and fc2
        with torch.no_grad():
            for layer in [b.conv for b in self.blocks] + [self.fc1, self.fc2]:
                layer.weight.copy_(kaiming_normal(layer.weight.shape, gen, mode="fan_in",
                                                  nonlinearity="leaky_relu", a=0.2))
                if layer.bias is not None:
                    layer.bias.zero_()
        self.to(dev)

    def forward(self, x: torch.Tensor, train: bool = True,
                dtype: Optional[torch.dtype] = None, mesh=None) -> torch.Tensor:
        """NHWC image (this shard's rows under a row shard) -> f32 logits
        [N, 1]; ``train`` uses (and updates) the batch statistics, over
        every rank of ``mesh`` when it has more than one; ``dtype`` is the
        compute dtype of the convs and dense layers (None: f32)."""
        shard = spatial.current()
        with full_f32():
            h = x.to(dtype) if dtype is not None else x
            for block in self.blocks:
                if shard is not None and shard.conv_rows(h.shape[1], 3, 1, block.stride) is None:
                    h, shard = shard.gather(h), None  # whole maps from here on
                with spatial.rows(shard):
                    h = conv2d(h, block.conv.weight, block.conv.bias, padding=1,
                               stride=block.stride)
                if block.bn is not None:
                    h = _batch_norm(h, block.bn, train, _bn_sum(train, mesh, shard))
                h = leaky_relu(h, 0.2)
            h = leaky_relu(_dense_rows(h, self.fc1, shard), 0.2)
            out = _dense(h, self.fc2)
            if self.config.use_sigmoid:
                out = torch.sigmoid(out)
        return out.float()

    @torch.no_grad()
    def load_stats(self, stats: Dict[str, torch.Tensor],
                   keep: Optional[torch.Tensor] = None) -> None:
        """Write ``stats`` (by buffer name) into the running stats; with
        ``keep`` (a bool tensor) only where it is False (``torch.where`` on
        the device)."""
        for name, buf in self.named_buffers():
            buf.copy_(stats[name] if keep is None else torch.where(keep, buf, stats[name]))

    def get_model_info(self) -> Dict[str, Any]:
        return get_model_info(self)


def _bn_sum(train: bool, mesh, shard):
    """The sum over every row a train-mode BatchNorm's statistics cover
    (differentiable), or None for this process's rows alone (`F.batch_norm`):
    while the map is split, every rank's rows (``mesh``'s `Mesh.sum_group`:
    the whole group of a `data,space` grid, the `data` x `space` plane of a
    three-axis one, whose `model` ranks hold copies) or a thread group's
    (`RowShard.sum`); once it is whole, the ranks of the `data` axis."""
    from facesr_torch.parallel.mesh import _AllReduceSum

    if not train:
        return None
    distributed = mesh is not None and mesh.distributed
    if shard is not None:
        if not distributed:
            return shard.sum
        group = mesh.sum_group
    elif not distributed or mesh.data_size < 2:
        return None
    else:
        group = mesh.axis_group("data")
    return lambda t: _AllReduceSum.apply(t, group)


def _batch_norm(h: torch.Tensor, bn: _BatchNorm, train: bool, reduce) -> torch.Tensor:
    """BatchNorm of NHWC ``h`` on an f32 copy, cast back: ``F.batch_norm``,
    or with ``reduce`` (`_bn_sum`) the statistics of every row it sums.
    Under a `model` shard whose slices ``bn`` holds, on its gathered
    leaves, this rank's slice of the running stats written back."""
    tp = tensor.current()
    if tp is not None and tensor.is_split(bn.weight):
        weight, bias = tp.gather(torch.stack([bn.weight, bn.bias]), dim=1, kind="leaf")
        with torch.no_grad():
            stats = tp.gather(torch.stack([bn.running_mean, bn.running_var]), dim=1,
                              kind="leaf")
        whole = _BatchNormLeaves(weight, bias, stats[0].clone(), stats[1].clone())
        out = _batch_norm(h, whole, train, reduce)
        if train:
            with torch.no_grad():
                a, b = tp.bounds(whole.running_mean.shape[0])
                bn.running_mean.copy_(whole.running_mean[a:b])
                bn.running_var.copy_(whole.running_var[a:b])
        return out
    hf = h.float().permute(0, 3, 1, 2)
    if reduce is None:
        hf = F.batch_norm(hf, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                          training=train, momentum=BN_MOMENTUM, eps=BN_EPS)
    else:
        hf = _global_batch_norm(hf, bn, reduce)
    return hf.permute(0, 2, 3, 1).to(h.dtype)


class _BatchNormLeaves(NamedTuple):
    """A BatchNorm's whole leaves, gathered from a `model` shard's slices."""

    weight: torch.Tensor
    bias: torch.Tensor
    running_mean: torch.Tensor
    running_var: torch.Tensor


def _global_batch_norm(x: torch.Tensor, bn, reduce) -> torch.Tensor:
    """Train-mode BatchNorm of NCHW f32 ``x`` with the statistics of every
    row ``reduce`` sums over (each part counting its own rows); updates
    the running stats as `F.batch_norm` does."""
    c = x.shape[1]
    sums = reduce(torch.cat([x.sum(dim=(0, 2, 3)), x.new_tensor([x.numel() // c])]))
    count = sums[c]
    mean = sums[:c] / count
    dev = x - mean[None, :, None, None]
    var = reduce((dev * dev).sum(dim=(0, 2, 3))) / count
    with torch.no_grad():
        bn.running_mean.mul_(1 - BN_MOMENTUM).add_(mean.detach() * BN_MOMENTUM)
        bn.running_var.mul_(1 - BN_MOMENTUM).add_(
            var.detach() * (count / (count - 1)) * BN_MOMENTUM)
    scale = torch.rsqrt(var + BN_EPS) * bn.weight
    return dev * scale[None, :, None, None] + bn.bias[None, :, None, None]


def _dense_rows(x: torch.Tensor, fc: nn.Linear, shard) -> torch.Tensor:
    """``fc`` of the NCHW flatten of NHWC ``x``. Under a row ``shard`` (``x``
    its rows of the map) the partial product with the columns those rows
    hold (c * H * W + h * W + w), summed over the shards, the bias added
    once."""
    n, h, w, c = x.shape
    flat = x.permute(0, 3, 1, 2).reshape(n, -1)
    if shard is None:
        return _dense(flat, fc)
    rows = h * shard.size
    a, b = shard.bounds(rows)[shard.index]
    cols = fc.weight.view(fc.out_features, c, rows, w)[:, :, a:b].reshape(fc.out_features, -1)
    return shard.sum(flat @ cols.to(x.dtype).t()) + fc.bias.to(x.dtype)


def _dense(x: torch.Tensor, fc: nn.Linear) -> torch.Tensor:
    """[N, in] x [out, in]^T in x's dtype, the bias added after (the JAX
    package's `dense`)."""
    return x @ fc.weight.to(x.dtype).t() + fc.bias.to(x.dtype)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def get_model_info(model: nn.Module) -> Dict[str, Any]:
    total = param_count(model)
    return {"name": "VGGStyleDiscriminator", "total_params": total,
            "trainable_params": total, "size_mb": total * 4 / (1024 ** 2)}


def create_discriminator(input_size: int = 256, base_channels: int = 64, use_bn: bool = True,
                         seed: int = 0, device: DeviceLike = None, **kwargs) -> Discriminator:
    """The JAX package's factory: unknown keyword arguments raise."""
    fields = DiscriminatorConfig.__dataclass_fields__
    unknown = set(kwargs) - set(fields)
    if unknown:
        raise TypeError(f"create_discriminator got unknown argument(s) "
                        f"{sorted(unknown)} (valid: {sorted(fields)})")
    base = dict(in_channels=3, base_channels=base_channels, input_size=input_size,
                use_bn=use_bn, use_sigmoid=False)
    base.update(kwargs)
    return Discriminator(DiscriminatorConfig(**base), seed=seed, device=device)
