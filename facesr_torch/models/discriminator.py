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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.ops.conv import conv2d, full_f32, leaky_relu
from facesr_torch.ops.init import kaiming_normal

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
        """NHWC image -> f32 logits [N, 1]; ``train`` uses (and updates) the
        batch statistics, over every rank of ``mesh`` when it has more
        than one; ``dtype`` is the compute dtype of the convs and dense
        layers (None: f32)."""
        global_bn = train and mesh is not None and mesh.world_size > 1
        with full_f32():
            h = x.to(dtype) if dtype is not None else x
            for block in self.blocks:
                h = conv2d(h, block.conv.weight, block.conv.bias, padding=1,
                           stride=block.stride)
                if block.bn is not None:
                    bn = block.bn
                    hf = h.float().permute(0, 3, 1, 2)
                    if global_bn:
                        hf = _global_batch_norm(hf, bn, mesh)
                    else:
                        hf = F.batch_norm(hf, bn.running_mean, bn.running_var, bn.weight,
                                          bn.bias, training=train, momentum=BN_MOMENTUM,
                                          eps=BN_EPS)
                    h = hf.permute(0, 2, 3, 1).to(h.dtype)
                h = leaky_relu(h, 0.2)
            # NCHW flatten order, as the reference classifier weights expect
            h = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)
            h = leaky_relu(_dense(h, self.fc1), 0.2)
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


def _global_batch_norm(x: torch.Tensor, bn: _BatchNorm, mesh) -> torch.Tensor:
    """Train-mode BatchNorm of NCHW f32 ``x`` with the statistics of every
    rank's rows; updates the running stats as `F.batch_norm` does."""
    from facesr_torch.parallel.mesh import all_reduce_sum

    c = x.shape[1]
    sums = all_reduce_sum(torch.cat([x.sum(dim=(0, 2, 3)),
                                     x.new_tensor([x.numel() // c])]), mesh)
    count = sums[c]
    mean = sums[:c] / count
    dev = x - mean[None, :, None, None]
    var = all_reduce_sum((dev * dev).sum(dim=(0, 2, 3)), mesh) / count
    with torch.no_grad():
        bn.running_mean.mul_(1 - BN_MOMENTUM).add_(mean.detach() * BN_MOMENTUM)
        bn.running_var.mul_(1 - BN_MOMENTUM).add_(
            var.detach() * (count / (count - 1)) * BN_MOMENTUM)
    scale = torch.rsqrt(var + BN_EPS) * bn.weight
    return dev * scale[None, :, None, None] + bn.bias[None, :, None, None]


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
