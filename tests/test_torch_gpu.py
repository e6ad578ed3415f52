"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports no JAX (the card's machine has none), so it runs there
without the repo's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest
"""

import pytest
import torch

from facesr_torch.models import blocks
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.ops import rcab_group as tgroup

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _group_weights(B, seed, device):
    gen = torch.Generator().manual_seed(seed)
    group = blocks.make_residual_groups(1, B, 64, 3, 4, gen)[0]
    with torch.no_grad():
        for name, p in group.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return {k: v.to(device) for k, v in tgroup.prepare_group_weights(group).items()}


def _excess(got, want):
    """How far |got - want| exceeds the tolerance: bf16 output and another
    f32 summation order, so an element may round one bf16 ulp (at most
    2**-7 relative) the other way."""
    want = want.float()
    return ((got.float() - want).abs() - (2e-2 + 2.0 ** -7 * want.abs())).max().item()


# the resident variant at the production shape and a ragged one (bands of 2
# and 3 rows), each with one image a cluster and with clusters looping over
# several, and with bands of 1 and 2 rows at an odd width; the scratch
# variant at a tiny image and at a width past one 64-pixel tile with an H
# the band count does not divide; a lone image
_SHAPES = [((4, 64, 64, 64), 10), ((3, 20, 36, 64), 3), ((1, 7, 5, 64), 1),
           ((128, 64, 64, 64), 10), ((40, 20, 36, 64), 3), ((2, 12, 17, 64), 2),
           ((2, 40, 80, 64), 2), ((1, 64, 64, 64), 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,B", _SHAPES)
def test_kernel_matches_plain_on_cuda(cuda_device, shape, B):
    gw = _group_weights(B, seed=6, device=cuda_device)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16).to(cuda_device)
    before = tgroup.fused_residual_group.launches
    got = tgroup.fused_residual_group(x, gw, 0.2)
    torch.cuda.synchronize()
    assert tgroup.fused_residual_group.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.isfinite(got).all()
    assert _excess(got, tgroup.rcab_group_reference(x, gw, 0.2)) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape,B", [((4, 64, 64, 64), 10), ((40, 20, 36, 64), 3),
                                     ((2, 40, 80, 64), 2)])
def test_kernel_repeats_bitwise_on_cuda(cuda_device, shape, B):
    """The SE mean is summed in a fixed order (no atomics), so two calls on
    the same input agree to the bit."""
    gw = _group_weights(B, seed=7, device=cuda_device)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(2))
    x = x.to(torch.bfloat16).to(cuda_device)
    first = tgroup.fused_residual_group(x, gw, 0.2)
    second = tgroup.fused_residual_group(x, gw, 0.2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_kernel_rejects_other_widths_on_cuda(cuda_device):
    gen = torch.Generator().manual_seed(0)
    group = blocks.make_residual_groups(1, 1, 32, 3, 4, gen)[0]
    gw = {k: v.to(cuda_device) for k, v in tgroup.prepare_group_weights(group).items()}
    with pytest.raises(ValueError, match="C=64"):
        tgroup.fused_residual_group(torch.zeros(1, 8, 8, 32, dtype=torch.bfloat16,
                                                device=cuda_device), gw)


@pytest.mark.gpu
def test_bf16_model_trunk_runs_the_kernel(cuda_device):
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_groups=2, blocks_per_group=2,
                                                num_channels=64), device=cuda_device)
    x = torch.rand(2, 16, 16, 3, device=cuda_device)
    before = tgroup.fused_residual_group.launches
    with torch.inference_mode():
        out = model(x, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert tgroup.fused_residual_group.launches == before + 2
    assert out.shape == (2, 64, 64, 3) and torch.isfinite(out).all()
