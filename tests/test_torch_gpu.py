"""Tests of the port's CUDA kernels and of its f32 evaluation networks on
the card; they need a card and skip without one.

This file imports no JAX (the card's machine has none), so it runs there
without the repo's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest
"""

import contextlib

import pytest
import torch

from facesr_torch.models import blocks, inception, lpips
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


@pytest.mark.gpu
def test_custom_op_on_cuda_matches_plain_at_the_scratch_shape(cuda_device):
    """The op itself (what an exported graph calls) at (2, 40, 80, 64): a
    width past one 64-pixel tile, the kernel's scratch variant."""
    gw = _group_weights(2, seed=8, device=cuda_device)
    x = torch.rand((2, 40, 80, 64), generator=torch.Generator().manual_seed(3))
    x = x.to(torch.bfloat16).to(cuda_device)
    before = tgroup.fused_residual_group.launches
    got = torch.ops.facesr_torch.rcab_group(x, *tgroup.group_weight_args(gw), 0.2)
    torch.cuda.synchronize()
    assert tgroup.fused_residual_group.launches == before + 1
    assert _excess(got, tgroup.rcab_group_reference(x, gw, 0.2)) <= 0


@pytest.mark.gpu
def test_exported_bf16_artifact_launches_the_kernel(cuda_device):
    from facesr_torch.ckpt.export import export_serving, load_exported
    from facesr_torch.parallel.serving import Predictor

    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_groups=2, blocks_per_group=2,
                                                num_channels=64), device=cuda_device)
    fn = load_exported(export_serving(model, torch.bfloat16, input_size=16), device=cuda_device)
    x = torch.rand(3, 16, 16, 3, generator=torch.Generator().manual_seed(4)).numpy()
    before = tgroup.fused_residual_group.launches
    got = fn(x)
    assert tgroup.fused_residual_group.launches == before + 2
    want = Predictor(model, dtype=torch.bfloat16, max_batch=8, device=cuda_device)(x)
    assert got.shape == (3, 64, 64, 3)
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))


@pytest.mark.gpu
def test_predictor_pipeline_on_cuda_under_concurrency(cuda_device):
    """11 images at max_batch 4 (chunks 4, 4, 3 through the depth-2
    pipeline and pinned buffers) equal each chunk's own forward, also with
    four threads calling one Predictor at once; the launch count is exact."""
    import threading

    import numpy as np

    from facesr_torch.parallel.serving import Predictor

    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_groups=2, blocks_per_group=2,
                                                num_channels=64), device=cuda_device)
    pred = Predictor(model, dtype=torch.bfloat16, max_batch=4, device=cuda_device)
    images = np.random.default_rng(5).random((11, 16, 16, 3), dtype=np.float32)
    with torch.inference_mode():
        want = np.concatenate([
            model(torch.from_numpy(images[i:i + 4]).to(cuda_device),
                  dtype=torch.bfloat16).clamp(0, 1).cpu().numpy() for i in range(0, 11, 4)])
    before = tgroup.fused_residual_group.launches
    results = [None] * 4

    def client(i):
        results[i] = pred(images)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for r in results:
        np.testing.assert_array_equal(r, want)
    assert tgroup.fused_residual_group.launches == before + 4 * 3 * 2


@pytest.mark.gpu
def test_kernel_from_many_new_threads_on_cuda(cuda_device):
    """Both variants launched from 16 threads at once, new threads each
    round as a threading HTTP server makes them: every output equals the
    serial one bitwise and the launch count is exact."""
    import threading

    gw = _group_weights(2, 11, cuda_device)
    gen = torch.Generator().manual_seed(12)
    inputs = [torch.rand(shape, generator=gen).to(torch.bfloat16).to(cuda_device)
              for shape in ((1, 64, 64, 64), (1, 40, 80, 64))]  # resident, scratch
    with torch.inference_mode():
        want = [tgroup.fused_residual_group(x, gw, 0.2) for x in inputs]
    before = tgroup.fused_residual_group.launches
    failures = []

    def client():
        try:
            with torch.inference_mode():
                for _ in range(5):
                    for x, w in zip(inputs, want):
                        if not torch.equal(tgroup.fused_residual_group(x, gw, 0.2), w):
                            failures.append("output differs from the serial one")
        except Exception as e:  # noqa: BLE001 — reported by the assert below
            failures.append(repr(e))

    for _ in range(3):
        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert failures == []
    assert tgroup.fused_residual_group.launches == before + 3 * 16 * 5 * 2


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


@contextlib.contextmanager
def _tf32_forced():
    """cuDNN convs and cuBLAS matmuls in TF32, the control a f32 limit must
    reject."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
def test_lpips_on_cuda_matches_cpu(cuda_device):
    w = lpips.init_random_alexnet(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    a, b = torch.rand(4, 256, 256, 3, generator=gen), torch.rand(4, 256, 256, 3, generator=gen)
    want = lpips.lpips_distance(w, a * 2 - 1, b * 2 - 1)
    wc = {k: [{n: t.to(cuda_device) for n, t in p.items()} for p in v] for k, v in w.items()}
    got = lpips.lpips_distance(wc, (a * 2 - 1).to(cuda_device), (b * 2 - 1).to(cuda_device))
    assert abs(got.item() - want.item()) <= 1e-4 * abs(want.item())


@pytest.mark.gpu
def test_inception_on_cuda_matches_cpu_and_rejects_tf32(cuda_device, monkeypatch):
    params = inception.init_random_inception(torch.Generator().manual_seed(2))
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(3))
    want = inception.apply(params, x)
    pc = {n: {k: t.to(cuda_device) for k, t in p.items()} for n, p in params.items()}
    got = inception.apply(pc, x.to(cuda_device))
    assert got.shape == (2, 2048) and _rel(got, want) <= 1e-4
    monkeypatch.setattr(inception, "full_f32", _tf32_forced)
    assert _rel(inception.apply(pc, x.to(cuda_device)), want) > 1e-4
