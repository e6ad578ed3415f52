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
# the band count does not divide; a lone image (all on uniform noise); the
# scratch variant spread over many clusters: one 256x256 image over every
# cluster, ragged 4-row units with a partial column tile, several images
# sharing the clusters, more images than it keeps in flight (16), so each
# slot loops over five (on rows that darken towards the top, `_features`)
_SPLIT_SHAPES = [((1, 256, 256, 64), 10), ((1, 130, 200, 64), 2), ((3, 96, 96, 64), 3),
                 ((80, 40, 80, 64), 2)]
_SHAPES = [((4, 64, 64, 64), 10), ((3, 20, 36, 64), 3), ((1, 7, 5, 64), 1),
           ((128, 64, 64, 64), 10), ((40, 20, 36, 64), 3), ((2, 12, 17, 64), 2),
           ((2, 40, 80, 64), 2), ((1, 64, 64, 64), 10)] + _SPLIT_SHAPES


def _features(shape, seed, device):
    """bf16 NHWC uniform noise; for the split shapes its rows darken
    towards the top, so that a channel mean over part of the rows differs
    from the image's."""
    x = torch.rand(shape, generator=torch.Generator().manual_seed(seed))
    if any(tuple(shape) == split for split, _ in _SPLIT_SHAPES):
        x = x * torch.linspace(0.1, 1.0, shape[1]).reshape(1, -1, 1, 1)
    return x.to(torch.bfloat16).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,B", _SHAPES)
def test_kernel_matches_plain_on_cuda(cuda_device, shape, B):
    gw = _group_weights(B, seed=6, device=cuda_device)
    x = _features(shape, 1, cuda_device)
    before = tgroup.fused_residual_group.launches
    got = tgroup.fused_residual_group(x, gw, 0.2)
    torch.cuda.synchronize()
    assert tgroup.fused_residual_group.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.isfinite(got).all()
    assert _excess(got, tgroup.rcab_group_reference(x, gw, 0.2)) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape,B", [((4, 64, 64, 64), 10), ((40, 20, 36, 64), 3),
                                     ((2, 40, 80, 64), 2)] + _SPLIT_SHAPES)
def test_kernel_repeats_bitwise_on_cuda(cuda_device, shape, B):
    """The SE mean is summed in a fixed order (no atomics), also over the
    blocks of many clusters, so two calls on the same input agree to the
    bit."""
    gw = _group_weights(B, seed=7, device=cuda_device)
    x = _features(shape, 2, cuda_device)
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
    round as a threading HTTP server makes them, each thread on its own
    stream: the resident variant, the scratch variant in one cluster and a
    lone 256x256 image over every cluster (whole-card launches whose
    image-wide barriers would deadlock if two were placed in part; the
    join timeout fails the test instead of hanging). Every output equals
    the serial one bitwise and the launch count is exact."""
    import threading

    gw = _group_weights(2, 11, cuda_device)
    gen = torch.Generator().manual_seed(12)
    inputs = [torch.rand(shape, generator=gen).to(torch.bfloat16).to(cuda_device)
              for shape in ((1, 64, 64, 64), (1, 40, 80, 64), (1, 256, 256, 64))]
    with torch.inference_mode():
        want = [tgroup.fused_residual_group(x, gw, 0.2) for x in inputs]
    torch.cuda.synchronize()
    before = tgroup.fused_residual_group.launches
    failures = []

    def client():
        try:
            stream = torch.cuda.Stream()
            with torch.inference_mode(), torch.cuda.stream(stream):
                for _ in range(5):
                    for x, w in zip(inputs, want):
                        if not torch.equal(tgroup.fused_residual_group(x, gw, 0.2), w):
                            failures.append("output differs from the serial one")
            stream.synchronize()
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
    assert tgroup.fused_residual_group.launches == before + 3 * 16 * 5 * len(inputs)


@pytest.mark.gpu
def test_scratch_variant_spreads_a_lone_image_over_the_card(cuda_device):
    """A lone 256x256 image takes the scratch variant over many clusters
    (at least 100 of the H100's 132 SMs), several images share them, and
    a large batch keeps at most 16 images in flight, each over several
    SMs, with the card as busy."""
    lib = tgroup._lib()
    clusters, size, slots, per_image = tgroup._plan(lib, 1, 256, 256)
    assert slots == 1 and per_image == clusters and clusters * size >= 100
    clusters3, size3, slots3, per3 = tgroup._plan(lib, 3, 96, 96)
    assert slots3 == 3 and clusters3 == 3 * per3 and per3 > 1
    clusters_m, size_m, slots_m, per_m = tgroup._plan(lib, 256, 96, 96)
    assert slots_m == 16 and clusters_m == 16 * per_m and per_m * size_m >= 4
    assert clusters_m * size_m >= 100


@pytest.mark.gpu
def test_scratch_variant_in_a_cuda_graph(cuda_device):
    """The cooperative launch is captured into a CUDA graph and replays to
    the eager output bitwise, with eager calls on the capturing side stream
    before and after."""
    gw = _group_weights(2, 13, cuda_device)
    x = _features((1, 256, 256, 64), 14, cuda_device)
    with torch.inference_mode():
        want = tgroup.fused_residual_group(x, gw, 0.2)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            tgroup.fused_residual_group(x, gw, 0.2)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = tgroup.fused_residual_group(x, gw, 0.2)
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert torch.equal(tgroup.fused_residual_group(x, gw, 0.2), want)


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
