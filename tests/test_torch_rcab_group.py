"""The port's residual-group kernel module (facesr_torch.ops.rcab_group)
against the Pallas kernel of the JAX package, run in interpret mode on the
CPU. The CUDA kernel itself runs only on a card: its test, marked ``gpu``,
is in test_torch_gpu.py, which imports no JAX."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from facesr.models import face_enhance_net as fen
from facesr.ops.pallas import rcab_group as jgroup
from facesr_torch.ckpt.weights import state_dict_from_jax_params
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.ops import rcab_group as tgroup

torch.set_num_threads(1)


def _one_group(B, C=64, seed=0):
    """A 1-group model in both packages from the same numpy weights; biases
    and PReLU slopes perturbed off their init so every term counts.
    Returns (port ResidualGroup, JAX per-group params)."""
    cfg = dict(num_channels=C, num_groups=1, blocks_per_group=B)
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(seed),
                                               fen.FaceEnhanceNetConfig(**cfg)))
    rng = np.random.default_rng(seed + 100)
    rc = params["groups"]["rcab"]
    for name in ("conv1_b", "conv2_b"):
        rc[name] = (rng.standard_normal(rc[name].shape) * 0.05).astype(np.float32)
    rc["prelu_a"] = (0.25 + rng.standard_normal(rc["prelu_a"].shape) * 0.05).astype(np.float32)
    params["groups"]["conv_b"] = (
        rng.standard_normal(params["groups"]["conv_b"].shape) * 0.05).astype(np.float32)
    model = FaceEnhanceNet(FaceEnhanceNetConfig(**cfg), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    gp = jax.tree.map(lambda a: jnp.asarray(a[0]), params["groups"])
    return model.residual_groups[0], gp


# the third case is wider than one 64-pixel tile of the CUDA kernel; the
# last one also has an H that its 4-row units do not divide and a partial
# last column tile, as the scratch variant spread over clusters cuts it
@pytest.mark.parametrize("shape,B,seed", [((2, 16, 16, 64), 3, 0), ((1, 8, 8, 64), 1, 1),
                                          ((1, 32, 80, 64), 1, 2), ((1, 18, 72, 64), 1, 3)])
def test_plain_group_matches_pallas_interpret(shape, B, seed):
    group, gp = _one_group(B, seed=seed)
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    want = np.asarray(jgroup.fused_residual_group(
        jnp.asarray(x), jgroup.prepare_group_weights(gp), res_scale=0.2, interpret=True))
    got = tgroup.rcab_group_reference(torch.from_numpy(x),
                                      tgroup.prepare_group_weights(group), 0.2)
    assert got.dtype == torch.float32 and got.shape == shape
    # Both round the output to bf16 and sum in different orders, so an
    # element may land one bf16 ulp apart (1.6e-2 for |out| in [2, 4));
    # measured max abs: 1.5625e-2 (1.6% of elements differ) and 4.9e-4.
    err = float(np.abs(got.numpy() - want).max())
    assert err < 2e-2, err


def test_prepare_group_weights_gives_jax_layout():
    group, gp = _one_group(B=2, C=16, seed=3)
    got = tgroup.prepare_group_weights(group)
    want = jgroup.prepare_group_weights(gp)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert g.is_contiguous(), k
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=k)
        else:
            assert g.dtype == torch.float32, k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


def test_wrapper_takes_plain_path_on_cpu():
    group, _ = _one_group(B=1, C=64, seed=4)
    gw = tgroup.prepare_group_weights(group)
    x = torch.rand(1, 8, 12, 64, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    before = tgroup.fused_residual_group.launches
    got = tgroup.fused_residual_group(x, gw, 0.2)
    assert tgroup.fused_residual_group.launches == before  # no kernel launch on CPU
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, tgroup.rcab_group_reference(x, gw, 0.2))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    group, _ = _one_group(B=1, C=64, seed=5)
    gw = tgroup.prepare_group_weights(group)
    x = torch.rand(1, 8, 8, 64).to(torch.bfloat16)
    with pytest.raises(TypeError):
        tgroup.fused_residual_group(x.float(), gw)
    with pytest.raises(ValueError):
        tgroup.fused_residual_group(x.transpose(1, 2), gw)  # not contiguous
    bad = dict(gw, w1=gw["w1"].float())
    with pytest.raises(ValueError):
        tgroup.fused_residual_group(x, bad)
    with pytest.raises(ValueError):
        tgroup.fused_residual_group(x.to("meta"), gw)


def test_half_image_se_control_is_rejected_by_the_kernel_tolerance():
    """The control of chip_smoke.py's split check has teeth: a plain group
    whose SE mean covers the first half of the rows only (what an image
    spread over clusters computes without the image-wide sum) differs from
    the plain version by more than the kernel tolerance, on the check's
    input, whose rows darken towards the top; the kernel's own tolerance
    (one bf16 ulp) is what holds it."""
    import chip_smoke

    gw = chip_smoke.group_weights(chip_smoke.seeded_group(2, 7), "cpu")
    x = chip_smoke.check_input((1, 32, 40, 64), 7, "cpu")
    want = tgroup.rcab_group_reference(x, gw, 0.2)
    *_, excess = chip_smoke.group_diff(
        chip_smoke.planted_fault_group(x, gw, 0.2, chip_smoke.SPLIT_FAULT), want)
    assert excess > 0
    *_, same = chip_smoke.group_diff(chip_smoke.planted_fault_group(x, gw, 0.2, None), want)
    assert same <= 0


def test_profile_group_anchors_match_the_kernel_source():
    """profile_group marks a copy of the kernel source by text: every anchor
    is found as often as it expects, for both variants."""
    from facesr_torch.cli import profile_group
    from facesr_torch.ops import _build

    src = (_build.CSRC / "rcab_group.cu").read_text()
    for anchor, before, after, count in profile_group.ANCHORS + profile_group.S_ANCHORS:
        assert src.count(anchor) == count, anchor
        src = src.replace(anchor, before + anchor + after)
    assert len(profile_group.S_NAMES) < 48  # the durations' slots start at 48
