"""The port's FaceEnhanceNet (facesr_torch.models) against the JAX package's
forward on the same weights, carried over as numpy, on the CPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from facesr.ckpt.export_torch import export_face_enhance_net_state_dict
from facesr.models import face_enhance_net as fen
from facesr.ops.pallas import rcab_group as jgroup
from facesr_torch.ckpt.weights import load_reference_pth, state_dict_from_jax_params
from facesr_torch.models import face_enhance_net as tfen
from facesr_torch.ops import rcab_group as tgroup
from facesr_torch.ops.rcab_group import prepare_group_weights
from facesr_torch.ops.resize import bicubic_up

torch.set_num_threads(1)

G, B, C = 2, 2, 16
KC = tgroup.KERNEL_CHANNELS  # the group kernel's width: the bf16 eval trunk's tests


def _params(seed=0, zero_last=False, c=C, k=3):
    """JAX params (numpy leaves), every leaf perturbed off its init so biases,
    PReLU slopes and a non-zero conv_last all count."""
    cfg = fen.FaceEnhanceNetConfig(num_channels=c, num_groups=G, blocks_per_group=B,
                                   kernel_size=k)
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32), params)
    if zero_last:
        params["conv_last"] = jax.tree.map(np.zeros_like, params["conv_last"])
    return cfg, params


def _port(params, c=C, k=3):
    model = tfen.FaceEnhanceNet(
        tfen.FaceEnhanceNetConfig(num_channels=c, num_groups=G, blocks_per_group=B,
                                  kernel_size=k), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model


def _x(seed=1, n=2, size=16):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


@pytest.mark.parametrize("train", [False, True])
def test_f32_forward_matches_jax(train):
    cfg, params = _params()
    x = _x()
    want = np.asarray(fen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg,
                                train=train))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x), train=train).numpy()
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_clamp_only_at_eval():
    cfg, params = _params(seed=2)
    params["conv_last"]["w"] = params["conv_last"]["w"] * 50  # push outside [0, 1]
    model = _port(params)
    x = torch.from_numpy(_x(seed=3))
    with torch.no_grad():
        raw = model(x, train=True)
        clipped = model(x, train=False)
    assert raw.min() < 0 or raw.max() > 1
    assert clipped.min() >= 0 and clipped.max() <= 1
    assert torch.equal(clipped, raw.clamp(0, 1))


def _jax_kernel_trunk(res_scale):
    def trunk(groups, feat):
        for g in range(jax.tree.leaves(groups)[0].shape[0]):
            gp = jax.tree.map(lambda a: a[g], groups)
            feat = jgroup.fused_residual_group(
                feat, jgroup.prepare_group_weights(gp), res_scale=res_scale,
                interpret=True)
        return feat
    return trunk


def test_bf16_forward_matches_jax_kernel_trunk():
    cfg, params = _params(seed=4, c=KC)
    x = _x(seed=5)
    want = np.asarray(fen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg,
                                dtype=jnp.bfloat16,
                                trunk_fn=_jax_kernel_trunk(cfg.res_scale)))
    with torch.no_grad():
        got = _port(params, c=KC)(torch.from_numpy(x), dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    # bf16 convs outside the trunk round in both frameworks, in other
    # accumulation orders; one bf16 ulp of a residual output near 0.5 is
    # 2e-3 and a few such roundings stack. Measured max abs: 3.9e-3 here,
    # 5.9e-3 at the worst of two other seeds.
    err = float(np.abs(got.numpy() - want).max())
    assert err < 1e-2, err


def _count_group_calls(monkeypatch):
    """Calls of `fused_residual_group` made through the model module."""
    calls = []
    real = tfen.fused_residual_group

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tfen, "fused_residual_group", counted)
    return calls


@pytest.mark.parametrize("c,k", [(32, 3), (16, 5)])
def test_bf16_eval_forward_of_a_config_off_the_kernel_matches_jax_apply(monkeypatch, c, k):
    """C != 64 or k != 3: the bf16 eval forward takes the plain trunk in
    bf16, as the JAX package's ``apply``, and never the group kernel. Both
    round every conv, PReLU and SE op to bf16 in other summation orders, so
    the outputs (in [0, 1]) sit some bf16 ulps of 0.5 (2e-3) apart: max abs
    <= 3e-2, mean abs <= 3e-3 (measured over three seeds: max 1.1e-2-2.4e-2,
    mean 1.0e-3-2.2e-3). And the port's bf16 output is nearer to JAX's bf16
    output than JAX's f32 output is, in the mean (measured 0.68-0.77 of
    it): an f32 trunk would not be."""
    cfg, params = _params(seed=18, c=c, k=k)
    x = _x(seed=19)
    jparams, jx = jax.tree.map(jnp.asarray, params), jnp.asarray(x)
    want = np.asarray(fen.apply(jparams, jx, cfg, dtype=jnp.bfloat16))
    jax_f32 = np.asarray(fen.apply(jparams, jx, cfg))
    model = _port(params, c=c, k=k)
    assert not model.kernel_trunk
    calls = _count_group_calls(monkeypatch)
    with torch.no_grad():
        got = model(torch.from_numpy(x), dtype=torch.bfloat16).numpy()
    assert not calls
    diff = np.abs(got - want)
    print(f"C={c} k={k}: max abs {diff.max():.3g}, mean abs {diff.mean():.3g}; JAX bf16 vs "
          f"f32 mean abs {np.abs(want - jax_f32).mean():.3g}")
    assert got.shape == want.shape and diff.max() <= 3e-2 and diff.mean() <= 3e-3
    assert diff.mean() < np.abs(want - jax_f32).mean()


def test_bf16_eval_forward_of_a_64_channel_3x3_config_runs_the_group_kernel(monkeypatch):
    cfg, params = _params(seed=20, c=KC)
    model = _port(params, c=KC)
    assert model.kernel_trunk
    assert not tfen.kernel_trunk_fits(model.config.replace(reduction_ratio=0.5))
    calls = _count_group_calls(monkeypatch)
    with torch.no_grad():
        model(torch.from_numpy(_x(seed=21)), dtype=torch.bfloat16)
        assert len(calls) == G
        model(torch.from_numpy(_x(seed=21)))  # f32: the plain trunk
    assert len(calls) == G


def test_kernel_weights_prepared_once_and_refreshed_on_change():
    _, params = _params(seed=14, c=KC)
    model = _port(params, c=KC)
    x = torch.from_numpy(_x(seed=15))
    with torch.inference_mode():
        first = model(x, dtype=torch.bfloat16)
        gws = model.kernel_group_weights()
        assert model.kernel_group_weights() is gws  # reused, not re-stacked
        with torch.no_grad():
            model.residual_groups[1].blocks[0].conv2.weight.mul_(3.0)
        fresh = model.kernel_group_weights()
        assert fresh is not gws
        want = prepare_group_weights(model.residual_groups[1])["w2"]
        assert torch.equal(fresh[1]["w2"], want)
        assert not torch.equal(gws[1]["w2"], want)
        assert not torch.equal(model(x, dtype=torch.bfloat16), first)
    # a bf16 training forward after the serving ones trains the trunk (the
    # plain trunk: the kernel is forward-only)
    model.zero_grad()
    model(x, train=True, dtype=torch.bfloat16).sum().backward()
    assert model.conv_first.weight.grad is not None
    assert model.residual_groups[1].blocks[0].conv2.weight.grad.abs().max() > 0
    model.to(torch.device("cpu"))
    assert model.kernel_group_weights() is not fresh


def test_bf16_forward_of_a_model_built_in_inference_mode():
    _, params = _params(seed=16, c=KC)
    x = torch.from_numpy(_x(seed=17))
    with torch.no_grad():
        want = _port(params, c=KC)(x, dtype=torch.bfloat16)
    with torch.inference_mode():
        model = _port(params, c=KC)  # inference-tensor parameters: no version counter
        assert torch.equal(model(x, dtype=torch.bfloat16), want)
        with torch.no_grad():
            model.residual_groups[0].blocks[1].conv1.bias.add_(0.5)
        assert not torch.equal(model(x, dtype=torch.bfloat16), want)


def test_zero_conv_last_gives_bicubic():
    _, params = _params(seed=6, zero_last=True)
    x = torch.from_numpy(_x(seed=7))
    model = _port(params)
    with torch.no_grad():
        for dtype in (None, torch.bfloat16):
            out = model(x, train=True, dtype=dtype)
            assert torch.equal(out, bicubic_up(x, 4))


def test_fresh_model_output_is_bicubic():
    model = tfen.FaceEnhanceNet(
        tfen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B),
        seed=3, device="cpu")
    x = torch.from_numpy(_x(seed=8))
    with torch.no_grad():
        assert torch.equal(model(x, train=True), bicubic_up(x, 4))


def test_attention_maps_match_jax():
    cfg, params = _params(seed=9)
    x = _x(seed=10)
    _, attn = fen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg,
                        collect_attention=True)
    maps = _port(params).get_attention_maps(torch.from_numpy(x))
    assert len(maps) == G * B
    for g in range(G):
        for b in range(B):
            np.testing.assert_allclose(maps[f"group{g}_rcab{b}"].numpy(),
                                       np.asarray(attn[g, b]), atol=2e-5, rtol=1e-4)


def test_param_count_and_model_info_match_jax_at_production_size():
    cfg = fen.FaceEnhanceNetConfig(num_groups=6, blocks_per_group=10, num_channels=64)
    shapes = jax.eval_shape(lambda k: fen.init(k, cfg), jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    model = tfen.FaceEnhanceNet(
        tfen.FaceEnhanceNetConfig(num_groups=6, blocks_per_group=10, num_channels=64),
        device="cpu")
    assert tfen.param_count(model) == want
    info = model.get_model_info()
    assert info["total_params"] == want and info["total_rcab_blocks"] == 60
    assert info["output_size"] == "256x256"


def test_reference_pth_loads_strict(tmp_path):
    cfg, params = _params(seed=11)
    sd = export_face_enhance_net_state_dict(params)
    path = tmp_path / "model.pth"
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "config": {"num_channels": C, "num_groups": G, "blocks_per_group": B,
                           "scale_factor": 4, "res_scale": 0.2},
                "epoch": 3}, path)
    model = load_reference_pth(str(path), device="cpu")
    assert model.config.num_groups == G and model.config.num_channels == C
    x = _x(seed=12)
    want = np.asarray(fen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    # strict: a missing key raises
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v))
                                     for k, v in list(sd.items())[1:]},
                "config": {"num_channels": C, "num_groups": G, "blocks_per_group": B}},
               path)
    with pytest.raises(RuntimeError):
        load_reference_pth(str(path), device="cpu")


def test_state_dict_keys_match_the_reference_exporter():
    _, params = _params(seed=13)
    got = state_dict_from_jax_params(params)
    want = export_face_enhance_net_state_dict(params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_config_replace_rejects_unknown_fields():
    cfg = tfen.FaceEnhanceNetConfig()
    assert cfg.replace(upscale_factor=2).scale_factor == 2
    with pytest.raises(TypeError):
        cfg.replace(num_chanels=32)
    with pytest.raises(TypeError):
        tfen.FaceEnhanceNet(device="cpu", bogus=1)
