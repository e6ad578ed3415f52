"""The port's explainability (facesr_torch.evaluation.explainability) against
the JAX package's on the same weights and inputs, on the CPU: Grad-CAM at
every target layer and region, the SE attention, the heatmap overlay (its
float linear resize and JET colour map against cv2), and the report.

Sizes: FaceEnhanceNet G=2, B=2, C=16 (tests/test_evaluation.py's
explainability size), every leaf perturbed off its init and conv_last
redrawn non-zero so gradients reach the trunk; a batch of 2 16x16 inputs.

Limits: CAM max abs <= 1e-4 (f32 convs in other summation orders, then a
min-max normalisation); attention maps and their statistics max abs
<= 1e-6; the heatmap, the JET table and the float linear resize bitwise.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facesr.evaluation import explainability as jex
from facesr.models import face_enhance_net as fen
from facesr_torch.ckpt.weights import jax_params_from, state_dict_from_jax_params
from facesr_torch.data import cv_compat
from facesr_torch.evaluation import explainability as tex
from facesr_torch.models import blocks
from facesr_torch.models.esrgan import RRDBNet, RRDBNetConfig
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.ops.conv import conv2d
from facesr_torch.ops.resize import bicubic_up

torch.set_num_threads(1)

CAM_ATOL, ATTN_ATOL = 1e-4, 1e-6
G, B, C = 2, 2, 16
LAYERS = ("conv_first", "group1", "group2")
CUSTOM_BOX = (0.1, 0.15, 0.4, 0.9)


def _params(seed=0):
    """(JAX config, JAX params as numpy) of a seeded port model, every leaf
    moved off its init and conv_last redrawn non-zero (JAX's eager init
    costs seconds a tree)."""
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=C, num_groups=G,
                                                blocks_per_group=B), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
        model.conv_last.weight.normal_(0, 0.05, generator=gen)
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    return cfg, jax_params_from(model)


@pytest.fixture(scope="module")
def models():
    cfg, params = _params()
    jm = fen.FaceEnhanceNet(cfg, params=jax.tree.map(jnp.asarray, params))
    tm = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=C, num_groups=G,
                                             blocks_per_group=B), device="cpu")
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    x = np.random.default_rng(1).random((2, 16, 16, 3), dtype=np.float32)
    return jm, tm, x


@pytest.fixture(scope="module")
def jax_cams(models):
    """JAX's CAMs of every target layer: the four regions (one shared head
    forward) and the custom box."""
    jm, _, x = models
    out = {}
    for layer in LAYERS:
        cam = jex.GradCAM(jm, layer)
        out[layer] = dict(cam.generate_multi_region(jnp.asarray(x)))
        out[layer]["custom"] = cam.generate(jnp.asarray(x), CUSTOM_BOX)
    return out


@pytest.mark.parametrize("layer", LAYERS)
def test_gradcam_matches_jax_at_every_layer_and_region(models, jax_cams, layer):
    _, tm, x = models
    cam = tex.GradCAM(tm, layer)
    got = dict(cam.generate_multi_region(x))
    got["custom"] = cam.generate(x, CUSTOM_BOX)
    assert set(got) == set(jax_cams[layer]) == set(tex.FACE_REGIONS) | {"custom"}
    errs = {}
    for region, want in jax_cams[layer].items():
        assert got[region].shape == want.shape == (2, 16, 16)
        assert got[region].dtype == want.dtype == np.float32
        errs[region] = float(np.abs(got[region] - want).max())
    print(f"{layer}: CAM max abs per region {errs}")
    assert max(errs.values()) <= CAM_ATOL
    # the region mean's pullback moved nothing of the model
    assert all(p.grad is None and p.requires_grad for p in tm.parameters())


def test_multi_region_equals_generate_per_region_and_layers_clamp(models):
    _, tm, x = models
    cam = tex.GradCAM(tm, "group1")
    multi = cam.generate_multi_region(x)
    for region in tex.FACE_REGIONS:
        np.testing.assert_array_equal(multi[region], cam.generate(x, region))
    assert tex.GradCAM(tm, "group9").split_group == G
    assert tex.GradCAM(tm, "conv_first").split_group == tex.GradCAM(tm, "group0").split_group == 0
    with pytest.raises(ValueError, match="Unknown target layer"):
        tex.GradCAM(tm, "conv_last")
    # the _region_box guards keep a one-pixel region when a box collapses
    assert cam._region_box((0.5, 0.5, 0.5, 0.5), (64, 64)) == (32, 32, 33, 33)


def _split_forward_without_rebinding(model, x, split_group):
    """A planted fault: at split 0 the long skip reads the conv_first
    output as a constant, so the CAM loses the skip's contribution."""
    cfg = model.config
    pad = cfg.kernel_size // 2
    skip = bicubic_up(x.float(), cfg.scale_factor)
    feat = conv2d(x, model.conv_first.weight, model.conv_first.bias, padding=pad)
    residual = feat

    def finish(intermediate):
        h, _ = blocks.residual_groups(model.residual_groups, intermediate, cfg.res_scale, pad,
                                      remat="none")
        h = conv2d(h, model.conv_after_body.weight, model.conv_after_body.bias, padding=pad)
        h = h + residual
        h = blocks.upsample(model.upsample, h)
        return conv2d(h, model.conv_last.weight, model.conv_last.bias, padding=pad) + skip

    return feat, finish


def test_a_cam_without_the_split0_rebinding_is_rejected(models, jax_cams, monkeypatch):
    _, tm, x = models
    monkeypatch.setattr(tex, "_split_forward", _split_forward_without_rebinding)
    got = tex.GradCAM(tm, "conv_first").generate_multi_region(x)
    err = max(float(np.abs(got[r] - jax_cams["conv_first"][r]).max()) for r in got)
    print(f"CAM without the split-0 rebinding: max abs {err:.3g}")
    assert err > CAM_ATOL


def test_attention_extract_and_summary_match_jax(models):
    jm, tm, x = models
    want = jex.AttentionExtractor(jm).extract(jnp.asarray(x))
    got = tex.AttentionExtractor(tm).extract(x)
    assert list(got) == list(want) == [f"group{g}_rcab{b}" for g in range(G) for b in range(B)]
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= ATTN_ATOL
    ws, gs = jex.AttentionExtractor(jm).summary(jnp.asarray(x)), tex.AttentionExtractor(tm).summary(x)
    assert gs.keys() == ws.keys()
    assert max(abs(gs[k][s] - ws[k][s]) for k in ws for s in ws[k]) <= ATTN_ATOL
    assert tex.AttentionExtractor(RRDBNet(RRDBNetConfig(num_feat=8, num_blocks=1, num_grow_ch=4),
                                          device="cpu")).summary(x) == {}


def test_jet_table_and_float_linear_resize_are_cv2s():
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = cv2.cvtColor(cv2.applyColorMap(levels, cv2.COLORMAP_JET), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(cv_compat.apply_colormap_jet(levels), want)
    rng = np.random.default_rng(2)
    for src, dst in (((8, 8), (32, 32)), ((16, 16), (64, 64)), ((64, 64), (256, 256)),
                     ((7, 7), (30, 30)), ((5, 9), (37, 21)), ((40, 24), (13, 31))):
        img = rng.random(src, dtype=np.float32)
        np.testing.assert_array_equal(cv_compat.resize_linear_float(img, dst[::-1]),
                                      cv2.resize(img, dst[::-1]), err_msg=f"{src}->{dst}")
    rgb = rng.random((6, 7, 3), dtype=np.float32)
    np.testing.assert_array_equal(cv_compat.resize_linear_float(rgb, (20, 11)),
                                  cv2.resize(rgb, (20, 11)))
    with pytest.raises(ValueError):
        cv_compat.resize_linear_float(levels, (4, 4))


@pytest.mark.parametrize("cam_hw,img_hw", [(8, 32), (16, 64), (64, 256), (7, 30)])
def test_apply_heatmap_is_the_jax_functions(cam_hw, img_hw):
    rng = np.random.default_rng(cam_hw)
    cam = rng.random((cam_hw, cam_hw), dtype=np.float32)
    cam[0, 0], cam[-1, -1] = 0.0, 1.0
    img_f = rng.random((img_hw, img_hw, 3), dtype=np.float32) * 1.2 - 0.1
    img_u8 = rng.integers(0, 256, (img_hw, img_hw, 3), dtype=np.uint8)
    for img in (img_f, img_u8):
        for alpha in (0.5, 0.3):
            np.testing.assert_array_equal(tex.apply_heatmap(img, cam, alpha),
                                          jex.apply_heatmap(img, cam, alpha))


def test_attention_report_matches_jax_and_its_panels_are_the_ports_tiles(models, tmp_path):
    jm, tm, x = models
    lr = np.ascontiguousarray(x[0, :8, :8])
    want = jex.create_attention_report(jm, lr, str(tmp_path / "jax"), target_layer="group1")
    got = tex.create_attention_report(tm, lr, str(tmp_path / "port"), target_layer="group1")
    assert set(got) == set(want) | {"panel_columns"}
    for key in ("target_layer", "most_active_block", "least_active_block"):
        assert got[key] == want[key], key
    assert got["attention_summary"].keys() == want["attention_summary"].keys()
    assert json.loads((tmp_path / "port" / "attention_report.json").read_text()) == got
    assert {p.name for p in (tmp_path / "port").iterdir()} == {
        p.name for p in (tmp_path / "jax").iterdir()}

    from facesr_torch.data.png import read_rgb

    sr = tex._sr_image(tm, tex._input(tm, lr))  # the module's own f32 eval forward
    side = 8 * tm.config.scale_factor
    regions = read_rgb(tmp_path / "port" / "gradcam_regions.png")
    cams = tex.GradCAM(tm, "group1").generate_multi_region(lr[None])
    tiles = [tex._to_u8(sr)] + [tex.apply_heatmap(sr, c[0]) for c in cams.values()]
    assert regions.shape == (side, side * len(tiles), 3)
    assert got["panel_columns"]["gradcam_regions.png"] == ["SR output"] + [
        f"Grad-CAM: {r}" for r in tex.FACE_REGIONS]
    np.testing.assert_array_equal(regions, np.hstack(tiles))
    flow = tex.visualize_attention_flow(tm, lr)
    assert flow.dtype == np.uint8 and flow.shape == (side, side * (G + 1), 3)
    np.testing.assert_array_equal(flow, read_rgb(tmp_path / "port" / "attention_flow.png"))
    np.testing.assert_array_equal(
        flow[:, side:2 * side], tex.apply_heatmap(sr, tex.GradCAM(tm, "group1").generate(
            lr[None], "full")[0]))
    assert got["panel_columns"]["attention_flow.png"] == [
        "SR output", "after group 1", "after group 2"]
    np.testing.assert_array_equal(tex.create_gradcam_visualization(tm, lr, target_layer="group1"),
                                  regions)


def test_attention_report_refuses_a_model_without_se_maps(tmp_path):
    model = RRDBNet(RRDBNetConfig(num_feat=8, num_blocks=1, num_grow_ch=4), device="cpu")
    with pytest.raises(ValueError, match="exposes no SE attention maps"):
        tex.create_attention_report(model, np.zeros((8, 8, 3), np.float32), str(tmp_path))


def test_the_explainability_package_reexports_one_implementation():
    import facesr_torch.evaluation as ev
    import facesr_torch.explainability as pkg

    for name in pkg.__all__:
        assert getattr(pkg, name) is getattr(tex, name) is getattr(ev, name)
    assert sorted(pkg.__all__) == sorted(__import__("facesr.explainability",
                                                    fromlist=["x"]).__all__)
