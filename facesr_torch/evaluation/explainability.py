"""Explainability: regression Grad-CAM and SE-attention extraction (port
of `facesr/evaluation/explainability.py`).

- `GradCAM`: the "class score" of a regression model is the mean of the
  SR output over a face region (`FACE_REGIONS` or a custom box), and the
  CAM is relu(sum_k w_k A_k) with w_k the spatial mean of dTarget/dA_k.
  The forward is split at the chosen residual group (`_split_forward`)
  and `torch.autograd.grad` is taken of the region mean with respect to
  the intermediate activation: no hooks, and the model's parameters are
  not differentiated (their ``requires_grad`` is off during the call and
  restored after).
- `AttentionExtractor`: the SE gate of every RCAB, through the model's
  `get_attention_maps` (the plain f32 trunk).
- `apply_heatmap`: a CAM overlaid on an image with cv2's float linear
  resize and JET colour map, both copied bitwise in `data.cv_compat`.

Everything runs in float32 under `full_f32()` (TF32 off), on the model's
device, through the plain trunk: the group kernel is forward-only and
bf16, and the JAX package differentiates its plain trunk as well.

The panels of `create_gradcam_visualization` and
`visualize_attention_flow` are composed here, as tiles side by side in
the JAX package's order, and written as PNG (`data.png`); without a
``save_path`` they return the panel as an [H, W, 3] uint8 array. They have
no titles (text drawing is ROADMAP A.8.2): `create_attention_report`'s
JSON lists each panel's columns under ``panel_columns``.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from facesr_torch.data.cv_compat import apply_colormap_jet, resize_linear_float
from facesr_torch.data.png import write_png
from facesr_torch.models import blocks
from facesr_torch.ops.conv import conv2d, full_f32
from facesr_torch.ops.resize import bicubic_up

__all__ = [
    "FACE_REGIONS",
    "GradCAM",
    "AttentionExtractor",
    "apply_heatmap",
    "create_attention_report",
    "create_gradcam_visualization",
    "visualize_attention_flow",
]

# Face region boxes as (y0, x0, y1, x1) fractions of the output image
FACE_REGIONS = {
    "full": (0.0, 0.0, 1.0, 1.0),
    "center": (0.25, 0.25, 0.75, 0.75),
    "eyes": (0.3, 0.2, 0.5, 0.8),
    "mouth": (0.6, 0.3, 0.85, 0.7),
}


@contextlib.contextmanager
def _params_frozen(model):
    """The model's parameters with ``requires_grad`` off for the block,
    each restored after."""
    params = list(model.parameters())
    saved = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, saved):
            p.requires_grad_(flag)


def _input(model, x) -> torch.Tensor:
    """An NHWC (or HWC) image, numpy or tensor, as a float32 batch on the
    model's device."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    if x.ndim == 3:
        x = x[None]
    # C-contiguous, as the model's other callers feed it: a strided view
    # takes other conv paths and moves the output in its last bits
    return x.to(next(model.parameters()).device, torch.float32).contiguous()


def _split_forward(model, x: torch.Tensor, split_group: int
                   ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """Run conv_first and groups[:split_group]; return the intermediate
    activation and a closure completing the forward pass from there (no
    clamp, as the JAX package's)."""
    cfg = model.config
    pad = cfg.kernel_size // 2
    skip = bicubic_up(x.float(), cfg.scale_factor)

    feat = conv2d(x, model.conv_first.weight, model.conv_first.bias, padding=pad)
    residual = feat
    if split_group > 0:
        feat, _ = blocks.residual_groups(model.residual_groups[:split_group], feat,
                                         cfg.res_scale, pad, remat="none")

    def finish(intermediate: torch.Tensor) -> torch.Tensor:
        h = intermediate
        if split_group < cfg.num_groups:
            h, _ = blocks.residual_groups(model.residual_groups[split_group:], h,
                                          cfg.res_scale, pad, remat="none")
        h = conv2d(h, model.conv_after_body.weight, model.conv_after_body.bias, padding=pad)
        # at split 0 the intermediate IS the conv_first output feeding the
        # long skip: rebind it so the gradient credits the skip's (large,
        # conv_last is near-zero-init) contribution to the CAM target
        h = h + (intermediate if split_group == 0 else residual)
        h = blocks.upsample(model.upsample, h)
        out = conv2d(h, model.conv_last.weight, model.conv_last.bias, padding=pad)
        return out.float() + skip

    return feat, finish


class GradCAM:
    """Region-aware Grad-CAM on a FaceEnhanceNet.

    target_layer: 'group{i}', the activation after residual group i
    (clamped to the model's group count), or 'conv_first' (= 'group0').
    """

    def __init__(self, model, target_layer: str = "group3"):
        self.model = model
        self.cfg = model.config
        if target_layer.startswith("group"):
            self.split_group = int(target_layer[len("group"):])
        elif target_layer == "conv_first":
            self.split_group = 0
        else:
            raise ValueError(f"Unknown target layer: {target_layer}")
        self.split_group = min(self.split_group, self.cfg.num_groups)

    def _region_box(self, region, out_hw) -> Tuple[int, int, int, int]:
        if isinstance(region, str):
            fy0, fx0, fy1, fx1 = FACE_REGIONS[region]
        else:
            fy0, fx0, fy1, fx1 = region
        H, W = out_hw
        return (int(fy0 * H), int(fx0 * W), max(int(fy1 * H), int(fy0 * H) + 1),
                max(int(fx1 * W), int(fx0 * W) + 1))

    def generate(self, x, region="full") -> np.ndarray:
        """x: NHWC LR input. Returns the CAM heatmap [N, h, w] in [0, 1] at
        the target layer's spatial resolution."""
        x = _input(self.model, x)
        with full_f32(), _params_frozen(self.model), torch.no_grad():
            feat, finish = _split_forward(self.model, x, self.split_group)
            return self._cam(feat, finish, x, region)

    def _cam(self, feat, finish, x, region) -> np.ndarray:
        out_hw = (x.shape[1] * self.cfg.scale_factor, x.shape[2] * self.cfg.scale_factor)
        y0, x0, y1, x1 = self._region_box(region, out_hw)
        with torch.enable_grad():
            a = feat.detach().requires_grad_(True)
            target = finish(a)[:, y0:y1, x0:x1, :].mean()
            (grads,) = torch.autograd.grad(target, a)  # dTarget/dA, NHWC
        weights = grads.mean(dim=(1, 2), keepdim=True)  # GAP over space
        cam = torch.relu((weights * feat).sum(dim=-1)).cpu().numpy()  # [N, h, w]
        cmin = cam.min(axis=(1, 2), keepdims=True)
        cmax = cam.max(axis=(1, 2), keepdims=True)
        return (cam - cmin) / (cmax - cmin + 1e-8)

    def generate_multi_region(self, x) -> Dict[str, np.ndarray]:
        # one head forward shared across regions: only the CAM target (and
        # its pullback) differs per region
        x = _input(self.model, x)
        with full_f32(), _params_frozen(self.model), torch.no_grad():
            feat, finish = _split_forward(self.model, x, self.split_group)
            return {name: self._cam(feat, finish, x, name) for name in FACE_REGIONS}


class AttentionExtractor:
    """Per-RCAB SE attention weights, keyed 'group{g}_rcab{b}'. A model
    without SE attention (RRDBNet, the transfer model) has none: {}."""

    def __init__(self, model):
        self.model = model

    def extract(self, x) -> Dict[str, np.ndarray]:
        if not hasattr(self.model, "get_attention_maps"):
            return {}
        with full_f32():
            maps = self.model.get_attention_maps(_input(self.model, x))
        return {k: v.cpu().numpy() for k, v in maps.items()}

    def summary(self, x) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, attn in self.extract(x).items():
            out[name] = {
                "mean": float(attn.mean()),
                "std": float(attn.std()),
                "min": float(attn.min()),
                "max": float(attn.max()),
            }
        return out


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return img


def apply_heatmap(image: np.ndarray, cam: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Overlay an [h, w] CAM in [0, 1] on an HWC uint8 or float image (JET
    colour map)."""
    img = _to_u8(image)
    h, w = img.shape[:2]
    cam_r = resize_linear_float(np.asarray(cam).astype(np.float32), (w, h))
    heat = apply_colormap_jet((cam_r * 255).astype(np.uint8))
    return (alpha * heat + (1 - alpha) * img).astype(np.uint8)


def _sr_image(model, x: torch.Tensor) -> np.ndarray:
    with full_f32(), torch.no_grad():
        return model(x)[0].cpu().numpy()


def _panel(tiles: List[np.ndarray], save_path: Optional[str]):
    panel = np.hstack(tiles)
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        write_png(save_path, panel)
        return None
    return panel


def create_gradcam_visualization(model, lr_image: np.ndarray, save_path: Optional[str] = None,
                                 target_layer: str = "group3"):
    """Panel: the SR output, then a CAM overlay for each face region
    (`gradcam_columns`). Written as PNG to ``save_path`` (returns None),
    else returned as an uint8 array."""
    x = _input(model, lr_image)
    sr = _sr_image(model, x)
    cams = GradCAM(model, target_layer).generate_multi_region(x)
    return _panel([_to_u8(sr)] + [apply_heatmap(sr, cam[0]) for cam in cams.values()],
                  save_path)


def visualize_attention_flow(model, lr_image: np.ndarray, save_path: Optional[str] = None):
    """CAMs of the full region after each residual group, beside the SR
    output; written or returned as `create_gradcam_visualization`."""
    x = _input(model, lr_image)
    sr = _sr_image(model, x)
    tiles = [_to_u8(sr)]
    for g in range(model.config.num_groups):
        cam = GradCAM(model, f"group{g + 1}").generate(x, "full")
        tiles.append(apply_heatmap(sr, cam[0]))
    return _panel(tiles, save_path)


def create_attention_report(model, lr_image: np.ndarray, save_dir: str,
                            target_layer: str = "group3") -> Dict[str, object]:
    """The explainability report of one image: ``gradcam_regions.png``,
    ``attention_flow.png`` and ``attention_report.json`` (per-RCAB SE
    attention statistics, the most and least active block, and the panels'
    columns). Returns the report. A model without SE attention maps
    raises ValueError."""
    if not hasattr(model, "get_attention_maps"):
        raise ValueError(
            f"{type(model).__name__} exposes no SE attention maps — the "
            "attention report needs a channel-attention model (FaceEnhanceNet)")
    out = Path(save_dir)
    out.mkdir(parents=True, exist_ok=True)
    create_gradcam_visualization(model, lr_image, save_path=str(out / "gradcam_regions.png"),
                                 target_layer=target_layer)
    visualize_attention_flow(model, lr_image, save_path=str(out / "attention_flow.png"))

    summary = AttentionExtractor(model).summary(_input(model, lr_image))
    if not summary:
        raise ValueError(
            f"{type(model).__name__} exposes no SE attention maps — the "
            "attention report needs a channel-attention model "
            "(FaceEnhanceNet); Grad-CAM panels were still written to "
            f"{out}")
    report = {
        "target_layer": target_layer,
        "attention_summary": summary,
        "most_active_block": max(summary, key=lambda k: summary[k]["mean"]),
        "least_active_block": min(summary, key=lambda k: summary[k]["mean"]),
        "panel_columns": {
            "gradcam_regions.png": ["SR output"] + [f"Grad-CAM: {r}" for r in FACE_REGIONS],
            "attention_flow.png": ["SR output"] + [f"after group {g + 1}"
                                                   for g in range(model.config.num_groups)],
        },
    }
    (out / "attention_report.json").write_text(json.dumps(report, indent=2))
    return report
