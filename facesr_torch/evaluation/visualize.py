"""Visualisation helpers of the evaluation (port of
`facesr/evaluation/visualize.py`).

Ported: `tensor_to_image`, `save_sr_result` (PNG through the port's own
encoder, `data.png`) and `create_metrics_table` (text). The explainability
panels are composed without matplotlib (`evaluation.explainability`). The
three matplotlib figures here (`create_comparison_grid`,
`create_zoom_comparison`, `plot_training_curves`) raise
NotImplementedError: the card's machine has no matplotlib, and their port
as PNGs the port draws itself is ROADMAP A.8.4.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from facesr_torch.data.png import write_png

__all__ = ["tensor_to_image", "create_comparison_grid", "create_zoom_comparison",
           "create_metrics_table", "plot_training_curves", "save_sr_result"]


def tensor_to_image(tensor) -> np.ndarray:
    """HWC/NHWC float [0,1] (or CHW torch-style), numpy or tensor -> HWC
    uint8 (one channel squeezed to 2-D)."""
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().cpu().numpy()
    arr = np.asarray(tensor)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = arr.transpose(1, 2, 0)  # CHW -> HWC
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    return arr


def _figures_not_ported(name: str):
    def figure(*args, **kwargs):
        raise NotImplementedError(
            f"{name} draws a matplotlib figure, which is not ported (the card's machine "
            "has no matplotlib; ROADMAP A.8.4)")
    figure.__name__ = name
    figure.__doc__ = f"Not ported: {name} needs matplotlib (ROADMAP A.8.4)."
    return figure


create_comparison_grid = _figures_not_ported("create_comparison_grid")
create_zoom_comparison = _figures_not_ported("create_zoom_comparison")
plot_training_curves = _figures_not_ported("plot_training_curves")


def create_metrics_table(results: Dict[str, Dict[str, float]], save_path=None,
                         metrics: Sequence[str] = ("psnr", "ssim", "lpips")) -> str:
    """Markdown table of per-method metrics."""
    header = "| Method | " + " | ".join(m.upper() for m in metrics) + " |"
    sep = "|---" * (len(metrics) + 1) + "|"
    rows = [header, sep]
    for method, vals in results.items():
        cells = []
        for m in metrics:
            v = vals.get(m, vals.get(f"{m}_mean"))
            cells.append(f"{v:.4f}" if v is not None else "—")
        rows.append(f"| {method} | " + " | ".join(cells) + " |")
    table = "\n".join(rows)
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        Path(save_path).write_text(table + "\n")
    return table


def save_sr_result(sr_image, save_path: str) -> None:
    """Save an SR output (any form `tensor_to_image` takes) as a PNG."""
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    write_png(save_path, tensor_to_image(sr_image))
