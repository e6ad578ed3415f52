"""Evaluation of the port: metrics (PSNR/SSIM/LPIPS/FID), skimage-compatible
evaluation metrics, explainability (Grad-CAM, SE attention), and what of
the visualisation needs no matplotlib."""

from facesr_torch.evaluation.explainability import (
    FACE_REGIONS,
    AttentionExtractor,
    GradCAM,
    apply_heatmap,
    create_attention_report,
    create_gradcam_visualization,
    visualize_attention_flow,
)
from facesr_torch.evaluation.metrics import (
    LPIPS,
    PSNR,
    SSIM,
    MetricCalculator,
    compute_fid,
    psnr,
    psnr_batch,
)
from facesr_torch.evaluation.skimage_compat import (
    peak_signal_noise_ratio,
    structural_similarity,
)
from facesr_torch.evaluation.visualize import (
    create_metrics_table,
    save_sr_result,
    tensor_to_image,
)

__all__ = [
    "psnr",
    "psnr_batch",
    "PSNR",
    "SSIM",
    "LPIPS",
    "MetricCalculator",
    "compute_fid",
    "peak_signal_noise_ratio",
    "structural_similarity",
    "tensor_to_image",
    "create_metrics_table",
    "save_sr_result",
    "FACE_REGIONS",
    "GradCAM",
    "AttentionExtractor",
    "apply_heatmap",
    "create_gradcam_visualization",
    "create_attention_report",
    "visualize_attention_flow",
]
