"""The explainability package (the JAX package's `facesr.explainability`):
the same names as `facesr_torch.evaluation.explainability`, one
implementation."""

from facesr_torch.evaluation.explainability import (
    FACE_REGIONS,
    AttentionExtractor,
    GradCAM,
    apply_heatmap,
    create_attention_report,
    create_gradcam_visualization,
    visualize_attention_flow,
)

__all__ = [
    "FACE_REGIONS",
    "GradCAM",
    "AttentionExtractor",
    "apply_heatmap",
    "create_gradcam_visualization",
    "create_attention_report",
    "visualize_attention_flow",
]
