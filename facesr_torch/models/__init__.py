"""Models of the port."""

from facesr_torch.models.face_enhance_net import (
    FaceEnhanceNet, FaceEnhanceNetConfig, get_model_info, param_count,
)

__all__ = ["FaceEnhanceNet", "FaceEnhanceNetConfig", "get_model_info",
           "param_count"]
