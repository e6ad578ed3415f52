"""Models of the port: FaceEnhanceNet and the model zoo (RRDBNet /
ESRGANBaseline, TransferSRModel)."""

from facesr_torch.models.esrgan import ESRGANBaseline, RRDBNet, RRDBNetConfig
from facesr_torch.models.face_enhance_net import (
    FaceEnhanceNet, FaceEnhanceNetConfig, get_model_info, param_count,
)
from facesr_torch.models.transfer import TrainingStage, TransferModelConfig, TransferSRModel

__all__ = ["FaceEnhanceNet", "FaceEnhanceNetConfig", "get_model_info", "param_count",
           "RRDBNet", "RRDBNetConfig", "ESRGANBaseline", "TransferSRModel",
           "TransferModelConfig", "TrainingStage"]
