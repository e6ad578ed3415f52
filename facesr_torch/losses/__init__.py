"""Losses of the port: pixel, SSIM/MS-SSIM, VGG19 perceptual, combined."""

from facesr_torch.losses.basic import charbonnier_loss, l1_loss, l2_loss
from facesr_torch.losses.combined import (CombinedLoss, LossConfig, LossTracker,
                                          create_loss_function)
from facesr_torch.losses.perceptual import init_perceptual, perceptual_loss
from facesr_torch.losses.ssim import ms_ssim, ms_ssim_loss, ssim, ssim_loss

__all__ = ["l1_loss", "l2_loss", "charbonnier_loss", "ssim", "ms_ssim", "ssim_loss",
           "ms_ssim_loss", "init_perceptual", "perceptual_loss", "LossConfig",
           "CombinedLoss", "LossTracker", "create_loss_function"]
