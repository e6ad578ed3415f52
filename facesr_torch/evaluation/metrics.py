"""Evaluation metrics: PSNR, SSIM, LPIPS, FID and the dataset evaluator.

Port of `facesr/evaluation/metrics.py`:

- `psnr` (one MSE over the whole batch) and `psnr_batch` (per image),
  both inf on an exact match;
- `PSNR` and `SSIM`, which reuses the training SSIM (`losses.ssim`);
- `LPIPS`, unavailable (0.0, ``available=False``) without converted
  weights;
- `MetricCalculator.evaluate_dataset`, which keeps the JAX package's
  aggregation: PSNR per image, SSIM and LPIPS as means of per-batch means;
- `compute_fid`, -1.0 only when the Inception backend is absent.

Tensors are NHWC on any device; a model runs where the caller put it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from facesr_torch.losses.ssim import ssim as compute_ssim
from facesr_torch.models import lpips as lpips_lib

__all__ = ["psnr", "psnr_batch", "PSNR", "SSIM", "LPIPS", "MetricCalculator", "compute_fid"]


def _psnr_of(mse: torch.Tensor, data_range: float) -> torch.Tensor:
    return torch.where(mse == 0, torch.full_like(mse, float("inf")),
                       10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-20)))


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """PSNR of the batch's mean squared error (any layout), f32."""
    return _psnr_of(torch.mean((pred.float() - target.float()) ** 2), data_range)


def psnr_batch(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR of an NHWC batch -> [N], inf where an image matches
    exactly (as `psnr` and skimage give)."""
    diff = pred.float() - target.float()
    return _psnr_of(torch.mean(diff * diff, dim=(1, 2, 3)), data_range)


class PSNR:
    def __init__(self, data_range: float = 1.0):
        self.data_range = data_range

    def __call__(self, pred, target):
        return psnr(pred, target, self.data_range)


class SSIM:
    def __init__(self, data_range: float = 1.0, window_size: int = 11):
        self.data_range = data_range
        self.window_size = window_size

    def __call__(self, pred, target):
        return compute_ssim(pred, target, window_size=self.window_size,
                            data_range=self.data_range)


class LPIPS:
    """LPIPS metric; unavailable (returns 0.0, as the reference wrapper
    does) unless converted AlexNet-LPIPS weights are found. The weights
    move to each input's device on first use there."""

    def __init__(self, net: str = "alex", weights_path: Optional[str] = None,
                 verbose: bool = False, assume_unit_range: bool = True):
        """assume_unit_range: inputs are in [0, 1] and map to [-1, 1]
        without a look at their values. False detects the range as the
        reference wrapper does, at the cost of a host read a call."""
        self.net = net
        self.assume_unit_range = assume_unit_range
        self.weights = lpips_lib.load_lpips_weights(weights_path)
        self.available = self.weights is not None
        self._on: Dict[torch.device, lpips_lib.Weights] = {}
        if not self.available and verbose:
            print("Warning: LPIPS weights not found. LPIPS metric unavailable "
                  f"(set ${lpips_lib.ENV_WEIGHTS} to converted weights).")

    def _weights_on(self, device: torch.device) -> lpips_lib.Weights:
        if device not in self._on:
            self._on[device] = {k: [{n: t.to(device) for n, t in p.items()} for p in v]
                                for k, v in self.weights.items()}
        return self._on[device]

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if not self.available:
            return torch.tensor(0.0)
        if self.assume_unit_range or float(pred.min()) >= 0:
            pred = pred * 2 - 1
            target = target * 2 - 1
        with torch.inference_mode():
            return lpips_lib.lpips_distance(self._weights_on(pred.device), pred, target)


class MetricCalculator:
    """Batch and dataset metrics."""

    def __init__(self, lpips_weights_path: Optional[str] = None):
        self.psnr = PSNR()
        self.ssim = SSIM()
        self.lpips = LPIPS(weights_path=lpips_weights_path)

    def compute_metrics(self, pred: torch.Tensor, target: torch.Tensor) -> Dict[str, float]:
        pred, target = torch.as_tensor(pred), torch.as_tensor(target)
        metrics = {"psnr": float(self.psnr(pred, target)),
                   "ssim": float(self.ssim(pred, target))}
        if self.lpips.available:
            metrics["lpips"] = float(self.lpips(pred, target))
        return metrics

    def evaluate_dataset(self, model: Callable, dataloader, desc: str = "Evaluating",
                         device: Optional[torch.device] = None) -> Dict[str, float]:
        """model: NHWC LR batch -> SR batch (clipped to [0, 1] here). Batches
        are ``{'lr', 'hr'}`` arrays or tensors, moved to ``device`` when
        given. Returns mean and std of each metric.

        The JAX package's (and reference's) aggregation, kept so numbers
        compare with published tables: PSNR per image; SSIM and LPIPS as
        unweighted means of per-batch means (a ragged last batch weighs
        its images more), their std across batch means."""
        all_psnr: List[float] = []
        all_ssim: List[float] = []
        all_lpips: List[float] = []
        with torch.inference_mode():
            for batch in dataloader:
                lr = torch.as_tensor(batch["lr"])
                hr = torch.as_tensor(batch["hr"])
                if device is not None:
                    lr, hr = lr.to(device), hr.to(device)
                sr = torch.clamp(model(lr), 0.0, 1.0)
                all_psnr.extend(psnr_batch(sr, hr).cpu().tolist())
                all_ssim.append(float(self.ssim(sr, hr)))
                if self.lpips.available:
                    all_lpips.append(float(self.lpips(sr, hr)))

        if not all_psnr:
            # np.mean([]) is NaN with only a warning and would poison the
            # tables and best-model choice downstream
            raise RuntimeError(
                "evaluate_dataset received zero batches — empty eval split, "
                "or batch_size larger than the split with drop_last?")
        results = {
            "psnr_mean": float(np.mean(all_psnr)),
            "psnr_std": float(np.std(all_psnr)),
            "ssim_mean": float(np.mean(all_ssim)),
            "ssim_std": float(np.std(all_ssim)),
        }
        if all_lpips:
            results["lpips_mean"] = float(np.mean(all_lpips))
            results["lpips_std"] = float(np.std(all_lpips))
        return results


def compute_fid(real_images: Sequence[np.ndarray], fake_images: Sequence[np.ndarray],
                device=None) -> float:
    """Fréchet Inception Distance; -1.0 with a warning when the Inception
    backend is absent (no weights), as the reference does without
    pytorch-fid. Any other failure raises."""
    from facesr_torch.evaluation.fid import FIDUnavailable, fid_from_images

    try:
        return fid_from_images(real_images, fake_images, device=device)
    except (FIDUnavailable, FileNotFoundError) as e:
        print(f"Warning: FID computation unavailable ({e}).")
        return -1.0
