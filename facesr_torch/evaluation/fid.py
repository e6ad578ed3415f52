"""Fréchet Inception Distance on the port's InceptionV3 (`models.inception`).

Port of `facesr/evaluation/fid.py`. The Fréchet step is numpy f64 (the
two-``eigh`` symmetric form); the activations run on the card unless the
caller names another device. Without converted InceptionV3 weights
(``$FACESR_INCEPTION_WEIGHTS`` or ``weights/inception_fid.fckpt``) FID is
unavailable: `fid_from_images` raises `FIDUnavailable`, which callers
turn into a missing column.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.models import inception

__all__ = ["frechet_distance", "fid_from_activations", "inception_activations",
           "fid_from_images", "FIDUnavailable"]


class FIDUnavailable(RuntimeError):
    """The FID backend cannot run (no converted InceptionV3 weights), as
    distinct from a failure while it runs."""


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    diff = mu1 - mu2
    # Tr(sqrt(S1 S2)) by the symmetric form: eig(S1 S2) == eig(R S2 R^T)
    # with R = sqrt(S1), two symmetric eigh calls in place of the
    # eigenvalues of a nonsymmetric product
    w1, v1 = np.linalg.eigh((sigma1 + sigma1.T) / 2)
    root1 = (v1 * np.sqrt(np.clip(w1, 0, None))) @ v1.T
    m = root1 @ ((sigma2 + sigma2.T) / 2) @ root1
    eigvals = np.linalg.eigvalsh((m + m.T) / 2)
    covmean_trace = np.sum(np.sqrt(np.clip(eigvals, 0, None)))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * covmean_trace)


def fid_from_activations(act1: np.ndarray, act2: np.ndarray) -> float:
    """FID between two activation sets [N, D]."""
    if act1.shape[0] < 2 or act2.shape[0] < 2:
        # np.cov of one row is a scalar, and eigh would fail without naming
        # the cause
        raise ValueError(
            f"FID needs >=2 images per set to estimate covariances "
            f"(got {act1.shape[0]} vs {act2.shape[0]})")
    mu1, mu2 = act1.mean(axis=0), act2.mean(axis=0)
    s1 = np.cov(act1, rowvar=False)
    s2 = np.cov(act2, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)


def _to_float(img: np.ndarray) -> np.ndarray:
    """HWC float32 in [0, 1] with 3 channels: uint8 / 255, floats as they
    are, grey (2-D or one channel) repeated."""
    arr = np.asarray(img)
    arr = arr.astype(np.float32) / 255.0 if arr.dtype == np.uint8 else arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return arr


def inception_activations(images: Sequence[np.ndarray], weights: Dict,
                          batch_size: int = 32, device: DeviceLike = None) -> np.ndarray:
    """Pool3 activations [N, 2048] (f32) of a list of HWC images, uint8 or
    float in [0, 1], of mixed sizes. Each batch is resized to 299x299
    (bilinear, pytorch-fid's default) one group of same-shaped images at
    a time, on ``device`` (CUDA unless named), then runs the network at
    its own size (no padding of a ragged tail)."""
    dev = resolve_device(device)
    weights = {n: {k: t.to(dev) for k, t in p.items()} for n, p in weights.items()}
    size = (inception.INPUT_SIZE, inception.INPUT_SIZE)
    outs = []
    with torch.inference_mode():
        for start in range(0, len(images), batch_size):
            chunk = [_to_float(im) for im in images[start:start + batch_size]]
            by_shape: Dict[tuple, List[int]] = {}
            for i, im in enumerate(chunk):
                by_shape.setdefault(im.shape, []).append(i)
            batch: List[Optional[torch.Tensor]] = [None] * len(chunk)
            for shape, idxs in by_shape.items():
                x = torch.from_numpy(np.stack([chunk[i] for i in idxs])).to(dev)
                if shape[:2] != size:
                    x = inception.resize2d(x, size, method="bilinear")
                for j, i in enumerate(idxs):
                    batch[i] = x[j]
            acts = inception.apply(weights, torch.stack(batch), resize_input=False)
            outs.append(acts.cpu().numpy())
    return np.concatenate(outs, axis=0)


def fid_from_images(real_images: Sequence[np.ndarray], fake_images: Sequence[np.ndarray],
                    weights: Optional[Dict] = None, batch_size: int = 32,
                    device: DeviceLike = None) -> float:
    """FID between two image sets. Raises `FIDUnavailable` without
    weights."""
    if weights is None:
        weights = inception.load_inception_weights()
    if weights is None:
        raise FIDUnavailable(f"InceptionV3 weights unavailable: set ${inception.ENV_WEIGHTS} to a "
                             "converted inception_fid.fckpt")
    act_real = inception_activations(real_images, weights, batch_size, device)
    act_fake = inception_activations(fake_images, weights, batch_size, device)
    return fid_from_activations(act_real, act_fake)
