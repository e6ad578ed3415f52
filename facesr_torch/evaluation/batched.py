"""Batched evaluation: LR synthesis and SR forwards for lists of images.

Port of `facesr/evaluation/batched.py`. The evaluation CLIs decode N
images, synthesise their LR on the device (the trainer's bicubic x1/scale,
`ops.resize.bicubic_down`) and run the model through the port's
`ShardedPredictor` (every visible card unless one device is named; on
one device it is `Predictor`) in chunks, one group of same-shaped images
at a time, in place of one batch-1 forward an image. With ``dtype=None`` the batched
forward is the per-image f32 computation; a batch's images are
independent in a conv net, so the metrics match the per-image path up to
the conv library's choice of summation order for each batch size, which
moves an SR value one uint8 level now and then
(tests/test_torch_eval_cli.py, `chip_smoke.py` phase 9).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.ops.resize import bicubic_down
from facesr_torch.parallel.serving import ShardedPredictor

__all__ = ["sr_batched", "synthesize_lr_batched", "make_predictor", "to_uint8"]


def to_uint8(img: np.ndarray) -> np.ndarray:
    """A float [0, 1] image as uint8: clip, x255, round half to even."""
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def synthesize_lr_batched(hr_uint8_list: Sequence[np.ndarray], scale: int, chunk: int = 32,
                          device: DeviceLike = None) -> List[np.ndarray]:
    """Trainer-matched LR synthesis (PyTorch-parity bicubic x1/scale) of a
    list of HWC uint8 images, on ``device`` (CUDA unless named), batching
    same-shaped images ``chunk`` at a time. Returns HWC float32 [0, 1]."""
    dev = resolve_device(device)
    out: List[Optional[np.ndarray]] = [None] * len(hr_uint8_list)
    with torch.inference_mode():
        for idxs in _groups_by_shape(hr_uint8_list).values():
            for start in range(0, len(idxs), chunk):
                sel = idxs[start:start + chunk]
                hr = np.stack([hr_uint8_list[i] for i in sel]).astype(np.float32) / 255.0
                lr = bicubic_down(torch.from_numpy(hr).to(dev), scale).cpu().numpy()
                for j, i in enumerate(sel):
                    out[i] = lr[j]
    return out  # type: ignore[return-value]


def make_predictor(model: torch.nn.Module, max_batch: Optional[int] = None, dtype=None,
                   device: DeviceLike = None,
                   calibration: Optional[np.ndarray] = None) -> ShardedPredictor:
    """A `ShardedPredictor` over every visible card (``device`` None or
    ``"cuda"``), or on the one device named, with the evaluation
    defaults: ``dtype`` None is f32
    (the per-image computation), ``torch.bfloat16`` the kernel trunk,
    "int8"/"int8_full" the quantized paths (``calibration``: LR images
    that calibrate int8_full's static activation scales); ``max_batch``
    128 on CUDA and 8 on the CPU. Build it once a model and reuse it
    across chunks."""
    dev = resolve_device(device)
    if max_batch is None:
        max_batch = 128 if dev.type == "cuda" else 8
    mesh = None if dev.type == "cuda" and dev.index is None else [dev]
    return ShardedPredictor(model, mesh=mesh, dtype=dtype, max_batch=max_batch,
                            calibration=calibration)


def sr_batched(model: Optional[torch.nn.Module], lr_float_list: Sequence[np.ndarray],
               max_batch: Optional[int] = None, dtype=None,
               predictor: Optional[ShardedPredictor] = None,
               device: DeviceLike = None) -> List[np.ndarray]:
    """SR of a list of HWC float [0, 1] LR images through a predictor
    (``predictor``, or `make_predictor`'s for ``model``), as HWC uint8 in
    input order."""
    if predictor is None:
        predictor = make_predictor(model, max_batch=max_batch, dtype=dtype, device=device)
    out: List[Optional[np.ndarray]] = [None] * len(lr_float_list)
    for idxs in _groups_by_shape(lr_float_list).values():
        sr = predictor(np.stack([lr_float_list[i] for i in idxs]))
        for j, i in enumerate(idxs):
            out[i] = to_uint8(sr[j])
    return out  # type: ignore[return-value]


def _groups_by_shape(images: Sequence[np.ndarray]) -> Dict[Tuple[int, ...], List[int]]:
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for i, im in enumerate(images):
        groups.setdefault(tuple(im.shape), []).append(i)
    return groups
