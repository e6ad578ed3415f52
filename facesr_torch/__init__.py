"""facesr_torch — the PyTorch/CUDA port of facesr for NVIDIA Hopper.

Beside the JAX package `facesr`, which stays the reference. Public
functions take NHWC tensors like their JAX counterparts; parameters use
torch's OIHW layout and the reference state-dict key names. Entry points
run on CUDA unless the caller passes ``device="cpu"``; with no card and
no device they raise instead of falling back.

This package imports torch and numpy only — never jax, flax, optax or
anything of `facesr`.
"""

from facesr_torch.device import resolve_device

__all__ = ["resolve_device"]
