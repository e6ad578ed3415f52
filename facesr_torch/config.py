"""YAML config loading and seeding (port of `facesr/config/config.py`).

The machine with the card has no PyYAML, so `load_config` reads the YAML
with the port's own reader (`facesr_torch.yaml_lite`), which resolves
scalars as PyYAML's ``safe_load`` does and raises outside the subset the
repo's configs use.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List

import numpy as np
import torch

from facesr_torch import yaml_lite

__all__ = ["load_config", "set_seed", "validate_config"]

_KNOWN_SECTIONS = {
    "project", "data", "augmentation", "model", "loss", "training",
    "checkpoint", "logging", "evaluation",
}


def validate_config(config: Dict[str, Any], path: str = "<config>") -> List[str]:
    """Light sanity checks of a loaded config. Warn-only: prints and returns
    the warnings, never raises."""
    warnings = []
    for key in config:
        if key not in _KNOWN_SECTIONS:
            warnings.append(f"unknown top-level section {key!r}")
    mtype = config.get("model", {}).get("type")
    if mtype is not None and mtype not in ("custom", "transfer", "esrgan"):
        warnings.append(f"unknown model.type {mtype!r}")
    sched = config.get("training", {}).get("scheduler", {}).get("type")
    if sched is not None and sched not in ("cosine", "step", "plateau", "none"):
        warnings.append(f"unknown scheduler type {sched!r}")
    gan_type = config.get("loss", {}).get("gan", {}).get("type")
    if gan_type is not None and gan_type not in ("vanilla", "lsgan", "wgan"):
        warnings.append(f"unknown gan type {gan_type!r}")
    scale = config.get("data", {}).get("scale_factor")
    if scale is not None:
        if not isinstance(scale, int) or isinstance(scale, bool):
            warnings.append(f"scale_factor {scale!r} should be an integer")
        elif (scale & (scale - 1)) != 0:
            warnings.append(f"scale_factor {scale} is not a power of 2")
    for w in warnings:
        print(f"Config warning ({path}): {w}")
    return warnings


def load_config(config_path: str) -> Dict[str, Any]:
    """Read and validate a YAML config."""
    cfg = yaml_lite.load_file(config_path) or {}
    validate_config(cfg, config_path)
    return cfg


def set_seed(seed: int) -> None:
    """Seed Python's `random`, numpy and torch (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    print(f"Random seed set to {seed}")
