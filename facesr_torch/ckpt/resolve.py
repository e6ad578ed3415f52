"""Where an optional converted-weights file is (the LPIPS AlexNet, the FID
InceptionV3): the port's copy of the JAX package's `resolve_weights_path`.

An environment variable that is set wins and must name a file that
exists: a mistyped path raises instead of turning the metric off. Unset,
``weights/<default_name>`` at the root of the repository is probed; when
that is absent too the answer is None and the metric reports itself
unavailable.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

__all__ = ["resolve_weights_path", "WEIGHTS_DIR"]

WEIGHTS_DIR = Path(__file__).resolve().parent.parent.parent / "weights"


def resolve_weights_path(env_var: str, default_name: str) -> Optional[str]:
    """The path of a converted-weights file, or None when there is none.
    Raises FileNotFoundError when ``env_var`` is set to a missing file."""
    p = os.environ.get(env_var)
    if p:
        if not os.path.exists(p):
            raise FileNotFoundError(f"${env_var}={p!r} does not exist; write the weights "
                                    "there or unset the variable")
        return p
    here = WEIGHTS_DIR / default_name
    return str(here) if here.exists() else None
