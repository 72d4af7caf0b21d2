"""Runtime knobs (port of ``env_flag`` in motioneditor_tpu/utils/runtime.py;
the JAX-only ``setup`` has no counterpart here)."""

from __future__ import annotations

import os


def env_flag(name: str, default: bool) -> bool:
    """Boolean env knob: unset -> default; common falsy spellings disable."""
    env = os.environ.get(name)
    if env is None:
        return default
    return env.strip().lower() not in ("0", "false", "no", "off", "")
