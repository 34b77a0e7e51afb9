"""Shape helpers (the part of ``marlin_tpu/utils/split.py`` the port
uses)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to_multiple(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to the next multiple of ``mult``."""
    extra = (-x.shape[axis]) % mult
    if not extra:
        return x
    axis %= x.dim()
    # F.pad lists (before, after) pairs from the LAST axis backwards.
    pads = [0, 0] * (x.dim() - 1 - axis) + [0, extra]
    return F.pad(x, pads)
