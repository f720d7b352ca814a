"""Pre-emphasis filter (counterpart of `sonido_sonar_tpu/ops/filters.py`).

Reference parity: algorithms/filters/pre_emphasis.go.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pre_emphasis(signal: torch.Tensor, coefficient: float = 0.97) -> torch.Tensor:
    """y[n] = x[n] - a*x[n-1], y[0] = x[0], along the last axis."""
    shifted = F.pad(signal[..., :-1], (1, 0))
    return signal - coefficient * shifted
