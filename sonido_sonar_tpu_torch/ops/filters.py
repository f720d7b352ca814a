"""Pre-emphasis and DC removal (counterpart of
`sonido_sonar_tpu/ops/filters.py`).

Reference parity: algorithms/filters/pre_emphasis.go (per-content
coefficients :84-133) and dc_removal.go (1-pole DC blocker
y[n] = x[n] - x[n-1] + R y[n-1], default R = 0.995).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from sonido_sonar_tpu_torch.ops.tables import device_table

PRE_EMPHASIS_COEFFICIENTS = {
    # GetOptimalPreEmphasisCoefficient (pre_emphasis.go:112-133)
    "speech": 0.97,
    "music": 0.95,
    "broadcast": 0.96,
    "narrowband": 0.94,
    "wideband": 0.98,
    "general": 0.95,
}

_DC_CHUNK = 256
# carry taps below this weight are under float32 resolution and dropped
_DC_TAP_FLOOR = 1e-9


def pre_emphasis(signal: torch.Tensor, coefficient: float = 0.97) -> torch.Tensor:
    """y[n] = x[n] - a*x[n-1], y[0] = x[0], along the last axis."""
    shifted = F.pad(signal[..., :-1], (1, 0))
    return signal - coefficient * shifted


def pre_emphasis_coefficient(content_type: str) -> float:
    return PRE_EMPHASIS_COEFFICIENTS.get(content_type, 0.95)


def pre_emphasis_for_content(signal: torch.Tensor, content_type: str) -> torch.Tensor:
    """NewPreEmphasisForContent + ProcessBuffer (pre_emphasis.go:84-110)."""
    return pre_emphasis(signal, pre_emphasis_coefficient(content_type))


@functools.lru_cache(maxsize=8)
def _dc_chunk_kernel(pole: float, k: int) -> np.ndarray:
    """[K, K] upper-triangular pole^(j-i), designed in float64: row i of
    a chunk's input reaches output j >= i with weight pole^(j-i)."""
    i = np.arange(k)[:, None]
    j = np.arange(k)[None, :]
    return np.where(j >= i, float(pole) ** np.maximum(j - i, 0), 0.0)


@functools.lru_cache(maxsize=8)
def _dc_carry_powers(pole: float, k: int) -> np.ndarray:
    """[K] pole^(j+1): how the value before a chunk reaches its sample j."""
    return float(pole) ** (np.arange(k) + 1.0)


def dc_removal(signal: torch.Tensor, pole: float = 0.995) -> torch.Tensor:
    """DC blocker y[n] = x[n] - x[n-1] + R*y[n-1] (x[-1] = y[-1] = 0)
    along the last axis, in float32.

    Chunked: the in-chunk prefix is one matmul of the differences with
    the [K, K] pole^(j-i) kernel; the value entering chunk c is
    z[c-1] with z[c] = sum_m A^m last[c-m], A = pole^K, last[c] the
    in-chunk result at chunk c's final sample. Taps with A^m below 1e-9
    are dropped (under float32 resolution: 5 taps at R = 0.995)."""
    x = signal.to(torch.float32)
    diff = x - F.pad(x[..., :-1], (1, 0))
    n = diff.shape[-1]
    k = min(_DC_CHUNK, n)
    c = -(-n // k)
    chunks = F.pad(diff, (0, c * k - n)).reshape(diff.shape[:-1] + (c, k))
    dev = x.device
    y_in = torch.matmul(chunks, device_table(_dc_chunk_kernel, (pole, k), dev))
    last = y_in[..., -1]                                  # [..., C]
    a = float(pole) ** k
    taps = min(c, max(1, math.ceil(math.log(_DC_TAP_FLOOR) / math.log(a)) if a > 0 else 1))
    z = last.clone()
    for m in range(1, taps):
        z[..., m:] += (a ** m) * last[..., :-m]
    carry_prev = F.pad(z[..., :-1], (1, 0))               # z[c-1], 0 at c = 0
    y = y_in + carry_prev[..., None] * device_table(_dc_carry_powers, (pole, k), dev)
    return y.reshape(diff.shape[:-1] + (c * k,))[..., :n]
