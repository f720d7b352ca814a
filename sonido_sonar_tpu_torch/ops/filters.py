"""Pre-emphasis and DC removal (counterpart of
`sonido_sonar_tpu/ops/filters.py`).

Reference parity: algorithms/filters/pre_emphasis.go (per-content
coefficients :84-133, adaptive variant, frequency response),
dc_removal.go (1-pole DC blocker y[n] = x[n] - x[n-1] + R y[n-1],
default R = 0.995, R = 1 - 2 pi fc/fs for a cutoff) and bandpass.go (RBJ
biquad bandpass). The recursive filters run as block scans (below).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sonido_sonar_tpu_torch.ops.tables import device_table
from sonido_sonar_tpu_torch.utils.device import require_fp32_matmuls

PRE_EMPHASIS_COEFFICIENTS = {
    # GetOptimalPreEmphasisCoefficient (pre_emphasis.go:112-133)
    "speech": 0.97,
    "music": 0.95,
    "broadcast": 0.96,
    "narrowband": 0.94,
    "wideband": 0.98,
    "general": 0.95,
}

def pre_emphasis(signal: torch.Tensor, coefficient: float = 0.97) -> torch.Tensor:
    """y[n] = x[n] - a*x[n-1], y[0] = x[0], along the last axis."""
    shifted = F.pad(signal[..., :-1], (1, 0))
    return signal - coefficient * shifted


def pre_emphasis_coefficient(content_type: str) -> float:
    return PRE_EMPHASIS_COEFFICIENTS.get(content_type, 0.95)


def pre_emphasis_for_content(signal: torch.Tensor, content_type: str) -> torch.Tensor:
    """NewPreEmphasisForContent + ProcessBuffer (pre_emphasis.go:84-110)."""
    return pre_emphasis(signal, pre_emphasis_coefficient(content_type))


def pre_emphasis_response(
    coefficient: float, freqs_hz: torch.Tensor, sample_rate: int
) -> torch.Tensor:
    """|H(e^jw)| = |1 - a e^{-jw}| (pre_emphasis.go frequency response)."""
    w = 2.0 * math.pi * torch.as_tensor(freqs_hz, dtype=torch.float32) / sample_rate
    return torch.sqrt(1.0 + coefficient**2 - 2.0 * coefficient * torch.cos(w))


def dc_pole_for_cutoff(cutoff_hz: float, sample_rate: int) -> float:
    """R = 1 - 2*pi*fc/fs (dc_removal.go:48-50)."""
    return 1.0 - 2.0 * math.pi * cutoff_hz / sample_rate


# ---------------------------------------------------------------------
# Block scans of the recursive filters
# ---------------------------------------------------------------------
#
# A per-sample Python loop over a 30 s clip is 1.3 M steps. The
# recursive filters (the DC blocker, the biquad and adaptive
# pre-emphasis) are linear with constant coefficients, so each runs as a
# block scan: chunks of _SCAN_CHUNK samples, the in-chunk zero-state response as one matmul with a [K, K] table
# designed in float64, the state entering each chunk by a log-depth
# (Hillis-Steele) scan over the chunk axis with the chunk-to-chunk
# transition's powers, and that state's response added back.

_SCAN_CHUNK = 256


@functools.lru_cache(maxsize=8)
def _pole_prefix_kernel(pole: float, k: int) -> np.ndarray:
    """[K, K] upper-triangular pole^(j-i), designed in float64: row i of
    a chunk's input reaches output j >= i with weight pole^(j-i)."""
    i = np.arange(k)[:, None]
    j = np.arange(k)[None, :]
    return np.where(j >= i, float(pole) ** np.maximum(j - i, 0), 0.0)


@functools.lru_cache(maxsize=8)
def _pole_carry_powers(pole: float, k: int) -> np.ndarray:
    """[K] pole^(j+1): how the value before a chunk reaches its sample j."""
    return float(pole) ** (np.arange(k) + 1.0)


@functools.lru_cache(maxsize=16)
def _first_order_carry_steps(pole: float, k: int, c: int) -> tuple:
    """(pole^K)^s for the scan's shifts s = 1, 2, 4, ... < c."""
    out, s = [], 1
    while s < c:
        out.append(float(pole) ** (k * s))
        s <<= 1
    return tuple(out)


def _first_order_scan(u: torch.Tensor, pole: float) -> torch.Tensor:
    """z[n] = pole z[n-1] + u[n] along the last axis, z[-1] = 0, float32."""
    n = u.shape[-1]
    k = min(_SCAN_CHUNK, n)
    c = -(-n // k)
    chunks = F.pad(u, (0, c * k - n)).reshape(u.shape[:-1] + (c, k))
    dev = u.device
    y_in = torch.matmul(chunks, device_table(_pole_prefix_kernel, (pole, k), dev))
    z = y_in[..., -1]                                     # [..., C]
    s = 1
    for a_s in _first_order_carry_steps(pole, k, c):
        z = torch.cat([z[..., :s], z[..., s:] + a_s * z[..., :-s]], dim=-1)
        s <<= 1
    carry_prev = F.pad(z[..., :-1], (1, 0))               # z at the end of chunk c - 1
    y = y_in + carry_prev[..., None] * device_table(_pole_carry_powers, (pole, k), dev)
    return y.reshape(u.shape[:-1] + (c * k,))[..., :n]


def dc_removal(signal: torch.Tensor, pole: float = 0.995) -> torch.Tensor:
    """DC blocker y[n] = x[n] - x[n-1] + R*y[n-1] (x[-1] = y[-1] = 0)
    along the last axis, in float32: the first-order block scan over the
    differences."""
    x = signal.to(torch.float32)
    return _first_order_scan(x - F.pad(x[..., :-1], (1, 0)), pole)


def _biquad_state_space(b: tuple, a: tuple) -> tuple:
    """DF2T biquad as s' = A s + B x, y = C s + D x (s = (z1, z2))."""
    b0, b1, b2 = (float(v) for v in b)
    _, a1, a2 = (float(v) for v in a)
    big_a = np.array([[-a1, 1.0], [-a2, 0.0]])
    big_b = np.array([b1 - a1 * b0, b2 - a2 * b0])
    return big_a, big_b, b0


@functools.lru_cache(maxsize=16)
def _biquad_tables(b: tuple, a: tuple, k: int, c: int) -> tuple:
    """float64 tables of the biquad's block scan: the [K, K] zero-state
    Toeplitz T[i, j] = h[j - i], the [K, 2] end-state weights
    A^(K-1-i) B, the [2, K] state response (C A^j)^T, and (A^K)^s as
    [2, 2] transposes for the scan's shifts s = 1, 2, 4, ... < c."""
    big_a, big_b, d = _biquad_state_space(b, a)
    powers = [np.eye(2)]
    for _ in range(k):
        powers.append(big_a @ powers[-1])
    h = np.array([d] + [powers[m - 1][0] @ big_b for m in range(1, k)])
    i = np.arange(k)[:, None]
    j = np.arange(k)[None, :]
    toeplitz = np.where(j >= i, h[np.maximum(j - i, 0)], 0.0)
    end_w = np.stack([powers[k - 1 - m] @ big_b for m in range(k)])      # [K, 2]
    state_resp = np.stack([powers[m][0] for m in range(k)], axis=1)      # [2, K]
    steps, s, m_s = [], 1, powers[k]
    while s < c:
        steps.append(m_s.T)
        m_s = m_s @ m_s
        s <<= 1
    return toeplitz, end_w, state_resp, tuple(steps)


def biquad(
    signal: torch.Tensor,
    b: Tuple[float, float, float],
    a: Tuple[float, float, float],
) -> torch.Tensor:
    """Direct-form-II-transposed biquad along the last axis, zero initial
    state, float32, as a block scan: the two-value state (z1, z2) is
    carried from chunk to chunk by the companion matrix's powers."""
    x = signal.to(torch.float32)
    require_fp32_matmuls(x, "biquad")
    n = x.shape[-1]
    k = min(_SCAN_CHUNK, n)
    c = -(-n // k)
    key = (tuple(float(v) for v in b), tuple(float(v) for v in a), k, c)
    toeplitz, end_w, state_resp, steps = _biquad_tables(*key)
    dev = x.device
    f32 = lambda t: torch.from_numpy(np.asarray(t, dtype=np.float32)).to(dev)  # noqa: E731
    chunks = F.pad(x, (0, c * k - n)).reshape(x.shape[:-1] + (c, k))
    y_in = torch.matmul(chunks, f32(toeplitz))
    z = torch.matmul(chunks, f32(end_w))                   # [..., C, 2] zero-state end states
    s = 1
    for m_t in steps:
        z = torch.cat([z[..., :s, :], z[..., s:, :] + torch.matmul(z[..., :-s, :], f32(m_t))], dim=-2)
        s <<= 1
    state_prev = F.pad(z[..., :-1, :], (0, 0, 1, 0))       # the state entering chunk c
    y = y_in + torch.matmul(state_prev, f32(state_resp))
    return y.reshape(x.shape[:-1] + (c * k,))[..., :n]


def bandpass_coefficients(
    center_hz: float, q: float, sample_rate: int
) -> Tuple[Tuple[float, float, float], Tuple[float, float, float]]:
    """RBJ audio-EQ-cookbook bandpass (constant skirt gain, peak gain Q).

    Returns ((b0, b1, b2), (a0, a1, a2)) normalized so a0 = 1.
    """
    w0 = 2.0 * math.pi * center_hz / sample_rate
    alpha = math.sin(w0) / (2.0 * q)
    b0 = q * alpha
    b1 = 0.0
    b2 = -q * alpha
    a0 = 1.0 + alpha
    a1 = -2.0 * math.cos(w0)
    a2 = 1.0 - alpha
    return (b0 / a0, b1 / a0, b2 / a0), (1.0, a1 / a0, a2 / a0)


def bandpass(
    signal: torch.Tensor, center_hz: float, q: float, sample_rate: int
) -> torch.Tensor:
    """BandpassFilter.ProcessBuffer (bandpass.go:13-151)."""
    b, a = bandpass_coefficients(center_hz, q, sample_rate)
    return biquad(signal, b, a)


def biquad_response(
    b: Tuple[float, float, float],
    a: Tuple[float, float, float],
    freqs_hz: torch.Tensor,
    sample_rate: int,
) -> torch.Tensor:
    """|H(e^jw)| for the biquad (bandpass.go frequency response), in
    complex64 as JAX computes it."""
    w = 2.0 * math.pi * torch.as_tensor(freqs_hz, dtype=torch.float32) / sample_rate
    z1 = torch.exp(-1j * w.to(torch.complex64))
    z2 = torch.exp(-2j * w.to(torch.complex64))
    num = b[0] + b[1] * z1 + b[2] * z2
    den = a[0] + a[1] * z1 + a[2] * z2
    return torch.abs(num / den).to(torch.float32)


def adaptive_pre_emphasis(
    signal: torch.Tensor,
    base_coefficient: float = 0.95,
    adaptation_rate: float = 0.01,
) -> torch.Tensor:
    """Adaptive pre-emphasis (pre_emphasis.go NewAdaptivePreEmphasis):
    the coefficient tracks the signal's spectral tilt, with r the
    adaptation rate and x[-1] = 0:
        energy[n] = (1 - r) energy[n-1] + r (x[n] - x[n-1])^2 / max(x[n]^2 + 1e-10, 1e-10)
        alpha[n]  = (1 - r) alpha[n-1] + r clip(base + 0.03 (1 - clip(energy[n], 0, 1)), 0.9, 0.99)
        y[n]      = x[n] - alpha[n-1] x[n-1],   alpha[-1] = base, energy[-1] = 0.
    Both recurrences have the constant pole 1 - r and run as block scans,
    with the elementwise step between them."""
    x = signal.to(torch.float32)
    require_fp32_matmuls(x, "adaptive_pre_emphasis")
    r = float(adaptation_rate)
    pole = 1.0 - r
    prev = F.pad(x[..., :-1], (1, 0))
    d = x - prev
    energy = _first_order_scan(r * (d * d / torch.clamp_min(x * x + 1e-10, 1e-10)), pole)
    target = torch.clamp(base_coefficient + 0.03 * (1.0 - torch.clamp(energy, 0.0, 1.0)), 0.9, 0.99)
    u = r * target
    u[..., 0] += pole * float(np.float32(base_coefficient))    # alpha[-1] = base
    alpha = _first_order_scan(u, pole)
    alpha_prev = F.pad(alpha[..., :-1], (1, 0), value=float(np.float32(base_coefficient)))
    return x - alpha_prev * prev
