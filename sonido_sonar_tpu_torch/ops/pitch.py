"""Pitch detection (counterpart of `sonido_sonar_tpu/ops/pitch.py`): YIN,
whose functions are the plain version of the K2 kernel
(`ops/hopper_yin.py`), the autocorrelation pitch and the median filter.

Reference parity: algorithms/tonal/pitch_detection.go — YIN (:349-421):
difference function d(tau) = sum_{j<H} (x[j]-x[j+tau])^2 with H = W/2;
CMNDF d'(0)=1, d'(tau) = d(tau)*tau / sum_{1..tau} d; first local
minimum below threshold 0.15; parabolic interpolation; confidence =
1 - cmndf[tau]; frequency validated against [min, max] Hz.

The difference function follows the JAX formulation
d = E1 + S(tau) - 2 r(tau): E1 the first-half energy, S the sliding
half-window energy (cumsum) and r the cross-correlation of the first half
with the frame through length-W DFT matmuls (true float32).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sonido_sonar_tpu_torch.ops.tables import device_table

_EPS = 1e-10


@functools.lru_cache(maxsize=16)
def _yin_dft_mats(w: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(M_x [w, 2F], M_first [h, 2F], M_inv [2F, h], n_fft) with h = w//2,
    n_fft = w, F = n_fft//2 + 1: forward rDFT bases of the frame and its
    first half, and the truncated inverse producing r(tau), tau < h.
    Length w suffices: j + tau <= w - 2 never wraps."""
    h = w // 2
    n_fft = w
    f_bins = n_fft // 2 + 1
    k = np.arange(f_bins, dtype=np.float64)[None, :]

    nx = np.arange(w, dtype=np.float64)[:, None]
    ang_x = -2.0 * np.pi * nx * k / n_fft
    m_x = np.concatenate([np.cos(ang_x), np.sin(ang_x)], axis=1)

    nf = np.arange(h, dtype=np.float64)[:, None]
    ang_f = -2.0 * np.pi * nf * k / n_fft
    m_first = np.concatenate([np.cos(ang_f), np.sin(ang_f)], axis=1)

    # r[t] = (1/N) sum_k w_k (Re_k cos(2 pi k t/N) - Im_k sin(2 pi k t/N))
    t = np.arange(h, dtype=np.float64)[None, :]
    kk = np.arange(f_bins, dtype=np.float64)[:, None]
    wk = np.full((f_bins, 1), 2.0)
    wk[0, 0] = 1.0
    if n_fft % 2 == 0:
        wk[-1, 0] = 1.0
    ang_i = 2.0 * np.pi * kk * t / n_fft
    m_inv = np.concatenate(
        [wk * np.cos(ang_i), -wk * np.sin(ang_i)], axis=0
    ) / n_fft

    return (
        m_x.astype(np.float32),
        m_first.astype(np.float32),
        m_inv.astype(np.float32),
        n_fft,
    )


def _yin_mat(w: int, which: int) -> np.ndarray:
    return _yin_dft_mats(w)[which]


@dataclass(frozen=True)
class PitchParams:
    """pitch_detection.go:160-175 defaults."""

    sample_rate: int = 44100
    window_size: int = 1024
    min_freq: float = 80.0
    max_freq: float = 1000.0
    yin_threshold: float = 0.15
    voicing_threshold: float = 0.45


def _yin_difference(frames: torch.Tensor) -> torch.Tensor:
    """d(tau) for tau in [0, W/2), batched [..., W] -> [..., W/2]."""
    w = frames.shape[-1]
    h = w // 2
    f_bins = w // 2 + 1
    dev = frames.device
    x = frames.to(torch.float32)
    first = x[..., :h]
    e1 = torch.sum(first * first, dim=-1, keepdim=True)

    csum0 = F.pad(torch.cumsum(x * x, dim=-1), (1, 0))  # csum0[k] = sum x[<k]^2
    s = csum0[..., h: 2 * h] - csum0[..., :h]

    fx = torch.matmul(x, device_table(_yin_mat, (w, 0), dev))
    ff = torch.matmul(first, device_table(_yin_mat, (w, 1), dev))
    rex, imx = fx[..., :f_bins], fx[..., f_bins:]
    ref, imf = ff[..., :f_bins], ff[..., f_bins:]
    # conj(F_first) * F_x
    cross = torch.cat([ref * rex + imf * imx, ref * imx - imf * rex], dim=-1)
    r = torch.matmul(cross, device_table(_yin_mat, (w, 2), dev))
    return e1 + s - 2.0 * r


def _cmndf(diff: torch.Tensor) -> torch.Tensor:
    """Cumulative mean normalized difference (pitch_detection.go:365-372)."""
    h = diff.shape[-1]
    tau = torch.arange(1, h, dtype=torch.float32, device=diff.device)
    running = torch.cumsum(diff[..., 1:], dim=-1)
    cm = diff[..., 1:] * tau / torch.clamp_min(running, _EPS)
    return torch.cat([torch.ones_like(diff[..., :1]), cm], dim=-1)


def _yin_pick(
    d: torch.Tensor, params: PitchParams
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CMNDF + threshold pick + parabolic interpolation + validation over
    difference rows d [..., H] (pitch_detection.go:365-421)."""
    cm = _cmndf(d)
    h = cm.shape[-1]

    # first tau >= 1 with cmndf < threshold and cmndf[tau] < cmndf[tau+1]
    nxt = torch.cat([cm[..., 1:], torch.full_like(cm[..., :1], float("inf"))], dim=-1)
    cand = (cm < params.yin_threshold) & (cm < nxt)
    cand[..., 0] = False
    has = torch.any(cand, dim=-1)
    min_tau = torch.argmax(cand.to(torch.uint8), dim=-1)  # first True

    def at(idx):
        return torch.gather(cm, -1, idx[..., None])[..., 0]

    y0 = at(torch.clamp(min_tau - 1, 0, h - 1))
    y1 = at(min_tau)
    y2 = at(torch.clamp(min_tau + 1, 0, h - 1))
    denom = y0 - 2.0 * y1 + y2
    den_ok = torch.abs(denom) > _EPS
    shift = torch.where(den_ok, 0.5 * (y0 - y2) / torch.where(den_ok, denom, 1.0), 0.0)
    interior = (min_tau > 0) & (min_tau < h - 1)
    period = min_tau.to(torch.float32) + torch.where(interior, shift, 0.0)

    freq = params.sample_rate / torch.clamp_min(period, _EPS)
    confidence = 1.0 - y1
    ok = has & (freq >= params.min_freq) & (freq <= params.max_freq)
    pitch = torch.where(ok, freq, 0.0)
    conf = torch.where(ok, confidence, 0.0)
    return pitch, conf, conf  # voicing = confidence (pitch_detection.go:405)


def yin_pitch(
    frames: torch.Tensor, params: PitchParams = PitchParams()
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """YIN over frames [..., W] -> (pitch_hz, confidence, voicing), each [...].
    Unvoiced / out-of-range frames get pitch 0 and confidence 0."""
    return _yin_pick(_yin_difference(frames), params)


def yin_pitch_from_signal(
    signal: torch.Tensor,
    frame_size: int,
    hop_size: int,
    params: PitchParams,
    pre_emph: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame-wise YIN straight from PCM [..., N] -> each [..., T],
    through the K2 wrapper: the CUDA kernel for a CUDA tensor, the plain
    version (`yin_pitch` over frames) for a CPU tensor. `pre_emph != 0`
    pre-emphasizes the signal first (ops/filters.pre_emphasis)."""
    from sonido_sonar_tpu_torch.ops.hopper_yin import yin_pitch_hopper

    return yin_pitch_hopper(
        signal, frame_size, hop_size, params.sample_rate, params.min_freq,
        params.max_freq, params.yin_threshold, pre_emph=pre_emph,
    )


def detect_pitch_track(
    pcm: torch.Tensor,
    sample_rate: int,
    frame_size: int = 1024,
    hop_size: int = 512,
    params: PitchParams | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame-wise YIN pitch track over PCM [..., N] -> (pitch,
    confidence, voicing) each [..., T], through the K2 wrapper. The fixed
    1024/512 default is the extractors' hardcoded framing
    (extractors/speech.go:468-469, reference quirk #8)."""
    p = params or PitchParams(sample_rate=sample_rate, window_size=frame_size)
    return yin_pitch_from_signal(pcm, frame_size, hop_size, p)


def acf_pitch(
    frames: torch.Tensor, params: PitchParams = PitchParams()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autocorrelation pitch: normalized ACF peak within the lag range
    implied by [min_freq, max_freq] (pitch_detection.go:423-...).
    Returns (pitch_hz, confidence), 0 where the peak is at most 0.3."""
    w = frames.shape[-1]
    x = frames.to(torch.float32)
    x = x - torch.mean(x, dim=-1, keepdim=True)
    n_fft = 1
    while n_fft < 2 * w:
        n_fft <<= 1
    f = torch.fft.rfft(x, n=n_fft, dim=-1)
    ac = torch.fft.irfft(f * torch.conj(f), n=n_fft, dim=-1)[..., :w]
    nac = ac / torch.clamp_min(ac[..., :1], _EPS)

    min_lag = max(int(params.sample_rate / params.max_freq), 1)
    max_lag = min(int(params.sample_rate / params.min_freq) + 1, w - 1)
    if min_lag >= max_lag:
        z = torch.zeros(frames.shape[:-1], dtype=torch.float32, device=frames.device)
        return z, z
    best = torch.argmax(nac[..., min_lag:max_lag], dim=-1) + min_lag
    peak = torch.gather(nac, -1, best[..., None])[..., 0]
    lag = best.to(torch.float32)
    pitch = torch.full_like(lag, float(params.sample_rate)) / lag  # a true float32 division
    ok = peak > 0.3  # AutocorrThreshold (pitch_detection.go:168)
    return torch.where(ok, pitch, 0.0), torch.where(ok, peak, 0.0)


def median_filter_pitch(pitch: torch.Tensor, width: int = 5) -> torch.Tensor:
    """Median smoothing of a pitch track over its last axis
    (pitch_detection.go:767+): edge padding (clamped indices), the mean
    of the two middle values on an even width, and NaN in a window gives
    NaN, as `jnp.median` does (`correct_octave_errors` relies on it)."""
    t = pitch.shape[-1]
    pad = width // 2
    idx = torch.arange(t, device=pitch.device)[:, None] + torch.arange(width, device=pitch.device)[None, :]
    windows = pitch[..., torch.clamp(idx - pad, 0, t - 1)]  # [..., T, width]
    srt = torch.sort(windows, dim=-1).values
    if width % 2:
        med = srt[..., width // 2]
    else:
        med = 0.5 * srt[..., width // 2 - 1] + 0.5 * srt[..., width // 2]
    return torch.where(torch.isnan(windows).any(dim=-1), float("nan"), med)
