"""K2: fused YIN pitch on Hopper, and K3, its difference rows alone —
the wrappers, their plain PyTorch versions and their launch counters.

Counterpart of `sonido_sonar_tpu/ops/pallas_yin.py` (`yin_pitch_pallas`,
with its period-amplitude option, and `yin_difference_pallas`); the
kernels are `csrc/yin.cu`. For a CPU tensor a wrapper runs the plain
version (pre-emphasis, framing, `ops/pitch.yin_pitch`, and the period
amplitude over the frames; framing and `ops/pitch._yin_difference`); for
a CUDA tensor it launches the kernel or raises — nothing falls back.

`difference_model` is a numpy model of the kernels' difference function
(their transforms, pair order and index maps), held on the CPU to a
direct sum and to the plain version (tests/test_torch_kernels.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops.filters import pre_emphasis
from sonido_sonar_tpu_torch.ops.framing import frame_signal, kernel_signal
from sonido_sonar_tpu_torch.ops.hopper_stft import (
    complex_twiddles,
    fft_passes_model,
    swizzle,
    twiddle_table,
)
from sonido_sonar_tpu_torch.ops.pitch import PitchParams, _yin_difference, yin_pitch
from sonido_sonar_tpu_torch.ops.tables import device_table

KERNEL_WINDOWS = (256, 512, 1024, 2048)
_EPS = 1e-10
_LANES = 32


def scratch_swizzle(i):
    """The kernels' scratch index (csrc/yin.cu swz_scratch), in floats:
    bits 5-9 flip bits 0-4, a permutation of every aligned 32-float row."""
    return i ^ ((i >> 5) & 31)


def _cross_spectrum_model(buf_a: np.ndarray, buf_b: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """The kernels' bin-pair step (csrc/yin.cu cross_spectrum): from the
    warp buffers of the packed transforms of a and b ([..., N] complex64,
    point k at swizzle(k)) -> conj Z [..., N] in natural order, Z the
    packed inverse spectrum of r, 8x (the spectra are unhalved).

    Pair k in [0, N/2] (lane k % 32, round k // 32) reads points k and
    N - k (mod N) of both buffers and table entry k = W^k; its splits
    give 2X[k] = alpha + gamma and 2X[N-k] = conj(alpha - gamma), the
    product P = conj(A) B, and the inverse split Z[k] = mu + delta,
    Z[N-k] = conj(mu - delta) with mu = P[k] + conj P[N-k] and delta =
    i conj(W^k) (P[k] - conj P[N-k]). The N - k store comes first."""
    n = buf_a.shape[-1]
    k = np.arange(n // 2 + 1)
    kn = (n - k) & (n - 1)
    w = tw[k]

    def split(buf):
        zk, zn = buf[..., swizzle(k)], buf[..., swizzle(kn)]
        alpha = zk + np.conj(zn)
        gamma = w * (np.complex64(-1j) * (zk - np.conj(zn)))
        return alpha + gamma, np.conj(alpha - gamma)

    ak, an = split(buf_a)
    bk, bn = split(buf_b)
    pk, pn = np.conj(ak) * bk, np.conj(an) * bn
    mu = pk + np.conj(pn)
    delta = np.complex64(1j) * (np.conj(w) * (pk - np.conj(pn)))
    out = np.empty_like(buf_b)
    out[..., kn] = mu - delta
    out[..., k] = np.conj(mu + delta)
    return out


def difference_model(frames: np.ndarray) -> np.ndarray:
    """numpy model of K2/K3's difference function as csrc/yin.cu computes
    it: [..., W] float32 frames -> d [..., W/2] float32, d(tau) =
    (E1 + S(tau)) - 2 r(tau).

    r: the packed transforms (`fft_passes_model`, the table of
    `twiddle_table(W)`) of b = the frame and a = its first half zero-padded
    (pass 0 of a reads zeros above N/2), `_cross_spectrum_model`, and the
    same forward passes on conj Z: 2 r[2m] = Re y[m] / (2W), 2 r[2m+1] =
    -Im y[m] / (2W). E1 and S: lane l owns lags [c l, c l + c), c = W/64;
    its chunk sums of the squares of samples u and u + H, scanned over the
    lanes, start csum[u] = sum_{j<u} x[j]^2 and csum[u + H], which the
    lane then extends sample by sample; S = csum[u + H] - csum[u], E1 =
    csum[H]."""
    x = np.asarray(frames, np.float32)
    w = x.shape[-1]
    n = w // 2
    c = n // _LANES
    tw = complex_twiddles(w)
    zb = (x[..., 0::2] + 1j * x[..., 1::2]).astype(np.complex64)
    za = zb.copy()
    za[..., n // 2:] = 0
    conj_z = _cross_spectrum_model(fft_passes_model(za, tw), fft_passes_model(zb, tw), tw)
    y = fft_passes_model(conj_z, tw)[..., swizzle(np.arange(n // 2))]
    scale = np.float32(1.0 / (2 * w))
    two_r = np.empty(x.shape[:-1] + (n,), np.float32)
    two_r[..., 0::2] = y.real * scale
    two_r[..., 1::2] = -y.imag * scale
    sq = x * x
    q1 = sq[..., :n].reshape(x.shape[:-1] + (_LANES, c))
    q2 = sq[..., n:].reshape(x.shape[:-1] + (_LANES, c))
    ex1 = np.cumsum(q1.sum(-1, dtype=np.float32), -1, dtype=np.float32)
    ex2 = np.cumsum(q2.sum(-1, dtype=np.float32), -1, dtype=np.float32)
    e1 = ex1[..., -1:]
    zero = np.zeros_like(e1)
    ex1 = np.concatenate([zero, ex1[..., :-1]], -1)
    ex2 = np.concatenate([zero, ex2[..., :-1]], -1) + e1
    c1 = np.cumsum(np.concatenate([ex1[..., None], q1[..., :-1]], -1), -1, dtype=np.float32)
    c2 = np.cumsum(np.concatenate([ex2[..., None], q2[..., :-1]], -1), -1, dtype=np.float32)
    s = (c2 - c1).reshape(x.shape[:-1] + (n,))
    return (e1 + s) - two_r


def period_amplitude(
    frames: torch.Tensor, pitch: torch.Tensor, sample_rate: int
) -> torch.Tensor:
    """RMS over the first pitch period of each frame, [..., T, W] and
    [..., T] -> [..., T] (pallas_yin.py:356-368): plen =
    clamp(trunc(sr / max(pitch, eps)), 1, W - 1) for a voiced frame, 1
    otherwise. The division is IEEE float32 (not torch's scalar
    reciprocal-multiply), so plen truncates where the kernel's does."""
    w = frames.shape[-1]
    period = torch.where(
        pitch > 0,
        torch.full_like(pitch, float(sample_rate)) / torch.clamp_min(pitch, _EPS),
        0.0,
    )
    plen = torch.clamp(period.to(torch.int32), 1, w - 1)
    j = torch.arange(w, device=frames.device)
    psum = torch.sum(torch.where(j < plen[..., None], frames * frames, 0.0), dim=-1)
    return torch.sqrt(psum / plen.to(torch.float32))


def yin_pitch_plain(
    signal: torch.Tensor,
    window_size: int,
    hop_size: int,
    sample_rate: int,
    min_freq: float,
    max_freq: float,
    yin_threshold: float = 0.15,
    pre_emph: float = 0.0,
    with_period_amp: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of K2: (pitch, confidence, voicing[, amplitude]),
    each [..., T]."""
    x = signal.to(torch.float32)
    if pre_emph != 0.0:
        x = pre_emphasis(x, pre_emph)
    params = PitchParams(
        sample_rate=sample_rate, window_size=window_size, min_freq=min_freq,
        max_freq=max_freq, yin_threshold=yin_threshold,
    )
    frames = frame_signal(x, window_size, hop_size)
    pitch, conf, voicing = yin_pitch(frames, params)
    if with_period_amp:
        return pitch, conf, voicing, period_amplitude(frames, pitch, sample_rate)
    return pitch, conf, voicing


def yin_pitch_hopper(
    signal: torch.Tensor,
    window_size: int,
    hop_size: int,
    sample_rate: int,
    min_freq: float,
    max_freq: float,
    yin_threshold: float = 0.15,
    pre_emph: float = 0.0,
    with_period_amp: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """[..., N] float32 -> (pitch, confidence, voicing), each [..., T];
    voicing is the confidence. `with_period_amp` appends the period
    amplitude as a fourth output.

    CPU tensor: the plain version. CUDA tensor: the K2 kernel, which
    takes a float32 contiguous signal and a window in KERNEL_WINDOWS;
    anything else raises.
    """
    if signal.device.type == "cpu":
        return yin_pitch_plain(
            signal, window_size, hop_size, sample_rate, min_freq, max_freq,
            yin_threshold, pre_emph, with_period_amp,
        )
    if signal.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {signal.device}")
    if window_size not in KERNEL_WINDOWS:
        raise ValueError(f"K2 needs a window in {KERNEL_WINDOWS}, got {window_size}")
    sig, b, t = kernel_signal(signal, window_size, hop_size)
    dev = signal.device
    out = torch.empty((3 if with_period_amp else 2, b, t), dtype=torch.float32, device=dev)
    twiddle = device_table(twiddle_table, (window_size,), dev)
    with torch.cuda.device(dev):
        _build.call(
            "sonido_yin_pitch", sig.data_ptr(), twiddle.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(),
            out[2].data_ptr() if with_period_amp else None,
            b, sig.shape[1], t, window_size, hop_size, float(pre_emph),
            float(sample_rate), float(min_freq), float(max_freq), float(yin_threshold),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    yin_pitch_hopper.launches += 1
    if with_period_amp:
        yin_pitch_hopper.amp_launches += 1
        yin_pitch_hopper.amp_rows += b
    outs = [o.view(signal.shape[:-1] + (t,)) for o in out.unbind(0)]
    if with_period_amp:
        pitch, conf, amp = outs
        return pitch, conf, conf, amp
    pitch, conf = outs
    return pitch, conf, conf


yin_pitch_hopper.launches = 0      # every launch
yin_pitch_hopper.amp_launches = 0  # the launches with the period amplitude
yin_pitch_hopper.amp_rows = 0      # the rows those launches took


def yin_difference_plain(
    signal: torch.Tensor, window_size: int = 1024, hop_size: int = 512
) -> torch.Tensor:
    """Plain version of K3: the frames' difference rows, [..., N] ->
    [..., T, W/2], no pre-emphasis."""
    return _yin_difference(frame_signal(signal.to(torch.float32), window_size, hop_size))


def yin_difference_hopper(
    signal: torch.Tensor, window_size: int = 1024, hop_size: int = 512
) -> torch.Tensor:
    """[..., N] float32 -> d [..., T, W/2] with d(tau) = sum_{j<W/2}
    (x[j] - x[j+tau])^2 per frame (pallas_yin.py:162-168; no
    pre-emphasis).

    CPU tensor: the plain version. CUDA tensor: the K3 kernel, which takes
    a float32 contiguous signal and a window in KERNEL_WINDOWS; anything
    else raises.
    """
    if signal.device.type == "cpu":
        return yin_difference_plain(signal, window_size, hop_size)
    if signal.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {signal.device}")
    if window_size not in KERNEL_WINDOWS:
        raise ValueError(f"K3 needs a window in {KERNEL_WINDOWS}, got {window_size}")
    sig, b, t = kernel_signal(signal, window_size, hop_size)
    dev = signal.device
    h = window_size // 2
    d = torch.empty((b, t, h), dtype=torch.float32, device=dev)
    twiddle = device_table(twiddle_table, (window_size,), dev)
    with torch.cuda.device(dev):
        _build.call(
            "sonido_yin_difference", sig.data_ptr(), twiddle.data_ptr(), d.data_ptr(), b,
            sig.shape[1], t, window_size, hop_size, torch.cuda.current_stream(dev).cuda_stream,
        )
    yin_difference_hopper.launches += 1
    return d.view(signal.shape[:-1] + (t, h))


yin_difference_hopper.launches = 0
