"""K2: fused YIN pitch on Hopper, and K3, its difference rows alone —
the wrappers, their plain PyTorch versions and their launch counters.

Counterpart of `sonido_sonar_tpu/ops/pallas_yin.py` (`yin_pitch_pallas`,
with its period-amplitude option, and `yin_difference_pallas`); the
kernels are `csrc/yin.cu`. For a CPU tensor a wrapper runs the plain
version (pre-emphasis, framing, `ops/pitch.yin_pitch`, and the period
amplitude over the frames; framing and `ops/pitch._yin_difference`); for
a CUDA tensor it launches the kernel or raises — nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops.filters import pre_emphasis
from sonido_sonar_tpu_torch.ops.framing import frame_signal, kernel_signal
from sonido_sonar_tpu_torch.ops.pitch import PitchParams, _yin_difference, yin_pitch

KERNEL_WINDOWS = (256, 512, 1024, 2048)
_EPS = 1e-10


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
    with torch.cuda.device(dev):
        _build.call(
            "sonido_yin_pitch", sig.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr() if with_period_amp else None,
            b, sig.shape[1], t, window_size, hop_size, float(pre_emph),
            float(sample_rate), float(min_freq), float(max_freq), float(yin_threshold),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    yin_pitch_hopper.launches += 1
    yin_pitch_hopper.amp_launches += int(with_period_amp)
    outs = [o.view(signal.shape[:-1] + (t,)) for o in out.unbind(0)]
    if with_period_amp:
        pitch, conf, amp = outs
        return pitch, conf, conf, amp
    pitch, conf = outs
    return pitch, conf, conf


yin_pitch_hopper.launches = 0      # every launch
yin_pitch_hopper.amp_launches = 0  # the launches with the period amplitude


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
    with torch.cuda.device(dev):
        _build.call(
            "sonido_yin_difference", sig.data_ptr(), d.data_ptr(), b, sig.shape[1], t,
            window_size, hop_size, torch.cuda.current_stream(dev).cuda_stream,
        )
    yin_difference_hopper.launches += 1
    return d.view(signal.shape[:-1] + (t, h))


yin_difference_hopper.launches = 0
