"""K2: fused YIN pitch on Hopper — the wrapper, its plain PyTorch version
and its launch counter.

Counterpart of `sonido_sonar_tpu/ops/pallas_yin.py` (`yin_pitch_pallas`,
without the period-amplitude option); the kernel is `csrc/yin.cu`. For
a CPU tensor the wrapper runs the plain version (pre-emphasis, framing,
`ops/pitch.yin_pitch`); for a CUDA tensor it launches the kernel or
raises — nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.ops.filters import pre_emphasis
from sonido_sonar_tpu_torch.ops.framing import frame_signal, kernel_signal
from sonido_sonar_tpu_torch.ops.pitch import PitchParams, yin_pitch

KERNEL_WINDOWS = (256, 512, 1024, 2048)


def yin_pitch_plain(
    signal: torch.Tensor,
    window_size: int,
    hop_size: int,
    sample_rate: int,
    min_freq: float,
    max_freq: float,
    yin_threshold: float = 0.15,
    pre_emph: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2: (pitch, confidence, voicing), each [..., T]."""
    x = signal.to(torch.float32)
    if pre_emph != 0.0:
        x = pre_emphasis(x, pre_emph)
    params = PitchParams(
        sample_rate=sample_rate, window_size=window_size, min_freq=min_freq,
        max_freq=max_freq, yin_threshold=yin_threshold,
    )
    return yin_pitch(frame_signal(x, window_size, hop_size), params)


def yin_pitch_hopper(
    signal: torch.Tensor,
    window_size: int,
    hop_size: int,
    sample_rate: int,
    min_freq: float,
    max_freq: float,
    yin_threshold: float = 0.15,
    pre_emph: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, N] or [N] float32 -> (pitch, confidence, voicing), each [.., T];
    voicing is the confidence.

    CPU tensor: the plain version. CUDA tensor: the K2 kernel, which
    takes a float32 contiguous signal and a window in KERNEL_WINDOWS;
    anything else raises.
    """
    if signal.device.type == "cpu":
        return yin_pitch_plain(
            signal, window_size, hop_size, sample_rate, min_freq, max_freq,
            yin_threshold, pre_emph,
        )
    if signal.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {signal.device}")
    if window_size not in KERNEL_WINDOWS:
        raise ValueError(f"K2 needs a window in {KERNEL_WINDOWS}, got {window_size}")
    sig, b, t = kernel_signal(signal, window_size, hop_size)
    dev = signal.device
    pitch = torch.empty((b, t), dtype=torch.float32, device=dev)
    conf = torch.empty((b, t), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.call(
            "sonido_yin_pitch", sig.data_ptr(), pitch.data_ptr(), conf.data_ptr(),
            b, sig.shape[1], t, window_size, hop_size, float(pre_emph),
            float(sample_rate), float(min_freq), float(max_freq), float(yin_threshold),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    yin_pitch_hopper.launches += 1
    if signal.dim() == 1:
        pitch, conf = pitch[0], conf[0]
    return pitch, conf, conf


yin_pitch_hopper.launches = 0
