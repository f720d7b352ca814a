"""K1: fused STFT magnitude + aux epilogue on Hopper — the wrapper, its
plain PyTorch version and its launch counter.

Counterpart of `sonido_sonar_tpu/ops/pallas_stft.py`
(`stft_magnitude_pallas(with_aux=True, pre_emph=...)`); the kernel is
`csrc/stft.cu`. For a CPU tensor the wrapper runs the plain version; for
a CUDA tensor it launches the kernel or raises — nothing falls back.

Outputs: magnitude [B, T, F] and an aux dict of [B, T] series:
  rms               sqrt(mean(frame^2)) of the pre-emphasized frame
  zero_crossings    count of (x >= 0) flips between neighbours
  rolloff_bin       first bin whose power prefix sum reaches 0.85 of the
                    total (clamped to F-1), 0 where the total is 0
  low_energy_ratio  power in bins [0, F//4) over the total, 0 where the total is 0
  high_energy_ratio power in bins [F//4, F) over the total, 0 where the total is 0
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.config.config import WindowType
from sonido_sonar_tpu_torch.ops.filters import pre_emphasis
from sonido_sonar_tpu_torch.ops.framing import frame_signal, kernel_signal
from sonido_sonar_tpu_torch.ops.spectral import zero_crossings
from sonido_sonar_tpu_torch.ops.stft import stft
from sonido_sonar_tpu_torch.ops.tables import device_table
from sonido_sonar_tpu_torch.ops.windows import make_window

AUX_KEYS = (
    "rms", "zero_crossings", "rolloff_bin", "low_energy_ratio", "high_energy_ratio",
)
_EPS = 1e-10
_ROLLOFF = 0.85


@functools.lru_cache(maxsize=8)
def _twiddles(window_size: int) -> np.ndarray:
    """[W/2 + 1, 2] (cos, sin) of -2 pi k / W, built in float64."""
    ang = -2.0 * np.pi * np.arange(window_size // 2 + 1, dtype=np.float64) / window_size
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def stft_magnitude_plain(
    signal: torch.Tensor,
    window_size: int = 1024,
    hop_size: int = 256,
    window_type: WindowType = WindowType.HANN,
    pre_emph: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain version of K1: pre-emphasis, DFT-matmul STFT, then the aux
    series from the frames and a cumulative power sum."""
    x = signal.to(torch.float32)
    if pre_emph != 0.0:
        x = pre_emphasis(x, pre_emph)
    mag = stft(x, window_size, hop_size, window_type)
    frames = frame_signal(x, window_size, hop_size)
    power = mag * mag
    f_bins = mag.shape[-1]
    split = f_bins // 4
    total = torch.sum(power, dim=-1)
    reached = torch.cumsum(power, dim=-1) >= _ROLLOFF * total[..., None]
    first = torch.where(
        torch.any(reached, dim=-1),
        torch.argmax(reached.to(torch.uint8), dim=-1),
        f_bins - 1,
    )
    pos = total > 0
    denom = torch.clamp_min(total, _EPS)
    aux = {
        "rms": torch.sqrt(torch.mean(frames * frames, dim=-1)),
        "zero_crossings": zero_crossings(frames),
        "rolloff_bin": torch.where(pos, first.to(torch.float32), 0.0),
        "low_energy_ratio": torch.where(
            pos, torch.sum(power[..., :split], dim=-1) / denom, 0.0
        ),
        "high_energy_ratio": torch.where(
            pos, torch.sum(power[..., split:], dim=-1) / denom, 0.0
        ),
    }
    return mag, aux


def stft_magnitude_hopper(
    signal: torch.Tensor,
    window_size: int = 1024,
    hop_size: int = 256,
    window_type: WindowType = WindowType.HANN,
    pre_emph: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """[..., N] float32 -> (magnitude [..., T, F], aux dict of [..., T]).

    CPU tensor: the plain version. CUDA tensor: the K1 kernel, which
    takes a float32 contiguous signal and a power-of-two window in
    [64, 2048]; anything else raises.
    """
    if signal.device.type == "cpu":
        return stft_magnitude_plain(signal, window_size, hop_size, window_type, pre_emph)
    if signal.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {signal.device}")
    if window_size < 64 or window_size > 2048 or window_size & (window_size - 1):
        raise ValueError(f"K1 needs a power-of-two window in [64, 2048], got {window_size}")
    sig, b, t = kernel_signal(signal, window_size, hop_size)
    dev = signal.device
    f_bins = window_size // 2 + 1
    mag = torch.empty((b, t, f_bins), dtype=torch.float32, device=dev)
    aux = torch.empty((len(AUX_KEYS), b, t), dtype=torch.float32, device=dev)
    window = device_table(make_window, (WindowType(window_type), window_size), dev)
    twiddle = device_table(_twiddles, (window_size,), dev)
    with torch.cuda.device(dev):
        _build.call(
            "sonido_stft_aux", sig.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
            mag.data_ptr(), aux.data_ptr(), b, sig.shape[1], t, window_size, hop_size,
            float(pre_emph), torch.cuda.current_stream(dev).cuda_stream,
        )
    stft_magnitude_hopper.launches += 1
    lead = signal.shape[:-1]
    mag = mag.view(lead + (t, f_bins))
    return mag, {k: v.view(lead + (t,)) for k, v in zip(AUX_KEYS, aux.unbind(0))}


stft_magnitude_hopper.launches = 0
