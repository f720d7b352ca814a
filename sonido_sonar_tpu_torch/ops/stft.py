"""STFT engine, spectrum helpers and the streaming STFT (counterpart of
`sonido_sonar_tpu/ops/stft.py`).

Reference parity: fingerprint/analyzers/spectral.go:385-517 — frame,
window (symmetric, power-gain normalized), real DFT, magnitude and
phase. Up to W = 2048 the DFT is a matmul against the [W, 2F] windowed
basis, in true float32 (on a CUDA device TF32 must be off); above it,
`torch.fft.rfft` of the windowed frames, as the JAX package does.
`STFTStreamer` (spectral.go:289-374) runs the K1 kernel on the card
where K1 takes the window (`ops/hopper_stft.k1_takes_window`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sonido_sonar_tpu_torch.config.config import WindowType
from sonido_sonar_tpu_torch.ops.framing import frame_signal, num_frames
from sonido_sonar_tpu_torch.ops.tables import device_table
from sonido_sonar_tpu_torch.ops.windows import make_window
from sonido_sonar_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    Device,
    as_float32,
    require_fp32_matmuls,
)

# log-power floor (spectral/power_spectrum.go:46-70)
_LOG_FLOOR = 1e-10
# window sizes up to this take the DFT matmul, above it the FFT (JAX :37)
_MATMUL_FFT_MAX_W = 2048


@functools.lru_cache(maxsize=32)
def _windowed_dft_matrix(window_type: WindowType, window_size: int) -> np.ndarray:
    """[W, 2F] real matrix: columns are Re then Im of the rDFT basis,
    each row pre-scaled by the window — frames @ M = [Re | Im]."""
    w = make_window(
        window_type, window_size, normalize=True, symmetric=True, dtype=np.float64
    )
    f_bins = window_size // 2 + 1
    n = np.arange(window_size, dtype=np.float64)[:, None]
    k = np.arange(f_bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / window_size
    m = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    m *= w[:, None]
    out = m.astype(np.float32)
    out.setflags(write=False)
    return out


@dataclass
class STFTResult:
    """SpectrogramResult/STFTResult (analyzers/spectral.go:14-60): every
    tensor is [..., T, F], F = window_size // 2 + 1. `phase` and
    `complex_spec` are None unless asked for."""

    magnitude: torch.Tensor
    phase: Optional[torch.Tensor]
    complex_spec: Optional[torch.Tensor]
    sample_rate: int
    window_size: int
    hop_size: int

    @property
    def freq_bins(self) -> int:
        return self.window_size // 2 + 1

    @property
    def time_frames(self) -> int:
        return self.magnitude.shape[-2]


def stft(
    signal,
    window_size: int = 2048,
    hop_size: int = 512,
    window_type: WindowType = WindowType.HANN,
    sample_rate: int = 44100,
    return_phase: bool = False,
    return_complex: bool = False,
    device: Device = DEFAULT_DEVICE,
) -> STFTResult:
    """Batched STFT over the last axis of `signal` [..., N]. A tensor
    stays on its device, numpy goes to `device`; a CUDA input with TF32
    matmuls on raises (the magnitudes feed logs and ratios)."""
    x = as_float32(signal, device)
    require_fp32_matmuls(x, "stft")
    frames = frame_signal(x, window_size, hop_size)
    f_bins = window_size // 2 + 1
    window_type = WindowType(window_type)
    if window_size <= _MATMUL_FFT_MAX_W:
        m = device_table(_windowed_dft_matrix, (window_type, window_size), x.device)
        reim = torch.matmul(frames, m)
        re, im = reim[..., :f_bins], reim[..., f_bins:]
        mag = torch.sqrt(re * re + im * im)
        phase = torch.atan2(im, re) if return_phase else None
        cplx = torch.complex(re, im) if return_complex else None
    else:
        w = device_table(make_window, (window_type, window_size), x.device)
        spec = torch.fft.rfft(frames * w, dim=-1)
        mag = torch.abs(spec)
        phase = torch.angle(spec) if return_phase else None
        cplx = spec if return_complex else None
    return STFTResult(mag, phase, cplx, sample_rate, window_size, hop_size)


def fft_frame(
    frame,
    window_size: int = 2048,
    window_type: WindowType = WindowType.HANN,
    device: Device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Windowed rFFT of [..., W] frames (SpectralAnalyzer.ComputeFFT,
    spectral.go:63), complex64 [..., W // 2 + 1]."""
    x = as_float32(frame, device)
    w = device_table(make_window, (WindowType(window_type), window_size), x.device)
    return torch.fft.rfft(x * w, dim=-1)


def power_spectrum(magnitude: torch.Tensor) -> torch.Tensor:
    """mag^2 (spectral/power_spectrum.go:18-44)."""
    return magnitude * magnitude


def log_power_spectrum(magnitude: torch.Tensor, floor: float = _LOG_FLOOR) -> torch.Tensor:
    """10 log10(max(mag^2, floor)) dB (power_spectrum.go:46-102)."""
    return 10.0 * torch.log10(torch.clamp_min(power_spectrum(magnitude), floor))


def spectral_flux(magnitude: torch.Tensor) -> torch.Tensor:
    """Half-wave-rectified L2 frame-to-frame flux, [..., T, F] -> [..., T]
    (spectral/spectral_flux.go:17-56). Frame 0 has flux 0."""
    diff = magnitude[..., 1:, :] - magnitude[..., :-1, :]
    rect = torch.clamp_min(diff, 0.0)
    flux = torch.sqrt(torch.sum(rect * rect, dim=-1))
    return F.pad(flux, (1, 0))


def spectral_flux_all_changes(magnitude: torch.Tensor) -> torch.Tensor:
    """Unrectified flux, decreases counted too
    (SpectralFlux.ComputeAllChanges, spectral_flux.go:41-56)."""
    diff = magnitude[..., 1:, :] - magnitude[..., :-1, :]
    return F.pad(torch.sqrt(torch.sum(diff * diff, dim=-1)), (1, 0))


def _cat(parts: List[Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
    return torch.cat(parts, dim=0) if all(p is not None for p in parts) else None


class STFTStreamer:
    """Streaming STFT over a host ring buffer (analyzers/spectral.go:289-374).

    block_frames == 0 (legacy): every push consumes all complete frames.
    block_frames > 0: frames leave in fixed blocks of that many, so every
    launch has one shape; `flush()` drains the sub-block remainder at the
    end of a stream.

    Each chunk goes to `device`. There the route is a rule on the
    geometry, fixed at construction: where K1 takes the window (a power
    of two in [64, 2048]) the chunk's magnitudes come from the K1 wrapper
    (the kernel on a CUDA device, its plain version on the CPU), else
    from `stft`. A K1 failure raises; nothing falls back to `stft`.
    """

    def __init__(
        self,
        window_size: int = 2048,
        hop_size: int = 512,
        window_type: WindowType = WindowType.HANN,
        sample_rate: int = 44100,
        block_frames: int = 0,
        device: Device = DEFAULT_DEVICE,
    ):
        from sonido_sonar_tpu_torch.ops.hopper_stft import k1_takes_window

        self.window_size = window_size
        self.hop_size = hop_size
        self.window_type = WindowType(window_type)
        self.sample_rate = sample_rate
        self.block_frames = block_frames
        self.device = torch.device(device)
        self.route = "k1" if k1_takes_window(window_size) else "stft"
        self._buffer = np.zeros(0, dtype=np.float32)

    def _run(self, chunk: np.ndarray) -> STFTResult:
        sig = as_float32(chunk, self.device)
        if self.route == "stft":
            return stft(sig, self.window_size, self.hop_size, self.window_type, self.sample_rate)
        from sonido_sonar_tpu_torch.ops.hopper_stft import stft_magnitude_hopper

        mag, _ = stft_magnitude_hopper(sig, self.window_size, self.hop_size, self.window_type)
        return STFTResult(mag, None, None, self.sample_rate, self.window_size, self.hop_size)

    def _take(self, t: int) -> np.ndarray:
        """The samples of the next `t` frames; the buffer keeps what the
        frame after them starts with."""
        chunk = self._buffer[: (t - 1) * self.hop_size + self.window_size]
        self._buffer = self._buffer[t * self.hop_size:]
        return chunk

    def push(self, samples) -> Optional[STFTResult]:
        """Append samples; return the STFT of the newly completed frames
        (all of them in legacy mode, whole blocks in block mode), or None
        when there are none yet."""
        self._buffer = np.concatenate([self._buffer, np.asarray(samples, dtype=np.float32)])
        if self.block_frames > 0:
            b = self.block_frames
            results = []
            while num_frames(len(self._buffer), self.window_size, self.hop_size) >= b:
                results.append(self._run(self._take(b)))
            if not results:
                return None
            if len(results) == 1:
                return results[0]
            return STFTResult(
                _cat([r.magnitude for r in results]), _cat([r.phase for r in results]),
                _cat([r.complex_spec for r in results]),
                self.sample_rate, self.window_size, self.hop_size,
            )
        return self.flush()

    def flush(self) -> Optional[STFTResult]:
        """Drain every remaining complete frame (block mode's sub-block tail)."""
        t = num_frames(len(self._buffer), self.window_size, self.hop_size)
        if t == 0:
            return None
        return self._run(self._take(t))

    def reset(self) -> None:
        self._buffer = np.zeros(0, dtype=np.float32)
