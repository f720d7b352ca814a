"""MFCC: power -> mel filterbank -> log -> DCT-II -> lifter (counterpart
of `sonido_sonar_tpu/ops/mfcc.py`).

Reference parity: algorithms/spectral/mfcc.go — 13 coefficients, 26 mel
filters, lifter 22 (:44-53), log floor 1e-10 (:136-143), orthonormal
DCT-II (:194-212), lifter `1 + (L/2) sin(pi*i/L)` with C0 unliftered
(:230-245). Both matmuls run in true float32 (the log amplifies TF32's
error past the parity budget), so on a CUDA device TF32 stays off.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from sonido_sonar_tpu_torch.ops.mel import mel_filterbank
from sonido_sonar_tpu_torch.ops.tables import device_table

_LOG_FLOOR = 1e-10


@dataclass(frozen=True)
class MFCCParams:
    """mfcc.go:13-30."""

    num_coefficients: int = 13
    num_mel_filters: int = 26
    low_freq: float = 0.0
    high_freq: float = 0.0  # <=0 -> sample_rate/2
    use_liftering: bool = True
    lifter_coeff: float = 22.0


@functools.lru_cache(maxsize=64)
def dct_matrix(num_coefficients: int, num_mel_filters: int, dtype=np.float32) -> np.ndarray:
    """Orthonormal DCT-II [C, M]."""
    k = np.arange(num_coefficients, dtype=np.float64)[:, None]
    n = np.arange(num_mel_filters, dtype=np.float64)[None, :]
    d = np.cos(np.pi * k * (n + 0.5) / num_mel_filters)
    d[0, :] *= np.sqrt(1.0 / num_mel_filters)
    d[1:, :] *= np.sqrt(2.0 / num_mel_filters)
    out = d.astype(dtype)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=64)
def lifter_vector(num_coefficients: int, lifter_coeff: float, dtype=np.float32) -> np.ndarray:
    """`1 + (L/2) sin(pi*i/L)`, C0 unliftered."""
    i = np.arange(num_coefficients, dtype=np.float64)
    lift = 1.0 + (lifter_coeff / 2.0) * np.sin(np.pi * i / lifter_coeff)
    lift[0] = 1.0
    out = lift.astype(dtype)
    out.setflags(write=False)
    return out


def mfcc(
    magnitude: torch.Tensor,
    sample_rate: int,
    fft_size: int,
    params: MFCCParams = MFCCParams(),
) -> torch.Tensor:
    """MFCC over frames: magnitude [..., F] -> [..., C]."""
    high = params.high_freq if params.high_freq > 0 else sample_rate / 2.0
    fb = device_table(
        mel_filterbank,
        (params.num_mel_filters, fft_size, sample_rate, params.low_freq, high),
        magnitude.device,
    )
    mel_spec = torch.matmul(magnitude * magnitude, fb.T)
    return mfcc_from_mel(mel_spec, params)


def mfcc_from_mel(mel_spec: torch.Tensor, params: MFCCParams = MFCCParams()) -> torch.Tensor:
    """log -> DCT-II -> lifter over mel energies [..., M] -> [..., C]."""
    dev = mel_spec.device
    dct = device_table(
        dct_matrix, (params.num_coefficients, params.num_mel_filters), dev
    )
    log_mel = torch.log(torch.clamp_min(mel_spec, _LOG_FLOOR))
    coeffs = torch.matmul(log_mel, dct.T)
    if params.use_liftering:
        coeffs = coeffs * device_table(
            lifter_vector, (params.num_coefficients, params.lifter_coeff), dev
        )
    return coeffs


def mel_spectrum(
    magnitude: torch.Tensor,
    sample_rate: int,
    fft_size: int,
    params: MFCCParams = MFCCParams(),
) -> torch.Tensor:
    """Mel power spectrum [..., M] (MFCCResult.MelSpectrum)."""
    high = params.high_freq if params.high_freq > 0 else sample_rate / 2.0
    fb = device_table(
        mel_filterbank,
        (params.num_mel_filters, fft_size, sample_rate, params.low_freq, high),
        magnitude.device,
    )
    return torch.matmul(magnitude * magnitude, fb.T)


def log_energy_c0(
    magnitude: torch.Tensor,
    sample_rate: int,
    fft_size: int,
    params: MFCCParams = MFCCParams(),
) -> torch.Tensor:
    """C0 before liftering = MFCCResult.LogEnergy (mfcc.go:152-156)."""
    p = dataclasses.replace(params, use_liftering=False)
    return mfcc(magnitude, sample_rate, fft_size, p)[..., 0]
