"""Batched fingerprint pipeline — the port's main path.

Counterpart of `sonido_sonar_tpu/parallel/pipeline.batched_fingerprint_features`:
[B, N] PCM -> dict of MFCC, chroma, spectral series, energy series and
pitch, with the same arguments, defaults, output keys, shapes and dtypes.
It follows the JAX package's fused-kernel branch on every device: the K1
kernel (`ops/hopper_stft.py`) gives the magnitudes together with rms,
zero crossings, the rolloff bin and the band ratios, and the K2 kernel
(`ops/hopper_yin.py`) gives pitch from the raw PCM at 1024/512. On a CPU
tensor both run their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Dict

import torch

from sonido_sonar_tpu_torch.config.config import WindowType
from sonido_sonar_tpu_torch.ops import spectral as S
from sonido_sonar_tpu_torch.ops.chroma import chroma_from_magnitude
from sonido_sonar_tpu_torch.ops.hopper_stft import stft_magnitude_hopper
from sonido_sonar_tpu_torch.ops.mfcc import MFCCParams, mfcc
from sonido_sonar_tpu_torch.ops.pitch import PitchParams, yin_pitch_from_signal
from sonido_sonar_tpu_torch.ops.temporal import energy_variance

_EPS = 1e-10


def batched_fingerprint_features(
    pcm: torch.Tensor,
    sample_rate: int = 44100,
    window_size: int = 1024,
    hop_size: int = 256,
    window_type: WindowType = WindowType.HANN,
    mfcc_coefficients: int = 13,
    enable_chroma: bool = True,
    enable_contrast: bool = True,
    enable_pitch: bool = True,
    pre_emphasis_coeff: float = 0.97,
) -> Dict[str, torch.Tensor]:
    """[B, N] PCM -> dict of [B, ...] float32 feature tensors.

    Covers the fingerprint payload the comparator consumes: MFCC, chroma,
    spectral series (centroid/rolloff/bandwidth/flatness/crest/slope/
    flux/zcr/contrast), energy series + stats, pitch/voicing.

    On a CUDA device the float32 matmuls (DFT, mel, DCT, chroma fold)
    feed log and ratio math and must run in true float32, so TF32 must be
    off (`torch.backends.cuda.matmul.allow_tf32 = False`, the default).
    """
    if pcm.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError(
            "batched_fingerprint_features needs true float32 matmuls: "
            "set torch.backends.cuda.matmul.allow_tf32 = False"
        )
    x = pcm.to(torch.float32).contiguous()
    mag, aux = stft_magnitude_hopper(
        x, window_size, hop_size, window_type, pre_emph=pre_emphasis_coeff
    )

    out: Dict[str, torch.Tensor] = {}
    out["mfcc"] = mfcc(
        mag, sample_rate, window_size, MFCCParams(num_coefficients=mfcc_coefficients)
    )
    if enable_chroma:
        out["chroma"] = chroma_from_magnitude(mag, sample_rate, window_size)
    out.update(S.spectral_descriptor_bundle(mag, sample_rate))
    if enable_contrast:
        out["spectral_contrast"] = S.spectral_contrast(mag, sample_rate, 6)

    # from the K1 epilogue: crossings/sec like ops.spectral.zcr; rolloff
    # bin -> Hz on the same grid as ops.spectral._freq_bins
    out["zcr"] = aux["zero_crossings"] / (window_size / float(sample_rate))
    nyquist = sample_rate / 2.0
    out["spectral_rolloff"] = aux["rolloff_bin"] * (nyquist / float(mag.shape[-1] - 1))
    out["low_energy_ratio"] = aux["low_energy_ratio"]
    out["high_energy_ratio"] = aux["high_energy_ratio"]
    rms = aux["rms"]
    out["rms_energy"] = rms
    out["energy_entropy"] = torch.where(rms > 0, -rms * torch.log(rms + 1e-10), 0.0)
    out["energy_variance"] = energy_variance(rms)

    if enable_pitch:
        pitch, conf, voicing = yin_pitch_from_signal(
            x, 1024, 512, PitchParams(sample_rate=sample_rate, window_size=1024),
            pre_emph=pre_emphasis_coeff,
        )
        out["pitch"] = pitch
        out["pitch_confidence"] = conf
        out["voicing"] = voicing
    return out
