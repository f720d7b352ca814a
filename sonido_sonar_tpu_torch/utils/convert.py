"""Carry state across from the JAX package.

This system has no trained weights: its parameters are the constant
tables (windowed DFT basis, mel filterbank, DCT, lifter, chroma fold,
frequency grid) and the config. `constants_from_numpy` takes the JAX
package's tables as numpy arrays and returns them as the port's tensors,
so they can be held to the tables the port builds itself.
`feature_config_from_dict`, `fingerprint_config_from_dict` and
`comparison_config_from_dict` read configs written by the JAX package's
`config.asdict`; `features_to_numpy` flattens an ExtractedFeatures of
either package into one dict of numpy arrays, so the tests compare both
with one function. The comparator has no weights either: its state is
the corpus, and `fingerprint_from_reference` carries a fingerprint of
the JAX package (or any object of its fields) across, so both
comparators score the same corpus. `stft_result_from_reference` carries
a spectrogram across, so both packages' extractor compositions read the
same magnitudes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from sonido_sonar_tpu_torch.config.config import (
    ComparisonConfig,
    ContentAwareConfig,
    ContentType,
    FeatureConfig,
    FingerprintConfig,
    WindowType,
)
from sonido_sonar_tpu_torch.extractors import features as F
from sonido_sonar_tpu_torch.fingerprint.generator import AudioFingerprint
from sonido_sonar_tpu_torch.ops.stft import STFTResult

CONSTANT_KEYS = (
    "dft_basis",       # [W, 2F] windowed rDFT basis (ops/stft._windowed_dft_matrix)
    "mel_filterbank",  # [M, F] (ops/mel.mel_filterbank)
    "dct",             # [C, M] orthonormal DCT-II (ops/mfcc.dct_matrix)
    "lifter",          # [C] (ops/mfcc.lifter_vector)
    "chroma_fold",     # [12, F] (ops/chroma.chroma_fold_matrix)
    "freq_bins",       # [F] bin frequencies in Hz (ops/spectral._freq_bins)
)


def constants_from_numpy(
    arrays: Mapping[str, np.ndarray], device
) -> Dict[str, torch.Tensor]:
    """The JAX package's constant tables -> float32 tensors on `device`.
    Keys are CONSTANT_KEYS; an unknown key or a non-finite table raises."""
    unknown = sorted(set(arrays) - set(CONSTANT_KEYS))
    if unknown:
        raise ValueError(f"unknown constant tables {unknown}; expected {CONSTANT_KEYS}")
    out = {}
    for key, arr in arrays.items():
        a = np.array(arr, dtype=np.float32)
        if not np.isfinite(a).all():
            raise ValueError(f"constant table {key} holds non-finite values")
        out[key] = torch.from_numpy(a).to(device)
    return out


def feature_config_from_dict(d: Mapping) -> FeatureConfig:
    """FeatureConfig from a dict such as the JAX package's
    `config.asdict(FeatureConfig(...))` (enums as values, tuples as
    lists). Unknown keys raise."""
    names = {f.name for f in dataclasses.fields(FeatureConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown FeatureConfig fields {unknown}")
    kw = dict(d)
    if "window_type" in kw:
        kw["window_type"] = WindowType(kw["window_type"])
    if "freq_range" in kw:
        kw["freq_range"] = tuple(float(v) for v in kw["freq_range"])
    if "similarity_weights" in kw:
        kw["similarity_weights"] = tuple(
            (str(name), float(w)) for name, w in kw["similarity_weights"]
        )
    return FeatureConfig(**kw)


def _check_fields(cls, d: Mapping) -> None:
    unknown = sorted(set(d) - {f.name for f in dataclasses.fields(cls)})
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields {unknown}")


def fingerprint_config_from_dict(d: Mapping) -> FingerprintConfig:
    """FingerprintConfig from a dict such as the JAX package's
    `config.asdict(FingerprintConfig(...))`: the feature config, the
    content-aware config and the hashing flag. The per-content configs
    the JAX `ContentAwareConfigManager.get_generation_config` returns are
    FingerprintConfigs too, and convert the same way. Unknown keys raise."""
    _check_fields(FingerprintConfig, d)
    kw = dict(d)
    if "feature_config" in kw:
        kw["feature_config"] = feature_config_from_dict(kw["feature_config"])
    if "content_aware" in kw:
        ca = dict(kw["content_aware"])
        _check_fields(ContentAwareConfig, ca)
        if "default_content_type" in ca:
            ca["default_content_type"] = ContentType(ca["default_content_type"])
        kw["content_aware"] = ContentAwareConfig(**ca)
    return FingerprintConfig(**kw)


def comparison_config_from_dict(d: Mapping) -> ComparisonConfig:
    """ComparisonConfig from a dict such as the JAX package's
    `config.asdict(ComparisonConfig(...))` (the content type as its
    value, the weights as lists). Unknown keys raise."""
    _check_fields(ComparisonConfig, d)
    kw = dict(d)
    if "content_type" in kw:
        kw["content_type"] = ContentType(kw["content_type"])
    if "feature_weights" in kw:
        kw["feature_weights"] = tuple((str(name), float(w)) for name, w in kw["feature_weights"])
    return ComparisonConfig(**kw)


_SUBSTRUCTS = {
    "spectral_features": F.SpectralFeatures,
    "speech_features": F.SpeechFeatures,
    "temporal_features": F.TemporalFeatures,
    "energy_features": F.EnergyFeatures,
    "harmonic_features": F.HarmonicFeatures,
}


def _features_from_reference(src: Any):
    """The port's ExtractedFeatures from any object with its fields: every
    array leaf as numpy (`np.asarray`, so numpy, lists and arrays of
    other frameworks that hand numpy their buffer), None kept."""

    def convert(cls, obj):
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(obj, f.name, None)
            if f.name == "metadata":
                kw[f.name] = dict(v or {})
            elif v is None:
                kw[f.name] = None
            elif dataclasses.is_dataclass(v):
                kw[f.name] = convert(_SUBSTRUCTS[f.name], v)
            else:
                kw[f.name] = np.asarray(v)
        return cls(**kw)

    return None if src is None else convert(F.ExtractedFeatures, src)


def fingerprint_from_reference(fp: Any) -> AudioFingerprint:
    """The port's AudioFingerprint from any object with the fields of
    `AudioFingerprint` (the JAX package's, read by duck typing): the
    content type by its value, the features' leaves as numpy, the
    metadata a shallow copy."""
    return AudioFingerprint(
        id=fp.id,
        stream_url=fp.stream_url,
        content_type=ContentType(getattr(fp.content_type, "value", fp.content_type)),
        timestamp=fp.timestamp,
        duration=fp.duration,
        sample_rate=fp.sample_rate,
        hop_size=fp.hop_size,
        channels=fp.channels,
        features=_features_from_reference(fp.features),
        metadata=dict(fp.metadata or {}),
    )


def stft_result_from_reference(
    mag, phase, complex_spec, sample_rate: int, window_size: int, hop_size: int, device
) -> STFTResult:
    """The port's STFTResult from a spectrogram's arrays (numpy, or
    anything numpy reads, such as the JAX package's `STFTResult` fields):
    magnitude and phase as float32, the complex spectrum as complex64,
    None kept, all on `device`. The magnitude must be [..., T, W // 2 + 1]
    and finite."""
    def tensor(a, dtype):
        return None if a is None else torch.as_tensor(np.array(a, dtype=dtype), device=device)

    m = tensor(mag, np.float32)
    if m.dim() < 2 or m.shape[-1] != window_size // 2 + 1:
        raise ValueError(f"magnitude {tuple(m.shape)} is not [..., T, {window_size // 2 + 1}]")
    if not bool(torch.isfinite(m).all()):
        raise ValueError("magnitude holds non-finite values")
    return STFTResult(m, tensor(phase, np.float32), tensor(complex_spec, np.complex64),
                      int(sample_rate), int(window_size), int(hop_size))


def flatten_features(features: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten an ExtractedFeatures of either package into
    {"spectral_features.spectral_centroid": array, ...}: one key per array
    field, the arrays as they are; None fields and `metadata` left out."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(features):
        v = getattr(features, f.name)
        if v is None or f.name == "metadata":
            continue
        if dataclasses.is_dataclass(v):
            out.update(flatten_features(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


def features_to_numpy(features: Any) -> Dict[str, np.ndarray]:
    """`flatten_features` with every array on the host as numpy (tensors,
    JAX or numpy arrays alike), so both packages compare with one
    function."""
    return {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in flatten_features(features).items()
    }
