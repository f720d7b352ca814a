"""Fingerprint persistence: npz tensors + JSON metadata (counterpart of
`sonido_sonar_tpu/utils/serialize.py`, in the same format: the same npz
keys and header, the same JSON, so a file either package writes loads in
the other).

The reference serializes fingerprints as JSON value objects (struct tags
throughout extractors/features.go; Complex matrices excluded,
analyzers/spectral.go:25). Here the tensor payload goes to npz (compact,
mmap-able) and the metadata to JSON. A leaf may be a tensor on any
device: it is written as its host numpy array, dtype unchanged; a loaded
fingerprint holds numpy arrays.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import numpy as np
import torch

from sonido_sonar_tpu_torch.config.config import ContentType
from sonido_sonar_tpu_torch.extractors.features import (
    EnergyFeatures,
    ExtractedFeatures,
    HarmonicFeatures,
    SpectralFeatures,
    SpeechFeatures,
    TemporalFeatures,
)
from sonido_sonar_tpu_torch.fingerprint.generator import AudioFingerprint

_SUBSTRUCTS = {
    "spectral_features": SpectralFeatures,
    "speech_features": SpeechFeatures,
    "temporal_features": TemporalFeatures,
    "energy_features": EnergyFeatures,
    "harmonic_features": HarmonicFeatures,
}


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten_features(features: ExtractedFeatures) -> Dict[str, np.ndarray]:
    arrays: Dict[str, np.ndarray] = {}
    if features.mfcc is not None:
        arrays["mfcc"] = _host(features.mfcc)
    if features.chroma_features is not None:
        arrays["chroma_features"] = _host(features.chroma_features)
    for prefix, cls in _SUBSTRUCTS.items():
        sub = getattr(features, prefix)
        if sub is None:
            continue
        for f in dataclasses.fields(cls):
            v = getattr(sub, f.name)
            if v is not None:
                arrays[f"{prefix}.{f.name}"] = _host(v)
    return arrays


def _unflatten_features(arrays: Dict[str, np.ndarray]) -> ExtractedFeatures:
    feats = ExtractedFeatures(metadata={})
    if "mfcc" in arrays:
        feats.mfcc = arrays["mfcc"]
    if "chroma_features" in arrays:
        feats.chroma_features = arrays["chroma_features"]
    for prefix, cls in _SUBSTRUCTS.items():
        keys = {k.split(".", 1)[1]: k for k in arrays if k.startswith(prefix + ".")}
        if not keys:
            continue
        setattr(feats, prefix, cls(**{name: arrays[k] for name, k in keys.items()}))
    return feats


def save_fingerprint_npz(path: str, fp: AudioFingerprint) -> None:
    arrays = _flatten_features(fp.features)
    header = json.dumps(
        {
            "id": fp.id,
            "stream_url": fp.stream_url,
            "content_type": fp.content_type.value,
            "timestamp": fp.timestamp,
            "duration": fp.duration,
            "sample_rate": fp.sample_rate,
            "hop_size": fp.hop_size,
            "channels": fp.channels,
            "feature_weights": fp.metadata.get("feature_weights", {}),
            "extractor_name": fp.metadata.get("extractor_name", ""),
        }
    )
    np.savez_compressed(path, __header__=np.frombuffer(header.encode(), np.uint8), **arrays)


def load_fingerprint_npz(path: str) -> AudioFingerprint:
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        arrays = {k: data[k] for k in data.files if k != "__header__"}
    return AudioFingerprint(
        id=header["id"],
        stream_url=header["stream_url"],
        content_type=ContentType(header["content_type"]),
        timestamp=header["timestamp"],
        duration=header["duration"],
        sample_rate=header["sample_rate"],
        hop_size=header["hop_size"],
        channels=header["channels"],
        features=_unflatten_features(arrays),
        metadata={
            "feature_weights": header.get("feature_weights", {}),
            "extractor_name": header.get("extractor_name", ""),
        },
    )


def fingerprint_to_json(fp: AudioFingerprint) -> str:
    """Reference-style full-JSON export (arrays as nested lists)."""
    arrays = {k: v.tolist() for k, v in _flatten_features(fp.features).items()}
    return json.dumps(
        {
            "id": fp.id,
            "stream_url": fp.stream_url,
            "content_type": fp.content_type.value,
            "duration": fp.duration,
            "sample_rate": fp.sample_rate,
            "hop_size": fp.hop_size,
            "channels": fp.channels,
            "features": arrays,
        }
    )
