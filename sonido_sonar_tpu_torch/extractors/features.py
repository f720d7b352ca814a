"""ExtractedFeatures schema: plain dataclasses of fixed-shape tensors
(counterpart of `sonido_sonar_tpu/extractors/features.py`).

Reference parity: fingerprint/extractors/features.go:5-124. Ragged Go
slices become fixed-shape tensors plus (mask, count) pairs for
variable-length results (onsets, pauses, formants). All sub-structures
are optional (None when the content config disables them), mirroring
the omitempty JSON tags. `map_tensors` stands where the JAX package
registers the classes as pytrees.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

Tensor = Optional[torch.Tensor]


@dataclass
class SpectralFeatures:
    """features.go:32-44. All series are [..., T]; contrast is
    [..., T, num_bands]."""

    spectral_centroid: Tensor = None
    spectral_rolloff: Tensor = None
    spectral_bandwidth: Tensor = None
    spectral_flatness: Tensor = None
    spectral_crest: Tensor = None
    spectral_slope: Tensor = None
    spectral_flux: Tensor = None
    zero_crossing_rate: Tensor = None
    spectral_contrast: Tensor = None


@dataclass
class SpeechFeatures:
    """features.go:49-71. formant_frequencies is [..., T_f, max_formants]
    with formant_count giving validity."""

    formant_frequencies: Tensor = None
    formant_count: Tensor = None
    vocal_tract_length: Tensor = None   # scalar [...]
    voicing_probability: Tensor = None  # [..., T_p]
    spectral_tilt: Tensor = None        # [..., T_p]
    speech_rate: Tensor = None          # scalar [...]
    pause_duration: Tensor = None       # [..., max_pauses]
    pause_count: Tensor = None          # scalar [...]
    jitter: Tensor = None               # scalar [...]
    shimmer: Tensor = None              # scalar [...]


@dataclass
class TemporalFeatures:
    """features.go:76-97."""

    rms_energy: Tensor = None         # [..., T_e]
    peak_amplitude: Tensor = None     # scalar [...]
    average_amplitude: Tensor = None  # scalar [...]
    dynamic_range: Tensor = None      # scalar [...]
    crest_factor: Tensor = None       # [..., T_e]
    silence_ratio: Tensor = None      # scalar [...]
    activity_level: Tensor = None
    onset_density: Tensor = None      # scalar [...]
    onset_mask: Tensor = None         # [..., T_e-1] bool
    attack_time: Tensor = None        # [..., T_e-1] (0 off-onset)
    envelope_shape: Tensor = None     # [..., T_env]
    tempo_bpm: Tensor = None          # scalar [...] (music extractor)


@dataclass
class EnergyFeatures:
    """features.go:102-113."""

    short_time_energy: Tensor = None  # [..., T_e]
    energy_variance: Tensor = None    # scalar [...]
    energy_entropy: Tensor = None     # [..., T_e]
    loudness_range: Tensor = None     # scalar [...]
    low_energy_ratio: Tensor = None   # [..., T]
    high_energy_ratio: Tensor = None  # [..., T]


@dataclass
class HarmonicFeatures:
    """features.go:118-131."""

    pitch_estimate: Tensor = None       # [..., T_p]
    pitch_confidence: Tensor = None     # [..., T_p]
    voicing_strength: Tensor = None     # [..., T_p]
    harmonic_ratio: Tensor = None       # [..., T_p]
    inharmonicity_ratio: Tensor = None  # [..., T_p]
    tonal_centroid: Tensor = None       # [..., T_p]


@dataclass
class ExtractedFeatures:
    """features.go:5-27: the fingerprint payload."""

    spectral_features: Optional[SpectralFeatures] = None
    mfcc: Tensor = None             # [..., T, C]
    chroma_features: Tensor = None  # [..., T, 12]
    speech_features: Optional[SpeechFeatures] = None
    temporal_features: Optional[TemporalFeatures] = None
    energy_features: Optional[EnergyFeatures] = None
    harmonic_features: Optional[HarmonicFeatures] = None
    metadata: Dict[str, Any] = field(default_factory=dict)


def map_tensors(fn: Callable[[Any], Any], obj):
    """A copy of a feature dataclass with `fn` applied to every array
    field (a tensor, or a numpy array after `to_numpy`), nested
    dataclasses included; None fields and `metadata` are carried over as
    they are. `fn` may return any value (a numpy array, one row)."""
    if obj is None:
        return None
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return fn(obj)
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"map_tensors: not a feature dataclass: {type(obj).__name__}")
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kw[f.name] = dict(v) if f.name == "metadata" else map_tensors(fn, v)
    return type(obj)(**kw)


def to_numpy(features):
    """Pull a feature dataclass to host numpy (for export and compare)."""
    return map_tensors(lambda t: t.detach().cpu().numpy(), features)
