"""Carry state across from the JAX package.

This system has no trained weights: its parameters are the constant
tables (windowed DFT basis, mel filterbank, DCT, lifter, chroma fold,
frequency grid) and the config. `constants_from_numpy` takes the JAX
package's tables as numpy arrays and returns them as the port's tensors,
so they can be held to the tables the port builds itself.
`feature_config_from_dict` reads a config written by the JAX package's
`config.asdict`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from sonido_sonar_tpu_torch.config.config import FeatureConfig, WindowType

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
