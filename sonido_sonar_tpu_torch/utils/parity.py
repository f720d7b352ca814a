"""The tolerances the port is held to, each with its reason.

One table serves both comparisons: the CPU tests (the port against the
JAX package, same numpy inputs) and `chip_smoke.py` (each CUDA kernel
against its plain PyTorch version on the card). Every check returns the
measured errors and a list of failures; the caller prints or asserts.
Inputs to the checks are numpy arrays; `synth_pcm` makes the test
signals both use.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Report = Tuple[Dict[str, float], List[str]]

# Threshold decisions (rolloff: cum >= 0.85 total) can flip by one bin
# between summation orders: at most this share of frames may differ, and
# each by exactly one bin.
ROLLOFF_FLIP_SHARE = 0.005
# A sample within this distance of 0 may change sign between two
# roundings of the pre-emphasis; frames holding one are exempt from the
# exact zero-crossing comparison.
ZC_NEAR_ZERO = 1e-6
# Pitch (bench.py:189-200): voiced frames must agree, pitch within rtol
# 1e-3 and confidence within 1e-3 on frames voiced in both.
PITCH_AGREEMENT = 0.99
PITCH_RTOL = 1e-3
CONF_ATOL = 1e-3
# Magnitudes: two float32 DFTs of 1024 samples agree to ~1e-6 of the
# frame's scale; 2e-4 of the largest magnitude is the JAX kernel tests'
# bound (tests/test_pallas_stft.py).
MAG_ATOL_SCALE = 2e-4

# key -> (rtol, atol); atol "scale:x" means x times max |reference|.
#
# These hold whole feature dicts computed from two different float32
# DFTs (the port against JAX, or a kernel against its plain version).
# Their magnitudes agree to ~1.2e-6 of each frame's peak (measured), so a
# bin far under the peak carries a large relative error. Features that
# take the log of single bins or of small band energies (MFCC, contrast,
# flatness, slope) amplify it by the frame's dynamic range: over 64 rows
# of synth_pcm (tonal rows have a ~70 dB floor), port vs JAX on the CPU,
# the worst cases were MFCC 6.7e-3, contrast 0.148 dB (0.4 %), flatness
# 4.3e-4 (0.2 %), slope 9.6e-4. Their bounds below are ~3x those. On
# identical magnitudes the same functions agree to the JAX tests' bounds
# (MFCC 1e-3, contrast 1e-3 dB; tests/test_torch_pipeline.py).
FEATURE_TOLERANCES = {
    "mfcc": (0.0, 2e-2),
    "spectral_contrast": (1e-2, 2e-2),
    "spectral_flatness": (1e-2, 1e-5),
    "spectral_slope": (0.0, 3e-3),
    # unit-sum fractions of fold energies
    "chroma": (0.0, 1e-5),
    # ratios of float32 sums over F bins: ~1e-6 relative, 100x margin
    "spectral_centroid": (1e-4, 1e-2),
    "spectral_bandwidth": (1e-4, 1e-2),
    "spectral_crest": (1e-4, 1e-6),
    # differences of neighbouring magnitudes: the magnitude bound
    "spectral_flux": (0.0, "scale:2e-4"),
    # per-frame sums in another order
    "rms_energy": (1e-5, 1e-9),
    "energy_entropy": (1e-5, 1e-8),
    "low_energy_ratio": (1e-5, 1e-6),
    "high_energy_ratio": (1e-5, 1e-6),
    # sample variance of rms: mean subtraction cancels ~1 digit
    "energy_variance": (1e-4, 1e-12),
}


def synth_pcm(
    batch: int, n: int, seed: int, sample_rate: int = 44100, device="cpu"
) -> torch.Tensor:
    """[batch, n] float32 test PCM on `device`: every fourth row white
    noise (sigma 0.1), the others 12-harmonic tones (f0 100-800 Hz,
    amplitude 0.5/k) plus light noise, so that YIN finds voiced frames
    after 0.97 pre-emphasis. Parameters and noise come from numpy's
    generator seeded with `seed`; the tones are evaluated in float64 on
    `device` (fast at 128 x 30 s on a GPU)."""
    harmonics = 12
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(100.0, 800.0, batch)
    phases = rng.uniform(0.0, 2 * np.pi, (batch, harmonics))
    sigma = rng.uniform(0.001, 0.01, batch)
    tonal = (np.arange(batch) % 4) != 3
    sigma[~tonal] = 0.1
    noise = torch.from_numpy(rng.standard_normal((batch, n), dtype=np.float32)).to(device)
    t = torch.arange(n, dtype=torch.float64, device=device) / sample_rate
    f0_t = torch.from_numpy(f0).to(device)[:, None]
    ph = torch.from_numpy(phases).to(device)
    x = torch.zeros((batch, n), dtype=torch.float64, device=device)
    for k in range(1, harmonics + 1):
        x += (0.5 / k) * torch.sin(2 * np.pi * k * f0_t * t + ph[:, k - 1: k])
    x *= torch.from_numpy(tonal.astype(np.float64)).to(device)[:, None]
    x += torch.from_numpy(sigma).to(device)[:, None] * noise
    return x.to(torch.float32).contiguous()


def _close(name: str, got, ref, rtol, atol, errors, failures) -> None:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        failures.append(f"{name}: shape {got.shape} != {ref.shape}")
        return
    if isinstance(atol, str):
        atol = float(atol.split(":")[1]) * float(np.abs(ref).max(initial=0.0))
    diff = np.abs(got - ref)
    errors[name] = float(diff.max(initial=0.0))
    bad = ~(diff <= atol + rtol * np.abs(ref))
    if bad.any():
        i = np.unravel_index(np.argmax(diff - rtol * np.abs(ref)), diff.shape)
        failures.append(
            f"{name}: {int(bad.sum())} elements beyond rtol {rtol} atol {atol:.3g}"
            f" (worst at {i}: got {got[i]:.8g}, ref {ref[i]:.8g})"
        )


def near_zero_frames(
    pcm: np.ndarray, window_size: int, hop_size: int, pre_emph: float
) -> np.ndarray:
    """[..., T] bool: frames of the pre-emphasized signal holding a sample
    within ZC_NEAR_ZERO of 0."""
    x = np.asarray(pcm, dtype=np.float32)
    if pre_emph != 0.0:
        prev = np.concatenate([np.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)
        x = x - np.float32(pre_emph) * prev
    near = np.abs(x) < ZC_NEAR_ZERO
    frames = np.lib.stride_tricks.sliding_window_view(near, window_size, axis=-1)
    return frames[..., ::hop_size, :].any(axis=-1)


def _zero_crossings(name, got, ref, near, errors, failures) -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    diff = np.abs(got - ref)
    errors[name] = float(diff.max(initial=0.0))
    bad = (diff != 0) & ~near
    if bad.any():
        failures.append(f"{name}: {int(bad.sum())} frames differ away from near-zero samples")


def _rolloff(name, got, ref, unit, errors, failures) -> None:
    steps = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)) / unit
    off = np.rint(steps)
    errors[name] = float(steps.max(initial=0.0))
    share = float((off != 0).mean()) if off.size else 0.0
    errors[name + "_flip_share"] = share
    if (off > 1).any() or np.abs(steps - off).max(initial=0.0) > 1e-3:
        failures.append(f"{name}: values differ by other than one bin")
    if share > ROLLOFF_FLIP_SHARE:
        failures.append(f"{name}: {share:.4f} of frames off by one bin (limit {ROLLOFF_FLIP_SHARE})")


def check_pitch(pitch, conf, ref_pitch, ref_conf) -> Report:
    """Voiced agreement (both voiced / either voiced), pitch rtol and
    confidence atol on frames voiced in both."""
    errors: Dict[str, float] = {}
    failures: List[str] = []
    p, rp = np.asarray(pitch), np.asarray(ref_pitch)
    c, rc = np.asarray(conf), np.asarray(ref_conf)
    if p.shape != rp.shape or c.shape != rc.shape:
        return errors, [f"pitch: shape {p.shape} != {rp.shape}"]
    both = (p > 0) & (rp > 0)
    either = (p > 0) | (rp > 0)
    agreement = float(both.sum() / either.sum()) if either.any() else 1.0
    errors["voiced_agreement"] = agreement
    errors["voiced_share"] = float(both.mean()) if both.size else 0.0
    errors["pitch_max_rel"] = float((np.abs(p - rp)[both] / rp[both]).max(initial=0.0))
    errors["conf_max_abs"] = float(np.abs(c - rc)[both].max(initial=0.0))
    if agreement < PITCH_AGREEMENT:
        failures.append(f"pitch: voiced agreement {agreement:.4f} < {PITCH_AGREEMENT}")
    if errors["pitch_max_rel"] > PITCH_RTOL:
        failures.append(f"pitch: max relative difference {errors['pitch_max_rel']:.3g} > {PITCH_RTOL}")
    if errors["conf_max_abs"] > CONF_ATOL:
        failures.append(f"confidence: max difference {errors['conf_max_abs']:.3g} > {CONF_ATOL}")
    return errors, failures


def check_stft_aux(mag, aux, ref_mag, ref_aux, near_zero) -> Report:
    """K1 outputs (magnitude [.., T, F] and its aux dict) against a reference."""
    errors: Dict[str, float] = {}
    failures: List[str] = []
    _close("magnitude", mag, ref_mag, 0.0, f"scale:{MAG_ATOL_SCALE}", errors, failures)
    _close("rms", aux["rms"], ref_aux["rms"], *FEATURE_TOLERANCES["rms_energy"], errors, failures)
    for key in ("low_energy_ratio", "high_energy_ratio"):
        _close(key, aux[key], ref_aux[key], *FEATURE_TOLERANCES[key], errors, failures)
    _zero_crossings("zero_crossings", aux["zero_crossings"], ref_aux["zero_crossings"],
                    near_zero, errors, failures)
    _rolloff("rolloff_bin", aux["rolloff_bin"], ref_aux["rolloff_bin"], 1.0, errors, failures)
    return errors, failures


def check_features(
    got: dict, ref: dict, near_zero, sample_rate: int, window_size: int
) -> Report:
    """Whole `batched_fingerprint_features` dicts, key by key."""
    errors: Dict[str, float] = {}
    failures: List[str] = []
    if sorted(got) != sorted(ref):
        failures.append(f"keys differ: {sorted(set(got) ^ set(ref))}")
    for key in sorted(set(got) & set(ref)):
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        if g.dtype != r.dtype or g.shape != r.shape:
            failures.append(f"{key}: {g.dtype}{g.shape} != {r.dtype}{r.shape}")
        elif not np.isfinite(g).all():
            failures.append(f"{key}: non-finite values")
        elif key in FEATURE_TOLERANCES:
            _close(key, g, r, *FEATURE_TOLERANCES[key], errors, failures)
        elif key == "zcr":
            _zero_crossings(key, g, r, near_zero, errors, failures)
        elif key == "spectral_rolloff":
            # one bin = nyquist / (F - 1) Hz, F - 1 = W / 2
            unit = (sample_rate / 2.0) / (window_size // 2)
            _rolloff(key, g, r, unit, errors, failures)
    if "pitch" in got and "pitch" in ref:
        e, f = check_pitch(got["pitch"], got["pitch_confidence"],
                           ref["pitch"], ref["pitch_confidence"])
        errors.update(e)
        failures.extend(f)
        _close("voicing_is_confidence", got["voicing"], got["pitch_confidence"],
               0.0, 0.0, errors, failures)
    return errors, failures
