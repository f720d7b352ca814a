"""The tolerances the port is held to, each with its reason.

One table serves both comparisons: the CPU tests (the port against the
JAX package, same numpy inputs) and the card tests
(`tests/test_torch_card_*.py`: each CUDA kernel against its plain
PyTorch version, each path on the card against the CPU). Every check
returns the measured errors and a list of failures; the caller prints or
asserts. Inputs to the checks are numpy arrays; `synth_pcm` makes the
test signals both use.
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
# The complex spectrum takes the magnitudes' bound. Phase: the two
# packages' complex values agree to ~7e-7 of the largest magnitude at
# 1024 (DFT matmul) and ~2e-7 at 4096 (FFT), so on bins above
# PHASE_MAG_FLOOR of their frame's peak the phase moves by ~1e-3 rad at
# most (measured 2.8e-4 rad); PHASE_ATOL is 1e-2 rad, wrapped.
PHASE_MAG_FLOOR = 1e-3
PHASE_ATOL = 1e-2
# dB of the same float32 powers through two libraries' log10: an ulp of
# the result, ~1e-5 dB at 100 dB.
LOG_POWER_ATOL_DB = 1e-4
# One row of a batch against the same clip alone through an extractor
# composition: the JAX test's bound (tests/test_surface_extras.py:243-295).
BATCH_ROW_TOL = (1e-4, 1e-4)

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
    # 10 log10 of the flatness: its 1 % bound is 0.043 dB
    "spectral_flatness_db": (0.0, 5e-2),
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


# K10, the feature epilogue: feat [..., T, 43], mel in lanes 0-25, chroma
# in 26-37, then FEAT_DESCRIPTORS. On the same magnitudes (the kernel's
# lanes against its plain version over the kernel's own magnitudes; the
# port's plain lanes against JAX's epilogue over JAX's magnitudes) the
# bounds are those JAX's tests hold its epilogue to against the XLA
# functions (tests/test_pallas_stft.py:173-210): JAX sums mel, chroma and
# the masked logs as bf16 hi/lo three-pass matmuls (~1.5e-5 relative) and
# takes bandwidth by the moment expansion f2m - fm^2 / m. Descriptors
# other than bandwidth: |got - ref| <= 2e-3 max(|ref|, 1).
FEAT_DESCRIPTORS = ("spectral_centroid", "spectral_bandwidth", "spectral_flatness",
                    "spectral_crest", "spectral_slope")
FEAT_SAME_MAGNITUDES = {"mel": (1e-4, 1e-7), "chroma": (1e-3, 2e-5),
                        "spectral_bandwidth": (1e-3, 2.0)}
FEAT_DESCRIPTOR_SCALED_ATOL = 2e-3
# Across two DFTs (a kernel against its plain version, the port against
# JAX) the descriptors and chroma take FEATURE_TOLERANCES, and a mel
# energy carries the magnitudes' error through 2 m dm summed over its
# filter: beyond rtol 1e-4 of itself, at most 5.7e-9 of the largest mel
# energy of the input (measured, port against JAX's kernel, 4 s of a
# two-tone signal and 2-4 synth_pcm rows); bounded at 1e-6 of it.
FEAT_MEL_ACROSS_DFTS = (1e-4, "scale:1e-6")
# JAX's epilogue configuration against the port's (parallel/pipeline.py
# :119-141): its chroma and bandwidth lanes at its own bounds above.
FEAT_EPILOGUE_TOLERANCES = {"chroma": FEAT_SAME_MAGNITUDES["chroma"],
                            "spectral_bandwidth": FEAT_SAME_MAGNITUDES["spectral_bandwidth"]}
# K3, the YIN difference rows: E1 + S - 2r with r through the kernel's
# fp32 real FFTs against the same formulation through DFT matmuls, 2e-4
# of the largest |d| (the JAX kernel tests' bound,
# tests/test_pallas_yin.py:35-45).
YIN_DIFF_ATOL_SCALE = 2e-4
# K9, the contrast band means: exact k-th values, so only the fp32 sums
# of the selected powers differ from a sort's mean (~1e-7 relative);
# 2e-5 is the JAX kernel tests' bound (tests/test_pallas_contrast.py:54).
BAND_MEANS_RTOL = 2e-5

# K2's period amplitude (pallas_yin.py:356-368): RMS over the first
# plen = trunc(sr / pitch) samples. Where two pitches agree to ~3e-6
# relative, plen still moves by one sample where sr / pitch sits at an
# integer, and the amplitude then moves by ~1/plen. So the check counts
# the frames whose amplitude misses rtol 1e-5 (summation order alone
# gives ~1e-7) and allows at most this share of them.
AMP_RTOL = 1e-5
AMP_MISS_SHARE = 0.01
# Shimmer and amplitude stability, the port against JAX on the CPU: the
# JAX CPU path takes each period's energy as the difference of two
# prefixes of a float32 cumsum of squares over the whole row
# (ops/speech.py:387-408), which loses ~2^-24 * n * mean(x^2) on a row of
# n samples, against ~plen * mean(x^2) for the period (plen >= sr/500 =
# 88 at 44.1 kHz). Two such errors per period give a relative amplitude
# error up to 2 * 2^-24 * n / 88; shimmer is a percentage of relative
# amplitude differences (x 100), amplitude stability a coefficient of
# variation (x 1). The port's frame-based plain version has no such
# error, so the bound is the reference's: per sample of row length,
SHIMMER_ATOL_PER_SAMPLE = 100 * 2 * 2.0**-24 / 88
AMP_STABILITY_ATOL_PER_SAMPLE = 2 * 2.0**-24 / 88
# dc_removal: the two packages' chunked float32 recurrences round
# differently by ~1e-7 of the signal scale; a sample within this
# distance of 0 may change sign after DC removal + pre-emphasis, and its
# frames are exempt from the exact zero-crossing comparison.
DC_NEAR_ZERO = 1e-5

# The extractor payloads (program dicts and ExtractedFeatures fields,
# keyed by the last component of the field path); FEATURE_TOLERANCES
# above also applies. (rtol, atol):
EXTRACTOR_TOLERANCES = {
    # float32 sums of x^2 or |x| over frames in another order (~1e-7)
    "short_time_energy": (1e-5, 1e-9),
    "envelope_shape": (1e-5, 1e-9),
    "average_amplitude": (1e-5, 1e-9),
    "peak_amplitude": (1e-5, 1e-9),
    "crest_factor": (1e-5, 1e-6),
    "noise_measure": (1e-5, 1e-6),
    # dB (LU) of such sums: 1e-5 relative is ~4e-5 dB
    "loudness_range": (0.0, 1e-3),
    "dynamic_range": (0.0, 1e-3),
    "spectral_tilt": (1e-5, 1e-4),
    # correlations and cosines of chroma fractions (chroma: 1e-5)
    "key_correlations": (0.0, 1e-5),
    "chord_score": (0.0, 1e-5),
    # per-frame values of the pitch track, on frames whose voicing
    # decision agrees (check_pitch bounds the share that does not):
    # the confidence bound, x10 where the reference scales it
    "pitch_confidence": (0.0, CONF_ATOL),
    "voicing": (0.0, CONF_ATOL),
    "voicing_probability": (0.0, CONF_ATOL),
    "voicing_strength": (0.0, CONF_ATOL),
    "inharmonicity": (0.0, CONF_ATOL),
    "inharmonicity_ratio": (0.0, CONF_ATOL),
    "harmonic_ratio": (1e-4, 10 * CONF_ATOL),
    "tonal_centroid": (PITCH_RTOL, 1e-2),
    # HNR in dB from one autocorrelation lag (FFT against direct sums):
    # ~1e-6 of r0 on r, near the -100 dB clamp that is ~1e-2 dB
    "hnr": (1e-4, 1e-2),
    "f0_mean": (PITCH_RTOL, 0.0),
    "jitter": (0.0, 1e-3),
    "quality": (0.0, 2e-3),
    # formants: envelope peaks on the same 43 Hz bin grid
    "formant_frequencies": (1e-5, 1e-2),
    "vocal_tract_length": (1e-5, 1e-3),
    # counts over frames and decisions on them: equal
    "speech_rate": (0.0, 1e-6),
    "pause_duration": (0.0, 1e-6),
    "silence_ratio": (0.0, 1e-6),
    "onset_density": (0.0, 1e-6),
    "attack_time": (0.0, 1e-6),
    "tempo_bpm": (0.0, 0.0),
}
_ALIASES = {
    "zero_crossing_rate": "zcr",
    "chroma_features": "chroma",
    "pitch_estimate": "pitch",
}
# per-frame keys that follow the voicing decision of the pitch track
_PITCH_DERIVED = (
    "pitch_confidence", "voicing", "voicing_probability", "voicing_strength",
    "inharmonicity", "inharmonicity_ratio", "harmonic_ratio", "tonal_centroid", "hnr",
)


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


def voiced_pcm(batch: int, n: int, seed: int, sample_rate: int = 44100) -> torch.Tensor:
    """[batch, n] float32 speech-like PCM on the CPU: every fourth row
    white noise (sigma 0.1), the others 8-harmonic voices (f0 120-300 Hz
    with 3 % vibrato at 5 Hz and 20 % tremolo at 3 Hz, so jitter and
    shimmer are not zero) plus light noise; drawn from numpy's generator
    seeded with `seed`."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sample_rate
    rows = []
    for i, f0 in enumerate(rng.uniform(120.0, 300.0, batch)):
        if i % 4 == 3:
            rows.append(0.1 * rng.standard_normal(n))
            continue
        phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))) / sample_rate
        x = sum((0.5 / k) * np.sin(k * phase + rng.uniform(0, 2 * np.pi)) for k in range(1, 9))
        rows.append(x * (1 + 0.2 * np.sin(2 * np.pi * 3 * t)) + 0.003 * rng.standard_normal(n))
    return torch.from_numpy(np.stack(rows).astype(np.float32))


def harmonic_clips(
    batch: int, n: int, seed: int, sample_rate: int = 44100, f0: float = 196.0, device="cpu"
) -> torch.Tensor:
    """[batch, n] float32 music-like clips as the JAX bench's
    generate-batch line builds them (bench.py:421-435): 4 harmonics of
    f0 at 0.5/h, a per-row gain in [0.6, 1.0), noise sigma 0.01; gains
    and noise from numpy's generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    gain = torch.from_numpy(0.6 + 0.4 * rng.random((batch, 1), dtype=np.float32)).to(device)
    noise = torch.from_numpy(rng.standard_normal((batch, n), dtype=np.float32)).to(device)
    tgrid = torch.arange(n, dtype=torch.float32, device=device) / sample_rate
    sig = sum(
        torch.sin(2 * np.pi * f0 * (h + 1) * tgrid + 0.1 * h) * (0.5 / (h + 1)) for h in range(4)
    )
    return (sig[None, :] * gain + 0.01 * noise).contiguous()


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
    pcm: np.ndarray, window_size: int, hop_size: int, pre_emph: float,
    threshold: float = ZC_NEAR_ZERO,
) -> np.ndarray:
    """[..., T] bool: frames of the pre-emphasized signal holding a sample
    within `threshold` of 0."""
    x = np.asarray(pcm, dtype=np.float32)
    if pre_emph != 0.0:
        prev = np.concatenate([np.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)
        x = x - np.float32(pre_emph) * prev
    near = np.abs(x) < threshold
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
    got: dict, ref: dict, near_zero, sample_rate: int, window_size: int,
    tolerances: dict = None,
) -> Report:
    """Whole `batched_fingerprint_features` dicts, key by key;
    `tolerances` replaces FEATURE_TOLERANCES' entries for its keys."""
    errors: Dict[str, float] = {}
    failures: List[str] = []
    tol = {**FEATURE_TOLERANCES, **(tolerances or {})}
    if sorted(got) != sorted(ref):
        failures.append(f"keys differ: {sorted(set(got) ^ set(ref))}")
    for key in sorted(set(got) & set(ref)):
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        if g.dtype != r.dtype or g.shape != r.shape:
            failures.append(f"{key}: {g.dtype}{g.shape} != {r.dtype}{r.shape}")
        elif not np.isfinite(g).all():
            failures.append(f"{key}: non-finite values")
        elif key in tol:
            _close(key, g, r, *tol[key], errors, failures)
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


def check_sharded_step(got: dict, ref: dict, near_zero, sample_rate: int,
                       window_size: int) -> Report:
    """A mesh's sharded `batched_fingerprint_features` (the shards' rows
    joined) against one unsharded step on the same device: the same
    kernels and operations on fewer rows, so bit for bit wherever a
    library's algorithm does not depend on the row count. A library may
    pick another algorithm for a shard's rows (cuBLAS another GEMM for 64
    clips than for 128: another order of float32 sums), a smaller change
    than the two DFTs FEATURE_TOLERANCES covers, so a key that is not
    bit-equal is held to check_features. errors[key] is each key's
    largest |difference|; `near_zero` is called only if a key differs."""
    errors = {k: float(np.abs(np.asarray(got[k], np.float64) - np.asarray(ref[k], np.float64))
                       .max(initial=0.0)) for k in ref if k in got}
    if sorted(got) == sorted(ref) and all(
            np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype
            and np.array_equal(got[k], ref[k]) for k in ref):
        return errors, []
    e, failures = check_features(got, ref, near_zero(), sample_rate, window_size)
    return {**errors, **{f"held_{k}": v for k, v in e.items()}}, failures


def check_period_amp(amp, ref_amp) -> Report:
    """K2's period amplitude against a reference: the share of frames
    beyond AMP_RTOL must stay under AMP_MISS_SHARE."""
    a = np.asarray(amp, np.float64)
    r = np.asarray(ref_amp, np.float64)
    if a.shape != r.shape:
        return {}, [f"period amplitude: shape {a.shape} != {r.shape}"]
    rel = np.abs(a - r) / np.maximum(np.abs(r), 1e-30)
    miss = rel > AMP_RTOL
    errors = {"amp_max_rel": float(rel.max(initial=0.0)),
              "amp_miss_share": float(miss.mean()) if miss.size else 0.0}
    failures = []
    if errors["amp_miss_share"] > AMP_MISS_SHARE:
        failures.append(f"period amplitude: {errors['amp_miss_share']:.4f} of frames beyond "
                        f"rtol {AMP_RTOL} (limit {AMP_MISS_SHARE})")
    return errors, failures


def check_feat(feat, ref, same_magnitudes: bool) -> Report:
    """K10 lanes [..., T, 43] against a reference: on the same magnitudes
    (FEAT_SAME_MAGNITUDES) or across two DFTs (FEAT_MEL_ACROSS_DFTS and
    FEATURE_TOLERANCES)."""
    g = np.asarray(feat, np.float64)
    r = np.asarray(ref, np.float64)
    if g.shape != r.shape:
        return {}, [f"feat: shape {g.shape} != {r.shape}"]
    errors: Dict[str, float] = {}
    failures: List[str] = []
    if not np.isfinite(g).all():
        failures.append("feat: non-finite values")
    if same_magnitudes:
        _close("mel", g[..., :26], r[..., :26], *FEAT_SAME_MAGNITUDES["mel"], errors, failures)
        _close("chroma", g[..., 26:38], r[..., 26:38], *FEAT_SAME_MAGNITUDES["chroma"],
               errors, failures)
    else:
        _close("mel", g[..., :26], r[..., :26], *FEAT_MEL_ACROSS_DFTS, errors, failures)
        _close("chroma", g[..., 26:38], r[..., 26:38], *FEATURE_TOLERANCES["chroma"],
               errors, failures)
    for lane, key in enumerate(FEAT_DESCRIPTORS, start=38):
        gk, rk = g[..., lane], r[..., lane]
        if not same_magnitudes:
            _close(key, gk, rk, *FEATURE_TOLERANCES[key], errors, failures)
        elif key in FEAT_SAME_MAGNITUDES:
            _close(key, gk, rk, *FEAT_SAME_MAGNITUDES[key], errors, failures)
        else:
            scale = np.maximum(np.abs(rk), 1.0)
            _close(key, gk / scale, rk / scale, 0.0, FEAT_DESCRIPTOR_SCALED_ATOL,
                   errors, failures)
    return errors, failures


def check_band_means(peak, valley, ref_peak, ref_valley) -> Report:
    """K9's (peak, valley) [..., NB] against a reference, rtol
    BAND_MEANS_RTOL (atol 1e-12 for the zero means)."""
    errors: Dict[str, float] = {}
    failures: List[str] = []
    _close("peak", peak, ref_peak, BAND_MEANS_RTOL, 1e-12, errors, failures)
    _close("valley", valley, ref_valley, BAND_MEANS_RTOL, 1e-12, errors, failures)
    return errors, failures


# Extractor metadata: numbers computed on the device, key -> (rtol, atol);
# every other value must be equal. The sports extractor's excitement
# proxies are the energy variance (FEATURE_TOLERANCES) and the log2
# entropy of the frames' energy shares (float32 sums over T frames,
# ~1e-7 relative; 1e-5).
METADATA_TOLERANCES = {
    "excitement_variance": FEATURE_TOLERANCES["energy_variance"],
    "excitement_entropy": (1e-5, 1e-6),
}


def check_metadata(got: dict, ref: dict) -> Report:
    """ExtractedFeatures metadata: the same keys, the values of
    METADATA_TOLERANCES' keys (a float or a list of floats) within their
    bounds, every other value equal."""
    errors: Dict[str, float] = {}
    failures: List[str] = []
    if sorted(got) != sorted(ref):
        failures.append(f"keys differ: {sorted(set(got) ^ set(ref))}")
    for key in sorted(set(got) & set(ref)):
        if key in METADATA_TOLERANCES:
            _close(key, got[key], ref[key], *METADATA_TOLERANCES[key], errors, failures)
        elif got[key] != ref[key]:
            failures.append(f"{key}: {got[key]!r} != {ref[key]!r}")
    return errors, failures


def check_extracted(
    got: dict, ref: dict, sample_rate: int, window_size: int,
    near_zero=None, n_samples: int = 0, chord_margin=None,
) -> Report:
    """Extractor payloads key by key: a program dict, or the flat dict of
    `utils.convert.features_to_numpy`. `near_zero` ([..., T] bool) exempts
    frames from the exact ZCR comparison; `n_samples` (row length) sets
    the shimmer and amplitude-stability bounds; `chord_margin` ([..., T],
    the reference's top-two chord score gap) exempts near-tied frames from
    the chord index comparison."""
    errors: Dict[str, float] = {}
    failures: List[str] = []
    if sorted(got) != sorted(ref):
        failures.append(f"keys differ: {sorted(set(got) ^ set(ref))}")
    keys = sorted(set(got) & set(ref))
    agree = {}
    for key in keys:  # voicing agreement of each pitch track, by its prefix
        prefix, _, name = key.rpartition(".")
        if _ALIASES.get(name, name) == "pitch":
            conf_key = (prefix + "." if prefix else "") + "pitch_confidence"
            p, rp = np.asarray(got[key]), np.asarray(ref[key])
            e, f = check_pitch(p, got[conf_key], rp, ref[conf_key])
            errors.update({f"{key}:{k}": v for k, v in e.items()})
            failures.extend(f"{key}: {m}" for m in f)
            agree[prefix] = ((p > 0) == (rp > 0), p.shape)
    for key in keys:
        prefix, _, name = key.rpartition(".")
        name = _ALIASES.get(name, name)
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        if g.dtype != r.dtype or g.shape != r.shape:
            failures.append(f"{key}: {g.dtype}{g.shape} != {r.dtype}{r.shape}")
            continue
        if g.dtype.kind in "bi":
            diff = g != r
            if name == "chord_index" and chord_margin is not None:
                diff &= ~(np.asarray(chord_margin) < 1e-5)
            errors[key] = float(diff.sum())
            if diff.any():
                failures.append(f"{key}: {int(diff.sum())} of {diff.size} differ")
            continue
        if not np.isfinite(g).all():
            failures.append(f"{key}: non-finite values")
            continue
        if name == "pitch":
            continue
        if name == "zcr":
            near = near_zero if near_zero is not None else np.zeros(g.shape, bool)
            _zero_crossings(key, g, r, near, errors, failures)
            continue
        if name == "hpcp":
            check_frame_share(key, g, r, HPCP_ATOL, HPCP_MISS_SHARE, errors, failures)
            continue
        if name == "spectral_rolloff":
            _rolloff(key, g, r, (sample_rate / 2.0) / (window_size // 2), errors, failures)
            continue
        if name in ("shimmer", "amplitude_stability"):
            per = SHIMMER_ATOL_PER_SAMPLE if name == "shimmer" else AMP_STABILITY_ATOL_PER_SAMPLE
            tol = (0.0, per * n_samples)
        elif name == "quality":
            tol = (0.0, EXTRACTOR_TOLERANCES["quality"][1] + SHIMMER_ATOL_PER_SAMPLE * n_samples / 40)
        else:
            tol = EXTRACTOR_TOLERANCES.get(name) or FEATURE_TOLERANCES.get(name)
        if tol is None:
            failures.append(f"{key}: no tolerance stated")
            continue
        if name in _PITCH_DERIVED and prefix in agree and agree[prefix][1] == g.shape:
            mask = agree[prefix][0]
            g, r = g[mask], r[mask]
        _close(key, g, r, *tol, errors, failures)
    return errors, failures


# Banded DTW fill (K5/K6/K7's counterpart against its plain version on
# the card; the plain version against JAX's fills on the CPU). Both keep
# BIG = 3.4e38 / 4 as the finite "no path" sentinel, so the cells at or
# above DTW_SENTINEL must coincide exactly. A finite cell is a sum of up
# to n + m local distances taken in another order (the kernel's block
# scan, the plain log-step scan, JAX's associative scan and Pallas
# kernels): ~2e-7 of the largest cell at n ~ 300 (measured); the bound is
# the JAX kernel tests' (tests/test_pallas_dtw.py: rel 1e-5 of the max).
DTW_SENTINEL = 1e37
DTW_FILL_REL = 1e-5
# The fill's distance pre-pass: l = sqrt(max(|q|^2 + |r|^2 - 2 q.r, 0))
# per cell. Two float32 evaluations of the expansion (the kernel's FMA
# loop over d, the plain version's products and sum, JAX's HIGHEST
# dot_general) each err by at most ~(d + 2) eps (|q|^2 + |r|^2 + 2|q.r|)
# <= 2 (d + 2) eps S in the squared distance, S = max |q|^2 + max |r|^2;
# and |sqrt(x) - sqrt(y)| <= sqrt(|x - y|), so a cell may differ by
# sqrt(4 (d + 2) eps S) where the expansion cancels (q ~ r). At d = 1
# the kernel and the plain version take the same roundings in the same
# order, so they should agree bit for bit (the count of cells that differ
# is reported); XLA on the CPU contracts the expansion otherwise (~1e-5
# at d = 1, measured). The sentinel masks (j outside [1, m]) must
# coincide.
LOCAL_DIST_EPS = float(np.finfo(np.float32).eps)
# Backtrack on one shared band: the walk only compares cells, so the
# path and its length are exact; the path costs are float32 differences
# of the same cells (equal bits on one band; the bound allows another
# rounding of the same difference).
DTW_PATH_COST_RTOL = 1e-5
DTW_PATH_COST_ATOL = 1e-5
# Alignment scores (confidence, similarity, quality): float32 sums along
# paths and lags in another order, ~1e-6 (measured); 1e-4 is the JAX
# tests' bound between the batched and per-pair scorers
# (tests/test_batched_alignment.py:169-170). Offsets (integers) and the
# winning method must be equal.
ALIGN_SCORE_ATOL = 1e-4
# The comparator. The host comparator is float64 numpy in both packages
# (the same expressions in the same order): equal, not close. The
# device passes are float32:
# - against the host's float64 (tests/test_device_compare.py:28):
#   similarities, feature distances and confidences within 2e-6 (a
#   cosine over <= 70 float32 products rounds at ~1e-7, the weighted
#   mean adds a few ulp); the quality chain's temporal alignment, noise
#   level, dynamic range match and its confidence within 1e-5 (a sample
#   std of six float32 sims); spectral coherence within 2e-4 (a
#   two-pass float32 Pearson over up to 5,164 frames against float64
#   corrcoef; the constant-series floor of device_compare keeps a
#   series the host skips skipped);
# - the packed matrix from a batch of device features against the host
#   packer over the same features pulled to the host: 2e-4 after
#   scaling each entry by max(|x|, 1) (float32 means and sample stds
#   over 5,164 frames against float64);
# - the port against JAX, both on the same float32 matrix on the CPU:
#   the same expressions, with the selector matmuls and reductions
#   summed in another order; at most 3.0e-7 over 6 queries x 128
#   candidates (measured), so 1e-6; match classes, gates and top-k
#   indices equal (a stable sort: ties lowest index first in both).
COMPARATOR_HOST_ATOL = 2e-6
COMPARATOR_QUALITY_ATOL = 1e-5
COMPARATOR_COHERENCE_ATOL = 2e-4
COMPARATOR_PACK_SCALED_ATOL = 2e-4
COMPARATOR_PORT_ATOL = 1e-6
# The opt-in MFCC variants, port against JAX: float32 Pearson
# correlations over <= 60 frames and a dense float32 DTW distance
# (summed in another order), then a mean or exp(-d); at most 5.9e-6
# (measured, identical sequences, where each local distance is the
# float32 cancellation of |q|^2 + |r|^2 - 2 q.r).
COMPARATOR_MFCC_VARIANT_ATOL = 1e-5


def check_fill(got, ref) -> Report:
    """A banded cost fill [.., n+1, w] against a reference: sentinel
    masks equal, finite cells within DTW_FILL_REL of the largest."""
    g = np.asarray(got, np.float64)
    r = np.asarray(ref, np.float64)
    if g.shape != r.shape:
        return {}, [f"fill: shape {g.shape} != {r.shape}"]
    failures = []
    sent_g, sent_r = g >= DTW_SENTINEL, r >= DTW_SENTINEL
    mismatch = int((sent_g != sent_r).sum())
    finite = ~sent_r & ~sent_g
    scale = float(np.abs(r[finite]).max(initial=0.0))
    max_abs = float(np.abs(g - r)[finite].max(initial=0.0))
    rel = max_abs / max(scale, 1e-30)
    if mismatch:
        failures.append(f"fill: {mismatch} cells differ in their sentinel mask")
    if not np.isfinite(g).all():
        failures.append("fill: non-finite cells")
    if rel > DTW_FILL_REL:
        failures.append(f"fill: finite cells off by {rel:.3g} of the max (limit {DTW_FILL_REL})")
    return {"fill_max_abs": max_abs, "fill_max_rel": rel,
            "fill_sentinel_mismatch": float(mismatch)}, failures


def check_local_distances(got, ref, query, reference) -> Report:
    """A band of local distances [.., n+1, w] (row 0 the fill's first
    row) against a reference, for the pairs query [.., n, d] and
    reference [.., m, d]: sentinel masks equal, finite cells within
    sqrt(4 (d + 2) eps S) (LOCAL_DIST_EPS); also counts the cells that
    differ at all."""
    g = np.asarray(got, np.float64)
    r = np.asarray(ref, np.float64)
    if g.shape != r.shape:
        return {}, [f"local distances: shape {g.shape} != {r.shape}"]
    q = np.asarray(query, np.float64)
    x = np.asarray(reference, np.float64)
    d = q.shape[-1]
    scale = float((q * q).sum(-1).max()) + float((x * x).sum(-1).max())
    limit = float(np.sqrt(4 * (d + 2) * LOCAL_DIST_EPS * scale))
    sent_g, sent_r = g >= DTW_SENTINEL, r >= DTW_SENTINEL
    mismatch = int((sent_g != sent_r).sum())
    finite = ~sent_r & ~sent_g
    diff = np.abs(g - r)[finite]
    max_abs = float(diff.max(initial=0.0))
    failures = []
    if mismatch:
        failures.append(f"local distances: {mismatch} cells differ in their sentinel mask")
    if not np.isfinite(g).all():
        failures.append("local distances: non-finite cells")
    if max_abs > limit:
        failures.append(f"local distances: off by {max_abs:.3g} (limit {limit:.3g} at d = {d})")
    return {"dist_max_abs": max_abs, "dist_limit": limit,
            "dist_cells_differ": float((diff > 0).sum()),
            "dist_sentinel_mismatch": float(mismatch)}, failures


def check_backtrack(got, ref) -> Report:
    """(qs, rs, cs, length) against a reference on the same band: qs, rs
    and length equal, cs within DTW_PATH_COST_RTOL/ATOL."""
    errors: Dict[str, float] = {}
    failures: List[str] = []
    for name, g, r in zip(("qs", "rs", "length"), (got[0], got[1], got[3]),
                          (ref[0], ref[1], ref[3])):
        g, r = np.asarray(g), np.asarray(r)
        bad = int((g != r).sum()) if g.shape == r.shape else -1
        errors[f"{name}_differ"] = float(bad)
        if bad:
            failures.append(f"backtrack {name}: {bad} entries differ (shapes {g.shape}, {r.shape})")
    _close("path_cost", got[2], ref[2], DTW_PATH_COST_RTOL, DTW_PATH_COST_ATOL, errors, failures)
    return errors, failures


def alignment_streams(n_streams: int, seconds: float, sample_rate: int, lags_samples,
                      seed: int, gain: float = 0.9, unrelated=(), device="cpu"):
    """(source [N, L], cdn [N, L]) float32 test streams on `device`: each
    source row is white noise (sigma 0.1) under a piecewise-constant
    envelope of 6 segments per second drawn from [0.1, 1) (the JAX
    bench's monitor streams, bench.py:509-556); its cdn row is the source
    delayed by lags_samples[i] samples (zeros before) times `gain`, except
    for the rows named in `unrelated`, whose cdn is another seeded signal
    of the same kind. Drawn from numpy's generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sample_rate)
    seg = max(int(6 * seconds), 1)
    env = np.repeat(rng.uniform(0.1, 1.0, (n_streams, seg)), -(-n // seg), axis=1)[:, :n]
    src = (rng.standard_normal((n_streams, n), dtype=np.float32) * 0.1 * env).astype(np.float32)
    cdn = np.zeros_like(src)
    for i, lag in enumerate(lags_samples):
        lag = int(lag)
        if lag >= 0:
            cdn[i, lag:] = src[i, : n - lag]
        else:
            cdn[i, :lag] = src[i, -lag:]
    cdn *= np.float32(gain)
    for i in unrelated:
        env_u = np.repeat(rng.uniform(0.1, 1.0, seg), -(-n // seg))[:n]
        cdn[i] = (rng.standard_normal(n, dtype=np.float32) * 0.1 * env_u).astype(np.float32)
    return torch.from_numpy(src).to(device), torch.from_numpy(cdn).to(device)


def prescribed_path_band(runs, band: int, seed: int, device="cpu"):
    """A cost band whose greedy walk is a designed path: (band [n+1, 2 band
    + 1] float32 on `device`, ii, jj int64 numpy: the cells the walk
    visits, (n, m) first, (0, 0) left out).

    `runs` is a sequence of (move, count): "U" (i - 1), "L" (j - 1) or "D"
    (both), walked from (n, m) to (0, 0), so n = #U + #D and m = #L + #D.
    The path's cells up to its first cell on a border (i == 0 or j == 0)
    hold values that fall along the walk, below every other cell of the
    band, which holds dtw.BIG or, at random, a finite value above the
    path's; past that cell the walk moves along the border and reads
    nothing. An up step next to a left step would let the walk cut the
    corner by a diagonal, so that is refused, as is a path cell outside
    the band. (Once on a border the counts leave only border steps.)
    Drawn from `seed` (numpy for the path, a torch generator on `device`
    for the rest).
    """
    moves = "".join(mv * int(cnt) for mv, cnt in runs)
    if set(moves) - set("UDL"):
        raise ValueError(f"moves must be U, L or D: {sorted(set(moves))}")
    n = moves.count("U") + moves.count("D")
    m = moves.count("L") + moves.count("D")
    w = 2 * band + 1
    i, j, ii, jj, arrive = n, m, [n], [m], None
    for t, mv in enumerate(moves):
        if arrive is None and (i == 0 or j == 0):
            arrive = t
        if arrive is None and t > 0 and {mv, moves[t - 1]} == {"U", "L"}:
            raise ValueError(f"step {t}: an up step next to a left step")
        i, j = i - (mv in "UD"), j - (mv in "LD")
        ii.append(i)
        jj.append(j)
    # the cells up to the first on a border, (0, 0) at the latest
    valued = slice(0, len(moves) + 1 if arrive is None else arrive + 1)
    ii, jj = np.array(ii, np.int64), np.array(jj, np.int64)
    kk = jj - ii + band
    if ((kk[valued] < 0) | (kk[valued] >= w)).any():
        raise ValueError("a path cell lies outside the band")
    from sonido_sonar_tpu_torch.ops.stats.dtw import BIG

    rng = np.random.default_rng(seed)
    vals = np.cumsum(rng.uniform(0.5, 1.5, len(ii)))[::-1].astype(np.float32)[valued]
    top = float(vals.max())
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((n + 1, w), generator=gen, device=device)
    out = torch.where(u < 0.5, torch.tensor(BIG, device=device),
                      (2.0 * top + 1.0) * (1.0 + u))
    out[torch.from_numpy(ii[valued]).to(device), torch.from_numpy(kk[valued]).to(device)] = \
        torch.from_numpy(vals).to(device)
    return out, ii[:-1], jj[:-1]


# The music-analysis ops (ops/harmonic, chroma, pitch's ACF and median,
# tonal, tracking), the port against JAX on the CPU and the card against
# the CPU:
# - index outputs (peak bins and counts, argmax picks, key and chord
#   labels, track counts and frames) are equal on inputs without
#   near-ties; where two candidates' scores are within MUSIC_TIE of each
#   other the pick may go either way, and the check skips that item;
# - float32 reductions of a few to a few hundred terms (Pearson rows,
#   HPS products, HPCP window sums, noise floors, inharmonicity, HNR)
#   agree to ~1e-7 relative (measured), bounded at MUSIC_RTOL, and
#   MUSIC_ATOL for values near 0;
# - the CQT chroma: unit-sum fractions of octave-folded energies from
#   float32 products of 8,192 terms (two BLAS, or cuBLAS and a CPU BLAS);
#   at most 3.6e-7 (measured, port against JAX on the CPU), bounded at
#   the chroma's 1e-5;
# - HPCP on the same magnitudes: each peak's pitch class comes from a
#   float32 log2 (XLA's, torch's CPU and CUDA ones differ by an ulp),
#   and one ulp of the MIDI value (7.6e-6 semitones at MIDI 64-128)
#   through the cosine window's slope at its edge (pi / window_bins)
#   moves a unit-energy profile by up to ~2.4e-5 of the peak's share
#   (4.8e-6 measured): HPCP_ATOL = 3e-5 for every element. Across two
#   DFTs (the whole path; K1 against its plain version) the magnitudes
#   differ by ~1.2e-6 of each frame's peak, which can swap two
#   near-equal peaks in the greedy pick or move a local maximum by a
#   bin, and a frame's profile then moves by far more than rounding. So
#   each frame is within HPCP_ATOL elementwise or counts as a miss, and
#   at most HPCP_MISS_SHARE of the frames may miss (rolloff's model);
# - pitch decisions from FFT-based lag functions (ACF, NSDF, cepstrum,
#   and HPS over FFT magnitudes): the picked lag or bin moves where two
#   candidates are near-equal. At most FFT_PITCH_MISS_SHARE of the
#   frames may differ in pitch; on the rest, pitch within PITCH_RTOL and
#   confidence within CONF_ATOL.
MUSIC_RTOL = 1e-5
MUSIC_ATOL = 1e-6
MUSIC_TIE = 1e-5
# HNR and SNR in dB over the local noise floors: the floors' moving
# average is a float32 cumsum in another order (a CPU scan, a CUDA scan,
# XLA's), ~1e-6 relative on the floor, ~1e-5 dB on the ratio; 1e-4 of
# the value and 1e-4 dB.
MUSIC_DB_TOL = (1e-4, 1e-4)
# Vibrato rate and extent: a bin of a float32 rFFT of the pitch contour
# (pocketfft, cuFFT, XLA's) and its magnitude, ~1e-6 relative; 1e-4
# relative and 1e-4 Hz.
VIBRATO_TOL = (1e-4, 1e-4)
CQT_CHROMA_ATOL = FEATURE_TOLERANCES["chroma"][1]
EXTRACTOR_TOLERANCES["chroma_cqt"] = (0.0, CQT_CHROMA_ATOL)  # the music program's option
HPCP_ATOL = 3e-5
# Measured: no HPCP frame missed, in the options-on music program on an
# H100 against the CPU (338 frames at [2, 44100], 118 at [2, 16000]) or
# in the port against JAX on the CPU; the limit lets one frame of the
# 338 miss.
HPCP_MISS_SHARE = 0.003
# Measured: ACF (alone and in yin+acf) picks another lag on 3 of 10,328
# frames (2.9e-4) of four 30 s clips at 1024/512 on an H100 against the
# CPU, every other method on none; no frame differs in any of the port's
# CPU tests against JAX. The limit is ~3x the card's reading.
FFT_PITCH_MISS_SHARE = 0.001


def check_frame_share(name: str, got, ref, atol: float, share: float,
                      errors=None, failures=None) -> Report:
    """[..., T, K] per-frame vectors: a frame misses where any element
    differs by more than atol; at most `share` of the frames may miss."""
    errors = {} if errors is None else errors
    failures = [] if failures is None else failures
    g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if g.shape != r.shape:
        failures.append(f"{name}: shape {g.shape} != {r.shape}")
        return errors, failures
    if not np.isfinite(g).all():
        failures.append(f"{name}: non-finite values")
        return errors, failures
    miss = (np.abs(g - r) > atol).any(axis=-1)
    errors[name] = float(np.abs(g - r).max(initial=0.0))
    errors[name + "_miss_share"] = float(miss.mean()) if miss.size else 0.0
    if errors[name + "_miss_share"] > share:
        failures.append(f"{name}: {int(miss.sum())} of {miss.size} frames beyond {atol} "
                        f"(limit {share} of them)")
    return errors, failures


def check_pitch_decisions(pitch, conf, ref_pitch, ref_conf) -> Report:
    """FFT-based pitch picks: the share of frames whose pitch differs
    beyond PITCH_RTOL at most FFT_PITCH_MISS_SHARE; pitch and confidence
    on the other frames within PITCH_RTOL and CONF_ATOL."""
    p, rp = np.asarray(pitch, np.float64), np.asarray(ref_pitch, np.float64)
    c, rc = np.asarray(conf, np.float64), np.asarray(ref_conf, np.float64)
    if p.shape != rp.shape or c.shape != rc.shape:
        return {}, [f"pitch: shape {p.shape} != {rp.shape}"]
    same = np.abs(p - rp) <= PITCH_RTOL * np.abs(rp)
    errors = {"pitch_miss_share": float((~same).mean()) if same.size else 0.0,
              "conf_max_abs": float(np.abs(c - rc)[same].max(initial=0.0))}
    failures = []
    if errors["pitch_miss_share"] > FFT_PITCH_MISS_SHARE:
        failures.append(f"pitch: {int((~same).sum())} of {same.size} frames differ "
                        f"(limit {FFT_PITCH_MISS_SHARE} of them)")
    if errors["conf_max_abs"] > CONF_ATOL:
        failures.append(f"confidence: max difference {errors['conf_max_abs']:.3g} > {CONF_ATOL}")
    return errors, failures


# The op surface (ops/common, fft, chroma_analysis, stats/{distance,
# clustering, entropy, moments, percentiles} and the names added to
# filters, temporal, spectral, speech, mel, mfcc, framing and windows),
# the port against JAX on the CPU and the card against the CPU:
# - elementwise math and reductions of up to a few thousand float32 terms
#   in another order (normalizers, interpolators, distances, entropies,
#   chroma statistics, envelopes): ~1e-7 relative (measured), bounded at
#   OPS_RTOL, with OPS_ATOL for values near 0. Index outputs (argmax and
#   argmin picks, kNN order, histogram bins, peak indices, k-means labels)
#   are equal on inputs without near-ties;
# - moments: x**k with an integer k is repeated multiplication in both
#   packages, m2 ** (k/2) a float pow; with the sums' order the 3rd to
#   5th central and standardized moments agreed to 2.7e-6 of their value
#   (measured on 1,000-sample rows), bounded at MOMENTS_RTOL;
# - the block-scan filters (filters.biquad, adaptive_pre_emphasis): the
#   port sums each 256-sample chunk as one matmul with a float64-designed
#   table, JAX runs a sequential float32 lax.scan whose rounding drifts
#   over the filter's memory. Against a float64 recurrence the port
#   stayed within 9.5e-7 of the output's peak (biquad at Q = 100) and
#   2.2e-7 (adaptive, r = 0.001), JAX within 5.0e-6 and 2.4e-5: so the
#   port is held to a float64 recurrence at BLOCK_SCAN_F64_ATOL_SCALE and
#   to JAX at BLOCK_SCAN_JAX_ATOL_SCALE, each times the peak |output|;
# - Smith-Waterman's rows: the closed form cummax(a + j gap) - j gap
#   rounds a + j gap where JAX's associative scan rounds a - g; rows
#   feed one another, so the difference grows with the scores: 1.0e-3 on
#   a peak score of 281 (3.7e-6 of it) over 300 rows, measured.
#   SW_ATOL_SCALE times the peak score bounds every element, and the
#   normalized score by the same share;
# - DTW's rows through the same min-plus scan as JAX's: 2.4e-7 on exp(-d)
#   (measured), the overall similarity within OPS_RTOL;
# - an optimal transposition (OTI) is a first-of-maxima over 12 host
#   floats: the port's shift may differ from JAX's only where JAX's
#   similarity at the port's shift is within TRANSPOSITION_TIE of JAX's
#   best.
OPS_RTOL = 1e-5
OPS_ATOL = 1e-6
MOMENTS_RTOL = 2e-5
BLOCK_SCAN_F64_ATOL_SCALE = 4e-6
BLOCK_SCAN_JAX_ATOL_SCALE = 1e-4
SW_ATOL_SCALE = 3e-5
TRANSPOSITION_TIE = 1e-5
# k-means on real MFCC frames, card against CPU: the [N, K] squared
# distances come from the |x|^2 + |c|^2 - 2 x.c identity in two float32
# GEMMs, ~1e-6 of |x|^2 + |c|^2 apart, so a frame whose two nearest
# centroids are within KMEANS_TIE_SCALE of that scale may go to either.
# Each flip moves two centroids a little and Lloyd's 50 steps carry it,
# so after a fit at most KMEANS_LABEL_MISS_SHARE of the labels may
# differ, and the inertia by KMEANS_INERTIA_RTOL.
KMEANS_TIE_SCALE = 1e-5
KMEANS_LABEL_MISS_SHARE = 0.01
KMEANS_INERTIA_RTOL = 1e-3


def moments_analyze_atol(x) -> Dict[str, float]:
    """Absolute bounds for `stats.moments.analyze` of a float32 series
    computed in two summation orders (card against CPU, port against
    JAX). The central moments are taken about the float32 mean, and two
    orders put that mean up to ~2 log2(n) ulps apart, dm; a k-th central
    moment then moves by ~k dm E|x - m|^(k-1), which is not small against
    the moment where |mean| is large against the spread (a level series:
    the third moment of an energy series near 1,382 with a spread of 8
    moved by 6e-3 of 2.13 on an H100 against the CPU). The ratios follow
    by first-order propagation, doubled; each key also gets
    MOMENTS_RTOL of its float64 value. L-moments are float64 on the host
    in both and keep MOMENTS_RTOL alone."""
    x = np.asarray(x, np.float64)
    n = x.size
    eps = float(np.finfo(np.float32).eps)
    m = x.mean()
    d = x - m
    dm = 2.0 * max(np.log2(n), 1.0) * eps * abs(m) + OPS_ATOL
    m2, m3, m4 = (float(np.mean(d ** k)) for k in (2, 3, 4))
    s = np.sqrt(m2)

    def c(k):
        return k * dm * float(np.mean(np.abs(d) ** (k - 1))) + 2.0 * np.log2(n) * eps * float(np.mean(np.abs(d) ** k))

    tol = {"mean": dm, "k1": dm, "variance": c(2) * n / max(n - 1, 1), "k2": c(2),
           "std": c(2) / max(2.0 * s, OPS_ATOL), "k3": c(3), "k4": c(4) + 6.0 * m2 * c(2),
           "pearson_skewness": 3.0 * dm / max(s, OPS_ATOL) + 1.5 * c(2) / max(m2, OPS_ATOL),
           "skewness": c(3) / max(s ** 3, OPS_ATOL) + 1.5 * abs(m3) * c(2) / max(m2 ** 2.5, OPS_ATOL),
           "kurtosis": c(4) / max(m2 ** 2, OPS_ATOL) + 2.0 * m4 * c(2) / max(m2 ** 3, OPS_ATOL),
           "bowley_skewness": 0.0}
    ref = {"mean": m, "k1": m, "variance": m2, "k2": m2, "std": s, "k3": m3, "k4": m4 - 3 * m2 * m2,
           "pearson_skewness": 0.0, "skewness": m3 / max(s ** 3, OPS_ATOL), "kurtosis": m4 / max(m2 ** 2, OPS_ATOL),
           "bowley_skewness": 0.0}
    return {k: 2.0 * v + MOMENTS_RTOL * abs(ref[k]) + OPS_ATOL for k, v in tol.items()}
