"""What the `card` test files (`tests/test_torch_card_*.py`) share: the
shapes and seeds, the session fixture that builds the kernel library and
holds the full-width PCM, the launch counters, and the small holds those
files make against the plain versions or the CPU.

It imports neither JAX nor the JAX package: the card's machine has
neither. Nothing here touches the card while it is imported; a case
decides inside `card` (the fixture) whether there is one.
"""

from __future__ import annotations

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sonido_sonar_tpu_torch.utils import parity

ROOT = Path(__file__).resolve().parent.parent
SEED = 0
SR = 44100
WINDOW, HOP = 1024, 256
PITCH_WINDOW, PITCH_HOP = 1024, 512
PRE_EMPH = 0.97
FULL_B, FULL_SECONDS = 128, 30  # the backfill's batch shape
SMALL_B, SMALL_SECONDS = 4, 5
VQ_ARGS = (1024, 256, SR, 50.0, 500.0, 0.15, 0.0)  # voice quality's K2 call
N_FULL = FULL_SECONDS * SR
T_FRAMES = (N_FULL - WINDOW) // HOP + 1
T_PITCH = (N_FULL - PITCH_WINDOW) // PITCH_HOP + 1
CORPUS_ROWS = 262_144                     # bench.py:585-595's corpus
CORPUS_DUPLICATES = 64                    # rows made copies of one row, so scores tie
TOP_K = 16
LATENCY_LAG = int(1.234 * SR) + 137       # an injected CDN delay, off the hop grid
LATENCY_BUDGET = 30.0
CARD_COMMAND = ("python3 -m pytest --noconftest -q -p no:cacheprovider -m card "
                "tests/test_torch_card_*.py tests/test_torch_monitor.py tests/test_torch_tracing.py")


def needs_card() -> torch.device:
    """The card, with TF32 off; skips the case without one."""
    if not torch.cuda.is_available():
        pytest.skip(f"needs a CUDA device (on the card: {CARD_COMMAND})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def card():
    """The card (`dev`), the kernel library built from this checkout, and
    the PCM the kernels and the main path are held on: `full`, B=128 x
    30 s, and `small`, B=4 x 5 s (utils/parity.synth_pcm, seeds SEED + 1
    and SEED)."""
    dev = needs_card()
    from sonido_sonar_tpu_torch import _build

    _build.build()
    return types.SimpleNamespace(
        dev=dev,
        full=parity.synth_pcm(FULL_B, N_FULL, SEED + 1, SR, dev),
        small=parity.synth_pcm(SMALL_B, SMALL_SECONDS * SR, SEED, SR, dev),
    )


def np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def require(report, what: str) -> dict:
    """A utils/parity report's errors; fails the case on a failure."""
    errors, failures = report
    assert not failures, f"{what}: " + "; ".join(failures)
    return errors


def parity_close(name: str, got, ref, rtol: float, atol) -> tuple:
    """utils/parity's element check as a (errors, failures) report."""
    errors, failures = {}, []
    parity._close(name, got, ref, rtol, atol, errors, failures)
    return errors, failures


def kernel_wrappers() -> dict:
    """Each kernel's wrapper and the name of its launch counter."""
    from sonido_sonar_tpu_torch.ops import hopper_contrast, hopper_onsets, hopper_stft, hopper_yin
    from sonido_sonar_tpu_torch.ops.stats import hopper_backtrack, hopper_dtw

    k1, k2 = hopper_stft.stft_magnitude_hopper, hopper_yin.yin_pitch_hopper
    return {"K1": (k1, "launches"), "K10": (k1, "feat_launches"), "K2": (k2, "launches"),
            "K2amp": (k2, "amp_launches"), "K3": (hopper_yin.yin_difference_hopper, "launches"),
            "K4": (hopper_onsets.thin_onsets_hopper, "launches"),
            "K9": (hopper_contrast.band_select_means_hopper, "launches"),
            "fill": (hopper_dtw.fill_banded_hopper, "launches"),
            "backtrack": (hopper_backtrack.backtrack_banded_hopper, "launches")}


def counted(fn):
    """(fn()'s result, the kernels it launched): every count set to 0
    just before the call and read after the card is synchronized."""
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for fn_, attr in wrappers.values():
        setattr(fn_, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: getattr(fn_, attr) for k, (fn_, attr) in wrappers.items()}


def check_surface(what: str, arrays: dict, expect: dict, ints: dict) -> None:
    """Every array finite, float32 unless `ints` names its dtype, and of
    the shape `expect` gives where it names one."""
    for key, v in arrays.items():
        assert v.dtype == ints.get(key, torch.float32), f"{what} {key}: {v.dtype}"
        if key in expect:
            assert tuple(v.shape) == expect[key], f"{what} {key}: shape {tuple(v.shape)}, expected {expect[key]}"
        if v.dtype.is_floating_point:
            assert bool(torch.isfinite(v).all()), f"{what} {key}: non-finite values"
    assert not sorted(set(expect) - set(arrays)), f"{what}: missing {sorted(set(expect) - set(arrays))}"


def news_schema(b: int, n: int) -> dict:
    """The ExtractedFeatures fields of the speech extractor with every
    stage on (news), at 1024/256, as features_to_numpy paths -> shapes."""
    t = (n - WINDOW) // HOP + 1
    tp = (n - 1024) // 512 + 1
    frame = {k: (b, t) for k in (
        "spectral_features.spectral_centroid", "spectral_features.spectral_rolloff",
        "spectral_features.spectral_bandwidth", "spectral_features.spectral_flatness",
        "spectral_features.spectral_crest", "spectral_features.spectral_slope",
        "spectral_features.spectral_flux", "spectral_features.zero_crossing_rate",
        "temporal_features.rms_energy", "energy_features.short_time_energy",
        "energy_features.energy_entropy", "energy_features.low_energy_ratio",
        "energy_features.high_energy_ratio")}
    pitch = {f"harmonic_features.{k}": (b, tp) for k in (
        "pitch_estimate", "pitch_confidence", "voicing_strength", "harmonic_ratio",
        "inharmonicity_ratio", "tonal_centroid")}
    scalar = {k: (b,) for k in (
        "speech_features.vocal_tract_length", "speech_features.speech_rate",
        "speech_features.pause_count", "speech_features.formant_count",
        "speech_features.jitter", "speech_features.shimmer",
        "temporal_features.peak_amplitude", "temporal_features.average_amplitude",
        "temporal_features.dynamic_range", "temporal_features.silence_ratio",
        "temporal_features.onset_density", "energy_features.energy_variance",
        "energy_features.loudness_range")}
    return {
        **frame, **pitch, **scalar,
        "mfcc": (b, t, 13), "spectral_features.spectral_contrast": (b, t, 6),
        "speech_features.formant_frequencies": (b, 1, 4),
        "speech_features.voicing_probability": (b, tp),
        "speech_features.spectral_tilt": (b, tp),
        "speech_features.pause_duration": (b, 64),
        "temporal_features.onset_mask": (b, t - 1),
        "temporal_features.attack_time": (b, t - 1),
        "temporal_features.envelope_shape": (b, (n - 512) // 256 + 1),
    }


NEWS_INTS = {"speech_features.formant_count": torch.int32,
             "speech_features.pause_count": torch.int32,
             "temporal_features.onset_mask": torch.bool}


def music_schema(b: int, n: int) -> dict:
    """The music program's outputs at 1024/256 -> shapes."""
    t = (n - WINDOW) // HOP + 1
    per_frame = ("spectral_centroid", "spectral_bandwidth", "spectral_flatness", "spectral_crest",
                 "spectral_slope", "spectral_flux", "spectral_rolloff", "zcr", "chord_index",
                 "chord_score", "rms_energy", "onset_mask", "attack_time", "crest_factor",
                 "energy_entropy", "low_energy_ratio", "high_energy_ratio", "pitch",
                 "pitch_confidence", "voicing", "hnr", "inharmonicity", "tonal_centroid")
    scalar = ("onset_density", "peak_amplitude", "average_amplitude", "dynamic_range",
              "silence_ratio", "tempo_bpm", "energy_variance", "loudness_range")
    env_frame = max(n // t, 1)
    return {**{k: (b, t) for k in per_frame}, **{k: (b,) for k in scalar},
            "spectral_contrast": (b, t, 6), "mfcc": (b, t, 13), "chroma": (b, t, 12),
            "key_correlations": (b, 24), "envelope_shape": (b, (n - env_frame) // HOP + 1)}


MUSIC_INTS = {"chord_index": torch.int32, "onset_mask": torch.bool}


def music_class_schema(b: int, n: int) -> dict:
    """The music composition's ExtractedFeatures fields (the music
    content's feature config: every family but speech) at 1024/256, as
    features_to_numpy paths -> shapes."""
    t = (n - WINDOW) // HOP + 1
    frame = [f"spectral_features.{k}" for k in (
        "spectral_centroid", "spectral_rolloff", "spectral_bandwidth", "spectral_flatness",
        "spectral_crest", "spectral_slope", "spectral_flux", "zero_crossing_rate")]
    frame += [f"temporal_features.{k}" for k in ("rms_energy", "crest_factor", "onset_mask", "attack_time")]
    frame += [f"energy_features.{k}" for k in (
        "short_time_energy", "energy_entropy", "low_energy_ratio", "high_energy_ratio")]
    frame += [f"harmonic_features.{k}" for k in (
        "pitch_estimate", "pitch_confidence", "voicing_strength", "harmonic_ratio",
        "inharmonicity_ratio", "tonal_centroid")]
    scalar = [f"temporal_features.{k}" for k in (
        "peak_amplitude", "average_amplitude", "dynamic_range", "silence_ratio", "onset_density",
        "tempo_bpm")] + ["energy_features.energy_variance", "energy_features.loudness_range"]
    return {**{k: (b, t) for k in frame}, **{k: (b,) for k in scalar},
            "mfcc": (b, t, 13), "chroma_features": (b, t, 12),
            "spectral_features.spectral_contrast": (b, t, 6),
            "temporal_features.envelope_shape": (b, (n - max(n // t, 1)) // HOP + 1)}


def near_zero_for(x: torch.Tensor, music: bool) -> np.ndarray:
    """Frames exempt from the exact ZCR comparison (utils/parity): a
    sample near 0 after the path's preprocessing, from CPU PCM."""
    from sonido_sonar_tpu_torch.ops.filters import dc_removal, pre_emphasis_for_content

    if music:
        pre = pre_emphasis_for_content(dc_removal(x), "music").numpy()
        return parity.near_zero_frames(pre, WINDOW, HOP, 0.0, parity.DC_NEAR_ZERO)
    return parity.near_zero_frames(x.numpy(), WINDOW, HOP, 0.97)


def chord_margin(chroma: np.ndarray) -> np.ndarray:
    """The gap between the two best chord templates of each frame (chord
    indices within 1e-5 of a tie are exempt, utils/parity)."""
    from sonido_sonar_tpu_torch.ops.tonal import CHORD_MATRIX

    cn = chroma / np.maximum(np.linalg.norm(chroma, axis=-1, keepdims=True), 1e-10)
    sims = np.sort(cn @ CHORD_MATRIX.T, axis=-1)
    return sims[..., -1] - sims[..., -2]


MODULATIONS = (7, 5, 2, 9)  # semitones each chord clip's second half is raised


def chord_clips(count: int, seconds: int) -> torch.Tensor:
    """[count, seconds * SR] clips whose chords and key change: the first
    half io.synth.music_like (C major's I-V-vi-IV, a chord each 2 s, a
    melody note and a beat), the second half the same recipe with another
    seed raised by MODULATIONS[i] semitones (resampled by linear
    interpolation), each clip at its own tempo."""
    from sonido_sonar_tpu_torch.io.synth import music_like

    half = seconds * SR // 2
    out = []
    for i in range(count):
        r = 2.0 ** (MODULATIONS[i % len(MODULATIONS)] / 12)
        tempo = 90.0 + 8 * i
        first = music_like(half / SR, SR, tempo, seed=SEED + 300 + i)
        src = music_like(half * r / SR + 0.01, SR, tempo, seed=SEED + 400 + i)
        second = np.interp(np.arange(half) * r, np.arange(len(src)), src)
        out.append(np.concatenate([first, second]))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def corpus_rows(d: int) -> tuple:
    """The search corpus: CORPUS_ROWS rows of width d from numpy seeded
    with SEED + 29, CORPUS_DUPLICATES of them copies of row `src`.
    Returns (rows, src, the copies' indices, the generator, whose next
    draws are the cases' queries)."""
    rng = np.random.default_rng(SEED + 29)
    corpus = rng.standard_normal((CORPUS_ROWS, d)).astype(np.float32)
    corpus[:, :6] = 1.0  # presence flags
    corpus[:, 29] = np.abs(corpus[:, 29])
    src = 5000
    dups = np.sort(rng.choice(np.delete(np.arange(CORPUS_ROWS), src), CORPUS_DUPLICATES, replace=False))
    corpus[dups] = corpus[src]
    return corpus, src, dups, rng


def same_ranking(what: str, ids: list, sims: list, ref_ids: list, ref_sims: list) -> int:
    """A ranking (`ids`, descending `sims`) equal to a reference ranking
    that may run longer: the similarities within utils/parity
    .COMPARATOR_HOST_ATOL, the ids equal. Where reference similarities
    lie within that bound of each other, a float32 sum in another order
    may swap them, so such a run is compared as a set (a subset where the
    cut falls inside it). Returns the number of such runs."""
    tol, n = parity.COMPARATOR_HOST_ATOL, len(ids)
    assert len(ref_ids) >= n, f"{what}: {n} rows, the reference has {len(ref_ids)}"
    err = float(np.abs(np.asarray(sims) - np.asarray(ref_sims[:n])).max(initial=0.0))
    assert err <= tol, f"{what}: similarities differ by {err:.3g} > {tol}"
    runs, start = 0, 0
    for i in range(1, len(ref_ids) + 1):
        if start >= n:
            break
        if i < len(ref_ids) and ref_sims[i - 1] - ref_sims[i] <= tol:
            continue
        part, ref = ids[start:min(i, n)], ref_ids[start:i]
        assert (sorted(part) == sorted(ref) if i <= n else set(part) <= set(ref)), \
            f"{what}: rows {start}-{min(i, n) - 1} hold {part}, the reference {ref}"
        runs += i - start > 1
        start = i
    return runs


def ingest_clip(i: int, seconds: int) -> np.ndarray:
    """Corpus file i at SR: speech-like, music-like or a harmonic tone
    plus noise by i mod 3, each seeded from SEED and i."""
    from sonido_sonar_tpu_torch.io.synth import harmonic_tone, music_like, speech_like, white_noise

    seed = SEED + 100 + i
    if i % 3 == 0:
        return speech_like(seconds, SR, f0=100.0 + 5 * (i % 8), seed=seed, random_syllables=True)
    if i % 3 == 1:
        return music_like(seconds, SR, tempo_bpm=90.0 + i, seed=seed)
    return harmonic_tone(110.0 + 7 * i, seconds, SR, num_harmonics=8, decay=0.85) \
        + white_noise(seconds, SR, 0.02, seed=seed)


def write_ingest_clip(i: int, seconds: int, path: str) -> str:
    from sonido_sonar_tpu_torch.io.decode import write_wav

    write_wav(path, ingest_clip(i, seconds), SR)
    return path


def latency_pair(label: str, seconds: int, tmp: Path) -> tuple:
    """(source WAV, CDN WAV) paths: a speech-like or music-like source
    and its copy delayed by LATENCY_LAG (gain 0.9, noise 0.02)."""
    from sonido_sonar_tpu_torch.io.decode import write_wav
    from sonido_sonar_tpu_torch.io.synth import music_like, shift_signal, speech_like

    src = (speech_like(seconds, SR, seed=SEED + 200, random_syllables=True) if label == "speech"
           else music_like(seconds, SR, seed=SEED + 201))
    sp, cp = str(tmp / f"{label}_src.wav"), str(tmp / f"{label}_cdn.wav")
    write_wav(sp, src, SR)
    write_wav(cp, shift_signal(src, LATENCY_LAG, noise=0.02, gain=0.9), SR)
    return sp, cp


ALIGN_SECONDS, ALIGN_BUDGET = 60, 30      # the monitors' defaults: 60 s windows, 30 s budget
FLEET_STREAMS, FLEET_BATCH = 64, 32
# streams whose cdn is an unrelated signal: 8 in each sub-batch of 32, so
# the 0.7 gate fails and the banded DTW runs in both
UNRELATED = tuple(range(24, 32)) + tuple(range(56, 64))
N_CHROMA = ALIGN_SECONDS * SR // HOP              # 10,335: bench.py:303
BAND = int(ALIGN_BUDGET * SR) // HOP              # 5,167: the 30 s budget at hop 256
WIDE_BAND = int(60 * SR) // 128                   # 20,671: a 60 s budget at hop 128


def dtw_draws() -> dict:
    """The DTW cases' numpy draws from one generator seeded SEED + 10, in
    their order: K6's query [8, 2048, 12], K7's [1, 10,335, 12], the
    fleet's lags (0.1-3 s), then the wide band's query [2, 3000, 1] and
    reference [2, 2900, 1]."""
    rng = np.random.default_rng(SEED + 10)
    out = {"q6": rng.standard_normal((8, 2048, 12), dtype=np.float32),
           "q7": rng.standard_normal((1, N_CHROMA, 12), dtype=np.float32),
           "lags": rng.integers(int(0.1 * SR), 3 * SR, FLEET_STREAMS)}
    out["qw"] = rng.standard_normal((2, 3000, 1), dtype=np.float32)
    out["rw"] = rng.standard_normal((2, 2900, 1), dtype=np.float32)
    return out


def fleet_streams(lags, dev) -> tuple:
    """(source, cdn) [64, 60 s] on `dev`: each cdn row its source delayed
    by `lags` (gain 0.9), the UNRELATED rows another signal."""
    return parity.alignment_streams(FLEET_STREAMS, ALIGN_SECONDS, SR, lags, SEED + 11,
                                    unrelated=UNRELATED, device=dev)


def traced_step(model, x: torch.Tensor) -> dict:
    """One main-path step under utils.profiler_trace: the kernel records
    its Chrome trace holds, the host's kernel launch calls it holds
    (runtime or driver), whether K1's kernel is named, and the launches
    counted around the step."""
    import json
    import tempfile

    from sonido_sonar_tpu_torch.utils import profiler_trace

    with tempfile.TemporaryDirectory() as d:
        def step():
            with profiler_trace(d):
                model(x)
                torch.cuda.synchronize()

        _, launches = counted(step)
        traces = list(Path(d).glob("*.pt.trace.json"))
        events = json.loads(traces[0].read_text())["traceEvents"] if len(traces) == 1 else []
    kernels = [e for e in events if e.get("cat") == "kernel"]
    calls = {e["args"]["correlation"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "LaunchKernel" in e.get("name", "") and "correlation" in e.get("args", {})}
    return {"files": len(traces), "kernels": len(kernels), "launch_calls": len(calls),
            "names_k1": any("stft_aux_kernel" in k.get("name", "") for k in kernels), "launches": launches}
