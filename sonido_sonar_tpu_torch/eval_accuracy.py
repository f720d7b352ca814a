"""Alignment accuracy sweep on the port: recovered CDN offset against the
injected one (counterpart of the repo's `eval_accuracy.py`).

`run` sweeps lags and noise levels on an enveloped harmonic tone and
reports the frame-level and GCC-PHAT-refined errors against one hop
(5.8 ms at 44.1 kHz, hop 256); with `batched=True` it also runs the [B]
pair aligner (`ops/stats/batched_alignment.batched_align_audio`), whose
coarse offsets must equal the per-pair ones. `run_extended` is the
categorized sweep: speech-like, music-like and tone sources, 0 dB SNR,
band-limited CDNs with and without PCM verification, both offset signs,
stationary content and time stretch; `tests/test_torch_eval_gates.py`
holds its gates. The cases are the same as JAX's, built by
`tone_source`, `extended_sources`, `extended_cases` and
`stationary_cases`; `align_case` runs one (align, then refine).

    python -m sonido_sonar_tpu_torch.eval_accuracy [--sr 44100] [--quick]
        [--batched] [--full] [--device cuda]

Per-case lines go to stderr; the last line of stdout is the JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterator, Optional, Tuple

import numpy as np

from sonido_sonar_tpu_torch.config.config import FeatureConfig
from sonido_sonar_tpu_torch.extractors.alignment import AlignmentExtractor, AlignmentFeatures
from sonido_sonar_tpu_torch.extractors.features import EnergyFeatures, ExtractedFeatures
from sonido_sonar_tpu_torch.io.synth import (
    band_limit,
    harmonic_tone,
    music_like,
    shift_signal,
    speech_like,
    time_stretch,
    white_noise,
)
from sonido_sonar_tpu_torch.ops.chroma import chroma_from_magnitude
from sonido_sonar_tpu_torch.ops.stft import stft
from sonido_sonar_tpu_torch.ops.temporal import short_time_energy
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32

DURATION = 12.0          # seconds of every source
MAX_LAG_SECONDS = 4.0    # the aligner's lag budget
LAG_OFF_GRID = 137       # samples added to every lag: off the hop grid on purpose


def sweep_extractor(sr: int, device: Device) -> AlignmentExtractor:
    fc = FeatureConfig(sample_rate=sr, window_size=1024, hop_size=256)
    return AlignmentExtractor(fc, max_lag_seconds=MAX_LAG_SECONDS, device=device)


def align_case(ext: AlignmentExtractor, src, cdn, sr: int,
               verify_top_peaks: Optional[int] = None) -> Tuple[AlignmentFeatures, float]:
    """One case: `align_audio_files`, then `refine_offset_with_pcm` from
    its frame-level offset. -> (the alignment, the refined offset in s)."""
    s, c = as_float32(src, ext.device), as_float32(cdn, ext.device)
    feats = ext.align_audio_files(s, c, sr, verify_top_peaks=verify_top_peaks)
    refined = ext.refine_offset_with_pcm(s, c, sr, feats.temporal_offset)
    return feats, refined


def tone_source(sr: int, seed: int, rng: np.random.Generator) -> np.ndarray:
    """A 220 Hz harmonic tone plus noise under a random 96-point envelope."""
    base = harmonic_tone(220.0, DURATION, sr) + white_noise(DURATION, sr, 0.05, seed=seed)
    env = np.interp(np.arange(len(base)), np.linspace(0, len(base), 96),
                    rng.uniform(0.1, 1.0, 96))
    return (base * env).astype(np.float32)


def run(sr: int = 44100, quick: bool = False, batched: bool = False,
        device: Device = DEFAULT_DEVICE) -> dict:
    """The lag x noise sweep on the enveloped tone (eval_accuracy.py:20)."""
    source = tone_source(sr, 11, np.random.default_rng(7))
    ext = sweep_extractor(sr, device)
    hop_s = ext.config.hop_size / sr
    lags_s = [0.1, 0.5, 1.234, 2.5] if quick else [0.05, 0.1, 0.5, 1.234, 2.0, 3.5]
    noises = [0.01, 0.05] if quick else [0.005, 0.02, 0.05, 0.1]

    coarse_errs, refined_errs, confs = [], [], []
    coarse_offsets, cdns, true_lags = [], [], []
    for lag_s in lags_s:
        lag = int(lag_s * sr) + LAG_OFF_GRID
        for noise in noises:
            cdn = shift_signal(source, lag, noise=noise, gain=0.9)
            feats, refined = align_case(ext, source, cdn, sr)
            coarse_errs.append(abs(feats.temporal_offset - lag / sr))
            refined_errs.append(abs(refined - lag / sr))
            confs.append(feats.offset_confidence)
            coarse_offsets.append(feats.temporal_offset)
            cdns.append(cdn)
            true_lags.append(lag)
            print(f"lag={lag/sr*1000:8.1f}ms noise={noise:.3f} "
                  f"coarse_err={coarse_errs[-1]*1000:6.2f}ms "
                  f"refined_err={refined_errs[-1]*1000:7.3f}ms conf={confs[-1]:.2f}",
                  file=sys.stderr)

    batched_summary = None
    if batched:
        # the [B]-pair program must reproduce the per-pair offsets exactly
        from sonido_sonar_tpu_torch.ops.stats.batched_alignment import batched_align_audio

        q = np.broadcast_to(source, (len(cdns), len(source))).copy()
        out = batched_align_audio(
            q, np.stack(cdns), sr, window_size=ext.config.window_size,
            hop_size=ext.config.hop_size, max_lag_seconds=MAX_LAG_SECONDS,
            dtw_band=ext.alignment_config.dtw_band_radius, refine=True, device=device,
        )
        per_pair = np.round(np.asarray(coarse_offsets) * sr).astype(np.int64)
        got = out["offset_samples"].cpu().numpy().astype(np.int64)
        mismatches = int((per_pair != got).sum())
        ref_err = np.abs(out["offset_seconds_refined"].cpu().numpy() - np.asarray(true_lags) / sr)
        batched_summary = {
            "coarse_identical_to_per_pair": mismatches == 0,
            "coarse_mismatches": mismatches,
            "refined_within_one_hop": float((ref_err <= hop_s + 1e-6).mean()),
            "refined_err_ms_median": float(np.median(ref_err) * 1000),
        }
        print(f"[batched] {batched_summary}", file=sys.stderr)

    ce, re_ = np.array(coarse_errs), np.array(refined_errs)
    summary = {
        "cases": len(ce),
        "hop_ms": hop_s * 1000,
        "coarse_err_ms": {
            "median": float(np.median(ce) * 1000),
            "p95": float(np.percentile(ce, 95) * 1000),
            "within_one_hop": float((ce <= hop_s + 1e-6).mean()),
        },
        "refined_err_ms": {
            "median": float(np.median(re_) * 1000),
            "p95": float(np.percentile(re_, 95) * 1000),
            "within_one_hop": float((re_ <= hop_s + 1e-6).mean()),
        },
        "mean_confidence": float(np.mean(confs)),
    }
    if batched_summary is not None:
        summary["batched"] = batched_summary
    return summary


def extended_sources(sr: int) -> dict:
    return {
        "tone": tone_source(sr, 11, np.random.default_rng(7)),
        "speech": speech_like(DURATION, sr, seed=12, random_syllables=True),
        "music": music_like(DURATION, sr, seed=13),
    }


def extended_lags(sr: int, quick: bool) -> list:
    lags = [int(s * sr) + LAG_OFF_GRID for s in ([0.1, 1.234] if quick else [0.1, 0.5, 1.234, 2.5])]
    return lags + [-lag for lag in lags[:2]]  # both offset signs


def extended_cases(sr: int, quick: bool, sources: Optional[dict] = None
                   ) -> Iterator[Tuple[str, np.ndarray, np.ndarray, int, Optional[int]]]:
    """(category, source, cdn, true lag, verify_top_peaks) of every
    source-and-degradation case of `run_extended`, in its order."""
    sources = sources if sources is not None else extended_sources(sr)
    lags = extended_lags(sr, quick)
    for name, src in sources.items():
        rms = float(np.sqrt(np.mean(src ** 2)))
        for lag in lags:
            # moderate degradation, then 0 dB SNR (noise amplitude = signal RMS)
            yield name, src, shift_signal(src, lag, noise=0.05, gain=0.9), lag, None
            yield f"{name}_snr0db", src, shift_signal(src, lag, noise=rms, gain=0.9, seed=3), lag, None
        # band-limited CDN (codec simulation), moderate noise
        band = (300.0, 3400.0) if name == "speech" else (50.0, 8000.0)
        for lag in lags[:2]:
            cdn = band_limit(shift_signal(src, lag, noise=0.02, gain=0.9), sr, *band)
            # the default path: adaptive PCM verification (comb-ambiguous
            # pairs get top-K GCC-PHAT disambiguation)
            yield f"{name}_bandlimited", src, cdn, lag, None
            # verification forced off (the reference's raw behaviour): a
            # comb-ambiguous wrong answer must arrive at low confidence
            yield f"{name}_bandlimited_unverified", src, cdn, lag, 1


def stationary_cases(sr: int, quick: bool
                     ) -> Iterator[Tuple[str, np.ndarray, np.ndarray, int, Optional[int]]]:
    """Stationary content (no envelope): the energy-series NCC is blind
    here, so only the whitened full-range PHAT candidate recovers it."""
    src = (white_noise(DURATION, sr, 0.3, seed=21)
           + np.asarray(harmonic_tone(220.0, DURATION, sr)) * 0.3).astype(np.float32)
    lags = extended_lags(sr, quick)
    for lag in lags[:2] + [-lags[0]]:
        yield "stationary", src, shift_signal(src, lag, noise=0.05, gain=0.9), lag, None


def stretch_factors(quick: bool) -> list:
    return [0.99, 1.01] if quick else [0.98, 0.99, 1.005, 1.01, 1.02]


def stretch_features(ext: AlignmentExtractor, pcm: np.ndarray, sr: int) -> ExtractedFeatures:
    """Chroma and energy features of `pcm`, as the time-stretch cases use."""
    w, hop = ext.config.window_size, ext.config.hop_size
    x = as_float32(pcm, ext.device)
    mag = stft(x, w, hop, sample_rate=sr).magnitude
    return ExtractedFeatures(
        chroma_features=chroma_from_magnitude(mag, sr, w),
        energy_features=EnergyFeatures(short_time_energy=short_time_energy(x, w, hop)),
    )


def run_extended(sr: int = 44100, quick: bool = False, device: Device = DEFAULT_DEVICE) -> dict:
    """The categorized sweep (eval_accuracy.py:117): per-category
    within-one-hop rates and confidences, and the time-stretch errors."""
    ext = sweep_extractor(sr, device)
    hop_s = ext.config.hop_size / sr
    sources = extended_sources(sr)
    categories: dict = {}
    for cat, src, cdn, lag, verify in (*extended_cases(sr, quick, sources),
                                       *stationary_cases(sr, quick)):
        feats, refined = align_case(ext, src, cdn, sr, verify)
        c = categories.setdefault(cat, {"coarse": [], "refined": [], "conf": []})
        c["coarse"].append(abs(feats.temporal_offset - lag / sr))
        c["refined"].append(abs(refined - lag / sr))
        c["conf"].append(feats.offset_confidence)

    # time stretch (clock skew): estimate_time_stretch through the chroma DTW
    src = sources["music"]
    stretch_errs, dtw_stretch_errs = [], []
    for factor in stretch_factors(quick):
        cdn = time_stretch(src, factor)
        qf, rf = stretch_features(ext, src, sr), stretch_features(ext, cdn, sr)
        af = ext.extract_alignment_features(qf, rf, as_float32(src, ext.device),
                                            as_float32(cdn, ext.device), sr)
        expected = 1.0 / factor  # estimateTimeStretch: query span / reference span
        stretch_errs.append(abs(af.time_stretch - expected))
        # the DTW-slope path itself (alignment.go:448-476): the chroma-DTW
        # alignment taken as best, so the slope term is exercised
        dtw_fa = ext.perform_multi_feature_alignment(qf, rf, sr).get("dtw_chroma")
        est = float("nan")
        if dtw_fa is not None and dtw_fa.success:
            est = ext.estimate_time_stretch(dtw_fa, len(src) / sr, len(cdn) / sr)
            dtw_stretch_errs.append(abs(est - expected))
        print(f"[stretch] factor={factor} est={af.time_stretch:.4f} dtw_est={est:.4f} "
              f"expected~{expected:.4f}", file=sys.stderr)

    out: dict = {"hop_ms": hop_s * 1000, "categories": {}}
    for cat, c in categories.items():
        co, re_ = np.array(c["coarse"]), np.array(c["refined"])
        out["categories"][cat] = {
            "cases": len(co),
            "coarse_within_one_hop": float((co <= hop_s + 1e-6).mean()),
            "refined_within_one_hop": float((re_ <= hop_s + 1e-6).mean()),
            "refined_err_ms_median": float(np.median(re_) * 1000),
            "mean_confidence": float(np.mean(c["conf"])),
        }
        print(f"[{cat}] {out['categories'][cat]}", file=sys.stderr)
    out["time_stretch"] = {
        "cases": len(stretch_errs),
        "max_abs_error": float(np.max(stretch_errs)),
        "median_abs_error": float(np.median(stretch_errs)),
        "dtw_slope_max_abs_error": float(np.max(dtw_stretch_errs)) if dtw_stretch_errs else None,
    }
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sr", type=int, default=44100)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="the categorized sweep (sources x degradations)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    if args.full:
        summary = run_extended(args.sr, args.quick, device=args.device)
    else:
        summary = run(args.sr, args.quick, args.batched, device=args.device)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
