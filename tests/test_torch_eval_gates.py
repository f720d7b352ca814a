"""The accuracy gates of `tests/test_eval_gates.py` on the port's sweep
(`sonido_sonar_tpu_torch/eval_accuracy.run_extended`, sr 22,050, quick,
on the CPU), and single cases of the sweep held to JAX's aligner.

- Every default-path category aligns within one hop, coarse and refined.
- Correct default-path answers clear the laxest per-content accept
  threshold (`_MIN_ACCEPT`, from the port's config table).
- With verification forced off, a comb-ambiguous wrong answer arrives
  below every accept threshold.
- The time-stretch estimator stays within its error bound.

The single cases: the first case of each category (the same inputs as
JAX's sweep builds: the port's synth is JAX's bit for bit) through the
port's `align_case` and JAX's `AlignmentExtractor`: the frame-level and
refined offsets equal to the sample, the method equal, the confidence
within `utils/parity.ALIGN_SCORE_ATOL` (float32 sums in another order,
~1e-6 measured; 1e-5 in the aligner probe of ROADMAP item 16).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.config.config import FeatureConfig as JFeatureConfig  # noqa: E402
from sonido_sonar_tpu.extractors import AlignmentExtractor as JAlignmentExtractor  # noqa: E402
from sonido_sonar_tpu.extractors.features import EnergyFeatures as JEnergy  # noqa: E402
from sonido_sonar_tpu.extractors.features import ExtractedFeatures as JFeatures  # noqa: E402
from sonido_sonar_tpu.ops.chroma import chroma_from_magnitude as jchroma  # noqa: E402
from sonido_sonar_tpu.ops.stft import stft as jstft  # noqa: E402
from sonido_sonar_tpu.ops.temporal import short_time_energy as jenergy  # noqa: E402
from sonido_sonar_tpu_torch import eval_accuracy as EA  # noqa: E402
from sonido_sonar_tpu_torch.config.config import (  # noqa: E402
    ContentType,
    alignment_config_for_content,
)
from sonido_sonar_tpu_torch.io.synth import time_stretch  # noqa: E402
from sonido_sonar_tpu_torch.utils.parity import ALIGN_SCORE_ATOL  # noqa: E402

SR = 22050
_MIN_ACCEPT = min(alignment_config_for_content(ct).min_confidence for ct in ContentType)


@pytest.fixture(scope="module")
def extended_summary():
    return EA.run_extended(sr=SR, quick=True, device="cpu")


def test_default_path_categories_align(extended_summary):
    for cat, stats in extended_summary["categories"].items():
        if cat.endswith("_unverified"):
            continue
        assert stats["coarse_within_one_hop"] == 1.0, (cat, stats)
        assert stats["refined_within_one_hop"] == 1.0, (cat, stats)
        assert stats["refined_err_ms_median"] <= extended_summary["hop_ms"], (cat, stats)


def test_default_path_confidence_clears_accept(extended_summary):
    for cat, stats in extended_summary["categories"].items():
        if cat.endswith("_unverified"):
            continue
        assert stats["mean_confidence"] >= _MIN_ACCEPT, (cat, stats)


def test_unverified_comb_answer_is_low_confidence(extended_summary):
    stats = extended_summary["categories"]["music_bandlimited_unverified"]
    if stats["coarse_within_one_hop"] < 1.0:
        assert stats["mean_confidence"] < _MIN_ACCEPT, stats


def test_time_stretch_error_bound(extended_summary):
    ts = extended_summary["time_stretch"]
    assert ts["max_abs_error"] < 1e-3, ts
    if ts["dtw_slope_max_abs_error"] is not None:
        assert ts["dtw_slope_max_abs_error"] < 1e-3, ts


def test_the_sweep_has_jax_s_categories(extended_summary):
    names = [f"{s}{d}" for s in ("tone", "speech", "music")
             for d in ("", "_snr0db", "_bandlimited", "_bandlimited_unverified")]
    assert list(extended_summary["categories"]) == names + ["stationary"]
    assert {c: v["cases"] for c, v in extended_summary["categories"].items()} == {
        **{n: 4 if not n.count("_band") else 2 for n in names}, "stationary": 3}
    assert extended_summary["time_stretch"]["cases"] == 2


@pytest.fixture(scope="module")
def first_cases():
    cases = {}
    for cat, src, cdn, lag, verify in (*EA.extended_cases(SR, True), *EA.stationary_cases(SR, True)):
        cases.setdefault(cat, (src, cdn, lag, verify))
    return cases


@pytest.fixture(scope="module")
def extractors():
    jx = JAlignmentExtractor(JFeatureConfig(sample_rate=SR, window_size=1024, hop_size=256),
                             max_lag_seconds=EA.MAX_LAG_SECONDS)
    return EA.sweep_extractor(SR, "cpu"), jx


_CATEGORIES = [f"{s}{d}" for s in ("tone", "speech", "music")
               for d in ("", "_snr0db", "_bandlimited", "_bandlimited_unverified")] + ["stationary"]


@pytest.mark.parametrize("category", _CATEGORIES)
def test_case_matches_jax(category, first_cases, extractors):
    src, cdn, lag, verify = first_cases[category]
    tx, jx = extractors
    t, t_refined = EA.align_case(tx, src, cdn, SR, verify)
    j = jx.align_audio_files(jnp.asarray(src), jnp.asarray(cdn), SR, verify_top_peaks=verify)
    j_refined = jx.refine_offset_with_pcm(jnp.asarray(src), jnp.asarray(cdn), SR,
                                          j.temporal_offset)
    assert round(t.temporal_offset * SR) == round(j.temporal_offset * SR)
    assert round(t_refined * SR) == round(j_refined * SR)
    assert t.method == j.method
    assert t.offset_confidence == pytest.approx(j.offset_confidence, abs=ALIGN_SCORE_ATOL)
    if not category.endswith("_unverified"):
        assert round(t_refined * SR) == lag


def test_stretch_case_matches_jax(extractors):
    """One time-stretch case (chroma DTW through the fill and the walk):
    the stretch estimate and the chroma DTW's offset against JAX's."""
    tx, jx = extractors
    src = EA.extended_sources(SR)["music"]
    cdn = time_stretch(src, 1.01)

    def jfeatures(pcm):
        mag = jstft(jnp.asarray(pcm), 1024, 256, sample_rate=SR).magnitude
        return JFeatures(chroma_features=jchroma(mag, SR, 1024),
                         energy_features=JEnergy(short_time_energy=jenergy(jnp.asarray(pcm),
                                                                           1024, 256)))

    tq, tr = EA.stretch_features(tx, src, SR), EA.stretch_features(tx, cdn, SR)
    jq, jr = jfeatures(src), jfeatures(cdn)
    t = tx.extract_alignment_features(tq, tr, src, cdn, SR)
    j = jx.extract_alignment_features(jq, jr, jnp.asarray(src), jnp.asarray(cdn), SR)
    assert t.method == j.method
    assert round(t.temporal_offset * SR) == round(j.temporal_offset * SR)
    assert t.time_stretch == pytest.approx(j.time_stretch, abs=ALIGN_SCORE_ATOL)
    td = tx.perform_multi_feature_alignment(tq, tr, SR)["dtw_chroma"]
    jd = jx.perform_multi_feature_alignment(jq, jr, SR)["dtw_chroma"]
    assert td.success and jd.success
    assert td.result.offset == jd.result.offset
    assert tx.estimate_time_stretch(td, len(src) / SR, len(cdn) / SR) == pytest.approx(
        jx.estimate_time_stretch(jd, len(src) / SR, len(cdn) / SR), abs=ALIGN_SCORE_ATOL)


def test_44k_comb_cases_match_jax():
    """At 44.1 kHz, full, the two music_bandlimited_unverified cases:
    one right at 0.468 and one wrong (a beat comb) at 0.356, in both
    packages. The wrong answer is below every accept threshold (gate 3's
    intent), but the category's mean, 0.412, is not below the laxest
    (0.4), so gate 3's category-mean form misses there in JAX as in the
    port; `chip_smoke.py` phase 35 holds the gate per case."""
    sr = 44100
    tx = EA.sweep_extractor(sr, "cpu")
    jx = JAlignmentExtractor(JFeatureConfig(sample_rate=sr, window_size=1024, hop_size=256),
                             max_lag_seconds=EA.MAX_LAG_SECONDS)
    sources = {"music": EA.extended_sources(sr)["music"]}
    cases = [c for c in EA.extended_cases(sr, False, sources)
             if c[0] == "music_bandlimited_unverified"]
    wrong = 0
    for _, src, cdn, lag, verify in cases:
        t, _ = EA.align_case(tx, src, cdn, sr, verify)
        j = jx.align_audio_files(jnp.asarray(src), jnp.asarray(cdn), sr, verify_top_peaks=verify)
        assert round(t.temporal_offset * sr) == round(j.temporal_offset * sr)
        assert t.offset_confidence == pytest.approx(j.offset_confidence, abs=ALIGN_SCORE_ATOL)
        if abs(round(t.temporal_offset * sr) - lag) > 256:
            wrong += 1
            assert t.offset_confidence < _MIN_ACCEPT
    assert len(cases) == 2 and wrong == 1


def test_run_batched_is_the_per_pair_sweep():
    """`run(batched=True)`: the [B]-pair aligner's coarse offsets equal
    the per-pair ones, and every case lands within one hop."""
    summary = EA.run(SR, quick=True, batched=True, device="cpu")
    assert summary["cases"] == 8
    assert summary["batched"]["coarse_identical_to_per_pair"], summary
    assert summary["coarse_err_ms"]["within_one_hop"] == 1.0, summary
    assert summary["refined_err_ms"]["within_one_hop"] == 1.0, summary
    assert summary["batched"]["refined_within_one_hop"] == 1.0, summary


def test_cli_prints_the_summary_last(capsys):
    EA.main(["--sr", "8000", "--quick", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    import json

    summary = json.loads(out[-1])
    assert summary["cases"] == 8 and summary["hop_ms"] == pytest.approx(256 / 8000 * 1000)
    assert np.isfinite(summary["mean_confidence"])
