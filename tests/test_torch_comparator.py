"""The port's host comparator (`fingerprint/comparison.py`) held to the
JAX package's on the CPU, on fingerprints carried across by
`utils/convert.fingerprint_from_reference`.

The host comparator is float64 numpy in both packages, the same
expressions in the same order, so its results must be equal, not close.
The opt-in MFCC variants run float32 on a device in both (the port's
`cross_correlate_pearson` and dense `dtw_align`):
utils/parity.COMPARATOR_MFCC_VARIANT_ATOL.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from sonido_sonar_tpu.config import config as jconfig  # noqa: E402
from sonido_sonar_tpu.fingerprint import comparison as J  # noqa: E402
from sonido_sonar_tpu.fingerprint.device_compare import content_code as j_content_code  # noqa: E402
from sonido_sonar_tpu_torch.config import config as tconfig  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import comparison as T  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint.device_compare import content_code  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402
from sonido_sonar_tpu_torch.utils.convert import (  # noqa: E402
    comparison_config_from_dict,
    fingerprint_from_reference,
)

from tests.test_goref_parity import _GROUPS, _make_fp, _random_features  # noqa: E402

CONTENTS = ("news", "talk", "music", "sports", "mixed", "unknown")


def _pair_configs(**kw):
    return jconfig.ComparisonConfig(**kw), tconfig.ComparisonConfig(**kw)


def _same_result(got, want):
    """Every field of two SimilarityResults equal (processing time
    aside), the quality metrics too."""
    for f in dataclasses.fields(want):
        if f.name in ("processing_time", "quality_metrics"):
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    if want.quality_metrics is None:
        assert got.quality_metrics is None
    else:
        assert dataclasses.asdict(got.quality_metrics) == dataclasses.asdict(want.quality_metrics)


def _random_pair(rng):
    k = int(rng.integers(1, len(_GROUPS) + 1))
    present = set(rng.choice(_GROUPS, size=k, replace=False))
    content = jconfig.ContentType(CONTENTS[int(rng.integers(0, len(CONTENTS)))])
    f1, _ = _random_features(rng, present)
    f2, _ = _random_features(rng, present)
    return (_make_fp(rng, "a", content, f1, float(rng.uniform(5, 120))),
            _make_fp(rng, "b", content, f2, float(rng.uniform(5, 120))))


@pytest.mark.parametrize("detailed,content_filter", [(True, False), (False, True)])
def test_compare_matches_jax_on_the_goref_corpus(detailed, content_filter):
    """The 300 random trials of tests/test_goref_parity.py (mixed feature
    groups, six content types), both configurations: equal results."""
    rng = np.random.default_rng(4)
    jcfg, tcfg = _pair_configs(enable_detailed_metrics=detailed, enable_content_filter=content_filter)
    jc, tc = J.FingerprintComparator(jcfg), T.FingerprintComparator(tcfg, device="cpu")
    for trial in range(300):
        a, b = _random_pair(rng)
        if trial % 7 == 0:  # a content mismatch for the filter's early-out
            b.content_type = jconfig.ContentType.MUSIC
        _same_result(tc.compare(fingerprint_from_reference(a), fingerprint_from_reference(b)),
                     jc.compare(a, b))


def test_batch_compare_classify_and_statistics_match_jax():
    """batch_compare skips None and self and keeps going past a pair with
    no comparable features; classify_match at and around every bound;
    get_similarity_statistics of the results (and of none)."""
    rng = np.random.default_rng(5)
    query, _ = _random_pair(rng)
    query.id = "q"
    cands = [_random_pair(rng)[0] for _ in range(20)]
    for i, c in enumerate(cands):
        c.id = f"c{i}"
    empty = _make_fp(rng, "none", jconfig.ContentType.NEWS, _random_features(rng, set())[0], 10.0)
    jcands = [None, query] + cands + [empty]
    tq = fingerprint_from_reference(query)
    tcands = [None, tq] + [fingerprint_from_reference(c) for c in cands + [empty]]
    want = J.FingerprintComparator().batch_compare(query, jcands)
    got = T.FingerprintComparator(device="cpu").batch_compare(tq, tcands)
    assert 0 < len(got) == len(want) < len(cands) + 1
    for g, w in zip(got, want):
        _same_result(g, w)
    assert T.get_similarity_statistics(got) == J.get_similarity_statistics(want)
    assert T.get_similarity_statistics([]) == J.get_similarity_statistics([]) == {}
    for s in (0.0, 0.5999999, 0.6, 0.74, 0.75, 0.8499, 0.85, 0.9499, 0.95, 1.0):
        assert T.classify_match(s) == J.classify_match(s)


def test_helpers_and_mfcc_statistics_match_jax():
    rng = np.random.default_rng(6)
    for _ in range(50):
        a, b = rng.normal(size=int(rng.integers(1, 30))), rng.normal(size=int(rng.integers(1, 30)))
        assert T.compare_sequence_stats(a, b) == J.compare_sequence_stats(a, b)
        assert T.cosine_similarity(a, a[::-1]) == J.cosine_similarity(a, a[::-1])
        x, y = float(rng.normal()), float(rng.choice([0.0, rng.normal()]))
        assert T.compare_scalar(x, y) == J.compare_scalar(x, y)
        m = rng.normal(size=(int(rng.integers(1, 12)), 13))
        np.testing.assert_array_equal(T.extract_mfcc_statistics(m), J.extract_mfcc_statistics(m))
    assert T.compare_scalar(0.0, 0.0) == 1.0 and T.cosine_similarity(np.zeros(3), np.ones(3)) == 0.0
    np.testing.assert_array_equal(T.extract_mfcc_statistics(np.zeros((0, 13))), np.zeros(0))


def test_weight_tables_content_codes_and_config_match_jax():
    """The weight tables (comparison.go:1055-1104), the MFCC combination
    weights, and the content codes: positions in the enum, which must be
    in the same order in both packages."""
    def by_value(table):
        return {k.value: v for k, v in table.items()}

    assert by_value(T._CONTENT_WEIGHTS) == by_value(J._CONTENT_WEIGHTS)
    assert T._DEFAULT_WEIGHTS == J._DEFAULT_WEIGHTS
    assert by_value(T._MFCC_COMBINE_WEIGHTS) == by_value(J._MFCC_COMBINE_WEIGHTS)
    assert [c.value for c in tconfig.ContentType] == [c.value for c in jconfig.ContentType]
    for jct in jconfig.ContentType:
        assert content_code(tconfig.ContentType(jct.value)) == j_content_code(jct)
    assert content_code("not a type") == j_content_code("not a type") == -1
    cfg = jconfig.ComparisonConfig(similarity_threshold=0.7, method="precise", max_candidates=9,
                                   enable_content_filter=True, content_type=jconfig.ContentType.TALK,
                                   feature_weights=(("mfcc", 0.5), ("chroma", 0.25)))
    got = comparison_config_from_dict(jconfig.asdict(cfg))
    assert got == tconfig.ComparisonConfig(
        similarity_threshold=0.7, method="precise", max_candidates=9, enable_content_filter=True,
        content_type=tconfig.ContentType.TALK, feature_weights=(("mfcc", 0.5), ("chroma", 0.25)))
    with pytest.raises(ValueError, match="unknown ComparisonConfig"):
        comparison_config_from_dict({"threshold": 1.0})
    for method, internal in (("fast", "cosine"), ("precise", "pearson"), ("auto", "adaptive")):
        comp = T.FingerprintComparator(tconfig.ComparisonConfig(method=method), device="cpu")
        ref = J.FingerprintComparator(jconfig.ComparisonConfig(method=method))
        assert (comp.internal_method, comp.hash_weight, comp.feature_weight) == (
            internal, ref.hash_weight, ref.feature_weight)
    with pytest.raises(ValueError, match="unknown method"):
        T.FingerprintComparator(tconfig.ComparisonConfig(method="slow"), device="cpu").validate_config()


def test_mfcc_variants_match_jax():
    """compare_mfcc_sequences (per-coefficient Pearson cross-correlation
    peaks) and compare_mfcc_with_dtw (dense DTW, exp(-d)) on float32 in
    both packages; combine_mfcc_methods is arithmetic on floats."""
    rng = np.random.default_rng(7)
    base = rng.normal(size=(60, 13))
    other = np.concatenate([base[3:], rng.normal(size=(3, 13))]) + 0.3 * rng.normal(size=(60, 13))
    for m1, m2 in ((base, other), (base, rng.normal(size=(45, 13))), (base[:20], base[:20])):
        got = T.compare_mfcc_sequences(m1, m2, device="cpu")
        want = J.compare_mfcc_sequences(m1, m2)
        assert got == pytest.approx(want, abs=parity.COMPARATOR_MFCC_VARIANT_ATOL)
        got = T.compare_mfcc_with_dtw(m1, m2, band=10, device="cpu")
        want = J.compare_mfcc_with_dtw(m1, m2, band=10)
        assert got == pytest.approx(want, abs=parity.COMPARATOR_MFCC_VARIANT_ATOL)
    assert T.compare_mfcc_sequences(np.zeros((0, 13)), base, device="cpu") == 0.0
    assert T.compare_mfcc_with_dtw(np.zeros((0, 13)), base, device="cpu") == 0.0
    for ct in CONTENTS:
        assert T.combine_mfcc_methods(0.9, 0.5, 0.2, tconfig.ContentType(ct)) == \
            J.combine_mfcc_methods(0.9, 0.5, 0.2, jconfig.ContentType(ct))


def test_tensor_features_compare_as_numpy():
    """A fingerprint whose leaves are CPU tensors (as the port's
    generate_fingerprint leaves them on its device) compares, packs and
    scores exactly as the same fingerprint with numpy leaves."""
    from sonido_sonar_tpu_torch.extractors.features import map_tensors
    from sonido_sonar_tpu_torch.fingerprint.device_compare import pack_comparator_stats

    rng = np.random.default_rng(8)
    comp = T.FingerprintComparator(tconfig.ComparisonConfig(enable_detailed_metrics=True), device="cpu")
    for _ in range(20):
        a, b = (fingerprint_from_reference(fp) for fp in _random_pair(rng))
        ta = dataclasses.replace(a, features=map_tensors(torch.from_numpy, a.features))
        _same_result(comp.compare(ta, b), comp.compare(a, b))
        _same_result(comp.compare(b, ta), comp.compare(b, a))
        np.testing.assert_array_equal(pack_comparator_stats(ta), pack_comparator_stats(a))
