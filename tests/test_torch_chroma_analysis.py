"""The port's `ops/chroma_analysis.py` held to the JAX package on the
CPU: twins of `tests/test_chroma_analysis.py` (the same seeded chroma
through both packages), the Tonnetz tables bit for bit, all six sequence
similarities (Smith-Waterman and DTW rows under their stated
tolerances), the slanted DTW band's float32 divide at 5,164 x 5,164,
the transposition tie rule, and the even-window traps of smoothing and
voice leading. Tolerances: utils/parity.py (OPS_*, SW_ATOL_SCALE,
TRANSPOSITION_TIE)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.ops import chroma_analysis as J  # noqa: E402
from sonido_sonar_tpu_torch.ops import chroma_analysis as CA  # noqa: E402
from sonido_sonar_tpu_torch.ops.chroma import CHROMA_LABELS  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, ref, rtol=parity.OPS_RTOL, atol=parity.OPS_ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def cv(labels, weights=None):
    v = np.zeros(12, np.float32)
    for i, lab in enumerate(labels):
        v[CHROMA_LABELS.index(lab)] = weights[i] if weights else 1.0
    return v / v.sum()


def _seq(seed, t=20):
    s = np.abs(np.random.default_rng(seed).standard_normal((t, 12))).astype(np.float32)
    return s / s.sum(axis=1, keepdims=True)


def test_chroma_stats_match_jax():
    x = np.stack([np.ones(12, np.float32) / 12, cv(["C"]), cv(["C", "E", "G"]), np.zeros(12, np.float32),
                  *_seq(1, 6)])
    got, ref = CA.chroma_stats(_t(x)), J.chroma_stats(jnp.asarray(x))
    assert got.keys() == ref.keys()
    # the uniform row's circular mean has a zero resultant: its angle is
    # atan2 of rounding residues in either package, so it is not compared
    defined = np.ones(len(x), bool)
    defined[0] = False
    for k in ref:
        keep = defined if k == "centroid" else slice(None)
        _close(got[k].numpy()[keep], np.asarray(ref[k])[keep], atol=1e-5)
    assert float(got["entropy"][0]) == pytest.approx(np.log2(12), abs=1e-4)
    assert float(got["sparsity"][1]) == pytest.approx(1.0, abs=0.05)


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "correlation", "kl", "js", "hellinger"])
def test_chroma_distance_and_similarity_match_jax(metric):
    a, b = _seq(2, 5), _seq(3, 5)
    a[0] = b[0]
    _close(CA.chroma_distance(_t(a), _t(b), metric), J.chroma_distance(jnp.asarray(a), jnp.asarray(b), metric))
    _close(CA.chroma_similarity(_t(a), _t(b), metric), J.chroma_similarity(jnp.asarray(a), jnp.asarray(b), metric))
    with pytest.raises(ValueError):
        CA.chroma_distance(_t(a), _t(b), "nope")


def _same_shift(got, ref, a, b, metric="cosine"):
    """The port's shift is JAX's, or JAX's similarity there is within
    TRANSPOSITION_TIE of JAX's best."""
    if got[0] != ref[0]:
        at = float(J.chroma_similarity(jnp.roll(jnp.asarray(a), got[0]), jnp.asarray(b), metric))
        assert ref[1] - at <= parity.TRANSPOSITION_TIE
    assert got[1] == pytest.approx(ref[1], abs=parity.TRANSPOSITION_TIE)


def test_optimal_transposition_matches_jax_and_ties():
    a = cv(["C", "E", "G"])
    for s in range(12):
        got = CA.optimal_transposition(_t(a), _t(np.roll(a, s)))
        ref = J.optimal_transposition(jnp.asarray(a), jnp.asarray(np.roll(a, s)))
        assert got[0] == ref[0] == s
        _same_shift(got, ref, a, np.roll(a, s))
    # a symmetric profile: shifts 0, 4 and 8 tie exactly; the first wins
    aug = cv(["C", "E", "G#"])
    assert CA.optimal_transposition(_t(aug), _t(aug))[0] == J.optimal_transposition(
        jnp.asarray(aug), jnp.asarray(aug))[0] == 0
    for seed in range(4, 10):
        a, b = _seq(seed, 1)[0], _seq(seed + 10, 1)[0]
        for metric in ("cosine", "js"):
            _same_shift(CA.optimal_transposition(_t(a), _t(b), metric),
                        J.optimal_transposition(jnp.asarray(a), jnp.asarray(b), metric), a, b, metric)
    assert CA.transposition_search(_t(a), _t(b)) == CA.optimal_transposition(_t(a), _t(b))


@pytest.mark.parametrize("window", [3, 4, 5])
def test_smooth_chroma_edge_padding_matches_jax(window):
    seq = _seq(11, 9)
    _close(CA.smooth_chroma(_t(seq), window), J.smooth_chroma(jnp.asarray(seq), window))


def test_vector_helpers_match_jax():
    seq = _seq(12, 7)
    _close(CA.chroma_template(_t(seq)), J.chroma_template(jnp.asarray(seq)))
    _close(CA.chroma_template(torch.zeros(3, 12)), J.chroma_template(jnp.zeros((3, 12))))
    idx, val = CA.dominant_chroma(_t(seq))
    jidx, jval = J.dominant_chroma(jnp.asarray(seq))
    assert idx.tolist() == np.asarray(jidx).tolist()
    _close(val, jval)
    _close(CA.interpolate_chroma(_t(seq[0]), _t(seq[1]), 0.3), J.interpolate_chroma(jnp.asarray(seq[0]), jnp.asarray(seq[1]), 0.3))
    _close(CA.circular_shift(_t(seq), 5), J.circular_shift(jnp.asarray(seq), 5))


def _sequences(seed, tq, tr):
    rng = np.random.default_rng(seed)
    q = np.abs(rng.standard_normal((tq, 12))).astype(np.float32)
    r = np.abs(rng.standard_normal((tr, 12))).astype(np.float32)
    r[:min(tq, tr)] = 0.6 * r[:min(tq, tr)] + q[:min(tq, tr)]    # related, so scores grow
    return q, r


@pytest.mark.parametrize("method", ["direct", "binary", "qmax", "oti"])
@pytest.mark.parametrize("invariant", [False, True])
def test_sequence_similarity_matches_jax(method, invariant):
    q, r = _sequences(13, 23, 17)
    r = np.roll(r, 3, axis=1)
    got = CA.ChromaSequenceSimilarity(method, transposition_invariant=invariant, device=CPU).compute(q, r)
    ref = J.ChromaSequenceSimilarity(method, transposition_invariant=invariant).compute(q, r)
    assert (got.method, got.best_transposition, got.query_frames, got.reference_frames) == (
        ref.method, ref.best_transposition, ref.query_frames, ref.reference_frames)
    _close(got.similarity_matrix, ref.similarity_matrix)
    assert got.overall_similarity == pytest.approx(ref.overall_similarity, rel=parity.OPS_RTOL)


@pytest.mark.parametrize("tq,tr", [(40, 47), (300, 290)])
def test_smith_waterman_rows_match_jax(tq, tr):
    q, r = _sequences(14, tq, tr)
    got = CA.ChromaSequenceSimilarity("smith_waterman", device=CPU).compute(q, r)
    ref = J.ChromaSequenceSimilarity("smith_waterman").compute(q, r)
    peak = float(np.abs(ref.similarity_matrix).max())
    assert peak > tq / 4                                          # scores that grow along the rows
    err = np.abs(got.similarity_matrix - ref.similarity_matrix).max()
    assert err <= parity.SW_ATOL_SCALE * peak, (err, peak)
    assert got.overall_similarity == pytest.approx(ref.overall_similarity, rel=parity.SW_ATOL_SCALE)


@pytest.mark.parametrize("radius", [0, 1, 6])
def test_dtw_rows_match_jax(radius):
    q, r = _sequences(15, 37, 29)
    got = CA.ChromaSequenceSimilarity("dtw", dtw_band_radius=radius, device=CPU).compute(q, r)
    ref = J.ChromaSequenceSimilarity("dtw", dtw_band_radius=radius).compute(q, r)
    _close(got.similarity_matrix, ref.similarity_matrix)
    assert got.overall_similarity == pytest.approx(ref.overall_similarity, rel=parity.OPS_RTOL)


@pytest.mark.parametrize("tq,tr", [(5164, 5164), (5165, 5164), (5163, 5171)])
def test_dtw_band_mask_float32_divide_at_5164(tq, tr):
    got = CA.dtw_band_mask(tq, tr, 10)
    ii = jnp.arange(tq)[:, None]
    jj = jnp.arange(tr)[None, :]
    expected = (jj * tq / tr).astype(jnp.int32)                 # JAX's expression (chroma_analysis.py:289)
    ref = np.asarray(jnp.abs(ii - expected) <= 10)
    np.testing.assert_array_equal(got.numpy(), ref)
    exact = np.abs(np.arange(tq)[:, None] - (np.arange(tr)[None, :] * tq) // tr) <= 10
    if (tq, tr) == (5165, 5164):
        assert (ref != exact).any()                              # j * tq above 2^24 rounds


def test_self_similarity_above_other_and_oti_recovers_shift():
    seq, other = _seq(16), _seq(17)
    for method in ("direct", "binary", "smith_waterman", "dtw", "qmax", "oti"):
        css = CA.ChromaSequenceSimilarity(method, device=CPU)
        assert css.compute(seq, seq).overall_similarity > css.compute(seq, other).overall_similarity
    res = CA.ChromaSequenceSimilarity("oti", device=CPU).compute(seq, np.roll(seq, 4, axis=1))
    assert res.best_transposition == 4
    assert float(np.diag(res.similarity_matrix).mean()) > 0.99
    with pytest.raises(ValueError):
        CA.ChromaSequenceSimilarity("nope", device=CPU).compute(seq, seq)


def test_pitch_class_relations_match_jax():
    for a in range(12):
        for b in range(12):
            assert CA.fifths_distance(a, b) == J.fifths_distance(a, b)
            for m1 in ("major", "minor"):
                assert CA.diatonic_membership(a, b, m1) == J.diatonic_membership(a, b, m1)
                for m2 in ("major", "minor"):
                    assert CA.key_relationship(a, m1, b, m2) == J.key_relationship(a, m1, b, m2)
    assert CA.CIRCLE_OF_FIFTHS == J.CIRCLE_OF_FIFTHS


def test_tonnetz_tables_bit_equal():
    assert CA.TONNETZ_LATTICE.dtype == J.TONNETZ_LATTICE.dtype
    np.testing.assert_array_equal(CA.TONNETZ_LATTICE, J.TONNETZ_LATTICE)
    np.testing.assert_array_equal(CA._TONAL_CENTROID, J._TONAL_CENTROID)
    for consonant in (False, True):
        ref = J._CONSONANT_INTERVALS if consonant else J._DISSONANT_INTERVALS
        tab = CA._interval_weights(consonant)
        assert all(tab[i, j] == np.float32(ref.get((j - i) % 12, 0.0)) for i in range(12) for j in range(12))


def test_tonnetz_ops_match_jax():
    seq = np.concatenate([_seq(18, 9), np.zeros((1, 12), np.float32), -_seq(19, 2)])
    for fn in ("tonal_centroid", "tonnetz_point", "harmonic_tension", "consonance"):
        _close(getattr(CA, fn)(_t(seq)), getattr(J, fn)(jnp.asarray(seq)), atol=1e-5)
    got, ref = CA.tonnetz_trajectory(_t(seq[:9])), J.tonnetz_trajectory(jnp.asarray(seq[:9]))
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k], ref[k], atol=1e-5)


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_voice_leading_even_median_matches_jax(seed):
    a, b = _seq(seed, 4), _seq(seed + 5, 4)
    got = CA.voice_leading_distance(_t(a), _t(b))
    _close(got, J.voice_leading_distance(jnp.asarray(a), jnp.asarray(b)))
    # 12 cumulative differences: the median is the mean of the middle pair
    # (any value between the two gives the same L1 sum, so only rounding
    # would tell the lower one apart)
    c = torch.cumsum(_t(a / a.sum(-1, keepdims=True) - b / b.sum(-1, keepdims=True)), dim=-1)
    from sonido_sonar_tpu_torch.ops.stats.moments import median
    _close(median(c), jnp.median(jnp.asarray(c.numpy()), axis=-1))
    assert float(CA.voice_leading_distance(_t(a[0]), _t(a[0]))) == pytest.approx(0.0, abs=1e-6)
