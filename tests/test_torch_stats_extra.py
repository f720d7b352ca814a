"""The port's `ops/stats/{distance,entropy,moments,percentiles,clustering}.py`
held to the JAX package on the CPU: twins of `tests/test_stats_extra.py`
(each runs the same seeded input through both packages), plus the traps:
kNN with tied distances (ascending index order, as `lax.top_k`), the
averaged even median and JAX's float32 quantile position, a quantile
above 2^24 elements, and `entropy.analyze` binning a float64 series in
float32. Tolerances: utils/parity.py (OPS_*, MOMENTS_RTOL)."""

import math

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.ops.stats import clustering as JC  # noqa: E402
from sonido_sonar_tpu.ops.stats import distance as JD  # noqa: E402
from sonido_sonar_tpu.ops.stats import entropy as JE  # noqa: E402
from sonido_sonar_tpu.ops.stats import moments as JM  # noqa: E402
from sonido_sonar_tpu.ops.stats import percentiles as JP  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import clustering as C  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import distance as D  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import entropy as E  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import moments as M  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import percentiles as P  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, ref, rtol=parity.OPS_RTOL, atol=parity.OPS_ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _pair(seed, shape=(6, 12), positive=True):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    if positive:
        a, b = np.abs(a), np.abs(b)
        a[0, :3] = 0.0                      # zeros: the divergences' masks
    return a, b


# ------------------------------ distance ------------------------------

@pytest.mark.parametrize("metric", sorted(D._REGISTRY))
def test_metric_matches_jax(metric):
    a, b = _pair(1, positive=metric in ("kl", "js", "hellinger", "bhattacharyya", "emd", "jaccard"))
    a[1] = b[1]                             # an identical row
    _close(D.get_distance_function(metric)(_t(a), _t(b)),
           JD.get_distance_function(metric)(jnp.asarray(a), jnp.asarray(b)))


def test_metric_basics_as_jax_test():
    a, b = _t([1.0, 0.0, 0.0]), _t([0.0, 1.0, 0.0])
    assert float(D.euclidean(a, b)) == pytest.approx(math.sqrt(2))
    assert float(D.chebyshev(a, b)) == pytest.approx(1.0)
    assert float(D.hamming(a, b)) == pytest.approx(2 / 3)
    assert float(D.minkowski(a, b, 2.0)) == pytest.approx(math.sqrt(2), rel=1e-5)
    assert float(D.emd_1d(_t([1, 0, 0, 0]), _t([0, 0, 0, 1]))) == pytest.approx(3.0)
    with pytest.raises(ValueError):
        D.get_distance_function("nope")


def test_mahalanobis_matches_jax():
    a, b = _pair(2, (5, 4), positive=False)
    m = np.random.default_rng(3).standard_normal((4, 4)).astype(np.float32)
    inv_cov = (m @ m.T + np.eye(4, dtype=np.float32)).astype(np.float32)
    _close(D.mahalanobis(_t(a), _t(b), _t(inv_cov)),
           JD.mahalanobis(jnp.asarray(a), jnp.asarray(b), jnp.asarray(inv_cov)))
    assert float(D.mahalanobis(_t([1, 2]), _t([4, 6]), torch.eye(2))) == pytest.approx(5.0)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine", "js", "manhattan"])
def test_distance_matrix_matches_jax(metric, monkeypatch):
    x, y = _pair(4, (13, 5))
    monkeypatch.setattr(D, "MATRIX_CHUNK_BYTES", 4 * 7 * 5 * 2)   # chunks of 2 rows
    got = D.distance_matrix(_t(x), _t(y[:7]), metric)
    ref = JD.distance_matrix(jnp.asarray(x), jnp.asarray(y[:7]), metric)
    _close(got, ref, atol=1e-5 if metric.endswith("euclidean") else parity.OPS_ATOL)


def test_knn_ties_in_ascending_index_order():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((40, 3)).astype(np.float32)
    q = data[7].copy()
    for i in (31, 2, 19, 25):                # exact copies of the query: four ties at 0
        data[i] = q
    data[11] = q + np.float32(1.0)
    data[36] = q - np.float32(1.0)           # a tie at the same distance, other side
    idx, dist = D.knn(_t(q), _t(data), k=8, metric="manhattan")
    jidx, jdist = JD.knn(jnp.asarray(q), jnp.asarray(data), k=8, metric="manhattan")
    assert idx.tolist()[:5] == [2, 7, 19, 25, 31]
    assert idx.tolist() == np.asarray(jidx).tolist()
    assert idx.dtype == torch.int32
    _close(dist, jdist)
    idx2, _ = D.knn(_t(q), _t(data), k=100)
    assert len(idx2) == 40


# ------------------------------ entropy ------------------------------

@pytest.mark.parametrize("bins", [1, 7, 16])
def test_histogram_and_entropies_match_jax(bins):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 257)).astype(np.float32)
    x[2] = 0.25                              # a constant row: width at its floor
    p = E.histogram_probs(_t(x), bins)
    jp = JE.histogram_probs(jnp.asarray(x), bins)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    for name, kw in (("shannon_entropy", {}), ("renyi_entropy", {"alpha": 2.0}),
                     ("renyi_entropy", {"alpha": 1.0}), ("tsallis_entropy", {"q": 2.0}),
                     ("tsallis_entropy", {"q": 1.0}), ("hartley_entropy", {}), ("min_entropy", {})):
        _close(getattr(E, name)(p, **kw), getattr(JE, name)(jp, **kw))


def test_bin_selectors_and_rate_match_jax():
    x = np.random.default_rng(7).standard_normal(500)
    for m in ("sturges", "rice", "sqrt", "scott", "fd", "freedman-diaconis"):
        assert E.select_bins(x, m) == JE.select_bins(x, m)
    assert E.scott_bins(np.ones(5)) == JE.scott_bins(np.ones(5)) == 1
    with pytest.raises(ValueError):
        E.select_bins(x, "nope")
    s = np.random.default_rng(8).integers(0, 4, 300)
    assert E.entropy_rate(s, 4) == JE.entropy_rate(s, 4)
    assert E.entropy_rate(np.array([0, 1, 0, 1, 0, 1]), 2) == pytest.approx(0.0, abs=1e-9)


def test_conditional_entropy_matches_jax():
    j = np.abs(np.random.default_rng(9).standard_normal((2, 4, 5))).astype(np.float32)
    j[1, 2] = 0.0
    _close(E.conditional_entropy(_t(j)), JE.conditional_entropy(jnp.asarray(j)))


def test_entropy_analyze_bins_float64_series_in_float32():
    # values 1e-12 either side of the bin edges: their float32 cast moves
    # some across an edge, so binning the float64 values would give other
    # probabilities than JAX's (x64 off)
    rng = np.random.default_rng(10)
    x = np.concatenate([rng.standard_normal(200), [0.0, 1.0]])
    bins = E.select_bins(np.zeros(len(x) + 16))
    edges = x.min() + (x.max() - x.min()) * np.arange(1, bins) / bins
    x = np.concatenate([x, edges - 1e-12, edges + 1e-12])
    assert E.select_bins(x) == bins
    for method in ("sturges", "fd"):
        got = E.analyze(x, method, device=CPU)
        ref = JE.analyze(x, method)
        assert got.keys() == ref.keys()
        _close([got[k] for k in sorted(got)], [ref[k] for k in sorted(ref)])
    idx64 = np.clip(((x - x.min()) / (x.max() - x.min()) * bins).astype(np.int64), 0, bins - 1)
    p64 = np.bincount(idx64, minlength=bins) / len(x)
    p32 = E.histogram_probs(_t(x)[None], bins)[0].numpy()
    assert np.abs(p64 - p32).max() > 1e-3     # the cast does move values across edges
    _close(p32, np.asarray(JE.histogram_probs(jnp.asarray(x[None]), bins))[0])


# ------------------------------ moments ------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_moments_match_jax(k):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 301)) + 0.3).astype(np.float32)
    x[1] = rng.exponential(size=301).astype(np.float32)
    xj, xt = jnp.asarray(x), _t(x)
    for fn in ("raw_moment", "central_moment", "standardized_moment", "absolute_moment"):
        _close(getattr(M, fn)(xt, k), getattr(JM, fn)(xj, k), rtol=parity.MOMENTS_RTOL)


def test_moment_summaries_match_jax():
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((3, 200)) ** 3).astype(np.float32)
    x[2] = 1.5                                # constant row: the eps guards
    xj, xt = jnp.asarray(x), _t(x)
    for fn in ("mean", "skewness", "pearson_skewness", "bowley_skewness", "kurtosis"):
        _close(getattr(M, fn)(xt), getattr(JM, fn)(xj), rtol=parity.MOMENTS_RTOL)
    for sample in (True, False):
        _close(M.variance(xt, sample), JM.variance(xj, sample))
    for k, v in M.cumulants(xt).items():
        _close(v, JM.cumulants(xj)[k], rtol=parity.MOMENTS_RTOL)


def test_welford_l_moments_and_analyze_match_jax():
    x = np.random.default_rng(13).gamma(2.0, size=400)
    assert M.welford(x) == JM.welford(x)
    assert M.l_moments(x) == JM.l_moments(x)
    assert M.l_moments(x[:3]) == JM.l_moments(x[:3])
    got, ref = M.analyze(x, device=CPU), JM.analyze(x)
    assert got.keys() == ref.keys()
    _close([got[k] for k in ref], [ref[k] for k in ref], rtol=parity.MOMENTS_RTOL)


def test_median_averages_even_middle_pair_and_quantile_uses_float32_position():
    x = _t([[4.0, 1.0, 3.0, 2.0], [5.0, 5.0, 1.0, 1.0]])
    assert M.median(x).tolist() == [2.5, 3.0]
    assert torch.median(x, dim=-1).values.tolist() == [2.0, 1.0]   # the trap: the lower one
    rng = np.random.default_rng(14)
    for n in (2, 3, 10, 999, 1000):
        v = rng.standard_normal((2, n)).astype(np.float32)
        qs = (0.0, 0.05, 0.25, 0.5, 0.75, 0.95, 0.3, 1.0)
        for q, got in zip(qs, M.sorted_quantiles(_t(v), qs)):
            _close(got, jnp.quantile(jnp.asarray(v), q, axis=-1))
        np.testing.assert_array_equal(M.median(_t(v)).numpy(), np.asarray(jnp.median(jnp.asarray(v), axis=-1)))
    nan_row = _t([[1.0, float("nan"), 2.0], [1.0, 2.0, 3.0]])
    got = M.median(nan_row).numpy()
    assert np.isnan(got[0]) and got[1] == 2.0


def test_quantile_above_2_pow_24_elements():
    n = 2**24 + 1
    v = np.random.default_rng(15).random(n, dtype=np.float32)
    with pytest.raises(RuntimeError):
        torch.quantile(_t(v[:8]).expand(n // 8 + 1, 8).reshape(-1), 0.5)   # the trap
    got = [float(g) for g in M.sorted_quantiles(torch.from_numpy(v), (0.05, 0.5, 0.95))]
    srt = np.sort(v)
    for q, g in zip((0.05, 0.5, 0.95), got):
        pos = np.float32(q) * np.float32(n - 1)
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        w = np.float32(pos - np.floor(pos))
        assert g == np.float32(srt[lo] * (np.float32(1) - w) + srt[hi] * w)


# ------------------------------ percentiles ------------------------------

def test_percentiles_match_jax():
    x = np.random.default_rng(16).standard_normal(257) * 3.0
    for method in JP._HF_METHODS:
        assert P.calculate_percentile(x, 37.5, method) == JP.calculate_percentile(x, 37.5, method)
    assert P.quartiles(x, "hazen") == JP.quartiles(x, "hazen")
    assert P.outlier_fences(x) == JP.outlier_fences(x)
    assert P.analyze(x) == JP.analyze(x)
    assert P.analyze(np.zeros(0)) == {}
    assert P.analyze(np.arange(101.0))["median"] == pytest.approx(50.0)
    with pytest.raises(ValueError):
        P.calculate_percentile(x, 50, "nope")


# ------------------------------ clustering ------------------------------

def _blobs(seed, n=50):
    rng = np.random.default_rng(seed)
    centers = ([0, 0], [10, 10], [-10, 10])
    return np.concatenate([rng.standard_normal((n, 2)) + c for c in centers]).astype(np.float32)


@pytest.mark.parametrize("k,max_iter", [(3, 50), (5, 7)])
def test_kmeans_matches_jax(k, max_iter):
    x = _blobs(17)
    got = C.Clustering("kmeans", num_clusters=k, max_iter=max_iter, seed=1, device=CPU).fit(x)
    ref = JC.Clustering("kmeans", num_clusters=k, max_iter=max_iter, seed=1).fit(x)
    np.testing.assert_array_equal(got.labels, ref.labels)
    _close(got.centroids, ref.centroids, atol=1e-5)
    _close([got.inertia, got.silhouette], [ref.inertia, ref.silhouette])
    assert got.n_iter == ref.n_iter
    if k == 3:
        for grp in (got.labels[:50], got.labels[50:100], got.labels[100:]):
            assert len(np.unique(grp)) == 1
        assert got.silhouette > 0.7


def test_kmeans_empty_cluster_keeps_centroid_and_tensor_input():
    x = _blobs(19, n=20)
    init = np.array([[0, 0], [10, 10], [-10, 10], [100, -100]], np.float32)   # the last gets no point
    labels, cent, inertia = C._lloyd(_t(x), _t(init), 6)
    jl, jc, ji = JC._lloyd(jnp.asarray(x), jnp.asarray(init), 6)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    _close(cent, jc, atol=1e-5)
    assert cent[3].tolist() == [100.0, -100.0]
    _close(inertia, ji)
    got = C.Clustering(num_clusters=3, max_iter=5, seed=2, device=CPU).fit(torch.from_numpy(x))
    np.testing.assert_array_equal(got.labels, JC.Clustering(num_clusters=3, max_iter=5, seed=2).fit(x).labels)


def test_silhouette_subsample_and_unknown_algorithm():
    x = _blobs(18, n=700)
    labels = np.repeat(np.arange(3), 700).astype(np.int32)
    assert C.silhouette_score(x, labels) == JC.silhouette_score(x, labels)
    assert C.silhouette_score(x[:10], np.zeros(10, np.int32)) == 0.0
    with pytest.raises(NotImplementedError):
        C.Clustering("dbscan")


def test_kmeans_more_clusters_than_distinct_points_raises_as_jax():
    # a reference-side fault the port carries (ROADMAP section 3): once
    # every distinct point is a seed, kmeans++'s probabilities are all 0
    x = np.concatenate([np.zeros((20, 2)), np.ones((20, 2)) * 5]).astype(np.float32)
    with pytest.raises(ValueError, match="Probabilities"):
        JC.Clustering(num_clusters=4, max_iter=5, seed=2).fit(x)
    with pytest.raises(ValueError, match="Probabilities"):
        C.Clustering(num_clusters=4, max_iter=5, seed=2, device=CPU).fit(x)


@pytest.mark.parametrize("level", [0.0, 1382.0])
def test_moments_analyze_level_series_within_conditioning_bound(level):
    # a series whose mean is large against its spread: the central
    # moments about two float32 means differ by more than MOMENTS_RTOL,
    # within parity.moments_analyze_atol
    x = (level + 2.0 * np.random.default_rng(19).standard_normal(5164) ** 3).astype(np.float32)
    got, ref = M.analyze(x, device=CPU), JM.analyze(x)
    atol = parity.moments_analyze_atol(x)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=parity.MOMENTS_RTOL, atol=atol.get(k, parity.OPS_ATOL), err_msg=k)
