"""The port's device comparator (`fingerprint/device_compare.py` and the
device-facing half of `fingerprint/comparison.py`) on the CPU: a twin of
each case of tests/test_device_compare.py, held to the port's own host
comparator (utils/parity.COMPARATOR_HOST_ATOL and the quality bounds)
and to the JAX package's device functions on the same corpus
(COMPARATOR_PORT_ATOL; match classes, gates and top-k indices equal).
The two sharded cases are twinned in tests/test_torch_mesh.py. Added: the
order of tied scores with duplicate rows (lowest index first, as JAX),
a one-frame series (std 0, not NaN) and the TF32 guard.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.config import config as jconfig  # noqa: E402
from sonido_sonar_tpu.extractors import features as jfeat  # noqa: E402
from sonido_sonar_tpu.fingerprint import comparison as JC  # noqa: E402
from sonido_sonar_tpu.fingerprint import device_compare as J  # noqa: E402
from sonido_sonar_tpu.fingerprint import generator as jgen  # noqa: E402
from sonido_sonar_tpu_torch.config import config as tconfig  # noqa: E402
from sonido_sonar_tpu_torch.extractors import features as tfeat  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import comparison as TC  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import device_compare as T  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import generator as tgen  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402
from sonido_sonar_tpu_torch.utils.convert import fingerprint_from_reference  # noqa: E402

from tests.test_device_compare import _random_corpus  # noqa: E402
from tests.test_goref_parity import _GROUPS  # noqa: E402

TOL = parity.COMPARATOR_HOST_ATOL
PORT = parity.COMPARATOR_PORT_ATOL
QUALITY = parity.COMPARATOR_QUALITY_ATOL
ALL = set(_GROUPS)
NEWS, MUSIC, MIXED = jconfig.ContentType.NEWS, jconfig.ContentType.MUSIC, jconfig.ContentType.MIXED


def _carry(fps):
    return [None if fp is None else fingerprint_from_reference(fp) for fp in fps]


def _comparators(**kw):
    """(port comparator on the CPU, JAX comparator), one config."""
    return (TC.FingerprintComparator(tconfig.ComparisonConfig(**kw), device="cpu"),
            JC.FingerprintComparator(jconfig.ComparisonConfig(**kw)))


def _numpy(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _close_to_jax(got, want, what=""):
    """A port device result (tensors) against JAX's (same keys): floats
    within COMPARATOR_PORT_ATOL, ints and bools equal, same dtypes."""
    got, want = _numpy(got), _numpy(jax.device_get(want))
    assert set(got) == set(want), what
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, (what, k)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got[k], w, atol=PORT, rtol=0, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")


def _same_matches(got, want, tol=TOL):
    assert [m.fingerprint.id for m in got] == [m.fingerprint.id for m in want]
    for a, b in zip(got, want):
        assert a.rank == b.rank
        assert a.similarity.overall_similarity == pytest.approx(b.similarity.overall_similarity, abs=tol)
        assert a.similarity.confidence == pytest.approx(b.similarity.confidence, abs=tol)
        assert a.similarity.match_type == b.similarity.match_type
        assert set(a.similarity.feature_distances) == set(b.similarity.feature_distances)
        for k, v in b.similarity.feature_distances.items():
            assert a.similarity.feature_distances[k] == pytest.approx(v, abs=tol), k


def _same_result(r, want, tol=TOL):
    assert r.overall_similarity == pytest.approx(want.overall_similarity, abs=tol), want.fingerprint2_id
    assert r.feature_similarity == pytest.approx(want.feature_similarity, abs=tol)
    assert r.confidence == pytest.approx(want.confidence, abs=tol)
    assert r.match_type == want.match_type
    assert r.content_type_match == want.content_type_match
    assert set(r.feature_distances) == set(want.feature_distances)
    for k, v in want.feature_distances.items():
        assert r.feature_distances[k] == pytest.approx(v, abs=tol), k


@pytest.mark.parametrize("content_filter", [False, True])
def test_device_compare_matches_host(content_filter):
    rng = np.random.default_rng(10)
    tc, jc = _comparators(enable_content_filter=content_filter)
    jquery = _random_corpus(rng, 1, content=NEWS, present=ALL)[0]
    jcands = _random_corpus(rng, 64)
    query, cands = fingerprint_from_reference(jquery), _carry(jcands)
    got = tc.batch_compare_device(query, cands)
    assert len(got) == len(cands)
    for cand, r, jr in zip(cands, got, jc.batch_compare_device(jquery, jcands)):
        _same_result(r, tc.compare(query, cand))
        _same_result(r, jr, PORT)


def test_device_compare_many_random_pairs():
    rng = np.random.default_rng(11)
    tc, jc = _comparators()
    jqueries, jcands = _random_corpus(rng, 10, prefix="q"), _random_corpus(rng, 100)
    queries, cands = _carry(jqueries), _carry(jcands)
    for q, jq in zip(queries, jqueries):
        got = tc.batch_compare_device(q, cands)
        for r, jr in zip(got, jc.batch_compare_device(jq, jcands)):
            _same_result(r, jr, PORT)
        for i in range(0, len(cands), 3):
            try:
                want = tc.compare(q, cands[i])
            except ValueError:
                # no comparable features: the host errors and BatchCompare
                # would skip; the device path reports 0
                assert got[i].overall_similarity == 0.0
                continue
            assert got[i].overall_similarity == pytest.approx(want.overall_similarity, abs=TOL)
            assert got[i].confidence == pytest.approx(want.confidence, abs=TOL)


def test_find_best_matches_device_end_to_end():
    rng = np.random.default_rng(12)
    tc, jc = _comparators(similarity_threshold=0.0)
    jquery = _random_corpus(rng, 1, content=MUSIC, present=ALL)[0]
    jcands = _random_corpus(rng, 40, content=MUSIC, present=ALL)
    query, cands = fingerprint_from_reference(jquery), _carry(jcands)
    dev = tc.find_best_matches(query, cands, max_results=10)
    _same_matches(dev, tc.find_best_matches(query, cands, max_results=10, use_device_prefilter=False))
    _same_matches(dev, jc.find_best_matches(jquery, jcands, max_results=10), PORT)


@pytest.mark.parametrize("content_filter", [False, True])
def test_device_detailed_metrics_match_host(content_filter):
    """The quality chain against the port's host path (constant series,
    mixed availability, zero dynamic range) and against JAX's device
    pass."""
    rng = np.random.default_rng(21)
    tc, jc = _comparators(enable_detailed_metrics=True, enable_content_filter=content_filter)
    jquery = _random_corpus(rng, 1, content=MIXED, present=ALL, prefix="q")[0]
    jcands = _random_corpus(rng, 64)
    sf = jcands[0].features.spectral_features
    if sf is not None and sf.spectral_centroid is not None:
        sf.spectral_centroid = np.full_like(np.asarray(sf.spectral_centroid, dtype=np.float64), 1234.5)
    query, cands = fingerprint_from_reference(jquery), _carry(jcands)
    got = tc.batch_compare_device(query, cands)
    for cand, r, jr in zip(cands, got, jc.batch_compare_device(jquery, jcands)):
        want = tc.compare(query, cand)
        assert r.overall_similarity == pytest.approx(want.overall_similarity, abs=TOL), cand.id
        assert r.overall_similarity == pytest.approx(jr.overall_similarity, abs=PORT)
        assert r.confidence == pytest.approx(jr.confidence, abs=PORT)
        if want.quality_metrics is None:
            assert r.quality_metrics is None and jr.quality_metrics is None
            continue
        qm, wm = r.quality_metrics, want.quality_metrics
        assert qm.data_availability == pytest.approx(wm.data_availability, abs=TOL)
        assert qm.feature_coverage == pytest.approx(wm.feature_coverage, abs=TOL)
        for k in ("temporal_alignment", "noise_level", "dynamic_range_match"):
            assert getattr(qm, k) == pytest.approx(getattr(wm, k), abs=QUALITY), k
        assert qm.spectral_coherence == pytest.approx(
            wm.spectral_coherence, abs=parity.COMPARATOR_COHERENCE_ATOL), cand.id
        assert r.confidence == pytest.approx(want.confidence, abs=QUALITY)
        for k, v in dataclasses.asdict(jr.quality_metrics).items():
            assert getattr(qm, k) == pytest.approx(v, abs=PORT), k


def test_find_best_matches_detailed_stays_on_device(monkeypatch):
    rng = np.random.default_rng(22)
    tc, jc = _comparators(enable_detailed_metrics=True, similarity_threshold=0.0)
    jquery = _random_corpus(rng, 1, present=ALL, prefix="q")[0]
    jcands = _random_corpus(rng, 24, present=ALL)
    query, cands = fingerprint_from_reference(jquery), _carry(jcands)

    def _boom(*a, **k):  # host loop must not run
        raise AssertionError("detailed-metrics config routed to host loop")

    monkeypatch.setattr(tc, "batch_compare", _boom)
    dev = tc.find_best_matches(query, cands, max_results=10)
    assert len(dev) == 10 and all(m.similarity.quality_metrics is not None for m in dev)
    host = TC.FingerprintComparator(
        tconfig.ComparisonConfig(enable_detailed_metrics=True, similarity_threshold=0.0), device="cpu"
    ).find_best_matches(query, cands, max_results=10, use_device_prefilter=False)
    assert [m.fingerprint.id for m in dev] == [m.fingerprint.id for m in host]
    for a, b in zip(dev, host):
        assert a.similarity.confidence == pytest.approx(b.similarity.confidence, abs=QUALITY)
    _same_matches(dev, jc.find_best_matches(jquery, jcands, max_results=10), PORT)


def test_skip_self_and_none():
    rng = np.random.default_rng(14)
    tc, _ = _comparators(similarity_threshold=0.0)
    query = _carry(_random_corpus(rng, 1, present=ALL, prefix="q"))[0]
    cands = _carry(_random_corpus(rng, 5, present=ALL))
    matches = tc.find_best_matches(query, [None, query] + cands)
    assert query.id not in {m.fingerprint.id for m in matches}
    assert len(matches) == 5


def test_constant_series_rounding_noise_excluded():
    """A series the host sees as exactly constant (NaN corr, skipped)
    stays skipped in float32 (device_compare's constant-series floor)."""
    rng = np.random.default_rng(33)
    tc, jc = _comparators(enable_detailed_metrics=True)
    jquery = _random_corpus(rng, 1, content=MUSIC, present={"spectral"}, prefix="q")[0]
    jcand = _random_corpus(rng, 1, content=MUSIC, present={"spectral"})[0]
    n = 430
    qsf, csf = jquery.features.spectral_features, jcand.features.spectral_features
    qsf.spectral_centroid = rng.uniform(4000, 6000, size=n)
    qsf.spectral_rolloff = 732.0 + rng.normal(0, 1.5, size=n)
    qsf.spectral_flux = rng.uniform(0, 2, size=n)
    csf.spectral_centroid = rng.uniform(4000, 6000, size=n)
    csf.spectral_rolloff = np.full(n, 818.2999877929688)  # host var == 0
    csf.spectral_flux = rng.uniform(0, 2, size=n)
    query, cand = _carry([jquery, jcand])
    want = tc.compare(query, cand).quality_metrics
    got = tc.batch_compare_device(query, [cand])[0].quality_metrics
    assert got.spectral_coherence == pytest.approx(want.spectral_coherence,
                                                   abs=parity.COMPARATOR_COHERENCE_ATOL)
    jgot = jc.batch_compare_device(jquery, [jcand])[0].quality_metrics
    assert got.spectral_coherence == pytest.approx(jgot.spectral_coherence, abs=PORT)


def _multi_inputs(rng, nq, nc, **kw):
    queries, cands = _carry(_random_corpus(rng, nq, prefix="q", **kw)), _carry(_random_corpus(rng, nc))
    corpus, k = T.comparator_matrix(cands)
    qmat, _ = T.comparator_matrix(queries, num_mfcc_coeffs=k)
    weights = np.stack([T.content_weight_vector(q.content_type) for q in queries])
    q_codes = np.array([T.content_code(q.content_type) for q in queries], np.int32)
    c_codes = np.array([T.content_code(c.content_type) for c in cands], np.int32)
    return qmat, corpus, weights, q_codes, c_codes, k


@pytest.mark.parametrize("content_filter", [False, True])
def test_multi_query_matches_single(content_filter):
    """batched_similarity_multi row i == batched_similarity(query i), and
    each equals JAX's."""
    rng = np.random.default_rng(21)
    qmat, corpus, weights, q_codes, c_codes, k = _multi_inputs(rng, 6, 97)
    kw = dict(num_mfcc_coeffs=k, content_filter=content_filter)
    multi = T.batched_similarity_multi(qmat, corpus, weights, q_codes, c_codes, device="cpu", **kw)
    _close_to_jax(multi, J.batched_similarity_multi(qmat, corpus, weights, q_codes, c_codes, **kw),
                  "multi")
    for i in range(len(qmat)):
        match = q_codes[i] == c_codes
        single = T.batched_similarity(qmat[i], corpus, weights[i], match, device="cpu", **kw)
        _close_to_jax(single, J.batched_similarity(qmat[i], corpus, weights[i], match, **kw), "single")
        row = {key: v[i] for key, v in multi.items()}
        for key in ("overall", "confidence", "feature_sims"):
            np.testing.assert_allclose(row[key].numpy(), single[key].numpy(), atol=TOL, rtol=0)
        for key in ("match_class", "feature_present"):
            np.testing.assert_array_equal(row[key].numpy(), single[key].numpy())


def test_find_best_matches_multi_end_to_end():
    rng = np.random.default_rng(22)
    tc, jc = _comparators(similarity_threshold=0.1)
    jqueries = _random_corpus(rng, 4, prefix="q")
    jcands = _random_corpus(rng, 50) + [jqueries[0]]  # one query also in the corpus
    queries = _carry(jqueries)
    cands = _carry(jcands[:-1]) + [queries[0]]
    multi = tc.find_best_matches_multi(queries, [None] + cands)
    jmulti = jc.find_best_matches_multi(jqueries, [None] + jcands)
    assert len(multi) == len(queries)
    for q, got, jgot in zip(queries, multi, jmulti):
        _same_matches(got, tc.find_best_matches(q, [None] + cands))
        _same_matches(got, jgot, PORT)


def test_search_corpus_matches_host_path():
    rng = np.random.default_rng(21)
    tc, jc = _comparators(similarity_threshold=0.0)
    jquery = _random_corpus(rng, 1, content=NEWS, present=ALL)[0]
    jcands = _random_corpus(rng, 48, content=NEWS, present=ALL)
    query, cands = fingerprint_from_reference(jquery), _carry(jcands)
    packed = T.PackedCorpus.build([query] + cands, device="cpu")  # self included
    assert packed.matrix.dtype == torch.float32 and packed.codes.dtype == torch.int32
    got = tc.search_corpus(query, packed, max_results=8)
    _same_matches(got, tc.find_best_matches(query, cands, max_results=8, use_device_prefilter=False))
    _same_matches(got, jc.search_corpus(jquery, J.PackedCorpus.build([jquery] + jcands), 8), PORT)
    assert tc.search_corpus(query, T.PackedCorpus([], packed.matrix[:0], packed.codes[:0], 13)) == []


def test_topk_multi_matches_full_multi():
    """Fleet top-k equals the stable order of the full [Q, C] pass, and
    JAX's top-k: indices equal."""
    rng = np.random.default_rng(22)
    qmat, corpus, _, _, _, width = _multi_inputs(rng, 4, 200, present=ALL)
    wmat = np.tile(np.array([0.35, 0.25, 0.10, 0.20, 0.10, 0.10], np.float32), (4, 1))
    q_codes, c_codes = np.zeros(4, np.int32), np.zeros(len(corpus), np.int32)
    args = (qmat, corpus, wmat, q_codes, c_codes)
    full = _numpy(T.batched_similarity_multi(*args, num_mfcc_coeffs=width, device="cpu"))
    topk = T.topk_similarity_multi(*args, k=5, num_mfcc_coeffs=width, device="cpu")
    _close_to_jax(topk, J.topk_similarity_multi(*args, k=5, num_mfcc_coeffs=width), "topk multi")
    topk = _numpy(topk)
    for qi in range(4):
        order = np.argsort(-full["overall"][qi], kind="stable")[:5]
        np.testing.assert_array_equal(topk["index"][qi], order)
        np.testing.assert_array_equal(topk["overall"][qi], full["overall"][qi][order])
        np.testing.assert_array_equal(topk["feature_sims"][qi], full["feature_sims"][qi][order])


def _synthetic_batch(rng, one_frame: bool):
    """A two-group FingerprintBatch of each package on the same numpy
    features ([G, ...] leaves): group 0 (clips 0, 2, 3) has every packed
    field, group 1 (clips 1, 4) no chroma and no speech; `one_frame`
    gives group 1 one-frame series."""
    def arrays(g, t, full):
        a = {"mfcc": rng.normal(size=(g, t, 13)).astype(np.float32),
             "spectral_features": {k: rng.uniform(100, 4000, size=(g, t)).astype(np.float32)
                                   for k in ("spectral_centroid", "spectral_rolloff", "spectral_flux")},
             "temporal_features": {"rms_energy": rng.uniform(0, 1, (g, t)).astype(np.float32),
                                   "dynamic_range": rng.uniform(0, 60, g).astype(np.float32),
                                   "silence_ratio": rng.uniform(0, 1, g).astype(np.float32),
                                   "onset_density": rng.uniform(0, 5, g).astype(np.float32)},
             "harmonic_features": {"harmonic_ratio": rng.uniform(0, 1, (g, t)).astype(np.float32),
                                   "pitch_estimate": rng.uniform(80, 400, (g, t)).astype(np.float32)}}
        if full:
            a["chroma_features"] = rng.uniform(0, 1, (g, t, 12)).astype(np.float32)
            a["speech_features"] = {"speech_rate": rng.uniform(1, 6, g).astype(np.float32),
                                    "vocal_tract_length": rng.uniform(12, 20, g).astype(np.float32),
                                    "voicing_probability": rng.uniform(0, 1, (g, t)).astype(np.float32)}
        return a

    subs = {"spectral_features": "SpectralFeatures", "temporal_features": "TemporalFeatures",
            "harmonic_features": "HarmonicFeatures", "speech_features": "SpeechFeatures"}

    def build(mod, a, leaf):
        kw = {k: getattr(mod, subs[k])(**{n: leaf(x) for n, x in v.items()}) if k in subs else leaf(v)
              for k, v in a.items()}
        return mod.ExtractedFeatures(**kw)

    groups = [(jconfig.ContentType.NEWS, [0, 2, 3], arrays(3, 23, True)),
              (jconfig.ContentType.MUSIC, [1, 4], arrays(2, 1 if one_frame else 17, False))]

    def fingerprints(gen_mod, ct_of):
        fps = [None] * 5
        for ct, idxs, _ in groups:
            for i in idxs:
                fps[i] = gen_mod.AudioFingerprint(f"c{i}", "", ct_of(ct), 0.0, 30.0, 44100, 256, 1, None)
        return fps

    tb = tgen.FingerprintBatch(
        fingerprints(tgen, lambda ct: tconfig.ContentType(ct.value)),
        [(tconfig.ContentType(ct.value), idxs, build(tfeat, a, torch.from_numpy)) for ct, idxs, a in groups])
    jb = jgen.FingerprintBatch(
        fingerprints(jgen, lambda ct: ct), [(ct, idxs, build(jfeat, a, jnp.asarray)) for ct, idxs, a in groups])
    return tb, jb


@pytest.mark.parametrize("one_frame", [False, True])
def test_packed_corpus_from_batch_matches_host_pack(one_frame):
    """PackedCorpus.from_batch (the pack of a device-resident batch, two
    groups put back in clip order) equals the host packer over the
    materialized fingerprints (scaled 2e-4) and JAX's from_batch (scaled
    COMPARATOR_PORT_ATOL), with PackedCorpus.build's codes; a one-frame
    series packs a std of 0, not NaN."""
    tb, jb = _synthetic_batch(np.random.default_rng(31), one_frame)
    dev = T.PackedCorpus.from_batch(tb, 13)
    assert dev.matrix is tb.comparator_matrix(13)  # cached
    jdev = J.PackedCorpus.from_batch(jb, 13)
    host = T.PackedCorpus.build(tb.materialize(), 13, device="cpu")
    got, want = dev.matrix.numpy(), host.matrix.numpy()
    assert got.shape == (5, T.layout_size(13)) and np.isfinite(got).all()
    scale = np.maximum(np.abs(want), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=parity.COMPARATOR_PACK_SCALED_ATOL, rtol=0)
    np.testing.assert_allclose(got / scale, np.asarray(jdev.matrix) / scale, atol=PORT, rtol=0)
    np.testing.assert_array_equal(dev.codes.numpy(), host.codes.numpy())
    np.testing.assert_array_equal(dev.codes.numpy(), np.asarray(jdev.codes))
    if one_frame:
        off = T._offsets(13)
        stds = [off["mfcc"] + 13 + c for c in range(13)] + [off["spectral"] + 1, off["temporal"] + 4,
                                                             off["harmonic"] + 1, off["harmonic"] + 4]
        assert (got[[1, 4]][:, stds] == 0).all()


def test_search_corpus_stream_matches_sequential():
    rng = np.random.default_rng(23)
    tc, jc = _comparators(similarity_threshold=0.0)
    jqueries = _random_corpus(rng, 6, prefix="q", present=ALL, content=MUSIC)
    jcands = _random_corpus(rng, 64, content=MUSIC, present=ALL)
    queries, cands = _carry(jqueries), _carry(jcands)
    packed = T.PackedCorpus.build(cands, device="cpu")
    streamed = list(tc.search_corpus_stream(iter(queries), packed, max_results=5, depth=2))
    jstreamed = list(jc.search_corpus_stream(jqueries, J.PackedCorpus.build(jcands), max_results=5, depth=2))
    assert len(streamed) == len(queries)
    for q, got, jgot in zip(queries, streamed, jstreamed):
        _same_matches(got, tc.search_corpus(q, packed, max_results=5), 0.0)
        _same_matches(got, jgot, PORT)


def test_topk_ties_lowest_index_first():
    """Duplicate fingerprints (re-runs of one clip) tie exactly: the port
    gives them lowest index first, as JAX's exact selection, through
    topk_similarity, topk_similarity_multi and search_corpus, whose self
    skip then drops only the query's own id."""
    rng = np.random.default_rng(41)
    jbase = _random_corpus(rng, 24, content=NEWS, present=ALL)
    dup = [3, 7, 11, 19]
    jcands = list(jbase)
    for i in dup:
        jcands[i] = dataclasses.replace(jbase[0], id=f"dup{i}")   # four re-runs of clip 0
    cands = _carry(jcands)
    corpus, width = T.comparator_matrix(cands)
    q = corpus[0]
    w = T.content_weight_vector(tconfig.ContentType.NEWS)
    match = np.ones(len(cands), bool)
    got = T.topk_similarity(q, corpus, w, match, k=8, num_mfcc_coeffs=width, device="cpu")
    want = J.topk_similarity(q, corpus, w, match, k=8, num_mfcc_coeffs=width)
    _close_to_jax(got, want, "topk")
    assert got["index"][:5].tolist() == [0] + dup
    assert len(set(got["overall"][:5].tolist())) == 1
    qcodes = np.zeros(3, np.int32)
    multi = T.topk_similarity_multi(corpus[[0, 3, 5]], corpus, np.tile(w, (3, 1)), qcodes,
                                    np.zeros(len(cands), np.int32), k=8, num_mfcc_coeffs=width,
                                    device="cpu")
    jmulti = J.topk_similarity_multi(corpus[[0, 3, 5]], corpus, np.tile(w, (3, 1)), qcodes,
                                     np.zeros(len(cands), np.int32), k=8, num_mfcc_coeffs=width)
    _close_to_jax(multi, jmulti, "topk multi")
    assert multi["index"][1, :5].tolist() == [0] + dup
    tc, jc = _comparators(similarity_threshold=0.0)
    matches = tc.search_corpus(cands[0], T.PackedCorpus.build(cands, device="cpu"), max_results=6)
    assert [m.fingerprint.id for m in matches][:4] == [f"dup{i}" for i in dup]
    _same_matches(matches, jc.search_corpus(jcands[0], J.PackedCorpus.build(jcands), 6), PORT)


def test_tf32_guard():
    """On a CUDA corpus the selector matmuls raise while TF32 matmuls are
    on (checked here through the guard itself); on the CPU the flag
    changes nothing."""
    from types import SimpleNamespace

    from sonido_sonar_tpu_torch.utils.device import require_fp32_matmuls

    rng = np.random.default_rng(51)
    qmat, corpus, weights, q_codes, c_codes, k = _multi_inputs(rng, 2, 16)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = T.batched_similarity(qmat[0], corpus, weights[0], q_codes[0] == c_codes, k, device="cpu")
        torch.backends.cuda.matmul.allow_tf32 = True
        on = T.batched_similarity(qmat[0], corpus, weights[0], q_codes[0] == c_codes, k, device="cpu")
        T.batched_similarity_multi(qmat, corpus, weights, q_codes, c_codes, k, device="cpu")
        with pytest.raises(ValueError, match="allow_tf32"):
            require_fp32_matmuls(SimpleNamespace(is_cuda=True), "batched_similarity")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    for key in off:
        assert torch.equal(off[key], on[key]), key
    require_fp32_matmuls(SimpleNamespace(is_cuda=True), "batched_similarity")  # off again: no raise
