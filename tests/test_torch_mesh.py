"""The port's mesh (`parallel/mesh.py`), `BatchedFingerprintPipeline`,
the sharded matcher and the sharded comparator passes on the CPU, held to
the JAX package's on its 8-device virtual CPU mesh (tests/conftest.py).
Twins of tests/test_parallel.py:25-145 and of the two sharded cases of
tests/test_device_compare.py:183-222.

The port's mesh is `make_mesh(devices=[torch.device("cpu")] * 8)`: eight
entries on one device, each a shard run in turn. Tolerances: the
sharded pipeline against JAX's takes utils/parity.py's whole-path bounds
(check_features: two float32 DFTs); against the port's own unsharded
step it is bit for bit (the same arithmetic on fewer rows); the matcher
and the comparator take COMPARATOR_PORT_ATOL (1e-6) against JAX, with
the same indices, classes and gates.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from sonido_sonar_tpu.config.config import FeatureConfig as JFeatureConfig  # noqa: E402
from sonido_sonar_tpu.fingerprint import device_compare as JD  # noqa: E402
from sonido_sonar_tpu.parallel import matcher as JM  # noqa: E402
from sonido_sonar_tpu.parallel import mesh as JMS  # noqa: E402
from sonido_sonar_tpu.parallel import pipeline as JP  # noqa: E402
from sonido_sonar_tpu_torch.config.config import FeatureConfig  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import device_compare as TD  # noqa: E402
from sonido_sonar_tpu_torch.parallel import matcher as TM  # noqa: E402
from sonido_sonar_tpu_torch.parallel import mesh as TMS  # noqa: E402
from sonido_sonar_tpu_torch.parallel import pipeline as TP  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

from tests.test_device_compare import _random_corpus  # noqa: E402
from tests.test_goref_parity import _GROUPS  # noqa: E402
from tests.test_torch_device_compare import (  # noqa: E402
    _carry,
    _close_to_jax,
    _comparators,
    _same_matches,
    _same_result,
)

SR = 8000
CPU = torch.device("cpu")
PORT = parity.COMPARATOR_PORT_ATOL


def _mesh(n=8):
    return TMS.make_mesh(devices=[CPU] * n)


def _cfg(cls=FeatureConfig, hop=128):
    return cls(sample_rate=SR, window_size=512, hop_size=hop)


def _pcm(seed=0, b=8):
    return np.random.default_rng(seed).standard_normal((b, 2 * SR)).astype(np.float32) * 0.1


def test_mesh_has_8_entries():
    mesh = _mesh()
    jmesh = JMS.make_mesh()
    assert int(np.prod(list(mesh.shape.values()))) == int(np.prod(list(jmesh.shape.values()))) == 8
    assert mesh.size == 8 and dict(mesh.shape) == {"data": 8} and mesh.axis_names == ("data",)
    assert mesh.local == tuple(range(8)) and mesh.local_devices == [CPU] * 8
    assert not mesh.distributed
    two = TMS.make_mesh(("data", "model"), (4, 2), devices=[CPU] * 8)
    assert dict(two.shape) == {"data": 4, "model": 2} and two.devices.shape == (4, 2)
    with pytest.raises(ValueError, match="shape required"):
        TMS.make_mesh(("data", "model"), devices=[CPU] * 8)
    assert TMS.data_sharding(mesh).spec == ("data",) and TMS.replicated(mesh).spec == ()


def test_make_mesh_without_cuda_raises(monkeypatch):
    """No CUDA device and no `devices`: a RuntimeError, never a CPU mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMS.make_mesh()


def test_sharded_pipeline_matches_jax():
    """The same [8, 16000] batch through both packages' sharded pipelines
    at 512/128: utils/parity.check_features (two float32 DFTs)."""
    pcm = _pcm()
    got = {k: v.numpy() for k, v in TP.BatchedFingerprintPipeline(_mesh(), _cfg())(pcm).items()}
    want = {k: np.asarray(v) for k, v in
            JP.BatchedFingerprintPipeline(JMS.make_mesh(), _cfg(JFeatureConfig))(pcm).items()}
    near = parity.near_zero_frames(pcm, 512, 128, 0.97)
    errors, failures = parity.check_features(got, want, near, SR, 512)
    assert not failures, (failures, errors)


def test_sharded_pipeline_equals_unsharded_step():
    """Eight one-row shards against one [8, N] step: bit for bit; row 3
    against the row alone, as JAX's test holds it."""
    pcm = _pcm(1)
    pipe = TP.BatchedFingerprintPipeline(_mesh(), _cfg())
    got = pipe(pcm)
    want = TP.batched_fingerprint_features(pcm, sample_rate=SR, window_size=512, hop_size=128,
                                           device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device == CPU and torch.equal(got[k], want[k]), k
    single = TP.batched_fingerprint_features(pcm[3:4], sample_rate=SR, window_size=512,
                                             hop_size=128, device="cpu")
    np.testing.assert_allclose(got["mfcc"][3].numpy(), single["mfcc"][0].numpy(), atol=1e-4)
    np.testing.assert_allclose(got["spectral_centroid"][3].numpy(),
                               single["spectral_centroid"][0].numpy(), rtol=1e-5)


def test_one_entry_mesh_runs_the_step_directly():
    """A one-entry mesh is the plain step (JAX pipeline.py:507-513)."""
    pcm = _pcm(2, b=3)
    pipe = TP.BatchedFingerprintPipeline(_mesh(1), _cfg())
    got = pipe(pcm)
    assert pipe._cached_step[1].__name__ == "fn"
    want = TP.batched_fingerprint_features(pcm, sample_rate=SR, window_size=512, hop_size=128,
                                           device="cpu")
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_pipeline_cache_follows_config_and_mesh():
    """The step is cached on (config, id(mesh), axis): the same settings
    reuse it; a replaced config or mesh rebuilds it, so no stale
    features are served (JAX's ADVICE r4 #1)."""
    pcm = _pcm(3)
    pipe = TP.BatchedFingerprintPipeline(_mesh(), _cfg())
    first = pipe(pcm)
    step = pipe._cached_step[1]
    pipe(pcm)
    assert pipe._cached_step[1] is step
    pipe.config = dataclasses.replace(pipe.config, hop_size=256)
    coarse = pipe(pcm)
    assert pipe._cached_step[1] is not step
    assert coarse["mfcc"].shape[1] < first["mfcc"].shape[1]
    want = TP.batched_fingerprint_features(pcm, sample_rate=SR, window_size=512, hop_size=256,
                                           device="cpu")
    assert torch.equal(coarse["mfcc"], want["mfcc"])
    step = pipe._cached_step[1]
    pipe.mesh = _mesh(4)
    assert torch.equal(pipe(pcm)["mfcc"], want["mfcc"]) and pipe._cached_step[1] is not step


def test_uneven_batch_raises():
    """B not a multiple of the mesh size: ValueError, as JAX's device_put
    raises."""
    pcm = _pcm(4, b=6)
    with pytest.raises(ValueError, match="do not divide"):
        TP.BatchedFingerprintPipeline(_mesh(), _cfg())(pcm)
    with pytest.raises(ValueError, match="do not divide"):
        TMS.shard_batch(pcm, _mesh())
    with pytest.raises(ValueError):
        jax.device_put(jnp.asarray(pcm), JMS.data_sharding(JMS.make_mesh()))


def test_shard_batch_and_shard_over_batch():
    """shard_batch puts each entry's rows on its device (replicas of a
    2-D mesh hold the same rows); shard_over_batch returns tensors,
    tuples and dicts in row order."""
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    shards = TMS.shard_batch(x, _mesh())
    assert len(shards) == 8 and all(s.shape == (2, 3) for s in shards)
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    two = TMS.make_mesh(("data", "model"), (4, 2), devices=[CPU] * 8)
    rep = TMS.shard_batch(torch.from_numpy(x), two)
    assert [r[0, 0].item() for r in rep] == [0.0, 0.0, 12.0, 12.0, 24.0, 24.0, 36.0, 36.0]
    assert TMS.local_shards(two) == [(s, CPU) for s in range(4)]
    calls = []

    def fn(a, b):
        calls.append(a.shape[0])
        return {"sum": a + b, "pair": (a * 2, b[:, :1])}

    out = TMS.shard_over_batch(fn, two)(x, torch.from_numpy(x))
    assert calls == [4] * 4
    np.testing.assert_array_equal(out["sum"].numpy(), 2 * x)
    np.testing.assert_array_equal(out["pair"][0].numpy(), 2 * x)
    np.testing.assert_array_equal(out["pair"][1].numpy(), x[:, :1])
    assert isinstance(out["pair"], tuple)
    assert TMS.row_shards(21, _mesh()) == [(CPU, 3 * i, min(3 * i + 3, 21)) for i in range(7)]


def test_batched_pair_alignment_lags():
    """Energy pairs sharded over the mesh: the same lags as JAX's on its
    sharded inputs, and the peak correlations within 1e-5."""
    mesh = _mesh()
    rng = np.random.default_rng(1)
    base = rng.standard_normal((8, 500)).astype(np.float32)
    lags = [0, 2, 5, -3, 7, 1, 4, -6]
    shifted = np.stack([np.roll(base[i], lags[i]) for i in range(8)])
    got = TMS.shard_over_batch(lambda q, r: TP.batched_pair_alignment(q, r, max_lag=16), mesh)(
        base, shifted)
    jmesh = JMS.make_mesh()
    want = JP.batched_pair_alignment(jax.device_put(jnp.asarray(base), JMS.data_sharding(jmesh)),
                                     jax.device_put(jnp.asarray(shifted), JMS.data_sharding(jmesh)),
                                     max_lag=16)
    np.testing.assert_array_equal(got["lag_frames"].numpy(), lags)
    np.testing.assert_array_equal(got["lag_frames"].numpy(), np.asarray(want["lag_frames"]))
    assert (got["peak_correlation"].numpy() > 0.9).all()
    np.testing.assert_allclose(got["peak_correlation"].numpy(), np.asarray(want["peak_correlation"]),
                               atol=1e-5)


@pytest.mark.parametrize("rows,k", [(21, 5), (8, 8), (3, 10), (64, 12)])
def test_sharded_top_k_matches_jax(rows, k):
    """With a mesh, against JAX's with a mesh: equal indices, scores
    within 1e-6; the same ranking as mesh=None, duplicated rows (tied
    scores) lowest index first; rows fewer than the entries included."""
    rng = np.random.default_rng(rows)
    corpus = rng.standard_normal((rows, 44)).astype(np.float32)
    q = corpus[rows // 3] + 0.01 * rng.standard_normal(44).astype(np.float32)
    if rows > 8:
        corpus[[rows - 1, rows // 2]] = corpus[1]
        q = corpus[1].copy()
    idx, scores = TM.sharded_top_k_matches(q, corpus, k=k, mesh=_mesh())
    jidx, jscores = JM.sharded_top_k_matches(q, corpus, k=k, mesh=JMS.make_mesh())
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_allclose(scores, np.asarray(jscores), atol=PORT, rtol=0)
    assert idx.dtype == np.int32 and scores.dtype == np.float32 and len(idx) == min(k, rows)
    pidx, pscores = TM.sharded_top_k_matches(q, corpus, k=k, mesh=None, device="cpu")
    np.testing.assert_array_equal(idx, pidx)
    np.testing.assert_allclose(scores, pscores, atol=PORT, rtol=0)
    if rows > 8:
        assert idx[:3].tolist() == sorted([1, rows // 2, rows - 1])


def test_pad_to_multiple():
    for n, m in ((5, 4), (8, 4), (1, 8)):
        x = np.arange(n * 3.0).reshape(n, 3)
        got, want = TMS.pad_to_multiple(x, m), JMS.pad_to_multiple(x, m)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == n
    padded, n = TMS.pad_to_multiple(np.ones((5, 3)), 4)
    assert padded.shape == (8, 3) and n == 5


def test_run_stream_over_the_pipeline():
    """run_stream takes the pipeline: five batches in order, each equal
    to a blocking call."""
    pipe = TP.BatchedFingerprintPipeline(_mesh(), _cfg())
    batches = [_pcm(10 + i) for i in range(5)]
    outs = list(TP.run_stream(pipe, iter(batches), device="cpu"))
    assert len(outs) == 5
    for out, b in zip(outs, batches):
        direct = pipe(b)
        assert all(torch.equal(out[k], direct[k]) for k in direct)


def _corpus_case(seed):
    rng = np.random.default_rng(seed)
    query = _carry(_random_corpus(rng, 1, present=set(_GROUPS), prefix="q"))[0]
    jcands = _random_corpus(rng, 30)
    return query, _carry(jcands), rng


def test_sharded_corpus_matches_unsharded_and_jax():
    """30 packed rows over 8 entries (4 a shard, the last two shards
    short): the port with a mesh against the port without one and against
    JAX's with a mesh, plain and with the quality chain."""
    query, cands, _ = _corpus_case(13)
    corpus, width = TD.comparator_matrix(cands)
    qv = TD.pack_comparator_stats(query, width)
    wvec = TD.content_weight_vector(query.content_type)
    match = np.arange(len(cands)) % 3 != 0
    jmesh = JMesh(np.array(jax.devices()), ("data",))
    c_avail, c_dur, c_series, c_len = TD.quality_matrix(cands)
    q_avail, q_dur, q_series, q_len = TD.pack_quality_extras(query, c_series.shape[-1])
    quality = (q_avail, q_dur, q_series, q_len, c_avail, c_dur, c_series, c_len)
    for content_filter in (False, True):
        for q in (None, quality):
            kw = dict(num_mfcc_coeffs=width, content_filter=content_filter, quality=q)
            sharded = TD.sharded_batched_similarity(qv, corpus, wvec, match, mesh=_mesh(), **kw)
            plain = TD.sharded_batched_similarity(qv, corpus, wvec, match, mesh=None,
                                                  device="cpu", **kw)
            want = JD.sharded_batched_similarity(qv, corpus, wvec, match, mesh=jmesh, **kw)
            assert all(isinstance(v, np.ndarray) and len(v) == 30 for v in sharded.values())
            _close_to_jax(sharded, want, f"mesh, quality={q is not None}")
            _close_to_jax(plain, JD.sharded_batched_similarity(qv, corpus, wvec, match, **kw),
                          "no mesh")
            assert set(sharded) == set(plain)
            for key in plain:
                np.testing.assert_allclose(sharded[key], plain[key], atol=PORT, rtol=0,
                                           err_msg=key)


def test_sharded_detailed_matches_unsharded():
    """batch_compare_device and find_best_matches with a mesh and the
    quality chain: equal to the same calls without one, and to JAX's with
    a mesh."""
    query, cands, _ = _corpus_case(23)
    tc, jc = _comparators(enable_detailed_metrics=True, similarity_threshold=0.0)
    jmesh = JMesh(np.array(jax.devices()), ("data",))
    plain = tc.batch_compare_device(query, cands)
    sharded = tc.batch_compare_device(query, cands, mesh=_mesh())
    rng = np.random.default_rng(23)
    jquery = _random_corpus(rng, 1, present=set(_GROUPS), prefix="q")[0]
    jcands = _random_corpus(rng, 30)
    want = jc.batch_compare_device(jquery, jcands, mesh=jmesh)
    for a, b, w in zip(plain, sharded, want):
        _same_result(b, a, PORT)
        _same_result(b, w, PORT)
        assert b.quality_metrics is not None and a.quality_metrics is not None
        assert b.quality_metrics.spectral_coherence == pytest.approx(
            a.quality_metrics.spectral_coherence, abs=PORT)
        assert b.quality_metrics.spectral_coherence == pytest.approx(
            w.quality_metrics.spectral_coherence, abs=parity.COMPARATOR_COHERENCE_ATOL)
    _same_matches(tc.find_best_matches(query, cands, max_results=10, mesh=_mesh()),
                  tc.find_best_matches(query, cands, max_results=10), PORT)
    _same_matches(tc.find_best_matches(query, cands, max_results=10, mesh=_mesh()),
                  jc.find_best_matches(jquery, jcands, max_results=10, mesh=jmesh), PORT)


def test_find_best_matches_with_a_mesh_takes_the_full_pass(monkeypatch):
    """Without detailed metrics a mesh still sends the query to the
    full-[C] pass (JAX comparison.py:485-492), not the packed top-k."""
    query, cands, _ = _corpus_case(31)
    tc, _ = _comparators(similarity_threshold=0.0)
    seen = []
    real = tc.batch_compare_device
    monkeypatch.setattr(tc, "batch_compare_device",
                        lambda q, c, mesh=None: seen.append(mesh) or real(q, c, mesh=mesh))
    mesh = _mesh()
    got = tc.find_best_matches(query, cands, max_results=8, mesh=mesh)
    assert seen == [mesh]
    _same_matches(got, tc.find_best_matches(query, cands, max_results=8), parity.COMPARATOR_HOST_ATOL)
