"""The port's alignment stack held to the JAX package on the CPU:
correlation and NCC, the batch scorers, xcorr / DTW / hybrid batch
alignment, batched_align_audio (verify None, True, False; refine), the
GCC-PHAT helpers, AlignmentAnalyzer and AlignmentExtractor.

Geometry of tests/test_batched_alignment.py (SR 8000, window 512, hop
128; harmonic tone plus noise under a random envelope, delayed copies).
Integer offsets and methods must be equal; confidence, similarity and
quality within utils/parity.ALIGN_SCORE_ATOL.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.config.config import FeatureConfig as JFeatureConfig  # noqa: E402
from sonido_sonar_tpu.extractors import alignment as jext  # noqa: E402
from sonido_sonar_tpu.extractors.features import EnergyFeatures as JEnergy  # noqa: E402
from sonido_sonar_tpu.extractors.features import ExtractedFeatures as JFeatures  # noqa: E402
from sonido_sonar_tpu.io.synth import harmonic_tone, shift_signal, white_noise  # noqa: E402
from sonido_sonar_tpu.ops.stats import alignment as jal  # noqa: E402
from sonido_sonar_tpu.ops.stats import batched_alignment as jba  # noqa: E402
from sonido_sonar_tpu.ops.stats import correlation as jcorr  # noqa: E402
from sonido_sonar_tpu.ops.temporal import short_time_energy  # noqa: E402
from sonido_sonar_tpu.parallel import pipeline as jpipe  # noqa: E402
from sonido_sonar_tpu_torch.config.config import FeatureConfig  # noqa: E402
from sonido_sonar_tpu_torch.extractors import alignment as text  # noqa: E402
from sonido_sonar_tpu_torch.extractors.features import EnergyFeatures, ExtractedFeatures  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import alignment as tal  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import batched_alignment as tba  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import correlation as tcorr  # noqa: E402
from sonido_sonar_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from sonido_sonar_tpu_torch.utils.parity import ALIGN_SCORE_ATOL  # noqa: E402

torch.set_num_threads(1)
SR = 8000
WINDOW, HOP = 512, 128


def _pair(lag, noise, seed, dur=6.0, gain=0.9):
    src = (harmonic_tone(220.0, dur, SR) + white_noise(dur, SR, 0.05, seed=seed)).astype(np.float32)
    rng = np.random.default_rng(seed)
    env = np.interp(np.arange(len(src)), np.linspace(0, len(src), 48),
                    rng.uniform(0.1, 1.0, 48)).astype(np.float32)
    src = src * env
    cdn = shift_signal(src, lag, noise=noise, gain=gain, seed=seed + 1)
    return src, cdn


def _energies(pairs):
    e = [[np.asarray(short_time_energy(jnp.asarray(x), WINDOW, HOP)) for x in p] for p in pairs]
    return np.stack([x[0] for x in e]), np.stack([x[1] for x in e])


def _walks(seed, lags, t=256):
    """Random-walk series and their rolled copies: the correlation gate
    fails on some, so DTW decides."""
    rng = np.random.default_rng(seed)
    qs, rs = [], []
    for lag in lags:
        base = rng.standard_normal(t).astype(np.float32).cumsum()
        base = (base - base.mean()) / (base.std() + 1e-6)
        qs.append(base)
        rs.append(np.roll(base, lag))
    return np.stack(qs), np.stack(rs)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(got: dict, want: dict, ints=("offset_samples", "method"), keys=None):
    for key in keys or want:
        g = got[key].numpy() if isinstance(got[key], torch.Tensor) else np.asarray(got[key])
        w = np.asarray(want[key])
        if key in ints or w.dtype.kind in "bi":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       atol=ALIGN_SCORE_ATOL, err_msg=key)


CASES = [(137, 0.01), (1000, 0.05), (2500, 0.1), (-1800, 0.02)]


@pytest.fixture(scope="module")
def energies():
    return _energies([_pair(lag, noise, 30 + i) for i, (lag, noise) in enumerate(CASES)])


def test_ncc_and_peak_metrics_match_jax(energies):
    eq, er = energies
    max_lag = eq.shape[-1] // 2
    j = jal._ncc_arrays(jnp.asarray(eq[0]), jnp.asarray(er[0]), max_lag, eq.shape[-1], er.shape[-1])
    t = tal._ncc_arrays(_t(eq), _t(er), max_lag, eq.shape[-1], er.shape[-1])
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j), atol=1e-5)
    jm = jcorr._peak_metrics(j, max_lag, eq.shape[-1], er.shape[-1])
    tm = tcorr._peak_metrics(t, max_lag, eq.shape[-1], er.shape[-1])
    for name, a, b in zip(("peak", "lag", "index", "p", "snr", "sharp", "second", "psl", "ov"),
                          tm, jm):
        np.testing.assert_allclose(a[0].numpy().astype(np.float64), float(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    jr = jal.ncc_overlap(jnp.asarray(eq[1]), jnp.asarray(er[1]), 40)
    tr = tal.ncc_overlap(_t(eq[1]), _t(er[1]), 40)
    assert tal.correlation_confidence(tr) == pytest.approx(jal.correlation_confidence(jr), abs=1e-5)
    assert tal.correlation_quality(tr, 40) == pytest.approx(jal.correlation_quality(jr, 40),
                                                            abs=1e-5)
    assert tal.comb_ambiguity(tr.correlations, int(tr.peak_index), 6) == pytest.approx(
        jal.comb_ambiguity(np.asarray(jr.correlations), int(jr.peak_index), 6), abs=1e-5)


@pytest.mark.parametrize("method", ["fft", "time"])
def test_cross_correlate_and_autocorrelate_match_jax(method):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 300)).astype(np.float32)
    y = rng.normal(size=(2, 280)).astype(np.float32)
    j = jcorr.cross_correlate(jnp.asarray(x), jnp.asarray(y), 30, method=method)
    t = tcorr.cross_correlate(_t(x), _t(y), 30, method=method)
    np.testing.assert_allclose(t.correlations.numpy(), np.asarray(j.correlations), atol=2e-5)
    np.testing.assert_array_equal(t.peak_lag.numpy(), np.asarray(j.peak_lag))
    ja, ta = jcorr.autocorrelate(jnp.asarray(x[0]), 10), tcorr.autocorrelate(_t(x[0]), 10)
    assert int(ta.peak_lag) == int(ja.peak_lag) == 0


def test_batch_scorers_match_jax(energies):
    eq, er = energies
    max_lag = 200
    j = jal.ncc_overlap(jnp.asarray(eq), jnp.asarray(er), max_lag)
    args = ("peak_correlation", "sharpness", "peak_to_sidelobe", "snr", "second_peak")
    jc = jba.correlation_confidence_batch(*(getattr(j, a) for a in args))
    tc = tba.correlation_confidence_batch(*(_t(getattr(j, a)) for a in args))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    qargs = ("peak_correlation", "sharpness", "peak_to_sidelobe", "snr", "peak_lag")
    jq = jba.correlation_quality_batch(*(getattr(j, a) for a in qargs), max_lag)
    tq = tba.correlation_quality_batch(*(_t(getattr(j, a)) for a in qargs), max_lag)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)


def test_xcorr_align_batch_matches_jax(energies):
    eq, er = energies
    max_lag = eq.shape[-1] // 2
    t1, t2 = eq.shape[-1], er.shape[-1]
    j = jba.xcorr_align_batch(jnp.asarray(eq), jnp.asarray(er), max_lag, HOP, t1, t2,
                              min_sep=6, top_k=5)
    t = tba.xcorr_align_batch(_t(eq), _t(er), max_lag, HOP, t1, t2, min_sep=6, top_k=5)
    assert sorted(t) == sorted(j)
    _same(t, j, ints=("offset_samples", "peak_lag", "topk_lags"))


def test_dtw_align_batch_matches_jax():
    q, r = _walks(20, [10, 40, -25])
    j = jba.dtw_align_batch(jnp.asarray(q), jnp.asarray(r), 64, HOP, 256, 256)
    t = tba.dtw_align_batch(_t(q), _t(r), 64, HOP, 256, 256)
    assert sorted(t) == sorted(j)
    _same(t, j, keys=("offset_samples", "confidence", "similarity", "quality", "stability",
                      "offset_consistency"))
    np.testing.assert_allclose(t["distance"].numpy(), np.asarray(j["distance"]), rtol=1e-5)


def test_masked_median_takes_the_two_middle_values():
    """An even interior count with middles -4 and -3: the JAX median is
    -3.5 and its truncated offset -3, where the lower median would give
    -4. The same median feeds the offset-consistency gate."""
    disp = torch.tensor([[-9.0, -4.0, -3.0, 7.0, 100.0], [1.0, 2.0, 3.0, 4.0, 5.0]])
    mask = torch.tensor([[True, True, True, True, False], [False] * 5])
    med = tba.masked_median(disp, mask)
    assert med[0].item() == -3.5 and torch.isnan(med[1])
    assert int(torch.trunc(med[0])) == -3
    want = np.asarray(jnp.nanmedian(jnp.where(jnp.asarray(mask.numpy()),
                                              jnp.asarray(disp.numpy()), jnp.nan), axis=-1))
    assert want[0] == -3.5 and np.isnan(want[1])
    # through the path scorer: interior displacements -4, -4, -3, -3
    qs = torch.tensor([[0, 5, 6, 7, 8, 9]], dtype=torch.int32)
    rs = torch.tensor([[0, 1, 2, 4, 5, 9]], dtype=torch.int32)
    cs = torch.ones((1, 6))
    length = torch.tensor([6], dtype=torch.int32)
    got = tba._dtw_path_scores(qs, rs, cs, length, torch.tensor([6.0]), 10, 10)
    ref = jba._dtw_path_scores(jnp.asarray(qs[0].numpy()), jnp.asarray(rs[0].numpy()),
                               jnp.asarray(cs[0].numpy()), jnp.int32(6), jnp.float32(6.0), 10, 10)
    assert int(got["offset_frames"][0]) == int(ref["offset_frames"]) == -3
    for k in ("offset_consistency", "confidence", "similarity", "quality", "stability"):
        assert float(got[k][0]) == pytest.approx(float(ref[k]), abs=1e-6), k


@pytest.mark.parametrize("skip", [True, False])
def test_batched_hybrid_align_matches_jax(energies, skip):
    eq, er = energies
    q2, r2 = _walks(21, [12, -30])
    max_lag = eq.shape[-1] // 2
    for q, r, ml in ((eq, er, max_lag), (q2, r2, 60)):
        j = jba.batched_hybrid_align(q, r, ml, HOP, SR, dtw_band=50, skip_dtw_if_confident=skip,
                                     top_k=3)
        t = tba.batched_hybrid_align(_t(q), _t(r), ml, HOP, SR, dtw_band=50,
                                     skip_dtw_if_confident=skip, top_k=3)
        assert sorted(t) == sorted(j)
        _same(t, j, ints=("offset_samples", "method", "topk_lags"))
    assert set(t["method"].tolist()) & {1, 2}, "DTW decided no pair"


def test_batched_hybrid_align_device_matches_jax():
    q, r = _walks(22, [12, -30, 5])
    j = jba.batched_hybrid_align_device(jnp.asarray(q), jnp.asarray(r), 60, HOP, SR)
    t = tba.batched_hybrid_align_device(_t(q), _t(r), 60, HOP, SR)
    assert sorted(t) == sorted(j)
    _same(t, j)


@pytest.mark.parametrize("verify", [None, True, False])
def test_batched_align_audio_matches_jax(verify):
    pairs = [_pair(lag, 0.01, 40 + i) for i, lag in enumerate([137, 1000, -700])]
    q = np.stack([p[0] for p in pairs])
    r = np.stack([p[1] for p in pairs])
    kw = dict(window_size=WINDOW, hop_size=HOP, max_lag_seconds=3.0, refine=True, verify=verify)
    j = jba.batched_align_audio(q, r, SR, **kw)
    t = tba.batched_align_audio(_t(q), _t(r), SR, **kw)
    assert sorted(t) == sorted(j)
    _same(t, j, ints=("offset_samples", "method", "topk_lags", "verified"))
    np.testing.assert_allclose(t["offset_seconds_refined"].numpy(),
                               np.asarray(j["offset_seconds_refined"]), atol=1e-7)
    for i, lag in enumerate([137, 1000, -700]):
        assert abs(int(t["offset_samples"][i]) - lag) <= HOP
        assert abs(float(t["offset_seconds_refined"][i]) * SR - lag) <= 2.0


def test_phat_helpers_match_jax():
    pairs = [_pair(lag, 0.02, 50 + i) for i, lag in enumerate([300, -450])]
    q = np.stack([p[0] for p in pairs])
    r = np.stack([p[1] for p in pairs])
    cand = np.array([[0.03, 0.05, -0.2], [-0.05, 0.1, 0.0]], np.float32)
    jr, jp = jpipe.batched_phat_candidates(jnp.asarray(q), jnp.asarray(r), jnp.asarray(cand), SR,
                                           hop_size=HOP, max_offset_samples=4000)
    tr, tp = tpipe.batched_phat_candidates(_t(q), _t(r), _t(cand), SR, hop_size=HOP,
                                           max_offset_samples=4000)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-7)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    jo, jk = jpipe.batched_phat_global(jnp.asarray(q), jnp.asarray(r), SR, 8000)
    to, tk = tpipe.batched_phat_global(_t(q), _t(r), SR, 8000)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-7)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    coarse = np.array([0.03, -0.05], np.float32)
    jf = jpipe.batched_refine_offsets(jnp.asarray(q), jnp.asarray(r), jnp.asarray(coarse), SR,
                                      hop_size=HOP)
    tf = tpipe.batched_refine_offsets(_t(q), _t(r), _t(coarse), SR, hop_size=HOP)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-7)
    e = [np.asarray(short_time_energy(jnp.asarray(x), WINDOW, HOP)) for x in (q, r)]
    ja = jpipe.batched_pair_alignment(jnp.asarray(e[0]), jnp.asarray(e[1]), 40)
    ta = tpipe.batched_pair_alignment(_t(e[0]), _t(e[1]), 40)
    np.testing.assert_array_equal(ta["lag_frames"].numpy(), np.asarray(ja["lag_frames"]))
    np.testing.assert_allclose(ta["peak_correlation"].numpy(), np.asarray(ja["peak_correlation"]),
                               atol=1e-5)
    wq, wr = _walks(24, [6, -9], t=120)
    feats_q = np.stack([wq, wq ** 2], -1)
    feats_r = np.stack([wr, wr ** 2], -1)
    jd = jpipe.batched_pair_dtw(jnp.asarray(feats_q), jnp.asarray(feats_r), 16)
    td = tpipe.batched_pair_dtw(_t(feats_q), _t(feats_r), 16)
    np.testing.assert_array_equal(td["offset_frames"].numpy(), np.asarray(jd["offset_frames"]))
    np.testing.assert_array_equal(td["path_length"].numpy(), np.asarray(jd["path_length"]))
    np.testing.assert_allclose(td["distance"].numpy(), np.asarray(jd["distance"]), rtol=1e-5)


@pytest.mark.parametrize("method", ["correlation", "dtw", "hybrid"])
def test_alignment_analyzer_matches_jax(energies, method):
    eq, er = energies
    wq, wr = _walks(25, [20])
    max_lag = eq.shape[-1] // 2
    for q, r, ml in ((eq[1], er[1], max_lag), (eq[3], er[3], max_lag), (wq[0], wr[0], 60)):
        kw = dict(method=method, max_lag=ml, sample_rate=SR, hop_size=HOP, window_size=WINDOW,
                  dtw_band=50)
        j = jal.AlignmentAnalyzer(**kw).align_features(jnp.asarray(q)[:, None],
                                                       jnp.asarray(r)[:, None], SR)
        t = tal.AlignmentAnalyzer(**kw).align_features(_t(q)[:, None], _t(r)[:, None], SR)
        assert (t.method, t.offset) == (j.method, j.offset)
        for key in ("confidence", "similarity", "alignment_quality", "stability", "noise_level",
                    "ambiguity"):
            assert getattr(t, key) == pytest.approx(getattr(j, key), abs=ALIGN_SCORE_ATOL), key
    if method == "correlation":
        kw = dict(method=method, max_lag=40, sample_rate=SR, hop_size=HOP)
        js = jal.AlignmentAnalyzer(**kw).analyze_alignment_consistency(
            jnp.asarray(eq[0]), jnp.asarray(er[0]), SR, 3)
        ts = tal.AlignmentAnalyzer(**kw).analyze_alignment_consistency(_t(eq[0]), _t(er[0]), SR, 3)
        assert ts == pytest.approx(js)
        assert tal.offset_stats([]) == jal.offset_stats([])


@pytest.mark.parametrize("lag,verify", [(700, None), (-1100, 5), (300, 1)])
def test_align_audio_files_matches_jax(lag, verify):
    src, cdn = _pair(lag, 0.02, 60 + abs(lag) % 7, dur=5.0)
    jx = jext.AlignmentExtractor(JFeatureConfig(sample_rate=SR, window_size=WINDOW, hop_size=HOP),
                                 max_lag_seconds=2.0)
    tx = text.AlignmentExtractor(FeatureConfig(sample_rate=SR, window_size=WINDOW, hop_size=HOP),
                                 max_lag_seconds=2.0, device="cpu")
    j = jx.align_audio_files(jnp.asarray(src), jnp.asarray(cdn), SR, verify_top_peaks=verify)
    t = tx.align_audio_files(_t(src), _t(cdn), SR, verify_top_peaks=verify)
    assert t.best_alignment.result.offset == j.best_alignment.result.offset
    assert t.temporal_offset == pytest.approx(j.temporal_offset, abs=1e-9)
    assert t.method == j.method
    for key in ("offset_confidence", "alignment_similarity", "alignment_quality"):
        assert getattr(t, key) == pytest.approx(getattr(j, key), abs=ALIGN_SCORE_ATOL), key
    assert abs(t.temporal_offset * SR - lag) <= HOP
    ts, js = tx.get_alignment_summary(t), jx.get_alignment_summary(j)
    assert {k: v for k, v in ts.items() if isinstance(v, str)} == \
        {k: v for k, v in js.items() if isinstance(v, str)}
    for k in ("similarity_percent", "confidence_percent", "quality_percent"):
        assert ts[k] == pytest.approx(js[k], abs=100 * ALIGN_SCORE_ATOL), k
    a, b = tx.truncate_to_alignment_pcm(src, cdn, SR, t)
    ja, jb = jx.truncate_to_alignment_pcm(src, cdn, SR, j)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)


def test_extract_alignment_features_matches_jax():
    """Multi-feature alignment (energy correlation + chroma DTW), the
    selection, the time stretch and the consistency analysis."""
    src, cdn = _pair(640, 0.02, 70, dur=4.0)
    feats = {}
    for name, x in (("q", src), ("r", cdn)):
        e = np.asarray(short_time_energy(jnp.asarray(x), WINDOW, HOP))
        frames = np.lib.stride_tricks.sliding_window_view(x, WINDOW)[::HOP]
        spec = np.abs(np.fft.rfft(frames, axis=-1))[:, :120].reshape(len(frames), 12, 10).sum(-1)
        chroma = (spec / spec.sum(-1, keepdims=True)).astype(np.float32)
        feats[name] = (e, chroma)
    jx = jext.AlignmentExtractor(JFeatureConfig(sample_rate=SR, window_size=WINDOW, hop_size=HOP),
                                 max_lag_seconds=1.0)
    tx = text.AlignmentExtractor(FeatureConfig(sample_rate=SR, window_size=WINDOW, hop_size=HOP),
                                 max_lag_seconds=1.0, device="cpu")
    jf = [JFeatures(energy_features=JEnergy(short_time_energy=jnp.asarray(e)),
                    chroma_features=jnp.asarray(c)) for e, c in feats.values()]
    tf = [ExtractedFeatures(energy_features=EnergyFeatures(short_time_energy=_t(e)),
                            chroma_features=_t(c)) for e, c in feats.values()]
    j = jx.extract_alignment_features(jf[0], jf[1], jnp.asarray(src), jnp.asarray(cdn), SR,
                                      analyze_consistency=True)
    t = tx.extract_alignment_features(tf[0], tf[1], _t(src), _t(cdn), SR, analyze_consistency=True)
    assert t.method == j.method
    assert t.temporal_offset == pytest.approx(j.temporal_offset, abs=1e-9)
    assert sorted(t.feature_similarity) == sorted(j.feature_similarity)
    for key in t.feature_similarity:
        assert t.feature_similarity[key] == pytest.approx(j.feature_similarity[key],
                                                          abs=ALIGN_SCORE_ATOL)
    for key in ("offset_confidence", "alignment_similarity", "alignment_quality", "time_stretch"):
        assert getattr(t, key) == pytest.approx(getattr(j, key), abs=ALIGN_SCORE_ATOL), key
    assert t.consistency == pytest.approx(j.consistency)
