"""The port's LatencyMonitor and FleetMonitor held to the JAX package on
the CPU (the sizes of tests/test_monitor.py: SR 8000, 12 s windows, 3 s
lag budget, a fleet of 3), the rolling windows' contents and ownership,
and the rule that a kernel fault is never degraded into a data error.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from sonido_sonar_tpu import monitor as jmon  # noqa: E402
from sonido_sonar_tpu.config.config import AlignmentConfig as JAlignmentConfig  # noqa: E402
from sonido_sonar_tpu.config.config import FeatureConfig as JFeatureConfig  # noqa: E402
from sonido_sonar_tpu.io.synth import harmonic_tone, shift_signal, white_noise  # noqa: E402
from sonido_sonar_tpu_torch import FleetMonitor, LatencyMonitor, _build  # noqa: E402
from sonido_sonar_tpu_torch.config.config import AlignmentConfig, FeatureConfig  # noqa: E402
from sonido_sonar_tpu_torch.extractors.alignment import AlignmentExtractor  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import hopper_dtw  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats.alignment import AlignmentAnalyzer  # noqa: E402
from sonido_sonar_tpu_torch.utils.parity import ALIGN_SCORE_ATOL  # noqa: E402

torch.set_num_threads(1)
SR = 8000


def _streams(duration=20.0, lag_s=0.8):
    x = harmonic_tone(220.0, duration, SR) + white_noise(duration, SR, 0.05, seed=3)
    rng = np.random.default_rng(5)
    env = np.interp(np.arange(len(x)), np.linspace(0, len(x), 80), rng.uniform(0.1, 1.0, 80))
    src = (x * env).astype(np.float32)
    return src, shift_signal(src, int(lag_s * SR), noise=0.02, gain=0.9)


def _cfgs():
    return (FeatureConfig(sample_rate=SR, window_size=1024, hop_size=256),
            JFeatureConfig(sample_rate=SR, window_size=1024, hop_size=256))


def _same_measurement(t, j):
    assert t.method == j.method
    assert t.time_s == j.time_s
    assert t.latency_s == pytest.approx(j.latency_s, abs=1e-6)
    assert t.confidence == pytest.approx(j.confidence, abs=ALIGN_SCORE_ATOL)
    assert t.similarity == pytest.approx(j.similarity, abs=ALIGN_SCORE_ATOL)


def test_latency_monitor_matches_jax():
    lag_s = 0.8
    src, cdn = _streams(20.0, lag_s)
    tcfg, jcfg = _cfgs()
    tm = LatencyMonitor(tcfg, AlignmentConfig(), window_seconds=12.0, max_lag_seconds=3.0,
                        device="cpu")
    jm = jmon.LatencyMonitor(jcfg, JAlignmentConfig(), window_seconds=12.0, max_lag_seconds=3.0)
    assert tm.measure() is None and not tm.ready()
    chunk = SR // 2
    measured = 0
    for i in range(0, len(src), chunk):
        for mon in (tm, jm):
            mon.push_source(src[i: i + chunk])
            mon.push_cdn(cdn[i: i + chunk])
        assert tm.ready() == jm.ready()
        if tm.ready() and (i // chunk) % 8 == 0:
            refine = measured % 2 == 1
            _same_measurement(tm.measure(refine=refine), jm.measure(refine=refine))
            measured += 1
    assert measured >= 2
    np.testing.assert_array_equal(tm._src.buf.numpy(), np.asarray(jm._src.buf))
    assert tm.current_latency() == pytest.approx(jm.current_latency(), abs=1e-6)
    assert tm.current_latency() == pytest.approx(lag_s, abs=3 * 256 / SR)
    assert tm.stats() == pytest.approx(jm.stats())


def test_fleet_monitor_matches_jax():
    lags = [0.3, -0.2, 0.55]
    tcfg, jcfg = _cfgs()
    kw = dict(n_streams=3, window_seconds=8.0, max_lag_seconds=1.0, measure_batch=2)
    tf, jf = FleetMonitor(tcfg, device="cpu", **kw), jmon.FleetMonitor(jcfg, **kw)
    assert tf.measure_all() == [None] * 3
    src, _ = _streams(12.0, 0.0)
    for i, lag in enumerate(lags):
        cdn = shift_signal(src, int(lag * SR), noise=0.02, gain=0.9)
        for lo in range(0, len(src), 3 * SR // 2):
            for f in (tf, jf):
                f.push_source(i, src[lo: lo + 3 * SR // 2])
                f.push_cdn(i, cdn[lo: lo + 3 * SR // 2])
    assert tf.ready_mask().all()
    for refine in (True, False):
        got, want = tf.measure_all(refine=refine), jf.measure_all(refine=refine)
        for i, (t, j) in enumerate(zip(got, want)):
            _same_measurement(t, j)
            assert t.latency_s == pytest.approx(lags[i], abs=2 * 256 / SR)
    for i in range(3):
        assert tf.current_latency(i) == pytest.approx(jf.current_latency(i), abs=1e-6)
        assert tf.stats(i) == pytest.approx(jf.stats(i))
    # fleet-wide pushes, [N, L] and broadcast [L]
    pairs = np.stack([src[: 3 * SR], src[SR: 4 * SR], src[2 * SR: 5 * SR]])
    for f in (tf, jf):
        f.push_source_all(pairs)
        f.push_cdn_all(src[: 2 * SR])
    np.testing.assert_array_equal(tf._src.buf.numpy(), np.asarray(jf._src.buf))
    np.testing.assert_array_equal(tf._cdn.buf.numpy(), np.asarray(jf._cdn.buf))
    np.testing.assert_array_equal(tf._samples_seen, jf._samples_seen)


@pytest.mark.parametrize("fleet", [False, True])
def test_window_contents_after_pushes(fleet):
    """Pushes shorter than, equal to and longer than a window, per row and
    fleet-wide: each window holds the last W samples pushed to it."""
    tcfg, _ = _cfgs()
    w = 2 * SR
    rng = np.random.default_rng(0)
    if fleet:
        mon = FleetMonitor(tcfg, n_streams=2, window_seconds=2.0, max_lag_seconds=0.5, device="cpu")
        totals = [np.zeros(w, np.float32), np.zeros(w, np.float32)]  # windows start at 0
        for n in (1000, 37, w, 9000, 256, w + 5):
            row = int(rng.integers(0, 2))
            chunk = rng.standard_normal(n).astype(np.float32)
            mon.push_source(row, chunk)
            totals[row] = np.concatenate([totals[row], chunk])
            both = rng.standard_normal((2, n // 3 + 1)).astype(np.float32)
            mon.push_source_all(both)
            totals = [np.concatenate([totals[k], both[k]]) for k in range(2)]
        for k in range(2):
            np.testing.assert_array_equal(mon._src.buf[k].numpy(), totals[k][-w:])
            assert mon._samples_seen[k] == len(totals[k]) - w
    else:
        mon = LatencyMonitor(tcfg, window_seconds=2.0, max_lag_seconds=0.5, device="cpu")
        total = np.zeros(w, np.float32)  # the window starts at 0
        for n in (1000, 37, w, 9000, 256, 16001, w + 5):
            chunk = rng.standard_normal(n).astype(np.float32)
            mon.push_source(chunk)
            total = np.concatenate([total, chunk])
            np.testing.assert_array_equal(mon._src.buf.numpy(), total[-w:])
        assert mon._samples_seen == len(total) - w


@pytest.mark.parametrize("n", [2 * SR, 2 * SR + 100, 300])
def test_windows_own_their_buffers(n):
    """Changing a pushed tensor or array afterwards leaves the window as
    it was (a push of at least one window must not alias the caller's
    data)."""
    tcfg, _ = _cfgs()
    mon = LatencyMonitor(tcfg, window_seconds=2.0, max_lag_seconds=0.5, device="cpu")
    fleet = FleetMonitor(tcfg, n_streams=2, window_seconds=2.0, max_lag_seconds=0.5, device="cpu")
    x = torch.arange(n, dtype=torch.float32)
    a = np.arange(n, dtype=np.float32)
    mon.push_source(x)
    mon.push_cdn(a)
    fleet.push_source_all(torch.stack([x, x]))
    fleet.push_cdn(1, a)
    before = [t.clone() for t in (mon._src.buf, mon._cdn.buf, fleet._src.buf, fleet._cdn.buf)]
    x.fill_(-1.0)
    a.fill(-1.0)
    after = (mon._src.buf, mon._cdn.buf, fleet._src.buf, fleet._cdn.buf)
    assert all(torch.equal(b, c) for b, c in zip(before, after))


def _long_unrelated(frames=2100, d=1, seed=9):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((frames, d)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((frames, d)).astype(np.float32)))


def test_kernel_error_propagates_and_data_errors_degrade(monkeypatch):
    """Series long enough for the banded DTW path (n * m > 4M frames^2)
    and unrelated, so the hybrid falls through its 0.7 gate to DTW. A
    KernelError from the fill wrapper leaves AlignmentAnalyzer and
    AlignmentExtractor; a ValueError still degrades (the hybrid keeps its
    correlation answer, the extractor reports a failed feature)."""
    q, r = _long_unrelated()
    tcfg, _ = _cfgs()
    ext = AlignmentExtractor(tcfg, max_lag_seconds=1.0, device="cpu")
    analyzer = AlignmentAnalyzer(method="hybrid", max_lag=100, sample_rate=SR, hop_size=256,
                                 dtw_band=50)

    def kernel_fault(*args, **kwargs):
        raise _build.KernelError("sonido_dtw_fill_banded failed with CUDA error 700")

    monkeypatch.setattr(hopper_dtw, "fill_banded_hopper", kernel_fault)
    with pytest.raises(_build.KernelError):
        analyzer.align_features(q, r, SR)
    with pytest.raises(_build.KernelError):
        ext._align_with("dtw_chroma", q, r, SR, "dtw")
    with pytest.raises(_build.KernelError):
        ext._align_with("corr_energy", q, r, SR, "hybrid")

    def data_fault(*args, **kwargs):
        raise ValueError("|N-M| exceeds band")

    monkeypatch.setattr(hopper_dtw, "fill_banded_hopper", data_fault)
    res = analyzer.align_features(q, r, SR)
    assert res.method == "correlation"
    fa = ext._align_with("dtw_chroma", q, r, SR, "dtw")
    assert not fa.success and "exceeds band" in fa.error
    assert issubclass(_build.KernelError, RuntimeError)


def test_wrapper_refusal_propagates(monkeypatch):
    """The real fill wrapper, handed tensors on a device it has no kernel
    for (meta, standing in for an input the card cannot take), raises
    KernelError, and it leaves both degradation handlers."""
    q, r = _long_unrelated()
    tcfg, _ = _cfgs()
    real = hopper_dtw.fill_banded_hopper
    monkeypatch.setattr(hopper_dtw, "fill_banded_hopper",
                        lambda qq, rr, *args: real(qq.to("meta"), rr.to("meta"), *args))
    analyzer = AlignmentAnalyzer(method="hybrid", max_lag=100, sample_rate=SR, hop_size=256,
                                 dtw_band=50)
    with pytest.raises(_build.KernelError, match="no DTW fill kernel"):
        analyzer.align_features(q, r, SR)
    with pytest.raises(_build.KernelError, match="no DTW fill kernel"):
        AlignmentExtractor(tcfg, max_lag_seconds=1.0, device="cpu")._align_with("dtw_chroma", q, r, SR, "dtw")
