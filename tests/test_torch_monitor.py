"""The port's LatencyMonitor and FleetMonitor held to the JAX package on
the CPU (the sizes of tests/test_monitor.py: SR 8000, 12 s windows, 3 s
lag budget, a fleet of 3), the rolling windows' contents and ownership,
the staging of pushes to the card through pinned memory, and the rule
that a kernel fault is never degraded into a data error.

The cases on "cuda" are marked `card` and skip without one; on the card
(which has no JAX, so the cases held to JAX skip there):
`python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_monitor.py
tests/test_torch_tracing.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sonido_sonar_tpu_torch import FleetMonitor, LatencyMonitor, _build  # noqa: E402
from sonido_sonar_tpu_torch import monitor as MON  # noqa: E402
from sonido_sonar_tpu_torch.config.config import AlignmentConfig, FeatureConfig  # noqa: E402
from sonido_sonar_tpu_torch.extractors.alignment import AlignmentExtractor  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import hopper_dtw  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats.alignment import AlignmentAnalyzer  # noqa: E402
from sonido_sonar_tpu_torch.utils import metrics as M  # noqa: E402
from sonido_sonar_tpu_torch.utils.parity import ALIGN_SCORE_ATOL  # noqa: E402

torch.set_num_threads(1)
SR = 8000
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.card)]


def _device(name):
    """A case's device, decided inside the test: "cuda" skips without a card."""
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run the `card` cases on the card, module docstring)")
    return name


def _jax():
    """The JAX package's monitor, configs and synth; the cases held to it
    skip where JAX is not installed (the card's machine)."""
    pytest.importorskip("jax")
    from sonido_sonar_tpu import monitor as jmon
    from sonido_sonar_tpu.config import config as jconfig
    from sonido_sonar_tpu.io import synth

    return jmon, jconfig, synth


def _streams(duration=20.0, lag_s=0.8):
    synth = _jax()[2]
    x = synth.harmonic_tone(220.0, duration, SR) + synth.white_noise(duration, SR, 0.05, seed=3)
    rng = np.random.default_rng(5)
    env = np.interp(np.arange(len(x)), np.linspace(0, len(x), 80), rng.uniform(0.1, 1.0, 80))
    src = (x * env).astype(np.float32)
    return src, synth.shift_signal(src, int(lag_s * SR), noise=0.02, gain=0.9)


def _tcfg():
    return FeatureConfig(sample_rate=SR, window_size=1024, hop_size=256)


def _cfgs():
    return _tcfg(), _jax()[1].FeatureConfig(sample_rate=SR, window_size=1024, hop_size=256)


def _same_measurement(t, j):
    assert t.method == j.method
    assert t.time_s == j.time_s
    assert t.latency_s == pytest.approx(j.latency_s, abs=1e-6)
    assert t.confidence == pytest.approx(j.confidence, abs=ALIGN_SCORE_ATOL)
    assert t.similarity == pytest.approx(j.similarity, abs=ALIGN_SCORE_ATOL)


def test_latency_monitor_matches_jax():
    lag_s = 0.8
    jmon, jconfig, _ = _jax()
    src, cdn = _streams(20.0, lag_s)
    tcfg, jcfg = _cfgs()
    tm = LatencyMonitor(tcfg, AlignmentConfig(), window_seconds=12.0, max_lag_seconds=3.0,
                        device="cpu")
    jm = jmon.LatencyMonitor(jcfg, jconfig.AlignmentConfig(), window_seconds=12.0,
                             max_lag_seconds=3.0)
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
    jmon, _, synth = _jax()
    tcfg, jcfg = _cfgs()
    kw = dict(n_streams=3, window_seconds=8.0, max_lag_seconds=1.0, measure_batch=2)
    tf, jf = FleetMonitor(tcfg, device="cpu", **kw), jmon.FleetMonitor(jcfg, **kw)
    assert tf.measure_all() == [None] * 3
    src, _ = _streams(12.0, 0.0)
    for i, lag in enumerate(lags):
        cdn = synth.shift_signal(src, int(lag * SR), noise=0.02, gain=0.9)
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


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("fleet", [False, True])
def test_window_contents_after_pushes(fleet, device):
    """Pushes shorter than, equal to and longer than a window, per row and
    fleet-wide, back to back: each window holds the last W samples pushed
    to it, bit for bit (on the card, numpy pushes go through pinned memory)."""
    tcfg = _tcfg()
    device = _device(device)
    w = 2 * SR
    rng = np.random.default_rng(0)
    if fleet:
        mon = FleetMonitor(tcfg, n_streams=2, window_seconds=2.0, max_lag_seconds=0.5, device=device)
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
            np.testing.assert_array_equal(mon._src.buf[k].cpu().numpy(), totals[k][-w:])
            assert mon._samples_seen[k] == len(totals[k]) - w
    else:
        mon = LatencyMonitor(tcfg, window_seconds=2.0, max_lag_seconds=0.5, device=device)
        total = np.zeros(w, np.float32)  # the window starts at 0
        for n in (1000, 37, w, 9000, 256, 16001, w + 5):
            chunk = rng.standard_normal(n).astype(np.float32)
            mon.push_source(chunk)
            total = np.concatenate([total, chunk])
            np.testing.assert_array_equal(mon._src.buf.cpu().numpy(), total[-w:])
        assert mon._samples_seen == len(total) - w


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("n", [2 * SR, 2 * SR + 100, 300])
def test_windows_own_their_buffers(n, device):
    """Changing a pushed tensor or array afterwards leaves the window as
    it was (a push of at least one window must not alias the caller's
    data; on the card, the host's copy into pinned memory ends before
    `push` returns, and the window holds what was pushed)."""
    tcfg = _tcfg()
    device = _device(device)
    mon = LatencyMonitor(tcfg, window_seconds=2.0, max_lag_seconds=0.5, device=device)
    fleet = FleetMonitor(tcfg, n_streams=2, window_seconds=2.0, max_lag_seconds=0.5, device=device)
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
    w = 2 * SR
    want = np.concatenate([np.zeros(w, np.float32), np.arange(n, dtype=np.float32)])[-w:]
    for t in (mon._src.buf, mon._cdn.buf, fleet._src.buf[0], fleet._src.buf[1], fleet._cdn.buf[1]):
        np.testing.assert_array_equal(t.cpu().numpy(), want)
    assert not fleet._cdn.buf[0].any()


@pytest.mark.parametrize("device", DEVICES)
def test_back_to_back_pushes_of_one_reused_array(device):
    """A decoder that refills one array after each push returns: fleet-wide
    pushes of 64 rows, shorter and longer than the window, and per-row
    pushes, all back to back with no wait; every window equals the pushed
    history."""
    device = _device(device)
    rows, w = 64, 30 * SR
    mon = FleetMonitor(_tcfg(), n_streams=rows, window_seconds=30.0, max_lag_seconds=3.0,
                       device=device)
    rng = np.random.default_rng(3)
    buf = np.empty((rows, w + 10_000), np.float32)     # the decoder's one array
    hist = np.zeros((rows, w), np.float32)
    for n in (200_000, 150_001, w + 10_000, 200_000, 1_000, 190_000):
        buf[:, :n] = rng.standard_normal((rows, n), dtype=np.float32)
        mon.push_source_all(buf[:, :n])
        hist = np.concatenate([hist, buf[:, :n]], axis=1)[:, -w:]
        r = int(rng.integers(0, rows))
        buf[r, :n] = rng.standard_normal(n, dtype=np.float32)
        mon.push_source(r, buf[r, :n])
        hist[r] = np.concatenate([hist[r], buf[r, :n]])[-w:]
        buf.fill(np.nan)                                 # the refill starts at once
    np.testing.assert_array_equal(mon._src.buf.cpu().numpy(), hist)


@pytest.mark.parametrize("device", DEVICES)
def test_pushes_write_the_last_window_of_each_row(device):
    """Fleet-wide, per-row and broadcast ([n] for every row) pushes, shorter
    and longer than the window: each row holds its history and counts its
    samples. A push from host memory into a CPU window is one blocking copy
    (one host sync); into a window on the card it is one `monitor.stage`
    entry and waits on nothing."""
    device = _device(device)
    rows, w = 8, 1000
    win = MON._RollingWindow(w, rows, device=device)
    rng = np.random.default_rng(1)
    hist = np.zeros((rows, w), np.float32)
    pushes = ((300, "fleet"), (w, "fleet"), (w + 7, "fleet"), (999, "row"), (w + 1, "row"),
              (250, "broadcast"), (2 * w, "broadcast"), (1, "fleet"))
    syncs, stages = M.host_syncs, MON.STAGE.count
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for n, how in pushes:
            shape = {"fleet": (rows, n), "row": (n,), "broadcast": (n,)}[how]
            x = rng.standard_normal(shape).astype(np.float32)
            win.push(x, row=3 if how == "row" else None)
            if how == "row":
                hist[3] = np.concatenate([hist[3], x])[-w:]
            else:
                hist = np.concatenate([hist, np.broadcast_to(x, (rows, n))], axis=1)[:, -w:]
            np.testing.assert_array_equal(win.buf.cpu().numpy(), hist)
    on_card = device == "cuda"
    assert M.host_syncs - syncs == (0 if on_card else len(pushes))
    assert MON.STAGE.count - stages == (len(pushes) if on_card else 0)
    assert list(win.filled) == [300 + w + w + 7 + 250 + 2 * w + 1 + (999 + w + 1) * (r == 3)
                                for r in range(rows)]


@pytest.mark.parametrize("device", DEVICES)
def test_pushes_of_other_dtypes_fill_the_window_as_float32(device):
    """A float64 numpy push, a float64 or float32 CPU tensor, a list, int16
    PCM and a reversed view give the window a float32 push of the same
    values gives, bit for bit (the card's path converts in its copy to
    pinned memory; the CPU's through numpy)."""
    device = _device(device)
    rows, w = 3, 5000
    rng = np.random.default_rng(2)
    a64 = rng.standard_normal((rows, 4000)) * 1e3 + rng.standard_normal((rows, 4000)) * 1e-5
    pcm16 = rng.integers(-32768, 32768, (rows, 4000), dtype=np.int16)
    pushes = [a64, torch.from_numpy(a64), torch.from_numpy(a64).float(), a64.tolist(), pcm16,
              a64[:, ::-1]]
    got = []
    for x in pushes:
        win = MON._RollingWindow(w, rows, device=device)
        win.push(x)
        got.append(win.buf.cpu().numpy())
    want = [np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor)
            else x.numpy().astype(np.float32) for x in pushes]
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g[:, -4000:], x)
        assert not g[:, :-4000].any()


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
    tcfg = _tcfg()
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
    tcfg = _tcfg()
    real = hopper_dtw.fill_banded_hopper
    monkeypatch.setattr(hopper_dtw, "fill_banded_hopper",
                        lambda qq, rr, *args: real(qq.to("meta"), rr.to("meta"), *args))
    analyzer = AlignmentAnalyzer(method="hybrid", max_lag=100, sample_rate=SR, hop_size=256,
                                 dtw_band=50)
    with pytest.raises(_build.KernelError, match="no DTW fill kernel"):
        analyzer.align_features(q, r, SR)
    with pytest.raises(_build.KernelError, match="no DTW fill kernel"):
        AlignmentExtractor(tcfg, max_lag_seconds=1.0, device="cpu")._align_with("dtw_chroma", q, r, SR, "dtw")
