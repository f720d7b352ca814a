"""The port's spans and counters (`utils/metrics.py`): `host_syncs` counts
the monitor's host waits by site, exactly; outside a profiler session no
span moves and none enters `record_function`; inside one the spans add
to their totals and land in the Chrome trace as `user_annotation`
events, each inside its parent's interval; `run_stream` leaves no span
open across its yield; `Metrics` times stages with the profiler off.
A push from host memory into a window on the card is one `monitor.stage`
entry and waits on nothing; the `card` cases show it there (the command
is in `tests/test_torch_monitor.py`'s docstring)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sonido_sonar_tpu_torch.config.config import FeatureConfig  # noqa: E402
from sonido_sonar_tpu_torch.io.synth import shift_signal, white_noise  # noqa: E402
from sonido_sonar_tpu_torch.monitor import FleetMonitor, LatencyMonitor  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import batched_alignment as BA  # noqa: E402
from sonido_sonar_tpu_torch.parallel import pipeline as P  # noqa: E402
from sonido_sonar_tpu_torch.utils import metrics as M  # noqa: E402
from sonido_sonar_tpu_torch import monitor as MON  # noqa: E402

SR = 8000
CPU = [torch.profiler.ProfilerActivity.CPU]
SPANS = [MON.MEASURE, MON.PUSH, MON.STAGE, MON.HOST_COPY, BA.ENERGY, BA.XCORR, BA.GATE_READ, BA.DTW,
         BA.VERIFY_READ, BA.VERIFY, BA.REFINE, P.STAGE, P.UPLOAD, P.STEP, P.WAIT]
# outputs of batched_align_audio copied to the host: with refine=True the
# adaptive verification's eleven keys (topk_lags among them) and the refined offset
OUTPUTS = 12


def _fleet_chunks(n=4, seconds=8.0):
    """[n, L] source and CDN chunks: rows 0-2 the source delayed, row 3
    unrelated (it fails the 0.7 gate, so the second sub-batch runs the DTW)."""
    src = np.stack([np.asarray(white_noise(seconds, SR, 0.1, seed=10 + i)) for i in range(n)])
    env = np.interp(np.arange(src.shape[1]), np.linspace(0, src.shape[1], 48),
                    np.random.default_rng(4).uniform(0.1, 1.0, 48))
    src = (src * env).astype(np.float32)
    cdn = np.stack([shift_signal(src[i], int((0.2 + 0.1 * i) * SR), noise=0.02, gain=0.9)
                    for i in range(n)]).astype(np.float32)
    cdn[-1] = np.asarray(white_noise(seconds, SR, 0.1, seed=99), dtype=np.float32)
    return src, cdn


def _fleet_monitor(device="cpu"):
    return FleetMonitor(FeatureConfig(sample_rate=SR, window_size=1024, hop_size=256), n_streams=4,
                        window_seconds=8.0, max_lag_seconds=1.0, measure_batch=2, device=device)


@pytest.fixture
def fleet():
    return _fleet_monitor(), _fleet_chunks()


def _call(mon, chunks):
    """The benchmark's call: one fleet-wide push per side, then measure_all."""
    mon.push_source_all(chunks[0])
    mon.push_cdn_all(chunks[1])
    return mon.measure_all(refine=True)


def _totals():
    return [(s.count, s.total_ns) for s in SPANS]


def test_host_syncs_of_a_fleet_call_are_counted_by_site(fleet):
    mon, chunks = fleet
    before = M.host_syncs
    res = _call(mon, chunks)
    assert all(m is not None for m in res)
    # 2 pushes from numpy + 2 sub-batches x (the row-index upload, the gate
    # and verification reads, one copy per output)
    assert M.host_syncs - before == 2 + 2 * (1 + 2 + OUTPUTS) == 32
    before = M.host_syncs
    mon.measure_all(refine=False)
    assert M.host_syncs - before == 2 * (1 + 2 + OUTPUTS - 1)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def test_a_staged_push_is_one_stage_entry_and_waits_on_nothing(device, tmp_path):
    """Under a profiler session each push from host memory into a window on
    the card is one `monitor.stage` entry inside its `monitor.push` and adds
    no host sync; into a CPU window it is a blocking copy, one host sync
    and no `monitor.stage` entry."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the command is in tests/test_torch_monitor.py)")
    mon = _fleet_monitor(device)
    src, cdn = _fleet_chunks()
    before, syncs = (MON.STAGE.count, MON.PUSH.count), M.host_syncs
    with torch.profiler.profile(activities=CPU) as prof:
        mon.push_source_all(src)
        mon.push_cdn(3, cdn[3])
        mon.push_cdn_all(torch.from_numpy(cdn).double())
    staged = 3 if device == "cuda" else 0
    assert (MON.STAGE.count - before[0], MON.PUSH.count - before[1]) == (staged, 3)
    assert M.host_syncs - syncs == 3 - staged
    np.testing.assert_array_equal(mon._cdn.buf.cpu().numpy(), cdn)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ann = _annotations(path)
    pushes = [e for e in ann if e["name"] == "monitor.push"]
    stages = [e for e in ann if e["name"] == "monitor.stage"]
    assert len(pushes) == 3
    assert len(stages) == staged and all(_inside(e, pushes) for e in stages)


@pytest.mark.card
def test_a_card_fleet_call_stages_both_pushes_and_counts_30_syncs():
    """On the card the benchmark's call stages each side's numpy chunk
    (two `monitor.stage` entries) and waits only where measure_all does:
    30 host syncs, the CPU's 32 less the two pushes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the command is in tests/test_torch_monitor.py)")
    mon, chunks = _fleet_monitor("cuda"), _fleet_chunks()
    assert all(m is not None for m in _call(mon, chunks))   # the warm call
    before, syncs = MON.STAGE.count, M.host_syncs
    with torch.profiler.profile(activities=CPU):
        res = _call(mon, chunks)
    assert all(m is not None for m in res)
    assert MON.STAGE.count - before == 2
    assert M.host_syncs - syncs == 2 * (1 + 2 + OUTPUTS) == 30


def test_a_latency_monitor_and_tensor_pushes_count_their_sites():
    mon = LatencyMonitor(FeatureConfig(sample_rate=SR, window_size=1024, hop_size=256),
                         window_seconds=8.0, max_lag_seconds=1.0, device="cpu")
    src, cdn = _fleet_chunks(n=1)
    before = M.host_syncs
    mon.push_source(src[0])
    mon.push_cdn(torch.from_numpy(cdn[0]))   # a host tensor is a copy from host memory too
    assert M.host_syncs - before == 2
    before = M.host_syncs
    assert mon.measure(refine=True) is not None
    assert M.host_syncs - before == 2 + OUTPUTS   # no index upload at B = 1


def test_spans_off_outside_a_profiler_session(fleet, monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    mon, chunks = fleet
    before = _totals()
    _call(mon, chunks)
    list(P.run_stream(lambda x: x * 2, [np.ones((1, 8), np.float32)] * 3, device="cpu"))
    assert _totals() == before and entered == []
    assert all(s._open == 0 for s in SPANS)


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(child, parents):
    return any(p["ts"] <= child["ts"] and child["ts"] + child["dur"] <= p["ts"] + p["dur"]
               for p in parents)


def test_spans_on_under_the_profiler_land_in_its_trace(fleet, tmp_path):
    mon, chunks = fleet
    before = {s.name: (s.count, s.total_ns) for s in SPANS}
    with torch.profiler.profile(activities=CPU) as prof:
        _call(mon, chunks)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    moved = {s.name: s.count - before[s.name][0] for s in SPANS}
    assert {k: v for k, v in moved.items() if v} == {
        "monitor.push": 2, "monitor.measure": 1, "monitor.host_copy": 2, "align.energy": 2,
        "align.xcorr": 2, "align.gate_read": 2, "align.dtw": 1, "align.verify_read": 2,
        "align.verify": 1, "align.refine": 2}
    assert all(s.total_ns > before[s.name][1] for s in SPANS if moved[s.name])
    ann = _annotations(path)
    by = {}
    for e in ann:
        by.setdefault(e["name"], []).append(e)
    assert {k: len(v) for k, v in by.items() if k in moved} == {k: v for k, v in moved.items() if v}
    for name, events in by.items():
        if name.startswith("align.") or name == "monitor.host_copy":
            assert all(_inside(e, by["monitor.measure"]) for e in events), name
    assert not any(_inside(e, by["monitor.measure"]) for e in by["monitor.push"])
    # the gate's read comes after the NCC and before the DTW of its sub-batch
    xc, gate, dtw = (sorted(by[k], key=lambda e: e["ts"]) for k in
                     ("align.xcorr", "align.gate_read", "align.dtw"))
    assert xc[1]["ts"] + xc[1]["dur"] <= gate[1]["ts"] <= dtw[0]["ts"]


def test_run_stream_closes_its_spans_before_each_yield():
    batches = [np.full((2, 16), i, np.float32) for i in range(4)]
    before = P.STEP.count
    with torch.profiler.profile(activities=CPU):
        seen = []
        for out in P.run_stream(lambda x: x + 1, batches, drain_every=1, device="cpu"):
            assert all(s._open == 0 for s in (P.STAGE, P.UPLOAD, P.STEP, P.WAIT))
            seen.append(float(out[0, 0]))
    assert seen == [1.0, 2.0, 3.0, 4.0]
    assert P.STEP.count - before == 4


@pytest.mark.parametrize("feed,device", [("numpy", "cpu"), ("tensor", "cuda")])
def test_run_stream_makes_no_copy_upload_off_the_card(feed, device):
    """Numpy batches bound for the CPU, and tensor batches (which stay on
    their own device, here the CPU, whatever `device` says), take no copy
    stream: `run_stream.copy_uploads` stays put and the spans still close
    before each yield."""
    batches = [np.full((2, 16), i, np.float32) for i in range(5)]
    if feed == "tensor":
        batches = [torch.from_numpy(b) for b in batches]
    before = P.run_stream.copy_uploads
    with torch.profiler.profile(activities=CPU):
        seen = []
        for out in P.run_stream(lambda x: x * 2, batches, drain_every=2, device=device):
            assert all(s._open == 0 for s in (P.STAGE, P.UPLOAD, P.STEP, P.WAIT))
            assert out.device.type == "cpu"
            seen.append(float(out[0, 0]))
    assert seen == [0.0, 2.0, 4.0, 6.0, 8.0]
    assert P.run_stream.copy_uploads == before


def test_a_span_is_on_only_in_the_recorded_steps_of_a_schedule():
    span = M.Span("test.scheduled")
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=CPU, schedule=sched) as prof:
        with span:
            pass
        prof.step()
        with span:
            pass
        prof.step()
        with span:
            pass
    assert span.count == 1 and span.total_ns > 0 and span._open == 0


def test_metrics_times_stages_with_the_profiler_off_and_annotates_them_on(tmp_path):
    m = M.Metrics()
    with m.timer("decode"):
        sum(range(1000))
    with torch.profiler.profile(activities=CPU) as prof:
        with m.timer("decode", block_on="cpu"):
            pass
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    stages = m.snapshot()["stages"]
    assert list(stages) == ["decode"] and stages["decode"]["calls"] == 2
    assert stages["decode"]["total_s"] > 0
    assert [e["name"] for e in _annotations(path)] == ["decode"]


def test_one_span_entered_from_many_threads_loses_no_entry():
    """Threads share the module-level spans: under a profiler session each
    entry is counted once and every thread leaves its own entry."""
    import sys
    import threading

    span = M.Span("test.threads")
    threads, rounds = 8, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=CPU):
            def work():
                for _ in range(rounds):
                    with span:
                        with span:
                            pass

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert span.count == 2 * threads * rounds and span._open == 0
