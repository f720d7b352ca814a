"""The readers of the program's spans and host-sync counter
(`layer_metrics/_totals.py` and the eight metrics that use it): each
reading from a fake context, a program without the spans giving no
counters and no reading, and a traced monitor run on the CPU, under a
real profiler session, reading the exact count of host syncs."""

import importlib.util
import types

import pytest

from benchmark.core import spec as S

# metric -> (counter -> value over 4 calls, expected reading)
CALLS = 4
CASES = {
    "host_syncs_per_call": ({"host_syncs": 128}, 32.0),
    "host_wait_ms_per_call": ({"monitor_host_copy_ns": 8_000_000, "align_gate_read_ns": 2_000_000,
                               "align_verify_read_ns": 30_000_000}, 10.0),
    "push_ms_per_call": ({"monitor_push_ns": 160_000_000}, 40.0),
    "stage_ms_per_batch": ({"stream_stage_ns": 100_000_000}, 25.0),
    "stream_wait_ms_per_batch": ({"stream_wait_ns": 60_000_000}, 15.0),
}


def _ctx(counters):
    return types.SimpleNamespace(counters=counters, trace=types.SimpleNamespace(calls=CALLS))


@pytest.mark.parametrize("name", sorted(CASES) + [f"{m}.clean" for m in
                                                   ("host_syncs_per_call", "host_wait_ms_per_call",
                                                    "push_ms_per_call")])
def test_a_reader_divides_its_totals_by_the_traced_calls(name):
    counters, want = CASES[name.removesuffix(".clean")]
    mod = S.load_module("layer_metrics", name)
    assert set(mod.COUNTERS) == set(counters)
    assert mod.read(_ctx(counters)) == pytest.approx(want)


def test_every_new_metric_is_in_the_spec_with_its_reader():
    spec = {m["name"]: m for m in S.load_spec()["per_layer"]}
    for name in CASES:
        for n in (name, f"{name}.clean"):
            if n in spec:
                assert spec[n]["source"] == "program_counter"
                assert (S.BENCH / "layer_metrics" / f"{n}.py").is_file()


def test_a_program_without_the_spans_gives_no_counters_and_no_reading(monkeypatch):
    from sonido_sonar_tpu_torch import monitor

    t = S.load_module("layer_metrics", "_totals")
    assert t.present({"x": "sonido_sonar_tpu_torch.monitor:NO_SUCH_SPAN.total_ns"}) == {}
    assert t.per_call(_ctx({}), []) is None
    # the reader loaded afresh against a monitor module that lacks PUSH (a
    # commit before the spans): no counters, so the harness reads nothing
    monkeypatch.delattr(monitor, "PUSH")
    path = S.BENCH / "layer_metrics" / "push_ms_per_call.py"
    spec = importlib.util.spec_from_file_location("push_ms_per_call_fresh", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.COUNTERS == {} and mod.read(_ctx({})) is None


def test_a_traced_monitor_run_reads_its_spans_and_host_syncs(monkeypatch):
    """The traced branch of a run on the CPU with a real profiler session
    around the calls (so the spans are on), read back through a synthetic
    device trace: 32 host syncs a call at 4 pairs in sub-batches of 2, as
    at 64 in sub-batches of 32."""
    import torch

    from benchmark import run as R
    from benchmark.core import trace as T

    from .test_bench_faults import SEED, _tiny

    def traced(run_calls):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            n = run_calls()
        ev = [{"ph": "X", "name": T.WINDOW_LABEL, "cat": "user_annotation", "ts": 0, "dur": 1000}]
        return T.read_events(ev, n)

    monkeypatch.setattr(T, "traced", traced)
    res = R.run_cell(_tiny("monitor.mixed-64"), SEED, 1.0, True, "cpu", log=lambda *a, **k: None)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["host_syncs_per_call"] == 32.0
    assert got["push_ms_per_call"] > 0 and got["host_wait_ms_per_call"] > 0
    assert got["dtw_fill_launches_per_call"] == 0.0   # the CPU runs the plain fill
    assert res["correct"], res["checks"]
