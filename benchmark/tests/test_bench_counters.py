"""The program counters a per-layer metric reads are named in its own
file (`COUNTERS`) and read by the harness, not by a driver."""

import types

import pytest

from benchmark.core import counters as C
from benchmark.core import spec as S


def test_every_named_counter_is_an_integer_of_the_port():
    spec = S.load_spec()
    readers = [S.load_module("layer_metrics", m["name"]) for m in spec["per_layer"]]
    named = C.named(readers)
    assert {"dtw_fill_launches", "k1_launches", "k2_launches"} <= set(named)
    for name, where in named.items():
        assert where.split(":")[0].split(".")[0] == "sonido_sonar_tpu_torch", name
        assert isinstance(C.read(where), int), name


def test_a_snapshot_follows_the_counter(monkeypatch):
    from sonido_sonar_tpu_torch.ops.stats import hopper_dtw

    where = "sonido_sonar_tpu_torch.ops.stats.hopper_dtw:fill_banded_hopper.launches"
    before = C.snapshot({"fills": where})
    monkeypatch.setattr(hopper_dtw.fill_banded_hopper, "launches", before["fills"] + 2)
    assert C.snapshot({"fills": where})["fills"] - before["fills"] == 2


def test_one_name_for_two_places_is_refused():
    a = types.SimpleNamespace(COUNTERS={"n": "m:a"})
    b = types.SimpleNamespace(COUNTERS={"n": "m:b"})
    assert C.named([a, types.SimpleNamespace()]) == {"n": "m:a"}
    with pytest.raises(ValueError):
        C.named([a, b])


def test_a_traced_run_reads_the_counters_its_metrics_name(monkeypatch):
    """The traced branch of a run on the CPU, the profiler replaced by a
    synthetic trace and the card's two fills a call by the counter."""
    from sonido_sonar_tpu_torch.ops.stats import hopper_dtw

    from benchmark import run as R
    from benchmark.core import trace as T

    from .test_bench_faults import SEED, _tiny

    def fake(run_calls):
        n = run_calls()
        hopper_dtw.fill_banded_hopper.launches += 2 * n
        ev = [{"ph": "X", "name": T.WINDOW_LABEL, "cat": "user_annotation", "ts": 0, "dur": 1000},
              {"ph": "X", "name": "void regular_fft_factor<1>", "cat": "kernel", "ts": 10, "dur": 100},
              {"ph": "X", "name": "fill_rows_shared_kernel", "cat": "kernel", "ts": 200, "dur": 300}]
        return T.read_events(ev, n)

    monkeypatch.setattr(T, "traced", fake)
    cell = _tiny("monitor.mixed-64")
    res = R.run_cell(cell, SEED, 1.0, True, "cpu", log=lambda *a, **k: None)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == {m["name"] for m in cell.per_layer}
    assert got["dtw_fill_launches_per_call"] == 2.0
    assert got["dtw_roofline"] > 0
    calls = int(cell.check["trace_calls"])
    assert got["fft_device_ms_per_call"] == pytest.approx(0.1 / calls)
    assert got["device_idle_pct.monitor"] == pytest.approx(60.0)
    assert res["device"]["busy_s"] == pytest.approx(400e-6) and res["breakdown"]["device_ops"]
