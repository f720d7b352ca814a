"""staged_pushes_per_call and its `.clean` twin: the count of span
`monitor.stage` (one entry a push staged through pinned memory), read per
traced monitor call; no reading from a program without the span."""

import importlib.util
import types

import pytest

from benchmark.core import counters as C
from benchmark.core import spec as S

NAME = "staged_pushes_per_call"
WHERE = "sonido_sonar_tpu_torch.monitor:STAGE.count"
CELLS = {NAME: ("monitor.mixed-64", "pairs_per_s"),
         f"{NAME}.clean": ("monitor.clean-64", "pairs_per_s.clean")}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_readers_name_their_counter_and_the_spec_their_cells(name):
    mod = S.load_module("layer_metrics", name)
    assert mod.COUNTERS == {"monitor_stage_count": WHERE}
    assert isinstance(C.read(WHERE), int)
    entry = {m["name"]: m for m in S.load_spec()["per_layer"]}[name]
    cell, moves = CELLS[name]
    assert (entry["source"], entry["layer"], entry["moves"]) == ("program_counter", "monitors", moves)
    assert entry["workloads"] == [cell]


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("stages,want", [(12, 2.0), (0, 0.0)])
def test_staged_pushes_over_the_traced_calls(name, stages, want):
    ctx = types.SimpleNamespace(counters={"monitor_stage_count": stages},
                                trace=types.SimpleNamespace(calls=6))
    assert S.load_module("layer_metrics", name).read(ctx) == want


def test_a_program_without_the_span_gives_no_reading(monkeypatch):
    """The reader loaded afresh against a monitor module that lacks STAGE
    (the parent of the staged pushes): no counters, so the harness reads
    nothing and the metric is left out of the line."""
    from sonido_sonar_tpu_torch import monitor

    monkeypatch.delattr(monitor, "STAGE")
    path = S.BENCH / "layer_metrics" / f"{NAME}.py"
    spec = importlib.util.spec_from_file_location(f"{NAME}_fresh", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ctx = types.SimpleNamespace(counters={}, trace=types.SimpleNamespace(calls=6))
    assert mod.COUNTERS == {} and mod.read(ctx) is None


def _traced_run(monkeypatch, cell_name, device):
    """The traced branch of a tiny monitor run, under a real profiler
    session (so the spans are on), read back through a synthetic device
    trace where there is no card."""
    import torch

    from benchmark import run as R
    from benchmark.core import trace as T

    from .test_bench_faults import SEED, _tiny

    if torch.device(device).type == "cpu":
        def traced(run_calls):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                n = run_calls()
            ev = [{"ph": "X", "name": T.WINDOW_LABEL, "cat": "user_annotation", "ts": 0, "dur": 1000}]
            return T.read_events(ev, n)

        monkeypatch.setattr(T, "traced", traced)
    res = R.run_cell(_tiny(cell_name), SEED, 1.0, True, device, log=lambda *a, **k: None)
    return res, {k: v["value"] for k, v in res["metrics"].items()}


def test_a_traced_cpu_monitor_run_stages_no_push(monkeypatch):
    """Windows on the CPU take the blocking copy: 0 staged pushes a call,
    and the host syncs keep their 32."""
    res, got = _traced_run(monkeypatch, "monitor.mixed-64", "cpu")
    assert got[NAME] == 0.0
    assert got["host_syncs_per_call"] == 32.0
    assert res["correct"], res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell_name", ["monitor.mixed-64", "monitor.clean-64"])
def test_a_traced_card_monitor_run_stages_both_pushes(card, cell_name):
    """On the card each call stages both sides' numpy chunks: 2.0 staged
    pushes and 30 host syncs a call."""
    suffix = ".clean" if cell_name.endswith("clean-64") else ""
    res, got = _traced_run(None, cell_name, card)
    assert got[NAME + suffix] == 2.0
    assert got["host_syncs_per_call" + suffix] == 30.0
    assert res["correct"], res["checks"]
