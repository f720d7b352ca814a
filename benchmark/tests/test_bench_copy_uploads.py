"""copy_uploads_per_batch: the counter `run_stream.copy_uploads` (one a
host batch uploaded on `run_stream`'s copy stream), read per traced batch
in `backfill.stream-30s` alone; no reading from a program without the
counter."""

import importlib.util
import types

import pytest

from benchmark.core import counters as C
from benchmark.core import spec as S

NAME = "copy_uploads_per_batch"
WHERE = "sonido_sonar_tpu_torch.parallel.pipeline:run_stream.copy_uploads"


def test_the_reader_names_its_counter_and_the_spec_its_cell():
    mod = S.load_module("layer_metrics", NAME)
    assert mod.COUNTERS == {"stream_copy_uploads": WHERE}
    assert isinstance(C.read(WHERE), int)
    entry = {m["name"]: m for m in S.load_spec()["per_layer"]}[NAME]
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"], entry["moves"]) == (
        "uploads/batch", "higher", "program_counter", "staging", "audio_h_per_h")
    assert entry["workloads"] == ["backfill.stream-30s"]


@pytest.mark.parametrize("uploads,want", [(6, 1.0), (0, 0.0)])
def test_copy_uploads_over_the_traced_batches(uploads, want):
    ctx = types.SimpleNamespace(counters={"stream_copy_uploads": uploads},
                                trace=types.SimpleNamespace(calls=6))
    assert S.load_module("layer_metrics", NAME).read(ctx) == want


def test_a_program_without_the_counter_gives_no_reading(monkeypatch):
    """The reader loaded afresh against a pipeline module whose run_stream
    lacks `copy_uploads` (the parent of the copy stream): no counters, so
    the harness reads nothing and the metric is left out of the line."""
    from sonido_sonar_tpu_torch.parallel import pipeline

    monkeypatch.delattr(pipeline.run_stream, "copy_uploads")
    path = S.BENCH / "layer_metrics" / f"{NAME}.py"
    spec = importlib.util.spec_from_file_location(f"{NAME}_fresh", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ctx = types.SimpleNamespace(counters={}, trace=types.SimpleNamespace(calls=6))
    assert mod.COUNTERS == {} and mod.read(ctx) is None


def _traced_stream_run(monkeypatch, device):
    """The traced branch of a tiny `backfill.stream-30s` run, under a real
    profiler session, read back through a synthetic device trace where
    there is no card."""
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
    res = R.run_cell(_tiny("backfill.stream-30s"), SEED, 1.0, True, device, log=lambda *a, **k: None)
    return res, {k: v["value"] for k, v in res["metrics"].items()}


def test_a_traced_cpu_stream_run_makes_no_copy_upload(monkeypatch):
    """Host batches bound for the CPU take no copy stream: 0 a batch."""
    res, got = _traced_stream_run(monkeypatch, "cpu")
    assert got[NAME] == 0.0
    assert res["correct"], res["checks"]


@pytest.mark.card
def test_a_traced_card_stream_run_uploads_each_batch_on_the_copy_stream(card):
    res, got = _traced_stream_run(None, card)
    assert got[NAME] == 1.0
    assert res["correct"], res["checks"]
