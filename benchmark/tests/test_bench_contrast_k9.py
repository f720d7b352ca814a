"""contrast_k9_launches_per_batch: K9's launch counter, read per traced
batch of the backfill cells."""

import types

import pytest

from benchmark.core import counters as C
from benchmark.core import spec as S

NAME = "contrast_k9_launches_per_batch"
WHERE = "sonido_sonar_tpu_torch.ops.hopper_contrast:band_select_means_hopper.launches"


def test_the_reader_names_its_counter_and_the_spec_its_cells():
    mod = S.load_module("layer_metrics", NAME)
    assert mod.COUNTERS == {"k9_launches": WHERE}
    assert isinstance(C.read(WHERE), int)
    entry = {m["name"]: m for m in S.load_spec()["per_layer"]}[NAME]
    assert (entry["source"], entry["layer"], entry["moves"]) == ("program_counter", "main path", "audio_h_per_h")
    assert entry["workloads"] == ["backfill.stream-30s", "backfill.resident-30s"]


def test_the_spec_names_k9_among_the_ports_counters():
    readers = [S.load_module("layer_metrics", m["name"]) for m in S.load_spec()["per_layer"]]
    named = C.named(readers)
    assert {"dtw_fill_launches", "k1_launches", "k2_launches", "k9_launches"} <= set(named)
    assert named["k9_launches"] == WHERE


@pytest.mark.parametrize("launches,want", [(6, 1.0), (0, 0.0)])
def test_launches_over_the_traced_batches(launches, want):
    ctx = types.SimpleNamespace(counters={"k9_launches": launches}, trace=types.SimpleNamespace(calls=6))
    assert S.load_module("layer_metrics", NAME).read(ctx) == want


def test_a_traced_backfill_run_reads_one_launch_a_batch(monkeypatch):
    """The traced branch of a backfill run on the CPU, the profiler replaced
    by a synthetic trace and the card's one K9 launch a batch by the
    counter (the CPU's plain version counts none)."""
    from sonido_sonar_tpu_torch.ops import hopper_contrast

    from benchmark import run as R
    from benchmark.core import trace as T

    from .test_bench_faults import SEED, _tiny

    def fake(run_calls):
        n = run_calls()
        hopper_contrast.band_select_means_hopper.launches += n
        ev = [{"ph": "X", "name": T.WINDOW_LABEL, "cat": "user_annotation", "ts": 0, "dur": 1000},
              {"ph": "X", "name": "band_means_lanes_kernel", "cat": "kernel", "ts": 10, "dur": 100}]
        return T.read_events(ev, n)

    monkeypatch.setattr(T, "traced", fake)
    res = R.run_cell(_tiny("backfill.resident-30s"), SEED, 1.0, True, "cpu", log=lambda *a, **k: None)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got[NAME] == 1.0
    assert got["glue_device_ms_per_batch"] == 0.0  # K9 is the port's own kernel, not glue
