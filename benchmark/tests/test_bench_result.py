"""The result line's schema, the refusals, and the check of loaded modules."""

import json
import subprocess
import sys
import types

import pytest

from benchmark import run as R
from benchmark.core import spec as S

from .test_bench_faults import _run, _tiny


@pytest.mark.parametrize("cell_name", ["monitor.clean-64", "backfill.resident-30s"])
def test_result_schema(cell_name):
    cell = _tiny(cell_name)
    res = _run(cell, seconds=4.0)   # a few calls end inside the window
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert {"metrics", "device"} <= set(res)
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
        assert res["metrics"][m["name"]]["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(cell.check["limits"])
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    line = json.dumps(R._finite(res))
    assert json.loads(line)["checks"] == res["checks"]


def test_non_finite_numbers_stay_json():
    got = R._finite({"a": float("inf"), "b": [1.0, float("nan")], "c": {"d": -float("inf")}})
    assert got == {"a": "inf", "b": [1.0, "nan"], "c": {"d": "-inf"}}
    json.loads(json.dumps(got, allow_nan=False))


def test_every_cell_names_files_that_exist():
    spec = S.load_spec()
    for w in spec["workloads"]:
        cell = S.Cell(w["name"], spec)
        assert (S.BENCH / "drivers" / f"{cell.config['driver']}.py").is_file()
        assert (S.BENCH / "reference" / f"{cell.config['reference']}.py").is_file()
        assert {"sample", "trace_calls", "limits"} <= set(cell.check)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end) and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.end_to_end:
            assert (S.BENCH / "end_to_end" / f"{m['name']}.py").is_file()
        for m in cell.per_layer:
            assert (S.BENCH / "layer_metrics" / f"{m['name']}.py").is_file()
            moved = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
            assert S.reports(moved, w["name"])


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    p = subprocess.run([sys.executable, str(S.BENCH / "run.py"), "--workload", "monitor.mixed-64",
                        "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                       cwd=S.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_banned_modules_are_matched_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "sonido_sonar_tpu_torch_fake", types.ModuleType("x"))
    assert R.banned_modules() == [] or "sonido_sonar_tpu" not in R.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "sonido_sonar_tpu.ops", types.ModuleType("s"))
    assert {"jax", "sonido_sonar_tpu"} <= set(R.banned_modules())
