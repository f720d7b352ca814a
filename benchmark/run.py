#!/usr/bin/env python3
"""Run one benchmark cell once, on the machine it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic, driver,
reference and metrics are found by name (`benchmark/core/spec.py`). The
run makes its traffic on the card from the seed, builds the system and
warms its one shape (set-up), measures a closed loop for `--seconds`,
and then checks sampled outputs of the window against the plain
reference. `--trace 1` adds a profiled window of a few steady calls and
reports the per-layer metrics instead of the end-to-end ones. The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error.

`--control 1` puts the reference computed one precision lower in the
program's place for the check: its readings must fail the limits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

_T_IMPORT = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BANNED = ("jax", "jaxlib", "flax", "sonido_sonar_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def banned_modules() -> list:
    """Top-level names in sys.modules that the run must not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


@dataclass
class RunInfo:
    window: object
    setup_s: float


@dataclass
class LayerContext:
    cell: object
    trace: object
    counters: dict        # the readers' program counters over the traced calls
    kernels: dict         # benchmark/layer_metrics/kernels.json


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             control: bool = False, log=print) -> dict:
    """One run of `cell`: the result object (without the device key's
    card fields when `device` is not a card)."""
    import numpy as np
    import torch

    from benchmark.core import spec as S

    driver_mod = S.load_module("drivers", cell.config["driver"])
    reference = S.load_module("reference", cell.config["reference"])
    driver = driver_mod.Driver(cell.config, cell.traffic, cell.check, seed, device)
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.synchronize()
    setup_s = process_age()
    window = driver.run_window(seconds)
    log(f"calls {window.attempted} in {seconds} s (failed {window.failed})", file=sys.stderr)
    memory_peak = int(torch.cuda.max_memory_allocated()) if is_cuda else 0
    result = {"correct": False, "attempted": window.attempted, "failed": window.failed}
    if trace:
        from benchmark.core.trace import traced

        from benchmark.core import counters as C

        readers = {m["name"]: S.load_module("layer_metrics", m["name"]) for m in cell.per_layer}
        named = C.named(readers.values())
        before = C.snapshot(named)
        reading = traced(lambda: driver.run_calls(int(cell.check["trace_calls"])))
        ctx = LayerContext(cell, reading, _delta(C.snapshot(named), before),
                           S.read_json(S.BENCH / "layer_metrics" / "kernels.json"))
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = reading.breakdown()
        device_extra = {"busy_s": reading.busy_s, "window_s": reading.window_s}
    else:
        run = RunInfo(window, setup_s)
        metrics = {m["name"]: {"value": S.load_module("end_to_end", m["name"]).compute(run),
                               "unit": m["unit"]} for m in cell.end_to_end}
        device_extra = {}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if is_cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": memory_peak, **device_extra,
    }

    # the check, once the window has closed and the program's state is freed
    rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 0xC0FFEE])
    sample = driver.sample(rng, int(cell.check["sample"]), window.attempted)
    t0 = time.monotonic()
    expected = [driver.expected(reference, s, lowp=False) for s in sample]
    program = ([driver.as_program(driver.expected(reference, s, lowp=True)) for s in sample]
               if control else sample)
    readings = driver.compare(reference, program, expected)
    log(f"reference check of {len(sample)} sampled outputs took {time.monotonic() - t0:.1f} s",
        file=sys.stderr)
    limits = cell.check["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in readings.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())  # NaN fails
    result["correct"] = bool(ok and window.failed == 0 and window.attempted > 0)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.core import spec as S

    cell = S.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", bool(args.control))
    found = banned_modules()
    if found:
        print(f"the run loaded modules it must not load: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


def _finite(x):
    """The result with every non-finite number written as a string (the
    line stays JSON; such a check has already failed)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and x != x or x in (float("inf"), float("-inf")):
        return str(x)
    return x


if __name__ == "__main__":
    sys.exit(main())
