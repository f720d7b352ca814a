"""Find a cell's files by the names in `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix, cell, driver,
reference, end-to-end metric or per-layer metric is a file of its own
under `benchmark/`, named after it:

    configs/<config>.json          the deployment as it is run
    traffic/<traffic>.json         parameters of one traffic kind, named by its "kind"
    traffic/<kind>.py              make(traffic, seed, device, sample_rate): the generator
    workloads/<cell>.json          the cell's check: sample size and limits
    drivers/<driver>.py            the entry the window drives (named by the config)
    reference/<reference>.py       the plain reference (named by the config)
    end_to_end/<metric>.py         compute(window) -> value
    layer_metrics/<metric>.py      read(ctx) -> value or None; COUNTERS, the
                                   program counters it reads (core/counters.py)

A new cell, configuration or metric is new files and new entries in
`BENCHMARK.json`; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported in this cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(folder: str, name: str):
    """The module `benchmark/<folder>/<name>.py`, loaded by file path (the
    names hold dots and dashes)."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    mod_name = f"benchmark.{folder}." + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def traffic(t: dict, seed: int, device, sample_rate: int):
    """The traffic that `traffic/<t["kind"]>.py` makes from the seed."""
    return load_module("traffic", t["kind"]).make(t, seed, device, sample_rate)


class Cell:
    """One `workloads` entry with its configuration, traffic and check."""

    def __init__(self, name: str, spec: dict | None = None):
        spec = spec if spec is not None else load_spec()
        self.spec = spec
        self.entry = entry(spec["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.entry["chips"])
        cfg_entry = entry(spec["configs"], self.entry["config"], "config")
        self.config = read_json(ROOT / cfg_entry["file"])
        self.traffic = read_json(BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.check = read_json(BENCH / "workloads" / f"{name}.json")
        self.end_to_end = [m for m in spec["end_to_end"] if reports(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if reports(m, name)]
