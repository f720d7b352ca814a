"""The control of each cell, the plain reference computed one precision
lower and put in the program's place, fails the cell's limits.

The monitor's control rounds to bfloat16, which the CPU has; the
backfill's runs its matmuls in TF32, which only the card has (the
readings at the cells' own sizes on the H100 are in PERF.md)."""

import pytest
import torch

from benchmark import run as R
from benchmark.core import spec as S

from .test_bench_faults import SEED, _tiny


def _control(cell, device, seconds=1.0):
    return R.run_cell(cell, SEED, seconds, False, device, control=True, log=lambda *a, **k: None)


@pytest.mark.parametrize("cell_name", ["monitor.mixed-64", "monitor.clean-64"])
def test_monitor_control_fails_on_the_cpu(cell_name):
    torch.set_num_threads(4)
    res = _control(_tiny(cell_name), "cpu")
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.card
@pytest.mark.parametrize("cell_name", ["backfill.stream-30s", "backfill.resident-30s"])
def test_backfill_control_fails_on_the_card(card, cell_name):
    cell = S.Cell(cell_name)
    cell.config = dict(cell.config, batch=16)
    cell.traffic = dict(cell.traffic, batch=16, distinct=2)
    cell.check = dict(cell.check, sample_pool=2)
    res = _control(cell, card)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.card
@pytest.mark.parametrize("cell_name", ["monitor.mixed-64", "monitor.clean-64"])
def test_monitor_control_fails_on_the_card(card, cell_name):
    cell = S.Cell(cell_name)
    cell.config = dict(cell.config, n_streams=8, measure_batch=8)
    cell.traffic = dict(cell.traffic, streams=8,
                        unrelated=[6, 7] if cell.traffic["unrelated"] else [])
    res = _control(cell, card, seconds=2.0)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
