"""A run with the timed path broken underneath reads `correct` false:
the harness's look for a card is skipped (device "cpu", tiny sizes) and
the rest of a run is driven, window, sample and check, with each fault
a cell can have planted in the program. The limits are the cells' own."""

import pytest
import torch

from benchmark import run as R
from benchmark.core import spec as S

SEED = 2**31 + 4242


def _tiny(cell_name):
    cell = S.Cell(cell_name)
    if cell_name.startswith("monitor"):
        cell.config = dict(cell.config, n_streams=4, window_seconds=6, max_lag_seconds=2.0,
                           measure_batch=2, cadence_seconds=1)
        cell.traffic = dict(cell.traffic, streams=4, ring_seconds=12, advance_seconds=1,
                            unrelated=[1, 3] if cell.traffic["unrelated"] else [])
    else:
        cell.config = dict(cell.config, batch=4, clip_seconds=1)
        cell.traffic = dict(cell.traffic, batch=4, clip_seconds=1, distinct=2)
        cell.check = dict(cell.check, sample_pool=2)
    return cell


def _run(cell, seconds=1.0):
    torch.set_num_threads(4)
    return R.run_cell(cell, SEED, seconds, False, "cpu", log=lambda *a, **k: None)


# -- the monitor: an answer altered, the windows left unchanged, half of a
# sub-batch left out ---------------------------------------------------------

def _patch_align(monkeypatch, change):
    from sonido_sonar_tpu_torch.ops.stats import batched_alignment as BA

    real = BA.batched_align_audio

    def broken(q, r, *a, **k):
        return change(real, q, r, a, k)

    monkeypatch.setattr(BA, "batched_align_audio", broken)


def _altered(real, q, r, a, k):
    out = real(q, r, *a, **k)
    out["offset_seconds_refined"] = out["offset_seconds_refined"].clone()
    out["offset_seconds_refined"][0] += 1.0 / 44100
    return out


def _half(real, q, r, a, k):
    h = q.shape[0] // 2
    out = real(q[:h], r[:h], *a, **k)
    return {key: torch.cat([v, v[: q.shape[0] - h]]) for key, v in out.items()}


@pytest.mark.parametrize("cell_name", ["monitor.mixed-64", "monitor.clean-64"])
@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out", "state_unchanged"])
def test_monitor_fault_fails_the_check(monkeypatch, cell_name, fault):
    if fault == "state_unchanged":
        from sonido_sonar_tpu_torch import monitor as M

        real_push, seen = M._RollingWindow.push, {"n": 0}

        def push(self, pcm, row=None):   # the windows stop moving after set-up's fill
            seen["n"] += 1
            if seen["n"] <= 2 * 6:
                return real_push(self, pcm, row)
            n = int(pcm.shape[-1])
            self.filled += n
            return n

        monkeypatch.setattr(M._RollingWindow, "push", push)
    else:
        _patch_align(monkeypatch, _altered if fault == "answer_altered" else _half)
    res = _run(_tiny(cell_name))
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


# -- the backfill: an answer altered, half of the batch left out ---------------

@pytest.mark.parametrize("cell_name", ["backfill.stream-30s", "backfill.resident-30s"])
@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_backfill_fault_fails_the_check(monkeypatch, cell_name, fault):
    from sonido_sonar_tpu_torch.parallel import pipeline as P

    real = P.batched_fingerprint_features

    def broken(x, *a, **k):
        if fault == "answer_altered":
            out = real(x, *a, **k)
            out["mfcc"] = out["mfcc"].clone()
            out["mfcc"][0, 0, 1] += 0.01 * float(out["mfcc"].abs().max())
            return out
        h = x.shape[0] // 2
        out = real(x[:h], *a, **k)
        return {key: torch.cat([v, v[: x.shape[0] - h]]) for key, v in out.items()}

    monkeypatch.setattr(P, "batched_fingerprint_features", broken)
    res = _run(_tiny(cell_name))
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell_name", ["backfill.stream-30s", "monitor.mixed-64"])
def test_the_sound_run_is_correct(cell_name):
    res = _run(_tiny(cell_name))
    assert res["correct"] is True, res["checks"]
