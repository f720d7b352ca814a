"""Each plain reference held to the port's CPU path at tiny sizes (on a
CPU tensor every kernel of the port runs its plain version)."""

import numpy as np
import pytest
import torch

from benchmark.core import spec as S
from benchmark.reference import fingerprint_features as FF
from benchmark.reference import fleet_monitor as FM


def _tiny_monitor():
    cell = S.Cell("monitor.mixed-64")
    cfg = dict(cell.config, n_streams=4, window_seconds=6, max_lag_seconds=2.0, measure_batch=2,
               cadence_seconds=1)
    tr = dict(cell.traffic, streams=4, ring_seconds=12, advance_seconds=1, unrelated=[1, 3])
    return cell, cfg, tr


def test_dtw_fill_and_walk_match_the_ports_plain_versions():
    from sonido_sonar_tpu_torch.ops.stats import dtw as port_dtw

    g = torch.Generator().manual_seed(3)
    n, band = 300, 40
    q = torch.rand((2, n), generator=g)
    r = torch.roll(q, 7, dims=1) * 0.9 + 0.01 * torch.rand((2, n), generator=g)
    r[1] = torch.rand(n, generator=g)
    full = FM.dtw_fill(q, r, band)
    mine = full[:, :, 1:-1]
    port = port_dtw._fill_banded(q[..., None], r[..., None], band, n, n)
    finite = port < 1e30
    assert torch.equal(finite, mine < 1e30)
    rel = (mine - port).abs()[finite] / port.abs()[finite].clamp_min(1e-6)
    assert float(rel.max()) < 1e-5   # one add a cell here, a log-step scan's sums there
    qs, rs, cs, ln = port_dtw._backtrack_banded(port, band, n, n)
    padded = torch.nn.functional.pad(port, (1, 1), value=float("inf"))
    moves = FM.walk_moves(padded).numpy()
    for p in range(2):
        a, b = FM.dtw_walk(moves[p], band, n, n)
        assert a.size == int(ln[p])
        assert np.array_equal(a - 1, qs[p, : a.size].numpy()) and np.array_equal(b - 1, rs[p, : a.size].numpy())
    # the whole path scores on the reference's own fill
    got = FM.dtw_align(q, r, band, 256)
    assert got["offset_samples"][0] == -7 * 256 or got["offset_samples"][0] == 7 * 256


def test_monitor_reference_matches_fleet_monitor_on_the_cpu():
    from benchmark.drivers.fleet_monitor import Driver

    cell, cfg, tr = _tiny_monitor()
    d = Driver(cfg, tr, cell.check, 123456789012, "cpu")
    d.run_calls(2)
    calls = d.calls[-2:]
    want = [d.expected(FM, c, lowp=False) for c in calls]
    got = d.compare(FM, calls, want)
    assert got["confident_latency_max_abs_samples"] == 0.0
    assert got["method_mismatches"] == 0.0
    assert got["stream_time_max_abs_s"] == 0.0
    # the energies sum in another order, and a DTW path's near-ties move
    # its scores: 2.3e-4 read here on a related pair that fails the gate
    assert got["confidence_max_abs"] < 1e-3 and got["similarity_max_abs"] < 1e-3
    # the reference one precision lower (the control) moves them further
    low = d.compare(FM, [d.as_program(d.expected(FM, c, lowp=True)) for c in calls], want)
    assert low["confidence_max_abs"] > 3 * got["confidence_max_abs"]


def test_features_reference_matches_the_ports_cpu_path():
    from sonido_sonar_tpu_torch.parallel.pipeline import batched_fingerprint_features
    from benchmark.traffic import pcm_clips

    cell = S.Cell("backfill.stream-30s")
    t = dict(cell.traffic, batch=4, clip_seconds=1, distinct=1)
    pcm = pcm_clips.make(t, 2**31 + 5, "cpu", 44100)[0]
    port = batched_fingerprint_features(pcm, device="cpu")
    mine = FF.features(pcm, cell.config)
    assert sorted(port) == sorted(FF.KEYS)
    gaps = FF.compare([port], [mine])
    assert max(gaps.values()) == 0.0, gaps   # the same float32 operations in the same order


def test_compare_reads_inf_for_a_missing_or_broken_key():
    x = {k: torch.ones(2, 3) for k in FF.KEYS}
    broken = dict(x, mfcc=torch.full((2, 3), float("nan")))
    broken.pop("chroma")
    got = FF.compare([broken], [x])
    assert set(got) == set(FF.NAMES) and all(v == float("inf") for v in got.values())
    assert all(v == 0.0 for v in FF.compare([x], [x]).values())
