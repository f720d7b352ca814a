"""The roofline counts re-derive PERF.md's kernel bounds from their shapes."""

import pytest

from benchmark.core import spec as S
from benchmark.roofline import dtw, k1, k2, peaks

N = 30 * 44100


def test_k1_bound_is_the_bytes_at_the_main_path_shape():
    nbytes, ops = k1.counts(128, N, 1024, 256)
    assert k1.frames(N, 1024, 256) == 5164
    assert nbytes == 128 * N * 4 + 128 * 5164 * (513 + 5) * 4
    assert nbytes / peaks.PEAKS["hbm_bytes_per_s"] > ops / peaks.PEAKS["fp32_ops_per_s"]
    assert peaks.least_seconds(nbytes, ops) * 1e3 == pytest.approx(0.611, abs=5e-4)


def test_k2_bound_is_the_operations_at_1024_512():
    nbytes, ops = k2.counts(128, N, 1024, 512)
    assert k2.frames(N, 1024, 512) == 2582
    assert ops / peaks.PEAKS["fp32_ops_per_s"] > nbytes / peaks.PEAKS["hbm_bytes_per_s"]
    assert peaks.least_seconds(nbytes, ops) * 1e3 == pytest.approx(0.437, abs=5e-4)


def test_dtw_operations_at_the_fleet_geometry():
    n = (60 * 44100 - 1024) // 256 + 1
    band = (30 * 44100) // 256
    assert (n, band) == (10332, 5167)
    cfg = S.read_json(S.BENCH / "configs" / "cdn-monitor-64x60s.json")
    assert cfg["derived"] == {"frames": n, "dtw_band_frames": band,
                              "dtw_pairs_per_launch": cfg["measure_batch"]}
    nbytes, ops = dtw.counts(32, n, n, band)
    assert ops == 8 * 32 * 10333 * 10335
    assert nbytes == 32 * 2 * n * 4 + 32 * 2 * n * 12
    assert peaks.least_seconds(nbytes, ops) * 1e3 == pytest.approx(0.408, abs=5e-4)
