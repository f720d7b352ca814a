"""The port's DTW (dense and banded) held to the JAX package on the CPU.

The banded fill and backtrack of `sonido_sonar_tpu_torch/ops/stats/dtw.py`
are the plain versions of the CUDA kernels in `csrc/dtw.cu`; here they
are held to JAX's lax versions (`dtw._fill_banded`, `_backtrack_banded`)
and to its three Pallas fills and the Pallas backtrack in interpret mode,
at the shapes of tests/test_pallas_dtw.py. On a CPU tensor each wrapper
runs its plain version without building anything; the kernels are held
to the plain versions on the card by chip_smoke.py. The numpy model of
the backtrack kernel's walk (its ring of staged rows and the reads that
miss it, `hopper_backtrack.walk_model`) is held to the plain walk bit for
bit, on bands whose path is designed (utils/parity.prescribed_path_band)
and on filled bands. Tolerances are those of
sonido_sonar_tpu_torch/utils/parity.py.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.ops.stats import dtw as jdtw  # noqa: E402
from sonido_sonar_tpu.ops.stats.pallas_backtrack import backtrack_banded_pallas_batch  # noqa: E402
from sonido_sonar_tpu.ops.stats.pallas_dtw import (  # noqa: E402
    _banded_local_distances,
    fill_banded_pallas_batch,
    fill_banded_pallas_scan_batch,
    fill_banded_pallas_scan_pairs,
)
from sonido_sonar_tpu_torch import _build  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import dtw as tdtw  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import hopper_backtrack  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats.hopper_backtrack import backtrack_banded_hopper  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats.hopper_dtw import (  # noqa: E402
    fill_banded_hopper,
    fill_rows_hopper,
    local_distances_hopper,
)
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)


def _pairs(seed, b, n, m, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, d)).astype(np.float32),
            rng.normal(size=(b, m, d)).astype(np.float32))


def _require(report):
    errors, failures = report
    assert not failures, (failures, errors)
    return errors


@pytest.mark.parametrize("n,m,band,d", [
    (200, 200, 20, 12),
    (300, 290, 15, 5),    # query longer than reference
    (290, 300, 15, 5),    # reference longer than query
    (97, 100, 8, 1),      # scalar features
    (257, 250, 64, 13),
    (128, 120, 120, 6),   # band ~ sequence length (the lag-budget shape)
])
def test_fill_plain_matches_lax_fill(n, m, band, d):
    q, r = _pairs(7, 2, n, m, d)
    got = fill_banded_hopper(torch.from_numpy(q), torch.from_numpy(r), band, n, m).numpy()
    for b in range(2):
        ref = np.asarray(jdtw._fill_banded(jnp.asarray(q[b]), jnp.asarray(r[b]), band, n, m))
        _require(parity.check_fill(got[b], ref))


@pytest.mark.parametrize("n,m,band,d", [
    (33, 30, 1, 3),      # one row past a chunk boundary, n > m, minimal band
    (70, 64, 64, 12),    # band width past one lane tile
])
def test_fill_plain_matches_pallas_fill(n, m, band, d):
    """K6's fused fill (interpret mode) at the edge shapes of
    tests/test_pallas_dtw.py:193-201."""
    q, r = _pairs(n * 1000 + m, 2, n, m, d)
    got = fill_banded_hopper(torch.from_numpy(q), torch.from_numpy(r), band, n, m).numpy()
    ref = np.asarray(fill_banded_pallas_batch(jnp.asarray(q), jnp.asarray(r), band, n, m,
                                              interpret=True))
    _require(parity.check_fill(got, ref))


@pytest.mark.parametrize("n,m,band,d,b", [
    (100, 100, 10, 3, 3),
    (97, 100, 8, 1, 8),      # d = 1 energy series, a full sublane tile of pairs
    (128, 120, 120, 6, 2),   # band ~ sequence length
])
def test_fill_plain_matches_pallas_scan_fills(n, m, band, d, b):
    """K7's DP-only scan and K5's pairs fill (interpret mode) at the
    shapes of tests/test_pallas_dtw.py:301-308."""
    q, r = _pairs(23, b, n, m, d)
    got = fill_banded_hopper(torch.from_numpy(q), torch.from_numpy(r), band, n, m).numpy()
    for fill in (fill_banded_pallas_scan_batch, fill_banded_pallas_scan_pairs):
        ref = np.asarray(fill(jnp.asarray(q), jnp.asarray(r), band, n, m, interpret=True))
        _require(parity.check_fill(got, ref))


@pytest.mark.parametrize("d", [1, 12])
@pytest.mark.parametrize("n,m,band", [
    (40, 36, 40),     # band >= m: every row holds the whole reference
    (120, 100, 25),   # query longer than reference
    (100, 120, 25),   # reference longer than query
])
def test_local_distances_plain_matches_jax(n, m, band, d):
    """The plain pre-pass against JAX's band distances (the input of K7's
    scan kernel): rows 1..n equal `_banded_local_distances(...)[..., :w]`
    within utils/parity.check_local_distances (JAX contracts with a
    HIGHEST-precision dot_general, the port with products and a sum, so
    the cells differ where the expansion cancels); row 0 is the fill's
    first row."""
    q, r = _pairs(5 * n + m + d, 2, n, m, d)
    w = 2 * band + 1
    got = local_distances_hopper(torch.from_numpy(q), torch.from_numpy(r), band, n, m).numpy()
    assert got.shape == (2, n + 1, w)
    ref = np.asarray(_banded_local_distances(jnp.asarray(q), jnp.asarray(r), band, n, m, w))
    _require(parity.check_local_distances(got[:, 1:], ref, q, r))
    row0 = np.where(np.arange(w) == band, 0.0, tdtw.BIG).astype(np.float32)
    np.testing.assert_array_equal(got[:, 0], np.broadcast_to(row0, (2, w)))


@pytest.mark.parametrize("n,m,band,d", [(60, 64, 10, 3), (50, 40, 50, 1)])
def test_plain_fill_is_the_prepass_then_the_rows(n, m, band, d):
    """The plain fill is the plain pre-pass followed by the plain row
    recurrence, bit for bit, as the kernels compose it; the recurrence
    writes its band in place and leaves row 0 as the pre-pass set it."""
    q, r = (torch.from_numpy(a) for a in _pairs(n + m, 2, n, m, d))
    local = local_distances_hopper(q, r, band, n, m)
    row0 = local[:, 0].clone()
    out = fill_rows_hopper(local, band, n, m)
    assert out is local
    torch.testing.assert_close(out, tdtw._fill_banded(q, r, band, n, m), rtol=0, atol=0)
    torch.testing.assert_close(out[:, 0], row0, rtol=0, atol=0)
    single = tdtw._fill_banded_rows(tdtw._banded_local_distances(q[0], r[0], band, n, m),
                                    band, n, m)
    torch.testing.assert_close(single, out[0], rtol=0, atol=0)


def test_prepass_and_rows_wrappers_on_cpu_and_their_refusals(monkeypatch):
    """The pre-pass and recurrence wrappers take their plain versions on a
    CPU tensor without building or counting, and refuse what their
    kernels cannot take with KernelError."""
    def no_build():
        raise AssertionError("built on the CPU")

    monkeypatch.setattr(_build, "build", no_build)
    q, r = (torch.from_numpy(a) for a in _pairs(2, 2, 30, 33, 2))
    before = (local_distances_hopper.launches, fill_rows_hopper.launches)
    local = local_distances_hopper(q, r, 5, 30, 33)
    torch.testing.assert_close(local, tdtw._banded_local_distances(q, r, 5, 30, 33),
                               rtol=0, atol=0)
    fill_rows_hopper(local, 5, 30, 33)
    assert (local_distances_hopper.launches, fill_rows_hopper.launches) == before
    meta = torch.zeros((1, 4, 2), device="meta")
    with pytest.raises(_build.KernelError):
        local_distances_hopper(meta, meta, 2, 4, 4)
    with pytest.raises(_build.KernelError):
        fill_rows_hopper(torch.zeros((1, 5, 5), device="meta"), 2, 4, 4)


@pytest.mark.parametrize("n,m,band,d", [(120, 120, 12, 4), (97, 100, 8, 1), (70, 64, 64, 12)])
def test_backtrack_plain_matches_jax_on_one_band(n, m, band, d):
    """On one shared cost band (JAX's) the plain backtrack equals both
    the lax backtrack and K8 in interpret mode: paths and lengths exactly,
    path costs within the parity bound."""
    q, r = _pairs(3 * n + m, 2, n, m, d)
    band_j = jnp.stack([jdtw._fill_banded(jnp.asarray(q[b]), jnp.asarray(r[b]), band, n, m)
                        for b in range(2)])
    got = backtrack_banded_hopper(torch.from_numpy(np.array(band_j)), band, n, m)
    assert [t.dtype for t in got] == [torch.int32, torch.int32, torch.float32, torch.int32]
    assert got[0].shape == (2, n + m) and got[3].shape == (2,)
    pallas = backtrack_banded_pallas_batch(band_j, band, n, m, interpret=True)
    _require(parity.check_backtrack([t.numpy() for t in got], [np.asarray(t) for t in pallas]))
    for b in range(2):
        lax = jdtw._backtrack_banded(band_j[b], band, n, m)
        _require(parity.check_backtrack([t[b].numpy() for t in got], [np.asarray(t) for t in lax]))


# Prescribed-path bands (utils/parity.prescribed_path_band): runs of moves
# from (n, m) to (0, 0), the band, the ring's (rows, cols) in the model,
# and the band columns k = j - i + band the walk must reach.
_SQUARE_RUNS = (("D", 3), ("U", 150), ("D", 3), ("L", 300), ("D", 3), ("U", 150), ("D", 10))
_NARROW_RUNS = (("D", 5), ("U", 10), ("D", 5), ("L", 20), ("D", 5), ("U", 10), ("D", 20))
PRESCRIBED = {
    # left run 300 > C, up runs 150 > C / 2, k = w - 1 then k = 0
    "runs_square": (_SQUARE_RUNS, 150, 8, 32, (0, 300)),
    "runs_square_kernel_ring": (_SQUARE_RUNS, 150, hopper_backtrack.RING_ROWS,
                                hopper_backtrack.RING_COLS, (0, 300)),
    # n = 200 != m = 260; reaches row 0 at j = 72 (k = w - 1), then 72
    # steps left along i = 0
    "border_i0": ((("D", 5), ("L", 40), ("D", 3), ("U", 20), ("D", 140), ("U", 32), ("L", 72)),
                  72, 8, 32, (73, 144)),
    # n = 180 != m = 150; reaches column 0 at i = 40 (k = 0), then 40 steps
    # up along j = 0
    "border_j0": ((("D", 10), ("U", 30), ("D", 100), ("L", 40), ("U", 40)), 40, 8, 32, (0, 40)),
    # w = 21 < C: the whole row is the window, less its unaligned ends
    "narrow_band": (_NARROW_RUNS, 10, 8, 32, (0, 20)),
    "narrow_band_kernel_ring": (_NARROW_RUNS, 10, hopper_backtrack.RING_ROWS,
                                hopper_backtrack.RING_COLS, (0, 20)),
}


def _longest_run(steps, move):
    best = run = 0
    for s in steps:
        run = run + 1 if s == move else 0
        best = max(best, run)
    return best


@pytest.mark.parametrize("case", list(PRESCRIBED))
def test_walk_model_on_prescribed_paths(case):
    """The numpy model of the kernel's walk (its ring of staged rows, the
    windows' aligned middles, the reads that miss) equals the plain walk
    bit for bit on a band whose path is designed, at every 16-byte offset
    of the band; the plain walk follows the design and equals JAX's lax
    backtrack and K8 in interpret mode. The designed runs happen (the
    band columns reached, the run lengths) and the model's reads miss."""
    runs, band, rows, cols, (k_lo, k_hi) = PRESCRIBED[case]
    cost, ii, jj = parity.prescribed_path_band(runs, band, seed=len(case))
    n, m = int(ii[0]), int(jj[0])
    plain = tdtw._backtrack_banded(cost, band, n, m)
    length = int(plain[3])
    assert length == len(ii)
    np.testing.assert_array_equal(plain[0][:length].numpy(), ii[::-1] - 1)
    np.testing.assert_array_equal(plain[1][:length].numpy(), jj[::-1] - 1)
    kk = jj - ii + band
    assert (int(kk.min()), int(kk.max())) == (k_lo, k_hi)
    for offset in range(4):
        *model, model_len, misses = hopper_backtrack.walk_model(cost.numpy(), band, n, m, rows,
                                                                cols, offset)
        assert model_len == length
        for got, want in zip(model, plain[:3]):
            np.testing.assert_array_equal(got.view(np.int32), want.numpy().view(np.int32))
        assert misses > 0, offset
    steps = [("U" if di else "L") if di != dj else "D"
             for di, dj in zip(-np.diff(ii), -np.diff(jj))]
    if case.startswith("runs_square"):
        assert _longest_run(steps, "L") > cols and _longest_run(steps, "U") > cols // 2
    band_j = jnp.asarray(cost.numpy())
    lax = jdtw._backtrack_banded(band_j, band, n, m)
    _require(parity.check_backtrack([t.numpy() for t in plain], [np.asarray(t) for t in lax]))
    pallas = backtrack_banded_pallas_batch(band_j[None], band, n, m, interpret=True)
    _require(parity.check_backtrack([t.numpy() for t in plain],
                                    [np.asarray(t)[0] for t in pallas]))


@pytest.mark.parametrize("n,m,band,d", [(120, 120, 12, 4), (97, 100, 8, 1), (300, 280, 40, 1)])
def test_walk_model_matches_plain_on_filled_bands(n, m, band, d):
    """On bands the plain fill gives, the model's walk equals the plain
    walk bit for bit at the kernel's ring and at a small one."""
    q, r = (torch.from_numpy(a) for a in _pairs(n * m, 1, n, m, d))
    cost = tdtw._fill_banded(q, r, band, n, m)
    plain = tdtw._backtrack_banded(cost, band, n, m)
    for rows, cols in ((hopper_backtrack.RING_ROWS, hopper_backtrack.RING_COLS), (2, 8)):
        *model, model_len, _ = hopper_backtrack.walk_model(cost[0].numpy(), band, n, m, rows, cols)
        assert model_len == int(plain[3][0])
        for got, want in zip(model, plain[:3]):
            np.testing.assert_array_equal(got.view(np.int32), want[0].numpy().view(np.int32))


def test_ring_constants_match_the_kernel():
    """The model's default ring is the kernel's (csrc/dtw.cu)."""
    src = (_build._PKG / "csrc" / "dtw.cu").read_text()
    assert f"kRingRows = {hopper_backtrack.RING_ROWS};" in src
    assert f"kRingCols = {hopper_backtrack.RING_COLS};" in src
    assert hopper_backtrack.RING_COLS % 4 == 0
    assert hopper_backtrack.RING_ROWS & (hopper_backtrack.RING_ROWS - 1) == 0


@pytest.mark.parametrize("runs,band", [
    ((("U", 2), ("L", 2), ("D", 1)), 5),   # an up step next to a left step
    ((("U", 8), ("D", 2), ("L", 8)), 3),   # a path cell outside the band
    ((("D", 2), ("X", 1)), 5),             # not a move
])
def test_prescribed_path_band_refuses_what_the_walk_would_not_follow(runs, band):
    with pytest.raises(ValueError):
        parity.prescribed_path_band(runs, band, seed=0)


def test_misses_launcher_refuses_what_the_kernel_cannot_take():
    """backtrack_banded_misses launches the kernel only: a CPU or meta
    band is a KernelError, and the wrapper's launch count stays put."""
    before = backtrack_banded_hopper.launches
    for dev in ("cpu", "meta"):
        with pytest.raises(_build.KernelError):
            hopper_backtrack.backtrack_banded_misses(torch.zeros((1, 5, 5), device=dev), 2, 4, 4)
    assert backtrack_banded_hopper.launches == before


@pytest.mark.parametrize("pattern", ["symmetric2", "asymmetric", "symmetric1"])
@pytest.mark.parametrize("n,m,band", [(60, 55, -1), (40, 48, 10)])
def test_dense_dtw_align_matches_jax(pattern, n, m, band):
    q, r = _pairs(11 + n, 1, n, m, 3)
    j = jdtw.dtw_align(jnp.asarray(q[0]), jnp.asarray(r[0]), pattern, band)
    t = tdtw.dtw_align(torch.from_numpy(q[0]), torch.from_numpy(r[0]), pattern, band)
    assert int(t.path_length) == int(j.path_length)
    np.testing.assert_array_equal(t.path_qidx.numpy(), np.asarray(j.path_qidx))
    np.testing.assert_array_equal(t.path_ridx.numpy(), np.asarray(j.path_ridx))
    np.testing.assert_allclose(t.path_cost.numpy(), np.asarray(j.path_cost), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(t.distance), float(j.distance), rtol=1e-5)
    jq, tq = jdtw.alignment_quality(j), tdtw.alignment_quality(t)
    for key in jq:
        np.testing.assert_allclose(float(tq[key]), float(jq[key]), rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "manhattan", "cosine"])
def test_local_distance_matrix_matches_jax(metric):
    q, r = _pairs(5, 1, 30, 25, 4)
    j = jdtw.local_distance_matrix(jnp.asarray(q[0]), jnp.asarray(r[0]), metric)
    t = tdtw.local_distance_matrix(torch.from_numpy(q[0]), torch.from_numpy(r[0]), metric)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m,band", [(150, 140, 30), (200, 200, 16)])
def test_dtw_align_banded_matches_jax(n, m, band):
    """dtw_align_banded runs the wrappers (plain on the CPU); it agrees
    with JAX and, on every in-band cell, with the dense fill."""
    q, r = _pairs(n + 2 * m, 1, n, m, 2)
    j = jdtw.dtw_align_banded(jnp.asarray(q[0]), jnp.asarray(r[0]), band)
    t = tdtw.dtw_align_banded(torch.from_numpy(q[0]), torch.from_numpy(r[0]), band)
    _require(parity.check_fill(t.cost_matrix.numpy(), np.asarray(j.cost_matrix)))
    assert int(t.path_length) == int(j.path_length)
    np.testing.assert_array_equal(t.path_qidx.numpy(), np.asarray(j.path_qidx))
    np.testing.assert_allclose(float(t.distance), float(j.distance), rtol=1e-5)
    dense = tdtw.dtw_align(torch.from_numpy(q[0]), torch.from_numpy(r[0]), constraint_band=band)
    np.testing.assert_allclose(float(t.raw_distance), float(dense.raw_distance), rtol=1e-5)
    with pytest.raises(ValueError):
        tdtw.dtw_align_banded(torch.zeros(50, 2), torch.zeros(10, 2), 5)


def test_wrappers_take_plain_version_on_cpu(monkeypatch):
    """A CPU tensor never builds or launches: the wrappers give the plain
    versions' results and their launch counts stay put."""
    def no_build():
        raise AssertionError("built on the CPU")

    monkeypatch.setattr(_build, "build", no_build)
    q, r = _pairs(1, 2, 40, 42, 3)
    before = (fill_banded_hopper.launches, backtrack_banded_hopper.launches)
    cost = fill_banded_hopper(torch.from_numpy(q), torch.from_numpy(r), 6, 40, 42)
    torch.testing.assert_close(cost, tdtw._fill_banded(torch.from_numpy(q), torch.from_numpy(r),
                                                       6, 40, 42), rtol=0, atol=0)
    path = backtrack_banded_hopper(cost, 6, 40, 42)
    plain = tdtw._backtrack_banded(cost, 6, 40, 42)
    assert all(torch.equal(a, b) for a, b in zip(path, plain))
    assert (fill_banded_hopper.launches, backtrack_banded_hopper.launches) == before


def test_wrappers_refuse_other_devices():
    """An input the kernels cannot take is a KernelError, never the
    ValueError that the alignment handlers degrade on."""
    q = torch.zeros((1, 4, 2), device="meta")
    with pytest.raises(_build.KernelError):
        fill_banded_hopper(q, q, 2, 4, 4)
    with pytest.raises(_build.KernelError):
        backtrack_banded_hopper(torch.zeros((1, 5, 5), device="meta"), 2, 4, 4)


@pytest.mark.parametrize("entry", ["sonido_dtw_fill_banded", "sonido_dtw_backtrack_banded",
                                   "sonido_dtw_local_distances", "sonido_dtw_fill_rows"])
def test_cuda_error_of_an_entry_is_a_kernel_error(monkeypatch, entry):
    """A nonzero code from a C entry (dtw.cu returns cudaErrorInvalidValue
    for an input it refuses) comes out of `_build.call` as KernelError."""
    class Lib:
        def sonido_error_string(self, code):
            return b"invalid argument"

    setattr(Lib, entry, lambda self, *args: 1)
    monkeypatch.setattr(_build, "build", lambda: (Lib(), None))
    with pytest.raises(_build.KernelError, match=f"{entry} failed with CUDA error 1: invalid"):
        _build.call(entry, 0, 0, 0, 1, 1, 1, 1, 0, None)


def test_minplus_row_scan_matches_sequential():
    """The log-step scan solves D[j] = min(A[j], D[j-1] + c[j]) exactly as
    the sequential recurrence does on integer-valued inputs."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 50, (3, 37)).astype(np.float32)
    c = rng.integers(0, 5, (3, 37)).astype(np.float32)
    want = a.copy()
    for j in range(1, 37):
        want[:, j] = np.minimum(a[:, j], want[:, j - 1] + c[:, j])
    got = tdtw._minplus_row_scan(torch.from_numpy(a), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
