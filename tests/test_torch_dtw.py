"""The port's DTW (dense and banded) held to the JAX package on the CPU.

The banded fill and backtrack of `sonido_sonar_tpu_torch/ops/stats/dtw.py`
are the plain versions of the CUDA kernels in `csrc/dtw.cu`; here they
are held to JAX's lax versions (`dtw._fill_banded`, `_backtrack_banded`)
and to its three Pallas fills and the Pallas backtrack in interpret mode,
at the shapes of tests/test_pallas_dtw.py. On a CPU tensor each wrapper
runs its plain version without building anything; the kernels are held
to the plain versions on the card by chip_smoke.py. Tolerances are those
of sonido_sonar_tpu_torch/utils/parity.py.
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
