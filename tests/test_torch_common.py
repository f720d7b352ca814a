"""The port's `ops/common.py` and `ops/fft.py` held to the JAX package on
the CPU: twins of `tests/test_common.py` (the same seeded input through
both packages), plus the traps: standard deviations over N, the
even-window "same" moving average and median filter (windows 4 and 5),
the interpolators at indices below 0 and above n - 1, and resampling's
float32 index product. Tolerances: utils/parity.py (OPS_*)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.ops import common as J  # noqa: E402
from sonido_sonar_tpu.ops import fft as JFFT  # noqa: E402
from sonido_sonar_tpu_torch.ops import common as C  # noqa: E402
from sonido_sonar_tpu_torch.ops import fft as FFT  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, ref, rtol=parity.OPS_RTOL, atol=parity.OPS_ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _rows(seed, shape=(4, 257)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if len(shape) == 2 and shape[0] > 2:
        x[1] = rng.standard_t(1.5, shape[-1]).astype(np.float32)   # heavy tails: the adaptive switch
        x[2] = 0.5                                                  # a constant row: the eps guards
    return x


@pytest.mark.parametrize("method", sorted(J._NORMALIZERS))
def test_normalizers_match_jax(method):
    x = _rows(1)
    _close(C.normalize(_t(x), method), J.normalize(jnp.asarray(x), method), atol=1e-5)


def test_std_over_n_and_unknown_normalizer():
    x = _t([[1.0, 2.0, 3.0, 6.0]])
    z = C.z_score_normalize(x)
    assert float(z.pow(2).mean()) == pytest.approx(1.0, abs=1e-6)   # N, not N - 1
    assert float(torch.std(z, dim=-1)) != pytest.approx(1.0, abs=1e-3)
    _close(z, J.z_score_normalize(jnp.asarray(x.numpy())))
    with pytest.raises(ValueError):
        C.normalize(x, "nope")


def test_quantile_and_robust_normalize_match_jax():
    x = _rows(2, (3, 1000))
    _close(C.quantile_normalize(_t(x), 0.1, 0.9), J.quantile_normalize(jnp.asarray(x), 0.1, 0.9), atol=1e-5)
    x4 = _t([[1.0, 2.0, 10.0, 3.0]])                            # even count: medians average
    _close(C.robust_normalize(x4), J.robust_normalize(jnp.asarray(x4.numpy())))


@pytest.mark.parametrize("target", [-23.0, -14.0])
def test_normalize_db_and_lufs_match_jax(target):
    x = 0.2 * _rows(3, (2, 16000))
    x[1, :4000] = 0.0
    _close(C.normalize_db(_t(x), target), J.normalize_db(jnp.asarray(x), target), atol=1e-5)
    for sr in (16000, 80000):                                   # 80 kHz: a window past the clip
        _close(C.normalize_lufs(_t(x), target, sr), J.normalize_lufs(jnp.asarray(x), target, sr), atol=1e-5)


@pytest.mark.parametrize("fn", ["interp_linear", "interp_cubic", "interp_hermite", "interp_lanczos"])
def test_interpolators_clip_indices_as_jax(fn):
    data = _rows(4, (2, 17))
    index = np.array([-3.7, -1.0, -0.25, 0.0, 0.5, 3.25, 7.999, 15.5, 16.0, 16.75, 19.2], np.float32)
    _close(getattr(C, fn)(_t(data), _t(index)), getattr(J, fn)(jnp.asarray(data), jnp.asarray(index)), atol=1e-5)


def test_linear_extrapolates_from_clipped_index():
    data = _t([1.0, 3.0, 4.0])
    # below 0: t = index - 0, so 1 * (1 - t) + 3 * t at t = -1 gives -1
    assert C.interp_linear(data, _t([-1.0])).tolist() == pytest.approx([-1.0])
    # above n - 1: i0 = i1 = 2, the last value
    assert C.interp_linear(data, _t([3.5])).tolist() == pytest.approx([4.0 * (1 - 1.5) + 4.0 * 1.5])


@pytest.mark.parametrize("method", ["linear", "cubic", "hermite", "lanczos"])
def test_resample_matches_jax(method):
    x = _rows(5, (2, 4410))
    for rates in ((44100, 16000), (16000, 22050), (8000, 8000)):
        got = C.resample_signal(_t(x), *rates, method)
        ref = J.resample_signal(jnp.asarray(x), *rates, method)
        assert got.shape == ref.shape
        _close(got, ref, atol=1e-5)


def test_resample_index_is_a_float32_product():
    n_out, ratio = 480000, 44100 / 16000
    got = C.resample_signal(torch.arange(1323000, dtype=torch.float32), 44100, 16000)
    want = np.arange(n_out, dtype=np.float32) * np.float32(ratio)
    np.testing.assert_array_equal(got.numpy(), want)             # the data is its index
    assert (want != (np.arange(n_out) * ratio).astype(np.float32)).any()


def test_bilinear_matches_jax():
    g = _rows(6, (5, 7))
    yi = np.array([-1.0, 0.5, 2.25, 4.0, 5.5], np.float32)
    xi = np.array([0.0, 1.5, 6.9, -0.5, 7.5], np.float32)
    _close(C.bilinear_interpolate(_t(g), _t(yi), _t(xi)), J.bilinear_interpolate(jnp.asarray(g), jnp.asarray(yi), jnp.asarray(xi)))


@pytest.mark.parametrize("window", [1, 2, 4, 5, 8])
def test_moving_average_same_matches_numpy_and_jax(window):
    x = _rows(7, (3, 50))
    got = C.moving_average(_t(x), window)
    _close(got, J.moving_average(jnp.asarray(x), window))
    _close(got, np.stack([np.convolve(r, np.ones(window) / window, mode="same") for r in x]))
    if window == 4:                                          # conv1d's "same" centres it elsewhere
        conv = torch.nn.functional.conv1d(_t(x)[:, None], torch.full((1, 1, 4), 0.25), padding="same")[:, 0]
        assert float((conv - got).abs().max()) > 0.1


@pytest.mark.parametrize("window", [3, 4, 5, 6])
def test_median_filter_matches_jax(window):
    x = _rows(8, (3, 40))
    x[0, 7] = np.nan
    _close(C.median_filter(_t(x), window), J.median_filter(jnp.asarray(x), window))


def test_correlation_covariance_regression_match_jax():
    x = _rows(9, (3, 64))
    y = 2.0 * x + _rows(10, (3, 64)) * 0.1
    y[2] = 0.5
    for fn in ("correlation", "covariance"):
        _close(getattr(C, fn)(_t(x), _t(y)), getattr(J, fn)(jnp.asarray(x), jnp.asarray(y)), atol=1e-5)
    for g, r in zip(C.linear_regression(_t(x), _t(y)), J.linear_regression(jnp.asarray(x), jnp.asarray(y))):
        _close(g, r, atol=1e-5)
    assert float(C.covariance(_t([[1.0, 2.0, 3.0]]), _t([[1.0, 2.0, 3.0]]))) == pytest.approx(1.0)  # N - 1


@pytest.mark.parametrize("min_distance", [1, 3, 10])
def test_find_peaks_matches_jax(min_distance):
    x = np.abs(_rows(11, (3, 120)))
    x[2, 40:50] = 5.0                                       # a plateau: no strict maximum
    x[2, 60] = x[2, 64] = 7.0                               # equal peaks: the first wins
    for height in (0.0, 1.0):
        got = C.find_peaks(_t(x), height, min_distance, max_peaks=12)
        ref = J.find_peaks(jnp.asarray(x), height, min_distance, max_peaks=12)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            assert g.dtype == {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}[np.asarray(r).dtype]


def test_next_power_of_two_and_buffers_match_jax():
    for n in (0, 1, 5, 1024, 1025):
        assert C.next_power_of_two(n) == J.next_power_of_two(n)
    data = np.arange(12, dtype=np.float32)
    for mod in (C, J):
        cb = mod.CircularBuffer(8)
        assert cb.write(data) == 8 and cb.is_full
        assert cb.peek(3).tolist() == [0, 1, 2] and cb.read(5).tolist() == [0, 1, 2, 3, 4]
        assert cb.write(data[:3]) == 3 and cb.read(10).tolist() == [5, 6, 7, 0, 1, 2]
        assert cb.is_empty and cb.space() == 8
    for a, b in ((C.SlidingWindow(4, 2), J.SlidingWindow(4, 2)), (C.OverlapAddBuffer(4, 2), J.OverlapAddBuffer(4, 2))):
        for chunk in (data[:5], data[5:6], data[6:10]):
            if isinstance(a, C.SlidingWindow):
                np.testing.assert_array_equal(a.add_samples(chunk), b.add_samples(chunk))
            elif len(chunk) == 4:
                np.testing.assert_array_equal(a.add_frame(chunk), b.add_frame(chunk))
    d1, d2 = C.DelayLine(5), J.DelayLine(5)
    for i, v in enumerate(data):
        assert d1.process(v, 3) == d2.process(v, 3)
        assert d1.process_interpolated(v, 1.25 + i % 3) == d2.process_interpolated(v, 1.25 + i % 3)
    with pytest.raises(ValueError):
        C.OverlapAddBuffer(4, 2).add_frame(data[:3])


def test_fft_wrappers_match_jax():
    x = _rows(12, (2, 100))
    spec = FFT.compute(_t(x))
    jspec = JFFT.compute(jnp.asarray(x))
    _close(spec, jspec, atol=1e-4)
    _close(FFT.compute_inverse_real(spec, 100), JFFT.compute_inverse_real(jspec, 100), atol=1e-5)
    full = FFT.fft_complex(_t(x))
    _close(full, JFFT.fft_complex(jnp.asarray(x)), atol=1e-4)
    _close(FFT.compute_inverse(full).real, np.real(np.asarray(JFFT.compute_inverse(jnp.asarray(full.numpy())))), atol=1e-5)
