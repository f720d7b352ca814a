"""K9, the port's sort-free contrast band selection, held to the JAX
package on the CPU, and `ops/spectral.spectral_contrast`, which takes its
band means from K9's wrapper.

On a CPU tensor the wrapper runs its plain version (one sort per band);
these tests hold it to JAX's Pallas kernel in interpret mode (as
tests/test_pallas_contrast.py runs it), to a float64 numpy sort, and its
band constants to JAX's. The CUDA kernel is held to the plain version on
the card by chip_smoke.py (utils/parity.check_band_means).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import sonido_sonar_tpu.ops.pallas_contrast as jpc  # noqa: E402
from sonido_sonar_tpu.ops.spectral import contrast_band_edges as j_edges  # noqa: E402
from sonido_sonar_tpu_torch.ops import hopper_contrast  # noqa: E402
from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges, spectral_contrast  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)
SR = 44100
means = hopper_contrast.band_select_means_hopper


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jpc.pl, "pallas_call", interp)


def _mag(shape, seed=0):
    return np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _sorted_means(mag, edges):
    """float64 numpy: per band, the means of the top and bottom k powers."""
    p = np.asarray(mag, np.float64) ** 2
    f = p.shape[-1]
    peak, valley = [], []
    for b in range(len(edges) - 1):
        lo, hi = edges[b], min(edges[b + 1], f)
        if lo >= hi:
            peak.append(np.zeros(p.shape[:-1]))
            valley.append(np.zeros(p.shape[:-1]))
            continue
        k = max(int(0.2 * (hi - lo)), 1)
        band = np.sort(p[..., lo:hi], axis=-1)
        peak.append(band[..., -k:].mean(-1))
        valley.append(band[..., :k].mean(-1))
    return np.stack(peak, -1), np.stack(valley, -1)


@pytest.mark.parametrize("shape", [(2, 300, 513), (300, 257)])
def test_k9_plain_matches_pallas_interpret(interpret, shape):
    """rtol 2e-5, the JAX kernel tests' bound (tests/test_pallas_contrast.py
    :33-55): JAX's 22-bit quantized search fills its tie bucket with the
    bucket's mean (<= 2^-14 relative), the port takes a sort."""
    mag = _mag(shape)
    edges = contrast_band_edges(6, shape[-1], SR)
    peak, valley = means(torch.from_numpy(mag), edges)
    jpeak, jvalley = jpc.band_select_means_pallas(jnp.asarray(mag), edges)
    assert peak.shape == shape[:-1] + (6,) and peak.dtype == torch.float32
    errors, failures = parity.check_band_means(peak.numpy(), valley.numpy(),
                                               np.asarray(jpeak), np.asarray(jvalley))
    assert not failures, (failures, errors)


def test_k9_ties_and_zeros_match_pallas_interpret(interpret):
    """One band constant, the rest zero (tests/test_pallas_contrast.py
    :58-73): the constant band's means are its power, the zero bands' 0,
    exactly, in both packages."""
    f = 513
    edges = contrast_band_edges(6, f, SR)
    mag = np.zeros((1, 16, f), np.float32)
    mag[0, :, edges[3]:edges[4]] = 0.25
    peak, valley = (t.numpy() for t in means(torch.from_numpy(mag), edges))
    jpeak, jvalley = (np.asarray(t) for t in jpc.band_select_means_pallas(jnp.asarray(mag), edges))
    for got in (peak, valley, jpeak, jvalley):
        np.testing.assert_array_equal(got[0, :, 3], np.float32(0.0625))
        np.testing.assert_array_equal(got[0, :, [0, 1, 2, 4, 5]], 0.0)


@pytest.mark.parametrize("shape,bands", [((3, 40, 513), 6), ((50, 257), 4), ((7, 1025), 6)])
def test_k9_plain_matches_a_float64_sort(shape, bands):
    """The plain version is a float32 sort and mean: rtol 1e-6 of a
    float64 numpy sort."""
    mag = _mag(shape, seed=shape[-1])
    mag[..., 5:9] = 0.0  # zeros inside a band
    edges = contrast_band_edges(bands, shape[-1], SR)
    peak, valley = means(torch.from_numpy(mag), edges)
    want_peak, want_valley = _sorted_means(mag, edges)
    np.testing.assert_allclose(peak.numpy(), want_peak, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(valley.numpy(), want_valley, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("edges,f", [
    (None, 513), (None, 257), (None, 1025), ((0, 4, 4, 10, 600), 513), ((3, 9, 2, 50), 64),
])
def test_band_constants_equal_jax(edges, f):
    """_band_constants bit for bit, degenerate and clipped bands included;
    the kernel's (lo, hi, k) table is each indicator column's run."""
    edges = edges or contrast_band_edges(6, f, SR)
    if edges == contrast_band_edges(6, f, SR):
        assert edges == j_edges(6, f, SR)
    got = hopper_contrast._band_constants(tuple(edges), f)
    ref = jpc._band_constants(tuple(edges), f)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    table = hopper_contrast.band_table(tuple(edges), f)
    for b, (lo, hi, k) in enumerate(table.tolist()):
        want_lo, want_hi = edges[b], min(edges[b + 1], f)
        if want_lo >= want_hi:
            assert (lo, hi, k) == (0, 0, 1)
        else:
            assert (lo, hi, k) == (want_lo, want_hi, max(int(0.2 * (want_hi - want_lo)), 1))


def test_degenerate_bands_give_zero():
    mag = _mag((4, 64))
    peak, valley = means(torch.from_numpy(mag), (0, 4, 4, 10, 600))
    assert torch.equal(peak[:, 1], torch.zeros(4)) and torch.equal(valley[:, 1], torch.zeros(4))
    want_peak, want_valley = _sorted_means(mag, (0, 4, 4, 10, 600))
    np.testing.assert_allclose(peak.numpy(), want_peak, rtol=1e-6)
    np.testing.assert_allclose(valley.numpy(), want_valley, rtol=1e-6)


def test_k9_wrapper_plain_on_cpu_raises_elsewhere():
    mag = torch.from_numpy(_mag((2, 3, 10, 513)))
    edges = contrast_band_edges(6, 513, SR)
    before = means.launches
    got = means(mag, edges)
    ref = hopper_contrast.band_select_means_plain(mag, edges)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert means.launches == before
    assert got[0].shape == (2, 3, 10, 6)
    flat = means(mag.view(60, 513), edges)
    assert all(torch.equal(a.view(2, 3, 10, 6), b) for a, b in zip(flat, got))
    with pytest.raises(ValueError, match="no K9 kernel"):
        means(torch.empty((4, 513), device="meta"), edges)


def _case_magnitudes(kind, f, seed):
    """[3, 40, f] float32 magnitudes with the named hazard."""
    rng = np.random.default_rng(seed)
    mag = np.abs(rng.standard_normal((3, 40, f))).astype(np.float32)
    if kind == "ties":  # few levels: the k-th key sits in a run of equal keys
        mag = np.round(mag * 2.0).astype(np.float32) / 2.0
    elif kind == "zeros_subnormals":  # p = 0 and p below 2^-126
        mag[0] = 0.0
        mag[1] = (mag[1] * 1e-21).astype(np.float32)
        mag[2, :, ::3] = 0.0
    elif kind == "constant_band":
        mag[...] = 0.0
        mag[..., 20:300] = 0.5
    return mag


@pytest.mark.parametrize(
    "kind,f,sr,edges",
    [
        ("random", 513, 44100, None),
        ("ties", 513, 44100, None),
        ("zeros_subnormals", 513, 44100, None),
        ("constant_band", 513, 44100, None),
        ("random", 513, 44100, (0, 4, 4, 10, 600)),  # degenerate and clipped bands
        ("random", 1025, 44100, None),  # W = 2048: 35 keys on a lane
        ("random", 513, 22050, None),  # the 22.05 kHz edges
        ("ties", 257, 16000, None),
    ],
)
def test_band_means_model_matches_a_sort(interpret, kind, f, sr, edges):
    """The numpy replay of the kernel's lane plan (its rounds, packed
    counts, early end and tie fill): its k-th keys equal the sorted band's
    k-th values exactly, its means are within rtol 1e-6 of a float64 sort
    and within utils/parity.check_band_means of JAX's kernel in interpret
    mode (22-bit keys, not exact)."""
    mag = _case_magnitudes(kind, f, f + sr)
    edges = edges or contrast_band_edges(6, f, sr)
    peak, valley, k_top, k_bot, rounds = hopper_contrast.band_means_model(mag, edges)
    p = mag.astype(np.float32) ** 2
    for b, (lo, hi, k) in enumerate(hopper_contrast.band_table(tuple(edges), f).tolist()):
        if lo >= hi:
            assert not peak[..., b].any() and not valley[..., b].any()
            continue
        ordered = np.sort(p[..., lo:hi], axis=-1)
        np.testing.assert_array_equal(k_top[..., b].view(np.float32), ordered[..., hi - lo - k])
        np.testing.assert_array_equal(k_bot[..., b].view(np.float32), ordered[..., k - 1])
    want_peak, want_valley = _sorted_means(mag, edges)
    np.testing.assert_allclose(peak, want_peak, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(valley, want_valley, rtol=1e-6, atol=1e-12)
    jpeak, jvalley = jpc.band_select_means_pallas(jnp.asarray(mag), edges)
    errors, failures = parity.check_band_means(peak, valley, np.asarray(jpeak), np.asarray(jvalley))
    assert not failures, (failures, errors)
    assert ((rounds >= 1) & (rounds <= 31)).all()
    if kind == "constant_band":
        assert (rounds == 31).all()  # every bucket of equal keys runs to bit 0


@pytest.mark.parametrize(
    "edges,f,fits",
    [
        (None, 513, True), (None, 1025, True), (None, 257, True),
        (None, 2049, True),  # 70 keys a lane: the kernel takes its general form
        ((0, 4, 4, 10, 600), 513, True), ((3, 9, 2, 50), 64, True),
        (tuple(range(0, 34)), 64, False),  # 33 bands
        ((0, 70000), 70001, False),  # counts past 16 bits
    ],
)
def test_band_plan_covers_each_band_once(edges, f, fits):
    """Each band's bins are held once, by an aligned power-of-two group of
    lanes, K the most keys a lane holds; tables with no plan give K = 0
    (the kernel's general form)."""
    edges = edges or contrast_band_edges(6, f, SR)
    lanes, keys, gmax = hopper_contrast.band_plan(tuple(edges), f)
    assert lanes.shape == (32, 4) and lanes.dtype == np.int32
    if not fits:
        assert keys == 0 and (lanes[:, 0] == -1).all()
        return
    assert keys == lanes[:, 3].max() >= 1
    table = hopper_contrast.band_table(tuple(edges), f)
    for b, (lo, hi, _) in enumerate(table.tolist()):
        mine = np.flatnonzero(lanes[:, 0] == b)
        if lo >= hi:
            assert mine.size == 0
            continue
        g = mine.size
        assert g & (g - 1) == 0 and mine[0] % g == 0 and (np.diff(mine) == 1).all()
        assert (lanes[mine, 2] == g).all() and gmax >= g
        held = np.concatenate([lanes[i, 1] + g * np.arange(lanes[i, 3]) for i in mine])
        assert sorted(held.tolist()) == list(range(lo, hi))


# -- spectral_contrast: its band means from K9's wrapper ----------------------

def _contrast_sort_loop(magnitude, sample_rate, num_bands):
    """spectral_contrast as one sort per band (its form before it took its
    band means from K9), kept to hold the CPU path to its bits."""
    n_bins = magnitude.shape[-1]
    edges = contrast_band_edges(num_bands, n_bins, sample_rate)
    power = magnitude * magnitude
    outs = []
    for b in range(num_bands):
        lo, hi = edges[b], min(edges[b + 1], n_bins)
        if lo >= hi:
            outs.append(magnitude.new_zeros(magnitude.shape[:-1]))
            continue
        width = hi - lo
        k = max(int(0.2 * width), 1)
        ordered = torch.sort(power[..., lo:hi], dim=-1).values
        valley = torch.clamp_min(torch.mean(ordered[..., :k], dim=-1), 1e-10)
        peak = torch.mean(ordered[..., width - k:], dim=-1)
        outs.append(torch.where(peak > 0, 10.0 * torch.log10(peak / valley), 0.0))
    return torch.stack(outs, dim=-1)


def _contrast_magnitudes(kind, f, seed):
    """[3, 40, f] float32 magnitudes; "hazards": tied powers (few levels),
    all-zero frames and one band's bins all zero."""
    mag = _mag((3, 40, f), seed)
    if kind == "hazards":
        mag = np.round(mag * 2.0).astype(np.float32) / 2.0
        mag[0, :7] = 0.0
        mag[1, :, : max(f // 4, 1)] = 0.0
    return mag


@pytest.mark.parametrize(
    "kind,f,sr,bands",
    [
        ("random", 513, 44100, 6),  # the backfill's slice
        ("random", 513, 16000, 6),
        ("random", 513, 22050, 6),
        ("random", 513, 44100, 4),
        ("random", 513, 44100, 8),
        ("random", 1025, 44100, 6),
        ("hazards", 513, 44100, 6),
        ("hazards", 7, 16000, 8),  # band 7 starts past the last bin: degenerate
    ],
)
def test_spectral_contrast_cpu_bits_equal_the_sort_loop(kind, f, sr, bands):
    """On a CPU tensor the wrapper sorts, so spectral_contrast gives the
    bits of the per-band sort loop, degenerate bands (contrast 0), zero
    frames and ties included."""
    mag = torch.from_numpy(_contrast_magnitudes(kind, f, seed=f + sr + bands))
    edges = contrast_band_edges(bands, f, sr)
    degenerate = [b for b in range(bands) if edges[b] >= min(edges[b + 1], f)]
    assert bool(degenerate) == (f == 7)
    got = spectral_contrast(mag, sr, bands)
    want = _contrast_sort_loop(mag, sr, bands)
    assert got.shape == mag.shape[:-1] + (bands,) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not got[..., degenerate].any()
    if kind == "hazards" and f > 7:
        assert not got[0, :7].any()


def test_spectral_contrast_routes_through_the_k9_wrapper(monkeypatch):
    """One wrapper call per spectral_contrast call, on a contiguous copy of
    the magnitudes, with contrast_band_edges' edges."""
    calls = []
    real = hopper_contrast.band_select_means_hopper

    def spy(magnitude, edges):
        calls.append((tuple(magnitude.shape), magnitude.is_contiguous(), tuple(edges)))
        return real(magnitude, edges)

    monkeypatch.setattr(hopper_contrast, "band_select_means_hopper", spy)
    mag = torch.from_numpy(_mag((2, 513, 10))).transpose(-1, -2)  # not contiguous
    for sr, bands in ((SR, 6), (16000, 4)):
        calls.clear()
        got = spectral_contrast(mag, sr, bands)
        assert calls == [((2, 10, 513), True, contrast_band_edges(bands, 513, sr))]
        assert torch.equal(got, _contrast_sort_loop(mag.contiguous(), sr, bands))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_band_means_model_through_spectral_contrast(monkeypatch, seed):
    """The numpy replay of the kernel's lane plan, fed through
    spectral_contrast's floor and log in place of the wrapper, is within
    1e-4 dB of the CPU path at the backfill's edges (44.1 kHz, 513 bins,
    6 bands): the kernel's arithmetic as wired."""
    mag = _mag((4, 64, 513), seed=100 + seed)
    mag[0, :3] = 0.0  # zero frames: peak 0, contrast 0
    want = spectral_contrast(torch.from_numpy(mag), SR, 6)

    def model(magnitude, edges):
        assert edges == contrast_band_edges(6, 513, SR)
        peak, valley = hopper_contrast.band_means_model(magnitude.numpy(), edges)[:2]
        return torch.from_numpy(peak), torch.from_numpy(valley)

    monkeypatch.setattr(hopper_contrast, "band_select_means_hopper", model)
    got = spectral_contrast(torch.from_numpy(mag), SR, 6)
    assert not got[0, :3].any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_spectral_contrast_takes_float32_only(dtype):
    """K9 and its plain version work in float32: another dtype raises at
    spectral_contrast's entry instead of coming back cast."""
    mag = torch.from_numpy(_mag((2, 10, 513))).to(dtype)
    with pytest.raises(ValueError, match="float32"):
        spectral_contrast(mag, SR, 6)
