"""Each hand-written CUDA kernel held to its plain PyTorch version on the
card (K1-K4, K9, K10, the DTW fill and its pre-pass, K8), at the main
path's full width and at the other geometries and edge cases each
kernel must handle. Tolerances are utils/parity's; every case is marked
`card` and skips without a CUDA device. On the card:

    python3 -m pytest --noconftest -q -p no:cacheprovider -m card tests/test_torch_card_kernels.py

The CPU tests hold the plain versions to the JAX package
(tests/test_torch_kernels.py, test_torch_dtw.py, test_torch_contrast.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from card_support import (
    BAND, FLEET_BATCH, FULL_B, HOP, N_CHROMA, N_FULL, PITCH_HOP, PITCH_WINDOW, PRE_EMPH, SEED, SR,
    UNRELATED, VQ_ARGS, WIDE_BAND, WINDOW, dtw_draws, fleet_streams, np32, require,
)
from card_support import card  # noqa: F401  (the session fixture)
from sonido_sonar_tpu_torch.ops import hopper_contrast, hopper_onsets, hopper_stft, hopper_yin
from sonido_sonar_tpu_torch.ops.stats import hopper_backtrack, hopper_dtw
from sonido_sonar_tpu_torch.utils import parity

pytestmark = pytest.mark.card

k1, k1_plain = hopper_stft.stft_magnitude_hopper, hopper_stft.stft_magnitude_plain
k2, k2_plain = hopper_yin.yin_pitch_hopper, hopper_yin.yin_pitch_plain
k3, k3_plain = hopper_yin.yin_difference_hopper, hopper_yin.yin_difference_plain
k4, k4_plain = hopper_onsets.thin_onsets_hopper, hopper_onsets.thin_onsets_plain
k9, k9_plain = hopper_contrast.band_select_means_hopper, hopper_contrast.band_select_means_plain
fill, fill_plain = hopper_dtw.fill_banded_hopper, hopper_dtw.fill_banded_plain
walk, walk_plain = hopper_backtrack.backtrack_banded_hopper, hopper_backtrack.backtrack_banded_plain
K2_ARGS = (PITCH_WINDOW, PITCH_HOP, SR, 80.0, 1000.0, 0.15, PRE_EMPH)
# the other geometries, an odd hop (frames off 8-byte alignment)
GEOMETRIES = [(512, 128, 0.0), (2048, 512, 0.95), (256, 100, 0.97), (1024, 255, PRE_EMPH)]


def _odd(dev):
    return parity.synth_pcm(3, SR + 777, SEED + 3, SR, dev)


def hold_k1(x, w, hop, pre):
    near = parity.near_zero_frames(np32(x), w, hop, pre)
    mag, aux = k1(x, w, hop, pre_emph=pre)
    pmag, paux = k1_plain(x, w, hop, pre_emph=pre)
    torch.cuda.synchronize()
    require(parity.check_stft_aux(np32(mag), {k: np32(v) for k, v in aux.items()},
                                  np32(pmag), {k: np32(v) for k, v in paux.items()}, near),
            f"K1 vs plain, {tuple(x.shape)}, W={w}, hop={hop}, pre={pre}")


def hold_k2(x, w, hop, pre):
    args = (w, hop, SR, 80.0, 1000.0, 0.15, pre)
    p, c, v = k2(x, *args)
    pp, pc, _ = k2_plain(x, *args)
    torch.cuda.synchronize()
    require(parity.check_pitch(np32(p), np32(c), np32(pp), np32(pc)),
            f"K2 vs plain, {tuple(x.shape)}, W={w}, hop={hop}, pre={pre}")
    assert torch.equal(v, c), "K2: voicing is not the confidence"


def hold_k3(x, w, hop):
    d, pd = k3(x, w, hop), k3_plain(x, w, hop)
    torch.cuda.synchronize()
    assert d.shape == pd.shape, f"K3: shape {tuple(d.shape)}, plain {tuple(pd.shape)}"
    err, scale = float((d - pd).abs().max()), float(pd.abs().max())
    assert err <= parity.YIN_DIFF_ATOL_SCALE * scale, \
        f"K3 at {w}/{hop}: {err:.4g} = {err / scale:.3g} of the largest |d|"


@pytest.mark.parametrize("size", ["small", "full"])
def test_k1_against_plain(card, size):
    hold_k1(getattr(card, size), WINDOW, HOP, PRE_EMPH)


@pytest.mark.parametrize("size", ["small", "full"])
def test_k2_against_plain(card, size):
    hold_k2(getattr(card, size), PITCH_WINDOW, PITCH_HOP, PRE_EMPH)


@pytest.mark.parametrize("w,hop,pre", GEOMETRIES)
def test_k1_k2_k3_at_other_geometries(card, w, hop, pre):
    odd = _odd(card.dev)
    hold_k1(odd, w, hop, pre)
    hold_k2(odd, w, hop, pre)
    hold_k3(odd, w, hop)


@pytest.mark.parametrize("w,hop,pre", [(64, 32, PRE_EMPH), (128, 64, 0.0)])
def test_k1_smallest_ffts(card, w, hop, pre):
    hold_k1(_odd(card.dev), w, hop, pre)


def test_a_1d_row_equals_the_row_in_a_batch(card):
    odd = _odd(card.dev)
    mag1, aux1 = k1(odd[1], WINDOW, HOP, pre_emph=PRE_EMPH)
    mag3, aux3 = k1(odd, WINDOW, HOP, pre_emph=PRE_EMPH)
    assert torch.equal(mag1, mag3[1]) and torch.equal(aux1["rms"], aux3["rms"][1])
    assert torch.equal(k2(odd[1], *K2_ARGS)[0], k2(odd, *K2_ARGS)[0][1])


def test_k3_at_full_width(card):
    """K3 at B=128 x 30 s, 1024/512, its public op driven once."""
    hold_k3(card.full, PITCH_WINDOW, PITCH_HOP)


@pytest.mark.parametrize("size", ["small", "full"])
def test_k2_period_amplitude_against_plain(card, size):
    """Voice quality's K2 call (1024/256, 50-500 Hz) on speech-pre-emphasized
    PCM: the pitch gates, the amplitude by the share of frames off."""
    from sonido_sonar_tpu_torch.ops.filters import pre_emphasis_for_content

    x = pre_emphasis_for_content(getattr(card, size), "speech").contiguous()
    p, c, v, a = k2(x, *VQ_ARGS, with_period_amp=True)
    pp, pc, _, pa = k2_plain(x, *VQ_ARGS, with_period_amp=True)
    torch.cuda.synchronize()
    what = f"K2 with period amplitude vs plain, {tuple(x.shape)}"
    require(parity.check_pitch(np32(p), np32(c), np32(pp), np32(pc)), what)
    require(parity.check_period_amp(np32(a), np32(pa)), what + ", amplitude")
    assert torch.equal(v, c), "K2: voicing is not the confidence"


def test_wrappers_on_2x3_rows_equal_6_rows(card):
    six = parity.synth_pcm(6, SR + 777, SEED + 5, SR, card.dev)
    m6, a6 = k1(six, WINDOW, HOP, pre_emph=PRE_EMPH)
    m23, a23 = k1(six.view(2, 3, -1), WINDOW, HOP, pre_emph=PRE_EMPH)
    assert m23.shape[:2] == (2, 3) and torch.equal(m23.reshape(m6.shape), m6)
    assert all(torch.equal(a23[k].reshape(a6[k].shape), a6[k]) for k in a6)
    for amp in (False, True):
        y6 = k2(six, *VQ_ARGS, with_period_amp=amp)
        y23 = k2(six.view(2, 3, -1), *VQ_ARGS, with_period_amp=amp)
        assert all(torch.equal(q.reshape(r.shape), r) for q, r in zip(y23, y6)), f"K2, amplitude {amp}"


# -- K4 (onset thinning), bit for bit ----------------------------------------

T_FLUX = (N_FULL - WINDOW) // HOP + 1       # flux onsets at hop 256
T_ENERGY = (N_FULL - 512) // 256 + 1        # tempo's energy onsets, 512/256
T_TEMPO = (N_FULL - 1024) // 512 + 1        # tempo's flux onsets, hop 512
# the three calls' T, and T one frame longer (5165 and 5167)
RANDOM_T = sorted({T_FLUX, T_ENERGY, T_TEMPO, T_FLUX + 1, T_ENERGY + 1})
RANDOM_CASES = [(t, d, mf) for t in RANDOM_T for d in (0.05, 0.3) for mf in (8, 4)]
# the skip-ahead walk's edges, each also held to the numpy model of the plan
EDGE_CASES = [("edge", 40), ("edge", 1), ("edge", 8), ("odd", 8), ("long_rows", 20000),
              ("tiles", 1), ("tiles", 8), ("tiles", 40), ("tiles", 100)]


@pytest.fixture(scope="module")
def k4_inputs():
    """K4's candidates (CPU bool tensors), drawn from one generator seeded
    SEED + 4 in their order: random rows at each of RANDOM_T at densities
    5 % and 30 %; [3, 777]; [2, 3, T]; then the walk's edges: `edge`
    [128, 5164] (a skip that crosses words, one frame, full and empty
    rows, a lone candidate at T - 1), `odd` [2, 3, 5163], `long_rows`
    [4, 40000] (three tiles) and `tiles` [4, 40000], the walk carried from
    one tile into the next: row 0 keeps the frame just before each tile
    edge, then a run of candidates across it; row 1 is random; row 2
    holds dense runs across the edges; row 3 keeps the two frames just
    before each edge and T - 1."""
    rng = np.random.default_rng(SEED + 4)
    out = {(t, d): torch.from_numpy(rng.random((FULL_B, t)) < d) for t in RANDOM_T for d in (0.05, 0.3)}
    out["3x777"] = torch.from_numpy(rng.random((3, 777)) < 0.3)
    out["2x3xT"] = torch.from_numpy(rng.random((2, 3, T_TEMPO)) < 0.3)
    edge = torch.from_numpy(rng.random((FULL_B, T_FLUX)) < 0.3)
    edge[1] = False
    edge[2] = True
    edge[3, :] = False
    edge[3, -1] = True
    out["edge"] = edge
    out["odd"] = torch.from_numpy(rng.random((2, 3, 5163)) < 0.1)
    out["long_rows"] = torch.from_numpy(rng.random((4, 40000)) < 0.01)
    tiles = torch.from_numpy(rng.random((4, 40000)) < 0.3)
    tiles[0] = False
    tiles[2] = torch.from_numpy(rng.random(40000) < 0.02)
    tiles[3] = False
    for e in (hopper_onsets.TILE, 2 * hopper_onsets.TILE):
        tiles[0, e - 1:e + 121] = True
        tiles[2, e - 200:e + 200] = torch.from_numpy(rng.random(400) < 0.5)
        tiles[3, e - 2:e] = True
    tiles[3, -1] = True
    out["tiles"] = tiles
    return out


def hold_k4(cand, min_frames):
    got, ref = k4(cand, min_frames), k4_plain(cand, min_frames)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and got.shape == cand.shape
    assert torch.equal(got, ref), f"K4 vs plain: {int((got != ref).sum())} elements differ"
    return got


@pytest.mark.parametrize("t,density,min_frames", RANDOM_CASES)
def test_k4_random_candidates(card, k4_inputs, t, density, min_frames):
    hold_k4(k4_inputs[t, density].to(card.dev), min_frames)


def test_k4_music_flux_candidates(card):
    """The music path's real candidates: spectral flux of K1's magnitudes
    of the full PCM, peak-picked at 0.3, min_frames 8."""
    from sonido_sonar_tpu_torch.ops import temporal as T
    from sonido_sonar_tpu_torch.ops.stft import spectral_flux

    real = T.flux_onset_candidates(spectral_flux(k1(card.full, WINDOW, HOP)[0]), 0.3).contiguous()
    hold_k4(real, 8)


@pytest.mark.parametrize("name,min_frames", [("3x777", 1), ("2x3xT", 4)])
def test_k4_odd_shapes(card, k4_inputs, name, min_frames):
    hold_k4(k4_inputs[name].to(card.dev), min_frames)


@pytest.mark.parametrize("name,min_frames", EDGE_CASES)
def test_k4_walk_edges_and_numpy_model(card, k4_inputs, name, min_frames):
    cand = k4_inputs[name]
    got = hold_k4(cand.to(card.dev), min_frames).cpu().numpy()
    assert np.array_equal(got, hopper_onsets.thin_onsets_model(cand.numpy(), min_frames)), \
        "K4 differs from the numpy model of its plan"
    if name == "tiles":
        assert all(got[0, e - 1] for e in (hopper_onsets.TILE, 2 * hopper_onsets.TILE)), \
            "the frame before a tile edge was not kept"


# -- K10 (K1's feature epilogue) ----------------------------------------------

K10_CASES = {"small": None, "64/16": (64, 16, SR), "256/100 at 16 kHz": (256, 100, 16000),
             "1024/255": (1024, 255, SR), "2048/512": (2048, 512, SR), "full": None}


@pytest.mark.parametrize("case", list(K10_CASES))
def test_k10_against_plain(card, case):
    """Magnitudes and aux bit-equal to the launch without features; feat
    bit-equal between two launches; the lanes against the plain epilogue
    on the kernel's own magnitudes and, but at full width, against the
    whole plain version across the two DFTs. Flatness and slope take logs
    of every bin above 1e-10, so across two DFTs a frame's few smallest
    bins move them: at 128 x 30 s one frame in 661k missed the whole-path
    bound, so the whole plain version is held at the small sizes only."""
    w, hop, sr = K10_CASES[case] or (WINDOW, HOP, SR)
    x = (getattr(card, case) if case in ("small", "full")
         else parity.synth_pcm(3, sr + 777, SEED + 3, sr, card.dev))
    kw = dict(pre_emph=PRE_EMPH, with_features=True, sample_rate=sr)
    mag, aux, feat = k1(x, w, hop, **kw)
    mag0, aux0 = k1(x, w, hop, pre_emph=PRE_EMPH)
    again = k1(x, w, hop, **kw)[2]
    torch.cuda.synchronize()
    assert torch.equal(mag, mag0) and all(torch.equal(aux[k], aux0[k]) for k in aux0)
    assert torch.equal(feat, again), "two launches gave different feat bits"
    del again, mag0, aux0
    require(parity.check_feat(np32(feat), np32(hopper_stft.frame_features(mag, sr, w)),
                              same_magnitudes=True), f"K10 {case}, on the kernel's magnitudes")
    if case != "full":
        require(parity.check_feat(np32(feat), np32(k1_plain(x, w, hop, **kw)[2]), same_magnitudes=False),
                f"K10 {case}, across the two DFTs")


# -- K9 (contrast band means) ---------------------------------------------------

@pytest.fixture(scope="module")
def full_mag(card):
    """K1's magnitudes of the full PCM, [128, 5164, 513]."""
    return k1(card.full, WINDOW, HOP, pre_emph=PRE_EMPH)[0]


def test_k9_at_the_main_path_magnitudes(card, full_mag):
    """Against the contrast sorts, two launches bit-equal, and the tie and
    zero case exact."""
    from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges

    edges = contrast_band_edges(6, full_mag.shape[-1], SR)
    peak, valley = k9(full_mag, edges)
    torch.cuda.synchronize()
    require(parity.check_band_means(np32(peak), np32(valley), *(np32(t) for t in k9_plain(full_mag, edges))),
            f"K9 vs plain, {tuple(full_mag.shape)}")
    again = k9(full_mag, edges)
    assert torch.equal(peak, again[0]) and torch.equal(valley, again[1]), "two launches gave different bits"
    tie = torch.zeros((1, 16, full_mag.shape[-1]), device=card.dev)
    tie[0, :, edges[3]:edges[4]] = 0.25
    tpeak, tvalley = k9(tie, edges)
    others = [0, 1, 2, 4, 5]
    assert bool((tpeak[0, :, 3] == 0.0625).all()) and bool((tvalley[0, :, 3] == 0.0625).all())
    assert not bool(tpeak[0, :, others].any()) and not bool(tvalley[0, :, others].any())


K9_HAZARDS = ["ties", "zero and subnormal powers", "one constant band", "degenerate and clipped bands",
              "22.05 kHz edges", "W = 2048", "W = 4096 (random magnitudes, the general form)"]


@pytest.mark.parametrize("hazard", K9_HAZARDS)
def test_k9_hazards_at_full_size(card, full_mag, hazard):
    """The lane plan's hazards at full size, and the general form at
    W = 4096: K9 against its plain version, two launches bit-equal, and
    where band_plan gives a lane plan, against the numpy model of the plan
    on the first 4,096 frames. The random powers are one torch generator
    seeded SEED + 9 on the card: the first draw, then W = 4096's."""
    from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges

    edges = contrast_band_edges(6, full_mag.shape[-1], SR)
    gen = torch.Generator(device=card.dev).manual_seed(SEED + 9)
    haz = torch.randn(full_mag.shape, generator=gen, device=card.dev).abs_()
    m, e = {
        "ties": lambda: (torch.round(haz * 2) / 2, edges),
        "zero and subnormal powers": lambda: (_zero_subnormal(haz), edges),
        "one constant band": lambda: (_constant_band(haz), edges),
        "degenerate and clipped bands": lambda: (full_mag, (0, 4, 4, 10, 600)),
        "22.05 kHz edges": lambda: (full_mag, contrast_band_edges(6, full_mag.shape[-1], 22050)),
        "W = 2048": lambda: _w2048(card.full),
        "W = 4096 (random magnitudes, the general form)": lambda: (
            torch.randn((FULL_B, 645, 2049), generator=gen, device=card.dev).abs_(),
            contrast_band_edges(6, 2049, SR)),
    }[hazard]()
    del haz
    got, ref, again = k9(m, e), k9_plain(m, e), k9(m, e)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two launches gave different bits"
    require(parity.check_band_means(*(np32(t) for t in (*got, *ref))), f"K9 vs plain, {hazard}")
    if hopper_contrast.band_plan(tuple(e), m.shape[-1])[1]:
        sub = np32(m.reshape(-1, m.shape[-1])[:4096])
        mp, mv = hopper_contrast.band_means_model(sub, e)[:2]
        kp, kv = (np32(t.reshape(-1, t.shape[-1])[:4096]) for t in got)
        require(parity.check_band_means(kp, kv, mp, mv), f"K9 vs its numpy model, {hazard}")


def _zero_subnormal(haz):
    haz[::3] = 0.0
    haz[1::3] *= 1e-21
    return haz


def _constant_band(haz):
    haz.zero_()
    haz[..., 20:300] = 0.5
    return haz


def _w2048(full):
    from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges

    m = k1(full, 2048, 1024, pre_emph=PRE_EMPH)[0]
    return m, contrast_band_edges(6, m.shape[-1], SR)


# -- the DTW fill, its pre-pass, and K8 ----------------------------------------

@pytest.fixture(scope="module")
def dtw_inputs(card):
    """dtw_draws() on the and the fleet's short-time energies
    [64, 10332, 1] of both sides (card_support.fleet_streams)."""
    from sonido_sonar_tpu_torch.ops.temporal import short_time_energy

    d = {k: torch.from_numpy(v).to(card.dev) if k != "lags" else v for k, v in dtw_draws().items()}
    src, cdn = fleet_streams(d["lags"], card.dev)
    d["e_src"] = short_time_energy(src, WINDOW, HOP)[..., None].contiguous()
    d["e_cdn"] = short_time_energy(cdn, WINDOW, HOP)[..., None].contiguous()
    return d


PAIRS = [0, UNRELATED[0]]                          # one related pair, one unrelated
FILL_GEOMETRIES = ["K6 [8, 2048, 12] band 64", "K7 [1, 10335, 12] band 5167",
                   "K5 energies [2, 10332, 1] band 5167", "[2, 3000 x 2900, 1] band 20671"]


def _fill_case(d, case):
    """(query, reference, band) of one of the TPU fills' geometries."""
    if case.startswith("K6"):
        return d["q6"], torch.roll(d["q6"], 5, 1).contiguous(), 64
    if case.startswith("K7"):
        return d["q7"], torch.roll(d["q7"], 7, 1).contiguous(), BAND
    if case.startswith("K5"):
        return d["e_src"][PAIRS].contiguous(), d["e_cdn"][PAIRS].contiguous(), BAND
    return d["qw"], d["rw"], WIDE_BAND   # rows too wide for shared memory: kept in the cost band


@pytest.mark.parametrize("case", FILL_GEOMETRIES)
def test_dtw_fill_then_backtrack_against_plain(card, dtw_inputs, case):
    """The fill against its plain version, then K8 against the plain
    backtrack on the kernel's own band, exactly."""
    q, r, band = _fill_case(dtw_inputs, case)
    n, m = q.shape[1], r.shape[1]
    cost, plain = fill(q, r, band, n, m), fill_plain(q, r, band, n, m)
    torch.cuda.synchronize()
    require(parity.check_fill(np32(cost), np32(plain)), f"DTW fill vs plain, {case}")
    del plain
    got = walk(cost, band, n, m)
    torch.cuda.synchronize()
    require(parity.check_backtrack([np32(t) for t in got], [np32(t) for t in walk_plain(cost, band, n, m)]),
            f"DTW backtrack vs plain on the kernel's band, {case}")


@pytest.mark.parametrize("case", FILL_GEOMETRIES[1:3])
def test_dtw_prepass_against_plain(card, dtw_inputs, case):
    q, r, band = _fill_case(dtw_inputs, case)
    n, m = q.shape[1], r.shape[1]
    got, want = hopper_dtw.local_distances_hopper(q, r, band, n, m), hopper_dtw.local_distances_plain(q, r, band, n, m)
    torch.cuda.synchronize()
    require(parity.check_local_distances(np32(got), np32(want), np32(q), np32(r)),
            f"DTW distance pre-pass vs plain, {case}")


def hold_walk(cost, band, n, m, pairs, path=None):
    """K8 against the plain walk on `pairs` of `cost`, exactly (equal
    bits), its misses against the numpy model's (walk_model, at each
    pair's offset in the band), the designed path where there is one."""
    got, misses = hopper_backtrack.backtrack_banded_misses(cost, band, n, m)
    torch.cuda.synchronize()
    sub = cost if len(pairs) == cost.shape[0] else cost[torch.tensor(pairs, device=cost.device)]
    want = walk_plain(sub.contiguous(), band, n, m)
    del sub
    got_s = [np32(t)[pairs] for t in got]
    require(parity.check_backtrack(got_s, [np32(t) for t in want]), "DTW backtrack vs plain")
    assert all(np.array_equal(g.view(np.int32), np32(t).view(np.int32)) for g, t in zip(got_s, want)), \
        "K8's outputs are not bit-equal to the plain walk"
    model = [hopper_backtrack.walk_model(np32(cost[p]), band, n, m,
                                         offset=hopper_backtrack.band_offset(cost, p))[4] for p in pairs]
    assert model == np32(misses)[pairs].tolist(), f"K8 misses {np32(misses)[pairs].tolist()}, the model's {model}"
    if path is not None:
        ii, jj = path
        assert np.array_equal(got_s[0][0, : len(ii)], ii[::-1] - 1) \
            and np.array_equal(got_s[1][0, : len(jj)], jj[::-1] - 1), "K8 left the designed path"


@pytest.mark.parametrize("band", [BAND, WIDE_BAND])
def test_k8_on_prescribed_path_bands(card, band):
    """Bands built on the card (utils/parity.prescribed_path_band), n = m
    = 10,332: 3,000-step up and left runs, at band 5,167 also a left run
    to k = 0 and an up run back."""
    n_p, run, gap = N_CHROMA - 3, 3000, 3000 // 15
    runs = ([("D", gap // 2), ("U", run), ("D", gap), ("L", run), ("D", gap), ("L", band),
             ("D", gap), ("U", band), ("D", n_p - run - band - gap // 2 - 3 * gap)] if band == BAND
            else [("D", gap // 2), ("U", run), ("D", gap), ("L", run), ("D", n_p - run - gap // 2 - gap)])
    cost, ii, jj = parity.prescribed_path_band(runs, band, SEED + 13, device=card.dev)
    hold_walk(cost[None], band, n_p, n_p, [0], (ii, jj))


def test_k8_at_the_fleet_geometry(card, dtw_inputs):
    """K8 on the fill of the fleet's two pairs (B = 2, band 5,167)."""
    q, r, band = _fill_case(dtw_inputs, FILL_GEOMETRIES[2])
    n = q.shape[1]
    hold_walk(fill(q, r, band, n, n), band, n, n, [0, 1])


def test_dtw_at_the_fleet_sub_batch(card, dtw_inputs):
    """The sub-batch the fleet sends (B = 32): pairs 0, 24 (unrelated) and
    31 held to the plain fill and, bit for bit, to the plain walk. From
    pair 21 on a pair's offset in the band passes 2^31 elements."""
    q32, r32 = dtw_inputs["e_src"][:FLEET_BATCH].contiguous(), dtw_inputs["e_cdn"][:FLEET_BATCH].contiguous()
    n = q32.shape[1]
    rows = [0, UNRELATED[0], FLEET_BATCH - 1]
    cost32 = fill(q32, r32, BAND, n, n)
    sel = torch.tensor(rows, device=card.dev)
    plain = fill_plain(q32[sel].contiguous(), r32[sel].contiguous(), BAND, n, n)
    require(parity.check_fill(np32(cost32[sel]), np32(plain)), f"DTW fill vs plain, pairs {rows} of B = 32")
    del plain
    hold_walk(cost32, BAND, n, n, rows)
