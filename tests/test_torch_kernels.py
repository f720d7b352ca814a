"""The port's K1 (STFT + aux), K2 (YIN, with its period amplitude), K3
(the YIN difference rows) and K4 (onset thinning) modules held to the JAX
package on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; these tests
hold that version to both of the JAX package's paths: the Pallas kernel
in interpret mode (as tests/test_pallas_stft.py and test_pallas_yin.py
run it) and the XLA path JAX takes on the CPU. The CUDA kernels
themselves are held to the plain versions on the card by chip_smoke.py.
Tolerances are those of sonido_sonar_tpu_torch/utils/parity.py, where
each has its reason.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.ops import framing as jframing  # noqa: E402
from sonido_sonar_tpu.ops import pitch as jpitch  # noqa: E402
from sonido_sonar_tpu.ops import spectral as jspectral  # noqa: E402
from sonido_sonar_tpu.ops import temporal as jtemporal  # noqa: E402
from sonido_sonar_tpu.ops.filters import pre_emphasis as j_pre_emphasis  # noqa: E402
from sonido_sonar_tpu.ops.pallas_onsets import thin_onsets_pallas  # noqa: E402
from sonido_sonar_tpu.ops.pallas_stft import stft_magnitude_pallas  # noqa: E402
from sonido_sonar_tpu.ops.pallas_yin import yin_difference_pallas, yin_pitch_pallas  # noqa: E402
from sonido_sonar_tpu.ops.stft import stft as j_stft  # noqa: E402
from sonido_sonar_tpu_torch import _build  # noqa: E402
from sonido_sonar_tpu_torch.config.config import WindowType  # noqa: E402
from sonido_sonar_tpu_torch.ops import filters as tfilters  # noqa: E402
from sonido_sonar_tpu_torch.ops import framing as tframing  # noqa: E402
from sonido_sonar_tpu_torch.ops import hopper_onsets, hopper_stft, hopper_yin  # noqa: E402
from sonido_sonar_tpu_torch.ops import pitch as tpitch  # noqa: E402
from sonido_sonar_tpu_torch.ops import windows as twindows  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)
SR = 44100
PRE = 0.97


def _pcm(batch, seconds, seed):
    return parity.synth_pcm(batch, int(seconds * SR), seed, SR).numpy()


def _t(x):
    return {k: np.asarray(v) for k, v in x.items()}


@pytest.mark.parametrize("batch,seconds,seed", [(2, 1.0, 0), (3, 4.0, 1)])
def test_k1_plain_matches_pallas_interpret(batch, seconds, seed):
    """4 s rows give the interpret-mode kernel several 256-frame tiles,
    so its pre-emphasis crosses tile boundaries."""
    x = _pcm(batch, seconds, seed)
    mag, aux = hopper_stft.stft_magnitude_hopper(torch.from_numpy(x), 1024, 256, pre_emph=PRE)
    jmag, jaux = stft_magnitude_pallas(
        jnp.asarray(x), 1024, 256, interpret=True, with_aux=True, pre_emph=PRE
    )
    near = parity.near_zero_frames(x, 1024, 256, PRE)
    errors, failures = parity.check_stft_aux(
        mag.numpy(), _t(aux), np.asarray(jmag), _t(jaux), near
    )
    assert not failures, (failures, errors)


def test_k1_plain_matches_xla_path():
    """JAX on the CPU: pre_emphasis -> stft -> frame RMS / zero crossings,
    rolloff from the descriptor bundle's cumsum, band ratios from the
    power sums (parallel/pipeline.py:124-187)."""
    x = _pcm(4, 1.5, 2)
    xj = j_pre_emphasis(jnp.asarray(x), PRE)
    jmag = j_stft(xj, 1024, 256, sample_rate=SR).magnitude
    frames = jframing.frame_signal(xj, 1024, 256)
    power = np.asarray(jmag) ** 2
    tot = power.sum(-1)
    split = power.shape[-1] // 4
    roll_hz = np.asarray(jspectral.spectral_descriptor_bundle(jmag, SR)["spectral_rolloff"])
    ref_aux = {
        "rms": np.asarray(jnp.sqrt(jnp.mean(frames * frames, axis=-1))),
        "zero_crossings": np.asarray(jspectral.zero_crossings(frames)),
        "rolloff_bin": roll_hz / ((SR / 2.0) / (power.shape[-1] - 1)),
        "low_energy_ratio": np.where(tot > 0, power[..., :split].sum(-1) / np.maximum(tot, 1e-10), 0.0),
        "high_energy_ratio": np.where(tot > 0, power[..., split:].sum(-1) / np.maximum(tot, 1e-10), 0.0),
    }
    mag, aux = hopper_stft.stft_magnitude_hopper(torch.from_numpy(x), 1024, 256, pre_emph=PRE)
    near = parity.near_zero_frames(x, 1024, 256, PRE)
    errors, failures = parity.check_stft_aux(mag.numpy(), _t(aux), np.asarray(jmag), ref_aux, near)
    assert not failures, (failures, errors)


@pytest.mark.parametrize("batch,seconds,seed", [(2, 1.0, 3), (3, 4.0, 4)])
def test_k2_plain_matches_pallas_interpret(batch, seconds, seed):
    """4 s rows give the interpret-mode kernel several 64-frame tiles."""
    x = _pcm(batch, seconds, seed)
    p, c, v = hopper_yin.yin_pitch_hopper(torch.from_numpy(x), 1024, 512, SR, 80.0, 1000.0, pre_emph=PRE)
    jp, jc, _ = yin_pitch_pallas(jnp.asarray(x), 1024, 512, SR, 80.0, 1000.0, interpret=True, pre_emph=PRE)
    errors, failures = parity.check_pitch(p.numpy(), c.numpy(), np.asarray(jp), np.asarray(jc))
    assert not failures, (failures, errors)
    assert errors["voiced_share"] > 0.5  # the tonal rows are voiced
    assert torch.equal(v, c)


def test_k2_plain_matches_xla_path():
    x = _pcm(4, 1.5, 5)
    params = jpitch.PitchParams(sample_rate=SR, window_size=1024)
    jp, jc, jv = jpitch.yin_pitch_from_signal(jnp.asarray(x), 1024, 512, params, pre_emph=PRE)
    tparams = tpitch.PitchParams(sample_rate=SR, window_size=1024)
    p, c, v = tpitch.yin_pitch_from_signal(torch.from_numpy(x), 1024, 512, tparams, pre_emph=PRE)
    errors, failures = parity.check_pitch(p.numpy(), c.numpy(), np.asarray(jp), np.asarray(jc))
    assert not failures, (failures, errors)
    assert errors["voiced_share"] > 0.5


@pytest.mark.parametrize("w,hop", [(1024, 512), (512, 128)])
def test_yin_difference_and_pick(w, hop):
    """d(tau) = E1 + S - 2r: same formulation in both packages; atol
    2e-4 of the largest d, as tests/test_pallas_yin.py. Over the same
    rows the pick makes the same decisions; the CMNDF running sums round
    in another order, so pitch and confidence agree to float32 rounding
    (rtol 1e-6, atol 1e-6)."""
    x = _pcm(2, 0.5, 6)
    jframes = jframing.frame_signal(jnp.asarray(x), w, hop)
    tframes = tframing.frame_signal(torch.from_numpy(x), w, hop)
    jd = np.asarray(jpitch._yin_difference(jframes))
    td = tpitch._yin_difference(tframes)
    np.testing.assert_allclose(td.numpy(), jd, atol=2e-4 * np.abs(jd).max())
    params = (SR, w, 80.0, 1000.0, 0.15)
    jp, jc, _ = jpitch._yin_pick(jnp.asarray(jd), jpitch.PitchParams(*params))
    tp, tc, _ = tpitch._yin_pick(torch.from_numpy(jd.copy()), tpitch.PitchParams(*params))
    np.testing.assert_array_equal(tp.numpy() > 0, np.asarray(jp) > 0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)


def test_wrappers_take_plain_version_on_cpu_without_launching():
    x = torch.from_numpy(_pcm(2, 0.5, 7))
    k1_before = hopper_stft.stft_magnitude_hopper.launches
    k2_before = hopper_yin.yin_pitch_hopper.launches
    mag, aux = hopper_stft.stft_magnitude_hopper(x, 1024, 256, pre_emph=PRE)
    pmag, paux = hopper_stft.stft_magnitude_plain(x, 1024, 256, pre_emph=PRE)
    assert torch.equal(mag, pmag)
    assert list(aux) == list(hopper_stft.AUX_KEYS)
    assert all(torch.equal(aux[k], paux[k]) for k in aux)
    got = hopper_yin.yin_pitch_hopper(x, 1024, 512, SR, 80.0, 1000.0, pre_emph=PRE)
    ref = hopper_yin.yin_pitch_plain(x, 1024, 512, SR, 80.0, 1000.0, pre_emph=PRE)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert hopper_stft.stft_magnitude_hopper.launches == k1_before
    assert hopper_yin.yin_pitch_hopper.launches == k2_before
    # [N] input gives [T, ...] outputs
    mag1, aux1 = hopper_stft.stft_magnitude_hopper(x[0], 1024, 256, pre_emph=PRE)
    assert torch.equal(mag1, mag[0]) and aux1["rms"].shape == (mag.shape[1],)


def test_wrappers_raise_on_devices_without_a_kernel():
    x = torch.empty((2, 4096), device="meta")
    with pytest.raises(ValueError, match="no K1 kernel"):
        hopper_stft.stft_magnitude_hopper(x, 1024, 256)
    with pytest.raises(ValueError, match="no K2 kernel"):
        hopper_yin.yin_pitch_hopper(x, 1024, 512, SR, 80.0, 1000.0)
    with pytest.raises(ValueError, match="no K3 kernel"):
        hopper_yin.yin_difference_hopper(x, 1024, 512)


K1_WINDOWS = [64, 128, 256, 512, 1024, 2048]


@pytest.mark.parametrize("w", K1_WINDOWS)
def test_k1_fft_schedule_model_matches_rfft(w):
    """The numpy model of K1's warp FFT (its pass order, lane and buffer
    index maps, swizzle and twiddle-table reads) against np.fft.rfft of
    the same windowed, pre-emphasized frames, to 1e-5 of each frame's
    peak; a frame of zeros gives zeros."""
    x = torch.from_numpy(_pcm(2, 0.25, 30))
    frames = tframing.frame_signal(tfilters.pre_emphasis(x, PRE), w, w // 4)
    windowed = frames.numpy() * twindows.make_window(WindowType.HANN, w)
    got = hopper_stft.fft_model(windowed)
    ref = np.fft.rfft(windowed.astype(np.float64), axis=-1)
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert (np.abs(got - ref) <= 1e-5 * peak).all()
    assert not hopper_stft.fft_model(np.zeros((1, w), np.float32)).any()


@pytest.mark.parametrize("w", K1_WINDOWS)
def test_k1_fft_tables_follow_the_pass_plan(w):
    """The twiddle table holds the split's W/2 + 1 entries and (R - 1) Ns
    per pass after the first, every entry on the unit circle; the swizzle
    permutes the warp buffer's W/2 points."""
    half = w // 2
    passes = hopper_stft.fft_passes(half)
    assert np.prod([r for r, _ in passes]) == half
    assert [ns for _, ns in passes] == list(np.cumprod([1] + [r for r, _ in passes[:-1]]))
    tw = hopper_stft.twiddle_table(w)
    assert tw.shape == (half + 1 + sum((r - 1) * ns for r, ns in passes[1:]), 2)
    np.testing.assert_allclose(np.hypot(tw[:, 0], tw[:, 1]), 1.0, atol=1e-7)
    assert sorted(hopper_stft.swizzle(np.arange(half))) == list(range(half))


def _bank_ways(idx):
    """Worst bank conflict of one warp's 64-bit shared-memory access (lane
    -> float2 index, -1 idle): served per half-warp, 16 bank pairs."""
    ways = 1
    for h in (idx[:16], idx[16:]):
        h = np.unique(h[h >= 0])
        if h.size:
            ways = max(ways, int(np.bincount(h % 16).max()))
    return ways


@pytest.mark.parametrize("w", K1_WINDOWS)
def test_k1_fft_buffer_accesses_are_free_of_bank_conflicts(w):
    """Every FFT pass's loads and stores through the swizzle, with
    butterfly j on lane j % 32, serve each half-warp in one wavefront."""
    half = w // 2
    lanes = np.arange(32)
    for p, (radix, span) in enumerate(hopper_stft.fft_passes(half)):
        nb = half // radix
        for slot in range(-(-nb // 32)):
            j = lanes + 32 * slot
            for r in range(radix):
                dst = (j // span) * span * radix + j % span + r * span
                for idx in ([dst] if p == 0 else [j + r * nb, dst]):
                    assert _bank_ways(np.where(j < nb, hopper_stft.swizzle(idx), -1)) == 1, (p, r)


K2_WINDOWS = list(hopper_yin.KERNEL_WINDOWS)


def _direct_difference(frames):
    """d(tau) = sum_{j<H} (x[j] - x[j+tau])^2 in float64."""
    h = frames.shape[-1] // 2
    f = frames.astype(np.float64)
    return np.stack([((f[..., :h] - f[..., t:t + h]) ** 2).sum(-1) for t in range(h)], axis=-1)


@pytest.mark.parametrize("w,zero_first_half", [(w, False) for w in K2_WINDOWS] + [(1024, True)])
def test_k2_difference_model_matches_direct_sum(w, zero_first_half):
    """The numpy model of K2/K3's difference function (their two packed
    forward transforms, the bin-pair product and inverse split, the
    inverse passes, the lane-chunked prefix sums; table reads and swizzled
    indices as the kernel makes them) against a float64 direct sum and
    against the plain version ops/pitch._yin_difference, each within 2e-4
    of the largest |d| (utils/parity.YIN_DIFF_ATOL_SCALE). With the first
    half zeroed, r = 0 and d = S."""
    x = tfilters.pre_emphasis(torch.from_numpy(_pcm(2, 0.25, 40 + w)), PRE)
    frames = tframing.frame_signal(x, w, w // 2).numpy().reshape(-1, w)[:6].copy()
    if zero_first_half:
        frames[:, : w // 2] = 0.0
    got = hopper_yin.difference_model(frames)
    ref = _direct_difference(frames)
    plain = tpitch._yin_difference(torch.from_numpy(frames)).numpy()
    assert got.shape == ref.shape == plain.shape and got.dtype == np.float32
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= parity.YIN_DIFF_ATOL_SCALE * scale
    assert np.abs(got - plain).max() <= parity.YIN_DIFF_ATOL_SCALE * scale
    if zero_first_half:
        assert (got >= -1e-6 * scale).all()


def _bank_ways32(idx):
    """Worst bank conflict of one warp's 32-bit shared-memory access (lane
    -> float index, -1 idle): 32 banks."""
    idx = np.unique(idx[idx >= 0])
    return int(np.bincount(idx % 32).max()) if idx.size else 1


@pytest.mark.parametrize("w", K2_WINDOWS)
def test_k2_buffer_accesses_outside_the_fft_passes(w):
    """K2/K3's shared-memory accesses that K1's passes do not make: the
    squares' lane-strided stores and the d rows' lane-strided loads, and
    the lane-contiguous chunk loads and stores (H/32 floats per lane,
    twice for the squares) through the scratch swizzle, one wavefront
    each; the bin-pair step's loads of points k (one wavefront) and N - k
    (two at most: the half-warp's 16 points straddle an aligned 16-point
    block, as K1's split reads do); the inverse's lane-contiguous 64-bit
    loads of W/64 points (one wavefront at W = 1024, two at most
    elsewhere)."""
    n = w // 2
    c = n // 32
    lanes = np.arange(32)
    sw = hopper_yin.scratch_swizzle
    assert sorted(sw(np.arange(w))) == list(range(w))
    for i in range(w // 32):
        assert _bank_ways32(sw(32 * i + lanes)) == 1
    for t in range(c):
        for base in (0, n):
            assert _bank_ways32(sw(base + c * lanes + t)) == 1
    for i in range(-(-(n // 2 + 1) // 32)):
        k = 32 * i + lanes
        live = k <= n // 2
        assert _bank_ways(np.where(live, hopper_stft.swizzle(k), -1)) == 1
        assert _bank_ways(np.where(live, hopper_stft.swizzle((n - k) & (n - 1)), -1)) <= 2
    ways = [_bank_ways(hopper_stft.swizzle((c // 2) * lanes + t)) for t in range(c // 2)]
    assert max(ways) == 1 if w == 1024 else max(ways) <= 2


@pytest.mark.parametrize("hop,rows", [(512, 2), (256, 1)])
def test_k3_plain_matches_pallas_interpret(hop, rows):
    """The difference rows at 1024/512 and 1024/256 (a 1-D row): atol 2e-4
    of the largest |d|, as tests/test_pallas_yin.py:35-45; 1.5 s rows give
    the interpret-mode kernel more than one 64-frame tile."""
    x = _pcm(rows, 1.5, 20 + hop)
    x = x[0] if rows == 1 else x
    d = hopper_yin.yin_difference_hopper(torch.from_numpy(x), 1024, hop)
    ref = np.asarray(yin_difference_pallas(jnp.asarray(x), 1024, hop, interpret=True))
    assert d.shape == ref.shape and d.dtype == torch.float32
    np.testing.assert_allclose(d.numpy(), ref, atol=parity.YIN_DIFF_ATOL_SCALE * np.abs(ref).max())


def test_k3_wrapper_takes_plain_version_on_cpu_without_launching():
    """The plain version is framing + ops/pitch._yin_difference, no
    pre-emphasis; [2, 3, N] gives the rows of [6, N]."""
    x = torch.from_numpy(_pcm(6, 0.5, 21))
    before = hopper_yin.yin_difference_hopper.launches
    d = hopper_yin.yin_difference_hopper(x, 1024, 512)
    assert torch.equal(d, tpitch._yin_difference(tframing.frame_signal(x, 1024, 512)))
    assert torch.equal(d, hopper_yin.yin_difference_plain(x, 1024, 512))
    d3 = hopper_yin.yin_difference_hopper(x.view(2, 3, -1), 1024, 512)
    assert d3.shape == (2, 3) + d.shape[1:] and torch.equal(d3.reshape(d.shape), d)
    assert hopper_yin.yin_difference_hopper.launches == before


@pytest.mark.parametrize(
    "make,msg",
    [
        (lambda: torch.zeros(2, 4096, dtype=torch.float64), "float32"),
        (lambda: torch.zeros(()), r"\[N\] or \[B, N\]"),
        (lambda: torch.zeros(4096, 2).T, "contiguous"),
        (lambda: torch.zeros(2, 1000), "no frame"),
        (lambda: torch.zeros(70000, 1024), "launch grid"),
    ],
)
def test_kernel_signal_rejects_what_the_kernels_do_not_take(make, msg):
    with pytest.raises(ValueError, match=msg):
        tframing.kernel_signal(make(), 1024, 256)


def test_kernel_signal_views_rows():
    sig, b, t = tframing.kernel_signal(torch.zeros(44100), 1024, 256)
    assert sig.shape == (1, 44100) and (b, t) == (1, 169)
    sig, b, t = tframing.kernel_signal(torch.zeros(3, 2048), 1024, 512)
    assert (b, t) == (3, 3)
    x = torch.zeros(2, 3, 2048)
    sig, b, t = tframing.kernel_signal(x, 1024, 512)
    assert sig.shape == (6, 2048) and (b, t) == (6, 3)
    assert sig.data_ptr() == x.data_ptr()  # a view, no copy


def test_build_command_targets_hopper(tmp_path, monkeypatch):
    """nvcc by hand for sm_90a, one compile per source (started together),
    linked into a shared library with a C interface; the library name
    follows the sources, and nvcc comes from CUDA_HOME. Every kernel
    source is compiled, and every C entry point has its ctypes signature:
    pointers and the stream as c_void_p."""
    compiles, link = _build.nvcc_commands("nvcc", tmp_path / "lib.so")
    for cmd in compiles:
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        assert {"-c", "-fPIC", "-O3", "-std=c++17"} <= set(cmd)
    assert [c[c.index("-c") + 1] for c in compiles] == [
        str(_build._PKG / s) for s in _build.SOURCES
    ]
    assert link[:4] == ["nvcc", "-shared", "-o", str(tmp_path / "lib.so")]
    assert link[4:] == [c[-1] for c in compiles] and len(set(link[4:])) == len(compiles)
    assert {"csrc/stft.cu", "csrc/yin.cu", "csrc/onsets.cu", "csrc/dtw.cu",
            "csrc/contrast.cu"} == set(_build.SOURCES)
    assert all((_build._PKG / s).is_file() for s in _build.SOURCES)
    import ctypes
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    sigs = _build._SIGNATURES
    # sig, twiddle, pitch, conf, amp (nullable)
    assert sigs["sonido_yin_pitch"][:5] == (P, P, P, P, P)
    assert sigs["sonido_yin_pitch"][-1] == P and len(sigs["sonido_yin_pitch"]) == 16
    assert sigs["sonido_stft_features"] == (P,) * 9 + (I,) * 5 + (F, P)
    assert sigs["sonido_stft_occupancy"] == (I, I, I, P, P)
    assert sigs["sonido_yin_difference"] == (P, P, P, I, I, I, I, I, P)
    assert sigs["sonido_yin_occupancy"] == (I, I, I, P, P)
    assert sigs["sonido_contrast_band_means"] == (P, P, P, P, P, L, I, I, I, I, P)
    assert sigs["sonido_contrast_occupancy"] == (I, I, P, P, P, P)
    assert sigs["sonido_thin_onsets"] == (P, P, I, I, I, P)
    assert sigs["sonido_thin_onsets_occupancy"] == (P, P, P, P)
    assert sigs["sonido_dtw_fill_banded"] == (P, P, P, I, I, I, I, I, P)
    assert sigs["sonido_dtw_local_distances"] == (P, P, P, I, I, I, I, I, P)
    assert sigs["sonido_dtw_fill_rows"] == (P, I, I, I, I, P)
    assert sigs["sonido_dtw_backtrack_banded"] == (P, P, P, P, P, I, I, I, I, P, P)
    sources = "".join((_build._PKG / s).read_text() for s in _build.SOURCES)
    for name, argtypes in sigs.items():
        decl = sources[sources.index(f'extern "C" int {name}('):]
        decl = decl[: decl.index(")")]
        assert decl.count(",") + 1 == len(argtypes), name
        assert decl.count("*") == argtypes.count(P), name
        assert ("long long" in decl) == (L in argtypes), name
    assert len(_build.source_hash()) == 16 and _build.source_hash() == _build.source_hash()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(nvcc)


def test_source_hash_follows_the_headers(tmp_path, monkeypatch):
    """The library's hash covers csrc/*.cuh, which the sources include: an
    edited header gives another hash (so a stale library is never
    loaded), and so does a new header."""
    import shutil

    shutil.copytree(_build._PKG / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    before = _build.source_hash()
    assert before == _build.source_hash()
    header = tmp_path / "csrc" / "warp_fft.cuh"
    assert '#include "warp_fft.cuh"' in (tmp_path / "csrc" / "yin.cu").read_text()
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build.source_hash()
    assert edited != before
    (tmp_path / "csrc" / "extra.cuh").write_text("// new\n")
    assert _build.source_hash() not in (before, edited)


def test_failed_build_leaves_no_library(tmp_path, monkeypatch):
    """A build that fails raises KernelError and leaves neither the
    library nor its half-written temporary file nor the objects."""
    def failing_nvcc(nvcc, out):
        out.with_suffix("").mkdir(parents=True)
        out.write_bytes(b"half a library")
        raise _build.KernelError("nvcc failed (1)")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run_nvcc", failing_nvcc)
    with pytest.raises(_build.KernelError, match="nvcc failed"):
        _build.build.__wrapped__()
    assert list(tmp_path.iterdir()) == []


def test_k2_period_amp_plain_matches_pallas_interpret():
    """Voice quality's call (ops/speech.py:375-382): 1024/256, 50-500 Hz,
    on a speech-pre-emphasized signal, with the period amplitude."""
    x = np.array(j_pre_emphasis(jnp.asarray(_pcm(2, 1.0, 8)), PRE))
    p, c, v, a = hopper_yin.yin_pitch_hopper(
        torch.from_numpy(x), 1024, 256, SR, 50.0, 500.0, with_period_amp=True
    )
    jp, jc, _, ja = yin_pitch_pallas(
        jnp.asarray(x), 1024, 256, SR, 50.0, 500.0, interpret=True, with_period_amp=True
    )
    errors, failures = parity.check_pitch(p.numpy(), c.numpy(), np.asarray(jp), np.asarray(jc))
    e2, f2 = parity.check_period_amp(a.numpy(), np.asarray(ja))
    assert not failures + f2, (failures, f2, errors, e2)
    assert errors["voiced_share"] > 0.25 and torch.equal(v, c)  # a row in 50-500 Hz
    # without the option the same call gives the same three outputs
    assert all(torch.equal(q, r) for q, r in zip(
        hopper_yin.yin_pitch_hopper(torch.from_numpy(x), 1024, 256, SR, 50.0, 500.0), (p, c, v)))


def test_period_amplitude_definition():
    """plen = trunc(sr / pitch) clamped to [1, W - 1]; unvoiced frames
    take one sample."""
    frames = torch.arange(1.0, 9.0).reshape(1, 2, 4)
    amp = hopper_yin.period_amplitude(frames, torch.tensor([[0.0, 22050.0]]), 44100)
    assert torch.allclose(amp, torch.tensor([[1.0, np.sqrt((25 + 36) / 2)]], dtype=torch.float32))
    amp = hopper_yin.period_amplitude(frames, torch.tensor([[1.0, 1e9]]), 44100)
    assert torch.allclose(amp, torch.tensor([[np.sqrt(14 / 3), 5.0]], dtype=torch.float32))


@pytest.mark.parametrize(
    "rows,frames,density,min_frames",
    [(5, 700, 0.3, 8), (3, 777, 0.3, 1), (130, 100, 0.5, 4), (1, 33, 0.9, 8), (2, 1030, 0.05, 4)],
)
def test_k4_plain_matches_pallas_interpret(rows, frames, density, min_frames):
    """T not a multiple of 32 or 512, R not a multiple of 128: equal bits."""
    cand = np.random.default_rng(rows * frames).random((rows, frames)) < density
    got = hopper_onsets.thin_onsets_hopper(torch.from_numpy(cand), min_frames)
    ref = np.asarray(thin_onsets_pallas(jnp.asarray(cand), min_frames, interpret=True))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 0


@pytest.mark.parametrize("min_interval,hop", [(0.05, 256), (0.05, 512), (0.01, 441)])
def test_k4_plain_matches_jax_scan_path(min_interval, hop):
    """detect_onsets_from_flux on the CPU takes the JAX scan (no Pallas):
    the same mask and count; min_frames 8, 4 and 1."""
    flux = np.abs(np.random.default_rng(hop).standard_normal((3, 2, 601))).astype(np.float32)
    jm, jc = jtemporal.detect_onsets_from_flux(jnp.asarray(flux), hop, SR, 0.3, min_interval)
    from sonido_sonar_tpu_torch.ops import temporal as ttemporal

    m, c = ttemporal.detect_onsets_from_flux(torch.from_numpy(flux), hop, SR, 0.3, min_interval)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def _k4_candidates(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "tile_edge":  # the frame before each 64-frame tile edge, then a run across it
        cand = rng.random(shape) < 0.3
        cand[0] = False
        for e in range(64, shape[-1] - 40, 192):
            cand[:, e - 1:e + 40] = True
        return cand
    if kind == "empty":
        return np.zeros(shape, bool)
    if kind == "full":
        return np.ones(shape, bool)
    if kind == "last_frame":  # a lone candidate at T - 1 after a burst
        cand = np.zeros(shape, bool)
        cand[..., :5] = True
        cand[..., -1] = True
        return cand
    return rng.random(shape) < float(kind)


@pytest.mark.parametrize(
    "kind,shape,min_frames,tile",
    [
        ("0.3", (3, 777), 1, hopper_onsets.TILE),
        ("0.3", (5, 700), 8, hopper_onsets.TILE),
        ("0.3", (4, 1030), 40, hopper_onsets.TILE),  # skips cross words
        ("empty", (3, 500), 8, hopper_onsets.TILE),
        ("full", (3, 500), 8, hopper_onsets.TILE),
        ("full", (2, 333), 1, hopper_onsets.TILE),
        ("last_frame", (2, 645), 8, hopper_onsets.TILE),
        ("0.1", (2, 3, 5163), 8, hopper_onsets.TILE),  # odd T, leading axes
        ("0.002", (2, 5000), 4, hopper_onsets.TILE),  # runs of empty words
        # several tiles: the walk carries across them
        ("0.3", (4, 1030), 8, 64),
        ("0.2", (2, 2000), 40, 96),
        ("0.6", (3, 3000), 33, 128),  # min_frames past a word
        ("0.3", (2, 700), 100, 64),  # min_frames past a tile: the carry skips whole tiles
        ("0.3", (2, 700), 64, hopper_onsets.TILE),  # the last mask carried to the next word
        ("0.3", (2, 700), 65, hopper_onsets.TILE),  # past it: a seek from the kept frame
        # an onset kept just before each tile edge: the carry on the masked
        # path (1, 8, 40) and on the seek path (100)
        ("tile_edge", (2, 700), 1, 64),
        ("tile_edge", (2, 700), 8, 64),
        ("tile_edge", (2, 700), 40, 64),
        ("tile_edge", (2, 700), 100, 64),
    ],
)
def test_k4_model_matches_plain_and_pallas(kind, shape, min_frames, tile):
    """The numpy replay of the kernel's plan (tiles, candidate words, the
    walk that seeks words and steps through each on its bitmask) is
    bit-equal to the plain recurrence and to JAX's Pallas kernel in
    interpret mode."""
    cand = _k4_candidates(kind, shape, shape[-1] + min_frames)
    got = hopper_onsets.thin_onsets_model(cand, min_frames, tile)
    plain = hopper_onsets.thin_onsets_plain(torch.from_numpy(cand), min_frames).numpy()
    ref = np.asarray(thin_onsets_pallas(jnp.asarray(cand.reshape(-1, shape[-1])), min_frames,
                                        interpret=True)).reshape(shape)
    assert got.shape == shape and got.dtype == bool
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)
    if kind == "last_frame":
        assert got[..., -1].all()
    if kind == "tile_edge":
        assert got[0, 63:660:192].all()
    if kind == "full":
        assert got.sum() == np.prod(shape[:-1]) * -(-shape[-1] // min_frames)


def test_k4_tiling_constants_match_the_kernel():
    """The model's tile is the kernel's."""
    src = (_build._PKG / "csrc" / "onsets.cu").read_text()
    assert "constexpr int kThreads = 256;" in src and "kChunksPerThread = 4;" in src
    assert "constexpr int kTile = kThreads * kChunksPerThread * 16 - 32;" in src
    assert hopper_onsets.TILE == 256 * 4 * 16 - 32 and hopper_onsets.TILE % 32 == 0


def test_wrappers_take_leading_axes_as_rows():
    """[2, 3, N] through K1, K2 (with and without the amplitude) and K4
    equals the rows of [6, N], reshaped."""
    x = torch.from_numpy(_pcm(6, 0.5, 9))
    x3 = x.view(2, 3, -1)
    mag6, aux6 = hopper_stft.stft_magnitude_hopper(x, 1024, 256, pre_emph=PRE)
    mag3, aux3 = hopper_stft.stft_magnitude_hopper(x3, 1024, 256, pre_emph=PRE)
    assert mag3.shape == (2, 3) + mag6.shape[1:]
    assert torch.equal(mag3.reshape(mag6.shape), mag6)
    assert all(torch.equal(aux3[k].reshape(6, -1), aux6[k]) for k in aux6)
    for amp in (False, True):
        y6 = hopper_yin.yin_pitch_hopper(x, 1024, 256, SR, 50.0, 500.0, with_period_amp=amp)
        y3 = hopper_yin.yin_pitch_hopper(x3, 1024, 256, SR, 50.0, 500.0, with_period_amp=amp)
        assert len(y3) == (4 if amp else 3)
        assert all(q.shape == (2, 3, r.shape[1]) and torch.equal(q.reshape(r.shape), r)
                   for q, r in zip(y3, y6))
    cand = torch.from_numpy(np.random.default_rng(9).random((6, 300)) < 0.3)
    k6 = hopper_onsets.thin_onsets_hopper(cand, 4)
    assert torch.equal(hopper_onsets.thin_onsets_hopper(cand.view(2, 3, 300), 4).reshape(6, 300), k6)


def test_k4_wrapper_raises_on_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no K4 kernel"):
        hopper_onsets.thin_onsets_hopper(torch.empty((2, 64), dtype=torch.bool, device="meta"), 4)
