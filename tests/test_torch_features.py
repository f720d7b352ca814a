"""K10, the feature epilogue of the port's K1, and the main path's
feature-epilogue configuration, held to the JAX package on the CPU.

JAX runs its epilogue as `tests/test_pallas_stft.py` runs it: the Pallas
kernel in interpret mode. The port's plain lanes are held to JAX's lanes
on JAX's own magnitudes at the bounds JAX's tests hold its epilogue to
(utils/parity.FEAT_SAME_MAGNITUDES), and across the two packages' DFTs at
the whole-path bounds (FEAT_MEL_ACROSS_DFTS, FEATURE_TOLERANCES). JAX's
`batched_fingerprint_features` never takes its epilogue branch on the
CPU (`pallas_stft_available` is false there, and a jit cache would keep
a patched gate), so the branch is composed here from its public pieces
as parallel/pipeline.py:113-207 composes it.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.io.synth import sine, white_noise  # noqa: E402
from sonido_sonar_tpu.ops import mfcc as jmfcc  # noqa: E402
from sonido_sonar_tpu.ops import pitch as jpitch  # noqa: E402
from sonido_sonar_tpu.ops import spectral as jspectral  # noqa: E402
from sonido_sonar_tpu.ops import temporal as jtemporal  # noqa: E402
from sonido_sonar_tpu.ops.pallas_stft import FEAT_LANES as J_FEAT_LANES  # noqa: E402
from sonido_sonar_tpu.ops.pallas_stft import stft_magnitude_pallas  # noqa: E402
from sonido_sonar_tpu.ops.stft import spectral_flux as j_flux  # noqa: E402
from sonido_sonar_tpu_torch.models import FingerprintModel  # noqa: E402
from sonido_sonar_tpu_torch.ops import hopper_stft  # noqa: E402
from sonido_sonar_tpu_torch.ops import spectral as tspectral  # noqa: E402
from sonido_sonar_tpu_torch.ops.mfcc import MFCCParams, mfcc_from_mel  # noqa: E402
from sonido_sonar_tpu_torch.parallel import pipeline as tpipeline  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)
SR = 44100
PRE = 0.97
ENV = tpipeline.FEAT_EPILOGUE_ENV


def _two_tones(seconds=4.0):
    """The JAX epilogue test's signal (tests/test_pallas_stft.py:161-166),
    two rows."""
    x = (sine(440, seconds, SR) + 0.3 * sine(1234.5, seconds, SR)
         + white_noise(seconds, SR, 0.05)).astype(np.float32)
    return np.stack([x, x * 0.3])


def _jax_epilogue(x):
    mag, aux, feat = stft_magnitude_pallas(
        jnp.asarray(x), 1024, 256, interpret=True, with_aux=True, with_features=True,
        pre_emph=PRE, sample_rate=SR,
    )
    return mag, aux, feat


def test_feat_lanes_match_jax_layout():
    """The port's 43 lanes are the JAX kernel's lanes 0-42, by name."""
    assert hopper_stft.FEAT_LANES == J_FEAT_LANES
    assert hopper_stft.N_FEAT == 43
    assert tuple(k for k, v in J_FEAT_LANES.items() if isinstance(v, int)) == \
        parity.FEAT_DESCRIPTORS


@pytest.mark.parametrize("rows", ["two_tones", "synth"])
def test_k10_plain_matches_pallas_interpret(rows):
    """2 rows x 4 s: the interpret-mode kernel runs more than one 256-frame
    tile. On JAX's magnitudes the port's lanes meet JAX's own bounds
    (mel rtol 1e-4 atol 1e-7, MFCC atol 2e-3, chroma rtol 1e-3 atol 2e-5,
    descriptors 2e-3 scaled, bandwidth rtol 1e-3 atol 2 Hz); through the
    port's own DFT, the whole-path bounds."""
    x = _two_tones() if rows == "two_tones" else parity.synth_pcm(2, 4 * SR, 11, SR).numpy()
    jmag, _, jfeat = _jax_epilogue(x)
    jmag, jfeat = np.array(jmag), np.asarray(jfeat)[..., :hopper_stft.N_FEAT]
    same = hopper_stft.frame_features(torch.from_numpy(jmag), SR, 1024).numpy()
    errors, failures = parity.check_feat(same, jfeat, same_magnitudes=True)
    assert not failures, (failures, errors)
    mel = torch.from_numpy(np.ascontiguousarray(same[..., :26]))
    np.testing.assert_allclose(
        mfcc_from_mel(mel, MFCCParams()).numpy(),
        np.asarray(jmfcc.mfcc_from_mel(jnp.asarray(jfeat[..., :26]), jmfcc.MFCCParams())),
        atol=2e-3)

    mag, _, feat = hopper_stft.stft_magnitude_hopper(
        torch.from_numpy(x), 1024, 256, pre_emph=PRE, with_features=True, sample_rate=SR)
    assert feat.shape == mag.shape[:-1] + (43,) and feat.dtype == torch.float32
    errors, failures = parity.check_feat(feat.numpy(), jfeat, same_magnitudes=False)
    assert not failures, (failures, errors)


def test_k10_plain_lanes_are_the_default_path_functions():
    """Without features the wrapper gives the same magnitudes and aux; the
    lanes are mfcc's mel product, chroma_from_magnitude and the bundle's
    descriptors, bit for bit on the CPU."""
    from sonido_sonar_tpu_torch.ops.chroma import chroma_from_magnitude
    from sonido_sonar_tpu_torch.ops.mfcc import mfcc

    x = parity.synth_pcm(3, SR, 12, SR)
    mag, aux, feat = hopper_stft.stft_magnitude_hopper(x, 1024, 256, pre_emph=PRE,
                                                       with_features=True, sample_rate=SR)
    mag0, aux0 = hopper_stft.stft_magnitude_hopper(x, 1024, 256, pre_emph=PRE)
    assert torch.equal(mag, mag0) and all(torch.equal(aux[k], aux0[k]) for k in aux0)
    assert torch.equal(mfcc_from_mel(feat[..., :26]), mfcc(mag, SR, 1024))
    assert torch.equal(feat[..., 26:38], chroma_from_magnitude(mag, SR, 1024))
    bundle = tspectral.spectral_descriptor_bundle(mag, SR)
    for key, lane in tspectral.descriptors_from_feat(feat).items():
        assert torch.equal(lane, bundle[key]), key


def test_descriptors_from_feat_and_mfcc_from_mel_match_jax():
    """The lane slicing of both packages on one feat tensor, and the MFCC
    tail (log, DCT-II, lifter) on one mel tensor: float32 rounding only."""
    feat = np.abs(np.random.default_rng(3).standard_normal((2, 7, 43))).astype(np.float32)
    got = tspectral.descriptors_from_feat(torch.from_numpy(feat))
    ref = jspectral.descriptors_from_feat(jnp.asarray(np.pad(feat, ((0, 0), (0, 0), (0, 21)))))
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    mel = feat[..., :26] * 100.0
    mel[0, 0, :3] = 0.0  # the log floor
    for params in (MFCCParams(), MFCCParams(num_coefficients=20, num_mel_filters=26)):
        jparams = jmfcc.MFCCParams(**params.__dict__)
        np.testing.assert_allclose(
            mfcc_from_mel(torch.from_numpy(mel), params).numpy(),
            np.asarray(jmfcc.mfcc_from_mel(jnp.asarray(mel), jparams)), rtol=1e-5, atol=1e-4)


def _jax_feat_branch(x, enable_chroma=True):
    """JAX parallel/pipeline.py's epilogue configuration, composed from its
    public pieces (:113-207) with the kernel in interpret mode."""
    mag, aux, feat = _jax_epilogue(x)
    out = {}
    lo, hi = J_FEAT_LANES["mel"]
    out["mfcc"] = jmfcc.mfcc_from_mel(feat[..., lo:hi], jmfcc.MFCCParams(num_coefficients=13))
    if enable_chroma:
        clo, chi = J_FEAT_LANES["chroma"]
        out["chroma"] = feat[..., clo:chi]
    out.update(jspectral.descriptors_from_feat(feat))
    out["spectral_flux"] = j_flux(mag)
    out["spectral_contrast"] = jspectral.spectral_contrast(mag, SR, 6)
    out["zcr"] = aux["zero_crossings"] / (1024 / float(SR))
    rms = aux["rms"]
    out["spectral_rolloff"] = aux["rolloff_bin"] * ((SR / 2.0) / float(mag.shape[-1] - 1))
    out["low_energy_ratio"] = aux["low_energy_ratio"]
    out["high_energy_ratio"] = aux["high_energy_ratio"]
    out["rms_energy"] = rms
    out["energy_entropy"] = jnp.where(rms > 0, -rms * jnp.log(rms + 1e-10), 0.0)
    out["energy_variance"] = jtemporal.energy_variance(rms)
    pitch, conf, voicing = jpitch.yin_pitch_from_signal(
        jnp.asarray(x), 1024, 512, jpitch.PitchParams(sample_rate=SR, window_size=1024),
        pre_emph=PRE)
    out.update(pitch=pitch, pitch_confidence=conf, voicing=voicing)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("enable_chroma", [True, False])
def test_feat_configuration_matches_jax_feat_branch(monkeypatch, enable_chroma):
    """SONIDO_ENABLE_FEAT_EPILOGUE=1: the port's main path against JAX's
    epilogue branch on [2, 1.5 s], key by key at the whole-path bounds
    (chroma and bandwidth at JAX's epilogue bounds); the default keys,
    shapes and dtypes. The input is JAX's own epilogue test signal: JAX's
    kernel takes its DFT as bf16 hi/lo products (~1e-5 of the frame's
    peak), and on rows with a deep spectral floor (synth_pcm's tonal rows)
    the features that take logs of single bins or small bands (contrast,
    MFCC) then move past the whole-path bounds, which were measured
    against JAX's float32 DFT; K10's lanes on such rows are held to JAX
    on JAX's own magnitudes above."""
    monkeypatch.setenv(ENV, "1")
    x = _two_tones(1.5)
    got = {k: v.numpy() for k, v in tpipeline.batched_fingerprint_features(
        torch.from_numpy(x), enable_chroma=enable_chroma).items()}
    ref = _jax_feat_branch(x, enable_chroma)
    near = parity.near_zero_frames(x, 1024, 256, PRE)
    errors, failures = parity.check_features(got, ref, near, SR, 1024,
                                             tolerances=parity.FEAT_EPILOGUE_TOLERANCES)
    assert not failures, (failures, errors)
    assert len(got) == (19 if enable_chroma else 18)
    monkeypatch.delenv(ENV)
    default = tpipeline.batched_fingerprint_features(torch.from_numpy(x),
                                                     enable_chroma=enable_chroma)
    assert list(default) == list(got)
    assert all(default[k].shape == got[k].shape and default[k].dtype == torch.float32
               and got[k].dtype == np.float32 for k in got)


def test_feat_switch_is_read_on_every_call(monkeypatch):
    """The variable is read per call (no trace cache): set, empty and
    unset switch K1's epilogue on and off for the next call; the speech
    extractor follows it through batched_fingerprint_features."""
    calls = []
    real = tpipeline.stft_magnitude_hopper

    def spy(*args, **kwargs):
        calls.append(kwargs.get("with_features", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(tpipeline, "stft_magnitude_hopper", spy)
    x = parity.synth_pcm(1, SR // 2, 14, SR)
    for value, want in (("1", True), ("", False), (None, False), ("yes", True)):
        if value is None:
            monkeypatch.delenv(ENV, raising=False)
        else:
            monkeypatch.setenv(ENV, value)
        assert tpipeline.feat_epilogue_enabled() is want
        calls.clear()
        tpipeline.batched_fingerprint_features(x, enable_pitch=False)
        assert calls == [want], value
    calls.clear()
    tpipeline.batched_speech_extractor_features(x, SR, 1024, 256)
    assert calls[0] is True


def test_fingerprint_model_equals_the_main_path(monkeypatch):
    from sonido_sonar_tpu_torch.config.config import FeatureConfig

    x = parity.synth_pcm(2, SR // 2, 15, SR)
    model = FingerprintModel()
    assert isinstance(model, torch.nn.Module) and not list(model.parameters())
    for value in ("", "1"):
        monkeypatch.setenv(ENV, value)
        got, ref = model(x), tpipeline.batched_fingerprint_features(x)
        assert list(got) == list(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
    cfg = FeatureConfig(sample_rate=22050, window_size=2048, hop_size=512, enable_chroma=False)
    got = FingerprintModel(cfg, enable_pitch=False)(x)
    ref = tpipeline.batched_fingerprint_features(
        x, sample_rate=22050, window_size=2048, hop_size=512, enable_chroma=False,
        enable_pitch=False)
    assert list(got) == list(ref) and all(torch.equal(got[k], ref[k]) for k in ref)


def test_k10_wrapper_plain_on_cpu_raises_elsewhere():
    x = parity.synth_pcm(2, SR // 2, 16, SR)
    before = (hopper_stft.stft_magnitude_hopper.launches,
              hopper_stft.stft_magnitude_hopper.feat_launches)
    got = hopper_stft.stft_magnitude_hopper(x, 1024, 256, pre_emph=PRE, with_features=True)
    ref = hopper_stft.stft_magnitude_plain(x, 1024, 256, pre_emph=PRE, with_features=True)
    assert torch.equal(got[2], ref[2]) and torch.equal(got[0], ref[0])
    assert (hopper_stft.stft_magnitude_hopper.launches,
            hopper_stft.stft_magnitude_hopper.feat_launches) == before
    one = hopper_stft.stft_magnitude_hopper(x[1], 1024, 256, pre_emph=PRE, with_features=True)
    assert torch.equal(one[2], got[2][1])
    with pytest.raises(ValueError, match="no K1 kernel"):
        hopper_stft.stft_magnitude_hopper(torch.empty((2, 4096), device="meta"), 1024, 256,
                                          with_features=True)


GEOMETRIES = [(w, sr) for w in (64, 256, 1024, 2048) for sr in (8000, 16000, 22050, 44100)]


def _tables(w, sr):
    f_bins = w // 2 + 1
    row_ptr, bins, weights, _ = hopper_stft.feature_tables(f_bins, sr, w)
    return row_ptr, bins, weights, hopper_stft.feature_entries(f_bins, sr, w)


@pytest.mark.parametrize("w,sr", GEOMETRIES)
def test_feature_sums_model_matches_plain_lanes(w, sr):
    """K10's weighted sums in the kernel's order (feature_sums_model: 32
    lane segments, the slot layout, the fixed combine and the butterfly
    chroma total) against frame_features' mel and chroma lanes on the
    same magnitudes, at FEAT_SAME_MAGNITUDES; one frame of all-zero
    power gives zero mel and chroma. At 64/44.1 kHz 14 of the 38 rows
    are empty (8 mel filters and 6 chroma classes hold no bin)."""
    row_ptr, _, _, entries = _tables(w, sr)
    x = parity.synth_pcm(2, max(sr // 2, 3 * w), 21, sr)
    mag = hopper_stft.stft_magnitude_plain(x, w, max(w // 4, 16), pre_emph=PRE)[0]
    mag[1, 0] = 0.0
    ref = hopper_stft.frame_features(mag, sr, w).numpy()
    sums = hopper_stft.feature_sums_model((mag * mag).numpy(), row_ptr, entries)
    errors, failures = parity.check_feat(np.concatenate([sums, ref[..., 38:]], -1), ref,
                                         same_magnitudes=True)
    assert not failures, (failures, errors)
    assert not sums[1, 0].any()
    if (w, sr) == (64, 44100):
        assert int((np.diff(row_ptr) == 0).sum()) == 14


@pytest.mark.parametrize("w,sr", GEOMETRIES)
def test_feature_plan_covers_each_entry_once_in_distinct_slots(w, sr):
    """The 32 segments cover the table's entries once, in order, each
    within one of nnz / 32; no two (lane, row) partials share a slot;
    row r's slots are exactly the lanes that hold its entries, at
    lane + r, inside the kSlots scratch."""
    row_ptr, bins, weights, entries = _tables(w, sr)
    nnz = int(row_ptr[-1])
    segments, rows = hopper_stft.feature_plan(row_ptr)
    assert segments.shape == (32, 2) and rows.shape == (38, 2)
    assert segments[0, 0] == 0 and segments[-1, 1] == nnz
    assert (segments[1:, 0] == segments[:-1, 1]).all()
    size = segments[:, 1] - segments[:, 0]
    assert size.min() >= nnz // 32 and size.max() <= -(-nnz // 32)
    lane_of = np.repeat(np.arange(32), size)
    row_of = np.repeat(np.arange(38), np.diff(row_ptr))
    pairs = sorted(set(zip(lane_of.tolist(), row_of.tolist())))
    slots = [lane + row for lane, row in pairs]
    assert len(set(slots)) == len(slots) and max(slots) < hopper_stft.N_SLOTS
    for r, (first, count) in enumerate(rows):
        assert list(range(first, first + count)) == [lane + r for lane, row in pairs if row == r]
    # the packed entries, interleaved by lane: lane l's t-th entry at
    # [t, l], (bin | row << 16, the weight's bits); past its count no-ops
    # (bin 0, weight 0, its last row), to a multiple of WALK_STEP
    step = hopper_stft.WALK_STEP
    assert entries.shape == (-(-size.max() // step) * step, 32, 2) and entries.dtype == np.int32
    t = np.concatenate([np.arange(n) for n in size])
    np.testing.assert_array_equal(entries[t, lane_of, 0] & 0xFFFF, bins)
    np.testing.assert_array_equal(entries[t, lane_of, 0] >> 16, row_of)
    np.testing.assert_array_equal(entries[t, lane_of, 1].view(np.float32), weights)
    for lane, (start, end) in enumerate(segments):
        pad = entries[end - start:, lane]
        assert not pad[:, 1].any() and not (pad[:, 0] & 0xFFFF).any()
        assert (pad[:, 0] >> 16 == (row_of[end - 1] if end > start else 0)).all()
