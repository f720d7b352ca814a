"""The port's extractor surfaces held to the JAX package on the CPU, key
by key: `speech_extractor_program`, `batched_speech_extractor_features`
and `batched_music_extractor_features` (K1, K2 with and without the
period amplitude, K4 — all through their plain versions here), the
assembled ExtractedFeatures, and the factory's routing (sports and
mixed content to their class compositions under non-strict routing). Tolerances are
utils/parity.py's (check_extracted)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.config.config import FeatureConfig as JFeatureConfig  # noqa: E402
from sonido_sonar_tpu.config.config import ContentType as JContentType  # noqa: E402
from sonido_sonar_tpu.extractors import programs as jprog  # noqa: E402
from sonido_sonar_tpu.extractors.base import FeatureExtractorFactory as JFactory  # noqa: E402
from sonido_sonar_tpu.ops import filters as jfilters  # noqa: E402
from sonido_sonar_tpu.ops.tonal import _CHORD_MATRIX  # noqa: E402
from sonido_sonar_tpu.parallel import pipeline as jpipe  # noqa: E402
from sonido_sonar_tpu_torch.config.config import ContentType, FeatureConfig  # noqa: E402
from sonido_sonar_tpu_torch.extractors import programs as tprog  # noqa: E402
from sonido_sonar_tpu_torch.extractors.base import FeatureExtractorFactory  # noqa: E402
from sonido_sonar_tpu_torch.extractors.features import map_tensors  # noqa: E402
from sonido_sonar_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402
from sonido_sonar_tpu_torch.utils.convert import features_to_numpy  # noqa: E402

torch.set_num_threads(1)
SR = 44100
N = int(1.5 * SR)


@pytest.fixture(scope="module")
def voices():
    """[3, 1.5 s]: two voices and a noise row (parity.voiced_pcm)."""
    return parity.voiced_pcm(4, N, 31).numpy()[1:]


@pytest.fixture(scope="module")
def music():
    """[3, 1.5 s] harmonic music-like clips (parity.harmonic_clips) with
    an amplitude pulse every 0.5 s for onsets and tempo."""
    x = parity.harmonic_clips(3, N, 32).numpy()
    pulse = 1.0 + 0.8 * (np.mod(np.arange(N) / SR, 0.5) < 0.05)
    return (x * pulse).astype(np.float32)


def _t(d):
    return {k: v.numpy() for k, v in d.items()}


def _j(d):
    return {k: np.asarray(v) for k, v in d.items()}


def test_speech_extractor_program_matches_jax(voices):
    """1024/256 with every stage on: the generator's news program."""
    got = _t(tprog.speech_extractor_program(torch.from_numpy(voices), SR))
    ref = _j(jprog.speech_extractor_program(jnp.asarray(voices), SR))
    near = parity.near_zero_frames(voices, 1024, 256, 0.97)
    errors, failures = parity.check_extracted(got, ref, SR, 1024, near_zero=near, n_samples=N)
    assert not failures, (failures, errors)
    assert got["is_speech"].any() and got["formant_count"].max() >= 1


def test_speech_extractor_program_default_geometry_subset(voices):
    """2048/512 (the generator's default geometry), speech chain off."""
    kw = dict(window_size=2048, hop_size=512, enable_speech=False, enable_temporal=False)
    got = _t(tprog.speech_extractor_program(torch.from_numpy(voices[:2]), SR, **kw))
    ref = _j(jprog.speech_extractor_program(jnp.asarray(voices[:2]), SR, **kw))
    near = parity.near_zero_frames(voices[:2], 2048, 512, 0.97)
    errors, failures = parity.check_extracted(got, ref, SR, 2048, near_zero=near, n_samples=N)
    assert not failures, (failures, errors)
    assert "is_speech" not in got and "onset_mask" not in got


def test_batched_speech_extractor_features_matches_jax(voices):
    got = _t(tpipe.batched_speech_extractor_features(torch.from_numpy(voices), SR))
    ref = _j(jpipe.batched_speech_extractor_features(jnp.asarray(voices), SR))
    near = parity.near_zero_frames(voices, 1024, 256, 0.97)
    errors, failures = parity.check_extracted(got, ref, SR, 1024, near_zero=near, n_samples=N)
    assert not failures, (failures, errors)


@pytest.fixture(scope="module")
def music_pair(music):
    got = _t(tpipe.batched_music_extractor_features(torch.from_numpy(music), SR))
    ref = _j(jpipe.batched_music_extractor_features(jnp.asarray(music), SR))
    return got, ref


def test_batched_music_extractor_features_matches_jax(music, music_pair):
    """ZCR of the DC-removed, pre-emphasized signal: frames with a sample
    within DC_NEAR_ZERO of 0 are exempt; chord indices where the two best
    templates are within 1e-5 are exempt."""
    got, ref = music_pair
    pre = np.asarray(jfilters.pre_emphasis_for_content(jfilters.dc_removal(jnp.asarray(music)), "music"))
    near = parity.near_zero_frames(pre, 1024, 256, 0.0, parity.DC_NEAR_ZERO)
    chroma = ref["chroma"]
    cn = chroma / np.maximum(np.linalg.norm(chroma, axis=-1, keepdims=True), 1e-10)
    sims = np.sort(cn @ _CHORD_MATRIX.T, axis=-1)
    errors, failures = parity.check_extracted(
        got, ref, SR, 1024, near_zero=near, n_samples=N, chord_margin=sims[..., -1] - sims[..., -2])
    assert not failures, (failures, errors)


@pytest.mark.parametrize("sr,window,hop", [(16000, 1024, 256), (8000, 512, 128)])
def test_music_zcr_rates_match_jax(sr, window, hop):
    """The music program at 16 kHz and 8 kHz on the harmonic clips with
    the pulses above, ZCR bit-equal to JAX away from near-zero samples
    (ops/spectral.per_second scales the counts as JAX's jit does)."""
    n = int(1.5 * sr)
    x = parity.harmonic_clips(3, n, 32, sr).numpy()
    pulse = 1.0 + 0.8 * (np.mod(np.arange(n) / sr, 0.5) < 0.05)
    x = (x * pulse).astype(np.float32)
    got = _t(tpipe.batched_music_extractor_features(torch.from_numpy(x), sr, window, hop))
    ref = _j(jpipe.batched_music_extractor_features(jnp.asarray(x), sr, window, hop))
    pre = np.asarray(jfilters.pre_emphasis_for_content(jfilters.dc_removal(jnp.asarray(x)), "music"))
    near = parity.near_zero_frames(pre, window, hop, 0.0, parity.DC_NEAR_ZERO)
    chroma = ref["chroma"]
    cn = chroma / np.maximum(np.linalg.norm(chroma, axis=-1, keepdims=True), 1e-10)
    sims = np.sort(cn @ _CHORD_MATRIX.T, axis=-1)
    errors, failures = parity.check_extracted(
        got, ref, sr, window, near_zero=near, n_samples=n, chord_margin=sims[..., -1] - sims[..., -2])
    assert not failures, (failures, errors)
    assert "zcr" in errors


def test_music_outputs_are_live(music_pair):
    """The pulses give onsets and a 120 BPM tempo. (The per-frame pitch
    sees frames of N/T = 259 samples, 129 lags: nothing under 342 Hz, so
    the 196 Hz tones read unvoiced there, in both packages.)"""
    got, _ = music_pair
    assert got["onset_mask"].sum(-1).min() >= 2
    assert (got["tempo_bpm"] == 120.0).all()
    assert got["chord_index"].dtype == np.int32


def test_music_options_not_ported_raise(music):
    """Once the options raised here; now the options-on music program
    (CQT chroma of the raw PCM, HPCP from the magnitudes) is held to
    JAX's, every key by check_extracted: the CQT chroma at the chroma's
    1e-5, HPCP by utils/parity.HPCP_ATOL per frame with at most
    HPCP_MISS_SHARE of the frames off (the two DFTs' magnitudes differ by
    ~1.2e-6 of a frame's peak, which can swap near-equal HPCP peaks)."""
    kw = dict(enable_cqt=True, enable_hpcp=True)
    got = _t(tpipe.batched_music_extractor_features(torch.from_numpy(music[:2]), SR, **kw))
    ref = _j(jpipe.batched_music_extractor_features(jnp.asarray(music[:2]), SR, **kw))
    pre = np.asarray(jfilters.pre_emphasis_for_content(jfilters.dc_removal(jnp.asarray(music[:2])), "music"))
    near = parity.near_zero_frames(pre, 1024, 256, 0.0, parity.DC_NEAR_ZERO)
    chroma = ref["chroma"]
    cn = chroma / np.maximum(np.linalg.norm(chroma, axis=-1, keepdims=True), 1e-10)
    sims = np.sort(cn @ _CHORD_MATRIX.T, axis=-1)
    errors, failures = parity.check_extracted(
        got, ref, SR, 1024, near_zero=near, n_samples=N, chord_margin=sims[..., -1] - sims[..., -2])
    assert not failures, (failures, errors)
    assert got["chroma_cqt"].shape == (2, (N - 8192) // 512 + 1, 12)
    assert got["hpcp"].shape == got["chroma"].shape
    np.testing.assert_allclose(got["chroma_cqt"].sum(-1), 1.0, rtol=1e-5)
    norms = np.linalg.norm(got["hpcp"], axis=-1)
    np.testing.assert_allclose(norms[norms > 0], 1.0, rtol=1e-5)


@pytest.mark.parametrize("content", ["news", "talk", "music", "unknown"])
def test_extractor_classes_match_jax(voices, content):
    """The extractor the factory gives, non-strict routing, on one
    content's feature config: name, weights, and the assembled
    ExtractedFeatures field by field."""
    from sonido_sonar_tpu.config.content_config import ContentAwareConfigManager as JManager
    from sonido_sonar_tpu_torch.config.content_config import ContentAwareConfigManager

    ct = ContentType(content)
    fc = ContentAwareConfigManager().get_generation_config(ct).feature_config.with_(
        window_size=1024, hop_size=256)
    jfc = JManager().get_generation_config(JContentType(content)).feature_config.with_(
        window_size=1024, hop_size=256)
    ext = FeatureExtractorFactory(False).create_extractor(ct, fc)
    jext = JFactory(False).create_extractor(JContentType(content), jfc)
    assert ext.get_name() == jext.get_name()
    assert ext.get_content_type().value == jext.get_content_type().value
    assert ext.get_feature_weights() == jext.get_feature_weights()
    x = voices[:2]
    feats = ext.extract_features_from_pcm(torch.from_numpy(x), SR)
    jfeats = jext.extract_features_from_pcm(jnp.asarray(x), SR)
    assert feats.metadata == jfeats.metadata
    got, ref = features_to_numpy(feats), features_to_numpy(jfeats)
    pre = 0.97 if ext.get_name() == "SpeechFeatureExtractor" else None
    if pre is None:
        p = np.asarray(jfilters.pre_emphasis_for_content(jfilters.dc_removal(jnp.asarray(x)), "music"))
        near = parity.near_zero_frames(p, 1024, 256, 0.0, parity.DC_NEAR_ZERO)
    else:
        near = parity.near_zero_frames(x, 1024, 256, pre)
    errors, failures = parity.check_extracted(got, ref, SR, 1024, near_zero=near, n_samples=N)
    assert not failures, (failures, errors)


def test_factory_routing():
    fc = FeatureConfig()
    strict = FeatureExtractorFactory(True)
    for ct in ContentType:
        ext = strict.create_extractor(ct, fc)
        assert ext.get_name() == "SpeechFeatureExtractor"
        assert ext.is_news == (ct != ContentType.TALK)
    loose = FeatureExtractorFactory(False)
    jloose = JFactory(False)
    for ct, name in ((ContentType.MUSIC, "MusicFeatureExtractor"),
                     (ContentType.SPORTS, "SportsFeatureExtractor"),
                     (ContentType.MIXED, "MixedFeatureExtractor")):
        ext = loose.create_extractor(ct, fc)
        jext = jloose.create_extractor(JContentType(ct.value), JFeatureConfig())
        assert type(ext).__name__ == type(jext).__name__ == ext.get_name() == name
        assert ext.get_content_type() == ct and ext.get_feature_weights() == jext.get_feature_weights()
    assert JFeatureConfig().weights_dict() == fc.weights_dict()


def test_map_tensors_keeps_structure(voices):
    ext = FeatureExtractorFactory(True).create_extractor(ContentType.NEWS, FeatureConfig(window_size=1024, hop_size=256))
    feats = ext.extract_features_from_pcm(torch.from_numpy(voices[:2]), SR)
    row = map_tensors(lambda t: t[1], feats)
    one = ext.extract_features_from_pcm(torch.from_numpy(voices[1]), SR)
    assert row.metadata == one.metadata
    a, b = features_to_numpy(row), features_to_numpy(one)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
