"""The port's public fingerprint surface held to the JAX package on the
CPU: content detection (the [B, 9] feature pass and the classifier), the
generator under strict and non-strict routing, batch == per-clip,
speculation hit == miss, `pcm_matrix`, the mixed-corpus path, and the
config conversion. The clock-dependent `id` and `timestamp` fields are
not compared. Tolerances are utils/parity.py's (check_extracted)."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.config import config as jconfig  # noqa: E402
from sonido_sonar_tpu.config.content_config import ContentAwareConfigManager as JManager  # noqa: E402
from sonido_sonar_tpu.fingerprint import FingerprintGenerator as JGenerator  # noqa: E402
from sonido_sonar_tpu.fingerprint import content_detector as jcd  # noqa: E402
from sonido_sonar_tpu.ops import filters as jfilters  # noqa: E402
from sonido_sonar_tpu.io.audio import AudioData as JAudio  # noqa: E402
from sonido_sonar_tpu.io.audio import AudioMetadata as JMeta  # noqa: E402
from sonido_sonar_tpu_torch.config import config as tconfig  # noqa: E402
from sonido_sonar_tpu_torch.config.content_config import ContentAwareConfigManager  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import FingerprintBatch, FingerprintGenerator, batch_audios  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import content_detector as tcd  # noqa: E402
from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402
from sonido_sonar_tpu_torch.utils.convert import (  # noqa: E402
    features_to_numpy,
    fingerprint_config_from_dict,
)

torch.set_num_threads(1)
SR = 44100
N = int(1.2 * SR)
GEOMETRY = dict(sample_rate=SR, window_size=1024, hop_size=256)


def _babble(batch, n, seed):
    """Speech-like to the acoustic classifier: smoothed noise (ZCR ~0.2,
    centroid in 800-3000 Hz) gated off a quarter of the time."""
    rng = np.random.default_rng(seed)
    x = np.convolve(rng.standard_normal(batch * n), np.ones(6) / 6, "same").reshape(batch, n)
    gate = (np.arange(n) // 4410) % 4 != 0
    return (0.3 * x * gate).astype(np.float32)


@pytest.fixture(scope="module")
def clips():
    """[4, 1.2 s] each: music-like (harmonic_clips), voices, babble."""
    return {
        "music": parity.harmonic_clips(4, N, 41).numpy(),
        "voices": parity.voiced_pcm(4, N, 42).numpy(),
        "babble": _babble(4, N, 43),
    }


def _pair(x, label=None):
    meta = (lambda cls: cls(extra={"content_type": label})) if label else (lambda cls: None)
    return ([AudioData(r, SR, metadata=meta(AudioMetadata)) for r in x],
            [JAudio(r, SR, metadata=meta(JMeta)) for r in x])


def _compare_fps(fps, jfps, x, window=1024, hop=256):
    """Fingerprints of the rows of `x` from both packages, field by field."""
    assert [f.content_type.value for f in fps] == [f.content_type.value for f in jfps]
    for fp, jfp, row in zip(fps, jfps, x):
        for key in ("stream_url", "duration", "sample_rate", "hop_size", "channels"):
            assert getattr(fp, key) == getattr(jfp, key), key
        for key in ("extractor_name", "feature_weights", "feature_stats"):
            assert fp.metadata[key] == jfp.metadata[key], key
        assert fp.features.metadata == jfp.features.metadata
        got, ref = features_to_numpy(fp.features), features_to_numpy(jfp.features)
        if fp.metadata["extractor_name"] == "SpeechFeatureExtractor":
            near = parity.near_zero_frames(row, window, hop, 0.97)
        else:  # ZCR of the DC-removed, music-pre-emphasized row
            pre = np.asarray(jfilters.pre_emphasis_for_content(jfilters.dc_removal(jnp.asarray(row)), "music"))
            near = parity.near_zero_frames(pre, window, hop, 0.0, parity.DC_NEAR_ZERO)
        errors, failures = parity.check_extracted(
            got, ref, fp.sample_rate, window, near_zero=near, n_samples=len(row))
        assert not failures, (fp.content_type, failures, errors)


# ---------------------------------------------------------------------
# content detection
# ---------------------------------------------------------------------

def test_acoustic_features_and_classification_match_jax(clips):
    """[B, 9] float32 features against the JAX program: ZCR and silence
    are means of decisions (equal), the rest float32 sums of the same
    spectrum (rtol 1e-4; dB 1e-3); the classifier decides the same."""
    x = np.concatenate([clips["music"][:2], clips["voices"][:2], clips["babble"][:2]])
    got = tcd.batched_acoustic_features(torch.from_numpy(x), SR).numpy()
    ref = np.asarray(jcd.batched_acoustic_features_device(jnp.asarray(x), SR))
    np.testing.assert_allclose(got[:, [0, 3]], ref[:, [0, 3]], atol=1e-7)
    np.testing.assert_allclose(got[:, [1, 2, 5, 6, 7, 8]], ref[:, [1, 2, 5, 6, 7, 8]], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[:, 4], ref[:, 4], atol=1e-3)
    audios, jaudios = _pair(x)
    types = tcd.ContentDetector(device="cpu").detect_batch(audios)
    jtypes = jcd.ContentDetector().detect_batch(jaudios)
    assert [t.value for t in types] == [t.value for t in jtypes]
    assert {t.value for t in types} >= {"music", "news"}
    # the per-clip host path (float64 numpy) decides the same
    det = tcd.ContentDetector(device="cpu")
    assert [det.detect_content_type(a).value for a in audios] == [t.value for t in types]
    host = det.extract_acoustic_features(x[4], SR)
    jhost = jcd.ContentDetector().extract_acoustic_features(x[4], SR)
    assert dataclasses.asdict(host) == dataclasses.asdict(jhost)


@pytest.mark.parametrize("meta", [
    dict(extra={"content_type": "spoken"}), dict(genre="Hip Hop classics"),
    dict(genre="call-in"), dict(station="ESPN radio"), dict(url="http://x/npr/live"),
    dict(station="talk of the town"), dict(), None,
])
def test_metadata_cascade(meta):
    t = tcd.detect_from_metadata(AudioMetadata(**meta) if meta is not None else None)
    j = jcd.detect_from_metadata(JMeta(**meta) if meta is not None else None)
    assert t.value == j.value


# ---------------------------------------------------------------------
# the generator against JAX
# ---------------------------------------------------------------------

def test_generator_strict_news_matches_jax(clips):
    """News-labelled clips: the speech program with the voice-quality
    chain on (K2 with period amplitude)."""
    x = clips["voices"][:3]
    audios, jaudios = _pair(x, "news")
    cfg = tconfig.FingerprintConfig(feature_config=tconfig.FeatureConfig(**GEOMETRY))
    jcfg = jconfig.FingerprintConfig(feature_config=jconfig.FeatureConfig(**GEOMETRY))
    fps = FingerprintGenerator(cfg, device="cpu").generate_fingerprints_batch(audios)
    jfps = JGenerator(jcfg).generate_fingerprints_batch(jaudios)
    _compare_fps(fps, jfps, x)
    assert fps[0].features.speech_features is not None


def test_generator_nonstrict_music_matches_jax(clips):
    """Music-labelled clips under strict_reference_routing=False: the
    music program (K1 twice, K4 three times)."""
    x = clips["music"][:3]
    audios, jaudios = _pair(x, "music")
    cfg = tconfig.FingerprintConfig(feature_config=tconfig.FeatureConfig(**GEOMETRY))
    jcfg = jconfig.FingerprintConfig(feature_config=jconfig.FeatureConfig(**GEOMETRY))
    fps = FingerprintGenerator(cfg, strict_reference_routing=False, device="cpu").generate_fingerprints_batch(
        audios)
    jfps = JGenerator(jcfg, strict_reference_routing=False).generate_fingerprints_batch(jaudios)
    assert fps[0].metadata["extractor_name"] == "MusicFeatureExtractor"
    _compare_fps(fps, jfps, x)


def test_generator_detects_and_groups_like_jax(clips):
    """No metadata, the default config (2048/512): acoustic detection
    splits the batch into content groups, each on its own extractor."""
    x = np.concatenate([clips["babble"][:2], clips["music"][:1]])
    audios, jaudios = _pair(x)
    batch = FingerprintGenerator(device="cpu").generate_fingerprints_batch(audios, materialize=False)
    jbatch = JGenerator().generate_fingerprints_batch(jaudios, materialize=False)
    assert isinstance(batch, FingerprintBatch) and len(batch.groups) == 2
    assert all(fp.features is None for fp in batch.fingerprints)
    fps = batch.materialize()
    assert [f.content_type.value for f in fps] == ["news", "news", "music"]
    _compare_fps(fps, jbatch.materialize(), x, 2048, 512)
    # two groups, so the pack is put back in clip order: the same [3, 70]
    # matrix as JAX's, each entry scaled by max(|x|, 1)
    got, want = batch.comparator_matrix(13).numpy(), np.asarray(jbatch.comparator_matrix(13))
    scale = np.maximum(np.abs(want), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=parity.COMPARATOR_PACK_SCALED_ATOL, rtol=0)


def test_generate_fingerprints_mixed_matches_jax(clips):
    """Two lengths and two rates -> buckets, input order restored; both
    packages fingerprint the zero-padded bucket rows (a reference-side
    fault: whole-clip scalars see the padding)."""
    long = clips["voices"][0]
    short = clips["voices"][1][: SR // 2]
    low = clips["voices"][2][: SR // 2][::2].copy()
    pcms, rates = [short, long, low], [SR, SR, SR // 2]
    meta = {"content_type": "talk"}
    audios = [AudioData(p, r, metadata=AudioMetadata(extra=meta)) for p, r in zip(pcms, rates)]
    jaudios = [JAudio(p, r, metadata=JMeta(extra=meta)) for p, r in zip(pcms, rates)]
    cfg = tconfig.FingerprintConfig(feature_config=tconfig.FeatureConfig(**GEOMETRY))
    jcfg = jconfig.FingerprintConfig(feature_config=jconfig.FeatureConfig(**GEOMETRY))
    fps = FingerprintGenerator(cfg, device="cpu").generate_fingerprints_mixed(audios)
    jfps = JGenerator(jcfg).generate_fingerprints_mixed(jaudios)
    assert [f.duration for f in fps] == [a.duration for a in audios]
    assert [f.sample_rate for f in fps] == rates
    padded = {}
    for bucket in batch_audios(audios):
        padded.update(zip(bucket.indices, bucket.pcm_matrix))
    _compare_fps(fps, jfps, [padded[i] for i in range(3)])


# ---------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------

def _equal_features(a, b):
    fa, fb = features_to_numpy(a), features_to_numpy(b)
    assert sorted(fa) == sorted(fb)
    return all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_batch_equals_per_clip_and_pcm_matrix(clips):
    """One clip alone through generate_fingerprint gives its batch row's
    features (same program, leading axes as rows); a pre-stacked
    pcm_matrix gives the stacked batch's bits."""
    x = clips["voices"][:2]
    cfg = tconfig.FingerprintConfig(feature_config=tconfig.FeatureConfig(**GEOMETRY))
    gen = FingerprintGenerator(cfg, device="cpu")
    audios, _ = _pair(x, "news")
    fps = gen.generate_fingerprints_batch(audios)
    one = gen.generate_fingerprint(audios[1])
    got, ref = features_to_numpy(one.features), features_to_numpy(fps[1].features)
    errors, failures = parity.check_extracted(got, ref, SR, 1024, n_samples=N,
                                              near_zero=parity.near_zero_frames(x[1], 1024, 256, 0.97))
    assert not failures, (failures, errors)
    assert one.metadata["feature_stats"] == fps[1].metadata["feature_stats"]
    fpm = gen.generate_fingerprints_batch(audios, pcm_matrix=torch.from_numpy(np.stack(x)))
    assert all(_equal_features(a.features, b.features) for a, b in zip(fps, fpm))
    with pytest.raises(ValueError, match="pcm_matrix shape"):
        gen.generate_fingerprints_batch(audios, pcm_matrix=np.zeros((3, N), np.float32))


def test_speculation_hit_and_miss_equal_no_speculation(clips):
    """Prime with an all-music batch, then send babble (a miss: news
    detected) and music again (a hit): the features equal those of a
    generator that never speculates."""
    music, _ = _pair(clips["music"][:2])
    babble, _ = _pair(clips["babble"][:2])
    gen = FingerprintGenerator(device="cpu")
    ref_gen = FingerprintGenerator(device="cpu")
    gen.generate_fingerprints_batch(music)
    assert gen._spec_ct == tconfig.ContentType.MUSIC
    miss = gen.generate_fingerprints_batch(babble)
    assert gen._spec_ct == tconfig.ContentType.NEWS
    gen.generate_fingerprints_batch(music)
    hit = gen.generate_fingerprints_batch(music)
    for fps, audios in ((miss, babble), (hit, music)):
        ref = ref_gen.generate_fingerprints_batch(audios, speculate=False)
        assert [f.content_type for f in fps] == [f.content_type for f in ref]
        assert all(_equal_features(a.features, b.features) for a, b in zip(fps, ref))


def test_all_metadata_batch_dispatches_nothing(clips):
    """Every clip labelled: no acoustic pass, `dispatched` is bound and
    False (the JAX package leaves it unbound on this path)."""
    audios, _ = _pair(clips["voices"][:2], "talk")
    gen = FingerprintGenerator(device="cpu")
    resolve, dispatched = gen._detect_content_types_batch_async(audios, torch.from_numpy(clips["voices"][:2]))
    assert dispatched is False
    assert resolve() == [tconfig.ContentType.TALK] * 2
    cfg = dataclasses.replace(gen.config, content_aware=tconfig.ContentAwareConfig(enable_content_detection=False))
    plain, _ = _pair(clips["voices"][:2])
    resolve, dispatched = FingerprintGenerator(cfg, device="cpu")._detect_content_types_batch_async(
        plain, torch.from_numpy(clips["voices"][:2]))
    assert dispatched is False and resolve() == [tconfig.ContentType.UNKNOWN] * 2


def test_config_factories_and_conversion():
    """The per-content factories equal the JAX package's, and JAX configs
    convert to the port's."""
    for ct in tconfig.ContentType:
        jct = jconfig.ContentType(ct.value)
        for name in ("get_content_optimized_comparison_config", "alignment_config_for_content",
                     "comparison_config_for_content", "content_feature_toggles"):
            t, j = getattr(tconfig, name)(ct), getattr(jconfig, name)(jct)
            if isinstance(t, dict):
                assert t == j
            else:
                assert tconfig.asdict(t) == jconfig.asdict(j), (name, ct)
        jgen = JManager().get_generation_config(jct)
        assert fingerprint_config_from_dict(jconfig.asdict(jgen)) == \
            ContentAwareConfigManager().get_generation_config(ct)
        assert tconfig.asdict(ContentAwareConfigManager().get_comparison_config(ct)) == \
            jconfig.asdict(JManager().get_comparison_config(jct))
    jcfg = jconfig.FingerprintConfig(
        feature_config=jconfig.FeatureConfig(window_size=1024, hop_size=256),
        content_aware=jconfig.ContentAwareConfig(default_content_type=jconfig.ContentType.TALK),
    )
    cfg = fingerprint_config_from_dict(jconfig.asdict(jcfg))
    assert cfg.content_aware.default_content_type == tconfig.ContentType.TALK
    assert cfg == tconfig.FingerprintConfig(
        feature_config=tconfig.FeatureConfig(window_size=1024, hop_size=256),
        content_aware=tconfig.ContentAwareConfig(default_content_type=tconfig.ContentType.TALK))
    assert tconfig.default_fingerprint_config().feature_config.window_size == 2048
    with pytest.raises(ValueError, match="unknown"):
        fingerprint_config_from_dict({"nope": 1})
