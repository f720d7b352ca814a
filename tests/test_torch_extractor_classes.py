"""The port's extractor class compositions held to the JAX package's on
the CPU: `extract_features(spectrogram, pcm, sample_rate)` of the
speech, music, sports and mixed extractors, field by field and metadata
included, end to end (each package's own `stft`) and on one shared
spectrogram (`utils/convert.stft_result_from_reference`); the speech
and music compositions against the port's own programs; batch-axis
parity; the toggles; the optional steps' failure handling; the
standalone spectral descriptors and energy ops; the generator under
non-strict routing on sports- and mixed-labelled clips; and sports and
mixed fingerprints through the comparator and serialization. K2, K2
with the period amplitude, K4 and K1 run their plain versions here.
Tolerances are utils/parity.py's (check_extracted, check_metadata)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu import extractors as jext  # noqa: E402
from sonido_sonar_tpu.config import config as jconfig  # noqa: E402
from sonido_sonar_tpu.fingerprint import FingerprintComparator as JComparator  # noqa: E402
from sonido_sonar_tpu.fingerprint import FingerprintGenerator as JGenerator  # noqa: E402
from sonido_sonar_tpu.fingerprint.generator import AudioFingerprint as JFingerprint  # noqa: E402
from sonido_sonar_tpu.io.audio import AudioData as JAudio  # noqa: E402
from sonido_sonar_tpu.io.audio import AudioMetadata as JMeta  # noqa: E402
from sonido_sonar_tpu.ops import filters as jfilters  # noqa: E402
from sonido_sonar_tpu.ops import spectral as JS  # noqa: E402
from sonido_sonar_tpu.ops import temporal as JT  # noqa: E402
from sonido_sonar_tpu.ops.stft import stft as jstft  # noqa: E402
from sonido_sonar_tpu.utils import serialize as jserialize  # noqa: E402
from sonido_sonar_tpu_torch import _build, extractors as text  # noqa: E402
from sonido_sonar_tpu_torch.config import config as tconfig  # noqa: E402
from sonido_sonar_tpu_torch.extractors.features import map_tensors  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import FingerprintComparator, FingerprintGenerator  # noqa: E402
from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata  # noqa: E402
from sonido_sonar_tpu_torch.ops import hopper_yin  # noqa: E402
from sonido_sonar_tpu_torch.ops import spectral as TS  # noqa: E402
from sonido_sonar_tpu_torch.ops import temporal as TT  # noqa: E402
from sonido_sonar_tpu_torch.ops.stft import stft  # noqa: E402
from sonido_sonar_tpu_torch.utils import load_fingerprint_npz, parity, save_fingerprint_npz  # noqa: E402
from sonido_sonar_tpu_torch.utils.convert import (  # noqa: E402
    features_to_numpy,
    fingerprint_from_reference,
    stft_result_from_reference,
)

from tests.test_torch_comparator import _same_result  # noqa: E402

torch.set_num_threads(1)
SR = 44100
N = int(1.5 * SR)
W, HOP = 1024, 256
# every feature family on, so each step of each composition runs
FAMILIES = dict(enable_speech_features=True, enable_harmonic_features=True, enable_chroma=True)
CLASSES = ("speech", "music", "sports", "mixed")


def _extractor(pkg, name, **toggles):
    """The `name` extractor of one package (`jext` or `text`) on a 1024/256
    config with every family on (news for speech)."""
    cfg_mod = jconfig if pkg is jext else tconfig
    cfg = cfg_mod.FeatureConfig(sample_rate=SR, window_size=W, hop_size=HOP, **{**FAMILIES, **toggles})
    if name == "speech":
        return pkg.SpeechFeatureExtractor(cfg, is_news=True)
    return {"music": pkg.MusicFeatureExtractor, "sports": pkg.SportsFeatureExtractor,
            "mixed": pkg.MixedFeatureExtractor}[name](cfg)


@pytest.fixture(scope="module")
def inputs():
    """speech, sports, mixed: a voice and a noise row (parity.voiced_pcm);
    music: two harmonic clips with an amplitude pulse every 0.5 s."""
    voices = parity.voiced_pcm(4, N, 31).numpy()[2:]
    music = parity.harmonic_clips(2, N, 32).numpy()
    music = (music * (1.0 + 0.8 * (np.mod(np.arange(N) / SR, 0.5) < 0.05))).astype(np.float32)
    return {"speech": voices, "sports": voices, "mixed": voices, "music": music}


def _near(name, x):
    """Frames exempt from the exact ZCR comparison: a sample near 0 after
    the extractor's preprocessing."""
    if name == "music":
        pre = np.asarray(jfilters.pre_emphasis_for_content(jfilters.dc_removal(jnp.asarray(x)), "music"))
        return parity.near_zero_frames(pre, W, HOP, 0.0, parity.DC_NEAR_ZERO)
    return parity.near_zero_frames(x, W, HOP, 0.96 if name == "sports" else 0.97)


def _held(got, ref, name, x):
    errors, failures = parity.check_extracted(
        features_to_numpy(got), features_to_numpy(ref), SR, W, near_zero=_near(name, x),
        n_samples=x.shape[-1])
    m_errors, m_failures = parity.check_metadata(got.metadata, ref.metadata)
    assert not failures + m_failures, (name, failures + m_failures, errors, m_errors)


@pytest.fixture(scope="module")
def jax_refs(inputs):
    """name -> (JAX's spectrogram, JAX's composition over it)."""
    out = {}
    for name in CLASSES:
        x = jnp.asarray(inputs[name])
        spec = jstft(x, W, HOP, sample_rate=SR)
        out[name] = (spec, _extractor(jext, name).extract_features(spec, x, SR))
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_composition_matches_jax(inputs, jax_refs, name):
    """End to end: the port's composition over the port's stft."""
    x = inputs[name]
    got = _extractor(text, name).extract_features(stft(torch.from_numpy(x), W, HOP, sample_rate=SR),
                                                  torch.from_numpy(x), SR)
    _held(got, jax_refs[name][1], name, x)


@pytest.mark.parametrize("name", CLASSES)
def test_composition_on_shared_spectrogram(inputs, jax_refs, name):
    """Both packages' compositions on JAX's magnitudes; numpy PCM goes to
    the spectrogram's device."""
    x = inputs[name]
    spec = jax_refs[name][0]
    shared = stft_result_from_reference(spec.magnitude, None, None, SR, W, HOP, "cpu")
    got = _extractor(text, name).extract_features(shared, x, SR)
    _held(got, jax_refs[name][1], name, x)


@pytest.mark.parametrize("name", ["speech", "music"])
def test_composition_matches_program(inputs, name):
    """The port's composition is the oracle its program is held to (JAX
    tests/test_extractor_programs.py:64-125)."""
    x = torch.from_numpy(inputs[name])
    ext = _extractor(text, name)
    want = ext.extract_features(stft(x, W, HOP, sample_rate=SR), x, SR)
    _held(ext.extract_features_from_pcm(x, SR), want, name, inputs[name])


@pytest.mark.parametrize("name", CLASSES)
def test_batch_axis_parity(name):
    """[2, N] and the first clip alone at 8 kHz, 512/128 (JAX
    tests/test_surface_extras.py:243-295): every field of row 0 equals
    the single clip's within BATCH_ROW_TOL; sports' excitement proxies
    are a list for the batch and a float for the clip."""
    sr = 8000
    t = np.arange(sr) / sr
    rng = np.random.default_rng(7)
    pcm = np.stack([np.sin(2 * np.pi * (160.0 + 30 * i) * t) + 0.02 * rng.standard_normal(sr)
                    for i in range(2)]).astype(np.float32)
    cfg = tconfig.FeatureConfig(sample_rate=sr, window_size=512, hop_size=128, **FAMILIES)
    ext = {"speech": text.SpeechFeatureExtractor, "music": text.MusicFeatureExtractor,
           "sports": text.SportsFeatureExtractor, "mixed": text.MixedFeatureExtractor}[name](cfg)
    x = torch.from_numpy(pcm)
    fb = ext.extract_features(stft(x, 512, 128, sample_rate=sr), x, sr)
    f0 = ext.extract_features(stft(x[0], 512, 128, sample_rate=sr), x[0], sr)
    a, b = features_to_numpy(fb), features_to_numpy(f0)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].shape[1:] == b[k].shape, (k, a[k].shape, b[k].shape)
        np.testing.assert_allclose(a[k][0].astype(np.float64), b[k].astype(np.float64),
                                   *parity.BATCH_ROW_TOL, err_msg=k)
    if name == "sports":
        for key in ("excitement_variance", "excitement_entropy"):
            assert isinstance(fb.metadata[key], list) and isinstance(f0.metadata[key], float)
            assert fb.metadata[key][0] == pytest.approx(f0.metadata[key], rel=parity.BATCH_ROW_TOL[0])


def test_toggles(inputs, jax_refs):
    """Speech with MFCC, speech features, contrast and temporal off; music
    with MFCC, chroma and harmonic off (its temporal step always runs):
    the same fields present as JAX's, and their values held to it."""
    for name, toggles in (
        ("speech", dict(enable_mfcc=False, enable_speech_features=False,
                        enable_spectral_contrast=False, enable_temporal_features=False)),
        ("music", dict(enable_mfcc=False, enable_chroma=False, enable_harmonic_features=False,
                       enable_temporal_features=False)),
    ):
        x = inputs[name]
        spec = jax_refs[name][0]
        got = _extractor(text, name, **toggles).extract_features(
            stft_result_from_reference(spec.magnitude, None, None, SR, W, HOP, "cpu"), x, SR)
        ref = _extractor(jext, name, **toggles).extract_features(spec, jnp.asarray(x), SR)
        assert got.mfcc is None and got.chroma_features is None
        assert (got.temporal_features is None) == (name == "speech")
        assert (got.harmonic_features is None) == (name == "music")
        _held(got, ref, name, x)


@pytest.mark.parametrize("error", [_build.KernelError, RuntimeError])
def test_optional_steps_raise_kernel_errors(inputs, monkeypatch, error):
    """A K2 failure inside the speech step (3) and the harmonic step (7)
    raises when it is a KernelError; any other failure leaves those
    fields None and the rest whole, as the reference's handlers do."""
    def failing(*args, **kwargs):
        raise error("K2 launch failed")

    monkeypatch.setattr(hopper_yin, "yin_pitch_hopper", failing)
    x = torch.from_numpy(inputs["speech"])
    ext = _extractor(text, "speech")
    spec = stft(x, W, HOP, sample_rate=SR)
    if error is _build.KernelError:
        with pytest.raises(_build.KernelError):
            ext.extract_features(spec, x, SR)
        return
    got = ext.extract_features(spec, x, SR)
    assert got.speech_features is None and got.harmonic_features is None
    assert got.temporal_features is not None and got.energy_features is not None
    assert got.mfcc is not None and got.metadata["extractor_type"] == "speech"


def test_standalone_descriptors_match_jax_and_the_bundle(jax_refs):
    """The seven standalone descriptors on JAX's magnitudes against JAX's,
    and against the port's shared-pass bundle on the same magnitudes."""
    mag = np.array(jax_refs["speech"][0].magnitude)
    m, jm = torch.from_numpy(mag), jnp.asarray(mag)
    names = ("spectral_centroid", "spectral_rolloff", "spectral_bandwidth", "spectral_flatness",
             "spectral_crest", "spectral_slope")

    def call(mod, fn, a):
        f = getattr(mod, fn)
        return f(a) if fn in ("spectral_flatness", "spectral_crest", "spectral_flatness_db") else f(a, SR)

    got = {k: call(TS, k, m).numpy() for k in names + ("spectral_flatness_db",)}
    ref = {k: np.asarray(call(JS, k, jm)) for k in names + ("spectral_flatness_db",)}
    errors, failures = parity.check_extracted(got, ref, SR, W)
    assert not failures, (failures, errors)
    bundle = {k: v.numpy() for k, v in TS.spectral_descriptor_bundle(m, SR).items() if k in names}
    errors, failures = parity.check_extracted({k: got[k] for k in names}, bundle, SR, W)
    assert not failures, (failures, errors)


def test_energy_entropy_and_ratio_match_jax(inputs):
    rms = np.array(JT.short_time_energy(jnp.asarray(inputs["speech"]), W, HOP))
    r = torch.from_numpy(rms)
    errors, failures = {}, []
    parity._close("energy_entropy", TT.energy_entropy(r).numpy(), np.asarray(JT.energy_entropy(jnp.asarray(rms))),
                  *parity.METADATA_TOLERANCES["excitement_entropy"], errors, failures)
    e2 = rms[::-1].copy()
    e2[:, :5] = 0.0
    parity._close("energy_ratio", TT.energy_ratio(r, torch.from_numpy(e2)).numpy(),
                  np.asarray(JT.energy_ratio(jnp.asarray(rms), jnp.asarray(e2))),
                  *parity.FEATURE_TOLERANCES["low_energy_ratio"], errors, failures)
    assert not failures, (failures, errors)
    assert (TT.energy_ratio(r, torch.from_numpy(e2))[:, :5] == 0).all()


# ---------------------------------------------------------------------
# the generator, the comparator and serialization
# ---------------------------------------------------------------------

GEOMETRY = dict(sample_rate=SR, window_size=W, hop_size=HOP)


def _labelled(x, label):
    return ([AudioData(r, SR, metadata=AudioMetadata(extra={"content_type": label})) for r in x],
            [JAudio(r, SR, metadata=JMeta(extra={"content_type": label})) for r in x])


@pytest.fixture(scope="module")
def generated(inputs):
    """label -> (the port's FingerprintBatch, JAX's fingerprints, JAX's
    composition over JAX's stft with the generator's feature config),
    non-strict routing, on the voice and noise rows."""
    x = inputs["sports"]
    out = {}
    for label in ("sports", "mixed"):
        audios, jaudios = _labelled(x, label)
        gen = FingerprintGenerator(tconfig.FingerprintConfig(feature_config=tconfig.FeatureConfig(**GEOMETRY)),
                                   strict_reference_routing=False, device="cpu")
        jgen = JGenerator(jconfig.FingerprintConfig(feature_config=jconfig.FeatureConfig(**GEOMETRY)),
                          strict_reference_routing=False)
        batch = gen.generate_fingerprints_batch(audios, materialize=False)
        jfps = jgen.generate_fingerprints_batch(jaudios)
        ct = jconfig.ContentType(label)
        jext_ = jgen.extractor_factory.create_extractor(ct, jgen._feature_config_for(ct, SR))
        jfeats = jext_.extract_features(jstft(jnp.asarray(x), W, HOP, sample_rate=SR), jnp.asarray(x), SR)
        out[label] = (batch, jfps, jfeats)
    return out


@pytest.mark.parametrize("label", ["sports", "mixed"])
def test_generator_nonstrict_matches_jax(inputs, generated, label):
    """Sports- and mixed-labelled clips under strict_reference_routing=
    False: the class composition over `stft`, per clip, held to JAX's
    composition over JAX's stft (row by row). Mixed content also equals
    JAX's generator. Sports does not: the JAX class inherits the speech
    program, which JAX's `_extract` prefers, so JAX's generator gives a
    sports clip the speech payload (a reference-side fault, ROADMAP §3)."""
    x = inputs["sports"]
    batch, jfps, jfeats = generated[label]
    assert len(batch.groups) == 1 and batch.groups[0][0].value == label
    fps = batch.materialize()
    name = "SportsFeatureExtractor" if label == "sports" else "MixedFeatureExtractor"
    for i, (fp, jfp) in enumerate(zip(fps, jfps)):
        assert fp.content_type.value == jfp.content_type.value == label
        for key in ("extractor_name", "feature_weights", "feature_stats"):
            assert fp.metadata[key] == jfp.metadata[key], key
        assert fp.metadata["extractor_name"] == name
        row = features_to_numpy(jfeats)
        row = {k: v[i] for k, v in row.items()}
        errors, failures = parity.check_extracted(
            features_to_numpy(fp.features), row, SR, W, near_zero=_near(label, x[i]), n_samples=N)
        assert not failures, (label, i, failures, errors)
        if label == "mixed":
            _held(fp.features, jfp.features, label, x[i])
    if label == "sports":
        assert jfps[0].features.metadata["extractor_type"] == "speech"
        assert fps[0].features.metadata["extractor_type"] == "sports"


def test_group_metadata_lists_reach_every_clip(generated):
    """Every clip of a sports group carries the group's excitement lists,
    as JAX's `materialize` gives them; map_tensors keeps them."""
    batch, _, jfeats = generated["sports"]
    (_, idxs, feats), = batch.groups
    lists = feats.metadata["excitement_variance"]
    assert isinstance(lists, list) and len(lists) == len(idxs)
    errors, failures = parity.check_metadata(feats.metadata, jfeats.metadata)
    assert not failures, (failures, errors)
    row = map_tensors(lambda t: t[1], feats)
    assert row.metadata == feats.metadata and row.metadata is not feats.metadata
    assert row.energy_features.short_time_energy.shape == feats.energy_features.short_time_energy.shape[1:]
    for fp in batch.materialize():
        assert fp.features.metadata["excitement_variance"] == lists


@pytest.mark.parametrize("label", ["sports", "mixed"])
def test_comparator_on_sports_and_mixed_matches_jax(generated, label):
    """JAX's composition features for the two clips, wrapped as
    fingerprints, compare the same in both comparators (JAX
    tests/test_pipeline.py:329-360); the port's own fingerprints of one
    clip compare as near-identical."""
    _, jfps, jfeats = generated[label]
    ct = jconfig.ContentType(label)

    def wrap(i):
        from jax import tree_util

        feats = tree_util.tree_map(lambda a: np.asarray(a)[i], jfeats)
        return JFingerprint(id=f"{label}{i}", stream_url="", content_type=ct, timestamp=0.0,
                            duration=N / SR, sample_rate=SR, hop_size=HOP, channels=1,
                            features=feats, metadata={})

    a, b = wrap(0), wrap(1)
    comparator = FingerprintComparator(device="cpu")
    for p, q in ((a, a), (a, b)):
        _same_result(comparator.compare(fingerprint_from_reference(p), fingerprint_from_reference(q)),
                     JComparator().compare(p, q))
    fps = generated[label][0].materialize()
    assert comparator.compare(fps[0], fps[0]).overall_similarity > 0.9


def test_sports_fingerprint_serializes_both_ways(tmp_path, generated):
    """A port sports fingerprint written by the port loads in JAX bit for
    bit, and written by JAX (from what it loaded) loads in the port bit
    for bit."""
    fp = generated["sports"][0].materialize()[0]
    save_fingerprint_npz(str(tmp_path / "port.npz"), fp)
    jfp = jserialize.load_fingerprint_npz(str(tmp_path / "port.npz"))
    jserialize.save_fingerprint_npz(str(tmp_path / "jax.npz"), jfp)
    back = load_fingerprint_npz(str(tmp_path / "jax.npz"))
    want = features_to_numpy(fp.features)
    for got in (features_to_numpy(jfp.features), features_to_numpy(back.features)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert back.metadata["extractor_name"] == "SportsFeatureExtractor"
    assert back.content_type.value == jfp.content_type.value == "sports"
