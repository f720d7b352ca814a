"""The port's `ops/tonal.py` held to the JAX package on the CPU: twins of
`tests/test_tonal.py` (each runs the same recipe through both packages
and asserts the same property of the port), plus the key and chord
tables bit for bit, a chord sequence's one product against the
per-frame calls, every pitch method and hybrid over frames and tracks,
the spectral-mask HNR, octave correction at NaN edges and inharmonicity
on random spectra. Tolerances: utils/parity.py (MUSIC_*, MUSIC_TIE,
FFT_PITCH_MISS_SHARE, check_pitch)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.io.synth import harmonic_tone, sine, white_noise  # noqa: E402
from sonido_sonar_tpu.ops import tonal as J  # noqa: E402
from sonido_sonar_tpu.ops.framing import frame_signal as jframes  # noqa: E402
from sonido_sonar_tpu.ops.pitch import PitchParams as JParams  # noqa: E402
from sonido_sonar_tpu.ops.stft import stft as jstft  # noqa: E402
from sonido_sonar_tpu_torch.ops import tonal as T  # noqa: E402
from sonido_sonar_tpu_torch.ops.chroma import CHROMA_LABELS  # noqa: E402
from sonido_sonar_tpu_torch.ops.framing import frame_signal  # noqa: E402
from sonido_sonar_tpu_torch.ops.pitch import PitchParams  # noqa: E402
from sonido_sonar_tpu_torch.ops.stft import stft as tstft  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)
SR = 22050
CPU = "cpu"


def note_freq(label, octave=4):
    semis = CHROMA_LABELS.index(label) - 9 + (octave - 4) * 12
    return 440.0 * 2 ** (semis / 12)


def chroma_of(labels, weights=None):
    v = np.zeros(12)
    for i, lab in enumerate(labels):
        v[CHROMA_LABELS.index(lab)] = weights[i] if weights else 1.0
    return v / v.sum()


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, ref, rtol=parity.MUSIC_RTOL, atol=parity.MUSIC_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def _same_key(got, ref):
    """Equal results, the label only where the top two are not near-tied."""
    _close(got.all_correlations, ref.all_correlations)
    assert got.all_correlations.dtype == np.float32
    _close([got.strength, got.confidence, got.stability], [ref.strength, ref.confidence, ref.stability])
    if ref.confidence > parity.MUSIC_TIE:
        assert (got.key, got.mode) == (ref.key, ref.mode)
    assert [m["window"] for m in got.modulations] == [m["window"] for m in ref.modulations]


def _same_chord(got, ref):
    assert got.chord == ref.chord or ref.confidence == 0.0 or abs(
        ref.candidates[0].score - ref.candidates[1].score) <= parity.MUSIC_TIE
    _close([c.score for c in got.candidates], [c.score for c in ref.candidates])
    _close(got.confidence, ref.confidence)


# ------------------------------ key ------------------------------------

def test_key_profiles_all_present():
    assert set(T.KEY_PROFILES) == set(J.KEY_PROFILES) == {
        "krumhansl", "temperley", "shaath", "edma", "bgate", "diatonic", "tonic_triad"}
    for name, p in T.KEY_PROFILES.items():
        np.testing.assert_array_equal(T._profile_matrix(name), J._profile_matrix(name))
        assert len(p["major"]) == 12 and len(p["minor"]) == 12


def test_key_estimation_c_major_scale():
    scale = chroma_of(["C", "D", "E", "F", "G", "A", "B"])
    scale[CHROMA_LABELS.index("C")] *= 3
    scale[CHROMA_LABELS.index("G")] *= 2
    res = T.KeyEstimator("krumhansl", device=CPU).estimate_key(scale)
    _same_key(res, J.KeyEstimator("krumhansl").estimate_key(scale))
    assert res.key == "C" and res.mode == "major"
    assert res.strength > 0.5 and len(res.all_correlations) == 24


def test_key_estimation_a_minor_scale():
    scale = chroma_of(["A", "B", "C", "D", "E", "F", "G"])
    scale[CHROMA_LABELS.index("A")] *= 3
    scale[CHROMA_LABELS.index("E")] *= 2
    res = T.KeyEstimator("krumhansl", device=CPU).estimate_key(scale)
    _same_key(res, J.KeyEstimator("krumhansl").estimate_key(scale))
    assert res.key == "A" and res.mode == "minor"


@pytest.mark.parametrize("profile", list(J.KEY_PROFILES))
def test_key_all_profiles_run(profile):
    scale = chroma_of(["C", "E", "G"], weights=[3, 1, 2])
    res = T.KeyEstimator(profile, device=CPU).estimate_key(scale)
    _same_key(res, J.KeyEstimator(profile).estimate_key(scale))
    assert res.key in CHROMA_LABELS


def test_key_sequence_stability_and_modulation():
    c_major = chroma_of(["C", "D", "E", "F", "G", "A", "B"])
    c_major[0] *= 3
    g_major = np.roll(c_major, 7)
    seq = np.stack([c_major] * 24 + [g_major] * 24)
    res = T.KeyEstimator(device=CPU).estimate_key_sequence(seq)
    _same_key(res, J.KeyEstimator().estimate_key_sequence(seq))
    assert 0 <= res.stability <= 1.0
    assert len(res.modulations) >= 1


@pytest.mark.parametrize("profile", ["krumhansl", "edma"])
def test_key_sequence_random_matches_jax(profile):
    """A noisy 300-frame chromagram: the windows' keys, the stability
    and the modulations, from one device pass, equal JAX's window by
    window calls."""
    rng = np.random.default_rng(170)
    seq = rng.uniform(0, 1, (300, 12)).astype(np.float32) ** 3
    seq[150:] = np.roll(seq[150:], 5, axis=1)
    got = T.KeyEstimator(profile, device=CPU).estimate_key_sequence(torch.from_numpy(seq))
    _same_key(got, J.KeyEstimator(profile).estimate_key_sequence(seq))


def test_key_estimator_rejects_an_unknown_profile():
    with pytest.raises(ValueError, match="unknown key profile"):
        T.KeyEstimator("nope", device=CPU)


# ------------------------------ chords ---------------------------------

def test_chord_tables_bit_equal():
    np.testing.assert_array_equal(T.CHORD_MATRIX, J._CHORD_MATRIX)
    assert T.CHORD_LABELS == J._CHORD_LABELS and T.CHORD_QUALITIES == J.CHORD_QUALITIES


def test_chord_detection_major_minor():
    det, jdet = T.ChordDetector(device=CPU), J.ChordDetector()
    for labels, want in ((["C", "E", "G"], ("C", "major")), (["A", "C", "E"], ("A", "minor"))):
        res = det.detect_chord(chroma_of(labels))
        _same_chord(res, jdet.detect_chord(chroma_of(labels)))
        assert (res.root, res.quality) == want


def test_chord_detection_seventh():
    g7 = chroma_of(["G", "B", "D", "F"])
    res = T.ChordDetector(device=CPU).detect_chord(g7)
    _same_chord(res, J.ChordDetector().detect_chord(g7))
    assert res.root == "G" and res.quality == "dominant7"


def test_chord_silence():
    res = T.ChordDetector(device=CPU).detect_chord(np.zeros(12))
    ref = J.ChordDetector().detect_chord(np.zeros(12))
    assert (res.chord, res.root, res.quality, res.confidence, res.candidates) == (
        ref.chord, ref.root, ref.quality, ref.confidence, ref.candidates)
    assert res.chord == "N"


def test_chord_progression():
    c, f, g = chroma_of(["C", "E", "G"]), chroma_of(["F", "A", "C"]), chroma_of(["G", "B", "D"])
    seq = np.stack([c] * 8 + [f] * 8 + [g] * 8 + [c] * 8)
    out = T.ChordProgressionAnalyzer(device=CPU).analyze(seq)
    assert out == J.ChordProgressionAnalyzer().analyze(seq)
    assert out["progression"] == ["C", "F", "G", "C"] and out["num_changes"] == 3


def _jax_chords(seq, qualities):
    """JAX's detect_chord frame by frame. With `qualities` JAX itself
    raises on the CPU (it masks the read-only array `np.asarray` makes
    of a device result, `ops/tonal.py:220-226`): the reference then runs
    the same ranking on a writable copy of JAX's scores."""
    det = J.ChordDetector(qualities)
    if qualities is None:
        return det.detect_sequence(seq)
    out = []
    for v in seq:
        nv = np.linalg.norm(v)
        if nv < 1e-10:
            out.append(J.ChordDetectionResult("N", "N", "none", 0.0))
            continue
        sims = np.array(jnp.matmul(det._matrix, jnp.asarray(v / nv), preferred_element_type=jnp.float32))
        sims[[q not in qualities for _, q in det._labels]] = -np.inf
        order = np.argsort(sims)[::-1]
        cands = [J.ChordCandidate(*det._labels[i], float(sims[i])) for i in order[:5]]
        best = cands[0]
        out.append(J.ChordDetectionResult(
            f"{best.root}{'' if best.quality == 'major' else ':' + best.quality}", best.root,
            best.quality, min(1.0, max(0.0, best.score * 0.5 + float(sims[order[0]] - sims[order[1]]) * 2.0)),
            cands))
    return out


@pytest.mark.parametrize("qualities", [None, ["minor", "sus4", "dominant7"]])
def test_chord_sequence_one_product_matches_per_frame_and_jax(qualities):
    """detect_sequence (one device product) gives detect_chord's results
    frame by frame, silent frames included, and JAX's."""
    rng = np.random.default_rng(171)
    seq = rng.uniform(0, 1, (120, 12)).astype(np.float32) ** 4
    seq[[3, 50]] = 0.0
    det = T.ChordDetector(qualities, device=CPU)
    got = det.detect_sequence(torch.from_numpy(seq))
    ref = _jax_chords(seq, qualities)
    assert len(got) == len(ref) == 120
    for i, (g, r) in enumerate(zip(got, ref)):
        one = det.detect_chord(seq[i])
        assert g.chord == one.chord and [c.score for c in g.candidates] == [c.score for c in one.candidates]
        _same_chord(g, r)
    assert got[3].chord == got[50].chord == "N"
    if qualities:
        assert {g.quality for g in got} <= set(qualities) | {"none"}


# ------------------------------ HNR ------------------------------------

def test_hnr_analyzer_tone_vs_noise():
    tone = harmonic_tone(200.0, 0.5, SR)
    noise = white_noise(0.5, SR, 0.3, seed=1)
    an, jan = T.HarmonicRatioAnalyzer(SR, "acf", device=CPU), J.HarmonicRatioAnalyzer(SR, "acf")
    res = {}
    for name, x in (("tone", tone), ("noise", noise)):
        got = an.analyze_frames(frame_signal(_t(x), 2048, 1024))
        ref = jan.analyze_frames(jframes(jnp.asarray(x), 2048, 1024))
        errors, failures = parity.check_pitch_decisions(
            got.f0.numpy(), got.harmonic_ratio.numpy(), np.asarray(ref.f0), np.asarray(ref.harmonic_ratio))
        assert errors["pitch_miss_share"] == 0.0, errors
        _close(got.harmonic_ratio, ref.harmonic_ratio, *parity.EXTRACTOR_TOLERANCES["hnr"])
        res[name] = got
    assert float(res["tone"].harmonic_ratio.mean()) > 10.0
    assert float(res["noise"].harmonic_ratio.mean()) < 5.0
    assert float(res["tone"].voicing.float().mean()) > 0.8


@pytest.mark.parametrize("method", ["yin", "hnr", "comb"])
def test_hnr_frame_methods_match_jax(method):
    x = np.stack([harmonic_tone(180.0, 0.5, SR), white_noise(0.5, SR, 0.3, seed=2)]).astype(np.float32)
    got = T.HarmonicRatioAnalyzer(SR, method, device=CPU).analyze_frames(frame_signal(_t(x), 2048, 1024))
    ref = J.HarmonicRatioAnalyzer(SR, method).analyze_frames(jframes(jnp.asarray(x), 2048, 1024))
    p, rp = got.f0.numpy(), np.asarray(ref.f0)
    if method == "yin":  # interpolated periods: within PITCH_RTOL, voicing by confidence
        errors, failures = parity.check_pitch(p, got.harmonic_ratio.numpy() * 0, rp, rp * 0)
        assert not failures, (failures, errors)
        agree = (p > 0) == (rp > 0)
    else:
        agree = p == rp
        assert agree.mean() >= 1.0 - parity.FFT_PITCH_MISS_SHARE
    _close(got.harmonic_ratio.numpy()[agree], np.asarray(ref.harmonic_ratio)[agree],
           *parity.EXTRACTOR_TOLERANCES["harmonic_ratio"])
    assert (got.voicing.numpy()[agree] == np.asarray(ref.voicing)[agree]).mean() > 0.95


def test_hnr_analyzer_rejects_an_unknown_method():
    with pytest.raises(ValueError, match="unknown HNR method"):
        T.HarmonicRatioAnalyzer(SR, "nope", device=CPU).analyze_frames(torch.zeros(2, 256))


def test_hnr_spectral_method():
    tone = harmonic_tone(220.0, 0.5, SR)
    mag = np.asarray(jstft(jnp.asarray(tone), 4096, 1024, sample_rate=SR).magnitude)
    hnr = T.HarmonicRatioAnalyzer(SR, "acf", device=CPU).analyze_spectrum(_t(mag), 4096)
    _close(hnr, J.HarmonicRatioAnalyzer(SR, "acf").analyze_spectrum(jnp.asarray(mag), 4096), *parity.MUSIC_DB_TOL)
    assert float(hnr.median()) > 10.0
    port_mag = tstft(tone, 4096, 1024, sample_rate=SR, device=CPU).magnitude
    assert float(T.HarmonicRatioAnalyzer(SR, device=CPU).analyze_spectrum(port_mag, 4096).median()) > 10.0


def test_hnr_spectrum_mask_matches_jax():
    rng = np.random.default_rng(172)
    mag = rng.uniform(0, 1, (3, 9, 513)).astype(np.float32)
    mag[..., 20::20] += 8.0  # harmonics of ~215 Hz at 22.05 kHz / 1024
    f0 = rng.uniform(0, 400, (3, 9)).astype(np.float32)
    f0[0, 0] = 0.0
    an, jan = T.HarmonicRatioAnalyzer(SR, device=CPU), J.HarmonicRatioAnalyzer(SR)
    _close(an.analyze_spectrum_mask(_t(mag), 1024, f0=_t(f0)),
           jan.analyze_spectrum_mask(jnp.asarray(mag), 1024, f0=jnp.asarray(f0)), *parity.MUSIC_DB_TOL)
    _close(an.analyze_spectrum_mask(_t(mag), 1024), jan.analyze_spectrum_mask(jnp.asarray(mag), 1024),
           *parity.MUSIC_DB_TOL)


# --------------------------- inharmonicity ------------------------------

def _inharmonicity_pair(x, f0):
    mag = np.asarray(jstft(jnp.asarray(x), 8192, 2048, sample_rate=SR).magnitude)
    f0s = np.full(mag.shape[0], f0, np.float32)
    got = T.analyze_inharmonicity(_t(mag), _t(f0s), SR, 8192)
    ref = J.analyze_inharmonicity(jnp.asarray(mag), jnp.asarray(f0s), SR, 8192)
    np.testing.assert_array_equal(got.num_partials.numpy(), np.asarray(ref.num_partials))
    assert got.num_partials.dtype == torch.int32
    _close(got.inharmonicity, ref.inharmonicity)
    _close(got.b_coefficient, ref.b_coefficient, parity.MUSIC_RTOL, 1e-7)
    return got


def test_inharmonicity_pure_harmonic():
    res = _inharmonicity_pair(harmonic_tone(220.0, 0.5, SR, num_harmonics=6), 220.0)
    assert float(res.inharmonicity.mean()) < 0.01
    assert int(res.num_partials.median()) >= 3


def test_inharmonicity_stretched_partials():
    B, f0 = 0.001, 220.0
    t = np.arange(int(0.5 * SR)) / SR
    x = np.zeros_like(t)
    for n in range(1, 7):
        x += (0.7 ** (n - 1)) * np.sin(2 * np.pi * n * f0 * np.sqrt(1 + B * n * n) * t)
    x = (0.5 * x / np.abs(x).max()).astype(np.float32)
    res = _inharmonicity_pair(x, f0)
    assert float(res.inharmonicity.mean()) > 0.002
    assert float(res.b_coefficient.median()) == pytest.approx(B, rel=0.5)


def test_inharmonicity_random_spectra_match_jax():
    rng = np.random.default_rng(173)
    mag = rng.uniform(0, 0.2, (4, 6, 1025)).astype(np.float32)
    for k in range(1, 9):
        mag[..., int(k * 20.3)] += 3.0 / k
    f0 = rng.uniform(150, 250, (4, 6)).astype(np.float32)
    got = T.analyze_inharmonicity(_t(mag), _t(f0), SR, 2048, max_partials=8)
    ref = J.analyze_inharmonicity(jnp.asarray(mag), jnp.asarray(f0), SR, 2048, max_partials=8)
    np.testing.assert_array_equal(got.num_partials.numpy(), np.asarray(ref.num_partials))
    _close(got.inharmonicity, ref.inharmonicity)
    _close(got.b_coefficient, ref.b_coefficient, parity.MUSIC_RTOL, 1e-7)


# --------------------------- pitch facade -------------------------------

def _detect_pair(method, x, w=2048, hop=1024):
    got = T.PitchDetector(SR, method, PitchParams(sample_rate=SR, window_size=w), device=CPU).detect(
        frame_signal(_t(x), w, hop))
    ref = J.PitchDetector(SR, method, JParams(sample_rate=SR, window_size=w)).detect(
        jframes(jnp.asarray(x), w, hop))
    p, c = got.pitch.numpy(), got.confidence.numpy()
    if method == "yin":
        errors, failures = parity.check_pitch(p, c, np.asarray(ref.pitch), np.asarray(ref.confidence))
    else:
        errors, failures = parity.check_pitch_decisions(p, c, np.asarray(ref.pitch), np.asarray(ref.confidence))
    assert not failures, (method, failures, errors)
    assert got.method == ref.method == method
    return p


@pytest.mark.parametrize("method", ["yin", "acf", "nsdf", "cepstrum", "hps"])
def test_pitch_methods_on_tone(method):
    p = _detect_pair(method, harmonic_tone(220.0, 0.3, SR))
    valid = p[p > 0]
    assert len(valid) > 0, method
    med = np.median(valid)
    assert min(abs(med - 220), abs(med - 440)) < 25, (method, med)


@pytest.mark.parametrize("method", ["yin", "acf", "nsdf", "cepstrum", "hps", "zcr", "peaks", "yin+nsdf+peaks"])
def test_pitch_methods_match_jax_on_mixed_frames(method):
    """Tones, a glide, noise and silence at 1024/256."""
    rng = np.random.default_rng(174)
    n = SR // 2
    t = np.arange(n) / SR
    rows = [harmonic_tone(f, 0.5, SR)[:n] for f in (98.0, 247.0, 415.0)]
    rows.append(0.5 * np.sin(2 * np.pi * np.cumsum(150 + 300 * t) / SR))
    rows.append(0.3 * rng.standard_normal(n))
    rows.append(np.zeros(n))
    _detect_pair(method, np.stack(rows).astype(np.float32), 1024, 256)


def test_hybrid_pitch():
    p = _detect_pair("yin+acf", harmonic_tone(150.0, 0.3, SR))
    assert np.median(p[p > 0]) == pytest.approx(150.0, rel=0.05)


def test_pitch_detector_rejects_an_unknown_method():
    with pytest.raises(ValueError, match="unknown pitch method"):
        T.PitchDetector(SR, "nope", device=CPU).detect(torch.zeros(2, 512))


@pytest.mark.parametrize("method", ["yin", "acf", "yin+acf"])
def test_detect_track_matches_jax(method):
    """Frames, octave correction and the median filter over PCM."""
    x = np.stack([harmonic_tone(f, 1.0, SR) for f in (130.0, 262.0)]).astype(np.float32)
    x[0, SR // 3: SR // 3 + 3000] = 0.0  # an unvoiced stretch
    params = dict(sample_rate=SR, window_size=1024)
    got = T.PitchDetector(SR, method, PitchParams(**params), device=CPU).detect_track(x)
    ref = J.PitchDetector(SR, method, JParams(**params)).detect_track(jnp.asarray(x))
    check = parity.check_pitch if method == "yin" else parity.check_pitch_decisions
    errors, failures = check(got.pitch.numpy(), got.confidence.numpy(), np.asarray(ref.pitch),
                             np.asarray(ref.confidence))
    assert not failures, (failures, errors)
    assert (got.pitch.numpy() == 0).any() and (got.pitch.numpy() > 0).mean() > 0.8


def test_octave_correction():
    pitch = np.array([220.0] * 10 + [440.0] + [220.0] * 10, np.float32)
    fixed = T.correct_octave_errors(_t(pitch)).numpy()
    np.testing.assert_array_equal(fixed, np.asarray(J.correct_octave_errors(jnp.asarray(pitch))))
    assert fixed[10] == pytest.approx(220.0, rel=0.01)


def test_octave_correction_unvoiced_windows_match_jax():
    """Any unvoiced frame in a window leaves its median NaN, then 0: the
    frames near gaps keep their pitch, in both packages."""
    rng = np.random.default_rng(175)
    pitch = np.where(rng.uniform(size=(3, 60)) < 0.15, 0.0,
                     rng.choice([110.0, 220.0, 440.0], size=(3, 60))).astype(np.float32)
    np.testing.assert_array_equal(T.correct_octave_errors(_t(pitch)).numpy(),
                                  np.asarray(J.correct_octave_errors(jnp.asarray(pitch))))


def test_vibrato_detection():
    hop, frame_rate = 256, SR / 256
    t = np.arange(400) / frame_rate
    pitch = (220.0 + 10.0 * np.sin(2 * np.pi * 5.0 * t)).astype(np.float32)
    out = T.analyze_vibrato(_t(pitch), hop, SR)
    ref = J.analyze_vibrato(jnp.asarray(pitch), hop, SR)
    for k in out:
        _close(out[k].numpy(), np.asarray(ref[k]), *parity.VIBRATO_TOL)
    assert bool(out["has_vibrato"])
    assert float(out["vibrato_rate_hz"]) == pytest.approx(5.0, abs=0.5)
    flat = T.analyze_vibrato(torch.full((400,), 220.0), hop, SR)
    assert not bool(flat["has_vibrato"])


def test_vibrato_batch_matches_jax():
    """Rows with vibrato at 4-8 Hz, gaps and an all-unvoiced row."""
    rng = np.random.default_rng(176)
    hop = 512
    t = np.arange(300) * hop / SR
    rows = [200.0 + 8.0 * np.sin(2 * np.pi * r * t) for r in (4.0, 6.0, 8.0)]
    pitch = np.stack(rows + [np.zeros(300)]).astype(np.float32)
    pitch[1, rng.uniform(size=300) < 0.1] = 0.0
    out = T.analyze_vibrato(_t(pitch), hop, SR)
    ref = J.analyze_vibrato(jnp.asarray(pitch), hop, SR)
    np.testing.assert_array_equal(out["has_vibrato"].numpy(), np.asarray(ref["has_vibrato"]))
    for k in ("vibrato_rate_hz", "vibrato_extent_hz"):
        _close(out[k].numpy(), np.asarray(ref[k]), *parity.VIBRATO_TOL)


@pytest.mark.parametrize("module", ["harmonic", "chroma", "pitch", "tonal", "tracking"])
def test_public_names_and_signatures_match_jax(module):
    """Every public function, class and method that the JAX module
    defines exists in the port's, its parameters JAX's in JAX's order
    with JAX's defaults (the port may add a trailing `device`), and the
    dataclasses' fields equal."""
    import dataclasses
    import importlib
    import inspect

    jm = importlib.import_module(f"sonido_sonar_tpu.ops.{module}")
    tm = importlib.import_module(f"sonido_sonar_tpu_torch.ops.{module}")

    def same_params(jf, tf, what):
        jp = list(inspect.signature(jf).parameters.values())
        tp = list(inspect.signature(tf).parameters.values())
        extra = [p.name for p in tp[len(jp):]]
        assert [(p.name, repr(p.default)) for p in tp[: len(jp)]] == [
            (p.name, repr(p.default)) for p in jp], what
        assert extra in ([], ["device"]), (what, extra)

    names = [n for n, v in vars(jm).items() if not n.startswith("_")
             and getattr(v, "__module__", None) == jm.__name__]
    assert names
    for name in names:
        jv, tv = getattr(jm, name), getattr(tm, name, None)
        assert tv is not None, f"{module}.{name} is not ported"
        if dataclasses.is_dataclass(jv):
            assert [f.name for f in dataclasses.fields(jv)] == [f.name for f in dataclasses.fields(tv)], name
        elif inspect.isclass(jv):
            same_params(jv.__init__, tv.__init__, name)
            for m, f in vars(jv).items():
                if callable(f) and not m.startswith("_"):
                    same_params(f, getattr(tv, m), f"{name}.{m}")
        elif callable(jv):
            same_params(getattr(jv, "__wrapped__", jv), tv, name)
