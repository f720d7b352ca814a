"""The names the port adds to modules it already had (`ops/filters`,
`temporal`, `spectral`, `speech`, `mel`, `mfcc`, `framing`, `windows`)
held to the JAX package on the CPU: twins, for these names, of
`tests/test_surface_extras.py`, `test_tempo.py`, `test_windows.py`,
`test_mfcc.py`, `test_spectral_features.py` and `test_temporal.py`. The
block-scan filters are held both to JAX's sequential `lax.scan` and to a
float64 recurrence, on a high-Q band and on a clip with silent stretches;
`smooth_envelope` at even and odd windows. Tolerances: utils/parity.py
(OPS_*, BLOCK_SCAN_*)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.io.synth import harmonic_tone, sine, speech_like, white_noise  # noqa: E402
from sonido_sonar_tpu.ops import filters as JF  # noqa: E402
from sonido_sonar_tpu.ops import framing as JFR  # noqa: E402
from sonido_sonar_tpu.ops import mel as JMEL  # noqa: E402
from sonido_sonar_tpu.ops import mfcc as JMFCC  # noqa: E402
from sonido_sonar_tpu.ops import spectral as JS  # noqa: E402
from sonido_sonar_tpu.ops import speech as JSP  # noqa: E402
from sonido_sonar_tpu.ops import temporal as JT  # noqa: E402
from sonido_sonar_tpu.ops import windows as JW  # noqa: E402
from sonido_sonar_tpu.ops.stft import stft as jstft  # noqa: E402
from sonido_sonar_tpu_torch.config.config import WindowType  # noqa: E402
from sonido_sonar_tpu_torch.ops import filters as F  # noqa: E402
from sonido_sonar_tpu_torch.ops import framing as FR  # noqa: E402
from sonido_sonar_tpu_torch.ops import mel as MEL  # noqa: E402
from sonido_sonar_tpu_torch.ops import mfcc as MFCC  # noqa: E402
from sonido_sonar_tpu_torch.ops import spectral as S  # noqa: E402
from sonido_sonar_tpu_torch.ops import speech as SP  # noqa: E402
from sonido_sonar_tpu_torch.ops import temporal as T  # noqa: E402
from sonido_sonar_tpu_torch.ops import windows as W  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)
SR = 8000


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, ref, rtol=parity.OPS_RTOL, atol=parity.OPS_ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _clip_with_silences(n=12000, seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack([0.3 * rng.standard_normal(n), harmonic_tone(300.0, n / SR, SR)[:n]]).astype(np.float32)
    x[1, 2000:5000] = 0.0                     # exact zeros: the energy's 1e-10 floor
    x[1, 7000:7003] = 0.0
    x[0, 9000:] = 0.0
    return x


# ------------------------------ filters ------------------------------

def _biquad64(x, b, a):
    out = np.zeros(x.shape)
    for r, row in enumerate(x.astype(np.float64)):
        z1 = z2 = 0.0
        for n, xn in enumerate(row):
            y = b[0] * xn + z1
            z1 = b[1] * xn - a[1] * y + z2
            z2 = b[2] * xn - a[2] * y
            out[r, n] = y
    return out


def _adaptive64(x, base, rate):
    out = np.zeros(x.shape)
    for r, row in enumerate(x.astype(np.float64)):
        alpha, prev, e = base, 0.0, 0.0
        for n, xn in enumerate(row):
            out[r, n] = xn - alpha * prev
            e = (1 - rate) * e + rate * ((xn - prev) ** 2 / max(xn * xn + 1e-10, 1e-10))
            t = min(max(base + 0.03 * (1 - min(max(e, 0.0), 1.0)), 0.9), 0.99)
            alpha, prev = alpha + rate * (t - alpha), xn
    return out


@pytest.mark.parametrize("center,q", [(1000.0, 0.7), (300.0, 5.0), (1000.0, 100.0)])
def test_biquad_block_scan_matches_lax_scan_and_float64(center, q):
    x = _clip_with_silences()
    b, a = F.bandpass_coefficients(center, q, SR)
    assert (b, a) == JF.bandpass_coefficients(center, q, SR)
    got = F.bandpass(_t(x), center, q, SR).numpy()
    ref = np.asarray(JF.bandpass(jnp.asarray(x), center, q, SR))
    exact = _biquad64(x, b, a)
    peak = np.abs(exact).max()
    assert np.abs(got - exact).max() <= parity.BLOCK_SCAN_F64_ATOL_SCALE * peak
    assert np.abs(got - ref).max() <= parity.BLOCK_SCAN_JAX_ATOL_SCALE * peak
    # shorter than a chunk, a [2, 3, N] input and one of exactly two chunks
    for shape in ((2, 100), (2, 3, 700), (1, 512)):
        y = np.resize(x, shape).astype(np.float32)
        _close(F.biquad(_t(y), b, a), JF.biquad(jnp.asarray(y), b, a), atol=1e-5)


@pytest.mark.parametrize("base,rate", [(0.95, 0.01), (0.97, 0.001), (0.9, 0.2)])
def test_adaptive_pre_emphasis_block_scan_matches_lax_scan_and_float64(base, rate):
    x = _clip_with_silences(seed=1)
    got = F.adaptive_pre_emphasis(_t(x), base, rate).numpy()
    ref = np.asarray(JF.adaptive_pre_emphasis(jnp.asarray(x), base, rate))
    exact = _adaptive64(x, base, rate)
    peak = np.abs(exact).max()
    assert np.abs(got - exact).max() <= parity.BLOCK_SCAN_F64_ATOL_SCALE * peak
    assert np.abs(got - ref).max() <= parity.BLOCK_SCAN_JAX_ATOL_SCALE * peak
    tone = _t(sine(440, 0.2, SR, 0.5))
    y = F.adaptive_pre_emphasis(tone)
    assert float(y[100:].abs().mean()) < float(tone[100:].abs().mean())


def test_filter_responses_and_pole_match_jax():
    freqs = np.linspace(0, SR / 2, 33).astype(np.float32)
    b, a = F.bandpass_coefficients(1000.0, 2.0, SR)
    resp = F.biquad_response(b, a, _t(freqs), SR)
    _close(resp, JF.biquad_response(b, a, jnp.asarray(freqs), SR), atol=1e-5)
    assert int(resp.argmax()) == int(np.argmin(np.abs(freqs - 1000.0)))
    _close(F.pre_emphasis_response(0.97, _t(freqs), SR), JF.pre_emphasis_response(0.97, jnp.asarray(freqs), SR))
    assert F.dc_pole_for_cutoff(20.0, SR) == JF.dc_pole_for_cutoff(20.0, SR)


# ------------------------------ temporal ------------------------------

@pytest.mark.parametrize("kernel", [1, 4, 5, 8])
def test_smooth_envelope_even_and_odd_windows_match_jax(kernel):
    env = np.abs(_clip_with_silences(300))
    _close(T.smooth_envelope(_t(env), kernel), JT.smooth_envelope(jnp.asarray(env), kernel))


def test_envelopes_match_jax():
    x = _clip_with_silences()
    for w, hop in ((512, 256), (500, 200), (256, 100)):
        np.testing.assert_array_equal(T.peak_envelope(_t(x), w, hop).numpy(),
                                      np.asarray(JT.peak_envelope(jnp.asarray(x), w, hop)))
    for n in (8000, 8001):
        _close(T.hilbert_envelope(_t(x[:, :n])), JT.hilbert_envelope(jnp.asarray(x[:, :n])), atol=2e-5)
    env = T.hilbert_envelope(_t(sine(100, 0.5, SR, 0.7)))
    assert float(env[200:-200].mean()) == pytest.approx(0.7, rel=0.02)


def test_peak_energy_crest_and_statistics_match_jax():
    x = _clip_with_silences()
    e = np.asarray(JT.short_time_energy(jnp.asarray(x), 512, 256))
    for thr in (0.0, 0.2):
        m, c = T.peak_energy(_t(e), thr)
        jm, jc = JT.peak_energy(jnp.asarray(e), thr)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    _close(T.crest_factor(_t(x)), JT.crest_factor(jnp.asarray(x)))
    got, ref = T.energy_statistics(_t(x), 1024, 256), JT.energy_statistics(jnp.asarray(x), 1024, 256)
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k], ref[k], atol=1e-5)
    assert float(got["std"][0]) == pytest.approx(float(torch.std(T.short_time_energy(_t(x[0]), 1024, 256), correction=0)))


def test_attack_decay_transient_match_jax():
    t = np.arange(SR) / SR
    env_sig = np.minimum(t / 0.01, 1.0) * np.exp(-np.maximum(t - 0.01, 0) / 0.3)
    x = np.stack([env_sig * sine(440, 1.0, SR, 1.0), _clip_with_silences(SR)[1]]).astype(np.float32)
    env = np.array(JT.rms_envelope(jnp.asarray(x), 256, 128))
    env[1, 5] = env[1].max()                   # an equal peak earlier: the first one counts
    fr = SR / 128
    for fn in ("attack_time", "decay_time"):
        _close(getattr(T, fn)(_t(env), fr), getattr(JT, fn)(jnp.asarray(env), fr))
    _close(T.transient_ratio(_t(env)), JT.transient_ratio(jnp.asarray(env)))
    assert float(T.attack_time(_t(env[0]), fr)) < float(T.decay_time(_t(env[0]), fr))


def _click_track(bpm, dur, sr, seed=0):
    n = int(dur * sr)
    x = np.zeros(n, dtype=np.float32)
    t = np.arange(200)
    for start in range(0, n - 200, int(sr * 60.0 / bpm)):
        x[start:start + 200] += (np.exp(-t / 40.0) * np.sin(2 * np.pi * 1000 * t / sr)).astype(np.float32)
    return x + 0.01 * np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_tempo_autocorrelation_category_and_range_match_jax():
    xs = np.stack([_click_track(80.0, 8.0, SR), _click_track(120.0, 8.0, SR)])
    env = np.asarray(JT.rms_envelope(jnp.asarray(xs), 800, 200))
    for lo, hi in ((60.0, 200.0), (60.0, 180.0), (300.0, 400.0)):
        _close(T.estimate_tempo_autocorrelation(_t(env), 200, SR, lo, hi),
               JT.estimate_tempo_autocorrelation(jnp.asarray(env), 200, SR, lo, hi))
    bpm = np.array([50.0, 89.9, 90.0, 139.9, 140.0, 200.0], np.float32)
    np.testing.assert_array_equal(T.tempo_category(_t(bpm)).numpy(), np.asarray(JT.tempo_category(jnp.asarray(bpm))))
    for g, r in zip(T.estimate_tempo_range(_t(xs), SR), JT.estimate_tempo_range(jnp.asarray(xs), SR)):
        _close(g, r, atol=parity.OPS_RTOL * 240.0)       # BPM differences: rtol of the tempo
    avg, conf, _ = T.estimate_tempo_range(_t(xs[1]), SR)
    assert float(avg) == pytest.approx(120.0, abs=15.0) and float(conf) > 0.5
    assert T.np_ceil_log2(1000) == JT.np_ceil_log2(1000) == 10


def test_prefix_sums_at_match_jax():
    v = np.random.default_rng(2).standard_normal((2, 1000)).astype(np.float32)
    pos = np.array([0, 1, 127, 128, 129, 500, 999, 1000])
    _close(T.prefix_sums_at(_t(v), pos), JT.prefix_sums_at(jnp.asarray(v), pos), atol=1e-5)
    _close(T.prefix_sums_at(_t(v), pos), np.concatenate([np.zeros((2, 1)), np.cumsum(v, -1)], -1)[:, pos], atol=1e-4)


@pytest.mark.parametrize("chunk_bytes", [None, 1])
def test_complex_onsets_match_jax(chunk_bytes, monkeypatch):
    burst = sine(880, 0.15, SR, 0.8)
    gap = np.zeros(int(0.3 * SR), np.float32)
    x = np.stack([np.concatenate([gap, burst, gap, burst, gap]), np.concatenate([burst, gap, gap, burst, gap])])
    res = jstft(jnp.asarray(x), 1024, 256, sample_rate=SR, return_phase=True)
    mag, ph = np.asarray(res.magnitude), np.asarray(res.phase)
    if chunk_bytes:
        monkeypatch.setattr(T, "COMPLEX_ONSET_CHUNK_BYTES", chunk_bytes)   # one row a chunk
    mask, count = T.detect_onsets_complex(_t(mag), _t(ph), 256, SR, threshold=0.3)
    jmask, jcount = JT.detect_onsets_complex(jnp.asarray(mag), jnp.asarray(ph), 256, SR, threshold=0.3)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    assert all(1 <= int(c) <= 6 for c in count)


# ------------------------------ spectral ------------------------------

def test_band_flatness_and_custom_contrast_match_jax():
    x = np.stack([sine(1000, 0.3, SR, 0.5), white_noise(0.3, SR, 0.3, seed=3)])
    mag = np.asarray(jstft(jnp.asarray(x), 2048, 512, sample_rate=SR).magnitude)
    _close(S.speech_band_flatness(_t(mag), SR), JS.speech_band_flatness(jnp.asarray(mag), SR))
    _close(S.band_limited_flatness(_t(mag), SR, 3990.0, 4000.0), JS.band_limited_flatness(jnp.asarray(mag), SR, 3990.0, 4000.0))
    for bands in ((200.0, 800.0, 1500.0, 4000.0), (0.0, 1.0, 2.0, 5000.0, 100.0)):
        _close(S.spectral_contrast_custom_bands(_t(mag), SR, bands),
               JS.spectral_contrast_custom_bands(jnp.asarray(mag), SR, bands), atol=1e-4)
    con = S.spectral_contrast_custom_bands(_t(mag[0]), SR, (200.0, 800.0, 1500.0, 4000.0))
    assert int(con.mean(dim=0).argmax()) == 1


def test_vad_zcr_and_segments_match_jax():
    speech = speech_like(1.0, SR)
    sig = np.concatenate([np.zeros(SR, np.float32), speech, np.zeros(SR, np.float32)])
    frames = np.asarray(JFR.frame_signal(jnp.asarray(sig), 1024, 512))
    for fn, args in (("detect_voice_activity", ()), ("classify_frame_type", ()), ("zcr_normalized", ())):
        np.testing.assert_array_equal(getattr(S, fn)(_t(frames), *args).numpy(),
                                      np.asarray(getattr(JS, fn)(jnp.asarray(frames), *args)))
    for thr in (0.0, 0.01):
        _close(S.zcr_with_threshold(_t(frames), SR, thr), JS.zcr_with_threshold(jnp.asarray(frames), SR, thr))
    for min_seg in (0, SR // 10, 10 * SR):
        got = S.detect_speech_segments(_t(sig), 1024, 512, min_segment_samples=min_seg)
        ref = JS.detect_speech_segments(jnp.asarray(sig), 1024, 512, min_segment_samples=min_seg)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    assert abs(int(S.detect_speech_segments(_t(sig), 1024, 512, min_segment_samples=SR // 10)[0][0]) - SR) < 3 * 512
    assert (S.VAD_ENERGY_THRESHOLD, S.VAD_ZCR_LOW, S.VAD_ZCR_HIGH) == (
        JS.VAD_ENERGY_THRESHOLD, JS.VAD_ZCR_LOW, JS.VAD_ZCR_HIGH)


# ------------------------------ speech ------------------------------

def test_lpc_stability_and_residual_match_jax():
    x = np.asarray(harmonic_tone(200.0, 0.3, SR))[:2048]
    res = SP.lpc_analyze(_t(x), SR, order=12)
    jres = JSP.lpc_analyze(jnp.asarray(x), SR, order=12)
    assert bool(SP.lpc_is_stable(res.reflection)) == bool(JSP.lpc_is_stable(jres.reflection)) is True
    k = np.array([[0.5, -0.99], [1.0, 0.2]], np.float32)
    np.testing.assert_array_equal(SP.lpc_is_stable(_t(k)).numpy(), np.asarray(JSP.lpc_is_stable(jnp.asarray(k))))
    coeffs = np.asarray(jres.coefficients)
    for sig in (x, np.stack([x, x[::-1]])):
        _close(SP.lpc_residual(_t(sig), _t(coeffs)), JSP.lpc_residual(jnp.asarray(sig), jnp.asarray(coeffs)), atol=1e-5)


def test_gender_and_age_rules_match_jax():
    for f1, f2, count in ((400.0, 2000.0, 3), (600.0, 2600.0, 2), (480.0, 2300.0, 4), (400.0, 2000.0, 1)):
        fr = SP.FormantResult(_t([f1, f2, 0, 0]), *([torch.zeros(4)] * 3), torch.tensor(count, dtype=torch.int32),
                              torch.tensor(0.0), torch.tensor(0.0))
        jfr = JSP.FormantResult(jnp.asarray([f1, f2, 0, 0]), *([jnp.zeros(4)] * 3), jnp.asarray(count),
                                jnp.asarray(0.0), jnp.asarray(0.0))
        assert SP.estimate_gender(fr) == JSP.estimate_gender(jfr)
    names = [f.name for f in __import__("dataclasses").fields(SP.VoiceQualityResult)]
    for jit, shim, f0, rng in ((4.0, 1.0, 100.0, 10.0), (1.0, 9.0, 100.0, 10.0), (1.0, 1.0, 250.0, 150.0), (1.0, 1.0, 150.0, 50.0)):
        vals = dict.fromkeys(names, 0.0) | {"jitter": jit, "shimmer": shim, "mean_f0": f0, "f0_range": rng}
        vq = SP.VoiceQualityResult(**{k: torch.tensor(v) for k, v in vals.items()})
        jvq = JSP.VoiceQualityResult(**{k: jnp.asarray(v) for k, v in vals.items()})
        assert SP.estimate_age(vq) == JSP.estimate_age(jvq)


# ------------------------------ mel, mfcc, framing, windows ------------------------------

def test_bark_helpers_and_tables_bit_equal():
    hz = np.linspace(0, 22050, 301)
    for fn in ("hz_to_bark_traunmueller", "hz_to_bark_zwicker"):
        np.testing.assert_array_equal(getattr(MEL, fn)(hz), getattr(JMEL, fn)(hz))
    bark = np.linspace(0, 25, 101)
    np.testing.assert_array_equal(MEL.bark_to_hz_traunmueller(bark), JMEL.bark_to_hz_traunmueller(bark))
    np.testing.assert_array_equal(MEL.critical_band_edges(), JMEL.critical_band_edges())
    for args in ((24, 1024, 44100), (16, 512, 16000)):
        got, ref = MEL.bark_filterbank(*args), JMEL.bark_filterbank(*args)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_apply_filterbank_mel_spectrum_and_c0_match_jax():
    mag = np.abs(np.random.default_rng(4).standard_normal((2, 7, 513))).astype(np.float32)
    mag[1, 3] = 0.0                                               # a silent frame: the log floor
    fb = MEL.bark_filterbank(24, 1024, 44100)
    _close(MEL.apply_filterbank(_t(mag ** 2), fb), JMEL.apply_filterbank(jnp.asarray(mag ** 2), fb), rtol=1e-5, atol=1e-5)
    p = MFCC.MFCCParams(num_mel_filters=20, low_freq=100.0, high_freq=8000.0, use_liftering=True)
    jp = JMFCC.MFCCParams(num_mel_filters=20, low_freq=100.0, high_freq=8000.0, use_liftering=True)
    _close(MFCC.mel_spectrum(_t(mag), 44100, 1024, p), JMFCC.mel_spectrum(jnp.asarray(mag), 44100, 1024, jp), atol=1e-5)
    _close(MFCC.log_energy_c0(_t(mag), 44100, 1024, p), JMFCC.log_energy_c0(jnp.asarray(mag), 44100, 1024, jp), atol=1e-4)
    assert p.use_liftering                                        # the caller's params stay as they were


def test_frame_times_and_window_helpers_match_jax():
    np.testing.assert_array_equal(FR.frame_times(17, 256, 1024, 44100), JFR.frame_times(17, 256, 1024, 44100))
    assert W.all_window_types() == {k: WindowType(v.value) for k, v in JW.all_window_types().items()}
    for use in ("general_analysis", "speech_analysis", "music_analysis", "transient_analysis",
                "high_resolution", "unknown"):
        np.testing.assert_array_equal(W.get_recommended_window(use, 513), JW.get_recommended_window(use, 513))
    for wt in WindowType:
        w = W.make_window(wt, 256, normalize=False)
        got, ref = W.window_properties(w), JW.window_properties(w)
        assert got.__dict__ == ref.__dict__
    props = W.window_properties(W.make_window(WindowType.HANN, 1024, normalize=False, symmetric=False))
    assert props.enbw == pytest.approx(1.5, rel=1e-3) and props.coherent is False
