"""Synthetic signal generators for tests, the accuracy sweep and the
examples (counterpart of `sonido_sonar_tpu/io/synth.py`, bit for bit).

Tones (known pitch and chroma), chirps, noise, speech and music proxies,
known-lag shifted pairs for alignment, band limiting and time stretch.
Numpy in, numpy out: these build inputs on the host.
"""

from __future__ import annotations

import numpy as np


def sine(
    freq: float,
    duration: float,
    sample_rate: int = 44100,
    amplitude: float = 0.5,
    phase: float = 0.0,
) -> np.ndarray:
    t = np.arange(int(duration * sample_rate), dtype=np.float64) / sample_rate
    return (amplitude * np.sin(2 * np.pi * freq * t + phase)).astype(np.float32)


def harmonic_tone(
    f0: float,
    duration: float,
    sample_rate: int = 44100,
    num_harmonics: int = 5,
    decay: float = 0.7,
) -> np.ndarray:
    """Harmonic complex with geometrically decaying partials."""
    t = np.arange(int(duration * sample_rate), dtype=np.float64) / sample_rate
    x = np.zeros_like(t)
    for h in range(1, num_harmonics + 1):
        x += (decay ** (h - 1)) * np.sin(2 * np.pi * f0 * h * t)
    x /= np.max(np.abs(x)) + 1e-12
    return (0.5 * x).astype(np.float32)


def chirp(
    f_start: float,
    f_end: float,
    duration: float,
    sample_rate: int = 44100,
    amplitude: float = 0.5,
) -> np.ndarray:
    t = np.arange(int(duration * sample_rate), dtype=np.float64) / sample_rate
    k = (f_end - f_start) / duration
    phase = 2 * np.pi * (f_start * t + 0.5 * k * t * t)
    return (amplitude * np.sin(phase)).astype(np.float32)


def white_noise(
    duration: float, sample_rate: int = 44100, amplitude: float = 0.1, seed: int = 0
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(duration * sample_rate)
    return (amplitude * rng.standard_normal(n)).astype(np.float32)


def speech_like(
    duration: float, sample_rate: int = 44100, f0: float = 120.0, seed: int = 0,
    random_syllables: bool = False,
) -> np.ndarray:
    """Voiced-speech proxy: a glottal pulse train (slightly jittered)
    driven through two formant resonators (700 Hz, 1800 Hz) plus a touch
    of aspiration noise. Rich in harmonics around the formants, so it
    survives pre-emphasis and exercises pitch/formant/voice-quality
    paths realistically."""
    rng = np.random.default_rng(seed)
    n = int(duration * sample_rate)
    # jittered impulse train at f0
    src = np.zeros(n)
    pos = 0.0
    while pos < n:
        src[int(pos)] = 1.0
        period = sample_rate / (f0 * (1.0 + 0.005 * rng.standard_normal()))
        pos += period
    src += 0.01 * rng.standard_normal(n)  # aspiration noise

    def resonate(x, f, r=0.97):
        # the two-pole recurrence on Python floats: the same float64
        # operations in the same order as a loop over numpy scalars, ~10x
        # faster (30 s clips are built for every ingest run)
        w = 2 * np.pi * f / sample_rate
        a1, a2 = float(-2 * r * np.cos(w)), r * r
        y = [0.0] * len(x)
        y1 = y2 = 0.0
        for t, xt in enumerate(x.tolist()[2:], start=2):
            y1, y2 = xt - a1 * y1 - a2 * y2, y1
            y[t] = y1
        return np.asarray(y, dtype=np.float64)

    x = resonate(resonate(src, 700.0), 1800.0, r=0.95)
    # slow amplitude modulation (syllable-ish) with pauses
    t = np.arange(n, dtype=np.float64) / sample_rate
    if random_syllables:
        # aperiodic syllable rhythm: random-length voiced bursts and
        # pauses, smoothed — a strictly periodic envelope makes the
        # energy series self-similar at the syllable period, which real
        # speech is not (eval_accuracy relies on this realism)
        env = np.zeros(n)
        pos = 0
        while pos < n:
            burst = int(sample_rate * rng.uniform(0.12, 0.45))
            gap = int(sample_rate * rng.uniform(0.03, 0.25))
            env[pos: pos + burst] = rng.uniform(0.4, 1.0)
            pos += burst + gap
        kernel = np.hanning(max(int(0.03 * sample_rate), 3))
        env = np.convolve(env, kernel / kernel.sum(), mode="same") + 0.1
    else:
        env = 0.55 + 0.45 * np.sin(2 * np.pi * 2.5 * t)
    x = x * env
    x /= np.max(np.abs(x)) + 1e-12
    return (0.5 * x).astype(np.float32)


def shift_signal(
    x: np.ndarray, lag_samples: int, noise: float = 0.0, gain: float = 1.0, seed: int = 1
) -> np.ndarray:
    """Delay x by lag_samples (>0: y starts later), same length, optional
    noise + gain — the source/CDN pair generator for alignment tests."""
    y = np.zeros_like(x)
    if lag_samples >= 0:
        y[lag_samples:] = x[: len(x) - lag_samples]
    else:
        y[: len(x) + lag_samples] = x[-lag_samples:]
    y = gain * y
    if noise > 0:
        rng = np.random.default_rng(seed)
        y = y + noise * rng.standard_normal(len(x)).astype(np.float32)
    return y.astype(np.float32)


def music_like(
    duration: float, sample_rate: int = 44100, tempo_bpm: float = 110.0,
    seed: int = 0,
) -> np.ndarray:
    """Music proxy: an I-V-vi-IV chord progression (triads of harmonic
    tones with per-partial decay) over a percussive beat at `tempo_bpm`,
    plus light noise. Exercises chroma/key/onset/tempo paths and gives
    alignment a polyphonic, beat-structured source."""
    rng = np.random.default_rng(seed)
    n = int(duration * sample_rate)
    t = np.arange(n, dtype=np.float64) / sample_rate
    x = np.zeros(n)

    # chord roots (C major: C G Am F), midi -> Hz; every repetition gets
    # a random octave voicing + a melody note so cycles are not
    # sample-identical (real music is self-similar, not self-identical)
    progression = [[60, 64, 67], [55, 59, 62], [57, 60, 64], [53, 57, 60]]
    scale = [60, 62, 64, 65, 67, 69, 71, 72]
    chord_len = int(2.0 * sample_rate)
    for ci in range(0, n, chord_len):
        chord = list(progression[(ci // chord_len) % len(progression)])
        chord[rng.integers(0, len(chord))] += int(rng.choice([-12, 0, 12]))
        chord.append(int(rng.choice(scale)) + 12)  # melody note
        seg = slice(ci, min(ci + chord_len, n))
        ts = t[seg] - t[seg.start]
        for midi in chord:
            f = 440.0 * 2.0 ** ((midi - 69) / 12.0)
            for h in range(1, 5):
                if f * h < sample_rate / 2:
                    x[seg] += (
                        np.sin(2 * np.pi * f * h * ts + rng.uniform(0, 2 * np.pi))
                        * np.exp(-ts * (0.3 + 0.4 * h)) / (h * len(chord))
                    )

    # percussive beat: exponentially-decaying noise bursts on the grid
    period = int(sample_rate * 60.0 / tempo_bpm)
    burst = int(0.02 * sample_rate)
    for start in range(0, n - burst, period):
        x[start:start + burst] += (
            0.8 * np.exp(-np.arange(burst) / (burst / 5))
            * rng.standard_normal(burst)
        )

    x += 0.005 * rng.standard_normal(n)
    x /= np.max(np.abs(x)) + 1e-12
    return (0.6 * x).astype(np.float32)


def band_limit(
    x: np.ndarray, sample_rate: int, low_hz: float, high_hz: float
) -> np.ndarray:
    """FFT brickwall band-pass — a codec/CDN band-limiting proxy
    (e.g. 300-3400 Hz telephone band, or a 128 kbps-style low-pass)."""
    spec = np.fft.rfft(x.astype(np.float64))
    freqs = np.fft.rfftfreq(len(x), 1.0 / sample_rate)
    spec[(freqs < low_hz) | (freqs > high_hz)] = 0.0
    return np.fft.irfft(spec, n=len(x)).astype(np.float32)


def time_stretch(x: np.ndarray, factor: float) -> np.ndarray:
    """Resample-style time stretch (factor > 1 -> longer/slower): the
    clock-skew proxy for CDN streams. Linear interpolation."""
    n_out = int(round(len(x) * factor))
    src_pos = np.arange(n_out, dtype=np.float64) / factor
    i0 = np.clip(src_pos.astype(np.int64), 0, len(x) - 1)
    i1 = np.clip(i0 + 1, 0, len(x) - 1)
    frac = src_pos - i0
    return ((1.0 - frac) * x[i0] + frac * x[i1]).astype(np.float32)
