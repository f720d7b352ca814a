"""The port's signal generators (`sonido_sonar_tpu_torch/io/synth.py`) held
to the JAX package's `io/synth.py` bit for bit: every function, over
seeds, rates and arguments. The port's speech resonator runs on Python
floats instead of numpy scalars; the float64 operations and their order
are the same, so the bits are too."""

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from sonido_sonar_tpu.io import synth as J  # noqa: E402
from sonido_sonar_tpu_torch.io import synth as T  # noqa: E402


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("sr", [8000, 22050, 44100])
def test_tones_and_noise(sr):
    for fn, args, kw in (
        ("sine", (440.0, 0.37, sr), {"amplitude": 0.3, "phase": 0.5}),
        ("harmonic_tone", (220.0, 0.41, sr), {"num_harmonics": 12, "decay": 0.95}),
        ("harmonic_tone", (97.0, 0.2, sr), {}),
        ("chirp", (100.0, 3000.0, 0.33, sr), {"amplitude": 0.7}),
        ("white_noise", (0.29, sr, 0.05), {"seed": 11}),
    ):
        _same(getattr(T, fn)(*args, **kw), getattr(J, fn)(*args, **kw))


@pytest.mark.parametrize("seed", [0, 12, 31])
@pytest.mark.parametrize("random_syllables", [False, True])
def test_speech_like(seed, random_syllables):
    for sr, f0 in ((22050, 120.0), (16000, 210.0)):
        _same(T.speech_like(1.3, sr, f0=f0, seed=seed, random_syllables=random_syllables),
              J.speech_like(1.3, sr, f0=f0, seed=seed, random_syllables=random_syllables))


@pytest.mark.parametrize("seed", [0, 13, 40])
def test_music_like(seed):
    for sr, tempo in ((22050, 110.0), (44100, 137.0)):
        _same(T.music_like(2.5, sr, tempo_bpm=tempo, seed=seed),
              J.music_like(2.5, sr, tempo_bpm=tempo, seed=seed))


@pytest.mark.parametrize("lag", [0, 1234, -777, 5000])
@pytest.mark.parametrize("noise,gain,seed", [(0.0, 1.0, 1), (0.05, 0.9, 3)])
def test_shift_signal(lag, noise, gain, seed):
    x = J.harmonic_tone(180.0, 0.5, 22050) + J.white_noise(0.5, 22050, 0.02, seed=4)
    _same(T.shift_signal(x, lag, noise=noise, gain=gain, seed=seed),
          J.shift_signal(x, lag, noise=noise, gain=gain, seed=seed))


@pytest.mark.parametrize("band", [(300.0, 3400.0), (50.0, 8000.0)])
def test_band_limit(band):
    x = J.music_like(1.0, 22050, seed=5)
    _same(T.band_limit(x, 22050, *band), J.band_limit(x, 22050, *band))


@pytest.mark.parametrize("factor", [0.98, 0.99, 1.005, 1.02])
def test_time_stretch(factor):
    x = J.speech_like(0.8, 16000, seed=6)
    _same(T.time_stretch(x, factor), J.time_stretch(x, factor))


def test_every_jax_generator_is_ported():
    names = {n for n in vars(J) if callable(getattr(J, n)) and not n.startswith("_")
             and getattr(getattr(J, n), "__module__", "") == J.__name__}
    assert names and all(callable(getattr(T, n, None)) for n in names), names
