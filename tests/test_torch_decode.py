"""The port's ingest (`sonido_sonar_tpu_torch/io/decode.py`, `io/native/`)
held to the JAX package's `io/decode.py` and `io/native/`.

- Twins of `tests/test_native_io.py` and `tests/test_resample.py` on the
  port, at their tolerances.
- `decode_bytes` / `decode_file` against JAX's on the same WAV bytes
  (8/16/24/32-bit, stereo, 48 -> 44.1 kHz): the same PCM bits and
  metadata, on the native path and on the stdlib path. The native parser
  and the stdlib path give the same bits for one and two channels (the
  same int-to-float conversions, and (a + b) * 0.5 == (a + b) / 2), so
  the port's native path is held to JAX's stdlib path, which does not
  depend on JAX's own native build.
- The ffmpeg arguments and normalization filters, the content-optimized configs
  and the ffprobe parser equal JAX's.
- The native build: four processes loading a fresh build at once all
  succeed, and one library is left.
- The decode path's handlers: the native parser's rejection falls back to
  the stdlib path with a warning, any other native fault propagates, and
  `decode_files_parallel` keeps order with None for a file it cannot read.
"""

import dataclasses
import os
import shutil
import struct
import subprocess
import sys
import time
from math import gcd
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from sonido_sonar_tpu.io import decode as JD  # noqa: E402
from sonido_sonar_tpu.io import native as JN  # noqa: E402
from sonido_sonar_tpu_torch.io import decode as TD  # noqa: E402
from sonido_sonar_tpu_torch.io import native  # noqa: E402
from sonido_sonar_tpu_torch.io.decode import (  # noqa: E402
    Decoder,
    _resample_linear,
    _resample_polyphase,
    decode_files_parallel,
    design_resample_filter,
    write_wav,
)
from sonido_sonar_tpu_torch.io.synth import sine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SR = 22050


@pytest.fixture
def wavio():
    """The port's native loader; on a host without g++ the stdlib path is
    the only one and these cases do not apply."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native WAV loader cannot be built")
    assert native.available()
    return native


def _wav(samples: bytes, sr: int, channels: int, bits: int, fmt: int = 1) -> bytes:
    """A RIFF/WAVE file around `samples` (fmt 1: PCM; 0xFFFE: extensible,
    PCM subformat)."""
    block = channels * bits // 8
    if fmt == 0xFFFE:
        guid = struct.pack("<IHH", 1, 0x0000, 0x0010) + bytes.fromhex("800000aa00389b71")
        fmt_body = struct.pack("<HHIIHHHHI", fmt, channels, sr, sr * block, block, bits,
                               22, bits, 0) + guid
    else:
        fmt_body = struct.pack("<HHIIHH", fmt, channels, sr, sr * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
    body += b"data" + struct.pack("<I", len(samples)) + samples
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _pcm_bytes(x: np.ndarray, bits: int) -> bytes:
    """Float PCM in [-1, 1) as little-endian integer samples."""
    if bits == 8:
        return (np.clip(x * 128 + 128, 0, 255)).astype(np.uint8).tobytes()
    if bits == 16:
        return (x * 32767).astype("<i2").tobytes()
    if bits == 24:
        v = (x * 8388607).astype(np.int32)
        b = v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        return b.tobytes()
    return (x * 2147483647.0).astype("<i4").tobytes()


# -- twins of tests/test_native_io.py ---------------------------------------

def test_roundtrip_16bit(wavio):
    x = sine(440, 0.5, SR, 0.5)
    y, rate, ch = wavio.decode_wav_bytes(wavio.encode_wav16(x, SR))
    assert rate == SR and ch == 1
    assert len(y) == len(x)
    np.testing.assert_allclose(y, x, atol=2.0 / 32768)  # 2 LSB quantization


def test_matches_python_wav_path(wavio, tmp_path):
    import io as _io
    import wave

    x = sine(220, 0.3, SR, 0.4)
    p = str(tmp_path / "t.wav")
    write_wav(p, x, SR)
    data = Path(p).read_bytes()
    y_native, _, _ = wavio.decode_wav_bytes(data)
    with wave.open(_io.BytesIO(data), "rb") as w:
        frames = w.readframes(w.getnframes())
    y_py = np.frombuffer(frames, dtype="<i2").astype(np.float32) / 32768.0
    np.testing.assert_allclose(y_native, y_py, atol=1e-6)


def test_bytes_to_f32(wavio):
    x = np.random.default_rng(0).standard_normal(100).astype(np.float32)
    np.testing.assert_array_equal(wavio.bytes_to_f32(x.tobytes(), "f32le"), x)
    out64 = wavio.bytes_to_f32(x.astype(np.float64).tobytes(), "f64le")
    np.testing.assert_allclose(out64, x, atol=1e-6)
    s16 = (x * 0.4 * 32767).astype("<i2")
    out16 = wavio.bytes_to_f32(s16.tobytes(), "s16le")
    np.testing.assert_allclose(out16, s16.astype(np.float32) / 32768.0, atol=1e-6)


def test_native_resample(wavio):
    x = sine(100, 1.0, 8000, 0.5)
    y = wavio.resample_linear(x, 8000, 16000)
    assert len(y) == pytest.approx(16000, abs=2)
    expected = 0.5 * np.sin(2 * np.pi * 100 * np.arange(len(y)) / 16000)
    assert np.abs(y[100:-100] - expected[100:-100]).max() < 0.01


def test_decoder_uses_native(wavio, tmp_path, monkeypatch):
    x = sine(440, 0.5, SR, 0.5)
    p = str(tmp_path / "clip.wav")
    write_wav(p, x, SR)
    calls = []
    decode = wavio.decode_wav_bytes
    monkeypatch.setattr(wavio, "decode_wav_bytes", lambda d: calls.append(1) or decode(d))
    audio = Decoder().decode_file(p)
    assert calls and audio.sample_rate == 44100  # resampled to the default target
    assert abs(audio.duration - 0.5) < 0.01


def test_stereo_mixdown(wavio):
    sr, n = 8000, 800
    tone = (0.5 * np.sin(2 * np.pi * 440 * np.arange(n) / sr) * 32767).astype("<i2")
    interleaved = np.zeros(n * 2, "<i2")
    interleaved[0::2] = tone
    y, rate, ch = wavio.decode_wav_bytes(_wav(interleaved.tobytes(), sr, 2, 16))
    assert ch == 2 and rate == sr
    np.testing.assert_allclose(y, tone.astype(np.float32) / 32768.0 / 2.0, atol=1e-5)


def test_wavio_source_is_jax_s_code():
    """The port's wavio.cpp is JAX's below its header comment."""
    def code(p):
        text = Path(p).read_text()
        return text[text.index("#include"):]

    assert code(native.SOURCE) == code(Path(JN.__file__).with_name("wavio.cpp"))


# -- twins of tests/test_resample.py ----------------------------------------

def _brute_force(x, sr_in, sr_out):
    """Direct float64 evaluation: y[n] = sum_j x[j] h[nM + D - jL]."""
    g = gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    h = design_resample_filter(L, M)
    N = len(h)
    D = (N - 1) // 2
    x = np.asarray(x, dtype=np.float64)
    n_out = int(round(len(x) * sr_out / sr_in))
    y = np.zeros(n_out)
    j = np.arange(len(x))
    for n in range(n_out):
        k = n * M + D - j * L
        sel = (k >= 0) & (k < N)
        y[n] = np.dot(x[sel], h[k[sel]])
    return y


@pytest.mark.parametrize("sr_in,sr_out", [(48000, 44100), (22050, 44100),
                                          (8000, 44100), (44100, 16000)])
def test_polyphase_matches_brute_force(sr_in, sr_out):
    x = np.random.default_rng(5).standard_normal(2000)
    got = _resample_polyphase(x, sr_in, sr_out)
    want = _brute_force(x, sr_in, sr_out)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want.astype(np.float32), atol=2e-6)
    # and JAX's resampler, bit for bit
    assert got.tobytes() == JD._resample_polyphase(x, sr_in, sr_out).tobytes()


def test_matches_scipy_resample_poly():
    """scipy's polyphase engine driven with the same filter agrees."""
    scipy_signal = pytest.importorskip("scipy.signal")
    x = np.random.default_rng(6).standard_normal(5000)
    sr_in, sr_out = 48000, 44100
    g = gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    h = design_resample_filter(L, M)
    np.testing.assert_array_equal(h, JD.design_resample_filter(L, M))
    want = scipy_signal.upfirdn(h, x, up=L, down=M)
    got = _resample_polyphase(x, sr_in, sr_out)
    off = ((len(h) - 1) // 2) // L
    best = None
    for o in range(max(0, off - 2), off + 3):
        n = min(len(got) - 200, len(want) - o - 200)
        if n <= 0:
            continue
        err = np.max(np.abs(got[100:100 + n] - want[o + 100:o + 100 + n]))
        best = err if best is None else min(best, err)
    assert best is not None and best < 1e-5


def test_alias_rejection_tone():
    """A 23 kHz tone at 48k is annihilated, not folded to 21.1 kHz; the
    linear resampler fails this by ~55 dB."""
    sr_in, sr_out = 48000, 44100
    x = np.sin(2 * np.pi * 23000.0 * np.arange(sr_in) / sr_in)
    core = _resample_polyphase(x, sr_in, sr_out).astype(np.float64)[2000:-2000]
    assert 20 * np.log10(np.sqrt(np.mean(core ** 2)) / np.sqrt(0.5)) < -60.0
    lin = _resample_linear(x, sr_in, sr_out).astype(np.float64)[2000:-2000]
    assert 20 * np.log10(np.sqrt(np.mean(lin ** 2)) / np.sqrt(0.5)) > -30.0


def test_alias_rejection_sweep():
    sr_in, sr_out, dur = 48000, 44100, 2.0
    t = np.arange(int(sr_in * dur)) / sr_in
    f0, f1 = 22200.0, 23800.0
    x = np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * dur)))
    y = _resample_polyphase(x, sr_in, sr_out).astype(np.float64)[4000:-4000]
    assert 20 * np.log10(np.sqrt(np.mean(y ** 2)) / np.sqrt(0.5)) < -60.0


@pytest.mark.parametrize("freq", [440.0, 4000.0, 10000.0, 15000.0])
def test_passband_flatness(freq):
    sr_in, sr_out = 48000, 44100
    x = np.sin(2 * np.pi * freq * np.arange(2 * sr_in) / sr_in)
    y = _resample_polyphase(x, sr_in, sr_out).astype(np.float64)[4000:-4000]
    assert abs(20 * np.log10(np.sqrt(np.mean(y ** 2)) / np.sqrt(0.5))) < 0.1
    zc = np.sum(np.abs(np.diff(np.signbit(y)))) / 2
    assert abs(zc / (len(y) / sr_out) - freq) / freq < 0.01


def test_dc_and_identity():
    x = np.full(4000, 0.7071)
    y = _resample_polyphase(x, 48000, 44100).astype(np.float64)
    assert np.max(np.abs(y[1000:-1000] - 0.7071)) < 1e-4
    np.testing.assert_allclose(_resample_polyphase(x, 44100, 44100), x.astype(np.float32))
    assert _resample_polyphase(np.zeros(0), 48000, 44100).shape == (0,)


def test_decoder_wav_path_uses_polyphase(tmp_path):
    sr_in = 48000
    x = 0.5 * np.sin(2 * np.pi * 23000.0 * np.arange(sr_in) / sr_in)
    p = str(tmp_path / "hi.wav")
    write_wav(p, x, sr_in)
    audio = Decoder().decode_file(p)
    assert audio.sample_rate == 44100
    core = np.asarray(audio.pcm, dtype=np.float64)[2000:-2000]
    rej_db = 20 * np.log10(max(np.sqrt(np.mean(core ** 2)), 1e-12) / (0.5 * np.sqrt(0.5)))
    assert rej_db < -60.0


# -- decode against JAX --------------------------------------------------------

_FORMATS = [(8, 1, 22050), (16, 1, 22050), (24, 1, 16000), (32, 1, 22050),
            (16, 2, 22050), (24, 2, 8000), (16, 1, 48000), (16, 2, 48000)]


def _same_audio(got, want):
    assert got.pcm.dtype == want.pcm.dtype == np.float32
    assert got.pcm.tobytes() == want.pcm.tobytes()
    assert (got.sample_rate, got.channels) == (want.sample_rate, want.channels)
    assert dataclasses.asdict(got.metadata) == dataclasses.asdict(want.metadata)


@pytest.mark.parametrize("bits,channels,sr", _FORMATS)
def test_decode_bytes_matches_jax(bits, channels, sr, monkeypatch, wavio):
    x = np.random.default_rng(bits + channels).uniform(-0.9, 0.9, 3000 * channels)
    data = _wav(_pcm_bytes(x, bits), sr, channels, bits)
    monkeypatch.setattr(JN, "available", lambda: False)  # JAX's stdlib path
    want = JD.Decoder().decode_bytes(data)
    _same_audio(Decoder().decode_bytes(data), want)      # the port's native path
    monkeypatch.setattr(native, "available", lambda: False)
    _same_audio(Decoder().decode_bytes(data), want)      # the port's stdlib path
    assert want.sample_rate == 44100 and want.metadata.channels == channels


@pytest.mark.parametrize("max_duration", [0.0, 0.05])
def test_decode_file_matches_jax(tmp_path, max_duration, monkeypatch):
    x = sine(330, 0.2, 48000, 0.6)
    p = str(tmp_path / "clip.wav")
    write_wav(p, x, 48000)
    assert Path(p).read_bytes() == _wav_from_jax(tmp_path, x, 48000)
    monkeypatch.setattr(JN, "available", lambda: False)
    cfg = dict(max_duration=max_duration, target_sample_rate=44100)
    got = Decoder(TD.DecoderConfig(**cfg)).decode_file(p)
    want = JD.Decoder(JD.DecoderConfig(**cfg)).decode_file(p)
    _same_audio(got, want)
    assert dataclasses.asdict(Decoder().probe_file(p)) == dataclasses.asdict(
        JD.Decoder().probe_file(p))


def _wav_from_jax(tmp_path, x, sr) -> bytes:
    p = tmp_path / "jax.wav"
    JD.write_wav(str(p), x, sr)
    return p.read_bytes()


def test_decoder_arguments_match_jax():
    variants = [{}, {"max_duration": 12.5}, {"enable_normalization": False},
                {"resample_quality": "high"}, {"resample_quality": "fast"},
                {"resample_quality": ""}, {"normalization_method": ""},
                {"target_channels": 2, "output_format": "s16le"}]
    configs = [(TD.DecoderConfig(**v), JD.DecoderConfig(**v)) for v in variants]
    for ct in ("music", "speech", "news", "talk", "sports", "unknown"):
        configs.append((TD.content_optimized_decoder_config(ct),
                        JD.content_optimized_decoder_config(ct)))
    assert dataclasses.asdict(TD.default_decoder_config()) == dataclasses.asdict(
        JD.default_decoder_config())
    for tc, jc in configs:
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        td, jd = TD.Decoder(tc), JD.Decoder(jc)
        assert td.build_normalization_filter() == jd.build_normalization_filter()
        for resample in (True, False):
            assert td.build_ffmpeg_args(resample) == jd.build_ffmpeg_args(resample)
    for bad in ({"target_sample_rate": 0}, {"target_channels": 0},
                {"normalization_method": "rms"}):
        with pytest.raises(ValueError):
            TD.Decoder(TD.DecoderConfig(**bad)).validate_config()
        with pytest.raises(ValueError):
            JD.Decoder(JD.DecoderConfig(**bad)).validate_config()


def test_parse_ffprobe_matches_jax():
    probes = [
        {"format": {"format_name": "mp3", "duration": "183.27", "bit_rate": "128000",
                    "tags": {"GENRE": "Jazz", "Title": "Take Five", "icy-name": "KJAZ"}},
         "streams": [{"codec_type": "video", "codec_name": "mjpeg"},
                     {"codec_type": "audio", "codec_name": "mp3", "sample_rate": "44100",
                      "channels": 2}]},
        {"format": {"format_name": "hls", "duration": "", "tags": {"station": "News 24"}},
         "streams": [{"codec_type": "audio", "codec_name": "aac", "sample_rate": "48000"}]},
        {},
    ]
    for probe in probes:
        assert dataclasses.asdict(TD.Decoder._parse_ffprobe(probe, "u")) == dataclasses.asdict(
            JD.Decoder._parse_ffprobe(probe, "u"))


# -- the native build and the decode path's handlers --------------------------

_LOADER = """
import sys, time
from pathlib import Path
from sonido_sonar_tpu_torch.io import native
native.BUILD_DIR = Path(sys.argv[1])
time.sleep(max(0.0, float(sys.argv[2]) - time.time()))
print(native.available(), native.library_path().name)
"""


def test_concurrent_first_loads_all_succeed(tmp_path):
    """Four processes load a fresh native build at the same moment: each
    loads the library, and one library, no temporary file, is left."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native WAV loader cannot be built")
    start = time.time() + 6.0  # after every process has imported the package
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", _LOADER, str(tmp_path), str(start)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [o[1][-2000:] for o in outs]
    lines = {o[0].strip() for o in outs}
    assert len(lines) == 1 and lines.pop().startswith("True libwavio_"), outs
    assert sorted(p.name for p in tmp_path.iterdir() if p.suffix != ".lock") == [
        native.library_path().name]


class _Recorder:
    def __init__(self):
        self.warnings, self.errors = [], []

    def with_component(self, *args):
        return self

    def warn(self, msg, **fields):
        self.warnings.append((msg, fields))

    def error(self, msg, **fields):
        self.errors.append((msg, fields))

    def debug(self, msg, **fields):
        pass


def test_failed_build_is_logged_with_the_compiler_output(tmp_path, monkeypatch):
    """A source g++ rejects: no library, no temporary file left, and the
    error logged with g++'s stderr (the JAX loader swallows it)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native WAV loader cannot be built")
    broken = tmp_path / "wavio.cpp"
    broken.write_text('extern "C" int wavio_decode( { return 0; }\n')
    rec = _Recorder()
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "get_global_logger", lambda: rec)
    assert not native._build_library(native.library_path())
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["libwavio.lock"]
    assert len(rec.errors) == 1 and "error" in rec.errors[0][1]["stderr"]


def test_native_rejection_takes_the_stdlib_path(wavio):
    """An extensible-format header, which the native parser rejects
    (its ValueError), decodes through the stdlib path with a warning."""
    x = np.random.default_rng(9).uniform(-0.9, 0.9, 2000)
    samples = _pcm_bytes(x, 16)
    with pytest.raises(ValueError):
        wavio.decode_wav_bytes(_wav(samples, SR, 1, 16, fmt=0xFFFE))
    dec = Decoder()
    dec._log = _Recorder()
    got = dec.decode_bytes(_wav(samples, SR, 1, 16, fmt=0xFFFE))
    want = Decoder().decode_bytes(_wav(samples, SR, 1, 16))
    assert got.pcm.tobytes() == want.pcm.tobytes()
    assert len(dec._log.warnings) == 1 and "rejected" in dec._log.warnings[0][0]


def test_other_native_faults_propagate(wavio, monkeypatch):
    def fault(data):
        raise RuntimeError("native fault")

    monkeypatch.setattr(wavio, "decode_wav_bytes", fault)
    with pytest.raises(RuntimeError, match="native fault"):
        Decoder().decode_bytes(_wav(_pcm_bytes(np.zeros(100), 16), SR, 1, 16))


def test_decode_files_parallel_keeps_order(tmp_path):
    paths = []
    for i, f in enumerate((220.0, None, 330.0, 440.0, "missing")):
        p = tmp_path / f"clip{i}.wav"
        if isinstance(f, float):
            write_wav(str(p), sine(f, 0.1 + 0.05 * i, SR), SR)
        elif f is None:
            p.write_bytes(b"RIFF\x00\x00\x00\x00not a wave file at all")
        paths.append(str(p))
    got = decode_files_parallel(paths, max_workers=3)
    assert [a is None for a in got] == [False, True, False, False, True]
    for i in (0, 2, 3):
        assert got[i].metadata.url == paths[i]
        assert got[i].pcm.tobytes() == Decoder().decode_file(paths[i]).pcm.tobytes()
