"""Audio decoding: ffprobe-probe + ffmpeg-decode with a WAV path
(counterpart of `sonido_sonar_tpu/io/decode.py`).

Reference parity: transcode/decoder.go — DecodeFile (:146), DecodeBytes
(:176), DecodeURL (:262-434), ProbeURL (:437), buildFFmpegArgs (:707-753),
buildNormalizationFilter (:757-779: loudnorm I/TP/LRA, dynaudnorm
p=0.95:m=10:s=12, compand), ContentOptimizedDecoderConfig (:88-115:
music -16 LUFS loudnorm, speech -20 dynaudnorm, sports -18 compand),
bytesToFloat64 (:850-870 — here a vectorized numpy frombuffer).

The output is host float32 PCM in the port's `io/audio.AudioData`; the
entry points put it on their `device`. ffmpeg stays an optional
subprocess. Without it, WAV files decode through the native loader
(`io/native`) or, where that is unavailable or rejects the bytes, the
stdlib `wave` module; other formats raise. A native decoder fault other
than its rejection (`ValueError`) propagates.
"""

from __future__ import annotations

import io as _io
import json
import shutil
import subprocess
import wave
from dataclasses import dataclass, replace
from functools import lru_cache
from math import gcd
from typing import Optional, Sequence

import numpy as np

from sonido_sonar_tpu_torch.io import native
from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata
from sonido_sonar_tpu_torch.logging import get_global_logger


@dataclass(frozen=True)
class DecoderConfig:
    """transcode/decoder.go:38-64 defaults at :67-83."""

    target_sample_rate: int = 44100
    target_channels: int = 1
    output_format: str = "f32le"
    max_duration: float = 0.0  # seconds; 0 = no limit
    resample_quality: str = "medium"  # fast|medium|high -> soxr precision
    ffmpeg_path: str = "ffmpeg"
    ffprobe_path: str = "ffprobe"
    timeout: float = 30.0
    enable_normalization: bool = True
    normalization_method: str = "loudnorm"  # loudnorm|dynaudnorm|compand
    target_lufs: float = -23.0
    target_peak: float = -2.0
    loudness_range: float = 7.0


def default_decoder_config() -> DecoderConfig:
    return DecoderConfig()


def content_optimized_decoder_config(content_type: str) -> DecoderConfig:
    """decoder.go:88-115."""
    cfg = default_decoder_config()
    if content_type == "music":
        return replace(
            cfg,
            normalization_method="loudnorm",
            target_lufs=-16.0,
            target_peak=-1.0,
            loudness_range=8.0,
        )
    if content_type in ("speech", "news", "talk"):
        return replace(
            cfg,
            normalization_method="dynaudnorm",
            target_lufs=-20.0,
            target_peak=-3.0,
            loudness_range=5.0,
        )
    if content_type == "sports":
        return replace(
            cfg,
            normalization_method="compand",
            target_lufs=-18.0,
            target_peak=-2.0,
            loudness_range=10.0,
        )
    return cfg


_SOXR_PRECISION = {"fast": 16, "medium": 20, "high": 28}


class Decoder:
    """FFmpeg-backed decoder with pure-Python WAV fallback."""

    def __init__(self, config: Optional[DecoderConfig] = None):
        self.config = config or default_decoder_config()
        self._log = get_global_logger().with_component("transcode", "Decoder")

    # -- capability ------------------------------------------------------
    def ffmpeg_available(self) -> bool:
        return shutil.which(self.config.ffmpeg_path) is not None

    def validate_config(self) -> None:
        """decoder.go:873-909."""
        c = self.config
        if c.target_sample_rate <= 0:
            raise ValueError(f"invalid sample rate {c.target_sample_rate}")
        if c.target_channels <= 0:
            raise ValueError(f"invalid channels {c.target_channels}")
        if c.normalization_method not in ("loudnorm", "dynaudnorm", "compand", ""):
            raise ValueError(f"unknown normalization {c.normalization_method}")

    # -- ffmpeg command construction (decoder.go:707-779) -----------------
    def build_normalization_filter(self) -> str:
        c = self.config
        if c.normalization_method == "loudnorm":
            return f"loudnorm=I={c.target_lufs:.1f}:TP={c.target_peak:.1f}:LRA={c.loudness_range:.1f}"
        if c.normalization_method == "dynaudnorm":
            return "dynaudnorm=p=0.95:m=10:s=12"
        if c.normalization_method == "compand":
            tp = abs(c.target_peak)
            return f"compand=0.1,0.3:-90/-90,-{tp:.1f}/-{tp:.1f},0/0:6:0:-90:0.1"
        return ""

    def build_ffmpeg_args(self, needs_resample: bool = True) -> list:
        c = self.config
        args = [
            "-f", c.output_format,
            "-ac", str(c.target_channels),
            "-ar", str(c.target_sample_rate),
        ]
        filters = []
        if c.resample_quality and needs_resample:
            prec = _SOXR_PRECISION.get(c.resample_quality)
            if prec:
                filters.append(f"aresample=resampler=soxr:precision={prec}")
        if c.max_duration > 0:
            args += ["-t", f"{c.max_duration:.2f}"]
        if c.enable_normalization:
            nf = self.build_normalization_filter()
            if nf:
                filters.append(nf)
        if filters:
            args += ["-af", ",".join(filters)]
        args += ["-v", "error"]
        return args

    # -- probe (decoder.go:437-530) ---------------------------------------
    def probe_file(self, path: str) -> AudioMetadata:
        if shutil.which(self.config.ffprobe_path) is None:
            return self._probe_wav(path)
        cmd = [
            self.config.ffprobe_path,
            "-v", "error",
            "-show_format", "-show_streams",
            "-of", "json",
            path,
        ]
        out = subprocess.run(
            cmd, capture_output=True, timeout=self.config.timeout, check=True
        ).stdout
        return self._parse_ffprobe(json.loads(out), path)

    @staticmethod
    def _parse_ffprobe(data: dict, url: str) -> AudioMetadata:
        """decoder.go:566-625."""
        md = AudioMetadata(url=url)
        fmt = data.get("format", {})
        md.format_name = fmt.get("format_name", "")
        md.duration = float(fmt.get("duration", 0) or 0)
        md.bit_rate = int(fmt.get("bit_rate", 0) or 0)
        tags = {k.lower(): v for k, v in fmt.get("tags", {}).items()}
        md.genre = tags.get("genre", "")
        md.title = tags.get("title", "")
        md.station = tags.get("icy-name", tags.get("station", ""))
        for s in data.get("streams", []):
            if s.get("codec_type") == "audio":
                md.codec = s.get("codec_name", "")
                md.sample_rate = int(s.get("sample_rate", 0) or 0)
                md.channels = int(s.get("channels", 0) or 0)
                break
        return md

    def probe_url(self, url: str) -> AudioMetadata:
        """ProbeURL (decoder.go:437-...): ffprobe a remote stream."""
        if shutil.which(self.config.ffprobe_path) is None:
            raise RuntimeError("ffprobe required for URL probing")
        cmd = [
            self.config.ffprobe_path,
            "-v", "error",
            "-show_format", "-show_streams",
            "-of", "json",
            "-analyzeduration", "2000000",
            url,
        ]
        out = subprocess.run(
            cmd, capture_output=True, timeout=self.config.timeout, check=True
        ).stdout
        return self._parse_ffprobe(json.loads(out), url)

    def _probe_wav(self, path: str) -> AudioMetadata:
        with wave.open(path, "rb") as w:
            return AudioMetadata(
                url=path,
                format_name="wav",
                codec=f"pcm_s{8 * w.getsampwidth()}le",
                sample_rate=w.getframerate(),
                channels=w.getnchannels(),
                duration=w.getnframes() / float(w.getframerate()),
            )

    # -- decode paths ------------------------------------------------------
    def decode_file(self, path: str) -> AudioData:
        """decoder.go:146-173."""
        if self.ffmpeg_available():
            meta = self.probe_file(path)
            return self._decode_with_ffmpeg(["-i", path], meta)
        if path.lower().endswith(".wav"):
            return self._decode_wav_file(path)
        raise RuntimeError(
            f"ffmpeg not available and {path} is not a WAV file"
        )

    def decode_bytes(self, data: bytes, format_hint: str = "") -> AudioData:
        """decoder.go:176-224."""
        if self.ffmpeg_available():
            in_args = []
            if format_hint:
                in_args += ["-f", format_hint]
            in_args += ["-i", "pipe:0"]
            return self._decode_with_ffmpeg(in_args, AudioMetadata(), stdin=data)
        return self._decode_wav_bytes(data)

    def decode_reader(self, reader, format_hint: str = "") -> AudioData:
        """DecodeReader (decoder.go:227-259): decode from a file-like
        object (read fully, then the bytes path)."""
        return self.decode_bytes(reader.read(), format_hint)

    def decode_url(self, url: str, is_hls: bool = False, is_icecast: bool = False) -> AudioData:
        """decoder.go:262-434. Streaming flags map to ffmpeg input options."""
        if not self.ffmpeg_available():
            raise RuntimeError("ffmpeg required for URL decoding")
        in_args = []
        if is_icecast:
            in_args += ["-icy", "1", "-reconnect", "1", "-reconnect_streamed", "1"]
        if is_hls:
            in_args += ["-allowed_extensions", "ALL"]
        in_args += ["-i", url]
        return self._decode_with_ffmpeg(in_args, AudioMetadata(url=url))

    def _decode_with_ffmpeg(
        self, in_args: Sequence[str], meta: AudioMetadata, stdin: Optional[bytes] = None
    ) -> AudioData:
        needs_resample = meta.sample_rate != self.config.target_sample_rate
        cmd = (
            [self.config.ffmpeg_path]
            + list(in_args)
            + self.build_ffmpeg_args(needs_resample)
            + ["pipe:1"]
        )
        self._log.debug("running ffmpeg", cmd=" ".join(cmd))
        proc = subprocess.run(
            cmd,
            input=stdin,
            capture_output=True,
            timeout=max(self.config.timeout, (meta.duration or 30) * 2),
        )
        if proc.returncode != 0:
            raise RuntimeError(f"ffmpeg failed: {proc.stderr[-500:].decode(errors='replace')}")
        pcm = self._bytes_to_float32(proc.stdout)
        return AudioData(
            pcm=pcm,
            sample_rate=self.config.target_sample_rate,
            channels=self.config.target_channels,
            metadata=meta,
        )

    @staticmethod
    def _bytes_to_float32(raw: bytes) -> np.ndarray:
        """Vectorized equivalent of the reference's per-8-byte loop
        (decoder.go:850-870)."""
        n = len(raw) - (len(raw) % 4)
        return np.frombuffer(raw[:n], dtype="<f4").copy()

    # -- WAV path -----------------------------------------------------------
    def _decode_wav_file(self, path: str) -> AudioData:
        with open(path, "rb") as f:
            return self._decode_wav_bytes(f.read(), url=path)

    def _decode_wav_bytes(self, data: bytes, url: str = "") -> AudioData:
        if native.available():
            try:
                x, sr, ch = native.decode_wav_bytes(data)
            except ValueError as e:  # the parser's rejection (e.g. an extensible header)
                self._log.warn("native WAV decode rejected the data; using the stdlib path",
                               url=url, error=str(e))
            else:
                # decode stays native; resampling goes through the
                # polyphase Kaiser-sinc path (the native linear resampler
                # aliases — see tests/test_resample.py)
                return self._finish_wav(x, sr, ch, url)

        with wave.open(_io.BytesIO(data), "rb") as w:
            sr = w.getframerate()
            ch = w.getnchannels()
            width = w.getsampwidth()
            frames = w.readframes(w.getnframes())
        if width == 2:
            x = np.frombuffer(frames, dtype="<i2").astype(np.float32) / 32768.0
        elif width == 4:
            x = np.frombuffer(frames, dtype="<i4").astype(np.float32) / 2147483648.0
        elif width == 1:
            x = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif width == 3:
            b = np.frombuffer(frames, dtype=np.uint8).reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported WAV sample width {width}")
        if ch > 1:
            x = x.reshape(-1, ch).mean(axis=1)
        return self._finish_wav(x, sr, ch, url)

    def _finish_wav(self, x: np.ndarray, sr: int, ch: int, url: str) -> AudioData:
        """Resample mono PCM to the target rate, cut to max_duration."""
        if sr != self.config.target_sample_rate:
            x = _resample_polyphase(x, sr, self.config.target_sample_rate)
            sr = self.config.target_sample_rate
        if self.config.max_duration > 0:
            x = x[: int(self.config.max_duration * sr)]
        return AudioData(
            pcm=x,
            sample_rate=sr,
            channels=1,
            metadata=AudioMetadata(url=url, format_name="wav", sample_rate=sr, channels=ch),
        )


def _resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interp resampler (kept as a reference point for tests; the
    decode path uses _resample_polyphase, which matches the soxr-grade
    contract of transcode/decoder.go:75-83)."""
    n_out = int(round(len(x) * sr_out / sr_in))
    t_out = np.arange(n_out, dtype=np.float64) * sr_in / sr_out
    return np.interp(t_out, np.arange(len(x), dtype=np.float64), x).astype(np.float32)


@lru_cache(maxsize=32)
def design_resample_filter(
    L: int, M: int, taps_per_phase: int = 64, atten_db: float = 90.0
) -> np.ndarray:
    """Kaiser-windowed-sinc anti-aliasing lowpass for L/M rational
    resampling, designed in float64 at the upsampled rate sr_in*L.

    The stopband edge is pinned AT the tighter Nyquist (min of input and
    output): the cutoff is pulled DOWN by half the Kaiser transition
    width, so every frequency that could alias sits in the >=atten_db
    stopband. A naive cutoff at Nyquist leaves the transition band
    straddling it — for 48k->44.1k with a practical tap count that means
    NO input frequency reaches full attenuation and tones near 23 kHz
    alias in at -40 dB. Trades a slightly earlier passband edge
    (~18 kHz for 48k->44.1k at the defaults) for a hard alias floor.
    """
    n_taps = taps_per_phase * max(L, M) + 1
    n_taps |= 1  # odd length -> integer group delay
    beta = 0.1102 * (atten_db - 8.7)  # Kaiser's attenuation formula
    # transition width (fraction of the upsampled Nyquist) from the
    # Kaiser tap-count estimate N = (A - 7.95) / (2.285 * d_omega)
    trans = (atten_db - 7.95) / (2.285 * n_taps) / np.pi
    nyq = 1.0 / max(L, M)  # tighter Nyquist, upsampled-normalized
    cutoff = nyq - trans / 2.0
    if cutoff <= trans / 2.0:
        raise ValueError(
            f"resample filter infeasible: L={L} M={M} needs more than "
            f"{taps_per_phase} taps/phase for {atten_db} dB"
        )
    n = np.arange(n_taps, dtype=np.float64) - (n_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(n_taps, beta)
    return (L * h).astype(np.float64)  # gain L compensates zero-stuffing


def _resample_polyphase(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase Kaiser-windowed-sinc resampler (soxr-grade contract of
    transcode/decoder.go:75-83 for the ffmpeg-less ingest path).

    Equivalent to zero-stuff by L -> FIR lowpass -> take every M-th
    sample, evaluated without materializing the upsampled signal: output
    phase p advances through the input at stride M, so each phase is
    taps-per-phase strided multiply-adds — O(n_out * taps/L) total.
    Everything runs in float64; the final cast is float32.
    """
    if sr_in == sr_out:
        return np.asarray(x, dtype=np.float32)
    g = gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    h = design_resample_filter(L, M)
    N = len(h)
    D = (N - 1) // 2  # group delay in the upsampled domain
    T = -(-N // L)  # taps per phase
    hp = np.zeros((L, T), dtype=np.float64)
    for p in range(L):
        vals = h[p::L]
        hp[p, : len(vals)] = vals

    xin = np.asarray(x, dtype=np.float64)
    n_out = int(round(len(xin) * sr_out / sr_in))
    if n_out <= 0:
        return np.zeros(0, dtype=np.float32)
    pad = T + 1
    # highest input index any phase touches: j for output n is
    # (n*M + D) // L, maximal at n = n_out - 1
    j_max = ((n_out - 1) * M + D) // L
    right = max(0, j_max + 2 - len(xin))
    xp = np.concatenate(
        [np.zeros(pad), xin, np.zeros(right + pad)]
    )
    y = np.empty(n_out, dtype=np.float64)
    s8 = xp.strides[0]
    for n0 in range(min(L, n_out)):
        m = n0 * M + D
        p = m % L
        j0 = m // L
        cnt = (n_out - n0 + L - 1) // L
        # V[s, u] = xp[pad + j0 - (T-1) + u + s*M]  (u = T-1-t), so the
        # phase is ONE matvec against the tap-reversed filter
        view = np.lib.stride_tricks.as_strided(
            xp[pad + j0 - (T - 1):], shape=(cnt, T), strides=(M * s8, s8)
        )
        y[n0::L] = view @ hp[p, ::-1]
    return y.astype(np.float32)


def write_wav(path: str, pcm: np.ndarray, sample_rate: int) -> None:
    """Utility for tests/benchmarks: write mono float PCM as 16-bit WAV."""
    x = np.clip(np.asarray(pcm, dtype=np.float64), -1.0, 1.0)
    ints = (x * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(ints.tobytes())


# what decoding one file can raise: unreadable or missing files, malformed
# or unsupported WAV data, a failed ffmpeg or ffprobe run, and no decoder
# for the format
DECODE_ERRORS = (OSError, EOFError, ValueError, RuntimeError, wave.Error,
                 subprocess.SubprocessError)


def decode_files_parallel(
    paths, config: Optional[DecoderConfig] = None, max_workers: int = 8
):
    """Decode many files concurrently (the host-side data-loader for
    corpus work; decode is I/O + subprocess bound, so a thread pool is
    the right shape). Returns AudioData in input order; a file that
    fails with one of DECODE_ERRORS becomes None with a warning."""
    import concurrent.futures

    log = get_global_logger().with_component("transcode", "decode_files_parallel")
    dec = Decoder(config)

    def one(path):
        try:
            return dec.decode_file(path)
        except DECODE_ERRORS as e:
            log.warn("decode failed", path=path, error=str(e))
            return None

    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(one, paths))
