"""K1: fused STFT magnitude + aux epilogue on Hopper, and K10, its
feature epilogue — the wrapper, its plain PyTorch version and its launch
counters.

Counterpart of `sonido_sonar_tpu/ops/pallas_stft.py`
(`stft_magnitude_pallas(with_aux=True, pre_emph=..., with_features=...)`);
the kernel is `csrc/stft.cu`. For a CPU tensor the wrapper runs the plain
version; for a CUDA tensor it launches the kernel or raises — nothing
falls back.

Outputs: magnitude [B, T, F] and an aux dict of [B, T] series:
  rms               sqrt(mean(frame^2)) of the pre-emphasized frame
  zero_crossings    count of (x >= 0) flips between neighbours
  rolloff_bin       first bin whose power prefix sum reaches 0.85 of the
                    total (clamped to F-1), 0 where the total is 0
  low_energy_ratio  power in bins [0, F//4) over the total, 0 where the total is 0
  high_energy_ratio power in bins [F//4, F) over the total, 0 where the total is 0

With `with_features=True` a third output, feat [..., T, 43], carries per
frame (FEAT_LANES; the JAX kernel's lanes 0-42):
  mel       lanes 0-25: power @ mel_filterbank(26, W, sr, 0, sr/2).T
  chroma    lanes 26-37: the chroma-STFT fold of the power, unit-sum
            normalized (ops/chroma.chroma_from_magnitude)
  centroid, bandwidth, flatness, crest, slope  lanes 38-42: the
            descriptor bundle's values (ops/spectral.frame_descriptors),
            bandwidth by its second pass over (f - centroid)^2 m
The JAX kernel's lanes 43-63 are scratch for its moment matmuls
("overwritten or ignored", pallas_stft.py:50-65); the port emits 43 lanes.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.config.config import WindowType
from sonido_sonar_tpu_torch.ops import spectral as S
from sonido_sonar_tpu_torch.ops.chroma import chroma_fold_matrix, chroma_normalize
from sonido_sonar_tpu_torch.ops.filters import pre_emphasis
from sonido_sonar_tpu_torch.ops.framing import frame_signal, kernel_signal
from sonido_sonar_tpu_torch.ops.mel import mel_filterbank
from sonido_sonar_tpu_torch.ops.stft import stft
from sonido_sonar_tpu_torch.ops.tables import device_table
from sonido_sonar_tpu_torch.ops.windows import make_window

AUX_KEYS = (
    "rms", "zero_crossings", "rolloff_bin", "low_energy_ratio", "high_energy_ratio",
)
FEAT_LANES = {
    "mel": (0, 26),
    "chroma": (26, 38),
    "spectral_centroid": 38,
    "spectral_bandwidth": 39,
    "spectral_flatness": 40,
    "spectral_crest": 41,
    "spectral_slope": 42,
}
N_FEAT = 43
_N_MEL = 26
_N_SUMS = 38  # mel and chroma rows of the sparse table
_EPS = 1e-10
_ROLLOFF = 0.85


def fft_passes(half: int) -> Tuple[Tuple[int, int], ...]:
    """(radix R, span Ns) of each pass of K1's `half`-point FFT, in the
    order csrc/stft.cu's FftPlan runs them: radix-8 passes, then one of
    radix 2 or 4 for what is left; Ns is the product of the earlier
    radices (Stockham autosort, natural order out)."""
    log2 = half.bit_length() - 1
    radices = [8] * (log2 // 3) + ([1 << (log2 % 3)] if log2 % 3 else [])
    passes, span = [], 1
    for r in radices:
        passes.append((r, span))
        span *= r
    return tuple(passes)


def swizzle(i):
    """The kernel's warp-buffer index (csrc/stft.cu swz), in complex
    points: bits 3-6 flip bits 0-3, a permutation of [0, half)."""
    return i ^ ((i >> 3) & 15)


@functools.lru_cache(maxsize=8)
def twiddle_table(window_size: int) -> np.ndarray:
    """K1's twiddles as [T, 2] float32 (cos, sin), built in float64, in the
    order the kernel reads them: at 0, exp(-2 pi i k / W) for k in
    [0, W/2], the real-FFT split's; then for each pass p >= 1 of
    `fft_passes` (pass 0 has span 1 and no twiddles), exp(-2 pi i q r /
    (Ns R)) at (r - 1) Ns + q for r in [1, R), q in [0, Ns), so lanes of
    neighbouring butterflies (q = j mod Ns) read neighbouring entries."""
    half = window_size // 2
    ang = [-2.0 * np.pi * np.arange(half + 1, dtype=np.float64) / window_size]
    for radix, span in fft_passes(half)[1:]:
        r = np.arange(1, radix, dtype=np.float64)[:, None]
        q = np.arange(span, dtype=np.float64)[None, :]
        ang.append((-2.0 * np.pi * q * r / (span * radix)).ravel())
    a = np.concatenate(ang)
    return np.stack([np.cos(a), np.sin(a)], axis=1).astype(np.float32)


def complex_twiddles(window_size: int) -> np.ndarray:
    """`twiddle_table(window_size)` as complex64, the values the kernels read."""
    tw = twiddle_table(window_size)
    return (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)


def fft_passes_model(z: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """numpy model of the warp FFT core (csrc/warp_fft.cuh), pass by pass
    with the kernels' index maps: [..., half] complex64 points in natural
    order -> the warp buffer after the last pass, point k of the transform
    at `swizzle(k)`. `tw` is `complex_twiddles(2 * half)`.

    Butterfly j of a pass is lane j % 32's slot j // 32; it reads points
    j + r * half/R of the warp buffer (pass 0: of `z`), multiplies point
    r >= 1 by table entry (r - 1) Ns + (j mod Ns) of its pass, and writes
    the R-point DFT to (j // Ns) Ns R + (j mod Ns) + r Ns; every buffer
    index goes through `swizzle`. Arithmetic in complex64."""
    half = z.shape[-1]
    buf = np.zeros_like(z)
    offset = half + 1
    for p, (radix, span) in enumerate(fft_passes(half)):
        nb = half // radix
        j = np.arange(nb)
        r = np.arange(radix)
        src = j[:, None] + r[None, :] * nb                      # [butterflies, R]
        v = z[..., src] if p == 0 else buf[..., swizzle(src)]
        if p > 0:
            t = tw[offset + (r[None, 1:] - 1) * span + (j % span)[:, None]]
            v = np.concatenate([v[..., :1], v[..., 1:] * t], axis=-1)
            offset += (radix - 1) * span
        v = np.fft.fft(v, axis=-1).astype(np.complex64)
        dst = ((j // span) * span * radix + j % span)[:, None] + r[None, :] * span
        buf = np.empty_like(buf)
        buf[..., swizzle(dst)] = v
    return buf


def fft_model(frames: np.ndarray) -> np.ndarray:
    """numpy model of K1's per-frame transform: [..., W] windowed real
    frames -> [..., W/2 + 1] complex64 spectrum, as np.fft.rfft gives it.
    The packed frame z[m] = x[2m] + i x[2m+1] through `fft_passes_model`;
    the split gives bin k = lane + 32 i from Z[k] and Z[half - k] (mod
    half) and table entry k, halved at the end."""
    w = frames.shape[-1]
    half = w // 2
    tw = complex_twiddles(w)
    x = np.asarray(frames, np.float32)
    buf = fft_passes_model((x[..., 0::2] + 1j * x[..., 1::2]).astype(np.complex64), tw)
    k = np.arange(half + 1)
    zk = buf[..., swizzle(k & (half - 1))]
    zc = np.conj(buf[..., swizzle((half - k) & (half - 1))])
    # 2 X[k] = A + W^k (-i B), A = Z[k] + conj Z[N-k], B = Z[k] - conj Z[N-k]
    return (np.complex64(0.5) * ((zk + zc) + tw[k] * (np.complex64(-1j) * (zk - zc)))).astype(
        np.complex64)


@functools.lru_cache(maxsize=8)
def feature_tables(f_bins: int, sample_rate: int, window_size: int) -> Tuple[np.ndarray, ...]:
    """The K10 epilogue's constants, from the numpy builders of the plain
    version: the 26 mel filters over 0..sr/2 and the 12-class chroma fold
    (the tables mfcc() and chroma_from_magnitude() read) as a compressed
    sparse row table (row_ptr int32 [39], bin int32 [nnz], weight float32
    [nnz]; a mel filter is a triangle over a run of bins and a bin folds
    into at most one chroma class, so nnz ~ 2F), and [F, 2] float32 of
    (frequency, log10 frequency or 0 at f = 0), built in float64."""
    w = np.concatenate([
        mel_filterbank(_N_MEL, window_size, sample_rate, 0.0, sample_rate / 2.0),
        chroma_fold_matrix(f_bins, sample_rate, window_size),
    ])
    nz = [np.flatnonzero(row) for row in w]
    row_ptr = np.concatenate([[0], np.cumsum([len(z) for z in nz])]).astype(np.int32)
    bins = np.concatenate(nz).astype(np.int32)
    weights = np.concatenate([row[z] for row, z in zip(w, nz)]).astype(np.float32)
    freqs = S._freq_bins(f_bins, sample_rate)
    f64 = freqs.astype(np.float64)
    logf = np.where(f64 > 0, np.log10(np.maximum(f64, _EPS)), 0.0)
    freq_logf = np.stack([freqs, logf.astype(np.float32)], axis=1)
    return row_ptr, bins, weights, np.ascontiguousarray(freq_logf)


N_SLOTS = 32 + _N_SUMS  # the warp's scratch slots of the weighted sums' partials
WALK_STEP = 4  # table entries a lane loads together (csrc/stft.cu kWalkStep)


def feature_plan(row_ptr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """K10's plan for the 38 weighted sums (csrc/stft.cu sums_plan): the
    table's nnz entries cut into 32 contiguous segments of floor or ceil
    nnz / 32, lane l's [l nnz // 32, (l + 1) nnz // 32) -> (segments
    [32, 2]: lane l walks entries [start, end)), and (rows [38, 2]: row
    r's partials are the slots first .. first + count - 1). Lane l's
    partial of row r sits at slot l + r; entry e is lane (32 e + 31) //
    nnz's, so row r's lanes run from its first entry's to its last's,
    none for an empty row."""
    row_ptr = np.asarray(row_ptr, np.int64)
    nnz = int(row_ptr[-1])
    lanes = np.arange(33)
    bounds = lanes * nnz // 32
    segments = np.stack([bounds[:-1], bounds[1:]], axis=1)
    div = max(nnz, 1)
    lo = (32 * row_ptr[:-1] + 31) // div
    hi = (32 * (row_ptr[1:] - 1) + 31) // div
    count = np.where(row_ptr[1:] > row_ptr[:-1], hi - lo + 1, 0)
    return segments, np.stack([lo + np.arange(_N_SUMS), count], axis=1)


@functools.lru_cache(maxsize=8)
def feature_entries(f_bins: int, sample_rate: int, window_size: int) -> np.ndarray:
    """`feature_tables`' sparse table as the kernel reads it: [S, 32, 2]
    int32, lane l's t-th entry of `feature_plan`'s segments at [t, l],
    each entry (bin | row << 16, the bits of its float32 weight); so one
    8-byte load gives an entry's bin, weight and row, and the warp's t-th
    loads read one contiguous 256-byte run. S is ceil(nnz / 32) rounded up
    to WALK_STEP; past its segment a lane holds no-ops (bin 0, weight 0,
    the segment's last row; zeros for a lane without entries)."""
    row_ptr, bins, weights, _ = feature_tables(f_bins, sample_rate, window_size)
    rows = np.repeat(np.arange(_N_SUMS, dtype=np.int32), np.diff(row_ptr))
    packed = np.stack([bins | (rows << 16), weights.view(np.int32)], axis=1)
    segments, _ = feature_plan(row_ptr)
    per_lane = -(-int(row_ptr[-1]) // 32)
    out = np.zeros((max(-(-per_lane // WALK_STEP), 1) * WALK_STEP, 32, 2), np.int32)
    for lane, (start, end) in enumerate(segments):
        out[: end - start, lane] = packed[start:end]
        if end > start:
            out[end - start:, lane, 0] = rows[end - 1] << 16
    return out


def feature_sums_model(power: np.ndarray, row_ptr: np.ndarray, entries: np.ndarray) -> np.ndarray:
    """numpy model of K10's weighted sums in the kernel's order: [..., F]
    power -> [..., 38] (mel energies, then the unit-sum chroma), float32.
    `entries` is `feature_entries`' table. Each lane walks its segment of
    `feature_plan`, no-op pads included, with one running sum (acc += w *
    p[bin], one rounding as the kernel's fused multiply-add nearly gives),
    storing it at slot lane + row at each row change; row r adds its
    slots in lane order; the chroma total is the warp's butterfly sum over
    lanes (xor 16, 8, 4, 2, 1) of row `lane` for lanes 26-31 plus row
    lane + 32 for lanes 0-5."""
    p = np.asarray(power, np.float32)
    segments, rows = feature_plan(row_ptr)
    bins = entries[..., 0] & 0xFFFF
    row_of = entries[..., 0] >> 16
    w = entries[..., 1].view(np.float32).astype(np.float64)
    slots = np.zeros(p.shape[:-1] + (N_SLOTS,), np.float32)
    for lane, (j0, j1) in enumerate(segments):
        acc, cur = np.zeros(p.shape[:-1], np.float32), None
        for t in range(len(entries) if j1 > j0 else 0):
            if row_of[t, lane] != cur:
                if cur is not None:
                    slots[..., lane + cur] = acc
                acc, cur = np.zeros_like(acc), int(row_of[t, lane])
            acc = (w[t, lane] * p[..., bins[t, lane]].astype(np.float64) + acc).astype(np.float32)
        if cur is not None:
            slots[..., lane + cur] = acc
    sums = np.zeros(p.shape[:-1] + (_N_SUMS,), np.float32)
    for r, (first, count) in enumerate(rows):
        for t in range(count):
            sums[..., r] = sums[..., r] + slots[..., first + t]
    lanes = np.zeros(p.shape[:-1] + (32,), np.float32)
    lanes[..., _N_MEL:32] = sums[..., _N_MEL:32]
    lanes[..., : _N_SUMS - 32] += sums[..., 32:]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ o]
    total = lanes[..., :1]
    chroma = sums[..., _N_MEL:]
    sums[..., _N_MEL:] = np.where(total > _EPS, chroma / np.maximum(total, np.float32(_EPS)),
                                  chroma)
    return sums


@functools.lru_cache(maxsize=16)
def _feature_tables_on(f_bins: int, sample_rate: int, window_size: int, device: torch.device):
    """row_ptr, entries and freq_logf on `device`, as the kernel takes them."""
    row_ptr, _, _, freq_logf = feature_tables(f_bins, sample_rate, window_size)
    entries = feature_entries(f_bins, sample_rate, window_size)
    return tuple(torch.from_numpy(a).to(device) for a in (row_ptr, entries, freq_logf))


def frame_features(magnitude: torch.Tensor, sample_rate: int, window_size: int) -> torch.Tensor:
    """Plain version of the K10 epilogue over [..., T, F] magnitudes ->
    feat [..., T, 43] (FEAT_LANES): mel energies, the normalized chroma
    fold (pallas_stft.py:405-409) and the five finished descriptors."""
    dev = magnitude.device
    f_bins = magnitude.shape[-1]
    power = magnitude * magnitude
    # the tables, and so the products, of ops/mfcc.mfcc and
    # ops/chroma.chroma_from_magnitude at their defaults
    fb = device_table(
        mel_filterbank, (_N_MEL, window_size, sample_rate, 0.0, sample_rate / 2.0), dev)
    fold = device_table(
        chroma_fold_matrix, (f_bins, sample_rate, window_size, 440.0, 80.0, 8000.0), dev)
    desc = S.frame_descriptors(magnitude, sample_rate)
    lanes = [desc[k] for k, idx in FEAT_LANES.items() if isinstance(idx, int)]
    return torch.cat(
        [torch.matmul(power, fb.T), chroma_normalize(torch.matmul(power, fold.T)),
         torch.stack(lanes, dim=-1)],
        dim=-1,
    )


def k1_takes_window(window_size: int) -> bool:
    """Whether K1 takes this window: a power of two in [64, 2048]."""
    return 64 <= window_size <= 2048 and window_size & (window_size - 1) == 0


def stft_magnitude_plain(
    signal: torch.Tensor,
    window_size: int = 1024,
    hop_size: int = 256,
    window_type: WindowType = WindowType.HANN,
    pre_emph: float = 0.0,
    with_features: bool = False,
    sample_rate: int = 44100,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of K1: pre-emphasis, DFT-matmul STFT, then the aux
    series from the frames and a cumulative power sum; with features, the
    plain K10 epilogue (`frame_features`) as a third output."""
    x = signal.to(torch.float32)
    if pre_emph != 0.0:
        x = pre_emphasis(x, pre_emph)
    mag = stft(x, window_size, hop_size, window_type).magnitude
    frames = frame_signal(x, window_size, hop_size)
    power = mag * mag
    f_bins = mag.shape[-1]
    split = f_bins // 4
    total = torch.sum(power, dim=-1)
    reached = torch.cumsum(power, dim=-1) >= _ROLLOFF * total[..., None]
    first = torch.where(
        torch.any(reached, dim=-1),
        torch.argmax(reached.to(torch.uint8), dim=-1),
        f_bins - 1,
    )
    pos = total > 0
    denom = torch.clamp_min(total, _EPS)
    aux = {
        "rms": torch.sqrt(torch.mean(frames * frames, dim=-1)),
        "zero_crossings": S.zero_crossings(frames),
        "rolloff_bin": torch.where(pos, first.to(torch.float32), 0.0),
        "low_energy_ratio": torch.where(
            pos, torch.sum(power[..., :split], dim=-1) / denom, 0.0
        ),
        "high_energy_ratio": torch.where(
            pos, torch.sum(power[..., split:], dim=-1) / denom, 0.0
        ),
    }
    if with_features:
        return mag, aux, frame_features(mag, sample_rate, window_size)
    return mag, aux


def stft_magnitude_hopper(
    signal: torch.Tensor,
    window_size: int = 1024,
    hop_size: int = 256,
    window_type: WindowType = WindowType.HANN,
    pre_emph: float = 0.0,
    with_features: bool = False,
    sample_rate: int = 44100,
) -> Tuple[torch.Tensor, ...]:
    """[..., N] float32 -> (magnitude [..., T, F], aux dict of [..., T])
    and, with `with_features`, feat [..., T, 43] (K10, at `sample_rate`).

    CPU tensor: the plain version. CUDA tensor: the K1 kernel (with the
    K10 epilogue when asked), which takes a float32 contiguous signal and
    a power-of-two window in [64, 2048]; anything else raises. A launch
    with features gives the same magnitudes and aux bits as one without.
    """
    if signal.device.type == "cpu":
        return stft_magnitude_plain(
            signal, window_size, hop_size, window_type, pre_emph, with_features, sample_rate
        )
    if signal.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {signal.device}")
    if not k1_takes_window(window_size):
        raise ValueError(f"K1 needs a power-of-two window in [64, 2048], got {window_size}")
    sig, b, t = kernel_signal(signal, window_size, hop_size)
    dev = signal.device
    f_bins = window_size // 2 + 1
    mag = torch.empty((b, t, f_bins), dtype=torch.float32, device=dev)
    aux = torch.empty((len(AUX_KEYS), b, t), dtype=torch.float32, device=dev)
    window = device_table(make_window, (WindowType(window_type), window_size), dev)
    twiddle = device_table(twiddle_table, (window_size,), dev)
    geometry = (b, sig.shape[1], t, window_size, hop_size, float(pre_emph))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if with_features:
            feat = torch.empty((b, t, N_FEAT), dtype=torch.float32, device=dev)
            row_ptr, entries, freq_logf = _feature_tables_on(
                f_bins, int(sample_rate), window_size, dev)
            _build.call(
                "sonido_stft_features", sig.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
                mag.data_ptr(), aux.data_ptr(), feat.data_ptr(), row_ptr.data_ptr(),
                entries.data_ptr(), freq_logf.data_ptr(), *geometry, stream,
            )
        else:
            _build.call(
                "sonido_stft_aux", sig.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
                mag.data_ptr(), aux.data_ptr(), *geometry, stream,
            )
    stft_magnitude_hopper.launches += 1
    stft_magnitude_hopper.feat_launches += int(with_features)
    lead = signal.shape[:-1]
    mag = mag.view(lead + (t, f_bins))
    aux_dict = {k: v.view(lead + (t,)) for k, v in zip(AUX_KEYS, aux.unbind(0))}
    if with_features:
        return mag, aux_dict, feat.view(lead + (t, N_FEAT))
    return mag, aux_dict


stft_magnitude_hopper.launches = 0       # every launch
stft_magnitude_hopper.feat_launches = 0  # the launches with the K10 feature epilogue
