"""Batched pipelines — the port's main path and the extractor surfaces.

Counterpart of `sonido_sonar_tpu/parallel/pipeline.py`:
- `batched_fingerprint_features`: [B, N] PCM -> dict of MFCC, chroma,
  spectral series, energy series and pitch, with the same arguments,
  defaults, output keys, shapes and dtypes. It follows the JAX package's
  fused-kernel branch on every device: the K1 kernel (`ops/hopper_stft.py`)
  gives the magnitudes together with rms, zero crossings, the rolloff bin
  and the band ratios, and the K2 kernel (`ops/hopper_yin.py`) gives pitch
  from the raw PCM at 1024/512. Its feature-epilogue configuration
  (`SONIDO_ENABLE_FEAT_EPILOGUE`, `feat_epilogue_enabled`) takes mel,
  chroma and five descriptors from K1's K10 epilogue instead.
- `batched_speech_analysis`, `batched_speech_extractor_features`: the
  speech extractor's whole payload (K1, K2, and K2 with period amplitude
  in the voice-quality chain).
- `batched_music_extractor_features`: the music extractor's payload (K1
  twice, K4 three times), with the optional CQT and HPCP chromas.
- The alignment half: `batched_pair_alignment`, `batched_pair_dtw` (the
  banded DTW fill and backtrack kernels), `batched_refine_offsets`,
  `batched_phat_candidates` and `batched_phat_global` (GCC-PHAT, plain
  `torch.fft` on every device).
- `BatchedFingerprintPipeline`: `batched_fingerprint_features` with the
  batch sharded over a device mesh (`parallel/mesh.py`), K1 and K2
  launched once per shard.
- `run_stream`: a stream of [B, N] batches through any of them, each
  host batch's upload on a copy stream beside the steps before it.
On a CPU tensor every kernel runs its plain PyTorch version. Each
function takes `device` (the card by default): a tensor stays on its own
device, numpy input goes to `device` (utils/device.as_float32).
"""

from __future__ import annotations

import collections
import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator

import numpy as np
import torch

from sonido_sonar_tpu_torch.config.config import FeatureConfig, WindowType
from sonido_sonar_tpu_torch.ops import spectral as S
from sonido_sonar_tpu_torch.ops import temporal as T
from sonido_sonar_tpu_torch.ops.chroma import (
    chroma_cqt,
    chroma_from_magnitude,
    hpcp_from_magnitude,
    key_correlations,
)
from sonido_sonar_tpu_torch.ops.filters import dc_removal, pre_emphasis_for_content
from sonido_sonar_tpu_torch.ops.framing import num_frames
from sonido_sonar_tpu_torch.ops.hopper_stft import FEAT_LANES, stft_magnitude_hopper
from sonido_sonar_tpu_torch.ops.mfcc import MFCCParams, mfcc, mfcc_from_mel
from sonido_sonar_tpu_torch.ops.pitch import PitchParams, yin_pitch, yin_pitch_from_signal
from sonido_sonar_tpu_torch.ops.speech import analyze_speech, hnr_acf
from sonido_sonar_tpu_torch.ops.stft import spectral_flux
from sonido_sonar_tpu_torch.ops.tables import device_table
from sonido_sonar_tpu_torch.ops.temporal import energy_variance
from sonido_sonar_tpu_torch.ops.tonal import chord_matrix
from sonido_sonar_tpu_torch.parallel.mesh import Mesh, shard_over_batch
from sonido_sonar_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    Device,
    as_float32,
    require_fp32_matmuls,
)
from sonido_sonar_tpu_torch.utils.metrics import Span

_EPS = 1e-10
FEAT_EPILOGUE_ENV = "SONIDO_ENABLE_FEAT_EPILOGUE"


def feat_epilogue_enabled(mfcc_coefficients: int = 13) -> bool:
    """Whether `batched_fingerprint_features` takes its feature-epilogue
    configuration: SONIDO_ENABLE_FEAT_EPILOGUE set to a non-empty value and
    MFCC over the epilogue's 26 mel filters (JAX `pipeline.py:92-98`; the
    port always takes the kernel branch, so "the Pallas kernel is
    available" holds on every device). Read on every call: JAX reads it
    once, at trace time, and its compiled program keeps the answer
    (`pipeline.py:87-91`); the port has no trace cache."""
    return (bool(os.environ.get(FEAT_EPILOGUE_ENV))
            and MFCCParams(num_coefficients=mfcc_coefficients).num_mel_filters == 26)


def batched_fingerprint_features(
    pcm: torch.Tensor,
    sample_rate: int = 44100,
    window_size: int = 1024,
    hop_size: int = 256,
    window_type: WindowType = WindowType.HANN,
    mfcc_coefficients: int = 13,
    enable_chroma: bool = True,
    enable_contrast: bool = True,
    enable_pitch: bool = True,
    pre_emphasis_coeff: float = 0.97,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """[B, N] PCM -> dict of [B, ...] float32 feature tensors.

    Covers the fingerprint payload the comparator consumes: MFCC, chroma,
    spectral series (centroid/rolloff/bandwidth/flatness/crest/slope/
    flux/zcr/contrast), energy series + stats, pitch/voicing.

    On a CUDA device the float32 matmuls (DFT, mel, DCT, chroma fold)
    feed log and ratio math and must run in true float32, so TF32 must be
    off (`torch.backends.cuda.matmul.allow_tf32 = False`, the default).

    With the feature-epilogue configuration (`feat_epilogue_enabled`), K1
    runs its K10 epilogue and MFCC, chroma and the five frame descriptors
    come from its lanes (JAX `pipeline.py:119-141`); the keys, shapes and
    dtypes are those of the default configuration.
    """
    x = as_float32(pcm, device).contiguous()
    require_fp32_matmuls(x, "batched_fingerprint_features")
    params = MFCCParams(num_coefficients=mfcc_coefficients)
    out: Dict[str, torch.Tensor] = {}
    if feat_epilogue_enabled(mfcc_coefficients):
        mag, aux, feat = stft_magnitude_hopper(
            x, window_size, hop_size, window_type, pre_emph=pre_emphasis_coeff,
            with_features=True, sample_rate=sample_rate,
        )
        lo, hi = FEAT_LANES["mel"]
        out["mfcc"] = mfcc_from_mel(feat[..., lo:hi], params)
        if enable_chroma:
            clo, chi = FEAT_LANES["chroma"]
            out["chroma"] = feat[..., clo:chi]
        out.update(S.descriptors_from_feat(feat))
        out["spectral_flux"] = spectral_flux(mag)
    else:
        mag, aux = stft_magnitude_hopper(
            x, window_size, hop_size, window_type, pre_emph=pre_emphasis_coeff
        )
        out["mfcc"] = mfcc(mag, sample_rate, window_size, params)
        if enable_chroma:
            out["chroma"] = chroma_from_magnitude(mag, sample_rate, window_size)
        out.update(S.spectral_descriptor_bundle(mag, sample_rate, skip_rolloff=True))
    if enable_contrast:
        out["spectral_contrast"] = S.spectral_contrast(mag, sample_rate, 6)

    # from the K1 epilogue: crossings/sec like ops.spectral.zcr; rolloff
    # bin -> Hz on the same grid as ops.spectral._freq_bins
    out["zcr"] = S.per_second(aux["zero_crossings"], window_size, sample_rate)
    nyquist = sample_rate / 2.0
    out["spectral_rolloff"] = aux["rolloff_bin"] * (nyquist / float(mag.shape[-1] - 1))
    out["low_energy_ratio"] = aux["low_energy_ratio"]
    out["high_energy_ratio"] = aux["high_energy_ratio"]
    rms = aux["rms"]
    out["rms_energy"] = rms
    out["energy_entropy"] = torch.where(rms > 0, -rms * torch.log(rms + 1e-10), 0.0)
    out["energy_variance"] = energy_variance(rms)

    if enable_pitch:
        pitch, conf, voicing = yin_pitch_from_signal(
            x, 1024, 512, PitchParams(sample_rate=sample_rate, window_size=1024),
            pre_emph=pre_emphasis_coeff,
        )
        out["pitch"] = pitch
        out["pitch_confidence"] = conf
        out["voicing"] = voicing
    return out


def spectral_tilt_1024(x: torch.Tensor) -> torch.Tensor:
    """Per-frame spectral tilt at the fixed 1024/512 framing
    (extractors/speech.go:530-585) from hop-block sums: frame j covers
    [s, s+1024); the sums run over the diffs [s, s+1023) and the samples
    [s+1, s+1024) — a whole-window block sum minus one boundary term."""
    t = num_frames(x.shape[-1], 1024, 512)
    d = x[..., 1:] - x[..., :-1]
    d2 = torch.nn.functional.pad(d * d, (0, 1))
    x2 = x * x
    starts = torch.arange(t, device=x.device) * 512
    high_e = T.framed_sum_hopblocks(d2, 1024, 512, t) - d2[..., starts + 1023]
    low_e = T.framed_sum_hopblocks(x2, 1024, 512, t) - x2[..., starts]
    return torch.where(
        low_e > 0,
        -10.0 * torch.log10(torch.clamp_min(high_e / torch.clamp_min(low_e, _EPS), _EPS)),
        0.0,
    )


def batched_speech_analysis(pcm: torch.Tensor, sample_rate: int,
                            device: Device = DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """The speech-analysis stack (LPC -> formants -> voice quality ->
    speech detection, ops/speech.py) over [B, N] PCM, as a dict of
    [B]-leading results."""
    res = analyze_speech(as_float32(pcm, device), sample_rate)
    return {
        "formant_frequencies": res.formants.frequencies,
        "formant_count": res.formants.count,
        "vocal_tract_length": res.formants.vocal_tract_length,
        "jitter": res.voice_quality.jitter,
        "shimmer": res.voice_quality.shimmer,
        "hnr": res.voice_quality.hnr,
        "f0_mean": res.voice_quality.mean_f0,
        "voicing_strength": res.voice_quality.voicing_strength,
        "is_speech": res.is_speech,
        "quality": res.quality_score,
    }


def batched_speech_extractor_features(
    pcm: torch.Tensor,
    sample_rate: int = 44100,
    window_size: int = 1024,
    hop_size: int = 256,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """The speech extractor's whole surface (extractors/speech.go): the
    fingerprint features (no chroma) + the speech analysis chain on the
    speech-pre-emphasized signal + spectral tilt, pauses and speech rate."""
    pcm = as_float32(pcm, device)
    out = batched_fingerprint_features(
        pcm, sample_rate=sample_rate, window_size=window_size,
        hop_size=hop_size, enable_chroma=False, enable_contrast=True,
    )
    x = pre_emphasis_for_content(pcm, "speech")
    out.update(batched_speech_analysis(x, sample_rate))
    # the extractor gates tilt on is_speech (extractors/speech.py)
    out["spectral_tilt"] = torch.where(out["is_speech"][..., None], spectral_tilt_1024(x), 0.0)
    ste = T.short_time_energy_cumsum(x, window_size, hop_size)
    out["pause_duration"], out["pause_count"] = T.pause_durations(ste, hop_size, sample_rate)
    silence_ratio = T.silence_ratio_percentile(ste)
    out["speech_rate"] = torch.where(out["is_speech"], 4.0 * (1.0 - silence_ratio), 0.0)
    return out


# batched_music_extractor_features' stages (utils/metrics.Span, recorded
# while a profiler session runs); the tempo is a stage of its own, not
# nested in the temporal one
MUSIC_SPECTRAL = Span("music.spectral")
MUSIC_CHROMA = Span("music.chroma")
MUSIC_TEMPORAL = Span("music.temporal")
MUSIC_TEMPO = Span("music.tempo")
MUSIC_ENERGY = Span("music.energy")
MUSIC_HARMONIC = Span("music.harmonic")


def batched_music_extractor_features(
    pcm: torch.Tensor,
    sample_rate: int = 44100,
    window_size: int = 1024,
    hop_size: int = 256,
    enable_cqt: bool = False,
    enable_hpcp: bool = False,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """The music extractor's whole surface (extractors/music.go:178-243)
    over [B, N] PCM: DC removal + music pre-emphasis, the descriptor
    bundle + 6-band contrast, ZCR of the preprocessed signal, MFCC
    13/26/lifter 22, chroma + key correlations + chord match, flux onsets
    (0.3, 50 ms), -40 dB silence, interval-histogram tempo, energy, and
    per-frame pitch / HNR / inharmonicity over the contiguous frame split.
    `enable_cqt` adds "chroma_cqt" [B, T', 12] (the CQT chroma of the raw
    PCM, hop 512) and `enable_hpcp` adds "hpcp" [B, T, 12] (from K1's
    magnitudes), as JAX `pipeline.py:455-458`; both are plain PyTorch.
    Each stage runs under its span (`music.spectral`, which holds the
    preprocessing and K1 too, `music.chroma`, `music.temporal`,
    `music.tempo`, `music.energy`, `music.harmonic`)."""
    x = as_float32(pcm, device).contiguous()
    require_fp32_matmuls(x, "batched_music_extractor_features")
    out: Dict[str, torch.Tensor] = {}

    # spectral (music.go:261-302); ZCR of the preprocessed signal
    with MUSIC_SPECTRAL:
        pre = pre_emphasis_for_content(dc_removal(x), "music")
        mag, _ = stft_magnitude_hopper(x, window_size, hop_size)
        t = mag.shape[-2]
        out.update(S.spectral_descriptor_bundle(mag, sample_rate))
        out["spectral_contrast"] = S.spectral_contrast(mag, sample_rate, 6)
        out["zcr"] = S.zcr_from_signal(pre, window_size, hop_size, sample_rate)[..., :t]
        out["mfcc"] = mfcc(
            mag, sample_rate, window_size,
            MFCCParams(num_coefficients=13, num_mel_filters=26, lifter_coeff=22.0),
        )

    # chroma + key + chords
    with MUSIC_CHROMA:
        chroma = chroma_from_magnitude(mag, sample_rate, window_size)
        out["chroma"] = chroma
        out["key_correlations"] = key_correlations(torch.mean(chroma, dim=-2))
        cn = chroma / torch.clamp_min(torch.linalg.vector_norm(chroma, dim=-1, keepdim=True), _EPS)
        chord_sims = torch.matmul(cn, device_table(chord_matrix, (), mag.device).T)  # [B, T, chords]
        out["chord_index"] = torch.argmax(chord_sims, dim=-1).to(torch.int32)
        out["chord_score"] = torch.amax(chord_sims, dim=-1)

    # temporal (music.go:378-430)
    with MUSIC_TEMPORAL:
        out["rms_energy"] = T.short_time_energy(pre, window_size, hop_size)
        onset_mask, onset_count = T.detect_onsets_from_flux(
            spectral_flux(mag), hop_size, sample_rate, threshold=0.3, min_interval_sec=0.05
        )
        out["onset_mask"] = onset_mask
        out["onset_density"] = onset_count.to(torch.float32) / (x.shape[-1] / float(sample_rate))
        out["attack_time"] = torch.where(onset_mask, 0.01, 0.0)
        out["peak_amplitude"] = torch.amax(torch.abs(pre), dim=-1)
        out["average_amplitude"] = torch.mean(torch.abs(pre), dim=-1)
        # fixed 1024/512 framing per dynamic_range.go:27-28
        out["dynamic_range"] = T.dynamic_range_db(pre, 1024, 512)
        out["crest_factor"] = T.crest_factor_frames(pre, window_size, hop_size)
        silence = T.silence_mask_db(pre, window_size, hop_size, -40.0)
        out["silence_ratio"] = torch.mean(silence.to(torch.float32), dim=-1)
        # music envelope framing (music.go:383-386): frame len/numFrames, config hop
        env_frame = max(pre.shape[-1] // out["rms_energy"].shape[-1], 1)
        out["envelope_shape"] = T.rms_envelope(pre, env_frame, hop_size)
    with MUSIC_TEMPO:
        out["tempo_bpm"] = T.estimate_tempo(pre, sample_rate)

    # energy (music.go:478-525)
    with MUSIC_ENERGY:
        ste = out["rms_energy"]
        out["energy_variance"] = T.energy_variance(ste)
        out["energy_entropy"] = torch.where(ste > 0, -ste * torch.log(ste + 1e-10), 0.0)
        out["loudness_range"] = T.loudness_range(pre, sample_rate)
        power = mag * mag
        split = mag.shape[-1] // 4
        total = torch.sum(power, dim=-1)
        denom = torch.clamp_min(total, _EPS)
        out["low_energy_ratio"] = torch.where(total > 0, torch.sum(power[..., :split], dim=-1) / denom, 0.0)
        out["high_energy_ratio"] = torch.where(total > 0, torch.sum(power[..., split:], dim=-1) / denom, 0.0)

    # harmonic (music.go:528-592) over the contiguous frame split
    # (frame len/numFrames, no overlap). This YIN and hnr_acf are plain
    # PyTorch on every device, not K2's plain version standing in for a
    # kernel: the JAX package runs them as XLA (ops/pitch.yin_pitch on
    # [B, T, N/T] frames, the DFT-matmul hnr_acf) on the TPU too.
    with MUSIC_HARMONIC:
        frame_size = x.shape[-1] // t
        frames = pre[..., : t * frame_size].reshape(pre.shape[:-1] + (t, frame_size))
        pitch, conf, voicing = yin_pitch(frames, PitchParams(sample_rate=sample_rate, window_size=frame_size))
        hnr = hnr_acf(frames, sample_rate, torch.clamp_min(pitch, 1.0))
        out["pitch"] = pitch
        out["pitch_confidence"] = conf
        out["voicing"] = voicing
        out["hnr"] = torch.where(pitch > 0, hnr, 0.0)
        out["inharmonicity"] = torch.where(
            (pitch > 0) & (conf > 0.5), 1.0 - torch.clamp(voicing, 0.0, 1.0), 0.0
        )
        out["tonal_centroid"] = out["spectral_centroid"][..., :t] * voicing

    # the optional CQT and HPCP chromas (beyond the per-signal payload)
    if enable_cqt:
        out["chroma_cqt"] = chroma_cqt(x, sample_rate)
    if enable_hpcp:
        out["hpcp"] = hpcp_from_magnitude(mag, sample_rate, window_size)
    return out


@dataclass
class BatchedFingerprintPipeline:
    """Mesh-sharded fingerprint pipeline (JAX `parallel/pipeline.py:462-514`).

    Usage:
        pipe = BatchedFingerprintPipeline(make_mesh(), config)
        feats = pipe(pcm_batch)   # [B, N] numpy or tensor, B % mesh size == 0

    Each shard runs `batched_fingerprint_features` with the config's
    fields on its rows, on its entry's device (K1 and K2 once a shard);
    the outputs come back in row order on the first local entry's device
    (`mesh.shard_over_batch`). A one-entry mesh calls the step directly.
    Under a process group `pcm_batch` is this process's rows.
    """

    mesh: Mesh
    config: FeatureConfig
    axis: str = "data"

    def __call__(self, pcm_batch) -> Dict[str, torch.Tensor]:
        if not isinstance(pcm_batch, torch.Tensor):
            pcm_batch = torch.from_numpy(np.asarray(pcm_batch, dtype=np.float32))
        return self._step_fn()(pcm_batch)

    def _step_fn(self):
        # built once per (config, mesh, axis); keying on the settings means
        # a replaced pipe.config / pipe.mesh rebuilds the step instead of
        # serving features of the old settings (JAX's ADVICE r4 #1)
        cfg = self.config
        key = (cfg, id(self.mesh), self.axis)
        cached = getattr(self, "_cached_step", None)
        if cached is not None and cached[0] == key:
            return cached[1]

        def step(x):  # x on its entry's device
            return batched_fingerprint_features(
                x,
                sample_rate=cfg.sample_rate,
                window_size=cfg.window_size,
                hop_size=cfg.hop_size,
                window_type=cfg.window_type,
                mfcc_coefficients=cfg.mfcc_coefficients,
                enable_chroma=cfg.enable_chroma,
                enable_contrast=cfg.enable_spectral_contrast,
            )

        if self.mesh.size > 1:
            fn = shard_over_batch(step, self.mesh, self.axis)
        else:
            device = self.mesh.local_devices[0]

            def fn(x):
                return step(x.to(device))
        self._cached_step = (key, fn)
        return fn


# ---------------------------------------------------------------------
# Stream alignment: batched pair alignment and GCC-PHAT (plain PyTorch
# on every device, as these are XLA in JAX; the banded DTW fill and
# backtrack are the kernels)
# ---------------------------------------------------------------------

def batched_pair_alignment(
    query_energy: torch.Tensor, reference_energy: torch.Tensor, max_lag: int,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """Source/CDN alignment over energy series [B, T]: per-pair peak lag
    in frames (positive = reference delayed), peak correlation and SNR."""
    from sonido_sonar_tpu_torch.ops.stats.alignment import _ncc_arrays
    from sonido_sonar_tpu_torch.ops.stats.correlation import _peak_metrics

    query_energy = as_float32(query_energy, device)
    reference_energy = as_float32(reference_energy, device)
    t1, t2 = query_energy.shape[-1], reference_energy.shape[-1]
    corr = _ncc_arrays(query_energy, reference_energy, max_lag, t1, t2)
    peak_corr, peak_lag, _idx, _p, snr, *_rest = _peak_metrics(corr, max_lag, t1, t2)
    return {"lag_frames": -peak_lag, "peak_correlation": peak_corr, "snr": snr}


def batched_pair_dtw(
    query_feats: torch.Tensor, reference_feats: torch.Tensor, band: int,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """Banded DTW over feature-sequence pairs [B, T, D]: one fill and one
    backtrack launch over the batch (the kernels on a CUDA tensor), then
    per-pair normalized distance and the median interior displacement in
    frames (positive = reference delayed)."""
    from sonido_sonar_tpu_torch.ops.stats.batched_alignment import masked_median
    from sonido_sonar_tpu_torch.ops.stats.hopper_backtrack import backtrack_banded_hopper
    from sonido_sonar_tpu_torch.ops.stats.hopper_dtw import fill_banded_hopper

    q = as_float32(query_feats, device).contiguous()
    r = as_float32(reference_feats, device).contiguous()
    n, m = q.shape[1], r.shape[1]
    costs = fill_banded_hopper(q, r, band, n, m)
    qs, rs, _, lengths = backtrack_banded_hopper(costs, band, n, m)
    dists = costs[:, n, m - n + band] / torch.clamp_min(lengths, 1).to(torch.float32)
    idx = torch.arange(qs.shape[-1], device=qs.device)
    interior = ((idx < lengths.to(torch.int64)[:, None]) & (qs > 0) & (rs > 0)
                & (qs < n - 1) & (rs < m - 1))
    offsets = masked_median((rs - qs).to(torch.float32), interior)
    offsets = torch.where(torch.isnan(offsets), 0.0, offsets)
    return {"distance": dists, "offset_frames": offsets, "path_length": lengths}


def _pow2_at_least(n: int) -> int:
    k = 1
    while k < n:
        k <<= 1
    return k


def _windows(x: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """x [B, N], starts [B, ...] -> x[b, s : s + length] as [B, ..., length]."""
    idx = starts.to(torch.int64)[..., None] + torch.arange(length, device=x.device)
    flat = idx.reshape(idx.shape[0], -1)
    return torch.gather(x, 1, flat).reshape(idx.shape)


def _phat_cc(q: torch.Tensor, r: torch.Tensor, n_fft: int, max_lag: int) -> torch.Tensor:
    """Energy-weighted GCC-PHAT over lags -max_lag..max_lag: whitened
    cross-spectrum with a 1e-3 * mean soft floor, so bins without
    cross-power carry no random unit phases."""
    from sonido_sonar_tpu_torch.ops.stats.correlation import lag_window

    cross = torch.fft.rfft(q, n=n_fft, dim=-1) * torch.conj(torch.fft.rfft(r, n=n_fft, dim=-1))
    mag = torch.abs(cross)
    delta = 1e-3 * torch.mean(mag, dim=-1, keepdim=True)
    phat = cross / torch.clamp_min(mag + delta, 1e-12)
    return lag_window(torch.fft.irfft(phat, n=n_fft, dim=-1), n_fft, max_lag)


def _phat_geometry(n1: int, n2: int, hop_size: int, search_hops: int, max_offset_samples: int):
    if max_offset_samples <= 0:
        max_offset_samples = min(n1, n2) // 4
    length = min(n1, n2) - max_offset_samples
    if length <= 0:
        raise ValueError("max_offset_samples leaves no analysis window")
    max_lag = max(search_hops * hop_size, 8)
    return max_offset_samples, length, max_lag, _pow2_at_least(length + max_lag)


def batched_refine_offsets(
    query_pcm: torch.Tensor, reference_pcm: torch.Tensor, coarse_offsets_seconds: torch.Tensor,
    sample_rate: int, hop_size: int = 256, search_hops: int = 24, max_offset_samples: int = 0,
    device: Device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Exact-sample refinement of [B] coarse offsets (seconds, positive =
    reference delayed) by GCC-PHAT over +-search_hops hops, [B, N1] x
    [B, N2] PCM -> [B] float32 seconds. |coarse| is bounded by
    `max_offset_samples` (default N // 4)."""
    query_pcm, reference_pcm = as_float32(query_pcm, device), as_float32(reference_pcm, device)
    n1, n2 = query_pcm.shape[-1], reference_pcm.shape[-1]
    max_off, length, max_lag, n_fft = _phat_geometry(n1, n2, hop_size, search_hops,
                                                     max_offset_samples)
    coarse = torch.round(as_float32(coarse_offsets_seconds, device) * sample_rate).to(torch.int32)
    coarse = torch.clamp(coarse, -max_off, max_off)
    q = _windows(query_pcm, torch.clamp(-coarse, 0, n1 - length), length)
    r = _windows(reference_pcm, torch.clamp(coarse, 0, n2 - length), length)
    window = _phat_cc(q, r, n_fft, max_lag)
    residual = -(torch.argmax(window, dim=-1).to(torch.int32) - max_lag)
    return (coarse + residual).to(torch.float32) / float(sample_rate)


def batched_phat_candidates(
    query_pcm: torch.Tensor, reference_pcm: torch.Tensor, cand_offsets_seconds: torch.Tensor,
    sample_rate: int, hop_size: int = 256, search_hops: int = 24, max_offset_samples: int = 0,
    device: Device = DEFAULT_DEVICE,
) -> tuple:
    """GCC-PHAT refinement and whitened-peak strength of K candidate
    offsets per pair: [B, N1] x [B, N2] PCM, [B, K] seconds ->
    (refined [B, K] seconds, peaks [B, K])."""
    query_pcm, reference_pcm = as_float32(query_pcm, device), as_float32(reference_pcm, device)
    n1, n2 = query_pcm.shape[-1], reference_pcm.shape[-1]
    max_off, length, max_lag, n_fft = _phat_geometry(n1, n2, hop_size, search_hops,
                                                     max_offset_samples)
    coarse = torch.round(as_float32(cand_offsets_seconds, device) * sample_rate).to(torch.int32)
    coarse = torch.clamp(coarse, -max_off, max_off)
    q = _windows(query_pcm, torch.clamp(-coarse, 0, n1 - length), length)
    r = _windows(reference_pcm, torch.clamp(coarse, 0, n2 - length), length)
    window = _phat_cc(q, r, n_fft, max_lag)
    idx = torch.argmax(window, dim=-1)
    peaks = torch.gather(window, -1, idx[..., None])[..., 0]
    residual = -(idx.to(torch.int32) - max_lag)
    return (coarse + residual).to(torch.float32) / float(sample_rate), peaks


def batched_phat_global(
    query_pcm: torch.Tensor, reference_pcm: torch.Tensor, sample_rate: int, max_lag_samples: int,
    device: Device = DEFAULT_DEVICE,
) -> tuple:
    """Whitened full-range GCC-PHAT scan per pair, [B, N] x 2 ->
    ([B] offset seconds, [B] peak); positive offset = reference delayed."""
    query_pcm, reference_pcm = as_float32(query_pcm, device), as_float32(reference_pcm, device)
    length = min(query_pcm.shape[-1], reference_pcm.shape[-1])
    max_lag = min(max_lag_samples, length - 1)
    n_fft = _pow2_at_least(length + max_lag)
    window = _phat_cc(query_pcm[..., :length], reference_pcm[..., :length], n_fft, max_lag)
    idx = torch.argmax(window, dim=-1)
    peaks = torch.gather(window, -1, idx[..., None])[..., 0]
    offsets = -(idx.to(torch.int32) - max_lag).to(torch.float32) / float(sample_rate)
    return offsets, peaks


# run_stream's spans (utils/metrics.Span, recorded while a profiler
# session runs): none stays open across its yield
STAGE = Span("stream.stage")
UPLOAD = Span("stream.upload")
STEP = Span("stream.step")
WAIT = Span("stream.wait")


def run_stream(
    pipeline: Callable,
    batches: Iterable,
    drain_every: int = 2,
    device: Device = DEFAULT_DEVICE,
) -> Iterator:
    """Run `pipeline` over an iterable of [B, N] PCM batches with input
    overlap (counterpart of JAX's `run_stream`, parallel/pipeline.py:546).

    A numpy batch bound for the card is staged in pinned host memory and
    uploaded by a non-blocking copy (what JAX's asynchronous `device_put`
    gives) on a copy stream of the call's own, beside the steps before it:
    the compute stream waits on an event recorded after the copy, and the
    uploaded batch is recorded on the compute stream, so that its memory
    goes to no later upload while its step may read it
    (`run_stream.copy_uploads` counts these uploads). Other numpy batches
    go to `device`, a tensor stays on its own. A CUDA event recorded after
    each step marks it done: at most `drain_every + 1` steps are in flight,
    and each result is yielded, in order, once its event has completed. A
    step's staging buffer is held until then, so no buffer is reused while
    its copy may be reading it. `pipeline` is any callable on a [B, N]
    batch (`models.FingerprintModel`, a partial of
    `batched_fingerprint_features`).
    """
    dev = torch.device(device)
    copy = None   # made at the first host batch bound for the card
    inflight = collections.deque()

    def drained():
        out, done, _staged = inflight.popleft()
        if done is not None:
            with WAIT:
                done.synchronize()
        return out

    for batch in batches:
        staged = None
        if dev.type == "cuda" and not isinstance(batch, torch.Tensor):
            with STAGE:
                host = torch.from_numpy(np.asarray(batch, dtype=np.float32))
                staged = torch.empty(host.shape, dtype=torch.float32, pin_memory=True)
                staged.copy_(host)  # torch's copy runs on every host core
            with UPLOAD:
                if copy is None:
                    copy = torch.cuda.Stream(device=dev)
                compute = torch.cuda.current_stream(dev)
                with torch.cuda.stream(copy):
                    x = staged.to(dev, non_blocking=True)
                compute.wait_event(copy.record_event())
                x.record_stream(compute)
            run_stream.copy_uploads += 1
        else:
            x = as_float32(batch, dev)
        with STEP:
            out = pipeline(x)
        done = None
        if x.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(x.device))
        inflight.append((out, done, staged))
        if len(inflight) > drain_every:
            yield drained()
    while inflight:
        yield drained()


run_stream.copy_uploads = 0   # host batches uploaded on a copy stream
