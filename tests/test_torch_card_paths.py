"""The port's paths on the card at full width and against the CPU: the
main path (and its feature-epilogue configuration), the generator, the
music and speech programs, the extractor class compositions and
STFTStreamer, the fleet and LatencyMonitor, the comparator and a corpus
of 262,144 rows, the music-analysis ops, the op surface, and the meshes.
Each case launches the kernels its path must launch and holds its
outputs to utils/parity's bounds; every case is marked `card` and skips
without a CUDA device. On the card:

    python3 -m pytest --noconftest -q -p no:cacheprovider -m card tests/test_torch_card_paths.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import card_support as C
from card_support import (
    FULL_B, FULL_SECONDS, HOP, MUSIC_INTS, N_FULL, NEWS_INTS, PITCH_HOP, PITCH_WINDOW, PRE_EMPH,
    SEED, SR, T_FRAMES, T_PITCH, WINDOW, check_surface, counted, np32, parity_close, require,
)
from card_support import card  # noqa: F401  (the session fixture)
from sonido_sonar_tpu_torch.ops import hopper_contrast, hopper_stft
from sonido_sonar_tpu_torch.parallel import pipeline
from sonido_sonar_tpu_torch.utils import parity

pytestmark = pytest.mark.card

OUTPUT_KEYS = (
    "mfcc", "chroma", "spectral_centroid", "spectral_bandwidth", "spectral_flatness",
    "spectral_crest", "spectral_slope", "spectral_flux", "spectral_contrast", "zcr",
    "spectral_rolloff", "low_energy_ratio", "high_energy_ratio", "rms_energy",
    "energy_entropy", "energy_variance", "pitch", "pitch_confidence", "voicing",
)
CONTRAST_GAP_DB = 1e-3  # the main path's contrast against the sorts' (the tests' atol)


def _hold_features(x_cpu, dev, sr, what):
    on_card = pipeline.batched_fingerprint_features(x_cpu.to(dev), sample_rate=sr)
    on_cpu = pipeline.batched_fingerprint_features(x_cpu, sample_rate=sr)
    require(parity.check_features({k: np32(v) for k, v in on_card.items()},
                                  {k: v.numpy() for k, v in on_cpu.items()},
                                  parity.near_zero_frames(x_cpu.numpy(), WINDOW, HOP, PRE_EMPH), sr, WINDOW),
            what)


# -- the main path -------------------------------------------------------------

def test_main_path_at_full_width(card):
    """B=128 x 30 s, 1024/256: K1, K2 and K9 launched once each, every key
    float32 of its shape and finite, the contrast bit-equal to
    spectral_contrast of K1's magnitudes and within CONTRAST_GAP_DB of the
    sorts' (K9's plain version)."""
    from sonido_sonar_tpu_torch.ops.spectral import contrast_band_edges, spectral_contrast

    out, launches = counted(lambda: pipeline.batched_fingerprint_features(card.full, sample_rate=SR, window_size=WINDOW, hop_size=HOP))
    assert {k: launches[k] for k in ("K1", "K2", "K9")} == {"K1": 1, "K2": 1, "K9": 1}, launches
    assert sorted(out) == sorted(OUTPUT_KEYS)
    expect = {"mfcc": (T_FRAMES, 13), "chroma": (T_FRAMES, 12), "spectral_contrast": (T_FRAMES, 6),
              "energy_variance": (), "pitch": (T_PITCH,), "pitch_confidence": (T_PITCH,), "voicing": (T_PITCH,)}
    for key, v in out.items():
        shape = (FULL_B,) + expect.get(key, (T_FRAMES,))
        assert tuple(v.shape) == shape and v.dtype == torch.float32, f"{key}: {v.dtype}{tuple(v.shape)}"
        assert bool(torch.isfinite(v).all()), f"{key}: non-finite values"
    mag = hopper_stft.stft_magnitude_hopper(card.full, WINDOW, HOP, pre_emph=PRE_EMPH)[0]
    assert torch.equal(spectral_contrast(mag, SR, 6), out["spectral_contrast"])
    peak, valley = hopper_contrast.band_select_means_plain(mag, contrast_band_edges(6, mag.shape[-1], SR))
    sorted_db = torch.where(peak > 0, 10.0 * torch.log10(peak / torch.clamp_min(valley, 1e-10)), 0.0)
    gap = float((out["spectral_contrast"] - sorted_db).abs().max())
    assert gap <= CONTRAST_GAP_DB, f"the main path's contrast {gap} dB from the sorts'"


@pytest.mark.parametrize("sr", [SR, 16000])
def test_main_path_card_against_cpu(card, sr):
    """[2, 1 s]; at 16 kHz the zero-crossing rate by the exact gate."""
    _hold_features(parity.synth_pcm(2, sr, SEED + (2 if sr == SR else 3), sr), card.dev, sr,
                   f"main path [2, {sr}], card vs CPU")


def test_feature_epilogue_configuration_at_full_width(card, monkeypatch):
    """The default configuration launches K1 without features; the
    feature-epilogue one (SONIDO_ENABLE_FEAT_EPILOGUE=1) K1, K10, K2 and K9
    once each, with the default's keys, shapes and dtypes, finite, and
    within the whole-path bounds of the default's outputs."""
    monkeypatch.delenv(pipeline.FEAT_EPILOGUE_ENV, raising=False)
    default, launches = counted(lambda: pipeline.batched_fingerprint_features(card.full, sample_rate=SR, window_size=WINDOW, hop_size=HOP))
    assert (launches["K1"], launches["K10"]) == (1, 0), launches
    monkeypatch.setenv(pipeline.FEAT_EPILOGUE_ENV, "1")
    out, launches = counted(lambda: pipeline.batched_fingerprint_features(card.full, sample_rate=SR, window_size=WINDOW, hop_size=HOP))
    assert {k: launches[k] for k in ("K1", "K10", "K2", "K9")} == {"K1": 1, "K10": 1, "K2": 1, "K9": 1}
    assert list(out) == list(default)
    for key, v in out.items():
        want = default[key]
        assert v.shape == want.shape and v.dtype == want.dtype and bool(torch.isfinite(v).all()), key
    require(parity.check_features({k: np32(v) for k, v in out.items()}, {k: np32(v) for k, v in default.items()},
                                  np.zeros((FULL_B, T_FRAMES), bool), SR, WINDOW),
            "feature-epilogue against the default configuration")


def test_feature_epilogue_card_against_cpu(card, monkeypatch):
    monkeypatch.setenv(pipeline.FEAT_EPILOGUE_ENV, "1")
    _hold_features(parity.synth_pcm(2, SR, SEED + 2, SR), card.dev, SR,
                   "feature-epilogue main path [2, 44100], card vs CPU")


# -- the generator and the extractor programs ------------------------------------

@pytest.fixture(scope="module")
def clips(card):
    """[128, 30 s] news-labelled harmonic clips (utils/parity.harmonic_clips,
    f0 196 Hz, seed SEED + 6) and the generator's configuration."""
    from sonido_sonar_tpu_torch.config.config import FeatureConfig, FingerprintConfig

    return types.SimpleNamespace(
        pcm=parity.harmonic_clips(FULL_B, N_FULL, SEED + 6, SR, 196.0, card.dev),
        cfg=FingerprintConfig(feature_config=FeatureConfig(sample_rate=SR, window_size=WINDOW, hop_size=HOP)))


def _audios(pcm, label):
    from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata

    return [AudioData(pcm=pcm[i], sample_rate=SR, metadata=AudioMetadata(extra={"content_type": label}))
            for i in range(pcm.shape[0])]


@pytest.fixture(scope="module")
def news_batch(clips):
    """The generator's step on the news-labelled clips
    (generate_fingerprints_batch(pcm_matrix=..., materialize=False)), its
    launches, the batch and its materialized fingerprints."""
    from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator

    gen = FingerprintGenerator(clips.cfg)
    news = _audios(clips.pcm, "news")

    def step():
        return gen.generate_fingerprints_batch(news, pcm_matrix=clips.pcm, materialize=False)

    batch, launches = counted(step)
    return types.SimpleNamespace(step=step, batch=batch, launches=launches, fps=batch.materialize())


def test_generator_news_at_full_width(news_batch):
    """K1 >= 1, K2 >= 2 with one period-amplitude launch; one news group of
    the batch, the schema's shapes and dtypes, finite; each materialized
    fingerprint of the schema's shapes."""
    from sonido_sonar_tpu_torch.utils.convert import features_to_numpy, flatten_features

    lc = news_batch.launches
    assert lc["K1"] >= 1 and lc["K2"] >= 2 and lc["K2amp"] >= 1, lc
    (ct, idxs, feats), = news_batch.batch.groups
    assert ct.value == "news" and len(idxs) == FULL_B
    schema = C.news_schema(FULL_B, N_FULL)
    check_surface("generator news", flatten_features(feats), schema, NEWS_INTS)
    one = features_to_numpy(news_batch.fps[-1].features)
    for k, shape in schema.items():
        assert one[k].shape == shape[1:], f"materialized {k}: {one[k].shape}"


def test_music_program_at_full_width(clips):
    out, launches = counted(lambda: pipeline.batched_music_extractor_features(clips.pcm, SR, WINDOW, HOP))
    assert {k: launches[k] for k in ("K1", "K4", "K9")} == {"K1": 2, "K4": 3, "K9": 1}, launches
    check_surface("music program", out, C.music_schema(FULL_B, N_FULL), MUSIC_INTS)


def test_speech_extractor_at_full_width(clips):
    out = pipeline.batched_speech_extractor_features(clips.pcm, SR, WINDOW, HOP)
    check_surface("speech extractor", out, {"pitch": (FULL_B, (N_FULL - 1024) // 512 + 1)},
                  {"formant_count": torch.int32, "pause_count": torch.int32, "is_speech": torch.bool})


def _small_clips():
    return torch.cat([parity.harmonic_clips(1, SR, SEED + 8), parity.voiced_pcm(1, SR, SEED + 9)])


@pytest.mark.parametrize("label,strict", [("news", True), ("music", False)])
def test_generator_card_against_cpu(card, clips, label, strict):
    from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator
    from sonido_sonar_tpu_torch.utils.convert import features_to_numpy

    small = _small_clips()
    g = FingerprintGenerator(clips.cfg, strict_reference_routing=strict)
    on_card = g.generate_fingerprints_batch(_audios(small, label), pcm_matrix=small.to(card.dev))
    on_cpu = g.generate_fingerprints_batch(_audios(small, label), pcm_matrix=small)
    for i, (fc, fh) in enumerate(zip(on_card, on_cpu)):
        require(parity.check_extracted(features_to_numpy(fc.features), features_to_numpy(fh.features), SR,
                                       WINDOW, near_zero=C.near_zero_for(small[i], label == "music"), n_samples=SR),
                f"generator {label} (strict={strict}) [2, {SR}] row {i}, card vs CPU")


@pytest.mark.parametrize("sr", [SR, 16000])
def test_music_program_card_against_cpu(card, sr):
    """At 16 kHz the zero-crossing rate by the exact gate."""
    x = _small_clips() if sr == SR else parity.harmonic_clips(2, 16000, SEED + 8, 16000)
    on_card = {k: np32(v) for k, v in pipeline.batched_music_extractor_features(x.to(card.dev), sr).items()}
    on_cpu = {k: v.numpy() for k, v in pipeline.batched_music_extractor_features(x, sr).items()}
    require(parity.check_extracted(on_card, on_cpu, sr, WINDOW, near_zero=C.near_zero_for(x, True),
                                   n_samples=sr, chord_margin=C.chord_margin(on_cpu["chroma"])),
            f"music program [2, {sr}], card vs CPU")


# -- the extractor class compositions and STFTStreamer ----------------------------

CLASSES = ["sports", "mixed", "speech", "music"]


def _classes(cfg):
    from sonido_sonar_tpu_torch.config.config import ContentType
    from sonido_sonar_tpu_torch.extractors import (
        MixedFeatureExtractor, MusicFeatureExtractor, SpeechFeatureExtractor, SportsFeatureExtractor,
    )
    from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator

    gen = FingerprintGenerator(cfg, strict_reference_routing=False)
    return gen, {  # on the generator's feature config of each content type
        "speech": SpeechFeatureExtractor(gen._feature_config_for(ContentType.NEWS, SR), is_news=True),
        "music": MusicFeatureExtractor(gen._feature_config_for(ContentType.MUSIC, SR)),
        "sports": SportsFeatureExtractor(gen._feature_config_for(ContentType.SPORTS, SR)),
        "mixed": MixedFeatureExtractor(gen._feature_config_for(ContentType.MIXED, SR)),
    }


def _compose(ext, x, sr=SR):
    from sonido_sonar_tpu_torch.ops.stft import stft

    return ext.extract_features(stft(x, WINDOW, HOP, sample_rate=sr), x, sr)


@pytest.mark.parametrize("label", CLASSES)
def test_composition_at_full_width(clips, label):
    """The generator under non-strict routing on sports- and mixed-labelled
    batches, the speech and music compositions over `stft`: the launches
    each must show at least, the schema's shapes and dtypes, finite; the
    generator's materialized fingerprints (and sports' per-clip
    excitement lists on each)."""
    from sonido_sonar_tpu_torch.utils.convert import features_to_numpy, flatten_features

    gen, classes = _classes(clips.cfg)
    b, n, t = FULL_B, N_FULL, T_FRAMES
    news = C.news_schema(b, n)
    onsets = {"temporal_features.onset_mask": torch.bool}
    schema, ints = {
        "sports": ({k: v for k, v in news.items() if not k.startswith("speech_features.")}, onsets),
        "mixed": ({**news, "chroma_features": (b, t, 12)}, NEWS_INTS),
        "speech": (news, NEWS_INTS),
        "music": (C.music_class_schema(b, n), onsets),
    }[label]
    need = {"sports": {"K2": 1}, "mixed": {"K2": 2, "K2amp": 1}, "speech": {"K2": 2, "K2amp": 1},
            "music": {"K1": 1, "K4": 1}}[label]
    if label in ("sports", "mixed"):
        audios = _audios(clips.pcm, label)
        out, launches = counted(lambda: gen.generate_fingerprints_batch(audios, pcm_matrix=clips.pcm,
                                                                        materialize=False))
    else:
        out, launches = counted(lambda: _compose(classes[label], clips.pcm))
    assert all(launches[k] >= least for k, least in need.items()), f"{launches}, needs {need}"
    feats = out
    if label in ("sports", "mixed"):
        (ct, idxs, feats), = out.groups
        assert ct.value == label and len(idxs) == b and feats.metadata["extractor_type"] == label
    check_surface(f"{label} composition", flatten_features(feats), schema, ints)
    if label in ("sports", "mixed"):
        fps = out.materialize()
        one = features_to_numpy(fps[-1].features)
        for k, shape in schema.items():
            assert one[k].shape == shape[1:], f"materialized {label} {k}: {one[k].shape}"
        if label == "sports":
            for key in ("excitement_variance", "excitement_entropy"):
                vals = feats.metadata[key]
                assert len(vals) == b and np.isfinite(vals).all()
                assert all(fp.features.metadata[key] == vals for fp in fps), key


def _hold_extracted(got, ref, label, x, sr, what):
    from sonido_sonar_tpu_torch.ops.filters import dc_removal, pre_emphasis_for_content
    from sonido_sonar_tpu_torch.utils.convert import features_to_numpy

    if label == "music":
        pre = pre_emphasis_for_content(dc_removal(x), "music").numpy()
        near = parity.near_zero_frames(pre, WINDOW, HOP, 0.0, parity.DC_NEAR_ZERO)
    else:
        near = parity.near_zero_frames(x.numpy(), WINDOW, HOP, 0.96 if label == "sports" else 0.97)
    require(parity.check_extracted(features_to_numpy(got), features_to_numpy(ref), sr, WINDOW,
                                   near_zero=near, n_samples=x.shape[-1]), what)
    require(parity.check_metadata(got.metadata, ref.metadata), what + ", metadata")


def _class_small():
    return torch.cat([parity.voiced_pcm(1, SR, SEED + 10), parity.harmonic_clips(1, SR, SEED + 11)])


@pytest.mark.parametrize("label", CLASSES)
def test_composition_card_against_cpu(card, clips, label):
    ext = _classes(clips.cfg)[1][label]
    small = _class_small()
    _hold_extracted(_compose(ext, small.to(card.dev)), _compose(ext, small), label, small, SR,
                    f"{label} composition [2, {SR}], card vs CPU")


@pytest.mark.parametrize("label", ["speech", "music"])
def test_program_against_its_composition_on_the_card(card, clips, label):
    ext = _classes(clips.cfg)[1][label]
    small = _class_small()
    _hold_extracted(ext.extract_features_from_pcm(small.to(card.dev), SR), _compose(ext, small.to(card.dev)),
                    label, small, SR, f"{label} program against its composition [2, {SR}] on the card")


def test_music_composition_at_16k_card_against_cpu(card, clips):
    ext = _classes(clips.cfg)[1]["music"]
    x = parity.harmonic_clips(2, 16000, SEED + 8, 16000)
    _hold_extracted(_compose(ext, x.to(card.dev), 16000), _compose(ext, x, 16000), "music", x, 16000,
                    "music composition [2, 16000] at 16 kHz, card vs CPU (ZCR exact)")


@pytest.mark.parametrize("mode,w,hop,block", [("legacy", WINDOW, HOP, 0), ("block", WINDOW, HOP, 64),
                                              ("stft_route_4096", 4096, 1024, 0)])
def test_stft_streamer(card, mode, w, hop, block):
    """A 60 s stream pushed in 1 s chunks: K1 launched once a result
    (legacy) or a block, the concatenated magnitudes against stft of the
    whole signal; a 4096-window streamer takes the stft route, no K1."""
    from sonido_sonar_tpu_torch.ops.stft import STFTStreamer, stft

    stream = parity.synth_pcm(1, 60 * SR, SEED + 12, SR)[0].numpy()
    streamer = STFTStreamer(w, hop, sample_rate=SR, block_frames=block)
    assert streamer.route == ("stft" if w > 2048 else "k1")
    whole = stft(torch.from_numpy(stream).to(card.dev), w, hop, sample_rate=SR).magnitude

    def push_all():
        parts = [streamer.push(stream[i:i + SR]) for i in range(0, len(stream), SR)]
        return parts + [streamer.flush()]

    parts, launches = counted(push_all)
    mags = [r.magnitude for r in parts if r is not None]
    got = torch.cat(mags)
    assert got.shape == whole.shape
    want_k1 = len(mags) if streamer.route == "k1" else 0
    if block:
        want_k1 = sum(m.shape[0] // block + (m.shape[0] % block > 0) for m in mags)
    assert launches["K1"] == want_k1
    assert float((got - whole).abs().max()) <= parity.MAG_ATOL_SCALE * float(whole.abs().max())


# -- the fleet and LatencyMonitor ---------------------------------------------------

@pytest.fixture(scope="module")
def fleet(card):
    """FleetMonitor (44.1 kHz, 1024/256) of 64 streams x 60 s windows, a
    30 s budget, measure_batch 32; 48 streams carry the source delayed
    0.1-3 s x 0.9, 16 (8 per sub-batch) an unrelated signal, so the 0.7
    gate fails and DTW runs in both sub-batches. Both sides pushed from
    card tensors, then measure_all(refine=True) with its launches."""
    from sonido_sonar_tpu_torch import FleetMonitor
    from sonido_sonar_tpu_torch.config.config import FeatureConfig

    lags = C.dtw_draws()["lags"]
    src, cdn = C.fleet_streams(lags, card.dev)
    cfg = FeatureConfig(sample_rate=SR, window_size=WINDOW, hop_size=HOP)
    mon = FleetMonitor(cfg, n_streams=C.FLEET_STREAMS, window_seconds=C.ALIGN_SECONDS,
                       max_lag_seconds=C.ALIGN_BUDGET, measure_batch=C.FLEET_BATCH, device=card.dev)
    mon.push_source_all(src)
    mon.push_cdn_all(cdn)
    res, launches = counted(lambda: mon.measure_all(refine=True))
    return types.SimpleNamespace(cfg=cfg, lags=lags, src=src, cdn=cdn, mon=mon, res=res, launches=launches,
                                 related=[i for i in range(C.FLEET_STREAMS) if i not in C.UNRELATED])


def test_fleet_at_full_width(fleet):
    """The DTW kernels in both sub-batches; every related stream within
    one hop of its lag; every measurement finite."""
    assert fleet.launches["fill"] >= 2 and fleet.launches["backtrack"] >= 2, fleet.launches
    off = np.array([abs(fleet.res[i].latency_s - fleet.lags[i] / SR) for i in fleet.related])
    assert (off <= HOP / SR).all(), [fleet.related[k] for k in np.nonzero(off > HOP / SR)[0]]
    assert all(np.isfinite([m.latency_s, m.confidence, m.similarity]).all() for m in fleet.res)


def test_fleet_pushes_of_the_same_samples_leave_the_windows(fleet):
    """Both sides pushed again, whole windows, from card tensors (a device
    copy) and from numpy (staged through pinned memory)."""
    kept = (fleet.mon._src.buf.clone(), fleet.mon._cdn.buf.clone())
    for ps, pc in ((fleet.src, fleet.cdn), (fleet.src.cpu().numpy(), fleet.cdn.cpu().numpy())):
        fleet.mon.push_source_all(ps)
        fleet.mon.push_cdn_all(pc)
    assert torch.equal(fleet.mon._src.buf, kept[0]) and torch.equal(fleet.mon._cdn.buf, kept[1])


@pytest.mark.parametrize("side", ["gate passes", "gate fails"])
def test_latency_monitor_through_and_past_the_gate(card, fleet, side):
    """LatencyMonitor at 60 s / 30 s (B = 1) on a fleet row on each side
    of the 0.7 gate: numpy pushes leave the card tensors' windows, the
    fill runs only past the gate, the method is the fleet's, a related
    row within one hop."""
    from sonido_sonar_tpu_torch import LatencyMonitor

    res = fleet.res
    rows = ([i for i in fleet.related if res[i].method.startswith("energy_correlation")] if side == "gate passes"
            else [i for i in C.UNRELATED if not res[i].method.startswith("energy_correlation")])
    assert rows, f"no fleet stream on this side of the gate: {[m.method for m in res]}"
    row = rows[0]
    mon = LatencyMonitor(fleet.cfg, window_seconds=C.ALIGN_SECONDS, max_lag_seconds=C.ALIGN_BUDGET,
                         device=card.dev)
    mon.push_source(fleet.src[row])
    mon.push_cdn(fleet.cdn[row])
    mon.push_source(fleet.src[row].cpu().numpy())
    mon.push_cdn(fleet.cdn[row].cpu().numpy())
    assert torch.equal(mon._src.buf, fleet.src[row]) and torch.equal(mon._cdn.buf, fleet.cdn[row])
    m, launches = counted(lambda: mon.measure(refine=True))
    assert (row in C.UNRELATED) == (launches["fill"] > 0) and m.method == res[row].method, (m.method, launches)
    if row not in C.UNRELATED:
        assert abs(m.latency_s - fleet.lags[row] / SR) <= HOP / SR


def test_small_fleet_and_align_audio_files_card_against_cpu(card):
    """A 4-stream fleet (12 s, 3 s budget) and align_audio_files: offsets
    and methods equal, scores within ALIGN_SCORE_ATOL."""
    from sonido_sonar_tpu_torch import FleetMonitor
    from sonido_sonar_tpu_torch.config.config import FeatureConfig
    from sonido_sonar_tpu_torch.extractors.alignment import AlignmentExtractor

    cfg = FeatureConfig(sample_rate=SR, window_size=WINDOW, hop_size=HOP)
    s_src, s_cdn = parity.alignment_streams(4, 12, SR, [int(0.3 * SR), -int(0.45 * SR), int(1.1 * SR), 0],
                                            SEED + 12, unrelated=(3,))
    per_device = []
    for d in (card.dev, torch.device("cpu")):
        f = FleetMonitor(cfg, n_streams=4, window_seconds=12.0, max_lag_seconds=3.0, measure_batch=4, device=d)
        f.push_source_all(s_src)
        f.push_cdn_all(s_cdn)
        a = AlignmentExtractor(cfg, max_lag_seconds=2.0).align_audio_files(
            s_src[0, : 5 * SR].to(d), s_cdn[0, : 5 * SR].to(d), SR)
        per_device.append((f.measure_all(refine=True), a))
    (card_res, card_a), (cpu_res, cpu_a) = per_device
    worst = 0.0
    for i, (c, h) in enumerate(zip(card_res, cpu_res)):
        assert c.method == h.method and abs(c.latency_s - h.latency_s) <= 1e-6, f"stream {i}: {c} != {h}"
        worst = max(worst, abs(c.confidence - h.confidence), abs(c.similarity - h.similarity))
    for key in ("offset_confidence", "alignment_similarity", "alignment_quality"):
        worst = max(worst, abs(getattr(card_a, key) - getattr(cpu_a, key)))
    assert card_a.temporal_offset == cpu_a.temporal_offset and card_a.method == cpu_a.method
    assert worst <= parity.ALIGN_SCORE_ATOL


def test_hybrid_host_reads_under_sync_debug_mode(card, fleet):
    """One host read (the gate vector) for batched_hybrid_align, none for
    batched_hybrid_align_device; the same offsets and methods."""
    from sonido_sonar_tpu_torch.ops.stats.batched_alignment import (
        batched_hybrid_align, batched_hybrid_align_device,
    )
    from sonido_sonar_tpu_torch.ops.temporal import short_time_energy

    pairs = [0, C.UNRELATED[0]]
    e2 = (short_time_energy(fleet.src[pairs], WINDOW, HOP).contiguous(),
          short_time_energy(fleet.cdn[pairs], WINDOW, HOP).contiguous())
    max_lag = int(C.ALIGN_BUDGET * SR) // HOP
    syncs = {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for name, fn in (("device", batched_hybrid_align_device), ("gated", batched_hybrid_align)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn(*e2, max_lag, HOP, SR)
            syncs[name] = (sum("synchroniz" in str(w.message) for w in caught), out)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (syncs["device"][0], syncs["gated"][0]) == (0, 1)
    dev_out, gated_out = syncs["device"][1], syncs["gated"][1]
    assert torch.equal(dev_out["offset_samples"], gated_out["offset_samples"])
    assert torch.equal(dev_out["method"], gated_out["method"])


# -- the comparator and a corpus of 262,144 rows -------------------------------------

def test_comparator_matrix_and_packed_corpus(card, news_batch):
    """The batch's packed matrix [128, 70] float32 on the card against the
    host packer (scaled by max(|x|, 1)); PackedCorpus.from_batch's content
    codes equal PackedCorpus.build's."""
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC

    m = news_batch.batch.comparator_matrix(13)
    torch.cuda.synchronize()
    assert tuple(m.shape) == (FULL_B, DC.layout_size(13)) and m.dtype == torch.float32 and m.is_cuda
    assert bool(torch.isfinite(m).all())
    host, _ = DC.comparator_matrix(news_batch.fps, 13)
    err = float((np.abs(np32(m) - host) / np.maximum(np.abs(host), 1.0)).max())
    assert err <= parity.COMPARATOR_PACK_SCALED_ATOL, err
    packed = DC.PackedCorpus.from_batch(news_batch.batch, 13)
    built = DC.PackedCorpus.build(news_batch.fps, 13, device=card.dev)
    assert torch.equal(packed.codes, built.codes) and packed.codes.dtype == torch.int32


def test_generate_and_pack_launches(news_batch):
    """bench.py:396-493's generate-batch shape, fenced on the matrix."""
    _, lc = counted(lambda: news_batch.step().comparator_matrix(13))
    assert lc["K1"] >= 1 and lc["K2"] >= 2 and lc["K2amp"] >= 1, lc


def _comparator(dev):
    from sonido_sonar_tpu_torch.config.config import ComparisonConfig
    from sonido_sonar_tpu_torch.fingerprint.comparison import FingerprintComparator

    return FingerprintComparator(ComparisonConfig(similarity_threshold=0.0), device=dev)


def test_search_corpus_card_against_cpu(card, news_batch):
    """Four queries from the batch: card and CPU rank the same ids."""
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC

    packed = DC.PackedCorpus.from_batch(news_batch.batch, 13)
    on_cpu = DC.PackedCorpus(packed.fingerprints, packed.matrix.cpu(), packed.codes.cpu(), 13)
    comp, fps = _comparator(card.dev), news_batch.fps
    for qi in np.linspace(0, FULL_B - 1, 4).astype(int):
        got = comp.search_corpus(fps[qi], packed, max_results=12)
        want = comp.search_corpus(fps[qi], on_cpu, max_results=24)
        C.same_ranking(f"search_corpus, query {qi}", [mm.fingerprint.id for mm in got],
                       [mm.similarity.overall_similarity for mm in got], [mm.fingerprint.id for mm in want],
                       [mm.similarity.overall_similarity for mm in want])


W_FEATURES = np.array([0.35, 0.25, 0.10, 0.20, 0.10, 0.10], np.float32)
KW = dict(num_mfcc_coeffs=13)


@pytest.fixture(scope="module")
def corpus(card):
    """card_support.corpus_rows at the comparator's layout, on the card and
    the CPU, and the generator's next draws in their order: the random
    query, 64 more queries, then the quality chain's series [4097, 2, T],
    lengths, feature availability and durations."""
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC

    d = DC.layout_size(13)
    rows, src, dups, rng = C.corpus_rows(d)
    ns = types.SimpleNamespace(rows=rows, src=src, dups=dups, X=torch.from_numpy(rows).to(card.dev),
                               X_cpu=torch.from_numpy(rows), match=torch.ones(C.CORPUS_ROWS, dtype=torch.bool))
    ns.qv = rng.standard_normal(d).astype(np.float32)
    ns.qmat = rng.standard_normal((64, d)).astype(np.float32)
    n = 4096
    ns.series = rng.uniform(200, 8000, (n + 1, 2, T_FRAMES)).astype(np.float32)
    ns.lens = rng.integers(T_FRAMES // 2, T_FRAMES + 1, (n + 1, 2)).astype(np.int32)
    ns.lens[1] = 1                                      # a one-frame series: skipped
    ns.series[2, 1] = 818.2999877929688                 # a constant series: skipped
    ns.avail = (rng.random((n + 1, 6)) < 0.9).astype(np.float32)
    ns.dur = rng.uniform(5, 60, n + 1).astype(np.float32)
    return ns


def test_batched_similarity_card_against_cpu(card, corpus):
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC

    n = 4096
    got = DC.batched_similarity(corpus.qv, corpus.X[:n], W_FEATURES, corpus.match[:n].to(card.dev), **KW)
    want = DC.batched_similarity(corpus.qv, corpus.X_cpu[:n], W_FEATURES, corpus.match[:n], **KW)
    err = max(float((got[k].cpu() - want[k]).abs().max()) for k in ("overall", "confidence", "feature_sims"))
    assert err <= parity.COMPARATOR_HOST_ATOL
    assert all(torch.equal(got[k].cpu(), want[k]) for k in ("match_class", "feature_present"))


def test_topk_similarity_random_query(card, corpus):
    """The recipe's 2-vector cosines crowd a random query's top scores
    within ~1e-7 of each other, so runs within the bound compare as sets."""
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC

    got = DC.topk_similarity(corpus.qv, corpus.X, W_FEATURES, corpus.match.to(card.dev), k=C.TOP_K, **KW)
    want = DC.topk_similarity(corpus.qv, corpus.X_cpu, W_FEATURES, corpus.match, k=2 * C.TOP_K, **KW)
    C.same_ranking("topk_similarity, random query", got["index"].tolist(), got["overall"].tolist(),
                   want["index"].tolist(), want["overall"].tolist())


def test_topk_similarity_tied_rows_lowest_index_first(card, corpus):
    """The duplicated row: 65 exactly equal scores, lowest index first."""
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC

    q = corpus.rows[corpus.src]
    got = DC.topk_similarity(q, corpus.X, W_FEATURES, corpus.match.to(card.dev), k=C.TOP_K, **KW)
    want = DC.topk_similarity(q, corpus.X_cpu, W_FEATURES, corpus.match, k=C.TOP_K, **KW)
    tied = sorted([corpus.src, *corpus.dups.tolist()])[:C.TOP_K]
    assert got["index"].tolist() == want["index"].tolist() == tied
    assert len(set(got["overall"].tolist())) == 1


def test_search_corpus_stream_ranks_as_search_corpus(card, news_batch, corpus):
    """The public search over the corpus (placeholder fingerprints for the
    random rows, real queries from the batch): search_corpus_stream at
    depth 4 ranks the ids search_corpus does."""
    from sonido_sonar_tpu_torch.config.config import ContentType
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC
    from sonido_sonar_tpu_torch.fingerprint.generator import AudioFingerprint

    shells = [AudioFingerprint(f"r{i}", "", ContentType.NEWS, 0.0, 30.0, SR, HOP, 1, None)
              for i in range(C.CORPUS_ROWS)]
    codes = torch.full((C.CORPUS_ROWS,), DC.content_code(ContentType.NEWS), dtype=torch.int32, device=card.dev)
    big = DC.PackedCorpus(shells, corpus.X, codes, 13)
    comp = _comparator(card.dev)
    queries = [news_batch.fps[i] for i in range(0, FULL_B, FULL_B // 8)]
    stream = [queries[i % len(queries)] for i in range(32)]
    streamed = list(comp.search_corpus_stream(stream, big, max_results=12, depth=4))
    for q, got in zip(stream[:len(queries)], streamed):
        want = comp.search_corpus(q, big, max_results=12)
        assert [mm.fingerprint.id for mm in got] == [mm.fingerprint.id for mm in want]


def test_topk_similarity_multi_rows_equal_topk_similarity(card, corpus):
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC

    wmat = np.tile(W_FEATURES, (64, 1))
    multi = DC.topk_similarity_multi(corpus.qmat, corpus.X, wmat, np.zeros(64, np.int32),
                                     torch.zeros(C.CORPUS_ROWS, dtype=torch.int32, device=card.dev), k=C.TOP_K, **KW)
    match = corpus.match.to(card.dev)
    for i in range(64):
        single = DC.topk_similarity(corpus.qmat[i], corpus.X, W_FEATURES, match, k=2 * C.TOP_K, **KW)
        C.same_ranking(f"topk_similarity_multi row {i}", multi["index"][i].tolist(), multi["overall"][i].tolist(),
                       single["index"].tolist(), single["overall"].tolist())


def test_batched_similarity_detailed_card_against_cpu(card, corpus):
    """The quality chain at C = 4,096 with 5,164-frame series (a one-frame
    and a constant series among them)."""
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC

    n, c = 4096, corpus
    outs = {}
    for where, d in (("card", card.dev), ("cpu", torch.device("cpu"))):
        def on(a, d=d):
            return torch.from_numpy(np.ascontiguousarray(a)).to(d)

        out = DC.batched_similarity_detailed(
            c.rows[c.src], on(c.rows[:n]), W_FEATURES, on(np.ones(n, bool)), c.avail[0], on(c.avail[1:]),
            np.float32(c.dur[0]), on(c.dur[1:]), c.series[0], on(c.series[1:]), c.lens[0], on(c.lens[1:]), **KW)
        outs[where] = {k: v.cpu() for k, v in out.items()}
    for k in outs["cpu"]:
        e = float((outs["card"][k].float() - outs["cpu"][k].float()).abs().max())
        limit = (parity.COMPARATOR_COHERENCE_ATOL if k == "spectral_coherence" else
                 parity.COMPARATOR_QUALITY_ATOL if k in ("temporal_alignment", "noise_level",
                                                          "dynamic_range_match", "confidence")
                 else parity.COMPARATOR_HOST_ATOL)
        assert e <= limit, f"{k}: card vs CPU {e:.3g} > {limit}"


def test_batched_similarity_refuses_tf32(card, corpus):
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC

    n = 4096
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ValueError):
            DC.batched_similarity(corpus.qv, corpus.X[:n], W_FEATURES, corpus.match[:n].to(card.dev), **KW)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# -- the music-analysis ops ----------------------------------------------------------

TONAL_CLIPS = 4   # clips whose tonal surface is held to the CPU
PITCH_METHODS = ("yin", "acf", "nsdf", "cepstrum", "hps", "zcr", "peaks", "yin+acf")


def test_music_program_with_cqt_and_hpcp(clips):
    """K1 twice, K4 three times, K9 once with the options off and on; the
    schema with chroma_cqt [128, 2568, 12] and hpcp [128, 5164, 12];
    unit-sum CQT and unit-energy HPCP rows."""
    for label, kw in (("off", {}), ("on", dict(enable_cqt=True, enable_hpcp=True))):
        out, lc = counted(lambda: pipeline.batched_music_extractor_features(clips.pcm, SR, WINDOW, HOP, **kw))
        assert (lc["K1"], lc["K4"], lc["K9"], sum(lc.values())) == (2, 3, 1, 6), f"options {label}: {lc}"
    schema = {**C.music_schema(FULL_B, N_FULL), "chroma_cqt": (FULL_B, (N_FULL - 8192) // 512 + 1, 12),
              "hpcp": (FULL_B, T_FRAMES, 12)}
    check_surface("music program with CQT and HPCP", out, schema, MUSIC_INTS)
    cqt_sum = out["chroma_cqt"].sum(-1)
    hpcp_norm = torch.linalg.vector_norm(out["hpcp"], dim=-1)
    assert bool((cqt_sum > 0).all()) and float((cqt_sum - 1).abs().max()) <= 1e-5
    assert float((hpcp_norm[hpcp_norm > 0] - 1).abs().max()) <= 1e-5


@pytest.mark.parametrize("sr", [SR, 16000])
def test_music_cqt_hpcp_card_against_cpu(card, sr):
    small = parity.harmonic_clips(2, sr, SEED + 8, sr, 196.0)
    kw = dict(enable_cqt=True, enable_hpcp=True)
    on_card = {k: np32(v) for k, v in pipeline.batched_music_extractor_features(small.to(card.dev), sr, **kw).items()}
    on_cpu = {k: v.numpy() for k, v in pipeline.batched_music_extractor_features(small, sr, **kw).items()}
    require(parity.check_extracted(on_card, on_cpu, sr, WINDOW, near_zero=C.near_zero_for(small, True),
                                   n_samples=sr, chord_margin=C.chord_margin(on_cpu["chroma"])),
            f"music program with CQT and HPCP [2, {sr}], card vs CPU")


def _same_chords(what, got, ref) -> None:
    """The same chord frame by frame, or one whose CPU score is within
    MUSIC_TIE of the CPU's best."""
    for t, (g, r) in enumerate(zip(got, ref, strict=True)):
        if g.chord != r.chord:
            score = {(c.root, c.quality): c.score for c in r.candidates}.get((g.root, g.quality))
            assert score is not None and r.candidates[0].score - score <= parity.MUSIC_TIE, \
                f"{what} frame {t}: {g.chord} on the {r.chord} on the CPU"


def test_keys_and_chords_card_against_cpu(card):
    """KeyEstimator, ChordDetector and ChordProgressionAnalyzer over the
    music program's chroma of 4 clips whose chords and key change (the
    keys, modulations and chord changes must not be all alike)."""
    from sonido_sonar_tpu_torch.ops import tonal

    chroma = pipeline.batched_music_extractor_features(C.chord_clips(TONAL_CLIPS, FULL_SECONDS).to(card.dev), SR,
                                                       WINDOW, HOP)["chroma"]
    keys = [tonal.KeyEstimator(device=card.dev).estimate_key_sequence(c) for c in chroma]
    progs = [tonal.ChordProgressionAnalyzer(device=card.dev).analyze(c) for c in chroma]
    for i, c in enumerate(chroma.cpu()):
        what = f"clip {i}, card vs CPU"
        got, ref = keys[i], tonal.KeyEstimator(device="cpu").estimate_key_sequence(c)
        require(parity_close("key correlations", got.all_correlations, ref.all_correlations, parity.MUSIC_RTOL,
                             parity.MUSIC_ATOL), what)
        if ref.confidence > parity.MUSIC_TIE:
            assert (got.key, got.mode) == (ref.key, ref.mode), what
        assert got.stability == ref.stability, what
        assert [m["window"] for m in got.modulations] == [m["window"] for m in ref.modulations], what
        det = tonal.ChordDetector(device=card.dev).detect_sequence(chroma[i])
        ref_det = tonal.ChordDetector(device="cpu").detect_sequence(c)
        _same_chords(what, det, ref_det)
        if all(g.chord == r.chord for g, r in zip(det, ref_det)):
            assert progs[i] == tonal.ChordProgressionAnalyzer(device="cpu").analyze(c), what
    assert len({f"{k.key} {k.mode}" for k in keys}) >= 2 and sum(len(k.modulations) for k in keys)
    assert all(p["num_changes"] for p in progs)


@pytest.fixture(scope="module")
def clip_mag(clips):
    """K1's magnitudes of the clips, [128, 5164, 513]."""
    return hopper_stft.stft_magnitude_hopper(clips.pcm, WINDOW, HOP)[0]


@pytest.mark.parametrize("method", PITCH_METHODS)
def test_pitch_detector_card_against_cpu(card, clips, method):
    """detect_track at full width on the 1024/512; rows 0-3 held to
    the CPU (YIN by the pitch gates, the others by their decisions)."""
    from sonido_sonar_tpu_torch.ops import tonal

    got = tonal.PitchDetector(SR, method, device=card.dev).detect_track(clips.pcm, PITCH_WINDOW, PITCH_HOP)
    p = np32(got.pitch)
    assert p.shape == (FULL_B, T_PITCH) and np.isfinite(p).all()
    ref = tonal.PitchDetector(SR, method, device="cpu").detect_track(clips.pcm[:TONAL_CLIPS].cpu(),
                                                                     PITCH_WINDOW, PITCH_HOP)
    check = parity.check_pitch if method == "yin" else parity.check_pitch_decisions
    require(check(p[:TONAL_CLIPS], np32(got.confidence)[:TONAL_CLIPS], ref.pitch.numpy(), ref.confidence.numpy()),
            f"PitchDetector({method!r}).detect_track, card vs CPU")


@pytest.mark.parametrize("name", ["analyze_spectrum", "spectral_snr"])
def test_harmonic_ratio_card_against_cpu(card, clip_mag, name):
    from sonido_sonar_tpu_torch.ops import tonal

    got = getattr(tonal.HarmonicRatioAnalyzer(SR, device=card.dev), name)(clip_mag, WINDOW)
    ref = getattr(tonal.HarmonicRatioAnalyzer(SR, device="cpu"), name)(clip_mag[:TONAL_CLIPS].cpu(), WINDOW)
    require(parity_close(name, np32(got)[:TONAL_CLIPS], ref.numpy(), *parity.MUSIC_DB_TOL),
            f"HarmonicRatioAnalyzer.{name}, card vs CPU")


def test_inharmonicity_card_against_cpu(card, clip_mag):
    from sonido_sonar_tpu_torch.ops import tonal

    f0 = torch.full(clip_mag.shape[:-1], 196.0, device=card.dev)
    inh = tonal.analyze_inharmonicity(clip_mag, f0, SR, WINDOW)
    ref = tonal.analyze_inharmonicity(clip_mag[:TONAL_CLIPS].cpu(), f0[:TONAL_CLIPS].cpu(), SR, WINDOW)
    assert np.array_equal(np32(inh.num_partials)[:TONAL_CLIPS], ref.num_partials.numpy())
    require(parity_close("inharmonicity", np32(inh.inharmonicity)[:TONAL_CLIPS], ref.inharmonicity.numpy(),
                         parity.MUSIC_RTOL, parity.MUSIC_ATOL), "analyze_inharmonicity, card vs CPU")


@pytest.mark.parametrize("label", ["yin track", "4-8 Hz vibrato"])
def test_vibrato_card_against_cpu(card, clips, label):
    """The YIN track of the clips, and tracks with 4-8 Hz vibrato at the
    same frame rate (each must read as vibrato)."""
    from sonido_sonar_tpu_torch.ops import tonal

    if label == "yin track":
        track = tonal.PitchDetector(SR, "yin", device=card.dev).detect_track(clips.pcm, PITCH_WINDOW, PITCH_HOP).pitch
    else:
        t = torch.arange(T_PITCH, device=card.dev) / (SR / PITCH_HOP)
        track = 200.0 + 8.0 * torch.sin(2 * np.pi * torch.linspace(4.0, 8.0, FULL_B, device=card.dev)[:, None] * t)
    got = tonal.analyze_vibrato(track, PITCH_HOP, SR)
    ref = tonal.analyze_vibrato(track[:TONAL_CLIPS].cpu(), PITCH_HOP, SR)
    assert np.array_equal(np32(got["has_vibrato"])[:TONAL_CLIPS], ref["has_vibrato"].numpy())
    for k in ("vibrato_rate_hz", "vibrato_extent_hz"):
        require(parity_close(k, np32(got[k])[:TONAL_CLIPS], ref[k].numpy(), *parity.VIBRATO_TOL),
                f"analyze_vibrato ({label}) {k}, card vs CPU")
    if label != "yin track":
        assert bool(got["has_vibrato"].all()), "a 4-8 Hz vibrato track reads as none"


def test_harmonic_tracking_card_against_cpu(card, clip_mag):
    from sonido_sonar_tpu_torch.ops import tracking

    got = tracking.HarmonicTracking(SR, device=card.dev).process_magnitude_spectrogram(clip_mag[0], WINDOW)
    ref = tracking.HarmonicTracking(SR, device="cpu").process_magnitude_spectrogram(clip_mag[0].cpu(), WINDOW)
    assert [vars(x) for x in got.tracks] == [vars(x) for x in ref.tracks]


# -- the op surface at B=128 x 30 s, held to the CPU on 2 clips -----------------------

ROWS = 2
CUSTOM_BANDS = (200.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0, 16000.0)
SURFACE_SHIFT = 5   # semitones the chord clip's chroma is transposed
SURFACE_OPS = (
    [f"normalize_{m}" for m in ("zscore", "minmax", "energy", "peak", "rms", "quantile", "robust", "adaptive")]
    + ["normalize_lufs"] + [f"resample_{m}" for m in ("linear", "cubic", "hermite", "lanczos")]
    + ["bandpass_q5", "adaptive_pre_emphasis", "hilbert_envelope", "peak_envelope", "crest_factor",
       "energy_statistics", "estimate_tempo_range", "detect_voice_activity", "lpc_residual",
       "detect_onsets_complex", "mel_spectrum", "bark_apply_filterbank", "spectral_contrast_custom_bands",
       "distance_matrix_js", "knn_corpus"]
    + [f"moments_{m}" for m in ("skewness", "kurtosis", "pearson_skewness", "bowley_skewness")]
    + ["histogram_shannon", "chroma_stats", "tonal_centroid", "tonnetz_point", "harmonic_tension", "consonance",
       "voice_leading_distance", "smooth_chroma", "tonnetz_trajectory"])
SEQUENCE_METHODS = ("direct", "binary", "smith_waterman", "dtw", "qmax", "oti")


@pytest.fixture(scope="module")
def surface(card):
    """The op surface's inputs: PCM [128, 30 s] (synth_pcm, seed SEED +
    38) and its first 2 rows on the CPU, the main path's MFCC and chroma
    of it, K1's magnitudes, a full stft's magnitude and phase, frames at
    1024/512, the search corpus, clip 0's spectral energy series and the
    spectral centroids; the chroma of one chord clip."""
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC
    from sonido_sonar_tpu_torch.ops import spectral, speech
    from sonido_sonar_tpu_torch.ops.framing import frame_signal
    from sonido_sonar_tpu_torch.ops.stft import stft

    pcm = parity.synth_pcm(FULL_B, N_FULL, SEED + 38, SR, card.dev)
    ns = types.SimpleNamespace(pcm=pcm, pcm_cpu=pcm[:ROWS].cpu())
    feats = pipeline.batched_fingerprint_features(pcm, sample_rate=SR, window_size=WINDOW, hop_size=HOP)
    ns.mfcc, ns.chroma = feats["mfcc"], feats["chroma"]
    ns.mag = hopper_stft.stft_magnitude_hopper(pcm, WINDOW, HOP)[0]
    ns.spec = stft(pcm, WINDOW, HOP, sample_rate=SR, return_phase=True)
    ns.frames = frame_signal(pcm, WINDOW, 512)
    ns.lpc = speech.lpc_analyze(pcm[0, :8192], SR, order=16).coefficients
    ns.corpus, ns.src, ns.dups, _ = C.corpus_rows(DC.layout_size(13))
    ns.series = ns.mag[0].sum(-1)
    ns.cent = spectral.spectral_centroid(ns.mag, SR)
    ns.q = pipeline.batched_fingerprint_features(C.chord_clips(1, FULL_SECONDS).to(card.dev), sample_rate=SR, window_size=WINDOW,
                     hop_size=HOP)["chroma"][0]
    return ns


def surface_ops(s) -> dict:
    """name -> (card call, CPU call, rtol, atol, the card rows compared)."""
    from sonido_sonar_tpu_torch.ops import chroma_analysis as CA
    from sonido_sonar_tpu_torch.ops import common, filters, mel, mfcc, spectral, speech, temporal
    from sonido_sonar_tpu_torch.ops.framing import frame_signal
    from sonido_sonar_tpu_torch.ops.stats import distance, entropy, moments

    first, whole = (lambda o: o[:ROWS]), (lambda o: o)
    pcm, cpu, mag, mag_cpu = s.pcm, s.pcm_cpu, s.mag, s.mag[:ROWS].cpu()
    ch, ch_cpu, cent, cent_cpu = s.chroma, s.chroma[:ROWS].cpu(), s.cent, s.cent[:ROWS].cpu()
    rt, at = parity.OPS_RTOL, parity.OPS_ATOL
    scan = f"scale:{parity.BLOCK_SCAN_F64_ATOL_SCALE}"
    ops = {}
    for m in ("zscore", "minmax", "energy", "peak", "rms", "quantile", "robust", "adaptive"):
        ops[f"normalize_{m}"] = (lambda m=m: common.normalize(pcm, m), lambda m=m: common.normalize(cpu, m),
                                 rt, 1e-5, first)
    ops["normalize_lufs"] = (lambda: common.normalize_lufs(pcm, -23.0, SR),
                             lambda: common.normalize_lufs(cpu, -23.0, SR), rt, 1e-5, first)
    for m in ("linear", "cubic", "hermite", "lanczos"):
        ops[f"resample_{m}"] = (lambda m=m: common.resample_signal(pcm, SR, 16000, m),
                                lambda m=m: common.resample_signal(cpu, SR, 16000, m), rt, 1e-5, first)
    ops["bandpass_q5"] = (lambda: filters.bandpass(pcm, 1000.0, 5.0, SR),
                          lambda: filters.bandpass(cpu, 1000.0, 5.0, SR), 0.0, scan, first)
    ops["adaptive_pre_emphasis"] = (lambda: filters.adaptive_pre_emphasis(pcm),
                                    lambda: filters.adaptive_pre_emphasis(cpu), 0.0, scan, first)
    ops["hilbert_envelope"] = (lambda: temporal.hilbert_envelope(pcm), lambda: temporal.hilbert_envelope(cpu),
                               0.0, "scale:1e-5", first)
    ops["peak_envelope"] = (lambda: temporal.peak_envelope(pcm), lambda: temporal.peak_envelope(cpu), 0.0, 0.0, first)
    ops["crest_factor"] = (lambda: temporal.crest_factor(pcm), lambda: temporal.crest_factor(cpu), rt, at, first)
    ops["energy_statistics"] = (lambda: temporal.energy_statistics(pcm, WINDOW, HOP),
                                lambda: temporal.energy_statistics(cpu, WINDOW, HOP), rt, 1e-5, first)
    ops["estimate_tempo_range"] = (lambda: temporal.estimate_tempo_range(pcm, SR),
                                   lambda: temporal.estimate_tempo_range(cpu, SR), rt, rt * 240.0, first)
    ops["detect_voice_activity"] = (lambda: spectral.detect_voice_activity(s.frames),
                                    lambda: spectral.detect_voice_activity(frame_signal(cpu, WINDOW, 512)),
                                    0.0, 0.0, first)
    ops["lpc_residual"] = (lambda: speech.lpc_residual(pcm, s.lpc), lambda: speech.lpc_residual(cpu, s.lpc.cpu()),
                           rt, 1e-5, first)
    ops["detect_onsets_complex"] = (
        lambda: temporal.detect_onsets_complex(s.spec.magnitude, s.spec.phase, HOP, SR),
        lambda: temporal.detect_onsets_complex(s.spec.magnitude[:ROWS].cpu(), s.spec.phase[:ROWS].cpu(), HOP, SR),
        0.0, 0.0, first)
    ops["mel_spectrum"] = (lambda: mfcc.mel_spectrum(mag, SR, WINDOW), lambda: mfcc.mel_spectrum(mag_cpu, SR, WINDOW),
                           rt, 1e-5, first)
    bark = mel.bark_filterbank(24, WINDOW, SR)
    ops["bark_apply_filterbank"] = (lambda: mel.apply_filterbank(mag * mag, bark),
                                    lambda: mel.apply_filterbank(mag_cpu * mag_cpu, bark), rt, 1e-5, first)
    ops["spectral_contrast_custom_bands"] = (
        lambda: spectral.spectral_contrast_custom_bands(mag, SR, CUSTOM_BANDS),
        lambda: spectral.spectral_contrast_custom_bands(mag_cpu, SR, CUSTOM_BANDS), rt, 1e-4, first)
    c0 = ch[0]
    ops["distance_matrix_js"] = (lambda: distance.distance_matrix(c0, c0, "js"),
                                 lambda: distance.distance_matrix(c0[:500].cpu(), c0.cpu(), "js"), rt, at,
                                 lambda o: o[:500])
    ops["knn_corpus"] = (
        lambda: distance.knn(torch.from_numpy(s.corpus[s.src]).to(pcm.device),
                             torch.from_numpy(s.corpus).to(pcm.device), C.TOP_K, "manhattan"),
        lambda: distance.knn(torch.from_numpy(s.corpus[s.src]), torch.from_numpy(s.corpus), C.TOP_K, "manhattan"),
        0.0, 0.0, whole)
    row_atol = [parity.moments_analyze_atol(row) for row in cent_cpu.numpy()]
    for m in ("skewness", "kurtosis", "pearson_skewness", "bowley_skewness"):
        ops[f"moments_{m}"] = (lambda m=m: getattr(moments, m)(cent), lambda m=m: getattr(moments, m)(cent_cpu),
                               parity.MOMENTS_RTOL, max(a[m] for a in row_atol), first)
    ops["histogram_shannon"] = (lambda: entropy.shannon_entropy(entropy.histogram_probs(cent, 64)),
                                lambda: entropy.shannon_entropy(entropy.histogram_probs(cent_cpu, 64)), rt, at, first)
    ops["chroma_stats"] = (lambda: CA.chroma_stats(ch), lambda: CA.chroma_stats(ch_cpu), rt, 1e-5, first)
    for m in ("tonal_centroid", "tonnetz_point", "harmonic_tension", "consonance"):
        ops[m] = (lambda m=m: getattr(CA, m)(ch), lambda m=m: getattr(CA, m)(ch_cpu), rt, 1e-5, first)
    ops["voice_leading_distance"] = (lambda: CA.voice_leading_distance(ch[:, 1:], ch[:, :-1]),
                                     lambda: CA.voice_leading_distance(ch_cpu[:, 1:], ch_cpu[:, :-1]), rt, at, first)
    ops["smooth_chroma"] = (lambda: CA.smooth_chroma(ch[0], 8), lambda: CA.smooth_chroma(ch_cpu[0], 8), rt, at, whole)
    ops["tonnetz_trajectory"] = (lambda: CA.tonnetz_trajectory(ch[0]), lambda: CA.tonnetz_trajectory(ch_cpu[0]),
                                 rt, 1e-5, whole)
    return ops


@pytest.mark.parametrize("name", SURFACE_OPS)
def test_op_surface_card_against_cpu(surface, name):
    """The op at full width on the launching no kernel but K1 and
    K4; its leading rows held to the same op on the CPU (utils/parity
    OPS_*, MOMENTS_RTOL, BLOCK_SCAN_*)."""
    fn, cpu_fn, rtol, atol, rows_of = surface_ops(surface)[name]
    got, launches = counted(fn)
    assert {k for k, v in launches.items() if v} <= {"K1", "K4"}, launches
    ref = cpu_fn()
    if isinstance(ref, dict):
        pairs = [(f"{name}.{k}", rows_of(got[k]), ref[k]) for k in ref]
    elif isinstance(ref, tuple):
        pairs = [(f"{name}[{i}]", rows_of(g), r) for i, (g, r) in enumerate(zip(got, ref, strict=True))]
    else:
        pairs = [(name, rows_of(got), ref)]
    for label, g, r in pairs:
        require(parity_close(label, np32(g), r.numpy() if isinstance(r, torch.Tensor) else r, rtol, atol),
                f"{label}, card vs CPU")
    if name == "knn_corpus":
        idx, dist = got
        assert idx.tolist() == sorted([surface.src, *surface.dups.tolist()])[:C.TOP_K]
        assert float(dist.abs().max()) == 0.0


def test_op_surface_launches_k1_and_k4(surface):
    """The whole surface, each op once, launches K1 and K4 and no other kernel."""
    from sonido_sonar_tpu_torch.ops import chroma_analysis as CA
    from sonido_sonar_tpu_torch.ops import spectral
    from sonido_sonar_tpu_torch.ops.stats import clustering, entropy, moments

    ops = surface_ops(surface)
    frames = surface.mfcc.reshape(-1, surface.mfcc.shape[-1])
    r = torch.roll(surface.q, SURFACE_SHIFT, dims=-1)

    def everything():
        for fn, *_ in ops.values():
            fn()
        spectral.detect_speech_segments(surface.pcm[3], WINDOW, 512, min_segment_samples=SR // 10)
        clustering.Clustering(num_clusters=8, seed=SEED, device=surface.pcm.device).fit(frames)
        moments.analyze(surface.series)
        entropy.analyze(surface.series)
        for m in SEQUENCE_METHODS:
            CA.ChromaSequenceSimilarity(m, device=surface.pcm.device,
                                        **(dict(dtw_band_radius=64) if m == "dtw" else {})).compute(surface.q, r)

    _, launches = counted(everything)
    launched = {k for k, v in launches.items() if v}
    assert launched == {"K1", "K4"}, launches


def test_detect_speech_segments_card_against_cpu(surface):
    from sonido_sonar_tpu_torch.ops import spectral

    got = spectral.detect_speech_segments(surface.pcm[3], WINDOW, 512, min_segment_samples=SR // 10)
    ref = spectral.detect_speech_segments(surface.pcm[3].cpu(), WINDOW, 512, min_segment_samples=SR // 10)
    assert all(np.array_equal(g, r) for g, r in zip(got, ref, strict=True))


def test_kmeans_card_against_cpu(surface):
    """K = 8 over the main path's MFCC frames of 2 clips, card against CPU
    on the same frames and kmeans++ seeds: the assignment to the seeds
    equal but where a frame's two nearest seeds are within
    KMEANS_TIE_SCALE; after the fit, at most KMEANS_LABEL_MISS_SHARE of
    the labels differ and the inertia within KMEANS_INERTIA_RTOL. The fit
    at full width (661k frames) runs too."""
    from sonido_sonar_tpu_torch.ops.stats import clustering
    from sonido_sonar_tpu_torch.ops.stats.dtw import pairwise_sq_euclidean

    frames = surface.mfcc.reshape(-1, surface.mfcc.shape[-1])
    clustering.Clustering(num_clusters=8, seed=SEED, device=frames.device).fit(frames)
    x = frames[: ROWS * surface.mfcc.shape[1]]
    x_cpu = x.cpu()
    init = torch.from_numpy(clustering._kmeanspp_init(x_cpu.numpy(), 8, np.random.default_rng(SEED)))
    first = clustering._lloyd(x, init.to(x.device), 0)[0].cpu()
    d2 = pairwise_sq_euclidean(x_cpu, init)
    two = torch.topk(d2, 2, dim=-1, largest=False).values
    scale = torch.sum(x_cpu * x_cpu, -1) + torch.amax(torch.sum(init * init, -1))
    tied = (two[:, 1] - two[:, 0]) <= parity.KMEANS_TIE_SCALE * scale
    assert not bool(((first != torch.argmin(d2, dim=-1)) & ~tied).any()), "the assignment to the seeds differs"
    fit_card = clustering.Clustering(num_clusters=8, seed=SEED, device=x.device).fit(x)
    fit_cpu = clustering.Clustering(num_clusters=8, seed=SEED, device="cpu").fit(x_cpu)
    assert float(np.mean(fit_card.labels != fit_cpu.labels)) <= parity.KMEANS_LABEL_MISS_SHARE
    assert abs(fit_card.inertia - fit_cpu.inertia) / fit_cpu.inertia <= parity.KMEANS_INERTIA_RTOL


@pytest.mark.parametrize("name", ["moments_analyze", "entropy_analyze"])
def test_series_analyses_card_against_cpu(surface, name):
    from sonido_sonar_tpu_torch.ops.stats import entropy, moments

    fn = moments.analyze if name == "moments_analyze" else entropy.analyze
    got, ref = fn(surface.series), fn(surface.series.cpu())
    atol = parity.moments_analyze_atol(surface.series.cpu().numpy()) if name == "moments_analyze" else {}
    for k in ref:
        require(parity_close(f"{name}.{k}", got[k], ref[k], parity.MOMENTS_RTOL, atol.get(k, parity.OPS_ATOL)),
                f"{name}.{k}, card vs CPU")


@pytest.mark.parametrize("method", SEQUENCE_METHODS)
def test_chroma_sequence_similarity_card_against_cpu(surface, method):
    """A chord clip's chroma against itself transposed by SURFACE_SHIFT:
    the similarity matrix and score held to the CPU, the same best
    transposition; OTI must find the shift."""
    from sonido_sonar_tpu_torch.ops import chroma_analysis as CA

    q = surface.q
    r = torch.roll(q, SURFACE_SHIFT, dims=-1)
    kw = dict(dtw_band_radius=64) if method == "dtw" else {}
    got = CA.ChromaSequenceSimilarity(method, device=q.device, **kw).compute(q, r)
    ref = CA.ChromaSequenceSimilarity(method, device="cpu", **kw).compute(q.cpu(), r.cpu())
    if method == "smith_waterman":
        rtol, atol = 0.0, parity.SW_ATOL_SCALE * float(np.abs(ref.similarity_matrix).max())
    else:
        rtol, atol = parity.OPS_RTOL, parity.OPS_ATOL
    require(parity_close(f"{method} matrix", got.similarity_matrix, ref.similarity_matrix, rtol, atol),
            f"ChromaSequenceSimilarity({method!r}), card vs CPU")
    score_tol = parity.SW_ATOL_SCALE if method == "smith_waterman" else parity.OPS_RTOL
    assert abs(got.overall_similarity - ref.overall_similarity) <= score_tol * abs(ref.overall_similarity) + 1e-7
    assert got.best_transposition == ref.best_transposition
    if method == "oti":
        assert got.best_transposition == SURFACE_SHIFT


# -- the meshes --------------------------------------------------------------------

MESH_NCCL_STEP = """
import json, socket, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import torch.distributed as dist
import card_support as C
from sonido_sonar_tpu_torch.config.config import FeatureConfig
from sonido_sonar_tpu_torch.parallel import BatchedFingerprintPipeline, make_mesh, sharded_top_k_matches
from sonido_sonar_tpu_torch.parallel.mesh import initialize_distributed
from sonido_sonar_tpu_torch.parallel.pipeline import batched_fingerprint_features
from sonido_sonar_tpu_torch.utils import parity
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
x = parity.synth_pcm(C.FULL_B, C.N_FULL, C.SEED + 39, C.SR, dev)
cfg = FeatureConfig(sample_rate=C.SR, window_size=C.WINDOW, hop_size=C.HOP)
corpus, src, dups, rng = C.corpus_rows(44)
queries = [rng.standard_normal(44).astype(np.float32), corpus[src]]
want = batched_fingerprint_features(x, sample_rate=C.SR, window_size=C.WINDOW, hop_size=C.HOP)
want_topk = [sharded_top_k_matches(q, corpus, k=C.TOP_K, mesh=None, device=dev) for q in queries]
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
initialize_distributed(f"127.0.0.1:{port}", 1, 0)
res = {"backend": dist.get_backend(), "world_size": dist.get_world_size()}
for name, devices in (("one", None), ("two", [dev, dev])):
    mesh = make_mesh(devices=devices)
    got, launches = C.counted(lambda: BatchedFingerprintPipeline(mesh, cfg)(x))
    res[name] = {"entries": mesh.size, "distributed": mesh.distributed, "launches": launches,
                 "bit_equal": sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)}
    tk = [sharded_top_k_matches(q, corpus, k=C.TOP_K, mesh=mesh) for q in queries]
    res[name]["topk_same_indices"] = all(np.array_equal(a[0], b[0]) for a, b in zip(tk, want_topk))
    res[name]["topk_max_score_diff"] = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(tk, want_topk))
dist.destroy_process_group()
res["destroyed"] = not dist.is_initialized()
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def mesh(card):
    """PCM [128, 30 s] (seed SEED + 39), the unsharded step's features, a
    one-entry mesh (the card) and a two-entry mesh on the one card (a
    repeated entry is a shard run after the other)."""
    from sonido_sonar_tpu_torch.config.config import FeatureConfig
    from sonido_sonar_tpu_torch.parallel import make_mesh

    x = parity.synth_pcm(FULL_B, N_FULL, SEED + 39, SR, card.dev)
    return types.SimpleNamespace(
        x=x, cfg=FeatureConfig(sample_rate=SR, window_size=WINDOW, hop_size=HOP),
        want=pipeline.batched_fingerprint_features(x, sample_rate=SR, window_size=WINDOW, hop_size=HOP),
        meshes={"one": make_mesh(devices=None if torch.cuda.device_count() == 1 else [card.dev]),
                "two": make_mesh(devices=[card.dev, card.dev])})


@pytest.mark.parametrize("name", ["one", "two"])
def test_sharded_step_against_the_unsharded_step(mesh, name):
    """K1 and K2 launched once per shard; the features bit for bit, or a
    key that is not held to the whole-path bounds
    (utils/parity.check_sharded_step)."""
    from sonido_sonar_tpu_torch.parallel import BatchedFingerprintPipeline

    m = mesh.meshes[name]
    got, launches = counted(lambda: BatchedFingerprintPipeline(m, mesh.cfg)(mesh.x))
    assert launches["K1"] == m.size and launches["K2"] == m.size, launches
    require(parity.check_sharded_step({k: np32(v) for k, v in got.items()}, {k: np32(v) for k, v in mesh.want.items()},
                                      lambda: parity.near_zero_frames(np32(mesh.x), WINDOW, HOP, PRE_EMPH), SR, WINDOW),
            f"{name}-entry mesh vs the unsharded step")


def test_run_stream_over_the_two_entry_pipeline(card, mesh):
    from sonido_sonar_tpu_torch.parallel import BatchedFingerprintPipeline

    pipe = BatchedFingerprintPipeline(mesh.meshes["two"], mesh.cfg)
    batches = [mesh.x * (1.0 - 0.03 * k) for k in range(3)]
    got = list(pipeline.run_stream(pipe, batches, drain_every=2, device=card.dev))
    assert len(got) == len(batches)
    for k, b in enumerate(batches):
        direct = pipe(b)
        assert all(torch.equal(got[k][key], direct[key]) for key in direct), f"batch {k}"


@pytest.mark.parametrize("query", ["random", "tied"])
@pytest.mark.parametrize("name", ["none", "one", "two"])
def test_sharded_search_against_mesh_none(card, mesh, query, name):
    """sharded_top_k_matches and sharded_batched_similarity over the
    262,144-row corpus: the ranking of mesh=None (ties lowest index
    first), the scores within COMPARATOR_HOST_ATOL."""
    from sonido_sonar_tpu_torch.fingerprint import device_compare as DC
    from sonido_sonar_tpu_torch.parallel import sharded_top_k_matches

    rows, src, dups, rng = C.corpus_rows(DC.layout_size(13))
    q = rng.standard_normal(DC.layout_size(13)).astype(np.float32) if query == "random" else rows[src]
    X = torch.from_numpy(rows).to(card.dev)
    mcorpus = X[:, :44].contiguous()              # the matcher's packed layout
    match = torch.ones(C.CORPUS_ROWS, dtype=torch.bool, device=card.dev)
    m = None if name == "none" else mesh.meshes[name]
    ref = sharded_top_k_matches(q[:44], mcorpus, k=2 * C.TOP_K, mesh=None)
    ref_sim = DC.sharded_batched_similarity(q, X, W_FEATURES, match, num_mfcc_coeffs=13)
    idx, scores = sharded_top_k_matches(q[:44], mcorpus, k=C.TOP_K, mesh=m)
    sim = DC.sharded_batched_similarity(q, X, W_FEATURES, match, mesh=m, num_mfcc_coeffs=13)
    C.same_ranking(f"sharded_top_k_matches, {query} query, {name} mesh", idx.tolist(), scores.tolist(),
                   ref[0].tolist(), ref[1].tolist())
    if query == "tied":
        assert idx.tolist() == sorted([src, *dups.tolist()])[:C.TOP_K]
    err = max(float(np.abs(sim[k] - ref_sim[k]).max()) for k in ("overall", "confidence"))
    assert err <= parity.COMPARATOR_HOST_ATOL and len(sim["overall"]) == C.CORPUS_ROWS
    assert all(np.array_equal(sim[k], ref_sim[k]) for k in ("match_class", "feature_present"))


def test_nccl_group_of_world_size_1(card):
    """A fresh process: an NCCL group of world size 1, the global mesh, the
    pipeline on a one- and a two-entry mesh and the all-gather merge of
    the top k against the same calls without the group. One H100 holds no
    NCCL group of two ranks: the two-process path is checked on the CPU
    (tests/test_torch_multihost.py)."""
    proc = subprocess.run([sys.executable, "-c", MESH_NCCL_STEP, str(C.ROOT / "tests")],
                          capture_output=True, text=True, timeout=600, cwd=C.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    nccl = json.loads(proc.stdout.strip().splitlines()[-1])
    assert nccl["backend"] == "nccl" and nccl["world_size"] == 1 and nccl["destroyed"], nccl
    for name, size in (("one", 1), ("two", 2)):
        r = nccl[name]
        assert r["bit_equal"] and r["topk_same_indices"] and r["distributed"], r
        assert r["topk_max_score_diff"] <= parity.COMPARATOR_HOST_ATOL, r
        assert r["launches"]["K1"] == r["launches"]["K2"] == size, r
