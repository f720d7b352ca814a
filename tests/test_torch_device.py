"""Where the port's entry points run: a tensor stays on its device,
numpy input goes to the entry point's `device`, the card by default
(utils/device.py), as the JAX package puts numpy on its accelerator.

Without a card a default call with numpy input raises torch's own error
and never runs on the CPU; with `device="cpu"` it runs the plain versions
and gives what a CPU tensor gives. Whether there is a card is decided
inside each test.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from sonido_sonar_tpu_torch import FleetMonitor, LatencyMonitor  # noqa: E402
from sonido_sonar_tpu_torch.config.config import FeatureConfig, FingerprintConfig  # noqa: E402
from sonido_sonar_tpu_torch.extractors.alignment import AlignmentExtractor  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint.content_detector import ContentDetector  # noqa: E402
from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata  # noqa: E402
from sonido_sonar_tpu_torch.models import FingerprintModel  # noqa: E402
from sonido_sonar_tpu_torch.monitor import _RollingWindow  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats.alignment import AlignmentAnalyzer  # noqa: E402
from sonido_sonar_tpu_torch.ops.stats import batched_alignment as tba  # noqa: E402
from sonido_sonar_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402
from sonido_sonar_tpu_torch.utils.device import as_float32  # noqa: E402

torch.set_num_threads(1)
SR = 8000
CFG = FeatureConfig(sample_rate=SR, window_size=1024, hop_size=256)
CARD = torch.device("cuda")


def _clips(n=2, seconds=1.0):
    return parity.voiced_pcm(n, int(seconds * SR), 31, SR).numpy()


def _news(x):
    return [AudioData(r, SR, metadata=AudioMetadata(extra={"content_type": "news"})) for r in x]


@pytest.mark.parametrize("make", [
    lambda: FingerprintGenerator(),
    lambda: FingerprintGenerator().content_detector,
    lambda: ContentDetector(),
    lambda: AlignmentExtractor(CFG),
    lambda: LatencyMonitor(CFG),
    lambda: FleetMonitor(CFG),
    lambda: LatencyMonitor(CFG)._src,
    lambda: FleetMonitor(CFG, n_streams=2)._cdn,
    lambda: _RollingWindow(16),
    lambda: FingerprintModel(),
    lambda: AlignmentAnalyzer(),
], ids=["generator", "generator_detector", "detector", "extractor", "latency_monitor",
        "fleet_monitor", "latency_window", "fleet_window", "window", "model", "analyzer"])
def test_default_device_is_the_card(make):
    assert make().device == CARD


def _default_calls():
    x = _clips()
    e = np.abs(x[:, ::256]).astype(np.float32)
    unlabelled = [AudioData(r, SR) for r in x]
    return {
        "generator_batch": lambda: FingerprintGenerator(FingerprintConfig(feature_config=CFG))
        .generate_fingerprints_batch(_news(x), materialize=False).groups[0][2].mfcc,
        "generator_clip": lambda: FingerprintGenerator(FingerprintConfig(feature_config=CFG))
        .generate_fingerprint(_news(x)[0]).features.mfcc,
        "detector": lambda: ContentDetector().detect_batch(unlabelled),
        "extractor": lambda: AlignmentExtractor(CFG, max_lag_seconds=0.2)._tensor(x[0]),
        "latency_monitor": lambda: _pushed(LatencyMonitor(CFG, window_seconds=0.5), x[0]),
        "fleet_monitor": lambda: _pushed_all(FleetMonitor(CFG, n_streams=2, window_seconds=0.5), x),
        "hybrid": lambda: tba.batched_hybrid_align(e, e, 2, 256, SR)["offset_samples"],
        "hybrid_device": lambda: tba.batched_hybrid_align_device(e, e, 2, 256, SR)["offset_samples"],
        "align_audio": lambda: tba.batched_align_audio(x, x, SR, 1024, 256, 0.2)["offset_samples"],
        "helper": lambda: as_float32(x),
        **{name: (lambda call=call: call(_entry_inputs(), {}))
           for name, call in _ENTRY_CALLS.items()},
    }


def _entry_inputs(seconds=1.0):
    """Numpy inputs of the entry points below: two PCM batches [2, N],
    their energy series [2, T], coarse offsets [2] and candidates [2, 2]."""
    x = _clips(2, seconds)
    y = np.ascontiguousarray(np.roll(x[::-1], 40, axis=-1))
    return {"x": x, "y": y, "eq": np.abs(x[:, ::64]), "er": np.abs(y[:, ::64]),
            "coarse": np.array([0.01, -0.02], np.float32),
            "cands": np.array([[0.0, 0.01], [-0.02, 0.0]], np.float32)}


def _analyzer(**kw):
    return AlignmentAnalyzer(method="hybrid", max_lag=8, sample_rate=SR, hop_size=256,
                             window_size=1024, **kw)


_GEOMETRY = FeatureConfig(sample_rate=SR, window_size=1024, hop_size=256)

# The entry points of parallel/pipeline.py, FingerprintModel and the
# AlignmentAnalyzer methods, each as call(inputs, device kwargs) over
# _entry_inputs(): the pipeline functions and the model take `device`, the
# analyzer takes it at construction.
_ENTRY_CALLS = {
    "fingerprint_features": lambda a, kw: tpipe.batched_fingerprint_features(
        a["x"], SR, 1024, 256, **kw),
    "speech_analysis": lambda a, kw: tpipe.batched_speech_analysis(a["x"], SR, **kw),
    "speech_extractor": lambda a, kw: tpipe.batched_speech_extractor_features(a["x"], SR, **kw),
    "music_extractor": lambda a, kw: tpipe.batched_music_extractor_features(a["x"], SR, **kw),
    "pair_alignment": lambda a, kw: tpipe.batched_pair_alignment(a["eq"], a["er"], 8, **kw),
    "pair_dtw": lambda a, kw: tpipe.batched_pair_dtw(a["eq"][..., None], a["er"][..., None], 6,
                                                    **kw),
    "refine_offsets": lambda a, kw: tpipe.batched_refine_offsets(
        a["x"], a["y"], a["coarse"], SR, search_hops=2, **kw),
    "phat_candidates": lambda a, kw: tpipe.batched_phat_candidates(
        a["x"], a["y"], a["cands"], SR, search_hops=2, **kw),
    "phat_global": lambda a, kw: tpipe.batched_phat_global(a["x"], a["y"], SR, 400, **kw),
    "model": lambda a, kw: FingerprintModel(_GEOMETRY, **kw)(a["x"]),
    "analyzer_align_features": lambda a, kw: _analyzer(**kw).align_features(a["eq"][0],
                                                                            a["er"][0]),
    "analyzer_align_audio": lambda a, kw: _analyzer(**kw).align_audio(a["x"][0], a["y"][0]),
    "analyzer_find_best": lambda a, kw: _analyzer(**kw).find_best_alignment(a["eq"][0],
                                                                            a["er"][0]),
    "analyzer_consistency": lambda a, kw: _analyzer(**kw).analyze_alignment_consistency(
        a["eq"][0], a["er"][0], num_trials=2),
}


def _pushed(mon, row):
    mon.push_source(row)
    return mon._src.buf


def _pushed_all(fleet, rows):
    fleet.push_source_all(rows)
    return fleet._src.buf


@pytest.mark.parametrize("name", ["generator_batch", "generator_clip", "detector", "extractor",
                                  "latency_monitor", "fleet_monitor", "hybrid", "hybrid_device",
                                  "align_audio", "helper", *_ENTRY_CALLS])
def test_numpy_input_goes_to_the_card_by_default(name):
    """Without a card the default call raises torch's error instead of
    running on the CPU; with one, the result lies on the card."""
    call = _default_calls()[name]
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda|nvidia"):
            call()
        return
    out = call()
    if isinstance(out, torch.Tensor):
        assert out.device.type == "cuda"


def test_a_tensor_keeps_its_device():
    """The helper and the entry points leave a CPU tensor on the CPU
    whatever their default device."""
    x = torch.from_numpy(_clips())
    assert as_float32(x).device.type == "cpu"
    assert as_float32(x.to(torch.float64), "cuda").dtype == torch.float32
    ext = AlignmentExtractor(CFG, max_lag_seconds=0.2)
    assert ext._tensor(x[0]).device.type == "cpu"
    e = x[:, ::256].abs().contiguous()
    assert tba.batched_hybrid_align(e, e, 2, 256, SR)["offset_samples"].device.type == "cpu"
    fps = FingerprintGenerator(FingerprintConfig(feature_config=CFG)).generate_fingerprints_batch(
        _news(x), materialize=False, pcm_matrix=x)
    assert fps.groups[0][2].mfcc.device.type == "cpu"


def test_cpu_device_gives_what_a_cpu_tensor_gives():
    """device="cpu" with numpy input equals the same call on CPU tensors,
    bit for bit: the generator, the detector, the extractor, both monitors
    and the batched aligner."""
    x = _clips(3, 2.0)
    xt = torch.from_numpy(x)
    cfg = FingerprintConfig(feature_config=CFG)
    a = FingerprintGenerator(cfg, device="cpu").generate_fingerprints_batch(_news(x))
    b = FingerprintGenerator(cfg, device="cpu").generate_fingerprints_batch(_news(x), pcm_matrix=xt)
    assert all(np.array_equal(p.features.mfcc, q.features.mfcc) for p, q in zip(a, b))
    plain = [AudioData(r, SR) for r in x]
    assert ContentDetector(device="cpu").detect_batch(plain) == \
        ContentDetector(device="cpu").detect_batch(plain, pcm_device=xt)
    ext = AlignmentExtractor(CFG, max_lag_seconds=0.3, device="cpu")
    ra, rb = ext.align_audio_files(x[0], x[1], SR), ext.align_audio_files(xt[0], xt[1], SR)
    assert ra.temporal_offset == rb.temporal_offset and ra.offset_confidence == rb.offset_confidence
    mons = [LatencyMonitor(CFG, window_seconds=1.0, max_lag_seconds=0.2, device="cpu")
            for _ in range(2)]
    for mon, src in zip(mons, (x, xt)):
        mon.push_source(src[0])
        mon.push_cdn(src[1])
    assert mons[0].measure() == mons[1].measure()
    fleets = [FleetMonitor(CFG, n_streams=3, window_seconds=1.0, max_lag_seconds=0.2,
                           measure_batch=2, device="cpu") for _ in range(2)]
    for fleet, src in zip(fleets, (x, xt)):
        fleet.push_source_all(src)
        fleet.push_cdn_all(src[::-1].copy() if isinstance(src, np.ndarray) else src.flip(0))
    assert fleets[0].measure_all() == fleets[1].measure_all()
    got = tba.batched_align_audio(x, x[::-1].copy(), SR, 1024, 256, 0.2, device="cpu")
    want = tba.batched_align_audio(xt, xt.flip(0), SR, 1024, 256, 0.2)
    assert all(torch.equal(got[k], want[k]) for k in want)


def _leaves(out):
    """The tensors, arrays and numbers of an entry point's result, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [v for k in out for v in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [v for item in out for v in _leaves(item)]
    if hasattr(out, "__dataclass_fields__"):
        return [v for k in out.__dataclass_fields__ for v in _leaves(getattr(out, k))]
    return [out]


@pytest.mark.parametrize("name", list(_ENTRY_CALLS))
def test_cpu_device_on_numpy_equals_cpu_tensors(name):
    """device="cpu" with numpy input gives exactly what the same data as
    CPU tensors gives: the pipeline functions, the model and the
    AlignmentAnalyzer methods."""
    a = _entry_inputs()
    got = _leaves(_ENTRY_CALLS[name](a, {"device": "cpu"}))
    want = _leaves(_ENTRY_CALLS[name]({k: torch.from_numpy(v) for k, v in a.items()}, {}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.device.type == "cpu" and g.dtype == w.dtype
            assert torch.equal(g, w)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w or (g != g and w != w)


def test_numpy_main_path_on_cpu_matches_jax():
    """batched_fingerprint_features on numpy with device="cpu" against the
    JAX package's on the same [2, 44100] seed, within utils/parity's
    whole-path tolerances."""
    import jax.numpy as jnp

    from sonido_sonar_tpu.parallel.pipeline import batched_fingerprint_features as jax_features

    x = parity.synth_pcm(2, 44100, 0, 44100).numpy()
    got = {k: v.numpy() for k, v in tpipe.batched_fingerprint_features(x, device="cpu").items()}
    ref = {k: np.asarray(v) for k, v in jax_features(jnp.asarray(x)).items()}
    near = parity.near_zero_frames(x, 1024, 256, 0.97)
    errors, failures = parity.check_features(got, ref, near, 44100, 1024)
    assert not failures, (failures, errors)
    assert len(got) == 19
