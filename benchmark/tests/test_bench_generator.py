"""The content-aware generator's cell (`generator.archive-mixed-30s`) on
the CPU at a tiny size: its traffic is the same for a seed and forms at
least three content-type groups; a sound run reads `correct`, and a run
with a fault planted in the program (a clip's type altered, one group's
features swapped with another's, a batch left out of the window) reads
`correct` false; each of its readers gives a value from a synthetic
trace and its counters, and nothing where the program lacks them; the
generator's spans stay off outside a profiler session."""

import importlib.util
import types

import pytest
import torch

from benchmark import run as R
from benchmark.core import spec as S
from benchmark.core import trace as T

CELL = "generator.archive-mixed-30s"
SEED = 2**31 + 4243
SR = 44100


def _tiny():
    cell = S.Cell(CELL)
    cell.config = dict(cell.config, batch=8, clip_seconds=3)
    cell.traffic = dict(cell.traffic, batch=8, clip_seconds=3, distinct=2, speech=3, music=2, crowd=2, beds=1)
    cell.check = dict(cell.check, sample_pool=2, sample=2)
    return cell


def _run(cell, seconds=2.0):
    torch.set_num_threads(4)
    return R.run_cell(cell, SEED, seconds, False, "cpu", log=lambda *a, **k: None)


# -- the traffic ---------------------------------------------------------------

def test_the_traffic_is_the_same_for_a_seed_and_forms_three_groups():
    t = _tiny().traffic
    mod = S.load_module("traffic", "broadcast_clips")
    a, labels = mod.make_labelled(t, SEED, "cpu", SR)
    b, _ = mod.make_labelled(t, SEED, "cpu", SR)
    c, _ = mod.make_labelled(t, SEED + 1, "cpu", SR)
    assert len(a) == 2 and all(x.shape == (8, 3 * SR) and x.dtype == torch.float32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert all(sorted(set(k)) == ["beds", "crowd", "music", "speech"] for k in labels)
    detect = S.load_module("reference", "content_fingerprint").detect
    for x in a:
        assert len(set(detect(x, SR))) >= 3


# -- the check -----------------------------------------------------------------

def _patch_generator(monkeypatch, change):
    from sonido_sonar_tpu_torch.fingerprint.generator import FingerprintGenerator

    real = FingerprintGenerator.generate_fingerprints_batch
    state = {}

    def broken(self, audios, *a, **k):
        return change(state, real(self, audios, *a, **k))

    monkeypatch.setattr(FingerprintGenerator, "generate_fingerprints_batch", broken)


def _type_altered(state, fps):
    fps[0].content_type = type(fps[0].content_type)("sports" if fps[0].content_type.value != "sports"
                                                    else "music")
    return fps


def _features_swapped(state, fps):
    i = next(i for i, fp in enumerate(fps) if fp.content_type != fps[0].content_type)
    fps[0].features, fps[i].features = fps[i].features, fps[0].features
    return fps


def _batch_left_out(state, fps):
    """Each call hands back the previous call's fingerprints."""
    prev, state["prev"] = state.get("prev", fps), fps
    return prev


@pytest.mark.parametrize("fault", [_type_altered, _features_swapped, _batch_left_out],
                         ids=["type_altered", "features_swapped", "batch_left_out"])
def test_a_fault_fails_the_check(monkeypatch, fault):
    _patch_generator(monkeypatch, fault)
    res = _run(_tiny())
    assert res["correct"] is False
    assert any(not c["value"] <= c["limit"] for c in res["checks"].values())


def test_the_sound_run_is_correct():
    res = _run(_tiny())
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(S.Cell(CELL).check["limits"])
    assert res["metrics"]["audio_h_per_h"]["value"] > 0


# -- the readers ---------------------------------------------------------------

CALLS = 4
# metric -> (counter -> value over 4 calls, expected reading)
COUNTED = {
    "detect_wait_ms_per_batch": ({"generator_detect_wait_ns": 8_000_000}, 2.0),
    "extractor_calls_per_batch": ({"generator_extract_calls": 16}, 4.0),
    "materialize_ms_per_batch": ({"generator_materialize_ns": 100_000_000,
                                  "generator_assemble_ns": 20_000_000}, 30.0),
    "host_syncs_per_batch.generator": ({"host_syncs": 4 * 161}, 161.0),
}


def _ctx(counters, device=(), window=(0.0, 1000.0)):
    spans = [T.Span(name, "kernel", ts, dur) for name, ts, dur in device]
    trace = T.TraceReading(CALLS, T.Span(T.WINDOW_LABEL, "user_annotation", window[0], window[1]), spans, [])
    kernels = S.read_json(S.BENCH / "layer_metrics" / "kernels.json")
    return types.SimpleNamespace(counters=counters, trace=trace, kernels=kernels, cell=S.Cell(CELL))


@pytest.mark.parametrize("name", sorted(COUNTED))
def test_a_counting_reader_divides_its_totals_by_the_traced_calls(name):
    counters, want = COUNTED[name]
    mod = S.load_module("layer_metrics", name)
    assert set(mod.COUNTERS) == set(counters)
    assert mod.read(_ctx(counters)) == pytest.approx(want)
    assert mod.read(_ctx({})) is None


# a speech group (K1, K2, K2 with the amplitude), then a music group (K1, K2)
K1, K2 = "void (anonymous namespace)::stft_aux_kernel<10, false>", "void (anonymous namespace)::yin_kernel<9, false>"
SEQUENCE = [(K1, 0.0, 10.0), (K2, 20.0, 5.0), (K2, 40.0, 10.0), ("other", 55.0, 5.0),
            (K1, 60.0, 10.0), (K2, 80.0, 4.0)]


def test_k2amp_roofline_reads_the_amplitude_launches():
    from benchmark.roofline import k2amp, peaks

    mod = S.load_module("layer_metrics", "k2amp_roofline")
    ctx = _ctx({"k2amp_launches": 1, "k2amp_rows": 56}, SEQUENCE)
    assert [s.ts for s in mod.amplitude_records(ctx)] == [40.0]
    least = peaks.least_seconds(*k2amp.counts(56, 30 * SR, 1024, 256))
    assert mod.read(ctx) == pytest.approx(100.0 * least / 10e-6)
    assert mod.read(_ctx({"k2amp_launches": 2, "k2amp_rows": 112}, SEQUENCE)) is None  # one found
    assert mod.read(_ctx({}, SEQUENCE)) is None


def test_k2amp_bound_is_chip_smokes():
    from benchmark.roofline import k2amp, peaks

    assert peaks.least_seconds(*k2amp.counts(128, 30 * SR, 1024, 256)) * 1e3 == pytest.approx(0.874, abs=5e-4)


def test_device_idle_reads_the_busy_share():
    mod = S.load_module("layer_metrics", "device_idle_pct.generator")
    assert mod.read(_ctx({}, SEQUENCE, (0.0, 200.0))) == pytest.approx(100.0 * (1 - 44.0 / 200.0))


def test_a_program_without_the_counters_gives_none(monkeypatch):
    from sonido_sonar_tpu_torch.fingerprint import generator
    from sonido_sonar_tpu_torch.ops import hopper_yin

    monkeypatch.delattr(generator, "EXTRACT")
    monkeypatch.delattr(hopper_yin.yin_pitch_hopper, "amp_rows")
    for name in ("extractor_calls_per_batch", "k2amp_roofline"):
        path = S.BENCH / "layer_metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"{name}_fresh", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.COUNTERS == {}
        assert mod.read(_ctx({}, SEQUENCE)) is None


def test_every_new_metric_is_in_the_spec_with_its_reader():
    spec = {m["name"]: m for m in S.load_spec()["per_layer"]}
    for name in list(COUNTED) + ["device_idle_pct.generator", "k2amp_roofline"]:
        assert spec[name]["workloads"] == [CELL]
        assert spec[name]["moves"] == "audio_h_per_h"
        assert (S.BENCH / "layer_metrics" / f"{name}.py").is_file()


# -- the spans -----------------------------------------------------------------

def test_the_generators_spans_are_off_outside_a_profiler_session():
    from sonido_sonar_tpu_torch.fingerprint import content_detector, generator

    spans = [generator.DETECT, generator.EXTRACT, generator.MATERIALIZE, generator.ASSEMBLE,
             content_detector.DETECT_WAIT]
    before = [(s.count, s.total_ns) for s in spans]
    for s in spans:
        with s:
            pass
    assert [(s.count, s.total_ns) for s in spans] == before
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for s in spans:
            with s:
                pass
    assert [s.count for s in spans] == [c + 1 for c, _ in before]
