"""The tagged music catalogue's cell (`catalog.music-tagged-30s`) on the
CPU at a tiny size: its traffic is the same for a seed, mixes rhythmic
and beatless tracks and draws its tempi in range; a sound run reads
`correct`, and a run with a fault planted in the program (a clip's
onsets moved, half of a batch's fingerprints left out) reads `correct` false;
K4's roofline counts two bytes a cell; each new reader gives a value
from a synthetic trace and its counters, and nothing where the program
lacks them. The control (the reference one precision lower, TF32) fails
on the card, and on the CPU by the sums it rounds to TF32 on any device;
its DFT form of the YIN difference is the direct sum's at float32; a
moved harmonic pick counts as a flip and stays out of the harmonic
gap."""

import importlib.util
import types

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.core import spec as S
from benchmark.core import trace as T

CELL = "catalog.music-tagged-30s"
SEED = 2**31 + 2801
SR = 44100
NEW = ("k4_roofline", "k4_launches_per_batch", "tempo_ms_per_batch", "device_idle_pct.catalog")


def _tiny():
    cell = S.Cell(CELL)
    cell.config = dict(cell.config, batch=8, clip_seconds=3)
    cell.traffic = dict(cell.traffic, batch=8, clip_seconds=3, distinct=2, rhythmic=6, beatless=2)
    cell.check = dict(cell.check, sample_pool=2, sample=2)
    return cell


def _run(cell, seconds=2.0, control=False):
    torch.set_num_threads(4)
    return R.run_cell(cell, SEED, seconds, False, "cpu", control=control, log=lambda *a, **k: None)


# -- the traffic ---------------------------------------------------------------

def test_the_traffic_is_the_same_for_a_seed_and_its_tempi_lie_in_range():
    t = _tiny().traffic
    mod = S.load_module("traffic", "music_catalog")
    a, labels, tempi = mod.make_labelled(t, SEED, "cpu", SR)
    b, _, _ = mod.make_labelled(t, SEED, "cpu", SR)
    c, _, _ = mod.make_labelled(t, SEED + 1, "cpu", SR)
    assert len(a) == 2 and all(x.shape == (8, 3 * SR) and x.dtype == torch.float32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    for kinds, bpm, x in zip(labels, tempi, a):
        assert sorted(kinds) == ["beatless"] * 2 + ["rhythmic"] * 6
        rhythmic = torch.tensor([k == "rhythmic" for k in kinds])
        assert bool(((bpm[rhythmic] >= t["tempo_low"]) & (bpm[rhythmic] < t["tempo_high"])).all())
        assert bool((bpm[~rhythmic] == 0).all())
        peak_db = 20 * torch.log10(x.abs().amax(dim=-1))
        assert bool(((peak_db > t["peak_db_low"] - 0.5) & (peak_db < t["peak_db_high"] + 0.5)).all())


# -- the check -----------------------------------------------------------------

def _patch_generator(monkeypatch, change):
    from sonido_sonar_tpu_torch.fingerprint.generator import FingerprintGenerator

    real = FingerprintGenerator.generate_fingerprints_batch
    monkeypatch.setattr(FingerprintGenerator, "generate_fingerprints_batch",
                        lambda self, audios, *a, **k: change(real(self, audios, *a, **k)))


def _onsets_moved(fps):
    """The first clip's onset mask altered: every onset one frame later."""
    tf = fps[0].features.temporal_features
    assert np.any(tf.onset_mask)
    tf.onset_mask = np.roll(tf.onset_mask, 1)
    return fps


def _half_left_out(fps):
    """The second half of the batch's fingerprints left out."""
    return fps[: len(fps) // 2]


@pytest.mark.parametrize("fault", [_onsets_moved, _half_left_out], ids=["onsets_moved", "half_left_out"])
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


# numbers the control moves on any device: the DC blocker's and the YIN
# difference's inputs rounded to TF32 (the other matmuls round on the card)
MOVED_ANYWHERE = ("energy_gap", "temporal_gap", "zcr_flips", "harmonic_gap")


def test_the_control_fails_on_the_cpu():
    cell = _tiny()
    batches = S.load_module("traffic", "music_catalog").make(cell.traffic, SEED, "cpu", SR)
    ref = S.load_module("reference", cell.config["reference"])
    readings = ref.compare([ref.fingerprints(b, cell.config, lowp=True) for b in batches],
                           [ref.fingerprints(b, cell.config) for b in batches])
    limits = cell.check["limits"]
    assert set(readings) == set(limits)
    over = {k for k, v in readings.items() if not v <= limits[k]}
    assert set(MOVED_ANYWHERE) <= over, readings


@pytest.mark.card
def test_the_control_fails_on_the_card(card):
    res = R.run_cell(S.Cell(CELL), SEED, 10.0, False, card, control=True, log=lambda *a, **k: None)
    assert res["correct"] is False
    assert any(not c["value"] <= c["limit"] for c in res["checks"].values())


# -- the reference's pieces -------------------------------------------------------

def test_tf32_keeps_ten_bits_of_the_mantissa():
    from benchmark.reference import music_fingerprint as M

    x = torch.tensor([1.0, -2.5, 1.0 + 2.0**-10, 1.0 + 2.0**-11, -(1.0 + 3 * 2.0**-12), 3.0e-8])
    got = M.tf32(x)
    assert got[:3].tolist() == x[:3].tolist()
    assert got[3].item() == 1.0 + 2.0**-10          # a tie rounds away from zero
    assert got[4].item() == -(1.0 + 2.0**-10)
    mant = got.view(torch.int32) & 0x1FFF
    assert bool((mant == 0).all())
    assert float(torch.amax(torch.abs(got - x) / torch.abs(x))) <= 2.0**-11


def test_the_dft_yin_difference_is_the_direct_sum_and_moves_in_tf32():
    from benchmark.reference import music_fingerprint as M

    g = torch.Generator().manual_seed(SEED)
    frames = torch.randn(2, 40, 512, generator=g)
    direct = M.yin_difference(frames)
    scale = float(torch.amax(torch.abs(direct)))
    assert M.yin_difference_dft(frames).shape == direct.shape == (2, 40, 256)
    assert float(torch.amax(torch.abs(M.yin_difference_dft(frames) - direct))) / scale < 2e-6
    assert float(torch.amax(torch.abs(M.yin_difference_dft(frames, True) - direct))) / scale > 2e-5


def test_a_moved_harmonic_pick_is_a_flip_and_stays_out_of_the_gap():
    from benchmark.reference import music_fingerprint as M

    g = torch.Generator().manual_seed(SEED)
    r = {k: torch.rand(4, 50, generator=g, dtype=torch.float64) for k in M.HARMONIC}
    r[M.HP + "pitch_estimate"] = 100.0 + 400.0 * r[M.HP + "pitch_estimate"]
    r[M.HP + "pitch_estimate"][0, :5] = 0.0                           # unvoiced frames
    r[M.HP + "pitch_confidence"][:, :] = 0.8
    out = {k: v.clone() for k, v in r.items()}
    numbers = {k: M.NUMBERS[k] for k in ("harmonic_flips", "harmonic_gap")}

    def read():
        return M.read_numbers(numbers, lambda k: (out[k], r[k]), SR)

    assert read() == {"harmonic_flips": 0.0, "harmonic_gap": 0.0}
    out[M.HP + "pitch_estimate"][1, 7] *= 1.02                       # a pick moved
    out[M.HP + "harmonic_ratio"][1, 7] += 0.5                        # and what follows it
    out[M.HP + "pitch_estimate"][2, 3] = 0.0                         # voiced -> unvoiced
    out[M.HP + "pitch_confidence"][3, 9] = 0.4                       # inharmonicity's gate
    assert read() == {"harmonic_flips": pytest.approx(3 / 200), "harmonic_gap": 0.0}
    out[M.HP + "pitch_confidence"][3, 9] = 0.8
    out[M.HP + "tonal_centroid"][0, 20] += 1e-4                      # a gap on an agreeing frame
    scale = float(torch.amax(r[M.HP + "tonal_centroid"]))
    assert read() == {"harmonic_flips": pytest.approx(2 / 200), "harmonic_gap": pytest.approx(1e-4 / scale)}
    hnr = M.HP + "harmonic_ratio"                                    # HNR read as its autocorrelation
    r[hnr][:, :] = 0.0
    out[M.HP + "tonal_centroid"][0, 20] -= 1e-4
    out[hnr] = r[hnr].clone()
    out[hnr][0, 30] = 1.0
    assert read()["harmonic_gap"] == pytest.approx((1 / (1 + 10**-0.1) - 0.5) / 0.5)


# -- K4's roofline ---------------------------------------------------------------

def test_k4_counts_two_bytes_a_cell_and_bounds_the_batch():
    from benchmark.roofline import k4, peaks

    cfg = S.Cell(CELL).config
    d = cfg["derived"]
    cells = cfg["batch"] * (d["frames"] + d["tempo_flux_frames"] + d["tempo_energy_frames"])
    assert cells == d["k4_cells_per_batch"] == 1_321_984
    assert k4.counts(cells) == (2 * cells, 0)
    assert peaks.least_seconds(*k4.counts(cells)) * 1e6 == pytest.approx(0.789, abs=5e-4)


# -- the readers ---------------------------------------------------------------

CALLS = 4
K4 = "void (anonymous namespace)::thin_kernel(unsigned char const*, unsigned char*, int, int)"
K1 = "void (anonymous namespace)::stft_aux_kernel<11, false>"
SEQUENCE = [(K1, 0.0, 10.0), (K4, 20.0, 5.0), (K1, 40.0, 10.0), (K4, 55.0, 5.0), (K4, 70.0, 10.0),
            ("other", 90.0, 5.0)]


def _ctx(counters, device=(), window=(0.0, 1000.0)):
    spans = [T.Span(name, "kernel", ts, dur) for name, ts, dur in device]
    trace = T.TraceReading(CALLS, T.Span(T.WINDOW_LABEL, "user_annotation", window[0], window[1]), spans, [])
    kernels = S.read_json(S.BENCH / "layer_metrics" / "kernels.json")
    return types.SimpleNamespace(counters=counters, trace=trace, kernels=kernels, cell=S.Cell(CELL))


def test_k4_roofline_reads_the_thin_records():
    from benchmark.roofline import k4, peaks

    mod = S.load_module("layer_metrics", "k4_roofline")
    ctx = _ctx({"k4_launches": 3, "k4_cells": 1_321_984}, SEQUENCE)
    assert [s.ts for s in mod.records(ctx)] == [20.0, 55.0, 70.0]
    assert mod.read(ctx) == pytest.approx(100.0 * peaks.least_seconds(*k4.counts(1_321_984)) / 20e-6)
    assert mod.read(_ctx({"k4_launches": 6, "k4_cells": 2_643_968}, SEQUENCE)) is None   # three found
    assert mod.read(_ctx({}, SEQUENCE)) is None


@pytest.mark.parametrize("name,counters,want", [
    ("k4_launches_per_batch", {"k4_launches": 12}, 3.0),
    ("tempo_ms_per_batch", {"music_tempo_ns": 40_000_000}, 10.0),
])
def test_a_counting_reader_divides_its_totals_by_the_traced_calls(name, counters, want):
    mod = S.load_module("layer_metrics", name)
    assert set(mod.COUNTERS) == set(counters)
    assert mod.read(_ctx(counters)) == pytest.approx(want)
    assert mod.read(_ctx({})) is None


def test_device_idle_reads_the_busy_share():
    mod = S.load_module("layer_metrics", "device_idle_pct.catalog")
    assert mod.read(_ctx({}, SEQUENCE, (0.0, 200.0))) == pytest.approx(100.0 * (1 - 45.0 / 200.0))


def _fresh(name):
    path = S.BENCH / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name.replace('.', '_')}_fresh", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_program_without_the_counters_gives_none(monkeypatch):
    from sonido_sonar_tpu_torch.ops import hopper_onsets
    from sonido_sonar_tpu_torch.parallel import pipeline

    monkeypatch.delattr(hopper_onsets.thin_onsets_hopper, "cells")
    monkeypatch.delattr(hopper_onsets.thin_onsets_hopper, "launches")
    monkeypatch.delattr(pipeline, "MUSIC_TEMPO")
    for name in ("k4_roofline", "k4_launches_per_batch", "tempo_ms_per_batch"):
        mod = _fresh(name)
        assert mod.COUNTERS == {}
        assert mod.read(_ctx({}, SEQUENCE)) is None


def test_a_program_with_launches_but_no_cells_gives_no_roofline(monkeypatch):
    from sonido_sonar_tpu_torch.ops import hopper_onsets

    monkeypatch.delattr(hopper_onsets.thin_onsets_hopper, "cells")
    mod = _fresh("k4_roofline")
    assert mod.COUNTERS == {}
    assert mod.read(_ctx({"k4_launches": 3}, SEQUENCE)) is None
    assert _fresh("k4_launches_per_batch").read(_ctx({"k4_launches": 12}, SEQUENCE)) == pytest.approx(3.0)


def test_every_new_metric_is_in_the_spec_with_its_reader():
    spec = {m["name"]: m for m in S.load_spec()["per_layer"]}
    for name in NEW:
        assert spec[name]["workloads"] == [CELL]
        assert spec[name]["moves"] == "audio_h_per_h"
        assert (S.BENCH / "layer_metrics" / f"{name}.py").is_file()
    assert CELL in next(m for m in S.load_spec()["end_to_end"] if m["name"] == "audio_h_per_h")["workloads"]


# -- the spans -----------------------------------------------------------------

def test_the_music_spans_are_off_outside_a_profiler_session():
    from sonido_sonar_tpu_torch.parallel import pipeline

    spans = [pipeline.MUSIC_SPECTRAL, pipeline.MUSIC_CHROMA, pipeline.MUSIC_TEMPORAL, pipeline.MUSIC_TEMPO,
             pipeline.MUSIC_ENERGY, pipeline.MUSIC_HARMONIC]
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
