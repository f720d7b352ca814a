"""The port's public entry point at upstream's default 2048/512, content
detection on and strict routing, held to the benchmark's plain
reference of the same deployment (`benchmark/reference/
content_fingerprint.py`) on eight seeded 3 s clips of the benchmark's
broadcast traffic (speech, music, crowd noise and noise beds): the
detected content types equal, and every number the cell
`generator.archive-mixed-30s` compares within that cell's limit, one
case per content-type group and one through `materialize=False`. Then
the generator's spans and host-sync counts on a traced batch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark.core import spec as S  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import content_detector as CD  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import generator as G  # noqa: E402
from sonido_sonar_tpu_torch.io.audio import AudioData  # noqa: E402
from sonido_sonar_tpu_torch.utils import metrics as M  # noqa: E402

CELL = "generator.archive-mixed-30s"
SEED = 3          # eight 3 s clips that the detector puts in four groups
GROUPS = ["music", "news", "sports", "unknown"]
SR = 44100


@pytest.fixture(scope="module")
def batch():
    cell = S.Cell(CELL)
    traffic = dict(cell.traffic, batch=8, clip_seconds=3, distinct=1, speech=3, music=2, crowd=2, beds=1)
    pcm = S.load_module("traffic", "broadcast_clips").make(traffic, SEED, "cpu", SR)[0]
    reference = S.load_module("reference", cell.config["reference"])
    driver = S.load_module("drivers", cell.config["driver"])
    return {"pcm": pcm, "cell": cell, "reference": reference, "driver": driver,
            "want": reference.fingerprints(pcm, cell.config)}


def _generate(pcm, materialize=True):
    gen = FingerprintGenerator(device="cpu")
    return gen.generate_fingerprints_batch([AudioData(r, SR) for r in pcm], pcm_matrix=pcm,
                                           materialize=materialize)


def _within_limits(b, got, clips):
    """Every number of the cell over `clips`, each within the cell's limit."""
    pick = lambda d: {"types": [d["types"][i] for i in clips], "subtypes": [d["subtypes"][i] for i in clips],
                      "rows": [d["rows"][i] for i in clips]}
    readings = b["reference"].compare([pick(got)], [pick(b["want"])])
    limits = b["cell"].check["limits"]
    assert set(readings) == set(limits)
    over = {k: (v, limits[k]) for k, v in readings.items() if not v <= limits[k]}
    assert not over, over


def test_types_match_the_reference_and_cover_three_groups(batch):
    got = batch["driver"].as_checked(_generate(batch["pcm"]))
    assert got["types"] == batch["want"]["types"]
    assert got["subtypes"] == batch["want"]["subtypes"] == ["news"] * 8   # strict routing
    assert sorted(set(got["types"])) == GROUPS


@pytest.mark.parametrize("group", GROUPS)
def test_a_groups_features_match_the_reference(batch, group):
    got = batch["driver"].as_checked(_generate(batch["pcm"]))
    clips = [i for i, t in enumerate(batch["want"]["types"]) if t == group]
    assert clips
    keys = set(got["rows"][clips[0]])
    assert ("speech_features.jitter" in keys) == (group == "news")
    assert ("temporal_features.onset_mask" in keys) == (group != "music")
    _within_limits(batch, got, clips)


def test_materialize_later_gives_the_same_fingerprints(batch):
    fb = _generate(batch["pcm"], materialize=False)
    assert all(fp.features is None for fp in fb.fingerprints)
    later = batch["driver"].as_checked(fb.materialize())
    now = batch["driver"].as_checked(_generate(batch["pcm"]))
    assert later["types"] == now["types"]
    for a, b in zip(later["rows"], now["rows"]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    _within_limits(batch, later, list(range(8)))


def test_a_traced_batch_counts_its_spans_and_host_syncs(batch):
    spans = [G.DETECT, CD.DETECT_WAIT, G.EXTRACT, G.MATERIALIZE, G.ASSEMBLE]
    before = {s.name: s.count for s in spans}
    syncs = M.host_syncs
    fps = _generate(batch["pcm"])                    # untraced: the spans stay off
    assert {s.name: s.count for s in spans} == before
    n_tensors = sum(len(batch["driver"].flat(fps[i].features))
                    for i in [batch["want"]["types"].index(g) for g in GROUPS])
    assert M.host_syncs - syncs == 1 + n_tensors      # the [K, 9] copy, then each tensor once
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _generate(batch["pcm"])
    got = {s.name: s.count - before[s.name] for s in spans}
    assert got == {"generator.detect": 1, "generator.detect_wait": 1, "generator.extract": 4,
                   "generator.materialize": 4, "generator.assemble": 8}
    names = {e.name for e in prof.events()}
    assert {s.name for s in spans} <= names
