"""The port's public entry point on a tagged music catalogue at upstream's
default 2048/512, routing not strict, held to the benchmark's plain
reference of the same deployment (`benchmark/reference/
music_fingerprint.py`) on eight seeded 3 s clips of the benchmark's
`music_catalog` traffic (six rhythmic, two beatless): every clip typed
music from its metadata and given `MusicFeatureExtractor` in one
extractor call, every number the cell `catalog.music-tagged-30s`
compares within that cell's limit, and the key correlations and chords,
which the fingerprint does not carry, within the cell's `tonal_limits`.
Then a traced batch's spans: one extractor call, no detection wait, each
`music.*` stage once, and the three onset thinnings K4 takes on the card
with the cells its counter adds. Last, where the zero-crossing rates
differ at 30 s: only in frames where the preprocessing's last float32
bits put a sample within 1e-6 of zero on the other side."""

import pytest

torch = pytest.importorskip("torch")

from benchmark.core import spec as S  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import content_detector as CD  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import generator as G  # noqa: E402
from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata  # noqa: E402
from sonido_sonar_tpu_torch.ops import hopper_onsets  # noqa: E402
from sonido_sonar_tpu_torch.parallel import pipeline as P  # noqa: E402

CELL = "catalog.music-tagged-30s"
SEED = 7
SR = 44100
MUSIC_SPANS = [P.MUSIC_SPECTRAL, P.MUSIC_CHROMA, P.MUSIC_TEMPORAL, P.MUSIC_TEMPO, P.MUSIC_ENERGY,
               P.MUSIC_HARMONIC]


@pytest.fixture(scope="module")
def batch():
    cell = S.Cell(CELL)
    traffic = dict(cell.traffic, batch=8, clip_seconds=3, distinct=1, rhythmic=6, beatless=2)
    pcm = S.load_module("traffic", "music_catalog").make(traffic, SEED, "cpu", SR)[0]
    reference = S.load_module("reference", cell.config["reference"])
    driver = S.load_module("drivers", cell.config["driver"])
    return {"pcm": pcm, "cell": cell, "reference": reference, "driver": driver,
            "want": reference.fingerprints(pcm, cell.config)}


def _generate(pcm):
    tag = AudioMetadata(extra={"content_type": "music"})
    gen = FingerprintGenerator(strict_reference_routing=False, device="cpu")
    return gen.generate_fingerprints_batch([AudioData(r, SR, metadata=tag) for r in pcm], pcm_matrix=pcm)


def test_every_clip_is_music_through_the_music_extractor(batch):
    fps = _generate(batch["pcm"])
    got = batch["driver"].as_checked(fps)
    assert got["types"] == batch["want"]["types"] == ["music"] * 8
    assert got["subtypes"] == batch["want"]["subtypes"]
    assert {fp.metadata["extractor_name"] for fp in fps} == {"MusicFeatureExtractor"}
    assert set(got["rows"][0]) == set(batch["want"]["rows"][0])


def test_every_number_is_within_the_cells_limit(batch):
    got = batch["driver"].as_checked(_generate(batch["pcm"]))
    readings = batch["reference"].compare([got], [batch["want"]])
    limits = batch["cell"].check["limits"]
    assert set(readings) == set(limits)
    over = {k: (v, limits[k]) for k, v in readings.items() if not v <= limits[k]}
    assert not over, over


def test_keys_and_chords_are_within_the_cells_tonal_limits(batch):
    cfg = batch["cell"].config
    got = P.batched_music_extractor_features(batch["pcm"], SR, cfg["window_size"], cfg["hop_size"],
                                             device="cpu")
    want = batch["reference"].music_features(batch["pcm"], cfg)
    assert set(batch["reference"].TONAL_KEYS) <= set(got)
    readings = batch["reference"].tonal_numbers(got, want)
    limits = batch["cell"].check["tonal_limits"]
    assert set(readings) == set(limits)
    over = {k: (v, limits[k]) for k, v in readings.items() if not v <= limits[k]}
    assert not over, over


def test_a_traced_batch_enters_each_music_stage_once(batch, monkeypatch):
    shapes = []
    real = hopper_onsets.thin_onsets_hopper

    def spy(cand, min_frames):
        shapes.append(tuple(cand.shape))
        return real(cand, min_frames)

    monkeypatch.setattr(hopper_onsets, "thin_onsets_hopper", spy)
    spans = [G.DETECT, CD.DETECT_WAIT, G.EXTRACT, G.MATERIALIZE, G.ASSEMBLE] + MUSIC_SPANS
    before = {s.name: s.count for s in spans}
    counters = (real.launches, real.cells)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _generate(batch["pcm"])
    got = {s.name: s.count - before[s.name] for s in spans}
    assert got == {"generator.detect": 1, "generator.detect_wait": 0, "generator.extract": 1,
                   "generator.materialize": 1, "generator.assemble": 2,
                   **{s.name: 1 for s in MUSIC_SPANS}}
    names = {e.name for e in prof.events()}
    assert {s.name for s in MUSIC_SPANS} <= names and CD.DETECT_WAIT.name not in names
    # K4 three times: the payload's flux onsets [8, 255], the tempo's flux
    # [8, 257] and energy [8, 515] onsets; on a CPU tensor the plain
    # version runs and the kernel's counters stay as they were
    assert shapes == [(8, 255), (8, 257), (8, 515)]
    assert (real.launches, real.cells) == counters


def test_zero_crossings_differ_only_where_a_near_zero_sample_changes_sign():
    # 30 s clips, as the cell's; this seed's clips hold three such frames
    from sonido_sonar_tpu_torch.ops import spectral
    from sonido_sonar_tpu_torch.ops.filters import dc_removal, pre_emphasis_for_content

    cell = S.Cell(CELL)
    cfg = cell.config
    traffic = dict(cell.traffic, batch=4, distinct=1, rhythmic=3, beatless=1)
    x = S.load_module("traffic", "music_catalog").make(traffic, 2801200001, "cpu", SR)[0]
    reference = S.load_module("reference", cfg["reference"])
    w, hop = cfg["window_size"], cfg["hop_size"]
    pre = pre_emphasis_for_content(dc_removal(x), "music")
    want_pre = reference.FF.pre_emphasis(reference.dc_removal(x, cfg["dc_pole"]), cfg["pre_emphasis"])
    got = spectral.zcr_from_signal(pre, w, hop, SR)
    assert torch.equal(got, reference.zcr(pre, w, hop, SR))      # the count itself is exact
    moved = (pre >= 0) != (want_pre >= 0)
    assert float(torch.amax(torch.abs(want_pre[moved]))) < 1e-6
    frames_moved = torch.any(reference.frames_of(moved, w, hop), dim=-1)
    differ = got != reference.zcr(want_pre, w, hop, SR)
    assert int(differ.sum()) > 0 and not bool((differ & ~frames_moved).any())
