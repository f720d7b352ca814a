"""The tagged music catalogue on the card: two batches of the benchmark
cell `catalog.music-tagged-30s`'s driver (`benchmark/drivers/
tagged_generator.py`, 128 clips of 30 s tagged music, 2048/512, routing
not strict) held to its plain reference (`benchmark/reference/
music_fingerprint.py`) at the cell's limits; each batch one music group
that launches K1 twice, K4 three times over the cells its counter adds,
and K9 once; the music program's key correlations and chords at the
cell's `tonal_limits`. Marked `card`, skips without a CUDA device:

    python3 -m pytest --noconftest -q -p no:cacheprovider -m card tests/test_torch_card_catalog.py
"""

from __future__ import annotations

import pytest
import torch

from benchmark.core import spec as S
from card_support import card, counted  # noqa: F401  (card: the session fixture)
from sonido_sonar_tpu_torch.ops.hopper_onsets import thin_onsets_hopper
from sonido_sonar_tpu_torch.parallel import pipeline

pytestmark = pytest.mark.card

CELL = "catalog.music-tagged-30s"
SEED = 2**31 + 2802


@pytest.fixture(scope="module")
def catalog(card):
    cell = S.Cell(CELL)
    driver = S.load_module("drivers", cell.config["driver"]).Driver(
        cell.config, dict(cell.traffic, distinct=2), cell.check, SEED, card.dev)
    return cell, driver, S.load_module("reference", cell.config["reference"])


def _within(readings: dict, limits: dict) -> None:
    print({k: f"{v:.3e}" for k, v in readings.items()})
    assert set(readings) == set(limits)
    over = {k: (v, limits[k]) for k, v in readings.items() if not v <= limits[k]}
    assert not over, over


@pytest.mark.parametrize("i", [0, 1])
def test_a_batch_matches_the_reference_at_the_cells_limits(catalog, i):
    cell, driver, reference = catalog
    cells = thin_onsets_hopper.cells
    fps, launches = counted(lambda: driver.gen.generate_fingerprints_batch(
        driver.audios[i], pcm_matrix=driver.batches[i], materialize=True))
    d = cell.config["derived"]
    assert thin_onsets_hopper.cells - cells == d["k4_cells_per_batch"] == cell.config["batch"] * (
        d["frames"] + d["tempo_flux_frames"] + d["tempo_energy_frames"])
    assert {k: v for k, v in launches.items() if v} == {"K1": 2, "K4": 3, "K9": 1}
    assert {fp.metadata["extractor_name"] for fp in fps} == {"MusicFeatureExtractor"}
    got = S.load_module("drivers", cell.config["driver"]).as_checked(fps)
    _within(reference.compare([got], [reference.fingerprints(driver.batches[i], cell.config)]),
            cell.check["limits"])


def test_keys_and_chords_match_the_reference_at_the_cells_tonal_limits(catalog):
    cell, driver, reference = catalog
    cfg = cell.config
    got = pipeline.batched_music_extractor_features(driver.batches[0], cfg["sample_rate"], cfg["window_size"],
                                                    cfg["hop_size"])
    torch.cuda.synchronize()
    _within(reference.tonal_numbers(got, reference.music_features(driver.batches[0], cfg)),
            cell.check["tonal_limits"])
