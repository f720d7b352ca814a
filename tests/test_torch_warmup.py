"""The port's cold-start hook (`warmup.py`, and the build directory and
lock of `_build.py`), a twin of tests/test_warmup.py.

JAX's test warms a persistent XLA cache in one process and finds hits in
a second. The port's one compiled artifact is the kernel library, which
only nvcc on a card machine builds (`chip_smoke.py` phase 40 runs the two
processes there). Here: `warmup(device="cpu")` runs every component at a
small shape and reports JAX's stage names; `enable_persistent_cache`
moves the library under the given directory with the same source-hash
name; and, with nvcc and the loader replaced by fakes, `build()` counts
loads from disk (`cache_hit_counter`) and builds once under its lock.
"""

import sys
import threading
import time

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from sonido_sonar_tpu.config.config import ContentType as JContentType  # noqa: E402
from sonido_sonar_tpu.config.config import FeatureConfig as JFeatureConfig  # noqa: E402
from sonido_sonar_tpu_torch import _build  # noqa: E402
from sonido_sonar_tpu_torch.config.config import ContentType, FeatureConfig  # noqa: E402

KW = dict(batch_sizes=(2,), clip_seconds=(0.5,), components=("fingerprint", "alignment", "search"),
          alignment_pairs=(1, 2), window_seconds=2.0, max_lag_seconds=0.5, corpus_sizes=(64,))


@pytest.fixture
def build_dir(monkeypatch, tmp_path):
    """_build's directory and counters as they were after the test."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "loads_from_disk", _build.loads_from_disk)
    _build.build.cache_clear()
    yield tmp_path / "kernels"
    _build.build.cache_clear()


def test_warmup_runs_every_component_with_jax_stage_names():
    """Every component at each shape, on zeros, on the CPU: the report's
    keys equal JAX's warmup at the same arguments, each a time."""
    from sonido_sonar_tpu.warmup import warmup as jwarmup
    from sonido_sonar_tpu_torch.warmup import warmup

    geom = dict(sample_rate=8000, window_size=256, hop_size=128)
    got = warmup(FeatureConfig(**geom), content_types=[ContentType.UNKNOWN, ContentType.MUSIC],
                 group_buckets=True, device="cpu", **KW)
    want = jwarmup(JFeatureConfig(**geom), content_types=[JContentType.UNKNOWN, JContentType.MUSIC],
                   group_buckets=True, **KW)
    assert list(got) == list(want) == ["fingerprint[b=2,s=0.5]", "alignment[pairs=1]",
                                       "alignment[pairs=2]", "search[corpus=64]"]
    assert all(v >= 0.0 for v in got.values())
    assert list(warmup(FeatureConfig(**geom), components=("search",), device="cpu")) == []


def test_enable_persistent_cache_moves_the_library(build_dir):
    """The library path moves under cache_dir, keyed by the same source
    hash; later calls win; no library is built on the CPU."""
    from sonido_sonar_tpu_torch.warmup import enable_persistent_cache, warmup

    name = f"libsonido_kernels_{_build.source_hash()}.so"
    enable_persistent_cache(str(build_dir / "a"))
    assert _build.library_path() == build_dir / "a" / name
    enable_persistent_cache(str(build_dir / "b"), min_compile_time_secs=0.0)
    assert _build.library_path() == build_dir / "b" / name
    warmup(FeatureConfig(8000, 256, 128), components=("search",), corpus_sizes=(8,),
           cache_dir=str(build_dir / "c"), device="cpu")
    assert _build.library_path() == build_dir / "c" / name
    assert not build_dir.exists()
    with pytest.raises(ValueError):
        enable_persistent_cache(str(build_dir), min_compile_time_secs=-1.0)


class _FakeLib:
    def __getattr__(self, name):
        fn = lambda *a: 0  # noqa: E731
        setattr(self, name, fn)
        return fn


def _fake_toolchain(monkeypatch, runs, delay=0.0):
    def nvcc(_nvcc, out):
        with runs[1]:
            runs[0] += 1
        time.sleep(delay)
        out.write_bytes(b"library")
        return "ptxas info"

    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run_nvcc", nvcc)
    monkeypatch.setattr(_build, "_load", lambda path: _FakeLib())


def test_cache_hit_counter_counts_loads_from_disk(build_dir, monkeypatch):
    """The first process runs nvcc (no hit); a later one, pointed at the
    same directory, loads the library without nvcc (one hit)."""
    from sonido_sonar_tpu_torch.warmup import cache_hit_counter, enable_persistent_cache

    runs = [0, threading.Lock()]
    _fake_toolchain(monkeypatch, runs)
    hits = cache_hit_counter()
    enable_persistent_cache(str(build_dir))
    info = _build.build()[1]
    assert (runs[0], hits(), info.path.parent) == (1, 0, build_dir)
    assert info.seconds > 0.0 and info.compiler_log == "ptxas info"
    _build.build()
    assert hits() == 0  # the same process keeps its library
    enable_persistent_cache(str(build_dir))  # as a second process would
    again = cache_hit_counter()
    info = _build.build()[1]
    assert (runs[0], hits(), again(), info.seconds) == (1, 1, 1, 0.0)


def test_concurrent_first_builds_run_nvcc_once(build_dir, monkeypatch):
    """Builders that start at once take the directory's lock in turn: one
    runs nvcc, the others load its library."""
    runs = [0, threading.Lock()]
    _fake_toolchain(monkeypatch, runs, delay=0.3)
    _build.use_build_dir(build_dir)
    paths, errors = [], []

    def first_use():
        try:
            paths.append(_build.build.__wrapped__()[1].path)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert runs[0] == 1 and len(paths) == 4 and len(set(paths)) == 1
    assert sorted(p.name for p in build_dir.iterdir()) == sorted([paths[0].name, paths[0].with_suffix(".log").name])


def test_both_import_forms():
    """The package exports `warmup` and `enable_persistent_cache`, as
    JAX's does, and the submodule stays importable by name; as in JAX the
    function shadows the submodule as a package attribute."""
    import sonido_sonar_tpu_torch as port
    from sonido_sonar_tpu_torch import enable_persistent_cache, warmup
    from sonido_sonar_tpu_torch.warmup import cache_hit_counter
    from sonido_sonar_tpu_torch.warmup import enable_persistent_cache as epc
    from sonido_sonar_tpu_torch.warmup import warmup as w

    module = sys.modules["sonido_sonar_tpu_torch.warmup"]
    assert warmup is w is module.warmup and enable_persistent_cache is epc
    assert callable(cache_hit_counter) and port.warmup is warmup
    import sonido_sonar_tpu_torch.warmup as bound
    assert bound is warmup
