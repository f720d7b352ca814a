"""The port's package exports held to the JAX package's.

For each `__init__.py` of `sonido_sonar_tpu/`, the names it imports from
a module that the port also has must import from the port's package of
the same path (`from sonido_sonar_tpu_torch.extractors import
SpeechFeatureExtractor`, as `from sonido_sonar_tpu.extractors import
SpeechFeatureExtractor`). Names that a ported module still lacks would
be listed in NOT_PORTED, so the list stays exact; it is empty. Names the
port dropped on purpose are listed in DROPPED, with the reason. The JAX
`__init__` files are read as source, not imported.

Also two functions whose JAX name or signature the port once differed
from: `content_detector.batched_acoustic_features_device` and the
four-argument `ops/speech.formant_confidence(freq, amp, bw, max_amp)`.
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.fingerprint import content_detector as jcd  # noqa: E402
from sonido_sonar_tpu.ops import speech as jspeech  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import content_detector as tcd  # noqa: E402
from sonido_sonar_tpu_torch.ops import speech as tspeech  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = "sonido_sonar_tpu", "sonido_sonar_tpu_torch"
# the JAX packages that the port also has
JAX_INITS = sorted(p.relative_to(ROOT / JAX_PKG).parent.as_posix()
                   for p in (ROOT / JAX_PKG).rglob("__init__.py")
                   if (ROOT / PORT_PKG / p.relative_to(ROOT / JAX_PKG)).is_file())
# (port module, name): exported by a JAX __init__, the module ported,
# the name not yet
NOT_PORTED = set()
# (port module, name): exported by a JAX __init__, left out of the port on
# purpose. The port's spans and counters are module-level objects where
# the work happens (utils/metrics.py); a process-global Metrics is gone.
DROPPED = {("sonido_sonar_tpu_torch.utils.metrics", "get_global_metrics")}


def _port_module_exists(module: str) -> bool:
    path = ROOT.joinpath(*module.split("."))
    return path.with_suffix(".py").is_file() or (path / "__init__.py").is_file()


def _jax_exports(package: str):
    """(port module, name) for every `from sonido_sonar_tpu... import`
    at the top of a JAX package's __init__, its module mapped into the
    port."""
    init = ROOT / JAX_PKG / package / "__init__.py"
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(JAX_PKG):
            module = PORT_PKG + node.module[len(JAX_PKG):]
            for alias in node.names:
                yield module, alias.asname or alias.name


@pytest.mark.parametrize("package", JAX_INITS)
def test_jax_exports_import_from_the_port(package):
    """Every JAX export whose module the port has imports from the port's
    package of the same path, as the same object as in its module."""
    port_pkg = importlib.import_module(PORT_PKG if package == "." else
                                       f"{PORT_PKG}.{package.replace('/', '.')}")
    lacking, missing = set(), []
    for module, name in _jax_exports(package):
        if not _port_module_exists(module):
            continue
        mod = importlib.import_module(module)
        if not hasattr(mod, name):
            lacking.add((module, name))
        elif getattr(port_pkg, name, None) is not getattr(mod, name):
            missing.append(name)
    assert not missing, f"{port_pkg.__name__} does not export {missing}"
    assert lacking == (NOT_PORTED | DROPPED) & set(_jax_exports(package))


def test_the_reported_imports_work():
    from sonido_sonar_tpu_torch import ContentType, FeatureConfig  # noqa: F401
    from sonido_sonar_tpu_torch.config import get_content_configs
    from sonido_sonar_tpu_torch.extractors import (  # noqa: F401
        ExtractedFeatures,
        MusicFeatureExtractor,
        SpeechFeatureExtractor,
        create_extractor,
    )
    from sonido_sonar_tpu_torch.fingerprint import AcousticFeatures  # noqa: F401
    from sonido_sonar_tpu_torch.parallel import batched_fingerprint_features, batched_pair_dtw

    assert batched_fingerprint_features.__module__ == "sonido_sonar_tpu_torch.parallel.pipeline"
    assert callable(batched_pair_dtw) and get_content_configs()
    assert isinstance(create_extractor(ContentType.NEWS, FeatureConfig()), SpeechFeatureExtractor)


def test_batched_acoustic_features_device_is_the_jax_name():
    """The same function under both names; against JAX's at the bounds of
    tests/test_torch_generator.py (decision means equal, float32 sums
    rtol 1e-4, the dB range atol 1e-3)."""
    assert tcd.batched_acoustic_features_device is tcd.batched_acoustic_features
    x = np.random.default_rng(7).standard_normal((2, 8000)).astype(np.float32)
    got = tcd.batched_acoustic_features_device(torch.from_numpy(x), 16000).numpy()
    ref = np.asarray(jcd.batched_acoustic_features_device(jnp.asarray(x), 16000))
    np.testing.assert_allclose(got[:, [0, 3]], ref[:, [0, 3]], atol=1e-7)
    np.testing.assert_allclose(got[:, [1, 2, 5, 6, 7, 8]], ref[:, [1, 2, 5, 6, 7, 8]],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[:, 4], ref[:, 4], atol=1e-3)


def test_formant_confidence_takes_jax_four_arguments():
    """freq first, unused, as in JAX (ops/speech.py:209); float32 rounding
    of the same two scores only."""
    rng = np.random.default_rng(8)
    freq, amp = rng.uniform(50, 4000, (3, 4)), rng.uniform(0, 2, (3, 4))
    bw, max_amp = rng.uniform(0, 1500, (3, 4)), np.array([[2.0], [0.0], [1.5]])
    args = [a.astype(np.float32) for a in (freq, amp, bw, max_amp)]
    got = tspeech.formant_confidence(*map(torch.from_numpy, args)).numpy()
    ref = np.asarray(jspeech.formant_confidence(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[1], 0.4 * np.clip(1 - args[2][1] / 1000, 0, 1), rtol=1e-6)
