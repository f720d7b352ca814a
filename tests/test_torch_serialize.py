"""The port's fingerprint serialization (`utils/serialize.py`) held to
the JAX package's format: an .npz the JAX package writes loads in the
port bit for bit, one the port writes loads in the JAX package bit for
bit, and both write the same JSON. Dtypes are kept (float64, float32,
int32 and bool leaves); a fingerprint whose leaves are tensors writes
what the same fingerprint with numpy leaves writes."""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from sonido_sonar_tpu.utils import serialize as J  # noqa: E402
from sonido_sonar_tpu_torch.extractors.features import map_tensors  # noqa: E402
from sonido_sonar_tpu_torch.fingerprint import FingerprintComparator  # noqa: E402
from sonido_sonar_tpu_torch.utils import (  # noqa: E402
    fingerprint_to_json,
    load_fingerprint_npz,
    save_fingerprint_npz,
)
from sonido_sonar_tpu_torch.utils.convert import features_to_numpy, fingerprint_from_reference  # noqa: E402

from tests.test_device_compare import _random_corpus  # noqa: E402
from tests.test_goref_parity import _GROUPS  # noqa: E402


@pytest.fixture
def jfp():
    """A JAX fingerprint with every feature group, some float32, int32
    and bool leaves, and the metadata the header carries."""
    fp = _random_corpus(np.random.default_rng(3), 1, present=set(_GROUPS))[0]
    f = fp.features
    f.mfcc = f.mfcc.astype(np.float32)
    f.speech_features.formant_count = np.int32(3)
    f.temporal_features.onset_mask = np.array([True, False, True])
    f.temporal_features.dynamic_range = np.float32(f.temporal_features.dynamic_range)
    fp.metadata = {"feature_weights": {"mfcc": 0.5, "chroma": 0.2}, "extractor_name": "SpeechFeatureExtractor"}
    return fp


def _same(got, want):
    """Header fields equal; every leaf equal bit for bit, dtype and shape
    included."""
    for key in ("id", "stream_url", "timestamp", "duration", "sample_rate", "hop_size", "channels"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.content_type.value == want.content_type.value
    assert got.metadata == want.metadata
    a, b = features_to_numpy(got.features), features_to_numpy(want.features)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_jax_npz_loads_in_the_port(tmp_path, jfp):
    path = str(tmp_path / "jax.npz")
    J.save_fingerprint_npz(path, jfp)
    got = load_fingerprint_npz(path)
    _same(got, J.load_fingerprint_npz(path))
    _same(got, fingerprint_from_reference(jfp))
    # a loaded fingerprint compares as identical to its source
    res = FingerprintComparator(device="cpu").compare(fingerprint_from_reference(jfp), got)
    assert res.overall_similarity == pytest.approx(1.0, abs=1e-12)


def test_port_npz_loads_in_jax_and_json_is_the_same(tmp_path, jfp):
    fp = fingerprint_from_reference(jfp)
    path = str(tmp_path / "port.npz")
    save_fingerprint_npz(path, fp)
    _same(fingerprint_from_reference(J.load_fingerprint_npz(path)), fp)
    _same(load_fingerprint_npz(path), fp)
    blob = fingerprint_to_json(fp)
    assert blob == J.fingerprint_to_json(jfp)
    assert len(json.loads(blob)["features"]["mfcc"]) == jfp.features.mfcc.shape[0]


def test_tensor_leaves_write_as_numpy(tmp_path, jfp):
    fp = fingerprint_from_reference(jfp)
    tfp = dataclasses.replace(fp, features=map_tensors(torch.from_numpy, fp.features))
    assert isinstance(tfp.features.mfcc, torch.Tensor)
    save_fingerprint_npz(str(tmp_path / "t.npz"), tfp)
    _same(load_fingerprint_npz(str(tmp_path / "t.npz")), fp)
    assert fingerprint_to_json(tfp) == fingerprint_to_json(fp)
