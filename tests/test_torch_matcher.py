"""The port's single-device matcher (`parallel/matcher.py`) held to the
JAX package's on the CPU: the host packers equal (float64 numpy in both,
the same expressions), the segment cosines within
utils/parity.COMPARATOR_PORT_ATOL, the top-k indices equal (ties lowest
index first in both); the sharded cases are in tests/test_torch_mesh.py."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

from sonido_sonar_tpu.parallel import matcher as J  # noqa: E402
from sonido_sonar_tpu_torch.parallel import matcher as T  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402
from sonido_sonar_tpu_torch.utils.convert import fingerprint_from_reference  # noqa: E402

from tests.test_device_compare import _random_corpus  # noqa: E402


def _corpus(seed, n, present=frozenset({"mfcc", "chroma", "spectral"})):
    jfps = _random_corpus(np.random.default_rng(seed), n, present=set(present))
    return jfps, [fingerprint_from_reference(fp) for fp in jfps]


def test_pack_statistics_and_matrix_match_jax():
    """pack_statistics, corpus_mfcc_width and fingerprint_matrix equal
    JAX's, absent groups (zeros) and a one-frame spectral series (std 0)
    included; identical fingerprints give identical vectors."""
    jfps, fps = _corpus(1, 12)
    jpart, part = _corpus(2, 6, present=frozenset({"spectral"}))
    one = _random_corpus(np.random.default_rng(3), 1, present={"mfcc", "spectral"})[0]
    sf = one.features.spectral_features
    sf.spectral_centroid, sf.spectral_rolloff, sf.spectral_flux = (
        sf.spectral_centroid[:1], sf.spectral_rolloff[:1], sf.spectral_flux[:1])
    jfps, fps = jfps + jpart + [one], fps + part + [fingerprint_from_reference(one)]
    assert T.corpus_mfcc_width(fps) == J.corpus_mfcc_width(jfps) == 13
    assert T.corpus_mfcc_width(part, default=20) == J.corpus_mfcc_width(jpart, default=20) == 20
    for fp, jfp in zip(fps, jfps):
        np.testing.assert_array_equal(T.pack_statistics(fp), J.pack_statistics(jfp))
    got = T.fingerprint_matrix(fps)
    np.testing.assert_array_equal(got, J.fingerprint_matrix(jfps))
    assert got.dtype == np.float32 and got.shape == (19, 44) and np.isfinite(got).all()
    np.testing.assert_array_equal(T.pack_statistics(fps[0]), T.pack_statistics(fps[0]))
    with pytest.raises(ValueError, match="expects 20"):
        T.pack_statistics(fps[0], num_mfcc_coeffs=20)


def test_segment_cosines_and_top_k_match_jax():
    """segment_cosine_similarities within COMPARATOR_PORT_ATOL of JAX's;
    sharded_top_k_matches (mesh=None) with the same indices as JAX's,
    among them rows duplicated so that scores tie."""
    _, fps = _corpus(4, 40)
    corpus = T.fingerprint_matrix(fps)
    corpus[[9, 17, 30]] = corpus[5]                 # three re-runs of row 5
    w = np.array([0.40, 0.20, 0.25], np.float32)
    for qi in (5, 0, 12):
        got = T.segment_cosine_similarities(corpus[qi], corpus, w, device="cpu")
        want = np.asarray(J.segment_cosine_similarities(corpus[qi], corpus, w))
        np.testing.assert_allclose(got.numpy(), want, atol=parity.COMPARATOR_PORT_ATOL, rtol=0)
        idx, scores = T.sharded_top_k_matches(corpus[qi], corpus, k=6, mesh=None, device="cpu")
        jidx, jscores = jax.device_get(J.sharded_top_k_matches(corpus[qi], corpus, k=6, mesh=None))
        np.testing.assert_array_equal(idx, jidx)
        assert idx.dtype == np.int32 and scores.dtype == np.float32
        np.testing.assert_allclose(scores, jscores, atol=parity.COMPARATOR_PORT_ATOL, rtol=0)
    idx, _ = T.sharded_top_k_matches(corpus[5], corpus, k=4, device="cpu")
    assert idx.tolist() == [5, 9, 17, 30]
    idx, _ = T.sharded_top_k_matches(corpus[2], corpus[:3], k=10, device="cpu")
    assert idx[0] == 2 and len(idx) == 3
