"""The port's main path, `batched_fingerprint_features`, held to the JAX
package's on the CPU, key by key; and the modules between its two
kernels held to theirs on the same magnitudes.

On the CPU JAX takes its XLA branch (parallel/pipeline.py:123-187): rms,
zero crossings and rolloff from frames and the descriptor bundle's
cumsum, pitch from pre_emphasis + frames. The port follows the kernel
branch on every device, so its plain K1 aux must reproduce those.
Tolerances are those of sonido_sonar_tpu_torch/utils/parity.py, where
each has its reason.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.ops import chroma as jchroma  # noqa: E402
from sonido_sonar_tpu.ops import mfcc as jmfcc  # noqa: E402
from sonido_sonar_tpu.ops import spectral as jspectral  # noqa: E402
from sonido_sonar_tpu.ops import temporal as jtemporal  # noqa: E402
from sonido_sonar_tpu.ops.stft import spectral_flux as j_flux  # noqa: E402
from sonido_sonar_tpu.ops.stft import stft as j_stft  # noqa: E402
from sonido_sonar_tpu.parallel.pipeline import (  # noqa: E402
    batched_fingerprint_features as jax_features,
)
from sonido_sonar_tpu_torch.ops import chroma as tchroma  # noqa: E402
from sonido_sonar_tpu_torch.ops import mfcc as tmfcc  # noqa: E402
from sonido_sonar_tpu_torch.ops import spectral as tspectral  # noqa: E402
from sonido_sonar_tpu_torch.ops import temporal as ttemporal  # noqa: E402
from sonido_sonar_tpu_torch.ops.stft import spectral_flux as t_flux  # noqa: E402
from sonido_sonar_tpu_torch.parallel.pipeline import (  # noqa: E402
    batched_fingerprint_features as torch_features,
)
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)
SR = 44100


def _pcm(batch, n, seed):
    return parity.synth_pcm(batch, n, seed, SR).numpy()


def _compare(x, **kw):
    ref = {k: np.asarray(v) for k, v in jax_features(jnp.asarray(x), **kw).items()}
    got = {k: v.numpy() for k, v in torch_features(torch.from_numpy(x), **kw).items()}
    w = kw.get("window_size", 1024)
    near = parity.near_zero_frames(
        x, w, kw.get("hop_size", 256), kw.get("pre_emphasis_coeff", 0.97)
    )
    errors, failures = parity.check_features(got, ref, near, kw.get("sample_rate", SR), w)
    assert not failures, (failures, errors)
    return got, errors


@pytest.mark.parametrize("batch,n,seed", [(2, SR, 0), (4, 4 * SR, 1)])
def test_whole_slice_matches_jax(batch, n, seed):
    """[2, 44100] and a 4 s batch; rows 0-2 tonal, row 3 white noise."""
    got, errors = _compare(_pcm(batch, n, seed))
    assert len(got) == 19
    assert errors["voiced_share"] > 0.5
    assert all(v.dtype == np.float32 for v in got.values())


@pytest.mark.parametrize(
    "flags",
    [
        dict(enable_chroma=False),
        dict(enable_contrast=False, enable_pitch=False),
        dict(pre_emphasis_coeff=0.0, mfcc_coefficients=20),
        dict(window_size=2048, hop_size=512, sample_rate=22050),
    ],
)
def test_flags_and_geometries_match_jax(flags):
    got, _ = _compare(_pcm(2, SR, 2), **flags)
    assert ("chroma" in got) == flags.get("enable_chroma", True)
    assert ("spectral_contrast" in got) == flags.get("enable_contrast", True)
    assert ("pitch" in got) == flags.get("enable_pitch", True)


@pytest.mark.parametrize("sr,window,hop", [(16000, 1024, 256), (8000, 512, 128)])
def test_zcr_rates_match_jax(sr, window, hop):
    """The whole slice at 16 kHz and 8 kHz, ZCR bit-equal to JAX (its
    exact gate): at these rates torch's exact CPU division by W / sr and
    JAX's multiplication by the float32 reciprocal round some frames
    differently, so the port scales by that reciprocal
    (ops/spectral.per_second)."""
    x = parity.synth_pcm(2, sr, 3, sr).numpy()
    got, _ = _compare(x, sample_rate=sr, window_size=window, hop_size=hop)
    assert len(got) == 19
    if sr == 16000:  # the case rounds differently under an exact division
        counts = torch.from_numpy(got["zcr"]) * (window / float(sr))
        exact = torch.round(counts) / (window / float(sr))
        assert (exact.numpy() != got["zcr"]).any()


def test_input_cast_to_float32():
    x = _pcm(2, SR // 2, 3)
    a = torch_features(torch.from_numpy(x))
    b = torch_features(torch.from_numpy(x.astype(np.float64)))
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def magnitudes():
    """One JAX magnitude tensor [4, T, F] fed to both packages' modules."""
    x = _pcm(4, 2 * SR, 4)
    return np.asarray(j_stft(jnp.asarray(x), 1024, 256, sample_rate=SR).magnitude)


def test_mfcc_and_chroma_on_same_magnitudes(magnitudes):
    """MFCC atol 1e-3 (the log of mel energies, JAX MFCC tests' bound);
    chroma atol 1e-5 (unit-sum fractions)."""
    m = torch.from_numpy(magnitudes)
    for params in (jmfcc.MFCCParams(), jmfcc.MFCCParams(num_coefficients=20, num_mel_filters=40)):
        tparams = tmfcc.MFCCParams(**params.__dict__)
        np.testing.assert_allclose(
            tmfcc.mfcc(m, SR, 1024, tparams).numpy(),
            np.asarray(jmfcc.mfcc(jnp.asarray(magnitudes), SR, 1024, params)),
            atol=1e-3,
        )
    np.testing.assert_allclose(
        tchroma.chroma_from_magnitude(m, SR, 1024).numpy(),
        np.asarray(jchroma.chroma_from_magnitude(jnp.asarray(magnitudes), SR, 1024)),
        atol=1e-5,
    )


def test_descriptor_bundle_on_same_magnitudes(magnitudes):
    m = torch.from_numpy(magnitudes)
    got = {k: v.numpy() for k, v in tspectral.spectral_descriptor_bundle(m, SR).items()}
    ref = {k: np.asarray(v) for k, v in jspectral.spectral_descriptor_bundle(
        jnp.asarray(magnitudes), SR).items()}
    assert "spectral_rolloff" in got
    assert sorted(got) == sorted(ref)
    near = np.zeros(magnitudes.shape[:-1], bool)
    errors, failures = parity.check_features(got, ref, near, SR, 1024)
    assert not failures, (failures, errors)
    np.testing.assert_allclose(
        t_flux(m).numpy(), np.asarray(j_flux(jnp.asarray(magnitudes))),
        rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("bands", [6, 4])
def test_contrast_on_same_magnitudes(magnitudes, bands):
    """On identical magnitudes only the sort and the means differ in
    order of summation: atol 1e-3 dB."""
    m = torch.from_numpy(magnitudes)
    np.testing.assert_allclose(
        tspectral.spectral_contrast(m, SR, bands).numpy(),
        np.asarray(jspectral.spectral_contrast(jnp.asarray(magnitudes), SR, bands)),
        atol=1e-3,
    )


def test_zcr_and_energy_variance():
    frames = np.random.default_rng(5).standard_normal((3, 40, 1024)).astype(np.float32)
    frames[0, 0, :10] = 0.0
    np.testing.assert_array_equal(
        tspectral.zcr(torch.from_numpy(frames), SR).numpy(),
        np.asarray(jspectral.zcr(jnp.asarray(frames), SR)),
    )
    e = np.abs(frames[..., 0])
    np.testing.assert_allclose(
        ttemporal.energy_variance(torch.from_numpy(e)).numpy(),
        np.asarray(jtemporal.energy_variance(jnp.asarray(e))), rtol=1e-5,
    )
    assert ttemporal.energy_variance(torch.ones(3, 1)).tolist() == [0.0, 0.0, 0.0]
