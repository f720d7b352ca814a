"""The port's spectrogram surface (`ops/stft.py`) held to the JAX
package's on the CPU: `stft` and its `STFTResult` at W <= 2048 (the DFT
matmul) and above it (the FFT), phase and complex spectrum included;
`fft_frame`, the power spectra and `spectral_flux_all_changes`; and
`STFTStreamer` in legacy and block mode, against JAX's streamer and
against `stft` of the whole signal. Tolerances are utils/parity.py's."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.ops import stft as J  # noqa: E402
from sonido_sonar_tpu_torch.ops import hopper_stft  # noqa: E402
from sonido_sonar_tpu_torch.ops import stft as T  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402
from sonido_sonar_tpu_torch.utils.convert import stft_result_from_reference  # noqa: E402

torch.set_num_threads(1)
SR = 44100


@pytest.fixture(scope="module")
def pcm():
    """[3, 1 s]: two harmonic rows and a noise row (parity.synth_pcm)."""
    return parity.synth_pcm(4, SR, 5).numpy()[1:]


def _close_scaled(got, ref, what):
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    assert err <= parity.MAG_ATOL_SCALE * scale, (what, err, scale)


@pytest.mark.parametrize("w,hop", [(1024, 256), (4096, 1024)])
def test_stft_matches_jax(pcm, w, hop):
    """The DFT-matmul branch (1024) and the FFT branch (4096): magnitude
    and complex spectrum within MAG_ATOL_SCALE of the largest magnitude;
    phase within PHASE_ATOL (wrapped) on bins above PHASE_MAG_FLOOR of
    their frame's peak; the metadata and the properties equal."""
    got = T.stft(torch.from_numpy(pcm), w, hop, sample_rate=SR, return_phase=True,
                 return_complex=True)
    ref = J.stft(jnp.asarray(pcm), w, hop, sample_rate=SR, return_phase=True, return_complex=True)
    mag = np.asarray(ref.magnitude)
    assert got.magnitude.dtype == torch.float32 and tuple(got.magnitude.shape) == mag.shape
    assert got.complex_spec.dtype == torch.complex64 and got.phase.dtype == torch.float32
    _close_scaled(got.magnitude.numpy(), mag, "magnitude")
    _close_scaled(got.complex_spec.numpy(), np.asarray(ref.complex_spec), "complex")
    dphi = np.angle(np.exp(1j * (got.phase.numpy().astype(np.float64) - np.asarray(ref.phase))))
    live = mag > parity.PHASE_MAG_FLOOR * mag.max(axis=-1, keepdims=True)
    assert live.mean() > 0.1
    assert np.abs(dphi[live]).max() <= parity.PHASE_ATOL
    for key in ("sample_rate", "window_size", "hop_size", "freq_bins", "time_frames"):
        assert getattr(got, key) == getattr(ref, key), key
    plain = T.stft(torch.from_numpy(pcm), w, hop, sample_rate=SR)
    assert plain.phase is None and plain.complex_spec is None
    assert torch.equal(plain.magnitude, got.magnitude)


def test_stft_numpy_input_goes_to_device(pcm):
    """Numpy goes to `device`; a tensor keeps its own; the K1 plain
    version reads `stft(...).magnitude`."""
    a = T.stft(pcm[0], 1024, 256, device="cpu")
    b = T.stft(torch.from_numpy(pcm[0]), 1024, 256)
    assert a.magnitude.device.type == "cpu" and torch.equal(a.magnitude, b.magnitude)
    assert a.magnitude.shape == (a.time_frames, 513)
    mag, _ = hopper_stft.stft_magnitude_plain(torch.from_numpy(pcm), 1024, 256)
    assert torch.equal(mag, T.stft(torch.from_numpy(pcm), 1024, 256).magnitude)


def test_spectrum_helpers_match_jax(pcm):
    frames = pcm[:, 1000:3048]
    got = T.fft_frame(frames, 2048, device="cpu")
    ref = np.asarray(J.fft_frame(jnp.asarray(frames), 2048))
    assert got.dtype == torch.complex64
    _close_scaled(got.numpy(), ref, "fft_frame")
    mag = np.array(J.stft(jnp.asarray(pcm), 1024, 256).magnitude)
    m = torch.from_numpy(mag)
    np.testing.assert_array_equal(T.power_spectrum(m).numpy(), np.asarray(J.power_spectrum(mag)))
    np.testing.assert_allclose(T.log_power_spectrum(m).numpy(),
                               np.asarray(J.log_power_spectrum(jnp.asarray(mag))),
                               rtol=0.0, atol=parity.LOG_POWER_ATOL_DB)
    for t_fn, j_fn in ((T.spectral_flux_all_changes, J.spectral_flux_all_changes),
                       (T.spectral_flux, J.spectral_flux)):
        errors, failures = {}, []
        parity._close(t_fn.__name__, t_fn(m).numpy(), np.asarray(j_fn(jnp.asarray(mag))),
                      *parity.FEATURE_TOLERANCES["spectral_flux"], errors, failures)
        assert not failures, failures
    assert (T.spectral_flux_all_changes(m) >= T.spectral_flux(m)).all()


def _stream(streamer, x, chunk):
    outs = [streamer.push(x[i:i + chunk]) for i in range(0, len(x), chunk)]
    outs.append(streamer.flush())
    return [o for o in outs if o is not None]


@pytest.mark.parametrize("block_frames", [0, 16])
def test_streamer_matches_jax_and_the_whole_signal(pcm, block_frames):
    """2 s at 1024/256 pushed in 0.25 s chunks: the same magnitudes as
    JAX's streamer, and as `stft` of the whole signal (every frame the
    stream completes); block mode's pieces hold 16 frames each but the
    flushed tail."""
    x = np.concatenate([pcm[0], pcm[1]])
    chunk = SR // 4
    got = _stream(T.STFTStreamer(1024, 256, block_frames=block_frames, device="cpu"), x, chunk)
    ref = _stream(J.STFTStreamer(1024, 256, block_frames=block_frames), x, chunk)
    assert [tuple(r.magnitude.shape) for r in got] == [np.asarray(r.magnitude).shape for r in ref]
    if block_frames:
        assert all(r.magnitude.shape[0] % block_frames == 0 for r in got[:-1])
    cat = torch.cat([r.magnitude for r in got]).numpy()
    _close_scaled(cat, np.concatenate([np.asarray(r.magnitude) for r in ref]), "vs JAX streamer")
    whole = T.stft(torch.from_numpy(x), 1024, 256).magnitude.numpy()
    assert cat.shape == whole.shape
    _close_scaled(cat, whole, "vs stft of the whole signal")


def test_streamer_routes_by_geometry(pcm, monkeypatch):
    """K1's windows take its wrapper (its plain version on the CPU); a
    4096 window takes `stft` and never calls K1; reset empties the
    buffer."""
    calls = []
    real = hopper_stft.stft_magnitude_hopper

    def counting(*a, **k):
        calls.append(a[1])
        return real(*a, **k)

    monkeypatch.setattr(hopper_stft, "stft_magnitude_hopper", counting)
    k1 = T.STFTStreamer(1024, 256, device="cpu")
    wide = T.STFTStreamer(4096, 1024, device="cpu")
    assert (k1.route, wide.route, T.STFTStreamer(3000, 750, device="cpu").route) == ("k1", "stft", "stft")
    r1 = k1.push(pcm[0])
    assert calls == [1024]
    r2 = wide.push(pcm[0])
    assert calls == [1024]
    _close_scaled(r2.magnitude.numpy(), T.stft(torch.from_numpy(pcm[0]), 4096, 1024).magnitude.numpy(),
                  "4096 streamer")
    assert r1.magnitude.shape[-1] == 513 and r2.magnitude.shape[-1] == 2049
    wide.reset()
    assert wide.flush() is None


def test_stft_result_from_reference(pcm):
    ref = J.stft(jnp.asarray(pcm), 1024, 256, sample_rate=SR, return_phase=True, return_complex=True)
    got = stft_result_from_reference(ref.magnitude, ref.phase, ref.complex_spec, SR, 1024, 256, "cpu")
    np.testing.assert_array_equal(got.magnitude.numpy(), np.asarray(ref.magnitude))
    np.testing.assert_array_equal(got.complex_spec.numpy(), np.asarray(ref.complex_spec))
    assert got.time_frames == ref.time_frames and got.sample_rate == SR
    bare = stft_result_from_reference(ref.magnitude, None, None, SR, 1024, 256, "cpu")
    assert bare.phase is None and bare.complex_spec is None
    with pytest.raises(ValueError, match="not"):
        stft_result_from_reference(ref.magnitude, None, None, SR, 2048, 256, "cpu")
