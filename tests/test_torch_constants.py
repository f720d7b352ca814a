"""The PyTorch port's constant tables, config and framing held to the JAX
package.

Tables are built by the same float64 numpy code in both packages, so
they must be equal to the last bit (exact float32 equality): a table
that differs by one ulp moves every feature built on it.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.config import config as jcfg  # noqa: E402
from sonido_sonar_tpu.ops import chroma as jchroma  # noqa: E402
from sonido_sonar_tpu.ops import filters as jfilters  # noqa: E402
from sonido_sonar_tpu.ops import framing as jframing  # noqa: E402
from sonido_sonar_tpu.ops import mel as jmel  # noqa: E402
from sonido_sonar_tpu.ops import mfcc as jmfcc  # noqa: E402
from sonido_sonar_tpu.ops import pitch as jpitch  # noqa: E402
from sonido_sonar_tpu.ops import spectral as jspectral  # noqa: E402
from sonido_sonar_tpu.ops import stft as jstft  # noqa: E402
from sonido_sonar_tpu.ops import windows as jwindows  # noqa: E402
from sonido_sonar_tpu_torch.config import config as tcfg  # noqa: E402
from sonido_sonar_tpu_torch.ops import chroma as tchroma  # noqa: E402
from sonido_sonar_tpu_torch.ops import filters as tfilters  # noqa: E402
from sonido_sonar_tpu_torch.ops import framing as tframing  # noqa: E402
from sonido_sonar_tpu_torch.ops import mel as tmel  # noqa: E402
from sonido_sonar_tpu_torch.ops import mfcc as tmfcc  # noqa: E402
from sonido_sonar_tpu_torch.ops import pitch as tpitch  # noqa: E402
from sonido_sonar_tpu_torch.ops import spectral as tspectral  # noqa: E402
from sonido_sonar_tpu_torch.ops import stft as tstft  # noqa: E402
from sonido_sonar_tpu_torch.ops import windows as twindows  # noqa: E402
from sonido_sonar_tpu_torch.ops.tables import device_table  # noqa: E402
from sonido_sonar_tpu_torch.utils import convert  # noqa: E402

torch.set_num_threads(1)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wt", list(jcfg.WindowType))
@pytest.mark.parametrize("size", [256, 1024, 1025])
def test_make_window_exact(wt, size):
    twt = tcfg.WindowType(wt.value)
    _same(twindows.make_window(twt, size), jwindows.make_window(wt, size))
    _same(
        twindows.make_window(twt, size, dtype=np.float64),
        jwindows.make_window(wt, size, dtype=np.float64),
    )


@pytest.mark.parametrize("wt", ["hann", "hamming", "blackman"])
@pytest.mark.parametrize("size", [512, 1024, 2048])
def test_windowed_dft_matrix_exact(wt, size):
    _same(
        tstft._windowed_dft_matrix(tcfg.WindowType(wt), size),
        jstft._windowed_dft_matrix(jcfg.WindowType(wt), size),
    )


@pytest.mark.parametrize(
    "args", [(26, 1024, 44100, 0.0, 22050.0), (40, 2048, 22050, 0.0, 0.0),
             (26, 512, 16000, 300.0, 3400.0)],
)
def test_mel_filterbank_exact(args):
    _same(tmel.mel_filterbank(*args), jmel.mel_filterbank(*args))
    hz = np.array([0.0, 440.0, 8000.0, 22050.0])
    _same(tmel.hz_to_mel(hz), jmel.hz_to_mel(hz))
    _same(tmel.mel_to_hz(hz), jmel.mel_to_hz(hz))


@pytest.mark.parametrize("c,m,lift", [(13, 26, 22.0), (20, 40, 22.0), (13, 26, 0.5)])
def test_dct_and_lifter_exact(c, m, lift):
    _same(tmfcc.dct_matrix(c, m), jmfcc.dct_matrix(c, m))
    _same(tmfcc.lifter_vector(c, lift), jmfcc.lifter_vector(c, lift))


@pytest.mark.parametrize("f_bins,sr,w", [(513, 44100, 1024), (1025, 22050, 2048), (257, 16000, 512)])
def test_chroma_fold_freq_bins_and_bands_exact(f_bins, sr, w):
    # chroma maps bins with round-half-to-even; _freq_bins is float64 -> float32
    _same(tchroma.chroma_fold_matrix(f_bins, sr, w), jchroma.chroma_fold_matrix(f_bins, sr, w))
    _same(tspectral._freq_bins(f_bins, sr), jspectral._freq_bins(f_bins, sr))
    assert tspectral.contrast_band_edges(6, f_bins, sr) == jspectral.contrast_band_edges(6, f_bins, sr)


@pytest.mark.parametrize("w", [512, 1024, 2048])
def test_yin_dft_mats_exact(w):
    for a, b in zip(tpitch._yin_dft_mats(w), jpitch._yin_dft_mats(w)):
        _same(a, b)


def test_constants_from_numpy_match_port_tables():
    """The JAX package's tables, carried across, equal the tables the
    port's main path reads (exact float32)."""
    sr, w = 44100, 1024
    jax_tables = {
        "dft_basis": jstft._windowed_dft_matrix(jcfg.WindowType.HANN, w),
        "mel_filterbank": jmel.mel_filterbank(26, w, sr, 0.0, sr / 2.0),
        "dct": jmfcc.dct_matrix(13, 26),
        "lifter": jmfcc.lifter_vector(13, 22.0),
        "chroma_fold": jchroma.chroma_fold_matrix(w // 2 + 1, sr, w),
        "freq_bins": jspectral._freq_bins(w // 2 + 1, sr),
    }
    carried = convert.constants_from_numpy(jax_tables, "cpu")
    # the cached tensors the port's ops read, with the ops' own arguments
    # (ops/stft.stft, ops/mfcc.mfcc, ops/chroma.chroma_from_magnitude,
    # ops/spectral.spectral_descriptor_bundle)
    f_bins = w // 2 + 1
    cpu = torch.device("cpu")
    own = {
        "dft_basis": device_table(tstft._windowed_dft_matrix, (tcfg.WindowType.HANN, w), cpu),
        "mel_filterbank": device_table(tmel.mel_filterbank, (26, w, sr, 0.0, sr / 2.0), cpu),
        "dct": device_table(tmfcc.dct_matrix, (13, 26), cpu),
        "lifter": device_table(tmfcc.lifter_vector, (13, 22.0), cpu),
        "chroma_fold": device_table(
            tchroma.chroma_fold_matrix, (f_bins, sr, w, 440.0, 80.0, 8000.0), cpu
        ),
        "freq_bins": device_table(tspectral._freq_bins, (f_bins, sr), cpu),
    }
    assert sorted(carried) == sorted(own) == sorted(convert.CONSTANT_KEYS)
    for key in own:
        assert carried[key].dtype == torch.float32
        assert torch.equal(carried[key], own[key]), key
    with pytest.raises(ValueError):
        convert.constants_from_numpy({"weights": np.zeros(3)}, "cpu")
    with pytest.raises(ValueError):
        convert.constants_from_numpy({"dct": np.full(3, np.nan)}, "cpu")


@pytest.mark.parametrize(
    "name", ["FeatureConfig", "ComparisonConfig", "AlignmentConfig",
             "ContentAwareConfig", "FingerprintConfig"],
)
def test_config_fields_and_defaults(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(j)]
    tf = [(f.name, f.type) for f in dataclasses.fields(t)]
    assert jf == tf
    assert jcfg.asdict(j()) == tcfg.asdict(t())


def test_enums_and_feature_config_from_dict():
    assert [e.value for e in jcfg.WindowType] == [e.value for e in tcfg.WindowType]
    assert [e.value for e in jcfg.ContentType] == [e.value for e in tcfg.ContentType]
    assert tcfg.to_content_type("talk") == tcfg.ContentType.TALK
    assert tcfg.to_content_type("opera") == tcfg.ContentType.UNKNOWN
    jc = jcfg.FeatureConfig(window_size=1024, hop_size=256, window_type=jcfg.WindowType.HAMMING,
                            similarity_weights=(("mfcc", 1.0),))
    tc = convert.feature_config_from_dict(jcfg.asdict(jc))
    assert tc == tcfg.FeatureConfig(window_size=1024, hop_size=256,
                                    window_type=tcfg.WindowType.HAMMING,
                                    similarity_weights=(("mfcc", 1.0),))
    assert tc.num_frames(44100) == jc.num_frames(44100) and tc.freq_bins == jc.freq_bins
    assert tcfg.asdict(tc) == jcfg.asdict(jc)
    with pytest.raises(ValueError):
        convert.feature_config_from_dict({"window": 1024})


@pytest.mark.parametrize("n,w,hop", [(44100, 1024, 256), (5000, 1024, 512), (1024, 1024, 256), (3000, 1000, 300)])
def test_framing_exact(n, w, hop):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    assert tframing.num_frames(n, w, hop) == jframing.num_frames(n, w, hop)
    got = tframing.frame_signal(torch.from_numpy(x), w, hop).numpy()
    _same(got, np.asarray(jframing.frame_signal(jnp.asarray(x), w, hop)))
    with pytest.raises(ValueError):
        tframing.frame_signal(torch.from_numpy(x[:, : w - 1]), w, hop)


@pytest.mark.parametrize("coef", [0.97, 0.95, 0.0])
def test_pre_emphasis(coef):
    """y[0] = x[0], y[n] = x[n] - a x[n-1]: one multiply and one subtract
    per sample in both packages, so the results are equal up to the
    one-ulp freedom XLA has to fuse them into an FMA."""
    x = np.random.default_rng(1).standard_normal((3, 4000)).astype(np.float32)
    got = tfilters.pre_emphasis(torch.from_numpy(x), coef).numpy()
    ref = np.asarray(jfilters.pre_emphasis(jnp.asarray(x), coef))
    assert got[:, 0].tolist() == x[:, 0].tolist()
    np.testing.assert_allclose(got, ref, rtol=0, atol=np.spacing(np.abs(ref)).max())


@pytest.mark.parametrize("f_bins,sr,w", [(513, 44100, 1024), (1025, 22050, 2048), (257, 16000, 512)])
def test_k10_feature_tables_exact(f_bins, sr, w):
    """The K10 epilogue's sparse table, expanded, is JAX's 26-filter mel
    bank over 0..sr/2 and its chroma fold, and its frequency column JAX's
    _freq_bins, exactly; log10 f is float64's, rounded once (0 at f = 0)."""
    from sonido_sonar_tpu_torch.ops.hopper_stft import feature_tables

    row_ptr, bins, weights, freq_logf = feature_tables(f_bins, sr, w)
    assert row_ptr.dtype == bins.dtype == np.int32 and weights.dtype == np.float32
    assert row_ptr.shape == (39,) and row_ptr[0] == 0 and row_ptr[-1] == bins.size
    dense = np.zeros((38, f_bins), np.float64)
    for o in range(38):
        seg = slice(row_ptr[o], row_ptr[o + 1])
        assert np.all(np.diff(bins[seg]) > 0)  # ascending bins, no repeats
        dense[o, bins[seg]] = weights[seg]
    ref = np.concatenate([
        np.asarray(jmel.mel_filterbank(26, w, sr, 0.0, sr / 2.0), np.float64),
        np.asarray(jchroma.chroma_fold_matrix(f_bins, sr, w), np.float64),
    ])
    np.testing.assert_array_equal(dense, ref)
    freqs = np.asarray(jspectral._freq_bins(f_bins, sr))
    _same(freq_logf[:, 0], freqs)
    f64 = freqs.astype(np.float64)
    want = np.where(f64 > 0, np.log10(np.maximum(f64, 1e-10)), 0.0).astype(np.float32)
    _same(freq_logf[:, 1], want)
