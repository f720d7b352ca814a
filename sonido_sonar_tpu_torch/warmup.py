"""Cold-start management: pre-build the kernel library into a shared
directory and prime a process's device state (counterpart of
`sonido_sonar_tpu/warmup.py`).

The port's one compiled artifact is the CUDA kernel library (`_build.py`:
nvcc for sm_90a, ~15 s, named by a hash of the sources and flags). A
fleet that starts many processes from one image wants it built once:
`warmup(cache_dir=...)` (or `enable_persistent_cache`) points this
process's build at a shared directory, where the first process builds
it under a lock and every later one loads it from disk. Then `warmup`
runs each component once on zeros at each deployment shape, which
creates what a first call otherwise pays for: cuFFT plans, cuBLAS
handles and the caching allocator's blocks. The report keys are JAX's.

Typical use:

    from sonido_sonar_tpu_torch.warmup import warmup
    report = warmup(
        feature_config=FeatureConfig(sample_rate=44100,
                                     window_size=1024, hop_size=256),
        batch_sizes=(128,), clip_seconds=(30,),
        cache_dir="/var/cache/sonido_kernels",
    )

The package also exports `warmup` and `enable_persistent_cache`, as the
JAX package does; like JAX's, the `warmup` function then shadows this
submodule as an attribute of the package, so import its names with
`from sonido_sonar_tpu_torch.warmup import ...` (`import
sonido_sonar_tpu_torch.warmup as W` binds the function).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from sonido_sonar_tpu_torch import _build
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device

_DEFAULT_COMPONENTS = (
    "fingerprint",  # public generate_fingerprints_batch + comparator pack
    "alignment",    # batched hybrid aligner (monitor/measure path)
    "search",       # packed-corpus top-k search pass
)


def enable_persistent_cache(cache_dir: str, min_compile_time_secs: float = 1.0) -> None:
    """Point THIS process's kernel build at `cache_dir`: the library goes
    there under its source-hash name, built under the build lock, and a
    library already there is loaded without nvcc. Safe to call more than
    once; later calls win (a library this process already loaded stays
    loaded). Serving processes call this (or pass cache_dir= to warmup())
    with the same directory the warm-up run used.

    `min_compile_time_secs` keeps JAX's signature. JAX persists only
    executables that took longer than this to compile; the port's one
    artifact must be on disk to be loaded at all, so it is always kept,
    and the argument has no effect."""
    if min_compile_time_secs < 0:
        raise ValueError(f"min_compile_time_secs {min_compile_time_secs} < 0")
    _build.use_build_dir(cache_dir)


def cache_hit_counter():
    """A zero-argument callable giving the number of times, since this
    call, that `_build.build()` loaded a kernel library already on disk
    instead of running nvcc. Used by the warm-path checks; handy for
    deployment smoke checks."""
    start = _build.loads_from_disk
    return lambda: _build.loads_from_disk - start


def warmup(
    feature_config=None,
    *,
    batch_sizes: Sequence[int] = (128,),
    clip_seconds: Sequence[float] = (30.0,),
    content_types: Optional[Iterable] = None,
    components: Sequence[str] = _DEFAULT_COMPONENTS,
    alignment_pairs: Sequence[int] = (1,),
    window_seconds: float = 60.0,
    max_lag_seconds: float = 30.0,
    corpus_sizes: Sequence[int] = (),
    cache_dir: Optional[str] = None,
    min_compile_time_secs: float = 1.0,
    group_buckets: bool = False,
    device: Device = DEFAULT_DEVICE,
) -> Dict[str, float]:
    """Build (or load) the kernel library, then run every program the
    given deployment geometry will run once, on zeros, on `device`.
    Returns {stage: seconds}, with JAX's stage names.

    feature_config: the production FeatureConfig (geometry + rate). The
        default matches the bench: 44.1 kHz, window 1024, hop 256.
    batch_sizes x clip_seconds: the [B, N] shapes generation will see.
    content_types: which per-content extractor programs to run (default:
        UNKNOWN, the reference's default routing, and MUSIC).
    components: subset of ("fingerprint", "alignment", "search").
    alignment_pairs: batch sizes for the hybrid aligner (LatencyMonitor
        uses 1; FleetMonitor uses its measure_batch).
    corpus_sizes: packed-corpus candidate counts for the top-k search
        (skipped when empty).
    group_buckets: also run the power-of-two sub-batch sizes that
        mixed-content batches route through.
    cache_dir: `enable_persistent_cache(cache_dir, min_compile_time_secs)`
        first. The library is built only for a CUDA `device`: on the CPU
        every kernel wrapper runs its plain version.
    """
    if cache_dir is not None:
        enable_persistent_cache(cache_dir, min_compile_time_secs)
    dev = torch.device(device)
    if dev.type == "cuda":
        _build.build()

    from sonido_sonar_tpu_torch.config.config import ContentType, FeatureConfig, FingerprintConfig

    fc = feature_config or FeatureConfig(sample_rate=44100, window_size=1024, hop_size=256)
    sr = fc.sample_rate
    report: Dict[str, float] = {}

    def _stage(name: str, fn) -> None:
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        report[name] = time.perf_counter() - t0

    if "fingerprint" in components:
        from sonido_sonar_tpu_torch.fingerprint import FingerprintGenerator
        from sonido_sonar_tpu_torch.io.audio import AudioData

        gen = FingerprintGenerator(FingerprintConfig(feature_config=fc), device=dev)
        cts = list(content_types) if content_types is not None else [
            ContentType.UNKNOWN, ContentType.MUSIC]
        for b in batch_sizes:
            for secs in clip_seconds:
                n = int(sr * secs)
                pcm = torch.zeros((b, n), dtype=torch.float32, device=dev)

                def _fp(b=b, pcm=pcm):
                    # the public path end to end: detection, the detected
                    # type's extractor, the comparator's packing
                    audios = [AudioData(pcm=pcm[i], sample_rate=sr) for i in range(b)]
                    fb = gen.generate_fingerprints_batch(audios, materialize=False, pcm_matrix=pcm)
                    fb.comparator_matrix(13)
                    # every requested content type's extractor (detection
                    # on zeros takes one route)
                    sizes = [b]
                    if group_buckets:
                        g = 1
                        while g < b:
                            sizes.append(g)
                            g <<= 1
                    for ct in cts:
                        ext, fcc = gen._extractor_for(ct, sr)
                        for g in sizes:
                            gen._extract(ext, pcm[:g], fcc, sr)

                _stage(f"fingerprint[b={b},s={secs:g}]", _fp)

    if "alignment" in components:
        from sonido_sonar_tpu_torch.ops.stats.batched_alignment import batched_align_audio

        wn = int(window_seconds * sr)
        max_off = min(int(max_lag_seconds * sr) + 32 * fc.hop_size, 3 * wn // 4)
        for p in alignment_pairs:
            z = torch.zeros((p, wn), dtype=torch.float32, device=dev)

            def _al(z=z):
                batched_align_audio(z, z, sr, window_size=fc.window_size, hop_size=fc.hop_size,
                                    max_lag_seconds=max_lag_seconds, refine=True,
                                    max_offset_samples=max_off)

            _stage(f"alignment[pairs={p}]", _al)

    if "search" in components and corpus_sizes:
        from sonido_sonar_tpu_torch.fingerprint.device_compare import layout_size, topk_similarity

        d = layout_size(13)
        wvec = torch.from_numpy(np.array([0.35, 0.25, 0.10, 0.20, 0.10, 0.10], np.float32)).to(dev)
        for c in corpus_sizes:
            corpus = torch.zeros((c, d), dtype=torch.float32, device=dev)
            q = torch.zeros((d,), dtype=torch.float32, device=dev)
            match = torch.ones(c, dtype=torch.bool, device=dev)

            def _se(corpus=corpus, q=q, match=match):
                topk_similarity(q, corpus, wvec, match, k=16)

            _stage(f"search[corpus={c}]", _se)

    return report
