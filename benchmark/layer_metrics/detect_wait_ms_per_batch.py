"""detect_wait_ms_per_batch: host ms the generator's `resolve()` waits
for the content detector's [K, 9] features to reach the host (span
`generator.detect_wait`), over the traced batches."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({"generator_detect_wait_ns":
                       "sonido_sonar_tpu_torch.fingerprint.content_detector:DETECT_WAIT.total_ns"})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS), 1e-6)
