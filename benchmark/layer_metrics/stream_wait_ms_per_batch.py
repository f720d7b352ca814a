"""stream_wait_ms_per_batch: host ms `run_stream` waits on a step's
completion event before it yields the result (span `stream.wait`), over
the traced batches."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({"stream_wait_ns": "sonido_sonar_tpu_torch.parallel.pipeline:WAIT.total_ns"})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS), 1e-6)
