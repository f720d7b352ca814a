"""stage_ms_per_batch: host ms `run_stream` spends staging a numpy batch
in pinned memory (span `stream.stage`: the pinned allocation and the
host `copy_`), over the traced batches."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({"stream_stage_ns": "sonido_sonar_tpu_torch.parallel.pipeline:STAGE.total_ns"})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS), 1e-6)
