"""copy_uploads_per_batch: the host batches `run_stream` uploads on a copy
stream of its own, beside the steps before them (the counter
`run_stream.copy_uploads`, one a batch so uploaded), over the traced
batches. One a batch where each numpy batch is staged and uploaded; 0
where the batches are already on the card; no reading from a program
without the counter."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({"stream_copy_uploads": "sonido_sonar_tpu_torch.parallel.pipeline:run_stream.copy_uploads"})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS))
