"""extractor_calls_per_batch: extractor calls a batch (span
`generator.extract`'s count: one a content-type group, and a speculative
call where the last batch was of one type), over the traced batches."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({"generator_extract_calls":
                       "sonido_sonar_tpu_torch.fingerprint.generator:EXTRACT.count"})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS))
