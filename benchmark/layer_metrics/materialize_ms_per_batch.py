"""materialize_ms_per_batch: host ms a batch spends pulling its groups'
features to the host and building the per-clip fingerprint objects
(spans `generator.materialize` and `generator.assemble`), over the
traced batches."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({
    "generator_materialize_ns": "sonido_sonar_tpu_torch.fingerprint.generator:MATERIALIZE.total_ns",
    "generator_assemble_ns": "sonido_sonar_tpu_torch.fingerprint.generator:ASSEMBLE.total_ns",
})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS), 1e-6)
