"""host_syncs_per_batch.generator: the sites where the host waits for
the card in one generator batch (`utils/metrics.host_syncs`, an exact
count by site: the detector's [K, 9] copy, then one copy per feature
tensor of each content-type group), over the traced batches."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({"host_syncs": "sonido_sonar_tpu_torch.utils.metrics:host_syncs"})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS))
