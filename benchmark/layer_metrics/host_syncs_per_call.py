"""host_syncs_per_call: the sites where the host waits for the card in
one monitor call (`utils/metrics.host_syncs`, an exact count by site),
over the traced calls. At 64 pairs in two sub-batches of 32: the two
pushes from host memory, then per sub-batch the row-index upload, the
gate's and the verification's flag reads and 12 output copies: 32."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({"host_syncs": "sonido_sonar_tpu_torch.utils.metrics:host_syncs"})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS))
