"""host_wait_ms_per_call: host ms a monitor call spends in its reads of
the card (spans `monitor.host_copy`, `align.gate_read`,
`align.verify_read`), over the traced calls. Each read waits for the
work enqueued before it, so this is the host's wait on the card, not
the copies' own time."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({
    "monitor_host_copy_ns": "sonido_sonar_tpu_torch.monitor:HOST_COPY.total_ns",
    "align_gate_read_ns": "sonido_sonar_tpu_torch.ops.stats.batched_alignment:GATE_READ.total_ns",
    "align_verify_read_ns": "sonido_sonar_tpu_torch.ops.stats.batched_alignment:VERIFY_READ.total_ns",
})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS), 1e-6)
