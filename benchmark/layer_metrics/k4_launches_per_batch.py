"""k4_launches_per_batch: K4 launches a batch (the onset thinning:
the payload's flux onsets and the tempo's flux and energy onsets, three
a music extractor call), over the traced batches."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({"k4_launches": "sonido_sonar_tpu_torch.ops.hopper_onsets:thin_onsets_hopper.launches"})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS))
