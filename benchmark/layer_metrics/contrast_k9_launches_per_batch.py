"""contrast_k9_launches_per_batch: the port's K9 contrast band-selection
launches (`ops/hopper_contrast.band_select_means_hopper.launches`, an
exact count) per batch, over the traced batches. One a batch where the
main path takes contrast's band means from the kernel; 0 where it sorts."""


COUNTERS = {"k9_launches": "sonido_sonar_tpu_torch.ops.hopper_contrast:band_select_means_hopper.launches"}


def read(ctx):
    return ctx.counters["k9_launches"] / ctx.trace.calls
