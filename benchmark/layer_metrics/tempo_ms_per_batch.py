"""tempo_ms_per_batch: host ms a batch in the music program's tempo
stage (span `music.tempo`: K1 at 1024/512, two K4 launches and the
merge of the two onset lists, a loop of small operators the host
enqueues), over the traced batches."""

from benchmark.core.spec import load_module

_t = load_module("layer_metrics", "_totals")
COUNTERS = _t.present({"music_tempo_ns": "sonido_sonar_tpu_torch.parallel.pipeline:MUSIC_TEMPO.total_ns"})


def read(ctx):
    return _t.per_call(ctx, list(COUNTERS), 1e-6)
