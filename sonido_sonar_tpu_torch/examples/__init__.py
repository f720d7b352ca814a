"""Runnable examples of the port's entry points (counterparts of the
repo's `examples/`), each `python -m sonido_sonar_tpu_torch.examples.<name>`:

- `cdn_latency source.wav cdn.wav [max_lag_seconds]`: decode two files,
  fingerprint both, align them and refine the latency to the sample;
- `corpus_search query.wav corpus_dir/ [k]`: fingerprint a directory of
  files and rank them against a query;
- `batch_monitor [n_pairs] [seconds]`: align B synthesized source/CDN
  pairs at once and report the exact-sample recovery.

Each `main` takes the same arguments as its JAX twin plus `device`
(the card by default) and prints the same lines.
"""
