"""Batched pipelines (counterpart of `sonido_sonar_tpu/parallel/`)."""
