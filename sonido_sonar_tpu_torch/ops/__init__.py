"""Feature ops: PyTorch counterparts of `sonido_sonar_tpu/ops/`."""
