from sonido_sonar_tpu_torch.models.pipeline import FingerprintModel  # noqa: F401
