from sonido_sonar_tpu_torch.config.config import (  # noqa: F401
    AlignmentConfig,
    ComparisonConfig,
    ContentAwareConfig,
    ContentType,
    FeatureConfig,
    FingerprintConfig,
    WindowType,
)
