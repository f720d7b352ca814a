from sonido_sonar_tpu_torch.config.config import (  # noqa: F401
    AlignmentConfig,
    ComparisonConfig,
    ContentAwareConfig,
    ContentType,
    FeatureConfig,
    FingerprintConfig,
    WindowType,
    alignment_config_for_content,
    comparison_config_for_content,
    content_feature_toggles,
    default_alignment_config,
    default_comparison_config,
    default_fingerprint_config,
    get_content_optimized_comparison_config,
    to_content_type,
)
from sonido_sonar_tpu_torch.config.content_config import (  # noqa: F401
    ComparisonSettings,
    ContentAwareConfigManager,
    ContentSettings,
    FeatureSettings,
    get_content_configs,
)
