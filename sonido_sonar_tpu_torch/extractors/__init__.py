"""Content-specific feature extraction (counterpart of
`sonido_sonar_tpu/extractors/`): the schema, the factory, the speech,
music, sports and mixed extractors, and the alignment extractor."""

from sonido_sonar_tpu_torch.extractors.features import (  # noqa: F401
    EnergyFeatures,
    ExtractedFeatures,
    HarmonicFeatures,
    SpectralFeatures,
    SpeechFeatures,
    TemporalFeatures,
)
from sonido_sonar_tpu_torch.extractors.base import (  # noqa: F401
    FeatureExtractorFactory,
    create_extractor,
)
from sonido_sonar_tpu_torch.extractors.speech import SpeechFeatureExtractor  # noqa: F401
from sonido_sonar_tpu_torch.extractors.music import MusicFeatureExtractor  # noqa: F401
from sonido_sonar_tpu_torch.extractors.sports import (  # noqa: F401
    MixedFeatureExtractor,
    SportsFeatureExtractor,
)
from sonido_sonar_tpu_torch.extractors.alignment import (  # noqa: F401
    AlignmentExtractor,
    AlignmentFeatures,
)
