"""Content-specific feature extraction (counterpart of
`sonido_sonar_tpu/extractors/`): the schema, the single-program
extractor paths of the speech and music extractors, the factory, and
the alignment extractor."""

from sonido_sonar_tpu_torch.extractors.alignment import (  # noqa: F401
    AlignmentExtractor,
    AlignmentFeatures,
)
