"""The public fingerprint surface (counterpart of
`sonido_sonar_tpu/fingerprint/`): generator, content detector, corpus
bucketing. The comparator is not ported yet."""

from sonido_sonar_tpu_torch.fingerprint.batching import AudioBucket, batch_audios  # noqa: F401
from sonido_sonar_tpu_torch.fingerprint.content_detector import (  # noqa: F401
    AcousticFeatures,
    ContentDetector,
)
from sonido_sonar_tpu_torch.fingerprint.generator import (  # noqa: F401
    AudioFingerprint,
    FingerprintBatch,
    FingerprintGenerator,
)
from sonido_sonar_tpu_torch.fingerprint.comparison import (  # noqa: F401
    FingerprintComparator,
    Match,
    SimilarityResult,
    get_similarity_statistics,
)
