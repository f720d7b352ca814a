from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata, StreamMetadata  # noqa: F401
