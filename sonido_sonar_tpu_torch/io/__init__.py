"""Host-side audio ingest: decode -> float32 PCM (counterpart of
`sonido_sonar_tpu/io/`; transcode/decoder.go).

The FFmpeg/ffprobe subprocess boundary is kept (used where the binaries
exist); a WAV path (the native loader of `io/native`, else the stdlib
`wave` module) covers hosts without ffmpeg. Downstream code sees mono
float32 PCM at the target rate; the entry points put it on their device.
"""

from sonido_sonar_tpu_torch.io.audio import AudioData, AudioMetadata, StreamMetadata  # noqa: F401
from sonido_sonar_tpu_torch.io.decode import (  # noqa: F401
    Decoder,
    DecoderConfig,
    content_optimized_decoder_config,
    default_decoder_config,
)
from sonido_sonar_tpu_torch.io.synth import chirp, shift_signal, sine, white_noise  # noqa: F401
