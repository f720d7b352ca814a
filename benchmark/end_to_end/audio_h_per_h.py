"""audio_h_per_h: audio-seconds of the batches whose results were
complete inside the window, per second of the window (audio-hours
fingerprinted per wall-hour)."""


def compute(run) -> float:
    return run.window.rate("audio_s")
