"""setup_s: seconds from the process's start to the first timed call:
imports, traffic, the kernel library's build or load, the system's
construction and its warm call."""


def compute(run) -> float:
    return run.setup_s
