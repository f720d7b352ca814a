"""The traced window's arithmetic on a synthetic Chrome trace: busy time
as the union of device intervals inside the window, device time by
group, and idle gaps named by the host operation that overlaps them."""

import pytest

from benchmark.core.kernels import is_kernel, picker
from benchmark.core.trace import WINDOW_LABEL, read_events


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_groups_and_gaps():
    events = [
        _ev(WINDOW_LABEL, "user_annotation", 0, 100),
        _ev("void stft_aux_kernel<9>", "kernel", 10, 20),
        _ev("void regular_fft_factor<1024u>", "kernel", 20, 20),     # overlaps the first
        _ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 70, 10),
        _ev("void late_kernel", "kernel", 95, 10),                     # cut at the window's end
        _ev("void before_window", "kernel", -30, 20),                  # outside
        _ev("aten::item", "cpu_op", 42, 20),
        {"ph": "i", "name": "marker", "ts": 5},
    ]
    r = read_events(events, calls=2)
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx((40 - 10 + 10 + 5) * 1e-6)
    groups = {"k1": ["stft_aux_kernel"], "fft": ["fft"], "h2d": ["memcpy htod"], "csrc": ["stft_aux_kernel"]}
    assert r.device_seconds(picker(groups, "k1")) == pytest.approx(20e-6)
    assert r.device_seconds(lambda s: is_kernel(s) and picker(groups, "fft", exclude=("csrc",))(s)) == pytest.approx(20e-6)
    assert r.device_seconds(picker(groups, "h2d")) == pytest.approx(10e-6)
    b = r.breakdown()
    assert b["device_ops"][0] == ["void stft_aux_kernel<9>", pytest.approx(20e-6)]
    gaps = dict((round(v * 1e6), n) for n, v in b["idle_gaps"])
    assert gaps[30] == "aten::item"                     # 40-70: the host op overlapping it
    assert gaps[15] == "host after aten::item"          # 80-95: no host op
    assert gaps[10] == "host after start"               # 0-10


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        read_events([_ev("k", "kernel", 0, 1)], calls=1)
