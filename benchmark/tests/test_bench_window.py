"""Rate and percentile arithmetic over a closed-loop window that holds a
stall, on a fake clock."""

import statistics

import pytest

from benchmark.core.window import Call, Window, closed_loop, percentile


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_with_a_stall():
    clock = FakeClock()
    durations = iter([0.25] * 16 + [3.0] + [0.25] * 100)   # a 3 s stall after 4 s

    def call():
        clock.t += next(durations)
        return {"pairs": 64.0}, False

    win = closed_loop(call, 10.0, clock=clock)
    # 16 calls of 0.25 s, the stall to 7 s, 12 calls to 10 s: 29 started before the end
    assert win.attempted == 29
    assert len(win.completed()) == 29
    assert win.rate("pairs") == pytest.approx(29 * 64 / 10.0)
    lat = win.latencies_s()
    assert max(lat) == pytest.approx(3.0)
    # the stall is one call of 29: past the 95th percentile's rank, so p95
    # lies between the two largest (rank 26.6 of 0..28)
    assert percentile(lat, 95) == pytest.approx(0.25)
    assert percentile(lat, 99) == pytest.approx(0.25 + (3.0 - 0.25) * (0.99 * 28 - 27))
    assert percentile(lat, 100) == pytest.approx(3.0)


def test_the_call_running_at_the_close_counts_for_latency_not_for_rate():
    clock = FakeClock()
    durations = iter([0.4] * 24 + [2.0])   # the 25th call starts at 9.6 s, ends at 11.6 s

    def call():
        clock.t += next(durations)
        return {"audio_s": 3840.0}, False

    win = closed_loop(call, 10.0, clock=clock)
    assert win.attempted == 25
    assert len(win.completed()) == 24
    assert win.rate("audio_s") == pytest.approx(24 * 3840.0 / 10.0)
    assert max(win.latencies_s()) == pytest.approx(2.0)


def test_failed_calls_count_as_attempted_and_not_completed():
    win = Window(0.0, 10.0, [Call(0, 1, {"pairs": 64}), Call(1, 2, {"pairs": 60}, failed=True)])
    assert (win.attempted, win.failed) == (2, 1)
    assert win.rate("pairs") == pytest.approx(6.4)


@pytest.mark.parametrize("q", [5, 25, 50, 75, 95, 99])
def test_percentile_matches_statistics_inclusive(q):
    values = [((i * 7919) % 101) / 10.0 for i in range(203)]
    want = statistics.quantiles(values, n=100, method="inclusive")[q - 1]
    assert percentile(values, q) == pytest.approx(want)
