"""The window's arithmetic with a fake clock: the rate is every request
over the whole window, the tail is over every request, and a stall inside
the window moves both."""

from __future__ import annotations

from port_bench import window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def run_loop(times, seconds=10.0):
    clock = Clock()

    def send(i):
        clock.t += times[i % len(times)]

    return window.closed_loop(send, seconds, clock)


def test_rate_is_all_requests_over_the_window():
    w = run_loop([0.5])
    assert len(w["latency_s"]) == 20 and w["seconds"] == 10.0
    assert window.rate(w) == 2.0
    # the last request started before the close finishes inside the window
    w = run_loop([0.3])
    assert len(w["latency_s"]) == 34 and abs(w["seconds"] - 10.2) < 1e-9
    assert abs(window.rate(w) - 34 / 10.2) < 1e-12


def test_p90_is_over_every_request():
    assert window.percentile(range(1, 101), 90) == 90
    assert window.percentile([5.0], 90) == 5.0
    assert window.percentile([], 90) is None


def test_a_stall_moves_the_rate_and_the_tail():
    steady = run_loop([0.4])
    stalled = run_loop([0.4] * 4 + [2.0])
    assert window.rate(stalled) < window.rate(steady)
    assert window.percentile(stalled["latency_s"], 90) > window.percentile(steady["latency_s"], 90)
    # a median of chunks would hide it
    assert abs(sorted(stalled["latency_s"])[len(stalled["latency_s"]) // 2] - 0.4) < 1e-9


def test_work_left_in_flight_at_the_close_counts_inside_the_window():
    clock = Clock()

    def send(i):
        clock.t += 0.5

    def finish():
        clock.t += 0.7

    w = window.closed_loop(send, 10.0, clock, finish=finish)
    assert len(w["latency_s"]) == 20 and abs(w["seconds"] - 10.7) < 1e-9
    assert abs(window.rate(w) - 20 / 10.7) < 1e-12
