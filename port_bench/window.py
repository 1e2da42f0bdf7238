"""The measured window: a closed loop of one client, and the arithmetic of
its end-to-end numbers.

The loop sends the next request when ``send`` returns (as a rule, once the
previous one's outputs are on the host; a training cell reads a step's row
one step late), and stops sending once ``seconds`` have passed since the
window opened.  The window closes when the last request sent has finished,
so the rate is every request over all the time they took, and the tail is
over every request.
"""

from __future__ import annotations

import math
import time


def closed_loop(send, seconds: float, clock=time.perf_counter, agree=None,
                finish=None) -> dict:
    """Call ``send(i)`` for i = 0, 1, ... one at a time until ``seconds``
    have passed (with ``agree``, until ``agree(this process's decision)``
    says so: the ranks of one job stop together), then ``finish()``, which
    waits for whatever ``send`` left in flight, inside the window.  Returns
    ``{"seconds": window length, "latency_s": [each send's time, in order],
    "starts_s": [each start, from the open]}``."""
    t0 = clock()
    lat, starts = [], []
    i = 0
    while True:
        ts = clock()
        stop = ts - t0 >= seconds
        if agree(stop) if agree is not None else stop:
            break
        send(i)
        te = clock()
        lat.append(te - ts)
        starts.append(ts - t0)
        i += 1
    if finish is not None:
        finish()
    return {"seconds": clock() - t0, "latency_s": lat, "starts_s": starts}


def rate(window: dict) -> float | None:
    """Requests completed per second of the window."""
    n = len(window["latency_s"])
    return n / window["seconds"] if n and window["seconds"] > 0 else None


def percentile(values, q: float) -> float | None:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]
