"""90th percentile of every request's host time in the window, send to
final instances on the host (ms)."""

from port_bench import window


def read(rec):
    if rec.get("kind") != "eval" or "window" not in rec:
        return None
    p = window.percentile(rec["window"]["latency_s"], 90)
    return None if p is None else p * 1e3
