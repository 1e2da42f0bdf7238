"""Requests completed in the window over the window's seconds."""

from port_bench import window


def read(rec):
    return window.rate(rec["window"]) if rec.get("kind") == "eval" and "window" in rec else None
