"""Useful operations of the traced train steps (three times the forward's,
from the reference's present kernel-map entries) over the window's wall,
as a share of the card's dense bf16 peak (%)."""


def read(rec):
    t, w, p = rec.get("trace"), rec.get("work"), rec.get("peaks")
    if rec.get("kind") != "train" or not t or not w or not p or w["ops"] <= 0:
        return None
    return 100.0 * w["ops"] / t["window_s"] / p["flops"]
