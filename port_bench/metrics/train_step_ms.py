"""The window's seconds over the train steps completed in it (ms)."""


def read(rec):
    w = rec.get("window") if rec.get("kind") == "train" else None
    return w["seconds"] * 1e3 / len(w["latency_s"]) if w and w["latency_s"] else None
