"""Host ms inside the port's own ``pbnet.fold`` span (the TTA fold, the
score and size thresholds, NMS and the superpoint vote) per request of the
traced window, from ``pbnet_torch.telemetry``."""


def read(rec):
    if rec.get("kind") != "eval" or not rec.get("trace") or not rec.get("requests"):
        return None
    try:
        from pbnet_torch import telemetry
    except ImportError:  # a port that records no spans
        return None
    s = telemetry.collected()["spans"].get("pbnet.fold")
    return s["ms"] / rec["requests"] if s else None
