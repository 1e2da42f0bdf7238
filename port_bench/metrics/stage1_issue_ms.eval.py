"""Host ms inside the port's own ``pbnet.backbone`` span per request of the
traced window, from ``pbnet_torch.telemetry``: the time the host takes to
issue stage 1, with every wait for the device inside it (stage 1 reads no
tensor back, but a copy of a host value to the device waits for the
stream).  Beside ``stage1_ms.eval`` (device events) it says whether the
host or the device sets stage 1's time."""


def read(rec):
    if rec.get("kind") != "eval" or not rec.get("trace") or not rec.get("requests"):
        return None
    try:
        from pbnet_torch import telemetry
    except ImportError:  # a port that records no spans
        return None
    s = telemetry.collected()["spans"].get("pbnet.backbone")
    return s["ms"] / rec["requests"] if s else None
