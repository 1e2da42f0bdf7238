"""Host ms inside the port's own ``pbnet.cluster`` span
(``binary_cluster``: its torch calls, B1-B4 launches and host reads) per
request of the traced window, from ``pbnet_torch.telemetry``."""


def read(rec):
    if rec.get("kind") != "eval" or not rec.get("trace") or not rec.get("requests"):
        return None
    try:
        from pbnet_torch import telemetry
    except ImportError:  # a port that records no spans
        return None
    s = telemetry.collected()["spans"].get("pbnet.cluster")
    return s["ms"] / rec["requests"] if s else None
