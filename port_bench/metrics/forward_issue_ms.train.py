"""Host ms per step of the traced window inside the port's own spans of the
forward: ``pbnet.backbone``, ``pbnet.instance_stage`` and ``pbnet.losses``
(``pbnet_torch.telemetry``).  Beside the step's device time it locates the
host time that issues the forward."""

SPANS = ("pbnet.backbone", "pbnet.instance_stage", "pbnet.losses")


def read(rec):
    if rec.get("kind") != "train" or not rec.get("trace") or not rec.get("requests"):
        return None
    try:
        from pbnet_torch import telemetry
    except ImportError:  # a port that records no spans
        return None
    spans = telemetry.collected()["spans"]
    if not all(s in spans for s in SPANS):
        return None
    return sum(spans[s]["ms"] for s in SPANS) / rec["requests"]
