"""Operations the port's conv and dense layers execute inside its
``pbnet.backbone`` span (``conv.executed_ops``: every map entry and padded
row multiplied, from ``pbnet_torch.telemetry``) over the useful operations
of stage 1 the reference counts from its own maps (``work.py``), over the
traced window's requests (x)."""


def read(rec):
    w = rec.get("work")
    if rec.get("kind") != "eval" or not rec.get("trace") or not w \
            or w.get("ops_stage1", 0) <= 0:
        return None
    try:
        from pbnet_torch import telemetry
    except ImportError:  # a port that counts no executed operations
        return None
    c = telemetry.collected()["counts"].get("conv.executed_ops")
    ex = c["by_span"].get("pbnet.backbone") if c else None
    return ex / w["ops_stage1"] if ex else None
