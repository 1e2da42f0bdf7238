"""Stages 2-3 (``PBNet.instance_stage``) and the host fold, thresholds and
NMS per request, CUDA events around them, mean over the traced window's
requests (ms)."""


def read(rec):
    v = rec.get("stages23_ms") if rec.get("kind") == "eval" else None
    return sum(v) / len(v) if v else None
