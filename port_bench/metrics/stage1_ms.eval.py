"""Stage 1 (``PBNet.backbone``) per request, CUDA events the benchmark
records around it, mean over the traced window's requests (ms)."""


def read(rec):
    v = rec.get("stage1_ms") if rec.get("kind") == "eval" else None
    return sum(v) / len(v) if v else None
