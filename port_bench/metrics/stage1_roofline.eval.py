"""Stage 1's least time over its measured time: the larger of its useful
operations over the bf16 peak and its bytes over the HBM peak (both from
the reference's present map entries), over the CUDA-event time of stage 1,
summed over the traced window's requests (%)."""


def read(rec):
    w, p, s1 = rec.get("work"), rec.get("peaks"), rec.get("stage1_ms")
    if rec.get("kind") != "eval" or not w or not p or not s1 or w["ops_stage1"] <= 0:
        return None
    least_s = max(w["ops_stage1"] / p["flops"], w["bytes_stage1"] / p["bytes"])
    return 100.0 * least_s / (sum(s1) * 1e-3)
