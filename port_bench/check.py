"""The comparison that decides ``correct``: what the timed path produced
for a request, beside what the plain reference works out for it.

Numbers, each the worst over the checked requests:

* ``logit_gap``, ``offset_gap``: stage 1's semantic logits and offsets at
  the points both sides map to a voxel, the largest absolute gap over the
  reference's root mean square (the topology, every sparse conv, the norms
  and the heads);
* ``point_map_diff``: points mapped to a voxel on one side only (exact);
* ``cluster_diff``: points whose cluster id differs (exact: the clustering
  kernels B1-B4 and ``ops/cluster.py`` on the same oracle);
* ``mask_gap``: the largest gap of a local-scene point's mask score
  (D_Unet over the local scenes), 1 where the scenes differ in size;
* ``score_gap``: the largest gap of a proposal's score (ScoreNet over the
  kept voxels), 1 where the proposal counts differ;
* ``instance_miss``: the share of final instances, of both sides, with no
  instance of the same label and a mask IoU of at least 0.5 on the other
  (the TTA fold, thresholds, NMS and superpoint vote).
"""

from __future__ import annotations

import numpy as np
import torch

OPERAND_BYTES = {"bfloat16": 2, "float32": 4}
# the outputs the host fold reads
FOLD_KEYS = ("prop_point_kept", "prop_point_src", "prop_point_pid", "num_final_proposals",
             "clt_scores", "prop_sem")
NUMBERS = ("logit_gap", "offset_gap", "point_map_diff", "cluster_diff", "mask_gap",
           "score_gap", "instance_miss")
IOU_MATCH = 0.5


def outputs(bb: dict, out: dict, pred, n_points: int) -> dict:
    """What the check reads of one request (device tensors stay where they
    are until the window has closed)."""
    n = n_points
    return {
        "ok": bb["point_ok"][:n],
        "logits": bb["sem_pred_score_p"][:n],
        "offsets": bb["offset_pred_p"][:n],
        "cluster_id": out["cluster"].cluster_id[:n],
        "scene_valid": out["scene_valid"],
        "mask": out["mask_scores"],
        "num_final": out["num_final_proposals"],
        "scores": out["clt_scores"],
        "pred": pred,
    }


def gap(a: torch.Tensor, b: torch.Tensor, ok: torch.Tensor) -> float:
    """The largest absolute gap at ``ok`` over the reference's root mean
    square."""
    a, b = a[ok].double(), b[ok].double()
    if b.numel() == 0:
        return 0.0
    rms = float(b.square().mean().sqrt())
    return float((a - b).abs().max()) / max(rms, 1e-12)


def _instances_missed(p, r) -> tuple[int, int]:
    """(instances without a match, instances) over both sides' final
    instances (``pred_info`` dicts or None)."""
    pm = [] if p is None else list(zip(p["label_id"], p["mask"].astype(bool)))
    rm = [] if r is None else list(zip(r["label_id"], r["mask"].astype(bool)))

    def unmatched(xs, ys):
        miss = 0
        for lab, m in xs:
            best = 0.0
            for lab2, m2 in ys:
                if lab2 == lab:
                    inter = np.count_nonzero(m & m2)
                    best = max(best, inter / max(np.count_nonzero(m | m2), 1))
            miss += best < IOU_MATCH
        return miss

    return unmatched(pm, rm) + unmatched(rm, pm), len(pm) + len(rm)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of one request."""
    ok = prog["ok"].cpu() & ref["ok"].cpu()
    num = {
        "logit_gap": gap(prog["logits"].cpu(), ref["logits"].cpu(), ok),
        "offset_gap": gap(prog["offsets"].cpu(), ref["offsets"].cpu(), ok),
        "point_map_diff": int((prog["ok"].cpu() != ref["ok"].cpu()).sum()),
        "cluster_diff": int((prog["cluster_id"].cpu() != ref["cluster_id"].cpu()).sum()),
    }
    sv_p, sv_r = prog["scene_valid"].cpu(), ref["scene_valid"].cpu()
    if sv_p.shape == sv_r.shape and torch.equal(sv_p, sv_r):
        d = (prog["mask"].cpu() - ref["mask"].cpu()).abs()[sv_r]
        num["mask_gap"] = float(d.max()) if d.numel() else 0.0
    else:
        num["mask_gap"] = 1.0
    nf_p, nf_r = int(prog["num_final"]), int(ref["num_final"])
    if nf_p == nf_r:
        d = (prog["scores"].cpu()[:nf_r] - ref["scores"].cpu()[:nf_r]).abs()
        num["score_gap"] = float(d.max()) if d.numel() else 0.0
    else:
        num["score_gap"] = 1.0
    miss, total = _instances_missed(prog["pred"], ref["pred"])
    num["instance_miss"] = float(miss / total) if total else 0.0
    return num


def worst(per_request: dict) -> dict:
    """Each number's worst over the requests."""
    return {k: max(v[k] for v in per_request.values()) for k in NUMBERS} \
        if per_request else {}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit, and no number without one."""
    return bool(numbers) and all(k in limits and v <= limits[k] for k, v in numbers.items())
