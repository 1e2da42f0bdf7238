"""Host-side instance evaluation glue for one validation scene (port of
pbnet_tpu/eval_pipeline.py).

Reproduces the per-scene evaluation of PBNet eval_map.py:54-139 and
train.py:170-253:

1. merge the 3 TTA copies by folding proposal point indices mod N/3
2. score > TEST_SCORE_THRESH and size > TEST_NPOINT_THRESH filters
3. matrix IoU + greedy NMS at TEST_NMS_THRESH
4. superpoint alignment: per-point proposal ids (later proposals overwrite),
   majority vote per superpoint, re-mask, drop emptied proposals
5. package pred_info for the ScanNet AP evaluator
"""

from __future__ import annotations

import numpy as np

from .ops.nms import greedy_nms_np
from .tools.eval_protocol import SEMANTIC_LABEL_IDX
from .tools.metrics import align_superpoint_label


def _host(x) -> np.ndarray:
    """A model output (tensor on any device, or array) as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def proposals_to_masks(ret: dict, num_points: int) -> dict:
    """Device outputs -> host proposal masks over the N/3 base scene.

    ``num_points`` counts the points of the three TTA copies the reference
    evaluates; a point index folds onto its base-scene vertex mod N/3.  A
    scene run as a single copy of n points passes ``num_points = 3 * n``,
    so that N/3 = n and the fold leaves every index as it is.
    """
    n3 = num_points // 3
    kept = _host(ret["prop_point_kept"])
    src = _host(ret["prop_point_src"])[kept]
    pid = _host(ret["prop_point_pid"])[kept]
    num_final = int(ret["num_final_proposals"])
    scores = _host(ret["clt_scores"])[:num_final]
    sems = _host(ret["prop_sem"])[:num_final]

    masks = np.zeros((num_final, n3), np.int32)
    ok = (pid >= 0) & (pid < num_final) & (src < num_points)
    masks[pid[ok], src[ok] % n3] = 1  # TTA fold (PBNet eval_map.py:67)
    return {"masks": masks, "scores": scores, "sems": sems}


def eval_scene_instances(ret: dict, num_points: int, superpoint: np.ndarray,
                         cfg) -> dict | None:
    """Full per-scene instance post-processing -> pred_info (or None if no
    proposal survives)."""
    p = proposals_to_masks(ret, num_points)
    masks, scores, sems = p["masks"], p["scores"], p["sems"]

    # score threshold (PBNet eval_map.py:74-77)
    keep = scores > cfg.TEST_SCORE_THRESH
    masks, scores, sems = masks[keep], scores[keep], sems[keep]

    # npoint threshold (:80-84)
    sizes = masks.sum(1)
    keep = sizes > cfg.TEST_NPOINT_THRESH
    masks, scores, sems = masks[keep], scores[keep], sems[keep]

    if masks.shape[0] == 0:
        return None

    # greedy NMS on the mask IoU matrix (:87-98)
    m = masks.astype(np.float32)
    inter = m @ m.T
    sizes = m.sum(1)
    ious = inter / np.maximum(sizes[:, None] + sizes[None, :] - inter, 1e-12)
    pick = greedy_nms_np(ious, scores, cfg.TEST_NMS_THRESH)
    masks, scores, sems = masks[pick], scores[pick], sems[pick]

    # superpoint refinement (:106-123): per-point proposal id (later wins),
    # majority vote per superpoint, re-mask, drop emptied proposals
    n3 = masks.shape[1]
    seg_result = np.full(n3, -100, np.int64)
    for ci in range(masks.shape[0]):
        seg_result[masks[ci] == 1] = ci
    sp_labels, _ = align_superpoint_label(
        seg_result, superpoint, num_label=masks.shape[0]
    )
    seg_result = sp_labels[superpoint]
    new_masks = np.zeros_like(masks)
    alive = []
    for ci in range(masks.shape[0]):
        idx = seg_result == ci
        if idx.sum() == 0:
            continue
        new_masks[ci, idx] = 1
        alive.append(ci)
    if not alive:
        return None
    alive = np.array(alive)
    masks, scores, sems = new_masks[alive], scores[alive], sems[alive]

    label_ids = np.array(SEMANTIC_LABEL_IDX)[np.clip(sems, 0, 19)]
    return {
        "conf": scores.astype(np.float64),
        "label_id": label_ids.astype(np.int64),
        "mask": masks,
    }
