"""Greedy NMS over proposal masks, plain reference (a frozen copy of the
port's ``pbnet_torch/ops/nms.py``).

PBNet computes the (P, P) cross-IoU with one mask matmul and runs greedy
NMS on the host (eval_map.py:87-98, tools/mIOU.py:77-87).
"""

from __future__ import annotations

import numpy as np


def greedy_nms_np(ious: np.ndarray, scores: np.ndarray, threshold: float) -> np.ndarray:
    """Host oracle: literal port of the reference algorithm."""
    ixs = scores.argsort()[::-1]
    pick = []
    while len(ixs) > 0:
        i = ixs[0]
        pick.append(i)
        iou = ious[i, ixs[1:]]
        remove = np.where(iou > threshold)[0] + 1
        ixs = np.delete(ixs, remove)
        ixs = np.delete(ixs, 0)
    return np.array(pick, dtype=np.int32)
