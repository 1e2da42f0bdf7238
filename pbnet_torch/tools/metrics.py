"""Semantic metrics + superpoint alignment (host-side numpy).

The port's own copy of ``pbnet_tpu/tools/metrics.py`` (the port imports
nothing of the JAX package); tests/test_torch_eval.py holds the two equal.

Ports the semantics of PBNet tools/mIOU.py and
PBNet tools/getins.py:72-98 without torch/scipy dependencies.
"""

from __future__ import annotations

import numpy as np


def intersection_and_union(output: np.ndarray, target: np.ndarray, k: int,
                           ignore_index: int = -100):
    """Histogram mIoU pieces (PBNet tools/mIOU.py:18-31)."""
    output = output.reshape(-1).copy()
    target = target.reshape(-1)
    output[target == ignore_index] = ignore_index
    intersection = output[output == target]
    area_inter = np.histogram(intersection, bins=k, range=(0, k - 1))[0]
    area_out = np.histogram(output, bins=k, range=(0, k - 1))[0]
    area_tgt = np.histogram(target, bins=k, range=(0, k - 1))[0]
    return area_inter, area_out + area_tgt - area_inter, area_tgt


def get_segmented_scores(scores: np.ndarray, fg_thresh=1.0, bg_thresh=0.0):
    """Linear fg/bg score ramp (PBNet tools/mIOU.py:34-48)."""
    fg = scores > fg_thresh
    bg = scores < bg_thresh
    k = 1.0 / (fg_thresh - bg_thresh)
    b = bg_thresh / (bg_thresh - fg_thresh)
    return np.where(fg, 1.0, np.where(bg, 0.0, scores * k + b))


def align_superpoint_label(labels: np.ndarray, superpoint: np.ndarray,
                           num_label: int = 20, ignore_label: int = -100):
    """Majority-vote label per superpoint (PBNet tools/
    getins.py:72-98): build a (num_superpoint, num_label+1) vote matrix
    (ignore votes in the last column), take argmax, return per-superpoint
    label + confidence."""
    sp = superpoint.astype(np.int64)
    lab = labels.astype(np.int64).copy()
    lab[lab < 0] = num_label
    n_sp = int(np.unique(sp).shape[0])
    votes = np.zeros((n_sp, num_label + 1), np.float64)
    np.add.at(votes, (sp, lab), 1.0)
    sp_label = votes.argmax(1)
    sp_label[sp_label == num_label] = ignore_label
    denom = votes.sum(1)
    sp_scores = votes.max(1) / np.maximum(denom, 1e-12)
    return sp_label, sp_scores


class AverageMeter:
    """Running value/average tracker (PBNet tools/log.py:16-30)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum = self.sum + val * n
        self.count = self.count + n
        self.avg = self.sum / max(self.count, 1e-12)


def get_center_scores(dist: np.ndarray, near_thresh=0.3, far_thresh=0.6):
    """Linear near/far center-distance ramp (PBNet tools/
    mIOU.py:51-65, capability parity — unused by the main path)."""
    far = dist > far_thresh
    near = dist < near_thresh
    k = 1.0 / (far_thresh - near_thresh)
    b = far_thresh / (far_thresh - near_thresh)
    return np.where(near, 1.0, np.where(far, 0.0, b - dist * k))


def get_gt_dist(instance_info: np.ndarray, ins_label: np.ndarray,
                gt_instance_idxs: np.ndarray, pred_center: np.ndarray):
    """Distance between predicted and GT instance centers
    (PBNet tools/mIOU.py:68-74, capability parity)."""
    valid = ins_label != -100
    pairs = np.concatenate(
        [ins_label[valid, None].astype(np.float64), instance_info[valid, :3]], 1
    )
    gt_center = np.unique(pairs, axis=0)
    gt_center = gt_center[gt_instance_idxs][:, 1:]
    return np.linalg.norm(gt_center - pred_center, axis=1)
