"""Proposal-instance IoU (plain reference: a frozen copy of the port's
``pbnet_torch/ops/iou.py``: PB_lib get_iou and
cal_iou_and_masklabel).

Proposals are static-shape: a flat point list with a proposal id, an
instance label and a validity flag per point.  Intersections are one
segment sum over ``proposal_id * I + instance_label``.  Counts are f32, as in
the JAX package; they stay exact below 2**24 points.
"""

from __future__ import annotations

import torch


def _segment_count(keep, seg, num):
    out = torch.zeros(num + 1, dtype=torch.float32, device=keep.device)
    return out.index_add_(0, seg.long(), keep.to(torch.float32))[:-1]


def proposal_instance_iou(point_proposal: torch.Tensor, point_instance: torch.Tensor,
                          point_valid: torch.Tensor, instance_pointnum: torch.Tensor,
                          proposal_cap: int, instance_cap: int) -> torch.Tensor:
    """IoU matrix (P_cap, I_cap): inter / (prop_size + inst_size - inter).

    point_proposal (T,) int proposal id per proposal point; point_instance
    (T,) int instance label of that point (-100 = none); point_valid (T,)
    bool; instance_pointnum (I_cap,) int GT instance sizes."""
    p, i = point_proposal, point_instance
    ok = point_valid & (p >= 0) & (p < proposal_cap)
    okk = ok & (i >= 0) & (i < instance_cap)
    flat = torch.where(okk, p * instance_cap + i, proposal_cap * instance_cap)
    inter = _segment_count(okk, flat, proposal_cap * instance_cap).reshape(
        proposal_cap, instance_cap)
    prop_size = _segment_count(ok, torch.where(ok, p, proposal_cap), proposal_cap)
    union = prop_size[:, None] + instance_pointnum[None, :].to(torch.float32) - inter
    return inter / torch.clamp(union, min=1e-12)


def iou_and_mask_label(point_proposal, point_instance, point_valid, mask_scores,
                       instance_pointnum, proposal_cap: int, instance_cap: int,
                       mode: int = 0):
    """(ious, labels): IoU on raw membership (mode 0) or on mask > 0.5
    membership (mode 1); each proposal's best-IoU instance defines 1/0 mask
    labels where that IoU exceeds 0.5, else -1."""
    member = point_valid if mode == 0 else (point_valid & (mask_scores > 0.5))
    ious = proposal_instance_iou(point_proposal, point_instance, member,
                                 instance_pointnum, proposal_cap, instance_cap)
    best_inst = ious.argmax(1)  # the first maximum on ties, as jnp.argmax
    use = ious.amax(1) > 0.5
    p_ok = (point_proposal >= 0) & (point_proposal < proposal_cap) & point_valid
    pid = torch.clamp(point_proposal, 0, proposal_cap - 1).long()
    lbl = torch.where(p_ok & use[pid],
                      (point_instance == best_inst[pid]).to(torch.float32), -1.0)
    return ious, lbl
