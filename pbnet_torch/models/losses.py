"""PBNet losses (port of pbnet_tpu/models/losses.py, PBNet model_fn).

* semantic: cross-entropy with ignore_index=-100
* offset: L1 norm + cosine direction, masked to valid instance points
* mask: BCE with -1-ignore weighting + dice loss
* score: BCE against linearly ramped max-IoU targets

Every expression keeps the JAX package's order, so the values agree to f32
rounding.  One difference at a point: the JAX package's ``linalg.norm`` has a
NaN gradient at a zero offset, ``torch.linalg.vector_norm`` a zero one; the
model's voxel->point gather masks those rows out of the gradient either way.
"""

from __future__ import annotations

import torch

from .. import telemetry
from ..ops import iou as iou_ops


def semantic_loss(logits, sem_label, valid):
    """CE with ignore_index=-100, mean over the non-ignored rows."""
    ok = valid & (sem_label != -100)
    lab = torch.clamp(sem_label, 0, logits.shape[-1] - 1).long()
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, 1, lab[:, None])[:, 0]
    return torch.where(ok, nll, 0.0).sum() / torch.clamp(ok.to(torch.float32).sum(), min=1.0)


def offset_losses(offset_pred, xyz, instance_info, ins_label, valid):
    """(L1-norm loss, cosine direction loss); instance_info[:, :3] is the
    instance mean."""
    gt_offsets = instance_info[:, 0:3] - xyz
    pt_dist = (offset_pred - gt_offsets).abs().sum(-1)
    vmask = (valid & (ins_label != -100)).to(torch.float32)
    denom = vmask.sum() + 1e-6
    norm_loss = (pt_dist * vmask).sum() / denom

    gt_norm = torch.linalg.vector_norm(gt_offsets, dim=1)
    gt_unit = gt_offsets / (gt_norm[:, None] + 1e-8)
    pred_norm = torch.linalg.vector_norm(offset_pred, dim=1)
    pred_unit = offset_pred / (pred_norm[:, None] + 1e-8)
    direction_diff = -(gt_unit * pred_unit).sum(-1)
    dir_loss = (direction_diff * vmask).sum() / denom
    return norm_loss, dir_loss


def mask_losses(pred_mask, gt_mask, valid):
    """(BCE, dice) over scene points; gt_mask is 1/0/-1 and -1 is ignored
    (zero weight).  The BCE is averaged over all valid points, as the
    reference takes ``.mean()`` after weighting."""
    w = (valid & (gt_mask != -1.0)).to(torch.float32)
    gt = torch.where(gt_mask == -1.0, 0.5, gt_mask)  # any value: zero weight
    p = torch.clamp(pred_mask, 1e-7, 1 - 1e-7)
    bce = -(gt * torch.log(p) + (1 - gt) * torch.log(1 - p)) * w
    denom = torch.clamp(valid.to(torch.float32).sum(), min=1.0)
    mask_loss = bce.sum() / denom

    mp = pred_mask * w
    mg = gt_mask * w
    inter = 2.0 * (mg * mp).sum() + 1.0
    union = (mg * mg).sum() + (mp * mp).sum() + 1.0 + 1e-8
    dice = 1.0 - inter / union
    return mask_loss, dice


def get_segmented_scores(scores, fg_thresh=1.0, bg_thresh=0.0):
    """Linear fg/bg ramp: 1 above fg_thresh, 0 below bg_thresh."""
    fg = scores > fg_thresh
    bg = scores < bg_thresh
    k = 1.0 / (fg_thresh - bg_thresh)
    b = bg_thresh / (bg_thresh - fg_thresh)
    mid = scores * k + b
    return torch.where(fg, 1.0, torch.where(bg, 0.0, mid))


def score_loss(clt_scores, prop_valid, point_pid, point_ins, point_kept,
               instance_pointnum, fg_thresh, bg_thresh, proposal_cap, instance_cap):
    """BCE between the predicted proposal scores and their ramped max IoU."""
    ious = iou_ops.proposal_instance_iou(point_pid, point_ins, point_kept,
                                         instance_pointnum, proposal_cap, instance_cap)
    gt_scores = get_segmented_scores(ious.amax(1), fg_thresh, bg_thresh)
    p = torch.clamp(clt_scores, 1e-7, 1 - 1e-7)
    bce = -(gt_scores * torch.log(p) + (1 - gt_scores) * torch.log(1 - p))
    vm = prop_valid.to(torch.float32)
    return (bce * vm).sum() / torch.clamp(vm.sum(), min=1.0)


@telemetry.span("pbnet.losses")
def model_fn(ret, batch, cfg_like, with_instances: bool):
    """(total loss, aux): the loss terms and every overflow counter as f32
    under the JAX package's keys.  ``cfg_like`` has ``fg_thresh`` and
    ``bg_thresh``."""
    sem_l = semantic_loss(ret["sem_pred_score_p"], batch["sem_label"], ret["point_ok"])
    norm_l, dir_l = offset_losses(ret["offset_pred_p"], batch["xyz"], batch["inst_info"],
                                  batch["ins_label"], ret["point_ok"])
    loss = sem_l + norm_l + dir_l
    aux = {"semantic_loss": sem_l, "offset_norm_loss": norm_l, "offset_dir_loss": dir_l}
    for k in ("overflow_vox", "overflow_grid", "overflow_band"):
        if k in ret:
            aux[k] = ret[k].to(torch.float32)
    if with_instances and "overflow" in ret:
        for k, v in ret["overflow"].items():
            aux[f"overflow_{k}"] = v.to(torch.float32)
    if with_instances:
        mask_l, dice_l = mask_losses(ret["mask_scores"], ret["gt_mask"], ret["scene_valid"])
        sc_l = score_loss(
            ret["clt_scores"], ret["prop_valid"], ret["prop_point_pid"],
            batch["ins_label"][ret["prop_point_src"]], ret["prop_point_kept"],
            batch["instance_pointnum"], cfg_like.fg_thresh, cfg_like.bg_thresh,
            ret["clt_scores"].shape[0], batch["instance_pointnum"].shape[0])
        loss = loss + mask_l + dice_l + sc_l
        aux.update(mask_loss=mask_l, dice_loss=dice_l, score_loss=sc_l)
    aux["loss"] = loss
    return loss, aux
