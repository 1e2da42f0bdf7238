"""PBNet: divide-and-conquer 3D instance segmentation, inference forward
(port of pbnet_tpu/models/pbnet.py).

stage 1  backbone MinkUNet (6 -> 32) + semantic/offset heads, voxel->point
         gather
stage 2  per-class gate, clustering (ops/cluster), cluster K-NN local scenes
         assembled with a ragged gather, re-voxelized, D_Unet mask branch,
         proposal threshold
stage 3  ScoreNet over the kept proposal voxels, global avg+max pooled IoU
         score head

Every capacity comes from config.StaticShapes and every stage reports
overflow counts instead of silently dropping work, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..config import StaticShapes
from ..core import coords as ck
from ..core import quantize as qz
from ..core import topology as tp
from ..nn import minkunet, onehot_conv, sparse_ops
from ..nn.modules import MLPHead
from ..ops import cluster as cluster_ops

# per-class mean point counts (SoftGroup/HAIS, PBNet network/PBNet.py:33-34)
COUNT_MEAN = np.array(
    [-1.0, -1.0, 3917.0, 12056.0, 2303.0, 8331.0, 3948.0, 3166.0, 5629.0,
     11719.0, 1003.0, 3317.0, 4912.0, 10221.0, 3889.0, 4136.0, 2120.0, 945.0,
     3967.0, 2589.0],
    np.float32,
)

K_MAX = 6  # neighbor clusters per local scene
N_SLOTS = K_MAX + 1
MASK_THRESH = 0.45  # get_proposal threshold
LOCAL_VOXEL = 0.02  # local-scene voxel size


def make_level0(coords4, feats, valid, stride=1):
    """Sort voxel coords into canonical key order, carrying features along."""
    hi, lo = ck.pack(coords4, valid)
    hi_s, lo_s, coords_s, feats_s = ck.sort_by_key(hi, lo, coords4.to(torch.int32), feats)
    level = tp.SparseLevel(
        coords=coords_s, hi=hi_s, lo=lo_s, valid=hi_s != ck.SENTINEL,
        count=valid.to(torch.int32).sum(dtype=torch.int32), stride=stride,
    )
    return level, torch.where(level.valid[:, None], feats_s, 0.0)


def _segment_sum_i32(vals, seg, num):
    return torch.zeros(num, dtype=torch.int32, device=vals.device).index_add_(
        0, seg.long(), vals.to(torch.int32))


def _i32(v, dev):
    return torch.tensor(v, dtype=torch.int32, device=dev)


class PBNet(nn.Module):
    """The three-stage inference forward.  Parameters are made on
    ``device`` (CUDA unless the caller passes ``device="cpu"``) from a seeded
    ``torch.Generator``; ``convert.py`` loads the JAX package's variables."""

    def __init__(self, shapes: StaticShapes, sem_num: int = 20,
                 voxel_size: float = 0.02, scale_size: float = 1.0,
                 radius: float = 0.04, min_pts: int = 31,
                 backbone_arch: str = "MinkUNet34C", dunet_arch: str = "MinkUNet14A",
                 score_arch: str = "MinkUNet34C", seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        kw = dict(generator=gen, device=dev)
        self.shapes = shapes
        self.sem_num = sem_num
        self.voxel_size = voxel_size
        self.scale_size = scale_size
        self.radius = radius
        self.min_pts = min_pts
        self.MEUnet = minkunet.mink_unet(6, 32, backbone_arch, **kw)
        self.D_Unet = minkunet.mink_unet(34, 32, dunet_arch, **kw)
        self.score_Unet = minkunet.mink_unet(32, 32, score_arch, **kw)
        self.linear_sem = MLPHead(32, 16, sem_num, **kw)
        self.linear_offset = MLPHead(32, 16, 3, **kw)
        self.linear_binary = MLPHead(32, 16, 1, final_sigmoid=True, **kw)
        self.linear_IOU_feat = MLPHead(32, 32, 32, **kw)
        self.linear_IOU = MLPHead(32, 16, 1, final_sigmoid=True, **kw)
        self.register_buffer("count_mean", torch.as_tensor(COUNT_MEAN, device=dev),
                             persistent=False)
        self.eval()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def backbone(self, batch: dict) -> dict:
        """Stage 1: voxel backbone, heads, voxel->point gather."""
        sh = self.shapes
        level0, feats = make_level0(batch["vox_coords"], batch["vox_feats"], batch["vox_valid"])
        topo = tp.build_unet_topology(level0, list(sh.voxel_caps))
        if sh.onehot_spans:
            topo = onehot_conv.attach_plans(topo, sh.onehot_tm, sh.onehot_spans)
        point_feat_v = self.MEUnet(topo, feats)  # (V, 32)
        v0 = topo.levels[0].valid
        sem_score_v = self.linear_sem(point_feat_v, v0)
        offset_v = self.linear_offset(point_feat_v, v0)

        pvalid = batch["point_valid"]
        v2p = tp.point_to_voxel_map(topo.levels[0], batch["xyz"], batch["point_batch"],
                                    pvalid, self.voxel_size)
        ok = (v2p >= 0) & pvalid
        packed_v = torch.cat([point_feat_v, sem_score_v, offset_v], 1)
        g = torch.where(ok[:, None], packed_v[torch.where(ok, v2p, 0).long()], 0.0)
        f = point_feat_v.shape[1]
        s = f + self.sem_num
        sem_score_p = g[:, f:s]
        return {
            "topo": topo,
            "overflow_vox": torch.clamp(
                batch["vox_valid"].sum(dtype=torch.int32) - level0.cap, min=0)
            + topo.level_overflow,
            "overflow_grid": topo.grid_overflow,
            "overflow_band": topo.plan_overflow,
            "point_feat_p": g[:, :f],
            "sem_pred_score_p": sem_score_p,
            "sem_soft_p": torch.softmax(sem_score_p, -1),
            "offset_pred_p": g[:, s:s + 3],
            "sem_pred_p": torch.where(ok, sem_score_p.argmax(-1), -1).to(torch.int32),
            "point_ok": ok,
            "v2p": v2p,
        }

    # ------------------------------------------------------------------
    @torch.no_grad()
    def instance_stage(self, batch: dict, bb: dict, with_labels: bool) -> dict:
        """Stages 2+3.  ``bb`` is stage 1's output (or an injected one with
        the same keys: sem_pred_p, point_ok, offset_pred_p, sem_soft_p,
        point_feat_p)."""
        sh = self.shapes
        xyz = batch["xyz"]
        dev = xyz.device
        n = xyz.shape[0]
        pbatch = batch["point_batch"].to(torch.int32)
        sem_p = bb["sem_pred_p"].to(torch.int32)
        ok = bb["point_ok"]
        count_mean = self.count_mean

        # ---- per-class gate: total class count >= 0.05 * count_mean ----
        sem_clip = torch.clamp(sem_p, 0, self.sem_num - 1)
        class_count = _segment_sum_i32(
            ok, torch.where(ok, sem_clip, self.sem_num), self.sem_num + 1)[: self.sem_num]
        class_ok = class_count.to(torch.float32) >= torch.tensor(0.05, device=dev) * count_mean
        fg = ok & (sem_p >= 2) & class_ok[sem_clip.long()]

        # ---- clustering over the fg points, compacted to fg_point_cap ----
        shifted = xyz + bb["offset_pred_p"]
        NF = sh.fg_point_cap or n
        ckw = dict(radius=self.radius, min_pts=self.min_pts, count_mean=count_mean,
                   cluster_cap=sh.cluster_cap, band=sh.cluster_band,
                   nn_exact_cap=sh.nn_exact_cap)
        if NF < n:
            okey = torch.where(fg, 0, 1).to(torch.int32)
            sel = torch.sort(okey, stable=True).indices[:NF]
            fg_overflow = torch.clamp(fg.sum(dtype=torch.int32) - NF, min=0)
            res_c = cluster_ops.binary_cluster(
                shifted[sel], xyz[sel], sem_p[sel], pbatch[sel], fg[sel], **ckw)
            cid_full = torch.full((n,), -1, dtype=torch.int32, device=dev)
            cid_full[sel] = res_c.cluster_id
            dens_full = torch.zeros(n, dtype=torch.int32, device=dev)
            dens_full[sel] = res_c.density
            res = res_c._replace(cluster_id=cid_full, density=dens_full)
        else:
            fg_overflow = _i32(0, dev)
            res = cluster_ops.binary_cluster(shifted, xyz, sem_p, pbatch, fg, **ckw)
        C = sh.cluster_cap
        cid = res.cluster_id
        csem, cbatch, csize, cvalid = (res.cluster_sem, res.cluster_batch,
                                       res.cluster_size, res.cluster_valid)

        # ---- cluster K-NN within (sem, batch) groups ----
        group = torch.where(cvalid, csem * 64 + cbatch, -1)
        same = (group[:, None] == group[None, :]) & cvalid[:, None] & cvalid[None, :]
        d = res.centers[:, None, :] - res.centers[None, :, :]
        dist = torch.where(
            same, (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2],
            float("inf"))
        # neighbors sorted by distance (stable: ties keep index order)
        knn = torch.argsort(dist, dim=1, stable=True)[:, :N_SLOTS].to(torch.int32)
        group_size = same.sum(1, dtype=torch.int32)
        para_k = torch.clamp(group_size - 1, max=K_MAX)

        # ---- GT label per cluster: mode of member instance labels ----
        if with_labels:
            ins = batch["ins_label"].to(torch.int32)
            I = sh.instance_cap
            member = cid >= 0
            ins_slot = torch.where(ins == -100, 0, torch.clamp(ins, 0, I - 1) + 1)
            flat = torch.where(member, cid * (I + 1) + ins_slot, C * (I + 1))
            counts = _segment_sum_i32(member, flat, C * (I + 1) + 1)[:-1].reshape(C, I + 1)
            mode_slot = counts.argmax(1)  # first max: slot 0 (-100) wins ties
            gt_label_c = torch.where(mode_slot == 0, -100, mode_slot - 1).to(torch.int32)
            skip = cvalid & (gt_label_c == -100)
        else:
            gt_label_c = torch.full((C,), -100, dtype=torch.int32, device=dev)
            skip = torch.zeros(C, dtype=torch.bool, device=dev)

        scene_c = cvalid & ~skip  # clusters that emit a local scene
        pid_of_cluster = torch.where(
            scene_c, torch.cumsum(scene_c.to(torch.int32), 0, dtype=torch.int32) - 1, -1)
        num_proposals = scene_c.sum(dtype=torch.int32)

        # ---- local-scene slot table ----
        expand = scene_c & (
            csize.to(torch.float32)
            > torch.tensor(0.2, device=dev) * count_mean[torch.clamp(csem, 0, self.sem_num - 1).long()]
        ) & (para_k > 0)
        slot_idx = torch.arange(N_SLOTS, device=dev)
        slot_valid = torch.where(
            slot_idx[None, :] == 0, scene_c[:, None],
            expand[:, None] & (slot_idx[None, :] - 1 < para_k[:, None]))
        pk = para_k.to(torch.float32)[:, None]
        sf = slot_idx[None, :].to(torch.float32)
        peak = 0.5 * ((pk + 1.0) - (sf - 1.0)) / (pk + 1.0)
        weight = torch.where(slot_idx[None, :] == 0, torch.ones_like(peak), peak)
        src_cluster = torch.where(slot_valid, knn, 0)

        # ---- ragged gather: flatten (cluster, slot) segments ----
        cid_key = torch.where(cid >= 0, cid, C).to(torch.int32)
        member_pts = torch.sort(cid_key, stable=True).indices
        cluster_start = torch.cat([
            torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(csize, 0)[:-1]])

        seg_len = torch.where(slot_valid, csize[src_cluster.long()], 0).reshape(-1)
        cum = torch.cumsum(seg_len.to(torch.int64), 0)
        total = cum[-1].to(torch.int32)  # scene points actually needed
        T = sh.local_point_cap
        t_idx = torch.arange(T, device=dev)
        # segj[t] = #{j: cum[j] <= t} (searchsorted-right)
        marks = torch.bincount(torch.clamp(cum, max=T), minlength=T + 1)
        segj = torch.cumsum(marks[:T], 0)
        segj_c = torch.clamp(segj, 0, seg_len.shape[0] - 1)
        seg_start = cum[segj_c] - seg_len[segj_c]
        within = t_idx - seg_start
        t_ok = t_idx < torch.clamp(total, max=T)
        own_c = torch.div(segj_c, N_SLOTS, rounding_mode="floor")
        sslot = torch.remainder(segj_c, N_SLOTS)
        sc = src_cluster[own_c, sslot].long()
        src_local = torch.clamp(cluster_start[sc] + within, 0, n - 1)
        src_pt = member_pts[src_local]  # global point index per scene point
        scene_w = weight[own_c, sslot]
        scene_pid = torch.where(t_ok, pid_of_cluster[own_c], -1)

        # ---- scene features: [feat32 | class softmax | weight] ----
        own_sem = torch.clamp(csem[own_c], 0, self.sem_num - 1).long()
        sem_sf = bb["sem_soft_p"][src_pt, own_sem]
        feat32 = bb["point_feat_p"][src_pt]
        scene_feat = torch.cat([feat32, sem_sf[:, None], scene_w[:, None].to(torch.float32)], 1)
        scene_feat = torch.where(t_ok[:, None], scene_feat, 0.0)
        scene_xyz = torch.where(t_ok[:, None], xyz[src_pt], 0.0)

        if with_labels:
            src_ins = batch["ins_label"][src_pt]
            gt_mask = torch.where(
                src_ins == -100, -1.0, (src_ins == gt_label_c[own_c]).to(torch.float32))
            gt_mask = torch.where(t_ok, gt_mask, -1.0)
        else:
            gt_mask = torch.full((T,), -1.0, device=dev)

        # ---- D_Unet over the re-voxelized local scenes ----
        V2 = sh.local_voxel_caps[0]
        q2 = qz.quantize_device(qz.true_div(scene_xyz, LOCAL_VOXEL), scene_pid, t_ok, V2)
        lv2 = tp.level_from_quantize(q2)
        feats2 = torch.where(lv2.valid[:, None], scene_feat[q2["voxel2point"].long()], 0.0)
        # the JAX package derives these maps from the backbone's; the lookup
        # build gives the same maps (pbnet_torch/core/topology.py)
        topo2 = tp.build_unet_topology(lv2, list(sh.local_voxel_caps))
        if sh.onehot_spans_local:
            topo2 = onehot_conv.attach_plans(topo2, sh.onehot_tm, sh.onehot_spans_local)
        d_feat = self.D_Unet(topo2, feats2)
        mask_v = self.linear_binary(d_feat, topo2.levels[0].valid)[:, 0]
        p2v2 = q2["point2voxel"]
        mask_score = torch.where(
            t_ok & (p2v2 >= 0), mask_v[torch.clamp(p2v2, min=0).long()], 0.0)

        # ---- get_proposal: threshold + drop null proposals ----
        kept = t_ok & (mask_score > MASK_THRESH) & (scene_pid >= 0)
        P = C  # proposal capacity = cluster capacity
        kept_per_pid = _segment_sum_i32(kept, torch.where(kept, scene_pid, P), P + 1)[:P]
        pid_alive = kept_per_pid > 0
        pid2 = torch.where(
            pid_alive, torch.cumsum(pid_alive.to(torch.int32), 0, dtype=torch.int32) - 1, -1)
        final_pid = torch.where(kept, pid2[torch.clamp(scene_pid, 0, P - 1).long()], -1)
        num_final = pid_alive.sum(dtype=torch.int32)

        # proposal semantics: the owner cluster's predicted class
        cluster_of_pid = torch.zeros(P + 1, dtype=torch.int32, device=dev)
        cluster_of_pid[torch.where(scene_c, pid_of_cluster, P).long()] = torch.arange(
            C, dtype=torch.int32, device=dev)
        sem_of_pid = csem[cluster_of_pid[:P].long()]
        sem_of_pid2 = torch.zeros(P + 1, dtype=torch.int32, device=dev)
        sem_of_pid2[torch.where(pid_alive, pid2, P).long()] = sem_of_pid
        sem_of_pid2 = sem_of_pid2[:P]

        # ---- ScoreNet over the kept proposal voxels ----
        # On the local-scene lattice (the JAX package's grid branch, scale 1)
        # the ScoreNet topology is DERIVED from topo2: voxels without a kept
        # point drop out level by level through the down maps, every map is
        # reused (a map entry at a dropped voxel reads zeros, as -1 would),
        # and so is every banding plan.  Otherwise the kept points are
        # re-quantized into a fresh topology without plans.
        derive3 = (sh.grid_extent is not None and self.voxel_size == LOCAL_VOXEL
                   and self.scale_size == 1.0)
        if derive3:
            live = kept & (p2v2 >= 0)
            seg_v = torch.where(live, p2v2, V2).long()
            kept_in_vox = _segment_sum_i32(kept, seg_v, V2 + 1)[:V2]
            # representative = first kept scene point of the voxel
            rep3 = torch.full((V2 + 1,), 2**31 - 1, dtype=torch.int64, device=dev).scatter_reduce(
                0, seg_v, torch.where(live, t_idx, T), "amin", include_self=True)[:V2]
            keeps = [topo2.levels[0].valid & (kept_in_vox > 0)]
            for l, km in enumerate(topo2.down_maps):
                child_keep = (km >= 0) & keeps[l][torch.clamp(km, min=0).long()]
                keeps.append(topo2.levels[l + 1].valid & child_keep.any(1))
            topo3 = topo2.replace(levels=tuple(
                lv.replace(valid=kp, count=kp.sum(dtype=torch.int32))
                for lv, kp in zip(topo2.levels, keeps)))
            v3_valid = keeps[0]
            feats3 = torch.where(v3_valid[:, None], feat32[torch.clamp(rep3, max=T - 1)], 0.0)
            vb3 = pid2[torch.clamp(topo2.levels[0].coords[:, 0], 0, P - 1).long()]
            score_count = keeps[0].sum(dtype=torch.int32)
            score_overflow = _i32(0, dev)  # a subset of topo2: cannot overflow
        else:
            sxyz = qz.true_div(scene_xyz * self.scale_size, self.voxel_size)
            V3 = sh.score_voxel_caps[0]
            q3 = qz.quantize_device(torch.where(kept[:, None], sxyz, 0.0),
                                    torch.where(kept, final_pid, -1), kept, V3)
            lv3 = tp.level_from_quantize(q3)
            feats3 = torch.where(lv3.valid[:, None], feat32[q3["voxel2point"].long()], 0.0)
            topo3 = tp.build_unet_topology(lv3, list(sh.score_voxel_caps))
            v3_valid = topo3.levels[0].valid
            vb3 = topo3.levels[0].coords[:, 0]
            score_count = q3["count"]
            score_overflow = torch.clamp(q3["count"] - V3, min=0) + topo3.level_overflow
        iou_feat = self.score_Unet(topo3, feats3)
        iou_feat = self.linear_IOU_feat(iou_feat, v3_valid)
        gfeat = (sparse_ops.global_pool(iou_feat, vb3, v3_valid, P, "max")
                 + sparse_ops.global_pool(iou_feat, vb3, v3_valid, P, "avg"))
        pvalid2 = torch.arange(P, device=dev) < num_final
        clt_scores = self.linear_IOU(gfeat, pvalid2)[:, 0]

        overflow = {
            "cluster_band": res.band_overflow,
            "cluster_nn": res.nn_overflow,
            "fg_points": fg_overflow,
            "scene_points": torch.clamp(total - T, min=0),
            "local_vox": torch.clamp(q2["count"] - V2, min=0) + topo2.level_overflow,
            "local_grid": topo2.grid_overflow,
            # topo3 derives from topo2 (same maps and plans): counted once
            "conv_band": topo2.plan_overflow,
            "score_vox": score_overflow,
            "score_grid": topo3.grid_overflow,
        }
        usage = {
            "scene_points": total,
            "local_vox": q2["count"],
            "score_vox": score_count,
            "fg_points": fg.sum(dtype=torch.int32),
            "kept_points": kept.sum(dtype=torch.int32),
        }
        return {
            "cluster": res,
            "num_proposals": num_proposals,
            "overflow": overflow,
            "usage": usage,
            "scene_total": total,
            "scene_overflow": torch.clamp(total - T, min=0),
            "mask_scores": mask_score,
            "gt_mask": gt_mask,
            "scene_valid": t_ok,
            "scene_pid": scene_pid,
            "scene_src": src_pt,
            "prop_point_src": src_pt,
            "prop_point_pid": final_pid,
            "prop_point_kept": kept,
            "prop_point_mask_score": torch.where(kept, mask_score, 0.0),
            "num_final_proposals": num_final,
            "prop_sem": sem_of_pid2,
            "prop_valid": pvalid2,
            "clt_scores": clt_scores,
        }

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, batch: dict, with_instances: bool = True,
                with_labels: bool = False) -> dict:
        bb = self.backbone(batch)
        ret = {k: bb[k] for k in ("sem_pred_p", "sem_pred_score_p", "offset_pred_p",
                                  "point_ok", "overflow_vox", "overflow_grid",
                                  "overflow_band")}
        if with_instances:
            ret.update(self.instance_stage(batch, bb, with_labels))
        return ret


def batch_to_device(batch: dict, device) -> dict:
    """numpy batch (synthetic.py, the data path) -> tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}
