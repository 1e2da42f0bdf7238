"""Where a training cell's first-step gradient gaps come from: a look at the
check's numbers, run by hand at the cell's own size (the benchmark's own
runs never run it).

    python3 -m port_bench.grad_look --workload pbnet34c.train --seeds 1,2,3

For each seed, the first step's gradient of every leaf, as the check reads
it, from:

* ``program``: the port, through the step object set-up builds;
* ``bf16``: the plain reference with its conv operands rounded to
  bfloat16, the configuration's precision;
* ``bf16_pinned``: the same, with the reference's float32 decisions
  replayed: which local-scene points pass the 0.45 mask threshold and which
  voxel each proposal's max-pool picks in each channel;
* ``float8``: the control;

each against the float32 reference.  A line per seed holds, for each: the
worst leaf's gap (as ``train_cell.leaf_gap``) and name, the worst leaf of
each stage, the median leaf's gap, and step 1's loss terms' gaps; for the
references also the gap of the gradient of each group of loss terms alone
(stage 1: semantic and offsets; masks: BCE and dice; scores); the number
of points whose threshold decision flips and the share of max-pool picks
that change; and, for the worst leaves that belong to a normalisation
layer, that layer's rows and its largest |mean| / std over its channels in
the float32 reference (the gain by which the layer multiplies a rounding
error of its input, relative to that input's size).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from . import rooms, spec, train_cell, weights
from .weights import arch_kw

GROUPS = {"stage1": ("semantic_loss", "offset_norm_loss", "offset_dir_loss"),
          "masks": ("mask_loss", "dice_loss"), "scores": ("score_loss",)}
TERMS = GROUPS["stage1"] + GROUPS["masks"] + GROUPS["scores"]


def stage(leaf: str) -> str:
    if leaf.startswith(("score_Unet", "linear_IOU")):
        return "scores"
    if leaf.startswith(("D_Unet", "linear_binary")):
        return "masks"
    return "stage1"


class Decisions:
    """Records the reference's discontinuous decisions in one run and
    replays them in the next."""

    def __init__(self):
        self.kept, self.picks, self.mode = [], [], "record"
        self.flips, self.changed = 0, []

    def __enter__(self):
        from .reference.models import pbnet as ref_pbnet
        from .reference.nn import sparse_ops as ref_sparse

        self._thresh, self._pool = ref_pbnet.over_mask_thresh, ref_sparse.global_pool
        self._i = self._j = 0
        ref_pbnet.over_mask_thresh = self.thresh
        ref_sparse.global_pool = self.pool
        return self

    def __exit__(self, *exc):
        from .reference.models import pbnet as ref_pbnet
        from .reference.nn import sparse_ops as ref_sparse

        ref_pbnet.over_mask_thresh, ref_sparse.global_pool = self._thresh, self._pool
        if self.mode == "record":
            self.mode = "compare"

    def thresh(self, mask):
        own = self._thresh(mask)
        if self.mode == "record":
            self.kept.append(own)
            return own
        ref = self.kept[self._i]
        self._i += 1
        self.flips += int((own != ref).sum())
        return ref if self.mode == "replay" else own

    def pool(self, feats, ids, valid, n, mode):
        if mode != "max":
            return self._pool(feats, ids, valid, n, mode)
        own = _picks(feats, ids, valid, n)
        if self.mode == "record":
            self.picks.append(own)
            return self._pool(feats, ids, valid, n, mode)
        ref = self.picks[self._j]
        self._j += 1
        self.changed.append(float((own != ref).float().mean()))
        if self.mode != "replay":
            return self._pool(feats, ids, valid, n, mode)
        return torch.where(ref >= 0, torch.gather(feats, 0, ref.clamp(min=0)), 0.0)


def _picks(feats, ids, valid, n):
    """The row each (segment, channel) max takes (-1: empty segment)."""
    c = feats.shape[1]
    seg = torch.where(valid, ids, n).long()[:, None].expand(-1, c)
    src = torch.where(valid[:, None], feats.detach(), float("-inf"))
    top = torch.full((n + 1, c), float("-inf"), device=feats.device).scatter_reduce(
        0, seg, src, "amax")
    rows = torch.arange(feats.shape[0], device=feats.device)[:, None].expand(-1, c)
    hit = (src == top.gather(0, seg)) & valid[:, None]
    pick = torch.full((n + 1, c), -1, dtype=torch.long, device=feats.device)
    return pick.scatter_reduce(0, seg, torch.where(hit, rows, -1), "amax")[:n]


def norm_gains(model) -> tuple:
    """Forward hooks on every normalisation layer: its rows and largest
    |mean| / std in the run."""
    from .reference.nn.modules import MaskedBatchNorm

    out, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, MaskedBatchNorm):
            def hook(mod, args, _y, name=name):
                x, v = args[0].detach(), args[1]
                xs = x[v]
                mean, var = xs.mean(0), xs.var(0, unbiased=False)
                out[name] = (int(v.sum()), float((mean.abs() * torch.rsqrt(var + mod.eps)).max()))
            hooks.append(m.register_forward_hook(hook))
    return out, hooks


def reference_first(cell, batches, wts, device, operands, decisions=None, gains=False) -> dict:
    """The reference's first step: each group's and the whole loss's
    gradient norms per leaf, and the loss terms."""
    from .reference import collate as ref_collate
    from .reference.models import losses as ref_losses
    from .reference.models import pbnet as ref_pbnet
    from .reference.nn import sparse_ops as ref_sparse

    cfg, tr = cell.config, cell.traffic
    caps = ref_collate.Caps.from_dict(tr["caps"])
    model = ref_pbnet.PBNet(caps, device=device, **arch_kw(cfg))
    model.load_state_dict(wts)
    model.train()
    named = list(model.named_parameters())
    stats, hooks = norm_gains(model) if gains else ({}, [])
    b = batches[0]
    batch = ref_collate.collate_train([(xyz, room.feats, room.sem, room.ins) for room, xyz in b],
                                      caps, cfg["voxel_size"], device)
    sem_o, offs_o = train_cell.oracle_tensors(b, caps.point_cap, device)
    thr = type("T", (), {"fg_thresh": cfg["fg_thresh"], "bg_thresh": cfg["bg_thresh"]})
    ref_sparse.OPERANDS = operands
    try:
        with decisions if decisions is not None else contextlib.nullcontext():
            bb = model.backbone(batch)
            bb2 = dict(bb, sem_pred_p=torch.where(bb["point_ok"], sem_o, -1),
                       offset_pred_p=offs_o)
            ret = {k: bb[k] for k in train_cell.STAGE1_KEYS}
            ret.update(model.instance_stage(batch, bb2, True))
            loss, aux = ref_losses.model_fn(ret, batch, thr, True)
        out = {"terms": {k: float(aux[k].detach()) for k in TERMS}, "gains": stats}
        params = [p for _, p in named]
        for g, keys in list(GROUPS.items()) + [("all", TERMS)]:
            part = sum(aux[k] for k in keys)
            gs = torch.autograd.grad(part, params, retain_graph=g != "all", allow_unused=True)
            out[g] = {n: float(x.norm()) if x is not None else 0.0
                      for (n, _), x in zip(named, gs)}
    finally:
        ref_sparse.OPERANDS = "float32"
        for h in hooks:
            h.remove()
    return out


def worst(p: dict, r: dict) -> dict:
    med = float(np.median(list(r.values())))
    gaps = {n: abs(p.get(n, 0.0) - r[n]) / max(r[n], med, 1e-30) for n in r}
    order = sorted(gaps, key=gaps.get, reverse=True)
    by_stage = {}
    for n in order:
        by_stage.setdefault(stage(n), (n, round(gaps[n], 4)))
    return {"gap": round(gaps[order[0]], 4), "leaves": [(n, round(gaps[n], 4)) for n in order[:3]],
            "by_stage": by_stage, "median_gap": round(float(np.median(list(gaps.values()))), 4)}


def look(cell, seed: int, device) -> dict:
    batches = rooms.make_batches(cell.traffic, seed)
    wts = weights.make(cell.config, seed, device)
    prog, _, _, first, _ = train_cell.first_steps(cell, seed, device)
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    dec = Decisions()
    ref = reference_first(cell, batches, wts, device, "float32", dec, gains=True)
    out = {"seed": seed, "program": worst(first["grads"], ref["all"])}
    out["program"]["terms"] = {k: _rel(first["terms"][k], ref["terms"][k])
                               for k in train_cell.TERMS[1:]}
    for name, ops, mode in (("bf16", "bfloat16", "compare"), ("bf16_pinned", "bfloat16", "replay"),
                            ("float8", "float8", "compare")):
        dec.mode, dec.flips, dec.changed = mode, 0, []
        got = reference_first(cell, batches, wts, device, ops, dec)
        row = worst(got["all"], ref["all"])
        row["groups"] = {g: worst(got[g], ref[g])["leaves"][0] for g in GROUPS}
        row["terms"] = {k: _rel(got["terms"][k], ref["terms"][k]) for k in TERMS}
        row["mask_flips"], row["max_picks_changed"] = dec.flips, dec.changed
        out[name] = row
    leaves = {n for v in out.values() if isinstance(v, dict) and "leaves" in v
              for n, _ in v["leaves"]}
    out["norm_gain"] = {n: ref["gains"][n.rsplit(".", 1)[0]] for n in sorted(leaves)
                        if n.rsplit(".", 1)[0] in ref["gains"]}
    gains = sorted(g for _, g in ref["gains"].values())
    out["norm_gain_median"] = gains[len(gains) // 2]
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.grad_look")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(args.workload)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = look(cell, int(s), torch.device("cuda", 0))
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
