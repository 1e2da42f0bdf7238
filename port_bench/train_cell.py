"""A training cell: full PBNet train steps through the port, closed loop,
and the check of the steps against the plain reference.

A step is the port's full phase, stage 2 driven by the oracle's classes and
offsets (random weights make no clusters), as ``chip_smoke.full_step``
runs it: ``PBNet.backbone``; ``PBNet.instance_stage`` with labels on the
oracle's classes and offsets and the model's own features and softmax;
``models.losses.model_fn`` over the model's own stage-1 outputs and
stages 2-3; backward; ``parallel.train_step.finish_step`` (Adam at the
traffic's learning rate).  The step ends when its loss, gradient norm and
overflow counters are on the host.

Set-up builds the step's one object (model and optimizer), collates the
traffic's batches with the port's training data path (``Dataset._collate``
at the traffic's caps), and drives the first ``check_steps`` steps on
batches 0, 1, 2, ...: they record what the check compares and warm every
shape.  The window then runs the same object on the following batches,
cycling.

The check, once the window has closed: the plain reference builds its own
batches from the raw rooms and runs the same steps from the same weights
(``reference/``, plain Adam), once in float32 and once with its conv
operands rounded to the configuration's precision.  Numbers judged against
the float32 reference: step 1's stage-1 logits and offsets (as the eval
check reads them), step 1's semantic loss, and each leaf's change after
the last check step, against the larger of the leaf's and the median
leaf's reference norm (leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off and are left out).
Judged against the reference at the configuration's precision: step 1's
loss, and each leaf's gradient norm after step 1 as Adam holds it
(``exp_avg / (1 - beta1)``), by the worst leaf.  Against float32 those two
read what the precision itself does to a first step from random weights
(``grad_look.py``), as far as float8 does; against the same precision
only the program's own departures show.  Logged and not judged: both
against float32, the later steps' losses, and step 1's offset loss.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from . import rooms, spec, window
from .weights import arch_kw, port_kw

STAGE1_KEYS = ("sem_pred_p", "sem_pred_score_p", "offset_pred_p", "point_ok", "overflow_vox",
               "overflow_grid", "overflow_band")
BETA1 = 0.9
STILL = 1e-3  # reference gradient under this share of the median leaf's: round-off
# the loss terms a step reports; the first step's stage-1 terms are compared
TERMS = ("loss", "semantic_loss", "offset_norm_loss", "offset_dir_loss")
AHEAD = 1  # window steps sent before the oldest one's row is read


def oracle_tensors(batch: list, point_cap: int, device):
    sem, offs, _ = rooms.batch_oracle(batch)
    n = sem.shape[0]
    s = np.full(point_cap, -1, np.int32)
    s[:n] = sem
    o = np.zeros((point_cap, 3), np.float32)
    o[:n] = offs
    return torch.from_numpy(s).to(device), torch.from_numpy(o).to(device)


class Program:
    """The port's train step over the traffic's batches."""

    KEYS = ("vox_coords", "vox_feats", "vox_valid", "xyz", "point_batch", "point_valid",
            "sem_label", "ins_label", "inst_info", "instance_pointnum")

    def __init__(self, cell, batches, wts: dict, device, group=None):
        from pbnet_torch.config import Config, StaticShapes
        from pbnet_torch.data.dataset import Dataset
        from pbnet_torch.models.pbnet import PBNet
        from pbnet_torch.nn.modules import set_bn_group
        from pbnet_torch.parallel import train_step

        cfg, tr = cell.config, cell.traffic
        caps = {k: tuple(v) if isinstance(v, list) else v for k, v in tr["caps"].items()}
        self.cfg = Config(shapes=StaticShapes(**caps), optimizer=tr["optimizer"], lr=tr["lr"],
                          fg_thresh=cfg["fg_thresh"], bg_thresh=cfg["bg_thresh"],
                          voxel_size=cfg["voxel_size"], data_root=str(spec.HERE))
        ds = Dataset(self.cfg)
        self.device, self.group = device, group
        self.batches = []
        for i, b in enumerate(batches):
            scenes = [(f"b{i}r{j}", xyz, room.feats[:, :3], room.feats[:, 3:], room.sem,
                       room.ins) for j, (room, xyz) in enumerate(b)]
            nb = ds._collate(scenes)
            t = {k: torch.as_tensor(nb[k]).to(device) for k in self.KEYS}
            t["oracle"] = oracle_tensors(b, self.cfg.shapes.point_cap, device)
            self.batches.append(t)
        self.model = PBNet(self.cfg.shapes, device=device, **port_kw(cfg))
        self.model.load_state_dict(wts)
        if group is not None:
            set_bn_group(self.model, group)
        self.opt = train_step.make_optimizer(self.model, self.cfg)

    def __call__(self, b: int, fault=None, keep_stage1: bool = False) -> dict:
        """One train step on batch ``b``; returns its loss terms, gradient
        norm and overflow on the host (and, if asked, its stage-1 outputs)."""
        return self.read(self.issue(b, fault, keep_stage1))

    @staticmethod
    def read(sent: tuple) -> dict:
        """The host row of a step that ``issue`` sent (waits for the step)."""
        vals, stage1 = sent
        vals = vals.tolist()
        row = dict(zip(TERMS, vals))
        row.update(grad_norm=vals[-3], overflow=vals[-2], clusters=int(vals[-1]), stage1=stage1)
        return row

    def issue(self, b: int, fault=None, keep_stage1: bool = False) -> tuple:
        """Send one train step on batch ``b`` to the device; returns what
        ``read`` takes, still on the device (nothing waits for the step)."""
        from pbnet_torch.models import losses
        from pbnet_torch.parallel import train_step

        batch = self.batches[b]
        sem_o, offs_o = batch["oracle"]
        if fault is not None:
            batch = fault.batch(batch)
        model = self.model
        model.train()
        self.opt.zero_grad(set_to_none=True)
        with record_function("step.forward"):
            bb = model.backbone(batch)
            bb2 = dict(bb, sem_pred_p=torch.where(bb["point_ok"], sem_o, -1),
                       offset_pred_p=offs_o)
            ret = {k: bb[k] for k in STAGE1_KEYS}
            ret.update(model.instance_stage(batch, bb2, True))
            loss, aux = losses.model_fn(ret, batch, self.cfg, True)
        with record_function("step.backward"):
            loss.backward()
        with record_function("step.update"):
            if fault is not None and fault.skip_update:
                aux = dict(aux, grad_norm=torch.zeros(()), param_norm=torch.zeros(()))
            else:
                aux = train_step.finish_step(model, self.opt, self.cfg, aux, self.cfg.lr,
                                             self.group)
        over = sum(v for k, v in aux.items() if k.startswith("overflow"))
        dev = loss.device
        vals = torch.stack([aux[k].detach().float().to(dev) for k in TERMS]
                           + [aux["grad_norm"].float().to(dev), over.float().to(dev),
                              torch.as_tensor(ret["cluster"].num_clusters).float().to(dev)])
        return vals, stage1_outputs(bb) if keep_stage1 else None

    def grad_norms_after_first(self) -> dict:
        """Each leaf's gradient norm as Adam holds it after one step."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        return {names[id(p)]: float(st["exp_avg"].norm()) / (1 - BETA1)
                for p, st in self.opt.state.items()}

    def change_norms(self, w0: dict) -> dict:
        return {n: float((p.detach() - w0[n]).norm()) for n, p in self.model.named_parameters()}


def stage1_outputs(bb: dict) -> dict:
    """Stage 1's outputs of a step, as the eval check reads them."""
    return {"ok": bb["point_ok"].detach(), "logits": bb["sem_pred_score_p"].detach(),
            "offsets": bb["offset_pred_p"].detach()}


def leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    """The worst leaf's gap of norms, against the larger of its own and the
    median leaf's reference norm."""
    names = [n for n in ref if leaves is None or n in leaves]
    if not names:
        return 0.0
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def compare(prog: dict, ref: dict, same: dict) -> dict:
    """The numbers of the check steps (``prog``, the float32 reference
    ``ref`` and the reference at the configuration's precision ``same``:
    each step's ``losses``, ``stage1`` outputs and loss ``terms`` of step
    1, ``grads`` after it, ``changes`` after the last)."""
    from .check import gap

    p, r = prog["stage1"], ref["stage1"]
    ok = p["ok"].cpu() & r["ok"].cpu()
    med = float(np.median(list(ref["grads"].values())))
    moving = {n for n, g in ref["grads"].items() if g >= STILL * med}
    return {"logit_gap": gap(p["logits"].cpu(), r["logits"].cpu(), ok),
            "offset_gap": gap(p["offsets"].cpu(), r["offsets"].cpu(), ok),
            "semantic_loss_gap": _rel(prog, ref, "semantic_loss"),
            "update_gap": leaf_gap(prog["changes"], ref["changes"], moving),
            "loss_gap": loss_gap(prog, same, 0, 1),
            "grad_gap": leaf_gap(prog["grads"], same["grads"])}


def loss_gap(prog: dict, ref: dict, first: int = 0, stop=None) -> float:
    """The largest relative gap of the check steps' losses, steps ``first``
    to ``stop`` (from 0)."""
    pairs = list(zip(prog["losses"], ref["losses"]))[first:stop]
    return max((abs(a - b) / max(abs(b), 1e-30) for a, b in pairs), default=0.0)


def _rel(prog: dict, ref: dict, k: str) -> float:
    return abs(prog["terms"][k] - ref["terms"][k]) / max(abs(ref["terms"][k]), 1e-30)


def uncompared(prog: dict, ref: dict, same: dict) -> dict:
    """Readings the check logs and does not judge (no control or fault
    separates them from sound runs): the later steps' losses against the
    reference at the same precision; against float32, each step's loss, the
    worst leaf's gradient norm after step 1, step 1's offset loss."""
    return {"later_loss_gap": loss_gap(prog, same, 1),
            "loss_gap_f32": loss_gap(prog, ref),
            "grad_gap_f32": leaf_gap(prog["grads"], ref["grads"]),
            "offset_loss_gap": _rel(prog, ref, "offset_norm_loss")}


def diagnose(prog: dict, ref: dict) -> dict:
    """Where the leaf gaps come from: the worst leaf of each, and the
    median leaf's gap."""
    out = {}
    for key in ("grads", "changes"):
        p, r = prog[key], ref[key]
        med = float(np.median(list(r.values())))
        gaps = {n: abs(p.get(n, 0.0) - r[n]) / max(r[n], med, 1e-30) for n in r}
        worst = max(gaps, key=gaps.get)
        out[key] = {"worst_leaf": worst, "worst": gaps[worst], "ref_norm": r[worst],
                    "median_norm": med, "median_gap": float(np.median(list(gaps.values())))}
    return out


class Ranks:
    """The data-parallel ranks a training run is one of: the program's
    process ``group`` (its gradient all-reduce and SyncBN), the reference's
    ``ref_group`` (any backend), this ``rank`` and the ``world`` size."""

    def __init__(self, group=None, ref_group=None, rank: int = 0, world: int = 1):
        self.group, self.ref_group, self.rank, self.world = group, ref_group, rank, world

    def pick(self, step: int, n_batches: int) -> int:
        """The batch this rank trains on at global step ``step``: a
        different one per rank per step."""
        return (step * self.world + self.rank) % n_batches

    def agree(self, stop: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if self.group is None:
            return stop
        import torch.distributed as dist

        flag = torch.tensor([float(stop)], device=_group_device(self.group))
        dist.broadcast(flag, 0, group=self.group)
        return bool(flag.item())


def _group_device(group):
    import torch.distributed as dist

    return torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")


SOLO = Ranks()


def _host_mean(x: torch.Tensor, group, world: int) -> torch.Tensor:
    import torch.distributed as dist

    y = x.detach().cpu().clone()
    dist.all_reduce(y, group=group)
    return (y / world).to(x.device)


def reference_steps(cell, batches, wts: dict, device, n: int, operands="float32",
                    ranks: Ranks = SOLO) -> dict:
    """The plain reference's first ``n`` steps on ``batches`` from ``wts``:
    losses, gradient norms after step 1 and change norms after step ``n``.
    Over ranks, each rank takes its own batches, the norms' statistics are
    summed over ``ranks.ref_group`` (SyncBatchNorm) and the gradients and
    losses averaged over it."""
    from .reference import collate as ref_collate
    from .reference.models import losses as ref_losses
    from .reference.models import pbnet as ref_pbnet
    from .reference.nn import sparse_ops as ref_sparse
    from .reference.nn.modules import set_bn_group

    cfg, tr = cell.config, cell.traffic
    caps = ref_collate.Caps.from_dict(tr["caps"])
    model = ref_pbnet.PBNet(caps, device=device, **arch_kw(cfg))
    model.load_state_dict(wts)
    if ranks.ref_group is not None:
        set_bn_group(model, ranks.ref_group)
    named = list(model.named_parameters())
    opt = torch.optim.Adam([p for _, p in named], lr=tr["lr"], betas=(BETA1, 0.999), eps=1e-8)
    thr = type("T", (), {"fg_thresh": cfg["fg_thresh"], "bg_thresh": cfg["bg_thresh"]})
    ref_sparse.OPERANDS = operands
    out = {"losses": []}
    try:
        for s in range(n):
            b = batches[ranks.pick(s, len(batches))]
            batch = ref_collate.collate_train(
                [(xyz, room.feats, room.sem, room.ins) for room, xyz in b], caps,
                cfg["voxel_size"], device)
            sem_o, offs_o = oracle_tensors(b, caps.point_cap, device)
            model.train()
            opt.zero_grad(set_to_none=True)
            bb = model.backbone(batch)
            bb2 = dict(bb, sem_pred_p=torch.where(bb["point_ok"], sem_o, -1),
                       offset_pred_p=offs_o)
            ret = {k: bb[k] for k in STAGE1_KEYS}
            ret.update(model.instance_stage(batch, bb2, True))
            loss, aux = ref_losses.model_fn(ret, batch, thr, True)
            loss.backward()
            loss = loss.detach()
            if s == 0:
                out["stage1"] = stage1_outputs(bb)
                terms = torch.stack([aux[k].detach() for k in TERMS])
                if ranks.ref_group is not None:
                    terms = _host_mean(terms, ranks.ref_group, ranks.world)
                out["terms"] = dict(zip(TERMS, terms.tolist()))
            for _, p in named:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if ranks.ref_group is not None:
                    p.grad = _host_mean(p.grad, ranks.ref_group, ranks.world)
            if ranks.ref_group is not None:
                loss = _host_mean(loss, ranks.ref_group, ranks.world)
            opt.step()
            out["losses"].append(float(loss))
            if s == 0:
                out["grads"] = {nm: float(opt.state[p]["exp_avg"].norm()) / (1 - BETA1)
                                for nm, p in named}
            del bb, bb2, ret, loss, aux
        out["changes"] = {nm: float((p.detach() - wts[nm]).norm()) for nm, p in named}
    finally:
        ref_sparse.OPERANDS = "float32"
    return out


def first_steps(cell, seed: int, device, fault=None, ranks: Ranks = SOLO):
    """Set-up: the batches, the weights, the step's one object, and the
    first ``check_steps`` steps through it.  Returns (program, batches,
    weights, what the check compares, the steps' rows)."""
    from . import weights

    n_check = cell.traffic["check_steps"]
    batches = rooms.make_batches(cell.traffic, seed)
    wts = weights.make(cell.config, seed, device)
    exchange = fault is None or not getattr(fault, "no_exchange", False)
    prog = Program(cell, batches, wts, device, ranks.group if exchange else None)
    rows, first = [], {"losses": []}
    for s in range(n_check):
        r = prog(ranks.pick(s, len(batches)), fault, keep_stage1=s == 0)
        rows.append(r)
        first["losses"].append(r["loss"])
        if s == 0:
            first["grads"] = prog.grad_norms_after_first()
            first["terms"] = {k: r[k] for k in TERMS}
            first["stage1"] = r["stage1"]
    first["changes"] = prog.change_norms(wts)
    return prog, batches, wts, first, rows


def run(cell, seed: int, seconds: float, trace: bool, device, log, fault=None,
        ranks: Ranks = SOLO) -> dict:
    """One run of a training cell on this rank's card."""
    cuda = device.type == "cuda"
    n_check = cell.traffic["check_steps"]
    t0 = time.perf_counter()
    prog, batches, wts, first, rows = first_steps(cell, seed, device, fault, ranks)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[set-up] {setup_s:.3f} s: {len(batches)} batches; check steps "
        f"{[(round(r['loss'], 5), r['clusters'], r['overflow']) for r in rows]}")

    steps, sent = [], []

    def send(k):
        # a step's row is read once the next step is sent: the host issues
        # step k+1's forward while the device still runs step k's backward
        sent.append(prog.issue(ranks.pick(n_check + k, len(batches)), fault))
        if len(sent) > AHEAD:
            steps.append(prog.read(sent.pop(0)))

    def finish():
        while sent:
            steps.append(prog.read(sent.pop(0)))

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    record = {"kind": "train", "setup_s": setup_s}
    if trace:
        from . import trace as tr_mod

        record["trace"] = tr_mod.traced(send, len(batches), finish)
        record["requests"] = len(steps)
    else:
        record["window"] = window.closed_loop(send, seconds, agree=ranks.agree, finish=finish)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = [r for r in rows + steps if r["overflow"] or r["clusters"] <= 0
           or not np.isfinite(r["loss"])]
    log(f"[window] {len(steps)} steps, {len(bad)} failed; losses "
        f"{[round(r['loss'], 4) for r in steps[:8]]}...")
    del prog
    if cuda:
        torch.cuda.empty_cache()

    t1 = time.perf_counter()
    ref = reference_steps(cell, batches, wts, device, n_check, ranks=ranks)
    same = reference_steps(cell, batches, wts, device, n_check, cell.config["conv_operands"],
                           ranks)
    numbers = compare(first, ref, same)
    log(f"[check] {n_check} steps of the reference, twice, in "
        f"{time.perf_counter() - t1:.3f} s; losses {first['losses']} vs {ref['losses']} "
        f"(float32), {same['losses']} (same precision); not judged: {uncompared(first, ref, same)}")
    if trace:
        record["work"] = train_work(cell, batches, wts, device, len(steps), n_check, ranks)
    return {"record": record, "numbers": numbers, "attempted": len(steps) + n_check,
            "failed": len(bad), "peak": peak}


def train_work(cell, batches, wts, device, n_steps, n_check, ranks: Ranks = SOLO) -> dict:
    """Useful operations of this rank's traced steps: three times the
    forward's, counted from the reference's maps on each step's batch."""
    from . import check, work
    from .reference import collate as ref_collate
    from .reference.models import pbnet as ref_pbnet

    cfg, tr = cell.config, cell.traffic
    caps = ref_collate.Caps.from_dict(tr["caps"])
    model = ref_pbnet.PBNet(caps, device=device, **arch_kw(cfg))
    model.load_state_dict(wts)
    model.train()
    per_batch = {}
    total = 0
    for k in range(n_steps):
        b = ranks.pick(n_check + k, len(batches))
        if b not in per_batch:
            batch = ref_collate.collate_train(
                [(xyz, room.feats, room.sem, room.ins) for room, xyz in batches[b]], caps,
                cfg["voxel_size"], device)
            sem_o, offs_o = oracle_tensors(batches[b], caps.point_cap, device)
            with torch.no_grad(), work.WorkCount(
                    operand_bytes=check.OPERAND_BYTES[cfg["conv_operands"]]) as wc:
                bb = model.backbone(batch)
                model.instance_stage(batch, dict(bb, sem_pred_p=torch.where(
                    bb["point_ok"], sem_o, -1), offset_pred_p=offs_o), True)
            per_batch[b] = 3 * wc.ops()
        total += per_batch[b]
    return {"ops": total}
