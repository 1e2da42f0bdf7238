"""Training and evaluation (port of ``pbnet_tpu/engine.py``).

* ``train``: the reference's schedule — backbone-only steps through
  ``cfg.cluster_epoch``, the full three-stage pipeline after it; the cosine
  learning rate per epoch; per-iteration console meters with an ETA; a
  warning when any overflow counter is non-zero; per-epoch scalars in
  ``logpath/scalars.jsonl`` (and TensorBoard where it imports); a checkpoint
  every epoch, auto-resume from the newest one (the port's or the JAX
  package's); validation every 4th epoch and at the last; a
  ``torch.profiler`` trace of iterations ``[2, 2 + cfg.profile_steps)``,
  with the port's ``pbnet.*`` spans in it (``telemetry``).
  With ``cfg.num_devices > 1`` (0: every visible GPU) or ``cfg.nodes > 1``
  it is data-parallel: one process per local rank (``parallel/``), SyncBN
  with ``cfg.sync_bn``, gradients, aux and BN statistics averaged every
  step; rank 0 alone writes the log, scalars and checkpoints.
* ``evaluate``: semantic mIoU/mAcc/allAcc and, past ``cluster_epoch``, the
  ScanNet instance AP of the validation split, one scene (3 TTA copies) per
  forward in the smallest size bucket it fits; over a process group each
  rank forwards its share of the scenes and the results merge in scene
  order.
* ``evaluate_pretrained`` and ``predict_testset``: the standalone eval and
  benchmark-submission drivers over a restored checkpoint.
"""

from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device, telemetry
from .config import Config
from .data.dataset import Dataset
from .eval_pipeline import eval_scene_instances
from .models.pbnet import PBNet, batch_to_device
from .nn.modules import set_bn_group
from .ops import window_kernels
from .parallel import distributed, mesh
from .parallel.train_step import (cosine_lr_after_step, make_eval_step, make_optimizer,
                                  make_train_step)
from .tools import eval_protocol
from .tools import log as log_tools
from .tools import metrics


class ScalarWriter:
    """Scalar logging: one JSON object per line in ``scalars.jsonl``, and
    TensorBoard events where ``torch.utils.tensorboard`` imports."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.f = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(logdir)

    def add_scalar(self, tag, value, step):
        self.f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self.f.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def close(self):
        self.f.close()
        if self.tb is not None:
            self.tb.close()


def build_model(cfg: Config, device=None, shapes=None, group=None) -> PBNet:
    """PBNet of ``cfg`` with seeded weights; over a process ``group`` with
    ``cfg.sync_bn`` its BatchNorms are SyncBatchNorms."""
    model = PBNet(shapes=shapes or cfg.shapes, sem_num=cfg.sem_num, voxel_size=cfg.voxel_size,
                  scale_size=cfg.scale_size, radius=cfg.radius, min_pts=cfg.min_pts,
                  backbone_arch=cfg.backbone_arch, dunet_arch=cfg.dunet_arch,
                  score_arch=cfg.score_arch, seed=cfg.manual_seed, device=device)
    if group is not None and cfg.sync_bn:
        set_bn_group(model, group)
    return model


_HOST_ONLY = {"num_points", "num_voxels", "num_instances", "fn", "sup", "shapes", "keep_idx",
              "orig_num_points", "dropped_sem", "collate_s"}


def device_batch(batch: dict, device) -> dict:
    """The arrays a forward reads, as tensors on ``device``."""
    return batch_to_device({k: v for k, v in batch.items()
                            if k not in _HOST_ONLY and v is not None}, device)


def scatter_cropped_masks(pred_info: dict, batch: dict) -> dict:
    """Expand proposal masks of a cropped oversize scene back to the full
    point count (dropped points belong to no proposal)."""
    keep = batch.get("keep_idx")
    if keep is None:
        return pred_info
    full = np.zeros((pred_info["mask"].shape[0], batch["orig_num_points"]),
                    pred_info["mask"].dtype)
    full[:, keep] = pred_info["mask"]
    return dict(pred_info, mask=full)


def scene_superpoints(batch: dict) -> np.ndarray:
    """The superpoint ids of the scene's base copy, dense from 0.  A cropped
    scene keeps a subset of the decoded ids, which superpoint alignment
    (dense ids) cannot index; the JAX package passes them as they are and
    raises IndexError there (pbnet_tpu/engine.py:370)."""
    if batch.get("keep_idx") is None:
        return batch["sup"]
    return np.unique(batch["sup"], return_inverse=True)[1]


class _BucketModels:
    """One eval step per size bucket, over a model built at the bucket's
    first scene and loaded with ``model``'s state dict (weights do not
    depend on the caps); ``model`` itself serves its own shapes.  Keys the
    buckets for ``timing`` as the JAX package does (primes where two
    buckets round alike)."""

    def __init__(self, cfg, model, with_instances=True, with_labels=False):
        self.cfg, self.model = cfg, model
        self.modes = (with_instances, with_labels)
        self.device = next(model.parameters()).device
        self.steps, self.keys = {}, {}

    def get(self, shapes):
        """(eval step ``batch -> host outputs``, timing key, whether it was
        just built)."""
        new = shapes not in self.steps
        if new:
            if shapes == self.model.shapes:
                m = self.model
            else:
                m = build_model(self.cfg, self.device, shapes)
                m.load_state_dict(self.model.state_dict())
            self.steps[shapes] = make_eval_step(m.eval(), *self.modes)
            k = f"p{shapes.point_cap}/v{shapes.voxel_caps[0]}"
            while k in self.keys.values():
                k += "'"
            self.keys[shapes] = k
        return self.steps[shapes], self.keys[shapes], new


def evaluate(cfg: Config, model: PBNet, dataset, epoch, logger=None, writer=None,
             max_scenes: int | None = None, test_mode: bool = False,
             timing: dict | None = None, group=None) -> dict:
    """Validation: semantic mIoU + (past cluster_epoch) instance AP, on the
    model's device (PBNet train.py:123-304, eval_map.py:40-158).

    test_mode=True reproduces the standalone eval driver (task='test'): no
    labels in the forward, so no proposals are skipped by GT-mode and no
    mask-accuracy meters.

    Over a process ``group`` (every rank calls it) rank ``r`` forwards val
    scenes ``r, r + world, ...`` and runs their host work; the per-scene
    results are gathered to every rank and merged in scene order, so the
    metrics equal a one-rank run's and every rank returns them.  An error on
    any rank is raised on every rank.

    ``timing`` (a dict to fill) gets the JAX package's keys
    (``bucket_compile_s``: the first forward's seconds per bucket;
    ``bucket_scene_counts``, ``wall_s``, ``scenes``, ``compile_s``,
    ``scenes_per_sec``, ``scenes_per_sec_warm``) and ``per_scene``: for each
    scene its name, points, voxels, bucket, overflow counters, clustering
    kernel launches, collate seconds, forward ms (to the outputs on the
    host), peak device memory of the forward in GiB (None on the CPU),
    host-eval seconds and proposals.
    """
    with_instances = epoch > cfg.cluster_epoch
    use_labels = with_instances and not test_mode
    emit = logger.info if logger else print
    rank, world = (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))

    inter_m = np.zeros(cfg.sem_num)
    union_m = np.zeros(cfg.sem_num)
    target_m = np.zeros(cfg.sem_num)
    matches = {}
    gt_dir = os.path.join(cfg.data_root, "val_gt")
    buckets = _BucketModels(cfg, model, with_instances, use_labels)
    dev = buckets.device

    all_acc = metrics.AverageMeter()
    tp_acc = metrics.AverageMeter()
    tf_acc = metrics.AverageMeter()
    n_scenes = len(dataset.val_file_list)
    if max_scenes:
        n_scenes = min(n_scenes, max_scenes)

    def scene_work(i, batch, ret):
        """Host-side per-scene metric work — PURE (no shared state):
        semantic histogram, mask stats, NMS/superpoint/AP assignment.  Runs
        on the worker pool over host arrays; the serial accumulation happens
        in merge_scene."""
        t0 = time.perf_counter()
        out = {}
        n = batch["num_points"]
        ov = (int(ret.get("overflow_vox", 0)) + int(ret.get("overflow_grid", 0))
              + int(ret.get("overflow_band", 0)))
        if "overflow" in ret:
            ov += sum(int(v) for v in ret["overflow"].values())
        if ov:
            emit(f"WARNING {batch.get('fn', i)}: capacity overflow, {ov} items "
                 f"dropped — raise StaticShapes caps")
        sem_pred = ret["sem_pred_p"][:n]
        sem_lab = batch["sem_label"][:n]
        out["iu"] = metrics.intersection_and_union(sem_pred, sem_lab, cfg.sem_num)
        if batch.get("keep_idx") is not None:
            # cropped oversize scene: dropped points carry no prediction, so
            # their GT classes count as misses.  The labels are float64 as
            # decoded; the JAX package bincounts them as they are, which
            # raises TypeError (pbnet_tpu/engine.py:352-355)
            dsem = batch["dropped_sem"].astype(np.int64)
            out["dropped_cnt"] = np.bincount(
                dsem[(dsem >= 0) & (dsem < cfg.sem_num)], minlength=cfg.sem_num
            )[: cfg.sem_num]

        if with_instances and use_labels:
            pm = ret["mask_scores"] >= 0.5
            gm = ret["gt_mask"]
            sv = ret["scene_valid"] & (gm != -1.0)
            if sv.any():
                out["mask_all"] = float((pm[sv] == (gm[sv] == 1.0)).mean())
                pos = sv & (gm == 1.0)
                neg = sv & (gm == 0.0)
                if pos.any():
                    out["mask_tp"] = float(pm[pos].mean())
                if neg.any():
                    out["mask_tf"] = float(1.0 - pm[neg].mean())
        out["proposals"] = 0
        if with_instances:
            pred_info = eval_scene_instances(ret, n, scene_superpoints(batch), cfg)
            if pred_info is None:
                print("no cluster")
            else:
                pred_info = scatter_cropped_masks(pred_info, batch)
                gt_ids = eval_protocol.load_gt_ids(os.path.join(gt_dir, batch["fn"] + ".txt"))
                gt2pred, pred2gt = eval_protocol.assign_instances_for_scan(
                    batch["fn"], pred_info, gt_ids)
                out["match"] = (batch["fn"], {"gt": gt2pred, "pred": pred2gt})
                out["proposals"] = pred_info["mask"].shape[0]
                print(f"complete {i}, has {pred_info['mask'].shape[0]} clts")
        out["host_eval_s"] = time.perf_counter() - t0
        return out

    per_scene = []

    def merge_scene(out, record):
        """Serial accumulator merge (main thread only)."""
        inter, union, target = out["iu"]
        inter_m[:] += inter
        union_m[:] += union
        target_m[:] += target
        if "dropped_cnt" in out:
            union_m[:] += out["dropped_cnt"]
            target_m[:] += out["dropped_cnt"]
        if "mask_all" in out:
            all_acc.update(out["mask_all"])
        if "mask_tp" in out:
            tp_acc.update(out["mask_tp"])
        if "mask_tf" in out:
            tf_acc.update(out["mask_tf"])
        if "match" in out:
            fn, m_ = out["match"]
            matches[fn] = m_
        per_scene.append(dict(record, host_eval_s=out["host_eval_s"],
                              proposals=out["proposals"]))

    # The loader prepares later scenes on its threads while the main thread
    # runs scene i's forward; the pool runs earlier scenes' host work
    # (scene_work is pure) over outputs already copied to the host.  The
    # results (scene index, scene_work output, record) merge in scene order
    # on the main thread once every scene is done.
    pw = max(1, min((os.cpu_count() or 1) - 1, 8))
    was_training = model.training
    t_loop = time.time()
    results, local_timing, error = [], {}, None
    try:
        with ThreadPoolExecutor(max_workers=pw) as pool:
            pending = []
            scenes = zip(range(rank, n_scenes, world),
                         dataset.val_loader(max_scenes=n_scenes, rank=rank, world=world))
            for i, batch in scenes:
                step, bk, new = buckets.get(batch.get("shapes", cfg.shapes))
                before = dict(window_kernels.LAUNCHES)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                ret = step(device_batch(batch, dev))
                fwd_s = time.perf_counter() - t0
                after = dict(window_kernels.LAUNCHES)
                peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
                if new:
                    local_timing.setdefault("bucket_compile_s", {})[bk] = round(fwd_s, 1)
                h = local_timing.setdefault("bucket_scene_counts", {})
                h[bk] = h.get(bk, 0) + 1
                over = {"vox": int(ret["overflow_vox"]), "grid": int(ret["overflow_grid"]),
                        "band": int(ret["overflow_band"])}
                over.update({k: int(v) for k, v in ret.get("overflow", {}).items()})
                record = dict(fn=batch["fn"], points=batch["num_points"],
                              voxels=batch["num_voxels"], bucket=bk, overflow=over,
                              launches={k: after[k] - before[k] for k in after},
                              collate_s=batch.get("collate_s"), forward_ms=fwd_s * 1e3,
                              peak_mem_gib=peak)
                while len(pending) >= pw:
                    j, f, r = pending.pop(0)
                    results.append((j, f.result(), r))
                pending.append((i, pool.submit(scene_work, i, batch, ret), record))
            for j, f, r in pending:
                results.append((j, f.result(), r))
    except Exception as e:
        if world == 1:
            raise
        error = e  # raised on every rank after the gather, so no rank waits alone
    finally:
        model.train(was_training)
    parts = [(results, local_timing, None if error is None else (type(error), str(error)))]
    if world > 1:
        gathered = [None] * world
        dist.all_gather_object(gathered, parts[0], group=group)
        if error is not None:
            raise error
        failed = next((g[2] for g in gathered if g[2] is not None), None)
        if failed:
            raise failed[0](failed[1])
        parts = gathered
    for _, out, record in sorted((r for p in parts for r in p[0]), key=lambda r: r[0]):
        merge_scene(out, record)
    if timing is not None:
        for _, t, _ in parts:
            for bk, v in t.get("bucket_compile_s", {}).items():
                c = timing.setdefault("bucket_compile_s", {})
                c[bk] = max(c.get(bk, 0.0), v)
            for bk, v in t.get("bucket_scene_counts", {}).items():
                h = timing.setdefault("bucket_scene_counts", {})
                h[bk] = h.get(bk, 0) + v
        wall = time.time() - t_loop
        n_done = len(per_scene)
        timing["wall_s"] = round(wall, 2)
        timing["scenes"] = n_done
        compile_s = sum(timing.get("bucket_compile_s", {}).values())
        timing["compile_s"] = round(compile_s, 1)
        if n_done:
            timing["scenes_per_sec"] = round(n_done / wall, 3)
            timing["scenes_per_sec_warm"] = round(n_done / max(wall - compile_s, 1e-9), 3)
        timing["per_scene"] = per_scene

    iou_class = inter_m / (union_m + 1e-10)
    acc_class = inter_m / (target_m + 1e-10)
    miou, macc = float(np.mean(iou_class)), float(np.mean(acc_class))
    allacc = float(inter_m.sum() / (target_m.sum() + 1e-10))
    if rank == 0:
        emit(f"mIoU/mAcc/allAcc {miou:.4f}/{macc:.4f}/{allacc:.4f}.")
    result = {"mIoU": miou, "mAcc": macc, "allAcc": allacc}
    if writer:
        writer.add_scalar("val/mIOU_eval", miou, epoch)
        writer.add_scalar("val/mAcc_eval", macc, epoch)
        writer.add_scalar("val/allACC_eval", allacc, epoch)
    if with_instances and matches:
        aps = eval_protocol.evaluate_matches(matches)
        avgs = eval_protocol.compute_averages(aps)
        if rank == 0:
            eval_protocol.print_results(avgs, logger)
        result.update(mAP=float(avgs["all_ap"]), AP50=float(avgs["all_ap_50%"]),
                      AP25=float(avgs["all_ap_25%"]))
        result.update(mask_all_acc=all_acc.avg, mask_tp_acc=tp_acc.avg,
                      mask_tf_acc=tf_acc.avg)
        if writer:
            writer.add_scalar("val/mAP", avgs["all_ap"], epoch)
            writer.add_scalar("val/AP_50", avgs["all_ap_50%"], epoch)
            writer.add_scalar("val/AP_25", avgs["all_ap_25%"], epoch)
            writer.add_scalar("val/All_mask_acc", all_acc.avg, epoch)
            writer.add_scalar("val/Tp_acc", tp_acc.avg, epoch)
            writer.add_scalar("val/Fp_acc", tf_acc.avg, epoch)
    return result


def restored_model(cfg: Config, logger, device=None):
    """(model on ``device`` with the newest checkpoint in ``cfg.logpath`` or
    ``cfg.pretrain`` loaded, the checkpoint's epoch + 1)."""
    model = build_model(cfg, resolve_device(device))
    state, start_epoch, ckfile = log_tools.checkpoint_restore(
        {"model": model}, cfg.logpath, cfg.pretrain, map_location=next(model.parameters()).device)
    if state and "model" in state:
        model.load_state_dict(state["model"])
    logger.info(f"Restore from {ckfile}" if ckfile else f"Start from epoch {start_epoch}")
    return model, start_epoch


def evaluate_pretrained(cfg: Config, max_scenes=None, timing: dict | None = None, device=None):
    """Standalone eval with the auto-resumed checkpoint (eval_map.py
    driver).  Runs on CUDA unless ``device`` says otherwise."""
    logger = log_tools.get_logger(cfg)
    model, start_epoch = restored_model(cfg, logger, device)
    return evaluate(cfg, model, Dataset(cfg), epoch=start_epoch, logger=logger,
                    max_scenes=max_scenes, test_mode=True, timing=timing)


def write_submission(result_dir: str, scene_name: str, pred_info: dict):
    """ScanNet benchmark submission writer (the reference ships it commented
    out, PBNet eval_map.py:142-155)."""
    os.makedirs(os.path.join(result_dir, "predicted_masks"), exist_ok=True)
    lines = []
    for pi in range(pred_info["mask"].shape[0]):
        mask_name = f"predicted_masks/{scene_name}_{pi:03d}.txt"
        lines.append(f"{mask_name} {int(pred_info['label_id'][pi])} "
                     f"{float(pred_info['conf'][pi]):.4f}")
        np.savetxt(os.path.join(result_dir, mask_name), pred_info["mask"][pi], fmt="%d")
    with open(os.path.join(result_dir, scene_name + ".txt"), "w") as f:
        f.write("\n".join(lines))


def predict_testset(cfg: Config, max_scenes=None, device=None) -> str:
    """Test-split inference -> benchmark submission files under
    result/epoch{..}/test of the working directory (the reference's
    result-dir naming, PBNet eval_map.py:28).  Runs on CUDA unless
    ``device`` says otherwise.  Returns the result directory."""
    logger = log_tools.get_logger(cfg)
    model, _ = restored_model(cfg, logger, device)
    dataset = Dataset(cfg)
    result_dir = os.path.join(
        "result",
        f"epoch{cfg.test_epoch}_nmst{cfg.TEST_NMS_THRESH}_scoret"
        f"{cfg.TEST_SCORE_THRESH}_npointt{cfg.TEST_NPOINT_THRESH}",
        "test",
    )
    buckets = _BucketModels(cfg, model)
    n_scenes = len(dataset.test_file_list)
    if max_scenes:
        n_scenes = min(n_scenes, max_scenes)
    for i in range(n_scenes):
        batch = dataset.test_batch(i)
        step, _, _ = buckets.get(batch.get("shapes", cfg.shapes))
        ret = step(device_batch(batch, buckets.device))
        pred_info = eval_scene_instances(ret, batch["num_points"], scene_superpoints(batch), cfg)
        if pred_info is None:
            logger.info(f"{batch['fn']}: no proposals")
            continue
        pred_info = scatter_cropped_masks(pred_info, batch)
        write_submission(result_dir, batch["fn"], pred_info)
        logger.info(f"{batch['fn']}: {pred_info['mask'].shape[0]} instances")
    return result_dir


def train(cfg: Config, dataset=None, max_epochs: int | None = None,
          max_iters: int | None = None, device=None, join_timeout_s: float | None = None):
    """Train with auto-resume; returns (model, optimizer).  Runs on CUDA
    unless ``device`` says otherwise.  ``dataset`` defaults to
    ``Dataset(cfg)``; any object with its training interface
    (``train_file_list``, ``train_epoch_ids(epoch, rank, world)``,
    ``train_loader(epoch, rank, world, picks=...)``) will do, and with
    ``cfg.validation`` its ``val_file_list`` and ``val_loader``.

    Data parallelism: this host runs ``cfg.num_devices`` ranks (0: every
    visible GPU; one on the CPU), ``cfg.nodes`` hosts in all, each starting
    its own.  With more than one rank in all, each local rank is a process
    of its own (``spawn``) on ``cuda:<local rank>`` over NCCL, or on the CPU
    over gloo; the call returns when every rank has, with rank 0's model
    and optimizer restored from the newest checkpoint onto the device of
    local rank 0.  ``join_timeout_s`` bounds the wait for the ranks.  When
    the dataset holds fewer scenes than one global step takes, a single
    host shrinks to as many ranks as it can feed, with a warning."""
    dev = resolve_device(device)
    dataset = dataset or Dataset(cfg)
    local = mesh.local_device_count(dev.type, cfg.num_devices)
    notes = []
    n_scenes = len(dataset.train_file_list)
    if cfg.nodes == 1 and n_scenes < local * cfg.batch_size:
        # fewer scenes than one global step consumes -> fewer ranks
        local = max(1, n_scenes // cfg.batch_size)
        notes.append(f"dataset has only {n_scenes} scenes — shrinking to {local} rank(s) so "
                     f"one step fits")
    if cfg.nodes * local == 1:
        return _train_rank(0, cfg, dataset, max_epochs, max_iters, dev, 1, notes)
    distributed.spawn(_train_rank, local,
                      (cfg, dataset, max_epochs, max_iters, dev, local, notes),
                      join_timeout_s)
    rank0 = mesh.rank_device(dev.type, 0)
    model = build_model(cfg, rank0)
    optimizer = make_optimizer(model, cfg)
    state, _, _ = log_tools.checkpoint_restore({"model": model, "optimizer": optimizer},
                                               cfg.logpath, map_location=rank0)
    if state:  # no checkpoint when no epoch yielded a batch
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
    return model, optimizer


def _train_rank(local_rank, cfg, dataset, max_epochs, max_iters, device, local_world, notes):
    """The training loop of one rank (the whole run when it is alone).
    Returns (model, optimizer)."""
    if cfg.nodes * local_world > 1:
        if device.type == "cpu":
            torch.set_num_threads(1)
        dev = mesh.rank_device(device.type, local_rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        distributed.initialize_from_config(cfg, local_rank, local_world,
                                           "nccl" if dev.type == "cuda" else "gloo")
        try:
            return _train_loop(cfg, dataset, max_epochs, max_iters, dev, local_rank,
                               local_world, notes)
        finally:
            distributed.shutdown()
    return _train_loop(cfg, dataset, max_epochs, max_iters, device, 0, 1, notes)


def _train_loop(cfg, dataset, max_epochs, max_iters, dev, local_rank, local_world, notes):
    group = mesh.data_group()
    rank = dist.get_rank() if group is not None else 0
    node_rank, nodes = distributed.local_data_rank() if group is not None else (0, 1)
    logger = log_tools.get_logger(cfg) if rank == 0 else log_tools.rank_logger(rank)
    logger.info(str(cfg))
    for note in notes:
        logger.warning(note)

    model = build_model(cfg, dev, group=group)
    optimizer = make_optimizer(model, cfg)
    world = cfg.nodes * local_world
    logger.info(f"device: {dev}; ranks: {world} ({local_world} on this host, rank {rank}); "
                f"#Model parameters: {sum(p.numel() for p in model.parameters())}")

    # a file without "model" or "optimizer" (a model-only file, say) leaves
    # the freshly built one in place, as the JAX package keeps its template
    state, start_epoch, ckfile = log_tools.checkpoint_restore(
        {"model": model, "optimizer": optimizer}, cfg.logpath, cfg.pretrain, map_location=dev)
    if state and "model" in state:
        model.load_state_dict(state["model"])
    if state and "optimizer" in state:
        optimizer.load_state_dict(state["optimizer"])
    logger.info(f"Restore from {ckfile}" if ckfile else f"Start from epoch {start_epoch}")

    writer = ScalarWriter(cfg.logpath) if rank == 0 else None
    prof = None
    try:
        steps = {}
        iter_time = metrics.AverageMeter()
        total_iters = 0
        end_epoch = min(cfg.epochs, max_epochs or cfg.epochs)
        for epoch in range(start_epoch, end_epoch + 1):
            with_instances = epoch > cfg.cluster_epoch
            if with_instances not in steps:
                steps[with_instances] = make_train_step(model, optimizer, cfg, with_instances,
                                                        group)
            step_fn = steps[with_instances]
            lr = cosine_lr_after_step(cfg.lr, epoch, cfg.step_epoch, cfg.epochs)

            # this host's batches; local rank r takes batch t * local_world + r
            n_host = len(dataset.train_epoch_ids(epoch, node_rank, nodes))
            picks = mesh.rank_batches(list(range(n_host)), local_rank, local_world)
            nsteps = len(picks)
            am = {}
            t_epoch = time.time()
            it = 0
            for batch in dataset.train_loader(epoch, node_rank, nodes, picks=picks):
                t0 = time.time()
                if cfg.profile_steps and total_iters == 2 and rank == 0:
                    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                                  + ([torch.profiler.ProfilerActivity.CUDA]
                                                     if dev.type == "cuda" else []))
                    prof.start()
                aux = step_fn(device_batch(batch, dev), lr)
                aux = {k: float(telemetry.host_read(v)) for k, v in aux.items()}
                dt = time.time() - t0
                iter_time.update(dt)
                it += 1
                total_iters += 1
                if prof is not None and total_iters == 2 + cfg.profile_steps:
                    _stop_profile(prof, cfg)
                    prof = None
                for k, v in aux.items():
                    am.setdefault(k, metrics.AverageMeter()).update(v)
                eta = ((nsteps - it) + nsteps * (end_epoch - epoch)) * iter_time.avg
                if rank == 0:
                    sys.stdout.write(
                        f"epoch: {epoch}/{cfg.epochs} iter: {it}/{nsteps} "
                        f"loss: {aux['loss']:.4f}({am['loss'].avg:.4f}) "
                        f"iter_time: {dt:.2f}({iter_time.avg:.2f}) "
                        f"remain_time: {int(eta // 3600):02d}:{int(eta % 3600 // 60):02d}:"
                        f"{int(eta % 60):02d}\n")
                if max_iters and total_iters >= max_iters:
                    break
            left = n_host % local_world
            if left and it == nsteps and rank == 0:
                logger.warning(f"epoch: {epoch}/{cfg.epochs}: dropped {left} leftover batch(es) "
                               f"(< {local_world} local ranks; drop-last across the ranks)")
            if not am:
                logger.warning(f"epoch: {epoch}/{cfg.epochs}: the loader yielded no batch")
                continue
            logger.info(f"epoch: {epoch}/{cfg.epochs}, train loss: {am['loss'].avg:.4f}, "
                        f"time: {time.time() - t_epoch:.1f}s")
            over = {k: v.avg for k, v in am.items() if k.startswith("overflow") and v.avg > 0}
            if over:
                logger.warning(f"capacity overflow detected (work was dropped; raise "
                               f"StaticShapes caps): {over}")
            if rank == 0:
                for k, v in am.items():
                    writer.add_scalar(k + "_train", v.avg, epoch)
                writer.add_scalar("train/learning_rate", lr, epoch)
                ck = log_tools.checkpoint_save(
                    {"model": model.state_dict(), "optimizer": optimizer.state_dict()},
                    cfg.logpath, epoch, cfg.save_freq)
                logger.info(f"Saving {ck}")
            if group is not None:
                dist.barrier()  # no rank reads a checkpoint rank 0 is still writing

            if cfg.validation and (epoch % 4 == 0 or epoch == cfg.epochs):
                try:
                    evaluate(cfg, model, dataset, epoch, logger, writer, group=group)
                except FileNotFoundError as e:
                    logger.info(f"validation skipped: {e}")
            if max_iters and total_iters >= max_iters:
                break
    finally:
        if prof is not None:
            _stop_profile(prof, cfg)
        if writer is not None:
            writer.close()
    return model, optimizer


def _stop_profile(prof, cfg):
    """Stop a train-step profile and write its trace under
    ``cfg.logpath/profile``."""
    prof.stop()
    out = os.path.join(cfg.logpath, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json"))
