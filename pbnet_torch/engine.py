"""The training loop on one device (port of ``pbnet_tpu/engine.py`` ``train``).

The reference's schedule: backbone-only steps through ``cfg.cluster_epoch``,
the full three-stage pipeline after it; the cosine learning rate per epoch;
per-iteration console meters with an ETA; a warning when any overflow
counter is non-zero; per-epoch scalars in ``logpath/scalars.jsonl``; a
checkpoint every epoch and auto-resume from the newest one.

Validation, the evaluation entry points and data parallelism come with later
slices; the data modules too, so ``train`` takes the dataset as an argument
(an object with the JAX package's ``Dataset`` training interface:
``train_file_list``, ``train_epoch_ids(epoch)`` and ``train_loader(epoch)``,
e.g. ``synthetic.SyntheticDataset``).
"""

from __future__ import annotations

import json
import os
import sys
import time

from . import resolve_device
from .config import Config
from .models.pbnet import PBNet, batch_to_device
from .parallel.train_step import cosine_lr_after_step, make_optimizer, make_train_step
from .tools import log as log_tools
from .tools import metrics


class ScalarWriter:
    """Scalar logging: one JSON object per line in ``scalars.jsonl``."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.f = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self.f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


def build_model(cfg: Config, device=None) -> PBNet:
    return PBNet(shapes=cfg.shapes, sem_num=cfg.sem_num, voxel_size=cfg.voxel_size,
                 scale_size=cfg.scale_size, radius=cfg.radius, min_pts=cfg.min_pts,
                 backbone_arch=cfg.backbone_arch, dunet_arch=cfg.dunet_arch,
                 score_arch=cfg.score_arch, seed=cfg.manual_seed, device=device)


def device_batch(batch: dict, device) -> dict:
    """The arrays a step reads, as tensors on ``device``."""
    drop = {"num_points", "num_voxels", "num_instances", "fn", "sup", "shapes",
            "keep_idx", "orig_num_points", "dropped_sem"}
    return batch_to_device({k: v for k, v in batch.items()
                            if k not in drop and v is not None}, device)


def train(cfg: Config, dataset, max_epochs: int | None = None,
          max_iters: int | None = None, device=None):
    """Train with auto-resume; returns (model, optimizer).  Runs on CUDA
    unless ``device`` says otherwise."""
    if cfg.validation:
        raise NotImplementedError("validation during training comes with the evaluation "
                                  "slice (engine.evaluate); set cfg.validation=False")
    if cfg.num_devices > 1:
        raise NotImplementedError("data-parallel training (DDP + SyncBatchNorm) comes with "
                                  "a later slice; set cfg.num_devices to 0 or 1")
    if cfg.profile_steps:
        raise NotImplementedError("cfg.profile_steps is not ported; profile with "
                                  "torch.profiler around the step")
    dev = resolve_device(device)
    logger = log_tools.get_logger(cfg)
    logger.info(str(cfg))

    model = build_model(cfg, dev)
    optimizer = make_optimizer(model, cfg)
    logger.info(f"device: {dev}; #Model parameters: "
                f"{sum(p.numel() for p in model.parameters())}")

    state, start_epoch, ckfile = log_tools.checkpoint_restore(cfg.logpath, cfg.pretrain,
                                                              map_location=dev)
    if state is not None:
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
    logger.info(f"Restore from {ckfile}" if ckfile else f"Start from epoch {start_epoch}")

    writer = ScalarWriter(cfg.logpath)
    try:
        steps = {}
        iter_time = metrics.AverageMeter()
        total_iters = 0
        end_epoch = min(cfg.epochs, max_epochs or cfg.epochs)
        for epoch in range(start_epoch, end_epoch + 1):
            with_instances = epoch > cfg.cluster_epoch
            if with_instances not in steps:
                steps[with_instances] = make_train_step(model, optimizer, cfg, with_instances)
            step_fn = steps[with_instances]
            lr = cosine_lr_after_step(cfg.lr, epoch, cfg.step_epoch, cfg.epochs)

            nsteps = len(dataset.train_epoch_ids(epoch))
            am = {}
            t_epoch = time.time()
            it = 0
            for batch in dataset.train_loader(epoch):
                t0 = time.time()
                aux = step_fn(device_batch(batch, dev), lr)
                aux = {k: float(v) for k, v in aux.items()}
                dt = time.time() - t0
                iter_time.update(dt)
                it += 1
                total_iters += 1
                for k, v in aux.items():
                    am.setdefault(k, metrics.AverageMeter()).update(v)
                eta = ((nsteps - it) + nsteps * (end_epoch - epoch)) * iter_time.avg
                sys.stdout.write(
                    f"epoch: {epoch}/{cfg.epochs} iter: {it}/{nsteps} "
                    f"loss: {aux['loss']:.4f}({am['loss'].avg:.4f}) "
                    f"iter_time: {dt:.2f}({iter_time.avg:.2f}) "
                    f"remain_time: {int(eta // 3600):02d}:{int(eta % 3600 // 60):02d}:"
                    f"{int(eta % 60):02d}\n")
                if max_iters and total_iters >= max_iters:
                    break
            if not am:
                logger.warning(f"epoch: {epoch}/{cfg.epochs}: the loader yielded no batch")
                continue
            logger.info(f"epoch: {epoch}/{cfg.epochs}, train loss: {am['loss'].avg:.4f}, "
                        f"time: {time.time() - t_epoch:.1f}s")
            over = {k: v.avg for k, v in am.items() if k.startswith("overflow") and v.avg > 0}
            if over:
                logger.warning(f"capacity overflow detected (work was dropped; raise "
                               f"StaticShapes caps): {over}")
            for k, v in am.items():
                writer.add_scalar(k + "_train", v.avg, epoch)
            writer.add_scalar("train/learning_rate", lr, epoch)
            ck = log_tools.checkpoint_save(
                {"model": model.state_dict(), "optimizer": optimizer.state_dict()},
                cfg.logpath, epoch, cfg.save_freq)
            logger.info(f"Saving {ck}")
            if max_iters and total_iters >= max_iters:
                break
    finally:
        writer.close()
    return model, optimizer
