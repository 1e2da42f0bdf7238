"""Logging and checkpoint auto-resume (port of pbnet_tpu/tools/log.py).

* a timestamped log file under ``logpath/{train|result}/`` plus the console;
* ``checkpoint_save``: one file per epoch named ``%09d.ckpt`` (``torch.save``
  of a mapping of state dicts), written to a temporary name and renamed, so
  a crash leaves no torn file; the previous epoch's file is pruned unless
  ``epoch % save_freq == 0``;
* ``checkpoint_restore``: an explicit file or the newest ``*.ckpt``, epoch
  parsed from the file name.  It reads the port's files (``torch.load`` with
  ``weights_only``) and the JAX package's (a pickle of flax msgpack bytes,
  read by ``flax_checkpoint`` and converted by ``convert``).
"""

from __future__ import annotations

import glob
import logging
import os
import sys
import time
import zipfile

import torch

from .. import convert
from . import flax_checkpoint


def create_logger(log_file: str) -> logging.Logger:
    logger = logging.getLogger("pbnet_torch")
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s  %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.propagate = False
    return logger


def get_logger(cfg) -> logging.Logger:
    sub = "train" if cfg.task == "train" else "result"
    log_dir = os.path.join(cfg.logpath, sub)
    os.makedirs(log_dir, exist_ok=True)
    log_file = os.path.join(log_dir, time.strftime("%Y%m%d_%H%M%S", time.localtime()) + ".log")
    return create_logger(log_file)


def checkpoint_save(state: dict, logpath: str, epoch: int, save_freq: int = 16) -> str:
    """state: e.g. {'model': model.state_dict(), 'optimizer':
    optimizer.state_dict()} (the model's state dict holds its parameters and
    BN running statistics)."""
    os.makedirs(logpath, exist_ok=True)
    fname = os.path.join(logpath, f"{epoch:09d}.ckpt")
    torch.save(state, fname + ".tmp")
    os.replace(fname + ".tmp", fname)
    prev = epoch - 1
    if prev % save_freq != 0:
        prev_f = os.path.join(logpath, f"{prev:09d}.ckpt")
        if os.path.isfile(prev_f):
            os.remove(prev_f)
    return fname


def _from_jax(trees: dict, template: dict) -> dict:
    """The port's state for a JAX-package checkpoint's trees: ``model`` from
    ``params`` and ``batch_stats``, ``optimizer`` from ``opt_state`` (which
    needs the template's model and optimizer)."""
    state = {}
    if "model" in template and "params" in trees:
        state["model"] = convert.state_dict_from_jax(
            {k: trees[k] for k in ("params", "batch_stats") if k in trees})
    if "optimizer" in template and "opt_state" in trees:
        state["optimizer"] = convert.optimizer_state_from_optax(
            trees["opt_state"], template["model"], template["optimizer"])
    return state


def checkpoint_restore(template: dict, logpath: str, pretrain_file: str = "",
                       map_location=None):
    """(state or None, start_epoch, restored_file): start_epoch is the
    checkpoint's epoch + 1, or 1 when there is none (epochs count from 1).

    ``template`` maps ``"model"`` to the model and, where one is restored,
    ``"optimizer"`` to its optimizer.  ``state`` holds the state dicts of
    those keys the file has; a key it lacks is left out, so the caller keeps
    what it built (the JAX package takes it from its template).  A torch
    file loads tensors and plain containers only (``weights_only``); any
    other file must be a JAX-package checkpoint."""
    fname = pretrain_file
    if not fname:
        cands = sorted(glob.glob(os.path.join(logpath, "*.ckpt")))
        fname = cands[-1] if cands else ""
    if not fname or not os.path.isfile(fname):
        return None, 1, ""
    if zipfile.is_zipfile(fname):  # torch.save's format
        saved = torch.load(fname, map_location=map_location, weights_only=True)
        state = {k: v for k, v in saved.items() if k in template}
    else:
        state = _from_jax(flax_checkpoint.read_checkpoint(fname), template)
    try:
        epoch = int(os.path.basename(fname).split(".")[0])
    except ValueError:
        epoch = 0
    return state, epoch + 1, fname
