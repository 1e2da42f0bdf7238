"""Eval-loop throughput of the port (the counterpart of the JAX package's
``eval_throughput.py``, which stays that package's)::

    python -m pbnet_torch.eval_throughput [--device cuda|cpu]

``engine.evaluate`` over a fabricated val set of 20 scenes of mixed size
(``SCENE_MIX``: 12k, 25k and 45k points, the bench scene's geometry at
room sizes that follow the point count) in the dataset's npy layout, with
size buckets: what a user of the evaluation pays per scene, host data
preparation, the overlapped loop and the host metric work included.  The
weights are fresh, from ``cfg.manual_seed``.  Three passes over the same
scenes:

1. first-dispatch: each bucket's model is built and its first forward
   timed (``bucket_compile_s``); in a fresh process the CUDA kernels build
   at first use inside it;
2. warm: the same again;
3. single-bucket: every scene padded to the largest bucket
   (``eval_bucket_scales=(1.0,)``), what the buckets save on small scenes.

Each pass gets one ``eval-pass {json}`` line on stderr (scenes, scenes per
bucket, wall seconds, scenes/s).  The last stdout line holds the keys of
the JAX package's script plus the card (``device``, ``power_limit``).  A
CPU run (``--device cpu``) reports no rate: its scenes/s are null.  Without
a card and without ``--device cpu`` the script raises.  The fabricated
scenes live in a temporary directory removed on every exit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import engine, resolve_device
from .bench import card_line
from .config import Config, StaticShapes
from .data.dataset import Dataset
from .data.decode_scannet import write_val_gt
from .synthetic import make_scene

# (count, points per scene): small scenes land in the 0.4 bucket after the
# x3 TTA fold, large ones in the 1.0 bucket
SCENE_MIX = ((8, 12_000), (7, 25_000), (5, 45_000))

# the JAX script's caps (eval_throughput.py:103-116), measured on this
# synthetic mix; the grid extent covers 3 TTA-rotated 4.5 m scenes
SHAPES = StaticShapes(
    point_cap=147_456,
    voxel_caps=(122_880, 90_112, 53_248, 20_480, 4_608),
    cluster_cap=128,
    local_point_cap=61_440,
    local_voxel_caps=(45_056, 22_528, 9_216, 4_608, 2_048),
    score_voxel_caps=(45_056, 22_528, 9_216, 4_608, 2_048),
    instance_cap=128,
    cluster_band=4_096,
    fg_point_cap=61_440,
    nn_exact_cap=1_024,
    grid_extent=(3, 384, 384, 160),
)


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


def fabricate_val_set(root):
    """Write ``SCENE_MIX`` scenes in the dataset's npy layout, the split
    lists and ``val_gt`` under ``root``; returns the scene names."""
    npy = os.path.join(root, "npy")
    os.makedirs(npy, exist_ok=True)
    rng = np.random.RandomState(0)
    names = []
    for count, n_pts in SCENE_MIX:
        for _ in range(count):
            nm = f"scene{len(names):04d}_00"
            # floor area tracks point count (real small scans are spatially
            # small); bucket choice checks the spatial extent too, so only
            # genuinely small rooms ride the 0.4x bucket
            room = 4.5 * (n_pts / 45_000.0) ** 0.5
            xyz, sem, ins, _ = make_scene(rng, n_pts=n_pts, room=room)
            n = xyz.shape[0]
            # colours keyed to class, normals up: only sizes matter here
            rgb = (sem[:, None] / 20.0 - 0.5) + rng.randn(n, 3) * 0.05
            nl = np.tile([0.0, 0.0, 1.0], (n, 1))
            # superpoints: background in ~50-point blocks, objects one each
            sup = np.where(ins >= 0, ins + n // 50 + 1, np.arange(n) // 50)
            pre = os.path.join(npy, nm)
            np.save(pre + "_xyz.npy", xyz.astype(np.float64))
            np.save(pre + "_rgb.npy", rgb.astype(np.float64))
            np.save(pre + "_nl.npy", nl.astype(np.float64))
            np.save(pre + "_sem_label.npy", sem.astype(np.float64))
            np.save(pre + "_ins_label.npy", ins.astype(np.float64))
            np.save(pre + "_sup.npy", sup.astype(np.int64))
            names.append(nm)
    for split in ("train", "val", "test"):
        np.savetxt(os.path.join(root, f"scannetv2_{split}.txt"), names, fmt="%s")
    write_val_gt(npy, names, os.path.join(root, "val_gt"))
    return names


def eval_config(root) -> Config:
    """The JAX script's Config over the val set under ``root``: two buckets
    (0.4 and 1.0), instances on, test mode."""
    return Config(task="test", data_root=root, batch_size=1, num_works=0, cache=False,
                  shapes=SHAPES, cluster_epoch=-1, validation=False,
                  logpath=os.path.join(root, "log"), eval_bucket_scales=(0.4, 1.0))


def measure(cfg: Config, model) -> dict:
    """The three passes of ``engine.evaluate`` over ``cfg``'s val set with
    ``model``; returns the JSON line's fields."""
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"

    def run(tag, c, dset):
        timing = {}
        t0 = time.time()
        engine.evaluate(c, model, dset, epoch=0, test_mode=True, timing=timing)
        row = {"pass": tag, "scenes": timing["scenes"],
               "bucket_scene_counts": timing["bucket_scene_counts"],
               "bucket_compile_s": timing["bucket_compile_s"],
               "wall_s": time.time() - t0,
               "scenes_per_sec": timing["scenes_per_sec"] if cuda else None}
        log(f"eval-pass {json.dumps(row)}")
        return row

    ds = Dataset(cfg)
    first = run("first-dispatch", cfg, ds)
    warm = run("warm", cfg, ds)
    # bucket tagging happens in Dataset's collate from its own cfg, so the
    # single-bucket pass brings its own Dataset
    cfg1 = cfg.replace(eval_bucket_scales=(1.0,))
    single = run("single-bucket", cfg1, Dataset(cfg1))
    return {
        "metric": "eval_loop_scenes_per_sec",
        "scenes": len(ds.val_file_list),
        "first_dispatch_scenes_per_sec": first["scenes_per_sec"],
        "first_dispatch_compile_s": first["bucket_compile_s"],
        "warm_scenes_per_sec": warm["scenes_per_sec"],
        "single_bucket_scenes_per_sec": single["scenes_per_sec"],
        "bucket_scene_counts": warm["bucket_scene_counts"],
        "single_bucket_scene_counts": single["bucket_scene_counts"],
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "power_limit": card_line().rsplit(",", 1)[1].strip() if cuda else None,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pbnet_torch.eval_throughput",
                                description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' for the plain path)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="evaltp_") as root:
        names = fabricate_val_set(root)
        log(f"[eval-throughput] fabricated {len(names)} scenes under {root}")
        cfg = eval_config(root)
        result = measure(cfg, engine.build_model(cfg, dev))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
