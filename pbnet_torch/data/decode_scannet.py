"""Offline ScanNet v2 decoding -> the npy data contract (port of
pbnet_tpu/data/decode_scannet.py).

Reproduces PBNet datasets/scannetv2/decode_scannet.py: for each
scene, reads ``*_vh_clean_2.ply`` (+ ``.labels.ply``, ``.0.010000.segs.json``,
``.aggregation.json``), computes area-weighted vertex normals and
Felzenszwalb superpoints, remaps NYU40 labels to the 20-class set, extracts
instance ids from aggregation groups, and writes
``<scene>_{xyz,rgb,sem_label,ins_label,nl,face,sup}.npy`` — byte-compatible
with the reference's loaders.

Also provides ``write_val_gt`` (PBNet datasets/scannetv2/get_val_gt.py:15-38)
and ``split_scans`` (split_data.py), plus a /dev/shm npy cache equivalent to
the SharedArray one (its own directory, ``/dev/shm/pbnet_torch``).
"""

from __future__ import annotations

import glob
import json
import multiprocessing as mp
import os
import shutil

import numpy as np

from ..native import segmentator
from ..ops.normals import vertex_normals_np
from .ply import read_ply

# NYU40 ids of the 20 evaluated classes, in semantic-index order
# (PBNet datasets/scannetv2/decode_scannet.py:28)
VALID_NYU40 = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]

REMAPPER = np.full(150, -100.0)
for i, x in enumerate(VALID_NYU40):
    REMAPPER[x] = i

LABEL_NAMES = [
    "unannotated", "wall", "floor", "chair", "table", "desk", "bed",
    "bookshelf", "sofa", "sink", "bathtub", "toilet", "curtain", "counter",
    "door", "window", "shower curtain", "refridgerator", "picture", "cabinet",
    "otherfurniture",
]


def raw_to_scannetv2_map(label_map_file: str) -> dict:
    """raw label -> nyu40 class name, 'unannotated' when outside the 20-class
    set (PBNet datasets/scannetv2/decode_scannet.py:34-52)."""
    with open(label_map_file) as f:
        lines = [ln.rstrip("\n") for ln in f][1:]
    valid = set(LABEL_NAMES)
    out = {}
    for ln in lines:
        el = ln.split("\t")
        raw_name, nyu40_name = el[1], el[7]
        out[raw_name] = nyu40_name if nyu40_name in valid else "unannotated"
    return out


def read_mesh(path: str):
    """xyz (centered), rgb in [-1,1], faces (F,3)."""
    ply = read_ply(path)
    vert = ply["vertex"]
    xyz = np.stack([vert["x"], vert["y"], vert["z"]], 1).astype(np.float32)
    rgb = np.stack([vert["red"], vert["green"], vert["blue"]], 1).astype(np.float32)
    xyz = xyz - xyz.mean(0)
    rgb = rgb / 127.5 - 1.0
    faces = np.asarray(ply["face"]["vertex_indices"], np.int64)
    return xyz, rgb, faces


def decode_scene(ply_path: str, out_dir: str, raw2scannet: dict | None,
                 with_labels: bool = True) -> str:
    scan_name = os.path.basename(ply_path)[:12]
    prefix = os.path.join(out_dir, scan_name)
    xyz, rgb, faces = read_mesh(ply_path)
    nl = vertex_normals_np(xyz, faces)
    sup = segmentator.segment_mesh(xyz, faces)

    np.save(prefix + "_xyz.npy", xyz)
    np.save(prefix + "_rgb.npy", rgb)
    np.save(prefix + "_nl.npy", nl)
    np.save(prefix + "_face.npy", faces)
    np.save(prefix + "_sup.npy", sup)
    if not with_labels:
        return scan_name

    labels_ply = read_ply(ply_path[:-4] + ".labels.ply")
    sem = REMAPPER[np.asarray(labels_ply["vertex"]["label"])]

    base = ply_path[: -len("_vh_clean_2.ply")]
    with open(base + "_vh_clean_2.0.010000.segs.json") as f:
        seg = json.load(f)["segIndices"]
    segid_to_points: dict = {}
    for i, s in enumerate(seg):
        segid_to_points.setdefault(s, []).append(i)

    with open(base + ".aggregation.json") as f:
        groups = json.load(f)["segGroups"]
    instance_segids, labels = [], []
    for g in groups:
        name = raw2scannet[g["label"]] if raw2scannet else g["label"]
        if name not in ("wall", "floor"):
            instance_segids.append(g["segments"])
            labels.append(g["label"])
    # scene0217_00 ships its aggregation twice
    # (PBNet datasets/scannetv2/decode_scannet.py:179-180)
    if (
        scan_name == "scene0217_00"
        and instance_segids
        and instance_segids[0] == instance_segids[len(instance_segids) // 2]
    ):
        instance_segids = instance_segids[: len(instance_segids) // 2]
    flat = [s for group in instance_segids for s in group]
    if len(np.unique(flat)) != len(flat):
        raise ValueError(f"{scan_name}: overlapping instance segments")

    ins = np.full(sem.shape[0], -100.0)
    for i, segids in enumerate(instance_segids):
        pointids = []
        for s in segids:
            pointids += segid_to_points[s]
        ins[pointids] = i
        if len(np.unique(sem[pointids])) != 1:
            raise ValueError(f"{scan_name}: instance {i} spans semantic classes")

    np.save(prefix + "_sem_label.npy", sem)
    np.save(prefix + "_ins_label.npy", ins)
    return scan_name


def decode_split(scannet_dir: str, split: str, out_dir: str,
                 label_map_file: str | None = None, workers: int = 0):
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(glob.glob(os.path.join(scannet_dir, split, "*_vh_clean_2.ply")))
    with_labels = split != "test"
    raw2 = raw_to_scannetv2_map(label_map_file) if label_map_file else None
    args = [(f, out_dir, raw2, with_labels) for f in files]
    if workers and workers > 1:
        with mp.get_context("spawn").Pool(workers) as pool:
            pool.starmap(decode_scene, args)
    else:
        for a in args:
            decode_scene(*a)
    return files


def write_val_gt(npy_dir: str, val_list, gt_dir: str):
    """Encoded GT ids ``sem_nyu40*1000 + inst + 1`` per vertex
    (PBNet datasets/scannetv2/get_val_gt.py:15-38)."""
    os.makedirs(gt_dir, exist_ok=True)
    label_ids = np.array([0] + VALID_NYU40)  # sem -100 -> 0
    for fn in val_list:
        sem = np.load(os.path.join(npy_dir, fn + "_sem_label.npy")).astype(np.int64)
        ins = np.load(os.path.join(npy_dir, fn + "_ins_label.npy")).astype(np.int64)
        sem_nyu = label_ids[np.where(sem < 0, -1, sem) + 1]
        gt = np.where(
            (ins == -100) | (sem < 0), 0, sem_nyu * 1000 + ins + 1
        )
        np.savetxt(os.path.join(gt_dir, fn + ".txt"), gt, fmt="%d")


def split_scans(scans_dir: str, list_file: str, dst_dir: str):
    """Copy raw scans into a split directory per the official split lists
    (PBNet datasets/scannetv2/split_data.py)."""
    os.makedirs(dst_dir, exist_ok=True)
    names = np.loadtxt(list_file, dtype=str).tolist()
    for name in names:
        src = os.path.join(scans_dir, name)
        for f in glob.glob(os.path.join(src, "*")):
            shutil.copy(f, dst_dir)


# ---------------- /dev/shm cache (SharedArray replacement) ----------------

SHM_DIR = "/dev/shm/pbnet_torch"
_SUFFIXES_TRAIN = ("xyz", "rgb", "sem_label", "ins_label", "nl")
_SUFFIXES_VAL = _SUFFIXES_TRAIN + ("sup",)
_SUFFIXES_TEST = ("xyz", "rgb", "sup", "nl")


def create_shm(names, npy_dir: str, split: str = "train"):
    sfx = {"train": _SUFFIXES_TRAIN, "val": _SUFFIXES_VAL, "test": _SUFFIXES_TEST}[split]
    os.makedirs(SHM_DIR, exist_ok=True)
    for fn in names:
        for s in sfx:
            dst = os.path.join(SHM_DIR, f"{fn}_{s}.npy")
            if not os.path.exists(dst):
                shutil.copy(os.path.join(npy_dir, f"{fn}_{s}.npy"), dst)


def shm_load(fn: str, suffix: str, npy_dir: str, cache: bool):
    if cache:
        p = os.path.join(SHM_DIR, f"{fn}_{suffix}.npy")
        if os.path.exists(p):
            return np.load(p, mmap_mode="r")
    return np.load(os.path.join(npy_dir, f"{fn}_{suffix}.npy"))


def main(argv=None):
    """CLI mirroring the reference decode entrypoint
    (PBNet datasets/scannetv2/decode_scannet.py:268-285):
    decode train/val/test splits to npy, build the /dev/shm cache and the
    val-GT files."""
    import argparse

    ap = argparse.ArgumentParser(description="ScanNet v2 offline decoding")
    ap.add_argument("--scannet_dir", default="datasets/scannetv2")
    ap.add_argument("--out_dir", default=None, help="default <scannet_dir>/npy")
    ap.add_argument("--label_map", default=None,
                    help="scannetv2-labels.combined.tsv (omit to use raw names)")
    ap.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    ap.add_argument("--workers", type=int, default=os.cpu_count())
    ap.add_argument("--shm", action="store_true", help="populate /dev/shm cache")
    ap.add_argument("--val_gt", action="store_true", help="write val_gt txts")
    args = ap.parse_args(argv)

    out = args.out_dir or os.path.join(args.scannet_dir, "npy")
    for split in args.splits:
        files = decode_split(args.scannet_dir, split, out,
                             label_map_file=args.label_map,
                             workers=args.workers)
        print(f"{split}: decoded {len(files)} scenes -> {out}")
        names = [os.path.basename(f)[:12] for f in files]
        if args.shm and names:
            create_shm(names, out, split if split != "train" else "train")
    if args.val_gt:
        val_list = np.loadtxt(
            os.path.join(args.scannet_dir, "scannetv2_val.txt"), dtype=str,
            ndmin=1,
        ).tolist()
        write_val_gt(out, val_list, os.path.join(args.scannet_dir, "val_gt"))
        print(f"val_gt written for {len(val_list)} scenes")


if __name__ == "__main__":
    main()
