"""ScanNet dataset + loaders producing padded, static-shape batches (port of
pbnet_tpu/data/dataset.py).

Same construction semantics as PBNet datasets/scannetv2/
dataset_preprocess.py (trainMerge :197-306, valMerge :308-385): augment ->
scene mixup -> crop -> 2 cm quantization with cross-scene voxel offsets ->
instance info — but the collate PADS everything to the capacities in
config.StaticShapes, so the model's static capacities hold every batch
and its overflow counters stay comparable row for row with the JAX
package's.

Loader model: deterministic per-epoch shuffling with per-host sharding
(replaces torch DistributedSampler, :48-71) and a background thread prefetch
pool (replaces DataLoader worker processes — numpy/scipy release the GIL for
the heavy parts).  Unlike the JAX package's loaders, which submit every
batch of an epoch at once, the pool keeps at most ``workers + 1`` batches in
flight (``prefetch``); the batches and their order are the same.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import os
import time
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from ..config import Config
from ..core.quantize import sparse_quantize_np
from . import augment
from .decode_scannet import shm_load


def batch_seed(manual_seed: int, epoch: int, i: int) -> int:
    """Collision-free per-(seed, epoch, iter) RNG seed for one train batch.

    The former ``seed*1000 + epoch*7 + i`` collided across epochs (epoch+1
    replayed epoch's streams shifted by 7 iters), repeating augmentation
    streams.  With i < 100_003 (ScanNet epochs are ~1200 batches) the
    (epoch, i) map below is injective for a fixed seed.
    """
    return (manual_seed * 1_000_003 + epoch * 100_003 + i) % (2**32)


def prefetch(fn: Callable, args: Iterable[tuple], workers: int) -> Iterator:
    """``fn(*a)`` for each ``a`` of ``args``, in order.  With ``workers > 1``
    a thread pool computes ahead, holding at most ``workers + 1`` calls in
    flight (submitted and not yet yielded); an abandoned iteration cancels
    the calls not yet started."""
    if workers <= 1:
        for a in args:
            yield fn(*a)
        return
    with cf.ThreadPoolExecutor(workers) as ex:
        pending = collections.deque()
        try:
            for a in args:
                pending.append(ex.submit(fn, *a))
                if len(pending) > workers:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()


class Dataset:
    def __init__(self, cfg: Config, npy_dir: Optional[str] = None):
        self.cfg = cfg
        self.voxel_size = cfg.voxel_size
        self.scale_size = cfg.scale_size
        self.full_scale = [128 * cfg.scale_size / 50.0, 512 * cfg.scale_size / 50.0]
        self.npy_dir = npy_dir or os.path.join(cfg.data_root, "npy")
        self.mixup = cfg.mixup

        root = cfg.data_root
        self.train_file_list = self._load_list(os.path.join(root, "scannetv2_train.txt"))
        self.val_file_list = self._load_list(os.path.join(root, "scannetv2_val.txt"))
        self.test_file_list = self._load_list(os.path.join(root, "scannetv2_test.txt"))

    @staticmethod
    def _load_list(path):
        if not os.path.isfile(path):
            return []
        lst = np.loadtxt(path, dtype=str, ndmin=1).tolist()
        lst.sort()
        return lst

    # ---------------- scene IO ----------------

    def _load_scene(self, fn, with_labels=True, with_sup=False):
        c = self.cfg.cache
        out = {
            "xyz": np.asarray(shm_load(fn, "xyz", self.npy_dir, c), np.float64),
            "rgb": np.asarray(shm_load(fn, "rgb", self.npy_dir, c), np.float64),
            "nl": np.asarray(shm_load(fn, "nl", self.npy_dir, c), np.float64),
        }
        if with_labels:
            out["sem"] = np.asarray(shm_load(fn, "sem_label", self.npy_dir, c))
            out["ins"] = np.asarray(shm_load(fn, "ins_label", self.npy_dir, c))
        if with_sup:
            out["sup"] = np.asarray(shm_load(fn, "sup", self.npy_dir, c))
        return out

    # ---------------- batch builders ----------------

    def train_batch(self, ids, rng: np.random.RandomState):
        """Build one training batch (trainMerge semantics + padding)."""
        scenes = []
        for i, idx in enumerate(ids):
            fn = self.train_file_list[idx]
            s = self._load_scene(fn)
            xyz = s["xyz"] - s["xyz"].min(0)
            xyz, rgb, nl = augment.data_augment(
                xyz, s["rgb"], s["nl"], i, rng, jitter=True, flip=True, rot=True,
                scale=True, elastic_dist=True,
            )
            sem, ins = s["sem"].copy(), s["ins"].copy()

            if self.mixup:  # (:233-250)
                mix_fn = self.train_file_list[
                    int(np.floor(rng.rand() * len(self.train_file_list)))
                ]
                m = self._load_scene(mix_fn)
                mxyz, mrgb, mnl = augment.data_augment(
                    m["xyz"] - m["xyz"].min(0), m["rgb"], m["nl"], i, rng,
                    jitter=True, flip=True, rot=True, scale=True, elastic_dist=True,
                )
                mins = m["ins"].copy()
                mins[mins != -100] += ins.max() + 1
                xyz = np.concatenate([xyz, mxyz])
                rgb = np.concatenate([rgb, mrgb])
                nl = np.concatenate([nl, mnl])
                sem = np.concatenate([sem, m["sem"]])
                ins = np.concatenate([ins, mins])

            # crop with retries (:253-265)
            for _ in range(5):
                xyz_crop, valid = augment.crop(
                    xyz, self.cfg.max_crop_p, self.full_scale[1],
                    self.scale_size, rng,
                )
                if valid.sum() >= self.cfg.min_crop_p:
                    xyz = xyz_crop
                    break
            xyz = xyz - xyz.min(0)
            xyz = xyz[valid]
            rgb, nl, sem = rgb[valid], nl[valid], sem[valid]
            ins = augment.compact_instance_labels(ins, valid)
            scenes.append((fn, xyz, rgb, nl, sem, ins))
        return self._collate(scenes)

    def _fit_eval_scene(self, s, with_labels=True):
        """Oversize fallback: if the 3 TTA copies of a scene would exceed the
        largest eval bucket, spatially crop the BASE scene (identical subset
        for every copy keeps the TTA fold index-aligned).  Returns keep index
        (or None) and the original point count; the engine scatters
        predictions back and counts dropped points against the metrics."""
        n = s["xyz"].shape[0]
        p_max = self.cfg.eval_buckets()[-1].point_cap
        if 3 * n <= p_max:
            return s, None, n
        xyz0 = s["xyz"] - s["xyz"].min(0)
        _, valid = augment.crop(
            xyz0, p_max // 3, self.full_scale[1], self.scale_size,
            np.random.RandomState(0),
        )
        keep = np.where(valid)[0]
        if keep.size == 0:
            # degenerate crop (tiny/pathological geometry): deterministic
            # uniform subsample instead
            keep = np.sort(
                np.random.RandomState(0).choice(n, p_max // 3, replace=False)
            )
            valid = np.zeros(n, bool)
            valid[keep] = True
        out = {k: v[keep] for k, v in s.items()}
        if with_labels:
            out["ins"] = augment.compact_instance_labels(s["ins"], valid)
        return out, keep, n

    def val_batch(self, idx):
        """One validation scene as 3 TTA rotated copies (valMerge :324).
        ``collate_s`` holds the seconds it took to load, augment and
        collate."""
        t0 = time.perf_counter()
        fn = self.val_file_list[idx]
        s = self._load_scene(fn, with_sup=True)
        sem_full = s["sem"]
        s, keep, orig_n = self._fit_eval_scene(s)
        dropped_sem = None
        if keep is not None:
            drop_mask = np.ones(orig_n, bool)
            drop_mask[keep] = False
            dropped_sem = np.asarray(sem_full)[drop_mask]
        # val path draws only the rgb jitter; deterministic per scene by
        # default (reproducible eval), or the reference's global-stream
        # behavior under cfg.val_jitter_global (dataset_preprocess.py:107)
        rng = np.random if self.cfg.val_jitter_global else np.random.RandomState(0)
        scenes = []
        for i in range(3):
            xyz, rgb, nl = augment.data_augment(
                s["xyz"].copy(), s["rgb"].copy(), s["nl"], i, rng,
            )
            ins = augment.compact_instance_labels(s["ins"].copy())
            scenes.append((fn, xyz, rgb, nl, s["sem"].copy(), ins))
        batch = self._collate(scenes, buckets=self.cfg.eval_buckets())
        batch["sup"] = s["sup"]
        batch["fn"] = fn
        batch["keep_idx"] = keep
        batch["orig_num_points"] = orig_n
        batch["dropped_sem"] = dropped_sem
        batch["collate_s"] = time.perf_counter() - t0
        return batch

    def _collate(self, scenes, buckets=None):
        """Quantize + concatenate + pad to StaticShapes.

        With ``buckets`` (ascending list of StaticShapes), pads to the
        smallest bucket that fits and records it as ``batch["shapes"]`` —
        small scenes then run in a small bucket instead of paying the
        worst-case latency (SURVEY §5 scene-size buckets)."""
        sh = self.cfg.shapes
        xs, feats_v, coords_v, sems, inss, infos, pointnum = [], [], [], [], [], [], []
        pbatch = []
        total_inst = 0
        for bi, (fn, xyz, rgb, nl, sem, ins) in enumerate(scenes):
            feats = np.concatenate([rgb, nl], 1).astype(np.float32)
            vox, index, inverse = sparse_quantize_np(xyz, self.voxel_size)
            coords_v.append(
                np.concatenate(
                    [np.full((vox.shape[0], 1), bi, np.int32), vox], 1
                )
            )
            feats_v.append(feats[index])
            xs.append(xyz.astype(np.float32))
            pbatch.append(np.full(xyz.shape[0], bi, np.int32))
            sems.append(sem.astype(np.int32))
            n_inst, info, pn = augment.instance_info(
                xyz.astype(np.float32), ins.astype(np.int32)
            )
            ins = ins.copy()
            ins[ins != -100] += total_inst
            total_inst += n_inst
            inss.append(ins.astype(np.int32))
            infos.append(info)
            pointnum.extend(pn)

        coords = np.concatenate(coords_v)
        vfeats = np.concatenate(feats_v)
        xyz_all = np.concatenate(xs)
        n_pts, n_vox = xyz_all.shape[0], coords.shape[0]

        if buckets:
            # spatial fit: bucket extents shrink with the scale factor
            # (StaticShapes.scaled), so the scene's voxel bbox must fit the
            # bucket's grid extent too — a too-small extent would overflow
            # the lookup grid and drop kernel-map entries
            vmax = coords[:, 1:].max(0) + 1 if n_vox else np.zeros(3, np.int64)
            for b in buckets:
                ext_ok = b.grid_extent is None or all(
                    int(vmax[i]) <= b.grid_extent[1 + i] for i in range(3)
                )
                if (n_pts <= b.point_cap and n_vox <= b.voxel_caps[0]
                        and total_inst <= b.instance_cap and ext_ok):
                    sh = b
                    break
            else:
                sh = buckets[-1]
        P, V, I = sh.point_cap, sh.voxel_caps[0], sh.instance_cap
        if n_pts > P or n_vox > V or total_inst > I:
            raise ValueError(
                f"batch exceeds static caps: pts {n_pts}/{P}, vox {n_vox}/{V}, "
                f"inst {total_inst}/{I}"
            )

        def pad(a, cap, fill):
            out = np.full((cap,) + a.shape[1:], fill, a.dtype)
            out[: a.shape[0]] = a
            return out

        batch = {
            "vox_coords": pad(coords, V, 0),
            "vox_feats": pad(vfeats.astype(np.float32), V, 0),
            "vox_valid": np.arange(V) < n_vox,
            "xyz": pad(xyz_all, P, 0),
            "point_batch": pad(np.concatenate(pbatch), P, 0),
            "point_valid": np.arange(P) < n_pts,
            "sem_label": pad(np.concatenate(sems), P, -100),
            "ins_label": pad(np.concatenate(inss), P, -100),
            "inst_info": pad(np.concatenate(infos), P, -100.0),
            "instance_pointnum": pad(np.asarray(pointnum, np.int32), I, 0),
            "num_points": n_pts,
            "num_voxels": n_vox,
            "num_instances": total_inst,
        }
        if buckets:
            batch["shapes"] = sh
        return batch

    # ---------------- epoch iterators ----------------

    def train_epoch_ids(self, epoch: int, rank: int = 0, world: int = 1):
        """Deterministic per-epoch shuffle + per-host shard (replaces
        DistributedSampler.set_epoch, PBNet train.py:381)."""
        g = np.random.RandomState(self.cfg.manual_seed + epoch)
        order = g.permutation(len(self.train_file_list))
        order = order[rank::world]
        bs = self.cfg.batch_size
        nb = len(order) // bs  # drop_last=True (:54)
        return [order[i * bs : (i + 1) * bs] for i in range(nb)]

    def train_loader(self, epoch: int, rank: int = 0, world: int = 1,
                     num_workers: Optional[int] = None,
                     picks: Optional[Sequence[int]] = None) -> Iterator[dict]:
        """The host's batches of ``train_epoch_ids(epoch, rank, world)``, or
        those at the indices ``picks`` of that list (one data-parallel
        rank's share, ``parallel/mesh.rank_batches``); batch ``i`` draws
        its augmentation from ``batch_seed(manual_seed, epoch, i)``."""
        batches = self.train_epoch_ids(epoch, rank, world)
        workers = self.cfg.num_works if num_workers is None else num_workers
        picks = range(len(batches)) if picks is None else picks

        def batch_rng(i):
            return np.random.RandomState(
                batch_seed(self.cfg.manual_seed, epoch, i)
            )

        yield from prefetch(
            self.train_batch, ((batches[i], batch_rng(i)) for i in picks), workers,
        )

    def val_loader(self, num_workers: Optional[int] = None,
                   max_scenes: Optional[int] = None, rank: int = 0,
                   world: int = 1) -> Iterator[dict]:
        """Val scenes ``rank, rank + world, ...`` of the first ``max_scenes``."""
        n = len(self.val_file_list)
        if max_scenes is not None:
            n = min(n, max_scenes)
        workers = self.cfg.num_works if num_workers is None else num_workers
        yield from prefetch(self.val_batch, ((i,) for i in range(rank, n, world)), workers)

    # ---------------- test split (benchmark submission) ----------------

    def test_batch(self, idx):
        """One test scene as 3 TTA rotated copies, no labels (the reference's
        testLoader references a testMerge that was never written —
        PBNet datasets/scannetv2/dataset_preprocess.py:68; this is the
        working equivalent using the valMerge TTA flow)."""
        t0 = time.perf_counter()
        fn = self.test_file_list[idx]
        s = self._load_scene(fn, with_labels=False, with_sup=True)
        s, keep, orig_n = self._fit_eval_scene(s, with_labels=False)
        rng = np.random if self.cfg.val_jitter_global else np.random.RandomState(0)
        scenes = []
        for i in range(3):
            xyz, rgb, nl = augment.data_augment(
                s["xyz"].copy(), s["rgb"].copy(), s["nl"], i, rng,
            )
            n = xyz.shape[0]
            sem = np.full(n, -100, np.int64)
            ins = np.full(n, -100, np.int64)
            scenes.append((fn, xyz, rgb, nl, sem, ins))
        batch = self._collate(scenes, buckets=self.cfg.eval_buckets())
        batch["sup"] = s["sup"]
        batch["fn"] = fn
        batch["keep_idx"] = keep
        batch["orig_num_points"] = orig_n
        batch["collate_s"] = time.perf_counter() - t0
        return batch

    def test_loader(self):
        for i in range(len(self.test_file_list)):
            yield self.test_batch(i)
