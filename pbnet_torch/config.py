"""Static capacities and run configuration of the PyTorch port.

A copy of ``pbnet_tpu/config.py:18-203`` (``StaticShapes`` and ``Config``):
the port keeps the same capacities, padding and overflow counters at every
module boundary, so its outputs line up row for row with the JAX package's.
The port builds no dense lookup grids; ``grid_extent`` only selects the same
stage-2/3 topology branch the JAX package takes (``models/pbnet.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class StaticShapes:
    """Static capacities that fix every XLA-compiled shape.

    The reference runs fully dynamic shapes; on TPU we bucket-and-pad.  The
    crop cap (max_crop_p=300k, PBNet config/config.py:29) bounds the
    training worst case; eval scenes are padded per-bucket.
    """

    # points per device batch (train: batch_size scenes incl. mixup, cropped)
    point_cap: int = 400_000
    # stride-1..16 voxel caps; ratios measured on surface scans at 2 cm:
    # s2 ~ 42% of s1, s4 ~ 26% of s2, s8 ~ 24% of s4, s16 ~ 22% of s8
    voxel_caps: Tuple[int, ...] = (160_000, 72_000, 20_000, 5_500, 1_600)
    # clustering
    cluster_cap: int = 384  # max clusters (proposals) per batch
    # local-scene (stage 2) flat point budget and voxel cap
    local_point_cap: int = 600_000
    local_voxel_caps: Tuple[int, ...] = (300_000, 130_000, 36_000, 10_000, 3_000)
    # stage-3 (ScoreNet) point/voxel caps
    score_voxel_caps: Tuple[int, ...] = (160_000, 72_000, 20_000, 5_500, 1_600)
    # max GT instances per batch (score loss IoU matrix)
    instance_cap: int = 192
    # banded neighbor window for clustering (columns per row chunk)
    cluster_band: int = 4096
    # cap on foreground (clusterable, sem>=2 + class-gated) points: the
    # clustering work is compacted to this many rows before the banded
    # passes (None = point_cap, no compaction).  Overflow is counted.
    fg_point_cap: Optional[int] = None
    # cap on rows routed to the exact 1-NN fallback (None = npad//32)
    nn_exact_cap: Optional[int] = None
    # dense-grid lookup extent for the backbone topology (B, X, Y, Z) in
    # stride-1 voxel units; None falls back to binary search
    grid_extent: Optional[Tuple[int, int, int, int]] = (4, 512, 512, 256)
    # banded one-hot MXU convs (nn/onehot_conv.py): output-tile rows and the
    # per-level k=3 band spans (0 = keep the gather path at that level; down/
    # up maps derive 2x spans).  Spans bound the input-rank spread of one
    # tile's kernel-map entries — sized ~1.5x the worst spread measured on
    # real scenes; overruns are counted (plan_overflow), never silent.
    onehot_tm: int = 256
    onehot_spans: Optional[Tuple[int, ...]] = None
    # same, for the derived local-scene topology (D_Unet/ScoreNet); local
    # voxels sort by (proposal, key), so bands stay contiguous across pid
    # seams — spans measured separately from the main topology's
    onehot_spans_local: Optional[Tuple[int, ...]] = None

    def scaled(self, f: float) -> "StaticShapes":
        """A size bucket: every point/voxel capacity scaled by ``f`` (rounded
        up to TPU-friendly multiples), cluster/instance capacities unchanged.
        Small validation scenes run in a small bucket so they do not pay
        worst-case latency (SURVEY §5: static-shape scene buckets vs the
        reference's fully dynamic shapes,
        PBNet datasets/scannetv2/dataset_preprocess.py:308-385).

        The grid extent's X/Y dims scale by ``sqrt(f)`` (point count tracks
        scan surface ~ floor area) while Z stays fixed (rooms keep their
        height no matter how small the scan): smaller scenes get
        proportionally smaller dense-grid tables, which gather faster.
        Collation only picks a bucket whose extent the scene's voxel
        bounding box FITS (see Dataset._collate), so a shrunken extent
        never drops voxels."""
        if f == 1.0:
            return self

        def r(x, q):
            return max(q, -int(-x * f // q) * q)

        ext = self.grid_extent
        if ext is not None:
            s = f ** 0.5
            ext = (ext[0],) + tuple(
                max(64, -int(-d * s // 32) * 32) for d in ext[1:3]
            ) + (ext[3],)
        return dataclasses.replace(
            self,
            point_cap=r(self.point_cap, 4096),
            voxel_caps=tuple(r(v, 512) for v in self.voxel_caps),
            local_point_cap=r(self.local_point_cap, 4096),
            local_voxel_caps=tuple(r(v, 512) for v in self.local_voxel_caps),
            score_voxel_caps=tuple(r(v, 512) for v in self.score_voxel_caps),
            fg_point_cap=(
                r(self.fg_point_cap, 4096) if self.fg_point_cap else None
            ),
            grid_extent=ext,
        )


@dataclass
class Config:
    # ---- task / schedule (config.py:14-22) ----
    task: str = "train"
    manual_seed: int = 22
    epochs: int = 520
    num_works: int = 4
    pretrain: str = ""
    save_freq: int = 4
    logpath: str = "./log/config_1/"
    cache: bool = False
    validation: bool = True

    # ---- dataset (config.py:25-32) ----
    dataset: str = "Scannet"
    data_root: str = "datasets/scannetv2"
    voxel_size: float = 0.02
    scale_size: float = 1.0
    sem_num: int = 20
    max_crop_p: int = 300_000
    min_crop_p: int = 50_000
    batch_size: int = 4
    batch_size_v: int = 1
    mixup: bool = True  # scene-mixup augmentation (the reference hardcodes it)

    # ---- optimizer (config.py:35-40) ----
    lr: float = 0.001
    optimizer: str = "Adam"
    step_epoch: int = 50
    multiplier: float = 0.5
    momentum: float = 0.9
    weight_decay: float = 0.0001

    # ---- model architecture (PBNet network/PBNet.py:89-92; the
    # reference hardcodes 34C/14A/34C but ships the full MinkUNet factory) ----
    backbone_arch: str = "MinkUNet34C"
    dunet_arch: str = "MinkUNet14A"
    score_arch: str = "MinkUNet34C"

    # ---- clustering (config.py:43-46) ----
    cluster_epoch: int = 128
    min_pts: int = 31
    radius: float = 0.04
    method: int = 0

    # ---- score net (config.py:48-50) ----
    fg_thresh: float = 0.95
    bg_thresh: float = 0.20
    fg_score: float = -1.0

    # ---- test (config.py:53-56) ----
    TEST_NMS_THRESH: float = 0.10
    TEST_SCORE_THRESH: float = 0.07
    TEST_NPOINT_THRESH: int = 101
    test_epoch: int = 392
    # val/test rgb jitter source: False (default) = deterministic per-scene
    # RandomState(0), so eval metrics are reproducible run to run; True =
    # the reference's behavior of drawing from the global numpy stream
    # (PBNet datasets/scannetv2/dataset_preprocess.py:107 via
    # valMerge), for checkpoint-parity evaluation under the exact published
    # conditions.  See ARCHITECTURE.md "Known gaps".
    val_jitter_global: bool = False

    # ---- distributed (config.py:59-64); TPU: devices on a 1-D data mesh ----
    local_rank: int = 0
    node_rank: int = 0  # this host's process id (reference -nr/--node_rank)
    nodes: int = 1  # number of hosts (reference --nodes)
    coordinator: str = ""  # host:port of process 0 (replaces the reference's
    # hard-coded tcp://127.0.0.1:<tcp_port> NCCL rendezvous, train.py:323)
    tcp_port: int = 16677
    sync_bn: bool = True
    num_devices: int = 0  # 0 = all visible devices
    # capture a jax.profiler trace of train iterations [2, 2+profile_steps)
    # under logpath/profile (0 = off)
    profile_steps: int = 0

    # ---- module freezing (reference fix_module map,
    # PBNet network/PBNet.py:91-101) ----
    fix_module: Tuple[str, ...] = ()

    # ---- TPU static shapes ----
    shapes: StaticShapes = field(default_factory=StaticShapes)
    # eval-time scene-size buckets, as scale factors of `shapes`; each
    # val/test scene runs in the smallest bucket it fits (one XLA compile
    # per bucket, amortized by the persistent compile cache)
    eval_bucket_scales: Tuple[float, ...] = (0.4, 0.7, 1.0)

    # derived
    dist: bool = False
    world_size: int = 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def eval_buckets(self) -> Tuple[StaticShapes, ...]:
        """Ascending size buckets for eval collation (largest == `shapes`)."""
        return tuple(
            self.shapes.scaled(f) for f in sorted(set(self.eval_bucket_scales))
        )
