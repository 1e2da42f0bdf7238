#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pbnet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its progress; any failed check raises and the script
exits non-zero — no phase catches its own failure):

1. build     nvcc-compile csrc/window_kernels.cu and csrc/onehot_conv.cu for
             sm_90a (with ``--baseline``, the baseline's window kernels
             too), one nvcc per source, all started together; print
             ptxas's report; read B1's, B2's and B4's hot loops from the
             SASS (cuobjdump): instructions per pair test (B1, B4) and per
             bit and row (B2).
2. kernels   one warm-up forward of the bench scene records the arguments
             of each clustering kernel's first call; at those bench shapes
             each kernel must equal its plain PyTorch version exactly (bits,
             density, labels, columns; the 1-NN d2 bit for bit), and both
             are timed (kernel: median of 20 launches by CUDA events; plain:
             median of 3 calls) beside the kernel's bound (see ``bound``).
             B4 (one launch over both windows, needy rows only) at three
             shapes: the main path's arguments, the noisy content's below
             (needy rows where trained offsets put them) and the main path's
             with every row needy; at each, exact against its plain version
             and timed beside the bound, with the needy rows and chunks
             counted; with ``--baseline``, also equal on needy rows to the
             design before the rebuild (its kernel on each window and
             clustering's former merge), timed the same way.  B1's line
             adds the pairs the bound counts, those of the full grid and
             those the kernel tests.  B2 runs
             again in every propagation round of binary_cluster on the bench
             scene's foreground points with 4 cm of noise on the offsets
             (more rounds, as trained offsets make): each round exact, and
             timed (reported, not gated); that call's B4 arguments are the
             noisy shape above.  match_pick (B5, on no path) runs on the
             border kernel's arguments with its ``best`` output as target:
             it must equal its plain version exactly and the border kernel's
             ``root``.  A warm-up forward in the banded configuration
             records the banded conv's (B6) arguments at every distinct
             (topology, map kind, level, Cin, Cout) it launches; at each the
             kernel must agree with its plain version within 1e-4 of the
             plain output's largest magnitude (the same bf16 operands, f32
             sums in another order), a second launch must repeat the first
             bit for bit, and kernel, plain version and the port's gather
             conv on the same map and weights (``library_ms``) are timed;
             each shape's line gives the kernel/gather-conv ratio and the
             launch's block count, and a last line counts the shapes where
             the kernel is slower (a number, not a gate).  Edge cases at
             small tiles are in tests/test_torch_cuda.py.
3. cluster   binary_cluster on the card and on the CPU (plain path) from the
             same reduced bench scene (30k points, oracle semantics; oracle
             offsets and offsets with 4 cm noise): every ClusterResult field
             equal, centers within 1e-4 m.
4. reference the full three-stage forward at full width on the tiny
             two-instance scene, on the card and on the CPU with the same
             weights and f32 conv operands: cluster/scene/proposal ids
             equal, scores within 1e-3.
5. main      the full PBNet (MinkUNet34C / 14A / 34C, 32 channels, seeded
             random weights) on the bench scene (140k points, ~92k voxels),
             stage 2 driven by the bench's oracle semantics/offsets, in two
             configurations with the same weights: gather (BENCH_SHAPES) and
             banded (BANDED_SHAPES, the banded conv on).  3 requests each,
             in turns gather, banded, banded, gather, gather, banded.
             Launch counters are zeroed just before each request and read
             just after: every kernel of the path must have run (the banded
             conv on the banded path only), B4 once per clustering call (as
             often as B1); clusters > 0, proposals > 0,
             zero overflow (overflow_band and conv_band included), finite
             outputs; the banded path's cluster and scene ids equal the
             gather path's and its scores lie within ``SCORE_ATOL``.
6. eval      the ScanNet AP chain (eval_scene_instances ->
             assign_instances_for_scan -> evaluate_matches ->
             compute_averages) on one gather and one banded output against
             the bench scene's GT ids: every AP finite and in [0, 1].
7. trace     2 more requests of each configuration under torch.profiler:
             wall and device-busy ms per request, the device's idle share,
             device time by kernel family and the top kernels by device
             time.
8. train-reference
             one full-phase train step (stage 2 driven by the oracle, as in
             ``oracle_train_forward``) at full width on two copies of the
             tiny scene (4 instances), on the card and on the CPU with the
             same weights, f32 conv operands and SGD: cluster ids equal,
             every loss term within rtol 1e-4, every BN running statistic
             within 1e-3 of its tensor's largest magnitude; gradients and
             SGD updates within ``REF_TENSOR_TOL`` of each tensor's scale
             and ``REF_MODEL_TOL`` in relative L2 over the model (why: at
             ``REF_TENSOR_TOL``), with the share within 1e-3 printed.  Then
             the conv backward alone at the bench shapes (a k3, a down and
             an up map of the bench topology): the card's transposed-map
             backward against the CPU's plain autograd, dx and dW within
             1e-3 of their largest magnitude, f32 and bf16 operands.
9. train-main
             training steps on the bench scene at full width, Adam at lr
             1e-3, seeded weights: the backbone phase through
             ``make_train_step`` (what epochs up to ``cluster_epoch`` run)
             and the full phase oracle-driven through
             ``train_step.apply_gradients``; 1 warm-up and 5 timed steps
             each, in turns.  Gates: finite losses; in the full phase
             clusters > 0, proposals > 0, every overflow counter 0, mask,
             dice and score losses > 0 and each of B1-B4 launched within
             every step, B4 once per clustering call; a finite non-zero
             gradient norm in every module
             the phase trains (all three UNets and every head in the full
             phase); parameters changed; a later loss below the first.  No
             banded conv runs under grad.  Median ms/step (CUDA-synchronised
             wall time) and peak device memory per phase.
10. train-engine
             ``engine.train`` with no device argument (CUDA by default) on
             the tiny synthetic dataset for 2 iterations: a checkpoint and
             ``scalars.jsonl``; a second call resumes at the next epoch.
11. train trace
             one profiled step of each training phase: device-busy ms, the
             idle share and device time by family, with the backward's
             gathers and GEMMs as families of their own.
12. data-eval
             from ScanNet files on disk to the AP report, at the default
             Config (point cap 400,000 in buckets of 0.4, 0.7 and 1.0; the
             MinkUNet34C / 14A / 34C trio): three val scenes and one test
             scene written by ``synthetic.write_scannet_scene`` (``DATA_VAL``:
             one in the 0.4 bucket, one in the 1.0 bucket, one over the
             largest that the oversize crop cuts) and decoded by the port's
             ``decode_scannet`` (segmentator included); a checkpoint of
             seeded weights with ``synthetic.color_oracle`` set, saved by the
             port's ``checkpoint_save``; ``engine.evaluate_pretrained`` on
             CUDA with the launch counters zeroed just before and read just
             after, then ``predict_testset``.  Per scene: points, voxels,
             bucket, overflow counters, B1-B4 launches, decode s, collate s,
             forward ms, peak memory and host-eval s.  Gates: zero overflow;
             each of B1-B4 launched on every scene (B4 once per clustering
             call), B5 and B6 on none; at
             least two buckets and one cropped scene; a proposal scored;
             every metric finite in [0, 1]; a submission file for the test
             scene.  B1-B4 then equal their plain versions exactly at the
             last scene's arguments (timed beside their bound).  Last, the
             tiny config ``TINY_EVAL`` evaluates the same files on the card
             and on the CPU: mIoU, mAcc, allAcc and the per-scene proposal
             counts equal, every other key within 1e-6.
13. parity    the port's checkpoint-parity harness
             (``python -m pbnet_torch.tools.parity_eval``) on the card: one
             [data-eval] val scene (``DATA_VAL[0]``) written in ScanNet's
             layout, seeded weights of the full-width test config with
             ``synthetic.color_oracle`` set, written as a reference-format
             ``.pth`` by ``convert_checkpoint.write_reference_pth``; ``main`` with
             ``--scans`` decodes, writes val_gt, converts, evaluates and
             prints its table.  Gates: no converted tensor unmatched, every
             converted tensor equal to its source, the metrics finite in
             [0, 1], zero overflow, B1-B4 launched (B4 once per clustering
             call), B5 and B6 not; the phase's seconds.
14. ddp       data parallelism.  (a) NCCL at world size 1: one full-phase
             train step at full width on the bench scene (f32 conv
             operands) through the distributed step (SyncBN and the
             gradient average over the group) against the plain step from
             the same weights and batch,
             under phase 8's gates (``hold_step``; the gradient and
             parameter norms held as the gradients are, ``REF_MODEL_TOL``:
             at full width in bf16 the two steps' gradient norms were
             1.9e-4 apart in relative terms).
             (b) Two gloo ranks on
             the one card (NCCL refuses two ranks on one device) at full
             width: rank 0 the bench scene, rank 1 its flipped and rotated
             copy (``augment``, seed 1; caps 1.25x: rotated, the scene takes
             14% more voxels at stride 4); Adam, 1 warm-up and ``DDP_STEPS`` timed steps of
             the full phase.  Gates: parameters and BN statistics
             bit-identical across the ranks after every step, each of
             B1-B4 launched in every step of each rank (B4 once per
             clustering call), zero overflow,
             finite losses; median ms/step and peak memory per rank (both
             ranks share the card).  (c) The tiny two-rank step (phase 8's
             scene, rank r seeded r) on the card against the same two ranks
             on the CPU, under phase 8's gates.
15. bottleneck
             PBNet with the MinkUNet50 backbone (D_Unet 14A, ScoreNet 34C) on
             the bench scene, gather and banded, 2 requests each in turns:
             [main]'s gates (every kernel of the path launched, zero
             overflow, banded ids equal to gather ids, scores within
             ``SCORE_ATOL``).  B6 at every shape it launches (new ones
             marked) against its plain version within ``B6_RTOL``, timed
             beside ``b6_bound`` and the gather conv.  Card == CPU on the
             tiny scene as in phase 4.
16. resnet    ResNet50 and ResFieldNet14 on two small rooms (5 mm voxels): an
             eval forward and a train forward and backward, card against
             CPU, f32 conv operands: logits within 1e-3 of their largest
             magnitude; gradients under phase 8's gates (the head's
             instance norm over a few voxels per room amplifies rounding:
             at 1 cm ResNet50's gradients moved by 1.2e-2 in relative L2).
17. bench     the port's benchmark entry point as a user runs it,
             ``python -m pbnet_torch.bench --config gather`` and ``--config
             banded``, each in a process of its own (phases, timing and
             output: ``pbnet_torch/bench.py``).  Gates: the headline (the
             last stdout line) finite and > 0; in each of the 10 timed
             requests (one stderr line each, the subprocess's own launch
             counters zeroed before it) clusters > 0, zero overflow, B1-B4
             launched, B4 once per clustering call, B6 in the banded run
             only, B5 never; 0 < mfu <= 1 and 0 < mfu_f32 <= 1; the executed
             GEMM operations over the GEMM family's device time within the
             f32 peak (a count the card could not have done is a counting
             fault); the production extent's ids equal the headline's; the
             useful count of stages 1 and 2 equal in both runs (the same
             maps), and of stage 3 too where both kept the same points.
             Headline, stage split, device busy and idle share, mfu,
             train-step ms and peak memory per run; the phase's seconds.
18. eval-throughput
             ``python -m pbnet_torch.eval_throughput`` in a process of its
             own: the last stdout line holds the JAX script's keys and the
             card, every rate finite and > 0; every pass evaluates all 20
             scenes, the warm pass in two buckets and the single-bucket
             pass in one; its seconds.
``python3 chip_smoke.py --only <phase>`` (data-eval, parity, ddp,
bottleneck, resnet, bench, eval-throughput) runs the build and that phase
alone and prints no result lines.
``python3 chip_smoke.py --baseline DIR [...]``: DIR holds a checkout from
before B4's rebuild (commit 8062b0f, e.g. unpacked by ``git archive``);
phase 2 builds its csrc/window_kernels.cu and times its B4 design (one
launch per window and the merge) beside the one-launch kernel at the three
shapes.
``--only ddp-cards``, on a machine with several cards (not in the default
run): every card one NCCL rank through (b)'s full-width step and gates,
then ``engine.train`` over the same ranks with a resume.

TF32 is switched off for matmuls and cuDNN: the port's f32 GEMMs run in full
f32, so the CPU comparisons hold at the stated tolerances.

The card line comes third from last; the kernels JSON, second from last,
lists the counterparts of all six TPU kernels.  ``launches`` counts the
kernel's launches over the main phase's requests of the path it serves
(B1-B4: gather, B6: banded; ``launches_by_path`` has both); B5 is on no
path.  B6's ``ms``,
``plain_ms``, ``bound_ms`` and ``library_ms`` are per banded request: each
shape's time times its launches in one request, summed (``shapes`` lists
them).  ``launches_by_path["train"]`` counts B1-B4 over the 5 timed
full-phase train steps, ``launches_by_path["data-eval"]`` over the
data-eval phase's evaluate run (three scenes), whose own kernel check is
under ``data_eval``; ``["parity"]`` over the parity harness's run (one
scene); ``["ddp"]`` counts B1-B4 on rank 0 over the timed
two-rank steps, ``["bottleneck"]`` every kernel over the bottleneck
phase's four requests, ``["bench-gather"]`` and ``["bench-banded"]``
every kernel over the [bench] runs' 10 timed requests each; B6's
``shapes`` adds the bottleneck path's rows
(``"path": "bottleneck"``, ``"new"`` where the main path has no such
shape).  B4's row adds ``shapes`` (its three shapes: kernel, plain and
bound ms, ``baseline_ms`` or null, needy rows and chunks, pairs),
``empty_launch_ms`` and ``sass``.  The last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA device, or outside a checkout of the
repository, the script fails and prints no result.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# the clustering kernels (B1-B4), captured from the gather path
KERNELS = ("neighbor_pack", "masked_window_reduce", "masked_window_border", "window_1nn")
ALL_KERNELS = KERNELS + ("masked_window_match_pick", "onehot_conv")
TPU_KERNEL = {
    "neighbor_pack": "pbnet_tpu/ops/pallas_kernels.py:151",
    "masked_window_reduce": "pbnet_tpu/ops/pallas_kernels.py:77",
    "masked_window_border": "pbnet_tpu/ops/pallas_kernels.py:326",
    "window_1nn": "pbnet_tpu/ops/pallas_kernels.py:247",
    "masked_window_match_pick": "pbnet_tpu/ops/pallas_kernels.py:383",
    "onehot_conv": "pbnet_tpu/nn/onehot_conv.py:204",
}
SOURCE = {k: "pbnet_torch/csrc/window_kernels.cu" for k in ALL_KERNELS}
SOURCE["onehot_conv"] = "pbnet_torch/csrc/onehot_conv.cu"
PATHS = ("gather", "banded")
# the path each kernel serves (its ``launches``); B5 serves none
SERVES = {k: "gather" for k in KERNELS}
SERVES.update(masked_window_match_pick=None, onehot_conv="banded")
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit).  Its 67
# TFLOP/s in f32 counts an FMA as two operations; the kernels are built with
# -fmad=false, so every f32 add, multiply or compare is one instruction, and
# the SMs issue lane instructions of all types at 67e12 / 2 per second.
# Hopper has half as many INT32 lanes as FP32 lanes per SM.
HBM_BYTES_PER_S = 3.35e12
ISSUE_PER_S = 67e12 / 2
I32_PER_S = 67e12 / 4
BF16_FLOPS_PER_S = 989e12  # dense tensor-core rate
# (f32, int32) operations of one pair test (B1, B4): 3 sub, 3 mul, 2 add and
# the d2 compare; two integer compares or selects, one predicate and, one
# bit set or select
PAIR_OPS = (9, 4)
# int32 operations per set neighbor bit: find it, clear it, form its column,
# then min/max (B2) or the (first-orig, label) max (B3)
SET_BIT_OPS = {"masked_window_reduce": 4, "masked_window_border": 6,
               "masked_window_match_pick": 5}
# rows per block of the B1 kernel (NP_ROWS in csrc/window_kernels.cu)
B1_BLOCK_ROWS = 64
# B6 against its plain version: the same bf16-rounded operands multiplied in
# f32, only the order of the f32 sums differs
B6_RTOL = 1e-4
# banded vs gather path on the bench scene: every conv's f32 sums differ in
# their last bits between the two, which flips the bf16 rounding of some
# inputs of the next conv (2**-9 relative each); through three UNets that
# moves the sigmoid scores by up to this much
SCORE_ATOL = 5e-2
N_REQUESTS = 3
TRACE_REQUESTS = 2
TRAIN_STEPS = 5  # timed steps per training phase, after one warm-up
# Train reference at full width: the gradient of a 34-layer step moves by up
# to 10% of a tensor's largest magnitude (and 2-4e-3 in relative L2 over
# the model) when only the order of the f32 sums changes (the CPU step with
# 1 or 3 threads against 8; 21% under 1e-7 relative noise on the input), as
# ReLU and threshold decisions flip; so each tensor is held to half its
# scale (a wrong backward errs by about its whole scale) and the model's
# gradient to 2e-2 in relative L2.  The
# backward's arithmetic is held to 1e-3 per tensor on single convs at the
# bench shapes (``conv_backward_check``).
REF_TENSOR_TOL = 0.5
REF_MODEL_TOL = 2e-2
# [ddp]: timed steps of the two-rank bench run, after one warm-up
DDP_STEPS = 3
# [bottleneck]: PBNet with the bottleneck backbone
BOTTLENECK_ARCHS = dict(backbone_arch="MinkUNet50", dunet_arch="MinkUNet14A",
                        score_arch="MinkUNet34C")
# [bench] and [eval-throughput]: the entry points run as subprocesses, each
# within this many seconds
ENTRY_TIMEOUT_S = 900
# [eval-throughput]: the scenes of pbnet_torch.eval_throughput's val set
EVAL_TP_SCENES = 20
# [resnet]: the classifiers held card against CPU, on two rooms of
# ``RESNET_POINTS`` points quantized at ``RESNET_VOXEL`` m: a 2.5 m room
# spans 500 voxels, so the head's stride-192 level keeps 15-18 voxels per
# room.  Its instance norm over a few voxels amplifies rounding in the
# backward (at 1 cm, a few voxels per room, ResNet50's gradients moved by
# 1.2e-2 in relative L2 between card and CPU), and over one voxel it gives
# a constant
RESNET_ARCHS_ON_CARD = ("ResNet50", "ResFieldNet14")
RESNET_POINTS = 6_000
RESNET_VOXEL = 0.005
# the modules each training phase must reach with a non-zero gradient
TRAIN_MODULES = {
    "backbone": ("MEUnet", "linear_sem", "linear_offset"),
    "full": ("MEUnet", "D_Unet", "score_Unet", "linear_sem", "linear_offset", "linear_binary",
             "linear_IOU_feat", "linear_IOU"),
}
# stage-1 outputs the losses read, from the model's own backbone
STAGE1_KEYS = ("sem_pred_p", "sem_pred_score_p", "offset_pred_p", "point_ok", "overflow_vox",
               "overflow_grid", "overflow_band")

# [data-eval]: ScanNet-layout scenes (``synthetic.write_scannet_scene``,
# vertices about 1 cm apart) sized for the default Config's eval buckets
# (0.4, 0.7 and 1.0 of 400,000 points; a scene runs as three TTA copies):
# one in the 0.4 bucket, one in the 1.0 bucket, one over the largest bucket
# (the oversize crop); and one test scene.  (name, vertices, objects)
DATA_VAL = (("scene0000_00", 40_000, 4), ("scene0001_00", 115_000, 8),
            ("scene0002_00", 170_000, 12))
DATA_TEST = (("scene0100_00", 40_000, 4),)
# every object is a NYU40 'cabinet' (semantic index 2), the class the colour
# oracle predicts on every object: its AP is then that of right classes
ORACLE_NYU40, ORACLE_CLASS = 3, 2
# the tiny card-vs-CPU evaluate on the same files: the Mini_Unet trio at
# small caps in one bucket, so every scene goes through the oversize crop
# (a spatial window of at most 6,144 points).  The window cuts objects, and
# the cut pieces that cluster below the size filter send their points to
# the exact 1-NN pass: its cap is every point
TINY_EVAL = dict(
    shapes=dict(point_cap=3 * 6144, voxel_caps=(18432, 9216), cluster_cap=64,
                local_point_cap=36864, local_voxel_caps=(16384, 8192),
                score_voxel_caps=(16384, 8192), instance_cap=64, cluster_band=2048,
                nn_exact_cap=3 * 6144),
    backbone_arch="Mini_Unet", dunet_arch="Mini_Unet", score_arch="Mini_Unet",
    eval_bucket_scales=(1.0,))

def log(msg):
    print(msg, flush=True)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def to_u64(t):
    """int32 bit words -> their uint32 values as int64 (exact comparison)."""
    import torch

    return t.to(torch.int64) & 0xFFFFFFFF


def max_abs_err(got, want):
    """Max |kernel - plain| over all outputs; raises unless it is 0 (and
    float outputs equal bit for bit)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            fin = torch.isfinite(w)
            if fin.any():
                err = max(err, (g[fin] - w[fin]).abs().max().item())
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"float output differs bitwise (max |diff| {err})")
        elif g.numel():
            err = max(err, float((to_u64(g) - to_u64(w)).abs().max().item()))
    if err != 0:
        raise AssertionError(f"kernel differs from its plain version (max |diff| {err})")
    return err


def time_kernel(fn, reps=20):
    """Median device time of ``reps`` launches.  A sleep kernel keeps the
    card busy while the host enqueues them, so host launch overhead (ctypes,
    argument checks) falls outside the events."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def time_plain(fn, reps=3):
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def set_bits(*words):
    """Number of set bits in int32 bit words (SWAR popcount)."""
    import torch

    n = 0
    for w in words:
        x = w.to(torch.int64) & 0xFFFFFFFF
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        n += int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())
    return n


def bound(name, args, outs):
    """(bound_ms, bound_by, detail): the least time the card could take for this
    call, the larger of two times.  Bytes: each input the call needs read
    once and each output written once, over HBM bandwidth.  Operations: the
    f32 and int32 operations that this call's data needs (pair tests of
    valid rows and columns, set bits), at the issue rate for all of them
    and at the int32 rate for the integer ones (PAIR_OPS, SET_BIT_OPS)."""
    tensors = [a for a in args if hasattr(a, "shape")]
    n_bytes = nbytes(*tensors) + nbytes(*outs)
    if name == "neighbor_pack":
        rows_i, w1i, w2i = args[2], args[4], args[6]
        cols = (w1i[:, 1] > 0).sum(1) + (w2i[:, 1] > 0).sum(1)
        pairs = int(((rows_i[:, 1] > 0).sum(1) * cols).sum())
        f32, i32 = (k * pairs for k in PAIR_OPS)
    elif name == "window_1nn":
        # needy rows against their chunk's candidate columns (left window
        # and right fresh); bytes: the needy rows' xyz and group, the planes
        # and anchors of chunks with a needy row, the row mask, the outputs
        rows_f, rows_g, need, w1f, w1i, w2f, w2i, anchor, anchor2 = args
        per_chunk = need.sum(1)
        hit = per_chunk > 0
        n_bytes = (int(per_chunk.sum()) * 4 * 4 + nbytes(need, *outs)
                   + sum(nbytes(t[hit]) for t in (w1f, w1i, w2f, w2i, anchor, anchor2)))
        pairs = b4_pairs(args)
        f32, i32 = (k * pairs for k in PAIR_OPS)
    else:
        f32, i32 = 0, SET_BIT_OPS[name] * set_bits(args[0], args[1])
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max((f32 + i32) / ISSUE_PER_S, i32 / I32_PER_S)
    detail = f"{n_bytes / 1e6:.3f} MB, {f32} f32 + {i32} int32 ops"
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            detail)


def sass_hot_blocks(lib_path, kernels, score=None):
    """The SASS of each kernel named in ``kernels`` (name fragments), read
    with cuobjdump: {fragment: [(instructions, opcode counts)]} of the
    largest straight-line block of each instantiation (its fully unrolled
    inner loop), or the one ``score(opcode counts)`` ranks first.  Blocks
    end at labels and branches."""
    import re
    from collections import Counter

    from pbnet_torch import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    instr = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")

    def total(ops):
        return sum(ops.values())
    found = {k: [] for k in kernels}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        key = next((k for k in kernels if k in func.split()[0]), None)
        if key is None:
            continue
        best, cur = Counter(), Counter()
        for line in func.splitlines():
            m = instr.search(line)
            if m:
                cur[m.group(1)] += 1
            if (m is None and re.match(r"\s*\.L_x_\d+:", line)) or (
                    m and m.group(1) in ("BRA", "EXIT", "RET", "BSYNC", "WARPSYNC")):
                if (score or total)(cur) > (score or total)(best):
                    best = cur
                cur = Counter()
        found[key].append((sum(best.values()), best))
    return found


def b1_pairs(args, block_rows=B1_BLOCK_ROWS):
    """(pairs the bound counts, pairs of the full grid 2 * nchunks * chunk *
    W, pairs the B1 kernel tests) of one neighbor_pack call.  The kernel
    tests the rows of its ``block_rows``-row blocks that hold a valid row
    against the 32 columns of every word that holds a valid column."""
    import torch

    rows_i, w1i, w2i = args[2], args[4], args[6]
    nchunks, _, chunk = rows_i.shape
    W = w1i.shape[2]
    rv = rows_i[:, 1] > 0
    cols = sum((wi[:, 1] > 0).sum(1) for wi in (w1i, w2i))
    counted = int((rv.sum(1) * cols).sum())
    nb = -(-chunk // block_rows)
    v = torch.zeros(nchunks, nb * block_rows, dtype=torch.bool, device=rv.device)
    v[:, :chunk] = rv
    size = torch.tensor([min(block_rows, chunk - block_rows * b) for b in range(nb)],
                        device=rv.device)
    rows = (v.view(nchunks, nb, block_rows).any(2) * size).sum(1)
    words = sum((wi[:, 1] > 0).view(nchunks, W // 32, 32).any(2).sum(1) for wi in (w1i, w2i))
    return counted, 2 * nchunks * chunk * W, int((rows * words * 32).sum())



def b4_pairs(args):
    """Pair tests B4's data needs: each needy row against the candidate
    columns of its chunk's two windows."""
    need, w1i, w2i = args[2], args[4], args[6]
    cands = (w1i[:, 1] > 0).sum(1) + (w2i[:, 1] > 0).sum(1)
    return int((need.sum(1) * cands).sum())


def b4_once(counts, where):
    """B4 runs once per clustering call, as B1 does."""
    if counts["window_1nn"] != counts["neighbor_pack"]:
        raise AssertionError(f"{where}: B4 launched {counts['window_1nn']} times for "
                             f"{counts['neighbor_pack']} clustering calls")


def start_baseline_build(root):
    """Start nvcc (the package's flags) on the window kernels of the checkout
    at ``root``, from before B4's rebuild, into the build directory:
    (process or None if built, library path)."""
    import hashlib
    from pathlib import Path

    from pbnet_torch import _build

    src = Path(root) / "pbnet_torch" / "csrc" / "window_kernels.cu"
    if "int pbnet_window_1nn(const int* need" not in src.read_text():
        raise SystemExit(f"--baseline {root}: not a checkout from before B4's rebuild "
                         "(its pbnet_window_1nn takes one window)")
    tag = hashlib.sha256(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    lib = _build.BUILD_DIR / f"window_kernels_baseline-{tag[:16]}.so"
    if lib.exists():
        return None, lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # into a temporary name, renamed once nvcc succeeds
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib.with_suffix(".tmp")), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def baseline_b4(lib, args, need_c):
    """The baseline's design on B4's arguments: its kernel on the left
    window, again on the right one, and clustering's merge of the two
    (``take2``, two selects, the anchor adds, ``isfinite``).  ``need_c``:
    needy rows per chunk, int32."""
    import ctypes

    import torch

    rows_f, rows_g, _, w1f, w1i, w2f, w2i, anchor, anchor2 = args
    nchunks, _, chunk = rows_f.shape
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    outs = []
    for wf, wi in ((w1f, w1i), (w2f, w2i)):
        d2 = torch.empty((nchunks, chunk), dtype=torch.float32, device=rows_f.device)
        col = torch.empty((nchunks, chunk), dtype=torch.int32, device=rows_f.device)
        err = lib.pbnet_window_1nn(*(ctypes.c_void_p(t.data_ptr()) for t in (
            need_c, rows_f, rows_g, wf, wi, d2, col)), nchunks, chunk, wf.shape[2], stream)
        if err:
            raise RuntimeError(f"baseline B4 kernel: CUDA launch failed with error {err}")
        outs.append((d2, col))
    (bd1, c1), (bd2, c2) = outs
    take2 = bd2 <= bd1
    best = torch.where(take2, bd2, bd1)
    j = torch.where(take2, anchor2[:, None] + c2, anchor[:, None] + c1)
    return best, j, torch.isfinite(best)


def b4_shape(tag, args, base_lib, card):
    """B4 at one shape: exact against its plain version and timed beside the
    bound; with a baseline library (``base_lib``), also equal on needy rows
    to its design (``baseline_b4``), timed the same way.  Logs and returns the
    shape's record."""
    import torch

    from pbnet_torch.ops import window_kernels as wk

    got = wk.window_1nn(*args)
    err = max_abs_err(got, wk.window_1nn_plain(*args))
    need = args[2]
    ms = time_kernel(lambda: wk.window_1nn(*args))
    baseline_ms, base_note = None, "baseline not timed (no --baseline)"
    if base_lib is not None:
        need_c = need.sum(1, dtype=torch.int32)
        base = baseline_b4(base_lib, args, need_c)
        fin = need & torch.isfinite(got[0])
        if not (torch.equal(base[0][need].view(torch.int32), got[0][need].view(torch.int32))
                and torch.equal(base[1][fin], got[1][fin])):
            raise AssertionError(f"B4 {tag}: the baseline answers otherwise on needy rows")
        baseline_ms = time_kernel(lambda: baseline_b4(base_lib, args, need_c))
        base_note = (f"baseline equal on needy rows, 2 launches + merge {baseline_ms:.4f} ms "
                    f"({baseline_ms / ms:.2f}x the kernel)")
    plain_ms = time_plain(lambda: wk.window_1nn_plain(*args))
    bms, by, detail = bound("window_1nn", args, got)
    n_rows, n_chunks, pairs = int(need.sum()), int(need.any(1).sum()), b4_pairs(args)
    log(f"[kernels] window_1nn {tag}: {n_rows} needy rows in {n_chunks} of {need.shape[0]} "
        f"chunks, {pairs} pair tests; exact; kernel {ms:.4f} ms; {base_note}; plain "
        f"{plain_ms:.3f} ms, bound {bms:.6f} ms ({by}; {detail}; the kernel at "
        f"{bms / ms:.3f} of it); card {card}")
    return dict(max_abs_err=err, ms=ms, baseline_ms=baseline_ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, needy_rows=n_rows, needy_chunks=n_chunks, chunks=need.shape[0],
                pairs=pairs)


def b6_key(sh, plan, weights):
    """'<topology> <map kind> L<output level> <Cin>-><Cout>' of a banded conv
    call (the main and local caps are disjoint)."""
    nt, tm, K = plan.rel.shape
    m_out = nt * tm
    _, cin, cout = weights.shape
    topo = "main" if m_out in sh.voxel_caps else "local"
    caps = list(sh.voxel_caps if topo == "main" else sh.local_voxel_caps)
    kind = "k3" if K == 27 else ("down" if m_out < plan.m_in else "up")
    return f"{topo} {kind} L{caps.index(m_out)} {cin}->{cout}"


def b6_bound(feats, plan, weights, valid_out, out):
    """(bound_ms, bound_by, detail) of one banded conv call: the feature
    table, weights, plan, mask and output moved once over HBM bandwidth,
    against 2 * (present in-band entries) * Cin * Cout flops at the bf16
    tensor-core rate."""
    _, cin, cout = weights.shape
    n_bytes = nbytes(feats, weights, plan.starts, plan.rel, valid_out, out)
    present = int((plan.rel < plan.span).sum())
    flops = 2 * present * cin * cout
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            f"{n_bytes / 1e6:.3f} MB, {present} entries, {flops / 1e9:.3f} GFLOP")


def close_err(got, want, rtol):
    """Max |got - want|; raises unless it is within rtol of max |want|."""
    err = (got - want).abs().max().item()
    if not err <= rtol * want.abs().max().item():
        raise AssertionError(f"differs from its plain version by {err} "
                             f"(max |plain| {want.abs().max().item()})")
    return err


def oracle_bb_tiny(batch, ok, feat32):
    """Perfect stage-1 output for the tiny scene (true class, offsets onto
    the instance centers), with the model's own per-point features."""
    import torch

    sem = torch.clamp(batch["sem_label"], 0, 19)
    offs = torch.where((batch["ins_label"] != -100)[:, None],
                       batch["inst_info"][:, 0:3] - batch["xyz"], 0.0)
    soft = torch.nn.functional.one_hot(sem.long(), 20).float() * 0.9 + 0.005
    return {"point_feat_p": feat32, "sem_soft_p": soft, "offset_pred_p": offs,
            "sem_pred_p": torch.where(ok, sem, -1).to(torch.int32), "point_ok": ok}


def train_ref_shapes():
    """The train reference's caps: two copies of the tiny scene (4
    instances, so the IoU head's train-mode BN normalises over 4 proposals;
    over 2 its input gradient is rounding noise on any device), at every
    level of the full-width UNets without overflow."""
    from pbnet_torch import synthetic

    caps = (1024,) * 5
    return dataclasses.replace(synthetic.GRAFT_SHAPES, point_cap=2048, voxel_caps=caps,
                               local_point_cap=2048, local_voxel_caps=caps,
                               score_voxel_caps=caps, cluster_band=1024)


def oracle_train_forward(model, batch, sem, offs):
    """The full-phase forward with stage 2 driven by the oracle semantics
    and offsets (random weights make no clusters): the model's own stage-1
    outputs feed the losses, its per-point features and softmax feed stages
    2-3, so the gradient reaches the backbone through them."""
    import torch

    bb = model.backbone(batch)
    bb2 = dict(bb, sem_pred_p=torch.where(bb["point_ok"], sem, -1), offset_pred_p=offs)
    ret = {k: bb[k] for k in STAGE1_KEYS}
    ret.update(model.instance_stage(batch, bb2, True))
    return ret


def full_step(model, opt, cfg, batch, sem, offs, lr, group=None):
    """One oracle-driven full-phase train step: the package's forward,
    ``losses.model_fn``, backward and ``train_step.finish_step`` (over a
    process ``group`` the gradients, aux and BN statistics are averaged).
    Returns (aux, forward outputs)."""
    from pbnet_torch.models import losses
    from pbnet_torch.parallel import train_step

    model.train()
    opt.zero_grad(set_to_none=True)
    ret = oracle_train_forward(model, batch, sem, offs)
    loss, aux = losses.model_fn(ret, batch, cfg, True)
    loss.backward()
    return train_step.finish_step(model, opt, cfg, aux, lr, group), ret


def step_record(model, aux, ret, state0):
    """What ``hold_step`` compares of one train step, on the host: aux
    floats, cluster ids, and per parameter its gradient and update (from
    ``state0``), per BN buffer its value."""
    params = dict(model.named_parameters())
    return {"aux": {k: float(v) for k, v in aux.items()},
            "cluster_id": ret["cluster"].cluster_id.cpu(),
            "grad": {n: p.grad.detach().cpu() for n, p in params.items()},
            "update": {n: p.detach().cpu() - state0[n] for n, p in params.items()},
            "stat": {n: b.detach().cpu() for n, b in model.named_buffers()
                     if n.endswith(("running_mean", "running_var"))}}


def hold_step(tag, got, want, norm_rtol=1e-4):
    """Phase 8's gates on one train step against another (``step_record``s):
    cluster ids equal, no overflow, every loss term within rtol 1e-4 and
    the gradient and parameter norms within ``norm_rtol``, every gradient
    and update within ``REF_TENSOR_TOL`` of its tensor's scale and
    ``REF_MODEL_TOL`` in relative L2 over the model, every BN statistic
    within 1e-3 of its tensor's largest magnitude.  Returns (worst error
    relative to scale, relative L2, tensors within 1e-3 of their scale)."""
    import torch

    if not torch.equal(got["cluster_id"], want["cluster_id"]):
        raise AssertionError(f"{tag}: cluster ids differ")
    over = {k: v for k, v in want["aux"].items() if k.startswith("overflow") and v}
    if over:
        raise AssertionError(f"{tag}: overflow {over}")
    for k, v in want["aux"].items():
        rtol = norm_rtol if k in ("grad_norm", "param_norm") else 1e-4
        if not abs(got["aux"][k] - v) <= rtol * abs(v) + 1e-5:
            raise AssertionError(f"{tag}: {k} {got['aux'][k]} against {v}")
    within = {"grad": 0, "update": 0}
    worst = {"grad": 0.0, "update": 0.0, "stat": 0.0}
    rel_l2 = {}
    for what in ("grad", "update"):
        a, b = got[what], want[what]
        # biases right before a train-mode BN have a zero gradient in exact
        # arithmetic: their scale is 1e-3 of the model's largest
        floor = 1e-3 * max(float(v.abs().max()) for v in b.values())
        for n in b:
            if not torch.isfinite(a[n]).all():
                raise AssertionError(f"{tag}: non-finite {what} {n}")
            rel = float((a[n] - b[n]).abs().max()) / max(float(b[n].abs().max()), floor)
            if not rel <= REF_TENSOR_TOL:
                raise AssertionError(f"{tag}: {what} {n} differs by {rel} of its scale")
            within[what] += rel <= 1e-3
            worst[what] = max(worst[what], rel)
        rel_l2[what] = (sum(float((a[n] - b[n]).norm()) ** 2 for n in b)
                        / sum(float(b[n].norm()) ** 2 for n in b)) ** 0.5
        if not rel_l2[what] <= REF_MODEL_TOL:
            raise AssertionError(f"{tag}: {what}s differ by {rel_l2[what]} in relative L2")
    for n, v in want["stat"].items():
        worst["stat"] = max(worst["stat"], close_err(got["stat"][n], v, 1e-3)
                            / float(v.abs().max()))
    return worst, rel_l2, within


def write_dataset(root, val, test):
    """Write ScanNet-layout scenes, (name, vertices, objects) each
    (``synthetic.write_scannet_scene``, seed = the scene's index) under
    ``root/scans``, decode each with the port's
    ``decode_scannet`` (segmentator included) into ``root/npy``, write the
    split lists and ``val_gt``.  Returns {scene: (vertices, decode seconds)}
    and the seconds the segmentator's build and load took."""
    import numpy as np

    from pbnet_torch import synthetic
    from pbnet_torch.data import decode_scannet
    from pbnet_torch.native import segmentator

    t0 = time.perf_counter()
    segmentator.loaded_library()
    build_s = time.perf_counter() - t0
    scans, npy = os.path.join(root, "scans"), os.path.join(root, "npy")
    os.makedirs(npy, exist_ok=True)
    scenes = {}
    for i, (name, n, n_objects) in enumerate(val + test):
        nv = synthetic.write_scannet_scene(scans, name, np.random.RandomState(i), n, n_objects,
                                           object_labels=(ORACLE_NYU40,))
        t0 = time.perf_counter()
        decode_scannet.decode_scene(os.path.join(scans, name + "_vh_clean_2.ply"), npy, None,
                                    with_labels=i < len(val))
        scenes[name] = (nv, time.perf_counter() - t0)
    for split, names in (("val", val), ("test", test)):
        with open(os.path.join(root, f"scannetv2_{split}.txt"), "w") as f:
            f.write("".join(sc[0] + "\n" for sc in names))
    decode_scannet.write_val_gt(npy, [sc[0] for sc in val], os.path.join(root, "val_gt"))
    return scenes, build_s


def oracle_checkpoint(cfg):
    """Seeded weights (``cfg.manual_seed``) with ``synthetic.color_oracle``
    set, saved by the port's ``checkpoint_save`` into ``cfg.logpath`` as
    epoch 1."""
    from pbnet_torch import engine, synthetic
    from pbnet_torch.tools import log as log_tools

    model = engine.build_model(cfg, "cpu")
    synthetic.color_oracle(model, ORACLE_CLASS)
    return log_tools.checkpoint_save({"model": model.state_dict()}, cfg.logpath, 1)


def data_eval_configs(root):
    """(full, tiny) configs of the data-eval phase over ``root``: the
    default ``Config`` caps and UNets under ``test_config``, and the tiny
    card-vs-CPU one (``TINY_EVAL``), each with its own checkpoint dir."""
    from pbnet_torch.config import StaticShapes, test_config

    base = test_config().replace(data_root=root, num_works=2)
    tiny = dict(TINY_EVAL)
    shapes = StaticShapes(**tiny.pop("shapes"))
    return (base.replace(logpath=os.path.join(root, "log")),
            base.replace(logpath=os.path.join(root, "log_tiny"), shapes=shapes, **tiny))


def data_eval_phase(card, reset_launches, launches, device="cuda"):
    """Phase 12: from ScanNet files on disk to the AP report (see the module
    docstring).  Returns {kernel: launches in the evaluate run}."""
    import numpy as np
    import torch

    from pbnet_torch import engine
    from pbnet_torch.ops import window_kernels as wk

    t_phase = time.time()
    with tempfile.TemporaryDirectory() as root:
        scenes, build_s = write_dataset(root, DATA_VAL, DATA_TEST)
        decode_s = {k: s for k, (_, s) in scenes.items()}
        cfg, tiny = data_eval_configs(root)
        for c in (cfg, tiny):
            oracle_checkpoint(c)
        log(f"[data-eval] segmentator built and loaded in {build_s:.2f} s; wrote and decoded "
            f"{len(scenes)} scenes (vertices, decode s): "
            f"{ {k: (n, round(s, 3)) for k, (n, s) in scenes.items()} }; buckets "
            f"{[(b.point_cap, b.voxel_caps[0]) for b in cfg.eval_buckets()]}")

        # the evaluate run, counted: B1-B4's arguments at the eval shapes are
        # recorded (the last call of each) for the comparison after it
        captured = {}
        originals = {k: getattr(wk, k) for k in KERNELS}

        def recorder(name):
            def wrapped(*a, **kw):
                captured[name] = (a, kw)
                return originals[name](*a, **kw)
            return wrapped

        timing = {}
        for k in KERNELS:
            setattr(wk, k, recorder(k))
        try:
            reset_launches()
            t0 = time.time()
            res = engine.evaluate_pretrained(cfg, timing=timing, device=device)
            eval_s = time.time() - t0
            counts = launches()
        finally:
            for k in KERNELS:
                setattr(wk, k, originals[k])

        per_scene = timing["per_scene"]
        for r in per_scene:
            log(f"[data-eval] {r['fn']}: {r['points']} points, {r['voxels']} voxels, bucket "
                f"{r['bucket']}; overflow {r['overflow']}; launches "
                f"{ {k: r['launches'][k] for k in KERNELS} }; decode {decode_s[r['fn']]:.3f} s, "
                f"collate {r['collate_s']:.3f} s, forward {r['forward_ms']:.1f} ms, host-eval "
                f"{r['host_eval_s']:.3f} s; peak memory {r['peak_mem_gib']} GiB; "
                f"{r['proposals']} proposals scored")
        over = {r["fn"]: {k: v for k, v in r["overflow"].items() if v} for r in per_scene}
        if any(over.values()):
            raise AssertionError(f"data-eval: overflow {over}")
        unlaunched = {r["fn"]: [k for k in KERNELS if r["launches"][k] <= 0] for r in per_scene}
        if any(unlaunched.values()):
            raise AssertionError(f"data-eval: clustering kernels not launched {unlaunched}")
        for r in per_scene:
            b4_once(r["launches"], f"data-eval {r['fn']}")
        if any(counts[k] for k in ALL_KERNELS if k not in KERNELS):
            raise AssertionError(f"data-eval: a kernel off this path ran {counts}")
        buckets = {r["bucket"] for r in per_scene}
        cropped = [r["fn"] for r in per_scene if r["points"] < 3 * scenes[r["fn"]][0]]
        if len(buckets) < 2 or len(cropped) != 1:
            raise AssertionError(f"data-eval: buckets {buckets}, cropped scenes {cropped}")
        if sum(r["proposals"] for r in per_scene) < 1:
            raise AssertionError("data-eval: no proposal was scored")
        metrics = {k: res.get(k) for k in ("mIoU", "mAcc", "allAcc", "mAP", "AP50", "AP25")}
        if not all(v is not None and np.isfinite(v) and 0.0 <= v <= 1.0
                   for v in metrics.values()):
            raise AssertionError(f"data-eval: a metric is not finite in [0, 1]: {metrics}")
        by_bucket = {}
        for r in per_scene:
            b = by_bucket.setdefault(r["bucket"], {"forward_ms": [], "peak_mem_gib": 0.0})
            b["forward_ms"].append(round(r["forward_ms"], 3))
            b["peak_mem_gib"] = max(b["peak_mem_gib"], r["peak_mem_gib"] or 0.0)
        stages = {k: statistics.mean(decode_s[r["fn"]] if k == "decode_s" else r[k]
                                     for r in per_scene)
                  for k in ("decode_s", "collate_s", "host_eval_s")}
        stages["forward_s"] = statistics.mean(r["forward_ms"] / 1e3 for r in per_scene)
        log(f"[data-eval] evaluate_pretrained: {metrics}; {eval_s:.2f} s; s/scene by stage "
            f"{ {k: round(v, 4) for k, v in stages.items()} }; by bucket (forward ms, peak "
            f"GiB) {by_bucket}; timing "
            f"{ {k: v for k, v in timing.items() if k != 'per_scene'} }; card {card}")

        # the kernels against their plain versions at the eval shapes (these
        # launches come after the counts were read)
        kernel_rows = {}
        for name in KERNELS:
            args, kw = captured[name]
            kern, plain = getattr(wk, name), getattr(wk, name + "_plain")
            got, want = kern(*args, **kw), plain(*args, **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max_abs_err(got, want)
            ms = time_kernel(lambda: kern(*args, **kw))
            plain_ms = time_plain(lambda: plain(*args, **kw))
            bms, by, detail = bound(name, args, got)
            shp = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            kernel_rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                     bound_by=by, launches=counts[name],
                                     launches_per_scene=counts[name] / len(per_scene))
            log(f"[data-eval] {name} at the last scene's shapes {shp}: exact; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; {detail}); "
                f"{counts[name]} launches over {len(per_scene)} scenes")

        # the submission of the test split, written under the working directory
        cwd = os.getcwd()
        os.chdir(root)
        try:
            t0 = time.time()
            result_dir = engine.predict_testset(cfg, device=device)
            sub = [os.path.join(root, result_dir, sc[0] + ".txt") for sc in DATA_TEST]
            missing = [p for p in sub if not os.path.isfile(p)]
            if missing:
                raise AssertionError(f"data-eval: no submission file {missing}")
            with open(sub[0]) as f:
                n_inst = len(f.read().splitlines())
            log(f"[data-eval] predict_testset: {result_dir}, {n_inst} instances in "
                f"{os.path.basename(sub[0])}; {time.time() - t0:.2f} s")
        finally:
            os.chdir(cwd)

        # the tiny config on the same files: the card's result equals the CPU's
        t0 = time.time()
        out = {}
        for dev in (device, "cpu"):
            tm = {}
            out[dev] = (engine.evaluate_pretrained(tiny, timing=tm, device=dev),
                        [r["proposals"] for r in tm["per_scene"]],
                        [r["overflow"] for r in tm["per_scene"]])
        (rg, pg, og), (rc, pc, oc_) = out[device], out["cpu"]
        exact = ("mIoU", "mAcc", "allAcc")
        if (rg.keys() != rc.keys() or any(rg[k] != rc[k] for k in exact) or pg != pc
                or any(abs(rg[k] - rc[k]) > 1e-6 for k in rg if k not in exact)):
            raise AssertionError(f"data-eval tiny: card {rg} {pg} != CPU {rc} {pc}")
        if sum(pg) < 1 or any(v for o in og + oc_ for v in o.values()):
            raise AssertionError(f"data-eval tiny: proposals {pg}, overflow {og} / {oc_}")
        log(f"[data-eval] tiny config ({tiny.backbone_arch}, point cap "
            f"{tiny.shapes.point_cap}) card == CPU: {rg}; proposals per "
            f"scene {pg}; {time.time() - t0:.2f} s")
    log(f"[data-eval] phase {time.time() - t_phase:.1f} s")
    return kernel_rows



def parity_phase(card, reset_launches, launches):
    """Phase 13 [parity]: the port's checkpoint-parity harness
    (``pbnet_torch.tools.parity_eval``) on the card, from a raw scan to its
    table.  One [data-eval] val scene (``DATA_VAL[0]``) written in ScanNet's
    layout; seeded weights of the full-width test config with
    ``synthetic.color_oracle`` set, written as a reference-format ``.pth``
    by ``convert_checkpoint.write_reference_pth``; then ``main`` with ``--scans``
    (decode, val_gt, convert, evaluate).  Gates: no converted tensor
    unmatched; every converted tensor equal to its source; the metrics
    finite in [0, 1]; zero overflow; B1-B4 launched, B4 once per clustering
    call, B5 and B6 not at all.  Returns {kernel: launches}."""
    import numpy as np
    import torch

    from pbnet_torch import engine, synthetic
    from pbnet_torch.config import test_config
    from pbnet_torch.tools import convert_checkpoint as cc
    from pbnet_torch.tools import parity_eval

    t_phase = time.time()
    with tempfile.TemporaryDirectory() as root:
        name, n_vertices, n_objects = DATA_VAL[0]
        scans = os.path.join(root, "scans")
        synthetic.write_scannet_scene(os.path.join(scans, "val"), name, np.random.RandomState(0),
                                      n_vertices, n_objects, object_labels=(ORACLE_NYU40,))
        with open(os.path.join(root, "scannetv2_val.txt"), "w") as f:
            f.write(name + "\n")
        cfg = test_config()
        model = engine.build_model(cfg, "cpu")
        synthetic.color_oracle(model, ORACLE_CLASS)
        source = model.state_dict()
        pth = os.path.join(root, "000000001.pth")
        cc.write_reference_pth(source, pth)
        converted = cc.load_reference_checkpoint(pth)
        differ = sorted(set(source) ^ set(converted)) + [
            k for k in source if k in converted and not torch.equal(converted[k], source[k])]
        if differ:
            raise AssertionError(f"parity: converted tensors differ from their source {differ[:8]}")

        runs = []
        run_parity = parity_eval.run_parity

        def spy(*a, **kw):
            runs.append(run_parity(*a, **kw))
            return runs[-1]

        cwd = os.getcwd()
        os.chdir(root)  # the harness's log directory is relative
        parity_eval.run_parity = spy
        try:
            reset_launches()
            t0 = time.time()
            res = parity_eval.main(["--pth", pth, "--scans", scans, "--data_root", root,
                                    "--max_scenes", "1"])
            secs = time.time() - t0
            counts = launches()
        finally:
            parity_eval.run_parity = run_parity
            os.chdir(cwd)
    (_, unmatched, timing), = runs
    if unmatched:
        raise AssertionError(f"parity: converted tensors matched nothing {unmatched[:8]}")
    metrics = {k: res.get(k) for k in ("mIoU", "mAcc", "allAcc", "mAP", "AP50", "AP25")}
    if not all(v is not None and np.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()):
        raise AssertionError(f"parity: a metric is not finite in [0, 1]: {metrics}")
    (scene,) = timing["per_scene"]
    if any(scene["overflow"].values()):
        raise AssertionError(f"parity: overflow {scene['overflow']}")
    if not all(counts[k] > 0 for k in KERNELS) or any(counts[k] for k in ALL_KERNELS
                                                      if k not in KERNELS):
        raise AssertionError(f"parity: launches {counts}")
    b4_once(counts, "parity")
    log(f"[parity] {name} ({n_vertices} vertices, {scene['points']} points, bucket "
        f"{scene['bucket']}): {len(source)} tensors written, converted back equal, none "
        f"unmatched; {metrics}; {scene['proposals']} proposals; launches "
        f"{ {k: counts[k] for k in KERNELS} }; harness {secs:.2f} s (forward "
        f"{scene['forward_ms']:.1f} ms); card {card}")
    log(f"[parity] phase {time.time() - t_phase:.1f} s")
    return counts


def module_grad_norms(model, names):
    from pbnet_torch.parallel import train_step

    return {n: float(train_step.global_norm(p.grad for p in getattr(model, n).parameters()
                                            if p.grad is not None)) for n in names}


def main():
    import ctypes

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    argv, baseline = sys.argv[1:], None
    if len(argv) >= 2 and argv[0] == "--baseline":
        baseline, argv = os.path.abspath(argv[1]), argv[2:]
    if argv and not (len(argv) == 2 and argv[0] == "--only"):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pbnet_torch import _build, synthetic
    from pbnet_torch.bench import card_line, launches, reset_launches, trace_requests
    from pbnet_torch.config import Config
    from pbnet_torch.eval_pipeline import eval_scene_instances
    from pbnet_torch.models.pbnet import COUNT_MEAN, PBNet, batch_to_device
    from pbnet_torch.nn import onehot_conv as oc
    from pbnet_torch.nn import sparse_ops
    from pbnet_torch.ops import cluster as cl
    from pbnet_torch.ops import window_kernels as wk
    from pbnet_torch.tools import eval_protocol as ev

    # full f32 for every f32 matmul/convolution (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build ----
    t0 = time.time()
    base_proc = base_lib_path = None
    if baseline is not None:
        base_proc, base_lib_path = start_baseline_build(baseline)
    _build.build_all(["window_kernels", "onehot_conv"])
    if base_proc is not None:
        out, _ = base_proc.communicate()
        if base_proc.returncode:
            raise RuntimeError(f"nvcc failed for the baseline's window kernels:\n{out}")
        os.replace(base_lib_path.with_suffix(".tmp"), base_lib_path)
        _build.BUILD_LOG["window_kernels (baseline)"] = (out, time.time() - t0)
    for name, (out, secs) in _build.BUILD_LOG.items():
        log(f"[build] {name}.cu: {secs:.1f} s")
        for line in out.splitlines():
            if "Used" in line or "spill" in line or "error" in line.lower():
                log(f"[build]   {line.strip()}")
    log(f"[build] done in {time.time() - t0:.1f} s")
    base_lib = None
    if base_lib_path is not None:
        base_lib = ctypes.CDLL(str(base_lib_path))
        base_lib.pbnet_window_1nn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
    # the hot loops of B1 and B2 as compiled: instructions per pair test
    # (B1: 3 FMUL per pair) and per bit and row (B2: one min/max each)
    hot = sass_hot_blocks(_build._target("window_kernels")[1],
                          ("neighbor_pack_kernel", "masked_window_reduce_kernel"))
    for key, blocks in hot.items():
        for size, ops in blocks:
            if key.startswith("neighbor"):
                npair = ops["FMUL"] // 3
                per = f"{npair} pair tests, {size / max(npair, 1):.2f} per pair"
            else:
                nred = ops["IMNMX"] + ops["VIMNMX"]
                per = f"{nred} bit-rows, {size / max(nred, 1):.3f} per bit-row"
            log(f"[sass] {key}: hot block {size} instructions ({per}); "
                f"{dict(ops.most_common(10))}")
    # B4's hot loop: the block with the most pair tests (3 FMUL each)
    b4_sass = []
    for size, ops in sass_hot_blocks(_build._target("window_kernels")[1], ("window_1nn_kernel",),
                                     score=lambda ops: ops["FMUL"])["window_1nn_kernel"]:
        npair = ops["FMUL"] // 3
        b4_sass.append(dict(instructions=size, pair_tests=npair,
                            per_pair=size / max(npair, 1), opcodes=dict(ops.most_common(12))))
        log(f"[sass] window_1nn_kernel: hot block {size} instructions ({npair} pair tests, "
            f"{size / max(npair, 1):.2f} per pair); {dict(ops.most_common(12))}")

    only = {"data-eval": lambda: data_eval_phase(card, reset_launches, launches),
            "parity": lambda: parity_phase(card, reset_launches, launches),
            "ddp": lambda: ddp_phase(card, reset_launches, launches),
            "ddp-cards": lambda: ddp_cards_phase(card),
            "bottleneck": lambda: bottleneck_phase(card, reset_launches, launches, ()),
            "resnet": lambda: resnet_phase(card),
            "bench": lambda: bench_phase(card),
            "eval-throughput": lambda: eval_throughput_phase(card)}
    if len(argv) == 2 and argv[0] == "--only" and argv[1] in only:
        only[argv[1]]()
        log(f"[done] {time.time() - t_start:.1f} s ({argv[1]} only: no result lines)")
        return 0

    # ---- bench scene (shared by the capture and the main path) ----
    shapes = {"gather": synthetic.BENCH_SHAPES, "banded": synthetic.BANDED_SHAPES}
    batch, (sem_o, offs_o, soft_o), n_points = synthetic.bench_request("cuda")
    log(f"[scene] {n_points} points, {int(batch['vox_valid'].sum())} voxels")
    models = {"gather": PBNet(shapes["gather"], seed=0, device="cuda")}
    models["banded"] = PBNet(shapes["banded"], device="cuda")
    models["banded"].load_state_dict(models["gather"].state_dict())

    def stage1(path):
        return models[path].backbone(batch)

    def stages23(path, bb):
        bb.update(sem_pred_p=sem_o, offset_pred_p=offs_o, sem_soft_p=soft_o)
        return models[path].instance_stage(batch, bb, with_labels=False)

    def request(path):
        bb = stage1(path)
        return bb, stages23(path, bb)

    # ---- 2. capture real kernel arguments from one warm-up request each ----
    captured = {}
    b6_calls = {}  # shape key -> (args, launches in one banded request)
    originals = {k: getattr(wk, k) for k in KERNELS}
    oc_original = oc.onehot_conv

    def recorder(name):
        fn = originals[name]

        def wrapped(*a, **kw):
            captured.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return wrapped

    def b6_recorder(*a):
        key = b6_key(shapes["banded"], a[1], a[2])
        args, n = b6_calls.get(key, (a, 0))
        b6_calls[key] = (args, n + 1)
        return oc_original(*a)

    for k in KERNELS:
        setattr(wk, k, recorder(k))
    oc.onehot_conv = b6_recorder
    try:
        t0 = time.time()
        request("gather")
        torch.cuda.synchronize()
        t1 = time.time()
        request("banded")
        torch.cuda.synchronize()
    finally:
        for k in KERNELS:
            setattr(wk, k, originals[k])
        oc.onehot_conv = oc_original
    log(f"[kernels] warm-up requests: gather {t1 - t0:.2f} s, banded {time.time() - t1:.2f} s; "
        f"captured {sorted(captured)} and {len(b6_calls)} banded-conv shapes")

    rows = {}
    for name in KERNELS[:3]:  # B4 below, at three shapes
        args, kw = captured[name]
        kern, plain = getattr(wk, name), getattr(wk, name + "_plain")
        got = kern(*args, **kw)
        want = plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        ms = time_kernel(lambda: kern(*args, **kw))
        plain_ms = time_plain(lambda: plain(*args, **kw))
        bms, by, detail = bound(name, args, got)
        shp = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        log(f"[kernels] {name}: exact at {shp}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; {detail})")
        if name == "neighbor_pack":
            counted, grid, tested = b1_pairs(args)
            log(f"[kernels] {name}: pairs the bound counts {counted}, pairs of the full grid "
                f"{grid}, pairs the kernel tests {tested} ({tested / counted:.4f} x counted)")
        rows[name] = dict(name=name, route="cuda", source=SOURCE[name],
                          replaces=TPU_KERNEL[name], max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
    # B2 on content that needs several propagation rounds: binary_cluster on
    # the bench scene's foreground points (compacted to the fg cap, as the
    # model does) with 4 cm of noise on the oracle offsets (as phase 3);
    # every round's call must equal the plain version and is timed
    xyz_b, sem_b, ins_b, cen_b = synthetic.make_scene(np.random.RandomState(0))
    _, offs_b, _ = synthetic.oracle_stage1(xyz_b, sem_b, ins_b, cen_b, xyz_b.shape[0])
    nf = shapes["gather"].fg_point_cap
    sel = np.argsort(sem_b < 2, kind="stable")[:nf]
    noise = np.random.RandomState(2).randn(nf, 3).astype(np.float32) * 0.04
    nargs = ((xyz_b + offs_b)[sel] + noise, xyz_b[sel], sem_b[sel], np.zeros(nf, np.int32),
             sem_b[sel] >= 2)
    reduce_calls, noisy_b4 = [], []

    def reduce_recorder(*a, **kw):
        reduce_calls.append((a, kw))
        return originals["masked_window_reduce"](*a, **kw)

    def b4_recorder(*a):
        noisy_b4.append(a)
        return originals["window_1nn"](*a)

    wk.masked_window_reduce = reduce_recorder
    wk.window_1nn = b4_recorder
    try:
        m, sh = models["gather"], shapes["gather"]
        noisy = cl.binary_cluster(*(torch.from_numpy(a).cuda() for a in nargs),
                                  count_mean=m.count_mean, radius=m.radius, min_pts=m.min_pts,
                                  cluster_cap=sh.cluster_cap, band=sh.cluster_band,
                                  nn_exact_cap=sh.nn_exact_cap)
        torch.cuda.synchronize()
    finally:
        wk.masked_window_reduce = originals["masked_window_reduce"]
        wk.window_1nn = originals["window_1nn"]
    round_ms = []
    for a, kw in reduce_calls:
        max_abs_err((wk.masked_window_reduce(*a, **kw),),
                    (wk.masked_window_reduce_plain(*a, **kw),))
        round_ms.append(time_kernel(lambda: wk.masked_window_reduce(*a, **kw)))
    med = statistics.median(round_ms)
    a0 = reduce_calls[0][0]
    nbits = set_bits(a0[0], a0[1])
    bms, by, _ = bound("masked_window_reduce", a0, (wk.masked_window_reduce(*a0),))
    rows["masked_window_reduce"]["noisy"] = dict(rounds=len(reduce_calls), ms_median=med,
                                                 ms_rounds=med * len(reduce_calls),
                                                 set_bits=nbits, bound_ms=bms)
    log(f"[kernels] masked_window_reduce on noisy content ({int(nargs[4].sum())} fg points, "
        f"4 cm offset noise, {int(noisy.num_clusters)} clusters): {len(reduce_calls)} rounds, "
        f"each exact; median {med:.4f} ms per launch, rounds x median "
        f"{med * len(reduce_calls):.4f} ms; {nbits} set bits; bound {bms:.4f} ms per launch "
        f"({by}); per round {[round(t, 4) for t in round_ms]}")
    del reduce_calls

    # B4 at three shapes: the main path's arguments (oracle content: few
    # needy rows), the noisy content's (needy rows where trained offsets put
    # them) and the main path's with every row needy.  The one-launch kernel
    # against its plain version (with --baseline, beside the design before
    # the rebuild: its kernel on each window and the merge), against the
    # bound of the work the shape needs
    name = "window_1nn"
    empty_ms = time_kernel(lambda: torch.cuda._sleep(0))
    (main_args, _), (noisy_args,) = captured[name], noisy_b4
    all_needy = main_args[:2] + (torch.ones_like(main_args[2]),) + main_args[3:]
    b4_rows = {tag: b4_shape(tag, args, base_lib, card) for tag, args in (
        ("main", main_args), ("noisy", noisy_args), ("all_needy", all_needy))}
    log(f"[kernels] {name}: an empty launch (torch.cuda._sleep(0)) takes {empty_ms:.4f} ms "
        f"by the same timing")
    m = b4_rows["main"]
    rows[name] = dict(name=name, route="cuda", source=SOURCE[name], replaces=TPU_KERNEL[name],
                      max_abs_err=max(r["max_abs_err"] for r in b4_rows.values()), ms=m["ms"],
                      plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                      library_ms=None, empty_launch_ms=empty_ms, shapes=b4_rows, sass=b4_sass)
    del noisy_b4, main_args, noisy_args, all_needy

    # B5 on the border kernel's arguments, with its ``best`` as the target:
    # there match_pick must give the border kernel's ``root``
    name = "masked_window_match_pick"
    bargs, _ = captured["masked_window_border"]
    best, root = wk.masked_window_border(*bargs)
    args = tuple(bargs) + (best,)
    got = wk.masked_window_match_pick(*args)
    err = max_abs_err((got,), (wk.masked_window_match_pick_plain(*args),))
    if not torch.equal(got, root):
        raise AssertionError("match_pick(best) differs from the border kernel's root")
    ms = time_kernel(lambda: wk.masked_window_match_pick(*args))
    plain_ms = time_plain(lambda: wk.masked_window_match_pick_plain(*args))
    bms, by, detail = bound(name, args, (got,))
    log(f"[kernels] {name}: exact and equal to border's root; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; {detail})")
    rows[name] = dict(name=name, route="cuda", source=SOURCE[name], replaces=TPU_KERNEL[name],
                      max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                      library_ms=None)
    del captured

    # B6 at every shape the banded path launches; library: the port's gather
    # conv on the same map (the plan drops nothing here, so it computes the
    # same function) and weights
    name = "onehot_conv"
    shape_rows = []
    for key in sorted(b6_calls):
        (feats, plan, w, valid, dt), n = b6_calls[key]
        if int(plan.overflow):
            raise AssertionError(f"{key}: the plan drops {int(plan.overflow)} entries")
        kmap = oc.plan_map(plan)
        got = oc.onehot_conv(feats, plan, w, valid, dt)
        err = close_err(got, oc.onehot_conv_plain(feats, plan, w, valid, dt), B6_RTOL)
        close_err(got, sparse_ops.gather_conv(feats, kmap, w, valid), B6_RTOL)
        # the slot split sums its partial tiles in a fixed order: a second
        # launch must repeat the first bit for bit
        if not torch.equal(got.view(torch.int32), oc.onehot_conv(feats, plan, w, valid, dt)
                           .view(torch.int32)):
            raise AssertionError(f"{key}: two launches of the banded conv differ")
        ms = time_kernel(lambda: oc.onehot_conv(feats, plan, w, valid, dt))
        plain_ms = time_plain(lambda: oc.onehot_conv_plain(feats, plan, w, valid, dt))
        lib_ms = time_kernel(lambda: sparse_ops.gather_conv(feats, kmap, w, valid))
        bms, by, detail = b6_bound(feats, plan, w, valid, got)
        t = oc.LAST_TILING["onehot_conv"]  # the launch shape the wrapper used
        log(f"[kernels] {name} {key} x{n}/request: max err {err:.3e}, repeat bitwise equal; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, gather conv {lib_ms:.4f} ms "
            f"(kernel/gather {ms / lib_ms:.3f}), bound {bms:.4f} ms ({by}; {detail}); "
            f"{t.blocks} blocks ({t.bm} rows, {t.nsplit} split)")
        shape_rows.append(dict(shape=key, per_request=n, max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                               bound_by=by))
    del b6_calls
    slower = [r["shape"] for r in shape_rows if r["ms"] > r["library_ms"]]
    log(f"[kernels] {name}: {len(slower)} of {len(shape_rows)} shapes slower than the gather "
        f"conv {slower}")

    def total(k):
        return sum(r["per_request"] * r[k] for r in shape_rows)

    by_ops = sum(r["per_request"] * r["bound_ms"] for r in shape_rows
                 if r["bound_by"] == "operations")
    rows[name] = dict(name=name, route="cuda", source=SOURCE[name], replaces=TPU_KERNEL[name],
                      max_abs_err=max(r["max_abs_err"] for r in shape_rows),
                      ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                      bound_by="operations" if 2 * by_ops > total("bound_ms") else "bytes",
                      library_ms=total("library_ms"), shapes=shape_rows)
    log(f"[kernels] {name}, per banded request: kernel {rows[name]['ms']:.4f} ms, plain "
        f"{rows[name]['plain_ms']:.3f} ms, gather conv {rows[name]['library_ms']:.4f} ms, "
        f"bound {rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']})")

    # ---- 3. clustering: card vs CPU on a reduced bench scene ----
    # oracle offsets, and offsets with 4 cm of noise (more propagation
    # rounds, border points and 1-NN rows, as trained offsets make)
    r2 = np.random.RandomState(1)
    cxyz, csem, cins, ccent = synthetic.make_scene(r2, n_pts=30_000, room=2.5, n_obj=6)
    s_o, o_o, _ = synthetic.oracle_stage1(cxyz, csem, cins, ccent, cxyz.shape[0])
    fg = csem >= 2
    nfg = int(fg.sum())
    noise = np.random.RandomState(2).randn(*o_o.shape).astype(np.float32) * 0.04
    kw = dict(radius=0.04, min_pts=31, cluster_cap=16, band=4096, nn_exact_cap=1024)
    for label, offs in (("oracle", o_o), ("noisy", o_o + noise)):
        args_np = ((cxyz + offs)[fg], cxyz[fg], s_o[fg], np.zeros(nfg, np.int32),
                   np.ones(nfg, bool))
        t0 = time.time()
        res_g = cl.binary_cluster(*(torch.from_numpy(a).cuda() for a in args_np),
                                  count_mean=torch.from_numpy(COUNT_MEAN).cuda(), **kw)
        torch.cuda.synchronize()
        t_g = time.time() - t0
        t0 = time.time()
        res_c = cl.binary_cluster(*(torch.from_numpy(a) for a in args_np),
                                  count_mean=torch.from_numpy(COUNT_MEAN), **kw)
        t_c = time.time() - t0
        for f in res_c._fields:
            g, c = getattr(res_g, f).cpu(), getattr(res_c, f)
            if f == "centers":
                if not torch.allclose(g, c, rtol=0, atol=1e-4):
                    raise AssertionError(f"centers differ by {(g - c).abs().max().item()}")
            elif not torch.equal(g, c):
                raise AssertionError(f"{label}: cluster field {f} differs between card and CPU")
        if int(res_g.num_clusters) == 0:
            raise AssertionError(f"{label}: clustering phase found no clusters")
        log(f"[cluster] {label}, {nfg} fg points: card == CPU ({int(res_g.num_clusters)} "
            f"clusters, {int(res_g.prop_rounds)} rounds, "
            f"{int((res_g.density < 31).sum())} low-density points); "
            f"card {t_g:.2f} s, CPU {t_c:.2f} s")

    # ---- 4. reference: full forward, card vs CPU, tiny scene ----
    tiny = synthetic.GRAFT_SHAPES
    tb = synthetic.synthetic_batch(tiny, np.random.RandomState(0))
    old_dtype = sparse_ops.COMPUTE_DTYPE
    sparse_ops.COMPUTE_DTYPE = torch.float32
    try:
        outs = []
        m_g = PBNet(tiny, seed=1, device="cuda")
        m_c = PBNet(tiny, device="cpu")
        m_c.load_state_dict({k: v.cpu() for k, v in m_g.state_dict().items()})
        for m, dev in ((m_g, "cuda"), (m_c, "cpu")):
            b = batch_to_device(tb, dev)
            bb = m.backbone(b)
            o = m.instance_stage(b, oracle_bb_tiny(b, bb["point_ok"], bb["point_feat_p"]), True)
            outs.append((bb, o))
    finally:
        sparse_ops.COMPUTE_DTYPE = old_dtype
    (bg, og), (bc, oc_) = outs
    if not torch.allclose(bg["point_feat_p"].cpu(), bc["point_feat_p"], rtol=1e-3, atol=1e-3):
        raise AssertionError("stage-1 features differ between card and CPU")
    for k in ("scene_pid", "prop_point_src", "num_proposals"):
        if not torch.equal(og[k].cpu(), oc_[k]):
            raise AssertionError(f"{k} differs between card and CPU")
    if not torch.equal(og["cluster"].cluster_id.cpu(), oc_["cluster"].cluster_id):
        raise AssertionError("cluster ids differ between card and CPU")
    ms_g, ms_c = og["mask_scores"].cpu(), oc_["mask_scores"]
    if not torch.allclose(ms_g, ms_c, rtol=1e-3, atol=1e-3):
        raise AssertionError("mask scores differ between card and CPU")
    if int(oc_["num_proposals"]) < 1:
        raise AssertionError("reference phase made no proposals")
    log(f"[reference] tiny scene full forward: card == CPU ({int(oc_['num_proposals'])} "
        f"proposals, max mask-score diff {(ms_g - ms_c).abs().max().item():.2e})")

    # ---- 5. main paths: 3 requests each, in turns ----
    times = {p: [] for p in PATHS}
    stage_ms = {p: [] for p in PATHS}
    path_launches = {p: {k: 0 for k in ALL_KERNELS} for p in PATHS}
    peak_gb = {p: 0.0 for p in PATHS}
    last = {}
    for path in ("gather", "banded", "banded", "gather", "gather", "banded"):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        bb = stage1(path)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = stages23(path, bb)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = launches()
        times[path].append((t2 - t0) * 1e3)
        stage_ms[path].append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
        peak_gb[path] = max(peak_gb[path], torch.cuda.max_memory_allocated() / 2**30)
        for k in ALL_KERNELS:
            on_path = k in KERNELS or (k == "onehot_conv" and path == "banded")
            if on_path and counts[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the {path} path")
            if not on_path and counts[k]:
                raise AssertionError(f"kernel {k} was launched on the {path} path")
            path_launches[path][k] += counts[k]
        b4_once(counts, f"[main] {path} request")
        last[path] = (bb, out)

    for path in PATHS:
        bb, out = last[path]
        ncl = int(out["cluster"].num_clusters)
        nprop = int(out["num_final_proposals"])
        overflow = {k: int(v) for k, v in out["overflow"].items()}
        overflow.update(vox=int(bb["overflow_vox"]), grid=int(bb["overflow_grid"]),
                        band=int(bb["overflow_band"]))
        usage = {k: int(v) for k, v in out["usage"].items()}
        log(f"[main] {path}: clusters {ncl}, proposals {nprop}, rounds "
            f"{int(out['cluster'].prop_rounds)}, overflow {overflow}, usage {usage}")
        if ncl <= 0 or nprop <= 0:
            raise AssertionError(f"{path} path produced no clusters/proposals")
        if any(overflow.values()):
            raise AssertionError(f"capacity overflow on the bench scene ({path}): {overflow}")
        for k in ("sem_pred_score_p", "offset_pred_p", "point_feat_p"):
            if not torch.isfinite(bb[k]).all():
                raise AssertionError(f"non-finite {k} ({path})")
        for k in ("mask_scores", "clt_scores"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"non-finite {k} ({path})")
        if tuple(out["clt_scores"].shape) != (shapes[path].cluster_cap,):
            raise AssertionError("clt_scores has the wrong shape")
        per_req = {k: v // N_REQUESTS for k, v in path_launches[path].items() if v}
        log(f"[main] {path}: {N_REQUESTS} requests: ms/scene "
            f"{[round(t, 3) for t in times[path]]} (stage 1, stages 2-3: "
            f"{[(round(a, 3), round(b, 3)) for a, b in stage_ms[path]]}); median "
            f"{statistics.median(times[path]):.3f} ms; peak memory {peak_gb[path]:.2f} GiB; "
            f"launches per request {per_req}; card {card}")

    (_, og), (_, ob) = last["gather"], last["banded"]
    for k in ("scene_pid", "scene_src"):
        if not torch.equal(og[k], ob[k]):
            raise AssertionError(f"{k} differs between the banded and the gather path")
    if not torch.equal(og["cluster"].cluster_id, ob["cluster"].cluster_id):
        raise AssertionError("cluster ids differ between the banded and the gather path")
    diffs = {}
    for k in ("mask_scores", "clt_scores"):
        diffs[k] = (ob[k] - og[k]).abs().max().item()
        if not diffs[k] <= SCORE_ATOL:
            raise AssertionError(f"{k} of the banded path differ by {diffs[k]} > {SCORE_ATOL}")
    kept_diff = int((og["prop_point_kept"] != ob["prop_point_kept"]).sum())
    log(f"[main] banded vs gather: cluster and scene ids equal; max |diff| "
        f"{ {k: f'{v:.3e}' for k, v in diffs.items()} } (gate {SCORE_ATOL}); "
        f"kept flags differ at {kept_diff} of {int(og['scene_valid'].sum())} scene points; "
        f"median ms/scene gather {statistics.median(times['gather']):.3f}, banded "
        f"{statistics.median(times['banded']):.3f}")
    for k in ALL_KERNELS:
        serves = SERVES[k]
        rows[k]["launches"] = path_launches[serves][k] if serves else 0
        rows[k]["path"] = serves or "off every path"
        rows[k]["launches_by_path"] = {p: path_launches[p][k] for p in PATHS}

    # ---- 6. eval: the ScanNet AP chain on both paths' outputs ----
    gt_ids, superpoint = synthetic.bench_eval_inputs(0)
    cfg = Config()
    for path in PATHS:
        # the scene runs as one copy of n points: eval_pipeline folds point
        # indices mod num_points // 3 (the reference's three TTA copies), so
        # num_points = 3 * n leaves them as they are
        pred = eval_scene_instances(last[path][1], 3 * n_points, superpoint, cfg)
        if pred is None:
            raise AssertionError(f"no proposal of the {path} path survived the eval filters")
        g2p, p2g = ev.assign_instances_for_scan("bench", pred, gt_ids)
        aps = ev.evaluate_matches({"bench": {"gt": g2p, "pred": p2g}})
        avgs = ev.compute_averages(aps)
        # the classes evaluate_matches gives an AP (the others are NaN)
        has_gt = [any(g["instance_id"] >= 1000 and g["vert_count"] >= ev.MIN_REGION_SIZES[0]
                      for g in g2p[lab]) for lab in ev.CLASS_LABELS]
        vals = [avgs["all_ap"], avgs["all_ap_50%"], avgs["all_ap_25%"]]
        vals += [float(x) for x in aps[0][np.array(has_gt)].ravel()]
        if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals):
            raise AssertionError(f"{path}: an AP is not finite in [0, 1]: {vals}")
        log(f"[eval] {path}: {len(pred['conf'])} proposals kept of "
            f"{int(last[path][1]['num_final_proposals'])}; mAP {avgs['all_ap']:.4f}, "
            f"AP50 {avgs['all_ap_50%']:.4f}, AP25 {avgs['all_ap_25%']:.4f} "
            f"({sum(has_gt)} classes with GT)")

    # ---- 7. trace: where a request's time goes ----
    for path in PATHS:
        log(f"[trace] {path} path:")
        trace_requests(lambda: request(path), TRACE_REQUESTS, log=log)
    models.clear()
    del batch, last
    torch.cuda.empty_cache()

    train_launches = train_phases(card, reset_launches, launches)
    for k in KERNELS:
        rows[k]["launches_by_path"]["train"] = train_launches[k]

    eval_rows = data_eval_phase(card, reset_launches, launches)
    for k in ALL_KERNELS:
        rows[k]["launches_by_path"]["data-eval"] = eval_rows[k]["launches"] if k in KERNELS else 0
    for k in KERNELS:
        rows[k]["data_eval"] = eval_rows[k]
    parity_counts = parity_phase(card, reset_launches, launches)
    for k in ALL_KERNELS:
        rows[k]["launches_by_path"]["parity"] = parity_counts[k]

    ddp_launches = ddp_phase(card, reset_launches, launches)
    bn_counts, bn_rows = bottleneck_phase(card, reset_launches, launches,
                                          [r["shape"] for r in shape_rows])
    resnet_phase(card)
    torch.cuda.empty_cache()
    bench_counts = bench_phase(card)
    eval_throughput_phase(card)
    for k in ALL_KERNELS:
        rows[k]["launches_by_path"]["ddp"] = ddp_launches.get(k, 0)
        rows[k]["launches_by_path"]["bottleneck"] = bn_counts[k]
        for config, c in bench_counts.items():
            rows[k]["launches_by_path"]["bench-" + config] = c[k]
    rows["onehot_conv"]["shapes"] += bn_rows
    log(f"[done] {time.time() - t_start:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": [rows[k] for k in ALL_KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def conv_backward_check():
    """The gather conv's backward alone on maps of the bench topology (a k3
    map at L1, the L0->L1 down map and the L1->L0 up map): the card's
    transposed-map backward against the CPU's plain autograd (a scatter-add)
    with f32 operands, and against the same backward on the CPU with bf16
    operands (the plain autograd rounds dx to bf16 where this backward
    rounds dy); y, dx and dW within 1e-3 of their largest magnitude."""
    import numpy as np
    import torch
    from pbnet_torch import synthetic
    from pbnet_torch.core import topology as tp
    from pbnet_torch.models.pbnet import make_level0
    from pbnet_torch.nn import sparse_ops

    t0 = time.time()
    batch, _, _ = synthetic.bench_request("cuda")
    level0, _ = make_level0(batch["vox_coords"], batch["vox_feats"], batch["vox_valid"])
    topo = tp.build_unet_topology(level0, list(synthetic.BENCH_SHAPES.voxel_caps))
    valid = [lv.valid for lv in topo.levels]
    cases = (("k3 L1 64->64", topo.k3_maps[1], topo.k3_maps[1].flip(1), 1, 1, 64, 64),
             ("down L0->L1 32->32", topo.down_maps[0], topo.up_maps[0], 0, 1, 32, 32),
             ("up L1->L0 64->96", topo.up_maps[0], topo.down_maps[0], 1, 0, 64, 96))
    rng = np.random.RandomState(3)
    old = sparse_ops.COMPUTE_DTYPE
    try:
        for name, km, kb, lin, lout, cin, cout in cases:
            m_in, k = valid[lin].shape[0], km.shape[1]
            feats = rng.randn(m_in, cin).astype(np.float32) * valid[lin].cpu().numpy()[:, None]
            w = (rng.randn(k, cin, cout) * 0.1).astype(np.float32)
            dy = rng.randn(km.shape[0], cout).astype(np.float32)
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                sparse_ops.COMPUTE_DTYPE = dtype
                outs = []
                for dev, bwd in (("cuda", kb), ("cpu", None if dtype == torch.float32 else kb)):
                    f = torch.from_numpy(feats).to(dev).requires_grad_(True)
                    ww = torch.from_numpy(w).to(dev).requires_grad_(True)
                    y = sparse_ops.gather_conv(f, km.to(dev), ww, valid[lout].to(dev),
                                               kmap_bwd=None if bwd is None else bwd.to(dev))
                    y.backward(torch.from_numpy(dy).to(dev))
                    outs.append((y.detach().cpu(), f.grad.cpu(), ww.grad.cpu()))
                errs[str(dtype).split(".")[-1]] = [
                    close_err(g, c, 1e-3) / float(c.abs().max()) for g, c in zip(*outs)]
            log(f"[train-reference] conv backward {name} ({km.shape[0]} x {k} map): card "
                f"(transposed map) vs CPU, relative max error of y, dx, dW {errs}")
    finally:
        sparse_ops.COMPUTE_DTYPE = old
    log(f"[train-reference] conv backward checks: {time.time() - t0:.1f} s")


def train_phases(card, reset_launches, launches):
    """Phases 8-11 (module docstring).  Returns B1-B4's launches over the
    timed full-phase steps."""
    import numpy as np
    import torch
    from pbnet_torch import engine, synthetic
    from pbnet_torch.bench import trace_requests
    from pbnet_torch.config import Config
    from pbnet_torch.models.pbnet import PBNet, batch_to_device
    from pbnet_torch.nn import sparse_ops
    from pbnet_torch.parallel import train_step

    # ---- 8. train-reference: one full-phase step, card vs CPU ----
    t0 = time.time()
    ref_sh = train_ref_shapes()
    tb = synthetic.synthetic_batch(ref_sh, np.random.RandomState(0), n_copies=2)
    sem = np.clip(tb["sem_label"], 0, 19).astype(np.int32)
    offs = np.where((tb["ins_label"] != -100)[:, None],
                    tb["inst_info"][:, 0:3] - tb["xyz"], 0.0).astype(np.float32)
    cfg = Config(shapes=ref_sh, optimizer="SGD", lr=0.05, momentum=0.9, weight_decay=1e-4)
    old_dtype = sparse_ops.COMPUTE_DTYPE
    sparse_ops.COMPUTE_DTYPE = torch.float32
    try:
        m_g = PBNet(ref_sh, seed=1, device="cuda")
        state = {k: v.detach().cpu().clone() for k, v in m_g.state_dict().items()}
        runs = {}
        for run, dev in (("card", "cuda"), ("cpu", "cpu")):
            m = m_g if run == "card" else PBNet(ref_sh, device="cpu")
            if run == "cpu":
                m.load_state_dict(state)
            b = batch_to_device(tb, dev)
            aux, ret = full_step(m, train_step.make_optimizer(m, cfg), cfg, b,
                                 torch.from_numpy(sem).to(dev), torch.from_numpy(offs).to(dev),
                                 cfg.lr)
            runs[run] = (m, aux, ret)
    finally:
        sparse_ops.COMPUTE_DTYPE = old_dtype
    (m_g, aux_g, ret_g), (m_c, aux_c, ret_c) = runs["card"], runs["cpu"]
    if int(ret_c["num_final_proposals"]) < 4:
        raise AssertionError("train reference: fewer than 4 proposals")
    worst, rel_l2, within = hold_step("train reference", step_record(m_g, aux_g, ret_g, state),
                                      step_record(m_c, aux_c, ret_c, state))
    n_params = len(list(m_c.parameters()))
    log(f"[train-reference] full-phase step, card vs CPU: {int(ret_c['cluster'].num_clusters)} "
        f"clusters (ids equal), {int(ret_c['num_final_proposals'])} proposals, loss "
        f"{float(aux_g['loss']):.6f} / {float(aux_c['loss']):.6f}; worst error relative to its "
        f"tensor's scale {worst}; relative L2 over the model {rel_l2}; within 1e-3 of their "
        f"scale: {within['grad']} of {n_params} gradients, {within['update']} updates; "
        f"{time.time() - t0:.1f} s")
    del m_g, m_c, runs, state
    torch.cuda.empty_cache()
    conv_backward_check()

    # ---- 9. train-main: the bench scene at full width ----
    nb, (sem_o, offs_o, _) = synthetic.bench_train_batch(0)
    batch = batch_to_device(nb, "cuda")
    sem_t, offs_t = torch.from_numpy(sem_o).cuda(), torch.from_numpy(offs_o).cuda()
    cfg = Config(shapes=synthetic.BENCH_SHAPES, optimizer="Adam", lr=1e-3)
    phases = ("backbone", "full")
    models, steps = {}, {}
    for ph in phases:
        models[ph] = PBNet(synthetic.BENCH_SHAPES, seed=0, device="cuda").train()
        opt = train_step.make_optimizer(models[ph], cfg)
        if ph == "backbone":
            steps[ph] = (lambda s: lambda: (s(batch, cfg.lr), None))(
                train_step.make_train_step(models[ph], opt, cfg, with_instances=False))
        else:
            steps[ph] = (lambda m, o: lambda: full_step(m, o, cfg, batch, sem_t, offs_t, cfg.lr))(
                models[ph], opt)
    first = {ph: {n: p.detach().clone() for n, p in models[ph].named_parameters()}
             for ph in phases}
    losses = {ph: [] for ph in phases}
    ms = {ph: [] for ph in phases}
    peak = {ph: 0.0 for ph in phases}
    train_launches = {k: 0 for k in KERNELS}
    for i in range(TRAIN_STEPS + 1):
        for ph in phases:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            aux, ret = steps[ph]()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            counts = launches()
            if i > 0:
                ms[ph].append(dt)
                peak[ph] = max(peak[ph], torch.cuda.max_memory_allocated() / 2**30)
            vals = {k: float(v) for k, v in aux.items()}
            losses[ph].append(vals["loss"])
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f"train {ph} step {i}: non-finite aux {vals}")
            if counts["onehot_conv"]:
                raise AssertionError(f"train {ph} step {i}: the banded conv ran under grad")
            norms = module_grad_norms(models[ph], TRAIN_MODULES[ph])
            if not all(np.isfinite(v) and v > 0 for v in norms.values()):
                raise AssertionError(f"train {ph} step {i}: gradient norms {norms}")
            if ph == "full":
                over = {k: v for k, v in vals.items() if k.startswith("overflow") and v}
                ncl, nprop = int(ret["cluster"].num_clusters), int(ret["num_final_proposals"])
                if ncl <= 0 or nprop <= 0 or over:
                    raise AssertionError(f"train full step {i}: clusters {ncl}, proposals "
                                         f"{nprop}, overflow {over}")
                if not all(vals[k] > 0 for k in ("mask_loss", "dice_loss", "score_loss")):
                    raise AssertionError(f"train full step {i}: a zero instance loss {vals}")
                if not all(counts[k] > 0 for k in KERNELS):
                    raise AssertionError(f"train full step {i}: launches {counts}")
                b4_once(counts, f"train full step {i}")
                if i > 0:
                    for k in KERNELS:
                        train_launches[k] += counts[k]
            elif any(counts[k] for k in KERNELS):
                raise AssertionError(f"train backbone step {i}: clustering ran {counts}")
            if i in (0, TRAIN_STEPS):
                log(f"[train-main] {ph} step {i}: {dt:.1f} ms; "
                    f"{ {k: round(v, 5) for k, v in vals.items() if not k.startswith('overflow')} }"
                    + (f"; {ncl} clusters, {nprop} proposals, launches "
                       f"{ {k: counts[k] for k in KERNELS} }" if ph == "full" else "")
                    + f"; module grad norms { {k: round(v, 5) for k, v in norms.items()} }")
    for ph in phases:
        moved = [n for n, p in models[ph].named_parameters()
                 if n.split(".")[0] in TRAIN_MODULES[ph] and not torch.equal(p, first[ph][n])]
        if not moved:
            raise AssertionError(f"train {ph}: no parameter changed")
        if not min(losses[ph][1:]) < losses[ph][0]:
            raise AssertionError(f"train {ph}: the loss did not fall {losses[ph]}")
        log(f"[train-main] {ph} phase: {TRAIN_STEPS} timed steps ms/step "
            f"{[round(t, 3) for t in ms[ph]]}; median {statistics.median(ms[ph]):.3f} ms; "
            f"peak memory {peak[ph]:.3f} GiB; losses {[round(v, 5) for v in losses[ph]]}; "
            f"{len(moved)} parameter tensors changed; card {card}")
    log(f"[train-main] B1-B4 launches over the {TRAIN_STEPS} timed full-phase steps "
        f"{train_launches}")

    # ---- 11. (profiled here, while the models are built) train trace ----
    for ph in phases:
        log(f"[train-trace] {ph} phase:")
        trace_requests(steps[ph], 1, tag="train-trace", split_backward=True, log=log)
    del models, steps, first, batch
    torch.cuda.empty_cache()

    # ---- 10. train-engine: engine.train on CUDA by default, then resume ----
    t0 = time.time()
    with tempfile.TemporaryDirectory() as logdir:
        ecfg = Config(shapes=train_ref_shapes(), epochs=2, cluster_epoch=1, validation=False,
                      logpath=logdir)
        ds = synthetic.SyntheticDataset(ecfg.shapes, n_scenes=2)
        model, _ = engine.train(ecfg, ds, max_epochs=1, max_iters=2)
        if next(model.parameters()).device.type != "cuda":
            raise AssertionError("engine.train did not run on CUDA by default")
        ck1 = sorted(f for f in os.listdir(logdir) if f.endswith(".ckpt"))
        model, _ = engine.train(ecfg, ds, max_epochs=2, max_iters=1)
        ck2 = sorted(f for f in os.listdir(logdir) if f.endswith(".ckpt"))
        with open(os.path.join(logdir, "scalars.jsonl")) as f:
            epochs = sorted({json.loads(line)["step"] for line in f})
        if ck1 != ["000000001.ckpt"] or "000000002.ckpt" not in ck2 or epochs != [1, 2]:
            raise AssertionError(f"engine: checkpoints {ck1} then {ck2}, scalar epochs {epochs}")
    log(f"[train-engine] engine.train on {next(model.parameters()).device}: checkpoint {ck1}, "
        f"resumed at epoch 2 ({ck2}), scalars for epochs {epochs}; {time.time() - t0:.1f} s")
    return train_launches


def ddp_rank(rank, world, port, spec, out_dir):
    """One rank of a [ddp] run of ``world`` processes: a gloo group on the
    card (every rank on device 0) or on the CPU, or with ``spec["backend"]
    == "nccl"`` one rank per card.  ``spec["scene"]``: "bench" (full width;
    rank 0 the bench scene, rank r > 0 its augmented copy with seed r in
    caps 1.25x as large; Adam; ``spec["steps"]`` steps, the first a
    warm-up) or "tiny" (phase 8's two-copy tiny scene, rank r seeded r; SGD;
    one step, f32 conv operands).  Every step checks that all ranks hold
    the same parameters and BN statistics bit for bit.  Writes its record
    to ``out_dir/rank<r>.pt``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pbnet_torch import synthetic
    from pbnet_torch.config import Config
    from pbnet_torch.models.pbnet import PBNet, batch_to_device
    from pbnet_torch.nn import modules, sparse_ops
    from pbnet_torch.ops import window_kernels as wk
    from pbnet_torch.parallel import distributed, train_step

    backend = spec.get("backend", "gloo")
    if spec["device"] == "cpu":
        dev = torch.device("cpu")
        torch.set_num_threads(4)
    else:
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank, backend, timeout_s=300)
    group = dist.group.WORLD
    if spec["scene"] == "bench":
        shapes = synthetic.BENCH_SHAPES if rank == 0 else synthetic.BENCH_SHAPES.scaled(1.25)
        nb, (sem, offs, _) = synthetic.bench_train_batch(0, shapes,
                                                         augment_seed=rank or None)
        cfg, seed = Config(shapes=shapes, optimizer="Adam", lr=1e-3), 0
    else:
        sparse_ops.COMPUTE_DTYPE = torch.float32
        shapes = train_ref_shapes()
        nb = synthetic.synthetic_batch(shapes, np.random.RandomState(rank), n_copies=2)
        sem = np.clip(nb["sem_label"], 0, 19).astype(np.int32)
        offs = np.where((nb["ins_label"] != -100)[:, None],
                        nb["inst_info"][:, 0:3] - nb["xyz"], 0.0).astype(np.float32)
        cfg, seed = Config(shapes=shapes, optimizer="SGD", lr=0.05, momentum=0.9,
                           weight_decay=1e-4), 1
    batch = batch_to_device(nb, dev)
    sem, offs = torch.from_numpy(sem).to(dev), torch.from_numpy(offs).to(dev)
    # weights drawn on the CPU: a CUDA generator gives other numbers for the
    # same seed, and (c) holds the card's ranks against the CPU's
    model = PBNet(shapes, device=dev)
    model.load_state_dict(PBNet(shapes, seed=seed, device="cpu").state_dict())
    modules.set_bn_group(model, group)
    state0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    opt = train_step.make_optimizer(model, cfg)
    steps = []
    for i in range(spec["steps"]):
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        wk.reset_launches()
        t0 = time.perf_counter()
        aux, ret = full_step(model, opt, cfg, batch, sem, offs, cfg.lr, group)
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        flat = torch.cat([t.detach().reshape(-1) for t in
                          list(model.parameters()) + list(model.buffers())])
        ref = flat.clone()
        dist.broadcast(ref, 0)
        steps.append(dict(
            ms=ms, aux={k: float(v) for k, v in aux.items()},
            launches={k: wk.LAUNCHES[k] for k in KERNELS},
            peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
            same_as_rank0=torch.equal(ref.view(torch.int32), flat.view(torch.int32)),
            clusters=int(ret["cluster"].num_clusters),
            proposals=int(ret["num_final_proposals"])))
    record = {"steps": steps, "voxels": int(nb["vox_valid"].sum())}
    if spec["scene"] == "tiny":
        record["step"] = step_record(model, aux, ret, state0)
    distributed.shutdown()
    torch.save(record, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(spec, world=2, timeout_s=600):
    """The [ddp] two-rank run of ``spec`` (``ddp_rank``): each rank's
    record."""
    import socket

    import torch
    from pbnet_torch.parallel import distributed

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    with tempfile.TemporaryDirectory() as out:
        distributed.spawn(ddp_rank, world, (world, port, spec, out), timeout_s)
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def ddp_phase(card, reset_launches, launches):
    """Phase 14 [ddp] (module docstring).  Returns B1-B4's launches on rank
    0 over the timed steps of the two-rank bench run."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from pbnet_torch import synthetic
    from pbnet_torch.config import Config
    from pbnet_torch.models.pbnet import PBNet, batch_to_device
    from pbnet_torch.nn import modules, sparse_ops
    from pbnet_torch.parallel import train_step

    t_phase = time.time()
    # (a) NCCL at world size 1: the distributed full step against the plain
    # one, same weights and batch
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    # f32 conv operands, as phase 8: in bf16 the atomic index backwards'
    # order flips roundings, and the two steps' gradients moved by 1.2e-2
    # in relative L2 (first run of this phase)
    old_dtype = sparse_ops.COMPUTE_DTYPE
    sparse_ops.COMPUTE_DTYPE = torch.float32
    try:
        nb, (sem_o, offs_o, _) = synthetic.bench_train_batch(0)
        batch = batch_to_device(nb, "cuda")
        sem_t, offs_t = torch.from_numpy(sem_o).cuda(), torch.from_numpy(offs_o).cuda()
        cfg = Config(shapes=synthetic.BENCH_SHAPES, optimizer="SGD", lr=0.05, momentum=0.9,
                     weight_decay=1e-4)
        records, ms = {}, {}
        state0 = None
        for run in ("nccl", "plain"):
            model = PBNet(synthetic.BENCH_SHAPES, seed=0, device="cuda")
            if state0 is None:
                state0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            group = dist.group.WORLD if run == "nccl" else None
            modules.set_bn_group(model, group)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux, ret = full_step(model, train_step.make_optimizer(model, cfg), cfg, batch, sem_t,
                                 offs_t, cfg.lr, group)
            torch.cuda.synchronize()
            ms[run] = (time.perf_counter() - t0) * 1e3
            counts = launches()
            if not all(counts[k] > 0 for k in KERNELS):
                raise AssertionError(f"ddp {run} step: launches {counts}")
            records[run] = step_record(model, aux, ret, state0)
            del model, aux, ret
            torch.cuda.empty_cache()
    finally:
        sparse_ops.COMPUTE_DTYPE = old_dtype
        dist.destroy_process_group()
    # the card's atomic index backwards reorder sums between any two steps:
    # the norms are held as the gradients are (1.9e-4 apart in bf16 in the
    # first run of this phase)
    worst, rel_l2, within = hold_step("ddp nccl", records["nccl"], records["plain"],
                                      norm_rtol=REF_MODEL_TOL)
    log(f"[ddp] (a) NCCL, world size 1: the full-phase bench step (f32) through the "
        f"distributed step equals the plain step within phase 8's gates (cluster ids equal; "
        f"worst error relative to scale {worst}; relative L2 {rel_l2}; within 1e-3: {within}); "
        f"ms {ms} (one step each, the NCCL one first, with the communicator's set-up)")
    del records, batch
    torch.cuda.empty_cache()

    # (b) two gloo ranks on the one card at full width
    t0 = time.time()
    steps = 1 + DDP_STEPS
    ranks = run_ranks({"device": "cuda", "scene": "bench", "steps": steps})
    for r, rec in enumerate(ranks):
        for i, st in enumerate(rec["steps"]):
            bad = [k for k in KERNELS if st["launches"][k] <= 0]
            over = {k: v for k, v in st["aux"].items() if k.startswith("overflow") and v}
            if not st["same_as_rank0"] or bad or over or not all(
                    np.isfinite(v) for v in st["aux"].values()):
                raise AssertionError(f"ddp rank {r} step {i}: same as rank 0 "
                                     f"{st['same_as_rank0']}, unlaunched {bad}, overflow "
                                     f"{over}, aux {st['aux']}")
            b4_once(st["launches"], f"ddp rank {r} step {i}")
            if st["clusters"] <= 0 or st["proposals"] <= 0:
                raise AssertionError(f"ddp rank {r} step {i}: {st['clusters']} clusters, "
                                     f"{st['proposals']} proposals")
    if ranks[0]["steps"][-1]["aux"] != ranks[1]["steps"][-1]["aux"]:
        raise AssertionError("ddp: the averaged aux differs between the ranks")
    for r, rec in enumerate(ranks):
        timed = rec["steps"][1:]
        log(f"[ddp] (b) gloo rank {r} of 2 on one card, {rec['voxels']} voxels: ms/step "
            f"{[round(st['ms'], 3) for st in timed]}; median "
            f"{statistics.median(st['ms'] for st in timed):.3f} ms; peak memory "
            f"{max(st['peak_gib'] for st in timed):.3f} GiB; launches per step "
            f"{timed[-1]['launches']}; clusters {timed[-1]['clusters']}, proposals "
            f"{timed[-1]['proposals']}; card {card}")
    losses = [st["aux"]["loss"] for st in ranks[0]["steps"]]
    log(f"[ddp] (b) {steps} steps (1 warm-up): parameters and BN statistics bit-identical "
        f"across the ranks after every step; averaged losses {[round(v, 5) for v in losses]}; "
        f"{time.time() - t0:.1f} s")
    ddp_launches = {k: sum(st["launches"][k] for st in ranks[0]["steps"][1:]) for k in KERNELS}

    # (c) the tiny two-rank step on the card against the same on the CPU
    t0 = time.time()
    tiny = {dev: run_ranks({"device": dev, "scene": "tiny", "steps": 1})
            for dev in ("cuda", "cpu")}
    for r in range(2):
        worst, rel_l2, within = hold_step(f"ddp tiny rank {r}", tiny["cuda"][r]["step"],
                                          tiny["cpu"][r]["step"])
        if not all(st["same_as_rank0"] for dev in tiny for st in tiny[dev][r]["steps"]):
            raise AssertionError("ddp tiny: the ranks differ")
        log(f"[ddp] (c) tiny two-rank full step, rank {r}, card vs CPU: worst error relative "
            f"to scale {worst}; relative L2 {rel_l2}; within 1e-3: {within}")
    log(f"[ddp] (c) {time.time() - t0:.1f} s; phase {time.time() - t_phase:.1f} s")
    return ddp_launches


def ddp_cards_phase(card):
    """``--only ddp-cards`` (not in the default run, which needs one card):
    every visible card one NCCL rank.  The full-phase bench step as in
    [ddp] (b), rank r on the bench scene's augmented copy with seed r
    (rank 0 the scene itself), 1 warm-up and ``DDP_STEPS`` timed steps,
    under (b)'s gates; then ``engine.train`` over the same ranks on the tiny
    synthetic dataset, resumed by a second call."""
    import numpy as np
    import torch
    from pbnet_torch import engine, synthetic
    from pbnet_torch.config import Config

    t_phase = time.time()
    n = torch.cuda.device_count()
    if n < 2:
        raise AssertionError(f"ddp-cards needs two cards or more, found {n}")
    ranks = run_ranks({"device": "cuda", "backend": "nccl", "scene": "bench",
                       "steps": 1 + DDP_STEPS}, world=n)
    for r, rec in enumerate(ranks):
        for i, st in enumerate(rec["steps"]):
            bad = [k for k in KERNELS if st["launches"][k] <= 0]
            over = {k: v for k, v in st["aux"].items() if k.startswith("overflow") and v}
            if not st["same_as_rank0"] or bad or over or not all(
                    np.isfinite(v) for v in st["aux"].values()):
                raise AssertionError(f"ddp-cards rank {r} step {i}: same as rank 0 "
                                     f"{st['same_as_rank0']}, unlaunched {bad}, overflow {over}")
            b4_once(st["launches"], f"ddp-cards rank {r} step {i}")
        timed = rec["steps"][1:]
        log(f"[ddp-cards] NCCL rank {r} of {n} (cuda:{r}), {rec['voxels']} voxels: ms/step "
            f"{[round(st['ms'], 3) for st in timed]}; median "
            f"{statistics.median(st['ms'] for st in timed):.3f} ms; peak memory "
            f"{max(st['peak_gib'] for st in timed):.3f} GiB; launches per step "
            f"{timed[-1]['launches']}; card {card}")
    log(f"[ddp-cards] {n} ranks bit-identical after every step; averaged losses "
        f"{[round(st['aux']['loss'], 5) for st in ranks[0]['steps']]}")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as logdir:
        cfg = Config(shapes=train_ref_shapes(), epochs=2, cluster_epoch=1, validation=False,
                     logpath=logdir, num_devices=n, batch_size=1)
        ds = synthetic.SyntheticDataset(cfg.shapes, n_scenes=n)
        engine.train(cfg, ds, max_epochs=1, device="cuda", join_timeout_s=600)
        model, _ = engine.train(cfg, ds, max_epochs=2, device="cuda", join_timeout_s=600)
        cks = sorted(f for f in os.listdir(logdir) if f.endswith(".ckpt"))
        with open(os.path.join(logdir, "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        logs = os.listdir(os.path.join(logdir, "train"))
    keys = [(r["tag"], r["step"]) for r in rows]
    # one log file per call, named by the second it started in
    if cks != ["000000002.ckpt"] or len(keys) != len(set(keys)) or not 1 <= len(logs) <= 2:
        raise AssertionError(f"ddp-cards engine: checkpoints {cks}, {len(logs)} logs, "
                             f"{len(keys) - len(set(keys))} repeated scalars")
    log(f"[ddp-cards] engine.train over {n} NCCL ranks, then resumed: checkpoints {cks}, "
        f"scalars of epochs {sorted({r['step'] for r in rows})} written once, one log per "
        f"call; model on {next(model.parameters()).device}; {time.time() - t0:.1f} s; phase "
        f"{time.time() - t_phase:.1f} s")


def bottleneck_phase(card, reset_launches, launches, main_b6_keys):
    """Phase 15 [bottleneck] (module docstring).  Returns ({kernel:
    launches over the requests}, B6 shape rows)."""
    import numpy as np
    import torch
    from pbnet_torch import synthetic
    from pbnet_torch.models.pbnet import PBNet, batch_to_device
    from pbnet_torch.nn import onehot_conv as oc
    from pbnet_torch.nn import sparse_ops

    t_phase = time.time()
    shapes = {"gather": synthetic.BENCH_SHAPES, "banded": synthetic.BANDED_SHAPES}
    batch, (sem_o, offs_o, soft_o), _ = synthetic.bench_request("cuda")
    models = {"gather": PBNet(shapes["gather"], seed=0, device="cuda", **BOTTLENECK_ARCHS)}
    models["banded"] = PBNet(shapes["banded"], device="cuda", **BOTTLENECK_ARCHS)
    models["banded"].load_state_dict(models["gather"].state_dict())

    def request(path):
        bb = models[path].backbone(batch)
        out = models[path].instance_stage(
            batch, dict(bb, sem_pred_p=sem_o, offset_pred_p=offs_o, sem_soft_p=soft_o), False)
        return bb, out

    # a warm-up request of each; B6's arguments at every shape it launches
    b6_calls = {}
    oc_original = oc.onehot_conv

    def b6_recorder(*a):
        key = b6_key(shapes["banded"], a[1], a[2])
        args, n = b6_calls.get(key, (a, 0))
        b6_calls[key] = (args, n + 1)
        return oc_original(*a)

    oc.onehot_conv = b6_recorder
    try:
        t0 = time.time()
        request("gather")
        torch.cuda.synchronize()
        t1 = time.time()
        request("banded")
        torch.cuda.synchronize()
    finally:
        oc.onehot_conv = oc_original
    log(f"[bottleneck] MinkUNet50 / 14A / 34C; warm-up requests: gather {t1 - t0:.2f} s, banded "
        f"{time.time() - t1:.2f} s; {len(b6_calls)} banded-conv shapes, "
        f"{len(set(b6_calls) - set(main_b6_keys))} not on the main path")
    shape_rows = []
    for key in sorted(b6_calls):
        (feats, plan, w, valid, dt), n = b6_calls[key]
        if int(plan.overflow):
            raise AssertionError(f"bottleneck {key}: the plan drops {int(plan.overflow)} entries")
        kmap = oc.plan_map(plan)
        got = oc.onehot_conv(feats, plan, w, valid, dt)
        err = close_err(got, oc.onehot_conv_plain(feats, plan, w, valid, dt), B6_RTOL)
        close_err(got, sparse_ops.gather_conv(feats, kmap, w, valid), B6_RTOL)
        ms = time_kernel(lambda: oc.onehot_conv(feats, plan, w, valid, dt))
        plain_ms = time_plain(lambda: oc.onehot_conv_plain(feats, plan, w, valid, dt))
        lib_ms = time_kernel(lambda: sparse_ops.gather_conv(feats, kmap, w, valid))
        bms, by, detail = b6_bound(feats, plan, w, valid, got)
        new = key not in main_b6_keys
        log(f"[bottleneck] onehot_conv {key}{' (new)' if new else ''} x{n}/request: max err "
            f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, gather conv {lib_ms:.4f} "
            f"ms (kernel/gather {ms / lib_ms:.3f}), bound {bms:.4f} ms ({by}; {detail})")
        shape_rows.append(dict(shape=key, path="bottleneck", new=new, per_request=n,
                               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bms, bound_by=by))
    del b6_calls

    counts_total = {k: 0 for k in ALL_KERNELS}
    times, last = {p: [] for p in PATHS}, {}
    for path in ("gather", "banded", "banded", "gather"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        bb, out = request(path)
        torch.cuda.synchronize()
        times[path].append((time.perf_counter() - t0) * 1e3)
        counts = launches()
        for k in ALL_KERNELS:
            on_path = k in KERNELS or (k == "onehot_conv" and path == "banded")
            if on_path != (counts[k] > 0):
                raise AssertionError(f"bottleneck {path}: kernel {k} launched {counts[k]} times")
            counts_total[k] += counts[k]
        b4_once(counts, f"bottleneck {path}")
        overflow = {k: int(v) for k, v in out["overflow"].items()}
        overflow.update(vox=int(bb["overflow_vox"]), grid=int(bb["overflow_grid"]),
                        band=int(bb["overflow_band"]))
        if any(overflow.values()):
            raise AssertionError(f"bottleneck {path}: overflow {overflow}")
        if int(out["cluster"].num_clusters) <= 0 or int(out["num_final_proposals"]) <= 0:
            raise AssertionError(f"bottleneck {path}: no clusters or proposals")
        for k in ("mask_scores", "clt_scores"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"bottleneck {path}: non-finite {k}")
        last[path] = (out, torch.cuda.max_memory_allocated() / 2**30)
    (og, pk_g), (ob, pk_b) = last["gather"], last["banded"]
    for k in ("scene_pid", "scene_src"):
        if not torch.equal(og[k], ob[k]):
            raise AssertionError(f"bottleneck: {k} differs between the banded and gather paths")
    if not torch.equal(og["cluster"].cluster_id, ob["cluster"].cluster_id):
        raise AssertionError("bottleneck: cluster ids differ between the banded and gather paths")
    diffs = {k: (ob[k] - og[k]).abs().max().item() for k in ("mask_scores", "clt_scores")}
    if not all(v <= SCORE_ATOL for v in diffs.values()):
        raise AssertionError(f"bottleneck: banded scores differ by {diffs} > {SCORE_ATOL}")
    log(f"[bottleneck] 2 requests each: ms/request gather "
        f"{[round(t, 3) for t in times['gather']]}, banded "
        f"{[round(t, 3) for t in times['banded']]}; peak memory gather {pk_g:.2f} GiB, banded "
        f"{pk_b:.2f} GiB; launches {counts_total}; banded vs gather: ids equal, max |diff| "
        f"{ {k: f'{v:.3e}' for k, v in diffs.items()} } (gate {SCORE_ATOL}); card {card}")
    models.clear()
    del batch, last, og, ob
    torch.cuda.empty_cache()

    # card == CPU on the tiny scene (phase 4's check with this backbone)
    tiny = synthetic.GRAFT_SHAPES
    tb = synthetic.synthetic_batch(tiny, np.random.RandomState(0))
    old = sparse_ops.COMPUTE_DTYPE
    sparse_ops.COMPUTE_DTYPE = torch.float32
    try:
        m_g = PBNet(tiny, seed=1, device="cuda", **BOTTLENECK_ARCHS)
        m_c = PBNet(tiny, device="cpu", **BOTTLENECK_ARCHS)
        m_c.load_state_dict({k: v.cpu() for k, v in m_g.state_dict().items()})
        outs = []
        for m, dev in ((m_g, "cuda"), (m_c, "cpu")):
            b = batch_to_device(tb, dev)
            bb = m.backbone(b)
            outs.append((bb, m.instance_stage(b, oracle_bb_tiny(b, bb["point_ok"],
                                                               bb["point_feat_p"]), True)))
    finally:
        sparse_ops.COMPUTE_DTYPE = old
    (bg, og), (bc, oc_) = outs
    close_err(bg["point_feat_p"].cpu(), bc["point_feat_p"], 1e-3)
    for k in ("scene_pid", "prop_point_src", "num_proposals"):
        if not torch.equal(og[k].cpu(), oc_[k]):
            raise AssertionError(f"bottleneck tiny: {k} differs between card and CPU")
    if not torch.equal(og["cluster"].cluster_id.cpu(), oc_["cluster"].cluster_id):
        raise AssertionError("bottleneck tiny: cluster ids differ between card and CPU")
    if not torch.allclose(og["mask_scores"].cpu(), oc_["mask_scores"], rtol=1e-3, atol=1e-3):
        raise AssertionError("bottleneck tiny: mask scores differ between card and CPU")
    log(f"[bottleneck] tiny scene full forward, card == CPU ({int(oc_['num_proposals'])} "
        f"proposals); phase {time.time() - t_phase:.1f} s")
    return counts_total, shape_rows


def run_entry(module, *args):
    """``python -m module args`` from the checkout, as a user runs it:
    (seconds, stdout, stderr).  Raises on a non-zero exit."""
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", module, *args],
                       cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                       text=True, timeout=ENTRY_TIMEOUT_S)
    if r.returncode:
        raise RuntimeError(f"{module} {' '.join(args)} exited {r.returncode}:\n"
                           f"{r.stdout[-2000:]}\n{r.stderr[-6000:]}")
    return time.time() - t0, r.stdout, r.stderr


def tagged(stderr, tag):
    """The JSON objects of ``stderr``'s lines that start with ``tag``."""
    return [json.loads(line[len(tag) + 1:]) for line in stderr.splitlines()
            if line.startswith(tag + " ")]


def bench_phase(card):
    """Phase 17 [bench]: ``python -m pbnet_torch.bench`` with ``--config
    gather`` and ``--config banded``, each in its own process.  Gates: the
    headline (the last stdout line) finite and > 0; in each of the 10 timed
    requests clusters > 0, zero overflow, B1-B4 launched, B4 once per
    clustering call, B6 in the banded run only, B5 never; 0 < mfu <= 1 and
    0 < mfu_f32 <= 1; the executed operations over the GEMM family's device
    time within the f32 peak; the production extent's ids equal the
    headline's; the useful count of stages 1 and 2 equal in both runs, and
    of stage 3 too where both kept the same points.  Returns {config:
    {kernel: launches over the timed requests}}."""
    import math

    t_phase = time.time()
    runs, counts = {}, {}
    for config in ("gather", "banded"):
        secs, out, err = run_entry("pbnet_torch.bench", "--config", config)
        head = json.loads(out.strip().splitlines()[-1])
        reqs = tagged(err, "bench-request")
        (sup,) = tagged(err, "bench-supplementary")
        if not (head["metric"] == "inference_scenes_per_sec" and math.isfinite(head["value"])
                and head["value"] > 0):
            raise AssertionError(f"bench {config}: headline {head}")
        if len(reqs) != 10:
            raise AssertionError(f"bench {config}: {len(reqs)} request lines")
        counts[config] = {k: 0 for k in ALL_KERNELS}
        for r in reqs:
            n = r["launches"]
            if r["clusters"] <= 0 or r["overflow"]:
                raise AssertionError(f"bench {config} request {r['request']}: {r}")
            if not all(n[k] > 0 for k in KERNELS) or n["masked_window_match_pick"] or \
                    (n["onehot_conv"] > 0) != (config == "banded"):
                raise AssertionError(f"bench {config} request {r['request']}: launches {n}")
            b4_once(n, f"bench {config} request {r['request']}")
            for k in ALL_KERNELS:
                counts[config][k] += n[k]
        w, peaks = sup["work"], sup["peaks"]
        if not (0 < w["mfu"] <= 1 and 0 < w["mfu_f32"] <= 1):
            raise AssertionError(f"bench {config}: mfu {w['mfu']}, mfu_f32 {w['mfu_f32']}")
        if not 0 < w["executed_flops_per_s"] <= peaks["f32_flops"]:
            raise AssertionError(f"bench {config}: {w['executed_ops']} executed operations in "
                                 f"{w['gemm_device_ms']} ms of GEMMs exceed the f32 peak: a "
                                 f"counting fault")
        if not sup["production_extent"]["ids_equal_headline"]:
            raise AssertionError(f"bench {config}: production-extent ids differ")
        runs[config] = sup
        h, tr, t = sup["headline"], sup["trace"], sup["train_step"]
        log(f"[bench] {config}: {head['value']:.4f} scenes/s (median {h['median_ms']:.3f} ms; "
            f"stage 1 {statistics.median(h['stage1_ms']):.3f}, stages 2-3 "
            f"{statistics.median(h['stages23_ms']):.3f} ms by CUDA events); device busy "
            f"{tr['busy_ms']:.3f} ms, idle share {tr['idle_share']:.3f}; production extent "
            f"{sup['production_extent']['median_ms']:.3f} ms (ids equal); useful "
            f"{w['useful_ops']} operations (stage 1 share {w['stage1_useful_share']:.3f}), "
            f"executed {w['executed_ops']} in {w['gemm_device_ms']:.3f} ms of GEMMs "
            f"({w['executed_flops_per_s'] / 1e12:.3f} TFLOP/s); mfu {w['mfu']:.3e}, mfu_f32 "
            f"{w['mfu_f32']:.3e}; train step {t['median_ms']:.3f} ms, peak {t['peak_gib']:.3f} "
            f"GiB; launches per request {reqs[-1]['launches']}; kernel builds "
            f"{sup['build_s'] or 'none'}; {secs:.1f} s; card {card}")
        fams = sorted(tr["by_family_ms"].items(), key=lambda kv: -kv[1])
        log(f"[bench] {config}: device ms per request by family "
            f"{ {f: round(ms, 3) for f, ms in fams} }; requests ms "
            f"{[round(x, 3) for x in h['ms']]}; production extent ms "
            f"{[round(x, 3) for x in sup['production_extent']['ms']]}; train steps ms "
            f"{[round(x, 3) for x in t['ms']]}; useful by stage {w['useful_ops_by_stage']}, "
            f"executed by stage {w['executed_ops_by_stage']}")
    g, b = runs["gather"]["work"], runs["banded"]["work"]
    for stage in ("stage 1", "stage 2"):
        if g["useful_ops_by_stage"][stage] != b["useful_ops_by_stage"][stage]:
            raise AssertionError(f"bench: {stage}'s useful count differs between gather "
                                 f"{g['useful_ops_by_stage']} and banded {b['useful_ops_by_stage']}")
    same_kept = g["kept_digest"] == b["kept_digest"]
    if same_kept and g["useful_ops"] != b["useful_ops"]:
        raise AssertionError(f"bench: the useful count differs between gather "
                             f"{g['useful_ops']} and banded {b['useful_ops']}")
    log(f"[bench] useful count gather vs banded: {g['useful_ops_by_stage']} vs "
        f"{b['useful_ops_by_stage']}; kept flags {'equal' if same_kept else 'differ'} "
        f"(usage {g['usage']} vs {b['usage']})")
    log(f"[bench] phase {time.time() - t_phase:.1f} s")
    return counts


def eval_throughput_phase(card):
    """Phase 18 [eval-throughput]: ``python -m pbnet_torch.eval_throughput``
    in its own process.  Gates: the last stdout line holds the JAX script's
    keys and the card, every rate finite and > 0; every pass evaluates all
    ``EVAL_TP_SCENES`` scenes, the warm pass in two buckets, the
    single-bucket pass in one."""
    import math

    secs, out, err = run_entry("pbnet_torch.eval_throughput")
    res = json.loads(out.strip().splitlines()[-1])
    passes = tagged(err, "eval-pass")
    rates = [res[k] for k in ("first_dispatch_scenes_per_sec", "warm_scenes_per_sec",
                              "single_bucket_scenes_per_sec")]
    if res["scenes"] != EVAL_TP_SCENES or not all(math.isfinite(v) and v > 0 for v in rates):
        raise AssertionError(f"eval-throughput: {res}")
    if [p["scenes"] for p in passes] != [EVAL_TP_SCENES] * 3 or \
            [len(p["bucket_scene_counts"]) for p in passes[1:]] != [2, 1]:
        raise AssertionError(f"eval-throughput: passes {passes}")
    log(f"[eval-throughput] scenes/s first-dispatch {rates[0]}, warm {rates[1]}, single-bucket "
        f"{rates[2]}; first forward per bucket {res['first_dispatch_compile_s']} s; buckets "
        f"{res['bucket_scene_counts']} / {res['single_bucket_scene_counts']}; pass walls "
        f"{[round(p['wall_s'], 2) for p in passes]} s; {secs:.1f} s; card {card}")
    return res




def resnet_case(arch, dev, pts, pbatch, coords, valid):
    """The classifier ``arch`` (weights seeded on the CPU) on ``dev`` over
    the input level of ``coords``: (model, topology, inputs, batch ids).  A
    point's voxel is its row in the key-sorted level; a voxel's features are
    the mean of its points' coordinates."""
    import torch
    from pbnet_torch.core import topology as tp
    from pbnet_torch.nn import resnet

    cap = coords.shape[0]
    level = tp.level_from_coords(coords.to(dev), valid.to(dev), cap, 1)
    topo = resnet.build_resnet_topology(level, [cap] * 7)
    bids = [lv.coords[:, 0] for lv in topo.levels]
    pts, pbatch = pts.to(dev), pbatch.to(dev)
    pvalid = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    p2v = tp.point_to_voxel_map(level, pts, pbatch, pvalid, RESNET_VOXEL)
    gen = torch.Generator().manual_seed(0)
    if arch.startswith("ResField"):
        model = resnet.sparse_resfieldnet(3, 10, arch, generator=gen, device="cpu")
        inputs = (pts, p2v, pvalid, level.valid)
    else:
        seg = p2v.long()
        vfeat = torch.zeros((cap, 3), device=dev).index_add_(0, seg, pts)
        cnt = torch.zeros(cap, device=dev).index_add_(0, seg, torch.ones_like(pts[:, 0]))
        model = resnet.sparse_resnet(3, 10, arch, generator=gen, device="cpu")
        inputs = (vfeat / cnt.clamp(min=1.0)[:, None],)
    return model.to(dev), topo, inputs, bids


def resnet_phase(card):
    """Phase 16 [resnet] (module docstring)."""
    import numpy as np
    import torch
    from pbnet_torch import synthetic
    from pbnet_torch.core.quantize import sparse_quantize_np
    from pbnet_torch.nn import sparse_ops

    t_phase = time.time()
    # two small rooms, one per batch item
    rows, pts, pbatch = [], [], []
    for b in range(2):
        xyz, _, _, _ = synthetic.make_scene(np.random.RandomState(3 + b), n_pts=RESNET_POINTS,
                                            room=2.5, n_obj=6)
        vox, _, _ = sparse_quantize_np(xyz, RESNET_VOXEL)
        rows.append(np.concatenate([np.full((len(vox), 1), b), vox], 1))
        pts.append(xyz.astype(np.float32))
        pbatch.append(np.full(len(xyz), b, np.int32))
    coords = np.concatenate(rows).astype(np.int32)
    cap = -(-len(coords) // 512) * 512
    cpad = np.zeros((cap, 4), np.int32)
    cpad[: len(coords)] = coords
    valid = np.arange(cap) < len(coords)
    t = torch.from_numpy
    args = (t(np.concatenate(pts)), t(np.concatenate(pbatch)), t(cpad), t(valid))
    ct = t(np.random.RandomState(5).randn(8, 10).astype(np.float32))
    old = sparse_ops.COMPUTE_DTYPE
    sparse_ops.COMPUTE_DTYPE = torch.float32
    try:
        for arch in RESNET_ARCHS_ON_CARD:
            res = {}
            for dev in ("cuda", "cpu"):
                model, topo, inputs, bids = resnet_case(arch, dev, *args)
                with torch.no_grad():
                    logits_eval = model.eval()(topo, *inputs, bids)
                model.train()
                if dev == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = model(topo, *inputs, bids)
                (out * ct.to(dev)).sum().backward()
                if dev == "cuda":
                    torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3
                res[dev] = (logits_eval.cpu(), out.detach().cpu(),
                            {n: p.grad.cpu() for n, p in model.named_parameters()}, step_ms)
            (eg, tg, gg, ms_g), (ec, tc, gc, ms_c) = res["cuda"], res["cpu"]
            errs = {"eval": close_err(eg, ec, 1e-3) / float(ec.abs().max()),
                    "train": close_err(tg, tc, 1e-3) / float(tc.abs().max())}
            # the gradients under phase 8's gates: a deep net's backward
            # through norms of few rows (the head normalises ~6 voxels per
            # room) amplifies f32 summation-order differences
            floor = 1e-3 * max(float(v.abs().max()) for v in gc.values())
            worst, within = 0.0, 0
            for n, v in gc.items():
                rel = float((gg[n] - v).abs().max()) / max(float(v.abs().max()), floor)
                if not rel <= REF_TENSOR_TOL:
                    raise AssertionError(f"resnet {arch}: gradient {n} differs by {rel} of its "
                                         f"scale between card and CPU")
                worst, within = max(worst, rel), within + (rel <= 1e-3)
            rel_l2 = (sum(float((gg[n] - v).norm()) ** 2 for n, v in gc.items())
                      / sum(float(v.norm()) ** 2 for v in gc.values())) ** 0.5
            if not rel_l2 <= REF_MODEL_TOL:
                raise AssertionError(f"resnet {arch}: gradients differ by {rel_l2} in relative "
                                     f"L2 between card and CPU")
            log(f"[resnet] {arch} on {int(valid.sum())} voxels ({args[0].shape[0]} points), "
                f"card vs CPU: logits relative error {errs}; gradients: worst {worst:.2e} of "
                f"a tensor's scale, relative L2 {rel_l2:.2e}, {within} of {len(gc)} within 1e-3; "
                f"train forward+backward {ms_g:.1f} ms on the card (first call), {ms_c:.1f} ms "
                f"on the CPU; card {card}")
    finally:
        sparse_ops.COMPUTE_DTYPE = old
    log(f"[resnet] phase {time.time() - t_phase:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
