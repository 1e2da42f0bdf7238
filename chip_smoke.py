#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pbnet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its progress; any failed check raises and the script
exits non-zero — no phase catches its own failure):

1. build     nvcc-compile csrc/window_kernels.cu and csrc/onehot_conv.cu for
             sm_90a (one nvcc per source, all started together) and print
             ptxas's report; read B1's and B2's hot loops from the SASS
             (cuobjdump): instructions per pair test and per bit and row.
2. kernels   one warm-up forward of the bench scene records the arguments
             of each clustering kernel's first call; at those bench shapes
             each kernel must equal its plain PyTorch version exactly (bits,
             density, labels, columns; the 1-NN d2 bit for bit), and both
             are timed (kernel: median of 20 launches by CUDA events; plain:
             median of 3 calls) beside the kernel's bound (see ``bound``);
             window_1nn is timed again with every chunk needy, as trained
             content makes it.  B1's line adds the pairs the bound counts,
             those of the full grid and those the kernel tests.  B2 runs
             again in every propagation round of binary_cluster on the bench
             scene's foreground points with 4 cm of noise on the offsets
             (more rounds, as trained offsets make): each round exact, and
             timed (reported, not gated).  match_pick (B5, on no path) runs on the
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
             conv on the banded path only); clusters > 0, proposals > 0,
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
             every step; a finite non-zero gradient norm in every module
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
             each of B1-B4 launched on every scene, B5 and B6 on none; at
             least two buckets and one cropped scene; a proposal scored;
             every metric finite in [0, 1]; a submission file for the test
             scene.  B1-B4 then equal their plain versions exactly at the
             last scene's arguments (timed beside their bound).  Last, the
             tiny config ``TINY_EVAL`` evaluates the same files on the card
             and on the CPU: mIoU, mAcc, allAcc and the per-scene proposal
             counts equal, every other key within 1e-6.
             ``python3 chip_smoke.py --only data-eval`` runs the build and
             this phase alone and prints no result lines.

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
under ``data_eval``.  The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, the script fails and
prints no result.
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
# kernel-name fragments -> family for the trace phase, first match wins
FAMILIES = (
    ("clustering kernels", ("neighbor_pack", "masked_window", "window_1nn")),
    # B6's kernels: the conv, its bf16 operand pass and its split sum
    ("banded conv kernel", ("onehot_conv", "to_bf16_kernel", "split_sum_kernel")),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "sm90_")),
    ("sort", ("radix", "sort", "Sort")),
    ("searchsorted", ("searchsorted",)),
    ("scatter/index_add", ("scatter", "index_add", "indexFunc", "bincount", "histogram")),
    ("gather/index", ("index", "gather", "Index", "take")),
    ("reduce", ("reduce", "Reduce")),
    ("scan", ("scan", "Scan", "cumsum")),
    ("copy/cat/fill", ("copy", "Copy", "cat", "Cat", "fill", "Fill", "memcpy", "Memcpy",
                       "memset", "Memset")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized")),
    # the optimizer's and the global norms' multi-tensor kernels (training)
    ("multi-tensor (optimizer, norms)", ("multi_tensor_apply",)),
)
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


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
        # a chunk with need == 0 reads neither its rows nor its window
        rows_f, rows_g, wf, wi, need = args
        needy = need > 0
        n_bytes = nbytes(need, *outs) + sum(nbytes(t[needy]) for t in (rows_f, rows_g, wf, wi))
        pairs = rows_f.shape[2] * int((wi[:, 1] > 0)[needy].sum())
        f32, i32 = (k * pairs for k in PAIR_OPS)
    else:
        f32, i32 = 0, SET_BIT_OPS[name] * set_bits(args[0], args[1])
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max((f32 + i32) / ISSUE_PER_S, i32 / I32_PER_S)
    detail = f"{n_bytes / 1e6:.3f} MB, {f32} f32 + {i32} int32 ops"
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            detail)


def sass_hot_blocks(lib_path, kernels):
    """The SASS of each kernel named in ``kernels`` (name fragments), read
    with cuobjdump: {fragment: [(instructions, opcode counts)]} of the
    largest straight-line block of each instantiation (its fully unrolled
    inner loop).  Blocks end at labels and branches."""
    import re
    from collections import Counter

    from pbnet_torch import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    instr = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")
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
                if sum(cur.values()) > sum(best.values()):
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


def family(name):
    return next((f for f, keys in FAMILIES if any(k in name for k in keys)), "other")


def in_backward(event):
    """Whether a CPU op ran inside the autograd engine's backward."""
    while event is not None:
        if event.name.startswith("autograd::engine::evaluate_function"):
            return True
        event = event.cpu_parent
    return False


def trace_requests(request, n, tag="trace", split_backward=False):
    """Profile ``n`` requests: wall and device-busy ms per request, the
    device's idle share, and device time per request by kernel family.
    With ``split_backward`` the gathers and GEMMs that the backward launched
    (kernels of CPU ops under the autograd engine) are families of their
    own."""
    from collections import defaultdict

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            request()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # device activity: Kineto lists it as CUDA-type events, or (older
    # profilers) as the ``kernels`` of the CPU ops that launched it.  A
    # range annotated on the device's track (``Optimizer.step``) spans
    # kernels counted on their own: it is left out.
    events = prof.events()
    dev_events = [(e.name, e.time_range.elapsed_us()) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    linked = [(k.name, k.duration, e) for e in events
              if e.device_type == torch.autograd.DeviceType.CPU for k in e.kernels]
    if not dev_events:
        dev_events = [(name, us) for name, us, _ in linked]
    if not dev_events:
        raise RuntimeError("the profiler recorded no device activity")
    by_family = defaultdict(float)
    for name, us in dev_events:
        by_family[family(name)] += us
    busy_us = sum(by_family.values())
    busy_ms = busy_us / 1e3 / n
    if split_backward:
        # the backward's kernels, found through the CPU op that launched
        # each (the package's own CUDA kernels go through ctypes and have
        # none: they stay in their families)
        bwd_us = 0.0
        for name, us, ev in linked:
            if in_backward(ev):
                bwd_us += us
                fam = family(name)
                if fam in ("gather/index", "gemm"):
                    by_family[fam] -= us
                    by_family["backward " + {"gather/index": "gathers",
                                             "gemm": "GEMMs"}[fam]] += us
        log(f"[{tag}] backward: {bwd_us / 1e3 / n:.3f} ms/step ({bwd_us / busy_us:.1%} of "
            f"device time; {sum(us for _, us, _ in linked) / busy_us:.1%} of device time "
            f"linked to a CPU op)")
    log(f"[{tag}] wall {wall_ms:.3f} ms/request, device busy {busy_ms:.3f} ms/request, "
        f"idle share {1 - busy_ms / wall_ms:.3f} ({n} requests, profiler on)")
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        log(f"[{tag}]   {fam:20s} {us / 1e3 / n:9.3f} ms/request "
            f"({us / busy_us:6.1%} of device time)")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))


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


def full_step(model, opt, cfg, batch, sem, offs, lr):
    """One oracle-driven full-phase train step: the package's forward,
    ``losses.model_fn``, backward and ``train_step.apply_gradients``.
    Returns (aux, forward outputs)."""
    from pbnet_torch.models import losses
    from pbnet_torch.parallel import train_step

    model.train()
    opt.zero_grad(set_to_none=True)
    ret = oracle_train_forward(model, batch, sem, offs)
    loss, aux = losses.model_fn(ret, batch, cfg, True)
    loss.backward()
    gn, pn = train_step.apply_gradients(model, opt, cfg.fix_module, lr)
    aux = {k: v.detach() for k, v in aux.items()}
    aux.update(grad_norm=gn, param_norm=pn)
    return aux, ret


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


def module_grad_norms(model, names):
    from pbnet_torch.parallel import train_step

    return {n: float(train_step.global_norm(p.grad for p in getattr(model, n).parameters()
                                            if p.grad is not None)) for n in names}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pbnet_torch import _build, synthetic
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
    _build.build_all(["window_kernels", "onehot_conv"])
    for name, (out, secs) in _build.BUILD_LOG.items():
        log(f"[build] {name}.cu: {secs:.1f} s")
        for line in out.splitlines():
            if "Used" in line or "spill" in line or "error" in line.lower():
                log(f"[build]   {line.strip()}")
    log(f"[build] done in {time.time() - t0:.1f} s")
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

    def launches():
        return {**wk.LAUNCHES, **oc.LAUNCHES}

    def reset_launches():
        wk.reset_launches()
        oc.reset_launches()

    if sys.argv[1:] == ["--only", "data-eval"]:
        data_eval_phase(card, reset_launches, launches)
        log(f"[done] {time.time() - t_start:.1f} s (data-eval only: no result lines)")
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
    for name in KERNELS:
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
        if name == "window_1nn":
            # the main path's B4 launches skip every chunk: set an empty
            # launch beside them, timed the same way
            empty_ms = time_kernel(lambda: torch.cuda._sleep(0))
            log(f"[kernels] {name}: an empty launch (torch.cuda._sleep(0)) takes "
                f"{empty_ms:.4f} ms by the same timing; B4 on the main path {ms:.4f} ms")
        if name == "neighbor_pack":
            counted, grid, tested = b1_pairs(args)
            log(f"[kernels] {name}: pairs the bound counts {counted}, pairs of the full grid "
                f"{grid}, pairs the kernel tests {tested} ({tested / counted:.4f} x counted)")
        rows[name] = dict(name=name, route="cuda", source=SOURCE[name],
                          replaces=TPU_KERNEL[name], max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
    rows["window_1nn"]["empty_launch_ms"] = empty_ms
    # oracle content routes almost no rows to the 1-NN pass, so the captured
    # call mostly skips; time the same tiles with every chunk needy as well
    # (trained offsets leave needy rows in many chunks)
    args, _ = captured["window_1nn"]
    args = args[:4] + (torch.ones_like(args[4]),)
    max_abs_err(wk.window_1nn(*args), wk.window_1nn_plain(*args))
    ms = time_kernel(lambda: wk.window_1nn(*args))
    plain_ms = time_plain(lambda: wk.window_1nn_plain(*args))
    bms, by, detail = bound("window_1nn", args, wk.window_1nn(*args))
    log(f"[kernels] window_1nn, every chunk needy: exact; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; {detail})")

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
    reduce_calls = []

    def reduce_recorder(*a, **kw):
        reduce_calls.append((a, kw))
        return originals["masked_window_reduce"](*a, **kw)

    wk.masked_window_reduce = reduce_recorder
    try:
        m, sh = models["gather"], shapes["gather"]
        noisy = cl.binary_cluster(*(torch.from_numpy(a).cuda() for a in nargs),
                                  count_mean=m.count_mean, radius=m.radius, min_pts=m.min_pts,
                                  cluster_cap=sh.cluster_cap, band=sh.cluster_band,
                                  nn_exact_cap=sh.nn_exact_cap)
        torch.cuda.synchronize()
    finally:
        wk.masked_window_reduce = originals["masked_window_reduce"]
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
        trace_requests(lambda: request(path), TRACE_REQUESTS)
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
    if not torch.equal(ret_g["cluster"].cluster_id.cpu(), ret_c["cluster"].cluster_id):
        raise AssertionError("train reference: cluster ids differ between card and CPU")
    if int(ret_c["num_final_proposals"]) < 4:
        raise AssertionError("train reference: fewer than 4 proposals")
    over = {k: float(v) for k, v in aux_c.items() if k.startswith("overflow") and v}
    if over:
        raise AssertionError(f"train reference: overflow {over}")
    for k, v in aux_c.items():
        if not abs(float(aux_g[k]) - float(v)) <= 1e-4 * abs(float(v)) + 1e-5:
            raise AssertionError(f"train reference: {k} {float(aux_g[k])} on the card, "
                                 f"{float(v)} on the CPU")
    pg, pc = dict(m_g.named_parameters()), dict(m_c.named_parameters())
    p0 = {n: v for n, v in state.items() if n in pc}
    within = {"grad": 0, "update": 0}
    worst = {"grad": 0.0, "update": 0.0, "stat": 0.0}
    rel_l2 = {}
    for what, get in (("grad", lambda p, n: p.grad.detach().cpu()),
                      ("update", lambda p, n: p.detach().cpu() - p0[n])):
        on_card, on_cpu = ({n: get(p, n) for n, p in d.items()} for d in (pg, pc))
        # biases right before a train-mode BN have a zero gradient in exact
        # arithmetic: their scale is 1e-3 of the model's largest
        floor = 1e-3 * max(float(v.abs().max()) for v in on_cpu.values())
        for n in pc:
            if not torch.isfinite(on_card[n]).all():
                raise AssertionError(f"train reference: non-finite {what} {n}")
            scale = max(float(on_cpu[n].abs().max()), floor)
            rel = float((on_card[n] - on_cpu[n]).abs().max()) / scale
            if not rel <= REF_TENSOR_TOL:
                raise AssertionError(f"train reference: {what} {n} differs by {rel} of its scale")
            within[what] += rel <= 1e-3
            worst[what] = max(worst[what], rel)
        rel_l2[what] = (sum(float((on_card[n] - on_cpu[n]).norm()) ** 2 for n in pc)
                        / sum(float(on_cpu[n].norm()) ** 2 for n in pc)) ** 0.5
        if not rel_l2[what] <= REF_MODEL_TOL:
            raise AssertionError(f"train reference: {what}s differ by {rel_l2[what]} in "
                                 f"relative L2")
    bg = dict(m_g.named_buffers())
    for n, v in m_c.named_buffers():
        worst["stat"] = max(worst["stat"], close_err(bg[n].cpu(), v, 1e-3) / float(v.abs().max()))
    log(f"[train-reference] full-phase step, card vs CPU: {int(ret_c['cluster'].num_clusters)} "
        f"clusters (ids equal), {int(ret_c['num_final_proposals'])} proposals, loss "
        f"{float(aux_g['loss']):.6f} / {float(aux_c['loss']):.6f}; worst error relative to its "
        f"tensor's scale {worst}; relative L2 over the model {rel_l2}; within 1e-3 of their "
        f"scale: {within['grad']} of {len(pc)} gradients, {within['update']} updates; "
        f"{time.time() - t0:.1f} s")
    del m_g, m_c, runs, pg, pc, bg, state
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
        trace_requests(steps[ph], 1, tag="train-trace", split_backward=True)
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


if __name__ == "__main__":
    sys.exit(main())
