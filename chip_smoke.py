#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pbnet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its progress; any failed check raises and the script
exits non-zero — no phase catches its own failure):

1. build     nvcc-compile csrc/window_kernels.cu and csrc/onehot_conv.cu for
             sm_90a (one nvcc per source, all started together) and print
             ptxas's report.
2. kernels   one warm-up forward of the bench scene records the arguments
             of each clustering kernel's first call; at those bench shapes
             each kernel must equal its plain PyTorch version exactly (bits,
             density, labels, columns; the 1-NN d2 bit for bit), and both
             are timed (kernel: median of 20 launches by CUDA events; plain:
             median of 3 calls) beside the kernel's bound (see ``bound``);
             window_1nn is timed again with every chunk needy, as trained
             content makes it.  match_pick (B5, on no path) runs on the
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

TF32 is switched off for matmuls and cuDNN: the port's f32 GEMMs run in full
f32, so the CPU comparisons hold at the stated tolerances.

The card line comes third from last; the kernels JSON, second from last,
lists the counterparts of all six TPU kernels.  ``launches`` counts the
kernel's launches over the main phase's requests of the path it serves
(B1-B4: gather, B6: banded; ``launches_by_path`` has both); B5 is on no
path.  B6's ``ms``,
``plain_ms``, ``bound_ms`` and ``library_ms`` are per banded request: each
shape's time times its launches in one request, summed (``shapes`` lists
them).  The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, the script fails and
prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
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
)
N_REQUESTS = 3
TRACE_REQUESTS = 2


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


def trace_requests(request, n):
    """Profile ``n`` requests: wall and device-busy ms per request, the
    device's idle share, and device time per request by kernel family."""
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
    # profilers) as the ``kernels`` of the CPU ops that launched it
    events = prof.events()
    dev_events = [(e.name, e.time_range.elapsed_us()) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        dev_events = [(k.name, k.duration) for e in events for k in e.kernels]
    if not dev_events:
        raise RuntimeError("the profiler recorded no device activity")
    by_family = defaultdict(float)
    for name, us in dev_events:
        fam = next((f for f, keys in FAMILIES if any(k in name for k in keys)), "other")
        by_family[fam] += us
    busy_us = sum(by_family.values())
    busy_ms = busy_us / 1e3 / n
    log(f"[trace] wall {wall_ms:.3f} ms/request, device busy {busy_ms:.3f} ms/request, "
        f"idle share {1 - busy_ms / wall_ms:.3f} ({n} requests, profiler on)")
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        log(f"[trace]   {fam:20s} {us / 1e3 / n:9.3f} ms/request "
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

    def launches():
        return {**wk.LAUNCHES, **oc.LAUNCHES}

    def reset_launches():
        wk.reset_launches()
        oc.reset_launches()

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
        rows[name] = dict(name=name, route="cuda", source=SOURCE[name],
                          replaces=TPU_KERNEL[name], max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
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
    log(f"[done] {time.time() - t_start:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": [rows[k] for k in ALL_KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
