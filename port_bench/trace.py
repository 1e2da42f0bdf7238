"""The traced window: ``torch.profiler`` over a run of requests, reduced to
what the per-layer readers take (the reduction of the port's
``pbnet_torch/bench.py`` ``trace_requests``, copied so the yardstick stays
fixed).

* device intervals: the CUDA-type events (Kineto), or the kernels of the
  CPU ops that launched them (older profilers); ranges annotated on the
  device's track are left out;
* busy: the union of the device intervals; idle gaps: the holes in that
  union inside the window, each named by the deepest host op that was
  running at its middle;
* families: device seconds by kernel-name fragment (:data:`FAMILIES`);
* backward: device seconds of kernels launched under the autograd engine.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

# kernel-name fragments -> family, first match wins
FAMILIES = (
    ("clustering kernels", ("neighbor_pack", "masked_window", "window_1nn")),
    ("banded conv kernel", ("onehot_conv", "to_bf16_kernel", "split_sum_kernel")),
    ("nccl", ("nccl", "NCCL")),
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
    ("multi-tensor (optimizer, norms)", ("multi_tensor_apply",)),
)
TOP = 10


def family(name: str) -> str:
    return next((f for f, keys in FAMILIES if any(k in name for k in keys)), "other")


def _in_backward(event) -> bool:
    while event is not None:
        if event.name.startswith("autograd::engine::evaluate_function"):
            return True
        event = event.cpu_parent
    return False


def traced(run, n: int, finish=None) -> dict:
    """Profile ``run(i)`` for i < n, one after another, then ``finish()``
    (what ``run`` left in flight), and reduce the trace.
    Returns ``{"window_s", "busy_s", "by_family_s", "backward_s",
    "device_ops", "idle_gaps"}`` (seconds over the whole traced window)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        if finish is not None:
            finish()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    linked = [(k.name, k.duration, e) for e in cpu for k in e.kernels]
    if not dev and not linked:
        raise RuntimeError("the profiler recorded no device activity")
    by_family = defaultdict(float)
    by_op = defaultdict(float)
    if dev:
        for name, s, e in dev:
            by_family[family(name)] += (e - s) * 1e-6
            by_op[name] += (e - s) * 1e-6
        union, gaps, reach = 0.0, [], None
        for _, s, e in sorted(dev, key=lambda d: d[1]):
            if reach is not None and s > reach:
                gaps.append((reach, s))
            union += max(0.0, e - max(s, reach if reach is not None else s))
            reach = e if reach is None else max(reach, e)
        busy_s = union * 1e-6
    else:
        for name, us, _ in linked:
            by_family[family(name)] += us * 1e-6
            by_op[name] += us * 1e-6
        busy_s, gaps = sum(by_family.values()), []
    backward_s = sum(us for _, us, e in linked if _in_backward(e)) * 1e-6

    # name each idle gap by the deepest host op running at its middle
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu),
                   key=lambda s: s[0])
    starts = [s[0] for s in spans]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        name = "host (no op recorded)"
        j = bisect.bisect_right(starts, mid) - 1
        # the latest-started op that still runs at ``mid`` is the deepest
        for s, e, nm in reversed(spans[max(0, j - 64):j + 1]):
            if e >= mid:
                name = nm
                break
        idle[name] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": window_s, "busy_s": busy_s, "by_family_s": dict(by_family),
            "backward_s": backward_s, "device_ops": top(by_op), "idle_gaps": top(idle)}
