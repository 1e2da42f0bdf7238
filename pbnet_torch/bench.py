"""Single-card inference benchmark of the port (the counterpart of the JAX
package's ``bench.py``, which stays that package's)::

    python -m pbnet_torch.bench [--device cuda|cpu] [--config gather|banded]

The request is the three-stage forward on the bench scene
(``synthetic.bench_request``, seed 0: 140,000 points, 92,403 voxels) with
the MinkUNet34C / 14A / 34C trio at full width and seeded random weights.
Stages 2-3 are driven by the oracle semantics, offsets and softmax
(``synthetic.oracle_stage1``), as the JAX bench drives them, so clustering
runs at its real round count and the request makes real clusters and
proposals.  ``--config gather`` (the default) runs ``BENCH_SHAPES``, the
JAX bench's caps; ``banded`` runs ``BANDED_SHAPES`` (the banded conv on).

Headline: 2 warm-up requests (the first builds the CUDA kernels at first
use; the build's seconds are reported apart), then 10 timed requests, one at
a time.  A request's time is the host clock from its start to after the
``torch.cuda.synchronize()`` that follows reading the cluster and proposal
counts and the overflow counters on the host; CUDA events split it into
stage 1 (``PBNet.backbone``) and stages 2-3 (``instance_stage``).  Each
timed request gets one ``bench-request {json}`` line on stderr with its
times and its kernel launches (``ops/window_kernels.LAUNCHES`` and
``nn/onehot_conv.LAUNCHES``, zeroed just before it).  Clusters > 0,
proposals > 0 and zero overflow are required; anything else raises.

stdout holds one line, the headline in the JAX bench's schema plus the
card::

    {"metric": "inference_scenes_per_sec", "value": 1 / median, "unit":
     "scenes/s", "vs_baseline": value / 2.5, "device": ..., "power_limit": ...}

After it, the supplementary phases (a failure raises, after the headline):

* production extent: the same request with ``grid_extent=(1, 512, 512,
  256)``, which in the port only selects the stage-2/3 topology branch; its
  latency, and its cluster and proposal ids against the headline's;
* device busy: ``torch.profiler`` over 3 requests; busy is the union of the
  CUDA kernels' intervals, idle share = 1 - busy / median headline wall;
* work: one counting request under ``tools.work.WorkCount``: the useful
  operations from the present kernel-map entries and the GEMMs' executed
  operations, by stage (stage 3's follow the kept points); ``mfu`` =
  useful / median wall / the card's dense bf16 peak (the conv operands are
  bf16), ``mfu_f32`` = the same against the f32 peak outside the tensor
  cores (the products run in f32); the executed operations over the GEMM
  family's device time; stage 1's share;
* train step: the full step (with instances and labels, Adam at lr 1e-3)
  through ``parallel/train_step.make_train_step``, 1 warm-up and 3 timed
  steps, and its peak device memory.

They end with one ``bench-supplementary {json}`` line on stderr.

``--device cpu`` runs the plain PyTorch path (at these shapes it takes tens
of GiB of host memory): it prints the work count and host times but no
rate and no device metric (the headline's ``value`` is null).  Without a
card and without ``--device cpu`` the script raises.  TF32 is off for
matmuls and cuDNN: the f32 peak assumes it.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from . import _build, resolve_device, synthetic
from .config import Config
from .models.pbnet import PBNet, batch_to_device
from .nn import onehot_conv
from .ops import window_kernels
from .parallel import train_step
from .tools import work

# the reference publishes no throughput; the JAX bench assumes 2.5 scenes/s
# for the full pipeline on an RTX 3090 (bench.py's docstring)
ASSUMED_3090_SCENES_PER_SEC = 2.5
CONFIGS = {"gather": synthetic.BENCH_SHAPES, "banded": synthetic.BANDED_SHAPES}
PRODUCTION_EXTENT = (1, 512, 512, 256)
WARMUP, TIMED, PRODUCTION_TIMED, TRACED, TRAIN_TIMED = 2, 10, 5, 3, 3


@dataclass(frozen=True)
class Peaks:
    """A card's published peak rates and the power limit they assume."""

    bf16_flops: float  # dense tensor-core bf16, operations per second
    f32_flops: float  # f32 outside the tensor cores
    hbm_bytes: float  # bytes per second
    watts: float


# NVIDIA's H100 SXM data sheet (dense rates, no sparsity), at 700 W; keyed
# by a fragment of the name CUDA reports for that part
PEAKS = {"H100 80GB HBM3": Peaks(989e12, 67e12, 3.35e12, 700.0)}

# kernel-name fragments -> family for the trace, first match wins
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


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_peaks(name: str) -> Peaks:
    """The peak rates of the card called ``name``; raises for a card the
    table does not hold."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise KeyError(f"no peak rates for device {name!r}; add its data sheet's to bench.PEAKS")


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def reset_launches() -> None:
    window_kernels.reset_launches()
    onehot_conv.reset_launches()


def launches() -> dict:
    return {**window_kernels.LAUNCHES, **onehot_conv.LAUNCHES}


def request(model: PBNet, batch: dict, oracle, split=None):
    """One bench request: stage 1 (``PBNet.backbone``), the oracle's
    semantics, offsets and softmax in place of stage 1's predictions
    (``bench.py:237-244``), then stages 2-3 (``instance_stage``).  ``split``,
    when given, is called between the two (a CUDA event's ``record``).  Returns (stage-1 output, stages 2-3 output)."""
    sem_o, offs_o, soft_o = oracle
    bb = model.backbone(batch)
    if split is not None:
        split()
    bb = dict(bb, sem_pred_p=sem_o, offset_pred_p=offs_o, sem_soft_p=soft_o)
    return bb, model.instance_stage(batch, bb, with_labels=False)


def outcome(bb: dict, out: dict) -> tuple[int, int, int]:
    """(clusters, proposals, total overflow) of a request, read on the host
    in one copy."""
    dev = out["num_final_proposals"].device

    def i64(v):
        return torch.as_tensor(v, device=dev).to(torch.int64).reshape(())

    over = [bb["overflow_vox"], bb["overflow_grid"], bb["overflow_band"],
            *out["overflow"].values()]
    ncl, nprop, ov = torch.stack([i64(out["cluster"].num_clusters),
                                  i64(out["num_final_proposals"]),
                                  torch.stack([i64(v) for v in over]).sum()]).tolist()
    return ncl, nprop, ov


def timed_requests(run, n: int, cuda: bool, tag: str) -> list[dict]:
    """``n`` requests ``run(split) -> (bb, out)``, one at a time; one
    stderr line each (``{tag} {json}``).  Raises unless every request makes
    clusters and proposals with zero overflow.  Returns the rows; the last
    also holds its request's output (``out``)."""
    rows = []
    for i in range(n):
        reset_launches()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else None
        t0 = time.perf_counter()
        if cuda:
            ev[0].record()
        bb, out = run(ev[1].record if cuda else None)
        if cuda:
            ev[2].record()
        ncl, nprop, ov = outcome(bb, out)
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        row = dict(request=i, wall_ms=wall_ms,
                   stage1_ms=ev[0].elapsed_time(ev[1]) if cuda else None,
                   stages23_ms=ev[1].elapsed_time(ev[2]) if cuda else None,
                   clusters=ncl, proposals=nprop, overflow=ov, launches=launches())
        log(f"{tag} {json.dumps(row)}")
        if ncl <= 0 or nprop <= 0:
            raise RuntimeError(f"{tag} {i}: {ncl} clusters, {nprop} proposals; the timed "
                               f"request must do real instance work")
        if ov:
            raise RuntimeError(f"{tag} {i}: capacity overflow {ov} on bench content")
        rows.append(row)
    rows[-1]["out"] = out
    return rows


def family(name: str) -> str:
    return next((f for f, keys in FAMILIES if any(k in name for k in keys)), "other")


def in_backward(event) -> bool:
    """Whether a CPU op ran inside the autograd engine's backward."""
    while event is not None:
        if event.name.startswith("autograd::engine::evaluate_function"):
            return True
        event = event.cpu_parent
    return False


def trace_requests(request, n, tag="trace", split_backward=False, log=log) -> dict:
    """Profile ``n`` requests: wall and device-busy ms per request, the
    device's idle share, and device time per request by kernel family.
    With ``split_backward`` the gathers and GEMMs that the backward launched
    (kernels of CPU ops under the autograd engine) are families of their
    own.  Busy is the union of the device intervals.  Returns
    ``{"wall_ms", "busy_ms", "idle_share", "by_family_ms"}`` (per request,
    profiler on)."""
    from collections import defaultdict

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
    dev_events = [(e.name, e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    linked = [(k.name, k.duration, e) for e in events
              if e.device_type == torch.autograd.DeviceType.CPU for k in e.kernels]
    if dev_events:
        by_family = defaultdict(float)
        for name, start, end in dev_events:
            by_family[family(name)] += end - start
        # the union of the intervals (kernels on two streams may overlap)
        union_us, reach = 0.0, float("-inf")
        for _, start, end in sorted(dev_events, key=lambda e: e[1]):
            union_us += max(0.0, end - max(start, reach))
            reach = max(reach, end)
    elif linked:  # durations only: their sum stands in for the union
        by_family = defaultdict(float)
        for name, us, _ in linked:
            by_family[family(name)] += us
        union_us = sum(by_family.values())
    else:
        raise RuntimeError("the profiler recorded no device activity")
    total_us = sum(by_family.values())
    busy_ms = union_us / 1e3 / n
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
        log(f"[{tag}] backward: {bwd_us / 1e3 / n:.3f} ms/step ({bwd_us / total_us:.1%} of "
            f"device time; {sum(us for _, us, _ in linked) / total_us:.1%} of device time "
            f"linked to a CPU op)")
    log(f"[{tag}] wall {wall_ms:.3f} ms/request, device busy {busy_ms:.3f} ms/request, "
        f"idle share {1 - busy_ms / wall_ms:.3f} ({n} requests, profiler on)")
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        log(f"[{tag}]   {fam:20s} {us / 1e3 / n:9.3f} ms/request "
            f"({us / total_us:6.1%} of device time)")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "by_family_ms": {f: us / 1e3 / n for f, us in by_family.items()}}


STAGE_OF = (("MEUnet", "stage 1"), ("D_Unet", "stage 2"), ("score_Unet", "stage 3"))


def count_work(model: PBNet, batch: dict, oracle) -> tuple[work.WorkCount, dict]:
    """One counting request (never a timed one): every conv's and dense
    layer's operations, labelled by the stage whose UNet ran last (its
    heads follow it).  Returns the count and the request's stages 2-3
    output."""
    with work.WorkCount() as wc:
        hooks = [getattr(model, name).register_forward_pre_hook(
            lambda *_, s=stage: setattr(wc, "stage", s)) for name, stage in STAGE_OF]
        try:
            _, out = request(model, batch, oracle)
        finally:
            for h in hooks:
                h.remove()
    return wc, out


def same_ids(a: dict, b: dict) -> bool:
    """Whether two requests' cluster and proposal ids are equal."""
    return (torch.equal(a["cluster"].cluster_id, b["cluster"].cluster_id)
            and all(torch.equal(a[k], b[k])
                    for k in ("scene_pid", "prop_point_pid", "num_final_proposals")))


def train_phase(shapes, dev, cuda: bool) -> dict:
    """The full train step on the bench scene: 1 warm-up and
    ``TRAIN_TIMED`` timed steps (host clock to after reading the loss and
    the gradient norm and a synchronize) and the peak device memory."""
    nb, _ = synthetic.bench_train_batch(0, shapes)
    batch = batch_to_device(nb, dev)
    cfg = Config(shapes=shapes, optimizer="Adam", lr=1e-3)
    model = PBNet(shapes, seed=0, device=dev)
    step = train_step.make_train_step(model, train_step.make_optimizer(model, cfg), cfg,
                                      with_instances=True)
    ms, peak = [], None
    for i in range(1 + TRAIN_TIMED):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        aux = step(batch, cfg.lr)
        loss, grad_norm = torch.stack([aux["loss"], aux["grad_norm"]]).tolist()
        if cuda:
            torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if not (torch.isfinite(torch.tensor([loss, grad_norm])).all() and grad_norm > 0):
            raise RuntimeError(f"train step {i}: loss {loss}, gradient norm {grad_norm}")
        if i:
            ms.append(dt)
            if cuda:
                peak = max(peak or 0.0, torch.cuda.max_memory_allocated() / 2**30)
        over = {k: int(v) for k, v in aux.items() if k.startswith("overflow") and int(v)}
        log(f"[bench-train] step {i}: {dt:.1f} ms, loss {loss:.5f}, gradient norm "
            f"{grad_norm:.5f}, overflow {over}")
    return {"ms": ms, "median_ms": statistics.median(ms), "peak_gib": peak}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pbnet_torch.bench", description=__doc__.split(
        "\n\n")[0], formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' for tests at small shapes)")
    p.add_argument("--config", choices=sorted(CONFIGS), default="gather")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    shapes = CONFIGS[args.config]
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        name = torch.cuda.get_device_name(0)
        power = card_line().rsplit(",", 1)[1].strip()
        peaks = device_peaks(name)
    else:
        name, power, peaks = "cpu", None, None
    log(f"[bench] {args.config} on {name} ({power}); torch {torch.__version__}")

    batch, oracle, n_points = synthetic.bench_request(dev, 0, shapes)
    model = PBNet(shapes, seed=0, device=dev)
    log(f"[bench] scene: {n_points} points, {int(batch['vox_valid'].sum())} voxels")

    def run(split, m=model):
        return request(m, batch, oracle, split)

    t0 = time.perf_counter()
    timed_requests(run, WARMUP, cuda, "bench-warmup")
    build_s = {k: secs for k, (_, secs) in _build.BUILD_LOG.items()}
    log(f"[bench] warm-up: {WARMUP} requests {time.perf_counter() - t0:.2f} s, of which "
        f"kernel builds {build_s or 'none (already built)'}")
    rows = timed_requests(run, TIMED, cuda, "bench-request")
    wall = [r["wall_ms"] for r in rows]
    median_ms = statistics.median(wall)
    value = 1e3 / median_ms if cuda else None
    log(f"[bench] {TIMED} requests: ms {[round(t, 3) for t in wall]}; median {median_ms:.3f}")
    print(json.dumps({
        "metric": "inference_scenes_per_sec",
        "value": value,
        "unit": "scenes/s",
        "vs_baseline": value / ASSUMED_3090_SCENES_PER_SEC if cuda else None,
        "device": name,
        "power_limit": power,
    }), flush=True)

    # ---- supplementary phases (after the headline; a failure raises) ----
    head_out = rows[-1]["out"]
    res = {"config": args.config, "device": name, "power_limit": power,
           "peaks": dataclasses.asdict(peaks) if peaks else None, "build_s": build_s,
           "headline": {"ms": wall, "median_ms": median_ms,
                        "stage1_ms": [r["stage1_ms"] for r in rows],
                        "stages23_ms": [r["stages23_ms"] for r in rows],
                        "clusters": rows[-1]["clusters"], "proposals": rows[-1]["proposals"],
                        "overflow": rows[-1]["overflow"], "launches": rows[-1]["launches"]}}
    del rows

    prod = PBNet(dataclasses.replace(shapes, grid_extent=PRODUCTION_EXTENT), device=dev)
    prod.load_state_dict(model.state_dict())
    prows = timed_requests(lambda split: run(split, prod), 1 + PRODUCTION_TIMED, cuda,
                           "bench-production")[1:]
    ids_equal = same_ids(prows[-1]["out"], head_out)
    res["production_extent"] = {"grid_extent": PRODUCTION_EXTENT,
                                "ms": [r["wall_ms"] for r in prows],
                                "median_ms": statistics.median(r["wall_ms"] for r in prows),
                                "ids_equal_headline": ids_equal}
    log(f"[bench] production extent {PRODUCTION_EXTENT}: median "
        f"{res['production_extent']['median_ms']:.3f} ms; ids equal the headline's: {ids_equal}")
    if not ids_equal:
        raise RuntimeError("the production extent's cluster or proposal ids differ from "
                           "the headline's")
    del prod, prows

    if cuda:
        tr = trace_requests(lambda: run(None), TRACED, tag="bench-trace")
        tr["idle_share"] = 1 - tr["busy_ms"] / median_ms  # against the unprofiled median
        res["trace"] = tr

    wc, out = count_work(model, batch, oracle)
    w = wc.summary()
    w["stage1_useful_share"] = w["useful_ops_by_stage"]["stage 1"] / w["useful_ops"]
    w["usage"] = {k: int(v) for k, v in out["usage"].items()}
    # the ScoreNet's voxels follow the kept flags: two runs with the same
    # digest count the same stage 3
    w["kept_digest"] = hashlib.sha256(
        out["prop_point_kept"].cpu().numpy().tobytes()).hexdigest()[:16]
    del out
    if cuda:
        gemm_ms = res["trace"]["by_family_ms"].get("gemm", 0.0)
        w.update(mfu=w["useful_ops"] / (median_ms * 1e-3) / peaks.bf16_flops,
                 mfu_f32=w["useful_ops"] / (median_ms * 1e-3) / peaks.f32_flops,
                 gemm_device_ms=gemm_ms,
                 executed_flops_per_s=w["executed_ops"] / (gemm_ms * 1e-3) if gemm_ms else None)
    res["work"] = w
    log(f"[bench] work of one request: {json.dumps(w)}; peaks {res['peaks']} at "
        f"{peaks.watts if peaks else None} W, card power limit {power}")

    del model
    if cuda:
        torch.cuda.empty_cache()
    res["train_step"] = train_phase(shapes, dev, cuda)
    log(f"bench-supplementary {json.dumps(res)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
