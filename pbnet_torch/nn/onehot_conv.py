"""Banded sparse convolution: plans, CUDA kernel and plain version (port of
pbnet_tpu/nn/onehot_conv.py).

Within one (dx, dy) kernel-offset group, the input rows read by TM
consecutive output rows of a key-sorted level span a narrow band of the
input.  A plan records, per output tile of TM rows and per group, the band
start (16-aligned) and, per (row, slot), the entry's offset inside the band
(``rel``; ``span`` marks an absent entry).  Entries that fall outside their
band are DROPPED and counted in ``overflow``: the caller surfaces the count
(``overflow_band`` / ``conv_band``) and sizes the span.

The conv then reads each present slot's row straight from its band, so no
img2col tensor is written: ``y[r] = sum_s bf16(feats[start_g + rel]) @
bf16(W[s])`` accumulated in f32, 0 where ``valid_out`` is false.

* ``onehot_conv`` launches the CUDA kernel ``csrc/onehot_conv.cu`` for CUDA
  tensors (or raises) and runs ``onehot_conv_plain`` for CPU tensors.
  ``tiling`` picks the kernel's launch shape (block height, slot split)
  from the conv's shape.
* ``onehot_conv_plain`` computes the same function in plain PyTorch from
  ``(starts, rel)`` alone, never from the raw map, so dropped entries drop.

The TPU kernel's formulation (band DMAs into VMEM, the one-hot matrix
product that performs the gather on the MXU, ``Cin`` padded to 128 lanes)
is not carried over: a one-hot row times the band is exactly that band row,
which the kernel reads directly.

``LAUNCHES["onehot_conv"]`` counts kernel launches (plain calls do not).
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from .. import _build, telemetry

# Below this many input channels the conv keeps the gather path (the JAX
# package's gate, which the port keeps so both run the same convs banded).
MIN_CIN = 64

# kernel slots one block walks (the kernel keeps them in a 32-bit mask)
MAX_SLOTS = 32

LAUNCHES = {"onehot_conv": 0}
# the Tiling of the wrapper's last launch (None before the first)
LAST_TILING = {"onehot_conv": None}

_SOURCE = "onehot_conv"
_lib = None


def reset_launches() -> None:
    LAUNCHES["onehot_conv"] = 0


@dataclass
class OnehotPlan:
    """Per-map banding plan (see :func:`build_onehot_plan`)."""

    starts: torch.Tensor  # (n_tiles, G) int32 band start row, 16-aligned
    rel: torch.Tensor  # (n_tiles, TM, K) int32 in-band offset; span = absent
    overflow: torch.Tensor  # () int32 present entries outside their band
    span: int
    kz: int
    m_in: int

    def replace(self, **kw) -> "OnehotPlan":
        return dataclasses.replace(self, **kw)


def build_onehot_plan(kmap: torch.Tensor, kz: int, m_in: int, tm: int = 256,
                      span: int = 768) -> OnehotPlan | None:
    """Band each (dx, dy) offset group of ``kmap`` into per-tile windows.

    kmap (M_out, K) int32 (-1 = missing), K = G * kz with dz fastest;
    ``m_in`` is the input level's row count.  None when the map cannot be
    tiled: M_out not a multiple of ``tm``, the input shorter than one band,
    or K not a multiple of ``kz``.
    """
    m_out, K = kmap.shape
    if m_out % tm != 0 or m_in < span or K % kz != 0:
        return None
    nt = m_out // tm
    G = K // kz
    km4 = kmap.reshape(nt, tm, G, kz)
    pres = km4 >= 0
    big = 2**30
    mins = torch.where(pres, km4, big).amin(dim=(1, 3))  # (nt, G)
    start = torch.where(mins < big, mins, 0)
    start = torch.div(start, 16, rounding_mode="floor") * 16
    # clip to an aligned upper bound: m_in - span is 16-aligned only when
    # span is, and every start is promised 16-aligned
    start = torch.clamp(start, 0, ((m_in - span) // 16) * 16)
    rel = km4 - start[:, None, :, None]
    ok = pres & (rel >= 0) & (rel < span)
    overflow = (pres & ~ok).sum(dtype=torch.int32)
    rel = torch.where(ok, rel, span).to(torch.int32).reshape(nt, tm, K)
    return OnehotPlan(starts=start.to(torch.int32), rel=rel, overflow=overflow,
                      span=span, kz=kz, m_in=m_in)


def reverse_plan(plan: OnehotPlan | None) -> OnehotPlan | None:
    """Plan of the column-reversed map (``kmap[:, ::-1]``): reversal
    permutes groups and slots, so the banding is the reversed banding."""
    if plan is None:
        return None
    return plan.replace(starts=plan.starts.flip(1), rel=plan.rel.flip(2))


def attach_plans(topo, tm: int, spans):
    """The topology with banding plans for its k3/down/up maps and their
    summed ``plan_overflow``.

    ``spans[l]`` is the k3 band span at level l (0 disables the level).  Down
    maps read the finer level and get ``2 * spans[l]``; up maps read the
    coarser level and get ``2 * spans[l + 1]``.  A map that cannot be tiled
    quietly gets None.
    """
    caps = [lv.hi.shape[0] for lv in topo.levels]
    spans = list(spans) + [0] * (len(topo.levels) - len(spans))
    ovf = topo.plan_overflow

    def mk(kmap, kz, m_in, span):
        nonlocal ovf
        if not span:
            return None
        p = build_onehot_plan(kmap, kz, m_in, tm=tm, span=span)
        if p is not None:
            ovf = ovf + p.overflow
        return p

    k3 = tuple(mk(km, 3, caps[l], spans[l]) for l, km in enumerate(topo.k3_maps))
    down = tuple(mk(km, 2, caps[l], 2 * spans[l]) for l, km in enumerate(topo.down_maps))
    up = tuple(mk(km, 2, caps[l + 1], 2 * spans[l + 1]) for l, km in enumerate(topo.up_maps))
    return topo.replace(k3_plans=k3, down_plans=down, up_plans=up, plan_overflow=ovf)


def plan_map(plan: OnehotPlan) -> torch.Tensor:
    """The (M_out, K) map the plan keeps: ``start_g + rel`` for in-band
    entries, -1 for absent and dropped ones."""
    nt, tm, K = plan.rel.shape
    g_of_slot = torch.arange(K, device=plan.rel.device) // plan.kz
    abs_row = plan.starts[:, None, g_of_slot] + plan.rel
    return torch.where(plan.rel < plan.span, abs_row, -1).reshape(nt * tm, K)


def onehot_conv_plain(feats, plan: OnehotPlan, weights, valid_out,
                      compute_dtype=torch.bfloat16):
    """The banded conv in plain PyTorch.  feats (M_in, Cin); weights (K,
    Cin, Cout); returns (M_out, Cout) f32.  Operands are rounded to
    ``compute_dtype`` and multiplied in f32."""
    from .sparse_ops import take_rows0

    kmap = plan_map(plan)
    k, cin, cout = weights.shape
    telemetry.count("conv.executed_ops", 2 * kmap.shape[0] * k * cin * cout)
    g = take_rows0(feats.to(compute_dtype), kmap).reshape(kmap.shape[0], k * cin)
    w = weights.to(compute_dtype).reshape(k * cin, cout)
    y = torch.matmul(g.float(), w.float())
    return torch.where(valid_out[:, None], y, 0.0)


@dataclass(frozen=True)
class Tiling:
    """Launch shape of the CUDA kernel (see ``csrc/onehot_conv.cu``)."""

    bm: int  # output rows per block: 128 (8 warps) or 64 (4 warps)
    bn: int  # output columns per block: cout rounded up to 32, at most 128
    strips: int  # column strips (cout > 128 only)
    slots: int  # kernel slots per block
    nsplit: int  # blocks that share one row block's slots (grid z)
    cin_p: int  # input channels rounded up to 32 (the kernel's step)
    blocks: int


def tiling(m_out: int, K: int, cin: int, cout: int, sms: int) -> Tiling:
    """The kernel's launch shape for an (m_out, K, cin, cout) conv on a card
    with ``sms`` SMs: 128-row blocks when that launches at least two blocks
    per SM, else 64-row blocks; while that is still fewer, the slots split
    across blocks (at most MAX_SLOTS slots per block either way)."""
    bn = min(128, -(-cout // 32) * 32)
    strips = -(-cout // bn)
    target = 2 * sms
    bm = 128 if -(-m_out // 128) * strips >= target else 64
    base = -(-m_out // bm) * strips
    nsplit = max(-(-K // MAX_SLOTS), min(K, -(-target // base)))
    slots = -(-K // nsplit)
    nsplit = -(-K // slots)
    return Tiling(bm=bm, bn=bn, strips=strips, slots=slots, nsplit=nsplit,
                  cin_p=-(-cin // 32) * 32, blocks=base * nsplit)


def _library():
    """The kernel library, built and bound on first use."""
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pbnet_onehot_conv.argtypes = [P] * 9 + [I] * 13 + [P]
        lib.pbnet_onehot_conv.restype = ctypes.c_int
        _lib = lib
    return _lib


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def onehot_conv(feats, plan: OnehotPlan, weights, valid_out,
                compute_dtype=torch.bfloat16):
    """See :func:`onehot_conv_plain`; CUDA tensors run the kernel, which
    takes f32 features and weights and rounds both to bf16 itself (one pass
    per call, into scratch)."""
    if feats.device.type == "cpu":
        return onehot_conv_plain(feats, plan, weights, valid_out, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"onehot_conv: the kernel computes in bf16, not {compute_dtype}")
    nt, tm, K = plan.rel.shape
    kk, cin, cout = weights.shape
    m_out = nt * tm
    if kk != K or K % plan.kz:
        raise ValueError(f"onehot_conv: {kk} weight slots for a {K}-slot plan (kz {plan.kz})")
    dev = feats.device
    check, ptr = _build.check, _build.ptr
    check("feats", feats, torch.float32, (plan.m_in, cin), dev)
    check("weights", weights, torch.float32, (K, cin, cout), dev)
    check("valid_out", valid_out, torch.bool, (m_out,), dev)
    check("starts", plan.starts, torch.int32, (nt, K // plan.kz), dev)
    check("rel", plan.rel, torch.int32, (nt, tm, K), dev)
    t = tiling(m_out, K, cin, cout, _sm_count(dev))
    w_pitch = t.strips * t.bn
    # what the blocks may walk: every row and slot at the padded widths (a
    # warp that skips a slot none of its rows uses is not seen on the host)
    telemetry.count("conv.executed_ops", 2 * m_out * K * t.cin_p * w_pitch)
    out = torch.empty((m_out, cout), dtype=torch.float32, device=dev)
    feats_bf = torch.empty((plan.m_in, t.cin_p), dtype=torch.bfloat16, device=dev)
    w_bf = torch.empty((K, t.cin_p, w_pitch), dtype=torch.bfloat16, device=dev)
    part = (torch.empty((t.nsplit, m_out, cout), dtype=torch.float32, device=dev)
            if t.nsplit > 1 else out)
    _build.launch(LAUNCHES, "onehot_conv", _library().pbnet_onehot_conv,
                  ptr(feats), ptr(weights), ptr(plan.starts), ptr(plan.rel), ptr(valid_out),
                  ptr(out), ptr(feats_bf), ptr(w_bf), ptr(part), plan.m_in, cin, t.cin_p,
                  cout, w_pitch, K, plan.kz, tm, m_out, plan.span, t.bm, t.bn, t.slots)
    LAST_TILING["onehot_conv"] = t
    return out
