"""Functional sparse-tensor ops (port of pbnet_tpu/nn/sparse_ops.py).

A kernel map (core/topology.py) turns a sparse convolution into one row
gather and one GEMM ``(M, K*Cin) @ (K*Cin, Cout)``: each (output voxel,
offset) pair has at most one input voxel, so nothing is scattered.  The JAX
package leaves this product to XLA; the port's plain version leaves it to
``torch.matmul``.

The backward is a gather-GEMM too (``_GatherConv``): every kernel map's
transpose is another kernel map of the same topology, so the gradient
gathers ``dy`` through it instead of scatter-adding into ``feats``.

On the card a forward that autograd does not record (evaluation) is one
hand-written kernel (``gather_gemm``, ``csrc/gather_gemm.cu``): it gathers
the rows through the map into shared memory and multiplies them on the bf16
tensor cores, so no img2col buffer reaches device memory.  ``_conv_fwd`` is
its plain version, and for now the forward of a training step (see
``gather_conv``).
``LAUNCHES["gather_gemm"]`` counts the kernel's launches, and while tracing
the telemetry counter ``gather_gemm`` does too; ``conv.gather_plain``
counts the plain forwards.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import _build, telemetry
from ..tools import work
from . import onehot_conv

# Conv operand dtype: operands are rounded to this type and the product is
# accumulated in f32 (bf16 by default, as in the JAX package).  Set to
# torch.float32 for strict-parity comparisons.
COMPUTE_DTYPE = torch.bfloat16


def take_rows0(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather where ``-1`` (missing) reads a zero row.  Plain indexing
    would wrap -1 to the LAST row — real data whenever a level is full."""
    zero = torch.zeros((1,) + tbl.shape[1:], dtype=tbl.dtype, device=tbl.device)
    ext = torch.cat([tbl, zero], 0)
    safe = torch.where(idx >= 0, idx, tbl.shape[0]).to(torch.int64)
    return ext[safe]


def _conv_fwd(feats, kmap, weights, valid_out, bias=None):
    """The gather conv in plain PyTorch: an (M, K*Cin) img2col gather and
    one GEMM, then the mask and the bias (``conv_epilogue``)."""
    k, cin, cout = weights.shape
    telemetry.count("conv.gather_plain")
    # every (row, column) entry of the map is multiplied: padded rows and
    # absent entries (zero rows) included
    telemetry.count("conv.executed_ops", 2 * kmap.shape[0] * k * cin * cout)
    g = take_rows0(feats.to(COMPUTE_DTYPE), kmap).reshape(kmap.shape[0], k * cin)
    w = weights.to(COMPUTE_DTYPE).reshape(k * cin, cout)
    return conv_epilogue(torch.matmul(g.float(), w.float()), valid_out, bias)


def conv_epilogue(y, valid_out, bias=None):
    """``y + bias`` where ``valid_out``, else 0, in one step: what the
    kernel's epilogue does to its f32 sums, and bit for bit the mask
    followed by ``gather_conv``'s masked bias add."""
    return torch.where(valid_out[:, None], y if bias is None else y + bias, 0.0)


# ---------------------------------------------------------------------------
# the fused gather-GEMM kernel (csrc/gather_gemm.cu)
# ---------------------------------------------------------------------------
LAUNCHES = {"gather_gemm": 0}
GEMM_KC = 32  # reduction depth of one pipeline step (KC in the source)
GEMM_STAGES = 4  # cp.async ring depth (STAGES in the source)
SMEM_PER_BLOCK = 232_448  # what one block may use on an H100
_SOURCE = "gather_gemm"
_lib = None


def reset_launches() -> None:
    LAUNCHES["gather_gemm"] = 0


@dataclass(frozen=True)
class GemmTiling:
    """Launch shape of the gather-GEMM kernel (see ``csrc/gather_gemm.cu``)."""

    k: int  # map offsets
    bm: int  # output rows per block: 128 (8 warps), 64 (4 warps) where K > 32
    bn: int  # output columns per block: cout rounded up to 32, at most 128
    strips: int  # column strips (cout > 128)
    cin_p: int  # input channels rounded up to 8 (16-byte bf16 rows)
    depth: int  # K * cin_p rounded up to GEMM_KC, the zero-padded reduction

    @property
    def w_pitch(self) -> int:
        return self.strips * self.bn

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block (the source's formula): the
        ring of A (80-byte rows) and B tiles, and the block's map rows at a
        pitch of K | 1 words."""
        ring = GEMM_STAGES * (self.bm * (GEMM_KC + 8) + GEMM_KC * (self.bn + 8)) * 2
        return ring + self.bm * (self.k | 1) * 4


def gemm_tiling(K: int, cin: int, cout: int) -> GemmTiling:
    """The kernel's launch shape, a function of the conv's (K, Cin, Cout)
    alone: 128-row blocks, 64-row ones where the block's map rows (K ints
    each) would crowd the ring out of shared memory (the k=5 stem); column
    blocks of cout rounded up to 32, at most 128; rows padded to 8
    channels."""
    bn = min(128, -(-cout // 32) * 32)
    cin_p = -(-cin // 8) * 8
    return GemmTiling(k=K, bm=128 if K <= 32 else 64, bn=bn, strips=-(-cout // bn),
                      cin_p=cin_p, depth=-(-K * cin_p // GEMM_KC) * GEMM_KC)


def gemm_executed_ops(m_out: int, t: GemmTiling) -> int:
    """Operations the kernel executes: every row and every (offset, channel)
    of the padded depth times every padded column, absent entries
    included."""
    return 2 * m_out * t.depth * t.w_pitch


def gemm_error_bound(feats, kmap, weights):
    """Per output, the most that two summation orders of the conv's f32 sums
    can differ by: ``2 n 2^-24 sum_{k,c} |x||w|`` with ``n = K * Cin``,
    over the bf16-rounded operands (a product of two bf16 values is exact
    in f32, so only the order of the adds differs between the kernel and
    the plain version)."""
    k, cin, cout = weights.shape
    g = take_rows0(feats.to(torch.bfloat16).float().abs(), kmap).reshape(kmap.shape[0], k * cin)
    w = weights.to(torch.bfloat16).float().abs().reshape(k * cin, cout)
    return 2 * k * cin * 2.0**-24 * torch.matmul(g, w)


def _library():
    """The kernel library, built and bound on first use."""
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pbnet_gather_gemm.argtypes = [P] * 8 + [I] * 10 + [P]
        lib.pbnet_gather_gemm.restype = ctypes.c_int
        _lib = lib
    return _lib


def gather_gemm(feats, kmap, weights, valid_out, bias=None):
    """The gather conv's forward (see :func:`_conv_fwd`).  CUDA tensors run
    the fused kernel when ``COMPUTE_DTYPE`` is bf16, the precision it
    computes in; CPU tensors, and f32 operands (a strict-parity setting
    that the kernel does not compute), take the plain version.  The kernel
    takes f32 features and weights and rounds both to bf16 itself, once per
    call."""
    if feats.device.type == "cpu" or COMPUTE_DTYPE != torch.bfloat16:
        return _conv_fwd(feats, kmap, weights, valid_out, bias)
    m_out, K = kmap.shape
    m_in = feats.shape[0]
    _, cin, cout = weights.shape
    dev = feats.device
    check, ptr = _build.check, _build.ptr
    check("feats", feats, torch.float32, (m_in, cin), dev)
    check("weights", weights, torch.float32, (K, cin, cout), dev)
    check("kmap", kmap, torch.int32, (m_out, K), dev)
    check("valid_out", valid_out, torch.bool, (m_out,), dev)
    if bias is not None:
        check("bias", bias, torch.float32, (cout,), dev)
    out = torch.empty((m_out, cout), dtype=torch.float32, device=dev)
    if m_out == 0:
        return out
    t = gemm_tiling(K, cin, cout)
    if t.smem_bytes > SMEM_PER_BLOCK:
        raise ValueError(f"gather_gemm: a {K}-offset map needs {t.smem_bytes} bytes of "
                         f"shared memory per block, more than {SMEM_PER_BLOCK}")
    telemetry.count("conv.executed_ops", gemm_executed_ops(m_out, t))
    feats_bf = torch.empty((m_in, t.cin_p), dtype=torch.bfloat16, device=dev)
    w_bf = torch.empty((t.depth, t.w_pitch), dtype=torch.bfloat16, device=dev)
    _build.launch(LAUNCHES, "gather_gemm", _library().pbnet_gather_gemm,
                  ptr(feats), ptr(weights), ptr(kmap), ptr(valid_out),
                  None if bias is None else ptr(bias), ptr(out), ptr(feats_bf), ptr(w_bf),
                  m_in, m_out, K, cin, t.cin_p, cout, t.w_pitch, t.depth, t.bm, t.bn)
    return out


class _GatherConv(torch.autograd.Function):
    """The gather conv with the JAX package's hand-written VJP
    (``pbnet_tpu/nn/sparse_ops.py`` ``_gc_bwd``).  ``kmap_bwd[j, k]`` is the
    output row that reads input ``j`` at forward offset ``k``: the
    column-reversed map for a same-level conv, the up map of the same level
    pair for a strided conv, the down map for a transposed conv.

    Only the inputs are saved, never the (M, K*Cin) img2col buffer: the
    backward gathers ``dy`` instead, so a train step holds one conv's
    buffer at a time (the JAX package rematerialises its blocks for the same
    reason)."""

    @staticmethod
    def forward(ctx, feats, kmap, kmap_bwd, weights, valid_out):
        ctx.save_for_backward(feats, kmap_bwd, weights, valid_out)
        return _conv_fwd(feats, kmap, weights, valid_out)

    @staticmethod
    def backward(ctx, dy):
        feats, kmap_bwd, weights, valid_out = ctx.saved_tensors
        k, cin, cout = weights.shape
        dy = torch.where(valid_out[:, None], dy, 0.0).to(COMPUTE_DTYPE)
        # one gather serves both gradients: gy[j, k] = dy[output reading j at
        # forward offset k]
        gy = take_rows0(dy, kmap_bwd).reshape(kmap_bwd.shape[0], k * cout).float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx[j] = sum_k gy[j, k] @ W[k]^T
            wt = weights.to(COMPUTE_DTYPE).transpose(1, 2).reshape(k * cout, cin)
            dx = torch.matmul(gy, wt.float())
        if ctx.needs_input_grad[3]:
            # dW[k] = sum_i x[kmap[i, k]] dy[i] = sum_j x[j] gy[j, k]
            dw = torch.matmul(feats.to(COMPUTE_DTYPE).float().t(), gy)
            dw = dw.reshape(cin, k, cout).transpose(0, 1)
        return dx, None, None, dw, None


def gather_conv(feats: torch.Tensor, kmap: torch.Tensor, weights: torch.Tensor,
                valid_out: torch.Tensor, bias: torch.Tensor | None = None,
                kmap_bwd: torch.Tensor | None = None,
                plan: onehot_conv.OnehotPlan | None = None) -> torch.Tensor:
    """Sparse convolution as gather + GEMM.  Returns (M_out, Cout) f32.

    feats (M_in, Cin); kmap (M_out, K) int32 with -1 = missing input;
    weights (K, Cin, Cout); valid_out (M_out,) bool.  Operands are rounded
    to ``COMPUTE_DTYPE`` and multiplied in f32, which is exactly "bf16
    operands, f32 accumulation" (a product of two bf16 values is exact in
    f32).

    With gradients off the forward is :func:`gather_gemm` (on the card,
    the fused kernel).  With gradients on (a training step) it is, for now,
    the plain version: the training benchmark's same-precision check
    (``port_bench/train_cell.py``) holds a step to the plain GEMM's own
    summation order, and a step that adds the same products in another
    order flips mask-threshold and max-pool decisions that move whole
    gradient tensors.  The kernel takes the training forward once that
    check judges a step against a spread of summation orders.  With
    ``kmap_bwd`` (the transposed map, see ``_GatherConv``) the backward is
    a gather-GEMM; without it autograd differentiates the plain ops (a
    scatter-add into ``feats``), as in the JAX package.

    With a banding ``plan`` of this map and at least ``onehot_conv.MIN_CIN``
    input channels, the banded conv runs instead; it drops the entries the
    plan counts in its ``overflow``.  The banded conv has no backward, so a
    plan raises where a gradient is wanted (the models attach plans in eval
    mode only).

    Inside a ``tools.work.WorkCount`` the conv's present map entries are
    counted, on either route.
    """
    banded = plan is not None and feats.shape[1] >= onehot_conv.MIN_CIN
    if work.ACTIVE:
        work.conv(kmap, valid_out, weights, "banded" if banded else "gather")
    if banded:
        if torch.is_grad_enabled() and (feats.requires_grad or weights.requires_grad):
            raise RuntimeError("the banded conv has no backward: a banding plan "
                               "reached a conv while gradients are wanted")
        y = onehot_conv.onehot_conv(feats.contiguous(), plan, weights, valid_out,
                                    COMPUTE_DTYPE)
    elif not torch.is_grad_enabled():
        return gather_gemm(feats.contiguous(), kmap, weights, valid_out, bias)
    elif kmap_bwd is not None:
        y = _GatherConv.apply(feats, kmap, kmap_bwd, weights, valid_out)
    else:
        return _conv_fwd(feats, kmap, weights, valid_out, bias)
    return conv_epilogue(y, valid_out, bias) if bias is not None else y


def max_pool(feats: torch.Tensor, kmap: torch.Tensor, valid_out: torch.Tensor) -> torch.Tensor:
    """Max pooling over the kernel-map neighborhood (e.g. k=2 s=2): missing
    entries read -inf, a row with no entry pools to 0."""
    present = (kmap >= 0)[:, :, None]
    g = torch.where(present, take_rows0(feats, kmap), float("-inf"))
    y = torch.where(present.any(1), g.amax(1), 0.0)
    return torch.where(valid_out[:, None], y, 0.0)


def global_pool(feats: torch.Tensor, batch_ids: torch.Tensor, valid: torch.Tensor,
                num_segments: int, mode: str) -> torch.Tensor:
    """Per-batch-item global max/avg pooling over valid rows ->
    (num_segments, C); empty segments pool to 0."""
    c = feats.shape[1]
    seg = torch.where(valid, batch_ids, num_segments).to(torch.int64)
    idx = seg[:, None].expand(-1, c)
    if mode == "max":
        src = torch.where(valid[:, None], feats, float("-inf"))
        y = torch.full((num_segments + 1, c), float("-inf"), dtype=feats.dtype,
                       device=feats.device)
        y = y.scatter_reduce(0, idx, src, "amax", include_self=True)[:num_segments]
        return torch.where(torch.isfinite(y), y, 0.0)
    if mode == "avg":
        s = torch.zeros((num_segments + 1, c), dtype=feats.dtype, device=feats.device)
        s.index_add_(0, seg, torch.where(valid[:, None], feats, 0.0))
        cnt = torch.zeros(num_segments + 1, dtype=feats.dtype, device=feats.device)
        cnt.index_add_(0, seg, valid.to(feats.dtype))
        return s[:num_segments] / torch.clamp(cnt[:num_segments], min=1.0)[:, None]
    raise ValueError(mode)
