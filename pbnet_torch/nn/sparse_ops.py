"""Functional sparse-tensor ops (port of pbnet_tpu/nn/sparse_ops.py).

A kernel map (core/topology.py) turns a sparse convolution into one row
gather and one GEMM ``(M, K*Cin) @ (K*Cin, Cout)``: each (output voxel,
offset) pair has at most one input voxel, so nothing is scattered.  The JAX
package leaves this product to XLA, so the port leaves it to ``torch.matmul``.

The backward is a gather-GEMM too (``_GatherConv``): every kernel map's
transpose is another kernel map of the same topology, so the gradient
gathers ``dy`` through it instead of scatter-adding into ``feats``.
"""

from __future__ import annotations

import torch

from .. import telemetry
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


def _conv_fwd(feats, kmap, weights, valid_out):
    k, cin, cout = weights.shape
    # every (row, column) entry of the map is multiplied: padded rows and
    # absent entries (zero rows) included
    telemetry.count("conv.executed_ops", 2 * kmap.shape[0] * k * cin * cout)
    g = take_rows0(feats.to(COMPUTE_DTYPE), kmap).reshape(kmap.shape[0], k * cin)
    w = weights.to(COMPUTE_DTYPE).reshape(k * cin, cout)
    return torch.where(valid_out[:, None], torch.matmul(g.float(), w.float()), 0.0)


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

    With ``kmap_bwd`` (the transposed map, see ``_GatherConv``) the
    backward is a gather-GEMM; without it autograd differentiates the same
    ops (a scatter-add into ``feats``), as in the JAX package.

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
    elif kmap_bwd is not None and torch.is_grad_enabled():
        y = _GatherConv.apply(feats, kmap, kmap_bwd, weights, valid_out)
    else:
        y = _conv_fwd(feats, kmap, weights, valid_out)
    if bias is not None:
        y = torch.where(valid_out[:, None], y + bias, 0.0)
    return y


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
