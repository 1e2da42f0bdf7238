"""Functional sparse-tensor ops (port of pbnet_tpu/nn/sparse_ops.py).

A kernel map (core/topology.py) turns a sparse convolution into one row
gather and one GEMM ``(M, K*Cin) @ (K*Cin, Cout)``: each (output voxel,
offset) pair has at most one input voxel, so nothing is scattered.  The JAX
package leaves this product to XLA, so the port leaves it to ``torch.matmul``.

Forward only in this package for now: training brings the gradient, whose
backward is the same gather-GEMM through the transposed map.
"""

from __future__ import annotations

import torch

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


def gather_conv(feats: torch.Tensor, kmap: torch.Tensor, weights: torch.Tensor,
                valid_out: torch.Tensor, bias: torch.Tensor | None = None,
                plan: onehot_conv.OnehotPlan | None = None) -> torch.Tensor:
    """Sparse convolution as gather + GEMM.  Returns (M_out, Cout) f32.

    feats (M_in, Cin); kmap (M_out, K) int32 with -1 = missing input;
    weights (K, Cin, Cout); valid_out (M_out,) bool.  Operands are rounded
    to ``COMPUTE_DTYPE`` and multiplied in f32, which is exactly "bf16
    operands, f32 accumulation" (a product of two bf16 values is exact in
    f32).

    With a banding ``plan`` of this map and at least ``onehot_conv.MIN_CIN``
    input channels, the banded conv runs instead; it drops the entries the
    plan counts in its ``overflow``.
    """
    if plan is not None and feats.shape[1] >= onehot_conv.MIN_CIN:
        y = onehot_conv.onehot_conv(feats.contiguous(), plan, weights, valid_out,
                                    COMPUTE_DTYPE)
        if bias is not None:
            y = torch.where(valid_out[:, None], y + bias, 0.0)
        return y
    k, cin, cout = weights.shape
    g = take_rows0(feats.to(COMPUTE_DTYPE), kmap).reshape(kmap.shape[0], k * cin)
    w = weights.to(COMPUTE_DTYPE).reshape(k * cin, cout)
    y = torch.matmul(g.float(), w.float())
    if bias is not None:
        y = y + bias
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
