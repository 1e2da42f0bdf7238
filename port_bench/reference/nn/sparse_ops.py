"""Functional sparse-tensor ops of the plain reference: a conv is a row
gather through its kernel map and one f32 GEMM (a frozen copy of the port's
gather path, ``pbnet_torch/nn/sparse_ops.py``, without its banded route).

``OPERANDS`` sets the precision the conv operands are rounded to before the
f32 product: ``"float32"`` (the reference: no rounding, TF32 off),
``"bfloat16"`` (the configuration's stated precision), or ``"float8"``
(the control: e4m3 with one scale per tensor, amax to 448, the step below
bfloat16).  While ``port_bench.work`` counts, every conv reports its
present map entries.
"""

from __future__ import annotations

import torch

from ... import work

OPERANDS = "float32"
FP8_MAX = 448.0


def round_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to ``OPERANDS``, returned in f32; the gradient
    passes the rounding unchanged."""
    x = x.float()
    if OPERANDS == "float32":
        return x
    d = x.detach()
    if OPERANDS == "bfloat16":
        q = d.to(torch.bfloat16).float()
    elif OPERANDS == "float8":
        scale = torch.clamp(d.abs().amax(), min=1e-30) / FP8_MAX
        q = (d / scale).to(torch.float8_e4m3fn).float() * scale
    else:
        raise ValueError(OPERANDS)
    return x + (q - d) if x.requires_grad else q


def take_rows0(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather where ``-1`` (missing) reads a zero row (``index_select``,
    whose gradient is one ``index_add_``)."""
    zero = torch.zeros((1,) + tbl.shape[1:], dtype=tbl.dtype, device=tbl.device)
    ext = torch.cat([tbl, zero], 0)
    safe = torch.where(idx >= 0, idx, tbl.shape[0]).to(torch.int64)
    return ext.index_select(0, safe.reshape(-1)).reshape(safe.shape + tbl.shape[1:])


def gather_conv(feats: torch.Tensor, kmap: torch.Tensor, weights: torch.Tensor,
                valid_out: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse convolution as gather + GEMM.  Returns (M_out, Cout) f32.

    feats (M_in, Cin); kmap (M_out, K) int32 with -1 = missing input;
    weights (K, Cin, Cout); valid_out (M_out,) bool."""
    if work.ACTIVE:
        work.conv(kmap, valid_out, weights, feats.shape[0])
    k, cin, cout = weights.shape
    g = take_rows0(round_operand(feats), kmap).reshape(kmap.shape[0], k * cin)
    w = round_operand(weights).reshape(k * cin, cout)
    y = torch.where(valid_out[:, None], torch.matmul(g, w), 0.0)
    if bias is not None:
        y = torch.where(valid_out[:, None], y + bias, 0.0)
    return y


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
