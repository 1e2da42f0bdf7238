"""The work a forward needs, counted from the plain reference's own kernel
maps (the arithmetic of the port's ``pbnet_torch/tools/work.py``).

While a :class:`WorkCount` is active, every conv, dense and attention
layer of the reference records one :class:`Layer`:

* operations of a conv: ``2 * Cin * Cout * #{(i, k): valid_out[i] and
  kmap[i, k] >= 0}``, the present map entries on valid output rows;
* operations of a dense layer: ``2 * rows * Cin * Cout`` over its valid
  rows;
* operations of an attention layer: ``4 * heads * head_dim * sum(keys)``
  over its valid query rows (QK^T and AV; softmax and scaling are not
  counted, as norms are not);
* bytes: each input row the layer reads counted once, its weights once and
  each valid output row once, at the operand widths the configuration
  states (``operand_bytes`` for a conv's inputs and weights, f32 for its
  outputs and for dense layers); an attention layer's Q, K and V read once
  and its output written once, all at ``operand_bytes``.

A backbone family (``reference/backbones/<family>.py``) reports each of its
layers through :func:`conv`, :func:`dense` and :func:`attention`; the
reference's ``SparseConv`` and ``SparseLinear`` call the first two
themselves.  This is what these inputs need, not what a padded program
executes.  A counting pass reads each layer's count on the host, so it is
never timed.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

ACTIVE: list["WorkCount"] = []


@dataclass(frozen=True)
class Layer:
    kind: str  # "conv", "dense" or "attention"
    stage: str
    k: int  # kernel volume (conv), 1 (dense), heads (attention)
    cin: int  # input channels; head_dim (attention)
    cout: int  # output channels; head_dim (attention)
    entries: int  # present entries on valid rows (conv), valid rows (dense),
    #               keys summed over valid query rows (attention)
    rows_in: int  # input rows read
    rows_out: int  # valid output rows
    operand_bytes: int

    @property
    def ops(self) -> int:
        if self.kind == "attention":
            return 4 * self.k * self.cin * self.entries
        return 2 * self.cin * self.cout * self.entries

    @property
    def bytes(self) -> int:
        if self.kind == "attention":
            return (3 * self.rows_in + self.rows_out) * self.k * self.cin * self.operand_bytes
        ob = self.operand_bytes if self.kind == "conv" else 4
        return (self.rows_in * self.cin + self.k * self.cin * self.cout) * ob \
            + self.rows_out * self.cout * 4


class WorkCount:
    """Collects the :class:`Layer` of every conv, dense and attention layer
    run inside it; ``stage`` labels the layers recorded from then on."""

    def __init__(self, operand_bytes: int = 2, stage: str = "all"):
        self.operand_bytes = operand_bytes
        self.stage = stage
        self.layers: list[Layer] = []

    def __enter__(self) -> "WorkCount":
        ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        ACTIVE.remove(self)

    def ops(self, stage: str | None = None) -> int:
        return sum(l.ops for l in self.layers if stage in (None, l.stage))

    def bytes(self, stage: str | None = None) -> int:
        return sum(l.bytes for l in self.layers if stage in (None, l.stage))


def conv(kmap: torch.Tensor, valid_out: torch.Tensor, weights: torch.Tensor,
         m_in: int) -> None:
    """Record one sparse conv: ``kmap`` (M_out, K) over ``m_in`` input rows,
    ``valid_out`` (M_out,), ``weights`` (K, Cin, Cout)."""
    present = (kmap >= 0) & valid_out[:, None]
    entries = int(present.sum())
    rows_in = int(torch.unique(kmap[present]).numel()) if entries else 0
    rows_out = int(valid_out.sum())
    k, cin, cout = weights.shape
    for wc in ACTIVE:
        wc.layers.append(Layer("conv", wc.stage, k, cin, cout, entries, rows_in, rows_out,
                               wc.operand_bytes))


def dense(valid: torch.Tensor, cin: int, cout: int) -> None:
    """Record one dense layer over the rows of ``valid``."""
    rows = int(valid.sum())
    for wc in ACTIVE:
        wc.layers.append(Layer("dense", wc.stage, 1, cin, cout, rows, rows, rows, 4))


def attention(valid_q: torch.Tensor, keys_per_row, heads: int, head_dim: int) -> None:
    """Record one self-attention layer over the query rows of ``valid_q``
    (M,): each valid row attends to ``keys_per_row`` keys (a number or
    (M,)), which are rows of the same set, in ``heads`` heads of
    ``head_dim``."""
    keys = torch.as_tensor(keys_per_row, dtype=torch.int64, device=valid_q.device)
    entries = int(keys.expand(valid_q.shape)[valid_q].sum())
    rows = int(valid_q.sum())
    for wc in ACTIVE:
        wc.layers.append(Layer("attention", wc.stage, heads, head_dim, head_dim, entries,
                               rows, rows, wc.operand_bytes))
