"""The work a forward needs, counted from the plain reference's own kernel
maps (the arithmetic of the port's ``pbnet_torch/tools/work.py``).

While a :class:`WorkCount` is active, every conv and dense layer of the
reference records one :class:`Layer`:

* operations of a conv: ``2 * Cin * Cout * #{(i, k): valid_out[i] and
  kmap[i, k] >= 0}``, the present map entries on valid output rows;
* operations of a dense layer: ``2 * rows * Cin * Cout`` over its valid
  rows;
* bytes: each input row the layer reads counted once, its weights once and
  each valid output row once, at the operand widths the configuration
  states (``operand_bytes`` for a conv's inputs and weights, f32 for its
  outputs and for dense layers).

This is what these inputs need, not what a padded program executes.  A
counting pass reads each layer's count on the host, so it is never timed.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

ACTIVE: list["WorkCount"] = []


@dataclass(frozen=True)
class Layer:
    kind: str  # "conv" or "dense"
    stage: str
    k: int
    cin: int
    cout: int
    entries: int  # present entries on valid rows (conv), valid rows (dense)
    rows_in: int  # input rows read
    rows_out: int  # valid output rows
    operand_bytes: int

    @property
    def ops(self) -> int:
        return 2 * self.cin * self.cout * self.entries

    @property
    def bytes(self) -> int:
        ob = self.operand_bytes if self.kind == "conv" else 4
        return (self.rows_in * self.cin + self.k * self.cin * self.cout) * ob \
            + self.rows_out * self.cout * 4


class WorkCount:
    """Collects the :class:`Layer` of every conv and dense layer run inside
    it; ``stage`` labels the layers recorded from then on."""

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
