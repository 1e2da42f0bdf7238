"""The work a forward does, counted from its kernel maps.

While a :class:`WorkCount` is active, every sparse conv
(``nn/sparse_ops.gather_conv``) and every dense layer on point or voxel
rows (``nn/modules.SparseLinear``) records one :class:`Layer`:

* useful operations of a conv: ``2 * Cin * Cout * #{(i, k): valid_out[i]
  and kmap[i, k] >= 0}``, the present kernel-map entries on valid output
  rows, whichever route (gather-GEMM or the banded kernel) computes it: the
  work is the model's.  A map that the ScoreNet derives from the local
  scene's (``models/pbnet.py``) keeps its entries at dropped voxels, which
  read zeros; they count as present, as the map holds them;
* useful operations of a dense layer: ``2 * rows * Cin * Cout`` over its
  valid rows;
* executed operations: what the GEMMs run, ``2 * M_cap * K * Cin * Cout``
  for a gather conv (every img2col column of every row up to the capacity)
  and ``2 * M_cap * Cin * Cout`` for a dense layer.  A banded conv runs no
  GEMM and executes 0 here.

This counts what these inputs need, not the most they could: XLA's
``cost_analysis()`` of the JAX package's bench counts its padded program
instead, and has no PyTorch counterpart.

Counting reads each layer's count on the host (one synchronisation per
layer), so a counting pass is never a timed one.  With no count active the
hooks cost one check of :data:`ACTIVE`.
"""

from __future__ import annotations

from dataclasses import dataclass

# the active counts, innermost last; the hooks record into each
ACTIVE: list["WorkCount"] = []


@dataclass(frozen=True)
class Layer:
    route: str  # a conv's "gather" or "banded", or "dense"
    stage: str  # the count's stage when the layer ran
    rows: int  # output capacity M_cap
    k: int  # kernel volume (1 for a dense layer)
    cin: int
    cout: int
    entries: int  # present map entries on valid rows (conv), valid rows (dense)

    @property
    def useful(self) -> int:
        return 2 * self.cin * self.cout * self.entries

    @property
    def executed(self) -> int:
        return 0 if self.route == "banded" else 2 * self.rows * self.k * self.cin * self.cout


class WorkCount:
    """A context manager that collects the :class:`Layer` of every conv and
    dense layer run inside it.  ``stage`` labels the layers recorded from
    then on (set it between the stages of a forward)."""

    def __init__(self, stage: str = "all"):
        self.stage = stage
        self.layers: list[Layer] = []

    def __enter__(self) -> "WorkCount":
        ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        ACTIVE.remove(self)

    def _layers(self, stage):
        return [l for l in self.layers if stage is None or l.stage == stage]

    def useful(self, stage: str | None = None) -> int:
        return sum(l.useful for l in self._layers(stage))

    def executed(self, stage: str | None = None) -> int:
        return sum(l.executed for l in self._layers(stage))

    def summary(self) -> dict:
        """Totals, totals by stage, and the layer count of each route."""
        stages = list(dict.fromkeys(l.stage for l in self.layers))
        routes = list(dict.fromkeys(l.route for l in self.layers))
        return {
            "useful_ops": self.useful(),
            "executed_ops": self.executed(),
            "useful_ops_by_stage": {s: self.useful(s) for s in stages},
            "executed_ops_by_stage": {s: self.executed(s) for s in stages},
            "layers_by_route": {r: sum(l.route == r for l in self.layers) for r in routes},
        }


def conv(kmap, valid_out, weights, route: str) -> None:
    """Record one sparse conv: ``kmap`` (M_out, K), ``valid_out`` (M_out,),
    ``weights`` (K, Cin, Cout)."""
    entries = int(((kmap >= 0) & valid_out[:, None]).sum())
    k, cin, cout = weights.shape
    for wc in ACTIVE:
        wc.layers.append(Layer(route, wc.stage, kmap.shape[0], k, cin, cout, entries))


def dense(valid, cin: int, cout: int) -> None:
    """Record one dense layer over the rows of ``valid``."""
    entries = int(valid.sum())
    for wc in ACTIVE:
        wc.layers.append(Layer("dense", wc.stage, valid.shape[0], 1, cin, cout, entries))
