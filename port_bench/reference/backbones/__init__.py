"""Backbone families of the plain reference, one file each.

A family is a file ``<family>.py`` in this directory (``spec.family``
finds it, in the directory of the cell's files) that exposes

* ``build(in_channels, out_channels, spec, generator, device) -> nn.Module``;
  the module's ``forward(topo, feats) -> (V, out_channels)`` takes a
  :class:`~port_bench.reference.core.topology.UNetTopology` (levels with
  ``coords`` [b, x, y, z], ``valid`` and ``stride``; its k=3 maps) and the
  level-0 features;
* optionally ``scale(name, shape)`` and ``const(name)``: how
  ``port_bench.weights.make`` draws that module's parameters (``name``
  inside the module).

It imports by absolute names (``port_bench....``): a family file outside
the package is loaded by its path.  Its layers report their work through
``port_bench.work``'s ``conv``, ``dense`` and ``attention`` (the
reference's ``SparseConv`` and ``SparseLinear`` report their own).

A configuration states each architecture it names under ``archs`` (name ->
spec); the spec's ``family`` picks the file, ``"minkunet"`` where it is
absent.
"""

from __future__ import annotations

DEFAULT_FAMILY = "minkunet"


def family_of(spec: dict) -> str:
    return spec.get("family", DEFAULT_FAMILY)


def build(in_channels: int, out_channels: int, arch: str, archs: dict, families: dict,
          generator=None, device=None) -> tuple:
    """``(network, family module)`` for architecture ``arch``, built by its
    family (``families``: family name -> module) from its spec in
    ``archs``."""
    if arch not in archs:
        raise KeyError(f"architecture {arch!r} is not stated under the configuration's "
                       f"archs ({sorted(archs)})")
    fam = families[family_of(archs[arch])]
    return fam.build(in_channels, out_channels, archs[arch], generator, device).eval(), fam
