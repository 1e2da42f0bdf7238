"""The JAX package's variables -> this package's state dict.

Input: ``{"params": ..., "batch_stats": ...}`` as nested mappings of numpy
arrays (flax variables after ``tree_map(np.asarray, ...)``).  Output: a
mapping that ``PBNet.load_state_dict`` (or any of the port's modules) takes.

Name rules (flax -> port):

* ``.../Dense_0/kernel`` (Cin, Cout)  -> ``....weight`` transposed to
  (Cout, Cin); ``.../Dense_0/bias`` -> ``....bias``   (SparseLinear)
* ``.../kernel`` (K, Cin, Cout)       -> ``....kernel`` unchanged (SparseConv)
* ``.../scale``, ``.../bias``         -> ``....weight``, ``....bias`` (norms)
* ``.../alpha``                       -> ``....alpha`` (PReLU)
* batch_stats ``mean``, ``var``       -> ``running_mean``, ``running_var``
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _param_name(path, value):
    leaf = path[-1]
    dense = len(path) >= 2 and path[-2] == "Dense_0"
    base = ".".join(path[:-2] if dense else path[:-1])
    if leaf == "kernel":
        if dense:
            return base + ".weight", value.T
        return base + ".kernel", value
    if leaf == "bias":
        return base + ".bias", value
    if leaf == "scale":
        return base + ".weight", value
    if leaf == "alpha":
        return base + ".alpha", value
    raise KeyError(f"unknown parameter {'/'.join(path)}")


_STATS = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Convert JAX-package variables into a ``load_state_dict`` mapping."""
    out = {}
    for path, v in _leaves(variables.get("params", {})):
        name, val = _param_name(path, v)
        out[name] = torch.from_numpy(np.array(val, dtype=val.dtype, order="C"))
    for path, v in _leaves(variables.get("batch_stats", {})):
        if path[-1] not in _STATS:
            raise KeyError(f"unknown batch statistic {'/'.join(path)}")
        out[".".join(path[:-1] + (_STATS[path[-1]],))] = torch.from_numpy(
            np.array(v, dtype=v.dtype, order="C"))
    return out
