"""The JAX package's variables -> this package's state dict.

Input: ``{"params": ..., "batch_stats": ...}`` as nested mappings of numpy
arrays (flax variables after ``tree_map(np.asarray, ...)``).  Output: a
mapping that ``PBNet.load_state_dict`` (or any of the port's modules) takes.

Name rules (flax -> port):

* ``.../Dense_0/kernel`` (Cin, Cout)  -> ``....weight`` transposed to
  (Cout, Cin); ``.../Dense_0/bias`` -> ``....bias``   (SparseLinear)
* ``.../kernel`` (Cin, Cout) of an ``nn.Dense`` named by its module (the
  classifiers' ``final``, the field blocks' ``field*_sinusoidal`` and
  ``field*_linear``) -> ``....weight`` transposed, as above
* ``.../kernel`` (K, Cin, Cout)       -> ``....kernel`` unchanged (SparseConv)
* ``.../scale``, ``.../bias``         -> ``....weight``, ``....bias`` (norms)
* ``.../alpha``                       -> ``....alpha`` (PReLU)
* batch_stats ``mean``, ``var``       -> ``running_mean``, ``running_var``

``optimizer_state_from_optax`` carries an optax optimizer state (the Adam
moments of ``ScaleByAdamState``, or the momentum of ``TraceState``) into the
state dict of the port's optimizer over the same model, so that a run can
continue from a JAX checkpoint.
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
    base = path[:-2] if dense else path[:-1]
    if leaf == "kernel":
        if value.ndim == 2:  # a Dense kernel; sparse-conv kernels are (K, Cin, Cout)
            return ".".join(base + ("weight",)), value.T
        return ".".join(base + ("kernel",)), value
    names = {"bias": "bias", "scale": "weight", "alpha": "alpha"}
    if leaf in names:
        return ".".join(base + (names[leaf],)), value
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


def _params_by_name(tree) -> dict[str, torch.Tensor]:
    """A params-shaped pytree (optax moments) under the port's names."""
    return {name: torch.from_numpy(np.array(val, dtype=val.dtype, order="C"))
            for name, val in (_param_name(p, v) for p, v in _leaves(tree))}


def _field(node, name):
    """A field of an optax state node: a NamedTuple's attribute, or the key
    of the same name in the mapping a JAX checkpoint restores it as."""
    return node[name] if isinstance(node, Mapping) else getattr(node, name)


def _has_fields(node, fields) -> bool:
    if isinstance(node, Mapping):
        return all(f in node for f in fields)
    return all(hasattr(node, f) for f in fields)


def _find_state(state, fields):
    """The first node of an optax state that has every field in ``fields``:
    the state itself, or a member of a chain (a tuple of NamedTuples, or the
    ``{"0": ..., "1": ...}`` mapping a JAX checkpoint restores it as)."""
    if _has_fields(state, fields):
        return state
    members = state.values() if isinstance(state, Mapping) else (
        state if isinstance(state, (tuple, list)) else ())
    for s in members:
        found = _find_state(s, fields)
        if found is not None:
            return found
    return None


def optimizer_state_from_optax(opt_state, model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer) -> dict:
    """A ``optimizer.load_state_dict`` mapping from the JAX package's optax
    state (leaves as numpy arrays; NamedTuples, or the mappings a JAX
    checkpoint file restores them as).  ``optimizer`` runs over
    ``model.parameters()`` in order (``train_step.make_optimizer``): Adam or
    AdamW takes ``count``, ``mu`` and ``nu`` as its ``step``, ``exp_avg`` and
    ``exp_avg_sq``; ``OptaxSGD`` takes ``trace``."""
    names = [n for n, _ in model.named_parameters()]
    adam = _find_state(opt_state, ("count", "mu", "nu"))
    if adam is not None:
        mu, nu = _params_by_name(_field(adam, "mu")), _params_by_name(_field(adam, "nu"))
        step = torch.tensor(float(np.asarray(_field(adam, "count"))), dtype=torch.float32)
        per = [{"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]} for n in names]
    else:
        tr = _find_state(opt_state, ("trace",))
        if tr is None:
            raise KeyError(f"no Adam or trace state in {type(opt_state).__name__}")
        trace = _params_by_name(_field(tr, "trace"))
        per = [{"trace": trace[n]} for n in names]
    sd = optimizer.state_dict()
    order = [i for g in sd["param_groups"] for i in g["params"]]
    if len(order) != len(names):
        raise ValueError(f"the optimizer holds {len(order)} parameters, the model {len(names)}")
    return {"state": dict(zip(order, per)), "param_groups": sd["param_groups"]}
