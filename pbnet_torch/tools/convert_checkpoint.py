"""Reference PBNet checkpoints (MinkowskiEngine, ``.pth``) -> the port's
state dict (port of pbnet_tpu/tools/convert_checkpoint.py).

The reference saves ``{'model': state_dict, 'optimizer': ...}`` with
MinkowskiEngine module naming:

reference name                          JAX-package path (then ``convert``)
--------------------------------------  --------------------------------------
MEUnet.conv0p1s1.kernel (125,Ci,Co)     MEUnet/conv0/kernel
MEUnet.bn0.bn.{weight,bias}             MEUnet/bn0/{scale,bias}
MEUnet.bn0.bn.running_{mean,var}        batch_stats: MEUnet/bn0/{mean,var}
MEUnet.conv{n}p*s2.kernel (8,Ci,Co)     MEUnet/conv{n}s2/kernel
MEUnet.block{n}.{i}.conv1.kernel        MEUnet/block{n}_{i}/conv1/kernel
MEUnet.block{n}.{i}.downsample.0.kernel MEUnet/block{n}_{i}/downsample_conv/
                                          Dense_0 kernel (1x1 conv == linear)
MEUnet.convtr{n}p*s2.kernel (8,Ci,Co)   MEUnet/convtr{n}/kernel
MEUnet.final_sematic.kernel (Ci,Co)     MEUnet/final/Dense_0/kernel
linear_sem.0.linear.weight (Co,Ci)      linear_sem/linear1/Dense_0/kernel^T
linear_sem.1.bn.*                       linear_sem/norm/*
linear_sem.2.weight (PReLU alpha)       linear_sem/prelu/alpha
linear_sem.3.linear.{weight,bias}       linear_sem/linear2/Dense_0/*

``convert_state_dict`` gives the JAX package's ``(params, batch_stats)``
trees (the same rename tables); ``to_state_dict`` carries them through
``convert.state_dict_from_jax`` into the port's names.
``to_reference_state_dict`` is the inverse (the port's names -> the
reference's, from the same tables), and ``write_reference_pth`` saves it as
a reference ``.pth``, for the checkpoint-parity harness
(``tools/parity_eval.py``) on weights made here.

Kernel offsets: the port enumerates them x-major (dx slowest, dz fastest;
``core/topology.kernel_offsets``), MinkowskiEngine x-fastest.
``me_offset_permutation`` converts; ``me_order='x_fastest'`` (default) for
real ME checkpoints, ``'z_fastest'`` for the identity.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .. import convert
from ..core.topology import kernel_offsets

UNETS = ("MEUnet", "D_Unet", "score_Unet")
HEADS = ("linear_sem", "linear_offset", "linear_binary", "linear_IOU_feat", "linear_IOU")

# reference strided/transposed conv names -> the port's
_CONV_RENAME = {
    "conv0p1s1": "conv0",
    "conv1p1s2": "conv1s2",
    "conv2p2s2": "conv2s2",
    "conv3p4s2": "conv3s2",
    "conv4p8s2": "conv4s2",
    "convtr4p16s2": "convtr4",
    "convtr5p8s2": "convtr5",
    "convtr6p4s2": "convtr6",
    "convtr7p2s2": "convtr7",
    "final_sematic": "final",
    # Mini UNet
    "convtr2p1s2": "convtr2",
    "final_score": "final",
}
_BN_RENAME = {
    "bn0": "bn0", "bn1": "bn1", "bn2": "bn2", "bn3": "bn3", "bn4": "bn4",
    "bntr4": "bntr4", "bntr5": "bntr5", "bntr6": "bntr6", "bntr7": "bntr7",
    "bntr1": "bntr1",
}
# head layers: the port's -> the reference's nn.Sequential entries
_HEAD_RENAME = {"linear1": "0.linear", "norm": "1.bn", "prelu": "2", "linear2": "3.linear"}
_BN_LEAF = {"weight": (0, "scale"), "bias": (0, "bias"), "running_mean": (1, "mean"),
            "running_var": (1, "var")}


def me_offset_permutation(k: int, me_order: str = "x_fastest") -> np.ndarray:
    """perm such that ours_kernel[i] = me_kernel[perm[i]]."""
    ours = [tuple(o) for o in kernel_offsets(k)]
    if me_order == "z_fastest":
        me = ours
    elif me_order == "x_fastest":
        r = range(-(k // 2), k // 2 + 1) if k % 2 == 1 else range(0, k)
        me = [(dx, dy, dz) for dz in r for dy in r for dx in r]
    else:
        raise ValueError(me_order)
    index = {o: i for i, o in enumerate(me)}
    return np.array([index[o] for o in ours], np.int64)


def _conv_kernel(w: np.ndarray, me_order: str) -> np.ndarray:
    """(K^3, Ci, Co) ME kernel -> the port's, the offset axis permuted."""
    kv = w.shape[0]
    k = round(kv ** (1 / 3))
    if k ** 3 != kv:
        raise ValueError(f"kernel volume {kv} is not a cube: {w.shape}")
    return w[me_offset_permutation(k, me_order)]


def _put(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


def convert_state_dict(state_dict: dict, me_order: str = "x_fastest"):
    """Reference state dict (numpy-convertible values) -> (params,
    batch_stats) as the JAX package's nested trees."""
    trees = ({}, {})  # params, batch_stats
    params = trees[0]

    def bn(path, parts, v):
        if parts[-1] in _BN_LEAF:  # num_batches_tracked is dropped
            which, leaf = _BN_LEAF[parts[-1]]
            _put(trees[which], path + (leaf,), v)

    for name, val in state_dict.items():
        parts = re.sub(r"^module\.", "", name).split(".")
        v = np.asarray(val)
        top = parts[0]
        if top in UNETS:
            sub = parts[1]
            if sub in _CONV_RENAME:
                ours = _CONV_RENAME[sub]
                if parts[-1] == "kernel":
                    if v.ndim == 3:
                        _put(params, (top, ours, "kernel"), _conv_kernel(v, me_order))
                    else:  # a 1x1 conv stored 2-D is the Dense final head
                        _put(params, (top, ours, "Dense_0", "kernel"), v)
                elif parts[-1] == "bias":
                    _put(params, (top, ours, "Dense_0", "bias"), v)
            elif sub in _BN_RENAME:
                bn((top, _BN_RENAME[sub]), parts, v)
            elif sub.startswith("block"):
                blk = f"{sub}_{parts[2]}"
                inner = parts[3]
                if inner in ("conv1", "conv2"):
                    if parts[-1] == "kernel":
                        _put(params, (top, blk, inner, "kernel"), _conv_kernel(v, me_order))
                elif inner in ("norm1", "norm2"):
                    bn((top, blk, inner), parts, v)
                elif inner == "downsample":
                    if parts[4] == "0":  # 1x1 conv
                        if parts[-1] == "kernel":
                            _put(params, (top, blk, "downsample_conv", "Dense_0", "kernel"), v)
                    else:
                        bn((top, blk, "downsample_norm"), parts, v)
        elif top in HEADS:
            idx, leaf = parts[1], parts[-1]
            if idx == "0" and parts[2] == "linear":
                _put(params, (top, "linear1", "Dense_0", "kernel"), v.T)
            elif idx == "1":
                bn((top, "norm"), parts, v)
            elif idx == "2" and leaf == "weight":  # PReLU
                _put(params, (top, "prelu", "alpha"), v.reshape(-1)[:1])
            elif idx == "3" and parts[2] == "linear":
                if leaf == "weight":
                    _put(params, (top, "linear2", "Dense_0", "kernel"), v.T)
                else:
                    _put(params, (top, "linear2", "Dense_0", "bias"), v)
    return trees


def to_state_dict(state_dict: dict, me_order: str = "x_fastest") -> dict[str, torch.Tensor]:
    """Reference state dict -> a mapping the port's ``PBNet.load_state_dict``
    takes."""
    params, stats = convert_state_dict(state_dict, me_order)
    return convert.state_dict_from_jax({"params": params, "batch_stats": stats})


def load_reference_checkpoint(path: str, me_order: str = "x_fastest") -> dict[str, torch.Tensor]:
    """A reference ``.pth`` (``{'model': state_dict, ...}`` or a bare state
    dict) -> the port's state dict."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload["model"] if isinstance(payload, dict) and "model" in payload else payload
    sd = {k: t.detach().numpy() for k, t in sd.items() if isinstance(t, torch.Tensor)}
    return to_state_dict(sd, me_order)


def merge_into_model(model: torch.nn.Module, state_dict: dict) -> list[str]:
    """Load the converted tensors whose name and shape match ``model``'s
    into it; returns the names that matched nothing."""
    own = model.state_dict()
    matched = {k: v for k, v in state_dict.items() if k in own and own[k].shape == v.shape}
    model.load_state_dict(matched, strict=False)
    return sorted(set(state_dict) - set(matched))


def to_reference_state_dict(state_dict: dict,
                            me_order: str = "x_fastest") -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` (a PBNet with basic-block UNets) -> the
    reference's: MinkowskiEngine module names under ``module.``, sparse-conv
    kernels in ME's offset order (``me_order``), dense kernels as ME stores
    them.  ``to_state_dict`` maps it back to the same tensors.  Raises on a
    name the reference format has no place for."""
    inv_conv = {v: k for k, v in _CONV_RENAME.items()}
    inv_bn = {v: k for k, v in _BN_RENAME.items()}
    bn_leaves = tuple(_BN_LEAF)
    out = {}

    def put(name, value):
        out["module." + name] = torch.from_numpy(np.ascontiguousarray(value))

    def me_kernel(v):
        k = round(v.shape[0] ** (1 / 3))
        return v[np.argsort(me_offset_permutation(k, me_order))]

    for name, t in state_dict.items():
        v = t.detach().cpu().numpy()
        parts = name.split(".")
        top, leaf = parts[0], parts[-1]
        if top in UNETS and len(parts) == 3 and parts[1] in inv_conv:
            ref = f"{top}.{inv_conv[parts[1]]}"
            if leaf == "kernel":
                put(ref + ".kernel", me_kernel(v))
            elif leaf == "weight":  # a dense 1x1 conv: ME keeps (Cin, Cout)
                put(ref + ".kernel", v.T)
            elif leaf == "bias":
                put(ref + ".bias", v)
            else:
                raise KeyError(name)
        elif top in UNETS and len(parts) == 3 and parts[1] in inv_bn and leaf in bn_leaves:
            put(f"{top}.{inv_bn[parts[1]]}.bn.{leaf}", v)
        elif top in UNETS and len(parts) == 4 and parts[1].startswith("block"):
            base, idx = parts[1].rsplit("_", 1)
            ref, inner = f"{top}.{base}.{idx}", parts[2]
            if inner in ("conv1", "conv2") and leaf == "kernel":
                put(f"{ref}.{inner}.kernel", me_kernel(v))
            elif inner in ("norm1", "norm2") and leaf in bn_leaves:
                put(f"{ref}.{inner}.bn.{leaf}", v)
            elif inner == "downsample_conv" and leaf == "weight":
                put(f"{ref}.downsample.0.kernel", v.T)
            elif inner == "downsample_norm" and leaf in bn_leaves:
                put(f"{ref}.downsample.1.bn.{leaf}", v)
            else:
                raise KeyError(name)
        elif top in HEADS and len(parts) == 3 and parts[1] in _HEAD_RENAME:
            put(f"{top}.{_HEAD_RENAME[parts[1]]}.{'weight' if leaf == 'alpha' else leaf}", v)
        else:
            raise KeyError(f"{name}: no place in the reference format")
    return out


def write_reference_pth(state_dict: dict, path: str, me_order: str = "x_fastest") -> None:
    """Save ``to_reference_state_dict(state_dict)`` as a reference ``.pth``
    (``{"model": ..., "optimizer": {}}``), which ``load_reference_checkpoint``
    reads back to the same tensors."""
    torch.save({"model": to_reference_state_dict(state_dict, me_order), "optimizer": {}}, path)
