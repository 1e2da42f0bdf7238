"""The weights both sides run: made on the device from the seed, in one
draw, in f32 (the type the port keeps its parameters in; its convs round
the operands to the configuration's precision as they run).

Layout and scales: the state dict of the plain reference's model, which is
the port's (same names and shapes).  Conv kernels (K, Cin, Cout) draw
Kaiming-normal fan-out, std sqrt(2 / (K Cout)) (MinkowskiEngine's
``kaiming_normal_``); dense weights (Cout, Cin) std sqrt(1 / Cin); norms
start at weight 1, bias 0, running mean 0, running variance 1; PReLU at
0.25; biases at 0.
"""

from __future__ import annotations

import torch

from .reference.collate import Caps
from .reference.models import pbnet as ref_pbnet

SEED_MOD = 2**63 - 1


def _scale(name: str, shape) -> float | None:
    if name.endswith(".kernel"):
        k, _, cout = shape
        return (2.0 / (k * cout)) ** 0.5
    if name.endswith(".weight") and len(shape) == 2:
        return (1.0 / shape[1]) ** 0.5
    return None


def _const(name: str) -> float:
    if name.endswith((".running_var", ".weight")):
        return 1.0
    if name.endswith(".alpha"):
        return 0.25
    return 0.0


def arch_kw(cfg: dict) -> dict:
    """PBNet's constructor arguments from a configuration file."""
    return {k: cfg[k] for k in ("sem_num", "voxel_size", "scale_size", "radius", "min_pts",
                                "backbone_arch", "dunet_arch", "score_arch")}


def make(cfg: dict, seed: int, device) -> dict:
    """``{name: tensor}`` for configuration ``cfg`` on ``device``."""
    caps = Caps(1, (1,), 1, 1, (1,), (1,), 1, 32)
    layout = ref_pbnet.PBNet(caps, device="meta", **arch_kw(cfg)).state_dict()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    drawn = [(k, v.shape, _scale(k, v.shape)) for k, v in layout.items()]
    total = sum(v.numel() for k, v in layout.items() if _scale(k, v.shape) is not None)
    buf = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k, shape, s in drawn:
        n = int(torch.Size(shape).numel())
        if s is None:
            out[k] = torch.full(shape, _const(k), device=device)
        else:
            out[k] = buf[off:off + n].view(shape) * s
            off += n
    return out
