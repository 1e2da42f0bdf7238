"""The weights both sides run: made on the device from the seed, in one
draw, in f32 (the type the port keeps its parameters in; its convs round
the operands to the configuration's precision as they run).

Layout and scales: the state dict of the plain reference's model, which is
the port's (same names and shapes).  Conv kernels (K, Cin, Cout) draw
Kaiming-normal fan-out, std sqrt(2 / (K Cout)) (MinkowskiEngine's
``kaiming_normal_``); dense weights (Cout, Cin) std sqrt(1 / Cin); norms
start at weight 1, bias 0, running mean 0, running variance 1; PReLU at
0.25; biases at 0.

A backbone family's file (``reference/backbones/<family>.py``) may bring
its own rule for the parameters of the UNets it builds: ``scale(name,
shape)`` (the std, or None for a constant) and ``const(name)``, with
``name`` inside that UNet; where it lacks one, the rule above holds.  The
draw stays one ``randn`` in state-dict order.
"""

from __future__ import annotations

import torch

from . import spec
from .reference import backbones
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


NAMES = ("sem_num", "voxel_size", "scale_size", "radius", "min_pts",
         "backbone_arch", "dunet_arch", "score_arch")


def arch_kw(cfg: dict) -> dict:
    """The reference PBNet's constructor arguments from a configuration
    file: the architectures' names, their specs under ``archs`` and the
    modules of the families those name, read from the cell's
    ``backbones_dir`` (set by ``spec.cell``; the package's own where
    absent)."""
    archs = cfg["archs"]
    families = {f: spec.family(f, cfg.get("backbones_dir"))
                for f in {backbones.family_of(a) for a in archs.values()}}
    return dict({k: cfg[k] for k in NAMES}, archs=archs, backbone_families=families)


def port_kw(cfg: dict) -> dict:
    """The port's PBNet arguments: the architectures' names (the port builds
    them from its own table)."""
    return {k: cfg[k] for k in NAMES}


def make(cfg: dict, seed: int, device) -> dict:
    """``{name: tensor}`` for configuration ``cfg`` on ``device``."""
    caps = Caps(1, (1,), 1, 1, (1,), (1,), 1, 32)
    model = ref_pbnet.PBNet(caps, device="meta", **arch_kw(cfg))

    def scale(k: str, shape):
        unet, _, inner = k.partition(".")
        fam = model.families.get(unet)
        return fam.scale(inner, shape) if hasattr(fam, "scale") else _scale(k, shape)

    def const(k: str) -> float:
        unet, _, inner = k.partition(".")
        fam = model.families.get(unet)
        return fam.const(inner) if hasattr(fam, "const") else _const(k)

    layout = model.state_dict()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    drawn = [(k, v.shape, scale(k, v.shape)) for k, v in layout.items()]
    total = sum(int(torch.Size(shape).numel()) for _, shape, s in drawn if s is not None)
    buf = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k, shape, s in drawn:
        n = int(torch.Size(shape).numel())
        if s is None:
            out[k] = torch.full(shape, const(k), device=device)
        else:
            out[k] = buf[off:off + n].view(shape) * s
            off += n
    return out
