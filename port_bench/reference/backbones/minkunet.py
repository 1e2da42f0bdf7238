"""The MinkUNet family: ``nn/minkunet.py``'s network from a spec with the
keys of the MinkUNet table (``block``, ``layers``, ``planes``, optionally
``init_dim``, ``expansion`` and ``stem_kernel``).  Its parameters take
``weights.make``'s own rule."""

from __future__ import annotations

from port_bench.reference.nn.minkunet import STEM_VOLUME, MinkUNetBase
from port_bench.reference.nn.modules import BLOCK_EXPANSION


def build(in_channels: int, out_channels: int, spec: dict, generator=None, device=None):
    block = spec["block"]
    if block not in BLOCK_EXPANSION:
        raise ValueError(f"MinkUNet block {block!r}: one of {sorted(BLOCK_EXPANSION)}")
    if spec.get("expansion", BLOCK_EXPANSION[block]) != BLOCK_EXPANSION[block]:
        raise ValueError(f"{block} blocks expand by {BLOCK_EXPANSION[block]}, "
                         f"not {spec['expansion']}")
    if spec.get("stem_kernel", 5) ** 3 != STEM_VOLUME:
        raise ValueError(f"the stem's map is k=5, not k={spec['stem_kernel']}")
    if len(spec["layers"]) != 8 or len(spec["planes"]) != 8:
        raise ValueError("a MinkUNet has 8 stages of layers and planes")
    return MinkUNetBase(in_channels, out_channels, block=block, layers=tuple(spec["layers"]),
                        planes=tuple(spec["planes"]), init_dim=spec.get("init_dim", 32),
                        generator=generator, device=device)
