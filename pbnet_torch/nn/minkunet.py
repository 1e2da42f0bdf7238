"""MinkUNet family (port of pbnet_tpu/nn/minkunet.py).

* MinkUNetBase: stem k=5 conv -> 4 encoder stages (k=2 s=2 conv + residual
  blocks) -> 4 decoder stages (k=2 s=2 transposed conv + skip concat +
  residual blocks) -> 1x1 head.
* MinkMiniUNet: the 2-level 'Mini_Unet'.

Kernel maps come from a precomputed :class:`~pbnet_torch.core.topology
.UNetTopology`; all residual blocks at one stride share one k=3 map.  Module
names follow the JAX package's flax names (``conv0``, ``bn0``, ``conv{s}s2``,
``bn{s}``, ``block{n}_{i}``, ``convtr{k}``, ``bntr{k}``, ``final``).

Backward maps as the JAX package sets them: the stem takes its own map
column-reversed, a strided (down) conv at level s the up map ``up_maps[s]``,
a transposed (up) conv to level l the down map ``down_maps[l]``, and a
residual block its k3 map reversed.

Banding plans (``topo.k3_plans``/``down_plans``/``up_plans``, attached by
``onehot_conv.attach_plans``) go to the same convs as in the JAX package,
in eval mode only (the banded conv has no backward): an encoder stage's
strided conv takes ``down_plans[s]`` and its blocks ``k3_plans[s + 1]``; a
decoder stage's transposed conv takes ``up_plans[lvl]`` and its blocks
``k3_plans[lvl]``; the stem never bands.
The JAX package runs a dense-grid conv at levels of at most 30,000 grid
cells, and there its dense path wins over a band plan; the port has no
dense convs (they compute the same values), so a span set at such a level
makes the port run the banded kernel where the JAX package runs a dense
conv.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.topology import UNetTopology
from .modules import (BLOCK_EXPANSION, BLOCKS, MaskedBatchNorm, SparseConv, SparseLinear,
                      flipped_map)

STEM_VOLUME = 125  # k=5 stem


def _plan(plans, i, training):
    """Plan ``i`` of a topology's plan tuple, or None (always None in train
    mode)."""
    return plans[i] if not training and i < len(plans) else None


class MinkUNetBase(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, block: str = "basic",
                 layers: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2),
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 init_dim: int = 32, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        blk = BLOCKS[block]
        exp = BLOCK_EXPANSION[block]
        self.layers = tuple(layers)
        self.conv0 = SparseConv(in_channels, init_dim, STEM_VOLUME, **kw)
        self.bn0 = MaskedBatchNorm(init_dim, device=device)

        ch = init_dim
        enc_ch = []
        for s in range(4):
            setattr(self, f"conv{s+1}s2", SparseConv(ch, ch, 8, **kw))
            setattr(self, f"bn{s+1}", MaskedBatchNorm(ch, device=device))
            inp = ch
            for i in range(layers[s]):
                setattr(self, f"block{s+1}_{i}", blk(inp, planes[s], **kw))
                inp = planes[s] * exp
            ch = planes[s] * exp
            enc_ch.append(ch)
        skip_ch = [enc_ch[2], enc_ch[1], enc_ch[0], init_dim]
        for d in range(4):
            setattr(self, f"convtr{4+d}", SparseConv(ch, planes[4 + d], 8, **kw))
            setattr(self, f"bntr{4+d}", MaskedBatchNorm(planes[4 + d], device=device))
            inp = planes[4 + d] + skip_ch[d]
            for i in range(layers[4 + d]):
                setattr(self, f"block{5+d}_{i}", blk(inp, planes[4 + d], **kw))
                inp = planes[4 + d] * exp
            ch = planes[4 + d] * exp
        self.final = SparseLinear(ch, out_channels, use_bias=True, **kw)

    def _blocks(self, name, n, x, kmap, valid, plan):
        for i in range(n):
            x = getattr(self, f"{name}_{i}")(x, kmap, valid, plan)
        return x

    def forward(self, topo: UNetTopology, feats: torch.Tensor) -> torch.Tensor:
        v = [lv.valid for lv in topo.levels]
        tr = self.training
        out_p1 = torch.relu(self.bn0(
            self.conv0(feats, topo.stem_map, v[0], kmap_bwd=flipped_map(topo.stem_map)), v[0]))

        enc = []
        x = out_p1
        for s in range(4):
            x = getattr(self, f"conv{s+1}s2")(x, topo.down_maps[s], v[s + 1],
                                              _plan(topo.down_plans, s, tr), topo.up_maps[s])
            x = torch.relu(getattr(self, f"bn{s+1}")(x, v[s + 1]))
            x = self._blocks(f"block{s+1}", self.layers[s], x,
                             topo.k3_maps[s + 1], v[s + 1], _plan(topo.k3_plans, s + 1, tr))
            enc.append(x)

        # decoder: levels 3, 2, 1, 0 with skips enc[2], enc[1], enc[0], out_p1
        skips = [enc[2], enc[1], enc[0], out_p1]
        for d in range(4):
            lvl = 3 - d
            x = getattr(self, f"convtr{4+d}")(x, topo.up_maps[lvl], v[lvl],
                                              _plan(topo.up_plans, lvl, tr), topo.down_maps[lvl])
            x = torch.relu(getattr(self, f"bntr{4+d}")(x, v[lvl]))
            x = torch.cat([x, skips[d]], 1)
            x = self._blocks(f"block{5+d}", self.layers[4 + d], x,
                             topo.k3_maps[lvl], v[lvl], _plan(topo.k3_plans, lvl, tr))
        return self.final(x, v[0])


class MinkMiniUNet(nn.Module):
    """2-level UNet ('Mini_Unet')."""

    def __init__(self, in_channels: int, out_channels: int, block: str = "basic",
                 layers: Sequence[int] = (2, 2), planes: Sequence[int] = (32, 64),
                 init_dim: int = 32, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        blk = BLOCKS[block]
        self.layers = tuple(layers)
        self.conv0 = SparseConv(in_channels, init_dim, STEM_VOLUME, **kw)
        self.bn0 = MaskedBatchNorm(init_dim, device=device)
        self.conv1s2 = SparseConv(init_dim, init_dim, 8, **kw)
        self.bn1 = MaskedBatchNorm(init_dim, device=device)
        inp = init_dim
        for i in range(layers[0]):
            setattr(self, f"block1_{i}", blk(inp, planes[0], **kw))
            inp = planes[0]
        self.convtr2 = SparseConv(inp, planes[1], 8, **kw)
        self.bntr1 = MaskedBatchNorm(planes[1], device=device)
        inp = planes[1] + init_dim
        for i in range(layers[1]):
            setattr(self, f"block2_{i}", blk(inp, planes[1], **kw))
            inp = planes[1]
        self.final = SparseLinear(inp, out_channels, use_bias=True, **kw)

    def forward(self, topo: UNetTopology, feats: torch.Tensor) -> torch.Tensor:
        v = [lv.valid for lv in topo.levels]
        tr = self.training
        out_p0 = torch.relu(self.bn0(
            self.conv0(feats, topo.stem_map, v[0], kmap_bwd=flipped_map(topo.stem_map)), v[0]))
        x = self.conv1s2(out_p0, topo.down_maps[0], v[1], _plan(topo.down_plans, 0, tr),
                         topo.up_maps[0])
        x = torch.relu(self.bn1(x, v[1]))
        for i in range(self.layers[0]):
            x = getattr(self, f"block1_{i}")(x, topo.k3_maps[1], v[1],
                                             _plan(topo.k3_plans, 1, tr))
        x = self.convtr2(x, topo.up_maps[0], v[0], _plan(topo.up_plans, 0, tr),
                         topo.down_maps[0])
        x = torch.relu(self.bntr1(x, v[0]))
        x = torch.cat([x, out_p0], 1)
        for i in range(self.layers[1]):
            x = getattr(self, f"block2_{i}")(x, topo.k3_maps[0], v[0],
                                             _plan(topo.k3_plans, 0, tr))
        return self.final(x, v[0])


# Architecture registry mirroring Mink_unet(arch=...)
ARCHS = {
    "MinkUNet14A": dict(layers=(1,) * 8, planes=(32, 64, 128, 256, 128, 128, 96, 96), block="basic"),
    "MinkUNet14B": dict(layers=(1,) * 8, planes=(32, 64, 128, 256, 128, 128, 128, 128), block="basic"),
    "MinkUNet14C": dict(layers=(1,) * 8, planes=(32, 64, 128, 256, 192, 192, 128, 128), block="basic"),
    "MinkUNet14D": dict(layers=(1,) * 8, planes=(32, 64, 128, 256, 384, 384, 384, 384), block="basic"),
    "MinkUNet18A": dict(layers=(2,) * 8, planes=(32, 64, 128, 256, 128, 128, 96, 96), block="basic"),
    "MinkUNet18B": dict(layers=(2,) * 8, planes=(32, 64, 128, 256, 128, 128, 128, 128), block="basic"),
    "MinkUNet18D": dict(layers=(2,) * 8, planes=(32, 64, 128, 256, 384, 384, 384, 384), block="basic"),
    "MinkUNet34A": dict(layers=(2, 3, 4, 6, 2, 2, 2, 2), planes=(32, 64, 128, 256, 256, 128, 64, 64), block="basic"),
    "MinkUNet34B": dict(layers=(2, 3, 4, 6, 2, 2, 2, 2), planes=(32, 64, 128, 256, 256, 128, 64, 32), block="basic"),
    "MinkUNet34C": dict(layers=(2, 3, 4, 6, 2, 2, 2, 2), planes=(32, 64, 128, 256, 256, 128, 96, 96), block="basic"),
    "MinkUNet50": dict(layers=(2, 3, 4, 6, 2, 2, 2, 2), planes=(32, 64, 128, 256, 256, 128, 96, 96), block="bottleneck"),
    "MinkUNet101": dict(layers=(2, 3, 4, 23, 2, 2, 2, 2), planes=(32, 64, 128, 256, 256, 128, 96, 96), block="bottleneck"),
}


def mink_unet(in_channels: int, out_channels: int, arch: str = "MinkUNet18A",
              generator: torch.Generator | None = None, device=None) -> nn.Module:
    """Factory matching the reference's Mink_unet(); the network starts in
    eval mode, as ``PBNet`` does (``.train()`` switches it)."""
    if arch == "Mini_Unet":
        return MinkMiniUNet(in_channels, out_channels, generator=generator, device=device).eval()
    if arch not in ARCHS:
        raise ValueError(f"architecture {arch} not supported")
    return MinkUNetBase(in_channels, out_channels, generator=generator,
                        device=device, **ARCHS[arch]).eval()
