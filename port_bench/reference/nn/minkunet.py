"""MinkUNet family of the plain reference (a frozen copy of the port's
``pbnet_torch/nn/minkunet.py`` on its gather path): stem k=5 conv -> 4
encoder stages (k=2 s=2 conv + residual blocks) -> 4 decoder stages (k=2 s=2
transposed conv + skip concat + residual blocks) -> 1x1 head.  Kernel maps
come from a :class:`~port_bench.reference.core.topology.UNetTopology` that
the reference builds itself."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.topology import UNetTopology
from .modules import BLOCK_EXPANSION, BLOCKS, MaskedBatchNorm, SparseConv, SparseLinear

STEM_VOLUME = 125  # k=5 stem


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

    def _blocks(self, name, n, x, kmap, valid):
        for i in range(n):
            x = getattr(self, f"{name}_{i}")(x, kmap, valid)
        return x

    def forward(self, topo: UNetTopology, feats: torch.Tensor) -> torch.Tensor:
        v = [lv.valid for lv in topo.levels]
        out_p1 = torch.relu(self.bn0(
            self.conv0(feats, topo.stem_map, v[0]), v[0]))

        enc = []
        x = out_p1
        for s in range(4):
            x = getattr(self, f"conv{s+1}s2")(x, topo.down_maps[s], v[s + 1])
            x = torch.relu(getattr(self, f"bn{s+1}")(x, v[s + 1]))
            x = self._blocks(f"block{s+1}", self.layers[s], x, topo.k3_maps[s + 1], v[s + 1])
            enc.append(x)

        # decoder: levels 3, 2, 1, 0 with skips enc[2], enc[1], enc[0], out_p1
        skips = [enc[2], enc[1], enc[0], out_p1]
        for d in range(4):
            lvl = 3 - d
            x = getattr(self, f"convtr{4+d}")(x, topo.up_maps[lvl], v[lvl])
            x = torch.relu(getattr(self, f"bntr{4+d}")(x, v[lvl]))
            x = torch.cat([x, skips[d]], 1)
            x = self._blocks(f"block{5+d}", self.layers[4 + d], x, topo.k3_maps[lvl], v[lvl])
        return self.final(x, v[0])

