"""Sparse ResNet classifier family (port of pbnet_tpu/nn/resnet.py):
ResNet14/18/34/50/101 and the ResFieldNet variants.

Structure: conv k3 s2 + InstanceNorm + ReLU + maxpool k2 s2, four residual
stages each entered with a stride-2 conv (1x1 stride-2 downsample skip), a
dropout + k3 s3 conv + InstanceNorm + GELU head, global max pooling and a
final linear classifier.

ResFieldNet prefixes the classifier with two field blocks over the points:
a sinusoidal embedding ``sin(x @ W + b)`` + BN/ReLU/Linear/BN/ReLU, pooled to
voxels as the per-voxel mean of member points; the second block reads the
first block's voxel features sliced back to the points beside the raw point
features.

Module names follow the JAX package's flax names (``conv1``, ``in1``,
``layer{s}_{i}``, ``conv5``, ``in5``, ``final``, ``field{1,2}_*``,
``resnet``), so ``convert.state_dict_from_jax`` carries its weights.
Dropout draws from a ``torch.Generator`` passed to the forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from ..core import topology as tp
from . import sparse_ops
from .modules import (BLOCK_EXPANSION, BLOCKS, MaskedBatchNorm, MaskedInstanceNorm, SparseConv,
                      SparseLinear)


@dataclass
class ResNetTopology:
    """Levels and kernel maps of the classifier pyramid: strides (2, 4, 8,
    16, 32, 64, 192) relative to the input level."""

    levels: tuple
    stem_map: torch.Tensor  # k3 s2: input -> levels[0]
    pool_map: torch.Tensor  # k2 s2: levels[0] -> levels[1]
    stage_down_maps: tuple  # k3 s2 maps entering each residual stage
    stage_skip_maps: tuple  # k1 s2 maps of the downsample skips
    stage_k3_maps: tuple  # k3 s1 maps inside each stage
    head_map: torch.Tensor  # k3 s3: levels[5] -> levels[6]


def build_resnet_topology(level0: tp.SparseLevel, caps: Sequence[int]) -> ResNetTopology:
    """``caps``: the capacities of the 7 derived levels."""
    l1 = tp.downsample(level0, 2, caps[0])
    l2 = tp.downsample(l1, 2, caps[1])
    levels = [l1, l2]
    downs, skips, k3s = [], [], []
    cur = l2
    for s in range(4):
        nxt = tp.downsample(cur, 2, caps[2 + s])
        downs.append(tp.conv_map(nxt, cur, 3))
        skips.append(tp.conv_map(nxt, cur, 1))
        k3s.append(tp.conv_map(nxt, nxt, 3))
        levels.append(nxt)
        cur = nxt
    l7 = tp.downsample(cur, 3, caps[6])
    levels.append(l7)
    return ResNetTopology(levels=tuple(levels), stem_map=tp.conv_map(l1, level0, 3),
                          pool_map=tp.conv_map(l2, l1, 2), stage_down_maps=tuple(downs),
                          stage_skip_maps=tuple(skips), stage_k3_maps=tuple(k3s),
                          head_map=tp.conv_map(l7, cur, 3))


def dropout_rows(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Drop whole rows with probability ``rate`` and scale the kept ones by
    ``1 / (1 - rate)`` (the JAX package draws the same Bernoulli from
    ``jax.random``)."""
    keep = torch.rand((x.shape[0], 1), generator=generator, device=x.device) < 1.0 - rate
    return x * keep / (1.0 - rate)


class StridedBasicBlock(nn.Module):
    """BasicBlock whose first conv is strided (stage entry)."""

    def __init__(self, inplanes: int, planes: int, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = SparseConv(inplanes, planes, 27, **kw)
        self.norm1 = MaskedBatchNorm(planes, device=device)
        self.conv2 = SparseConv(planes, planes, 27, **kw)
        self.norm2 = MaskedBatchNorm(planes, device=device)
        self.downsample_conv = SparseConv(inplanes, planes, 1, **kw)
        self.downsample_norm = MaskedBatchNorm(planes, device=device)

    def forward(self, feats, down_map, skip_map, k3_map, valid_out):
        y = torch.relu(self.norm1(self.conv1(feats, down_map, valid_out), valid_out))
        y = self.norm2(self.conv2(y, k3_map, valid_out), valid_out)
        skip = self.downsample_norm(self.downsample_conv(feats, skip_map, valid_out), valid_out)
        return torch.relu(y + skip)


class StridedBottleneck(nn.Module):
    """Bottleneck whose 3x3 conv is strided (stage entry), expansion 4.  Its
    first linear and norm run over every input row, as in the JAX package
    (the rows past the level's count are 0 and count in the statistics)."""

    def __init__(self, inplanes: int, planes: int, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = SparseLinear(inplanes, planes, use_bias=False, **kw)
        self.norm1 = MaskedBatchNorm(planes, device=device)
        self.conv2 = SparseConv(planes, planes, 27, **kw)
        self.norm2 = MaskedBatchNorm(planes, device=device)
        self.conv3 = SparseLinear(planes, planes * 4, use_bias=False, **kw)
        self.norm3 = MaskedBatchNorm(planes * 4, device=device)
        self.downsample_conv = SparseConv(inplanes, planes * 4, 1, **kw)
        self.downsample_norm = MaskedBatchNorm(planes * 4, device=device)

    def forward(self, feats, down_map, skip_map, k3_map, valid_out):
        valid_in = torch.ones(feats.shape[0], dtype=torch.bool, device=feats.device)
        y = torch.relu(self.norm1(self.conv1(feats, valid_in), valid_in))
        y = torch.relu(self.norm2(self.conv2(y, down_map, valid_out), valid_out))
        y = self.norm3(self.conv3(y, valid_out), valid_out)
        skip = self.downsample_norm(self.downsample_conv(feats, skip_map, valid_out), valid_out)
        return torch.relu(y + skip)


class SparseResNet(nn.Module):
    """ResNetBase on the port's sparse ops.  ``forward(topo, feats,
    batch_ids_per_level, dropout_generator=None)`` -> (num_batch,
    out_channels) logits; dropout acts in train mode when a generator is
    given."""

    def __init__(self, in_channels: int, out_channels: int,
                 layers: Sequence[int] = (1, 1, 1, 1), planes: Sequence[int] = (64, 128, 256, 512),
                 init_dim: int = 64, block: str = "basic", dropout_rate: float = 0.5,
                 num_batch: int = 8, generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.layers = tuple(layers)
        self.dropout_rate = dropout_rate
        self.num_batch = num_batch
        entry = StridedBottleneck if block == "bottleneck" else StridedBasicBlock
        exp = BLOCK_EXPANSION[block]
        self.conv1 = SparseConv(in_channels, init_dim, 27, **kw)
        self.in1 = MaskedInstanceNorm(init_dim, device=device)
        inp = init_dim
        for s in range(4):
            setattr(self, f"layer{s + 1}_0", entry(inp, planes[s], **kw))
            inp = planes[s] * exp
            for i in range(1, layers[s]):
                setattr(self, f"layer{s + 1}_{i}", BLOCKS[block](inp, planes[s], **kw))
        self.conv5 = SparseConv(inp, planes[3], 27, **kw)
        self.in5 = MaskedInstanceNorm(planes[3], device=device)
        self.final = SparseLinear(planes[3], out_channels, use_bias=True, **kw)

    def forward(self, topo: ResNetTopology, feats, batch_ids_per_level,
                dropout_generator: torch.Generator | None = None):
        v = [lv.valid for lv in topo.levels]
        x = self.conv1(feats, topo.stem_map, v[0])
        x = torch.relu(self.in1(x, batch_ids_per_level[0], v[0]))
        x = sparse_ops.max_pool(x, topo.pool_map, v[1])
        for s in range(4):
            x = getattr(self, f"layer{s + 1}_0")(x, topo.stage_down_maps[s],
                                                 topo.stage_skip_maps[s], topo.stage_k3_maps[s],
                                                 v[2 + s])
            for i in range(1, self.layers[s]):
                x = getattr(self, f"layer{s + 1}_{i}")(x, topo.stage_k3_maps[s], v[2 + s])
        if self.training and dropout_generator is not None:
            x = dropout_rows(x, self.dropout_rate, dropout_generator)
        x = self.conv5(x, topo.head_map, v[6])
        x = self.in5(x, batch_ids_per_level[6], v[6])
        # jax.nn.gelu's default is the tanh approximation
        x = torch.where(v[6][:, None], nn.functional.gelu(x, approximate="tanh"), 0.0)
        pooled = sparse_ops.global_pool(x, batch_ids_per_level[6], v[6], self.num_batch, "max")
        return self.final(pooled, torch.ones(self.num_batch, dtype=torch.bool,
                                             device=pooled.device))


class SparseResFieldNet(nn.Module):
    """ResFieldNetBase: two sinusoidal field blocks over the points, then
    the sparse ResNet on the pooled voxel features."""

    def __init__(self, in_channels: int, out_channels: int,
                 layers: Sequence[int] = (1, 1, 1, 1), planes: Sequence[int] = (64, 128, 256, 512),
                 block: str = "basic", field_ch: int = 32, field_ch2: int = 64,
                 num_batch: int = 8, generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        for name, cin, ch in (("field1", in_channels, field_ch),
                              ("field2", field_ch + in_channels, field_ch2)):
            setattr(self, f"{name}_sinusoidal", SparseLinear(cin, ch, **kw))
            setattr(self, f"{name}_bn1", MaskedBatchNorm(ch, device=device))
            setattr(self, f"{name}_linear", SparseLinear(ch, ch, **kw))
            setattr(self, f"{name}_bn2", MaskedBatchNorm(ch, device=device))
        self.resnet = SparseResNet(field_ch2, out_channels, layers=layers, planes=planes,
                                   block=block, num_batch=num_batch, **kw)

    def _field(self, x, pvalid, name):
        y = torch.sin(getattr(self, f"{name}_sinusoidal")(x, pvalid))
        y = torch.relu(getattr(self, f"{name}_bn1")(y, pvalid))
        y = getattr(self, f"{name}_linear")(y, pvalid)
        return torch.relu(getattr(self, f"{name}_bn2")(y, pvalid))

    @staticmethod
    def _to_sparse(y, p2v, pvalid, cap):
        """The per-voxel mean of member point features."""
        member = pvalid & (p2v >= 0)
        seg = torch.where(member, p2v, cap).to(torch.int64)
        s = torch.zeros((cap + 1, y.shape[1]), dtype=y.dtype, device=y.device).index_add(
            0, seg, torch.where(pvalid[:, None], y, 0.0))[:cap]
        c = torch.zeros(cap + 1, dtype=y.dtype, device=y.device).index_add(
            0, seg, member.to(y.dtype))[:cap]
        return s / torch.clamp(c, min=1.0)[:, None]

    def forward(self, topo: ResNetTopology, point_feats, p2v, point_valid, in_level_valid,
                batch_ids_per_level, dropout_generator: torch.Generator | None = None):
        """``p2v`` (P,): each point's row in the classifier's input voxel
        level (the level ``build_resnet_topology`` was given);
        ``in_level_valid``: that level's validity."""
        cap = in_level_valid.shape[0]
        v1 = self._to_sparse(self._field(point_feats, point_valid, "field1"), p2v, point_valid,
                             cap)
        member = point_valid & (p2v >= 0)
        sl = torch.where(member[:, None], v1[p2v.clamp(0, cap - 1).long()], 0.0)
        y2 = self._field(torch.cat([sl, point_feats], 1), point_valid, "field2")
        v2 = self._to_sparse(y2, p2v, point_valid, cap)
        v2 = torch.where(in_level_valid[:, None], v2, 0.0)
        return self.resnet(topo, v2, batch_ids_per_level, dropout_generator)


RESNET_ARCHS = {
    "ResNet14": dict(layers=(1, 1, 1, 1)),
    "ResNet18": dict(layers=(2, 2, 2, 2)),
    "ResNet34": dict(layers=(3, 4, 6, 3)),
    "ResNet50": dict(layers=(3, 4, 6, 3), block="bottleneck"),
    "ResNet101": dict(layers=(3, 4, 23, 3), block="bottleneck"),
}

RESFIELD_ARCHS = {
    "ResFieldNet14": dict(layers=(1, 1, 1, 1)),
    "ResFieldNet18": dict(layers=(2, 2, 2, 2)),
    "ResFieldNet34": dict(layers=(3, 4, 6, 3)),
    "ResFieldNet50": dict(layers=(3, 4, 6, 3), block="bottleneck"),
    "ResFieldNet101": dict(layers=(3, 4, 23, 3), block="bottleneck"),
}


def sparse_resnet(in_channels: int, out_channels: int, arch: str = "ResNet14",
                  generator: torch.Generator | None = None, device=None) -> SparseResNet:
    if arch not in RESNET_ARCHS:
        raise ValueError(f"unknown ResNet arch {arch}")
    return SparseResNet(in_channels, out_channels, generator=generator, device=device,
                        **RESNET_ARCHS[arch])


def sparse_resfieldnet(in_channels: int, out_channels: int, arch: str = "ResFieldNet14",
                       generator: torch.Generator | None = None,
                       device=None) -> SparseResFieldNet:
    if arch not in RESFIELD_ARCHS:
        raise ValueError(f"unknown ResFieldNet arch {arch}")
    return SparseResFieldNet(in_channels, out_channels, generator=generator, device=device,
                             **RESFIELD_ARCHS[arch])
