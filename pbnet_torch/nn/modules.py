"""Sparse-tensor modules: conv, norms, activation, residual blocks, MLP head
(port of pbnet_tpu/nn/modules.py).

Feature arrays are (M, C) with invalid rows kept at exactly 0 by masking
after every layer, so kernel-map gathers of missing neighbors read zeros.
Parameter names follow the JAX package's flax names (``kernel`` for sparse
convs, ``weight``/``bias`` + running statistics for norms, ``alpha`` for
PReLU); ``convert.py`` maps one onto the other.

SyncBatchNorm: a ``MaskedBatchNorm`` given a process group (``set_bn_group``)
sums its train-mode statistics over the group, as the JAX package's
``axis_name`` ``psum``s them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from . import sparse_ops


def _masked(y, valid):
    return torch.where(valid[:, None], y, 0.0)


def flipped_map(kmap):
    """The transpose of a same-level map with symmetric offsets (offset -d
    sits at column K-1-k), made only where a backward may need it."""
    return kmap.flip(1) if torch.is_grad_enabled() else None


def kaiming_conv_init(shape, generator: torch.Generator | None, device=None):
    """Kaiming-normal fan_out/relu for (K, Cin, Cout) sparse-conv kernels
    (ME.utils.kaiming_normal_)."""
    k, _, cout = shape
    std = (2.0 / (k * cout)) ** 0.5
    return torch.randn(shape, generator=generator, device=device) * std


class SparseConv(nn.Module):
    """Sparse convolution driven by a precomputed kernel map; weight layout
    ``(K, Cin, Cout)`` with offsets x-major, dz fastest."""

    def __init__(self, cin: int, cout: int, kernel_volume: int,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            kaiming_conv_init((kernel_volume, cin, cout), generator, device))

    def forward(self, feats, kmap, valid_out, plan=None, kmap_bwd=None):
        return sparse_ops.gather_conv(feats, kmap, self.kernel, valid_out,
                                      kmap_bwd=kmap_bwd, plan=plan)


class SparseLinear(nn.Module):
    """Pointwise linear (ME MinkowskiLinear); ``weight`` is (Cout, Cin)."""

    def __init__(self, cin: int, cout: int, use_bias: bool = True,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        # flax nn.Dense default init: lecun-normal kernel, zero bias
        w = torch.randn((cout, cin), generator=generator, device=device) * (1.0 / cin) ** 0.5
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if use_bias else None

    def forward(self, feats, valid):
        y = torch.matmul(feats, self.weight.t())
        if self.bias is not None:
            y = y + self.bias
        return _masked(y, valid)


class _AllReduceSum(torch.autograd.Function):
    """A sum over a process group whose backward sums the cotangent over the
    group: the transpose JAX applies to ``psum`` under
    ``shard_map(check_vma=False)``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows with torch semantics (momentum 0.1, eps
    1e-5, unbiased running variance).  Eval mode normalises with the running
    statistics; train mode with the valid rows' statistics in the JAX
    package's formula (E[x^2] - mean^2, not torch's two-pass variance, which
    gives other values and gradients) and updates the running ones.

    With a process ``group`` (SyncBatchNorm) train mode sums the count, sum
    and sum of squares over the group's ranks in one collective before the
    formula.  ``nn.SyncBatchNorm`` cannot mask rows and uses the two-pass
    variance, so it does not serve."""

    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.1, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.group = None
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, feats, valid):
        if self.training:
            vmask = valid[:, None].to(feats.dtype)
            cnt = vmask.sum()
            s = (feats * vmask).sum(0)
            ss = ((feats * feats) * vmask).sum(0)
            if self.group is not None:
                c = s.shape[0]
                stats = _AllReduceSum.apply(torch.cat([cnt.reshape(1), s, ss]), self.group)
                cnt, s, ss = stats[0], stats[1:c + 1], stats[c + 1:]
            cnt = torch.clamp(cnt, min=1.0)
            mean = s / cnt
            var = torch.clamp(ss / cnt - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (feats - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return _masked(y, valid)


def set_bn_group(module: nn.Module, group) -> None:
    """Make every ``MaskedBatchNorm`` under ``module`` a SyncBatchNorm over
    ``group`` (None: per-rank statistics), as the JAX package's modules take
    ``axis_name``."""
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.group = group


class MaskedInstanceNorm(nn.Module):
    """Per-batch-item normalisation over valid rows (ME
    MinkowskiInstanceNorm, used by the ResNet classifier family); items are
    ``batch_ids`` in ``[0, num_batch)``."""

    def __init__(self, c: int, eps: float = 1e-5, num_batch: int = 8, device=None):
        super().__init__()
        self.eps = eps
        self.num_batch = num_batch
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, feats, batch_ids, valid):
        nb = self.num_batch
        seg = torch.where(valid, batch_ids, nb).to(torch.int64)
        vmask = valid[:, None].to(feats.dtype)

        def segment_sum(x):
            return torch.zeros((nb + 1,) + x.shape[1:], dtype=x.dtype,
                               device=x.device).index_add(0, seg, x)

        cnt = torch.clamp(segment_sum(vmask[:, 0]), min=1.0)[:, None]
        mean = segment_sum(feats * vmask) / cnt
        var = torch.clamp(segment_sum(feats * feats * vmask) / cnt - mean * mean, min=0.0)
        row = seg.clamp(0, nb)
        y = (feats - mean[row]) * torch.rsqrt(var[row] + self.eps) * self.weight + self.bias
        return _masked(y, valid)


class PReLU(nn.Module):
    """Single-parameter PReLU (init 0.25)."""

    def __init__(self, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25, device=device))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class BasicBlock(nn.Module):
    """ME resnet_block.BasicBlock: conv3-BN-relu-conv3-BN + skip -> relu."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, kernel_volume: int = 27,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = SparseConv(inplanes, planes, kernel_volume, **kw)
        self.norm1 = MaskedBatchNorm(planes, device=device)
        self.conv2 = SparseConv(planes, planes, kernel_volume, **kw)
        self.norm2 = MaskedBatchNorm(planes, device=device)
        if inplanes != planes * self.expansion:
            self.downsample_conv = SparseLinear(inplanes, planes * self.expansion,
                                                use_bias=False, **kw)
            self.downsample_norm = MaskedBatchNorm(planes * self.expansion, device=device)
        else:
            self.downsample_conv = None

    def forward(self, feats, kmap3, valid, plan=None):
        kb = flipped_map(kmap3)
        y = torch.relu(self.norm1(self.conv1(feats, kmap3, valid, plan, kb), valid))
        y = self.norm2(self.conv2(y, kmap3, valid, plan, kb), valid)
        if self.downsample_conv is not None:
            skip = self.downsample_norm(self.downsample_conv(feats, valid), valid)
        else:
            skip = feats
        return torch.relu(y + skip)


class Bottleneck(nn.Module):
    """ME resnet_block.Bottleneck: linear-BN-relu, conv3-BN-relu,
    linear-BN, + skip -> relu (expansion 4).  A banding plan reaches its
    3x3 conv only."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, kernel_volume: int = 27,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        out = planes * self.expansion
        self.conv1 = SparseLinear(inplanes, planes, use_bias=False, **kw)
        self.norm1 = MaskedBatchNorm(planes, device=device)
        self.conv2 = SparseConv(planes, planes, kernel_volume, **kw)
        self.norm2 = MaskedBatchNorm(planes, device=device)
        self.conv3 = SparseLinear(planes, out, use_bias=False, **kw)
        self.norm3 = MaskedBatchNorm(out, device=device)
        if inplanes != out:
            self.downsample_conv = SparseLinear(inplanes, out, use_bias=False, **kw)
            self.downsample_norm = MaskedBatchNorm(out, device=device)
        else:
            self.downsample_conv = None

    def forward(self, feats, kmap3, valid, plan=None):
        y = torch.relu(self.norm1(self.conv1(feats, valid), valid))
        y = self.conv2(y, kmap3, valid, plan, flipped_map(kmap3))
        y = torch.relu(self.norm2(y, valid))
        y = self.norm3(self.conv3(y, valid), valid)
        if self.downsample_conv is not None:
            skip = self.downsample_norm(self.downsample_conv(feats, valid), valid)
        else:
            skip = feats
        return torch.relu(y + skip)


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}
BLOCK_EXPANSION = {"basic": 1, "bottleneck": 4}


class MLPHead(nn.Module):
    """Linear(bias=False)-BN-PReLU-Linear, optionally sigmoid."""

    def __init__(self, cin: int, hidden: int, out: int, final_sigmoid: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.linear1 = SparseLinear(cin, hidden, use_bias=False, **kw)
        self.norm = MaskedBatchNorm(hidden, device=device)
        self.prelu = PReLU(device=device)
        self.linear2 = SparseLinear(hidden, out, use_bias=True, **kw)
        self.final_sigmoid = final_sigmoid

    def forward(self, feats, valid):
        y = self.norm(self.linear1(feats, valid), valid)
        y = _masked(self.prelu(y), valid)
        y = self.linear2(y, valid)
        if self.final_sigmoid:
            y = _masked(torch.sigmoid(y), valid)
        return y
