"""Sparse-tensor modules of the plain reference (a frozen copy of the port's
``pbnet_torch/nn/modules.py``): conv, batch norm in eval and train mode,
PReLU, residual blocks, MLP head.  Invalid rows stay exactly 0."""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ... import work
from . import sparse_ops


def _masked(y, valid):
    return torch.where(valid[:, None], y, 0.0)


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

    def forward(self, feats, kmap, valid_out):
        return sparse_ops.gather_conv(feats, kmap, self.kernel, valid_out)


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
        if work.ACTIVE:
            work.dense(valid, *self.weight.shape[::-1])
        y = torch.matmul(feats, self.weight.t())
        if self.bias is not None:
            y = y + self.bias
        return _masked(y, valid)


class _AllReduceSum(torch.autograd.Function):
    """A sum over a process group whose backward sums the cotangent over the
    group (SyncBatchNorm's statistics), through host memory so that any
    backend serves."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _host_sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _host_sum(dy, ctx.group), None


def _host_sum(x, group):
    y = x.detach().cpu().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.device)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows (momentum 0.1, eps 1e-5, unbiased running
    variance; train mode in the E[x^2] - mean^2 formula).  With a process
    ``group`` train mode sums the count, sum and sum of squares over its
    ranks first (SyncBatchNorm)."""

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
    ``group``."""
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.group = group


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

    def forward(self, feats, kmap3, valid):
        y = torch.relu(self.norm1(self.conv1(feats, kmap3, valid), valid))
        y = self.norm2(self.conv2(y, kmap3, valid), valid)
        if self.downsample_conv is not None:
            skip = self.downsample_norm(self.downsample_conv(feats, valid), valid)
        else:
            skip = feats
        return torch.relu(y + skip)


class Bottleneck(nn.Module):
    """ME resnet_block.Bottleneck: linear-BN-relu, conv3-BN-relu,
    linear-BN, + skip -> relu (expansion 4). """

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

    def forward(self, feats, kmap3, valid):
        y = torch.relu(self.norm1(self.conv1(feats, valid), valid))
        y = self.conv2(y, kmap3, valid)
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
