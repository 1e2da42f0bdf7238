"""Sparse-tensor modules: conv, norm, activation, residual block, MLP head
(port of pbnet_tpu/nn/modules.py, eval mode).

Feature arrays are (M, C) with invalid rows kept at exactly 0 by masking
after every layer, so kernel-map gathers of missing neighbors read zeros.
Parameter names follow the JAX package's flax names (``kernel`` for sparse
convs, ``weight``/``bias`` + running statistics for norms, ``alpha`` for
PReLU); ``convert.py`` maps one onto the other.
"""

from __future__ import annotations

import torch
from torch import nn

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
            kaiming_conv_init((kernel_volume, cin, cout), generator, device),
            requires_grad=False,
        )

    def forward(self, feats, kmap, valid_out, plan=None):
        return sparse_ops.gather_conv(feats, kmap, self.kernel, valid_out, plan=plan)


class SparseLinear(nn.Module):
    """Pointwise linear (ME MinkowskiLinear); ``weight`` is (Cout, Cin)."""

    def __init__(self, cin: int, cout: int, use_bias: bool = True,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        # flax nn.Dense default init: lecun-normal kernel, zero bias
        w = torch.randn((cout, cin), generator=generator, device=device) * (1.0 / cin) ** 0.5
        self.weight = nn.Parameter(w, requires_grad=False)
        self.bias = (
            nn.Parameter(torch.zeros(cout, device=device), requires_grad=False)
            if use_bias else None
        )

    def forward(self, feats, valid):
        y = torch.matmul(feats, self.weight.t())
        if self.bias is not None:
            y = y + self.bias
        return _masked(y, valid)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows with torch semantics (eps 1e-5), eval
    mode: normalises with the running statistics.  The train-mode batch
    statistics come with the training port."""

    def __init__(self, c: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c, device=device), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, feats, valid):
        y = (feats - self.running_mean) * torch.rsqrt(
            self.running_var + self.eps) * self.weight + self.bias
        return _masked(y, valid)


class PReLU(nn.Module):
    """Single-parameter PReLU (init 0.25)."""

    def __init__(self, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25, device=device),
                                  requires_grad=False)

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
        y = torch.relu(self.norm1(self.conv1(feats, kmap3, valid, plan), valid))
        y = self.norm2(self.conv2(y, kmap3, valid, plan), valid)
        if self.downsample_conv is not None:
            skip = self.downsample_norm(self.downsample_conv(feats, valid), valid)
        else:
            skip = feats
        return torch.relu(y + skip)


BLOCKS = {"basic": BasicBlock}
BLOCK_EXPANSION = {"basic": 1}


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
