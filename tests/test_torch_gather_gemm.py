"""The gather conv's fused kernel (``nn/sparse_ops.gather_gemm``,
``csrc/gather_gemm.cu``) as far as the CPU reaches it.  The kernel itself
runs only on the card (tests/test_torch_cuda.py, ``cuda`` marker).

* On CPU tensors the wrapper is the plain version ``_conv_fwd``, bit for
  bit, with and without a bias: no build is tried, ``LAUNCHES`` stays as
  it was, and the package imports and runs with no ``nvcc`` anywhere.
* ``gather_conv``'s routes: a gradient wanted without a transposed map
  keeps the plain ops (autograd differentiates them), with it the
  transposed-map backward.
* ``gemm_tiling``, a function of (K, Cin, Cout) alone, gives legal launch
  shapes for every conv of the ``pbnet-34c`` and ``pbnet-minkunet50``
  networks (backbone, D_Unet, ScoreNet): one shared-memory budget, the
  widths padded by less than a step.
* The kernel's one-step mask-and-bias epilogue, in plain torch, equals the
  mask followed by ``gather_conv``'s masked bias add, bit for bit.
* ``gemm_error_bound`` holds the plain version against the exact sum, and
  ``conv.executed_ops`` counts the kernel's padded stem as it runs.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pbnet_torch import _build, telemetry
from pbnet_torch.nn import minkunet
from pbnet_torch.nn import modules as nm
from pbnet_torch.nn import sparse_ops as so

REPO = Path(__file__).resolve().parents[1]

# the networks of the benchmark's two configurations
# (port_bench/configs/pbnet-34c.json, pbnet-minkunet50.json): backbone,
# D_Unet, ScoreNet as (in channels, architecture)
CONFIGS = {
    "pbnet-34c": ((6, "MinkUNet34C"), (34, "MinkUNet14A"), (32, "MinkUNet34C")),
    "pbnet-minkunet50": ((6, "MinkUNet50"), (34, "MinkUNet14A"), (32, "MinkUNet34C")),
}


def conv_case(rng, m_out, m_in, K, cin, cout, present=0.6):
    """A map with absent entries and padding rows (every entry -1, valid
    false), features, weights and a bias."""
    kmap = np.where(rng.rand(m_out, K) < present, rng.randint(0, m_in, (m_out, K)), -1)
    kmap[m_out - 7:] = -1
    valid = rng.rand(m_out) < 0.85
    valid[m_out - 7:] = False
    t = torch.from_numpy
    return (t(rng.randn(m_in, cin).astype(np.float32)), t(kmap.astype(np.int32)),
            t((rng.randn(K, cin, cout) * 0.1).astype(np.float32)), t(valid),
            t(rng.randn(cout).astype(np.float32)))


@pytest.mark.parametrize("with_bias", [False, True])
def test_cpu_wrapper_is_the_plain_version(monkeypatch, with_bias):
    def no_build(name):
        raise AssertionError(f"a build of {name} was tried on the CPU")

    monkeypatch.setattr(_build, "load", no_build)
    feats, kmap, w, valid, bias = conv_case(np.random.RandomState(0), 300, 200, 27, 6, 45)
    bias = bias if with_bias else None
    before = dict(so.LAUNCHES)
    got = so.gather_gemm(feats, kmap, w, valid, bias)
    want = so._conv_fwd(feats, kmap, w, valid, bias)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # gather_conv without a gradient takes the wrapper
    again = so.gather_conv(feats, kmap, w, valid, bias)
    assert torch.equal(again.view(torch.int32), want.view(torch.int32))
    assert so.LAUNCHES == before and so._lib is None
    assert torch.equal(got[~valid], torch.zeros_like(got[~valid]))


def test_gather_conv_routes_under_grad(monkeypatch):
    """Without a transposed map a wanted gradient keeps the plain ops (the
    same values); with one, the transposed-map backward gives the same
    gradients (f32 operands: in bf16 the two round at other places)."""
    monkeypatch.setattr(so, "COMPUTE_DTYPE", torch.float32)
    rng = np.random.RandomState(1)
    feats, kmap, w, valid, _ = conv_case(rng, 120, 120, 27, 8, 16, present=0.5)
    # a same-level map with symmetric offsets: its transpose is the
    # column-reversed map when every input is read at most once per offset
    kmap = torch.from_numpy(np.stack([rng.permutation(120) for _ in range(14)], 1)
                            .astype(np.int32))
    kmap = torch.cat([kmap, kmap[:, :13].flip(1)], 1)
    kb = torch.full_like(kmap, -1)
    for k in range(27):
        kb[kmap[:, k], k] = torch.arange(120, dtype=torch.int32)
    dy = torch.from_numpy(rng.randn(120, 16).astype(np.float32))
    grads = []
    for bwd in (None, kb):
        f = feats.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        y = so.gather_conv(f, kmap, ww, valid, kmap_bwd=bwd)
        assert y.grad_fn is not None
        assert torch.equal(y.detach(), so._conv_fwd(feats, kmap, w, valid))
        y.backward(dy)
        grads.append((f.grad, ww.grad))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def test_imports_and_runs_without_nvcc(tmp_path):
    code = (
        "import torch\n"
        "from pbnet_torch import _build\n"
        "from pbnet_torch.nn import sparse_ops as so\n"
        "try:\n"
        "    _build.find_nvcc()\n"
        "    raise SystemExit('nvcc found')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "kmap = torch.tensor([[0, -1], [1, 0]], dtype=torch.int32)\n"
        "y = so.gather_conv(torch.ones(2, 6), kmap, torch.ones(2, 6, 32),\n"
        "                   torch.tensor([True, False]))\n"
        "assert y.shape == (2, 32) and float(y[0, 0]) == 6.0 and float(y[1].abs().sum()) == 0\n"
        "assert so._lib is None and so.LAUNCHES['gather_gemm'] == 0\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"))
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_tiling_is_legal_for_every_conv(config):
    shapes = set()
    for cin, arch in CONFIGS[config]:
        net = minkunet.mink_unet(cin, 32, arch, device="meta")
        shapes |= {tuple(m.kernel.shape) for m in net.modules() if isinstance(m, nm.SparseConv)}
    assert (125, 6, 32) in shapes and (125, 34, 32) in shapes
    for K, cin, cout in sorted(shapes):
        t = so.gemm_tiling(K, cin, cout)
        assert t == so.gemm_tiling(K, cin, cout) and t.k == K
        assert t.bm in (64, 128) and t.bn in (32, 64, 96, 128)
        assert t.w_pitch >= cout and t.w_pitch - cout < t.bn and t.w_pitch % t.bn == 0
        assert t.cin_p % 8 == 0 and 0 <= t.cin_p - cin < 8
        assert t.depth % so.GEMM_KC == 0 and 0 <= t.depth - K * t.cin_p < so.GEMM_KC
        # two 128-row blocks share an SM; every block fits
        assert t.smem_bytes <= so.SMEM_PER_BLOCK
        if t.bm == 128:
            assert 2 * t.smem_bytes <= so.SMEM_PER_BLOCK
        assert so.gemm_executed_ops(1000, t) >= 2 * 1000 * K * cin * cout
    assert so.gemm_tiling(125, 6, 32).cin_p == 8  # the stem's 16-byte rows


def test_epilogue_is_the_two_masked_steps():
    rng = np.random.RandomState(2)
    y = torch.from_numpy(rng.randn(500, 40).astype(np.float32) * 1e3)
    y[::7] = -0.0
    y[1, :3] = torch.tensor([float("inf"), 3.4e38, 1e-45])
    bias = torch.from_numpy(rng.randn(40).astype(np.float32))
    bias[5] = -0.0
    valid = torch.from_numpy(rng.rand(500) < 0.7)
    v = valid[:, None]
    two_step = torch.where(v, torch.where(v, y, 0.0) + bias, 0.0)
    assert torch.equal(so.conv_epilogue(y, valid, bias).view(torch.int32),
                       two_step.view(torch.int32))
    assert torch.equal(so.conv_epilogue(y, valid).view(torch.int32),
                       torch.where(v, y, 0.0).view(torch.int32))


@pytest.mark.parametrize("K,cin,cout", [(125, 6, 32), (27, 64, 48), (8, 96, 96)])
def test_error_bound_holds_the_plain_sum(K, cin, cout):
    feats, kmap, w, valid, _ = conv_case(np.random.RandomState(K + cin), 400, 300, K, cin, cout)
    plain = so._conv_fwd(feats, kmap, w, valid)
    g = so.take_rows0(feats.to(torch.bfloat16).double(), kmap).reshape(400, K * cin)
    exact = torch.where(valid[:, None],
                        g @ w.to(torch.bfloat16).double().reshape(K * cin, cout), 0.0)
    bound = so.gemm_error_bound(feats, kmap, w).double()
    assert bool(((plain.double() - exact).abs() <= bound / 2).all())
    assert float(bound.max()) > 0


def test_executed_ops_count_the_padded_stem():
    t = so.gemm_tiling(125, 6, 32)
    assert (t.cin_p, t.depth, t.w_pitch) == (8, 1024, 32)
    assert so.gemm_executed_ops(1000, t) == 2 * 1000 * 1024 * 32
    # the plain version counts its own unpadded work, and its route
    feats, kmap, w, valid, _ = conv_case(np.random.RandomState(3), 64, 64, 125, 6, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        so.gather_gemm(feats, kmap, w, valid)
    c = telemetry.collected()["counts"]
    assert c["conv.executed_ops"]["total"] == 2 * 64 * 125 * 6 * 32
    assert c["conv.gather_plain"]["total"] == 1 and "gather_gemm" not in c
