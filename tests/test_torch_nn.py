"""The port's sparse NN layer (pbnet_torch/nn) against the JAX package's.

Both packages run their conv operands in f32 here (``COMPUTE_DTYPE``), the
JAX variables are carried across by ``pbnet_torch.convert`` and the BN
running statistics are randomised so every norm does real work.

Tolerance: rtol 1e-4, atol 1e-5 for single ops; 1e-4 / 1e-4 for whole
UNets.  Both sides multiply the same f32 operands, but the GEMM libraries
(XLA:CPU vs PyTorch's) sum the K*Cin products in different orders, and a
deep UNet compounds ~1e-6 relative differences over ~30 layers.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu.core import topology as jtp
from pbnet_tpu.nn import minkunet as jmu
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_torch import convert
from pbnet_torch.core import topology as ttp
from pbnet_torch.nn import minkunet as tmu
from pbnet_torch.nn import sparse_ops as tso


@contextlib.contextmanager
def f32_both():
    oj, ot = jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        yield
    finally:
        jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = oj, ot


def random_level(rng, n=200, extent=8, cap_extra=8, batches=2):
    c = np.unique(np.stack([rng.randint(0, batches, n)]
                           + [rng.randint(0, extent, n) for _ in range(3)], 1), axis=0)
    cap = len(c) + cap_extra
    cp = np.zeros((cap, 4), np.int32)
    cp[: len(c)] = c
    valid = np.arange(cap) < len(c)
    return cp, valid


def test_gather_conv_matches_jax(rng):
    c, valid = random_level(rng)
    lv = jtp.level_from_coords(jnp.asarray(c), jnp.asarray(valid), len(c), 1)
    km = np.array(jtp.conv_map(lv, lv, 3))
    assert (km == -1).any()
    # the LAST row is real data: a -1 entry that wrapped would read it
    feats = rng.randn(len(c), 5).astype(np.float32)
    w = rng.randn(27, 5, 7).astype(np.float32)
    bias = rng.randn(7).astype(np.float32)
    vout = np.asarray(lv.valid)
    with f32_both():
        want = jso.gather_conv(jnp.asarray(feats), jnp.asarray(km), jnp.asarray(w),
                               jnp.asarray(vout), jnp.asarray(bias))
        got = tso.gather_conv(torch.from_numpy(feats), torch.from_numpy(km),
                              torch.from_numpy(w), torch.from_numpy(vout),
                              torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # -1 reads zeros: a map of all -1 gives bias on valid rows only
    got0 = tso.gather_conv(torch.from_numpy(feats), torch.full_like(torch.from_numpy(km), -1),
                           torch.from_numpy(w), torch.from_numpy(vout), torch.from_numpy(bias))
    np.testing.assert_array_equal(got0.numpy(), np.where(vout[:, None], bias[None], 0.0))


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_global_pool_matches_jax(rng, mode):
    feats = rng.randn(40, 6).astype(np.float32)
    ids = rng.randint(0, 5, 40).astype(np.int32)
    valid = rng.rand(40) < 0.8
    valid[ids == 3] = False  # an empty segment pools to 0
    want = jso.global_pool(jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(valid), 6, mode)
    got = tso.global_pool(torch.from_numpy(feats), torch.from_numpy(ids),
                          torch.from_numpy(valid), 6, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def randomise_stats(variables, seed):
    """BN running stats away from (0, 1) so eval-mode norms matter."""
    r = np.random.RandomState(seed)

    def f(path, x):
        name = path[-1].key
        if name == "mean":
            return r.randn(*x.shape).astype(np.float32) * 0.1
        if name == "var":
            return r.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return np.asarray(x)

    return {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(f, variables["batch_stats"])}


@pytest.mark.parametrize("arch,cin", [("MinkUNet34C", 6), ("MinkUNet14A", 34), ("Mini_Unet", 32)])
def test_unet_forward_matches_jax(rng, arch, cin):
    c, valid = random_level(rng, n=300, extent=10)
    cap = len(c)
    caps = [cap] * (2 if arch == "Mini_Unet" else 5)
    jl = jtp.level_from_coords(jnp.asarray(c), jnp.asarray(valid), cap, 1)
    jt = jtp.build_unet_topology(jl, caps)
    tl = ttp.level_from_coords(torch.from_numpy(c), torch.from_numpy(valid), cap, 1)
    tt = ttp.build_unet_topology(tl, caps)
    feats = rng.randn(cap, cin).astype(np.float32) * np.asarray(jl.valid)[:, None]

    jm = jmu.mink_unet(16, arch)
    with f32_both():
        variables = jax.jit(lambda t, f: jm.init(jax.random.PRNGKey(3), t, f, False))(
            jt, jnp.asarray(feats))
        variables = randomise_stats(variables, 5)
        want = jax.jit(lambda v, t, f: jm.apply(v, t, f, False))(variables, jt, jnp.asarray(feats))
        tm = tmu.mink_unet(cin, 16, arch, device="cpu")
        tm.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
        with torch.no_grad():
            got = tm(tt, torch.from_numpy(feats))
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
