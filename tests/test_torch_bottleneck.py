"""The bottleneck block and the bottleneck UNets (MinkUNet50/101) against
the JAX package's.  Conv operands are f32 on both sides; the JAX variables
are carried across by ``convert.state_dict_from_jax`` (BN statistics
randomised where they act).

* ``Bottleneck`` alone, train mode: output within 1e-4 and every gradient
  (input and parameters) within 1e-3 of each tensor's scale; running
  statistics within 1e-4.
* ``mink_unet("MinkUNet50")`` on a 5-level pyramid, eval mode: features
  within 1e-4; ``MinkUNet101`` builds, 23 blocks at stride 8.
* In the banded configuration (``attach_plans``, ``MIN_CIN`` lowered to 32
  so that the narrow widths band, the Pallas kernel in interpret mode) a
  bottleneck UNet at MinkUNet50's planes, one block per stage: within
  1e-4, the banded conv launched at Cin 64 and 128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu.core import topology as jtp
from pbnet_tpu.nn import minkunet as jmu
from pbnet_tpu.nn import modules as jmod
from pbnet_tpu.nn import onehot_conv as joc
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_torch import convert
from pbnet_torch.core import topology as ttp
from pbnet_torch.nn import minkunet as tmu
from pbnet_torch.nn import modules as tmod
from pbnet_torch.nn import onehot_conv as toc
from pbnet_torch.nn import sparse_ops as tso
from tests.test_torch_nn import random_level, randomise_stats
from tests.test_torch_resnet import GRAD_REL, TOL, assert_close_to_scale, compare_grads


@pytest.fixture(autouse=True)
def f32(monkeypatch):
    monkeypatch.setattr(jso, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tso, "COMPUTE_DTYPE", torch.float32)


def levels(rng, n=300, extent=10, cap_extra=8):
    c, valid = random_level(rng, n=n, extent=extent, cap_extra=cap_extra)
    jl = jtp.level_from_coords(jnp.asarray(c), jnp.asarray(valid), len(c), 1)
    tl = ttp.level_from_coords(torch.from_numpy(c), torch.from_numpy(valid), len(c), 1)
    return jl, tl


def test_bottleneck_train_matches_jax(rng):
    jl, tl = levels(rng)
    km = np.asarray(jtp.conv_map(jl, jl, 3))
    valid = np.asarray(jl.valid)
    x = rng.randn(len(valid), 24).astype(np.float32) * valid[:, None]
    ct = rng.randn(len(valid), 64).astype(np.float32)
    jb = jmod.Bottleneck(16)
    v = jb.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(km), jnp.asarray(valid), False)

    def loss(p, xx):
        y, upd = jb.apply({"params": p, "batch_stats": v["batch_stats"]}, xx, jnp.asarray(km),
                          jnp.asarray(valid), True, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, upd["batch_stats"])

    (_, (y_j, st_j)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        v["params"], jnp.asarray(x))
    tb = tmod.Bottleneck(24, 16, device="cpu")
    tb.load_state_dict(convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, v)))
    tb.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tb(xt, torch.from_numpy(km), torch.from_numpy(valid))
    (y * torch.from_numpy(ct)).sum().backward()
    assert_close_to_scale(y.detach(), y_j, "y")
    assert_close_to_scale(xt.grad, gx, "dx", GRAD_REL)
    compare_grads(tb, gp)
    for n, b in convert.state_dict_from_jax(
            {"batch_stats": jax.tree_util.tree_map(np.asarray, st_j)}).items():
        np.testing.assert_allclose(dict(tb.named_buffers())[n].numpy(), b.numpy(), err_msg=n,
                                   **TOL)


def test_minkunet50_forward_matches_jax(rng, fast_compile):
    jl, tl = levels(rng, n=900, extent=14, cap_extra=0)
    caps = [jl.cap] * 5
    jt = jtp.build_unet_topology(jl, caps)
    tt = ttp.build_unet_topology(tl, caps)
    feats = rng.randn(caps[0], 6).astype(np.float32) * np.asarray(jl.valid)[:, None]
    jm = jmu.mink_unet(16, "MinkUNet50")
    variables = randomise_stats(jax.jit(lambda t, f: jm.init(jax.random.PRNGKey(3), t, f, False))(
        jt, jnp.asarray(feats)), 5)
    want = np.asarray(jax.jit(lambda v, t, f: jm.apply(v, t, f, False))(
        variables, jt, jnp.asarray(feats)))
    tm = tmu.mink_unet(6, 16, "MinkUNet50", device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = tm(tt, torch.from_numpy(feats)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **TOL)
    assert isinstance(tm.block1_0, tmod.Bottleneck) and not tm.training
    m101 = tmu.mink_unet(6, 32, "MinkUNet101", device="cpu")
    assert isinstance(m101.block4_22, tmod.Bottleneck) and not hasattr(m101, "block4_23")


def test_bottleneck_unet_banded_matches_jax(monkeypatch, fast_compile):
    """One bottleneck per stage at MinkUNet50's planes, every map with a
    plan that fits it (tiles of 128 rows over levels of 1024, 512, 256 and
    128 rows); the banded conv runs in every block's 3x3 conv and every
    strided and transposed conv of at least 32 input channels."""
    monkeypatch.setattr(joc, "INTERPRET", True)
    monkeypatch.setattr(joc, "MIN_CIN", 32)
    monkeypatch.setattr(toc, "MIN_CIN", 32)
    rng = np.random.RandomState(1)
    xyz = np.unique((rng.rand(900, 3) * np.array([40, 40, 16])).astype(np.int32), axis=0)
    caps = [1024, 512, 256, 128, 128]
    coords = np.zeros((caps[0], 4), np.int32)
    coords[: len(xyz), 1:] = xyz
    valid = np.arange(caps[0]) < len(xyz)
    jl = jtp.level_from_coords(jnp.asarray(coords), jnp.asarray(valid), caps[0], 1)
    tl = ttp.level_from_coords(torch.from_numpy(coords), torch.from_numpy(valid), caps[0], 1)
    arch = dict(tmu.ARCHS["MinkUNet50"], layers=(1,) * 8)
    spans = (256, 256, 256, 128)
    jt = joc.attach_plans(jtp.build_unet_topology(jl, caps), 128, spans)
    tt = toc.attach_plans(ttp.build_unet_topology(tl, caps), 128, spans)
    assert sum(p is not None for p in tt.k3_plans + tt.down_plans + tt.up_plans) >= 6
    assert int(tt.plan_overflow) == int(jt.plan_overflow)
    feats = rng.randn(caps[0], 6).astype(np.float32) * valid[:, None]
    jm = jmu.MinkUNetBase(out_channels=16, **arch)
    variables = randomise_stats(jax.jit(lambda t, f: jm.init(jax.random.PRNGKey(3), t, f, False))(
        jt, jnp.asarray(feats)), 5)
    want = np.asarray(jax.jit(lambda v, t, f: jm.apply(v, t, f, False))(
        variables, jt, jnp.asarray(feats)))
    tm_ = tmu.MinkUNetBase(6, 16, device="cpu", **arch).eval()
    tm_.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
    calls = []
    orig = toc.onehot_conv

    def counting(*a, **kw):
        calls.append(a[2].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(toc, "onehot_conv", counting)
    with torch.no_grad():
        got = tm_(tt, torch.from_numpy(feats)).numpy()
    assert len(calls) >= 8 and {s[1] for s in calls} >= {64, 128}
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **TOL)
