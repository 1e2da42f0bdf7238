"""The classifier modules against the JAX package's: the instance norm, max
pooling and the ResNet/ResFieldNet classifiers (the bottleneck block and
UNets are in ``test_torch_bottleneck.py``).

Conv operands are f32 on both sides; the JAX variables are carried across
by ``convert.state_dict_from_jax`` (BN statistics randomised where they
act).

* ``MaskedInstanceNorm`` and ``max_pool``: outputs and gradients within
  1e-5.
* ``SparseResNet`` (ResNet14, ResNet50) and ``SparseResFieldNet``
  (ResFieldNet14), eval mode and train mode without dropout: logits within
  1e-4 and every gradient of a fixed projection of them within 1e-3 of
  each tensor's scale (2e-3 in ResNet50, ``GRAD_REL_DEEP``); train-mode BN
  statistics within 1e-4.
* Row dropout: keep rate and scaling, and one ``torch.Generator`` seed
  giving one mask.  The JAX package draws its mask from ``jax.random``,
  which no torch generator reproduces, so the classifiers are compared with
  dropout off.
* Unknown architecture names raise ``ValueError`` (tests/test_extras.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu.core import topology as jtp
from pbnet_tpu.nn import minkunet as jmu
from pbnet_tpu.nn import modules as jmod
from pbnet_tpu.nn import resnet as jres
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_torch import convert
from pbnet_torch.core import topology as ttp
from pbnet_torch.nn import minkunet as tmu
from pbnet_torch.nn import modules as tmod
from pbnet_torch.nn import resnet as tres
from pbnet_torch.nn import sparse_ops as tso
from tests.test_torch_nn import randomise_stats

TOL = dict(rtol=1e-4, atol=1e-4)
# gradients, relative to each tensor's largest magnitude, as test_torch_train
# holds them.  ResNet50 in train mode: every gradient differs by about 8.5e-4
# in relative L2 and up to 1.6e-3 of its scale, the same share in every
# layer (the head's instance norm normalises 6 voxels per item, whose
# backward amplifies the f32 rounding of its input, and the error flows
# down unchanged); it is held at 2e-3
GRAD_REL = 1e-3
GRAD_REL_DEEP = 2e-3


@pytest.fixture(autouse=True)
def f32(monkeypatch):
    monkeypatch.setattr(jso, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tso, "COMPUTE_DTYPE", torch.float32)


def assert_close_to_scale(got, want, name, rel=1e-4, floor=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), floor)
    assert float(np.abs(got - want).max()) <= rel * scale + 1e-12, name


def compare_grads(module, grads_j, rel=GRAD_REL):
    want = convert.state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads_j)})
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(want)
    # a bias right before a train-mode norm has a zero gradient in exact
    # arithmetic: it is held to a floor of 1e-3 of the largest gradient
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        assert_close_to_scale(named[n].grad, g, n, rel, floor)


def test_instance_norm_matches_jax(rng):
    m, c = 80, 6
    x = rng.randn(m, c).astype(np.float32) * 3 + 1
    ids = rng.randint(0, 4, m).astype(np.int32)
    valid = rng.rand(m) < 0.8
    ct = rng.randn(m, c).astype(np.float32)
    jn = jmod.MaskedInstanceNorm(num_batch=4)
    v = jn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ids), jnp.asarray(valid))
    params = {"scale": jnp.asarray(rng.rand(c).astype(np.float32) + 0.5),
              "bias": jnp.asarray(rng.randn(c).astype(np.float32))}
    assert v["params"].keys() == params.keys()

    def loss(p, xx):
        y = jn.apply({"params": p}, xx, jnp.asarray(ids), jnp.asarray(valid))
        return jnp.sum(y * ct), y

    (_, y_j), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tn = tmod.MaskedInstanceNorm(c, num_batch=4)
    tn.load_state_dict(convert.state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, params)}))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tn(xt, torch.from_numpy(ids), torch.from_numpy(valid))
    (y * torch.from_numpy(ct)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(tn.weight.grad.numpy(), np.asarray(gp["scale"]), **tol)
    np.testing.assert_allclose(tn.bias.grad.numpy(), np.asarray(gp["bias"]), **tol)


def test_max_pool_matches_jax(rng):
    m_in, m_out, k, c = 50, 30, 8, 5
    x = rng.randn(m_in, c).astype(np.float32)
    km = rng.randint(-1, m_in, (m_out, k)).astype(np.int32)
    km[rng.rand(m_out, k) < 0.4] = -1
    km[3] = -1  # a row with no entry pools to 0
    valid = rng.rand(m_out) < 0.9
    ct = rng.randn(m_out, c).astype(np.float32)

    def loss(xx):
        y = jso.max_pool(xx, jnp.asarray(km), jnp.asarray(valid))
        return jnp.sum(y * ct), y

    (_, y_j), gx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tso.max_pool(xt, torch.from_numpy(km), torch.from_numpy(valid))
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    assert not y[3].any()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-6, atol=1e-6)


def grid_level(rng, n_blobs=6, per_blob=60, batches=2):
    """A classifier input level (both packages): dense blobs of points far
    apart, so that every level has neighbours to convolve and the coarsest
    (stride 192) several voxels per item for the instance norm."""
    rows = []
    for b in range(batches):
        for _ in range(n_blobs):
            c = rng.randint(0, 700, 3)
            pts = c + rng.randint(0, 12, (per_blob, 3))
            rows.append(np.concatenate([np.full((per_blob, 1), b), pts], 1))
    c = np.unique(np.concatenate(rows).astype(np.int32), axis=0)
    cap = c.shape[0] + 5
    cpad = np.zeros((cap, 4), np.int32)
    cpad[: c.shape[0]] = c
    valid = np.arange(cap) < c.shape[0]
    return (jtp.level_from_coords(jnp.asarray(cpad), jnp.asarray(valid), cap, 1),
            ttp.level_from_coords(torch.from_numpy(cpad), torch.from_numpy(valid), cap, 1))


def classifier_case(rng, field):
    jl, tl = grid_level(rng)
    caps = [jl.cap] * 7
    jt = jres.build_resnet_topology(jl, caps)
    tt = tres.build_resnet_topology(tl, caps)
    assert [lv.stride for lv in tt.levels] == [2, 4, 8, 16, 32, 64, 192]
    for a, b in zip(jt.levels, tt.levels):
        np.testing.assert_array_equal(np.asarray(a.coords), b.coords.numpy())
    for name in ("stem_map", "pool_map", "head_map"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)), getattr(tt, name).numpy())
    jb = [lv.coords[:, 0] for lv in jt.levels]
    tb = [lv.coords[:, 0] for lv in tt.levels]
    valid = np.asarray(jl.valid)
    if not field:
        feats = rng.randn(jl.cap, 3).astype(np.float32) * valid[:, None]
        return jt, tt, jb, tb, (feats,), ()
    # a point field: three points per voxel row
    p2v = np.repeat(np.arange(jl.cap, dtype=np.int32), 3)
    pvalid = valid[p2v]
    pfeats = rng.randn(len(p2v), 3).astype(np.float32) * pvalid[:, None]
    return jt, tt, jb, tb, (pfeats,), (p2v, pvalid, valid)


@pytest.mark.parametrize("arch,train", [("ResNet14", False), ("ResNet14", True),
                                        ("ResNet50", True), ("ResFieldNet14", False),
                                        ("ResFieldNet14", True)])
def test_classifier_matches_jax(rng, fast_compile, arch, train):
    field = arch.startswith("ResField")
    jt, tt, jb, tb, (feats,), extra = classifier_case(rng, field)
    ct = rng.randn(8, 10).astype(np.float32)
    if field:
        jm = jres.sparse_resfieldnet(10, arch)
        tm = tres.sparse_resfieldnet(3, 10, arch, device="cpu")
        jx = tuple(jnp.asarray(a) for a in extra)
        tx = tuple(torch.from_numpy(a) for a in extra)
    else:
        jm = jres.sparse_resnet(10, arch)
        tm = tres.sparse_resnet(3, 10, arch, device="cpu")
        jx, tx = (), ()
    v = jax.jit(lambda t, f, *x: jm.init(jax.random.PRNGKey(2), t, f, *x, jb, False))(
        jt, jnp.asarray(feats), *jx)
    v = randomise_stats(v, 3)
    tm.load_state_dict(convert.state_dict_from_jax(v), strict=True)

    def loss(p, f):
        out, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jt, f, *jx, jb, train,
                            mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, upd["batch_stats"])

    (_, (out_j, st_j)), (gp, gf) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                              has_aux=True))(v["params"],
                                                                             jnp.asarray(feats))
    tm.train(train)
    ft = torch.from_numpy(feats).requires_grad_(True)
    out = tm(tt, ft, *tx, tb)
    (out * torch.from_numpy(ct)).sum().backward()
    out_j = np.asarray(out_j)
    assert np.abs(out_j).max() > 1e-2 and np.isfinite(out.detach().numpy()).all()
    assert_close_to_scale(out.detach(), out_j, "logits")
    rel = GRAD_REL_DEEP if arch == "ResNet50" else GRAD_REL
    assert_close_to_scale(ft.grad, gf, "dfeats", rel)
    compare_grads(tm, gp, rel)
    if train:
        for n, b in convert.state_dict_from_jax(
                {"batch_stats": jax.tree_util.tree_map(np.asarray, st_j)}).items():
            np.testing.assert_allclose(dict(tm.named_buffers())[n].numpy(), b.numpy(),
                                       err_msg=n, **TOL)


def test_row_dropout_keep_rate_and_scale():
    x = torch.ones(20000, 4)
    g = torch.Generator().manual_seed(7)
    y = tres.dropout_rows(x, 0.5, g)
    kept = (y != 0).all(1)
    assert ((y == 0).all(1) | kept).all()  # whole rows
    assert abs(kept.float().mean().item() - 0.5) < 4 * (0.25 / len(x)) ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    y2 = tres.dropout_rows(x, 0.5, torch.Generator().manual_seed(7))
    assert torch.equal(y, y2)
    # the classifier's train forward applies it only with a generator
    rng = np.random.RandomState(0)
    _, tt, _, tb, (feats,), _ = classifier_case(rng, False)
    tm = tres.sparse_resnet(3, 10, "ResNet14", generator=torch.Generator().manual_seed(0),
                            device="cpu").train()
    f = torch.from_numpy(feats)
    with torch.no_grad():
        a, b = tm(tt, f, tb), tm(tt, f, tb)
        d = tm(tt, f, tb, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, d)


def test_unknown_archs_raise():
    with pytest.raises(ValueError):
        tres.sparse_resnet(3, 10, "ResNet7")
    with pytest.raises(ValueError):
        tres.sparse_resfieldnet(3, 10, "ResFieldNet7")
    with pytest.raises(ValueError):
        tmu.mink_unet(6, 32, "MinkUNet7")
    assert tres.RESNET_ARCHS == jres.RESNET_ARCHS
    assert tres.RESFIELD_ARCHS == jres.RESFIELD_ARCHS
    assert tmu.ARCHS == jmu.ARCHS
