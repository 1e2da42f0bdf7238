"""The port's gradients against the JAX package's, module by module.

* the gather conv's backward (``_GatherConv``: a gather of ``dy`` through the
  transposed map and two GEMMs) against ``jax.vjp`` of JAX's custom-VJP core
  ``_gather_conv_core``, for a k3 map with its column flip, the k5 stem, a
  strided (down) map with the up map and a transposed (up) map with the down
  map, on a level with padding rows and missing entries; and against the
  port's own plain autograd (a scatter-add), which must give the same;
* ``MaskedBatchNorm`` in train mode against flax: output, gradients, and the
  running statistics from ``mutable=["batch_stats"]``;
* a Mini_Unet in train mode: ``value_and_grad`` of a weighted sum of its
  outputs, every parameter's gradient and every running statistic;
* every loss function's value and gradient, and ``ops/iou.py``;
* no banding plan where a gradient is wanted.

Conv operands are f32 on both sides.  Tolerances: values rtol 1e-4 / atol
1e-5; each gradient within 1e-3 of its tensor's largest magnitude (the GEMMs
of XLA:CPU and PyTorch sum in different orders, and BN divides by a batch
standard deviation); IoU matrices and labels exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu.core import topology as jtp
from pbnet_tpu.models import losses as jlosses
from pbnet_tpu.nn import minkunet as jmu
from pbnet_tpu.nn import modules as jmod
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_tpu.ops import iou as jiou
from pbnet_torch import convert, synthetic
from pbnet_torch.core import topology as ttp
from pbnet_torch.models import losses as tlosses
from pbnet_torch.models.pbnet import PBNet, batch_to_device
from pbnet_torch.nn import minkunet as tmu
from pbnet_torch.nn import modules as tmod
from pbnet_torch.nn import onehot_conv as toc
from pbnet_torch.nn import sparse_ops as tso
from pbnet_torch.ops import iou as tiou
from tests.test_torch_nn import f32_both, random_level, randomise_stats

VAL = dict(rtol=1e-4, atol=1e-5)


def assert_grad_close(got, want, name="", floor=0.0):
    """|got - want| within 1e-3 of want's largest magnitude, or of ``floor``
    where that is larger (a gradient that is zero in exact arithmetic, such
    as a bias right before a train-mode BN, is rounding noise on both
    sides)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), floor)
    assert float(np.abs(got - want).max()) <= 1e-3 * scale + 1e-12, name


def t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.fixture(scope="module")
def topo():
    c, valid = random_level(np.random.RandomState(4), n=300, extent=9, cap_extra=10)
    jl = jtp.level_from_coords(jnp.asarray(c), jnp.asarray(valid), len(c), 1)
    jt = jtp.build_unet_topology(jl, [len(c), len(c)])
    return jax.tree_util.tree_map(np.asarray, jt)


CASES = {  # name -> (forward map, backward map, input level, output level)
    "k3": (lambda tp: tp.k3_maps[0], lambda tp: tp.k3_maps[0][:, ::-1], 0, 0),
    "stem": (lambda tp: tp.stem_map, lambda tp: tp.stem_map[:, ::-1], 0, 0),
    "down": (lambda tp: tp.down_maps[0], lambda tp: tp.up_maps[0], 0, 1),
    "up": (lambda tp: tp.up_maps[0], lambda tp: tp.down_maps[0], 1, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_conv_vjp_matches_jax(topo, case):
    fmap, bmap, lin, lout = CASES[case]
    km, kb = np.ascontiguousarray(fmap(topo)), np.ascontiguousarray(bmap(topo))
    assert (km == -1).any() and (kb == -1).any()
    rng = np.random.RandomState(len(case))
    m_in, vout = topo.levels[lin].valid.shape[0], topo.levels[lout].valid
    assert not vout.all()
    cin, cout, k = 5, 7, km.shape[1]
    feats = rng.randn(m_in, cin).astype(np.float32) * topo.levels[lin].valid[:, None]
    w = rng.randn(k, cin, cout).astype(np.float32)
    dy = rng.randn(km.shape[0], cout).astype(np.float32)
    kz = {125: 5, 27: 3, 8: 2}[k]
    dummy = jnp.zeros((1,), bool)
    with f32_both():
        y, vjp = jax.vjp(lambda f, ww: jso._gather_conv_core(
            (kz, False, False), f, jnp.asarray(km), jnp.asarray(kb), ww, jnp.asarray(vout),
            dummy, dummy), jnp.asarray(feats), jnp.asarray(w))
        dx_j, dw_j = vjp(jnp.asarray(dy))
        grads = {}
        for path, bwd in (("transposed", t(kb)), ("plain", None)):
            f, ww = t(feats, True), t(w, True)
            yt = tso.gather_conv(f, t(km), ww, t(vout), kmap_bwd=bwd)
            yt.backward(t(dy))
            np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **VAL)
            grads[path] = (f.grad.numpy(), ww.grad.numpy())
    for path, (dx, dw) in grads.items():
        assert_grad_close(dx, dx_j, f"{case} {path} dx")
        assert_grad_close(dw, dw_j, f"{case} {path} dw")
    # the transposed map's gradient is the scatter-add's, row for row
    np.testing.assert_allclose(grads["transposed"][0], grads["plain"][0], rtol=1e-5, atol=1e-5)


def test_batchnorm_train_matches_flax():
    rng = np.random.RandomState(7)
    c, m = 6, 50
    feats = (rng.randn(m, c) * 2 + 1).astype(np.float32)
    valid = rng.rand(m) < 0.7
    gamma, beta = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    mean0, var0 = rng.randn(c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    r = rng.randn(m, c).astype(np.float32)
    bn = jmod.MaskedBatchNorm()
    variables = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def f(x, params):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                          jnp.asarray(valid), True, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, upd["batch_stats"])

    (loss_j, (y_j, st_j)), (gx_j, gp_j) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feats), variables["params"])

    mod = tmod.MaskedBatchNorm(c, device="cpu").train()
    mod.load_state_dict({"weight": t(gamma), "bias": t(beta), "running_mean": t(mean0),
                         "running_var": t(var0)})
    x = t(feats, True)
    y = mod(x, t(valid))
    (y * t(r)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **VAL)
    assert_grad_close(x.grad, gx_j, "x")
    assert_grad_close(mod.weight.grad, gp_j["scale"], "scale")
    assert_grad_close(mod.bias.grad, gp_j["bias"], "bias")
    np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(st_j["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(st_j["var"]),
                               rtol=1e-6, atol=1e-6)
    # eval mode reads the running statistics and leaves them as they are
    mod.eval()
    y2 = mod(x.detach(), t(valid))
    want = np.where(valid[:, None], (feats - mod.running_mean.numpy()) / np.sqrt(
        mod.running_var.numpy() + 1e-5) * gamma + beta, 0.0)
    np.testing.assert_allclose(y2.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(st_j["mean"]), rtol=1e-6)


def test_mini_unet_grad_matches_jax(fast_compile_module):
    rng = np.random.RandomState(3)
    c, valid = random_level(rng, n=300, extent=10)
    cap = len(c)
    jl = jtp.level_from_coords(jnp.asarray(c), jnp.asarray(valid), cap, 1)
    jt = jtp.build_unet_topology(jl, [cap, cap])
    tl = ttp.level_from_coords(t(c), t(valid), cap, 1)
    tt = ttp.build_unet_topology(tl, [cap, cap])
    feats = rng.randn(cap, 6).astype(np.float32) * np.asarray(jl.valid)[:, None]
    r = rng.randn(cap, 16).astype(np.float32)
    jm = jmu.mink_unet(16, "Mini_Unet")
    with f32_both():
        variables = jax.jit(lambda tp, f: jm.init(jax.random.PRNGKey(3), tp, f, False))(
            jt, jnp.asarray(feats))
        variables = randomise_stats(variables, 5)

        def loss_fn(params, tp, f):
            y, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              tp, f, True, mutable=["batch_stats"])
            return jnp.sum(y * r), upd["batch_stats"]

        (loss_j, stats_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], jt, jnp.asarray(feats))
        tm = tmu.mink_unet(6, 16, "Mini_Unet", device="cpu")
        tm.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
        tm.train()
        loss = (tm(tt, t(feats)) * t(r)).sum()
        loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    want = convert.state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads_j)})
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for n in want:
        assert_grad_close(got[n], want[n], n)
    stats = convert.state_dict_from_jax(
        {"batch_stats": jax.tree_util.tree_map(np.asarray, stats_j)})
    buffers = dict(tm.named_buffers())
    for n, v in stats.items():
        np.testing.assert_allclose(buffers[n].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def loss_inputs(rng, n=300):
    valid = rng.rand(n) < 0.85
    ins = np.where(rng.rand(n) < 0.7, rng.randint(0, 5, n), -100).astype(np.int32)
    return valid, ins


def test_semantic_and_offset_losses_match_jax():
    rng = np.random.RandomState(11)
    n = 300
    valid, ins = loss_inputs(rng, n)
    logits = rng.randn(n, 20).astype(np.float32) * 2
    sem = np.where(rng.rand(n) < 0.8, rng.randint(0, 20, n), -100).astype(np.int32)
    offs = rng.randn(n, 3).astype(np.float32) * 0.3
    xyz = rng.rand(n, 3).astype(np.float32) * 4
    info = np.full((n, 9), -100.0, np.float32)
    info[:, :3] = np.where((ins >= 0)[:, None], rng.rand(5, 3)[np.clip(ins, 0, 4)] * 4, -100.0)

    (js, jgl) = jax.value_and_grad(jlosses.semantic_loss)(jnp.asarray(logits), jnp.asarray(sem),
                                                          jnp.asarray(valid))
    lg = t(logits, True)
    ts_ = tlosses.semantic_loss(lg, t(sem), t(valid))
    ts_.backward()
    np.testing.assert_allclose(ts_.item(), float(js), **VAL)
    assert_grad_close(lg.grad, jgl, "logits")

    for term in (0, 1):
        jv, jg = jax.value_and_grad(lambda o: jlosses.offset_losses(
            o, jnp.asarray(xyz), jnp.asarray(info), jnp.asarray(ins), jnp.asarray(valid))[term])(
            jnp.asarray(offs))
        o = t(offs, True)
        tv = tlosses.offset_losses(o, t(xyz), t(info), t(ins), t(valid))[term]
        tv.backward()
        np.testing.assert_allclose(tv.item(), float(jv), **VAL)
        assert_grad_close(o.grad, jg, f"offset term {term}")


def test_mask_and_score_losses_match_jax():
    rng = np.random.RandomState(12)
    T, P, I = 400, 8, 6
    valid = rng.rand(T) < 0.8
    pred = rng.uniform(0.02, 0.98, T).astype(np.float32)
    gt = rng.choice([-1.0, 0.0, 1.0], T).astype(np.float32)
    for term in (0, 1):
        jv, jg = jax.value_and_grad(lambda p: jlosses.mask_losses(
            p, jnp.asarray(gt), jnp.asarray(valid))[term])(jnp.asarray(pred))
        p = t(pred, True)
        tv = tlosses.mask_losses(p, t(gt), t(valid))[term]
        tv.backward()
        np.testing.assert_allclose(tv.item(), float(jv), **VAL)
        assert_grad_close(p.grad, jg, f"mask term {term}")

    pid = rng.randint(-1, P, T).astype(np.int32)
    pins = np.where(rng.rand(T) < 0.8, rng.randint(0, I, T), -100).astype(np.int32)
    kept = rng.rand(T) < 0.7
    pointnum = (np.bincount(np.clip(pins, 0, None), minlength=I)[:I] + 3).astype(np.int32)
    scores = rng.uniform(0.05, 0.95, P).astype(np.float32)
    pvalid = np.arange(P) < 6
    args = (pvalid, pid, pins, kept, pointnum)
    jv, jg = jax.value_and_grad(lambda s: jlosses.score_loss(
        s, *(jnp.asarray(a) for a in args), 0.95, 0.2, P, I))(jnp.asarray(scores))
    s = t(scores, True)
    tv = tlosses.score_loss(s, *(t(a) for a in args), 0.95, 0.2, P, I)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **VAL)
    assert_grad_close(s.grad, jg, "clt_scores")
    x = np.linspace(-0.2, 1.2, 57).astype(np.float32)
    np.testing.assert_allclose(tlosses.get_segmented_scores(t(x), 0.95, 0.2).numpy(),
                               np.asarray(jlosses.get_segmented_scores(jnp.asarray(x), 0.95, 0.2)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", [0, 1])
def test_iou_matches_jax(mode):
    rng = np.random.RandomState(20 + mode)
    T, P, I = 500, 10, 7
    pins = np.where(rng.rand(T) < 0.8, rng.randint(-1, I + 1, T), -100).astype(np.int32)
    # proposals mostly follow instances (IoU above 0.5), the rest at random
    pid = np.where(rng.rand(T) < 0.8, np.abs(pins) % P, rng.randint(-2, P + 1, T)).astype(np.int32)
    valid = rng.rand(T) < 0.8
    scores = np.where(rng.rand(T) < 0.9, 0.9, 0.2).astype(np.float32)  # mode 1: > 0.5
    pointnum = (np.bincount(np.clip(pins, 0, I - 1), minlength=I)[:I] + rng.randint(0, 4, I)
                ).astype(np.int32)
    ious_j = np.asarray(jiou.proposal_instance_iou(
        jnp.asarray(pid), jnp.asarray(pins), jnp.asarray(valid), jnp.asarray(pointnum), P, I))
    ious_t = tiou.proposal_instance_iou(t(pid), t(pins), t(valid), t(pointnum), P, I).numpy()
    np.testing.assert_array_equal(ious_t, ious_j)
    assert (ious_j > 0.5).any() and (ious_j > 0).sum() > P
    jl = jiou.iou_and_mask_label(*(jnp.asarray(a) for a in (pid, pins, valid, scores, pointnum)),
                                 P, I, mode)
    tl = tiou.iou_and_mask_label(*(t(a) for a in (pid, pins, valid, scores, pointnum)), P, I, mode)
    for g, w in zip(tl, jl):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert set(np.unique(tl[1].numpy())) == {-1.0, 0.0, 1.0}


def test_plan_raises_where_a_gradient_is_wanted():
    rng = np.random.RandomState(5)
    km = np.where(rng.rand(256, 27) < 0.3, rng.randint(0, 256, (256, 27)), -1).astype(np.int32)
    km = np.sort(km, 0)  # rows with nearby inputs, so the plan bands them
    plan = toc.build_onehot_plan(t(km), 3, 256, tm=128, span=256)
    feats = t(rng.randn(256, toc.MIN_CIN).astype(np.float32))
    w = t(rng.randn(27, toc.MIN_CIN, 8).astype(np.float32), True)
    valid = t(np.ones(256, bool))
    with pytest.raises(RuntimeError, match="no backward"):
        tso.gather_conv(feats, t(km), w, valid, plan=plan)
    with torch.no_grad():
        y = tso.gather_conv(feats, t(km), w, valid, plan=plan)
    assert y.shape == (256, 8) and torch.isfinite(y).all()


def test_train_mode_attaches_no_plans():
    sh = dataclasses.replace(synthetic.GRAFT_SHAPES, onehot_tm=128, onehot_spans=(256, 128))
    m = PBNet(sh, device="cpu", backbone_arch="Mini_Unet", dunet_arch="Mini_Unet",
              score_arch="Mini_Unet")
    b = batch_to_device(synthetic.synthetic_batch(sh, np.random.RandomState(0)), "cpu")
    assert any(p is not None for p in m.backbone(b)["topo"].k3_plans)
    m.train()
    bb = m.backbone(b)
    assert not any(p is not None for p in bb["topo"].k3_plans)
    assert bb["point_feat_p"].requires_grad
