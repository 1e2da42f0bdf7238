"""The port's train step and loop against the JAX package's.

* Adam, AdamW and SGD (``train_step.make_optimizer``) against their optax
  chains, on identical gradients over 3 steps with a new learning rate each
  step: parameters within rtol 1e-6 / atol 1e-7.  (Adam's first update is
  about ``lr * sign(g)``, so optimizers are compared on fed gradients, never
  through a model.)
* ``freeze_grads`` and ``cosine_lr_after_step`` against JAX's.
* ``convert.optimizer_state_from_optax``: two optax steps, the state carried
  across, a third step on both sides.
* One backbone-phase step (Mini_Unet trio, TINY caps, SGD, a frozen head)
  against JAX's own ``make_train_step`` on a one-device mesh: loss terms,
  gradients (JAX's from ``value_and_grad`` of the same loss), updated
  parameters and BN running statistics.
* One full-phase step, stage 2 driven by oracle semantics and offsets as the
  chip smoke run drives it (the model's own features and softmax), against
  JAX's ``value_and_grad`` of ``model.apply`` with the same composition
  followed by ``losses.model_fn``: cluster ids exactly, loss terms, every
  gradient, BN statistics.
* ``engine.train``: a checkpoint and ``scalars.jsonl`` after 2 iterations, a
  second call resuming at the next epoch in the full phase; CUDA by default.

Conv operands are f32 on both sides.  Loss terms rtol 1e-4 / atol 1e-5; each
gradient within 1e-3 of its tensor's largest magnitude.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from pbnet_tpu import config as jconfig
from pbnet_tpu import engine as jengine
from pbnet_tpu.models import losses as jlosses
from pbnet_tpu.models.pbnet import PBNet as JPBNet
from pbnet_tpu.nn import modules as jmod
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_tpu.parallel import mesh as mesh_lib
from pbnet_tpu.parallel import train_step as jts
from pbnet_torch import convert, engine, synthetic
from pbnet_torch.config import Config
from pbnet_torch.models import losses as tlosses
from pbnet_torch.models.pbnet import PBNet as TPBNet
from pbnet_torch.models.pbnet import batch_to_device
from pbnet_torch.nn import modules as tmod
from pbnet_torch.nn import sparse_ops as tso
from pbnet_torch.parallel import train_step as tts
from tests.test_pbnet import TINY
from tests.test_torch_grad import assert_grad_close

ARCHS = dict(backbone_arch="Mini_Unet", dunet_arch="Mini_Unet", score_arch="Mini_Unet")
# the step tests run two copies of the tiny scene (4 instances, so the IoU
# head's train-mode BN normalises over 4 proposals: over 2 its input
# gradient is rounding noise on both sides).  Without a grid extent: two
# copies overflow the JAX package's local-scene grid at TINY's extent (its
# lookup then drops kernel-map entries), and JAX takes the lookup topology.
SHAPES = dataclasses.replace(TINY, grid_extent=None)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
OPTIMIZERS = ("Adam", "AdamW", "SGD")


def opt_cfg(name, **kw):
    return Config(optimizer=name, lr=1e-3, momentum=0.9, weight_decay=1e-2, **kw)


def jax_tx(cfg):
    return jts.make_optimizer(jconfig.Config(optimizer=cfg.optimizer, lr=cfg.lr,
                                             momentum=cfg.momentum,
                                             weight_decay=cfg.weight_decay))


def head_pair(seed):
    """A flax MLPHead's params and the port's MLPHead carrying them."""
    jh = jmod.MLPHead(16, 3)
    x = jnp.asarray(np.random.RandomState(seed).randn(10, 32).astype(np.float32))
    v = jh.init(jax.random.PRNGKey(seed), x, jnp.ones(10, bool), False)
    v = jax.tree_util.tree_map(np.asarray, v)
    th = tmod.MLPHead(32, 16, 3, device="cpu")
    th.load_state_dict(convert.state_dict_from_jax(v))
    return v["params"], th


def same_params(params, module, rtol=1e-6, atol=1e-7):
    want = convert.state_dict_from_jax({"params": params})
    for n, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=rtol, atol=atol,
                                   err_msg=n)


def jax_steps(tx, params, grads, lrs, state=None):
    state = tx.init(params) if state is None else state
    for g, lr in zip(grads, lrs):
        u, state = tx.update(g, state, params)
        params = optax.apply_updates(params, jax.tree_util.tree_map(lambda x: -lr * x, u))
    return jax.tree_util.tree_map(np.asarray, params), state


def torch_steps(module, opt, grads, lrs):
    for g, lr in zip(grads, lrs):
        gt = convert.state_dict_from_jax({"params": g})
        for n, p in module.named_parameters():
            p.grad = gt[n].clone()
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()


def random_grads(params, seed, n):
    rng = np.random.RandomState(seed)
    return [jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32), params)
            for _ in range(n)]


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name):
    cfg = opt_cfg(name)
    params, th = head_pair(1)
    grads = random_grads(params, 2, 3)
    lrs = (1e-3, 5e-4, 2e-4)
    want, _ = jax_steps(jax_tx(cfg), params, grads, lrs)
    torch_steps(th, tts.make_optimizer(th, cfg), grads, lrs)
    same_params(want, th)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optax_state_conversion(name):
    """Two optax steps, the state carried into the port, one more step on
    both sides from the same parameters."""
    cfg = opt_cfg(name)
    params, th = head_pair(3)
    grads = random_grads(params, 4, 3)
    tx = jax_tx(cfg)
    mid, state = jax_steps(tx, params, grads[:2], (1e-3, 1e-3))
    want, _ = jax_steps(tx, mid, grads[2:], (5e-4,), state)
    th.load_state_dict(convert.state_dict_from_jax({"params": mid}), strict=False)
    opt = tts.make_optimizer(th, cfg)
    opt.load_state_dict(convert.optimizer_state_from_optax(
        jax.tree_util.tree_map(np.asarray, state), th, opt))
    torch_steps(th, opt, grads[2:], (5e-4,))
    same_params(want, th)


def test_freeze_grads_and_cosine_lr_match_jax():
    rng = np.random.RandomState(0)
    tops = ("MEUnet", "linear_offset", "linear_sem", "D_Unet", "score_Unet")
    jgrads = {k: {"a": rng.randn(3).astype(np.float32)} for k in tops}
    fix = ("Unet_backbone", "linear_off", "score_Unet")
    want = jts.freeze_grads(jgrads, fix)
    got = tts.freeze_grads({f"{k}.a": torch.from_numpy(v["a"]) for k, v in jgrads.items()}, fix)
    for k in tops:
        np.testing.assert_array_equal(got[f"{k}.a"].numpy(), np.asarray(want[k]["a"]))
    assert not got["MEUnet.a"].any() and got["D_Unet.a"].any()
    assert tts.FIX_MODULE_MAP == jts.FIX_MODULE_MAP
    for e in (1, 49, 50, 51, 200, 285, 519, 520):
        assert tts.cosine_lr_after_step(1e-3, e, 50, 520) == jts.cosine_lr_after_step(
            1e-3, e, 50, 520)


@pytest.fixture(scope="module")
def f32(fast_compile_module):
    oj, ot = jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = jnp.float32, torch.float32
    yield
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = oj, ot


@pytest.fixture(scope="module")
def setup(f32):
    batch = graft._synthetic_batch(SHAPES, np.random.RandomState(0), n_copies=2)
    jm = JPBNet(shapes=SHAPES, **ARCHS)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda k, b: jm.init(k, b, with_instances=True, with_labels=True,
                                             train=False))(jax.random.PRNGKey(0), jb)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # lift the mask head so that scene points pass the 0.45 cut and the
    # ScoreNet sees proposals
    head = variables["params"]["linear_binary"]["linear2"]["Dense_0"]
    head["bias"] = head["bias"] + np.float32(0.5)
    return dict(batch=batch, jb=jb, variables=variables)


def port_model(variables):
    tm = TPBNet(SHAPES, device="cpu", **ARCHS)
    tm.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
    return tm


def compare_grads_and_stats(tm, grads_j, stats_j):
    want = convert.state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads_j)})
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(want)
    # biases right before a train-mode BN have a zero gradient in exact
    # arithmetic: held to 1e-3 of 1e-3 of the model's largest gradient
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        assert_grad_close(named[n].grad, g, n, floor)
    stats = convert.state_dict_from_jax(
        {"batch_stats": jax.tree_util.tree_map(np.asarray, stats_j)})
    buffers = dict(tm.named_buffers())
    for n, v in stats.items():
        np.testing.assert_allclose(buffers[n].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def compare_aux(aux_t, aux_j):
    assert set(aux_j) <= set(aux_t)
    for k, v in aux_j.items():
        np.testing.assert_allclose(float(aux_t[k]), float(v), err_msg=k, **LOSS_TOL)


def test_backbone_step_matches_jax(setup):
    """JAX's make_train_step on a one-device mesh against the port's step:
    SGD with momentum and weight decay, the offset head frozen."""
    lr, fix = 0.05, ("linear_off",)
    kw = dict(shapes=SHAPES, optimizer="SGD", lr=lr, momentum=0.9, weight_decay=1e-4,
              fix_module=fix, num_devices=1, **ARCHS)
    cfg_j = jconfig.Config(**kw)
    variables, batch = setup["variables"], setup["batch"]
    jm = jengine.build_model(cfg_j, multi_device=False)
    tx = jts.make_optimizer(cfg_j)
    state = jts.TrainState(variables["params"], variables["batch_stats"],
                           tx.init(variables["params"]))
    mesh = mesh_lib.make_mesh(1)
    step_j = jts.make_train_step(jm, cfg_j, mesh, tx, with_instances=False)
    new_state, aux_j = step_j(state, mesh_lib.shard_batch(mesh, [batch]), lr)

    def loss_fn(p):
        ret, upd = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                            setup["jb"], with_instances=False, with_labels=True, train=True,
                            mutable=["batch_stats"])
        return jlosses.model_fn(ret, setup["jb"], cfg_j, False)[0]

    grads_j = jts.freeze_grads(jax.jit(jax.grad(loss_fn))(variables["params"]), fix)

    tm = port_model(variables)
    cfg = Config(**kw)
    opt = tts.make_optimizer(tm, cfg)
    aux = tts.make_train_step(tm, opt, cfg, with_instances=False)(
        batch_to_device(batch, "cpu"), lr)
    compare_aux(aux, aux_j)
    compare_grads_and_stats(tm, grads_j, new_state.batch_stats)
    assert not tm.linear_offset.linear1.weight.grad.any()
    # the SGD update as the gradients (floor included), plus the rounding
    # of the parameter itself
    p1 = convert.state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, new_state.params)})
    p0 = convert.state_dict_from_jax({"params": variables["params"]})
    upd = {n: (p1[n] - p0[n]).numpy() for n in p0}
    floor = 1e-3 * max(np.abs(d).max() for d in upd.values())
    for n, p in tm.named_parameters():
        tol = 1e-3 * max(np.abs(upd[n]).max(), floor) + 4 * np.finfo(np.float32).eps * float(
            p0[n].abs().max())
        assert np.abs((p.detach() - p0[n]).numpy() - upd[n]).max() <= tol, n


def oracle_stage1(batch):
    """The oracle semantics and offsets of the tiny scene (numpy)."""
    sem = np.clip(batch["sem_label"], 0, 19).astype(np.int32)
    offs = np.where((batch["ins_label"] != -100)[:, None],
                    batch["inst_info"][:, 0:3] - batch["xyz"], 0.0).astype(np.float32)
    return sem, offs


STAGE1_KEYS = ("sem_pred_p", "sem_pred_score_p", "offset_pred_p", "point_ok", "overflow_vox",
               "overflow_grid", "overflow_band")


def jax_oracle_forward(self, batch, sem, offs):
    """``PBNet.__call__`` with stage 2 driven by the oracle: the model's own
    stage-1 outputs feed the losses, its features and softmax feed stages
    2-3."""
    bb = self.backbone(batch, True)
    bb2 = dict(bb, sem_pred_p=jnp.where(bb["point_ok"], sem, -1), offset_pred_p=offs)
    ret = {k: bb[k] for k in STAGE1_KEYS}
    ret.update(self.instance_stage(batch, bb2, True, True))
    return ret


def torch_oracle_forward(model, batch, sem, offs):
    bb = model.backbone(batch)
    bb2 = dict(bb, sem_pred_p=torch.where(bb["point_ok"], sem, -1), offset_pred_p=offs)
    ret = {k: bb[k] for k in STAGE1_KEYS}
    ret.update(model.instance_stage(batch, bb2, True))
    return ret


def test_full_phase_step_matches_jax(setup):
    variables, batch = setup["variables"], setup["batch"]
    sem, offs = oracle_stage1(batch)
    cfg = Config(shapes=SHAPES, **ARCHS)
    jm = JPBNet(shapes=SHAPES, **ARCHS)

    def loss_fn(p):
        ret, upd = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                            setup["jb"], jnp.asarray(sem), jnp.asarray(offs),
                            method=jax_oracle_forward, mutable=["batch_stats"])
        loss, aux = jlosses.model_fn(ret, setup["jb"], cfg, True)
        return loss, (aux, upd["batch_stats"], ret["cluster"].cluster_id, ret["mask_scores"])

    (_, (aux_j, stats_j, cid_j, ms_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    ms_j = np.asarray(ms_j)
    # no mask score within 1e-5 of the threshold: the kept flags, and with
    # them the ScoreNet's voxels, are the same on both sides
    assert (np.abs(ms_j - 0.45) >= 1e-5).all()

    tm = port_model(variables).train()
    tb = batch_to_device(batch, "cpu")
    ret = torch_oracle_forward(tm, tb, torch.from_numpy(sem), torch.from_numpy(offs))
    loss, aux = tlosses.model_fn(ret, tb, cfg, True)
    loss.backward()
    np.testing.assert_array_equal(ret["cluster"].cluster_id.numpy(), np.asarray(cid_j))
    assert int(ret["num_final_proposals"]) > 0
    for k in ("mask_loss", "dice_loss", "score_loss"):
        assert aux[k].item() > 0, k
    compare_aux(aux, aux_j)
    compare_grads_and_stats(tm, grads_j, stats_j)
    for name in ("MEUnet", "D_Unet", "score_Unet", "linear_binary", "linear_IOU"):
        assert tts.global_norm(p.grad for p in getattr(tm, name).parameters()) > 0, name
    # the update that follows in the step
    before = tm.D_Unet.conv0.kernel.detach().clone()
    gn, pn = tts.apply_gradients(tm, tts.make_optimizer(tm, cfg), (), 1e-3)
    assert torch.isfinite(gn) and gn > 0 and torch.isfinite(pn)
    assert not torch.equal(before, tm.D_Unet.conv0.kernel)


def engine_cfg(tmp_path, **kw):
    base = dict(shapes=TINY, epochs=3, step_epoch=2, cluster_epoch=1, validation=False,
                save_freq=4, logpath=str(tmp_path / "log"), **ARCHS)
    base.update(kw)
    return Config(**base)


def test_engine_train_checkpoints_and_resumes(tmp_path):
    cfg = engine_cfg(tmp_path)
    ds = synthetic.SyntheticDataset(TINY, n_scenes=2)
    m1, _ = engine.train(cfg, ds, max_epochs=1, max_iters=2, device="cpu")
    assert sorted(f for f in os.listdir(cfg.logpath) if f.endswith(".ckpt")) == ["000000001.ckpt"]
    with open(os.path.join(cfg.logpath, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert {r["step"] for r in rows} == {1}
    tags = {r["tag"] for r in rows}
    assert {"loss_train", "semantic_loss_train", "grad_norm_train",
            "train/learning_rate"} <= tags
    assert "mask_loss_train" not in tags  # epoch 1 is the backbone phase
    # the second call resumes at epoch 2, past cluster_epoch: the full phase
    m2, opt2 = engine.train(cfg, ds, max_epochs=2, max_iters=1, device="cpu")
    assert sorted(f for f in os.listdir(cfg.logpath) if f.endswith(".ckpt")) == [
        "000000002.ckpt"]  # epoch 1 pruned (1 % save_freq != 0)
    with open(os.path.join(cfg.logpath, "scalars.jsonl")) as f:
        rows2 = [json.loads(line) for line in f][len(rows):]
    assert {r["step"] for r in rows2} == {2}
    assert "mask_loss_train" in {r["tag"] for r in rows2}
    assert all(np.isfinite(r["value"]) for r in rows + rows2)
    state = torch.load(os.path.join(cfg.logpath, "000000002.ckpt"), weights_only=True)
    for n, v in m2.state_dict().items():
        assert torch.equal(state["model"][n], v), n
    assert not torch.equal(m1.MEUnet.conv0.kernel, m2.MEUnet.conv0.kernel)


def test_engine_entry_points_refuse(tmp_path):
    """No GPU: the default device raises.  Four ranks asked for on a
    one-scene dataset: the run shrinks to one rank (in this process) with
    the JAX package's warning, and trains."""
    ds = synthetic.SyntheticDataset(TINY, n_scenes=1)
    if not torch.cuda.is_available():  # the default device is CUDA
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.train(engine_cfg(tmp_path), ds)
    cfg = engine_cfg(tmp_path, num_devices=4)
    model, _ = engine.train(cfg, ds, max_epochs=1, max_iters=1, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert sorted(f for f in os.listdir(cfg.logpath) if f.endswith(".ckpt")) == ["000000001.ckpt"]
    log = "".join(open(os.path.join(cfg.logpath, "train", f)).read()
                  for f in os.listdir(os.path.join(cfg.logpath, "train")))
    assert "dataset has only 1 scenes — shrinking to 1 rank(s)" in log
