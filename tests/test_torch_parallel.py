"""The port's data parallelism against the JAX package's, on the CPU.

The JAX side runs in this process on the conftest's host devices (a
2-device mesh); the port's side runs in two gloo rank processes
(``tests/torch_parallel_worker.py``, started with
``distributed.spawn``), which import no JAX.  Every multi-process call
joins its ranks within ``JOIN_TIMEOUT_S`` or kills them and fails.

* SyncBatchNorm: ``MaskedBatchNorm`` over 2 ranks against JAX's
  ``MaskedBatchNorm(axis_name=...)`` under ``shard_map`` on 2 devices
  (gradients ``pmean``-ed, as the train step does): output, input and
  parameter gradients and running statistics within 1e-5.  This fixes the
  factor of the gradient through the summed statistics.
* The backbone-phase step on 2 ranks (different batches, ``sync_bn``,
  Adam) against JAX's ``make_train_step`` on a 2-device mesh: every aux
  value within rtol 1e-4; the averaged gradients (Adam's first moments
  over 0.1) within 1e-3 of each tensor's scale; every parameter update
  within 1e-3 of the learning rate where the gradient is not rounding
  noise; BN statistics within rtol 1e-4; both ranks' parameters and
  statistics bit-identical.
* ``engine.train`` with ``num_devices=3`` on 7 synthetic scenes at batch
  size 3: it shrinks to 2 ranks, each step's batch per rank is the batch
  JAX's device gets (``t * 2 + r``), the last scene is dropped with the
  warning, rank 0 alone writes the log and scalars, a trace is written for
  ``profile_steps=1``, and a second call resumes at the next epoch.

The data side (each rank's share of a ScanNet epoch, ``evaluate`` over
ranks) is in ``test_torch_parallel_eval.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import __graft_entry__ as graft
from pbnet_tpu import config as jconfig
from pbnet_tpu import engine as jengine
from pbnet_tpu.models.pbnet import PBNet as JPBNet
from pbnet_tpu.nn import modules as jmod
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_tpu.parallel import mesh as mesh_lib
from pbnet_tpu.parallel import train_step as jts
from pbnet_torch import convert, engine
from pbnet_torch.config import Config
from pbnet_torch.nn import sparse_ops as tso
from tests import torch_parallel_worker as worker
from tests.test_pbnet import TINY
from tests.test_torch_grad import assert_grad_close
from tests.test_torch_train import ARCHS, LOSS_TOL, SHAPES


@pytest.fixture(scope="module")
def f32(fast_compile_module):
    oj, ot = jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = jnp.float32, torch.float32
    yield
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = oj, ot


def test_syncbn_matches_jax_shard_map(tmp_path):
    rng = np.random.RandomState(0)
    m, c = 48, 16
    x = rng.randn(2, m, c).astype(np.float32) * 2 + 1
    valid = rng.rand(2, m) > 0.2
    x *= valid[..., None]
    ct = rng.randn(2, m, c).astype(np.float32)
    bn = jmod.MaskedBatchNorm(axis_name=mesh_lib.DATA_AXIS)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x[0]), jnp.asarray(valid[0]), False)
    params = {"scale": jnp.asarray(rng.rand(c).astype(np.float32) + 0.5),
              "bias": jnp.asarray(rng.randn(c).astype(np.float32))}
    stats = {"mean": jnp.asarray(rng.randn(c).astype(np.float32)),
             "var": jnp.asarray(rng.rand(c).astype(np.float32) + 0.5)}

    def per_device(params, stats, xx, vv, cc):
        xx, vv, cc = xx[0], vv[0], cc[0]

        def f(p, xi):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, xi, vv, True,
                              mutable=["batch_stats"])
            return jnp.sum(y * cc), (y, upd["batch_stats"])

        (_, (y, st)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, xx)
        return y[None], gx[None], jax.lax.pmean(gp, mesh_lib.DATA_AXIS), st

    mesh2 = mesh_lib.make_mesh(2)
    d = P(mesh_lib.DATA_AXIS)
    y_j, dx_j, gp_j, st_j = jax.jit(jax.shard_map(
        per_device, mesh=mesh2, in_specs=(P(), P(), d, d, d), out_specs=(d, d, P(), P()),
        check_vma=False))(params, stats, jnp.asarray(x), jnp.asarray(valid), jnp.asarray(ct))
    assert variables["params"]["scale"].shape == (c,)

    state = {"weight": torch.tensor(np.asarray(params["scale"])),
             "bias": torch.tensor(np.asarray(params["bias"])),
             "running_mean": torch.tensor(np.asarray(stats["mean"])),
             "running_var": torch.tensor(np.asarray(stats["var"]))}
    outs = worker.launch("syncbn", {"x": torch.from_numpy(x), "valid": torch.from_numpy(valid),
                                    "ct": torch.from_numpy(ct), "state": state}, tmp_path)
    tol = dict(rtol=1e-5, atol=1e-5)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["y"].numpy(), np.asarray(y_j)[r], **tol)
        np.testing.assert_allclose(o["dx"].numpy(), np.asarray(dx_j)[r], **tol)
        np.testing.assert_allclose(o["weight"].numpy(), np.asarray(gp_j["scale"]), **tol)
        np.testing.assert_allclose(o["bias"].numpy(), np.asarray(gp_j["bias"]), **tol)
        np.testing.assert_allclose(o["running_mean"].numpy(), np.asarray(st_j["mean"]), **tol)
        np.testing.assert_allclose(o["running_var"].numpy(), np.asarray(st_j["var"]), **tol)
    # the summed statistics reach the input gradient: it differs from the
    # per-rank BN's
    assert np.abs(np.asarray(dx_j)[0]).max() > 0


@pytest.fixture(scope="module")
def variables(f32):
    batch = graft._synthetic_batch(SHAPES, np.random.RandomState(0), n_copies=2)
    jm = JPBNet(shapes=SHAPES, **ARCHS)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = jax.jit(lambda k, b: jm.init(k, b, with_instances=True, with_labels=True,
                                     train=False))(jax.random.PRNGKey(0), jb)
    return jax.tree_util.tree_map(np.asarray, v)


def test_backbone_step_two_ranks_matches_jax(variables, tmp_path):
    lr = 1e-3
    kw = dict(shapes=SHAPES, optimizer="Adam", lr=lr, num_devices=2, sync_bn=True, **ARCHS)
    cfg_j = jconfig.Config(**kw)
    batches = [graft._synthetic_batch(SHAPES, np.random.RandomState(r), n_copies=2)
               for r in range(2)]
    jm = jengine.build_model(cfg_j, multi_device=True)
    tx = jts.make_optimizer(cfg_j)
    state = jts.TrainState(variables["params"], variables["batch_stats"],
                           tx.init(variables["params"]))
    mesh2 = mesh_lib.make_mesh(2)
    step_j = jts.make_train_step(jm, cfg_j, mesh2, tx, with_instances=False)
    new_state, aux_j = step_j(state, mesh_lib.shard_batch(mesh2, batches), lr)
    new_state = jax.tree_util.tree_map(np.asarray, new_state)

    outs = worker.launch("train_step", {
        "f32": True, "cfg": Config(**kw), "state": convert.state_dict_from_jax(variables),
        "batches": [[b] for b in batches], "lr": lr}, tmp_path)
    # the DDP invariant: both ranks end with the same parameters, statistics
    # and aux, bit for bit
    for n, v in outs[0]["state"].items():
        assert torch.equal(v, outs[1]["state"][n]), n
    assert outs[0]["aux"] == outs[1]["aux"]
    aux = outs[0]["aux"][0]
    assert set(aux_j) <= set(aux)
    for k, v in aux_j.items():
        np.testing.assert_allclose(aux[k], float(v), err_msg=k, **LOSS_TOL)

    # the averaged gradients, read from Adam's first moments (0.1 * g)
    mu = jts_find_mu(new_state.opt_state)
    want_g = {n: v / 0.1 for n, v in convert.state_dict_from_jax({"params": mu}).items()}
    got_g = {n: v / 0.1 for n, v in outs[0]["exp_avg"].items()}
    assert sorted(got_g) == sorted(want_g)
    floor = 1e-3 * max(float(g.abs().max()) for g in want_g.values())
    for n, g in want_g.items():
        assert_grad_close(got_g[n], g, n, floor)
    # Adam's first update is about -lr * sign(g): held where |g| is well
    # above rounding noise (1e-2 of the tensor's largest), and within 2 lr
    # elsewhere
    p0 = convert.state_dict_from_jax({"params": variables["params"]})
    p1 = convert.state_dict_from_jax({"params": new_state.params})
    for n, g in want_g.items():
        du_t = (outs[0]["state"][n] - p0[n]).numpy()
        du_j = (p1[n] - p0[n]).numpy()
        big = np.abs(g.numpy()) > max(1e-2 * float(g.abs().max()), floor)
        eps = 4 * np.finfo(np.float32).eps * float(p0[n].abs().max())
        assert np.abs(du_t - du_j)[big].max(initial=0) <= 1e-3 * lr + eps, n
        assert np.abs(du_t - du_j).max() <= 2 * lr + eps, n
    stats = convert.state_dict_from_jax({"batch_stats": new_state.batch_stats})
    for n, v in stats.items():
        np.testing.assert_allclose(outs[0]["state"][n].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def jts_find_mu(opt_state):
    """Adam's first moments of an optax ``scale_by_adam`` state."""
    return jax.tree_util.tree_map(np.asarray, opt_state.mu)


def read_log(logpath):
    d = os.path.join(logpath, "train")
    return [open(os.path.join(d, f)).read() for f in sorted(os.listdir(d))]


def test_engine_train_two_ranks(tmp_path):
    record = tmp_path / "record"
    record.mkdir()
    ds = worker.RecordingDataset(TINY, 7, record)
    cfg = Config(shapes=TINY, epochs=3, step_epoch=2, cluster_epoch=1, validation=False,
                 save_freq=4, logpath=str(tmp_path / "log"), num_devices=3, batch_size=3,
                 tcp_port=worker.free_port(), profile_steps=1, **ARCHS)
    m1, _ = engine.train(cfg, ds, max_epochs=1, device="cpu",
                         join_timeout_s=worker.JOIN_TIMEOUT_S)
    # JAX's device r takes batch t * ndev + r of the epoch's list
    order = [int(ids[0]) for ids in ds.train_epoch_ids(1)]
    got = {r: [line.split() for line in open(record / f"rank{r}.txt")] for r in range(2)}
    for r in range(2):
        assert got[r] == [["1", str(order[t * 2 + r])] for t in range(3)], r
    assert sorted(os.listdir(record)) == ["rank0.txt", "rank1.txt"]
    logs = read_log(cfg.logpath)
    assert len(logs) == 1  # rank 0's log only
    assert "dataset has only 7 scenes — shrinking to 2 rank(s)" in logs[0]
    assert "dropped 1 leftover batch(es) (< 2 local ranks" in logs[0]
    assert "ranks: 2 (2 on this host, rank 0)" in logs[0]
    assert sorted(f for f in os.listdir(cfg.logpath) if f.endswith(".ckpt")) == ["000000001.ckpt"]
    traces = os.listdir(os.path.join(cfg.logpath, "profile"))
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(cfg.logpath, "profile", traces[0])) as f:
        assert json.load(f)["traceEvents"]

    m2, _ = engine.train(cfg, ds, max_epochs=2, max_iters=1, device="cpu",
                         join_timeout_s=worker.JOIN_TIMEOUT_S)
    with open(os.path.join(cfg.logpath, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    keys = [(r["tag"], r["step"]) for r in rows]
    assert len(keys) == len(set(keys))  # one writer
    assert {r["step"] for r in rows} == {1, 2}
    assert "mask_loss_train" in {r["tag"] for r in rows if r["step"] == 2}
    assert sorted(f for f in os.listdir(cfg.logpath) if f.endswith(".ckpt")) == ["000000002.ckpt"]
    assert "Restore from" in read_log(cfg.logpath)[-1]
    state = torch.load(os.path.join(cfg.logpath, "000000002.ckpt"), weights_only=True)
    for n, v in m2.state_dict().items():
        assert torch.equal(state["model"][n], v), n
    assert not torch.equal(m1.MEUnet.conv0.kernel, m2.MEUnet.conv0.kernel)
    assert [ln.split()[0] for ln in open(record / "rank1.txt")][-1] == "2"


def test_cli_train_reaches_data_parallel_training(monkeypatch):
    """``python -m pbnet_torch.cli train`` hands the data-parallel flags
    that ``build_parser`` generates to ``engine.train`` unchanged."""
    from pbnet_torch import cli

    seen = {}
    monkeypatch.setattr(engine, "train", lambda cfg, device=None: seen.update(cfg=cfg,
                                                                             device=device))
    argv = ["train", "--device", "cpu", "--num_devices", "2", "--nodes", "2", "--node_rank", "1",
            "--coordinator", "10.0.0.1:29500", "--tcp_port", "29501", "--sync_bn", "false",
            "--profile_steps", "3"]
    assert cli.main(argv) == 0
    cfg = seen["cfg"]
    assert seen["device"] == "cpu"
    assert (cfg.num_devices, cfg.nodes, cfg.node_rank, cfg.coordinator, cfg.tcp_port,
            cfg.sync_bn, cfg.profile_steps) == (2, 2, 1, "10.0.0.1:29500", 29501, False, 3)
