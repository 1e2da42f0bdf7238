"""The port's data-parallel data side against the JAX package's, on the
CPU (the step and ``engine.train`` are in ``test_torch_parallel.py``).

Scenes: three small rooms (``synthetic.write_scannet_scene``) decoded by the
JAX package; the Mini_Unet trio at the caps of ``test_torch_engine`` in f32,
with its JAX variables (semantic and instance mode).  The port's ranks run
in two gloo processes (``tests/torch_parallel_worker.py``), joined within
``JOIN_TIMEOUT_S``.

* Each rank's share of a ScanNet ``Dataset`` epoch (``mesh.rank_batches``)
  equals the batch the JAX package's ``engine.train`` stacks for its
  device: step ``t``, device ``r`` takes batch ``t * ndev + r``.
* ``engine.evaluate`` over 2 ranks (semantic and instance mode; 3 scenes,
  so the ranks hold 2 and 1): every rank's result equal to the one-rank
  run exactly, ``timing`` with the same keys and per-scene records, and
  within 1e-6 of JAX's ``evaluate`` on a 2-device mesh.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu import engine as jengine
from pbnet_tpu.data import dataset as jds
from pbnet_tpu.data import decode_scannet as jdec
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_tpu.parallel import mesh as mesh_lib
from pbnet_torch import convert, engine, synthetic
from pbnet_torch.data import dataset as tds
from pbnet_torch.nn import sparse_ops as tso
from pbnet_torch.parallel import mesh
from tests import test_torch_engine as te
from tests import torch_parallel_worker as worker


@pytest.fixture(scope="module")
def f32(fast_compile_module):
    oj, ot = jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = jnp.float32, torch.float32
    yield
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = oj, ot


@pytest.fixture(scope="module")
def scenes(f32, tmp_path_factory):
    """Three val scenes and three train scenes, decoded by the JAX package;
    the JAX variables of ``test_torch_engine`` (semantic and instance
    mode)."""
    root = tmp_path_factory.mktemp("scannet")
    scans, out = str(root / "scans"), str(root / "npy")
    os.makedirs(out)
    val = dict(te.VAL, scene0002_00=3300)
    for i, (nm, n) in enumerate(val.items()):
        synthetic.write_scannet_scene(scans, nm, np.random.RandomState(i), n, n_objects=1,
                                      wall_height=0.1, object_labels=(4,))
        jdec.decode_scene(os.path.join(scans, nm + "_vh_clean_2.ply"), out, None)
    np.savetxt(str(root / "scannetv2_val.txt"), list(val), fmt="%s")
    np.savetxt(str(root / "scannetv2_train.txt"), list(val), fmt="%s")
    jdec.write_val_gt(out, list(val), str(root / "val_gt"))
    cfg_j, _ = te.configs(root)
    jm = jengine.build_model(cfg_j, multi_device=False)
    sample = jds.Dataset(cfg_j).val_batch(0)
    state, _ = jengine.init_state(jm, cfg_j, jengine.device_batch(sample), cfg_j.manual_seed)
    v = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                            "batch_stats": state.batch_stats})
    inst = jax.tree_util.tree_map(np.copy, v)
    p = inst["params"]
    p["linear_sem"]["linear2"]["Dense_0"]["bias"][te.BED] += np.float32(100.0)
    for leaf in ("kernel", "bias"):
        p["linear_offset"]["linear2"]["Dense_0"][leaf][...] = 0.0
    p["linear_binary"]["linear2"]["Dense_0"]["bias"] += np.float32(5.0)
    return dict(root=root, n_val=len(val), variables={"semantic": v, "instance": inst})


def test_rank_shares_match_jax_device_batches(scenes):
    """Each rank's share of a ScanNet epoch (``mesh.rank_batches`` over the
    host's list, batch ``i`` seeded as ``i``) is the batch the JAX
    package's ``engine.train`` stacks for its device."""
    cfg_j, cfg_t = te.configs(scenes["root"], batch_size=1, mixup=False, max_crop_p=4096,
                              min_crop_p=10)
    ndev, epoch = 2, 3
    jax_batches = list(jds.Dataset(cfg_j).train_loader(epoch, rank=0, world=1))
    n = len(jax_batches)
    assert n == 3
    ds_t = tds.Dataset(cfg_t)
    for r in range(ndev):
        picks = mesh.rank_batches(list(range(n)), r, ndev)
        got = list(ds_t.train_loader(epoch, 0, 1, picks=picks))
        want = [jax_batches[t * ndev + r] for t in range(n // ndev)]
        assert len(got) == len(want) == 1
        for g, w in zip(got, want):
            for k in ("xyz", "vox_coords", "vox_feats", "sem_label", "ins_label"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("mode", ["semantic", "instance"])
def test_evaluate_two_ranks_matches_one_rank_and_jax(scenes, mode, tmp_path):
    ce = 1000 if mode == "semantic" else -1
    cfg_j, cfg_t = te.configs(scenes["root"], cluster_epoch=ce)
    variables = scenes["variables"][mode]
    state = convert.state_dict_from_jax(variables)
    outs = worker.launch("evaluate", {"f32": True, "cfg": cfg_t, "state": state, "epoch": 1},
                         tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as in the ranks: the same f32 sums
    try:
        one = {}
        want_t = engine.evaluate(cfg_t, te.port_model(cfg_t, variables), tds.Dataset(cfg_t),
                                 epoch=1, timing=one)
    finally:
        torch.set_num_threads(threads)
    for o in outs:
        assert o["result"] == want_t
    two = outs[0]["timing"]
    assert set(two) == set(one)
    assert two["scenes"] == scenes["n_val"]
    assert two["bucket_scene_counts"] == one["bucket_scene_counts"]
    strip = ("forward_ms", "collate_s", "host_eval_s", "peak_mem_gib")
    assert ([{k: v for k, v in r.items() if k not in strip} for r in two["per_scene"]]
            == [{k: v for k, v in r.items() if k not in strip} for r in one["per_scene"]])
    if mode == "instance":
        assert sum(r["proposals"] for r in two["per_scene"]) > 0 and "mAP" in want_t
    want_j = jengine.evaluate(cfg_j, jengine.build_model(cfg_j, False), te.jax_state(variables),
                              jds.Dataset(cfg_j), epoch=1, mesh=mesh_lib.make_mesh(2))
    assert want_j.keys() == want_t.keys()
    for k, v in want_j.items():
        np.testing.assert_allclose(want_t[k], v, rtol=0, atol=1e-6, err_msg=k)
