"""The port's three-stage PBNet forward against the JAX package's, end to end.

TINY shapes with the Mini_Unet trio (tests/test_pbnet.py) on the
``__graft_entry__._synthetic_batch`` scene; JAX variables (with randomised
BN statistics) carried across by ``pbnet_torch.convert``; conv operands in
f32 on both sides.

* Stage 1: per-point features, semantic scores and offsets within rtol/atol
  1e-4 (f32 GEMMs summed in different orders through a UNet and two heads);
  the voxel->point map and validity exactly.
* Stages 2-3 run with the SAME injected stage-1 output on both sides (oracle
  semantics/offsets/softmax, as bench.py drives them, plus JAX's per-point
  features), so clustering sees identical inputs: cluster ids, scene point
  ids and proposal ids, and every overflow and usage counter must be exactly
  equal.  Mask and IoU scores within rtol/atol 1e-4; kept flags equal except
  where a mask score sits within 1e-5 of the 0.45 threshold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench
from pbnet_tpu.models.pbnet import PBNet as JPBNet
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_torch import convert, synthetic
from pbnet_torch.config import StaticShapes
from pbnet_torch.models.pbnet import MASK_THRESH, batch_to_device
from pbnet_torch.models.pbnet import PBNet as TPBNet
from pbnet_torch.nn import sparse_ops as tso
from tests.test_pbnet import TINY
from tests.test_torch_nn import randomise_stats

ARCHS = dict(backbone_arch="Mini_Unet", dunet_arch="Mini_Unet", score_arch="Mini_Unet")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def f32_module():
    oj, ot = jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = jnp.float32, torch.float32
    yield
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = oj, ot


@pytest.fixture(scope="module")
def models(f32_module):
    batch = graft._synthetic_batch(TINY, np.random.RandomState(0))
    jm = JPBNet(shapes=TINY, **ARCHS)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda k, b: jm.init(k, b, with_instances=True, with_labels=True,
                                             train=False))(jax.random.PRNGKey(0), jb)
    variables = randomise_stats(variables, 11)
    # lift the mask head so a good share of scene points pass the 0.45 cut
    # and the ScoreNet sees real proposals
    head = variables["params"]["linear_binary"]["linear2"]["Dense_0"]
    head["bias"] = head["bias"] + np.float32(0.25)
    tm = TPBNet(TINY, device="cpu", **ARCHS)
    tm.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
    jbb = jax.jit(lambda v, b: jm.apply(v, b, False, method=JPBNet.backbone))(variables, jb)
    tb = batch_to_device(batch, "cpu")
    return dict(batch=batch, jm=jm, variables=variables, jb=jb, jbb=jbb, tm=tm, tb=tb,
                tbb=tm.backbone(tb))


def test_synthetic_copies_match_entry_scripts():
    a = graft._synthetic_batch(TINY, np.random.RandomState(3), n_copies=2)
    b = synthetic.synthetic_batch(StaticShapes(**dataclasses.asdict(TINY)),
                                  np.random.RandomState(3), n_copies=2)
    assert dataclasses.asdict(synthetic.GRAFT_SHAPES) == dataclasses.asdict(graft._SHAPES)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for x, y in zip(bench.make_scene(np.random.RandomState(1), n_pts=3000),
                    synthetic.make_scene(np.random.RandomState(1), n_pts=3000)):
        np.testing.assert_array_equal(y, x)


def test_stage1_matches_jax(models):
    j, t = models["jbb"], models["tbb"]
    np.testing.assert_array_equal(t["point_ok"].numpy(), np.asarray(j["point_ok"]))
    np.testing.assert_array_equal(t["v2p"].numpy(), np.asarray(j["v2p"]))
    for k in ("overflow_vox", "overflow_grid"):
        assert int(t[k]) == int(j[k]), k
    for k in ("point_feat_p", "sem_pred_score_p", "offset_pred_p", "sem_soft_p"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), err_msg=k, **TOL)
    # argmax agrees wherever the top two scores are not a near tie
    s = np.sort(np.asarray(j["sem_pred_score_p"]), 1)
    clear = (s[:, -1] - s[:, -2]) > 1e-3
    np.testing.assert_array_equal(t["sem_pred_p"].numpy()[clear], np.asarray(j["sem_pred_p"])[clear])


def oracle_bb(batch, ok, feat32):
    """test_pbnet's perfect stage-1 output, with the given per-point features."""
    sem = np.clip(batch["sem_label"], 0, 19)
    offs = np.where((batch["ins_label"] != -100)[:, None],
                    batch["inst_info"][:, 0:3] - batch["xyz"], 0.0).astype(np.float32)
    soft = (np.eye(20, dtype=np.float32)[sem] * 0.9 + 0.005).astype(np.float32)
    return {"point_feat_p": feat32, "sem_soft_p": soft, "offset_pred_p": offs,
            "sem_pred_score_p": soft * 10,
            "sem_pred_p": np.where(ok, sem, -1).astype(np.int32), "point_ok": ok}


@pytest.mark.parametrize("extent", ["default", None])  # derived / re-quantized ScoreNet topology
def test_instance_stage_matches_jax(models, extent):
    shapes = TINY if extent == "default" else dataclasses.replace(TINY, grid_extent=None)
    batch, variables = models["batch"], models["variables"]
    ok = np.asarray(models["jbb"]["point_ok"])
    bb = oracle_bb(batch, ok, np.asarray(models["jbb"]["point_feat_p"]))

    jm = JPBNet(shapes=shapes, **ARCHS)
    jbb = dict(models["jbb"] if extent == "default" else jax.jit(
        lambda v, b: jm.apply(v, b, False, method=JPBNet.backbone))(variables, models["jb"]))
    jbb.update({k: jnp.asarray(v) for k, v in bb.items()})
    ref = jax.jit(lambda v, b, s: jm.apply(v, b, s, True, False, method=JPBNet.instance_stage))(
        variables, models["jb"], jbb)

    tm = models["tm"]
    tm.shapes = shapes
    try:
        got = tm.instance_stage(models["tb"], {k: torch.from_numpy(np.array(v)) for k, v in bb.items()}, True)
    finally:
        tm.shapes = TINY

    rc, gc = ref["cluster"], got["cluster"]
    for f in rc._fields:
        if f == "centers":
            np.testing.assert_allclose(gc.centers.numpy(), np.asarray(rc.centers),
                                       rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(getattr(gc, f).numpy(), np.asarray(getattr(rc, f)),
                                          err_msg=f)
    assert int(gc.num_clusters) == 2
    for k in ("scene_pid", "scene_src", "scene_valid", "prop_point_src", "gt_mask",
              "num_proposals", "scene_total"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for d in ("overflow", "usage"):
        for k in ref[d]:
            if d == "usage" and k in ("kept_points", "score_vox"):
                continue  # follow the kept flags, checked below
            assert int(got[d][k]) == int(ref[d][k]), (d, k)
    ms = np.asarray(ref["mask_scores"])
    np.testing.assert_allclose(got["mask_scores"].numpy(), ms, **TOL)
    clear = np.abs(ms - MASK_THRESH) >= 1e-5
    kept_j = np.asarray(ref["prop_point_kept"])
    np.testing.assert_array_equal(got["prop_point_kept"].numpy()[clear], kept_j[clear])
    if clear.all():
        np.testing.assert_array_equal(got["prop_point_pid"].numpy(),
                                      np.asarray(ref["prop_point_pid"]))
        for k in ("num_final_proposals", "prop_sem", "prop_valid"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
        for k in ("kept_points", "score_vox"):
            assert int(got["usage"][k]) == int(ref["usage"][k]), k
        np.testing.assert_allclose(got["clt_scores"].numpy(), np.asarray(ref["clt_scores"]), **TOL)
    assert kept_j.any()
