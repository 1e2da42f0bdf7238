"""The port's evaluation drivers against the JAX package's, on the CPU.

Scenes: small rooms written by ``synthetic.write_scannet_scene`` (1 cm
vertices, so that the 4 cm clustering radius finds dense neighbourhoods;
the 5 cm grid of ``tests.test_data.fabricate_scene`` has none), decoded by
the JAX package.  Models: the Mini_Unet trio at small caps with one size
bucket, conv operands in f32 on both sides; JAX variables (random, from
``PRNGKey(0)``) carried across by ``convert.state_dict_from_jax``.

* Semantic mode (``cluster_epoch`` past the epoch): mIoU, mAcc and allAcc
  exactly equal (the test first checks that no point's top two semantic
  scores lie within twice the largest score difference between the
  packages, so no argmax can flip).
* Instance mode (``cluster_epoch=-1``, labels on): the semantic head biased
  to one class, the offset head zeroed and the mask head raised by 5 on both
  sides (far enough that no mask score lies near the 0.45 and 0.5 cuts):
  per-scene proposal counts exactly equal; mAP, AP50, AP25 and the mask
  accuracies within 1e-6.
* ``predict_testset`` from one JAX checkpoint file, restored by each
  package: the same files, the masks and labels equal, ``conf`` within 1e-4.
* ``scatter_cropped_masks`` equal to JAX's; a cropped scene evaluates in
  the port where the JAX package raises.
* ``engine.train`` builds ``Dataset(cfg)`` and validates at the last epoch.
* ``python -m pbnet_torch.cli eval --device cpu`` runs in a subprocess over
  the same checkpoint; its parser has every flag of JAX's ``get_parser``
  with the same defaults.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu import config as jconfig
from pbnet_tpu import engine as jengine
from pbnet_tpu.data import dataset as jds
from pbnet_tpu.data import decode_scannet as jdec
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_tpu.tools import log as jlog
from pbnet_torch import config as tconfig
from pbnet_torch import convert, engine, synthetic
from pbnet_torch.data import dataset as tds
from pbnet_torch.nn import sparse_ops as tso

REPO = Path(__file__).resolve().parents[1]
ARCHS = dict(backbone_arch="Mini_Unet", dunet_arch="Mini_Unet", score_arch="Mini_Unet")
SHAPES = dict(point_cap=12288, voxel_caps=(4096, 2048), cluster_cap=16,
              local_point_cap=16384, local_voxel_caps=(6144, 3072),
              score_voxel_caps=(6144, 3072), instance_cap=16, cluster_band=2048)
VAL = {"scene0000_00": 3000, "scene0001_00": 3600}
TEST = {"scene0100_00": 3400}
BED = 3  # semantic index of NYU40 'bed', the class of every object here
AP_KEYS = ("mAP", "AP50", "AP25", "mask_all_acc", "mask_tp_acc", "mask_tf_acc")


def cfg_kwargs(root, **kw):
    base = dict(data_root=str(root), num_works=0, cache=False, eval_bucket_scales=(1.0,),
                logpath=str(root / "log"), manual_seed=22, **ARCHS)
    base.update(kw)
    return base


def configs(root, **kw):
    base = cfg_kwargs(root, **kw)
    return (jconfig.Config(shapes=jconfig.StaticShapes(**SHAPES), **base),
            tconfig.Config(shapes=tconfig.StaticShapes(**SHAPES), **base))


@pytest.fixture(scope="module")
def f32(fast_compile_module):
    oj, ot = jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = jnp.float32, torch.float32
    yield
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = oj, ot


@pytest.fixture(scope="module")
def setup(f32, tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    scans, out = str(root / "scans"), str(root / "npy")
    os.makedirs(out)
    for i, (nm, n) in enumerate({**VAL, **TEST}.items()):
        synthetic.write_scannet_scene(scans, nm, np.random.RandomState(i), n, n_objects=1,
                                      wall_height=0.1, object_labels=(4,))
        jdec.decode_scene(os.path.join(scans, nm + "_vh_clean_2.ply"), out, None,
                          with_labels=nm in VAL)
    np.savetxt(str(root / "scannetv2_val.txt"), list(VAL), fmt="%s")
    np.savetxt(str(root / "scannetv2_test.txt"), list(TEST), fmt="%s")
    jdec.write_val_gt(out, list(VAL), str(root / "val_gt"))

    cfg_j, _ = configs(root)
    jm = jengine.build_model(cfg_j, multi_device=False)
    sample = jds.Dataset(cfg_j).val_batch(0)
    state, _ = jengine.init_state(jm, cfg_j, jengine.device_batch(sample), cfg_j.manual_seed)
    variables = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                    "batch_stats": state.batch_stats})
    # instance-mode weights: every point 'bed', no offsets, masks kept
    inst = jax.tree_util.tree_map(np.copy, variables)
    p = inst["params"]
    p["linear_sem"]["linear2"]["Dense_0"]["bias"][BED] += np.float32(100.0)
    for leaf in ("kernel", "bias"):
        p["linear_offset"]["linear2"]["Dense_0"][leaf][...] = 0.0
    p["linear_binary"]["linear2"]["Dense_0"]["bias"] += np.float32(5.0)
    # one JAX checkpoint of the instance-mode weights (epoch 7)
    jlog.checkpoint_save({"params": inst["params"], "batch_stats": inst["batch_stats"],
                          "opt_state": state.opt_state}, cfg_j.logpath, 7)
    return dict(root=root, variables=variables, inst=inst)


def jax_state(variables):
    return jengine.TrainState(variables["params"], variables["batch_stats"], None)


def port_model(cfg, variables):
    m = engine.build_model(cfg, "cpu")
    m.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
    return m


def test_semantic_evaluate_matches_jax(setup):
    cfg_j, cfg_t = configs(setup["root"], cluster_epoch=1000)
    tm = port_model(cfg_t, setup["variables"])
    ds_t = tds.Dataset(cfg_t)
    jm = jengine.build_model(cfg_j, False)
    fwd = jax.jit(lambda b: jm.apply(setup["variables"], b, with_instances=False,
                                     with_labels=False, train=False))
    for i in range(len(VAL)):
        batch = ds_t.val_batch(i)
        out = tm(engine.device_batch(batch, "cpu"), with_instances=False)
        ok = out["point_ok"].numpy()
        score = out["sem_pred_score_p"].numpy()[ok]
        want = np.asarray(fwd(jengine.device_batch(batch))["sem_pred_score_p"])[ok]
        # no point's top two scores lie closer than twice the largest score
        # difference between the packages, so no argmax can differ
        top2 = np.sort(score, 1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 2 * np.abs(score - want).max()
    timing = {}
    got = engine.evaluate(cfg_t, tm, ds_t, epoch=1, timing=timing)
    want = jengine.evaluate(cfg_j, jengine.build_model(cfg_j, False),
                            jax_state(setup["variables"]), jds.Dataset(cfg_j), epoch=1)
    assert got == want
    assert 0 < got["allAcc"] <= 1
    assert timing["scenes"] == len(VAL) and len(timing["per_scene"]) == len(VAL)
    assert sum(timing["bucket_scene_counts"].values()) == len(VAL)
    assert all(r["proposals"] == 0 and r["overflow"]["vox"] == 0 for r in timing["per_scene"])


def proposal_lines(text):
    return sorted(re.findall(r"complete \d+, has \d+ clts", text))


def test_instance_evaluate_matches_jax(setup, capsys):
    cfg_j, cfg_t = configs(setup["root"], cluster_epoch=-1)
    capsys.readouterr()
    timing = {}
    tm = port_model(cfg_t, setup["inst"])
    got = engine.evaluate(cfg_t, tm, tds.Dataset(cfg_t), epoch=1, timing=timing)
    lines_t = proposal_lines(capsys.readouterr().out)
    want = jengine.evaluate(cfg_j, jengine.build_model(cfg_j, False),
                            jax_state(setup["inst"]), jds.Dataset(cfg_j), epoch=1)
    lines_j = proposal_lines(capsys.readouterr().out)
    assert len(lines_j) == len(VAL) and lines_t == lines_j
    assert [r["proposals"] for r in timing["per_scene"]] == [
        int(ln.split()[3]) for ln in sorted(lines_j, key=lambda s: int(s.split()[1][:-1]))]
    assert sum(r["proposals"] for r in timing["per_scene"]) > 0
    assert got.keys() == want.keys() and set(AP_KEYS) <= set(got)
    for k in ("mIoU", "mAcc", "allAcc"):
        assert got[k] == want[k], k
    for k in AP_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert 0 < got["mAP"] <= 1
    for r in timing["per_scene"]:
        assert not any(r["overflow"].values()), r
    assert not tm.training


def test_train_builds_the_dataset_and_validates(setup, tmp_path):
    """``engine.train`` with no dataset builds ``Dataset(cfg)`` from the data
    root and, with ``cfg.validation``, evaluates at the last epoch; the
    semantic metrics reach ``scalars.jsonl``."""
    root = setup["root"]
    (root / "scannetv2_train.txt").write_text("".join(n + "\n" for n in VAL))
    _, cfg_t = configs(root, cluster_epoch=1000, epochs=1, validation=True, batch_size=1,
                       mixup=False, max_crop_p=4096, min_crop_p=10,
                       logpath=str(tmp_path / "log"))
    try:
        engine.train(cfg_t, max_iters=1, device="cpu")
    finally:
        (root / "scannetv2_train.txt").unlink()
    with open(tmp_path / "log" / "scalars.jsonl") as f:
        rows = {r["tag"]: r for r in map(json.loads, f)}
    assert {"val/mIOU_eval", "val/mAcc_eval", "val/allACC_eval", "loss_train"} <= set(rows)
    assert rows["val/mIOU_eval"]["step"] == 1 and 0 < rows["val/allACC_eval"]["value"] <= 1


def read_submission(result_dir):
    files = {}
    for dirpath, _, names in os.walk(result_dir):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p) as f:
                files[os.path.relpath(p, result_dir)] = f.read()
    return files


def test_predict_testset_matches_jax(setup, tmp_path, monkeypatch):
    cfg_j, cfg_t = configs(setup["root"], task="test", cluster_epoch=-1)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    monkeypatch.chdir(tmp_path / "t")
    dir_t = engine.predict_testset(cfg_t, device="cpu")
    monkeypatch.chdir(tmp_path / "j")
    dir_j = jengine.predict_testset(cfg_j)
    assert dir_t == dir_j
    fj, ft = read_submission(tmp_path / "j" / dir_j), read_submission(tmp_path / "t" / dir_t)
    assert ft.keys() == fj.keys() and len(fj) >= 2
    for name, text in fj.items():
        if name.startswith("predicted_masks"):
            assert ft[name] == text, name
            continue
        rows_j = [ln.split() for ln in text.splitlines()]
        rows_t = [ln.split() for ln in ft[name].splitlines()]
        assert [r[:2] for r in rows_t] == [r[:2] for r in rows_j]
        np.testing.assert_allclose([float(r[2]) for r in rows_t], [float(r[2]) for r in rows_j],
                                   rtol=0, atol=1e-4)


def test_cropped_scene_evaluates_where_jax_raises(setup):
    """A val scene larger than the largest bucket is cropped; its dropped
    points count as misses and its masks scatter back to the full scene.
    The JAX package's evaluate raises on such a scene (it bincounts the
    float64 labels of the dropped points), so only the port evaluates here;
    scatter_cropped_masks is held to JAX's on the same crop."""
    small = dict(SHAPES, point_cap=9216)
    base = cfg_kwargs(setup["root"], cluster_epoch=-1)
    cfg_t = tconfig.Config(shapes=tconfig.StaticShapes(**small), **base)
    cfg_j = jconfig.Config(shapes=jconfig.StaticShapes(**small), **base)
    ds_t = tds.Dataset(cfg_t)
    b = ds_t.val_batch(1)
    assert b["keep_idx"] is not None
    k = b["num_points"] // 3
    pred = {"mask": (np.arange(2 * k).reshape(2, k) % 3 == 0).astype(np.int32),
            "conf": np.ones(2), "label_id": np.ones(2, np.int64)}
    got = engine.scatter_cropped_masks(pred, b)
    np.testing.assert_array_equal(got["mask"], jengine.scatter_cropped_masks(pred, b)["mask"])
    assert got["mask"].shape == (2, b["orig_num_points"])
    timing = {}
    res = engine.evaluate(cfg_t, port_model(cfg_t, setup["inst"]), ds_t, epoch=1,
                          timing=timing)
    assert all(np.isfinite(v) and 0 <= v <= 1 for k_, v in res.items() if k_ in ("mIoU", "mAcc",
                                                                                 "allAcc"))
    assert timing["per_scene"][1]["points"] == b["num_points"]
    dsem = jds.Dataset(cfg_j).val_batch(1)["dropped_sem"]
    np.testing.assert_array_equal(b["dropped_sem"], dsem)
    assert dsem.dtype == np.float64
    with pytest.raises(TypeError):  # pbnet_tpu/engine.py:353
        np.bincount(dsem[(dsem >= 0) & (dsem < cfg_j.sem_num)], minlength=cfg_j.sem_num)


def test_cli_eval_runs_on_cpu_and_parser_matches_jax(setup):
    jflags = {f.name for f in dataclasses.fields(jconfig.Config)} - {"shapes", "dist",
                                                                     "world_size"}
    opts = {a.dest for a in tconfig.build_parser(test=True)._actions} - {"help"}
    assert opts == jflags | {"device"}
    for test in (False, True):
        cfg_t, dev = tconfig.get_parser(test=test, argv=[])
        cfg_j = jconfig.get_parser(test=test, argv=[])
        assert dev is None and dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    cfg_t, dev = tconfig.get_parser(test=True, argv=["--device", "cpu", "--fix_module",
                                                     "D_Unet,linear_sem",
                                                     "--eval_bucket_scales", "0.5,1.0"])
    assert dev == "cpu" and cfg_t.fix_module == ("D_Unet", "linear_sem")
    assert cfg_t.eval_bucket_scales == (0.5, 1.0)

    root = setup["root"]
    argv = ["eval", "--device", "cpu", "--data_root", str(root), "--logpath",
            str(root / "log"), "--cluster_epoch", "1000", "--eval_bucket_scales", "0.4",
            "--num_works", "0"] + [x for k, v in ARCHS.items() for x in (f"--{k}", v)]
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", "pbnet_torch.cli", *argv], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Restore from" in r.stdout and "'mIoU'" in r.stdout and "'per_scene'" in r.stdout
    r = subprocess.run([sys.executable, "-m", "pbnet_torch.cli"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "usage" in r.stderr
