"""The port's checkpoint-parity harness (pbnet_torch/tools/parity_eval.py)
against the JAX package's (tools/parity_eval.py), on the CPU.

One small room written by ``synthetic.write_scannet_scene`` (1 cm
vertices); the Mini_Unet trio at small caps in one size bucket, conv
operands in f32 on both sides.  The weights: JAX variables (random, from the
JAX package's ``init_state``) with the semantic head biased to one class,
the offset head zeroed and the mask head raised by 5 (as in
``test_torch_engine.py``: far from every cut), written as a reference-format
``.pth`` by ``tests/test_convert.py``'s ``write_reference_pth``.

* ``convert_checkpoint.write_reference_pth`` (the port's writer) on the same
  weights, carried into the port's names, writes the same tensors under the
  same names.
* Both harnesses run end to end on that ``.pth`` (the port's from the raw
  scan with ``--scans``, which decodes it and writes ``val_gt``; JAX's on
  the decoded files): mIoU, mAcc and allAcc equal, the AP keys within 1e-6
  (``test_torch_engine.py::test_instance_evaluate_matches_jax``'s gates),
  both leave no converted tensor unmatched, and both print the table.
* The port's flags are JAX's plus ``--device``; without a GPU and without
  ``--device cpu`` the command raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.parity_eval as jpe
from pbnet_tpu import config as jconfig
from pbnet_tpu import engine as jengine
from pbnet_tpu.data import dataset as jds
from pbnet_tpu.data import decode_scannet as jdec
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_torch import config as tconfig
from pbnet_torch import convert, synthetic
from pbnet_torch.nn import sparse_ops as tso
from pbnet_torch.tools import convert_checkpoint
from pbnet_torch.tools import parity_eval as tpe
from tests.test_convert import write_reference_pth

ARCHS = dict(backbone_arch="Mini_Unet", dunet_arch="Mini_Unet", score_arch="Mini_Unet")
SHAPES = dict(point_cap=12288, voxel_caps=(4096, 2048), cluster_cap=16,
              local_point_cap=16384, local_voxel_caps=(6144, 3072),
              score_voxel_caps=(6144, 3072), instance_cap=16, cluster_band=2048)
SCENE = "scene0000_00"
BED = 3  # semantic index of NYU40 'bed', the class of the room's object
AP_KEYS = ("mAP", "AP50", "AP25")


def configs(root):
    base = dict(data_root=str(root), num_works=0, cache=False, eval_bucket_scales=(1.0,),
                logpath=str(root / "log"), manual_seed=22, cluster_epoch=-1, **ARCHS)
    return (jconfig.Config(shapes=jconfig.StaticShapes(**SHAPES), **base),
            tconfig.Config(shapes=tconfig.StaticShapes(**SHAPES), **base))


@pytest.fixture(scope="module")
def setup(fast_compile_module, tmp_path_factory):
    oj, ot = jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = jnp.float32, torch.float32
    root = tmp_path_factory.mktemp("scannet")
    scans = root / "scans"
    synthetic.write_scannet_scene(str(scans / "val"), SCENE, np.random.RandomState(0), 3000,
                                  n_objects=1, wall_height=0.1, object_labels=(4,))
    (root / "scannetv2_val.txt").write_text(SCENE + "\n")
    # decoded here only to shape JAX's initial state; the port's harness
    # decodes the scan again and writes val_gt
    os.makedirs(root / "npy")
    jdec.decode_scene(str(scans / "val" / f"{SCENE}_vh_clean_2.ply"), str(root / "npy"), None)
    cfg_j, _ = configs(root)
    jm = jengine.build_model(cfg_j, multi_device=False)
    sample = jds.Dataset(cfg_j).val_batch(0)
    state, _ = jengine.init_state(jm, cfg_j, jengine.device_batch(sample), cfg_j.manual_seed)
    v = jax.tree_util.tree_map(np.array, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    p = v["params"]
    p["linear_sem"]["linear2"]["Dense_0"]["bias"][BED] += np.float32(100.0)
    for leaf in ("kernel", "bias"):
        p["linear_offset"]["linear2"]["Dense_0"][leaf][...] = 0.0
    p["linear_binary"]["linear2"]["Dense_0"]["bias"] += np.float32(5.0)
    pth = root / "000000001.pth"
    write_reference_pth(v, str(pth))
    yield dict(root=root, scans=scans, pth=pth, variables=v)
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = oj, ot


def test_reference_writer_equals_jax_writer(setup, tmp_path):
    want = torch.load(setup["pth"], weights_only=False)
    path = tmp_path / "port.pth"
    convert_checkpoint.write_reference_pth(convert.state_dict_from_jax(setup["variables"]),
                                           str(path))
    got = torch.load(path, weights_only=False)
    assert got["optimizer"] == want["optimizer"] == {}
    assert sorted(got["model"]) == sorted(want["model"]) and len(want["model"]) > 100
    for k, w in want["model"].items():
        g = got["model"][k]
        assert g.dtype == w.dtype and torch.equal(g, w), k


def spy_on(monkeypatch, module, out):
    run = module.run_parity

    def spy(*a, **kw):
        out.append(run(*a, **kw))
        return out[-1]

    monkeypatch.setattr(module, "run_parity", spy)


def test_parity_harness_matches_jax(setup, monkeypatch, capsys):
    root = setup["root"]
    cfg_j, cfg_t = configs(root)
    runs_t, runs_j = [], []
    spy_on(monkeypatch, tpe, runs_t)
    spy_on(monkeypatch, jpe, runs_j)
    common = ["--pth", str(setup["pth"]), "--data_root", str(root), "--max_scenes", "1"]
    got = tpe.main(common + ["--scans", str(setup["scans"]), "--device", "cpu"], cfg=cfg_t)
    out_t = capsys.readouterr().out
    assert os.path.isfile(root / "val_gt" / f"{SCENE}.txt")
    want = jpe.main(common, cfg=cfg_j)
    out_j = capsys.readouterr().out
    (res_t, unmatched_t, timing_t), (res_j, unmatched_j, _) = runs_t[0], runs_j[0]
    assert res_t is got and res_j is want
    assert unmatched_t == unmatched_j == []
    assert got.keys() == want.keys() and set(AP_KEYS) <= set(got)
    for k in ("mIoU", "mAcc", "allAcc"):
        assert got[k] == want[k], k
    for k in AP_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert 0 < got["mAP"] <= 1
    assert [r["proposals"] > 0 and not any(r["overflow"].values())
            for r in timing_t["per_scene"]] == [True]
    for out in (out_t, out_j):
        assert "=== parity vs reference" in out and "reference 56.4" in out


def test_parity_flags_and_device(monkeypatch, tmp_path):
    def flags(ap):
        return {a.dest: a.default for a in ap._actions if a.dest != "help"}

    assert flags(tpe.build_argparser()) == dict(flags(jpe.build_argparser()), device=None)
    assert tpe.REFERENCE_NUMBERS == jpe.REFERENCE_NUMBERS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpe.main(["--pth", str(tmp_path / "x.pth"), "--data_root", str(tmp_path)])
