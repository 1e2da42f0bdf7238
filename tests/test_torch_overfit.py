"""The port's overfit-to-AP proof (pbnet_torch/tools/overfit.py) and its
trained-content clustering tool (pbnet_torch/tools/trained_cluster.py)
against their JAX originals (tests/overfit_worker.py,
perf/trained_cluster_r5.py), on the CPU.

* The fabricated scenes, split lists and val GT files equal the JAX
  worker's byte for byte, and every batch both overfit modes train and
  evaluate on (the memorised run's ``val_batch``, two steps of the held-out
  run's randomly rotated ``view_batch`` from ``RandomState(7)``) equals the
  worker's array for array, floats exactly (the same numpy arithmetic).
  The worker runs in a process of its own: importing it turns on
  ``jax_disable_most_optimizations``, which must not leak into this one.
* A short ``overfit.run`` writes a ``result.json`` with the worker's keys
  (plus ``ap25_by_round`` and ``seconds``), every value finite.
* ``trained_cluster``'s bench content equals the script's (its scene from
  the JAX bench's ``make_scene``), and ``cluster_on`` equals the script's
  fg compaction followed by the JAX package's ``binary_cluster``: every
  integer field exact, centres within 1e-5.  A 2 + 2 step
  ``trained_cluster.run`` at a reduced scene reads every content.
* Without a GPU and without ``--device cpu`` both entry points raise.

The full runs mirror tests/test_overfit.py and are ``slow`` (deselected
by default, as the JAX ones are): tens of minutes on the CPU.
"""

import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from pbnet_tpu.config import StaticShapes as JStaticShapes
from pbnet_tpu.ops import cluster as jcl
from pbnet_torch.config import StaticShapes
from pbnet_torch.data.dataset import Dataset
from pbnet_torch.models.pbnet import COUNT_MEAN
from pbnet_torch.tools import overfit, trained_cluster

REPO = Path(__file__).resolve().parents[1]

# the worker's result keys (tests/overfit_worker.py:223-255): evaluate()'s,
# with the instance ones only where a proposal matched, and the loss summary
EVAL_KEYS = {"mIoU", "mAcc", "allAcc"}
INSTANCE_KEYS = {"mAP", "AP50", "AP25", "mask_all_acc", "mask_tp_acc", "mask_tf_acc"}
SUMMARY_KEYS = {"sem_loss_final", "sem_loss_after_bb", "mask_loss_first", "mask_loss_last",
                "score_loss_first", "score_loss_last", "steps_full"}

# the JAX side of the batch test, in a process of its own: the worker's
# scenes, lists and GT files (its main, :136-146) and config (:153-163),
# then the batches its two modes train on
JAX_BATCHES = r"""
import dataclasses, os, pickle, sys
import numpy as np
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import overfit_worker as w
from pbnet_tpu.config import Config, StaticShapes
from pbnet_tpu.data.dataset import Dataset
from pbnet_tpu.data.decode_scannet import write_val_gt

outdir = sys.argv[2]
rng = np.random.RandomState(0)
npy = os.path.join(outdir, "npy")
names = []
for i in range(2):
    nm = f"scene{i:04d}_00"
    w.fabricate_npy_scene(npy, nm, rng)
    names.append(nm)
np.savetxt(os.path.join(outdir, "scannetv2_train.txt"), names, fmt="%s")
np.savetxt(os.path.join(outdir, "scannetv2_val.txt"), names, fmt="%s")
np.savetxt(os.path.join(outdir, "scannetv2_test.txt"), names[:1], fmt="%s")
write_val_gt(npy, names, os.path.join(outdir, "val_gt"))
shapes = StaticShapes(
    point_cap=4096, voxel_caps=(4096, 4096, 2048, 1024, 512),
    cluster_cap=16, local_point_cap=8192,
    local_voxel_caps=(8192, 8192, 4096, 2048, 1024),
    score_voxel_caps=(8192, 8192, 4096, 2048, 1024),
    instance_cap=16, cluster_band=1024,
)
cfg = Config(
    data_root=outdir, batch_size=1, max_crop_p=4000, min_crop_p=10,
    num_works=0, cache=False, shapes=shapes, mixup=False,
    cluster_epoch=-1, validation=False, logpath=os.path.join(outdir, "log"),
)
ds = Dataset(cfg)
aug_rng = np.random.RandomState(7)
out = {"val": [ds.val_batch(i) for i in range(2)],
       "heldout": [w.view_batch(ds, it % 2, (0, 1), full_bucket=True, rot_rng=aug_rng)
                   for it in range(2)],
       "shapes": dataclasses.asdict(shapes)}
for b in out["val"]:
    b["shapes"] = dataclasses.asdict(b["shapes"])
with open(sys.argv[3], "wb") as f:
    pickle.dump(out, f)
"""


def assert_batch_equal(got: dict, want: dict, where: str):
    """Every key of the JAX batch, equal exactly (arrays bit for bit)."""
    for k, v in want.items():
        g = got[k]
        if k == "shapes":
            assert dataclasses.asdict(g) == v, where
        elif isinstance(v, np.ndarray):
            assert g.dtype == v.dtype and g.shape == v.shape, (where, k)
            np.testing.assert_array_equal(g, v, err_msg=f"{where} {k}")
        else:
            assert g == v, (where, k, g, v)


def test_fabricated_scenes_and_batches_match_worker(tmp_path):
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    overfit.fabricate(str(port))
    ds = Dataset(overfit.config(str(port)))
    aug_rng = np.random.RandomState(7)
    val = [ds.val_batch(i) for i in range(2)]
    heldout = [overfit.view_batch(ds, it % 2, (0, 1), full_bucket=True, rot_rng=aug_rng)
               for it in range(2)]

    pkl = tmp_path / "jax_batches.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", JAX_BATCHES, str(REPO), str(jax_dir), str(pkl)],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(pkl, "rb") as f:
        ref = pickle.load(f)

    files = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*") if p.is_file())
    assert len(files) == 2 * 6 + 3 + 2  # npy sets, split lists, GT files
    assert files == sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file())
    for rel in files:
        assert (port / rel).read_bytes() == (jax_dir / rel).read_bytes(), rel

    assert dataclasses.asdict(overfit.SHAPES) == ref["shapes"]
    for i, (g, w) in enumerate(zip(val, ref["val"])):
        assert g["shapes"] == overfit.SHAPES  # the training model's shapes
        assert_batch_equal(g, w, f"val_batch({i})")
    for it, (g, w) in enumerate(zip(heldout, ref["heldout"])):
        assert_batch_equal(g, w, f"held-out step {it}")
    # the random rotations differ from step to step
    assert not np.array_equal(heldout[0]["xyz"], heldout[1]["xyz"])


def test_short_run_writes_worker_keys(tmp_path, monkeypatch):
    # the worker's config with the narrow Mini_Unet trio: the keys and the
    # record do not depend on the widths, and a full-width step takes tens
    # of seconds on a CPU shared with the rest of the suite
    worker_config = overfit.config
    monkeypatch.setattr(overfit, "config", lambda outdir: worker_config(outdir).replace(
        backbone_arch="Mini_Unet", dunet_arch="Mini_Unet", score_arch="Mini_Unet"))
    rec = {}
    res = overfit.run(str(tmp_path), device="cpu", bb_steps=2, full_steps=1, rounds=1,
                      record=rec)
    with open(tmp_path / "result.json") as f:
        r = json.load(f)
    assert r == json.loads(json.dumps(res))
    keys = set(r) - {"ap25_by_round", "seconds"}
    assert EVAL_KEYS | SUMMARY_KEYS <= keys <= EVAL_KEYS | SUMMARY_KEYS | INSTANCE_KEYS, keys
    assert r["steps_full"] == 1 and len(r["ap25_by_round"]) == 1
    assert set(r["seconds"]) == {"setup", "backbone", "full", "evaluate"}
    values = [r[k] for k in keys] + r["ap25_by_round"] + list(r["seconds"].values())
    assert all(math.isfinite(v) for v in values), r
    assert len(rec["bb_step_ms"]) == 2 and len(rec["full_step_ms"]) == 1
    # the CPU runs the plain versions: no kernel launch is counted
    assert not any(rec["full_step_launches"][0].values())
    (ev,) = rec["evaluations"]
    assert [s["fn"] for s in ev["timing"]["per_scene"]] == ["scene0000_00", "scene0001_00"]


# a reduced bench scene for the CPU: the script's caps cut to its size
SMALL = dict(point_cap=4096, voxel_caps=(4096, 2048, 1024, 512, 256), cluster_cap=16,
             local_point_cap=4096, local_voxel_caps=(1024, 512, 256, 128, 64),
             score_voxel_caps=(1024, 512, 256, 128, 64), instance_cap=16, cluster_band=1024,
             fg_point_cap=2048, nn_exact_cap=256, grid_extent=(1, 128, 128, 128))
SMALL_SCENE = dict(n_pts=3000, room=1.0, n_obj=3)


def script_content(shapes, scene):
    """perf/trained_cluster_r5.py:46-82 (the JAX bench's scene, its batch
    and oracle content) at ``shapes`` and ``scene``."""
    from pbnet_tpu.core.quantize import sparse_quantize_np

    rng = np.random.RandomState(0)
    xyz, sem_gt, ins_gt, obj_centers = jbench.make_scene(rng, **scene)
    vox, index, _ = sparse_quantize_np(xyz, 0.02)
    n, m = xyz.shape[0], vox.shape[0]
    P, V = shapes.point_cap, shapes.voxel_caps[0]

    def pad(a, cap, fill=0):
        out = np.full((cap,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    sem_o = pad(sem_gt.astype(np.int32), P, -1)
    center_of = np.zeros((P, 3), np.float32)
    has_ins = ins_gt >= 0
    center_of[:n][has_ins] = obj_centers[ins_gt[has_ins]]
    offs_o = np.zeros((P, 3), np.float32)
    offs_o[:n][has_ins] = center_of[:n][has_ins] - xyz[has_ins]
    info = np.full((P, 9), -100.0, np.float32)
    info[:n, 0:3] = center_of[:n]
    pointnum = np.zeros(shapes.instance_cap, np.int32)
    for i in range(int(ins_gt.max()) + 1):
        pointnum[i] = int((ins_gt == i).sum())
    batch = {
        "vox_coords": pad(np.concatenate([np.zeros((m, 1), np.int32), vox], 1), V),
        "vox_feats": pad(rng.randn(m, 6).astype(np.float32) * 0.1, V),
        "vox_valid": np.arange(V) < m,
        "xyz": pad(xyz, P),
        "point_batch": np.zeros(P, np.int32),
        "point_valid": np.arange(P) < n,
        "sem_label": pad(sem_gt.astype(np.int32), P, -100),
        "ins_label": pad(ins_gt.astype(np.int32), P, -100),
        "inst_info": info,
        "instance_pointnum": pointnum,
    }
    return batch, sem_o, offs_o, sem_gt, n


@pytest.mark.parametrize("size", ["reduced", "bench"])
def test_bench_content_matches_script(size):
    if size == "bench":
        shapes, scene = trained_cluster.SHAPES, {}
    else:
        shapes, scene = StaticShapes(**SMALL), SMALL_SCENE
    got = trained_cluster.bench_content(shapes, scene)
    want = script_content(shapes, scene)
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        assert got[0][k].dtype == want[0][k].dtype, k
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]


def script_cluster(sem_in, offs_in, xyz_p, n, shapes):
    """perf/trained_cluster_r5.py:144-173: the fg compaction, then the JAX
    package's binary_cluster (one call)."""
    P, NF = shapes.point_cap, shapes.fg_point_cap
    cm = jnp.asarray(COUNT_MEAN)
    sem_in, offs, xyz_p = jnp.asarray(sem_in), jnp.asarray(offs_in), jnp.asarray(xyz_p)
    sem_clip = jnp.clip(sem_in, 0, 19)
    ok = jnp.arange(P) < n
    class_count = jax.ops.segment_sum(
        ok.astype(jnp.int32), jnp.where(ok, sem_clip, 20), num_segments=21
    )[:20]
    class_ok = class_count.astype(jnp.float32) >= 0.05 * cm
    fg = ok & (sem_in >= 2) & class_ok[sem_clip]
    okey = jnp.where(fg, 0, 1).astype(jnp.int32)
    _, sel = jax.lax.sort((okey, jnp.arange(P, dtype=jnp.int32)), num_keys=2)
    sel = sel[:NF]
    live = fg[sel]
    return jcl.binary_cluster(
        (xyz_p + offs)[sel], xyz_p[sel], sem_in[sel],
        jnp.zeros((NF,), jnp.int32), live,
        radius=0.04, min_pts=31, count_mean=cm,
        cluster_cap=shapes.cluster_cap, band=shapes.cluster_band,
        nn_exact_cap=shapes.nn_exact_cap,
    )


@pytest.mark.parametrize("content", ["oracle", "noisy"])
def test_cluster_on_matches_script(content):
    """Oracle content, and offsets with 3 cm of noise (several propagation
    rounds and needy 1-NN rows, as trained offsets give)."""
    shapes = StaticShapes(**SMALL)
    batch, sem_o, offs_o, _, n = trained_cluster.bench_content(shapes, SMALL_SCENE)
    offs = offs_o.copy()
    if content == "noisy":
        offs[:n] += np.random.RandomState(2).randn(n, 3).astype(np.float32) * 0.03
    got = trained_cluster.cluster_on(torch.from_numpy(sem_o), torch.from_numpy(offs),
                                     torch.from_numpy(batch["xyz"]), n, shapes)
    ref = script_cluster(sem_o, offs, batch["xyz"], n, JStaticShapes(**SMALL))
    for f in got._fields:
        if f == "centers":
            np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                                       rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                          err_msg=f)
    assert int(got.num_clusters) > 0
    if content == "noisy":
        assert int(got.prop_rounds) > 1


def test_trained_cluster_short_run(tmp_path, monkeypatch):
    """``trained_cluster.run`` at the reduced scene, 2 + 2 steps: a reading
    of every content, the oracle's equal to ``cluster_on`` there, and each
    content's predictions saved."""
    shapes = StaticShapes(**SMALL)
    for k, v in dict(SHAPES=shapes, SCENE=SMALL_SCENE, EARLY_STEPS=2, LATE_STEPS=2, WARMUP=0,
                     REPS=1).items():
        monkeypatch.setattr(trained_cluster, k, v)
    r = trained_cluster.run("cpu", str(tmp_path))
    assert set(r["contents"]) == {"oracle", "early", "late"}
    assert [r["train"][k]["total_steps"] for k in ("early", "late")] == [2, 4]
    batch, sem_o, offs_o, _, n = trained_cluster.bench_content(shapes, SMALL_SCENE)
    ref = trained_cluster.cluster_on(torch.from_numpy(sem_o), torch.from_numpy(offs_o),
                                     torch.from_numpy(batch["xyz"]), n, shapes)
    o = r["contents"]["oracle"]
    assert (o["num_clusters"], o["prop_rounds"], o["band_overflow"], o["sem_acc"],
            o["offset_mae"]) == (int(ref.num_clusters), int(ref.prop_rounds), 0, 1.0, 0.0)
    for label, c in r["contents"].items():
        assert math.isfinite(c["ms"]) and c["ms"] > 0, (label, c)
        assert not any(c["launches"].values())  # the plain versions on the CPU
        saved = np.load(tmp_path / f"{label}.npz")
        assert saved["sem"].shape == (shapes.point_cap,)
        assert saved["offs"].shape == (shapes.point_cap, 3)
    np.testing.assert_array_equal(np.load(tmp_path / "oracle.npz")["offs"], offs_o)
    assert json.loads(json.dumps(r)) == r


@pytest.mark.parametrize("module", ["overfit", "trained_cluster"])
def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(tmp_path)] if module == "overfit" else []
    main = overfit.main if module == "overfit" else trained_cluster.main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def run_overfit(tmp_path, *flags):
    """``python -m pbnet_torch.tools.overfit`` on the CPU; its result.json."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "pbnet_torch.tools.overfit", str(tmp_path), "--device", "cpu",
         *flags], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=3600)
    assert proc.returncode == 0, f"overfit failed:\n{proc.stdout[-6000:]}"
    with open(tmp_path / "result.json") as f:
        return json.load(f)


@pytest.mark.slow
def test_overfit_two_scenes_to_ap(tmp_path):
    """tests/test_overfit.py's memorisation proof, on the port."""
    r = run_overfit(tmp_path)
    assert r["sem_loss_after_bb"] < 1.0, r
    assert r["sem_loss_final"] < r["sem_loss_after_bb"], r
    assert r["mask_loss_last"] < r["mask_loss_first"], r
    assert r["score_loss_last"] < r["score_loss_first"], r
    assert r.get("AP25", 0.0) >= 0.9, r
    assert r.get("mAP", 0.0) > 0.0, r


@pytest.mark.slow
def test_heldout_view_transfer(tmp_path):
    """tests/test_overfit.py's held-out proof, on the port."""
    r = run_overfit(tmp_path, "--heldout")
    assert r["sem_loss_after_bb"] < 1.0, r
    assert r.get("AP25", 0.0) >= 0.5, r
