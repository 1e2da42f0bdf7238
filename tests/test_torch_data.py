"""The port's data modules against the JAX package's, on the CPU.

Scenes are ``tests.test_data.fabricate_scene`` meshes in ``tmp_path`` (and a
bent two-plate mesh for the segmentator); the same seeds on both sides.
Every comparison is exact: bytes of the written PLY and val-GT files, every
decoded ``.npy`` (values and dtype), the segment ids, the augmentation
outputs and every array of every batch (train over two epochs with mixup,
val in each size bucket and through the oversize crop, test), the epoch
shards and the loader sequences.  The one float comparison with a tolerance
is the tensor ``vertex_normals`` against the jnp version: 1e-6 (a scatter
add against a segment sum, f32).
"""

import dataclasses
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu.config import Config as JConfig
from pbnet_tpu.config import StaticShapes as JShapes
from pbnet_tpu.data import augment as jaug
from pbnet_tpu.data import dataset as jds
from pbnet_tpu.data import decode_scannet as jdec
from pbnet_tpu.data import ply as jply
from pbnet_tpu.native import segmentator as jseg
from pbnet_tpu.ops import normals as jnorm
from pbnet_torch.config import Config, StaticShapes
from pbnet_torch.data import augment as taug
from pbnet_torch.data import dataset as tds
from pbnet_torch.data import decode_scannet as tdec
from pbnet_torch.data import ply as tply
from pbnet_torch.native import segmentator as tseg
from pbnet_torch.ops import normals as tnorm
from tests.test_data import fabricate_scene, make_grid_mesh


def same_batch(got: dict, want: dict):
    """Every key of the JAX package's batch, equal (arrays exactly, with
    dtype; StaticShapes field by field)."""
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif dataclasses.is_dataclass(w):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), k
        else:
            assert g == w, k


def bent_mesh():
    """Two grid plates meeting at an angle (2+ segments)."""
    xyz1, f1 = make_grid_mesh(10)
    xyz2, f2 = make_grid_mesh(10, z_fn=lambda x, y: x * 0.05)
    xyz2 = xyz2 + np.array([0.5, 0, 0.001])
    return (np.concatenate([xyz1, xyz2]).astype(np.float32),
            np.concatenate([f1, f2 + xyz1.shape[0]]))


def test_ply_bytes_and_arrays_equal(rng, tmp_path):
    xyz, faces = make_grid_mesh(7)
    rgb = rng.randint(0, 255, (xyz.shape[0], 3)).astype(np.uint8)
    labels = rng.randint(0, 40, xyz.shape[0]).astype(np.uint16)
    for lab in (None, labels):
        pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
        jply.write_ply_mesh(pj, xyz, rgb, faces, lab)
        tply.write_ply_mesh(pt, xyz, rgb, faces, lab)
        with open(pj, "rb") as a, open(pt, "rb") as b:
            assert a.read() == b.read()
        want, got = jply.read_ply(pj), tply.read_ply(pj)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["vertex"], want["vertex"])
        np.testing.assert_array_equal(got["face"]["vertex_indices"],
                                      want["face"]["vertex_indices"])


def test_vertex_normals_match_jax(rng):
    xyz, faces = bent_mesh()
    xyz = xyz + rng.randn(*xyz.shape).astype(np.float32) * 0.01
    want = jnorm.vertex_normals_np(xyz, faces)
    got = tnorm.vertex_normals_np(xyz, faces)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    t = tnorm.vertex_normals(torch.from_numpy(xyz), torch.from_numpy(faces))
    j = np.asarray(jnorm.vertex_normals(jnp.asarray(xyz), jnp.asarray(faces)))
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)


def test_segmentator_matches_jax(rng):
    xyz, faces = bent_mesh()
    for k, m in ((0.01, 5), (0.05, 20)):
        got = tseg.segment_mesh(xyz, faces, k, m)
        np.testing.assert_array_equal(got, jseg.segment_mesh(xyz, faces, k, m))
        np.testing.assert_array_equal(got, tseg.segment_mesh_np(xyz, faces, k, m))
        np.testing.assert_array_equal(got, jseg.segment_mesh_np(xyz, faces, k, m))
    assert len(np.unique(tseg.segment_mesh(xyz, faces, 0.01, 5))) >= 2
    pts = rng.rand(300, 3).astype(np.float32)
    nrm = rng.randn(300, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    edges = np.stack([rng.randint(0, 300, 900), rng.randint(0, 300, 900)], 1).astype(np.int64)
    for k, m in ((0.5, 1), (0.01, 20)):
        np.testing.assert_array_equal(tseg.segment_point(pts, nrm, edges, k, m),
                                      jseg.segment_point(pts, nrm, edges, k, m))
    with pytest.raises(ValueError, match="out of range"):
        tseg.segment_mesh(xyz, faces + xyz.shape[0])


def decode_both(tmp_path, rng, names, label_map=None, with_labels=True):
    scans = str(tmp_path / "scans")
    for nm in names:
        fabricate_scene(scans, nm, rng)
    outs = {}
    for tag, mod in (("jax", jdec), ("torch", tdec)):
        out = str(tmp_path / f"npy_{tag}")
        os.makedirs(out, exist_ok=True)
        raw2 = mod.raw_to_scannetv2_map(label_map) if label_map else None
        for nm in names:
            mod.decode_scene(os.path.join(scans, nm + "_vh_clean_2.ply"), out, raw2, with_labels)
        outs[tag] = out
    return outs


def test_decode_and_val_gt_files_equal(rng, tmp_path):
    # a label map in the reference's TSV layout (raw name in column 1,
    # NYU40 name in column 7): 'chair' maps to itself
    tsv = str(tmp_path / "labels.tsv")
    with open(tsv, "w") as f:
        f.write("id\traw_category\tcategory\tcount\tnyu40id\teigen13id\tnyuClass\tnyu40class\n")
        f.write("1\tchair\tchair\t1\t5\t11\tchair\tchair\n")
        f.write("2\tstool\tstool\t1\t40\t7\tstool\totherprop\n")
    assert tdec.raw_to_scannetv2_map(tsv) == jdec.raw_to_scannetv2_map(tsv)
    names = ["scene0001_00", "scene0002_00"]
    outs = decode_both(tmp_path, rng, names, label_map=tsv)
    files = sorted(os.listdir(outs["jax"]))
    assert files == sorted(os.listdir(outs["torch"]))
    assert len(files) == 7 * len(names)
    for fn in files:
        a = np.load(os.path.join(outs["jax"], fn))
        b = np.load(os.path.join(outs["torch"], fn))
        assert a.dtype == b.dtype, fn
        np.testing.assert_array_equal(b, a, err_msg=fn)
    for tag, mod in (("jax", jdec), ("torch", tdec)):
        mod.write_val_gt(outs[tag], names, str(tmp_path / f"gt_{tag}"))
    for nm in names:
        with open(tmp_path / "gt_jax" / f"{nm}.txt", "rb") as a, \
                open(tmp_path / "gt_torch" / f"{nm}.txt", "rb") as b:
            assert a.read() == b.read()
    # a test-split scene: no labels
    outs = decode_both(tmp_path / "test", rng, ["scene0100_00"], with_labels=False)
    files = sorted(os.listdir(outs["jax"]))
    assert files == sorted(os.listdir(outs["torch"])) and len(files) == 5
    for fn in files:
        np.testing.assert_array_equal(np.load(os.path.join(outs["torch"], fn)),
                                      np.load(os.path.join(outs["jax"], fn)), err_msg=fn)


def test_augment_matches_jax(rng):
    xyz = rng.rand(500, 3) * np.array([3.0, 2.0, 1.5])
    rgb = rng.rand(500, 3) * 2 - 1
    nl = rng.randn(500, 3)
    for flags in (dict(), dict(jitter=True, flip=True, rot=True, scale=True, elastic_dist=True)):
        for i in range(3):
            a = jaug.data_augment(xyz.copy(), rgb.copy(), nl, i, np.random.RandomState(5), **flags)
            b = taug.data_augment(xyz.copy(), rgb.copy(), nl, i, np.random.RandomState(5), **flags)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
    np.testing.assert_array_equal(taug.elastic(xyz * 50, 6, 40, np.random.RandomState(1)),
                                  jaug.elastic(xyz * 50, 6, 40, np.random.RandomState(1)))
    for max_p in (400, 120):
        a = jaug.crop(xyz * 10, max_p, 10.24, 1.0, np.random.RandomState(2))
        b = taug.crop(xyz * 10, max_p, 10.24, 1.0, np.random.RandomState(2))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    ins = np.where(rng.rand(500) < 0.2, -100, rng.randint(0, 9, 500)).astype(np.float64)
    valid = rng.rand(500) < 0.6
    for v in (None, valid):
        np.testing.assert_array_equal(taug.compact_instance_labels(ins, v),
                                      jaug.compact_instance_labels(ins, v))
    ins_c = taug.compact_instance_labels(ins, valid).astype(np.int32)
    a = jaug.instance_info(xyz[valid].astype(np.float32), ins_c)
    b = taug.instance_info(xyz[valid].astype(np.float32), ins_c)
    assert a[0] == b[0] and a[2] == b[2]
    np.testing.assert_array_equal(b[1], a[1])


# a 4-level-free cap set whose eval buckets (0.4, 0.7, 1.0) differ in
# points and voxels: fabricated grid meshes of side 20, 60 and 70 land in
# the three buckets and side 80 exceeds the largest (the oversize crop)
SHAPES = dict(point_cap=16384, voxel_caps=(16384, 8192, 4096, 2048, 1024), cluster_cap=16,
              local_point_cap=16384, local_voxel_caps=(8192, 4096, 2048, 1024, 512),
              score_voxel_caps=(8192, 4096, 2048, 1024, 512), instance_cap=16,
              cluster_band=512)
SIDES = {"scene0000_00": 20, "scene0001_00": 60, "scene0002_00": 70, "scene0003_00": 80,
         "scene0004_00": 14, "scene0005_00": 24}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    rng = np.random.RandomState(0)
    scans, out = str(root / "scans"), str(root / "npy")
    os.makedirs(out)
    for nm, side in SIDES.items():
        fabricate_scene(scans, nm, rng, side=side)
        jdec.decode_scene(os.path.join(scans, nm + "_vh_clean_2.ply"), out, None)
    names = sorted(SIDES)
    np.savetxt(str(root / "scannetv2_train.txt"), names, fmt="%s")
    np.savetxt(str(root / "scannetv2_val.txt"), names[:4], fmt="%s")
    np.savetxt(str(root / "scannetv2_test.txt"), names[2:4], fmt="%s")
    return str(root)


def both_datasets(data_root, **kw):
    base = dict(data_root=data_root, batch_size=2, max_crop_p=3000, min_crop_p=10,
                num_works=0, cache=False, **kw)
    return (jds.Dataset(JConfig(shapes=JShapes(**SHAPES), **base)),
            tds.Dataset(Config(shapes=StaticShapes(**SHAPES), **base)))


def test_batch_seed_and_epoch_shards_match_jax(data_root):
    for e in (0, 1, 519):
        for i in (0, 7, 1000):
            assert tds.batch_seed(22, e, i) == jds.batch_seed(22, e, i)
    jd, td = both_datasets(data_root)
    for epoch in (1, 2, 3):
        for rank, world in ((0, 1), (0, 2), (1, 2), (2, 3)):
            a = jd.train_epoch_ids(epoch, rank, world)
            b = td.train_epoch_ids(epoch, rank, world)
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)


def test_train_batches_match_jax_over_two_epochs(data_root):
    """Mixup on, crop retries: the loaders' whole sequence, epochs 1-2."""
    jd, td = both_datasets(data_root, mixup=True)
    n = 0
    for epoch in (1, 2):
        for a, b in zip(jd.train_loader(epoch, num_workers=0),
                        td.train_loader(epoch, num_workers=0), strict=True):
            same_batch(b, a)
            n += 1
    assert n == 6


def test_val_batches_match_jax_in_each_bucket(data_root):
    jd, td = both_datasets(data_root)
    buckets = td.cfg.eval_buckets()
    seen = []
    for i in range(4):
        a, b = jd.val_batch(i), td.val_batch(i)
        same_batch(b, a)
        assert b["collate_s"] >= 0
        seen.append(buckets.index(b["shapes"]))
        if b["keep_idx"] is not None:  # the oversize crop
            assert b["orig_num_points"] > b["num_points"] // 3
            assert b["dropped_sem"].shape[0] == b["orig_num_points"] - b["keep_idx"].shape[0]
    assert seen == [0, 1, 2, 2]
    assert [jd.val_batch(i)["keep_idx"] is None for i in range(4)] == [True, True, True, False]
    for i in range(2):
        same_batch(td.test_batch(i), jd.test_batch(i))


def test_bounded_loaders_match_jax(data_root):
    """num_works=2: the same batches in the same order as the JAX package's
    loaders (which submit every batch at once), with at most 3 in flight."""
    workers = 2
    jd, td = both_datasets(data_root, mixup=True)
    started, at_yield = [], []
    lock = threading.Lock()
    orig = td.train_batch

    def counted(ids, rng):
        with lock:
            started.append(1)
        time.sleep(0.02)  # let the pool run ahead if it would
        return orig(ids, rng)

    td.train_batch = counted
    for k, (a, b) in enumerate(zip(jd.train_loader(1, num_workers=workers),
                                   td.train_loader(1, num_workers=workers), strict=True)):
        with lock:
            at_yield.append(len(started))
        same_batch(b, a)
    assert at_yield and all(s <= k + 1 + workers for k, s in enumerate(at_yield))
    for a, b in zip(jd.val_loader(num_workers=workers), td.val_loader(num_workers=workers),
                    strict=True):
        same_batch(b, a)


def test_prefetch_window_and_cancel():
    """The pool never holds more than workers + 1 calls in flight; an
    abandoned iteration leaves no call running or queued."""
    workers, n = 3, 20
    live, peak, done = [0], [0], []
    lock = threading.Lock()

    def work(i):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.005)
        done.append(i)
        return i

    out = []
    for i in tds.prefetch(work, ((i,) for i in range(n)), workers):
        with lock:
            live[0] -= 1
        out.append(i)
    assert out == list(range(n)) and peak[0] <= workers + 1
    done.clear()
    it = tds.prefetch(work, ((i,) for i in range(n)), workers)
    assert next(it) == 0
    it.close()
    assert len(done) <= workers + 1


def test_shm_cache_directory_is_the_ports():
    assert tdec.SHM_DIR != jdec.SHM_DIR and tdec.SHM_DIR.endswith("pbnet_torch")
    assert json.dumps(tdec.VALID_NYU40) == json.dumps(jdec.VALID_NYU40)
    np.testing.assert_array_equal(tdec.REMAPPER, jdec.REMAPPER)
