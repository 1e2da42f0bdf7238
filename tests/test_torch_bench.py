"""The port's measurement entry points (``pbnet_torch.bench``,
``pbnet_torch.eval_throughput``) and its work count (``tools/work.py``), on
the CPU.

* The work count of every conv on the tiny two-instance scene
  (``synthetic.GRAFT_SHAPES`` with voxel caps and a clustering band that
  hold it, the MinkUNet34C / 14A / 34C trio, oracle stage 1) equals ``2 * Cin * Cout`` times a numpy count of present
  neighbour pairs, built from each level's voxel coordinates and the conv's
  offsets, and the present entries of the JAX package's kernel maps for the
  same voxels; with banding plans attached the count is the same, some
  convs on the banded route.
* The bench request (what ``bench.main`` times) on a small bench-like scene
  against the JAX package's ``PBNet.backbone`` and ``instance_stage``
  driven by the same oracle (``bench.py``'s loop body at r = 1), from the
  same converted weights, conv operands in f32, the Mini_Unet trio: cluster
  and proposal ids equal, scores within ``test_torch_pbnet.TOL``.
* ``eval_throughput.fabricate_val_set`` writes the JAX script's files byte
  for byte; the three eval passes at a tiny config give the JAX script's
  keys, every scene in each pass, two buckets in the warm pass and one in
  the single-bucket pass, and no rate on the CPU.
* An unknown card has no peaks; without a card and without ``--device
  cpu`` both entry points exit non-zero and print no result.
"""

import dataclasses
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval_throughput as jet
from pbnet_tpu.core import topology as jtp
from pbnet_tpu.models.pbnet import PBNet as JPBNet
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_torch import bench, convert
from pbnet_torch import eval_throughput as tet
from pbnet_torch import synthetic
from pbnet_torch.config import StaticShapes
from pbnet_torch.core.topology import kernel_offsets
from pbnet_torch.models.pbnet import MASK_THRESH, PBNet, batch_to_device
from pbnet_torch.nn import onehot_conv as toc
from pbnet_torch.nn import sparse_ops as tso
from tests.test_torch_pbnet import TOL

REPO = Path(__file__).resolve().parents[1]
ARCHS = dict(backbone_arch="Mini_Unet", dunet_arch="Mini_Unet", score_arch="Mini_Unet")


def tiny_oracle(tb):
    """The tiny scene's oracle stage 1 (true class, offsets onto the true
    centre, softmax 0.9 on the true class)."""
    sem = np.clip(tb["sem_label"], 0, 19).astype(np.int32)
    offs = np.where((tb["ins_label"] != -100)[:, None],
                    tb["inst_info"][:, 0:3] - tb["xyz"], 0.0).astype(np.float32)
    soft = (np.eye(20, dtype=np.float32)[sem] * 0.9 + 0.005).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (sem, offs, soft))


def conv_plan(unet):
    """(map kind, output level, kernel) of each conv of a MinkUNetBase, in
    forward order."""
    yield "stem", 0, unet.conv0.kernel
    for s in range(4):
        yield "down", s + 1, getattr(unet, f"conv{s + 1}s2").kernel
        for i in range(unet.layers[s]):
            blk = getattr(unet, f"block{s + 1}_{i}")
            yield "k3", s + 1, blk.conv1.kernel
            yield "k3", s + 1, blk.conv2.kernel
    for d in range(4):
        lvl = 3 - d
        yield "up", lvl, getattr(unet, f"convtr{4 + d}").kernel
        for i in range(unet.layers[4 + d]):
            blk = getattr(unet, f"block{5 + d}_{i}")
            yield "k3", lvl, blk.conv1.kernel
            yield "k3", lvl, blk.conv2.kernel


def numpy_pairs(kind, lvl, coords, valid_in, valid_out):
    """Present neighbour pairs of one conv from voxel coordinates: output
    voxels ``valid_out`` of level ``lvl`` against the input level's
    ``valid_in`` voxels (coordinates in stride-1 units, column 0 the batch
    or local-scene id)."""
    def voxels(l, v):
        return [tuple(int(x) for x in c) for c in coords[l][v[l]]]

    if kind == "up":  # each output voxel reads its parent, when present
        s2 = 2 ** (lvl + 1)
        present = set(voxels(lvl + 1, valid_in))
        return sum((c[0],) + tuple(x // s2 * s2 for x in c[1:]) in present
                   for c in voxels(lvl, valid_out))
    if kind == "down":
        offs, src = kernel_offsets(2) * 2 ** (lvl - 1), lvl - 1
    else:
        offs, src = kernel_offsets(5 if kind == "stem" else 3) * 2 ** lvl, lvl
    present = set(voxels(src, valid_in))
    return sum((c[0], c[1] + d[0], c[2] + d[1], c[3] + d[2]) in present
               for c in voxels(lvl, valid_out) for d in offs)


def jax_maps(level0, caps, extent=None, main=None, n_pids=0):
    """The JAX package's kernel maps for the voxels of the port's level 0
    ``level0``: the backbone's grid build, or with ``main`` (a JAX
    topology) a local scene's maps derived from it, as its model derives
    them."""
    @jax.jit
    def build(coords, valid, main):
        jl = jtp.level_from_coords(coords, valid, caps[0], 1)
        if main is None:
            j = jtp.build_unet_topology(jl, caps, extent=extent)
        else:
            j = jtp.build_pid_unet_topology(jl, caps, main, jnp.zeros((n_pids,), jnp.int32),
                                            n_pids)
        return j

    j = build(jnp.asarray(level0.coords.numpy()), jnp.asarray(level0.valid.numpy()), main)
    return j, {"stem": {0: j.stem_map}, "k3": dict(enumerate(j.k3_maps)),
               "down": {l + 1: m for l, m in enumerate(j.down_maps)},
               "up": dict(enumerate(j.up_maps))}


# the tiny two-instance scene's caps, with voxel caps and a clustering band
# that hold it (level counts 399, 386, 315, 165, 76): nothing overflows
CAPS = (512, 512, 512, 256, 128)
TINY_FIT = dataclasses.replace(synthetic.GRAFT_SHAPES, voxel_caps=CAPS, local_voxel_caps=CAPS,
                               score_voxel_caps=CAPS, cluster_band=512)


@pytest.fixture(scope="module")
def tiny_counts():
    """The tiny scene's work count, the three UNets' topologies and the
    JAX package's maps for them."""
    sh = TINY_FIT
    tb = synthetic.synthetic_batch(sh, np.random.RandomState(0))
    model = PBNet(sh, seed=1, device="cpu")
    topos = {}
    hooks = [getattr(model, n).register_forward_pre_hook(
        lambda _m, args, n=n: topos.__setitem__(n, args[0]))
        for n in ("MEUnet", "D_Unet", "score_Unet")]
    wc, out = bench.count_work(model, batch_to_device(tb, "cpu"), tiny_oracle(tb))
    for h in hooks:
        h.remove()
    main, jmain = jax_maps(topos["MEUnet"].levels[0], list(CAPS), extent=sh.grid_extent)
    _, jlocal = jax_maps(topos["D_Unet"].levels[0], list(CAPS), main=main,
                         n_pids=sh.cluster_cap)
    # the ScoreNet reuses the local scene's maps
    jmaps = {"MEUnet": jmain, "D_Unet": jlocal, "score_Unet": jlocal}
    return dict(tb=tb, model=model, wc=wc, out=out, topos=topos, jmaps=jmaps)


def test_work_count_matches_maps(tiny_counts):
    model, wc, topos, jmaps = (tiny_counts[k] for k in ("model", "wc", "topos", "jmaps"))
    convs = [l for l in wc.layers if l.route != "dense"]
    # the ScoreNet's topology derives from the local scene's: its maps are
    # the D_Unet's, its valid rows a subset
    map_topo = {"MEUnet": topos["MEUnet"], "D_Unet": topos["D_Unet"],
                "score_Unet": topos["D_Unet"]}
    want = []
    for name, stage in bench.STAGE_OF:
        coords = [lv.coords.numpy() for lv in map_topo[name].levels]
        valid_in = [lv.valid.numpy() for lv in map_topo[name].levels]
        valid_out = [lv.valid.numpy() for lv in topos[name].levels]
        for kind, lvl, kernel in conv_plan(getattr(model, name)):
            k, cin, cout = kernel.shape
            pairs = numpy_pairs(kind, lvl, coords, valid_in, valid_out)
            jm = np.asarray(jmaps[name][kind][lvl])
            jpairs = int(((jm >= 0) & valid_out[lvl][:, None]).sum())
            assert jpairs == pairs, (name, kind, lvl)
            want.append((stage, k, cin, cout, pairs, 2 * cin * cout * pairs))
    got = [(l.stage, l.k, l.cin, l.cout, l.entries, l.useful) for l in convs]
    assert got == want
    assert all(l.route == "gather" for l in convs)
    out = tiny_counts["out"]
    assert not any(int(v) for v in out["overflow"].values())
    # stage 3 keeps some of the local scene's voxels
    assert 0 < int(out["usage"]["score_vox"]) <= int(out["usage"]["local_vox"])
    dense = [l for l in wc.layers if l.route == "dense"]
    assert dense and all(l.useful == 2 * l.cin * l.cout * l.entries for l in dense)
    s = wc.summary()
    assert s["useful_ops"] == sum(w[-1] for w in want) + sum(l.useful for l in dense)
    assert s["executed_ops"] == sum(2 * l.rows * l.k * l.cin * l.cout for l in wc.layers)
    assert s["executed_ops"] > s["useful_ops"]


def test_work_count_same_with_banded_plans(tiny_counts, monkeypatch):
    monkeypatch.setattr(toc, "MIN_CIN", 32)
    sh = dataclasses.replace(TINY_FIT, onehot_tm=128,
                             onehot_spans=(256, 256, 128, 0, 0),
                             onehot_spans_local=(256, 256, 128, 0, 0))
    model = PBNet(sh, device="cpu")
    model.load_state_dict(tiny_counts["model"].state_dict())
    tb = tiny_counts["tb"]
    wc, _ = bench.count_work(model, batch_to_device(tb, "cpu"), tiny_oracle(tb))
    base = tiny_counts["wc"]
    routes = wc.summary()["layers_by_route"]
    assert routes.get("banded", 0) > 0 and routes["gather"] > 0
    assert [(l.stage, l.k, l.cin, l.cout, l.entries) for l in wc.layers] == \
           [(l.stage, l.k, l.cin, l.cout, l.entries) for l in base.layers]
    assert wc.useful() == base.useful()
    assert wc.executed() < base.executed()  # banded convs run no GEMM


def test_counting_off_costs_nothing():
    """Outside a count the hooks record nothing."""
    from pbnet_torch.tools import work

    assert not work.ACTIVE
    f = torch.randn(10, 4)
    km = torch.tensor([[0, -1], [3, 4]] * 5, dtype=torch.int32)
    tso.gather_conv(f, km, torch.randn(2, 4, 3), torch.ones(10, dtype=torch.bool))
    with work.WorkCount() as wc:
        tso.gather_conv(f, km, torch.randn(2, 4, 3), torch.arange(10) < 4)
    assert not work.ACTIVE
    (layer,) = wc.layers
    assert (layer.entries, layer.useful, layer.executed) == (6, 2 * 4 * 3 * 6, 2 * 10 * 2 * 4 * 3)


def small_bench_scene():
    """A bench-like room of 3,000 points (three box objects, two of them in
    classes whose counts pass the class gate), its shapes and oracle."""
    rng = np.random.RandomState(0)
    xyz, sem, ins, centers = synthetic.make_scene(rng, n_pts=3000, room=1.0, n_obj=3)
    shapes = StaticShapes(point_cap=3072, voxel_caps=(3072, 3072), cluster_cap=8,
                          local_point_cap=2048, local_voxel_caps=(2048, 1024),
                          score_voxel_caps=(2048, 1024), instance_cap=8, cluster_band=1024,
                          grid_extent=(1, 64, 64, 160))
    batch = synthetic.bench_batch(rng, xyz, shapes)
    return batch, synthetic.oracle_stage1(xyz, sem, ins, centers, shapes.point_cap), shapes


@pytest.fixture
def f32():
    oj, ot = jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = jnp.float32, torch.float32
    yield
    jso.COMPUTE_DTYPE, tso.COMPUTE_DTYPE = oj, ot


def test_bench_request_matches_jax(f32, fast_compile):
    batch, oracle, shapes = small_bench_scene()
    jm = JPBNet(shapes=shapes, **ARCHS)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda k, b: jm.init(k, b, with_instances=True, with_labels=False,
                                             train=False))(jax.random.PRNGKey(0), jb)
    tm = PBNet(shapes, device="cpu", **ARCHS)
    tm.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
    tbb, got = bench.request(tm, batch_to_device(batch, "cpu"),
                             tuple(torch.from_numpy(a) for a in oracle))

    @jax.jit
    def jax_request(v, b, orc):
        bb = dict(jm.apply(v, b, False, method=JPBNet.backbone))
        bb["sem_pred_p"], bb["offset_pred_p"], bb["sem_soft_p"] = orc
        return bb, jm.apply(v, b, bb, False, False, method=JPBNet.instance_stage)

    jbb, ref = jax_request(variables, jb, tuple(jnp.asarray(a) for a in oracle))
    # nothing overflows in either package (an overflowing JAX local grid
    # drops map entries the port keeps)
    for k in ("overflow_vox", "overflow_grid", "overflow_band"):
        assert int(tbb[k]) == int(jbb[k]) == 0, k
    for k in ref["overflow"]:
        assert int(got["overflow"][k]) == int(ref["overflow"][k]) == 0, k
    for k in ("point_feat_p", "sem_pred_score_p"):
        np.testing.assert_allclose(tbb[k].numpy(), np.asarray(jbb[k]), err_msg=k, **TOL)
    assert int(got["cluster"].num_clusters) == 2 == int(ref["cluster"].num_clusters)
    np.testing.assert_array_equal(got["cluster"].cluster_id.numpy(),
                                  np.asarray(ref["cluster"].cluster_id))
    for k in ("scene_pid", "scene_src", "num_proposals"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    ms = np.asarray(ref["mask_scores"])
    np.testing.assert_allclose(got["mask_scores"].numpy(), ms, **TOL)
    # no mask score sits near the cut, so every kept flag and proposal id is
    # held exactly
    assert (np.abs(ms - MASK_THRESH) >= 1e-5).all()
    for k in ("prop_point_kept", "prop_point_pid", "num_final_proposals", "prop_sem"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert int(got["num_final_proposals"]) > 0
    np.testing.assert_allclose(got["clt_scores"].numpy(), np.asarray(ref["clt_scores"]), **TOL)
    assert bench.outcome(tbb, got) == (2, int(ref["num_final_proposals"]), 0)


TWO_SCENES = ((1, 1200), (1, 2400))


def test_fabricated_val_set_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jet, "SCENE_MIX", TWO_SCENES)
    monkeypatch.setattr(tet, "SCENE_MIX", TWO_SCENES)
    a, b = tmp_path / "jax", tmp_path / "port"
    assert jet.fabricate_val_set(str(a)) == tet.fabricate_val_set(str(b)) == \
        ["scene0000_00", "scene0001_00"]
    files = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    assert len(files) == 2 * 6 + 3 + 2
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors


# eval_throughput.py's JSON keys (its last print)
JAX_KEYS = ("metric", "scenes", "first_dispatch_scenes_per_sec", "first_dispatch_compile_s",
            "warm_scenes_per_sec", "single_bucket_scenes_per_sec", "bucket_scene_counts",
            "single_bucket_scene_counts")


def test_eval_passes_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tet, "SCENE_MIX", TWO_SCENES)
    root = str(tmp_path)
    tet.fabricate_val_set(root)
    # the small scene's three copies fit the 0.4 bucket (4,096 points), the
    # large one's only the 1.0 bucket
    shapes = StaticShapes(point_cap=8192, voxel_caps=(8192, 8192), cluster_cap=64,
                          local_point_cap=8192, local_voxel_caps=(8192, 4096),
                          score_voxel_caps=(8192, 4096), instance_cap=64, cluster_band=1024)
    cfg = tet.eval_config(root).replace(shapes=shapes, **ARCHS)
    capsys.readouterr()
    res = tet.measure(cfg, PBNet(shapes, seed=cfg.manual_seed, device="cpu", **ARCHS))
    assert set(res) == set(JAX_KEYS) | {"device", "power_limit"}
    json.dumps(res)
    assert res["metric"] == "eval_loop_scenes_per_sec" and res["scenes"] == 2
    assert (res["device"], res["power_limit"]) == ("cpu", None)
    assert all(res[k] is None for k in JAX_KEYS if k.endswith("per_sec"))
    assert sorted(res["bucket_scene_counts"].values()) == [1, 1]
    assert list(res["single_bucket_scene_counts"].values()) == [2]
    assert set(res["first_dispatch_compile_s"]) == set(res["bucket_scene_counts"])
    passes = [json.loads(line.split(" ", 1)[1]) for line in capsys.readouterr().err.splitlines()
              if line.startswith("eval-pass ")]
    assert [p["pass"] for p in passes] == ["first-dispatch", "warm", "single-bucket"]
    assert [p["scenes"] for p in passes] == [2, 2, 2]
    assert [len(p["bucket_scene_counts"]) for p in passes] == [2, 2, 1]


def test_unknown_card_has_no_peaks():
    assert bench.device_peaks("NVIDIA H100 80GB HBM3").bf16_flops == 989e12
    with pytest.raises(KeyError, match="no peak rates"):
        bench.device_peaks("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("module", ["pbnet_torch.bench", "pbnet_torch.eval_throughput"])
def test_entry_point_without_card_fails(module):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", module], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert '"metric"' not in r.stdout
