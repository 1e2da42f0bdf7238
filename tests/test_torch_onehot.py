"""The port's banded conv (pbnet_torch/nn/onehot_conv.py) against the JAX
package's (pbnet_tpu/nn/onehot_conv.py, Pallas kernel in interpret mode).

* Plans: ``starts``, ``rel`` and ``overflow`` exactly equal on the synthetic
  maps of tests/test_onehot.py, the same untileable cases give None, and
  ``attach_plans`` on a tiny real pyramid matches plan for plan.
* The conv: ``onehot_conv_plain`` against JAX's ``onehot_conv`` for K = 27
  and K = 8, with a plan that drops nothing and with a tight plan that drops
  entries (where the banded conv differs from the gather conv), in bf16 and
  f32 operands.  Tolerance 1e-4 of the output's largest magnitude: both
  sides multiply the same rounded operands, only the order of the f32 sums
  differs.
* ``gather_conv(plan=...)`` against JAX's, and below ``MIN_CIN`` exactly
  the gather path.
* The whole PBNet forward (Mini_Unet trio) on the tiny two-instance scene
  with spans set: ids and every overflow counter exactly equal,
  ``overflow_band`` and ``conv_band`` included (> 0 with tight spans),
  floats within rtol/atol 1e-4 in f32 operands.  It runs in test_pbnet's
  TINY shapes, as tests/test_torch_pbnet.py does: in GRAFT_SHAPES the JAX
  package's local pid grid overflows (``local_grid`` 184), a grid the
  port's lookup topology does not have.  ``MIN_CIN`` is lowered to 32 in
  both packages so that the narrow test widths reach the banded path.
"""

import dataclasses

import __graft_entry__ as graft
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu.core import topology as jtp
from pbnet_tpu.models import pbnet as jpb
from pbnet_tpu.nn import onehot_conv as joc
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_torch import convert
from pbnet_torch.config import StaticShapes
from pbnet_torch.core import topology as ttp
from pbnet_torch.models import pbnet as tpb
from pbnet_torch.nn import onehot_conv as toc
from pbnet_torch.nn import sparse_ops as tso
from tests.test_onehot import synth_map
from tests.test_pbnet import TINY
from tests.test_torch_nn import randomise_stats

ARCHS = dict(backbone_arch="Mini_Unet", dunet_arch="Mini_Unet", score_arch="Mini_Unet")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(joc, "INTERPRET", True)


@pytest.fixture
def dtypes(request):
    """Set both packages' conv operand dtype ("bf16" or "f32")."""
    name = getattr(request, "param", "f32")
    monkey = pytest.MonkeyPatch()
    monkey.setattr(jso, "COMPUTE_DTYPE", jnp.bfloat16 if name == "bf16" else jnp.float32)
    monkey.setattr(tso, "COMPUTE_DTYPE", torch.bfloat16 if name == "bf16" else torch.float32)
    yield name
    monkey.undo()


def plans_equal(t, j):
    assert (t is None) == (j is None)
    if t is None:
        return
    np.testing.assert_array_equal(t.starts.numpy(), np.asarray(j.starts))
    np.testing.assert_array_equal(t.rel.numpy(), np.asarray(j.rel))
    assert int(t.overflow) == int(j.overflow)
    assert (t.span, t.kz, t.m_in) == (j.span, j.kz, j.m_in)


@pytest.mark.parametrize("M,m_in,K,kz,tm,span,jitter", [
    (256, 256, 27, 3, 128, 192, 40),
    (256, 256, 27, 3, 128, 64, 100),    # tight: overflow > 0
    (256, 300, 27, 3, 64, 200, 40),     # span % 16 != 0: aligned clip
    (128, 256, 8, 2, 64, 128, 40),
    (100, 128, 27, 3, 64, 128, 40),     # M_out % tm != 0 -> None
    (128, 100, 27, 3, 64, 128, 40),     # m_in < span -> None
])
def test_plan_matches_jax(M, m_in, K, kz, tm, span, jitter):
    km = np.asarray(synth_map(np.random.RandomState(M + span), M, m_in, K, kz, jitter=jitter))
    j = joc.build_onehot_plan(jnp.asarray(km), kz, m_in, tm=tm, span=span)
    t = toc.build_onehot_plan(torch.from_numpy(km), kz, m_in, tm=tm, span=span)
    plans_equal(t, j)
    plans_equal(toc.reverse_plan(t), joc.reverse_plan(j))
    if span == 64:
        assert int(t.overflow) > 0


def tiny_level(rng, n=700, cap=1024):
    xyz = np.unique((rng.rand(n, 3) * np.array([60, 60, 24])).astype(np.int32), axis=0)
    coords = np.zeros((cap, 4), np.int32)
    coords[: len(xyz), 1:] = xyz
    return coords, np.arange(cap) < len(xyz)


@pytest.mark.parametrize("spans", [(256, 256), (128, 32)])
def test_attach_plans_matches_jax(spans):
    coords, valid = tiny_level(np.random.RandomState(7))
    feats = np.zeros((len(coords), 1), np.float32)
    caps = [1024, 512, 256]
    jt = jax.jit(lambda c, f, v: joc.attach_plans(
        jtp.build_unet_topology(jpb.make_level0(c, f, v)[0], caps), 128, spans))(
        jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(valid))
    tl, _ = tpb.make_level0(torch.from_numpy(coords), torch.from_numpy(feats),
                            torch.from_numpy(valid))
    tt = toc.attach_plans(ttp.build_unet_topology(tl, caps), 128, spans)
    for name in ("k3_plans", "down_plans", "up_plans"):
        for t, j in zip(getattr(tt, name), getattr(jt, name), strict=True):
            plans_equal(t, j)
    assert int(tt.plan_overflow) == int(jt.plan_overflow)
    assert tt.k3_plans[0] is not None and tt.k3_plans[2] is None  # span 0 disables
    assert (int(tt.plan_overflow) > 0) == (spans[1] == 32)


def conv_case(rng, K, kz, cin, cout, span, M=256, m_in=256):
    km = np.asarray(synth_map(rng, M, m_in, K, kz, jitter=100 if span < 128 else 40))
    feats = rng.randn(m_in, cin).astype(np.float32)
    w = (rng.randn(K, cin, cout) * 0.1).astype(np.float32)
    valid = np.arange(M) < M - 7
    return km, feats, w, valid


def close(got, want):
    scale = float(np.abs(want).max()) + 1e-6
    assert float(np.abs(got - want).max()) <= 1e-4 * scale


@pytest.mark.parametrize("dtypes", ["bf16", "f32"], indirect=True)
@pytest.mark.parametrize("K,kz,span", [(27, 3, 192), (27, 3, 64), (8, 2, 192), (8, 2, 48)])
def test_onehot_conv_plain_matches_jax(dtypes, K, kz, span):
    rng = np.random.RandomState(K + span)
    km, feats, w, valid = conv_case(rng, K, kz, 64, 32, span)
    jp = joc.build_onehot_plan(jnp.asarray(km), kz, 256, tm=128, span=span)
    tp_ = toc.build_onehot_plan(torch.from_numpy(km), kz, 256, tm=128, span=span)
    want = np.asarray(joc.onehot_conv(jnp.asarray(feats), jp, jnp.asarray(w),
                                      jnp.asarray(valid), jso.COMPUTE_DTYPE))
    t = torch.from_numpy
    got = toc.onehot_conv(t(feats), tp_, t(w), t(valid), tso.COMPUTE_DTYPE).numpy()
    close(got, want)
    gather = tso.gather_conv(t(feats), t(km), t(w), t(valid)).numpy()
    if span < 128:  # dropped entries: the banded conv is not the gather conv
        assert int(tp_.overflow) > 0
        assert np.abs(got - gather).max() > 1e-2 * np.abs(gather).max()
        # it is the gather conv over the entries the plan keeps
        close(got, tso.gather_conv(t(feats), toc.plan_map(tp_), t(w), t(valid)).numpy())
    else:
        assert int(tp_.overflow) == 0
        close(got, gather)


# the bench's widest conv (Cin 192 -> Cout 128), and an m_out of one tile
@pytest.mark.parametrize("M,tm,cin,cout", [(256, 128, 192, 128), (256, 256, 64, 96)])
def test_onehot_conv_plain_bench_widths_match_jax(M, tm, cin, cout):
    rng = np.random.RandomState(cin + tm)
    km, feats, w, valid = conv_case(rng, 27, 3, cin, cout, 192, M=M)
    jp = joc.build_onehot_plan(jnp.asarray(km), 3, 256, tm=tm, span=192)
    tp_ = toc.build_onehot_plan(torch.from_numpy(km), 3, 256, tm=tm, span=192)
    plans_equal(tp_, jp)
    want = np.asarray(joc.onehot_conv(jnp.asarray(feats), jp, jnp.asarray(w),
                                      jnp.asarray(valid), jnp.bfloat16))
    t = torch.from_numpy
    got = toc.onehot_conv(t(feats), tp_, t(w), t(valid), torch.bfloat16).numpy()
    assert got.shape == (M, cout)
    close(got, want)


# (m_out, K, cin, cout) of the banded bench convs (synthetic.BANDED_SHAPES):
# main and local k3 at L1/L2, up at L0/L1, down at L3
BENCH_CONVS = [
    (39_424, 27, 128, 96), (39_424, 27, 96, 96), (10_240, 27, 128, 128),
    (10_240, 27, 192, 128), (10_240, 27, 64, 64), (92_416, 8, 96, 96),
    (39_424, 8, 128, 96), (4_096, 8, 64, 64), (20_992, 27, 128, 96),
    (20_992, 27, 96, 96), (5_888, 27, 128, 128), (5_888, 27, 192, 128),
    (5_888, 27, 64, 64), (41_984, 8, 96, 96), (20_992, 8, 128, 96), (1_536, 8, 64, 64),
]


def test_tiling_fills_the_card():
    """The CUDA kernel's launch shape at every bench conv on 132 SMs: all
    output columns in one block, about two blocks per SM or more (rounding
    the slots per block can leave a split a little short: main down L3's 8
    slots split in 4 give 256 blocks), at most MAX_SLOTS slots per block."""
    for m_out, K, cin, cout in BENCH_CONVS:
        t = toc.tiling(m_out, K, cin, cout, sms=132)
        assert t.strips == 1 and t.bn >= cout, (m_out, K, cin, cout)
        assert t.blocks >= 1.9 * 132 or t.slots == 1, (m_out, K, cin, cout)
        assert t.slots <= toc.MAX_SLOTS, (m_out, K, cin, cout)


@pytest.mark.parametrize("cin", [64, 16])  # 16 < MIN_CIN: the gather path
def test_gather_conv_plan_matches_jax(dtypes, cin):
    rng = np.random.RandomState(cin)
    km, feats, w, valid = conv_case(rng, 27, 3, cin, 16, 64)
    b = rng.randn(16).astype(np.float32)
    jp = joc.build_onehot_plan(jnp.asarray(km), 3, 256, tm=128, span=64)
    tp_ = toc.build_onehot_plan(torch.from_numpy(km), 3, 256, tm=128, span=64)
    assert int(tp_.overflow) > 0
    want = np.asarray(jso.gather_conv(*(jnp.asarray(a) for a in (feats, km, w, valid, b)),
                                      plan=jp))
    t = torch.from_numpy
    got = tso.gather_conv(t(feats), t(km), t(w), t(valid), t(b), plan=tp_).numpy()
    close(got, want)
    plain = tso.gather_conv(t(feats), t(km), t(w), t(valid), t(b)).numpy()
    if cin < toc.MIN_CIN:
        np.testing.assert_array_equal(got, plain)
    else:
        assert np.abs(got - plain).max() > 1e-2 * np.abs(plain).max()


def oracle_bb(batch, ok, feat32):
    """Perfect stage-1 output (tests/test_torch_pbnet.py) with the given
    per-point features."""
    sem = np.clip(batch["sem_label"], 0, 19)
    offs = np.where((batch["ins_label"] != -100)[:, None],
                    batch["inst_info"][:, 0:3] - batch["xyz"], 0.0).astype(np.float32)
    soft = (np.eye(20, dtype=np.float32)[sem] * 0.9 + 0.005).astype(np.float32)
    return {"point_feat_p": feat32, "sem_soft_p": soft, "offset_pred_p": offs,
            "sem_pred_score_p": soft * 10,
            "sem_pred_p": np.where(ok, sem, -1).astype(np.int32), "point_ok": ok}


@pytest.fixture(scope="module")
def variables():
    """JAX variables of the Mini_Unet trio (spans do not change them), BN
    statistics randomised, the mask head lifted so that a good share of
    scene points pass the 0.45 cut and the ScoreNet sees real proposals."""
    batch = graft._synthetic_batch(TINY, np.random.RandomState(0))
    jm = jpb.PBNet(shapes=TINY, **ARCHS)
    v = jax.jit(lambda k, b: jm.init(k, b, with_instances=True, with_labels=True,
                                     train=False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(a) for k, a in batch.items()})
    v = randomise_stats(v, 5)
    head = v["params"]["linear_binary"]["linear2"]["Dense_0"]
    head["bias"] = head["bias"] + np.float32(0.25)
    return v


# with 128-row tiles every map of both topologies gets a plan; (256, 256)
# drops nothing and is held through stage 1 (its compile is the file's
# largest cost, and the conv tests above hold overflow-free plans already);
# (128, 64) drops entries in both topologies and runs all three stages
@pytest.mark.parametrize("spans", [(256, 256), (128, 64)])
def test_banded_forward_matches_jax(dtypes, monkeypatch, variables, spans):
    monkeypatch.setattr(joc, "MIN_CIN", 32)
    monkeypatch.setattr(toc, "MIN_CIN", 32)
    shapes = dataclasses.replace(TINY, onehot_tm=128, onehot_spans=spans,
                                 onehot_spans_local=spans)
    tight = spans[1] == 64
    batch = graft._synthetic_batch(TINY, np.random.RandomState(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jpb.PBNet(shapes=shapes, **ARCHS)
    tm = tpb.PBNet(StaticShapes(**dataclasses.asdict(shapes)), device="cpu", **ARCHS)
    tm.load_state_dict(convert.state_dict_from_jax(variables), strict=True)
    tb = tpb.batch_to_device(batch, "cpu")

    jbb = jax.jit(lambda v, b: jm.apply(v, b, False, method=jpb.PBNet.backbone))(variables, jb)
    tbb = tm.backbone(tb)
    assert int(tbb["overflow_band"]) == int(jbb["overflow_band"])
    assert (int(tbb["overflow_band"]) > 0) == tight
    for k in ("point_feat_p", "offset_pred_p", "sem_pred_score_p"):
        np.testing.assert_allclose(tbb[k].numpy(), np.asarray(jbb[k]), err_msg=k, **TOL)
    if not tight:
        return

    ok = np.asarray(jbb["point_ok"])
    bb = oracle_bb(batch, ok, np.asarray(jbb["point_feat_p"]))
    jbb = dict(jbb, **{k: jnp.asarray(v) for k, v in bb.items()})
    ref = jax.jit(lambda v, b, s: jm.apply(v, b, s, True, False,
                                           method=jpb.PBNet.instance_stage))(variables, jb, jbb)
    got = tm.instance_stage(tb, {k: torch.from_numpy(np.array(v)) for k, v in bb.items()}, True)
    for f in ("cluster_id", "num_clusters"):
        np.testing.assert_array_equal(getattr(got["cluster"], f).numpy(),
                                      np.asarray(getattr(ref["cluster"], f)))
    assert int(got["num_proposals"]) == 2
    for k in ("scene_pid", "scene_src", "num_proposals"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ref["overflow"]:
        assert int(got["overflow"][k]) == int(ref["overflow"][k]), k
    assert int(got["overflow"]["conv_band"]) > 0
    ms = np.asarray(ref["mask_scores"])
    np.testing.assert_allclose(got["mask_scores"].numpy(), ms, **TOL)
    # kept flags agree wherever a mask score is not within 1e-5 of the cut
    clear = np.abs(ms - tpb.MASK_THRESH) >= 1e-5
    kept = np.asarray(ref["prop_point_kept"])
    assert kept.any()
    np.testing.assert_array_equal(got["prop_point_kept"].numpy()[clear], kept[clear])
    if clear.all():
        np.testing.assert_allclose(got["clt_scores"].numpy(), np.asarray(ref["clt_scores"]),
                                   **TOL)
