"""The port's MinkowskiEngine checkpoint converter
(``pbnet_torch/tools/convert_checkpoint.py``) against the JAX package's, on
the hand-written ME fragments of ``tests/test_convert_me_fixture.py``.

* For both offset orders, on the fragment and on the complete
  34C/14A/34C + five-head checkpoint: the port's ``convert_state_dict``
  trees equal JAX's ``convert_state_dict`` exactly, and ``to_state_dict``
  equals JAX's trees carried through ``convert.state_dict_from_jax``,
  exactly.  The complete checkpoint loads into the port's PBNet with
  ``strict=True`` and overwrites every parameter and BN statistic.
* A ``.pth`` written with ``torch.save`` loads through
  ``load_reference_checkpoint``; ``merge_into_model`` reports the fragment
  fully matched.
* ``write_reference_pth`` inverts the reader: the complete checkpoint,
  converted, written back in the reference's format and read again, gives
  the same tensors, for both offset orders; a name with no place in the
  format raises.
* An ME checkpoint of the Mini_Unet trio, converted by each package and
  loaded into each package's PBNet: stage-1 outputs within 1e-4 of their
  largest magnitude (f32 conv operands; the hand-made weights are larger
  than trained ones, features reach 25).
* A kernel that is non-zero only at ME offset (1, 0, 0) makes output voxel
  o read input voxel o + (1, 0, 0) through the port's conv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu.models.pbnet import PBNet as JPBNet
from pbnet_tpu.nn import sparse_ops as jso
from pbnet_tpu.tools import convert_checkpoint as jcc
from pbnet_torch import convert
from pbnet_torch.core import topology as ttp
from pbnet_torch.models.pbnet import PBNet, batch_to_device, make_level0
from pbnet_torch.nn import sparse_ops as tso
from pbnet_torch.synthetic import GRAFT_SHAPES
from pbnet_torch.tools import convert_checkpoint as tcc
from tests.test_convert_me_fixture import (make_me_fragment, make_me_full_state_dict,
                                           me_x_fastest_offsets)
from tests.test_pbnet import TINY

ORDERS = ("x_fastest", "z_fastest")
MINI = dict(backbone_arch="Mini_Unet", dunet_arch="Mini_Unet", score_arch="Mini_Unet")


def assert_trees_equal(a, b, path=()):
    assert a.keys() == b.keys(), path
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], path + (k,))
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), path + (k,)


def assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("which", ["fragment", "full"])
def test_converter_equals_jax(which, order):
    make = make_me_fragment if which == "fragment" else make_me_full_state_dict
    sd = make(np.random.RandomState(0))
    jp, js = jcc.convert_state_dict(sd, me_order=order)
    tp_, ts = tcc.convert_state_dict(sd, me_order=order)
    assert_trees_equal(tp_, jp)
    assert_trees_equal(ts, js)
    got = tcc.to_state_dict(sd, me_order=order)
    assert_state_dicts_equal(got, convert.state_dict_from_jax({"params": jp, "batch_stats": js}))
    np.testing.assert_array_equal(tcc.me_offset_permutation(3, order),
                                  jcc.me_offset_permutation(3, order))
    if which == "full":
        model = PBNet(GRAFT_SHAPES, device="cpu")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(got, strict=True)
        same = [k for k, v in model.state_dict().items() if torch.equal(v, before[k])]
        assert same == []


def test_pth_loads_through_load_reference_checkpoint(tmp_path):
    sd = make_me_fragment(np.random.RandomState(1))
    path = tmp_path / "000000128.pth"
    torch.save({"model": {"module." + k: torch.as_tensor(v) for k, v in sd.items()},
                "optimizer": {}}, path)
    got = tcc.load_reference_checkpoint(str(path))
    assert_state_dicts_equal(got, tcc.to_state_dict(sd))
    model = PBNet(GRAFT_SHAPES, device="cpu")
    assert tcc.merge_into_model(model, got) == []
    want = sd["MEUnet.conv0p1s1.kernel"][tcc.me_offset_permutation(5)]
    assert torch.equal(model.MEUnet.conv0.kernel, torch.from_numpy(want))


@pytest.mark.parametrize("order", ORDERS)
def test_reference_writer_inverts_the_reader(order, tmp_path):
    got = tcc.to_state_dict(make_me_full_state_dict(np.random.RandomState(2)), me_order=order)
    path = tmp_path / "000000002.pth"
    tcc.write_reference_pth(got, str(path), me_order=order)
    assert_state_dicts_equal(tcc.load_reference_checkpoint(str(path), me_order=order), got)
    with pytest.raises(KeyError):
        tcc.to_reference_state_dict({"MEUnet.conv0.scale": torch.zeros(1)})


def me_mini_trio(rng):
    """An ME-format checkpoint of PBNet with the Mini_Unet trio, written from
    the reference's names (conv0p1s1, conv1p1s2, convtr2p1s2, bntr1,
    final_score, ME BasicBlocks, the MLP heads)."""
    def t(*shape):
        return (rng.randn(*shape) * 0.2).astype(np.float32)

    sd = {}

    def bn(prefix, c):
        sd[f"{prefix}.bn.weight"] = 1 + t(c)
        sd[f"{prefix}.bn.bias"] = t(c)
        sd[f"{prefix}.bn.running_mean"] = t(c)
        sd[f"{prefix}.bn.running_var"] = np.abs(t(c)) + 0.5
        sd[f"{prefix}.bn.num_batches_tracked"] = np.int64(7)

    def block(prefix, cin, planes):
        sd[f"{prefix}.conv1.kernel"] = t(27, cin, planes)
        bn(f"{prefix}.norm1", planes)
        sd[f"{prefix}.conv2.kernel"] = t(27, planes, planes)
        bn(f"{prefix}.norm2", planes)
        if cin != planes:
            sd[f"{prefix}.downsample.0.kernel"] = t(cin, planes)
            bn(f"{prefix}.downsample.1", planes)

    for top, cin in (("MEUnet", 6), ("D_Unet", 34), ("score_Unet", 32)):
        sd[f"{top}.conv0p1s1.kernel"] = t(125, cin, 32)
        bn(f"{top}.bn0", 32)
        sd[f"{top}.conv1p1s2.kernel"] = t(8, 32, 32)
        bn(f"{top}.bn1", 32)
        block(f"{top}.block1.0", 32, 32)
        block(f"{top}.block1.1", 32, 32)
        sd[f"{top}.convtr2p1s2.kernel"] = t(8, 32, 64)
        bn(f"{top}.bntr1", 64)
        block(f"{top}.block2.0", 96, 64)
        block(f"{top}.block2.1", 64, 64)
        sd[f"{top}.final_score.kernel"] = t(64, 32)
        sd[f"{top}.final_score.bias"] = t(32)
    for name, cin, hidden, out in (("linear_sem", 32, 16, 20), ("linear_offset", 32, 16, 3),
                                   ("linear_binary", 32, 16, 1), ("linear_IOU_feat", 32, 32, 32),
                                   ("linear_IOU", 32, 16, 1)):
        sd[f"{name}.0.linear.weight"] = t(hidden, cin)
        bn(f"{name}.1", hidden)
        sd[f"{name}.2.weight"] = np.float32([0.25])
        sd[f"{name}.3.linear.weight"] = t(out, hidden)
        sd[f"{name}.3.linear.bias"] = t(out)
    return sd


def test_converted_forward_matches_jax(monkeypatch, fast_compile):
    monkeypatch.setattr(jso, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tso, "COMPUTE_DTYPE", torch.float32)
    import __graft_entry__ as graft

    sd = me_mini_trio(np.random.RandomState(2))
    batch = graft._synthetic_batch(TINY, np.random.RandomState(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JPBNet(shapes=TINY, **MINI)
    variables = jax.jit(lambda k, b: jm.init(k, b, with_instances=True, with_labels=True,
                                             train=False))(jax.random.PRNGKey(0), jb)
    merged, unmatched = jcc.merge_into_variables(variables, *jcc.convert_state_dict(sd))
    assert unmatched == []
    want = jax.jit(lambda v, b: jm.apply(v, b, False, method=JPBNet.backbone))(merged, jb)
    tm = PBNet(TINY, device="cpu", **MINI)
    tm.load_state_dict(tcc.to_state_dict(sd), strict=True)
    got = tm.backbone(batch_to_device(batch, "cpu"))
    for k in ("point_feat_p", "sem_pred_score_p", "offset_pred_p"):
        w = np.asarray(want[k])
        assert np.abs(w).max() > 0.1, k
        assert np.abs(got[k].numpy() - w).max() <= 1e-4 * np.abs(w).max(), k


def test_directional_offset_semantics():
    coords = np.zeros((8, 4), np.int32)
    coords[:4, 1] = np.arange(4)
    valid = np.arange(8) < 4
    level, _ = make_level0(torch.from_numpy(coords), torch.zeros(8, 1), torch.from_numpy(valid))
    kmap = ttp.conv_map(level, level, 3)
    me_kernel = np.zeros((27, 1, 1), np.float32)
    me_kernel[me_x_fastest_offsets(3).index((1, 0, 0))] = 1.0
    ours = torch.from_numpy(tcc._conv_kernel(me_kernel, "x_fastest"))
    feats = torch.from_numpy(np.where(valid, np.arange(8) + 1.0, 0.0)[:, None].astype(np.float32))
    y = tso.gather_conv(feats, kmap, ours, level.valid)
    np.testing.assert_allclose(y[:4, 0].numpy(), [2.0, 3.0, 4.0, 0.0], atol=1e-5)
