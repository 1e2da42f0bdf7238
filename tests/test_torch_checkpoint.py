"""Checkpoint files across the packages: the port restores what the JAX
package's ``checkpoint_save`` writes, with ``pickle`` and numpy only.

* A real Mini_Unet ``TrainState`` (TINY caps) with Adam, AdamW or SGD state
  after one optax update, saved by ``pbnet_tpu.tools.log.checkpoint_save``:
  the port's ``checkpoint_restore`` gives exactly the model state dict of
  ``convert.state_dict_from_jax`` and the optimizer state of
  ``convert.optimizer_state_from_optax`` on the same trees, and both load.
* ``flax_checkpoint.msgpack_restore`` returns the tree
  ``flax.serialization.msgpack_restore`` returns, on every tree of that file
  and on a tree of every leaf type flax writes; Python complex numbers
  (ext type 2), dtypes numpy does not know, chunked leaves and truncated
  input are refused.
* A model-only file, the port's or the JAX package's, resumes with the
  freshly built optimizer.
* A pickle that holds anything but a dict of str to bytes is refused, and
  nothing in it runs.
"""

import os
import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pbnet_tpu import config as jconfig
from pbnet_tpu.models.pbnet import PBNet as JPBNet
from pbnet_tpu.parallel import train_step as jts
from pbnet_tpu.tools import log as jlog
from pbnet_torch import convert, engine, synthetic
from pbnet_torch.config import Config
from pbnet_torch.models.pbnet import PBNet as TPBNet
from pbnet_torch.parallel import train_step as tts
from pbnet_torch.tools import flax_checkpoint
from pbnet_torch.tools import log as tlog
from tests.test_pbnet import TINY
from tests.test_torch_train import ARCHS, SHAPES, opt_cfg

OPTIMIZERS = ("Adam", "AdamW", "SGD")


@pytest.fixture(scope="module")
def variables(fast_compile_module):
    batch = graft._synthetic_batch(SHAPES, np.random.RandomState(0), n_copies=2)
    jm = JPBNet(shapes=SHAPES, **ARCHS)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = jax.jit(lambda k, b: jm.init(k, b, with_instances=True, with_labels=True,
                                     train=False))(jax.random.PRNGKey(0), jb)
    return jax.tree_util.tree_map(np.asarray, v)


def optax_state(name, params):
    """The optimizer's state after one update with seeded gradients."""
    tx = jts.make_optimizer(jconfig.Config(optimizer=name, lr=1e-3, momentum=0.9,
                                           weight_decay=1e-2))
    rng = np.random.RandomState(1)
    grads = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(p.dtype), params)
    _, state = tx.update(grads, tx.init(params), params)
    return state


def same(got, want, path="state"):
    """Recursive exact equality of state dicts (tensors with dtype)."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype, path
        assert torch.equal(got, want), path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def same_tree(got, want, path="tree"):
    """Recursive exact equality of restored msgpack trees (arrays with dtype
    and shape; scalars with their type)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same_tree(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_jax_checkpoint_restores_in_the_port(variables, name, tmp_path):
    opt_state = optax_state(name, variables["params"])
    jlog.checkpoint_save({"params": variables["params"], "batch_stats": variables["batch_stats"],
                          "opt_state": opt_state}, str(tmp_path), 5)
    tm = TPBNet(SHAPES, device="cpu", **ARCHS)
    opt = tts.make_optimizer(tm, opt_cfg(name))
    state, start, fname = tlog.checkpoint_restore({"model": tm, "optimizer": opt}, str(tmp_path))
    assert start == 6 and fname.endswith("000000005.ckpt")
    same(state["model"], convert.state_dict_from_jax(variables))
    same(state["optimizer"], convert.optimizer_state_from_optax(
        jax.tree_util.tree_map(np.asarray, opt_state), tm, opt))
    tm.load_state_dict(state["model"], strict=True)
    opt.load_state_dict(state["optimizer"])
    # the trees of the file, read by the port's msgpack reader and by flax's
    with open(fname, "rb") as f:
        payload = pickle.load(f)
    assert sorted(payload) == ["batch_stats", "opt_state", "params"]
    for k, data in payload.items():
        same_tree(flax_checkpoint.msgpack_restore(data), flax.serialization.msgpack_restore(data),
                  k)


def test_msgpack_reader_matches_flax_on_every_leaf_type():
    tree = {
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3), "i64": np.array(7, np.int64),
        "u8": np.arange(4, dtype=np.uint8), "bool": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float32), "f64": np.linspace(0, 1, 5),
        "i16": np.array([-3, 4], np.int16), "scalar32": np.float32(1.5),
        "scalar_i": np.int32(-9), "nested": {"none": None, "t": True, "f": False,
                                             "text": "x" * 40, "raw": b"\x00\x01" * 150,
                                             "ints": [0, 127, 128, -1, -33, 2**16, -2**31,
                                                      2**40, -2**40, 2**64 - 1],
                                             "floats": [0.5, -3.25, 1e300]},
        "wide": {f"k{i}": i for i in range(20)}, "long": list(range(20)),
        "big": np.zeros(70000, np.uint8),
    }
    data = flax.serialization.msgpack_serialize(tree)
    same_tree(flax_checkpoint.msgpack_restore(data), flax.serialization.msgpack_restore(data))
    with pytest.raises(ValueError, match="ext type 2"):  # a Python complex
        flax_checkpoint.msgpack_restore(flax.serialization.msgpack_serialize({"a": 1 + 2j}))
    unknown = msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb([[1], "no_such", b"\0"]))})
    with pytest.raises(ValueError, match="dtype 'no_such'"):
        flax_checkpoint.msgpack_restore(unknown)
    chunked = msgpack.packb({"a": {"__msgpack_chunked_array__": True, "shape": [1]}})
    with pytest.raises(ValueError, match="chunked"):
        flax_checkpoint.msgpack_restore(chunked)
    with pytest.raises(ValueError, match="truncated"):
        flax_checkpoint.msgpack_restore(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        flax_checkpoint.msgpack_restore(data + b"\xc0")


def test_model_only_files_resume_with_a_fresh_optimizer(variables, tmp_path):
    # the JAX package's: params and batch_stats only
    jlog.checkpoint_save({"params": variables["params"],
                          "batch_stats": variables["batch_stats"]}, str(tmp_path / "j"), 3)
    tm = TPBNet(SHAPES, device="cpu", **ARCHS)
    opt = tts.make_optimizer(tm, opt_cfg("Adam"))
    state, start, _ = tlog.checkpoint_restore({"model": tm, "optimizer": opt},
                                              str(tmp_path / "j"))
    assert start == 4 and set(state) == {"model"}
    same(state["model"], convert.state_dict_from_jax(variables))

    # the port's, through engine.train: the saved weights are loaded (the
    # frozen score_Unet keeps them through the step), the optimizer is new
    cfg = Config(shapes=TINY, epochs=3, step_epoch=2, cluster_epoch=1, validation=False,
                 logpath=str(tmp_path / "t"), optimizer="Adam", fix_module=("score_Unet",),
                 **ARCHS)
    saved = TPBNet(TINY, device="cpu", seed=5, **ARCHS)
    tlog.checkpoint_save({"model": saved.state_dict()}, cfg.logpath, 1)
    model, opt = engine.train(cfg, synthetic.SyntheticDataset(TINY, n_scenes=1), max_epochs=2,
                              max_iters=1, device="cpu")
    assert os.path.isfile(os.path.join(cfg.logpath, "000000002.ckpt"))
    for n, p in model.score_Unet.named_parameters():
        assert torch.equal(p, saved.score_Unet.get_parameter(n)), n
    steps = {float(s["step"]) for s in opt.state_dict()["state"].values()}
    assert steps == {1.0}


class _RunsACommand:
    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (os.system, (f"touch {self.path}",))


@pytest.mark.parametrize("payload", ["numpy", "command", "list", "int value"])
def test_foreign_pickles_are_refused(payload, tmp_path):
    marker = tmp_path / "ran"
    obj = {"numpy": {"params": np.ones(3)}, "command": {"params": _RunsACommand(marker)},
           "list": [b"\x80"], "int value": {"params": 1}}[payload]
    path = tmp_path / "000000001.ckpt"
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    tm = TPBNet(TINY, device="cpu", **ARCHS)
    with pytest.raises(pickle.UnpicklingError):
        tlog.checkpoint_restore({"model": tm}, str(tmp_path))
    assert not marker.exists()
