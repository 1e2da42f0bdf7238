"""The port stands alone: no JAX, no pbnet_tpu, no silent CPU fallback.

* Importing pbnet_torch (every module: the eval, training, data-parallel,
  classifier, checkpoint-converter, checkpoint-parity, plotting and
  checkpoint ones, the command line, the measurement entry points with
  their work count, the overfit and trained-clustering tools and the
  spans and counters included), building and running a
  model with banded convs (its work counted), running one CPU train step, segmenting a mesh and
  reading a JAX-package checkpoint leaves ``jax``, ``flax``, ``optax``,
  ``msgpack`` and ``pbnet_tpu`` out of ``sys.modules`` (checked in a fresh
  subprocess, since this test process imports JAX for the parity tests).
  The segmentator library it loads is the port's own build, under
  ``pbnet_torch/_build/``.
* A rank process spawned for data parallelism holds none of them.
* No file of the port, nor chip_smoke.py, imports them.
* An entry point called without ``device`` on a machine without CUDA raises.
* chip_smoke.py fails, printing no result, without a GPU and outside a
  checkout of the repository.
"""

import os
import pickle
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pbnet_torch
from pbnet_torch.models.pbnet import PBNet
from pbnet_torch.synthetic import GRAFT_SHAPES

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|msgpack|pbnet_tpu)\b", re.M)


def _env(**kw):
    env = dict(os.environ, **kw)
    env.pop("PYTHONPATH", None)
    return env


def test_import_and_run_leave_jax_out(tmp_path):
    import flax.serialization

    ckpt = tmp_path / "000000003.ckpt"
    with open(ckpt, "wb") as f:
        pickle.dump({"params": flax.serialization.to_bytes({"w": np.arange(4.0)})}, f)
    code = (
        "import sys, numpy as np\n"
        "import pbnet_torch\n"
        "from pbnet_torch import cli\n"
        "from pbnet_torch.data import augment, dataset, decode_scannet, ply\n"
        "from pbnet_torch.native import segmentator\n"
        "from pbnet_torch.ops import normals\n"
        "from pbnet_torch.tools import flax_checkpoint\n"
        "from pbnet_torch import convert, synthetic\n"
        "from pbnet_torch.models.pbnet import PBNet, batch_to_device\n"
        "from pbnet_torch import eval_pipeline\n"
        "from pbnet_torch.nn import onehot_conv\n"
        "from pbnet_torch.ops import cluster, nms, window_kernels\n"
        "from pbnet_torch.tools import eval_protocol, log, metrics\n"
        "from pbnet_torch import engine\n"
        "from pbnet_torch.config import Config\n"
        "from pbnet_torch.models import losses\n"
        "from pbnet_torch.ops import iou\n"
        "from pbnet_torch.parallel import distributed, mesh, train_step\n"
        "from pbnet_torch.nn import resnet\n"
        "from pbnet_torch.tools import convert_checkpoint, parity_eval, plot, work\n"
        "from pbnet_torch import bench, eval_throughput\n"
        "from pbnet_torch.tools import overfit, trained_cluster\n"
        "from pbnet_torch import telemetry\n"
        "import dataclasses\n"
        "sh = dataclasses.replace(synthetic.GRAFT_SHAPES, onehot_tm=128, onehot_spans=(256, 128),\n"
        "                         onehot_spans_local=(256, 128))\n"
        "m = PBNet(sh, device='cpu', backbone_arch='Mini_Unet', dunet_arch='Mini_Unet',\n"
        "          score_arch='Mini_Unet')\n"
        "with work.WorkCount() as wc:\n"
        "    out = m(batch_to_device(synthetic.synthetic_batch(sh, np.random.RandomState(0)), 'cpu'))\n"
        "assert wc.useful() > 0\n"
        "gt, sp = synthetic.bench_eval_inputs()\n"
        "cfg = Config()\n"
        "opt = train_step.make_optimizer(m, cfg)\n"
        "b = batch_to_device(synthetic.synthetic_batch(sh, np.random.RandomState(1)), 'cpu')\n"
        "aux = train_step.make_train_step(m, opt, cfg, with_instances=True)(b, 1e-3)\n"
        "assert np.isfinite(float(aux['loss'])) and float(aux['grad_norm']) > 0\n"
        "xyz = np.random.RandomState(0).rand(30, 3).astype(np.float32)\n"
        "faces = np.stack([np.arange(28), np.arange(1, 29), np.arange(2, 30)], 1)\n"
        "assert segmentator.segment_mesh(xyz, faces).shape == (30,)\n"
        "tree = flax_checkpoint.read_checkpoint(sys.argv[1])\n"
        "assert (tree['params']['w'] == np.arange(4.0)).all()\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'flax', 'optax', 'msgpack', 'pbnet_tpu'))\n"
        "assert not bad, bad\n"
        "print('library', segmentator.loaded_library())\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code, str(ckpt)], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout
    lib = Path(r.stdout.split("library ", 1)[1].split()[0])
    assert lib.parent == REPO / "pbnet_torch" / "_build" and lib.name.startswith("segmentator-")


def test_spawned_rank_holds_no_jax(tmp_path):
    """A gloo rank process started by ``distributed.spawn`` (as
    ``engine.train`` starts its ranks) from this process, which holds JAX,
    imports none of it."""
    from tests import torch_parallel_worker as worker

    assert "jax" in sys.modules
    assert worker.launch("modules", {}, tmp_path) == [[], []]


def test_no_jax_imports_in_port_sources():
    files = sorted((REPO / "pbnet_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files if FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders


def test_entry_point_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PBNet(GRAFT_SHAPES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbnet_torch.resolve_device("cuda")
    assert pbnet_torch.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, where):
    if where == "repo":
        cwd = REPO
    else:  # a directory holding chip_smoke.py and nothing else of the repo
        cwd = tmp_path
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                       env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
