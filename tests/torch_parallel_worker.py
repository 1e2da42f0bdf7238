"""Rank processes of the port's multi-process tests (``test_torch_parallel``,
``test_torch_isolation``, ``test_torch_cuda``).

It imports torch and ``pbnet_torch`` only: the rank processes, started with
``pbnet_torch.parallel.distributed.spawn``, must hold no JAX.  ``launch``
runs ``JOBS[job](rank, world, payload)`` on every rank of a gloo group and
returns each rank's result (saved with ``torch.save`` under ``out_dir``).
"""

import os
import socket
import sys

import torch

from pbnet_torch.parallel import distributed

JOIN_TIMEOUT_S = 120  # every multi-process test's own limit


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank, world, port, job, payload, out_dir):
    torch.set_num_threads(1)
    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank, "gloo", timeout_s=60)
    try:
        result = JOBS[job](rank, world, payload)
    finally:
        distributed.shutdown()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def launch(job: str, payload, out_dir, world: int = 2) -> list:
    distributed.spawn(_rank_main, world, (world, free_port(), job, payload, str(out_dir)),
                      JOIN_TIMEOUT_S)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _f32(payload):
    from pbnet_torch.nn import sparse_ops

    if payload.get("f32"):
        sparse_ops.COMPUTE_DTYPE = torch.float32


def job_modules(rank, world, payload):
    """The top-level modules of JAX and the JAX package this rank holds."""
    import pbnet_torch.engine  # noqa: F401  (the rank-side import of a training run)

    return sorted({k.split(".")[0] for k in sys.modules}
                  & {"jax", "jaxlib", "flax", "optax", "pbnet_tpu"})


def job_syncbn(rank, world, payload):
    """One train-mode ``MaskedBatchNorm`` over the group: output, input
    gradient, averaged parameter gradients, running statistics."""
    from pbnet_torch.nn.modules import MaskedBatchNorm, set_bn_group
    from pbnet_torch.parallel.mesh import data_group, pmean_

    dev = payload.get("device", "cpu")
    c = payload["x"].shape[-1]
    bn = MaskedBatchNorm(c, device=dev)
    bn.load_state_dict({k: v.to(dev) for k, v in payload["state"].items()})
    set_bn_group(bn, data_group())
    bn.train()
    x = payload["x"][rank].to(dev).requires_grad_(True)
    y = bn(x, payload["valid"][rank].to(dev))
    (y * payload["ct"][rank].to(dev)).sum().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    pmean_(grads, data_group())
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(), "weight": grads[0].cpu(),
            "bias": grads[1].cpu(), "running_mean": bn.running_mean.cpu(),
            "running_var": bn.running_var.cpu()}


def job_train_step(rank, world, payload):
    """``train_step.make_train_step`` over the group: each rank its own
    batch.  Returns the state dict, aux and Adam's first moments."""
    from pbnet_torch import engine
    from pbnet_torch.models.pbnet import batch_to_device
    from pbnet_torch.parallel import train_step
    from pbnet_torch.parallel.mesh import data_group

    _f32(payload)
    dev = payload.get("device", "cpu")
    cfg = payload["cfg"]
    model = engine.build_model(cfg, dev, group=data_group())
    model.load_state_dict(payload["state"])
    opt = train_step.make_optimizer(model, cfg)
    step = train_step.make_train_step(model, opt, cfg, payload.get("with_instances", False),
                                      data_group())
    out = []
    for batch in payload["batches"][rank]:
        aux = step(batch_to_device(batch, dev), payload["lr"])
        out.append({k: float(v) for k, v in aux.items()})
    moments = {n: opt.state[p]["exp_avg"].cpu() for n, p in model.named_parameters()
               if "exp_avg" in opt.state.get(p, {})}
    return {"state": {k: v.cpu() for k, v in model.state_dict().items()}, "aux": out,
            "exp_avg": moments}


def job_evaluate(rank, world, payload):
    """``engine.evaluate`` over the group."""
    from pbnet_torch import engine
    from pbnet_torch.data.dataset import Dataset
    from pbnet_torch.parallel.mesh import data_group

    _f32(payload)
    cfg = payload["cfg"]
    model = engine.build_model(cfg, "cpu")
    model.load_state_dict(payload["state"])
    timing = {}
    res = engine.evaluate(cfg, model, Dataset(cfg), epoch=payload["epoch"], timing=timing,
                          group=data_group())
    return {"result": res, "timing": timing}


JOBS = {"modules": job_modules, "syncbn": job_syncbn, "train_step": job_train_step,
        "evaluate": job_evaluate}


class RecordingDataset:
    """``SyntheticDataset`` whose loader appends ``epoch scene`` for every
    batch it serves to ``record_dir/rank<r>.txt``: which rank trained on
    which scene at each step."""

    def __init__(self, shapes, n_scenes, record_dir):
        from pbnet_torch.synthetic import SyntheticDataset

        self.inner = SyntheticDataset(shapes, n_scenes=n_scenes)
        self.train_file_list = self.inner.train_file_list
        self.record_dir = str(record_dir)

    def train_epoch_ids(self, epoch, rank=0, world=1):
        return self.inner.train_epoch_ids(epoch, rank, world)

    def train_loader(self, epoch, rank=0, world=1, picks=None):
        import torch.distributed as dist

        r = dist.get_rank() if dist.is_initialized() else 0
        batches = self.train_epoch_ids(epoch, rank, world)
        for i in range(len(batches)) if picks is None else picks:
            with open(os.path.join(self.record_dir, f"rank{r}.txt"), "a") as f:
                f.write(f"{epoch} {int(batches[i][0])}\n")
            yield self.inner.train_batch(batches[i])
