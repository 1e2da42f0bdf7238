"""The train and eval steps (port of pbnet_tpu/parallel/train_step.py).

A step is forward, loss, backward and the optimizer update.  Over a process
group (data parallelism, ``parallel/mesh.py``) it averages, as the JAX
package ``pmean``s over its data mesh: every gradient (those of parameters
the loss did not reach are zeros), the aux dict, and the BN running
statistics, each with one all-reduce of a flattened buffer.  SyncBatchNorm's
sum of the batch statistics happens inside ``MaskedBatchNorm``.  The
optimizers follow optax's semantics (``make_optimizer``), the learning rate
is an argument of each step (the per-epoch cosine schedule), and frozen
modules keep their parameters in the optimizer with zeroed gradients, as the
JAX package's.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import torch

from ..models import losses as L
from .mesh import pmean_

# reference module-freezing name map (PBNet network/PBNet.py:94-97)
FIX_MODULE_MAP = {
    "Unet_backbone": "MEUnet",
    "linear_sem": "linear_sem",
    "linear_off": "linear_offset",
    "D_Unet": "D_Unet",
}


def freeze_grads(grads: Mapping[str, torch.Tensor], fix_modules) -> dict:
    """Gradients by parameter name with those of the frozen top-level
    modules zeroed (the reference's requires_grad=False; the parameters
    stay in the optimizer, whose momentum and weight decay still act)."""
    frozen = {FIX_MODULE_MAP.get(m, m) for m in fix_modules}
    return {k: torch.zeros_like(g) if k.split(".")[0] in frozen else g
            for k, g in grads.items()}


def cosine_lr_after_step(base_lr, epoch, step_epoch, total_epochs, clip=1e-6):
    """Constant until step_epoch, then half-cosine decay to clip.  Epochs
    count from 1."""
    if epoch < step_epoch:
        return base_lr
    return clip + 0.5 * (base_lr - clip) * (
        1 + math.cos(math.pi * ((epoch - step_epoch) / (total_epochs - step_epoch)))
    )


class OptaxSGD(torch.optim.Optimizer):
    """optax ``chain(trace(decay=momentum), add_decayed_weights(wd))`` then
    ``p - lr * u``: the momentum trace holds the raw gradients and the weight
    decay is added after it.  ``torch.optim.SGD`` adds ``wd * p`` into its
    momentum buffer instead, which is another update."""

    def __init__(self, params, lr, momentum, weight_decay):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, mom, wd = group["lr"], group["momentum"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "trace" not in st:
                    st["trace"] = torch.zeros_like(p)
                t = st["trace"]
                t.copy_(p.grad + mom * t)
                u = t + wd * p
                p.add_(-lr * u)


def make_optimizer(model: torch.nn.Module, cfg) -> torch.optim.Optimizer:
    """The optimizer of ``cfg.optimizer`` over ``model.parameters()``, each
    equal to the JAX package's optax chain followed by ``-lr`` (up to f32
    rounding): Adam is ``scale_by_adam()`` (no weight decay), AdamW is
    ``scale_by_adam(b1=0.9, b2=0.99)`` then ``add_decayed_weights`` (torch's
    AdamW algebra), SGD is ``OptaxSGD``."""
    params = list(model.parameters())
    if cfg.optimizer == "Adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "AdamW":
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.99), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if cfg.optimizer == "SGD":
        return OptaxSGD(params, cfg.lr, cfg.momentum, cfg.weight_decay)
    raise ValueError(cfg.optimizer)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm), with
    PyTorch's multi-tensor norm (a few launches, not one per tensor)."""
    return torch.nn.utils.get_total_norm(list(tensors))


def apply_gradients(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    fix_modules, lr: float, group=None):
    """Average, freeze and update after ``backward``: parameters the loss
    did not reach get zero gradients (as JAX's gradient of an unused
    parameter), the gradients are averaged over ``group`` (when given),
    frozen modules' gradients are zeroed, the learning rate is set, and the
    optimizer steps.  The gradients stay in ``p.grad`` for inspection.
    Returns (grad_norm, param_norm): the global norms of the gradients after
    freezing and of the updated parameters, as 0-d tensors."""
    named = list(model.named_parameters())
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in named}
    if group is not None:
        pmean_(list(grads.values()), group)
    grads = freeze_grads(grads, fix_modules)
    for n, p in named:
        p.grad = grads[n]
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return global_norm(grads.values()), global_norm(p.detach() for _, p in named)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, cfg,
                    with_instances: bool, group=None):
    """A step ``(batch, lr) -> aux`` on the model's device: train-mode
    forward with labels, ``losses.model_fn``, backward, ``apply_gradients``.
    ``aux`` holds the loss, every loss term, the overflow counters,
    ``grad_norm`` and ``param_norm`` as 0-d tensors on the device (nothing
    is fetched to the host).  Over a process ``group`` the gradients, aux
    and BN running statistics are averaged over its ranks, so every rank
    ends the step with the same parameters, statistics and aux."""

    def step(batch: dict, lr: float) -> dict:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        ret = model(batch, with_instances=with_instances, with_labels=True)
        loss, aux = L.model_fn(ret, batch, cfg, with_instances)
        loss.backward()
        return finish_step(model, optimizer, cfg, aux, lr, group)

    return step


def finish_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, cfg, aux: dict,
                lr: float, group=None) -> dict:
    """The step after ``backward``: ``apply_gradients``, then the aux values
    (detached) and, over a process ``group``, the aux and the BN running
    statistics averaged over its ranks.  Returns the aux with
    ``grad_norm`` and ``param_norm``."""
    grad_norm, param_norm = apply_gradients(model, optimizer, cfg.fix_module, lr, group)
    keys = sorted(aux)
    vals = torch.stack([aux[k].detach() for k in keys])
    if group is not None:
        stats = [b for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))]
        pmean_([vals] + stats, group)
    aux = dict(zip(keys, vals.unbind()))
    aux.update(grad_norm=grad_norm, param_norm=param_norm)
    return aux


# the model outputs the host evaluation of a scene reads
EVAL_KEYS = ("sem_pred_p", "overflow_vox", "overflow_grid", "overflow_band", "overflow",
             "mask_scores", "gt_mask", "scene_valid", "prop_point_kept", "prop_point_src",
             "prop_point_pid", "num_final_proposals", "clt_scores", "prop_sem")


def host_outputs(ret: dict) -> dict:
    """The outputs in ``EVAL_KEYS`` copied to numpy on the calling thread
    (the copy waits for the device), so that worker threads read finished
    host arrays only."""
    def host(v):
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v.detach().cpu().numpy()

    return {k: host(ret[k]) for k in EVAL_KEYS if k in ret}


def make_eval_step(model: torch.nn.Module, with_instances: bool, with_labels: bool = False):
    """An eval forward on this rank's device: ``batch -> the outputs the
    host evaluation reads, on the host``.  The JAX package runs one scene
    per mesh device and stacks the outputs; here each rank forwards its own
    scenes and ``engine.evaluate`` gathers their host results."""

    def step(batch: dict) -> dict:
        model.eval()
        return host_outputs(model(batch, with_instances=with_instances, with_labels=with_labels))

    return step
