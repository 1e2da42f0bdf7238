"""PBNet in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of ``pbnet_tpu`` (JAX/XLA/Pallas), laid out the same way so each
module has an obvious counterpart:

  core/     coordinate keys, quantization, coordinate pyramids + kernel maps
  nn/       sparse conv (kernel-map gather + GEMM; on the card one fused
            kernel, csrc/gather_gemm.cu), masked norms, MinkUNets (basic and
            bottleneck blocks), the ResNet/ResFieldNet classifiers
  ops/      clustering; its four banded-window passes are CUDA kernels
            (ops/window_kernels.py, csrc/window_kernels.cu)
  models/   the three-stage PBNet forward and its losses
  parallel/ the train and eval steps, the optimizers, data parallelism over
            torch.distributed (ranks, SyncBN, gradient averaging)
  engine    training and evaluation: checkpoints, scalars, auto-resume, ranks
  data/     ScanNet decode, batches and loaders
  tools/    logging and checkpoints, metrics and the AP evaluator, the
            MinkowskiEngine checkpoint converter, the point-cloud plotter
  convert   JAX-package variables (and optax state) -> this package's
  synthetic seeded synthetic scenes for tests and the chip smoke run

The port imports neither JAX nor ``pbnet_tpu``.  Entry points run on CUDA
unless the caller passes ``device="cpu"``; with no GPU and no explicit CPU
request they raise.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise.  Raises when CUDA is asked for (explicitly or by default) and
    no GPU is present — nothing silently carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pbnet_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
