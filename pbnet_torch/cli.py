"""Command-line entry points of the port:

    python -m pbnet_torch.cli train   [--flags]   # train.py
    python -m pbnet_torch.cli eval    [--flags]   # eval_map.py
    python -m pbnet_torch.cli predict [--flags]   # engine.predict_testset

The flags are the JAX package's (``config.get_parser``: one per ``Config``
field; ``eval`` and ``predict`` start from ``test_config()``), plus
``--device``: the commands run on CUDA unless ``--device cpu`` is passed,
and raise without a GPU otherwise.  ``eval`` prints the result dict and the
timing dict, as eval_map.py does; ``predict`` prints the directory of the
submission files.  ``train`` is data-parallel with ``--num_devices N`` (0:
every visible GPU; one process per rank, SyncBN with ``--sync_bn``), and
across hosts with ``--nodes``, ``--node_rank``, ``--coordinator host:port``
(or ``--tcp_port`` on 127.0.0.1), each host running the command once.
"""

from __future__ import annotations

import random
import sys

import numpy as np

from . import engine
from .config import get_parser

COMMANDS = ("train", "eval", "predict")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m pbnet_torch.cli {{{','.join(COMMANDS)}}} [--flags] "
              "(--help after a command lists its flags)", file=sys.stderr)
        return 2
    cmd = argv[0]
    cfg, device = get_parser(test=cmd != "train", argv=argv[1:])
    random.seed(cfg.manual_seed)
    np.random.seed(cfg.manual_seed)
    if cmd == "train":
        engine.train(cfg, device=device)
    elif cmd == "eval":
        timing = {}
        print(engine.evaluate_pretrained(cfg, timing=timing, device=device))
        print(timing)
    else:
        print(engine.predict_testset(cfg, device=device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
