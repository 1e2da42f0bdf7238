"""The port's benchmark: one run of one cell on the card(s) it runs on.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout.  The cells, their configurations,
traffic, limits and metrics are in ``BENCHMARK.json`` and the files under
``port_bench/``.  The last line of standard output is the result (JSON);
the numbers the check compared, each beside its limit, end standard error.
Exits with a code other than 0, and prints no result, without enough CUDA
devices, or if the process holds a module of JAX or of the JAX package once
the run is done.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pbnet_tpu")


def caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = CHECKOUT / "port_bench" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    caches()
    import torch

    from . import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {n} available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cell.chips > 1:
        from . import ranks

        line = ranks.launch(args.workload, args.seed, args.seconds, bool(args.trace),
                            cell.chips)
    else:
        line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    if cell.chips > 1:  # the ranks' logs came first: the numbers end stderr
        for k, v in line["check"].items():
            print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
