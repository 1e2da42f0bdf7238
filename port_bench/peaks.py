"""Published peak rates of the cards the benchmark knows: NVIDIA's H100
SXM data sheet, dense rates without sparsity, at its 700 W limit.  The
conv operands are bf16, so ``mfu`` and the rooflines use the bf16 rate."""

from __future__ import annotations

PEAKS = {
    "H100 80GB HBM3": {"flops": 989e12, "bytes": 3.35e12, "watts": 700.0},
}


def of(device_name: str) -> dict | None:
    """The peaks of the card called ``device_name``, or None."""
    return next((p for k, p in PEAKS.items() if k in device_name), None)
