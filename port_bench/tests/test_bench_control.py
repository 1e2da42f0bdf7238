"""On the card, at each cell's own size: the program passes the check and
its control (the reference with float8 conv operands in its place) fails
it, on three seeds.  Skips without a card."""

from __future__ import annotations

import pytest
import torch

from port_bench import calibrate, check, spec

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(card, name):
    cell = spec.cell(name)
    if cell.chips > torch.cuda.device_count():
        pytest.skip(f"{name} needs {cell.chips} devices")
    fn = calibrate.train_readings if cell.traffic["kind"] == "train" else calibrate.readings
    for seed in (2**35 + 1, 2**35 + 2, 2**35 + 3):
        r = fn(cell, seed, card, "float8")
        assert check.verdict(r["program"], cell.limits), r
        assert not check.verdict(r["control"], cell.limits), r
