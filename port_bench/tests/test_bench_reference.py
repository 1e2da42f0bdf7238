"""The plain reference agrees with the port on tiny rooms on the CPU, and
its control (conv operands in float8) departs from it by far more."""

from __future__ import annotations

import torch

from port_bench import check, eval_cell, weights
from port_bench.tests import tiny

CPU = torch.device("cpu")


def test_reference_agrees_with_the_port_and_the_control_departs():
    cell = tiny.eval_cell()
    cell.traffic.update(points=[1500, 2000], objects=[1, 1])
    pool = cell.make_pool(cell.traffic, 2**34 + 3)
    wts = weights.make(cell.config, 2**34 + 3, CPU)
    prog = eval_cell.Program(cell, pool, wts, CPU)
    got = {i: prog(i)[0] for i in range(len(pool))}
    rooms = list(got)
    ref, _ = eval_cell.reference_outputs(cell, pool, wts, CPU, rooms)
    same, _ = eval_cell.reference_outputs(cell, pool, wts, CPU, rooms, operands="bfloat16")
    ctl, _ = eval_cell.reference_outputs(cell, pool, wts, CPU, rooms, operands="float8")
    prog_num = check.worst({i: check.compare(got[i], ref[i]) for i in rooms})
    same_num = check.worst({i: check.compare(got[i], same[i]) for i in rooms})
    ctl_num = check.worst({i: check.compare(ctl[i], ref[i]) for i in rooms})
    # the port's integer outputs equal the reference's
    for n in (prog_num, same_num, ctl_num):
        assert n["point_map_diff"] == 0 and n["cluster_diff"] == 0
    assert check.verdict(prog_num, cell.limits), prog_num
    # at the port's own operand precision only the summation order differs
    assert same_num["logit_gap"] < 0.2 * prog_num["logit_gap"], (same_num, prog_num)
    # the control's gaps are several times the port's
    for k in ("logit_gap", "offset_gap", "mask_gap"):
        assert ctl_num[k] > 3 * prog_num[k], (k, ctl_num, prog_num)
