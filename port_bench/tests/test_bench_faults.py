"""A run with the timed path broken underneath comes out not correct, and
a sound run comes out correct (tiny cells on the CPU, the cells' own
limits; the look for a card is skipped)."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench.tests import faults, tiny

CPU = torch.device("cpu")
SEED = 2**36 + 11


@pytest.mark.parametrize("fault", [None, faults.HalfBatchLeftOut(), faults.ClusterIdAltered(),
                                   faults.LogitsAltered()],
                         ids=["sound", "half_batch_left_out", "cluster_id_altered",
                              "logits_altered"])
def test_eval_run_with_a_fault_is_not_correct(fault):
    line = harness.run_cell(tiny.eval_cell(), SEED, 0.2, False, CPU, fault=fault)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["correct"] is (fault is None), line["check"]


@pytest.mark.parametrize("fault", [None, faults.StateUnchanged(), faults.HalfBatchLeftOut()],
                         ids=["sound", "state_unchanged", "half_batch_left_out"])
def test_train_run_with_a_fault_is_not_correct(fault):
    line = harness.run_cell(tiny.train_cell(), SEED, 0.2, False, CPU, fault=fault)
    assert line["attempted"] >= 1
    assert line["correct"] is (fault is None), line["check"]


@pytest.mark.parametrize("fault", [None, faults.ExchangeLeftOut()],
                         ids=["sound", "exchange_left_out"])
def test_data_parallel_run_with_the_exchange_left_out_is_not_correct(fault, tmp_path):
    """A training cell added as files for two ranks, run by two gloo ranks
    on the CPU through the launcher a multi-card cell uses: rank 0 gives
    the line, every rank is joined."""
    import json
    import shutil

    from port_bench import ranks, spec

    base = tmp_path / "bench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    cell = tiny.train_cell()
    (base / "traffic" / "train-tiny2.json").write_text(json.dumps(dict(cell.traffic, ranks=2)))
    (base / "limits" / "pbnet34c.train-tiny2.json").write_text(json.dumps(cell.limits))
    bench = json.loads(json.dumps(tiny.BENCH))
    bench["workloads"].append({"name": "pbnet34c.train-tiny2", "config": "pbnet-34c",
                               "traffic": "train-tiny2", "chips": 2, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "pbnet34c.train" in m.get("workloads", []):
            m["workloads"].append("pbnet34c.train-tiny2")
    line = ranks.launch("pbnet34c.train-tiny2", SEED, 0.2, False, 2, "cpu", bench, base, fault,
                        limit_s=3000)
    assert line["device"]["count"] == 2 and list(line)[-1] == "check"
    assert "train_step_ms" in line["metrics"]
    assert line["correct"] is (fault is None), line["check"]
