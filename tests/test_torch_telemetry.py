"""The port's spans and counters (``pbnet_torch.telemetry``) and the
benchmark's readers of them.

* Spans nest by thread with the right parents; self time is the duration
  less the children's; a worker thread's spans keep their own parents.
* With the profiler off nothing is recorded and ``record_function`` is
  never entered; the kernel launch tallies count on or off.
* Under ``torch.profiler`` the span names are profiler events.
* ``binary_cluster`` reads the host once per propagation round and once
  before the exact pass; ``host_outputs`` once per tensor it copies; a
  gather conv executes ``2 * M * K * Cin * Cout`` operations.
* A tiny PBNet forward gives the same bits with tracing on and off.
* Each of the benchmark's readers of the spans returns None without a
  traced pass or without the module, and its value on a planted collection.
"""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pbnet_torch import _build, synthetic, telemetry
from pbnet_torch.models.pbnet import COUNT_MEAN, PBNet, batch_to_device
from pbnet_torch.nn import sparse_ops
from pbnet_torch.ops import cluster
from pbnet_torch.parallel import train_step
from port_bench import spec

ARCHS = dict(backbone_arch="Mini_Unet", dunet_arch="Mini_Unet", score_arch="Mini_Unet")


def traced(fn):
    """Run ``fn`` under a CPU profiler session; return (its result, the
    profiler)."""
    telemetry.tracing()  # a call with the profiler off ends the last collection
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_spans_nest_and_self_time_excludes_children():
    def work():
        with telemetry.span("a"):
            time.sleep(0.01)
            with telemetry.span("a.b"):
                time.sleep(0.02)
                with telemetry.span("a.b.c"):
                    time.sleep(0.01)
            with telemetry.span("a.d"):
                time.sleep(0.01)

    traced(work)
    recs = {r.name: r for r in telemetry.records()}
    assert {n: r.parent for n, r in recs.items()} == {
        "a": None, "a.b": "a", "a.b.c": "a.b", "a.d": "a"}
    dur = {n: r.end_ns - r.start_ns for n, r in recs.items()}
    assert recs["a"].child_ns == dur["a.b"] + dur["a.d"]
    assert recs["a.b"].child_ns == dur["a.b.c"]
    spans = telemetry.collected()["spans"]
    for n in recs:
        assert spans[n]["calls"] == 1
        assert spans[n]["ms"] == pytest.approx(dur[n] * 1e-6)
        assert spans[n]["self_ms"] == pytest.approx((dur[n] - recs[n].child_ns) * 1e-6)
    assert spans["a"]["self_ms"] >= 9.0 and spans["a.b"]["self_ms"] >= 19.0


def test_worker_thread_spans_keep_their_own_parents():
    @telemetry.span("job")
    def job(i):
        with telemetry.span("job.part"):
            telemetry.count("items", i)
        return threading.get_ident()

    def work():
        with telemetry.span("main"):
            with ThreadPoolExecutor(max_workers=4) as pool:
                idents = list(pool.map(job, range(1, 9)))
            with telemetry.span("main.after"):
                pass
        return idents

    idents, _ = traced(work)
    recs = telemetry.records()
    assert sorted((r.name, r.parent) for r in recs if r.name.startswith("job")) == \
        [("job", None)] * 8 + [("job.part", "job")] * 8
    assert {r.thread for r in recs if r.name == "job"} == set(idents)
    assert [(r.name, r.parent) for r in recs if r.name.startswith("main")] == \
        [("main.after", "main"), ("main", None)]
    c = telemetry.collected()["counts"]["items"]
    assert c == {"total": 36, "by_span": {"job": 36, "job.part": 36}}


def test_profiler_off_records_nothing_and_enters_no_record_function(monkeypatch):
    traced(lambda: telemetry.count("before", 1))
    kept = telemetry.collected()

    def refuse(name):
        raise AssertionError(f"record_function entered for {name}")

    monkeypatch.setattr(telemetry, "record_function", refuse)
    tally = {"k": 0}

    @telemetry.span("decorated")
    def f():
        with telemetry.span("inner"):
            telemetry.count("k", 2, tally=tally)
            telemetry.host_read(torch.zeros(3))
        return 7

    assert f() == 7
    assert tally == {"k": 2}
    assert telemetry.collected() == kept
    # a new session starts a new collection
    monkeypatch.undo()
    traced(lambda: telemetry.count("after", 1))
    assert set(telemetry.collected()["counts"]) == {"after"}


def test_launch_tallies_count_on_and_off(monkeypatch):
    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    launches = {"kern": 0}

    def fn(*args):
        return 0

    _build.launch(launches, "kern", fn, 1, 2)
    traced(lambda: (_build.launch(launches, "kern", fn), _build.launch(launches, "kern", fn)))
    assert launches == {"kern": 3}
    assert telemetry.collected()["counts"]["kern"]["total"] == 2


def test_span_names_are_profiler_events():
    def work():
        with telemetry.span("pbnet.test_outer"):
            with telemetry.span("pbnet.test_inner"):
                torch.ones(4).sum()

    _, prof = traced(work)
    names = {e.name for e in prof.events()}
    assert {"pbnet.test_outer", "pbnet.test_inner"} <= names


def blob_scene(rng, n_blobs=3, per=120, pad=40):
    """Points in tight blobs of one class each, padded with invalid rows."""
    centers = rng.uniform(0, 3, (n_blobs, 3)).astype(np.float32)
    xyz = np.concatenate([c + rng.normal(0, 0.03, (per, 3)) for c in centers]).astype(np.float32)
    n = xyz.shape[0]
    pts = np.zeros((n + pad, 3), np.float32)
    pts[:n] = xyz
    sem = np.full(n + pad, 17, np.int32)
    valid = np.arange(n + pad) < n
    return (torch.from_numpy(pts), torch.from_numpy(pts.copy()), torch.from_numpy(sem),
            torch.zeros(n + pad, dtype=torch.int32), torch.from_numpy(valid))


@pytest.mark.parametrize("prop_iters", [1, 10])
def test_binary_cluster_reads_the_host_once_per_round_and_once_more(prop_iters):
    args = blob_scene(np.random.RandomState(3))
    res, _ = traced(lambda: cluster.binary_cluster(
        *args, radius=0.05, min_pts=5, count_mean=torch.from_numpy(COUNT_MEAN),
        cluster_cap=16, band=512, chunk=128, prop_iters=prop_iters))
    c = telemetry.collected()["counts"]
    rounds = c["cluster.rounds"]["total"]
    assert rounds == int(res.prop_rounds) and 1 <= rounds <= prop_iters
    assert c["host_reads"]["total"] == rounds + 1
    assert c["host_reads"]["by_span"]["pbnet.cluster.propagate"] == rounds
    assert c["host_reads"]["by_span"]["pbnet.cluster.exact_nn"] == 1
    assert c["cluster.exact_rows"]["total"] >= 0
    assert int(res.num_clusters) > 0


def test_host_outputs_reads_once_per_tensor():
    ret = {k: torch.arange(5, dtype=torch.int32) for k in train_step.EVAL_KEYS}
    ret["overflow"] = {"a": torch.zeros((), dtype=torch.int32),
                       "b": torch.zeros((), dtype=torch.int32)}
    host, _ = traced(lambda: train_step.host_outputs(ret))
    c = telemetry.collected()["counts"]
    n = len(train_step.EVAL_KEYS) - 1 + 2
    assert c["host_reads"] == {"total": n, "by_span": {"pbnet.host_outputs": n}}
    assert c["host_read_bytes"]["total"] == (n - 2) * 5 * 4 + 2 * 4
    assert host["overflow"]["b"] == 0


def test_gather_conv_counts_every_map_entry_executed():
    rng = np.random.RandomState(0)
    m_in, m, k, cin, cout = 50, 37, 27, 5, 7
    feats = torch.from_numpy(rng.randn(m_in, cin).astype(np.float32))
    kmap = torch.from_numpy(rng.randint(-1, m_in, (m, k)).astype(np.int32))
    w = torch.from_numpy(rng.randn(k, cin, cout).astype(np.float32))
    valid = torch.from_numpy(rng.rand(m) < 0.7)
    y, _ = traced(lambda: sparse_ops.gather_conv(feats, kmap, w, valid))
    assert telemetry.collected()["counts"]["conv.executed_ops"]["total"] == 2 * m * k * cin * cout
    torch.testing.assert_close(y, sparse_ops.gather_conv(feats, kmap, w, valid), rtol=0, atol=0)


def test_forward_is_bit_identical_with_tracing_on_and_off():
    sh = synthetic.GRAFT_SHAPES
    model = PBNet(sh, device="cpu", **ARCHS)
    batch = batch_to_device(synthetic.synthetic_batch(sh, np.random.RandomState(0)), "cpu")
    off = model(batch)
    on, prof = traced(lambda: model(batch))
    keys = ("sem_pred_p", "sem_pred_score_p", "offset_pred_p", "prop_point_pid",
            "prop_point_kept", "mask_scores", "clt_scores", "num_final_proposals")
    for k in keys:
        assert torch.equal(on[k], off[k]), k
    assert torch.equal(on["cluster"].cluster_id, off["cluster"].cluster_id)
    spans = telemetry.collected()["spans"]
    assert {"pbnet.backbone", "pbnet.backbone.topology", "pbnet.backbone.unet",
            "pbnet.instance_stage", "pbnet.cluster", "pbnet.local_scenes", "pbnet.mask_unet",
            "pbnet.score_net"} <= set(spans)
    assert telemetry.collected()["counts"]["conv.executed_ops"]["by_span"]["pbnet.backbone"] > 0


def planted(spans=None, counts=None):
    return {"spans": {n: {"calls": 4, "ms": ms, "self_ms": ms / 2}
                      for n, ms in (spans or {}).items()},
            "counts": counts or {}}


EVAL = {"kind": "eval", "trace": {"window_s": 1.0}, "requests": 4,
        "work": {"ops": 100, "ops_stage1": 50, "bytes_stage1": 10}}
TRAIN = {"kind": "train", "trace": {"window_s": 1.0}, "requests": 4, "work": {"ops": 100}}
READERS = [
    ("fold_ms.eval", EVAL, planted({"pbnet.fold": 80.0}), 20.0),
    ("cluster_ms.eval", EVAL, planted({"pbnet.cluster": 40.0, "pbnet.fold": 80.0}), 10.0),
    ("stage1_issue_ms.eval", EVAL, planted({"pbnet.backbone": 60.0}), 15.0),
    ("host_reads.eval", EVAL,
     planted(counts={"host_reads": {"total": 88, "by_span": {"pbnet.cluster": 8}}}), 22.0),
    ("stage1_executed_ratio.eval", EVAL,
     planted(counts={"conv.executed_ops": {"total": 999, "by_span": {"pbnet.backbone": 185}}}),
     3.7),
    ("host_reads.train", TRAIN,
     planted(counts={"host_reads": {"total": 8, "by_span": {"pbnet.cluster": 8}}}), 2.0),
    ("forward_issue_ms.train", TRAIN,
     planted({"pbnet.backbone": 100.0, "pbnet.instance_stage": 200.0, "pbnet.losses": 20.0,
              "pbnet.update": 1000.0}), 80.0),
]


@pytest.mark.parametrize("name,rec,coll,value", READERS, ids=[r[0] for r in READERS])
def test_reader_of_the_spans(monkeypatch, name, rec, coll, value):
    read = spec.reader(name)
    monkeypatch.setattr(telemetry, "collected", lambda: coll)
    assert read(rec) == pytest.approx(value)
    untraced = {k: v for k, v in rec.items() if k not in ("trace", "requests", "work")}
    assert read(untraced) is None
    other = dict(rec, kind="train" if rec["kind"] == "eval" else "eval")
    assert read(other) is None
    monkeypatch.setattr(telemetry, "collected", lambda: planted())
    assert read(rec) is None
    # a port without the module (the parent of these readers) reads nothing
    monkeypatch.setitem(sys.modules, "pbnet_torch.telemetry", None)
    monkeypatch.delattr(sys.modules["pbnet_torch"], "telemetry")
    assert read(rec) is None
