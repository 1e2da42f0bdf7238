"""The port's instance-evaluation copies (pbnet_torch/ops/nms.py,
tools/metrics.py, tools/eval_protocol.py, eval_pipeline.py) against the JAX
package's, exactly, on seeded masks, scores, superpoints and GT ids.

NMS: the IoU matrix and the keep mask equal JAX's (0/1 masks: every sum is
an exact integer in f32).  The host functions are numpy on both sides and
must give identical arrays and dicts (NaN where the JAX package gives NaN).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu import eval_pipeline as jep
from pbnet_tpu.ops import nms as jnms
from pbnet_tpu.tools import eval_protocol as jev
from pbnet_tpu.tools import metrics as jmet
from pbnet_torch import eval_pipeline as tep
from pbnet_torch.config import Config
from pbnet_torch.ops import nms as tnms
from pbnet_torch.tools import eval_protocol as tev
from pbnet_torch.tools import metrics as tmet


def same(a, b):
    """Deep equality of nested dicts/lists/arrays/scalars, NaN == NaN."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def overlapping_masks(rng, p=12, n=400):
    """Proposal masks built as runs with shared stretches (real overlaps)."""
    masks = np.zeros((p, n), np.int32)
    for i in range(p):
        lo = rng.randint(0, n - 60)
        masks[i, lo:lo + rng.randint(20, 120)] = 1
    masks[3] = masks[1]  # a duplicate
    return masks


def test_nms_matches_jax(rng):
    masks = overlapping_masks(rng)
    scores = rng.rand(len(masks)).astype(np.float32)
    valid = rng.rand(len(masks)) < 0.9
    ious_j = np.asarray(jnms.cross_iou(jnp.asarray(masks)))
    ious_t = tnms.cross_iou(torch.from_numpy(masks))
    np.testing.assert_array_equal(ious_t.numpy(), ious_j)
    for th in (0.1, 0.3):
        keep_j = jnms.greedy_nms(jnp.asarray(ious_j), jnp.asarray(scores), jnp.asarray(valid), th)
        keep_t = tnms.greedy_nms(ious_t, torch.from_numpy(scores), torch.from_numpy(valid), th)
        np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
        pick = tnms.greedy_nms_np(ious_j, scores, th)
        np.testing.assert_array_equal(pick, jnms.greedy_nms_np(ious_j, scores, th))
        assert 0 < len(pick) < len(masks)


def test_metrics_match_jax(rng):
    out = rng.randint(0, 20, 500)
    tgt = np.where(rng.rand(500) < 0.1, -100, rng.randint(0, 20, 500))
    same(tmet.intersection_and_union(out, tgt, 20), jmet.intersection_and_union(out, tgt, 20))
    s = rng.rand(300)
    same(tmet.get_segmented_scores(s, 0.75, 0.25), jmet.get_segmented_scores(s, 0.75, 0.25))
    same(tmet.get_center_scores(s), jmet.get_center_scores(s))
    labels = np.where(rng.rand(600) < 0.2, -100, rng.randint(0, 7, 600))
    sp = rng.randint(0, 40, 600)
    sp = np.unique(sp, return_inverse=True)[1]  # dense superpoint ids
    same(tmet.align_superpoint_label(labels, sp, num_label=7),
         jmet.align_superpoint_label(labels, sp, num_label=7))
    ins = np.repeat(np.arange(5), 20)
    info = np.repeat(rng.rand(5, 9), 20, 0)
    pc = rng.rand(3, 3)
    same(tmet.get_gt_dist(info, ins, np.array([0, 2, 4]), pc),
         jmet.get_gt_dist(info, ins, np.array([0, 2, 4]), pc))
    a, b = tmet.AverageMeter(), jmet.AverageMeter()
    for v, n in ((1.0, 2), (4.0, 1)):
        a.update(v, n)
        b.update(v, n)
    assert vars(a) == vars(b)


def scene(rng, n=2000, n_inst=9):
    """Seeded GT ids (a few classes, instances of 150-260 vertices, one
    below the 100-vertex region size, void stretches) and predictions."""
    gt = np.zeros(n, np.int64)
    lo = 0
    for i in range(n_inst):
        size = 60 if i == 4 else rng.randint(150, 260)
        label = int(rng.choice([3, 5, 7, 39]))
        gt[lo:lo + size] = label * 1000 + i + 1
        lo += size + rng.randint(0, 40)
    masks, conf, label_id = [], [], []
    for _ in range(14):
        m = np.zeros(n, np.int32)
        a = rng.randint(0, n - 300)
        m[a:a + rng.randint(50, 300)] = 1
        masks.append(m)
        conf.append(rng.rand())
        label_id.append(int(rng.choice([3, 5, 7, 39, 1])))
    pred = {"conf": np.array(conf), "label_id": np.array(label_id), "mask": np.array(masks)}
    return gt, pred


def test_eval_protocol_matches_jax(rng):
    for k in ("CLASS_LABELS", "VALID_CLASS_IDS", "OVERLAPS", "SEMANTIC_LABEL_IDX"):
        same(getattr(tev, k), getattr(jev, k))
    results = []
    for ev in (tev, jev):
        matches = {}
        for s in range(3):
            gt, pred = scene(np.random.RandomState(s))
            g2p, p2g = ev.assign_instances_for_scan(f"scene{s}", pred, gt)
            matches[f"scene{s}"] = {"gt": g2p, "pred": p2g}
        aps = ev.evaluate_matches(matches)
        results.append((matches, aps, ev.compute_averages(aps)))
    same(results[0], results[1])
    avg = results[0][2]
    assert 0 < avg["all_ap_25%"] <= 1


def fake_ret(rng, n3, n_copies=3, n_prop=6):
    """Model outputs: proposals as runs of base vertices spread over the TTA
    copies, some points not kept."""
    src, pid = [], []
    for p in range(n_prop):
        a = rng.randint(0, n3 - 250)
        idx = np.arange(a, a + rng.randint(80, 250))
        for c in range(n_copies):
            src.append(idx + c * n3)
            pid.append(np.full(len(idx), p))
    src = np.concatenate(src).astype(np.int32)
    return {
        "prop_point_src": src,
        "prop_point_pid": np.concatenate(pid).astype(np.int32),
        "prop_point_kept": rng.rand(len(src)) < 0.9,
        "num_final_proposals": np.int32(n_prop),
        "clt_scores": rng.rand(n_prop + 2).astype(np.float32),
        "prop_sem": rng.randint(0, 20, n_prop + 2).astype(np.int32),
    }


@pytest.mark.parametrize("n_copies", [3, 1])
def test_eval_pipeline_matches_jax(rng, n_copies):
    n3 = 900
    ret = fake_ret(rng, n3, n_copies)
    # a single-copy scene passes 3 * n points so that the fold is the identity
    num_points = 3 * n3
    tret = {k: torch.from_numpy(np.asarray(v)) for k, v in ret.items()}
    same(tep.proposals_to_masks(tret, num_points), jep.proposals_to_masks(ret, num_points))
    sp = np.arange(n3) // 7
    cfg = Config()
    got = tep.eval_scene_instances(tret, num_points, sp, cfg)
    same(got, jep.eval_scene_instances(ret, num_points, sp, cfg))
    assert got is not None and len(got["conf"]) > 0
