"""Official ScanNet v2 instance-segmentation AP protocol.

The port's own copy of ``pbnet_tpu/tools/eval_protocol.py`` (the port
imports nothing of the JAX package); tests/test_torch_eval.py holds the
two equal.

Re-implementation of the ScanNet benchmark evaluator the reference vendors
(PBNet tools/eval.py, itself derived from
ScanNet/BenchmarkScripts/3d_evaluation/evaluate_semantic_instance.py).
Numerics are kept identical: greedy confidence matching per overlap
threshold, hard false negatives, void/small-GT ignore rules, and the
precision-recall curve integrated with the [-0.5, 0, 0.5] convolution step.

Data model
----------
* GT: per-vertex encoded ids ``semantic_label*1000 + instance + 1`` read from
  ``val_gt/<scene>.txt`` (see PBNet datasets/scannetv2/
  get_val_gt.py:15-38).
* Pred: dict with 'conf' (P,), 'label_id' (P,) ScanNet semantic ids, and
  'mask' (P, N) binary vertex masks.
"""

from __future__ import annotations

import numpy as np

CLASS_LABELS = [
    "cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
    "picture", "counter", "desk", "curtain", "refrigerator", "shower curtain",
    "toilet", "sink", "bathtub", "otherfurniture",
]
VALID_CLASS_IDS = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
ID_TO_LABEL = {int(i): l for i, l in zip(VALID_CLASS_IDS, CLASS_LABELS)}
LABEL_TO_ID = {l: int(i) for i, l in zip(VALID_CLASS_IDS, CLASS_LABELS)}

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
MIN_REGION_SIZES = np.array([100])
DISTANCE_THRESHES = np.array([float("inf")])
DISTANCE_CONFS = np.array([-float("inf")])

# semantic class index (0..19) -> ScanNet label id
# (PBNet eval_map.py:32)
SEMANTIC_LABEL_IDX = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]


def load_gt_ids(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int64, ndmin=1)


def get_gt_instances(gt_ids: np.ndarray) -> dict:
    """Group GT vertices into per-label instance records."""
    instances = {label: [] for label in CLASS_LABELS}
    for iid in np.unique(gt_ids):
        if iid == 0:
            continue
        label_id = int(iid // 1000)
        if label_id not in ID_TO_LABEL:
            continue
        instances[ID_TO_LABEL[label_id]].append(
            {
                "instance_id": int(iid),
                "label_id": label_id,
                "vert_count": int((gt_ids == iid).sum()),
                "med_dist": -1,
                "dist_conf": 0.0,
                "matched_pred": [],
            }
        )
    return instances


def assign_instances_for_scan(scene_name: str, pred_info: dict, gt_ids: np.ndarray):
    """Cross-associate predictions and GT for one scene
    (semantics of PBNet tools/eval.py:207-270)."""
    gt2pred = get_gt_instances(gt_ids)
    pred2gt = {label: [] for label in CLASS_LABELS}
    void_mask = np.logical_not(np.isin(gt_ids // 1000, VALID_CLASS_IDS))

    num_pred = 0
    for i in range(pred_info["label_id"].shape[0]):
        label_id = int(pred_info["label_id"][i])
        if label_id not in ID_TO_LABEL:
            continue
        label_name = ID_TO_LABEL[label_id]
        mask = np.not_equal(pred_info["mask"][i], 0)
        if len(mask) != len(gt_ids):
            raise ValueError(
                f"mask length {len(mask)} != vertex count {len(gt_ids)}"
            )
        count = int(np.count_nonzero(mask))
        if count < MIN_REGION_SIZES[0]:
            continue
        pred_inst = {
            "filename": f"{scene_name}_{num_pred:03d}",
            "pred_id": num_pred,
            "label_id": label_id,
            "vert_count": count,
            "confidence": float(pred_info["conf"][i]),
            "void_intersection": int(np.count_nonzero(np.logical_and(void_mask, mask))),
        }
        matched_gt = []
        for gi, gt in enumerate(gt2pred[label_name]):
            inter = int(np.count_nonzero(
                np.logical_and(gt_ids == gt["instance_id"], mask)
            ))
            if inter > 0:
                gt_copy = dict(gt, intersection=inter)
                pred_copy = dict(pred_inst, intersection=inter)
                matched_gt.append(gt_copy)
                gt2pred[label_name][gi]["matched_pred"].append(pred_copy)
        pred_inst["matched_gt"] = matched_gt
        num_pred += 1
        pred2gt[label_name].append(pred_inst)
    return gt2pred, pred2gt


def evaluate_matches(matches: dict) -> np.ndarray:
    """AP per (distance-config, class, overlap); the official greedy matching
    + PR-curve convolution (semantics of PBNet tools/eval.py:27-184)."""
    overlaps = OVERLAPS
    min_region_size = MIN_REGION_SIZES[0]
    distance_thresh = DISTANCE_THRESHES[0]
    distance_conf = DISTANCE_CONFS[0]
    ap = np.zeros((1, len(CLASS_LABELS), len(overlaps)), np.float32)

    for oi, overlap_th in enumerate(overlaps):
        pred_visited = {}
        for m in matches:
            for label_name in CLASS_LABELS:
                for p in matches[m]["pred"][label_name]:
                    if "filename" in p:
                        pred_visited[p["filename"]] = False
        for li, label_name in enumerate(CLASS_LABELS):
            y_true = np.empty(0)
            y_score = np.empty(0)
            hard_false_negatives = 0
            has_gt = False
            has_pred = False
            for m in matches:
                pred_instances = matches[m]["pred"][label_name]
                gt_instances = [
                    gt
                    for gt in matches[m]["gt"][label_name]
                    if gt["instance_id"] >= 1000
                    and gt["vert_count"] >= min_region_size
                    and gt["med_dist"] <= distance_thresh
                    and gt["dist_conf"] >= distance_conf
                ]
                has_gt = has_gt or bool(gt_instances)
                has_pred = has_pred or bool(pred_instances)

                cur_true = np.ones(len(gt_instances))
                cur_score = np.full(len(gt_instances), -np.inf)
                cur_match = np.zeros(len(gt_instances), dtype=bool)
                for gti, gt in enumerate(gt_instances):
                    found_match = False
                    for pred in gt["matched_pred"]:
                        if pred_visited[pred["filename"]]:
                            continue
                        overlap = float(pred["intersection"]) / (
                            gt["vert_count"] + pred["vert_count"] - pred["intersection"]
                        )
                        if overlap > overlap_th:
                            confidence = pred["confidence"]
                            if cur_match[gti]:
                                # second match: lower-score one is a FP
                                max_s = max(cur_score[gti], confidence)
                                min_s = min(cur_score[gti], confidence)
                                cur_score[gti] = max_s
                                cur_true = np.append(cur_true, 0)
                                cur_score = np.append(cur_score, min_s)
                                cur_match = np.append(cur_match, True)
                            else:
                                found_match = True
                                cur_match[gti] = True
                                cur_score[gti] = confidence
                                pred_visited[pred["filename"]] = True
                    if not found_match:
                        hard_false_negatives += 1
                cur_true = cur_true[cur_match]
                cur_score = cur_score[cur_match]

                for pred in pred_instances:
                    found_gt = False
                    for gt in pred["matched_gt"]:
                        overlap = float(gt["intersection"]) / (
                            gt["vert_count"] + pred["vert_count"] - gt["intersection"]
                        )
                        if overlap > overlap_th:
                            found_gt = True
                            break
                    if not found_gt:
                        num_ignore = pred["void_intersection"]
                        for gt in pred["matched_gt"]:
                            if gt["instance_id"] < 1000:
                                num_ignore += gt["intersection"]
                            if (
                                gt["vert_count"] < min_region_size
                                or gt["med_dist"] > distance_thresh
                                or gt["dist_conf"] < distance_conf
                            ):
                                num_ignore += gt["intersection"]
                        if float(num_ignore) / pred["vert_count"] <= overlap_th:
                            cur_true = np.append(cur_true, 0)
                            cur_score = np.append(cur_score, pred["confidence"])

                y_true = np.append(y_true, cur_true)
                y_score = np.append(y_score, cur_score)

            if has_gt and has_pred:
                order = np.argsort(y_score)
                y_score_sorted = y_score[order]
                y_true_sorted = y_true[order]
                y_true_cumsum = np.cumsum(y_true_sorted)

                thresholds, unique_indices = np.unique(
                    y_score_sorted, return_index=True
                )
                num_prec_recall = len(unique_indices) + 1
                num_examples = len(y_score_sorted)
                num_true_examples = y_true_cumsum[-1] if len(y_true_cumsum) else 0
                precision = np.zeros(num_prec_recall)
                recall = np.zeros(num_prec_recall)
                y_true_cumsum = np.append(y_true_cumsum, 0)
                for idx_res, idx_scores in enumerate(unique_indices):
                    cumsum = y_true_cumsum[idx_scores - 1]
                    tp = num_true_examples - cumsum
                    fp = num_examples - idx_scores - tp
                    fn = cumsum + hard_false_negatives
                    precision[idx_res] = float(tp) / (tp + fp)
                    recall[idx_res] = float(tp) / (tp + fn)
                precision[-1] = 1.0
                recall[-1] = 0.0

                recall_for_conv = np.copy(recall)
                recall_for_conv = np.append(recall_for_conv[0], recall_for_conv)
                recall_for_conv = np.append(recall_for_conv, 0.0)
                step_widths = np.convolve(recall_for_conv, [-0.5, 0, 0.5], "valid")
                ap_current = np.dot(precision, step_widths)
            elif has_gt:
                ap_current = 0.0
            else:
                ap_current = float("nan")
            ap[0, li, oi] = ap_current
    return ap


def compute_averages(aps: np.ndarray) -> dict:
    o50 = np.where(np.isclose(OVERLAPS, 0.5))
    o25 = np.where(np.isclose(OVERLAPS, 0.25))
    o_all = np.where(np.logical_not(np.isclose(OVERLAPS, 0.25)))
    avg = {
        "all_ap": np.nanmean(aps[0, :, o_all]),
        "all_ap_50%": np.nanmean(aps[0, :, o50]),
        "all_ap_25%": np.nanmean(aps[0, :, o25]),
        "classes": {},
    }
    for li, label in enumerate(CLASS_LABELS):
        avg["classes"][label] = {
            "ap": np.average(aps[0, li, o_all]),
            "ap50%": np.average(aps[0, li, o50]),
            "ap25%": np.average(aps[0, li, o25]),
        }
    return avg


def print_results(avgs: dict, logger=None) -> None:
    emit = logger.info if logger else print
    line_len = 64
    emit("")
    emit("#" * line_len)
    emit(f"{'what':<15}:{'AP':>15}{'AP_50%':>15}{'AP_25%':>15}")
    emit("#" * line_len)
    for label in CLASS_LABELS:
        c = avgs["classes"][label]
        emit(f"{label:<15}:{c['ap']:>15.3f}{c['ap50%']:>15.3f}{c['ap25%']:>15.3f}")
    emit("-" * line_len)
    emit(
        f"{'average':<15}:{avgs['all_ap']:>15.3f}"
        f"{avgs['all_ap_50%']:>15.3f}{avgs['all_ap_25%']:>15.3f}"
    )
    emit("")
