"""Detection-mAP evaluation math (detection_map_op.h:308-475): the
greedy score-ranked matching and the AP interpolation that
metrics.DetectionMAP reads. The JAX package's module, copied.
"""
from __future__ import annotations

import numpy as np

__all__ = ["match_class", "average_precision"]


def match_class(dets, gts, difficult, thr, evaluate_difficult):
    """Greedy matching of one image's one-class detections to its GTs.

    dets: [M, 5] (score, xmin, ymin, xmax, ymax) in any order;
    gts: [N, 4]; difficult: [N] bool. Returns [(score, flag)] with
    flag 1 = true positive, 0 = false positive; detections matching a
    difficult GT under evaluate_difficult=False produce NO record
    (CalcTrueAndFalsePositive, detection_map_op.h:391-403). Matching is
    strict `overlap > thr` with predictions clipped to [0,1] (ClipBBox)
    and each GT consumed by at most one detection.
    """
    dets = np.asarray(dets, np.float32).reshape(-1, 5)
    gts = np.asarray(gts, np.float32).reshape(-1, 4)
    difficult = np.asarray(difficult, bool).reshape(-1)
    order = np.argsort(-dets[:, 0], kind="stable")
    used = np.zeros(len(gts), bool)
    records = []
    for row in dets[order]:
        score = float(row[0])
        if len(gts) == 0:
            records.append((score, 0))
            continue
        b = np.clip(row[1:5], 0.0, 1.0)
        x1 = np.maximum(gts[:, 0], b[0])
        y1 = np.maximum(gts[:, 1], b[1])
        x2 = np.minimum(gts[:, 2], b[2])
        y2 = np.minimum(gts[:, 3], b[3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
        area_b = (b[2] - b[0]) * (b[3] - b[1])
        iou = inter / np.maximum(area_g + area_b - inter, 1e-10)
        j = int(np.argmax(iou))
        if iou[j] > thr:
            if not evaluate_difficult and difficult[j]:
                continue  # difficult match: neither tp nor fp
            if used[j]:
                records.append((score, 0))
            else:
                used[j] = True
                records.append((score, 1))
        else:
            records.append((score, 0))
    return records


def average_precision(records, npos, ap_type):
    """AP from (score, tp-flag) records + the class positive count.
    ap_type 'integral' (reference default) or '11point' (VOC2007);
    CalcMAP, detection_map_op.h:414-475."""
    if npos == 0 or not records:
        return None
    recs = sorted(records, key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in recs])
    prec = tp / (np.arange(len(recs)) + 1)
    rec = tp / npos
    if ap_type == "11point":
        return sum(
            (prec[rec >= t].max() if (rec >= t).any() else 0.0) / 11.0
            for t in np.linspace(0, 1, 11))
    ap, prev = 0.0, 0.0
    for p, r in zip(prec, rec):
        if abs(r - prev) > 1e-6:
            ap += p * abs(r - prev)
        prev = r
    return float(ap)
