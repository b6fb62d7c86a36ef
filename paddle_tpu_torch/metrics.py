"""Host-side streaming metrics (reference: python/paddle/fluid/metrics.py),
numpy only: the JAX package's module, copied. They read fetched numpy
values, never tensors on the card."""
from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Precision", "Recall",
           "Accuracy", "ChunkEvaluator", "EditDistance", "Auc",
           "DetectionMAP"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if isinstance(v, (int, float)) and not k.startswith("_"):
                setattr(self, k, 0 if isinstance(v, int) else 0.0)

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def get_config(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(value) * float(weight)
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError("no data in Accuracy")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels != 1)))

    def eval(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds != 1) & (labels == 1)))

    def eval(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._n = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, -1] if preds.ndim > 1 else preds
        bucket = np.clip((pos_prob * self._n).astype(int), 0, self._n)
        for b, l in zip(bucket, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos * tot_neg == 0:
            return 0.0
        tp_prev = np.concatenate([[0], tp[:-1]])
        fp_prev = np.concatenate([[0], fp[:-1]])
        area = np.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
        return float(area / (tot_pos * tot_neg))


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(num_infer_chunks)
        self.num_label_chunks += int(num_label_chunks)
        self.num_correct_chunks += int(num_correct_chunks)

    def eval(self):
        p = self.num_correct_chunks / self.num_infer_chunks \
            if self.num_infer_chunks else 0.0
        r = self.num_correct_chunks / self.num_label_chunks \
            if self.num_label_chunks else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        return p, r, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data in EditDistance")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class DetectionMAP(MetricBase):
    """Streaming detection mAP (reference metrics.py:805), accumulated on
    the host: call `update(detections, gt_label, gt_box, gt_difficult)`
    once per image with numpy arrays, then `eval()` returns the mAP over
    everything seen. The matching and AP math mirror
    detection_map_op.h:308-475 (strict overlap > threshold, prediction
    ClipBBox, one GT consumed per match, integral/11point AP;
    core/detection_eval.py).

    detections: [M, 6] (label, confidence, xmin, ymin, xmax, ymax)
    gt_label: [N, 1]; gt_box: [N, 4]; gt_difficult: [N, 1] or None.
    """

    def __init__(self, class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral", name=None):
        super().__init__(name)
        if ap_version not in ("integral", "11point"):
            raise ValueError("ap_version must be 'integral' or '11point'")
        self._class_num = class_num
        self._background = background_label
        self._thr = overlap_threshold
        self._eval_difficult = evaluate_difficult
        self._ap_version = ap_version
        self.reset()

    def reset(self):
        # per class: npos count and (score, is_tp) match records
        self._npos = {}
        self._records = {}

    def update(self, detections, gt_label, gt_box, gt_difficult=None):
        """One image's detections + ground truth (numpy)."""
        from .core.detection_eval import match_class

        det = np.asarray(detections, np.float32).reshape(-1, 6)
        gl = np.asarray(gt_label).reshape(-1).astype(np.int64)
        gb = np.asarray(gt_box, np.float32).reshape(-1, 4)
        gd = np.zeros(len(gl), bool) if gt_difficult is None else \
            np.asarray(gt_difficult).reshape(-1) != 0
        for cls in set(gl.tolist()) | set(det[:, 0].astype(int).tolist()):
            if cls == self._background:
                continue
            sel = gl == cls
            gts, diff = gb[sel], gd[sel]
            npos = int(len(gts) if self._eval_difficult
                       else (~diff).sum())
            self._npos[cls] = self._npos.get(cls, 0) + npos
            d = det[det[:, 0] == cls]
            if len(d) == 0:
                continue
            self._records.setdefault(cls, []).extend(
                match_class(d[:, 1:6], gts, diff, self._thr,
                            self._eval_difficult))

    def eval(self):
        from .core.detection_eval import average_precision

        aps = [ap for cls, npos in self._npos.items()
               if (ap := average_precision(self._records.get(cls, []),
                                           npos,
                                           self._ap_version)) is not None]
        return float(np.mean(aps)) if aps else 0.0
