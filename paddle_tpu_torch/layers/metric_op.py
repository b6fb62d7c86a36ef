"""layers.metric_op — accuracy and the streaming auc."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import topk
from .tensor import create_global_var

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of `input` [N, C] against `label` [N, 1]: a top_k
    op, then accuracy; returns the float32 [1] accuracy."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32", True)
    if correct is None:
        correct = helper.create_variable_for_type_inference("int32", True)
    if total is None:
        total = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out.name],
                             "Indices": [topk_indices.name],
                             "Label": [label.name]},
                     outputs={"Accuracy": [acc_out.name],
                              "Correct": [correct.name],
                              "Total": [total.name]})
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming ROC AUC of `input` [N, 2] (the positive class's
    probability last) against `label` [N, 1]: the auc op adds this batch
    to two persistable int64 histograms of num_thresholds + 1 buckets,
    kept in place, and reads the area off them. Returns (AUC, [AUC],
    [StatPos, StatNeg])."""
    helper = LayerHelper("auc")
    stat_pos = create_global_var([num_thresholds + 1], 0, "int64",
                                 persistable=True)
    stat_neg = create_global_var([num_thresholds + 1], 0, "int64",
                                 persistable=True)
    auc_out = helper.create_variable_for_type_inference("float64", True)
    helper.append_op(type="auc",
                     inputs={"Predict": [input.name],
                             "Label": [label.name],
                             "StatPos": [stat_pos.name],
                             "StatNeg": [stat_neg.name]},
                     outputs={"AUC": [auc_out.name],
                              "StatPosOut": [stat_pos.name],
                              "StatNegOut": [stat_neg.name]},
                     attrs={"num_thresholds": num_thresholds})
    return auc_out, [auc_out], [stat_pos, stat_neg]
