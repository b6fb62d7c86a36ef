"""layers.metric_op — accuracy."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import topk

__all__ = ["accuracy"]


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
