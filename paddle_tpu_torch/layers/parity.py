"""layers.parity — layers of the JAX package's layers/parity.py: pool3d,
adaptive_pool3d, unique_with_counts, beam_search, beam_search_decode,
moe_ffn, the sequence helpers, and the CRF, CTC, chunk, edit-distance
and sampled-loss layers (the rest waits for ROADMAP §A8)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["pool3d", "adaptive_pool3d", "unique_with_counts",
           "beam_search", "beam_search_decode", "im2sequence", "lod_reset",
           "lod_append", "sequence_enumerate", "gather_tree",
           "filter_by_instag", "tensor_array_to_tensor",
           "reorder_lod_tensor_by_rank", "moe_ffn", "linear_chain_crf",
           "crf_decoding", "chunk_eval", "edit_distance",
           "ctc_greedy_decoder", "sampled_softmax_with_cross_entropy",
           "teacher_student_sigmoid_loss", "continuous_value_model"]


def _one_out(op_type, inputs, attrs=None, dtype=None, ref=None, name=None,
             out_slot="Out", stop_gradient=False):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(
        dtype or ref.dtype, stop_gradient)
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={out_slot: [out.name]}, attrs=attrs or {})
    return out


def _3(v):
    return [v, v, v] if isinstance(v, int) else list(v)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None):
    return _one_out("pool3d", {"X": [input.name]},
                    {"ksize": _3(pool_size), "pooling_type": pool_type,
                     "strides": _3(pool_stride),
                     "paddings": _3(pool_padding),
                     "global_pooling": global_pooling,
                     "ceil_mode": ceil_mode, "exclusive": exclusive},
                    ref=input, name=name)


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """pool3d to a fixed output size `pool_size`; the indices
    (`require_index`) are not computed, as in the JAX package."""
    return _one_out("pool3d", {"X": [input.name]},
                    {"ksize": _3(pool_size), "pooling_type": pool_type,
                     "adaptive": True, "strides": [1, 1, 1],
                     "paddings": [0, 0, 0]},
                    ref=input, name=name)


def unique_with_counts(x, dtype="int32"):
    """unique's padded Out and Index, and each value's count (0 in the
    padded slots)."""
    helper = LayerHelper("unique_with_counts")
    out = helper.create_variable_for_type_inference(x.dtype, True)
    index = helper.create_variable_for_type_inference(dtype, True)
    count = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="unique_with_counts", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Index": [index.name],
                              "Count": [count.name]})
    return out, index, count


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    helper = LayerHelper("beam_search", name=name)
    selected_ids = helper.create_variable_for_type_inference("int64", True)
    selected_scores = helper.create_variable_for_type_inference(
        scores.dtype, True)
    parent_idx = helper.create_variable_for_type_inference("int32", True)
    ins = {"pre_ids": [pre_ids.name], "pre_scores": [pre_scores.name],
           "scores": [scores.name]}
    if ids is not None:
        ins["ids"] = [ids.name]
    helper.append_op(
        type="beam_search", inputs=ins,
        outputs={"selected_ids": [selected_ids.name],
                 "selected_scores": [selected_scores.name],
                 "parent_idx": [parent_idx.name]},
        attrs={"beam_size": beam_size, "end_id": end_id, "level": level,
               "is_accumulated": is_accumulated})
    if return_parent_idx:
        return selected_ids, selected_scores, parent_idx
    return selected_ids, selected_scores


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    helper = LayerHelper("beam_search_decode", name=name)
    sentence_ids = helper.create_variable_for_type_inference("int64", True)
    sentence_scores = helper.create_variable_for_type_inference(
        scores.dtype, True)
    helper.append_op(type="beam_search_decode",
                     inputs={"Ids": [ids.name], "Scores": [scores.name]},
                     outputs={"SentenceIds": [sentence_ids.name],
                              "SentenceScores": [sentence_scores.name]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    return sentence_ids, sentence_scores


def im2sequence(input, filter_size=1, stride=1, padding=0, input_image_size=None,
                out_stride=1, name=None):
    def _2(v):
        return [v, v] if isinstance(v, int) else list(v)
    pad = _2(padding)
    if len(pad) == 2:
        pad = pad * 2
    return _one_out("im2sequence", {"X": [input.name]},
                    {"kernels": _2(filter_size), "strides": _2(stride),
                     "paddings": pad},
                    ref=input, name=name)


def lod_reset(x, y=None, target_lod=None):
    ins = {"X": [x.name]}
    if y is not None:
        ins["Y"] = [y.name]
    return _one_out("lod_reset", ins, {"target_lod": target_lod or []},
                    ref=x)


def lod_append(x, level):
    """The LoD lives on the host (core/lod.py): on the device the tensor
    is unchanged."""
    return lod_reset(x)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    from .sequence import sequence_enumerate as _se
    return _se(input, win_size, pad_value, name)


def gather_tree(ids, parents):
    return _one_out("gather_tree",
                    {"Ids": [ids.name], "Parents": [parents.name]},
                    ref=ids, stop_gradient=True)


def filter_by_instag(ins, ins_tag, filter_tag, is_lod, out_val_if_empty=0):
    helper = LayerHelper("filter_by_instag")
    out = helper.create_variable_for_type_inference(ins.dtype)
    loss_weight = helper.create_variable_for_type_inference("float32", True)
    index_map = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type="filter_by_instag",
                     inputs={"Ins": [ins.name], "Ins_tag": [ins_tag.name],
                             "Filter_tag": [filter_tag.name]},
                     outputs={"Out": [out.name],
                              "LossWeight": [loss_weight.name],
                              "IndexMap": [index_map.name]},
                     attrs={"is_lod": is_lod})
    return out, loss_weight


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference("float32")
    out_index = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(type="tensor_array_to_tensor",
                     inputs={"X": [input.name]},
                     outputs={"Out": [out.name],
                              "OutIndex": [out_index.name]},
                     attrs={"axis": axis, "use_stack": use_stack})
    return out, out_index


def reorder_lod_tensor_by_rank(x, rank_table):
    return _one_out("reorder_lod_tensor_by_rank",
                    {"X": [x.name], "RankTable": [rank_table.name]},
                    ref=x)


def moe_ffn(input, num_experts, d_ff, ep_axis="ep", capacity=None,
            batch_axis="dp", param_attr=None, name=None):
    """Mixture-of-experts FFN layer (parallel/moe.py): top-1 switch
    routing, the expert weights split over the `ep` mesh axis under
    CompiledProgram.with_distributed; `batch_axis` names the axis the
    batch is split over. A caller's param_attr (regularizer, lr, custom
    init) applies to every expert weight; each weight's own default
    initializer fills the gaps. Returns (out, router_load)."""
    from ..framework import ParamAttr
    from ..initializer import Normal
    if param_attr is False:
        raise TypeError(
            "moe_ffn: param_attr=False is not meaningful — the expert "
            "weights ARE the layer; pass a ParamAttr or None")
    helper = LayerHelper("moe_ffn", name=name, param_attr=param_attr)
    d = int(input.shape[-1])
    pfx = helper.name
    base = ParamAttr._to_attr(param_attr)

    def param(suffix, shape, std, is_bias=False):
        attr = ParamAttr(
            name=f"{pfx}.{suffix}",
            initializer=base.initializer or (None if is_bias
                                             else Normal(0.0, std)),
            learning_rate=base.learning_rate,
            regularizer=base.regularizer,
            trainable=base.trainable)
        return helper.create_parameter(attr, shape, input.dtype,
                                       is_bias=is_bias)

    gate_w = param("gate_w", [d, num_experts], 0.02)
    w1 = param("w1", [num_experts, d, d_ff], (2.0 / d) ** 0.5)
    b1 = param("b1", [num_experts, d_ff], 0.0, is_bias=True)
    w2 = param("w2", [num_experts, d_ff, d], (2.0 / d_ff) ** 0.5)
    b2 = param("b2", [num_experts, d], 0.0, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    load = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        type="moe_ffn",
        inputs={"X": [input.name], "GateW": [gate_w.name],
                "W1": [w1.name], "B1": [b1.name], "W2": [w2.name],
                "B2": [b2.name]},
        outputs={"Out": [out.name], "Load": [load.name]},
        attrs={"ep_axis": ep_axis, "capacity": capacity or 0,
               "batch_axis": batch_axis})
    return out, load


def linear_chain_crf(input, label, param_attr=None, length=None):
    """The CRF's negative log-likelihood [B, 1] of `label` under the
    emission scores `input` [B, T, n] and a transition parameter
    [n + 2, n] (rows 0 and 1 the start and stop weights)."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    n_tags = int(input.shape[-1])
    transition = helper.create_parameter(helper.param_attr,
                                         [n_tags + 2, n_tags],
                                         input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype, True)
    e_exps = helper.create_variable_for_type_inference(input.dtype, True)
    t_exps = helper.create_variable_for_type_inference(input.dtype, True)
    ll = helper.create_variable_for_type_inference(input.dtype)
    ins = {"Emission": [input.name], "Transition": [transition.name],
           "Label": [label.name]}
    if length is not None:
        ins["Length"] = [length.name]
    helper.append_op(type="linear_chain_crf", inputs=ins,
                     outputs={"Alpha": [alpha.name],
                              "EmissionExps": [e_exps.name],
                              "TransitionExps": [t_exps.name],
                              "LogLikelihood": [ll.name]})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decoding under the transition parameter that
    linear_chain_crf made with the same ParamAttr (found by name)."""
    from ..framework import ParamAttr, default_main_program
    helper = LayerHelper("crf_decoding")
    attr = ParamAttr._to_attr(param_attr)
    trans_var = default_main_program().global_block().var(attr.name)
    out = helper.create_variable_for_type_inference("int64", True)
    ins = {"Emission": [input.name], "Transition": [trans_var.name]}
    if label is not None:
        ins["Label"] = [label.name]
    if length is not None:
        ins["Length"] = [length.name]
    helper.append_op(type="crf_decoding", inputs=ins,
                     outputs={"ViterbiPath": [out.name]})
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """(precision, recall, F1, inferred, labelled and correct chunks)."""
    helper = LayerHelper("chunk_eval")
    precision = helper.create_variable_for_type_inference("float32", True)
    recall = helper.create_variable_for_type_inference("float32", True)
    f1 = helper.create_variable_for_type_inference("float32", True)
    n_infer = helper.create_variable_for_type_inference("int64", True)
    n_label = helper.create_variable_for_type_inference("int64", True)
    n_correct = helper.create_variable_for_type_inference("int64", True)
    ins = {"Inference": [input.name], "Label": [label.name]}
    if seq_length is not None:
        ins["SeqLength"] = [seq_length.name]
    helper.append_op(
        type="chunk_eval", inputs=ins,
        outputs={"Precision": [precision.name], "Recall": [recall.name],
                 "F1-Score": [f1.name], "NumInferChunks": [n_infer.name],
                 "NumLabelChunks": [n_label.name],
                 "NumCorrectChunks": [n_correct.name]},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": excluded_chunk_types or []})
    return precision, recall, f1, n_infer, n_label, n_correct


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """(distance [B, 1], the number of sequences) of -1-padded ids."""
    helper = LayerHelper("edit_distance")
    out = helper.create_variable_for_type_inference("float32", True)
    seq_num = helper.create_variable_for_type_inference("int64", True)
    ins = {"Hyps": [input.name], "Refs": [label.name]}
    if input_length is not None:
        ins["HypsLength"] = [input_length.name]
    if label_length is not None:
        ins["RefsLength"] = [label_length.name]
    helper.append_op(type="edit_distance", inputs=ins,
                     outputs={"Out": [out.name],
                              "SequenceNum": [seq_num.name]},
                     attrs={"normalized": normalized})
    return out, seq_num


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """The sample_logits op, then softmax cross-entropy over the sampled
    slice."""
    from .nn import softmax_with_cross_entropy
    helper = LayerHelper("sample_logits")
    samples = helper.create_variable_for_type_inference("int64", True)
    probabilities = helper.create_variable_for_type_inference(
        logits.dtype, True)
    sampled_logits = helper.create_variable_for_type_inference(logits.dtype)
    sampled_label = helper.create_variable_for_type_inference("int64", True)
    logits_dim = helper.create_variable_for_type_inference(
        logits.dtype, True)
    labels_dim = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(
        type="sample_logits",
        inputs={"Logits": [logits.name], "Labels": [label.name]},
        outputs={"Samples": [samples.name],
                 "Probabilities": [probabilities.name],
                 "SampledLogits": [sampled_logits.name],
                 "SampledLabels": [sampled_label.name],
                 "LogitsDim": [logits_dim.name],
                 "LabelsDim": [labels_dim.name]},
        attrs={"num_samples": num_samples,
               "remove_accidental_hits": remove_accidental_hits,
               "seed": seed})
    return softmax_with_cross_entropy(sampled_logits, sampled_label)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _one_out("teacher_student_sigmoid_loss",
                    {"X": [input.name], "Label": [label.name]},
                    {"soft_max_up_bound": soft_max_up_bound,
                     "soft_max_lower_bound": soft_max_lower_bound},
                    ref=input, out_slot="Y")


def continuous_value_model(input, cvm, use_cvm=True):
    return _one_out("cvm", {"X": [input.name], "CVM": [cvm.name]},
                    {"use_cvm": use_cvm}, ref=input, out_slot="Y")


def ctc_greedy_decoder(input, blank, name=None):
    """argmax a step, repeats merged, blanks dropped (topk + ctc_align,
    as the reference composes it)."""
    from .nn import squeeze, topk
    _, ids = topk(input, k=1)
    ids2 = squeeze(ids, axes=[-1])
    return _one_out("ctc_align", {"Input": [ids2.name]}, {"blank": blank},
                    dtype="int64", ref=input, name=name,
                    out_slot="Output", stop_gradient=True)
