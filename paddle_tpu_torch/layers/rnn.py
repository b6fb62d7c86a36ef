"""RNN layers: the GRU and LSTM sequence layers and cells, the RNNCell
API with rnn() / birnn(), and BeamSearchDecoder with dynamic_decode().

rnn() and dynamic_decode() record the cell's step into a sub-block once
and emit one `recurrent` op over it (ops/rnn_ops.py), which runs the
step for every time step; a beam search backtracks its parents with
gather_tree.
"""
from __future__ import annotations

import numpy as np

from ..framework import default_main_program, unique_name
from ..layer_helper import LayerHelper
from .sequence import _default_lengths
from . import nn as _nn
from . import tensor as _tensor

__all__ = ["RNNCell", "GRUCell", "LSTMCell", "rnn", "birnn", "Decoder",
           "BeamSearchDecoder", "dynamic_decode", "dynamic_gru",
           "dynamic_lstm", "dynamic_lstmp", "gru_unit", "lstm_unit", "lstm"]


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                sequence_length=None, name=None):
    """input [B, T, 3*size] pre-projected; returns hidden [B, T, size]."""
    helper = LayerHelper("dynamic_gru", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    if sequence_length is None:
        sequence_length = _default_lengths(helper, input)
    w = helper.create_parameter(param_attr, [size, 3 * size], "float32")
    b = helper.create_parameter(bias_attr, [1, 3 * size], "float32",
                                is_bias=True)
    hidden = helper.create_variable_for_type_inference()
    ins = {"Input": [input.name], "Weight": [w.name], "Bias": [b.name]}
    if h_0 is not None:
        ins["H0"] = [h_0.name]
    if sequence_length is not None:
        ins["Lengths"] = [sequence_length.name]
    helper.append_op(
        type="gru", inputs=ins, outputs={"Hidden": [hidden.name]},
        attrs={"gate_activation": gate_activation,
               "activation": candidate_activation,
               "is_reverse": is_reverse, "origin_mode": origin_mode})
    return hidden


def dynamic_lstm(input, size, param_attr=None, bias_attr=None,
                 use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", h_0=None, c_0=None,
                 sequence_length=None, name=None):
    """input [B, T, size] pre-projected (size = 4*hidden); returns
    (hidden, cell) each [B, T, size/4]."""
    d = size // 4
    helper = LayerHelper("dynamic_lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    if sequence_length is None:
        sequence_length = _default_lengths(helper, input)
    w = helper.create_parameter(param_attr, [d, 4 * d], "float32")
    bias_len = 7 * d if use_peepholes else 4 * d
    b = helper.create_parameter(bias_attr, [1, bias_len], "float32",
                                is_bias=True)
    hidden = helper.create_variable_for_type_inference()
    cell = helper.create_variable_for_type_inference()
    ins = {"Input": [input.name], "Weight": [w.name], "Bias": [b.name]}
    if h_0 is not None:
        ins["H0"] = [h_0.name]
    if c_0 is not None:
        ins["C0"] = [c_0.name]
    if sequence_length is not None:
        ins["Lengths"] = [sequence_length.name]
    helper.append_op(
        type="lstm", inputs=ins,
        outputs={"Hidden": [hidden.name], "Cell": [cell.name]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  sequence_length=None, name=None):
    """LSTM with a recurrent projection: recurrent weight
    [proj_size, 4*hidden], projection [hidden, proj_size]; returns
    (projection [B,T,proj_size], cell [B,T,hidden])."""
    d = size // 4
    helper = LayerHelper("dynamic_lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    if sequence_length is None:
        sequence_length = _default_lengths(helper, input)
    w = helper.create_parameter(param_attr, [proj_size, 4 * d], "float32")
    proj_w = helper.create_parameter(param_attr, [d, proj_size], "float32")
    bias_len = 7 * d if use_peepholes else 4 * d
    b = helper.create_parameter(bias_attr, [1, bias_len], "float32",
                                is_bias=True)
    hidden = helper.create_variable_for_type_inference()
    cell = helper.create_variable_for_type_inference()
    ins = {"Input": [input.name], "Weight": [w.name],
           "Bias": [b.name], "ProjWeight": [proj_w.name]}
    if sequence_length is not None:
        ins["Lengths"] = [sequence_length.name]
    helper.append_op(
        type="lstm",
        inputs=ins,
        outputs={"Hidden": [hidden.name], "Cell": [cell.name]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return hidden, cell


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One GRU step: input [B, 3*D] pre-projected, hidden [B, D]; returns
    (hidden, reset_hidden_prev, gate)."""
    d = size // 3
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    w = helper.create_parameter(param_attr, [d, 3 * d], "float32")
    b = helper.create_parameter(bias_attr, [1, 3 * d], "float32",
                                is_bias=True)
    gate = helper.create_variable_for_type_inference()
    rhp = helper.create_variable_for_type_inference()
    out = helper.create_variable_for_type_inference()
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input.name], "HiddenPrev": [hidden.name],
                "Weight": [w.name], "Bias": [b.name]},
        outputs={"Gate": [gate.name], "ResetHiddenPrev": [rhp.name],
                 "Hidden": [out.name]},
        attrs={"activation": activation,
               "gate_activation": gate_activation,
               "origin_mode": origin_mode})
    return out, rhp, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step over raw x_t [B, Din]: fc([x_t, h_prev]) -> 4 gates;
    returns (h, c)."""
    from . import tensor as _t
    d = hidden_t_prev.shape[-1]
    helper = LayerHelper("lstm_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    concat = _t.concat([x_t, hidden_t_prev], axis=1)
    gates = _nn.fc(concat, size=4 * d, param_attr=param_attr,
                   bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference()
    h = helper.create_variable_for_type_inference()
    helper.append_op(type="lstm_unit",
                     inputs={"X": [gates.name],
                             "C_prev": [cell_t_prev.name]},
                     outputs={"C": [c.name], "H": [h.name]},
                     attrs={"forget_bias": float(forget_bias)})
    return h, c


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         param_attr=None, bias_attr=None, seed=-1):
    """A stacked (optionally bidirectional) LSTM over raw input
    [B, T, Din]; init_h/init_c [num_layers*dirs, B, D] (or None for
    zeros). Returns (out [B,T,D*dirs], last_h, last_c each
    [num_layers*dirs, B, D]), composed from fc and the lstm op."""

    def _init_slice(init, idx):
        if init is None:
            return None
        if len(init.shape) == 2:  # single [B, D]
            return init if idx == 0 else None
        s = _nn.slice(init, axes=[0], starts=[idx], ends=[idx + 1])
        return _nn.squeeze(s, [0])

    x = input
    dirs = [False, True] if is_bidirec else [False]
    last_h_list, last_c_list = [], []
    for layer in range(num_layers):
        outs = []
        for d_i, rev in enumerate(dirs):
            idx = layer * len(dirs) + d_i
            proj = _nn.fc(x, size=4 * hidden_size, num_flatten_dims=2,
                          bias_attr=False,
                          name=f"{name or 'lstm'}.l{layer}.{int(rev)}.in")
            h, c = dynamic_lstm(proj, 4 * hidden_size,
                                use_peepholes=False, is_reverse=rev,
                                h_0=_init_slice(init_h, idx),
                                c_0=_init_slice(init_c, idx),
                                name=f"{name or 'lstm'}.l{layer}.{int(rev)}")
            outs.append(h)
            # final step state: last valid step (first row for a reversed
            # loop, since outputs are put back in input order)
            from .sequence import sequence_pool
            pool = "FIRST" if rev else "LAST"
            last_h_list.append(sequence_pool(h, pool))
            last_c_list.append(sequence_pool(c, pool))
        x = _tensor.concat(outs, axis=-1) if is_bidirec else outs[0]
        if dropout_prob and not is_test:
            x = _nn.dropout(x, dropout_prob)
    last_h = _nn.stack(last_h_list, axis=0)
    last_c = _nn.stack(last_c_list, axis=0)
    return x, last_h, last_c


class RNNCell:
    """Base cell: call(inputs, states) -> (outputs, new_states)."""

    def call(self, inputs, states):
        raise NotImplementedError

    def __call__(self, inputs, states):
        return self.call(inputs, states)

    @property
    def state_shape(self):
        raise NotImplementedError

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        shapes = shape or self.state_shape
        if isinstance(shapes, (list, tuple)) and \
                isinstance(shapes[0], (list, tuple)):
            return [self.get_initial_states(batch_ref, s, dtype, init_value)
                    for s in shapes]
        batch = batch_ref.shape[batch_dim_idx]
        if int(batch) < 0:  # dynamic batch: size taken from batch_ref at run
            return _tensor.fill_constant_batch_size_like(
                batch_ref, [-1] + [int(s) for s in shapes], dtype,
                init_value, output_dim_idx=0,
                input_dim_idx=batch_dim_idx)
        return _tensor.fill_constant([int(batch)] + [int(s) for s in shapes],
                                     dtype, init_value)


class GRUCell(RNNCell):
    """GRU over gru_unit (gates [u, r, c], ops/rnn_ops.py)."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation="sigmoid", activation="tanh",
                 origin_mode=False, name="GRUCell"):
        self.hidden_size = hidden_size
        self.param_attr = param_attr
        self.bias_attr = bias_attr
        self.gate_activation = gate_activation
        self.activation = activation
        self.origin_mode = origin_mode
        self.name = name
        self._helper = LayerHelper(name, param_attr=param_attr,
                                   bias_attr=bias_attr)
        self._weight = None
        self._bias = None

    def _params(self):
        d = self.hidden_size
        if self._weight is None:
            self._weight = self._helper.create_parameter(
                self.param_attr, [d, 3 * d], "float32")
            self._bias = self._helper.create_parameter(
                self.bias_attr, [1, 3 * d], "float32", is_bias=True)
        return self._weight, self._bias

    def call(self, inputs, states):
        w, b = self._params()
        x3 = _nn.fc(inputs, size=3 * self.hidden_size,
                    param_attr=self.param_attr, bias_attr=False,
                    name=f"{self.name}.x_proj")
        helper = self._helper
        gate = helper.create_variable_for_type_inference()
        rhp = helper.create_variable_for_type_inference()
        hidden = helper.create_variable_for_type_inference()
        helper.append_op(
            type="gru_unit",
            inputs={"Input": [x3.name], "HiddenPrev": [states.name],
                    "Weight": [w.name], "Bias": [b.name]},
            outputs={"Gate": [gate.name], "ResetHiddenPrev": [rhp.name],
                     "Hidden": [hidden.name]},
            attrs={"gate_activation": self.gate_activation,
                   "activation": self.activation,
                   "origin_mode": self.origin_mode})
        return hidden, hidden

    @property
    def state_shape(self):
        return [self.hidden_size]


class LSTMCell(RNNCell):
    """LSTM cell; states = [h, c]."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation="sigmoid", activation="tanh",
                 forget_bias=1.0, name="LSTMCell"):
        self.hidden_size = hidden_size
        self.param_attr = param_attr
        self.bias_attr = bias_attr
        self.forget_bias = forget_bias
        self.name = name
        self._helper = LayerHelper(name, param_attr=param_attr,
                                   bias_attr=bias_attr)

    def call(self, inputs, states):
        h, c = states
        d = self.hidden_size
        concat = _tensor.concat([inputs, h], axis=1)
        gates = _nn.fc(concat, size=4 * d, param_attr=self.param_attr,
                       bias_attr=self.bias_attr, name=f"{self.name}.gates")
        helper = self._helper
        new_c = helper.create_variable_for_type_inference()
        new_h = helper.create_variable_for_type_inference()
        helper.append_op(
            type="lstm_unit",
            inputs={"X": [gates.name], "C_prev": [c.name]},
            outputs={"C": [new_c.name], "H": [new_h.name]},
            attrs={"forget_bias": float(self.forget_bias)})
        return new_h, [new_h, new_c]

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]


def _flatten(x):
    if isinstance(x, (list, tuple)):
        out = []
        for i in x:
            out.extend(_flatten(i))
        return out
    return [x]


def _pack_as(flat, template):
    it = iter(flat)

    def rec(t):
        if isinstance(t, (list, tuple)):
            return [rec(i) for i in t]
        return next(it)

    return rec(template)


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """Run `cell` over the time dim of `inputs` [B, T, ...] via ONE
    recurrent op. Returns (outputs [B, T, ...], final_states)."""
    prog = default_main_program()
    inputs_list = _flatten(inputs)
    if initial_states is None:
        initial_states = cell.get_initial_states(inputs_list[0])
    init_list = _flatten(initial_states)

    parent = prog.current_block()
    sub = prog._create_block()
    # step vars: one slice of each sequence input, one per state
    step_ins = []
    for i, x in enumerate(inputs_list):
        shape = list(x.shape)
        step_shape = [shape[0]] + shape[2:] if not time_major else \
            [shape[1]] + shape[2:]
        v = sub.create_var(name=unique_name.generate("rnn_step_x"),
                           shape=step_shape, dtype=x.dtype,
                           stop_gradient=True)
        step_ins.append(v)
    step_states = []
    for s in init_list:
        v = sub.create_var(name=unique_name.generate("rnn_step_h"),
                           shape=list(s.shape), dtype=s.dtype,
                           stop_gradient=False)
        step_states.append(v)

    cell_in = _pack_as(step_ins, inputs)
    cell_states = _pack_as(step_states, initial_states)
    out, new_states = cell.call(cell_in, cell_states, **kwargs) if kwargs \
        else cell.call(cell_in, cell_states)
    out_list = _flatten(out)
    new_state_list = _flatten(new_states)
    prog._rollback()

    # params: vars the sub-block reads that live in the parent scope
    local = {v.name for v in step_ins + step_states}
    sub_written = set()
    param_names = []
    for op in sub.ops:
        for n in op.input_names():
            if n not in local and n not in sub_written and \
                    parent.has_var(n) and n not in param_names:
                param_names.append(n)
        for n in op.output_names():
            sub_written.add(n)

    if time_major:  # recurrent op wants [B, T, ...]
        inputs_bt = [_nn.transpose(x, [1, 0] + list(range(2, len(x.shape))))
                     for x in inputs_list]
    else:
        inputs_bt = inputs_list

    helper = LayerHelper("rnn")
    outs = []
    for o in out_list:
        v = parent.create_var(
            name=unique_name.generate("rnn_out"),
            shape=[inputs_bt[0].shape[0], inputs_bt[0].shape[1]] +
            list(o.shape)[1:], dtype=o.dtype, stop_gradient=False)
        outs.append(v)
    finals = []
    for s in new_state_list:
        v = parent.create_var(name=unique_name.generate("rnn_final"),
                              shape=list(s.shape), dtype=s.dtype,
                              stop_gradient=False)
        finals.append(v)

    op_inputs = {"X": [x.name for x in inputs_bt],
                 "Init": [s.name for s in init_list],
                 "Params": param_names}
    if sequence_length is not None:
        op_inputs["SeqLen"] = [sequence_length.name]
    parent.append_op(
        "recurrent",
        inputs=op_inputs,
        outputs={"Out": [o.name for o in outs],
                 "FinalStates": [f.name for f in finals]},
        attrs={"sub_block": sub.idx,
               "x_names": [v.name for v in step_ins],
               "state_names": [v.name for v in step_states],
               "state_out_names": [v.name for v in new_state_list],
               "out_names": [v.name for v in out_list],
               "param_names": param_names,
               "reverse": is_reverse},
        infer_shape=False)

    outputs = _pack_as(outs, out)
    if not isinstance(out, (list, tuple)):
        outputs = outs[0]
    if time_major:
        outputs_l = _flatten(outputs)
        outputs_l = [_nn.transpose(o, [1, 0] + list(range(2, len(o.shape))))
                     for o in outputs_l]
        outputs = _pack_as(outputs_l, out) if isinstance(out, (list, tuple))\
            else outputs_l[0]
    final_states = _pack_as(finals, new_states)
    if not isinstance(new_states, (list, tuple)):
        final_states = finals[0]
    return outputs, final_states


def birnn(cell_fw, cell_bw, inputs, initial_states=None, **kw):
    """initial_states, if given, is a pair (fw_states, bw_states)."""
    init_fw = init_bw = None
    if initial_states is not None:
        init_fw, init_bw = initial_states
    out_fw, st_fw = rnn(cell_fw, inputs, init_fw, **kw)
    out_bw, st_bw = rnn(cell_bw, inputs, init_bw, is_reverse=True, **kw)
    return _tensor.concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

class Decoder:
    """step(time, inputs, states) -> (outputs, next_states, next_inputs,
    finished); initialize(inits) -> (initial_inputs, initial_states,
    finished)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError


class BeamSearchDecoder(Decoder):
    """Batch-dense beam search (ops/rnn_ops.py beam_search): states and
    inputs carry the beam folded into the batch, [batch*beam, ...]."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B*beam, ...] by repeating each row beam times."""
        shape = list(x.shape)
        x = _nn.unsqueeze(x, [1])
        x = _nn.expand(x, [1, beam_size] + [1] * (len(shape) - 1))
        return _nn.reshape(x, [shape[0] * beam_size] + shape[1:])

    def initialize(self, initial_cell_states):
        states = _flatten(initial_cell_states)
        batch = states[0].shape[0]
        tiled = [self.tile_beam_merge_with_batch(s, self.beam_size)
                 for s in states]
        cell_states = _pack_as(tiled, initial_cell_states)
        start = _tensor.fill_constant([batch, self.beam_size], "int64",
                                      self.start_token)
        # scores: beam 0 active (0.0), others -inf so step 1 picks beam 0
        scores = _tensor.fill_constant([batch, self.beam_size], "float32",
                                       -1e9)
        zero_first = _tensor.fill_constant([batch, 1], "float32", 0.0)
        rest = _nn.slice(scores, axes=[1], starts=[1],
                         ends=[self.beam_size])
        scores = _tensor.concat([zero_first, rest], axis=1)
        return start, (cell_states, start, scores)

    def step(self, time, inputs, states):
        cell_states, pre_ids, pre_scores = states
        batch, beam = pre_ids.shape[0], self.beam_size
        ids_flat = _nn.reshape(inputs, [batch * beam])
        emb = self.embedding_fn(ids_flat) if self.embedding_fn else ids_flat
        cell_out, next_cell_states = self.cell(emb, cell_states)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        vocab = logits.shape[-1]
        logp = _nn.log_softmax(logits)
        logp = _nn.reshape(logp, [batch, beam, vocab])
        # accumulate: candidate score = pre_score + logp
        acc = _nn.elementwise_add(
            logp, _nn.reshape(pre_scores, [batch, beam, 1]))

        helper = LayerHelper("beam_search")
        sel_ids = helper.create_variable_for_type_inference("int64")
        sel_scores = helper.create_variable_for_type_inference("float32")
        parent = helper.create_variable_for_type_inference("int32")
        helper.append_op(
            type="beam_search",
            inputs={"pre_ids": [pre_ids.name],
                    "pre_scores": [pre_scores.name],
                    "scores": [acc.name]},
            outputs={"selected_ids": [sel_ids.name],
                     "selected_scores": [sel_scores.name],
                     "parent_idx": [parent.name]},
            attrs={"end_id": self.end_token, "beam_size": beam})

        # reorder cell states by parent beam
        flat_states = _flatten(next_cell_states)
        reordered = [self._reorder(s, parent, batch, beam)
                     for s in flat_states]
        next_cell_states = _pack_as(reordered, next_cell_states)
        from .control_flow import equal
        finished = equal(sel_ids, _tensor.fill_constant(
            [batch, beam], "int64", self.end_token))
        outputs = {"ids": sel_ids, "parents": parent, "scores": sel_scores}
        return outputs, (next_cell_states, sel_ids, sel_scores), sel_ids, \
            finished

    def _reorder(self, s, parent, batch, beam):
        rest = list(s.shape)[1:]
        s_b = _nn.reshape(s, [batch, beam] + rest)
        helper = LayerHelper("beam_reorder")
        out = helper.create_variable_for_type_inference(s.dtype)
        helper.append_op(type="beam_reorder",
                         inputs={"X": [s_b.name], "Index": [parent.name]},
                         outputs={"Out": [out.name]})
        return _nn.reshape(out, [batch * beam] + rest)


def dynamic_decode(decoder, inits=None, max_step_num=64, output_time_major
                   =False, return_length=False, **kwargs):
    """Run decoder.step for max_step_num steps as one recurrent op, then
    backtrack the beams with gather_tree. Returns (ids [B, T, beam],
    scores), plus per-beam lengths when return_length=True."""
    initial_inputs, initial_states = decoder.initialize(inits)

    prog = default_main_program()
    parent = prog.current_block()
    sub = prog._create_block()

    state_list = _flatten(initial_states) + [_flatten(initial_inputs)[0]]
    step_states = []
    for s in state_list:
        v = sub.create_var(name=unique_name.generate("dec_step"),
                           shape=list(s.shape), dtype=s.dtype,
                           stop_gradient=True)
        step_states.append(v)
    *cell_state_vars, input_var = step_states
    cell_states = _pack_as(cell_state_vars, initial_states)

    outputs, next_states, next_inputs, finished = decoder.step(
        None, input_var, cell_states, **kwargs)
    out_list = [outputs["ids"], outputs["parents"], outputs["scores"],
                finished]
    new_state_list = _flatten(next_states) + [next_inputs]
    prog._rollback()

    local = {v.name for v in step_states}
    written = set()
    param_names = []
    for op in sub.ops:
        for n in op.input_names():
            if n not in local and n not in written and parent.has_var(n) \
                    and n not in param_names:
                param_names.append(n)
        for n in op.output_names():
            written.add(n)

    helper = LayerHelper("dynamic_decode")
    # dummy sequence input to give the loop its length: [B, T] zeros.
    # batch comes from initial_inputs [B, beam] — cell states are tiled
    # to [B*beam, D] and would give the wrong leading dim.
    batch = _flatten(initial_inputs)[0].shape[0]
    dummy = _tensor.fill_constant([batch, max_step_num], "float32", 0.0)
    dummy_step = sub.create_var(name=unique_name.generate("dec_t"),
                                shape=[batch], dtype="float32",
                                stop_gradient=True)

    outs = []
    for o in out_list:
        v = parent.create_var(
            name=unique_name.generate("dec_out"),
            shape=[batch, max_step_num] + list(o.shape)[1:], dtype=o.dtype,
            stop_gradient=True)
        outs.append(v)
    finals = [parent.create_var(name=unique_name.generate("dec_final"),
                                shape=list(s.shape), dtype=s.dtype,
                                stop_gradient=True)
              for s in new_state_list]

    parent.append_op(
        "recurrent",
        inputs={"X": [dummy.name],
                "Init": [s.name for s in state_list],
                "Params": param_names},
        outputs={"Out": [o.name for o in outs],
                 "FinalStates": [f.name for f in finals]},
        attrs={"sub_block": sub.idx,
               "x_names": [dummy_step.name],
               "state_names": [v.name for v in step_states],
               "state_out_names": [v.name for v in new_state_list],
               "out_names": [v.name for v in out_list],
               "param_names": param_names,
               "reverse": False},
        infer_shape=False)

    ids_btk, parents_btk, scores_btk, fin_btk = outs
    # gather_tree wants [T, B, beam]
    ids_t = _nn.transpose(ids_btk, [1, 0, 2])
    par_t = _nn.transpose(parents_btk, [1, 0, 2])
    seq = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="gather_tree",
                     inputs={"Ids": [ids_t.name], "Parents": [par_t.name]},
                     outputs={"Out": [seq.name]})
    out_ids = seq if output_time_major else _nn.transpose(seq, [1, 0, 2])
    out_scores = _nn.transpose(scores_btk, [1, 0, 2]) if output_time_major \
        else scores_btk
    if return_length:
        # length per (batch, beam) = #steps not yet finished at step start
        not_fin = _tensor.cast(
            _nn.logical_not(_tensor.cast(fin_btk, "bool")), "int64")
        lengths = _nn.reduce_sum(not_fin, dim=1)
        return out_ids, out_scores, lengths
    return out_ids, out_scores
