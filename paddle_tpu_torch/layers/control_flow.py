"""layers.control_flow — the comparisons, ``increment``, ``is_empty``,
``Print``, the tensor arrays, While, Switch, IfElse, StaticRNN and
DynamicRNN. A body is recorded into a sub-block of the program
(``Program._create_block``) and becomes one op of the enclosing block:
``while``, ``conditional_block`` or ``recurrent``."""
from __future__ import annotations

from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = ["increment", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal", "not_equal", "array_write",
           "array_read", "array_length", "create_array", "While", "Switch",
           "Print", "is_empty", "StaticRNN", "DynamicRNN", "IfElse"]


def increment(x, value=1.0, in_place=True):
    """Out = X + value in X's dtype; in place, Out is X's own var (a step
    counter)."""
    helper = LayerHelper("increment")
    out_name = x.name if in_place else \
        helper.create_variable_for_type_inference(x.dtype).name
    helper.append_op(type="increment", inputs={"X": [x.name]},
                     outputs={"Out": [out_name]},
                     attrs={"step": float(value)})
    return x.block.var(out_name)


def _cmp(op_type):
    def layer(x, y, cond=None):
        """Out = X op Y, a bool var (Y broadcast to X by trailing
        alignment)."""
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_variable_for_type_inference("bool", True)
        helper.append_op(type=op_type,
                         inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [cond.name]})
        return cond
    layer.__name__ = op_type
    return layer


less_than = _cmp("less_than")
less_equal = _cmp("less_equal")
greater_than = _cmp("greater_than")
greater_equal = _cmp("greater_equal")
equal = _cmp("equal")
not_equal = _cmp("not_equal")


def is_empty(x, cond=None):
    """A bool var: whether `x` has no elements."""
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", True)
    helper.append_op(type="is_empty", inputs={"X": [x.name]},
                     outputs={"Out": [cond.name]})
    return cond


def Print(input, message=None, first_n=-1, summarize=-1, **kw):
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="print", inputs={"In": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"message": message or ""})
    return out


def create_array(dtype, max_len=64):
    helper = LayerHelper("array")
    return helper.block.create_var(
        name=helper.name, dtype=dtype, stop_gradient=True,
        lod_level=0)


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    inputs = {"X": [x.name], "I": [i.name]}
    if array.shape is not None:
        inputs["Array"] = [array.name]
    helper.append_op(type="write_to_array", inputs=inputs,
                     outputs={"Out": [array.name]}, attrs={"max_len": 64})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array.name], "I": [i.name]},
                     outputs={"Out": [out.name]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type="lod_array_length", inputs={"X": [array.name]},
                     outputs={"Out": [out.name]})
    return out


class While:
    """A while loop over a sub-block: ``with While(cond).block(): ...``
    records the body; the outer vars the body writes (and the condition)
    are the carried state, which keeps its shapes across iterations. The
    loop reads `cond` on the host before each iteration
    (ops/controlflow.py)."""

    def __init__(self, cond, is_test=False, name=None):
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)
        self._block_ctx = None

    class _BlockGuard:
        def __init__(self, w):
            self.w = w

        def __enter__(self):
            prog = default_main_program()
            self.prog = prog
            self.sub = prog._create_block()
            return self

        def __exit__(self, exc_type, exc, tb):
            if exc_type is not None:
                # leave the program pointing at the parent block even when
                # the body raised, or later ops land in the orphaned sub
                self.prog._rollback()
                return False
            prog = self.prog
            sub = prog.current_block()
            prog._rollback()
            parent = prog.current_block()
            # carried vars: sub-block writes to names visible in parent
            written = []
            read = []
            for op in sub.ops:
                for n in op.input_names():
                    if parent.has_var(n) and n not in read:
                        read.append(n)
                for n in op.output_names():
                    if parent.has_var(n) and n not in written:
                        written.append(n)
            w = self.w
            cond_name = w.cond_var.name
            if cond_name not in read:
                read.append(cond_name)
            carried = sorted(set(written) | {cond_name})
            parent.append_op(
                "while",
                inputs={"X": read},
                outputs={"Out": list(carried)},
                attrs={"sub_block": sub.idx, "condition": cond_name,
                       "carried_vars": list(carried),
                       "input_vars": list(read),
                       "output_vars": list(carried)},
                infer_shape=False)
            return False

    def block(self):
        return While._BlockGuard(self)


class _CondBlockGuard:
    """Record ops into a sub-block, then emit a conditional_block op whose
    outputs are the outer vars the body writes (a skipped block keeps
    their values, which Switch's first match relies on)."""

    def __init__(self, pred):
        self.pred = pred

    def __enter__(self):
        prog = default_main_program()
        self.prog = prog
        self.sub = prog._create_block()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.prog._rollback()
            return False
        prog = self.prog
        sub = prog.current_block()
        prog._rollback()
        parent = prog.current_block()
        read, written = [], []
        for op in sub.ops:
            for n in op.input_names():
                if parent.has_var(n) and n not in read:
                    read.append(n)
            for n in op.output_names():
                if parent.has_var(n) and n not in written:
                    written.append(n)
        parent.append_op(
            "conditional_block",
            inputs={"Cond": [self.pred.name], "Input": read},
            outputs={"Out": written},
            attrs={"sub_block": sub.idx, "input_vars": read,
                   "output_vars": written},
            infer_shape=False)
        return False


class Switch:
    """First-matching-case switch (LR schedules, mostly): each case body
    runs under a conditional_block gated on `cond and no earlier
    match`."""

    def __init__(self, name=None):
        self._matched = None

    def case(self, condition):
        from .nn import logical_and, logical_not
        if self._matched is None:
            pred = condition
            self._matched = condition
        else:
            pred = logical_and(condition, logical_not(self._matched))
            from .nn import logical_or
            self._matched = logical_or(self._matched, condition)
        return _CondBlockGuard(pred)

    def default(self):
        from .nn import logical_not
        assert self._matched is not None, "default() before any case()"
        return _CondBlockGuard(logical_not(self._matched))


class IfElse:
    """Row-wise if/else over a [N, 1] bool condition: both branches run on
    the full batch (static shapes) and their outputs merge row by row by
    the mask, which gives each row its branch's result."""

    def __init__(self, cond, name=None):
        self.cond = cond
        self._outs = {True: [], False: []}
        self._in_branch = None

    class _Branch:
        def __init__(self, ie, flag):
            self.ie, self.flag = ie, flag

        def __enter__(self):
            self.ie._in_branch = self.flag
            return self

        def __exit__(self, *a):
            self.ie._in_branch = None
            return False

    def true_block(self):
        return IfElse._Branch(self, True)

    def false_block(self):
        return IfElse._Branch(self, False)

    def input(self, x):
        return x

    def output(self, *outs):
        assert self._in_branch is not None, "output() outside a branch"
        self._outs[self._in_branch].extend(outs)

    def __call__(self):
        from .math_ops import elementwise_add, elementwise_mul
        from .tensor import cast
        t_outs, f_outs = self._outs[True], self._outs[False]
        assert len(t_outs) == len(f_outs), \
            "both branches must output the same number of vars"
        merged = []
        for tv, fv in zip(t_outs, f_outs):
            m = cast(self.cond, tv.dtype)
            one_minus = elementwise_add(
                elementwise_mul(m, _neg_one(tv.dtype)), _one(tv.dtype))
            merged.append(elementwise_add(elementwise_mul(tv, m),
                                          elementwise_mul(fv, one_minus)))
        return merged


def _one(dtype):
    from .tensor import fill_constant
    return fill_constant([1], dtype, 1.0)


def _neg_one(dtype):
    from .tensor import fill_constant
    return fill_constant([1], dtype, -1.0)


class StaticRNN:
    """Imperative RNN construction: step_input / memory / update_memory /
    step_output inside ``with rnn.step()``, then ``rnn()`` returns the
    stacked outputs. Sequences are time-major [T, B, ...]; the step body
    becomes one `recurrent` op (ops/rnn_ops.py)."""

    def __init__(self, name=None):
        self._seq_inputs = []   # (outer var, step var)
        self._memories = []     # [step var]
        self._mem_updates = {}  # step var name -> new var
        self._outputs = []
        self._sub = None
        self._parent = None

    class _StepGuard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            prog = default_main_program()
            self.rnn._prog = prog
            self.rnn._parent = prog.current_block()
            self.rnn._sub = prog._create_block()
            return self

        def __exit__(self, exc_type, exc, tb):
            if exc_type is not None:
                self.rnn._prog._rollback()
                return False
            self.rnn._prog._rollback()
            self.rnn._emit()
            return False

    def step(self):
        return StaticRNN._StepGuard(self)

    def step_input(self, x):
        from ..framework import unique_name
        shape = list(x.shape)
        v = self._sub.create_var(name=unique_name.generate("srnn_x"),
                                 shape=shape[1:], dtype=x.dtype,
                                 stop_gradient=True)
        self._seq_inputs.append((x, v))
        return v

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1):
        from ..framework import unique_name
        from .tensor import fill_constant
        if init is None:
            assert shape is not None
            blk_cur = default_main_program().current_block()
            # init built in the PARENT block (it feeds the scan carry)
            default_main_program()._current_block_idx = self._parent.idx
            dims = [int(s) if int(s) != -1 else
                    int(batch_ref.shape[ref_batch_dim_idx])
                    for s in shape]
            init = fill_constant(dims, "float32", init_value)
            default_main_program()._current_block_idx = blk_cur.idx
        v = self._sub.create_var(name=unique_name.generate("srnn_mem"),
                                 shape=list(init.shape), dtype=init.dtype,
                                 stop_gradient=False)
        self._memories.append((init, v))
        return v

    def update_memory(self, mem, var):
        self._mem_updates[mem.name] = var

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    _time_major = True  # sequence tensors [T, B, ...]

    def _emit(self):
        from ..framework import unique_name
        parent, sub = self._parent, self._sub
        local = {v.name for _, v in self._seq_inputs} | \
            {v.name for _, v in self._memories}
        written, param_names = set(), []
        for op in sub.ops:
            for n in op.input_names():
                if n not in local and n not in written and \
                        parent.has_var(n) and n not in param_names:
                    param_names.append(n)
            for n in op.output_names():
                written.add(n)
        self._result_vars = []
        seq_shape = list(self._seq_inputs[0][0].shape) if self._seq_inputs \
            else [None, None]
        for o in self._outputs:
            if self._time_major:
                shape = [seq_shape[0]] + list(o.shape)
            else:
                shape = [seq_shape[0], seq_shape[1]] + list(o.shape)[1:]
            v = parent.create_var(name=unique_name.generate("rnn_out"),
                                  shape=shape, dtype=o.dtype,
                                  stop_gradient=False)
            self._result_vars.append(v)
        finals = [parent.create_var(name=unique_name.generate("rnn_final"),
                                    shape=list(v.shape), dtype=v.dtype,
                                    stop_gradient=False)
                  for _, v in self._memories]
        state_out = [self._mem_updates[v.name].name
                     for _, v in self._memories]
        parent.append_op(
            "recurrent",
            inputs={"X": [x.name for x, _ in self._seq_inputs],
                    "Init": [i.name for i, _ in self._memories],
                    "Params": param_names},
            outputs={"Out": [v.name for v in self._result_vars],
                     "FinalStates": [f.name for f in finals]},
            attrs={"sub_block": sub.idx,
                   "x_names": [v.name for _, v in self._seq_inputs],
                   "state_names": [v.name for _, v in self._memories],
                   "state_out_names": state_out,
                   "out_names": [o.name for o in self._outputs],
                   "param_names": param_names,
                   "reverse": False, "time_major": self._time_major},
            infer_shape=False)

    def __call__(self):
        if len(self._result_vars) == 1:
            return self._result_vars[0]
        return self._result_vars


class DynamicRNN(StaticRNN):
    """StaticRNN over batch-major [B, T, ...] (padded) inputs; per-row
    lengths, if any, are the caller's to mask (sequence_mask over the
    outputs). block() aliases step()."""

    _time_major = False

    def block(self):
        return self.step()

    def step_input(self, x, level=0):
        from ..framework import unique_name
        shape = list(x.shape)
        v = self._sub.create_var(name=unique_name.generate("drnn_x"),
                                 shape=[shape[0]] + shape[2:], dtype=x.dtype,
                                 stop_gradient=True)
        self._seq_inputs.append((x, v))
        return v
