"""LR schedules as graph ops over a persistent step counter.

The JAX package's ``layers/learning_rate_scheduler.py``, op for op: each
schedule builds ops that compute the LR var from the one shared
``@STEP_COUNTER@`` (incremented once a step, before any forward op), so
the rate updates inside the step program and the programs stay
byte-identical. ``piecewise_decay`` and ``linear_lr_warmup`` select
through ``sign`` masks: at a step exactly on a boundary the mask reads
0.5 and the rate is the mean of the two sides, as in the JAX package.
"""
from __future__ import annotations

import math

from ..framework import default_main_program, unique_name
from ..layer_helper import LayerHelper
from .control_flow import equal
from .math_ops import elementwise_div, elementwise_min, elementwise_mod
from .tensor import cast, create_global_var, fill_constant

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "cosine_decay", "linear_lr_warmup", "autoincreased_step_counter",
           "every_n_steps"]


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Persistable int64 counter incremented once per executed step,
    starting from `begin - step`; one var per name, shared by every
    schedule of the program."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    blk = default_main_program().global_block()
    if blk.has_var(name):
        return blk.var(name)
    counter = create_global_var([1], begin - step, "int64", persistable=True,
                                name=name)
    blk.append_op("increment", inputs={"X": [counter.name]},
                  outputs={"Out": [counter.name]}, attrs={"step": float(step)},
                  infer_shape=False)
    counter.stop_gradient = True
    return counter


def every_n_steps(n, counter_name=None):
    """Bool var true once every n executed steps (counter starts at 1, so
    fires at steps n, 2n, ...). Shared trigger for gradient merge /
    LocalSGD-style periodic ops."""
    step = autoincreased_step_counter(
        counter_name=counter_name or unique_name.generate("@EVERY_N_STEP@"))
    n_var = fill_constant([1], "int64", n)
    zero = fill_constant([1], "int64", 0)
    return equal(elementwise_mod(step, n_var), zero)


def _fstep():
    return cast(autoincreased_step_counter(), "float32")


def _unary_attr(x, op, **attrs):
    helper = LayerHelper(op)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op, inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _fstep()
    exponent = step * (1.0 / decay_steps)
    if staircase:
        exponent = _unary_attr(exponent, "floor")
    return _pow_const(decay_rate, exponent) * float(learning_rate)


def _pow_const(base, exponent_var):
    # base ** e = exp(e * ln(base))
    return _unary_attr(exponent_var * float(math.log(base)), "exp")


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _fstep()
    div = step * (1.0 / decay_steps)
    if staircase:
        div = _unary_attr(div, "floor")
    return _unary_attr(div * (-decay_rate), "exp") * float(learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _fstep()
    div = step * (1.0 / decay_steps)
    if staircase:
        div = _unary_attr(div, "floor")
    denom = div * decay_rate + 1.0
    helper = LayerHelper("inverse_time_decay")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="reciprocal", inputs={"X": [denom.name]},
                     outputs={"Out": [out.name]})
    return out * float(learning_rate)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _fstep()
    if cycle:
        # Fluid's polynomial_decay with cycle: the
        # horizon stretches to decay_steps * ceil(step / decay_steps)
        # (>= 1 cycle) so the rate saw-tooths instead of flat-lining
        mult = _unary_attr(step * (1.0 / float(decay_steps)), "ceil")
        mult = _unary_attr(mult, "clip", min=1.0, max=1e30)
        frac = elementwise_div(step, mult * float(decay_steps))
    else:
        clipped = _unary_attr(step, "clip", min=0.0,
                              max=float(decay_steps))
        frac = clipped * (1.0 / decay_steps)
    one_minus = frac * -1.0 + 1.0
    poly = _unary_attr(one_minus, "pow", factor=float(power))
    return poly * float(learning_rate - end_learning_rate) + \
        float(end_learning_rate)


def piecewise_decay(boundaries, values):
    """lr = Σ values[i] * 1[b_{i-1} <= step < b_i] — branch-free masks
    instead of conditional blocks; 0.5 of each side at a boundary."""
    step = _fstep()
    bounds = [0.0] + [float(b) for b in boundaries] + [float("1e30")]
    lr = None
    for i, v in enumerate(values):
        lo = _unary_attr(step, "scale", scale=1.0, bias=-bounds[i])
        lo_mask = cast(_unary_attr(lo, "sign"), "float32")
        lo_mask = lo_mask * 0.5 + 0.5  # 1 if step>=lo else 0 (0.5 at ==)
        hi = _unary_attr(step, "scale", scale=-1.0, bias=bounds[i + 1])
        hi_mask = cast(_unary_attr(hi, "sign"), "float32")
        hi_mask = hi_mask * 0.5 + 0.5
        seg = lo_mask * hi_mask * float(v)
        lr = seg if lr is None else lr + seg
    return lr


def noam_decay(d_model, warmup_steps):
    step = _fstep()
    a = _unary_attr(step, "pow", factor=-0.5)
    b = step * float(warmup_steps ** -1.5)
    mn = elementwise_min(a, b)
    return mn * float(d_model ** -0.5)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _fstep()
    epoch = _unary_attr(step * (1.0 / step_each_epoch), "floor")
    inner = _unary_attr(epoch * (math.pi / epochs), "cos")
    return (inner + 1.0) * (learning_rate * 0.5)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _fstep()
    frac = _unary_attr(step * (1.0 / warmup_steps), "clip", min=0.0, max=1.0)
    warm = frac * float(end_lr - start_lr) + float(start_lr)
    if not isinstance(learning_rate, (int, float)):
        # after warmup follow the wrapped schedule: select by mask
        done = _unary_attr(step * (1.0 / warmup_steps) - 1.0, "sign")
        done = cast(done, "float32") * 0.5 + 0.5
        return warm * (done * -1.0 + 1.0) + learning_rate * done
    done_mask_lr = float(learning_rate)
    done = _unary_attr(step * (1.0 / warmup_steps) - 1.0, "sign")
    done = cast(done, "float32") * 0.5 + 0.5
    return warm * (done * -1.0 + 1.0) + done * done_mask_lr
