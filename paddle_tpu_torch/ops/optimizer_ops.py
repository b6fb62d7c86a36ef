"""Optimizer update ops: sgd, momentum, lars_momentum, adam, adamw,
adamax, adagrad, decayed_adagrad, adadelta, rmsprop, ftrl, lamb,
proximal_gd, proximal_adagrad, dpsgd and average_accumulates.

Each op consumes Param and its accumulators and writes *Out slots that
name the same vars. Where the JAX package donates the state buffers to
XLA, the port updates the Scope's tensors in place (the executor runs
training programs under ``torch.no_grad()``), so a step allocates no
second copy of the parameters or moments. Each update evaluates the
JAX package's expression in the same order.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


@register_op("sgd", inplace=True)
def _sgd(ctx, ins, attrs):
    # p -= lr * g
    p = ins["Param"][0]
    p.sub_(_lr(ins) * ins["Grad"][0])
    return {"ParamOut": [p]}


@register_op("momentum", inplace=True)
def _momentum(ctx, ins, attrs):
    # v = mu * v + g; p -= lr * v, or with Nesterov p -= (g + mu * v) * lr
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    v.mul_(mu).add_(g)
    if attrs.get("use_nesterov", False):
        p.sub_((g + mu * v) * lr)
    else:
        p.sub_(lr * v)
    return {"ParamOut": [p], "VelocityOut": [v]}


def _adam_step(ins, attrs):
    """Adam's moment and beta-power updates, in place. Returns (the
    update step lr_t * m / (sqrt(v) + eps), the base learning rate, the
    outputs)."""
    g = ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p_t, b2p_t = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1p, b2p = b1p_t.reshape(()), b2p_t.reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    base_lr = _lr(ins)
    lr = base_lr * torch.sqrt(1 - b2p) / (1 - b1p)
    m1.mul_(b1).add_((1 - b1) * g)
    m2.mul_(b2).add_((1 - b2) * g * g)
    step = lr * m1 / (torch.sqrt(m2) + eps)
    b1p_t.mul_(b1)
    b2p_t.mul_(b2)
    return step, base_lr, {
        "ParamOut": [ins["Param"][0]], "Moment1Out": [m1],
        "Moment2Out": [m2], "Beta1PowOut": [b1p_t], "Beta2PowOut": [b2p_t]}


@register_op("adam", inplace=True)
def _adam(ctx, ins, attrs):
    step, _, outs = _adam_step(ins, attrs)
    ins["Param"][0].sub_(step)
    return outs


@register_op("adamw", inplace=True)
def _adamw(ctx, ins, attrs):
    # decoupled weight decay: p -= lr_t * m / (sqrt(v) + eps) + lr * wd * p
    p = ins["Param"][0]
    step, base_lr, outs = _adam_step(ins, attrs)
    p.copy_(p - step - base_lr * attrs.get("coeff", 0.01) * p)
    return outs


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x)))


@register_op("lars_momentum", inplace=True)
def _lars_momentum(ctx, ins, attrs):
    # local_lr = lr * coeff * |p| / (|g| + decay * |p| + 1e-12)
    # v = mu * v + local_lr * (g + decay * p); p -= v
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    pn, gn = _norm(p), _norm(g)
    local_lr = _lr(ins) * coeff * pn / (gn + decay * pn + 1e-12)
    v.mul_(mu).add_(local_lr * (g + decay * p))
    p.sub_(v)
    return {"ParamOut": [p], "VelocityOut": [v]}


@register_op("adamax", inplace=True)
def _adamax(ctx, ins, attrs):
    # m = b1 * m + (1 - b1) * g; inf = max(b2 * inf, |g|)
    # p -= lr / (1 - beta1_pow) * m / (inf + eps); beta1_pow is scaled by
    # a scale op after the update
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m.mul_(b1).add_((1 - b1) * g)
    torch.maximum(inf.mul_(b2), torch.abs(g), out=inf)
    lr = _lr(ins) / (1 - b1p)
    p.sub_(lr * m / (inf + eps))
    return {"ParamOut": [p], "MomentOut": [m], "InfNormOut": [inf]}


@register_op("adagrad", inplace=True)
def _adagrad(ctx, ins, attrs):
    # m += g * g; p -= lr * g / (sqrt(m) + eps)
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    m.add_(g * g)
    p.sub_(_lr(ins) * g / (torch.sqrt(m) + eps))
    return {"ParamOut": [p], "MomentOut": [m]}


@register_op("decayed_adagrad", inplace=True)
def _decayed_adagrad(ctx, ins, attrs):
    # m = decay * m + (1 - decay) * g * g; p -= lr * g / (sqrt(m) + eps)
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m.mul_(decay).add_((1 - decay) * g * g)
    p.sub_(_lr(ins) * g / (torch.sqrt(m) + eps))
    return {"ParamOut": [p], "MomentOut": [m]}


@register_op("adadelta", inplace=True)
def _adadelta(ctx, ins, attrs):
    # sg = rho * sg + (1 - rho) * g * g
    # upd = -sqrt((su + eps) / (sg + eps)) * g
    # su = rho * su + (1 - rho) * upd * upd; p += upd
    p, g = ins["Param"][0], ins["Grad"][0]
    sg, su = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    sg.mul_(rho).add_((1 - rho) * g * g)
    upd = -torch.sqrt((su + eps) / (sg + eps)) * g
    su.mul_(rho).add_((1 - rho) * upd * upd)
    p.add_(upd)
    return {"ParamOut": [p], "AvgSquaredGradOut": [sg],
            "AvgSquaredUpdateOut": [su]}


@register_op("rmsprop", inplace=True)
def _rmsprop(ctx, ins, attrs):
    # ms = decay * ms + (1 - decay) * g * g; centered: mg = decay * mg +
    # (1 - decay) * g and the denominator ms - mg^2 + eps, else ms + eps
    # mom = mu * mom + lr * g * rsqrt(denominator); p -= mom
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-10)
    decay = attrs.get("decay", 0.9)
    mu = attrs.get("momentum", 0.0)
    ms.mul_(decay).add_((1 - decay) * g * g)
    outs = {"MeanSquareOut": [ms]}
    if attrs.get("centered", False):
        mg = ins["MeanGrad"][0]
        mg.mul_(decay).add_((1 - decay) * g)
        denom = ms - mg * mg + eps
        outs["MeanGradOut"] = [mg]
    else:
        denom = ms + eps
    mom.mul_(mu).add_(_lr(ins) * g * torch.rsqrt(denom))
    p.sub_(mom)
    outs["MomentOut"] = [mom]
    outs["ParamOut"] = [p]
    return outs


@register_op("ftrl", inplace=True)
def _ftrl(ctx, ins, attrs):
    # the JAX package's FTRL-proximal step; the shrink denominator carries
    # twice l2, as Fluid's ftrl_op.h does
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + g * g
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
        x = 2.0 * l2 + torch.sqrt(new_sq) / lr
    else:
        sigma = (torch.pow(new_sq, -lr_power)
                 - torch.pow(sq, -lr_power)) / lr
        x = 2.0 * l2 + torch.pow(new_sq, -lr_power) / lr
    lin.add_(g).sub_(sigma * p)
    pre = torch.clamp(lin, -l1, l1) - lin
    p.copy_(pre / x)
    sq.copy_(new_sq)
    return {"ParamOut": [p], "SquaredAccumOut": [sq],
            "LinearAccumOut": [lin]}


@register_op("lamb", inplace=True)
def _lamb(ctx, ins, attrs):
    # m1, m2 as Adam's; r = m1 / (sqrt(m2) + eps) + wd * p with no bias
    # correction (Fluid's lamb_op.h; the beta powers round-trip through
    # state unused); p -= lr * (|p| / |r|) * r, the trust ratio 1 where
    # either norm is 0
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p_t, b2p_t = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m1.mul_(b1).add_((1 - b1) * g)
    m2.mul_(b2).add_((1 - b2) * g * g)
    r = m1 / (torch.sqrt(m2) + eps) + wd * p
    pn, rn = _norm(p), _norm(r)
    trust = torch.where((pn > 0) & (rn > 0), pn / rn, torch.ones_like(pn))
    p.sub_(_lr(ins) * trust * r)
    b1p_t.mul_(b1)
    b2p_t.mul_(b2)
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
            "Beta1PowOut": [b1p_t], "Beta2PowOut": [b2p_t]}


def _proximal(prox, lr, l1, l2):
    # soft-threshold by lr * l1, then shrink by 1 + lr * l2
    if l1 > 0:
        prox = torch.sign(prox) * torch.clamp(
            torch.abs(prox) - lr * l1, min=0.0)
    return prox / (1.0 + lr * l2)


@register_op("proximal_gd", inplace=True)
def _proximal_gd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins)
    p.copy_(_proximal(p - lr * g, lr, attrs.get("l1", 0.0),
                      attrs.get("l2", 0.0)))
    return {"ParamOut": [p]}


@register_op("proximal_adagrad", inplace=True)
def _proximal_adagrad(ctx, ins, attrs):
    # m += g * g; the step's rate lr * rsqrt(m + 1e-12)
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    m.add_(g * g)
    lr = _lr(ins) * torch.rsqrt(m + 1e-12)
    p.copy_(_proximal(p - lr * g, lr, attrs.get("l1", 0.0),
                      attrs.get("l2", 0.0)))
    return {"ParamOut": [p], "MomentOut": [m]}


@register_op("dpsgd", inplace=True, stateful=True)
def _dpsgd(ctx, ins, attrs):
    # g clipped to norm `clip`, plus sigma * clip * N(0, 1) noise from the
    # op's own generator (not threefry's bits: equal to the JAX package's
    # only at sigma 0, and by distribution otherwise)
    p, g = ins["Param"][0], ins["Grad"][0]
    clip = attrs.get("clip", 10.0)
    sigma = attrs.get("sigma", 1.0)
    g = g * torch.clamp(clip / (_norm(g) + 1e-12), max=1.0)
    noise = sigma * clip * ctx.randn(tuple(g.shape)).to(g.dtype)
    p.sub_(_lr(ins) * (g + noise))
    return {"ParamOut": [p]}


@register_op("average_accumulates", inplace=True)
def _average_accumulates(ctx, ins, attrs):
    """ModelAverage's accumulators (Fluid's average_accumulates_op.h):
    sum1 += param each step; every 16384 updates sum1 rolls into sum2;
    when the window saturates (num_accumulates >= min_window and >=
    min(max_window, num_updates * average_window)) the sums roll into
    sum3 and the window restarts. The counters keep their own dtype; the
    window cap is the JAX package's int32 one."""
    p = ins["Param"][0]
    s1, s2, s3 = ins["InSum1"][0], ins["InSum2"][0], ins["InSum3"][0]
    na_t = ins["InNumAccumulates"][0]
    na = na_t.reshape(()).long()
    ona = ins["InOldNumAccumulates"][0].reshape(()).long() \
        if "InOldNumAccumulates" in ins else torch.zeros_like(na)
    nu = ins["InNumUpdates"][0].reshape(()).long() \
        if "InNumUpdates" in ins else na
    aw = attrs.get("average_window", 0.0)
    maxw = min(int(attrs.get("max_average_window", 2 ** 31 - 1)),
               2 ** 31 - 1)
    minw = attrs.get("min_average_window", 10000)
    nu1, na1 = nu + 1, na + 1
    # each branch reads the already-updated sum1 (= s1 + param), as the
    # reference's aliased accumulators do
    o1 = s1 + p
    roll = (nu1 % 16384) == 0
    o2 = torch.where(roll, s2 + o1, s2)
    o1 = torch.where(roll, torch.zeros_like(o1), o1)
    thr = torch.floor(nu1.float() * torch.tensor(aw, dtype=torch.float32)
                      + torch.tensor(1e-3, dtype=torch.float32)).long()
    win = (na1 >= minw) & (na1 >= torch.clamp(thr, max=maxw))
    o3 = torch.where(win, o1 + o2, s3)
    o1 = torch.where(win, torch.zeros_like(o1), o1)
    o2 = torch.where(win, torch.zeros_like(o2), o2)

    def count(x):
        return x.reshape(na_t.shape).to(na_t.dtype)
    return {"OutSum1": [o1], "OutSum2": [o2], "OutSum3": [o3],
            "OutNumAccumulates": [count(torch.where(
                win, torch.zeros_like(na1), na1))],
            "OutOldNumAccumulates": [count(torch.where(win, na1, ona))],
            "OutNumUpdates": [count(nu1)]}
