"""Recurrent ops: ``recurrent`` (a sub-block run once per time step),
the GRU and LSTM cells and sequence ops, and the beam-search ops.

Every sequence loop is a host loop over the time steps, each step a few
batched products on the card (the JAX package's is one ``lax.scan``).
Under the executor's autograd record (core/lowering.py) the whole
unrolled loop is one graph, which the op's one ``grad::generic``
differentiates. An op inside a recurrent body draws from its one
generator at every step, as the scan folds one key. With lengths, a
padded step carries the state through unchanged. Shape inference
(``meta`` tensors) runs one step and widens it to T, so a dynamic T
costs one step there.

Batch-dense beam search: beams ride in the batch as [batch, beam, ...];
``beam_search`` picks the top `beam` of beam * V candidates by a stable
descending sort (ties go to the lower index, as ``lax.top_k`` breaks
them).
"""
from __future__ import annotations

import torch

from ..core.registry import register_op

_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": lambda x: x, "": lambda x: x}


def _act(name):
    return _ACT[name if isinstance(name, str) else "sigmoid"]


def _steps(ctx, t, reverse=False):
    """The time indices a loop visits: all T in order (or reversed), or
    on meta tensors only the first (shape inference widens it)."""
    idx = range(t - 1, -1, -1) if reverse else range(t)
    return idx[:1] if ctx.device.type == "meta" else idx


def _stack_time(outs, t, reverse):
    """Per-step outputs (in visiting order) -> [T, ...] in time order."""
    if len(outs) == 1 and t != 1:  # meta: one step stands for T
        return outs[0].unsqueeze(0).expand((t,) + tuple(outs[0].shape))
    if reverse:
        outs = outs[::-1]
    return torch.stack(outs)


def _keep_valid(i, lens, new, old):
    """new where step i is inside the row's length, else old."""
    if lens is None:
        return new
    valid = (i < lens).reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(valid, new, old)


@register_op("recurrent")
def _recurrent(ctx, ins, attrs):
    """Run the sub-block over time. X: sequence inputs [B, T, ...] (or
    time-major); Init: initial states; Params: outer vars the body
    reads. attrs: x_names (the step var of each X), state_names (of each
    Init), state_out_names (the var the body writes for each state),
    out_names (per-step outputs to stack), param_names, reverse,
    time_major. SeqLen [B]: padded steps carry the states through."""
    block = ctx.sub_block(attrs["sub_block"])
    x_names = attrs.get("x_names", [])
    state_names = attrs.get("state_names", [])
    state_out = attrs.get("state_out_names", [])
    out_names = attrs.get("out_names", [])
    reverse = attrs.get("reverse", False)
    time_major = attrs.get("time_major", False)
    params = dict(zip(attrs.get("param_names", []), ins.get("Params", [])))
    lens = ins["SeqLen"][0].reshape(-1) if "SeqLen" in ins else None
    # one slice a step by unbind: its backward stacks the step gradients
    # once, where indexing would add each into a zero tensor of the input
    xs_t = [x.unbind(0 if time_major else 1) for x in ins.get("X", [])]
    t = len(xs_t[0])
    states = list(ins.get("Init", []))
    per_step = [[] for _ in out_names]
    for i in _steps(ctx, t, reverse):
        env = dict(params)
        env.update(zip(x_names, (x[i] for x in xs_t)))
        env.update(zip(state_names, states))
        ctx.lower_sub_block(block, env)
        states = [_keep_valid(i, lens, env[n], o)
                  for n, o in zip(state_out, states)]
        for acc, n in zip(per_step, out_names):
            acc.append(env[n])
    stacked = [_stack_time(o, t, reverse) for o in per_step]
    if not time_major:
        stacked = [o.movedim(0, 1) for o in stacked]
    return {"Out": stacked, "FinalStates": states}


def _gru_step(x3, h_prev, weight, bias, gate_act, cand_act, origin_mode):
    """x3 [B, 3D] pre-projected; weight [D, 3D] ([:, :2D] the update and
    reset gates, [:, 2D:] the candidate). Returns (gate, r * h_prev, h)."""
    d = h_prev.shape[-1]
    if bias is not None:
        x3 = x3 + bias.reshape(1, 3 * d)
    g2 = x3[:, :2 * d] + h_prev @ weight[:, :2 * d]
    u = gate_act(g2[:, :d])
    r = gate_act(g2[:, d:])
    rhp = r * h_prev
    c = cand_act(x3[:, 2 * d:] + rhp @ weight[:, 2 * d:])
    if origin_mode:
        h = c + u * (h_prev - c)      # (1 - u) * c + u * h_prev
    else:
        h = u * (c - h_prev) + h_prev  # u * c + (1 - u) * h_prev
    return torch.cat([u, r, c], dim=1), rhp, h


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """One GRU step. Input [B, 3D] (pre-projected) plus Bias [1, 3D],
    HiddenPrev [B, D], Weight [D, 3D]. h = u * c + (1 - u) * h_prev, or
    with `origin_mode` u * h_prev + (1 - u) * c. Gate is [u, r, c]."""
    gate, rhp, h = _gru_step(
        ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0],
        ins["Bias"][0] if "Bias" in ins else None,
        _act(attrs.get("gate_activation", "sigmoid")),
        _act(attrs.get("activation", "tanh")),
        attrs.get("origin_mode", False))
    return {"Gate": [gate], "ResetHiddenPrev": [rhp], "Hidden": [h]}


@register_op("gru", nondiff_inputs=("Lengths",))
def _gru(ctx, ins, attrs):
    """dynamic_gru: Input [B, T, 3D] (pre-projected), Weight [D, 3D],
    optional H0 [B, D], Bias [1, 3D], Lengths [B]; Hidden [B, T, D]."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    b = ins["Bias"][0] if "Bias" in ins else None
    bsz, t = x.shape[0], x.shape[1]
    h = ins["H0"][0] if "H0" in ins else \
        torch.zeros((bsz, w.shape[0]), dtype=x.dtype, device=x.device)
    lens = ins["Lengths"][0].reshape(-1) if "Lengths" in ins else None
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cand_act = _act(attrs.get("activation", "tanh"))
    origin = attrs.get("origin_mode", False)
    reverse = attrs.get("is_reverse", False)
    hs, xs = [], x.unbind(1)
    for i in _steps(ctx, t, reverse):
        _, _, h_new = _gru_step(xs[i], h, w, b, gate_act, cand_act,
                                origin)
        h = _keep_valid(i, lens, h_new, h)
        hs.append(h)
    return {"Hidden": [_stack_time(hs, t, reverse).movedim(0, 1)]}


@register_op("lstm", nondiff_inputs=("Lengths",))
def _lstm(ctx, ins, attrs):
    """dynamic_lstm: Input [B, T, 4D] pre-projected in gate order
    [c~, i, f, o], Weight [P, 4D], Bias [1, 4D] (or [1, 7D] with the
    peepholes i, f, o), optional H0/C0, Lengths. With ProjWeight [D, P]
    it is dynamic_lstmp: the recurrent state is the projection
    proj_act((o * act(c)) @ ProjWeight)."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    proj = ins["ProjWeight"][0] if "ProjWeight" in ins else None
    d = w.shape[1] // 4
    bsz, t = x.shape[0], x.shape[1]
    b = ins["Bias"][0].reshape(-1) if "Bias" in ins else None
    ci = cf = co = None
    if b is not None:
        x = x + b[:4 * d].reshape(1, 1, 4 * d)
        if attrs.get("use_peepholes", True) and b.shape[0] >= 7 * d:
            ci, cf, co = b[4 * d:5 * d], b[5 * d:6 * d], b[6 * d:7 * d]
    hdim = proj.shape[1] if proj is not None else d
    h = ins["H0"][0] if "H0" in ins else \
        torch.zeros((bsz, hdim), dtype=x.dtype, device=x.device)
    c = ins["C0"][0] if "C0" in ins else \
        torch.zeros((bsz, d), dtype=x.dtype, device=x.device)
    lens = ins["Lengths"][0].reshape(-1) if "Lengths" in ins else None
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cell_act = _act(attrs.get("cell_activation", "tanh"))
    cand_act = _act(attrs.get("candidate_activation", "tanh"))
    proj_act = _act(attrs.get("proj_activation", "identity"))
    reverse = attrs.get("is_reverse", False)
    hs, cs, xs = [], [], x.unbind(1)
    for i in _steps(ctx, t, reverse):
        g = xs[i] + h @ w
        cand = cand_act(g[:, :d])
        gi = g[:, d:2 * d] if ci is None else g[:, d:2 * d] + c * ci
        gf = g[:, 2 * d:3 * d] if cf is None else g[:, 2 * d:3 * d] + c * cf
        c_new = cand * gate_act(gi) + c * gate_act(gf)
        go = g[:, 3 * d:] if co is None else g[:, 3 * d:] + c_new * co
        h_new = gate_act(go) * cell_act(c_new)
        if proj is not None:
            h_new = proj_act(h_new @ proj)
        h = _keep_valid(i, lens, h_new, h)
        c = _keep_valid(i, lens, c_new, c)
        hs.append(h)
        cs.append(c)
    return {"Hidden": [_stack_time(hs, t, reverse).movedim(0, 1)],
            "Cell": [_stack_time(cs, t, reverse).movedim(0, 1)]}


@register_op("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """One LSTM step: X [B, 4D] pre-projected in gate order [i, f, o, c~],
    C_prev [B, D]; returns C and H."""
    x = ins["X"][0]
    c_prev = ins["C_prev"][0]
    d = c_prev.shape[-1]
    i = torch.sigmoid(x[:, :d])
    f = torch.sigmoid(x[:, d:2 * d] + attrs.get("forget_bias", 0.0))
    o = torch.sigmoid(x[:, 2 * d:3 * d])
    c = f * c_prev + i * torch.tanh(x[:, 3 * d:])
    return {"C": [c], "H": [o * torch.tanh(c)]}


# ---------------------------------------------------------------------------
# beam search (batch-dense: [batch, beam, ...])
# ---------------------------------------------------------------------------

@register_op("beam_search", nondiff_inputs=("pre_ids", "pre_scores", "ids"),
             nondiff_outputs=("selected_ids", "parent_idx"))
def _beam_search(ctx, ins, attrs):
    """One beam step. pre_ids, pre_scores [B, beam]; scores [B, beam, V]
    the accumulated log-probs of every extension. The top `beam` of
    beam * V per batch row; a finished beam (pre_id == end_id) offers
    one candidate, end_id at its pre_score."""
    pre_ids = ins["pre_ids"][0]
    pre_scores = ins["pre_scores"][0]
    scores = ins["scores"][0]
    end_id = attrs.get("end_id", 0)
    bsz, beam, vocab = scores.shape
    frozen = torch.full_like(scores, -1e9)
    frozen[:, :, end_id] = pre_scores.to(scores.dtype)
    cand = torch.where((pre_ids == end_id)[:, :, None], frozen, scores)
    top_scores, top_idx = torch.sort(cand.reshape(bsz, beam * vocab),
                                     dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :beam], top_idx[:, :beam]
    return {"selected_ids": [(top_idx % vocab).to(pre_ids.dtype)],
            "selected_scores": [top_scores],
            "parent_idx": [(top_idx // vocab).to(torch.int32)]}


@register_op("beam_reorder", nondiff_inputs=("Index",))
def _beam_reorder(ctx, ins, attrs):
    """X [B, beam, ...] gathered along the beam dim by Index [B, beam]."""
    x, idx = ins["X"][0], ins["Index"][0].long()
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2)).expand(
        tuple(idx.shape) + tuple(x.shape[2:]))
    return {"Out": [x.gather(1, idx)]}


@register_op("gather_tree", nondiff_inputs=("Ids", "Parents"),
             nondiff_outputs=("Out",))
def _gather_tree(ctx, ins, attrs):
    """Backtrack the beam parents: Ids, Parents [T, B, beam] -> the full
    sequences [T, B, beam], walking back from the last step."""
    ids, parents = ins["Ids"][0], ins["Parents"][0]
    t = ids.shape[0]
    beam_idx = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:])
    toks = []
    for i in range(t - 1, -1, -1):
        toks.append(ids[i].gather(-1, beam_idx))
        beam_idx = parents[i].gather(-1, beam_idx).long()
    return {"Out": [torch.stack(toks[::-1])]}


@register_op("beam_search_decode", nondiff_inputs=("Ids", "Scores"),
             nondiff_outputs=("SentenceIds", "SentenceScores"))
def _beam_search_decode(ctx, ins, attrs):
    """Ids already backtracked (gather_tree) pass through with Scores."""
    return {"SentenceIds": [ins["Ids"][0]],
            "SentenceScores": [ins["Scores"][0]]}
