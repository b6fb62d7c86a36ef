"""Loss and metric ops of Appendix A: robust losses, CTC, the linear-chain
CRF, sampled softmax and ranking metrics.

They keep the JAX package's padded formulation: sequences are [B, T, ...]
with per-row `Length` / `LogitsLength`, labels padded with -1, and the CRF
transition [n + 2, n] with row 0 the start and row 1 the stop weights.
The recursions (CTC's alpha, the CRF's forward algorithm, Viterbi and its
backtrace, the edit distance's rows) run as a loop over T of batched
tensor ops on the device, with no host sync a step, as the JAX package's
`lax.scan`s do; gradients come from autograd through them, as
`grad::generic` differentiates the scans. chunk_eval is host bookkeeping
in the JAX package too (an io_callback), and runs on the host here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.registry import register_op

NEG = -1e30


def _steps(x, n, start=1):
    """Steps start..n-1 of a recursion; one on the meta device, where T
    may be the dynamic-dim stand-in and only the shapes are wanted."""
    return range(start, min(n, start + 1) if x.device.type == "meta"
                 else n)


def _neg(like, shape=None):
    return torch.full(like.shape if shape is None else shape, NEG,
                      dtype=like.dtype, device=like.device)


@register_op("modified_huber_loss", nondiff_inputs=("Y",))
def _modified_huber(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]  # y in {0, 1}
    z = x * (2.0 * y - 1.0)
    loss = torch.where(z >= -1.0, torch.square(torch.clamp(1.0 - z, min=0.0)),
                       -4.0 * z)
    return {"Out": [loss], "IntermediateVal": [z]}


@register_op("sigmoid_focal_loss", nondiff_inputs=("Label", "FgNum"))
def _sigmoid_focal_loss(ctx, ins, attrs):
    """X [N, C] logits, Label [N] in [0, C] (0 the background: no class
    is a target), normalised by max(FgNum, 1)."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).long()
    fg = torch.clamp(ins["FgNum"][0].reshape(()).to(x.dtype), min=1.0)
    gamma = attrs.get("gamma", 2.0)
    alpha = attrs.get("alpha", 0.25)
    classes = torch.arange(x.shape[1], device=x.device)
    target = (label[:, None] - 1) == classes[None, :]
    p = torch.sigmoid(x)
    ce = torch.logaddexp(x.new_zeros(()), torch.where(target, -x, x))
    p_t = torch.where(target, p, 1.0 - p)
    a_t = torch.where(target, alpha, 1.0 - alpha)
    return {"Out": [a_t * torch.pow(1.0 - p_t, gamma) * ce / fg]}


@register_op("teacher_student_sigmoid_loss", nondiff_inputs=("Label",))
def _ts_sigmoid_loss(ctx, ins, attrs):
    """The label encodes a click and a teacher score
    (teacher_student_sigmoid_loss_op.h:43-62): < -1 no click, no score;
    [-1, 0) a click, no score; [0, 1) no click, score = label; >= 1 a
    click, score = label - 1. With sp = softplus(x) the two scored
    branches are both 2 sp - x label."""
    x, label = ins["X"][0], ins["Label"][0]
    sp = torch.logaddexp(x.new_zeros(()), x)
    out = torch.where(label < -1.0, sp,
                      torch.where(label < 0.0, sp - x, 2.0 * sp - x * label))
    return {"Y": [out]}


class _Cvm(torch.autograd.Function):
    """cvm_op.h: forward CvmComputeKernel, backward CvmGradComputeKernel
    (the show/click columns take their gradient from the CVM input)."""

    @staticmethod
    def forward(ctx, x, cvm, use_cvm):
        ctx.save_for_backward(cvm)
        ctx.use_cvm = use_cvm
        if use_cvm:
            y0 = torch.log(x[:, :1] + 1.0)
            y1 = torch.log(x[:, 1:2] + 1.0) - y0
            return torch.cat([y0, y1, x[:, 2:]], dim=1)
        return x[:, 2:].clone()

    @staticmethod
    def backward(ctx, gy):
        cvm, = ctx.saved_tensors
        rest = gy[:, 2:] if ctx.use_cvm else gy
        return torch.cat([cvm[:, :2].to(gy.dtype), rest], dim=1), None, None


@register_op("cvm", nondiff_inputs=("CVM",))
def _cvm(ctx, ins, attrs):
    """continuous_value_model: use_cvm keeps every column with the two
    leading show/click columns log-transformed (y0 = log(x0 + 1),
    y1 = log(x1 + 1) - y0); without it they are dropped."""
    return {"Y": [_Cvm.apply(ins["X"][0], ins["CVM"][0],
                             bool(attrs.get("use_cvm", True)))]}


@register_op("positive_negative_pair",
             nondiff_inputs=("Score", "Label", "QueryID"),
             nondiff_outputs=("PositivePair", "NegativePair", "NeutralPair"))
def _pnpair(ctx, ins, attrs):
    score = ins["Score"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1)
    qid = ins["QueryID"][0].reshape(-1)
    valid = (qid[:, None] == qid[None, :]) & torch.ones(
        len(qid), len(qid), dtype=torch.bool, device=qid.device).triu(1)
    ds = score[:, None] - score[None, :]
    dl = label[:, None] - label[None, :]

    def count(m):
        return (valid & m).sum().to(torch.float32).reshape(1)
    return {"PositivePair": [count(ds * dl > 0)],
            "NegativePair": [count(ds * dl < 0)],
            "NeutralPair": [count((dl != 0) & (ds == 0))]}


# ---------------------------------------------------------------------------
# the CTC family
# ---------------------------------------------------------------------------

def ctc_loss(logp, labels, blank, lengths):
    """-log p(labels | logits) per row by the alpha recursion, batched.
    logp [B, T, C] log-softmax; labels [B, L] padded with -1; lengths
    [B] true steps (a padded step emits nothing: alpha is frozen)."""
    b, t_len, _ = logp.shape
    n_lab = labels.shape[1]
    dev = logp.device
    ext = torch.full((b, 2 * n_lab + 1), blank, dtype=torch.long,
                     device=dev)
    ext[:, 1::2] = labels.clamp(min=0)
    n_ext = 2 * (labels >= 0).sum(1) + 1
    skip_ok = torch.zeros_like(ext, dtype=torch.bool)
    skip_ok[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    emit0 = torch.gather(logp[:, 0], 1, ext)
    alpha = _neg(emit0)
    alpha[:, 0] = logp[:, 0, blank]
    alpha[:, 1] = torch.where(n_ext > 1, emit0[:, 1], alpha[:, 1])
    neg1, neg2 = _neg(alpha, (b, 1)), _neg(alpha, (b, 2))
    for t in _steps(logp, t_len):
        prev1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        prev2 = torch.where(skip_ok, torch.cat([neg2, alpha[:, :-2]], 1),
                            NEG)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        emit = torch.gather(logp[:, t], 1, ext)
        alpha = torch.where((t < lengths)[:, None], merged + emit, alpha)
    last = torch.gather(alpha, 1, (n_ext - 1)[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, (n_ext - 2).clamp(min=0)[:, None])[:, 0]
    last2 = torch.where(n_ext > 1, last2, NEG)
    return -torch.logaddexp(last, last2)


@register_op("warpctc", nondiff_inputs=("Label", "LogitsLength",
                                        "LabelLength"))
def _warpctc(ctx, ins, attrs):
    """CTC loss (warpctc_op) over padded Logits [B, T, C] (or one
    sequence [T, C]) and Label [B, L] padded with -1; LogitsLength [B]
    are the true steps, LabelLength re-pads labels past their length.
    Loss [B, 1] in the logits' dtype (computed in float32);
    WarpCTCGrad, as in the JAX package, holds zeros."""
    logits = ins["Logits"][0]
    labels = ins["Label"][0].long()
    blank = attrs.get("blank", 0)
    if logits.dim() == 2:
        logits, labels = logits[None], labels.reshape(1, -1)
    b, t = logits.shape[0], logits.shape[1]
    if "LogitsLength" in ins:
        lengths = ins["LogitsLength"][0].reshape(-1).long()
    else:
        lengths = torch.full((b,), t, dtype=torch.long, device=logits.device)
    if "LabelLength" in ins:
        lab_len = ins["LabelLength"][0].reshape(-1).long()
        pos = torch.arange(labels.shape[1], device=labels.device)
        labels = torch.where(pos[None, :] < lab_len[:, None], labels, -1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    losses = ctc_loss(logp, labels, blank, lengths)
    if attrs.get("norm_by_times", False):
        losses = losses / lengths.clamp(min=1).to(losses.dtype)
    return {"Loss": [losses.reshape(-1, 1).to(logits.dtype)],
            "WarpCTCGrad": [torch.zeros_like(logits)]}


@register_op("ctc_align", nondiff_inputs=("Input",),
             nondiff_outputs=("Output",))
def _ctc_align(ctx, ins, attrs):
    """Greedy CTC decode of [B, T] argmax ids: merge repeats, drop
    blanks, left-align, pad with -1 (ctc_align_op)."""
    x = ins["Input"][0].long()
    blank = attrs.get("blank", 0)
    prev = torch.cat([torch.full_like(x[:, :1], -1), x[:, :-1]], dim=1)
    keep = (x != blank) & (x != prev)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    got = torch.gather(x, 1, order)
    kept = torch.gather(keep, 1, order)
    return {"Output": [torch.where(kept, got, -1)]}


@register_op("edit_distance", nondiff_inputs=("Hyps", "Refs"),
             nondiff_outputs=("Out", "SequenceNum"))
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance per row of -1-padded id sequences
    (edit_distance_op), on the device: one row of the table a hyp
    position, batched, each row by a cumulative min (an insertion chain
    row[j] = min_k c[k] + j - k) instead of the JAX package's inner
    scan; normalised by the reference length."""
    hyps = ins["Hyps"][0].long()
    refs = ins["Refs"][0].long()
    norm = attrs.get("normalized", True)
    b, l2 = refs.shape
    lh = (hyps >= 0).sum(1)
    lr = (refs >= 0).sum(1)
    idx = torch.arange(l2 + 1, dtype=torch.float32, device=refs.device)
    row = idx.expand(b, l2 + 1)
    for i in _steps(refs, hyps.shape[1], start=0):
        cost = (hyps[:, i:i + 1] != refs).to(torch.float32)
        c = torch.cat([torch.full((b, 1), i + 1.0, device=refs.device),
                       torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + cost)],
                      dim=1)
        new = torch.cummin(c - idx, dim=1).values + idx
        row = torch.where((i < lh)[:, None], new, row)
    d = torch.gather(row, 1, lr[:, None])[:, 0]
    if norm:
        d = torch.where(lr > 0, d / lr.clamp(min=1).to(d.dtype), d)
    return {"Out": [d.reshape(-1, 1)],
            "SequenceNum": [torch.tensor([b], dtype=torch.long,
                                         device=refs.device)]}


# ---------------------------------------------------------------------------
# the linear-chain CRF (linear_chain_crf_op.cc) and Viterbi decoding
# ---------------------------------------------------------------------------

def _lengths(ins, b, t, device):
    if "Length" in ins:
        return ins["Length"][0].reshape(-1).long()
    return torch.full((b,), t, dtype=torch.long, device=device)


def crf_log_norm(em, trans, lengths):
    """log Z per row by the forward algorithm: em [B, T, n], trans
    [n + 2, n]; steps t >= length leave alpha as it was."""
    start, stop, pair = trans[0], trans[1], trans[2:]
    a = start + em[:, 0]
    for t in _steps(em, em.shape[1]):
        nxt = torch.logsumexp(a[:, :, None] + pair, dim=1) + em[:, t]
        a = torch.where((t < lengths)[:, None], nxt, a)
    return torch.logsumexp(a + stop, dim=1)


def crf_path_score(em, trans, label, lengths):
    """The score of each row's label path (start + emissions +
    transitions + stop), batched."""
    b, t, _ = em.shape
    start, stop, pair = trans[0], trans[1], trans[2:]
    lab = label.clamp(min=0)
    rows = torch.arange(b, device=em.device)
    emit = torch.gather(em, 2, lab[:, :, None])[:, :, 0]
    steps = pair[lab[:, :-1], lab[:, 1:]] + emit[:, 1:]
    valid = torch.arange(1, t, device=em.device)[None, :] < lengths[:, None]
    last = (lengths - 1).clamp(0, t - 1)
    return (start[lab[:, 0]] + emit[:, 0]
            + torch.where(valid, steps, 0.0).sum(1)
            + stop[lab[rows, last]])


@register_op("linear_chain_crf", nondiff_inputs=("Label", "Length"))
def _linear_chain_crf(ctx, ins, attrs):
    """Emission [B, T, n], Label [B, T], Length [B] (default T):
    LogLikelihood [B, 1] = log Z - path score, in float32; Alpha reads
    zeros, EmissionExps and TransitionExps the exps, as the JAX package
    returns them."""
    em = ins["Emission"][0].float()
    trans = ins["Transition"][0].float()
    label = ins["Label"][0].long()
    if em.dim() == 2:
        em = em[None]
    b, t, _ = em.shape
    label = label.reshape(b, t)
    lengths = _lengths(ins, b, t, em.device)
    ll = crf_log_norm(em, trans, lengths) - \
        crf_path_score(em, trans, label, lengths)
    return {"LogLikelihood": [ll.reshape(-1, 1)],
            "Alpha": [torch.zeros_like(em)],
            "EmissionExps": [torch.exp(em)],
            "TransitionExps": [torch.exp(trans)]}


def viterbi(em, trans, lengths):
    """The best tag path per row [B, T]; steps past a row's length carry
    alpha through with identity back-pointers, so the backtrace starts
    at the row's last valid step. Ties go to the lowest tag (argmax's
    first maximum), as in the JAX package."""
    b, t, n = em.shape
    if em.device.type == "meta":
        return torch.empty((b, t), dtype=torch.long, device=em.device)
    start, stop, pair = trans[0], trans[1], trans[2:]
    a = start + em[:, 0]
    ident = torch.arange(n, device=em.device).expand(b, n)
    back = []
    for s in range(1, t):
        best, bp = torch.max(a[:, :, None] + pair + em[:, s, None, :], dim=1)
        valid = (s < lengths)[:, None]
        a = torch.where(valid, best, a)
        back.append(torch.where(valid, bp, ident))
    tag = torch.argmax(a + stop, dim=1)
    path = [tag]
    for bp in reversed(back):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return torch.stack(path[::-1], dim=1)


@register_op("crf_decoding", nondiff_inputs=("Label", "Length"),
             nondiff_outputs=("ViterbiPath",))
def _crf_decoding(ctx, ins, attrs):
    """Length-aware Viterbi (crf_decoding_op): ViterbiPath [B, T] int64,
    or with Label, 1 where the path equals the label and 0 elsewhere."""
    em = ins["Emission"][0].float()
    trans = ins["Transition"][0].float()
    if em.dim() == 2:
        em = em[None]
    b, t, _ = em.shape
    path = viterbi(em, trans, _lengths(ins, b, t, em.device))
    if "Label" in ins:
        label = ins["Label"][0].reshape(b, -1).long()
        return {"ViterbiPath": [(path == label).long()]}
    return {"ViterbiPath": [path]}


# ---------------------------------------------------------------------------
# the sampled softmax family
# ---------------------------------------------------------------------------

@register_op("nce", nondiff_inputs=("Label", "SampleWeight",
                                    "CustomDistProbs", "CustomDistAlias",
                                    "CustomDistAliasProbs"))
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation with uniform negatives: the true
    class and `num_neg_samples` classes drawn from the op's generator
    (the reference draws with jax.random, so the draws differ), scored
    by Input · Weight[id] + Bias[id] less log q, under the logistic loss
    with the true class positive. Cost [B, 1], SampleLogits [B, 1 + n],
    SampleLabels (the ids) [B, 1 + n]."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    label = ins["Label"][0].reshape(-1).long()
    n_neg = attrs.get("num_neg_samples", 10)
    total = attrs.get("num_total_classes", w.shape[0])
    batch = x.shape[0]
    neg = torch.randint(0, total, (batch, n_neg), generator=ctx.generator,
                        device=x.device)
    ids = torch.cat([label[:, None], neg], dim=1)
    logits = torch.einsum("bd,bkd->bk", x, w[ids])
    if "Bias" in ins:
        logits = logits + ins["Bias"][0].reshape(-1)[ids]
    adj = logits - torch.tensor(math.log(n_neg / total), dtype=logits.dtype,
                                device=x.device)
    labels01 = torch.zeros_like(adj)
    labels01[:, 0] = 1.0
    loss = torch.sum(torch.logaddexp(adj.new_zeros(()), adj)
                     - adj * labels01, dim=1)
    return {"Cost": [loss.reshape(-1, 1)], "SampleLogits": [logits],
            "SampleLabels": [ids]}


@register_op("sample_logits", nondiff_inputs=("Labels",))
def _sample_logits(ctx, ins, attrs):
    """sampled_softmax_with_cross_entropy's front half (sample_logits_op):
    the true and `num_samples` uniformly drawn logits (drawn from the
    op's generator: the JAX package's jax.random draws differ), a drawn
    class equal to a true one pushed to -1e30, less log q."""
    logits = ins["Logits"][0]
    labels = ins["Labels"][0].long()
    n_samp = attrs.get("num_samples", 10)
    b, n = logits.shape
    nt = labels.shape[1]
    samples = torch.randint(0, n, (b, n_samp), generator=ctx.generator,
                            device=logits.device)
    ids = torch.cat([labels, samples], dim=1)
    picked = torch.gather(logits, 1, ids)
    if attrs.get("remove_accidental_hits", True):
        hit = (samples[:, None, :] == labels[:, :, None]).any(1)
        picked = torch.cat([picked[:, :nt],
                            picked[:, nt:] + torch.where(hit, NEG, 0.0)], 1)
    picked = picked - math.log(n_samp / n)
    dev = logits.device
    return {"SampledLogits": [picked],
            "SampledLabels": [torch.arange(nt, device=dev).expand(b, nt)
                              .contiguous()],
            "Samples": [ids],
            "Probabilities": [torch.full_like(picked, 1.0 / n)],
            "LogitsDim": [torch.tensor(logits.shape, device=dev)],
            "LabelsDim": [torch.tensor(labels.shape, device=dev)]}


# ---------------------------------------------------------------------------
# chunk_eval (chunk_eval_op.h): host bookkeeping
# ---------------------------------------------------------------------------

_CHUNK_SCHEMES = {
    # scheme -> (tag types, begin, inside, end, single); chunk_eval_op.h
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def chunk_segments(seq, n_types, ntt, tb, ti, te, ts):
    """The GetSegments state machine (chunk_eval_op.h:41-108): the
    (begin, end inclusive, type) chunks of one tag sequence; the O tag
    is type n_types."""
    other = n_types

    def chunk_end(pt, pty, t, ty):
        if pty == other:
            return False
        if ty == other or ty != pty:
            return True
        if pt == tb or pt == ti:
            return t == tb or t == ts
        return pt == te or pt == ts

    def chunk_begin(pt, pty, t, ty):
        if pty == other:
            return ty != other
        if ty == other:
            return False
        if ty != pty:
            return True
        if t == tb or t == ts:
            return True
        if t == ti or t == te:
            return pt == te or pt == ts
        return False

    segs = []
    start, in_chunk = 0, False
    tag, typ = -1, other
    for i, v in enumerate(int(x) for x in seq):
        pt, pty = tag, typ
        tag, typ = v % ntt, v // ntt
        if in_chunk and chunk_end(pt, pty, tag, typ):
            segs.append((start, i - 1, pty))
            in_chunk = False
        if chunk_begin(pt, pty, tag, typ):
            start, in_chunk = i, True
    if in_chunk:
        segs.append((start, len(seq) - 1, typ))
    return segs


@register_op("chunk_eval", nondiff_inputs=("Inference", "Label", "SeqLength"),
             nondiff_outputs=("Precision", "Recall", "F1-Score",
                              "NumInferChunks", "NumLabelChunks",
                              "NumCorrectChunks"))
def _chunk_eval(ctx, ins, attrs):
    """Chunk precision, recall and F1 (IOB, IOE, IOBES, plain) with
    excluded_chunk_types and the padded SeqLength path. The JAX package
    runs this bookkeeping on the host (io_callback); so does the port:
    it reads the tags to the host, and the six [1] outputs go back to
    the inputs' device, the counts int32 as the JAX package's."""
    inf = ins["Inference"][0]
    dev = inf.device
    names = ("Precision", "Recall", "F1-Score", "NumInferChunks",
             "NumLabelChunks", "NumCorrectChunks")
    if dev.type == "meta":
        return {n: [torch.empty(1, dtype=torch.float32 if k < 3
                                else torch.int32, device=dev)]
                for k, n in enumerate(names)}
    inf = inf.detach().cpu().numpy().reshape(inf.shape[0], -1)
    lab = ins["Label"][0].detach().cpu().numpy().reshape(inf.shape[0], -1)
    n_types = attrs.get("num_chunk_types", 1)
    scheme = _CHUNK_SCHEMES[attrs.get("chunk_scheme", "IOB")]
    excluded = set(attrs.get("excluded_chunk_types", []) or [])
    if "SeqLength" in ins:
        lengths = ins["SeqLength"][0].detach().cpu().numpy().reshape(-1)
    else:
        lengths = np.full(inf.shape[0], inf.shape[1])
    ic = lc = cc = 0
    for row_i, row_l, ln in zip(inf, lab, lengths):
        a = chunk_segments(row_i[:int(ln)], n_types, *scheme)
        b = chunk_segments(row_l[:int(ln)], n_types, *scheme)
        ic += sum(1 for s in a if s[2] not in excluded)
        lc += sum(1 for s in b if s[2] not in excluded)
        cc += sum(1 for s in set(a) & set(b) if s[2] not in excluded)
    p = cc / ic if ic else 0.0
    r = cc / lc if lc else 0.0
    f = 2 * p * r / (p + r) if cc else 0.0

    return {n: [torch.tensor([v], dtype=torch.float32 if k < 3
                             else torch.int32, device=dev)]
            for k, (n, v) in enumerate(zip(names, (p, r, f, ic, lc, cc)))}
