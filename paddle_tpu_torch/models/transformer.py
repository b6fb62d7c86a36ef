"""Transformer encoder — BERT-base and its kin — and its training
programs.

Built from the layers API exactly as the JAX package builds it, so the
two packages produce the same programs (op types, attrs and parameter
names), forward and training alike, the Megatron-style tensor- and
sequence-parallel shard hints included (``tp``/``sp``): the q/k/v and
FFN-in products' outputs are pinned [dp, None, tp], the heads
[dp, tp, None, None], and with ``sp`` the activations between blocks
[dp, sp, None]. A model-parallel run (parallel/model_parallel.py) turns
them into this rank's program.
"""
from __future__ import annotations

import math

from .. import layers
from ..framework import ParamAttr
from ..initializer import Normal
from ..ops.attention import FLASH_AUTO_MIN_SEQ


class TransformerConfig:
    def __init__(self, vocab_size=30522, d_model=768, n_heads=12,
                 n_layers=12, d_ff=3072, max_seq_len=512, dropout=0.1,
                 tp=False, sp=False, dp_axis="dp", tp_axis="tp",
                 sp_axis="sp", use_flash="auto", causal=False,
                 attn_dropout=None, flash_block_q=None, flash_block_k=None):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.d_ff = d_ff
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.tp = tp
        self.sp = sp
        # "auto" writes block_q=0 below FLASH_AUTO_MIN_SEQ, which routes
        # the op to the plain path: a serving config that should run the
        # kernel passes use_flash=True
        if use_flash == "auto":
            use_flash = max_seq_len >= FLASH_AUTO_MIN_SEQ
        self.use_flash = use_flash
        self.flash_block_q = flash_block_q
        self.flash_block_k = flash_block_k
        self.causal = causal
        self.attn_dropout = dropout if attn_dropout is None else \
            attn_dropout
        # mesh axis names the hints refer to; Megatron-style sequence
        # parallelism shards the sequence over the tp group
        # (sp_axis=tp_axis)
        self.dp_axis = dp_axis
        self.tp_axis = tp_axis
        self.sp_axis = sp_axis


def bert_base(**kw):
    return TransformerConfig(**kw)


def bert_large(**kw):
    """24 layers, d 1024, 16 heads, d_ff 4096."""
    kw.setdefault("d_model", 1024)
    kw.setdefault("n_heads", 16)
    kw.setdefault("n_layers", 24)
    kw.setdefault("d_ff", 4096)
    return TransformerConfig(**kw)


def transformer_big(**kw):
    """Transformer-big's encoder at NMT scale: vocab 32000, 6 layers,
    d 1024, 16 heads, d_ff 4096."""
    kw.setdefault("vocab_size", 32000)
    kw.setdefault("d_model", 1024)
    kw.setdefault("n_heads", 16)
    kw.setdefault("n_layers", 6)
    kw.setdefault("d_ff", 4096)
    return TransformerConfig(**kw)


def _dense(x, size, name, cfg, act=None, tp_axis=None):
    """fc; a column-parallel one (tp_axis="col") pins its output's last
    dim over the tp axis when cfg.tp."""
    out = layers.fc(x, size=size, num_flatten_dims=2, act=act,
                    param_attr=ParamAttr(name=f"{name}.w",
                                         initializer=Normal(0.0, 0.02)),
                    bias_attr=ParamAttr(name=f"{name}.b"))
    if cfg.tp and tp_axis == "col":
        out = layers.shard_hint(out, [cfg.dp_axis, None, cfg.tp_axis])
    return out


def _flash_block_attrs(cfg):
    """block_q/block_k kwargs for layers.flash_attention: 0/0 forces the
    exact plain path when flash is off; explicit config tiles are
    recorded; otherwise none."""
    if not cfg.use_flash:
        return {"block_q": 0, "block_k": 0}
    kw = {}
    if cfg.flash_block_q is not None:
        kw["block_q"] = int(cfg.flash_block_q)
    if cfg.flash_block_k is not None:
        kw["block_k"] = int(cfg.flash_block_k)
    return kw


def _attention(x, cfg, prefix):
    b, t, d = x.shape[0], x.shape[1], cfg.d_model
    h = cfg.n_heads
    hd = d // h
    q = _dense(x, d, f"{prefix}.q", cfg, tp_axis="col")
    k = _dense(x, d, f"{prefix}.k", cfg, tp_axis="col")
    v = _dense(x, d, f"{prefix}.v", cfg, tp_axis="col")

    def split_heads(z):
        z = layers.reshape(z, [b, t, h, hd])
        return layers.transpose(z, [0, 2, 1, 3])  # [b, h, t, hd]

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if cfg.tp:
        q = layers.shard_hint(q, [cfg.dp_axis, cfg.tp_axis, None, None])
        k = layers.shard_hint(k, [cfg.dp_axis, cfg.tp_axis, None, None])
        v = layers.shard_hint(v, [cfg.dp_axis, cfg.tp_axis, None, None])
    ctxv = layers.flash_attention(
        q, k, v, causal=cfg.causal, sm_scale=1.0 / math.sqrt(hd),
        attn_dropout=cfg.attn_dropout, **_flash_block_attrs(cfg))
    ctxv = layers.transpose(ctxv, [0, 2, 1, 3])
    ctxv = layers.reshape(ctxv, [b, t, d])
    return _dense(ctxv, d, f"{prefix}.proj", cfg, tp_axis="row")


def _ffn(x, cfg, prefix):
    h = _dense(x, cfg.d_ff, f"{prefix}.fc1", cfg, act="gelu",
               tp_axis="col")
    return _dense(h, cfg.d_model, f"{prefix}.fc2", cfg, tp_axis="row")


def _block(x, cfg, i):
    att = _attention(x, cfg, f"layer_{i}.att")
    if cfg.dropout:
        att = layers.dropout(att, cfg.dropout,
                             dropout_implementation="upscale_in_train")
    x = layers.layer_norm(layers.elementwise_add(x, att),
                          begin_norm_axis=2,
                          param_attr=ParamAttr(name=f"layer_{i}.ln1.w"),
                          bias_attr=ParamAttr(name=f"layer_{i}.ln1.b"))
    ff = _ffn(x, cfg, f"layer_{i}.ffn")
    if cfg.dropout:
        ff = layers.dropout(ff, cfg.dropout,
                            dropout_implementation="upscale_in_train")
    x = layers.layer_norm(layers.elementwise_add(x, ff), begin_norm_axis=2,
                          param_attr=ParamAttr(name=f"layer_{i}.ln2.w"),
                          bias_attr=ParamAttr(name=f"layer_{i}.ln2.b"))
    if cfg.sp:
        x = layers.shard_hint(x, [cfg.dp_axis, cfg.sp_axis, None])
    return x


def encoder(tokens, cfg: TransformerConfig):
    """tokens: int64 [batch, seq]. Returns hidden states [b, t, d]."""
    emb = layers.embedding(
        tokens, size=[cfg.vocab_size, cfg.d_model],
        param_attr=ParamAttr(name="word_emb",
                             initializer=Normal(0.0, 0.02)))
    x = layers.add_position_encoding(emb, alpha=1.0, beta=1.0)
    if cfg.dropout:
        x = layers.dropout(x, cfg.dropout,
                           dropout_implementation="upscale_in_train")
    if cfg.sp:
        x = layers.shard_hint(x, [cfg.dp_axis, cfg.sp_axis, None])
    for i in range(cfg.n_layers):
        x = _block(x, cfg, i)
    return x


def lm_logits(hidden, cfg: TransformerConfig):
    """LM head projection to vocab logits."""
    return layers.fc(hidden, size=cfg.vocab_size, num_flatten_dims=2,
                     param_attr=ParamAttr(name="lm_head.w",
                                          initializer=Normal(0.0, 0.02)),
                     bias_attr=False)


def lm_loss(hidden, labels, cfg: TransformerConfig, logits=None):
    """LM head projection + per-token softmax CE, averaged. Pass
    precomputed `logits` to avoid a second head projection."""
    if logits is None:
        logits = lm_logits(hidden, cfg)
    # single -1: robust to dynamic batch/time dims (sliced inputs)
    logits2 = layers.reshape(logits, [-1, cfg.vocab_size])
    labels2 = layers.reshape(labels, [-1, 1])
    loss = layers.softmax_with_cross_entropy(logits2, labels2)
    return layers.mean(loss)


def build_train(cfg: TransformerConfig, batch, seq_len, lr=1e-4,
                optimizer_cls=None, amp=False):
    """Full training graph (LM loss at every position, AdamW); returns
    (loss, feed vars). amp=True runs the products and attention in bf16
    through the mixed-precision rewrite (contrib/)."""
    from .. import optimizer as opt
    tokens = layers.data("tokens", shape=[batch, seq_len], dtype="int64",
                         append_batch_size=False)
    labels = layers.data("labels", shape=[batch, seq_len], dtype="int64",
                         append_batch_size=False)
    hidden = encoder(tokens, cfg)
    loss = lm_loss(hidden, labels, cfg)
    optimizer_cls = optimizer_cls or opt.AdamW
    opt_inst = optimizer_cls(learning_rate=lr)
    if amp:
        from ..contrib import mixed_precision as mp
        opt_inst = mp.decorate(opt_inst)
    opt_inst.minimize(loss)
    return loss, [tokens, labels]


def build_train_mlm(cfg: TransformerConfig, batch, seq_len, n_mask,
                    lr=1e-4, optimizer_cls=None, amp=False):
    """BERT-style masked-LM pretraining graph: the vocab projection and
    softmax CE run only at the `n_mask` masked positions per sequence,
    gathered through `mask_pos`.

    Feeds: tokens [b, T] int64; mask_pos [b*n_mask] int32 (flattened
    row-major indices into [b*T]); mask_label [b*n_mask, 1] int64.
    """
    from .. import optimizer as opt
    tokens = layers.data("tokens", shape=[batch, seq_len], dtype="int64",
                         append_batch_size=False)
    mask_pos = layers.data("mask_pos", shape=[batch * n_mask],
                           dtype="int32", append_batch_size=False)
    mask_label = layers.data("mask_label", shape=[batch * n_mask, 1],
                             dtype="int64", append_batch_size=False)
    hidden = encoder(tokens, cfg)
    flat = layers.reshape(hidden, [-1, cfg.d_model])
    picked = layers.gather(flat, mask_pos)
    logits = layers.fc(picked, size=cfg.vocab_size,
                       param_attr=ParamAttr(name="lm_head.w",
                                            initializer=Normal(0.0, 0.02)),
                       bias_attr=False)
    loss = layers.mean(layers.softmax_with_cross_entropy(
        logits, mask_label))
    optimizer_cls = optimizer_cls or opt.AdamW
    opt_inst = optimizer_cls(learning_rate=lr)
    if amp:
        from ..contrib import mixed_precision as mp
        opt_inst = mp.decorate(opt_inst)
    opt_inst.minimize(loss)
    return loss, [tokens, mask_pos, mask_label]
