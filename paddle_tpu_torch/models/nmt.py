"""Transformer-big En-De NMT: an encoder-decoder with cross-attention
(bench.py's `build_transformer_bench`).

Built from the layers API as the JAX package builds it, so the two
packages produce the same programs. Self-attention takes the flash
kernels (the encoder's unmasked, the decoder's causal); cross-attention
takes the exact plain path (block_q=0), since its query and key lengths
differ. The tensor- and sequence-parallel hints are transformer.py's.
"""
from __future__ import annotations

import math

from .. import layers
from ..framework import ParamAttr
from ..initializer import Normal
from .transformer import TransformerConfig, _dense, _flash_block_attrs


def transformer_big_nmt(**kw):
    """Transformer-big: 6+6 layers, d_model 1024, 16 heads, d_ff 4096."""
    kw.setdefault("vocab_size", 32000)
    kw.setdefault("d_model", 1024)
    kw.setdefault("n_heads", 16)
    kw.setdefault("n_layers", 6)
    kw.setdefault("d_ff", 4096)
    return TransformerConfig(**kw)


def _split_heads(z, b, t, h, hd):
    z = layers.reshape(z, [b, t, h, hd])
    return layers.transpose(z, [0, 2, 1, 3])  # [b, h, t, hd]


def _mha(q_in, kv_in, cfg, prefix, causal):
    """Multi-head attention; q_in [b, tq, d], kv_in [b, tk, d].
    Self-attention (q_in is kv_in) takes the flash op's kernels;
    cross-attention the exact plain path (block_q=0)."""
    b, tq = q_in.shape[0], q_in.shape[1]
    tk = kv_in.shape[1]
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    q = _dense(q_in, d, f"{prefix}.q", cfg, tp_axis="col")
    k = _dense(kv_in, d, f"{prefix}.k", cfg, tp_axis="col")
    v = _dense(kv_in, d, f"{prefix}.v", cfg, tp_axis="col")
    q = _split_heads(q, b, tq, h, hd)
    k = _split_heads(k, b, tk, h, hd)
    v = _split_heads(v, b, tk, h, hd)
    if cfg.tp:
        q = layers.shard_hint(q, [cfg.dp_axis, cfg.tp_axis, None, None])
        k = layers.shard_hint(k, [cfg.dp_axis, cfg.tp_axis, None, None])
        v = layers.shard_hint(v, [cfg.dp_axis, cfg.tp_axis, None, None])
    if cfg.use_flash and q_in is kv_in:
        blk = _flash_block_attrs(cfg)
    else:
        blk = {"block_q": 0, "block_k": 0}
    ctx = layers.flash_attention(
        q, k, v, causal=causal, sm_scale=1.0 / math.sqrt(hd),
        attn_dropout=cfg.attn_dropout, **blk)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [b, tq, d])
    return _dense(ctx, d, f"{prefix}.proj", cfg, tp_axis="row")


def _residual_ln(x, sub, cfg, name):
    if cfg.dropout:
        sub = layers.dropout(sub, cfg.dropout,
                             dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(x, sub),
                             begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"{name}.w"),
                             bias_attr=ParamAttr(name=f"{name}.b"))


def _ffn(x, cfg, prefix):
    hdn = _dense(x, cfg.d_ff, f"{prefix}.fc1", cfg, act="relu",
                 tp_axis="col")
    return _dense(hdn, cfg.d_model, f"{prefix}.fc2", cfg, tp_axis="row")


def _embed(tokens, cfg, name):
    emb = layers.embedding(
        tokens, size=[cfg.vocab_size, cfg.d_model],
        param_attr=ParamAttr(name=name, initializer=Normal(0.0, 0.02)))
    emb = layers.scale(emb, scale=math.sqrt(cfg.d_model))
    x = layers.add_position_encoding(emb, alpha=1.0, beta=1.0)
    if cfg.dropout:
        x = layers.dropout(x, cfg.dropout,
                           dropout_implementation="upscale_in_train")
    if cfg.sp:
        x = layers.shard_hint(x, [cfg.dp_axis, cfg.sp_axis, None])
    return x


def encode(src_tokens, cfg):
    """src_tokens int64 [b, ts] -> encoder memory [b, ts, d]."""
    x = _embed(src_tokens, cfg, "src_emb")
    for i in range(cfg.n_layers):
        p = f"enc_{i}"
        x = _residual_ln(x, _mha(x, x, cfg, f"{p}.att", causal=False),
                         cfg, f"{p}.ln1")
        x = _residual_ln(x, _ffn(x, cfg, f"{p}.ffn"), cfg, f"{p}.ln2")
        if cfg.sp:
            x = layers.shard_hint(x, [cfg.dp_axis, cfg.sp_axis, None])
    return x


def decode(trg_tokens, memory, cfg):
    """trg_tokens int64 [b, tt] -> vocab logits [b, tt, V]."""
    x = _embed(trg_tokens, cfg, "trg_emb")
    for i in range(cfg.n_layers):
        p = f"dec_{i}"
        x = _residual_ln(x, _mha(x, x, cfg, f"{p}.self", causal=True),
                         cfg, f"{p}.ln1")
        x = _residual_ln(x, _mha(x, memory, cfg, f"{p}.cross",
                                 causal=False), cfg, f"{p}.ln2")
        x = _residual_ln(x, _ffn(x, cfg, f"{p}.ffn"), cfg, f"{p}.ln3")
        if cfg.sp:
            x = layers.shard_hint(x, [cfg.dp_axis, cfg.sp_axis, None])
    return layers.fc(x, size=cfg.vocab_size, num_flatten_dims=2,
                     param_attr=ParamAttr(name="nmt_head.w",
                                          initializer=Normal(0.0, 0.02)),
                     bias_attr=False)


def build_train(cfg, batch, src_len, trg_len, lr=1e-4, amp=False,
                label_smooth_eps=0.1, optimizer_cls=None):
    """Training graph: feed src_tokens [b, ts] and trg_tokens [b, tt+1]
    (BOS-prefixed); the input/label shift happens in the graph. Returns
    (loss, [src, trg]). Label smoothing 0.1, AdamW by default."""
    from .. import optimizer as opt

    src = layers.data("src_tokens", shape=[batch, src_len], dtype="int64",
                      append_batch_size=False)
    trg = layers.data("trg_tokens", shape=[batch, trg_len + 1],
                      dtype="int64", append_batch_size=False)
    trg_in = layers.slice(trg, axes=[1], starts=[0], ends=[trg_len])
    trg_out = layers.slice(trg, axes=[1], starts=[1], ends=[trg_len + 1])

    memory = encode(src, cfg)
    logits = decode(trg_in, memory, cfg)

    logits2 = layers.reshape(logits, [-1, cfg.vocab_size])
    if label_smooth_eps:
        oh = layers.one_hot(layers.reshape(trg_out, [-1, 1]),
                            depth=cfg.vocab_size)
        soft = layers.label_smooth(oh, epsilon=label_smooth_eps)
        loss = layers.softmax_with_cross_entropy(logits2, soft,
                                                 soft_label=True)
    else:
        loss = layers.softmax_with_cross_entropy(
            logits2, layers.reshape(trg_out, [-1, 1]))
    loss = layers.mean(loss)

    optimizer_cls = optimizer_cls or opt.AdamW
    opt_inst = optimizer_cls(learning_rate=lr)
    if amp:
        from ..contrib import mixed_precision as mp
        opt_inst = mp.decorate(opt_inst)
    opt_inst.minimize(loss)
    return loss, [src, trg]


def flops_per_step(cfg, batch, src_len, trg_len):
    """Matmul operations of one training step (3x the forward's), as
    bench.py counts them: the dense projections and the attention scores
    and contexts (encoder self, decoder self causal at about half the
    pairs, cross ts x tt)."""
    d, L, f, v = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab_size
    ts, tt = src_len, trg_len
    # multiply-adds a layer: encoder 4 d^2 + 2 d f per source token,
    # decoder (self 4 + cross 4) d^2 + 2 d f per target token, and the
    # head; times 6 below (2 operations a multiply-add, 3 for the
    # forward and backward)
    dense = L * (ts * (4 * d * d + 2 * d * f)
                 + tt * (8 * d * d + 2 * d * f)) + tt * v * d
    # attention multiply-adds: 2 d per query-key pair (scores and
    # context); causal decoder self-attention halves the pairs
    attn = L * (2 * d * ts * ts
                + 1 * d * tt * tt
                + 2 * d * tt * ts)
    return 6 * (dense + attn) * batch
