"""Decoder-only causal LM (GPT family): the causal counterpart of the
BERT flagship, built from the same transformer encoder stack with
causal=True (the flash kernels then skip the tiles above the diagonal).

The JAX package's models/gpt.py, built from the layers API exactly as
there, so the training, decode, paged decode, prefill and spec-verify
programs serialize identically in both packages: the next-token training
graph, greedy and beam decoding by full-context re-forwarding, and the
two KV-cache decode programs (the slab step with its cache in
persistable [B, H, max_seq, hd] vars, and the paged step over a
block-table pool through the paged_attention op)."""
from __future__ import annotations

import numpy as np

from .. import layers
from . import transformer

__all__ = ["gpt_small", "gpt_medium", "build_train", "greedy_generate",
           "DecodeStep", "build_decode_step", "PagedDecodeStep",
           "build_paged_decode_step", "build_spec_verify_step",
           "kv_generate", "beam_generate"]


def gpt_small(**kw):
    kw.setdefault("vocab_size", 32000)
    kw.setdefault("d_model", 768)
    kw.setdefault("n_heads", 12)
    kw.setdefault("n_layers", 12)
    kw.setdefault("d_ff", 3072)
    kw.setdefault("max_seq_len", 1024)
    kw.setdefault("causal", True)
    return transformer.TransformerConfig(**kw)


def gpt_medium(**kw):
    kw.setdefault("d_model", 1024)
    kw.setdefault("n_heads", 16)
    kw.setdefault("n_layers", 24)
    kw.setdefault("d_ff", 4096)
    return gpt_small(**kw)


def _sample(step_logits, temperature, rng, top_k=0):
    from . import sampling
    return sampling.sample_token(step_logits, temperature=temperature,
                                 top_k=top_k, rng=rng)


def build_train(cfg, batch, seq_len, lr=3e-4, amp=False,
                optimizer_cls=None):
    """Next-token LM training graph: predict tokens[1:] from
    tokens[:-1] (the shift happens in-graph so the feed is just the
    token stream, like the bench's BERT feed). Returns
    (loss, logits, tokens) — generation runs a clone(for_test=True) of
    this program fetching `logits` (positions 0..seq_len-2), so the
    parameters are shared by construction."""
    assert cfg.causal, "GPT training needs causal=True"
    from .. import optimizer as opt
    tokens = layers.data("tokens", shape=[batch, seq_len], dtype="int64",
                         append_batch_size=False)
    inp = layers.slice(tokens, axes=[1], starts=[0], ends=[seq_len - 1])
    tgt = layers.slice(tokens, axes=[1], starts=[1], ends=[seq_len])
    hidden = transformer.encoder(inp, cfg)
    logits = transformer.lm_logits(hidden, cfg)
    loss = transformer.lm_loss(hidden, tgt, cfg, logits=logits)
    opt_inst = (optimizer_cls or opt.AdamW)(learning_rate=lr)
    if amp:
        from ..contrib import mixed_precision as mp
        opt_inst = mp.decorate(opt_inst)
    opt_inst.minimize(loss)
    return loss, logits, tokens


def _window_row(ctx, win, seq_len):
    """Context window + zero pad for the full-re-forward decoders: the
    usable window is seq_len-1 because the train graph consumes
    tokens[:-1]; returns (row list of len seq_len, last real pos)."""
    window = ctx[-win:]
    return window + [0] * (seq_len - len(window)), len(window) - 1


def greedy_generate(exe, program, tokens_var, logits_var, prompt,
                    max_new_tokens, seq_len, temperature=0.0, seed=0):
    """Autoregressive decode by re-forwarding the full (fixed-length)
    context: right-pad the window to seq_len (harmless under the causal
    mask — padded positions sit in the future), take the logits at the
    last real position, append, repeat. O(T) forwards of an O(T)
    context — the simple exact scheme; KV-cache incremental decoding is
    a later optimization.

    prompt: 1-D int array. Returns the generated continuation (list)."""
    if not len(prompt):
        raise ValueError("greedy_generate: prompt must be non-empty")
    rng = np.random.RandomState(seed)
    ctx = list(int(t) for t in prompt)
    out = []
    # the train graph consumes tokens[:-1]: logits cover positions
    # 0..seq_len-2, so the usable context window is seq_len-1
    win = seq_len - 1
    # reshape attrs bake the build-time batch: tile the single prompt
    # row up to it and read row 0
    batch = int(tokens_var.shape[0])
    for _ in range(max_new_tokens):
        row, pos = _window_row(ctx, win, seq_len)
        feed_tokens = np.tile(np.asarray([row], np.int64), (batch, 1))
        logits, = exe.run(program,
                          feed={tokens_var.name: feed_tokens},
                          fetch_list=[logits_var])
        step_logits = np.asarray(logits)[0, pos]
        nxt = _sample(step_logits, temperature, rng)
        ctx.append(nxt)
        out.append(nxt)
    return out


class DecodeStep:
    """Handle on one multi-slot decode-step program.

    Iterates as the historical `(token_var, logits_var, cache_names)`
    3-tuple, and additionally exposes the per-slot control feeds the
    continuous-batching engine drives:

    * `reset_var` — `slot_reset` [batch] float32 feed; 1.0 zeroes that
      slot's K/V cache rows and position counter IN-GRAPH this step
      (no host-side zero upload).
    * `active_var` — `slot_active` [batch] float32 feed; 0.0 mutes a
      slot: no cache write, position frozen, its logits are junk to
      ignore.
    """

    def __init__(self, token_var, logits_var, cache_names, reset_var,
                 active_var, batch, max_seq, state_prefix):
        self.token_var = token_var
        self.logits_var = logits_var
        self.cache_names = cache_names
        self.reset_var = reset_var
        self.active_var = active_var
        self.batch = batch
        self.max_seq = max_seq
        self.state_prefix = state_prefix
        self.pos_name = cache_names[0]

    def __iter__(self):
        return iter((self.token_var, self.logits_var, self.cache_names))


def build_decode_step(cfg, batch, max_seq, state_prefix=""):
    """Incremental decoding graph: ONE token per slot in, next-token
    logits out, per-layer K/V caches carried as persistable state
    (read and written back by the Executor as state). O(T) per generated
    token instead of greedy_generate's
    O(T^2) full re-forward.

    Multi-slot: each of the `batch` rows is an independent decode slot
    with its own position (`decode_pos` is a per-slot [batch] vector)
    and its own cache region, so a continuous-batching scheduler can
    admit/evict requests between steps — the Orca iteration-level
    scheduling model — while every step runs the SAME fixed-shape
    program (one prepared run for the serving lifetime). Two extra
    float32 [batch] feeds control the slots: `slot_reset` (1.0 zeroes
    the slot's cache + position in-graph before this step's write) and
    `slot_active` (0.0 freezes the slot entirely).

    Weight names match the training graph (layer_i.att.*, layer_i.ln*,
    word_emb, lm_head.w), so running this program in the same scope as
    a trained model shares parameters by construction. `state_prefix`
    prefixes only the STATE names (decode_pos, cache_k/v) so two decode
    graphs of different batch sizes can share one trained scope without
    colliding; weight names stay unprefixed/shared.

    Returns a `DecodeStep` — unpacks as the historical
    (token_var, logits_var, cache_names) 3-tuple."""
    from ..framework import ParamAttr
    from ..initializer import Normal
    import math as _math

    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    token = layers.data("step_token", shape=[batch, 1], dtype="int64",
                        append_batch_size=False)
    reset = layers.data("slot_reset", shape=[batch], dtype="float32",
                        append_batch_size=False)
    active = layers.data("slot_active", shape=[batch], dtype="float32",
                         append_batch_size=False)
    pos = layers.create_global_var([batch], 0, "int64", persistable=True,
                                   name=f"{state_prefix}decode_pos")
    cache_names = [pos.name]

    # slot gates, computed once and broadcast everywhere:
    #   keep_slot  [B]  0.0 where the slot resets (wipes cache + pos)
    #   pos0       [B]  effective per-slot position after reset
    keep_slot = layers.scale(reset, scale=-1.0, bias=1.0)
    pos0 = layers.elementwise_mul(pos, layers.cast(keep_slot, "int64"))

    x = layers.embedding(token, size=[cfg.vocab_size, d],
                         param_attr=ParamAttr(name="word_emb",
                                              initializer=Normal(0.0,
                                                                 0.02)))
    # the embedding lookup squeezes the trailing length-1 dim ([B, d]);
    # pin the [B, 1, d] layout explicitly — at batch 1 broadcasting hid
    # this, at B > 1 it would silently grow a bogus seq dim
    x = layers.reshape(x, [batch, 1, d])
    # position encoding at each slot's current position: build the full
    # sinusoid table from a zero sequence, then gather one row per slot
    zeros_seq = layers.fill_constant([1, max_seq, d], "float32", 0.0)
    pe_table = layers.add_position_encoding(zeros_seq, alpha=1.0,
                                            beta=1.0)
    pe_rows = layers.gather(layers.reshape(pe_table, [max_seq, d]),
                            pos0)                       # [B, d]
    x = layers.elementwise_add(x, layers.reshape(pe_rows,
                                                 [batch, 1, d]))

    # per-slot causal mask over the cache length: row b keeps cache
    # positions <= pos0[b] (including this step's write at pos0[b])
    steps_f = layers.cast(layers.range(0, max_seq, 1, "int64"), "float32")
    keep = layers.cast(
        layers.less_equal(layers.reshape(steps_f, [1, max_seq]),
                          layers.reshape(layers.cast(pos0, "float32"),
                                         [batch, 1])),
        "float32")                                      # [B, maxT]
    neg4 = layers.reshape(layers.scale(keep, scale=1e30, bias=-1e30),
                          [batch, 1, 1, max_seq])   # 0 keep, -1e30 drop

    # per-slot one-hot write gate at pos0, gated by slot_active so a
    # muted slot's cache rows stay untouched
    onehot = layers.elementwise_mul(
        layers.one_hot(layers.reshape(pos0, [batch, 1]), max_seq),
        layers.reshape(active, [batch, 1]))             # [B, maxT]
    oh4 = layers.reshape(onehot, [batch, 1, max_seq, 1])
    inv_oh4 = layers.scale(oh4, scale=-1.0, bias=1.0)
    keep4 = layers.reshape(keep_slot, [batch, 1, 1, 1])

    def dense(z, size, name, act=None):
        # transformer._dense is the single source of truth for the
        # weight names/init the trained scope holds (cfg.tp is False
        # here, so its tp annotation is a no-op)
        return transformer._dense(z, size, name, cfg, act=act)

    for i in range(cfg.n_layers):
        pre = f"layer_{i}"
        q = dense(x, d, f"{pre}.att.q")
        k = dense(x, d, f"{pre}.att.k")
        v = dense(x, d, f"{pre}.att.v")

        def heads(z):
            return layers.transpose(layers.reshape(z, [batch, 1, h, hd]),
                                    [0, 2, 1, 3])   # [B, H, 1, hd]
        q, k, v = heads(q), heads(k), heads(v)

        ck = layers.create_global_var([batch, h, max_seq, hd], 0.0,
                                      "float32", persistable=True,
                                      name=f"{state_prefix}{pre}.cache_k")
        cv = layers.create_global_var([batch, h, max_seq, hd], 0.0,
                                      "float32", persistable=True,
                                      name=f"{state_prefix}{pre}.cache_v")
        cache_names += [ck.name, cv.name]
        # reset wipe, then one-hot write of this step's k/v at pos0:
        #   new = (cache * keep_slot) * (1 - onehot) + k * onehot
        ck_new = layers.elementwise_add(
            layers.elementwise_mul(layers.elementwise_mul(ck, keep4),
                                   inv_oh4),
            layers.elementwise_mul(k, oh4))
        cv_new = layers.elementwise_add(
            layers.elementwise_mul(layers.elementwise_mul(cv, keep4),
                                   inv_oh4),
            layers.elementwise_mul(v, oh4))
        layers.assign(ck_new, output=ck)
        layers.assign(cv_new, output=cv)

        scores = layers.scale(
            layers.matmul(q, ck_new, transpose_y=True),
            scale=1.0 / _math.sqrt(hd))              # [B, H, 1, maxT]
        scores = layers.elementwise_add(scores, neg4)
        probs = layers.softmax(scores)
        ctxv = layers.matmul(probs, cv_new)          # [B, H, 1, hd]
        ctxv = layers.reshape(
            layers.transpose(ctxv, [0, 2, 1, 3]), [batch, 1, d])
        att = dense(ctxv, d, f"{pre}.att.proj")
        x = layers.layer_norm(layers.elementwise_add(x, att),
                              begin_norm_axis=2,
                              param_attr=ParamAttr(name=f"{pre}.ln1.w"),
                              bias_attr=ParamAttr(name=f"{pre}.ln1.b"))
        ff = transformer._ffn(x, cfg, f"{pre}.ffn")
        x = layers.layer_norm(layers.elementwise_add(x, ff),
                              begin_norm_axis=2,
                              param_attr=ParamAttr(name=f"{pre}.ln2.w"),
                              bias_attr=ParamAttr(name=f"{pre}.ln2.b"))

    logits = layers.fc(x, size=cfg.vocab_size, num_flatten_dims=2,
                       param_attr=ParamAttr(name="lm_head.w",
                                            initializer=Normal(0.0, 0.02)),
                       bias_attr=False)
    # advance only the active slots (a muted slot's position is frozen)
    pos_next = layers.elementwise_add(pos0,
                                      layers.cast(active, "int64"))
    layers.assign(pos_next, output=pos)
    return DecodeStep(token, logits, cache_names, reset, active, batch,
                      max_seq, state_prefix)


class PagedDecodeStep:
    """Handle on one paged decode/prefill program.

    Unlike the slab `DecodeStep` there is NO in-graph position state
    and NO reset feed: the host scheduler owns every position (it knows
    them exactly — `serving/kv_blocks.py` tracks each slot's block
    table and write cursor), and "reset" is just releasing the slot's
    blocks back to the pool. The graph's per-step control feeds are:

    * `table_var`  — `block_table` [batch, max_blocks] int64: logical
      block j of row b lives in physical pool block table[b, j].
    * `start_var`  — `start_pos` [batch] int64: position of the row's
      first token this step.
    * `nvalid_var` — `n_valid` [batch] int64: how many of the
      `seq_tokens` fed tokens are real; 0 mutes the row (its writes
      land in the reserved scratch block 0, its logits are junk).

    `cache_names` are the per-layer `[num_blocks, block_size, h, hd]`
    K/V pool persistables — the SAME names for the 1-token decode
    program and the block-sized chunked-prefill program, so both
    programs update one physical pool in the shared scope.
    """

    def __init__(self, token_var, logits_var, cache_names, table_var,
                 start_var, nvalid_var, batch, max_seq, block_size,
                 num_blocks, seq_tokens, state_prefix):
        self.token_var = token_var
        self.logits_var = logits_var
        self.cache_names = cache_names
        self.table_var = table_var
        self.start_var = start_var
        self.nvalid_var = nvalid_var
        self.batch = batch
        self.max_seq = max_seq
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.seq_tokens = seq_tokens
        self.max_blocks_per_slot = int(table_var.shape[1])
        self.state_prefix = state_prefix

    def __iter__(self):
        return iter((self.token_var, self.logits_var, self.cache_names))


def build_paged_decode_step(cfg, batch, max_seq, block_size, num_blocks,
                            seq_tokens=1, state_prefix="",
                            with_logits=True):
    """Paged variant of `build_decode_step`: K/V lives in per-layer
    physical POOLS of `num_blocks` fixed-size blocks instead of one
    contiguous `[batch, max_seq]` slab per slot, and every read/write
    goes through the `paged_attention` op (ops/attention.py) via a
    per-slot block table. Peak KV HBM is therefore
    `num_blocks × block_bytes` — chosen from the budget, decoupled from
    `max_slots × max_seq`.

    `seq_tokens` tokens are consumed per row per step: 1 builds the
    decode program, `block_size` builds the chunked-prefill program
    that retires a whole block of prompt per step. Both use
    the same pool var names, so one scope carries one physical pool.
    `with_logits=False` (the prefill program) skips the lm head and
    returns a cheap [batch] health probe as `logits_var` instead —
    prefill logits are never sampled, and fetching
    `[batch, block_size, vocab]` per chunk would waste host bandwidth.

    Weight names match the training graph exactly as in
    `build_decode_step`; only the pool STATE names carry
    `state_prefix`."""
    from ..framework import ParamAttr
    from ..initializer import Normal
    from ..layer_helper import LayerHelper
    import math as _math

    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    T = int(seq_tokens)
    max_blocks = -(-int(max_seq) // int(block_size))
    token = layers.data("step_token", shape=[batch, T], dtype="int64",
                        append_batch_size=False)
    table = layers.data("block_table", shape=[batch, max_blocks],
                        dtype="int64", append_batch_size=False)
    start = layers.data("start_pos", shape=[batch], dtype="int64",
                        append_batch_size=False)
    nvalid = layers.data("n_valid", shape=[batch], dtype="int64",
                         append_batch_size=False)
    cache_names = []

    x = layers.embedding(token, size=[cfg.vocab_size, d],
                         param_attr=ParamAttr(name="word_emb",
                                              initializer=Normal(0.0,
                                                                 0.02)))
    x = layers.reshape(x, [batch, T, d])
    # per-token position encodings: row b token t sits at start[b] + t
    qpos = layers.elementwise_add(
        layers.reshape(start, [batch, 1]),
        layers.reshape(layers.range(0, T, 1, "int64"), [1, T]))
    zeros_seq = layers.fill_constant([1, max_seq, d], "float32", 0.0)
    pe_table = layers.add_position_encoding(zeros_seq, alpha=1.0,
                                            beta=1.0)
    pe_rows = layers.gather(layers.reshape(pe_table, [max_seq, d]),
                            layers.reshape(qpos, [batch * T]))
    x = layers.elementwise_add(x, layers.reshape(pe_rows, [batch, T, d]))

    def dense(z, size, name, act=None):
        return transformer._dense(z, size, name, cfg, act=act)

    for i in range(cfg.n_layers):
        pre = f"layer_{i}"
        q = dense(x, d, f"{pre}.att.q")
        k = dense(x, d, f"{pre}.att.k")
        v = dense(x, d, f"{pre}.att.v")

        def heads(z):
            return layers.transpose(layers.reshape(z, [batch, T, h, hd]),
                                    [0, 2, 1, 3])   # [B, H, T, hd]
        q, k, v = heads(q), heads(k), heads(v)

        ckp = layers.create_global_var(
            [num_blocks, block_size, h, hd], 0.0, "float32",
            persistable=True, name=f"{state_prefix}{pre}.kv_pool_k")
        cvp = layers.create_global_var(
            [num_blocks, block_size, h, hd], 0.0, "float32",
            persistable=True, name=f"{state_prefix}{pre}.kv_pool_v")
        cache_names += [ckp.name, cvp.name]

        helper = LayerHelper("paged_attention")
        ctxv = helper.create_variable_for_type_inference("float32")
        ck_out = helper.create_variable_for_type_inference("float32")
        cv_out = helper.create_variable_for_type_inference("float32")
        helper.append_op(
            type="paged_attention",
            inputs={"Q": [q.name], "K": [k.name], "V": [v.name],
                    "CacheK": [ckp.name], "CacheV": [cvp.name],
                    "BlockTable": [table.name], "StartPos": [start.name],
                    "NValid": [nvalid.name]},
            outputs={"Out": [ctxv.name], "CacheKOut": [ck_out.name],
                     "CacheVOut": [cv_out.name]},
            attrs={"sm_scale": 1.0 / _math.sqrt(hd)})
        layers.assign(ck_out, output=ckp)
        layers.assign(cv_out, output=cvp)

        ctxv = layers.reshape(
            layers.transpose(ctxv, [0, 2, 1, 3]), [batch, T, d])
        att = dense(ctxv, d, f"{pre}.att.proj")
        x = layers.layer_norm(layers.elementwise_add(x, att),
                              begin_norm_axis=2,
                              param_attr=ParamAttr(name=f"{pre}.ln1.w"),
                              bias_attr=ParamAttr(name=f"{pre}.ln1.b"))
        ff = transformer._ffn(x, cfg, f"{pre}.ffn")
        x = layers.layer_norm(layers.elementwise_add(x, ff),
                              begin_norm_axis=2,
                              param_attr=ParamAttr(name=f"{pre}.ln2.w"),
                              bias_attr=ParamAttr(name=f"{pre}.ln2.b"))

    if with_logits:
        out = layers.fc(x, size=cfg.vocab_size, num_flatten_dims=2,
                        param_attr=ParamAttr(
                            name="lm_head.w",
                            initializer=Normal(0.0, 0.02)),
                        bias_attr=False)
    else:
        # cheap [batch] health probe (keeps the whole stack live for
        # the fetch and feeds the serving NaN guard per-row)
        out = layers.reduce_mean(x, dim=[1, 2])
    return PagedDecodeStep(token, out, cache_names, table, start,
                           nvalid, batch, max_seq, block_size,
                           num_blocks, T, state_prefix)


def build_spec_verify_step(cfg, batch, max_seq, block_size, num_blocks,
                           k, state_prefix=""):
    """Speculative-decoding verify step: the `[batch, k+1]` multi-token
    sibling of the paged decode program (`seq_tokens = k+1`,
    `with_logits = True`), scoring a slot's committed token plus up to
    `k` draft tokens in ONE dispatch.

    Row b feeds `[cur, d_1..d_n, pad...]` at `start_pos = fed` with
    `n_valid = 1+n` — the draft tokens scatter through the SAME block
    table (and the same `state_prefix` K/V pools) as the decode step,
    and the `paged_attention` causal mask makes position j's logits
    condition on exactly the tokens a serial decode would have fed, so
    the returned `[batch, k+1, vocab]` logits are bit-identical to k+1
    sequential decode steps. The host accepts a draft prefix via
    `models/sampling.accept_draft` and re-feeds from the first
    rejection; rejected positions' pool writes are harmless — they sit
    past the slot's advanced write cursor and are overwritten before
    any mask ever exposes them. A draft-less slot rides along with
    `n_valid = 1`, making this step a strict superset of the decode
    step — the engine can route every decode iteration through it
    without a scheduling special case."""
    if k < 1:
        raise ValueError(f"build_spec_verify_step: k must be >= 1, "
                         f"got {k}")
    return build_paged_decode_step(
        cfg, batch=batch, max_seq=max_seq, block_size=block_size,
        num_blocks=num_blocks, seq_tokens=int(k) + 1,
        state_prefix=state_prefix, with_logits=True)


def _ensure_decode_state(scope, blk, cache_names, place):
    """Make every decode state var exist in `scope` with the graph's
    shape (zeros), as a tensor on `place`. An existing right-shaped var
    is left alone because the in-graph `slot_reset` wipe supersedes
    zeroing. Never runs the decode startup program (it would re-init the
    trained weights the scope shares). Integer state (`decode_pos`) is
    int64, the type torch indexes with; the IR records int32, as the JAX
    package's 64-bit-off inference does."""
    from ..convert import scope_from_numpy
    from ..core.dtypes import convert_dtype
    for name in cache_names:
        v = blk.var(name)
        shape = tuple(abs(int(s)) for s in v.shape)
        cur = scope.find_var(name)
        if cur is None or tuple(cur.shape) != shape:
            dtype = convert_dtype(v.dtype)
            if dtype in ("int32", "int64"):
                dtype = "int64"
            scope_from_numpy({name: np.zeros(shape, dtype)}, scope, place)


def kv_generate(exe, scope, decode_prog, token_var, logits_var,
                cache_names, prompt, max_new_tokens, temperature=0.0,
                seed=0, top_k=0, stream_cb=None):
    """Autoregressive generation over the KV-cache decode step: feed
    the prompt token by token (prefill), then sample/argmax the
    continuation.

    State reset happens IN-GRAPH: the first step feeds slot_reset=1,
    which zeroes the cache rows and position counters on the device —
    no B*H*max_seq*hd zero upload per call. Zero materialization
    survives only as the fallback for state vars that do not exist in
    the scope yet (the Executor requires persistable state to be
    initialised; running the decode startup would re-init the shared
    trained weights, so the caches are seeded directly, on the
    executor's place).

    `stream_cb(token_id)` (optional) fires after each generated token,
    for time-to-first-token and inter-token timing. `top_k` > 0 restricts
    sampling to the k highest logits (see models/sampling.py)."""
    from ..core.scope import scope_guard

    if not len(prompt):
        raise ValueError("kv_generate: prompt must be non-empty")
    rng = np.random.RandomState(seed)
    batch = int(token_var.shape[0])
    blk = decode_prog.global_block()
    # any cache var carries [B, H, max_seq, hd]
    max_seq = int(blk.var(cache_names[-1]).shape[2])
    need = len(prompt) + max_new_tokens - 1
    if need > max_seq:
        raise ValueError(
            f"kv_generate: prompt ({len(prompt)}) + max_new_tokens "
            f"({max_new_tokens}) needs {need} cache slots but the decode "
            f"graph was built with max_seq={max_seq}")
    ones = np.ones(batch, np.float32)
    zeros = np.zeros(batch, np.float32)
    state = {"first": True}
    with scope_guard(scope):
        _ensure_decode_state(scope, blk, cache_names, exe.place)

        def step(tok):
            feed = {token_var.name: np.full((batch, 1), tok, np.int64),
                    "slot_reset": ones if state["first"] else zeros,
                    "slot_active": ones}
            state["first"] = False
            out, = exe.run(decode_prog, feed=feed,
                           fetch_list=[logits_var])
            return np.asarray(out)[0, 0]

        for tok in prompt[:-1]:
            step(int(tok))
        out = []
        cur = int(prompt[-1])
        for _ in range(max_new_tokens):
            cur = _sample(step(cur), temperature, rng, top_k=top_k)
            out.append(cur)
            if stream_cb is not None:
                stream_cb(cur)
        return out


def beam_generate(exe, program, tokens_var, logits_var, prompt,
                  max_new_tokens, seq_len, beam_size=4,
                  length_penalty=0.0, eos_id=None):
    """Host-driven beam search over the full-re-forward graph (the
    reference's beam_search decoding style, driven from Python): all
    live beams ride one batched forward per step (beams pad up to the
    program's build-time batch), log-prob scores accumulate. A beam
    that emits `eos_id` is finished and stops extending; with
    hypotheses of different lengths in play, `length_penalty` > 0
    applies the GNMT-style normalization score/len^p (without an
    eos_id all hypotheses share one length, so the penalty cannot
    change the ranking). Returns the best continuation (list,
    including the eos token if one was produced).

    Requires beam_size <= the program's batch."""
    if not len(prompt):
        raise ValueError("beam_generate: prompt must be non-empty")
    batch = int(tokens_var.shape[0])
    if beam_size > batch:
        raise ValueError(
            f"beam_generate: beam_size ({beam_size}) exceeds the "
            f"program's batch ({batch}); rebuild with a larger batch")
    win = seq_len - 1

    def key(cs):
        ctx, score, _ = cs
        gen_len = max(len(ctx) - len(prompt), 1)
        return -score / (gen_len ** length_penalty
                         if length_penalty else 1.0)

    beams = [(list(int(t) for t in prompt), 0.0, False)]
    for _ in range(max_new_tokens):
        live = [b for b in beams if not b[2]]
        if not live:
            break
        rows = [_window_row(ctx, win, seq_len)[0] for ctx, _, _ in live]
        while len(rows) < batch:
            rows.append([0] * seq_len)
        feed = np.asarray(rows, np.int64)
        logits, = exe.run(program, feed={tokens_var.name: feed},
                          fetch_list=[logits_var])
        logits = np.asarray(logits)
        cand = [b for b in beams if b[2]]  # finished pass through
        for ri, (ctx, score, _) in enumerate(live):
            pos = _window_row(ctx, win, seq_len)[1]
            lp = logits[ri, pos]
            lp = lp - lp.max()
            logp = lp - np.log(np.exp(lp).sum())
            topk = np.argpartition(-logp, beam_size)[:beam_size]
            for tok in topk[np.argsort(-logp[topk])]:
                tok = int(tok)
                cand.append((ctx + [tok], score + float(logp[tok]),
                             eos_id is not None and tok == eos_id))
        cand.sort(key=key)
        beams = cand[:beam_size]
    best = beams[0][0]
    return best[len(prompt):]
