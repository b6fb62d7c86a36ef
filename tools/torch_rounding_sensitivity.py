"""How far rounding alone moves a training step's gradients, on the CPU,
in the JAX package and in its PyTorch port (paddle_tpu_torch).

One step of a model from the JAX package's startup values, carried to
the port by convert.scope_from_numpy, and for every parameter's
step-1 gradient, each gap as ||a - b|| / ||b|| (Frobenius):

- port_amp: the port's bf16 AMP gradient against the JAX package's;
- jax_pert: the JAX package's AMP gradient with the input moved by
  1e-3 (ResNet and DeepLab: the image plus 1e-3 of seeded noise; NMT:
  both embedding tables times 1 + 1e-3 of seeded noise) against the
  unmoved one, how far bf16 rounding alone moves it;
- jax_amp_vs_f32: the JAX package's AMP gradient against its float32
  one; port_amp_vs_f32 likewise for the port against the JAX float32;
- port_f32: the port's float32 gradient against the JAX package's.

Usage (both packages on the path, JAX on the CPU):

    JAX_PLATFORMS=cpu python tools/torch_rounding_sensitivity.py resnet \\
        [--batch 4] [--branch-scale 0.1]
    JAX_PLATFORMS=cpu python tools/torch_rounding_sensitivity.py nmt \\
        --d-model 128 --layers 2 --vocab 32000 --len 256
    JAX_PLATFORMS=cpu python tools/torch_rounding_sensitivity.py deeplab \\
        --hw 33 --batch 2 [--branch-scale 0.1]
    JAX_PLATFORMS=cpu python tools/torch_rounding_sensitivity.py recipe \\
        --d-model 128 --layers 2 --len 128 [--steps 2]
    JAX_PLATFORMS=cpu python tools/torch_rounding_sensitivity.py se_resnext \\
        [--batch 4] [--steps 2] [--pert 1e-6]
    JAX_PLATFORMS=cpu python tools/torch_rounding_sensitivity.py seq2seq \\
        [--batch 4] [--pert 1e-6] [--hidden 1000 --emb 620 --vocab 30000
        --len 50]
    JAX_PLATFORMS=cpu python tools/torch_rounding_sensitivity.py sentiment \\
        [--batch 128] [--pert 1e-6]
    PYTHONPATH=. python tools/torch_rounding_sensitivity.py tp \\
        [--d-model 128 --layers 2 --len 128 --batch 4]
    PYTHONPATH=. python tools/torch_rounding_sensitivity.py ring \\
        [--len 512 --d-model 128 --heads 4 --vocab 1000]
    PYTHONPATH=. python tools/torch_rounding_sensitivity.py moe \\
        [--d-model 64 --experts 8 --batch 4 --len 64]

ResNet runs at depth 50, 3x64x64, 10 classes, Momentum lr 0.1;
--branch-scale multiplies the scale of every batch_norm that ends a
residual branch (as tests/test_torch_resnet.py's AMP case does).
DeepLab runs DeepLabv3+ (19 classes, Momentum lr 1e-3) at the given
image side and batch, with the same --branch-scale. NMT
runs the Transformer-big shape at the given width, depth, vocab and
source = target length, batch 1, dropout 0, AdamW lr 1e-4. Prints one
line per parameter and the largest of each reading, the attention key
biases left out (their gradients are zero but for rounding).

`recipe` reads parameter updates instead of gradients: a BERT MLM model
(vocab 30522, the given width, depth and length, batch 1, dropout 0,
float32) under chip_smoke.py's BERT recipe (AdamW with weight decay 0.01
and epsilon 1e-6, the warmup and linear decay, the global-norm clip 1.0)
takes --steps steps from counter 9999, and each parameter's update
(after the steps minus before) is read: port_update, the port's against
the JAX package's; jax_pert_update, the JAX package's with the word
embedding moved by --pert (default 1e-6) of each value (seeded noise)
against the unmoved one. chip_smoke.py's RECIPE_UPDATE_RTOL comes from these.

`se_resnext` reads float32 only: SE-ResNeXt at the JAX package's test
size (3x32x32, 10 classes, stages (1, 1), cardinality 4, base 32,
Momentum lr 0.01, dropout off: the frameworks draw other masks), batch
--batch. Per parameter: port_f32 and jax_pert (the image moved by --pert
of seeded noise) for the step-1 gradient, and port_update and
jax_pert_update for the update after --steps steps; the largest loss
gap of each too. chip_smoke.py's SE_RESNEXT_BARS come from these.

`dp` reads chip_smoke.py's [dp_train] gaps on the CPU: BERT (vocab
30522, the given width, depth and length, dropout 0, bf16 AMP, AdamW lr
1e-4) at global batch --batch takes --steps steps from one startup state
through chip_smoke.dp_train_run: in one process; over two gloo rank
processes (paddle_tpu_torch.distributed.spawn.RankPool), each on half
the rows; the same two ranks broken as each of chip_smoke.DP_CONTROLS
(the sync skipped, the gradients summed); and in one process from the
startup state moved by --pert of seeded noise. It prints, of each run
against the first, the largest loss gap, the update gap and the first
step's gradient gap (the gaps DP_BARS bound), and the largest parameter
gap. chip_smoke.py's dp_phases takes the two-rank and control readings
again at the cell's own size on the card.

`tp`, `ring` and `moe` read chip_smoke.py's model-parallel gaps on the
CPU, each run against the one-rank run of the same program from one
startup state, and beside it the same one-rank run from the startup
state moved by --pert of seeded noise (how far rounding alone moves the
gaps). `tp`: chip_smoke.mp_train_run's BERT (the tp/sp hints, vocab
30522, the given width, depth and length, dropout 0, bf16 AMP, AdamW)
at global batch --batch over two gloo ranks on a mesh dp1 x tp2, on a
mesh fsdp2, as each of chip_smoke.MP_CONTROLS and with the fsdp
gradient's reduce-scatter unscaled: the loss, update and gradient gaps
MP_BARS bound. `ring`: chip_smoke.seq_train_run's
long-context program (causal, the given T, width, heads and vocab,
q/k/v in bf16) with ring and with Ulysses attention over sp2, and the
ring with its off-diagonal blocks dropped: the loss and gradient gaps
SEQ_BARS bound. `moe`: chip_smoke.moe_train_run's MoE program (the
given widths, experts and rows) over ep2, dense and sparse at capacity
factor 1.25, and dense with the ep sum's backward all-reduced (the
control): the dense losses' relative gap and the kept rows' error
MOE_TOL bounds, the dropped rows, and the gate weight's first-step
gradient gap MOE_GRAD_BAR bounds.

`pp` reads chip_smoke.py's pipeline gaps on the CPU
(chip_smoke.pp_train_run: BERT encoder layers of the given width and
depth, dropout 0, SGD, loss mean((out - x)^2)), in float32 and under
bf16 autocast: gpipe over two gloo ranks (half the layers a rank,
--micro microbatches), each chip_smoke.PP_CONTROLS kind, and the
one-process run with its input moved by --pert of seeded noise, each
against the one-process run: the largest relative loss gap and the
first step's gradient gap PP_BARS bound. Then [section_pipeline]'s
float32 gaps (chip_smoke.section_pipeline_run, three sections) that
SECTION_BARS bound.

`srl` reads float32 only, for chip_smoke.py's [srl_train] bar: the
book's label_semantic_roles (chip_smoke.build_srl at its widths) on
srl_feeds' two batches for --steps SGD steps from one startup state, and
again with the word and predicate embeddings moved by --pert of seeded
noise: the largest relative loss gap.

`seq2seq` and `sentiment` read float32 only, for chip_smoke.py's
[seq2seq_cpu_check] and [sentiment_lod] bars. seq2seq: chip_smoke's
RNNsearch program (build_seq2seq, widths from the flags, RNNsearch-50's
by default) at batch --batch on seq2seq_feed's rows; the loss and the
gradients [seq2seq_cpu_check] compares (the two embeddings, the output
projection, the decoder GRU's recurrent weight), port_f32 and jax_pert
(both embedding tables times 1 + --pert of seeded noise). sentiment:
chip_smoke's book stacked LSTM (build_sentiment) on the first of
imdb_batches' ragged batches of --batch reviews; the loss, port_f32 and
jax_pert (the embedding table moved likewise).
"""
import argparse
import sys

import numpy as np

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu_torch.convert import scope_from_numpy

READINGS = ("port_amp", "jax_pert", "jax_amp_vs_f32", "port_amp_vs_f32",
            "port_f32")


def _fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _resnet(args):
    from paddle_tpu.models import resnet as rj
    from paddle_tpu_torch.models import resnet as rt

    def build(f, mod, amp):
        main, startup = f.Program(), f.Program()
        startup.random_seed = 11
        with f.program_guard(main, startup), f.unique_name.guard():
            loss, _, _ = mod.build_train(img_shape=(3, 64, 64),
                                         class_dim=10, lr=0.1, amp=amp)
        return main, startup, loss

    progs = {(pkg, amp): build(f, mod, amp)
             for pkg, f, mod in (("j", fj, rj), ("t", ft, rt))
             for amp in (False, True)}
    rng = np.random.RandomState(0)
    feed = {"image": rng.randn(args.batch, 3, 64, 64).astype(np.float32),
            "label": rng.randint(0, 10, (args.batch, 1)).astype(np.int64)}
    noise = np.random.RandomState(5).randn(*feed["image"].shape)
    moved = dict(feed, image=(feed["image"] + 1e-3 * noise)
                 .astype(np.float32))
    init = _scale_branch_ends(_jax_init(progs["j", False][1]),
                              progs["t", False][0], args.branch_scale)
    return progs, init, (init, feed), (init, moved)


def _deeplab(args):
    from paddle_tpu.models import deeplab as dj
    from paddle_tpu_torch.models import deeplab as dt

    def build(f, mod, amp):
        main, startup = f.Program(), f.Program()
        startup.random_seed = 11
        with f.program_guard(main, startup), f.unique_name.guard():
            loss, _ = mod.build_train(args.hw, args.batch, amp=amp)
        return main, startup, loss

    progs = {(pkg, amp): build(f, mod, amp)
             for pkg, f, mod in (("j", fj, dj), ("t", ft, dt))
             for amp in (False, True)}
    rng = np.random.RandomState(0)
    shape = (args.batch, 3, args.hw, args.hw)
    feed = {"image": rng.randn(*shape).astype(np.float32),
            "label": rng.randint(0, dj.N_CLASSES, (args.batch, args.hw,
                                                   args.hw)).astype(np.int64)}
    noise = np.random.RandomState(5).randn(*shape)
    moved = dict(feed, image=(feed["image"] + 1e-3 * noise)
                 .astype(np.float32))
    init = _scale_branch_ends(_jax_init(progs["j", False][1]),
                              progs["t", False][0], args.branch_scale)
    return progs, init, (init, feed), (init, moved)


def _scale_branch_ends(init, main, factor):
    """`init` with the scale of every batch_norm that ends a residual
    branch (its Y is an elementwise_add's Y) multiplied by `factor`."""
    ops = main.global_block().ops
    add_y = {op.input("Y")[0] for op in ops if op.type == "elementwise_add"}
    for op in ops:
        if op.type == "batch_norm" and op.output("Y")[0] in add_y:
            name = op.input("Scale")[0]
            init[name] = (init[name] * factor).astype(np.float32)
    return init


def _nmt(args):
    from paddle_tpu.models import nmt as nj
    from paddle_tpu_torch.models import nmt as nt

    def build(f, mod, amp):
        cfg = mod.transformer_big_nmt(
            vocab_size=args.vocab, d_model=args.d_model,
            n_heads=max(args.d_model // 64, 1), n_layers=args.layers,
            d_ff=4 * args.d_model, dropout=0.0, attn_dropout=0.0,
            use_flash=True)
        main, startup = f.Program(), f.Program()
        startup.random_seed = 13
        with f.program_guard(main, startup), f.unique_name.guard():
            loss, _ = mod.build_train(cfg, 1, args.len, args.len, lr=1e-4,
                                      amp=amp)
        return main, startup, loss

    progs = {(pkg, amp): build(f, mod, amp)
             for pkg, f, mod in (("j", fj, nj), ("t", ft, nt))
             for amp in (False, True)}
    rng = np.random.RandomState(1)
    feed = {"src_tokens": rng.randint(0, args.vocab, (1, args.len))
            .astype(np.int64),
            "trg_tokens": rng.randint(0, args.vocab, (1, args.len + 1))
            .astype(np.int64)}
    init = _jax_init(progs["j", False][1])
    noise = np.random.RandomState(5)
    moved = dict(init)
    for name in ("src_emb", "trg_emb"):
        moved[name] = (init[name] * (1 + 1e-3 * noise.randn(
            *init[name].shape))).astype(np.float32)
    return progs, init, (init, feed), (moved, feed)


def _recipe(args):
    """The BERT recipe's parameter updates (see the module docstring)."""
    import functools
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    import chip_smoke
    from paddle_tpu.models import transformer as tj
    from paddle_tpu_torch.models import transformer as tt

    recipe = chip_smoke.RECIPES["bert"]
    n_mask = 16

    def build(f, mod):
        cfg = mod.bert_base(vocab_size=30522, d_model=args.d_model,
                            n_heads=max(args.d_model // 64, 1),
                            n_layers=args.layers, d_ff=4 * args.d_model,
                            max_seq_len=args.len, dropout=0.0,
                            attn_dropout=0.0, use_flash=True)
        L = f.layers
        main, startup = f.Program(), f.Program()
        startup.random_seed = 11
        f.clip.set_gradient_clip(f.clip.GradientClipByGlobalNorm(1.0))
        try:
            with f.program_guard(main, startup), f.unique_name.guard():
                lr = L.linear_lr_warmup(L.polynomial_decay(
                    recipe["lr"], decay_steps=recipe["decay_steps"],
                    end_learning_rate=0.0, power=recipe["power"]),
                    warmup_steps=recipe["warmup"], start_lr=0.0,
                    end_lr=recipe["lr"])
                loss, _ = mod.build_train_mlm(
                    cfg, 1, args.len, n_mask, lr=lr,
                    optimizer_cls=functools.partial(
                        f.optimizer.AdamW, weight_decay=0.01, epsilon=1e-6))
        finally:
            f.clip.set_gradient_clip(None)
        return main, startup, loss

    (mj, sj, lj), (mt, _, lt) = build(fj, tj), build(ft, tt)
    init = _jax_init(sj)
    init["@STEP_COUNTER@"] = np.array([9998], np.int32)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, 30522, (1, args.len)).astype(np.int64)
    pos = rng.choice(args.len, n_mask, replace=False).astype(np.int32)
    feed = {"tokens": toks, "mask_pos": pos,
            "mask_label": toks.reshape(-1)[pos].reshape(-1, 1)}
    noise = np.random.RandomState(5).randn(*init["word_emb"].shape)
    moved = dict(init, word_emb=(init["word_emb"] * (1 + args.pert * noise))
                 .astype(np.float32))
    names = [p.name for p in mt.all_parameters()]

    def jax_updates(state):
        scope = fj.Scope()
        for k, v in state.items():
            scope.set(k, v)
        exe = fj.Executor(fj.CPUPlace())
        with fj.scope_guard(scope):
            losses = [float(np.asarray(exe.run(mj, feed=feed,
                                               fetch_list=[lj])[0]))
                      for _ in range(args.steps)]
        return losses, {n: np.asarray(scope.get(n)) - state[n]
                        for n in names}

    scope = scope_from_numpy(init, ft.Scope(), ft.CPUPlace(), program=mt)
    exe = ft.Executor(ft.CPUPlace())
    lt_ = [float(exe.run(mt, feed=feed, fetch_list=[lt.name],
                         scope=scope)[0]) for _ in range(args.steps)]
    port = {n: scope.get_numpy(n) - init[n] for n in names}
    lj_, jax = jax_updates(init)
    _, pert = jax_updates(moved)
    print(f"losses: jax {lj_} port {lt_}")
    top = {"port_update": 0.0, "jax_pert_update": 0.0}
    for n in names:
        row = {"port_update": _fro(port[n], jax[n]),
               "jax_pert_update": _fro(pert[n], jax[n])}
        print(f"{n:28s} " + " ".join(f"{k} {v:.3e}" for k, v in row.items()))
        if n.endswith(".k.b"):
            continue  # zero gradient but for rounding
        for k, v in row.items():
            top[k] = max(top[k], v)
    print("max " + " ".join(f"{k} {v:.3e}" for k, v in top.items()))
    return 0


def _se_resnext(args):
    from paddle_tpu.models import se_resnext as sj
    from paddle_tpu_torch.models import se_resnext as st

    def build(f, mod):
        main, startup = f.Program(), f.Program()
        startup.random_seed = 11
        drop = f.layers.dropout
        f.layers.dropout = lambda x, dropout_prob, **kw: drop(x, 0.0, **kw)
        try:
            with f.program_guard(main, startup), f.unique_name.guard():
                loss, _ = mod.build_train(
                    img_shape=(3, 32, 32), class_dim=10,
                    layers_per_stage=(1, 1), cardinality=4, base_ch=32,
                    lr=0.01)
        finally:
            f.layers.dropout = drop
        return main, startup, loss

    (mj, startup, lj), (mt, _, lt) = build(fj, sj), build(ft, st)
    init = _jax_init(startup)
    rng = np.random.RandomState(0)
    feed = {"image": rng.randn(args.batch, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (args.batch, 1)).astype(np.int64)}
    noise = np.random.RandomState(5).randn(*feed["image"].shape)
    moved = dict(feed, image=(feed["image"] * (1 + args.pert * noise))
                 .astype(np.float32))
    names = sorted(p.name for p in mt.all_parameters())
    fetch = [f"{p}@GRAD" for p in names]

    def jax_run(fd):
        scope = fj.Scope()
        for k, v in init.items():
            scope.set(k, v)
        with fj.scope_guard(scope):
            exe = fj.Executor(fj.CPUPlace())
            out = [exe.run(mj, feed=fd, fetch_list=[lj.name] + fetch)
                   for _ in range(args.steps)]
            after = {n: np.asarray(scope.get(n)) for n in names}
        return [np.asarray(x, np.float32) for x in out[0]], \
            [float(o[0]) for o in out], after

    def port_run(fd):
        scope = scope_from_numpy(init, ft.Scope(), ft.CPUPlace())
        exe = ft.Executor(ft.CPUPlace())
        out = [exe.run(mt, feed=fd, fetch_list=[lt.name] + fetch,
                       scope=scope) for _ in range(args.steps)]
        return [np.asarray(x, np.float32) for x in out[0]], \
            [float(o[0]) for o in out], \
            {n: scope.get_numpy(n) for n in names}

    (jg, jl, ja), (pg, pl, pa) = jax_run(feed), jax_run(moved)
    tg, tl, ta = port_run(feed)
    print(f"losses: jax {jl} moved {pl} port {tl}; largest gap port "
          f"{max(abs(a - b) / abs(b) for a, b in zip(tl, jl)):.3e} "
          f"moved {max(abs(a - b) / abs(b) for a, b in zip(pl, jl)):.3e}")
    keys = ("port_f32", "jax_pert", "port_update", "jax_pert_update")
    top = dict.fromkeys(keys, 0.0)
    for i, n in enumerate(names, 1):
        step = ja[n] - init[n]
        row = dict(zip(keys, (_fro(tg[i], jg[i]), _fro(pg[i], jg[i]),
                              _fro(ta[n] - init[n], step),
                              _fro(pa[n] - init[n], step))))
        print(f"{n:28s} " + " ".join(f"{k} {v:.3e}" for k, v in row.items()))
        for k, v in row.items():
            top[k] = max(top[k], v)
    print("max " + " ".join(f"{k} {v:.3e}" for k, v in top.items()))
    return 0


def _chip_smoke():
    """chip_smoke.py (the repository root's), loaded by path."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), os.pardir, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _moved(init, names, pert):
    """init with each of `names` times 1 + pert of seeded noise."""
    out = dict(init)
    for i, n in enumerate(names):
        noise = np.random.RandomState(5 + i).randn(*init[n].shape)
        out[n] = (init[n] * (1 + pert * noise)).astype(init[n].dtype)
    return out


def _float32_step(progs, init, moved, feeds, fetch):
    """One step of the JAX program from `init` and from `moved`, and of
    the port's from `init`, fetching `fetch`: (jax, jax moved, port)
    lists of float32 numpy."""
    (mj, lj), (mt, lt) = progs

    def jax_run(state, feed):
        scope = fj.Scope()
        for k, v in state.items():
            scope.set(k, v)
        with fj.scope_guard(scope):
            out = fj.Executor(fj.CPUPlace()).run(
                mj, feed=feed, fetch_list=[lj.name] + fetch)
        return [np.asarray(x, np.float32) for x in out]

    scope = scope_from_numpy(init, ft.Scope(), ft.CPUPlace())
    port = ft.Executor(ft.CPUPlace()).run(
        mt, feed=feeds[1], fetch_list=[lt.name] + fetch, scope=scope)
    return jax_run(init, feeds[0]), jax_run(moved, feeds[0]), \
        [np.asarray(x, np.float32) for x in port]


def _print_float32(names, jg, pg, tg):
    keys = ("port_f32", "jax_pert")
    print(f"loss: jax {jg[0]} moved {pg[0]} port {tg[0]}; gap port "
          f"{abs(tg[0] - jg[0]) / abs(jg[0]):.3e} moved "
          f"{abs(pg[0] - jg[0]) / abs(jg[0]):.3e}")
    top = dict.fromkeys(keys, 0.0)
    for i, n in enumerate(names, 1):
        row = dict(zip(keys, (_fro(tg[i], jg[i]), _fro(pg[i], jg[i]))))
        print(f"{n:28s} " + " ".join(f"{k} {v:.3e}" for k, v in row.items()))
        for k, v in row.items():
            top[k] = max(top[k], v)
    if names:
        print("max " + " ".join(f"{k} {v:.3e}" for k, v in top.items()))
    return 0


def _seq2seq(args):
    c = _chip_smoke()
    c.S2S_HIDDEN, c.S2S_EMB, c.S2S_VOCAB, c.S2S_LEN = \
        args.hidden, args.emb, args.vocab, args.len
    (mj, startup, lj), (mt, _, lt) = c.build_seq2seq(fj), c.build_seq2seq(ft)
    init = _jax_init(startup)
    params = [p.name for p in mt.all_parameters()]
    names = [n for n in params if n in c.S2S_CHECK_GRADS] + [params[-2], [
        n for n in params if n.startswith("GRUCell") and
        n.endswith(".w_0")][-1]]
    feed = c.seq2seq_feed(args.batch, seed=1)
    moved = _moved(init, list(c.S2S_CHECK_GRADS), args.pert)
    jg, pg, tg = _float32_step(((mj, lj), (mt, lt)), init, moved,
                               (feed, feed), [f"{n}@GRAD" for n in names])
    return _print_float32(names, jg, pg, tg)


def _sentiment(args):
    c = _chip_smoke()
    from paddle_tpu_torch.datasets import imdb
    vocab = len(imdb.word_dict())
    mj, startup, lj, vj = c.build_sentiment(fj, vocab)
    mt, _, lt, vt = c.build_sentiment(ft, vocab)
    init = _jax_init(startup)
    feeds = (c.imdb_batches(fj, mj, vj, 1, args.batch)[0],
             c.imdb_batches(ft, mt, vt, 1, args.batch)[0])
    emb = [n for n in init if n.startswith("embedding")]
    jg, pg, tg = _float32_step(((mj, lj), (mt, lt)), init,
                               _moved(init, emb, args.pert), feeds, [])
    return _print_float32([], jg, pg, tg)


def _dp(args):
    import os
    import tempfile
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), os.pardir))
    import chip_smoke
    from paddle_tpu_torch.distributed.spawn import RankPool
    tmp = tempfile.TemporaryDirectory()
    path = lambda name: os.path.join(tmp.name, name)  # noqa: E731
    spec = {"cfg": dict(n_layers=args.layers, d_model=args.d_model,
                        n_heads=max(args.d_model // 64, 1),
                        d_ff=4 * args.d_model, max_seq_len=args.len),
            "batch": args.batch, "T": args.len, "amp": True, "flash": False,
            "place": "cpu", "steps": args.steps, "mesh": None,
            "init": path("init.npz"), "ref": None, "out": None}
    chip_smoke.dp_startup_state(spec, spec["init"])
    one = chip_smoke.dp_train_run({**spec, "out": path("one.npz")})
    init = dict(np.load(spec["init"]))
    params = set(np.load(path("one.npz")).files)
    rng = np.random.RandomState(0)
    moved = {k: (v * (1 + args.pert * rng.randn(*v.shape))).astype(v.dtype)
             if k in params else v for k, v in init.items()}
    np.savez(path("moved.npz"), **moved)
    pert = chip_smoke.dp_train_run({**spec, "init": path("moved.npz"),
                                    "ref": path("one.npz")})
    runs = [("moved_init", pert)]
    with RankPool(2, path("store")) as pool:
        for control in (None, *chip_smoke.DP_CONTROLS):
            runs.append((control or "two_ranks", pool.run(
                chip_smoke.dp_train_run, {**spec, "ref": path("one.npz"),
                                          "control": control})[0]))
    for tag, res in runs:
        loss, update, grad = chip_smoke._dp_gaps(res, one["losses"],
                                                 one["grad"])
        print(f"{tag}: loss_gap={loss:.3e} update_gap={update:.3e} "
              f"grad_gap={grad:.3e} param_gap={res['param_gap']:.3e}")
    tmp.cleanup()


def _chip_importable():
    """chip_smoke.py imported by name from the repository root, so the
    rank processes find the functions the pool sends them."""
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), os.pardir))
    import chip_smoke
    return chip_smoke


def _chip_pool_runs(fn, spec, variants):
    """chip_smoke's one-rank run of `spec` (and moved by spec["pert"]),
    then each variant ({spec changes}) over two gloo ranks: [(tag, the
    one-rank result, rank 0's result)]."""
    import os
    import tempfile
    c = _chip_importable()
    from paddle_tpu_torch.distributed.spawn import RankPool
    tmp = tempfile.TemporaryDirectory()
    one = fn(spec)
    init = dict(np.load(spec["init"]))
    # the parameters only (optimizer state moved too can overflow)
    params = set(np.load(spec["out"]).files) if spec.get("out") else \
        {k for k, v in init.items() if v.dtype.kind == "f"}
    rng = np.random.RandomState(0)
    moved = {k: (v * (1 + spec["pert"] * rng.randn(*v.shape)))
             .astype(v.dtype) if k in params else v
             for k, v in init.items()}
    np.savez(os.path.join(tmp.name, "moved.npz"), **moved)
    runs = [("moved_init", fn({**spec, "out": None, "init": os.path.join(
        tmp.name, "moved.npz")}))]
    with RankPool(2, os.path.join(tmp.name, "store"),
                  timeout_s=600.0) as pool:
        for tag, change in variants:
            runs.append((tag, pool.run(getattr(c, fn.__name__),
                                       {**spec, **change})[0]))
    tmp.cleanup()
    return one, runs


def _startup_npz(ptt, startup, path):
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    np.savez(path, **{n: scope.get_numpy(n) for n in scope.names()})


def _tp(args):
    import os
    import tempfile
    c = _chip_importable()
    tmp = tempfile.TemporaryDirectory()
    spec = {"cfg": dict(n_layers=args.layers, d_model=args.d_model,
                        n_heads=max(args.d_model // 64, 2),
                        d_ff=4 * args.d_model, max_seq_len=args.len),
            "T": args.len, "batch": args.batch, "steps": args.steps,
            "place": "cpu", "flash": False, "mesh": None,
            "batch_axes": ["dp"], "init": os.path.join(tmp.name, "i.npz"),
            "ref": None, "out": os.path.join(tmp.name, "one.npz"),
            "control": None, "save": None, "pert": args.pert}
    _, _, startup, _ = c._mp_build(ft, spec)
    _startup_npz(ft, startup, spec["init"])
    ref = {"ref": spec["out"], "out": None}
    one, runs = _chip_pool_runs(c.mp_train_run, spec, [
        ("tp2", {"mesh": "1,2", **ref}),
        ("fsdp2", {"mesh": "1,1,2", "batch_axes": ["fsdp"], **ref}),
        *[(k, {"mesh": "1,2", "control": k, **ref})
          for k in c.MP_CONTROLS],
        ("fsdp_rs_unscaled", {"mesh": "1,1,2", "batch_axes": ["fsdp"],
                              "control": "fsdp_rs_unscaled", **ref})])
    for tag, res in runs:
        if res.get("update_gap") is None:
            res["update_gap"] = float("nan")
        loss, update, grad = c._dp_gaps(res, one["losses"], one["grad"])
        print(f"{tag}: loss_gap={loss:.3e} update_gap={update:.3e} "
              f"grad_gap={grad:.3e}")
    tmp.cleanup()


def _ring(args):
    import os
    import tempfile
    c = _chip_importable()
    tmp = tempfile.TemporaryDirectory()
    dims = (args.len, args.d_model, args.heads, args.vocab)
    spec = {"scheme": "ring", "dims": dims, "steps": args.steps,
            "sp": False, "place": "cpu", "pert": args.pert,
            "init": os.path.join(tmp.name, "i.npz")}
    _, startup, _ = c._long_context(ft, "ring", dims=dims)
    _startup_npz(ft, startup, spec["init"])
    one, runs = _chip_pool_runs(c.seq_train_run, spec, [
        ("ring_sp2", {"sp": True}),
        ("ulysses_sp2", {"sp": True, "scheme": "ulysses"}),
        ("ring_no_offdiag", {"sp": True, "control": "no_offdiag"})])
    for tag, res in runs:
        loss = max(abs(a - b) for a, b in zip(res["losses"],
                                              one["losses"]))
        grad = float(np.linalg.norm(res["grad"] - one["grad"])
                     / np.linalg.norm(one["grad"]))
        print(f"{tag}: loss_gap={loss:.3e} grad_gap={grad:.3e}")
    tmp.cleanup()


def _moe(args):
    import os
    import tempfile
    c = _chip_importable()
    tmp = tempfile.TemporaryDirectory()
    dims = (args.d_model, 4 * args.d_model, args.experts, args.batch,
            args.len)
    cap = int(1.25 * args.batch * args.len / args.experts)
    spec = {"capacity": None, "dims": dims, "steps": args.steps,
            "ep": False, "place": "cpu", "pert": args.pert,
            "init": os.path.join(tmp.name, "i.npz")}
    _, startup, *_ = c._moe_build(ft, None, dims)
    _startup_npz(ft, startup, spec["init"])
    one, runs = _chip_pool_runs(c.moe_train_run, spec, [
        ("dense_ep2", {"ep": True}),
        ("sparse_ep2", {"ep": True, "capacity": cap}),
        ("g_bwd_allreduce", {"ep": True, "control": "g_bwd_allreduce"})])
    ref = one["y"].reshape(-1, args.d_model)
    for tag, res in runs:
        rows = res["y"].reshape(-1, args.d_model)
        zero = np.all(rows == 0.0, axis=-1) if tag.startswith("sparse") \
            else np.zeros(len(rows), bool)
        err = float(np.abs(rows[~zero] - ref[~zero]).max()
                    / np.abs(ref).max())
        loss = max(abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                       one["losses"]))
        grad = c._grad_gap(res["grad"], one["grad"], 0)
        print(f"{tag}: loss_rel_gap={loss:.3e} kept_rel_err={err:.3e} "
              f"grad_gap={grad:.3e} "
              f"dropped_rows={int(zero.sum())} of {len(rows)}")
    tmp.cleanup()


def _pp(args):
    import os
    import tempfile
    c = _chip_importable()
    from paddle_tpu_torch.distributed.spawn import RankPool
    tmp = tempfile.TemporaryDirectory()
    one_npz = os.path.join(tmp.name, "one.npz")
    dims = {"d": args.d_model, "heads": max(args.d_model // 64, 2),
            "ff": 4 * args.d_model, "layers": args.layers,
            "batch": args.batch, "T": args.len, "micro": args.micro}
    with RankPool(2, os.path.join(tmp.name, "store"),
                  timeout_s=600.0) as pool:
        for amp in (False, True):
            spec = {"place": "cpu", "amp": amp, "steps": args.steps,
                    "pipe": False, "control": None, **dims}
            one = c.pp_train_run({**spec, "out": one_npz})
            runs = [("moved_input", [c.pp_train_run(
                {**spec, "pert": args.pert, "ref": one_npz})])]
            for tag, ctl in (("pp2", None),
                             *((k, k) for k in c.PP_CONTROLS)):
                runs.append((tag, pool.run(c.pp_train_run, {
                    **spec, "pipe": True, "control": ctl,
                    "ref": one_npz})))
            for tag, ranks in runs:
                gaps = [c.pp_gaps(r, one) for r in ranks]
                print(f"{'amp' if amp else 'f32'} {tag}: loss_gap="
                      f"{max(g[0] for g in gaps):.3e} grad_gap="
                      f"{max(g[1] for g in gaps):.3e}")
    loss, grad, _, _, _ = c.section_pipeline_run(
        {"place": "cpu", "split": (args.layers // 2, args.layers // 4,
                                   args.layers - 3 * args.layers // 4),
         **dims})
    print(f"section_pipeline f32: loss_gap={loss:.3e} grad_gap={grad:.3e}")
    tmp.cleanup()


def _srl(args):
    c = _chip_importable()
    main, startup, loss, _, _ = c._srl_program(ft)
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: scope.get_numpy(n) for n in scope.names()}
    feeds = c.srl_feeds(2)
    runs = {}
    for tag, state in (("base", init),
                       ("moved", _moved(init, ["emb", "vemb"], args.pert))):
        sc = scope_from_numpy(state, ft.Scope(), ft.CPUPlace(),
                              program=main)
        runs[tag] = [float(exe.run(main, feed=feeds[i % 2],
                                   fetch_list=[loss], scope=sc)[0])
                     for i in range(args.steps)]
    gap = max(abs(a - b) / abs(b) for a, b in zip(runs["moved"],
                                                  runs["base"]))
    print(f"losses {runs['base']}; moved by {args.pert}: loss_rel_gap="
          f"{gap:.3e}")


def _jax_init(startup):
    scope = fj.Scope()
    with fj.scope_guard(scope):
        fj.Executor(fj.CPUPlace()).run(startup)
    return {n: np.asarray(scope.get(n)) for n in scope.names()
            if scope.find_var(n) is not None}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="model", required=True)
    r = sub.add_parser("resnet")
    r.add_argument("--batch", type=int, default=4)
    r.add_argument("--branch-scale", type=float, default=1.0)
    n = sub.add_parser("nmt")
    n.add_argument("--d-model", type=int, default=128)
    n.add_argument("--layers", type=int, default=2)
    n.add_argument("--vocab", type=int, default=32000)
    n.add_argument("--len", type=int, default=256)
    d = sub.add_parser("deeplab")
    d.add_argument("--hw", type=int, default=33)
    d.add_argument("--batch", type=int, default=2)
    d.add_argument("--branch-scale", type=float, default=1.0)
    b = sub.add_parser("recipe")
    b.add_argument("--d-model", type=int, default=128)
    b.add_argument("--layers", type=int, default=2)
    b.add_argument("--len", type=int, default=128)
    b.add_argument("--steps", type=int, default=2)
    b.add_argument("--pert", type=float, default=1e-6)
    s = sub.add_parser("se_resnext")
    s.add_argument("--batch", type=int, default=4)
    s.add_argument("--steps", type=int, default=2)
    s.add_argument("--pert", type=float, default=1e-6)
    q = sub.add_parser("seq2seq")
    q.add_argument("--batch", type=int, default=4)
    q.add_argument("--pert", type=float, default=1e-6)
    q.add_argument("--hidden", type=int, default=1000)
    q.add_argument("--emb", type=int, default=620)
    q.add_argument("--vocab", type=int, default=30000)
    q.add_argument("--len", type=int, default=50)
    g = sub.add_parser("dp")
    g.add_argument("--d-model", type=int, default=256)
    g.add_argument("--layers", type=int, default=2)
    g.add_argument("--len", type=int, default=128)
    g.add_argument("--batch", type=int, default=8)
    g.add_argument("--steps", type=int, default=5)
    g.add_argument("--pert", type=float, default=1e-3)
    t = sub.add_parser("tp")
    t.add_argument("--d-model", type=int, default=128)
    t.add_argument("--layers", type=int, default=2)
    t.add_argument("--len", type=int, default=128)
    t.add_argument("--batch", type=int, default=4)
    t.add_argument("--steps", type=int, default=3)
    t.add_argument("--pert", type=float, default=1e-3)
    rg = sub.add_parser("ring")
    rg.add_argument("--len", type=int, default=512)
    rg.add_argument("--d-model", type=int, default=128)
    rg.add_argument("--heads", type=int, default=4)
    rg.add_argument("--vocab", type=int, default=1000)
    rg.add_argument("--steps", type=int, default=3)
    rg.add_argument("--pert", type=float, default=1e-3)
    mo = sub.add_parser("moe")
    mo.add_argument("--d-model", type=int, default=64)
    mo.add_argument("--experts", type=int, default=8)
    mo.add_argument("--batch", type=int, default=4)
    mo.add_argument("--len", type=int, default=64)
    mo.add_argument("--steps", type=int, default=3)
    mo.add_argument("--pert", type=float, default=1e-3)
    sr = sub.add_parser("srl")
    sr.add_argument("--steps", type=int, default=3)
    sr.add_argument("--pert", type=float, default=1e-6)
    pp = sub.add_parser("pp")
    pp.add_argument("--d-model", type=int, default=128)
    pp.add_argument("--layers", type=int, default=4)
    pp.add_argument("--len", type=int, default=128)
    pp.add_argument("--batch", type=int, default=8)
    pp.add_argument("--micro", type=int, default=4)
    pp.add_argument("--steps", type=int, default=3)
    pp.add_argument("--pert", type=float, default=1e-3)
    m = sub.add_parser("sentiment")
    m.add_argument("--batch", type=int, default=128)
    m.add_argument("--pert", type=float, default=1e-6)
    args = ap.parse_args(argv)
    if args.model in ("seq2seq", "sentiment"):
        return {"seq2seq": _seq2seq, "sentiment": _sentiment}[args.model](
            args)
    if args.model == "recipe":
        return _recipe(args)
    if args.model == "dp":
        return _dp(args)
    if args.model == "pp":
        return _pp(args)
    if args.model == "srl":
        return _srl(args)
    if args.model in ("tp", "ring", "moe"):
        return {"tp": _tp, "ring": _ring, "moe": _moe}[args.model](args)
    if args.model == "se_resnext":
        return _se_resnext(args)
    progs, init, base, moved = {"resnet": _resnet, "nmt": _nmt,
                                "deeplab": _deeplab}[args.model](args)
    names = [p.name for p in progs["t", False][0].all_parameters()]
    fetch = [f"{p}@GRAD" for p in names]

    def jax_step(amp, state_feed):
        state, feed = state_feed
        main, _, loss = progs["j", amp]
        scope = fj.Scope()
        for k, v in state.items():
            scope.set(k, v)
        with fj.scope_guard(scope):
            out = fj.Executor(fj.CPUPlace()).run(
                main, feed=feed, fetch_list=[loss.name] + fetch)
        return [np.asarray(x, np.float32) for x in out]

    def port_step(amp, state_feed):
        state, feed = state_feed
        main, _, loss = progs["t", amp]
        scope = scope_from_numpy(state, ft.Scope(), ft.CPUPlace())
        out = ft.Executor(ft.CPUPlace()).run(
            main, feed=feed, fetch_list=[loss.name] + fetch, scope=scope)
        return [np.asarray(x, np.float32) for x in out]

    ja, jp, j32 = jax_step(True, base), jax_step(True, moved), \
        jax_step(False, base)
    ta, t32 = port_step(True, base), port_step(False, base)
    print(f"loss: jax amp {ja[0]} moved {jp[0]} f32 {j32[0]}; "
          f"port amp {ta[0]} f32 {t32[0]}")
    top = dict.fromkeys(READINGS, 0.0)
    for i, name in enumerate(names, 1):
        row = dict(zip(READINGS, (_fro(ta[i], ja[i]), _fro(jp[i], ja[i]),
                                  _fro(ja[i], j32[i]), _fro(ta[i], j32[i]),
                                  _fro(t32[i], j32[i]))))
        print(f"{name:28s} " + " ".join(f"{k} {v:.3e}"
                                        for k, v in row.items()))
        if name.endswith(".k.b"):
            continue  # zero but for rounding: softmax ignores the shift
        for k, v in row.items():
            top[k] = max(top[k], v)
    print("max " + " ".join(f"{k} {v:.3e}" for k, v in top.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
