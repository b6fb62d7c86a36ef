"""Shared by the analysis and graph-pass CPU tests of the port: the tiny
training builds of BERT, GPT, ResNet-50, the Transformer (NMT), DeepLab
and SE-ResNeXt in both packages, seeded feeds for them, crafted programs
from raw Operator appends, and finding keys to compare."""
import functools

import numpy as np

import paddle_tpu as fj
import paddle_tpu_torch as ft

B = 2


def pkg_mod(f, name):
    from importlib import import_module
    return import_module(f"{f.__name__}.models.{name}")


def _bert(f, amp):
    t = pkg_mod(f, "transformer")
    cfg = t.bert_base(vocab_size=100, d_model=64, n_heads=2, n_layers=2,
                      d_ff=128, max_seq_len=64, use_flash=True,
                      dropout=0.0, attn_dropout=0.0)
    return t.build_train(cfg, B, 64, lr=1e-3, amp=amp)[0]


def _bert_mlm(f, amp):
    t = pkg_mod(f, "transformer")
    cfg = t.bert_base(vocab_size=100, d_model=64, n_heads=2, n_layers=2,
                      d_ff=128, max_seq_len=64, use_flash=True,
                      dropout=0.1, attn_dropout=0.0)
    return t.build_train_mlm(cfg, B, 64, 8, lr=1e-3, amp=amp)[0]


def _gpt(f, amp):
    g = pkg_mod(f, "gpt")
    cfg = g.gpt_small(vocab_size=100, d_model=64, n_heads=2, n_layers=2,
                      d_ff=128, max_seq_len=65, use_flash=True,
                      dropout=0.0, attn_dropout=0.0)
    return g.build_train(cfg, B, 65, lr=1e-3, amp=amp)[0]


def _resnet(f, amp):
    return pkg_mod(f, "resnet").build_train(
        img_shape=(3, 32, 32), class_dim=10, lr=0.1, amp=amp)[0]


def _nmt(f, amp):
    m = pkg_mod(f, "nmt")
    cfg = m.transformer_big_nmt(vocab_size=100, d_model=64, n_heads=2,
                                n_layers=2, d_ff=128, dropout=0.0,
                                attn_dropout=0.0, use_flash=True)
    return m.build_train(cfg, B, 16, 8, lr=1e-3, amp=amp)[0]


def _deeplab(f, amp):
    return pkg_mod(f, "deeplab").build_train(17, B, amp=amp)[0]


def _se_resnext(f, amp):
    return pkg_mod(f, "se_resnext").build_train(
        img_shape=(3, 32, 32), class_dim=10, layers_per_stage=(1, 1),
        cardinality=4, base_ch=32, lr=0.01)[0]


# name -> (builder(f, amp) -> loss, amp)
BUILDS = {
    "bert": (_bert, False),
    "bert_mlm_amp": (_bert_mlm, True),
    "gpt_amp": (_gpt, True),
    "resnet50": (_resnet, False),
    "transformer": (_nmt, False),
    "deeplab": (_deeplab, False),
    "se_resnext": (_se_resnext, False),
}


def build(f, name):
    """(main, startup, loss name) of one tiny build in package f."""
    fn, amp = BUILDS[name]
    main, startup = f.Program(), f.Program()
    startup.random_seed = 11
    with f.program_guard(main, startup), f.unique_name.guard():
        loss = fn(f, amp)
    return main, startup, loss.name


@functools.lru_cache(maxsize=None)
def built(name):
    """Both packages' builds of `name`, built once a process: (JAX main,
    port main, port startup, loss name). The programs are byte-equal
    (asserted); callers must not mutate them."""
    mj, _, lj = build(fj, name)
    mt, st, lt = build(ft, name)
    assert mj.to_json() == mt.to_json() and lj == lt
    return mj, mt, st, lt


def feed_for(program, seed=0):
    """Seeded feeds for every data var of `program`: batch B where the
    declared dim is -1, ints in [0, 8), floats N(0, 1)."""
    rng = np.random.RandomState(seed)
    feed = {}
    for name, v in sorted(program.global_block().vars.items()):
        if not v.is_data:
            continue
        shape = [B if d == -1 else int(d) for d in v.shape]
        if "int" in v.dtype:
            feed[name] = rng.randint(0, 8, shape).astype(v.dtype)
        else:
            feed[name] = rng.randn(*shape).astype("float32")
    return feed


def feed_shapes(feed):
    """{name: (shape, IR dtype)}: int64 feeds read int32, as the JAX
    package stages them and the port's executor names them."""
    return {n: (tuple(a.shape), "int32" if a.dtype == np.int64
                else str(a.dtype)) for n, a in feed.items()}


def raw_program(f, var_specs, op_specs):
    """Program from raw Operator appends (append_op would reject some
    fixtures at build time — the verifier must catch them statically)."""
    prog = f.Program()
    blk = prog.global_block()
    for name, kw in var_specs:
        blk.create_var(name=name, **kw)
    for op_type, ins, outs, attrs in op_specs:
        blk.ops.append(f.framework.Operator(blk, op_type, ins, outs,
                                            dict(attrs)))
    return prog


def finding_keys(result):
    """Rule, severity, provenance and var of every finding, in order."""
    return [(d.rule, d.severity, d.where, d.var) for d in result.findings]


def flag_guard(f, **kv):
    """Set FLAGS_* of package f; returns the previous values to restore
    with f.set_flags."""
    names = [f"FLAGS_{k}" for k in kv]
    prev = f.get_flags(names)
    f.set_flags({f"FLAGS_{k}": v for k, v in kv.items()})
    return prev
