"""paddle_tpu_torch IR parity with paddle_tpu, and the port's import
hygiene.

A tiny encoder program built by each package serializes to the same JSON
and fingerprint, and each package's JSON loads in the other with an
unchanged fingerprint. `import paddle_tpu_torch` must not pull in JAX or
any module of the JAX package (checked in a clean subprocess and by an
AST scan of the package's sources).
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.models import transformer as tj
from paddle_tpu_torch.core import dtypes as tdt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.models import transformer as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(f, tmod, t=128, **kw):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        cfg = tmod.bert_base(vocab_size=50, d_model=32, n_heads=2,
                             n_layers=2, d_ff=64, max_seq_len=t,
                             dropout=0.1, attn_dropout=0.0, **kw)
        tok = f.layers.data("tokens", shape=[t], dtype="int64")
        tmod.encoder(tok, cfg)
    return main, startup


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("which", ["main", "startup"])
def test_programs_serialize_identically(use_flash, which):
    """Same builder, same JSON (ops, attrs, var shapes and dtypes from
    shape inference), same fingerprint."""
    pj = _build(fj, tj, use_flash=use_flash)[which == "startup"]
    pt = _build(ft, tt, use_flash=use_flash)[which == "startup"]
    assert pj.to_json() == pt.to_json()
    assert pj.fingerprint() == pt.fingerprint()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_json_round_trip_across_packages(direction):
    src, dst = (fj, ft) if direction == "jax_to_torch" else (ft, fj)
    main, _ = _build(src, tj if src is fj else tt, use_flash=True)
    loaded = dst.Program.from_json(main.to_json())
    assert loaded.fingerprint() == main.fingerprint()
    back = src.Program.from_json(loaded.to_json())
    assert back.fingerprint() == main.fingerprint()


def test_clone_for_test_matches():
    """clone(for_test=True) flips is_test on dropout and flash_attention
    in both packages alike."""
    mj = _build(fj, tj, use_flash=True)[0].clone(for_test=True)
    mt = _build(ft, tt, use_flash=True)[0].clone(for_test=True)
    assert mj.fingerprint() == mt.fingerprint()
    for op in mt.global_block().ops:
        if op.type in ("dropout", "flash_attention"):
            assert op.attrs["is_test"] is True


def test_import_leaves_out_jax_and_the_jax_package():
    code = ("import sys, paddle_tpu_torch\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', "
            "'paddle_tpu', 'ml_dtypes') or m.startswith(('jax.', "
            "'paddle_tpu.', 'jaxlib')))\n"
            "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    root = os.path.join(REPO, "paddle_tpu_torch")
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "_build"]  # kernel builds
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "paddle_tpu", "ml_dtypes"), \
            f"{path} imports {mod}"


@pytest.mark.parametrize("spec,name", [
    ("fp32", "float32"), ("bf16", "bfloat16"), ("int64", "int64"),
    (np.float32, "float32"), (np.dtype("int32"), "int32"),
    (torch.bfloat16, "bfloat16"), (torch.uint8, "uint8")])
def test_dtype_names(spec, name):
    assert tdt.convert_dtype(spec) == name
    assert tdt.convert_dtype(name) == name


def test_flags_env_bootstrap(monkeypatch):
    monkeypatch.setenv("FLAGS_serving_max_batch_size", "5")
    monkeypatch.setenv("FLAGS_check_nan_inf", "true")
    try:
        tflags.reload_from_env()
        assert tflags.FLAGS.serving_max_batch_size == 5
        assert tflags.FLAGS.check_nan_inf is True
        assert tflags.get_flags("FLAGS_serving_max_batch_size") == {
            "FLAGS_serving_max_batch_size": 5}
    finally:
        monkeypatch.delenv("FLAGS_serving_max_batch_size")
        monkeypatch.delenv("FLAGS_check_nan_inf")
        tflags.set_flags({"FLAGS_serving_max_batch_size": 8,
                          "FLAGS_check_nan_inf": False})
