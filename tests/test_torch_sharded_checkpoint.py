"""Sharded checkpoints (io_sharded.py) across the packages: a checkpoint
the JAX package writes from its dp4 x tp2 mesh loads in the port at one
rank and at two (each rank reading only the shards that cover its own),
a checkpoint two port ranks write at tp2 loads in the JAX package, and
the op-version gate refuses a newer program (tests/
test_sharded_checkpoint.py).
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
import torch_parallel_jobs as jobs
from torch_parallel_pool import make_pool_fixture

pool = make_pool_fixture()


def _jax_saved(path):
    """The JAX package's test run: one Adam step on dp4 x tp2, saved.
    Returns {state: value} after the step."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    def spec_fn(name):
        return {"w_col": P(None, "tp"), "w_row": P("tp", None)}.get(name)
    main, startup, loss = jobs.ckpt_build(fj)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("dp", "tp"))
    scope = fj.Scope()
    exe = fj.Executor()
    with fj.scope_guard(scope):
        exe.run(startup)
        compiled = fj.CompiledProgram(main).with_distributed(
            mesh, state_spec_fn=spec_fn, batch_axes=("dp",))
        exe.run(compiled, feed=jobs.ckpt_feed(), fetch_list=[loss])
        fj.save_sharded_persistables(exe, str(path), main, scope=scope)
    return {v.name: np.asarray(scope.get_numpy(v.name))
            for v in main.list_vars() if v.persistable
            and scope.find_var(v.name) is not None}


def test_jax_checkpoint_loads_in_the_port_at_one_rank(tmp_path):
    want = _jax_saved(tmp_path)
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("w_col__")]) == 2
    main, _, _ = jobs.ckpt_build(ft)
    scope = ft.Scope()
    man = ft.load_sharded_persistables(ft.Executor(ft.CPUPlace()),
                                       str(tmp_path), main, scope=scope)
    assert man["vars"]["w_col"]["spec"] == [None, "tp"]
    for n, v in want.items():
        np.testing.assert_array_equal(scope.get_numpy(n), v, err_msg=n)


def test_jax_checkpoint_loads_in_the_port_at_two_ranks(pool, tmp_path):
    """Each rank reads its own shard: w_col's columns and w_row's rows
    (the specs' tp split), the Adam moments with them; the values
    gathered equal the JAX package's, and one more step runs."""
    want = _jax_saved(tmp_path)
    got = pool.run(jobs.ckpt_load, str(tmp_path))
    for shapes, _, lv in got:
        assert shapes["w_col"] == (8, 8) and shapes["w_row"] == (8, 1)
        assert shapes["w_col_moment1_0"] == (8, 8)
        assert shapes["b1"] == (16,)
        assert np.isfinite(lv)
    (_, v0, _), (_, v1, _) = got
    for n, v in want.items():
        if n in ("w_col", "w_col_moment1_0", "w_col_moment2_0"):
            whole = np.concatenate([v0[n], v1[n]], axis=1)
        elif n in ("w_row", "w_row_moment1_0", "w_row_moment2_0"):
            whole = np.concatenate([v0[n], v1[n]], axis=0)
        else:
            whole = v0[n]
            np.testing.assert_array_equal(v1[n], v, err_msg=n)
        np.testing.assert_array_equal(whole, v, err_msg=n)


def test_port_checkpoint_loads_in_jax(pool, tmp_path):
    """Two port ranks at tp2 write their distinct shards (rank 0 the
    manifest, rank 1 manifest.1.json); the JAX package loads them whole
    and on its dp4 x tp2 mesh with the saved specs, equal to the port's
    gathered state, and runs a step from it."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    main, startup, loss = jobs.ckpt_build(fj)
    scope = fj.Scope()
    with fj.scope_guard(scope):
        fj.Executor().run(startup)
        init = {v.name: np.asarray(scope.get_numpy(v.name))
                for v in main.list_vars() if v.persistable
                and scope.find_var(v.name) is not None}
    got = pool.run(jobs.ckpt_save, init, str(tmp_path))
    (l0, values, shapes0), (l1, _, shapes1) = got
    assert l0 == l1 and shapes0["w_col"] == (8, 8)
    files = sorted(os.listdir(tmp_path))
    assert [f for f in files if f.startswith("w_col__")] == \
        ["w_col__shard0_0.npy", "w_col__shard1_0.npy"]
    assert "manifest.1.json" in files
    man = json.load(open(tmp_path / "manifest.json"))
    assert man["vars"]["w_col"]["spec"] == [None, "tp"]
    assert man["vars"]["w_row"]["spec"] == ["tp", None]
    host = fj.Scope()
    fj.load_sharded_persistables(fj.Executor(), str(tmp_path), main,
                                 mesh=None, scope=host)
    for n, v in values.items():
        np.testing.assert_array_equal(np.asarray(host.get(n)), v,
                                      err_msg=n)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("dp", "tp"))
    placed = fj.Scope()
    fj.load_sharded_persistables(fj.Executor(), str(tmp_path), main,
                                 mesh=mesh, scope=placed)
    w = placed.get("w_col")
    assert w.sharding == NamedSharding(mesh, P(None, "tp"))
    np.testing.assert_array_equal(np.asarray(w), values["w_col"])


def test_op_version_gate_refuses_newer_program(tmp_path):
    main, _, _ = jobs.ckpt_build(ft)
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    for n in ("w_col", "b1", "w_row", "b2"):
        scope.set(n, __import__("torch").zeros(
            main.global_block().var(n).shape))
    man = ft.save_sharded_persistables(exe, str(tmp_path), main,
                                       scope=scope)
    assert man["op_versions"]["mul"] == 1
    man["op_versions"]["mul"] = 9
    (tmp_path / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(RuntimeError, match="mul"):
        ft.load_sharded_persistables(exe, str(tmp_path), main,
                                     scope=ft.Scope())
    d = main.to_dict()
    d["op_versions"]["mul"] = 9
    with pytest.raises(RuntimeError, match="mul"):
        ft.Program.from_dict(d)
