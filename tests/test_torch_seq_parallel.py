"""Ring and Ulysses attention at two gloo ranks, against the JAX
package's shard_map versions on a 2-device mesh.

The port computes each ring block with the flash kernels' entry points
(their plain versions here on the CPU, the schedule the card runs) and
skips the blocks a causal mask hides; Ulysses trades the sequence split
for a head split and runs one flash attention over the whole T
(ROADMAP §C: the JAX package loops over 512-key blocks).
"""
import numpy as np
import pytest

import paddle_tpu as fj
import torch_parallel_jobs as jobs
from torch_parallel_pool import make_pool_fixture

pool = make_pool_fixture()


def _inputs(seed=5, b=2, h=4, t=64, d=16):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype(np.float32) for _ in range(4)]


def _jax(scheme, q, k, v, do, causal, mesh_axes=("sp",)):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from paddle_tpu.parallel.ring_attention import ring_attention_sharded
    from paddle_tpu.parallel.ulysses import ulysses_attention_sharded
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2), mesh_axes)
    fn = ring_attention_sharded if scheme == "ring" else \
        ulysses_attention_sharded

    @jax.jit
    def run(a, b_, c, g):
        out, vjp = jax.vjp(lambda a_, b2, c_: fn(a_, b2, c_, mesh, "sp",
                                                 causal=causal), a, b_, c)
        return out, vjp(g)

    out, grads = run(*(jnp.asarray(x) for x in (q, k, v, do)))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("scheme", ["ring", "ulysses", "ulysses_chunks"])
@pytest.mark.parametrize("causal", [True, False])
def test_seq_parallel_attention_matches_jax(pool, scheme, causal):
    """Output and dQ/dK/dV of the whole [2, 4, 64, 16] inputs over sp2
    within 2e-5 of the JAX package's, on both ranks: Ulysses on whole
    inputs (each rank on its own heads) and on sequence chunks (its
    all-to-alls)."""
    q, k, v, do = _inputs()
    want = _jax(scheme.split("_")[0], q, k, v, do, causal)
    for got in pool.run(jobs.seq_attention, scheme, q, k, v, do, causal):
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0,
                                       err_msg=name)


def test_ring_skips_the_blocks_a_causal_mask_hides():
    """A deliberate difference: rank r computes the blocks of chunks
    src <= r only (the JAX package computes every block and merges a
    fully masked one with weight 0). At sp2 rank 0 runs one block (its
    diagonal), rank 1 two."""
    from paddle_tpu_torch.parallel.ring_attention import _blocks
    assert _blocks(2, 0, True) == [(0, 0, True)]
    assert _blocks(2, 1, True) == [(0, 1, True), (1, 0, False)]
    assert _blocks(2, 0, False) == [(0, 0, False), (1, 1, False)]
    assert len(_blocks(4, 3, True)) == 4 and len(_blocks(4, 0, True)) == 1


def test_fallback_without_the_seq_axis():
    """On a mesh without `sp` the ops run flash attention over the whole
    T: equal to the JAX package's fallback (and to its sp run)."""
    import torch
    from paddle_tpu.core.registry import REGISTRY as JR
    from paddle_tpu_torch.core.registry import REGISTRY as TR
    import jax
    from jax.sharding import Mesh
    q, k, v, _ = _inputs(seed=6)

    class Ctx:
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("dp", "tp"))
    for op in ("ring_attention", "ulysses_attention"):
        want = np.asarray(JR.get(op).lower(
            Ctx(), {"Q": [q], "K": [k], "V": [v]}, {"causal": True})
            ["Out"][0])
        got = TR.get(op).lower(
            None, {"Q": [torch.tensor(q)], "K": [torch.tensor(k)],
                   "V": [torch.tensor(v)]}, {"causal": True})["Out"][0]
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_ulysses_refuses_heads_the_axis_does_not_divide(pool):
    for msg in pool.run(jobs.ulysses_refuses_odd_heads):
        assert msg and "must divide" in msg


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_long_context_program_matches_jax(pool, scheme):
    """examples/long_context.py's program (causal, T 64) with the ring
    or Ulysses op over a mesh sp2: 4 Adam steps' losses within 1e-4 of
    the JAX package's with_distributed run."""
    import jax
    from jax.sharding import Mesh
    main, startup, loss = jobs.long_context(fj, scheme)
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor()
        exe.run(startup)
        init = {v.name: np.asarray(scope.get_numpy(v.name))
                for v in main.list_vars() if v.persistable
                and scope.find_var(v.name) is not None}
        mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2), ("sp",))
        prog = fj.CompiledProgram(main).with_distributed(mesh,
                                                         batch_axes=())
        want = [float(np.asarray(exe.run(
            prog, feed=jobs.long_context_feeds(), fetch_list=[loss])[0]))
            for _ in range(4)]
    for got in pool.run(jobs.long_context_train, scheme, init, 4):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scheme", ["ring", "ulysses", "ring_bf16",
                                    "ulysses_bf16"])
def test_priced_collectives_are_the_moved_bytes(pool, scheme):
    """The long-context program over sp2, float32 and with q, k and v in
    bf16: the sharding gate's price of the rank program (the ring's K/V
    and float32 dK/dV hops, the chunking of whole inputs; Ulysses on its
    own heads) equals, to the byte, what the rank's collectives moved in
    its second step."""
    for moved, priced, kinds in pool.run(jobs.priced_and_moved, scheme):
        assert priced == moved, kinds
