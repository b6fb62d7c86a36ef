"""GradientMergeOptimizer in the port against the JAX package's, on the
CPU: a two-layer MLP under AdamW (weight decay on), k = 4 steps at batch
8 against one step at batch 32 on the same rows.

- The programs (k = 4 and k = 1) serialize to the JAX package's JSON.
- Steps 1-3 leave every parameter and every AdamW moment and beta power
  bit-equal to the startup state, in both packages; the merge buffers
  hold the summed gradients (within 1e-6 of the JAX package's).
- After step 4 the parameters are within 1e-6 of the JAX package's, and
  within 1e-5 relative (Frobenius) of one batch-32 step: the loss is a
  mean, so the mean of the four batch means is the batch-32 mean, and
  the update sees the same averaged gradient.
- After step 4 the buffers are zero again; steps 5-8 repeat the pattern.
"""
import numpy as np

from torch_seq_helpers import assert_close, build_both, fro, run_both

K = 4


def _mlp(k):
    def fn(f):
        L = f.layers
        x = L.data("x", shape=[16], dtype="float32")
        y = L.data("y", shape=[1], dtype="int64")
        h = L.fc(x, size=32, act="tanh")
        logits = L.fc(h, size=5)
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        inner = f.optimizer.AdamW(learning_rate=0.01, weight_decay=0.01)
        if k > 1:
            f.optimizer.GradientMergeOptimizer(inner, k_steps=k).minimize(
                loss)
        else:
            inner.minimize(loss)
        return [loss]
    return fn


def _rows(n=32):
    rng = np.random.RandomState(3)
    return {"x": rng.randn(n, 16).astype(np.float32),
            "y": rng.randint(0, 5, (n, 1)).astype(np.int64)}


def _micro(rows, k=K):
    n = rows["x"].shape[0] // k
    return [{key: v[i * n:(i + 1) * n] for key, v in rows.items()}
            for i in range(k)]


def test_k_steps_against_jax_and_against_one_big_batch():
    rows = _rows()
    bj, bt = build_both(_mlp(K))
    params = [p.name for p in bt[0].all_parameters()]
    state = [n for n in bt[1].global_block().vars
             if bt[1].global_block().vars[n].persistable]
    feeds = _micro(rows) * 2
    got_j, got_t, after_j, after_t = run_both(
        bj, bt, feeds[:K - 1], [bt[2][0].name])
    bufs = [n for n in after_t if "_gradient_merge" in n]
    assert len(bufs) == len(params)
    _, _, init_j, init_t = run_both(bj, bt, [], [])
    for n in after_t:
        if "_gradient_merge" in n or "@GRADIENT_MERGE_STEP@" in n:
            continue
        # the skipped steps touch no parameter and no optimizer state
        assert np.array_equal(after_t[n], init_t[n]), n
        assert np.array_equal(after_j[n], init_j[n]), n
    for n in bufs:
        assert_close([after_t[n]], [after_j[n]], 1e-6)
        assert np.abs(after_t[n]).max() > 0
    for gj, gt in zip(got_j, got_t):
        assert_close(gt, gj, 1e-6)

    _, _, after_j, after_t = run_both(bj, bt, feeds, [bt[2][0].name])
    for n in state:
        assert_close([after_t[n]], [after_j[n]], 1e-6)
    for n in bufs:
        assert not after_t[n].any()

    _, _, after_j4, after_t4 = run_both(bj, bt, feeds[:K], [])
    big_j, big_t = build_both(_mlp(1))
    _, _, one_j, one_t = run_both(big_j, big_t, [rows], [])
    for p in params:
        assert fro(after_t4[p], one_t[p]) < 1e-5, p
        assert fro(after_j4[p], one_j[p]) < 1e-5, p
        assert not np.array_equal(after_t4[p], init_t[p]), p
