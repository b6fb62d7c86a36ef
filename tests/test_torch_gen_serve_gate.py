"""chip_smoke.py's [gen_serve] spec-on against spec-off gate for sampled
streams (spec_flip_gate), and the DrawRecorder that feeds it, on the CPU.

A sampled request draws u from its RandomState and picks the first
token whose CDF exceeds u. Spec on, the logits come from the verify
step, spec off from decode, at other batch shapes, so the two rows can
round apart; where u falls between the two CDFs the tokens differ. The
gate passes that one flip and nothing else: a flip whose u lies far from
the boundary, rows further apart than 1e-4, or a difference with no draw
behind it fail.
"""
import numpy as np
import pytest

from torch_dense_helpers import chip_smoke


def _draw(row, u, temperature=1.0, top_k=0):
    """A recorded draw of `row` with uniform `u`: the token the CDF
    gives."""
    cdf = chip_smoke.sample_cdf(np.asarray(row, np.float32), temperature,
                                top_k)
    tok = int(np.searchsorted(cdf, u, side="right"))
    return (np.asarray(row, np.float32), temperature, top_k, u, tok)


ROW_OFF = [0.0, 0.0, -1.0, -3.0]
# the on row: token 0's logit 2e-5 higher, within the 1e-4 bar
ROW_ON = [2e-5, 0.0, -1.0, -3.0]


def _cdf0(row):
    return float(chip_smoke.sample_cdf(np.asarray(row, np.float32), 1.0,
                                       0)[0])


def test_equal_streams_pass():
    ok, flip = chip_smoke.spec_flip_gate([1, 2, 3], [1, 2, 3], [], [])
    assert ok and flip is None


def test_an_explained_flip_passes():
    u = 0.5 * (_cdf0(ROW_OFF) + _cdf0(ROW_ON))  # between the two CDFs
    early = _draw([0.0, 5.0, 0.0, 0.0], 0.7)
    off = [early, _draw(ROW_OFF, u)]
    on = [early, _draw(ROW_ON, u)]
    assert off[1][4] == 1 and on[1][4] == 0  # the flip
    # after the flip the streams part entirely; nothing there is read
    ok, flip = chip_smoke.spec_flip_gate([1, 1, 3, 3], [1, 0, 2, 0], off,
                                         on)
    assert ok, flip
    assert flip["index"] == 1
    assert flip["margin"] <= flip["gap"] + 1e-6
    assert flip["logit_gap"] == pytest.approx(2e-5, rel=1e-3)


def test_a_flip_with_u_far_from_the_boundary_fails():
    # the same rows, u well inside token 0's share: both runs would draw
    # token 0, yet the recorded tokens differ
    u = 0.2
    off = [(np.asarray(ROW_OFF, np.float32), 1.0, 0, u, 1)]
    on = [_draw(ROW_ON, u)]
    ok, flip = chip_smoke.spec_flip_gate([1], [on[0][4]], off, on)
    assert not ok
    assert flip["margin"] > flip["gap"] + 1e-6


def test_rows_further_apart_than_the_bar_fail():
    far = [3e-4, 0.0, -1.0, -3.0]
    u = 0.5 * (_cdf0(ROW_OFF) + _cdf0(far))
    off, on = [_draw(ROW_OFF, u)], [_draw(far, u)]
    assert off[0][4] != on[0][4]
    ok, flip = chip_smoke.spec_flip_gate([off[0][4]], [on[0][4]], off, on)
    assert not ok and flip["logit_gap"] > 1e-4
    assert flip["margin"] <= flip["gap"]  # u did lie between the CDFs


def test_a_difference_before_any_draw_fails():
    ok, flip = chip_smoke.spec_flip_gate([4, 5], [4, 6], [], [])
    assert not ok and "no draw" in flip["why"]
    one = [_draw(ROW_OFF, 0.9)]
    ok, _ = chip_smoke.spec_flip_gate([4, 5], [4, 6], one, one)
    assert not ok


def test_draws_that_are_not_the_streams_fail():
    u = 0.5 * (_cdf0(ROW_OFF) + _cdf0(ROW_ON))
    off, on = [_draw(ROW_OFF, u)], [_draw(ROW_ON, u)]
    ok, flip = chip_smoke.spec_flip_gate([3], [0], off, on)
    assert not ok and "not the streams" in flip["why"]
    on_other_u = [_draw(ROW_ON, u - 1e-3)]
    ok, _ = chip_smoke.spec_flip_gate([off[0][4]], [on_other_u[0][4]], off,
                                      on_other_u)
    assert not ok


def test_recorder_keeps_each_requests_draws_and_u():
    from paddle_tpu_torch.models import sampling
    rows = np.random.RandomState(0).randn(5, 50).astype(np.float32)
    want = []
    with chip_smoke.DrawRecorder() as rec:
        for seed in (100, 101):
            rng = np.random.RandomState(seed)
            ref = np.random.RandomState(seed)
            toks = [sampling.sample_token(r, 0.8, 40, rng) for r in rows]
            sampling.sample_token(rows[0], 0.0, 0, rng)  # greedy: no draw
            want.append((toks, [ref.random_sample() for _ in rows]))
    assert sampling.sample_token is rec._orig  # unwrapped on exit
    for seed, (toks, us) in zip((100, 101), want):
        draws = rec.draws(seed)
        assert [d[4] for d in draws] == toks
        assert [d[3] for d in draws] == us
        for d in draws:
            cdf = chip_smoke.sample_cdf(d[0], d[1], d[2])
            assert int(np.searchsorted(cdf, d[3], side="right")) == d[4]
    assert rec.draws(7) == []
