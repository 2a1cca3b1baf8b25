"""The warp walks of the two dynamic-threshold kernels, on the CPU.

`contour_context_tpu_torch/csrc/dyn_thres.cu` runs each row of
`dyn_pass_scan` and `dyn_post_scan` as one warp that skips from one rise
of the bars to the next. The kernel itself runs only on the card, where it
is held bit-equal to its plain version (`tests/test_torch_cuda.py::
test_dyn_thres_kernels_match_plain_on_card`, `chip_smoke.py` phase 9).
Here a numpy model of the two walks (`walk_pass`, `walk_post`: lanes of 8
hints or candidates, windows of 32 lanes, the pass scan's running max
clamped at U = max(ub); a round: each lane walks its steps from the state
in force, a ballot finds the first lane whose walk rose, the lanes up to
it keep their outputs, ORed in as the kernel does, and its final state
carries on; the kernel reads a lane's walk after its first rise from
tables it builds before the walk) is held exactly against the port's
plain versions (`dyn_pass_scan_plain`, `dyn_post_scan_plain`) and JAX's
`dynamic_pass_scan` / `dynamic_post_scan`
(`contour_context_tpu/ops/candidate.py:290`, `:322`) on seeded inputs:
rows of 256 and 2500 hints and of 64 and 2500 candidates, bars out of
order (lb > ub) and equal, counts and bars at the int32 extremes, every
step a rise, nothing passing, every row passing, a NaN upper bar, NaN
scores and signed zeros at the bars. The model's ballot rounds stay at or
below 4 at the default bars, and are one a lane of rising steps, plus
one, where every step rises. The port's `candidate.dynamic_post_scan`
keeps JAX's one row under a NaN upper bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contour_context_tpu import config as jconfig
from contour_context_tpu.ops.candidate import (dynamic_pass_scan,
                                               dynamic_post_scan)
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import kernel_times as kt
from contour_context_tpu_torch.ops import candidate as tcand
from contour_context_tpu_torch.ops import kernels

torch.set_num_threads(2)

LANES = 32
K = 8                                # steps a lane
I32 = np.iinfo(np.int32)
LB_PASS = (3, 3, 3, 3, 4)            # config.py's default bars, in the
UB_PASS = (6, 6, 6, 6, 6)            # scans' order
LB_POST = (0.03, -5.01, 0.3)
UB_POST = (0.15, -5.0, 0.75)


# ---------------------------------------------------------------------------
# the numpy model of the kernels' walks
# ---------------------------------------------------------------------------

def _walk(n_steps, state, step):
    """One row through the kernels' warp walk. `step(state, t)` gives step
    t's outputs (a tuple of bools) under `state` and the state after it
    when t raises it, else None. Windows of LANES * K steps, K a lane; a
    round: every lane walks its steps after `pos` from the state in force
    as if no earlier lane held a rise, a ballot of the lanes whose walk
    rose, the lanes up to the first of them keep their outputs, and its
    final state and last step carry on. Returns (outputs (tuple of
    (n_steps,) bool), rounds)."""
    outs, rounds = None, 0
    for w0 in range(0, n_steps, LANES * K):
        pos = w0 - 1
        while True:
            rounds += 1
            walks = []
            for lane in range(LANES):
                st, rose, got = state, False, {}
                for t in range(w0 + K * lane, w0 + K * lane + K):
                    if t <= pos or t >= n_steps:
                        continue
                    got[t], new = step(st, t)
                    if new is not None:
                        st, rose = new, True
                walks.append((rose, st, got))
            ballot = [w[0] for w in walks]
            src = ballot.index(True) if any(ballot) else LANES
            for rose, st, got in walks[:src + 1]:
                for t, o in got.items():
                    if outs is None:
                        outs = [np.zeros(n_steps, bool) for _ in o]
                    for x, v in zip(outs, o):
                        x[t] |= v          # the kernel ORs each round in
            if src == LANES:
                break
            state = walks[src][1]
            pos = w0 + K * src + K - 1
    return tuple(outs), rounds


def pass_step(p1, c, lb, ub):
    """The pass kernel's step on one row: the state is (raised, M), M the
    running max of the clamped orie; before the first raise a hint is
    gated at the lower bars, after it through its thresholds on M."""
    lb = np.asarray(lb, np.int64)[:, None]
    ub = np.asarray(ub, np.int64)[:, None]
    c = c.astype(np.int64)
    never = (c < ub) & (c < lb)
    th = np.where(c >= ub, I32.max, c)
    never2 = ~p1 | never[:3].any(0)
    never3 = never2 | never[3:].any(0)
    th2, th3 = th[:3].min(0), th.min(0)
    lb2 = p1 & (c[:3] >= lb[:3]).all(0)
    lb3 = lb2 & (c[3:] >= lb[3:]).all(0)
    op = np.minimum(c[4], ub.max())

    def step(state, t):
        raised, M = state
        if raised:
            p2 = M <= th2[t] and not never2[t]
            p3 = M <= th3[t] and not never3[t]
        else:
            p2, p3 = lb2[t], lb3[t]
        rises = p3 and (not raised or M < op[t])
        return (p2, p3), ((True, int(op[t])) if rises else None)

    return step


def walk_pass(pass1, cols, lb, ub):
    """The pass kernel's walk on (B, H) inputs: (pass2, pass3, rounds of
    each row)."""
    p2, p3, rounds = [], [], []
    for b in range(pass1.shape[0]):
        step = pass_step(pass1[b], np.stack([c[b] for c in cols]), lb, ub)
        (a, c), r = _walk(pass1.shape[1], (False, 0), step)
        p2.append(a)
        p3.append(c)
        rounds.append(r)
    return np.stack(p2), np.stack(p3), np.asarray(rounds)


def raised_bars(vals, ub):
    """The bars a kept row raises any bars below its scores to, by value,
    as torch.minimum(torch.maximum(bar, score), ub) does in float32: a NaN
    ub gives NaN."""
    ub = np.asarray(ub, np.float32)
    return np.where(np.isnan(ub), ub, np.fmin(vals, ub))


def walk_post(in_use, vals, lb, ub):
    """The post kernel's walk on (B, C) inputs: (keep, rounds of each
    row). The state is the three bars; a kept row raises them when its
    raised bars differ from them in value."""
    keep, rounds = [], []
    for b in range(in_use.shape[0]):
        sc = np.stack([v[b] for v in vals], -1).astype(np.float32)
        nb = raised_bars(sc, ub)

        def step(bars, t):
            with np.errstate(invalid="ignore"):
                kept = bool(in_use[b, t] and (sc[t] >= bars).all())
            moves = kept and bool((nb[t] != bars).any())
            return (kept,), (nb[t] if moves else None)

        (k,), r = _walk(in_use.shape[1], np.asarray(lb, np.float32), step)
        keep.append(k)
        rounds.append(r)
    return np.stack(keep), np.asarray(rounds)


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------

def j_pass_bars(v):
    return jconfig.CandidateScoreEnsemble(
        sim_constell=jconfig.ScoreConstellSim(*v[:3]),
        sim_pair=jconfig.ScorePairwiseSim(*v[3:]))


def j_post_bars(v):
    return jconfig.ScorePostProc(area_perc=v[0], neg_est_dist=v[1],
                                 correlation=v[2])


def references_pass(pass1, cols, lb, ub):
    """(pass2, pass3) of the port's plain version and of JAX's scan."""
    p2, p3 = kernels.dyn_pass_scan_plain(
        torch.from_numpy(pass1),
        *[torch.from_numpy(c.astype(np.int32)) for c in cols], lb, ub)
    j2, j3 = jax.vmap(lambda p, *c: dynamic_pass_scan(
        p, *c, j_pass_bars(lb), j_pass_bars(ub)))(
        jnp.asarray(pass1), *[jnp.asarray(c.astype(np.int32)) for c in cols])
    return (p2.numpy(), p3.numpy()), (np.asarray(j2), np.asarray(j3))


def references_post(in_use, vals, lb, ub):
    keep = kernels.dyn_post_scan_plain(
        torch.from_numpy(in_use),
        *[torch.from_numpy(v.astype(np.float32)) for v in vals], lb, ub)
    jk = jax.vmap(lambda u, a, d, c: dynamic_post_scan(
        u, a, d, c, j_post_bars(lb), j_post_bars(ub)))(
        jnp.asarray(in_use), *[jnp.asarray(v.astype(np.float32))
                               for v in vals])
    return keep.numpy(), np.asarray(jk)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def pass_case(kind, rng):
    """(pass1, cols, lb, ub) of a named case."""
    B, H = 4, 256
    lb, ub = LB_PASS, UB_PASS
    if kind == "random, H 2500":
        B, H = 3, 2500
    pass1 = rng.random((B, H)) < 0.7
    cols = [rng.integers(0, 9, (B, H)) for _ in range(5)]
    if kind == "lb above ub":
        lb, ub = (5, 2, 7, 3, 9), (3, 8, 7, 1, 12)
        cols = [rng.integers(0, 13, (B, H)) for _ in range(5)]
    elif kind == "lb equal to ub":
        lb = ub = (4, 4, 4, 4, 4)
    elif kind == "counts at the int32 extremes":
        cols = [rng.choice([I32.min, I32.min + 1, -1, 0, 3, 4, 5, 6, 7,
                            I32.max - 1, I32.max], (B, H)) for _ in range(5)]
    elif kind == "bars at the int32 extremes":
        lb = (I32.min, 0, I32.max, 4, I32.min + 1)
        ub = (I32.max, I32.min, I32.max - 1, 6, I32.max)
        cols = [rng.choice([I32.min, I32.min + 1, -1, 0, 4, 6, I32.max - 1,
                            I32.max], (B, H)) for _ in range(5)]
    elif kind == "every hint a rise":
        args = kt.dyn_worst_cases("cpu", H)[0]
        pass1 = args[0].numpy()
        cols = [a.numpy() for a in args[1:6]]
        lb, ub = args[6], args[7]
    elif kind == "nothing passes":
        pass1[:] = False
    elif kind == "every hint passes":
        pass1[:] = True
        for c in cols:
            c[:] = max(UB_PASS)
    return pass1, cols, lb, ub


PASS_KINDS = ["random, H 256", "random, H 2500", "lb above ub",
              "lb equal to ub", "counts at the int32 extremes",
              "bars at the int32 extremes", "every hint a rise",
              "nothing passes", "every hint passes"]


@pytest.mark.parametrize("kind", PASS_KINDS)
def test_pass_walk_matches_plain_and_jax(kind):
    rng = np.random.default_rng(PASS_KINDS.index(kind))
    pass1, cols, lb, ub = pass_case(kind, rng)
    m2, m3, rounds = walk_pass(pass1, cols, lb, ub)
    (p2, p3), (j2, j3) = references_pass(pass1, cols, lb, ub)
    np.testing.assert_array_equal(m2, p2)
    np.testing.assert_array_equal(m3, p3)
    np.testing.assert_array_equal(m2, j2)
    np.testing.assert_array_equal(m3, j3)
    H = pass1.shape[1]
    windows = -(-H // (LANES * K))
    if kind == "every hint a rise":
        # a round for each lane of rising hints, and the last
        assert m3.all() and (rounds == H // K + 1).all()
    elif kind == "nothing passes":
        assert not m2.any() and (rounds == windows).all()
    elif kind == "every hint passes":
        # the first hint raises the bars to ub; no later hint moves them
        assert m3.all() and (rounds == 2).all()
    else:
        assert 0 < m3.sum() < m3.size


def post_case(kind, rng):
    """(in_use, vals, lb, ub) of a named case."""
    B, C = 4, 64
    lb, ub = LB_POST, UB_POST
    use = rng.random((B, C)) < 0.8
    vals = [rng.uniform(0.0, 0.2, (B, C)), rng.uniform(-8.0, -3.0, (B, C)),
            rng.uniform(0.1, 0.9, (B, C))]
    if kind == "random, C 2500":
        use = rng.random((3, 2500)) < 0.8
        vals = [rng.uniform(lo, hi, (3, 2500)) for lo, hi in
                ((0.0, 0.2), (-8.0, -3.0), (0.1, 0.9))]
    elif kind == "lb above ub":
        lb, ub = (0.1, -4.0, 0.6), (0.05, -6.0, 0.4)
    elif kind == "nothing kept":
        use[:] = False
    elif kind == "every row kept":
        use[:] = True
        vals = [np.full((B, C), u) for u in UB_POST]
    elif kind == "a NaN upper bar":
        use[:] = True
        vals = [rng.uniform(0.2, 0.9, (B, C)) for _ in range(3)]
        lb, ub = (0.1, 0.1, 0.1), (float("nan"), 0.95, 0.95)
    elif kind == "NaN scores":
        for v in vals:
            v[rng.random((B, C)) < 0.2] = np.nan
    elif kind == "signed zeros at the bars":
        use = rng.random((B, C)) < 0.9
        vals = [rng.choice(np.array([0.0, -0.0, 0.25]), (B, C))
                for _ in range(3)]
        lb, ub = (0.0, -0.0, 0.0), (-0.0, 0.0, 0.5)
    elif kind == "every candidate a rise":
        args = kt.dyn_worst_cases("cpu", C=C)[1]
        use = args[0].numpy()
        vals = [a.numpy() for a in args[1:4]]
        lb, ub = args[4], args[5]
    return use, [v.astype(np.float32) for v in vals], lb, ub


POST_KINDS = ["random, C 64", "random, C 2500", "lb above ub",
              "nothing kept", "every row kept", "a NaN upper bar",
              "NaN scores", "signed zeros at the bars",
              "every candidate a rise"]


@pytest.mark.parametrize("kind", POST_KINDS)
def test_post_walk_matches_plain_and_jax(kind):
    rng = np.random.default_rng(100 + POST_KINDS.index(kind))
    use, vals, lb, ub = post_case(kind, rng)
    keep, rounds = walk_post(use, vals, lb, ub)
    plain, jk = references_post(use, vals, lb, ub)
    np.testing.assert_array_equal(keep, plain)
    np.testing.assert_array_equal(keep, jk)
    C = use.shape[1]
    if kind == "every candidate a rise":
        assert keep.all() and (rounds == C // K + 1).all()
    elif kind == "nothing kept":
        assert not keep.any() and (rounds == 1).all()
    elif kind == "every row kept":
        assert keep.all()
    elif kind == "a NaN upper bar":
        # the first kept row makes bar 0 NaN, and nothing reaches it
        np.testing.assert_array_equal(keep.sum(1), 1)
        assert (rounds == 2).all()
    else:
        assert 0 < keep.sum() < keep.size


def test_rounds_at_the_default_bars_are_at_most_four():
    """At the default bars the first pass sets the clamped running max to
    4 or more, so the state rises at most three times a row: at most 4
    ballot rounds on any row of 256 hints, and more than one on some."""
    rng = np.random.default_rng(7)
    pass1 = rng.random((64, 256)) < 0.8
    cols = [rng.integers(0, 9, (64, 256)) for _ in range(5)]
    cols[4] = np.sort(cols[4], axis=1)               # rising orie: most rises
    _, p3, rounds = walk_pass(pass1, cols, LB_PASS, UB_PASS)
    _, q3 = kernels.dyn_pass_scan_plain(
        torch.from_numpy(pass1),
        *[torch.from_numpy(c.astype(np.int32)) for c in cols], LB_PASS,
        UB_PASS)
    np.testing.assert_array_equal(p3, q3.numpy())
    assert rounds.max() <= 4 and rounds.max() == 4


def test_port_post_scan_keeps_jax_row_under_a_nan_upper_bar():
    """The port's `candidate.dynamic_post_scan` (the plain version on the
    CPU) against JAX's under ub = (nan, 0.95, 0.95): 64 in-use rows with
    scores in [0.2, 0.9] over lower bars of 0.1 keep one row, the first
    (the kernel before this repair kept 3)."""
    rng = np.random.default_rng(3)
    use = np.ones(64, bool)
    sc = rng.uniform(0.2, 0.9, (3, 64)).astype(np.float32)
    lb = tconfig.ScorePostProc(correlation=0.1, area_perc=0.1,
                               neg_est_dist=0.1)
    ub = dataclasses.replace(lb, area_perc=float("nan"), neg_est_dist=0.95,
                             correlation=0.95)
    keep = tcand.dynamic_post_scan(torch.from_numpy(use),
                                   *[torch.from_numpy(v) for v in sc], lb, ub)
    jlb = jconfig.ScorePostProc(correlation=0.1, area_perc=0.1,
                                neg_est_dist=0.1)
    jub = dataclasses.replace(jlb, area_perc=float("nan"),
                              neg_est_dist=0.95, correlation=0.95)
    jk = dynamic_post_scan(jnp.asarray(use), *[jnp.asarray(v) for v in sc],
                           jlb, jub)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    assert int(keep.sum()) == 1 and bool(keep[0])


@pytest.mark.parametrize("kernel,B,n,by", [
    ("pass", 1, 256, "operations"), ("pass", 16, 256, "bytes"),
    ("post", 1, 64, "operations"), ("post", 16, 64, "bytes")])
def test_dyn_bound_is_bytes_against_a_log_depth_chain(kernel, B, n, by):
    """The scans' bound (`kernel_times.dyn_bound`): the bytes (masks in,
    counts or scores in, masks out) over 3.35 TB/s against ceil(log2 n)
    dependent steps a row at one a clock, not n of them."""
    n_val, n_out = (5, 2) if kernel == "pass" else (3, 1)
    mask = torch.zeros((B, n), dtype=torch.bool)
    vals = [torch.zeros((B, n), dtype=torch.int32) for _ in range(n_val)]
    outs = [mask.clone() for _ in range(n_out)]
    clk = 1.98e9
    us, bound_by, n_bytes, steps = kt.dyn_bound([mask], vals, outs, n, clk)
    assert n_bytes == B * n * (1 + 4 * n_val + n_out)
    assert steps == int(np.log2(n))
    assert bound_by == by
    assert us == pytest.approx(1e6 * max(n_bytes / kt.HBM_BYTES_PER_S,
                                         steps / clk), rel=1e-12)


def test_stream_clouds_draws_every_seed_whatever_the_subset():
    """`kernel_times.stream_clouds` renders a scan with the seed the whole
    stream draws for it, so a subset (the dynamic scans' DB) holds the
    same clouds as the stream (the CC and merge cases)."""
    cfg = tconfig.PipelineConfig()
    one = kt.stream_clouds(cfg, [2])
    three = kt.stream_clouds(cfg, [0, 1, 2])
    assert len(one) == 1 and len(three) == 3
    np.testing.assert_array_equal(one[0], three[2])
    assert not np.array_equal(three[1], three[2])
