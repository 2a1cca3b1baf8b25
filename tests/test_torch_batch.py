"""The B axis of the port's query tail: row b of a batched call equals the
same call at B = 1.

One synth world (12 scans 6 s apart, built through the port's stream on the
CPU) and a ragged batch of six queries under caps small enough that every
budget overflows for some query and not for others (160 hints in cascade
chunks of 64, the last one's start clamped so that it overlaps the second; a
24-hint merge budget; 3 candidate rows):

    0  a revisit over the hint cap and the merge budget, candidates fit
    1  a padded zero cloud (found = False, no hit)
    2  a revisit at searchable_n 0: no valid hit at all
    3  a revisit overflowing the hint cap, the merge budget and the rows
    4  a scan seen from afar, at searchable_n 5: one cascade chunk where the
       busiest queries run three, under the hint cap, rows overflowing
    5  a revisit overflowing all three

For each stage (`select_topk_stable`, `check1`, the chunked cascade,
`merge_proposals`, `tidy_candidates`, `init_correlation`,
`optimize_correlation`) and for the stacked stage outputs and the records,
row b of the batched call is compared with the B = 1 call on query b alone:
ints, bools and orderings exactly, and the floats bit for bit too (every
reduction runs over a fixed inner extent of one row, so on the CPU its order
does not depend on B). One elementwise op is not position-free on the CPU:
ATen's vectorized `atan2` rounds a tail of fewer than 32 elements with the
scalar libm function, whose last bit can differ from the vector function's,
so the cascade's pose angle is bit-equal between two row counts only when
both are multiples of 32. The chunk widths here are (64, and 160 or 64
unchunked), as the defaults are (128 and 256); on a CUDA device the op is
position-free. `merge_proposals` is also held against the JAX
`merge_proposals` on the same numpy inputs, query by query (ints and bools
exactly, floats to rtol 1e-4 and atol 1e-4, the band of
tests/test_torch_query.py). `dynamic_thres=True` batched equals per-query
exactly.
"""

import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch.ops import candidate as tcand
from contour_context_tpu_torch.ops import gmm as tg
from contour_context_tpu_torch.ops.descriptor import build_descriptors
from contour_context_tpu_torch.types import ScanDesc
from contour_context_tpu_torch.utils.io import pad_points

torch.set_num_threads(2)

SMALL = dict(max_check_cands=160, cascade_chunk=64, max_pass_hints=24,
             max_cand_poses=3)


def _cfg(**db):
    return tconfig.PipelineConfig(
        cm=tconfig.ContourManagerConfig(max_points=16384),
        db=tconfig.ContourDBConfig(**db))


CFG, RAGGED = _cfg(), _cfg(**SMALL)
POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
    (10.5, 0.8, 0.2), (30.0, -1.0, -0.15), (50.2, 0.7, 0.1),
    (20.3, 0.5, -0.1)]
SEARCHABLE = [12, 12, 0, 12, 5, 12]
B = len(SEARCHABLE)


@pytest.fixture(scope="module")
def world():
    """(the 12-scan DB, the six queries' stacked descriptors, their hits)."""
    w = make_world(11, n_structs=220, extent=160.0)
    clouds = np.stack([pad_points(render_scan(w, p, seed=500 + i), 16384)
                       for i, p in enumerate(POSES)])
    db = tdb.ContourDB(CFG, capacity=16, device="cpu")
    for i in range(len(POSES)):
        db.step_async(clouds[i], i, 6.0 * i)
    queries = np.stack([clouds[8], np.zeros_like(clouds[0]), clouds[9],
                        clouds[10], clouds[7], clouds[11]])
    descs = build_descriptors(torch.from_numpy(queries), CFG.cm, CFG.gmm)
    hits = tdb.search_batch(db.keys_q, descs.keys,
                            torch.tensor(SEARCHABLE, dtype=torch.int32),
                            tuple(CFG.db.q_levels), CFG.db.nnk)
    return db, descs, hits


def _row(x, b):
    """Query b of a stacked (nested) tuple of tensors, as a batch of 1."""
    if isinstance(x, torch.Tensor):
        return x[b:b + 1]
    rows = [_row(v, b) for v in x]
    return type(x)(*rows) if hasattr(x, "_fields") else tuple(rows)


def _leaves(x, prefix=""):
    if isinstance(x, torch.Tensor):
        yield prefix, x
        return
    names = getattr(x, "_fields", range(len(x)))
    for name, v in zip(names, x):
        yield from _leaves(v, f"{prefix}.{name}")


def _assert_rows_equal(fn, *stacked, **kw):
    """fn on the stacked inputs against fn on each query's rows alone:
    every output leaf of row b bit-equal. Returns the batched output."""
    out = fn(*stacked, **kw)
    for b in range(B):
        one = fn(*[_row(x, b) for x in stacked], **kw)
        for (name, x), (_, y) in zip(_leaves(out), _leaves(one)):
            assert y.shape == x[b:b + 1].shape, (name, b)
            assert torch.equal(x[b:b + 1], y), (name, b)
    return out


def _hint_rows(hits, cfg):
    """The hint cap of `stages_from_hits`: (gidx, level, seq_src, seq_tgt,
    valid) (B, HC) and n_valid (B,)."""
    gidx, seq_src, dist, valid = hits
    n, Q, A, K = gidx.shape
    lv = torch.tensor(cfg.db.q_levels, dtype=torch.int32)
    level_f = lv[:, None, None].expand(Q, A, K).reshape(-1)
    seq_tgt_f = torch.arange(A, dtype=torch.int32)[None, :, None] \
        .expand(Q, A, K).reshape(-1)
    perm, hv, n_valid, _ = tcand.select_topk_stable(
        dist.reshape(n, -1), valid.reshape(n, -1), cfg.db.max_check_cands)
    return (gidx.reshape(n, -1).gather(1, perm), level_f[perm],
            seq_src.reshape(n, -1).gather(1, perm), seq_tgt_f[perm], hv,
            n_valid)


@pytest.fixture(scope="module")
def staged(world):
    """The ragged batch's stacked stage outputs and LM inputs."""
    db, descs, hits = world
    return tdb.refine_from_hits(db.store, descs, hits, RAGGED)


def test_the_batch_is_ragged(world, staged):
    db, descs, hits = world
    recs = tdb.query_from_hits(db.store, descs, hits, RAGGED).numpy()
    n_hints, ovf_hints = recs[:, 6], recs[:, 11]
    ovf_pass, ovf_cand = recs[:, 12], recs[:, 13]
    assert n_hints[1] == 0 and n_hints[2] == 0 and recs[1, 0] == 0
    assert n_hints[4] < RAGGED.db.max_check_cands < n_hints[0]
    for col in (ovf_hints, ovf_pass, ovf_cand):
        assert (col > 0).any() and (col == 0).any(), col
    assert ovf_cand[0] == 0 and ovf_cand[4] > 0 and ovf_hints[4] == 0
    assert recs[0, 0] == 1 and recs[3, 0] == 1
    # cascade chunks of their own: 3 for the busiest, 1 for query 4, none
    # for the two without a hint
    W = RAGGED.db.cascade_chunk
    assert [-(-int(a) // W) for a in recs[:, 7]] == [3, 0, 0, 2, 1, 3]


def test_select_topk_stable_rows():
    rng = np.random.default_rng(5)
    n, cap = 40, 12
    pri = rng.integers(0, 6, (B, n)).astype(np.float32)      # many ties
    pri[3, :5] = -0.0
    pri[3, 5:9] = 0.0
    mask = rng.random((B, n)) < np.array([0.0, 0.1, 0.3, 0.6, 0.9, 1.0])[:, None]
    mask[1, :] = False
    mask[1, 7] = True
    out = _assert_rows_equal(tcand.select_topk_stable,
                             torch.from_numpy(pri), torch.from_numpy(mask),
                             cap=cap)
    perm, sel, n_masked, overflow = (x.numpy() for x in out)
    assert perm.shape == (B, cap) and n_masked.tolist() == \
        mask.sum(1).tolist()
    assert overflow[0] == 0 and overflow[5] == n - cap
    for b in range(B):
        # numpy's own stable selection: the cap best by (priority, index),
        # in input order
        idx = np.nonzero(mask[b])[0]
        best = np.sort(idx[np.argsort(pri[b][idx], kind="stable")][:cap])
        assert perm[b][sel[b]].tolist() == best.tolist(), b
    # a priority shared by the rows broadcasts
    shared = torch.arange(n, dtype=torch.float32)
    p2 = tcand.select_topk_stable(shared, torch.from_numpy(mask), cap)[0]
    for b in range(B):
        assert torch.equal(p2[b], tcand.select_topk_stable(
            shared, torch.from_numpy(mask[b]), cap)[0])


def _stage_check1(world):
    db, descs, hits = world
    g, l, ss, st, hv, _ = _hint_rows(hits, RAGGED)

    def fn(descs, g, l, ss, st, hv):
        return tdb.check1(db.store, descs, g, l, ss, st, hv,
                          RAGGED.db.cont_sim)

    out = _assert_rows_equal(fn, descs, g, l, ss, st, hv)
    assert out[0].any() and not out[1].any() and not out[2].any()


def _stage_cascade(world):
    db, descs, hits = world
    g, l, ss, st, hv, n_valid = _hint_rows(hits, RAGGED)

    def fn(descs, g, l, ss, st, hv, n_valid):
        return tdb.cascade_chunked(db.store, descs, g, l, ss, st, hv,
                                   n_valid, RAGGED.thres_lb,
                                   RAGGED.db.cont_sim,
                                   RAGGED.db.cascade_chunk, RAGGED.db.p_pot)

    res = _assert_rows_equal(fn, descs, g, l, ss, st, hv, n_valid)
    assert res.pass3[0].any() and res.pass3[4].any()
    # without the prefilter the busiest queries run three chunks (the third
    # starts at 96 and overlaps the second); query 4 has 65 hints: its
    # third chunk never ran, and stays zero
    assert n_valid.tolist()[4] == 65 and int(n_valid.max()) > 128
    for name, x in zip(res._fields, res):
        assert not x[4, 128:].any(), name
        assert not x[1].any() and not x[2].any(), name


def _merge_inputs(staged):
    res = staged.qs.res
    return (res.pass3, staged.qs.gidx, res.T_delta, res.pair_valid,
            res.pair_level, res.pair_seq_src, res.pair_seq_tgt,
            res.pair_area_perc)


def _synthetic_merge(H=40, P=16):
    """Seeded merge inputs (B, H, ...): hints of five scans whose poses fall
    in three clusters further apart than the merge thresholds (noise well
    inside them), pair lists with repeated slots, and a ragged number of
    passing hints (none for query 0, all for queries 4 and 5)."""
    rng = np.random.default_rng(9)
    centers = np.array([[0.0, 0.0, 0.0], [10.0, 5.0, 0.5], [-8.0, 3.0, -0.6]])
    T = centers[rng.integers(0, 3, (B, H))] + rng.normal(0, 0.05, (B, H, 3))
    p_pass = np.array([0.0, 0.2, 0.5, 0.8, 1.0, 1.0])[:, None]
    arrays = (rng.random((B, H)) < p_pass,
              rng.choice([3, 5, 7, 9, 11], (B, H)).astype(np.int32),
              T.astype(np.float32), rng.random((B, H, P)) < 0.5,
              rng.integers(1, 5, (B, H, P)).astype(np.int32),
              rng.integers(0, 4, (B, H, P)).astype(np.int32),
              rng.integers(0, 4, (B, H, P)).astype(np.int32),
              rng.uniform(0.0, 0.2, (B, H, P)).astype(np.float32))
    return tuple(torch.from_numpy(a) for a in arrays)


def _stage_merge(world, staged):
    st = _assert_rows_equal(tcand.merge_proposals, *_merge_inputs(staged),
                            n_cand_max=RAGGED.db.max_cand_poses,
                            n_pass_max=RAGGED.db.max_pass_hints)
    for (name, x), (_, y) in zip(_leaves(st), _leaves(staged.qs.st)):
        assert torch.equal(x, y), name
    assert st.n_cand.tolist() == [3, 0, 0, 3, 3, 3]
    # poses in three clusters per scan: rows hold several proposals, and
    # the fifth scan finds no row
    syn = _assert_rows_equal(tcand.merge_proposals, *_synthetic_merge(),
                             n_cand_max=4, n_pass_max=24)
    assert (syn.prop_n > 1).any() and (syn.prop_votes > 20).any()
    assert syn.overflow_cand[4] > 0 and syn.n_cand.tolist()[0] == 0


def _stage_tidy(world, staged):
    post = RAGGED.thres_lb.sim_post
    cm = RAGGED.cm
    tidy = _assert_rows_equal(
        tcand.tidy_candidates, staged.qs.st, area_perc_lb=post.area_perc,
        neg_est_dist_lb=post.neg_est_dist, n_row=cm.n_row, n_col=cm.n_col,
        reso_row=cm.reso_row, reso_col=cm.reso_col)
    assert tidy.alive[0].any() and not tidy.in_use[1].any()


def _gmm_rows(db, staged):
    cg = staged.cand_gidx.clamp(0, db.n - 1).long()
    return tdb.gather_gmm(db.store, cg, tuple(RAGGED.gmm.levels),
                          RAGGED.gmm.max_gmm_ellipses)


def _stage_init_correlation(world, staged):
    db = world[0]
    post = RAGGED.thres_lb.sim_post
    cm = RAGGED.cm
    tidy = tcand.tidy_candidates(staged.qs.st, post.area_perc,
                                 post.neg_est_dist, cm.n_row, cm.n_col,
                                 cm.reso_row, cm.reso_col)

    def fn(src, tgt, T):
        return tg.init_correlation(src, tdb.per_query(tgt), T,
                                   scale=RAGGED.gmm.cov_dilate_scale)

    corr0, sel = _assert_rows_equal(fn, _gmm_rows(db, staged), staged.tgt,
                                    tidy.T_sel)
    assert corr0.shape == (B, 3) and sel[0].any()
    # a query's candidates against its GMM alone, without the B axis
    b = 3
    c1, s1 = tg.init_correlation(
        tg.GmmScan(*[x[b] for x in _gmm_rows(db, staged)]),
        tg.GmmScan(*[x[b] for x in staged.tgt]), tidy.T_sel[b],
        scale=RAGGED.gmm.cov_dilate_scale)
    assert torch.equal(c1, corr0[b]) and torch.equal(s1, sel[b])


def _stage_optimize_correlation(world, staged):
    def fn(src, tgt, T0, sel):
        return tg.optimize_correlation(
            src, tdb.per_query(tgt), T0, sel,
            scale=RAGGED.gmm.cov_dilate_scale, iters=RAGGED.gmm.gn_iters)

    corr, T = _assert_rows_equal(fn, staged.src, staged.tgt, staged.T0,
                                 staged.sel)
    assert corr.shape == (B, 3) and T.shape == (B, 3, 3)
    assert (corr[0][staged.valid[0]] > 0.5).any()


STAGES = {"check1": _stage_check1, "cascade": _stage_cascade,
          "merge_proposals": _stage_merge, "tidy_candidates": _stage_tidy,
          "init_correlation": _stage_init_correlation,
          "optimize_correlation": _stage_optimize_correlation}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_rows_equal_the_single_call(world, staged, stage):
    fn = STAGES[stage]
    if stage in ("check1", "cascade"):
        fn(world)
    else:
        fn(world, staged)


def test_merge_proposals_matches_jax(staged):
    import jax.numpy as jnp

    from contour_context_tpu.ops.candidate import merge_proposals

    caps = dict(n_cand_max=RAGGED.db.max_cand_poses,
                n_pass_max=RAGGED.db.max_pass_hints)
    for inputs, caps in ((_merge_inputs(staged), caps),
                         (_synthetic_merge(), dict(n_cand_max=4,
                                                   n_pass_max=24))):
        st = tcand.merge_proposals(*inputs, **caps)
        for b in range(B):
            st_j = merge_proposals(*[jnp.asarray(x[b].numpy())
                                     for x in inputs], **caps)
            for name, x, y in zip(st._fields, st, st_j):
                x, y = x[b].numpy(), np.asarray(y)
                assert x.shape == y.shape, name
                if x.dtype.kind == "f":
                    np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4,
                                               err_msg=f"{name} query {b}")
                else:
                    np.testing.assert_array_equal(x, y, f"{name} query {b}")
        assert int(st.overflow_pass.sum()) > 0
        assert int(st.overflow_cand.sum()) > 0 and (st.prop_n > 0).any()


@pytest.mark.parametrize("what", ["stages", "refine"])
def test_stacked_outputs_rows_equal_the_single_call(world, what):
    db, descs, hits = world
    fn = {"stages": tdb.stages_from_hits,
          "refine": tdb.refine_from_hits}[what]
    _assert_rows_equal(lambda d, h: fn(db.store, d, h, RAGGED), descs, hits)


@pytest.mark.parametrize("case", ["ragged", "default", "dynamic",
                                  "dynamic_ragged", "unchunked"])
def test_records_rows_equal_query_step(world, case):
    """`query_step_batch` row b against `query_step` of query b at its own
    window, every column bit for bit (the floats too, on the CPU)."""
    db, descs, _ = world
    cfg = {"ragged": RAGGED, "default": CFG,
           "dynamic": _cfg(dynamic_thres=True),
           "dynamic_ragged": _cfg(dynamic_thres=True, **SMALL),
           "unchunked": _cfg(cascade_chunk=0, max_check_cands=64)}[case]
    sb = torch.tensor(SEARCHABLE, dtype=torch.int32)
    recs = tdb.query_step_batch(db.store, db.keys_q, descs, sb, cfg)
    assert recs.shape == (B, tdb.RECORD_WIDTH)
    for b in range(B):
        state = torch.tensor([db.n, SEARCHABLE[b]], dtype=torch.int32)
        one = tdb.query_step(db.store, db.keys_q,
                             ScanDesc(*[x[b] for x in descs]), state, cfg)
        assert torch.equal(recs[b], one), (case, b, recs[b], one)
    assert recs[0, 0] == 1 and recs[1, 0] == 0 and recs[2, 0] == 0
    if case.startswith("dynamic"):
        static = tdb.query_step_batch(
            db.store, db.keys_q, descs, sb,
            RAGGED if case == "dynamic_ragged" else CFG)
        # the rising bars bite in some query, and never add a survivor
        assert (recs[:, 9] <= static[:, 9]).all()
        assert (recs[:, 9] < static[:, 9]).any()


def test_dynamic_scans_take_a_batch():
    """The host recurrences on (B, H) inputs equal their rows alone."""
    rng = np.random.default_rng(2)
    dyn = _cfg(dynamic_thres=True)
    H = 64
    cols = [torch.from_numpy(rng.integers(0, 14, (B, H)).astype(np.int32))
            for _ in range(5)]
    pass1 = torch.from_numpy(rng.random((B, H)) < 0.8)
    pass1[2] = False
    p2, p3 = tcand.dynamic_pass_scan(pass1, *cols, dyn.thres_lb, dyn.thres_ub)
    C = 16
    in_use = torch.from_numpy(rng.random((B, C)) < 0.85)
    fl = [torch.from_numpy(rng.uniform(lo, hi, (B, C)).astype(np.float32))
          for lo, hi in ((0.0, 0.4), (-8.0, 0.0), (0.1, 0.9))]
    keep = tcand.dynamic_post_scan(in_use, *fl, dyn.thres_lb.sim_post,
                                   dyn.thres_ub.sim_post)
    assert p2.shape == p3.shape == (B, H) and keep.shape == (B, C)
    for b in range(B):
        q2, q3 = tcand.dynamic_pass_scan(pass1[b], *[c[b] for c in cols],
                                         dyn.thres_lb, dyn.thres_ub)
        assert torch.equal(p2[b], q2) and torch.equal(p3[b], q3)
        assert torch.equal(keep[b], tcand.dynamic_post_scan(
            in_use[b], *[x[b] for x in fl], dyn.thres_lb.sim_post,
            dyn.thres_ub.sim_post))
    assert p3.any() and not p3[2].any() and keep.any()
