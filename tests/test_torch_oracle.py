"""The port against the numpy oracle (`contour_context_tpu/oracle.py`, the
sequential spec the JAX package is pinned to), wherever the oracle pins the
JAX function: mirrors tests/test_descriptor.py, tests/test_cascade.py:40-218
and tests/test_db_misc.py:328-432. Tests may import the oracle; the port
never does.

The tolerances are the JAX tests', stated where used: the oracle computes
in float64 with the reference's sequential loops, the port in float32 with
float64 component sums, so contour means and heights agree to atol 2e-3,
eigenvalues to 5e-3, keys to atol 2e-2 and rtol 2e-3, the cascade's pose
to 5e-2 cells and 1e-2 rad, GMM correlations to rtol 2e-2; labels, counts,
flags, neighbours and pass decisions exactly.
"""

import math

import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu import oracle
from contour_context_tpu import config as jconfig
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.types import ScanDesc
from contour_context_tpu_torch.utils.io import pad_points

torch.set_num_threads(2)

OCFG = jconfig.ContourManagerConfig(max_points=16384)   # the oracle's
CFG = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(max_points=16384))
CM = CFG.cm
SIM = jconfig.ContourSimThresConfig()
LB = jconfig.DEFAULT_THRES_LB


def _build(pts):
    return td.build_descriptor(torch.from_numpy(pad_points(pts,
                                                           CM.max_points)),
                               CM, CFG.gmm)


# -- the descriptor (tests/test_descriptor.py) -------------------------------

@pytest.fixture(scope="module")
def built():
    scene = render_scan(make_world(0), (0.0, 0.0, 0.0), seed=1)
    osc = oracle.build_scan(scene, OCFG, 0)
    desc = ScanDesc(*[x.numpy() for x in _build(scene)])
    return scene, osc, desc


def test_bev_parity(built):
    scene, _, _ = built
    ob = oracle.make_bev(scene, OCFG)
    bev, rowf, _ = td.rasterize_bev(
        torch.from_numpy(pad_points(scene, CM.max_points)), CM)
    bev = bev.numpy().reshape(CM.n_row, CM.n_col)
    np.testing.assert_allclose(bev, ob.bev, atol=1e-5)
    occ = ob.bev > -999
    np.testing.assert_allclose(rowf.numpy()[occ.reshape(-1)], ob.rowf[occ],
                               atol=1e-4)


def test_contour_tables(built):
    _, osc, desc = built
    for ll in range(CM.n_levels):
        conts = osc.cont_views[ll]
        assert int(desc.n_cont[ll]) == len(conts)
        assert int(desc.layer_cell_cnt[ll]) == osc.layer_cell_cnt[ll]
        for k, c in enumerate(conts[:CM.max_contours]):
            assert int(desc.cnt[ll, k]) == c.cell_cnt, (ll, k)
            np.testing.assert_allclose(desc.mean[ll, k], c.pos_mean,
                                       atol=2e-3, rtol=1e-4)
            np.testing.assert_allclose(desc.eig_vals[ll, k], c.eig_vals,
                                       atol=5e-3, rtol=1e-3)
            np.testing.assert_allclose(abs(float(np.dot(
                desc.eig_vecs[ll, k][:, 1], c.eig_vecs[:, 1]))), 1.0,
                atol=1e-3)
            np.testing.assert_allclose(desc.vol3_mean[ll, k], c.vol3_mean,
                                       atol=2e-3, rtol=1e-4)
            assert bool(desc.ecc_feat[ll, k]) == c.ecc_feat, (ll, k)


def test_keys(built):
    _, osc, desc = built
    np.testing.assert_allclose(desc.keys, osc.keys, atol=2e-2, rtol=2e-3)
    assert np.abs(desc.keys).sum() > 0


def test_bcis(built):
    _, osc, desc = built
    n_bci = 0
    for ll in range(CM.n_levels):
        for seq in range(CM.piv_firsts):
            ob = osc.bcis[ll][seq]
            nv = desc.nei_valid[ll, seq]
            if ob is None:
                assert not nv.any()
                continue
            n = int(nv.sum())
            n_bci += 1
            assert n == len(ob.nei_bit), (ll, seq)
            np.testing.assert_array_equal(desc.nei_bit[ll, seq][:n],
                                          ob.nei_bit)
            np.testing.assert_array_equal(desc.nei_level[ll, seq][:n],
                                          ob.nei_level)
            np.testing.assert_array_equal(desc.nei_seq[ll, seq][:n],
                                          ob.nei_seq)
            np.testing.assert_allclose(desc.nei_theta[ll, seq][:n],
                                       ob.nei_theta, atol=1e-4)
    assert n_bci > 10


def test_gmm_summary(built):
    _, osc, desc = built
    model = oracle.build_gmm(osc, jconfig.GMMOptConfig())
    np.testing.assert_allclose(float(desc.auto_corr), model.auto_corr,
                               rtol=2e-3)


# -- the check cascade and the GMM (tests/test_cascade.py) -------------------

def _oracle_hint(osc_src, osc_tgt, level, ss, st):
    """The sequential reference chain for one hint (tests/test_cascade.py)."""
    out = dict(pass1=False, pass2=False, pass3=False)
    if not (len(osc_src.cont_views[level]) > ss
            and len(osc_tgt.cont_views[level]) > st):
        return out
    if not oracle.check_sim(osc_src.cont_views[level][ss],
                            osc_tgt.cont_views[level][st], SIM):
        return out
    out["pass1"] = True
    bs, bt = osc_src.bcis[level][ss], osc_tgt.bcis[level][st]
    if bs is None or bt is None:
        return out
    score2, pairs = oracle.check_constell_sim(bs, bt, LB.sim_constell)
    out["score2"] = score2
    if pairs is None:
        return out
    out["pass2"] = True
    score3, pairs2, _ = oracle.check_constell_corresp_sim(
        osc_src, osc_tgt, pairs, LB.sim_pair, SIM)
    if pairs2 is None:
        return out
    out["pass3"] = True
    out["pairs"] = set(pairs2)
    out["T"] = oracle.umeyama_se2(osc_src, osc_tgt, pairs2)
    return out


def _cascade_vs_oracle(wseed, pose_b, seeds):
    """Every (level, ss, st) hint of a scan pair through the port's
    gather_and_cascade, hint for hint against the oracle. Returns the
    number of hints that passed all three checks."""
    world = make_world(wseed)
    pts_a = render_scan(world, (0.0, 0.0, 0.0), seed=seeds[0])
    pts_b = render_scan(world, pose_b, seed=seeds[1])
    osc_a = oracle.build_scan(pts_a, OCFG, 0)
    osc_b = oracle.build_scan(pts_b, OCFG, 1)
    da, db_ = _build(pts_a), _build(pts_b)
    hints = [(lv, ss, st) for lv in (1, 2, 3)
             for ss in range(CM.piv_firsts) for st in range(CM.piv_firsts)
             if np.abs(osc_a.keys[lv][ss]).sum() > 0
             and np.abs(osc_b.keys[lv][st]).sum() > 0]
    H = len(hints)
    i32 = torch.int32
    res = tdb.gather_and_cascade(
        ScanDesc(*[x[None] for x in da]), ScanDesc(*[x[None] for x in db_]),
        torch.zeros(H, dtype=torch.long), torch.zeros(H, dtype=i32),
        torch.tensor([h[0] for h in hints], dtype=i32),
        torch.tensor([h[1] for h in hints], dtype=i32),
        torch.tensor([h[2] for h in hints], dtype=i32),
        torch.ones(H, dtype=torch.bool), CFG.thres_lb, CFG.db.cont_sim,
        CFG.db.p_pot)
    res = type(res)(*[x.numpy() for x in res])
    n_pass3 = 0
    for i, (level, ss, st) in enumerate(hints):
        o = _oracle_hint(osc_a, osc_b, level, ss, st)
        for k in ("pass1", "pass2", "pass3"):
            assert bool(getattr(res, k)[i]) == o[k], (wseed, hints[i], k)
        if o["pass2"]:
            assert (int(res.ovlp_sum[i]), int(res.ovlp_max_one[i]),
                    int(res.in_ang_rng[i])) == tuple(o["score2"][:3])
        if o["pass3"]:
            n_pass3 += 1
            got = {(int(res.pair_level[i, j]), int(res.pair_seq_src[i, j]),
                    int(res.pair_seq_tgt[i, j]))
                   for j in np.flatnonzero(res.pair_valid[i])}
            assert got == o["pairs"], (wseed, hints[i])
            T_o = o["T"]
            np.testing.assert_allclose(res.T_delta[i, :2], T_o[:2, 2],
                                       atol=5e-2)
            np.testing.assert_allclose(res.T_delta[i, 2],
                                       math.atan2(T_o[1, 0], T_o[0, 0]),
                                       atol=1e-2)
    return H, n_pass3


def test_cascade_vs_oracle():
    H, n_pass3 = _cascade_vs_oracle(3, (2.0, 1.0, 0.3), (10, 11))
    assert H > 4 and n_pass3 >= 1          # the revisit passes


@pytest.mark.parametrize("wseed,pose_b,seeds", [
    (5, (1.0, -2.0, -0.2), (20, 21)),
    (8, (4.0, 3.0, 0.7), (30, 31)),
    (13, (0.2, 0.1, 0.02), (40, 41)),
    (21, (2.5, -1.5, 3.0), (50, 51)),      # a large rotation
    (34, (0.0, 0.0, 0.0), (60, 61)),       # near-identity: angle ties
    (55, (-3.0, 2.0, -1.4), (70, 71)),
])
def test_cascade_fuzz_vs_oracle(wseed, pose_b, seeds):
    _cascade_vs_oracle(wseed, pose_b, seeds)


def test_gmm_vs_oracle():
    from contour_context_tpu_torch.ops.gmm import (gmm_from_desc,
                                                   init_correlation,
                                                   optimize_correlation)

    world = make_world(3)
    pts_a = render_scan(world, (0.0, 0.0, 0.0), seed=10)
    pts_b = render_scan(world, (2.0, 1.0, 0.3), seed=11)
    gcfg = jconfig.GMMOptConfig()
    ga = oracle.build_gmm(oracle.build_scan(pts_a, OCFG, 0), gcfg)
    gb = oracle.build_gmm(oracle.build_scan(pts_b, OCFG, 1), gcfg)
    # the true BEV-frame delta of B at (2, 1, 0.3) against A at the origin
    # (tests/test_cascade.py)
    dth = -0.3
    c, s = math.cos(dth), math.sin(dth)
    ox = CM.n_row / 2 - 0.5
    dx = c * -2.0 - s * -1.0
    dy = s * -2.0 + c * -1.0
    tx = dx + ox - (c * ox - s * ox)
    ty = dy + ox - (s * ox + c * ox)
    T_init = np.array([tx, ty, dth])
    T33 = np.array([[c, -s, tx], [s, c, ty], [0, 0, 1.0]])
    sel_o = oracle.gmm_select_pairs(ga, gb, T33, gcfg)
    corr_o = oracle.gmm_correlation(ga, gb, sel_o, T_init, gcfg)

    ta = gmm_from_desc(ScanDesc(*[x[None] for x in _build(pts_a)]), CFG.gmm)
    tb = gmm_from_desc(ScanDesc(*[x[None] for x in _build(pts_b)]), CFG.gmm)
    T0 = torch.tensor(T_init, dtype=torch.float32)[None]
    corr_t, sel_t = init_correlation(ta, tb, T0)
    np.testing.assert_allclose(float(corr_t[0]), corr_o, rtol=2e-2)
    assert corr_o > 0.3                    # a genuine revisit correlates
    corr_f, _ = optimize_correlation(ta, tb, T0, sel_t)
    assert float(corr_f[0]) >= float(corr_t[0]) - 1e-4


# -- range search (tests/test_db_misc.py:328-432) ----------------------------

def test_range_search_vs_numpy_oracle():
    world = make_world(11, n_structs=220, extent=160.0)
    db = tdb.ContourDB(CFG, capacity=8, device="cpu")
    for i in range(6):
        db.add_scan(_build(render_scan(world, (10.0 * i, 0.0, 0.0),
                                       seed=500 + i)), i, 6.0 * i)
        db.push_and_balance(6.0 * i)
    assert db.searchable_n > 0
    q = _build(render_scan(world, (10.5, 0.8, 0.2), seed=900))
    r2 = 16.0
    hits, n_total = db.range_search(q, r2)
    assert n_total > 0

    keys = db.store.keys.numpy()            # (N, L, A, 10)
    qk = q.keys.numpy()                     # (L, A, 10)
    valid = [(g, lev, s, a) for lev in CFG.db.q_levels
             for a in range(qk.shape[1]) if np.abs(qk[lev, a]).sum() > 0
             for g in range(db.searchable_n)
             for s in range(keys.shape[2])
             if np.abs(keys[g, lev, s]).sum() > 0]

    def d2(g, lev, s, a):
        return float(((keys[g, lev, s] - qk[lev, a]) ** 2).sum())

    expect = {h for h in valid if d2(*h) < r2}
    assert n_total == len(expect)
    assert {h[:4] for h in hits} == expect
    dists = [h[4] for h in hits]
    assert dists == sorted(dists)
    for g, lev, s, a, dd in hits:
        # |q|^2+|r|^2-2qr in f32 against the oracle's direct diff^2
        np.testing.assert_allclose(dd, d2(g, lev, s, a), rtol=2e-3,
                                   atol=2e-3)
    hits2, n2 = db.range_search(q, r2, cap=2)
    assert n2 == n_total and len(hits2) == min(2, n_total)
    # an over-wide radius clamps below MAX_DIST_SQ: the masked sentinel rows
    # never surface as hits
    hits3, n3 = db.range_search(q, 1e12, cap=4096)
    assert n3 == len(valid) and {h[:4] for h in hits3} == set(valid)


def test_range_search_big_store_vs_numpy_oracle():
    rng = np.random.default_rng(5)
    N, L, A, D = 512, 6, 6, 10
    q_levels = (1, 2, 3)
    keys = rng.uniform(0.1, 5.0, (N, L, A, D)).astype(np.float32)
    keys[::9] = 0.0                         # invalid rows
    qk = rng.uniform(0.1, 5.0, (L, A, D)).astype(np.float32)
    searchable, r2, cap = 400, 9.0, 64
    packed = tdb.range_search_impl(
        tdb.keys_to_q_layout(torch.from_numpy(keys)).contiguous(),
        torch.from_numpy(qk), torch.tensor(searchable, dtype=torch.int32),
        r2, q_levels, cap).numpy()
    n_total = int(packed[0, 0])
    hits = packed[1:][packed[1:, 4] >= 0]
    d2 = np.stack([((keys[:searchable, lev][None] - qk[lev][:, None, None])
                    ** 2).sum(-1) for lev in q_levels])    # (Q, Aq, S, A)
    row_ok = np.stack([np.abs(keys[:searchable, lev]).sum(-1) > 0
                       for lev in q_levels])               # (Q, S, A)
    inr = (d2 < r2) & row_ok[:, None]
    assert n_total == int(inr.sum()) > cap
    expect = {(g, q_levels[qi], s, a) for qi, a, g, s in zip(*np.nonzero(inr))}
    got = {tuple(int(x) for x in h[:4]) for h in hits}
    assert got <= expect and len(hits) == cap      # the cap nearest
    dd = [float(h[4]) for h in hits]
    assert dd == sorted(dd)
    assert abs(dd[-1] - sorted(d2[inr].tolist())[cap - 1]) < 1e-2
