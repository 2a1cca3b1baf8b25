"""The port's host spec query against JAX's and against its own device path.

`ContourDB.query_ranged_knn_host` (the sequential host CandidateManager
path: key search, the cascade over every valid hit with no hint cap, the
host proposal merge, tidy statistics and screens, GMM init and the LM over
the best candidates) on the 11-scan revisit sequence of
tests/test_fused_query.py (scan 8 revisits scan 1, scan 9 scan 3, scan 10
is nowhere), caps raised so that the device path sees every hit, with
`dynamic_thres` off and on:
- against JAX's `query_ranged_knn_host` on the same clouds: the no-result
  decisions, found and gidx exactly, corr to rtol and atol 1e-4, T to rtol
  1e-4 and atol 2e-3 cells (the record bands; the LM pose band is where two
  float32 paths meet);
- against the port's device path (`query_ranged_knn`) on the same DB, in
  the same bands. The host path caps no hints, the device path keeps the
  `max_check_cands` nearest: the two are held to each other only on
  queries whose record has overflow_hints == 0. A run with a squeezed cap
  shows queries that do overflow, and holds the rest.
`HostCandidateManager` is held against JAX's on the same random proposal
streams (exactly: the same float64 host arithmetic) and the port's device
merge + tidy against it (mirroring tests/test_fused_query.py). Both query
functions take a `profiler=`.
"""

import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu import config as jconfig
from contour_context_tpu.utils.io import pad_points
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch.ops.descriptor import build_descriptor

torch.set_num_threads(2)

POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
    (10.5, 0.8, 0.2), (30.0, -1.0, -0.15), (110.0, 40.0, 0.6)]


def _cfgs(dynamic, max_check_cands=1024):
    kw = dict(max_check_cands=max_check_cands, max_pass_hints=128,
              dynamic_thres=dynamic)
    return (jconfig.PipelineConfig(
                cm=jconfig.ContourManagerConfig(max_points=16384),
                db=jconfig.ContourDBConfig(**kw)),
            tconfig.PipelineConfig(
                cm=tconfig.ContourManagerConfig(max_points=16384),
                db=tconfig.ContourDBConfig(**kw)))


@pytest.fixture(scope="module")
def clouds():
    world = make_world(11, n_structs=220, extent=160.0)
    return [pad_points(render_scan(world, p, seed=500 + i), 16384)
            for i, p in enumerate(POSES)]


def _drive_port(cfg, clouds):
    """Per scan on one CPU DB: (device record, host result), then append
    and push."""
    db = tdb.ContourDB(cfg, capacity=16, device="cpu")
    out = []
    for i, c in enumerate(clouds):
        d = build_descriptor(torch.from_numpy(c), cfg.cm, cfg.gmm)
        h = db.query_async(d)
        out.append((None if h is None else h.record(),
                    db.query_ranged_knn_host(d)))
        db.add_scan(d, i, 6.0 * i)
        db.push_and_balance(6.0 * i)
    return db, out


@pytest.fixture(scope="module", params=[False, True],
                ids=["static", "dynamic"])
def runs(request, clouds):
    from contour_context_tpu.db import ContourDB as JDB
    from contour_context_tpu.ops.descriptor import build_descriptor as jbuild

    jcfg, cfg = _cfgs(request.param)
    jdb = JDB(jcfg, capacity=16)
    jax_host = []
    for i, c in enumerate(clouds):
        d = jbuild(c, jcfg.cm, jcfg.gmm)
        jax_host.append(jdb.query_ranged_knn_host(d))
        jdb.add_scan(d, i, 6.0 * i)
        jdb.push_and_balance(6.0 * i)
    db, port = _drive_port(cfg, clouds)
    return jax_host, db, port


def _assert_same(a, b, what):
    """Two results (gidx, corr, T3) or None in the record bands."""
    if a is None:
        assert b is None, (what, b)
        return
    assert b is not None, (what, a)
    assert a[0] == b[0], (what, a, b)
    np.testing.assert_allclose(b[1], a[1], rtol=1e-4, atol=1e-4,
                               err_msg=what)
    np.testing.assert_allclose(b[2], a[2], rtol=1e-4, atol=2e-3,
                               err_msg=what)


def test_host_query_matches_jax(runs):
    jax_host, _, port = runs
    for i, (want, (_, got)) in enumerate(zip(jax_host, port)):
        _assert_same(want, got, f"scan {i}")
    found = {i: r[0] for i, r in enumerate(jax_host) if r is not None}
    assert found == {8: 1, 9: 3}, found


def test_host_query_matches_device_path(runs):
    _, db, port = runs
    n_found = 0
    for i, (rec, host) in enumerate(port):
        if rec is None:                  # the empty DB of scan 0
            assert host is None
            continue
        # held only where the device path's hint cap kept every hit
        assert rec.overflow_hints == 0, (i, rec)
        dev = (rec.gidx, rec.corr, rec.T) if rec.found else None
        _assert_same(dev, host, f"scan {i}")
        n_found += rec.found
    assert n_found == 2
    assert db.counters["overflow_pass"] == 0
    assert db.counters["overflow_cand"] == 0


def test_host_query_with_overflowing_hint_cap(clouds):
    """A 48-hint cap overflows on some queries (the device path then keeps
    only the nearest 48 hits, the host path all): host and device are held
    to each other on the others."""
    _, cfg = _cfgs(False, max_check_cands=48)
    _, port = _drive_port(cfg, clouds)
    held = over = 0
    for i, (rec, host) in enumerate(port):
        if rec is None:
            continue
        if rec.overflow_hints:
            over += 1
            continue
        held += 1
        _assert_same((rec.gidx, rec.corr, rec.T) if rec.found else None,
                     host, f"scan {i}")
    assert over > 0 and held > 0, (over, held)
    # the host path still closes both revisits whatever the device cap
    assert [i for i, (_, h) in enumerate(port) if h is not None] == [8, 9]


def test_profiler_on_both_query_functions(runs, clouds):
    from contour_context_tpu_torch.utils.profiling import \
        SequentialTimeProfiler

    _, db, _ = runs
    q = build_descriptor(torch.from_numpy(clouds[8]), db.cfg.cm, db.cfg.gmm)
    p = SequentialTimeProfiler("host")
    p.start()
    r_dev = db.query_ranged_knn(q, profiler=p)
    r_host = db.query_ranged_knn_host(q, profiler=p)
    assert list(p.logs) == ["query (fused)", "KNN search", "Constell",
                            "L2 opt"]
    assert all(lg.cnt == 1 for lg in p.logs.values())
    assert r_dev[0] == r_host[0] == 1
    plain = db.query_ranged_knn(q)
    assert plain[:2] == r_dev[:2]
    np.testing.assert_array_equal(plain[2], r_dev[2])


def test_host_query_on_an_empty_window():
    _, cfg = _cfgs(False)
    db = tdb.ContourDB(cfg, capacity=4, device="cpu")
    pts = torch.zeros((16384, 4))
    d = build_descriptor(pts, cfg.cm, cfg.gmm)
    assert db.query_ranged_knn_host(d) is None          # no store
    db.add_scan(d, 0, 0.0)
    assert db.searchable_n == 0
    assert db.query_ranged_knn_host(d) is None          # nothing searchable
    assert db.gmm_pad == 32 and db.max_fine == cfg.db.max_fine_opt


def _proposals(trial):
    """A random proposal stream (tests/test_fused_query.py): H hints over
    5 candidates, clumped transforms so that proposals merge, pairs unique
    within each hint."""
    from contour_context_tpu_torch.ops.candidate import N_SEQ

    rng = np.random.default_rng(3 + trial)
    H, P = 40, 8
    pass3 = rng.random(H) < 0.5
    gidx = rng.integers(0, 5, H).astype(np.int32)
    T = np.stack([rng.uniform(-8, 8, H), rng.uniform(-8, 8, H),
                  rng.uniform(-0.8, 0.8, H)], axis=1).astype(np.float32)
    T[rng.random(H) < 0.5, :2] = rng.uniform(-1, 1, 2).astype(np.float32)
    pv = rng.random((H, P)) < 0.8
    plev = rng.integers(1, 5, (H, P)).astype(np.int32)
    pss = rng.integers(0, N_SEQ, (H, P)).astype(np.int32)
    pst = rng.integers(0, N_SEQ, (H, P)).astype(np.int32)
    for h in range(H):
        seen = set()
        for j in range(P):
            while (plev[h, j], pss[h, j], pst[h, j]) in seen:
                pst[h, j] = (pst[h, j] + 1) % N_SEQ
            seen.add((plev[h, j], pss[h, j], pst[h, j]))
    perc = rng.uniform(0, 0.2, (H, P)).astype(np.float32)
    return pass3, gidx, T, pv, plev, pss, pst, perc


def _feed(mgr, pass3, gidx, T, pv, plev, pss, pst, perc):
    for h in np.flatnonzero(pass3):
        sel = np.flatnonzero(pv[h])
        mgr.add_passing_hint(int(gidx[h]), T[h].astype(np.float64),
                             [(int(plev[h, j]), int(pss[h, j]),
                               int(pst[h, j])) for j in sel],
                             [float(perc[h, j]) for j in sel])
    return mgr.tidy_stats()


@pytest.mark.parametrize("trial", range(4))
def test_host_candidate_manager_matches_jax(trial):
    from contour_context_tpu.db import HostCandidateManager as JMgr
    from contour_context_tpu_torch.ops.candidate import (merge_proposals,
                                                         tidy_candidates)

    jcfg, cfg = _cfgs(False)
    prop = _proposals(trial)
    mj, mt = JMgr(jcfg), tdb.HostCandidateManager(cfg)
    sj, st_ = _feed(mj, *prop), _feed(mt, *prop)
    assert mt.order == mj.order and len(st_) == len(sj) > 1
    for (cj, aj, nj), (ct, at, nt) in zip(sj, st_):
        assert ct.gidx == cj.gidx and (at, nt) == (aj, nj)
        assert len(ct.props) == len(cj.props)
        for pj, pt in zip(cj.props, ct.props):
            np.testing.assert_array_equal(pt.T, pj.T)
            assert (pt.vote_cnt, pt.constell, pt.area_perc) == \
                (pj.vote_cnt, pj.constell, pj.area_perc)
    assert any(len(c.props) > 1 or c.props[0].vote_cnt > 8
               for c, _, _ in st_)                      # proposals merged

    # the port's device merge + tidy against the host replica
    pass3, gidx, T, pv, plev, pss, pst, perc = prop
    st = merge_proposals(*[torch.from_numpy(np.asarray(x))[None] for x in (
        pass3, gidx, T, pv, plev, pss, pst, perc)], n_cand_max=8,
        n_pass_max=64)
    tt = tidy_candidates(st, -1.0, -1e9, cfg.cm.n_row, cfg.cm.n_col,
                         cfg.cm.reso_row, cfg.cm.reso_col)
    assert int(st.n_cand[0]) == len(mt.order)
    for ci, (cand, area, neg_d) in enumerate(st_):
        assert int(st.cand_gidx[0, ci]) == cand.gidx
        assert int(st.prop_n[0, ci]) == len(cand.props)
        np.testing.assert_allclose(tt.T_sel[0, ci].numpy(), cand.props[0].T,
                                   atol=1e-4)
        np.testing.assert_allclose(float(tt.area[0, ci]), area, atol=1e-5)
        np.testing.assert_allclose(float(tt.neg_d[0, ci]), neg_d, atol=1e-4)
        assert int(tt.votes[0, ci]) == cand.props[0].vote_cnt
