"""One query of the port against JAX on a carried-across store.

A JAX ContourDB is seeded with 11 synth scans (a revisit world, 6 s apart);
its device state is fetched as numpy and carried into the port with
ContourDB.from_numpy_state. One revisit query then runs in both, on the
same JAX-built query descriptor, at the default caps and at squeezed ones
that make every overflow path run. Every CascadeResult and CandidateState
leaf and the packed 18-float record are compared: ints and bools exactly,
floats (T_delta, pair/proposal percentages, prop_T, corr, T) to rtol 1e-4
and atol 1e-4, the record band of PARITY.md (T is in BEV cells and radians).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu import config as jconfig
from contour_context_tpu.utils.io import pad_points
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch.types import scan_desc_from_numpy

torch.set_num_threads(2)



def _configs(**db):
    """(JAX config, port config), each from its own package and the same
    arguments: neither package's functions see the other's config."""
    return tuple(m.PipelineConfig(cm=m.ContourManagerConfig(max_points=16384),
                                  db=m.ContourDBConfig(**db))
                 for m in (jconfig, tconfig))


CFG, TCFG = _configs()
POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
    (30.0, -1.0, -0.15), (110.0, 40.0, 0.6), (50.2, 0.7, 0.1)]
QUERY_POSE = (10.5, 0.8, 0.2)      # revisits scan 1


def _jax_stages(store, query, keys_q, state, pcfg):
    """JAX's _query_step_impl up to the merge, returning its intermediates
    (the same calls in the same order as db.py:782-850)."""
    from contour_context_tpu import db as jdb
    from contour_context_tpu.ops.candidate import (merge_proposals,
                                                   select_topk_stable)

    cfg = pcfg
    q_levels = tuple(cfg.db.q_levels)
    gidx, seq_src, dist, valid = jdb._search_impl(
        keys_q, query.keys, state[1], q_levels, cfg.db.nnk,
        cfg.db.topk_strategy)
    Q, A, K = gidx.shape
    lv = jnp.array(q_levels, jnp.int32)
    level_f = jnp.broadcast_to(lv[:, None, None], (Q, A, K)).reshape(-1)
    seq_tgt_f = jnp.broadcast_to(
        jnp.arange(A, dtype=jnp.int32)[None, :, None], (Q, A, K)).reshape(-1)
    HC = min(cfg.db.max_check_cands, Q * A * K)
    perm, hv, n_valid, overflow_hints = jdb._select_hints(
        valid.reshape(-1), dist.reshape(-1), HC)
    g_h, l_h = gidx.reshape(-1)[perm], level_f[perm]
    ss_h, st_h = seq_src.reshape(-1)[perm], seq_tgt_f[perm]
    pass1_all = jdb._check1_impl(store, query, g_h, l_h, ss_h, st_h, hv,
                                 cfg.db.cont_sim)
    aft1 = jnp.sum(pass1_all).astype(jnp.int32)
    perm2, hv_run, n_run, _ = select_topk_stable(
        jnp.arange(HC, dtype=jnp.float32), pass1_all, HC)
    g_h, l_h, ss_h, st_h = g_h[perm2], l_h[perm2], ss_h[perm2], st_h[perm2]
    res = jdb._cascade_chunked(store, query, g_h, l_h, ss_h, st_h, hv_run,
                               n_run, cfg.thres_lb, cfg.db.cont_sim,
                               cfg.db.cascade_chunk, cfg.db.p_pot)
    st = merge_proposals(
        res.pass3, g_h, res.T_delta, res.pair_valid, res.pair_level,
        res.pair_seq_src, res.pair_seq_tgt, res.pair_area_perc,
        n_cand_max=cfg.db.max_cand_poses, n_pass_max=cfg.db.max_pass_hints)
    return n_valid, overflow_hints, aft1, g_h, res, st


@pytest.fixture(scope="module")
def carried():
    """The seeded JAX DB's state as numpy, the JAX query descriptor and the
    JAX DB itself."""
    from contour_context_tpu.db import ContourDB as JDB
    from contour_context_tpu.ops.descriptor import build_descriptor

    world = make_world(11, n_structs=220, extent=160.0)
    jdb = JDB(CFG, capacity=16)
    for i, pose in enumerate(POSES):
        pts = pad_points(render_scan(world, pose, seed=500 + i),
                         CFG.cm.max_points)
        jdb.add_scan(build_descriptor(jnp.asarray(pts), CFG.cm, CFG.gmm),
                     i, 6.0 * i)
        jdb.push_and_balance(6.0 * i)
    qpts = pad_points(render_scan(world, QUERY_POSE, seed=777),
                      CFG.cm.max_points)
    qdesc = build_descriptor(jnp.asarray(qpts), CFG.cm, CFG.gmm)
    host = dict(store=jax.device_get(jdb.store),
                keys_q=np.asarray(jdb.keys_q),
                ts_store=np.asarray(jdb.ts_store),
                state=np.asarray(jdb.state), recs_store=None, n=jdb.n,
                seq_of_gidx=jdb.seq_of_gidx)
    return host, qdesc, jdb


# "squeezed" caps make every overflow path and overlapping cascade chunks
# run: 96 hints in chunks of 40 (the last chunk's start is clamped), a
# 16-hint merge budget, 2 candidate rows and an 8-pair angular window
CASES = {
    "default": (CFG, TCFG),
    "squeezed": _configs(max_check_cands=96, cascade_chunk=40,
                         max_pass_hints=16, max_cand_poses=2, p_pot=8),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, carried):
    """(port config, JAX record, JAX intermediates) of the one query."""
    from contour_context_tpu.db import _query_step

    cfg, tcfg = CASES[request.param]
    _, qdesc, jdb = carried
    rec_j = np.asarray(_query_step(jdb.store, qdesc, jdb.state, cfg,
                                   jdb.keys_q))
    stages_j = jax.device_get(jax.jit(_jax_stages, static_argnums=4)(
        jdb.store, qdesc, jdb.keys_q, jdb.state, cfg))
    return request.param, tcfg, rec_j, stages_j


def _port_db(host, derive_keys_q=False, cfg=TCFG):
    h = dict(host)
    if derive_keys_q:
        h["keys_q"] = None
    return tdb.ContourDB.from_numpy_state(cfg, device="cpu", **h)


def test_carry_across_keys_q_agree(carried):
    host, _, _ = carried
    assert host["keys_q"].dtype.name == "bfloat16"
    a = _port_db(host).keys_q
    b = _port_db(host, derive_keys_q=True).keys_q
    assert a.dtype == b.dtype == torch.bfloat16
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert int(_port_db(host).state[1]) == int(host["state"][1]) > 0


def _cmp(name, b, a, exact):
    a = np.asarray(a)
    b = b.cpu().numpy()
    assert a.shape == b.shape, name
    if exact or a.dtype.kind != "f":
        np.testing.assert_array_equal(b, a, err_msg=name)
    else:
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4, err_msg=name)


def test_query_stages_match_jax(carried, case):
    host, qdesc, _ = carried
    name, cfg, _, (n_valid, ovf, aft1, g_h, res_j, st_j) = case
    db = _port_db(host, cfg=cfg)
    q = scan_desc_from_numpy(jax.device_get(qdesc), device="cpu")
    qs = tdb.query_stages(db.store, db.keys_q, q, db.state, cfg)
    _cmp("n_valid", qs.n_valid, n_valid, True)
    _cmp("overflow_hints", qs.overflow_hints, ovf, True)
    _cmp("aft1", qs.aft1, aft1, True)
    _cmp("gidx", qs.gidx, g_h, True)
    for field, b, a in zip(res_j._fields, qs.res, res_j):
        _cmp("cascade." + field, b, a, False)
    for field, b, a in zip(st_j._fields, qs.st, st_j):
        _cmp("merge." + field, b, a, False)
    # the query genuinely exercises the cascade and the merge
    assert int(n_valid) > 20 and int(np.sum(res_j.pass3)) > 0
    assert int(st_j.n_cand) > 0
    if name == "squeezed":
        assert int(ovf) > 0 and int(st_j.overflow_pass) > 0
        assert int(st_j.overflow_cand) > 0 and np.any(res_j.pot_overflow)


def test_query_record_matches_jax(carried, case):
    host, qdesc, _ = carried
    name, cfg, rec_j, _ = case
    db = _port_db(host, cfg=cfg)
    q = scan_desc_from_numpy(jax.device_get(qdesc), device="cpu")
    rec_t = tdb.query_step(db.store, db.keys_q, q, db.state, cfg).numpy()
    assert rec_t.shape == (tdb.RECORD_WIDTH,)
    exact = [0, 1] + list(range(6, 18))       # found, gidx, counters
    np.testing.assert_array_equal(rec_t[exact], rec_j[exact])
    np.testing.assert_allclose(rec_t[2:6], rec_j[2:6], rtol=1e-4, atol=1e-4)
    r = tdb.unpack_record(rec_j)
    if name == "default":
        assert r.found and host["seq_of_gidx"][r.gidx] == 1, r


def test_grow_keeps_the_query(carried):
    host, qdesc, _ = carried
    db = _port_db(host)
    q = scan_desc_from_numpy(jax.device_get(qdesc), device="cpu")
    rec0 = tdb.query_step(db.store, db.keys_q, q, db.state, TCFG)
    kq0 = db.keys_q.clone()
    db._grow(40)
    assert db.capacity == 40 and db.store.keys.shape[0] == 40
    assert db.keys_q.shape == (6, 10, 40 * 6)
    assert torch.equal(db.keys_q[:, :, :kq0.shape[2]], kq0)
    assert db.searchable_n == int(host["state"][1])
    rec1 = tdb.query_step(db.store, db.keys_q, q, db.state, TCFG)
    assert torch.equal(rec0, rec1)


def test_device_and_unported_options_raise(carried):
    if not torch.cuda.is_available():       # no silent CPU carry-on
        with pytest.raises(RuntimeError):
            tdb.ContourDB(TCFG, capacity=8, device="cuda")
        with pytest.raises(RuntimeError):
            tdb.ContourDB.load("unused.npz", TCFG)
    # dynamic_thres is ported: the option constructs and runs (held against
    # JAX in tests/test_torch_dynamic.py); its rising bars can only thin out
    # the check-2/3 survivors, never check 1
    host, qdesc, _ = carried
    dyn = _configs(dynamic_thres=True)[1]
    db = _port_db(host, cfg=dyn)
    q = scan_desc_from_numpy(jax.device_get(qdesc), device="cpu")
    r_dyn = tdb.unpack_record(
        tdb.query_step(db.store, db.keys_q, q, db.state, dyn).numpy())
    r = tdb.unpack_record(
        tdb.query_step(db.store, db.keys_q, q, db.state, TCFG).numpy())
    assert r_dyn.found and r_dyn.gidx == r.gidx
    assert r_dyn.n_hints == r.n_hints and r_dyn.aft1 == r.aft1
    assert 0 < r_dyn.aft3 <= r_dyn.aft2 <= r.aft2
