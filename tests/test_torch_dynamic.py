"""`dynamic_thres` and `range_search` of the port against JAX.

- `dynamic_pass_scan` and `dynamic_post_scan` against the JAX functions on
  seeded numpy inputs: both are integer / comparison recurrences, so the
  masks are compared exactly, element for element;
- one query with `dynamic_thres=True` on a store carried across from a JAX
  ContourDB (as tests/test_torch_query.py does) against JAX `_query_step`:
  found, gidx and counters exactly, corr and T to rtol 1e-4 (atol 1e-4, and
  2e-3 cells for the pose where two float32 LM paths meet);
- `range_search` against JAX's on the same store, with bf16 and with f32
  `keys_q`, and a `cap` smaller than the in-range count: the hits' ids and
  order and the total exactly, the distances to rtol 1e-6 (XLA contracts
  the squared-difference chain into FMAs on the CPU, torch does not).
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
from contour_context_tpu_torch.ops import candidate as tcand
from contour_context_tpu_torch.types import scan_desc_from_numpy

torch.set_num_threads(2)


def _configs(keys_bf16=True, **db):
    return tuple(m.PipelineConfig(
        cm=m.ContourManagerConfig(max_points=16384, keys_bf16=keys_bf16),
        db=m.ContourDBConfig(**db)) for m in (jconfig, tconfig))


JDYN, TDYN = _configs(dynamic_thres=True)
POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
    (30.0, -1.0, -0.15), (110.0, 40.0, 0.6), (50.2, 0.7, 0.1)]
QUERY_POSE = (10.5, 0.8, 0.2)      # revisits scan 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dynamic_pass_scan_matches_jax(seed):
    from contour_context_tpu.ops.candidate import dynamic_pass_scan

    rng = np.random.default_rng(seed)
    H = 256
    # counts around the bars (lb 3/3/3/3/4, ub above), many passing rows so
    # the bars rise several times and hit the upper clamp
    cols = [rng.integers(0, 14, H).astype(np.int32) for _ in range(5)]
    pass1 = rng.random(H) < 0.8
    if seed == 3:
        pass1[:] = False                      # nothing passes: bars never move
    p2_j, p3_j = dynamic_pass_scan(jnp.asarray(pass1),
                                   *[jnp.asarray(c) for c in cols],
                                   JDYN.thres_lb, JDYN.thres_ub)
    p2_t, p3_t = tcand.dynamic_pass_scan(
        torch.from_numpy(pass1), *[torch.from_numpy(c) for c in cols],
        TDYN.thres_lb, TDYN.thres_ub)
    assert p2_t.dtype == p3_t.dtype == torch.bool and p2_t.shape == (H,)
    np.testing.assert_array_equal(p2_t.numpy(), np.asarray(p2_j))
    np.testing.assert_array_equal(p3_t.numpy(), np.asarray(p3_j))
    if seed != 3:
        # the rising bars bite: fewer rows pass than under the static bars
        lb = TDYN.thres_lb
        static = pass1 & (cols[0] >= lb.sim_constell.i_ovlp_sum) \
            & (cols[1] >= lb.sim_constell.i_ovlp_max_one) \
            & (cols[2] >= lb.sim_constell.i_in_ang_rng) \
            & (cols[3] >= lb.sim_pair.i_indiv_sim) \
            & (cols[4] >= lb.sim_pair.i_orie_sim)
        assert 0 < int(p3_t.sum()) < int(static.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dynamic_post_scan_matches_jax(seed):
    from contour_context_tpu.ops.candidate import dynamic_post_scan

    rng = np.random.default_rng(10 + seed)
    C = 32
    in_use = rng.random(C) < 0.85
    area = rng.uniform(0.0, 0.4, C).astype(np.float32)
    neg_d = rng.uniform(-8.0, 0.0, C).astype(np.float32)
    corr0 = rng.uniform(0.1, 0.9, C).astype(np.float32)
    # exact ties with a bar a previous candidate raised
    area[5], neg_d[5], corr0[5] = area[2], neg_d[2], corr0[2]
    lb, ub = JDYN.thres_lb.sim_post, JDYN.thres_ub.sim_post
    keep_j = dynamic_post_scan(jnp.asarray(in_use), jnp.asarray(area),
                               jnp.asarray(neg_d), jnp.asarray(corr0), lb, ub)
    keep_t = tcand.dynamic_post_scan(
        torch.from_numpy(in_use), torch.from_numpy(area),
        torch.from_numpy(neg_d), torch.from_numpy(corr0),
        TDYN.thres_lb.sim_post, TDYN.thres_ub.sim_post)
    assert keep_t.dtype == torch.bool and keep_t.shape == (C,)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    static = in_use & (area >= np.float32(lb.area_perc)) \
        & (neg_d >= np.float32(lb.neg_est_dist)) \
        & (corr0 >= np.float32(lb.correlation))
    assert 0 < int(keep_t.sum()) < int(static.sum())


@pytest.fixture(scope="module")
def carried():
    """A seeded JAX DB (11 scans, 6 s apart), its state as numpy and the
    JAX-built descriptor of a revisit query."""
    from contour_context_tpu.db import ContourDB as JDB
    from contour_context_tpu.ops.descriptor import build_descriptor

    cfg = JDYN
    world = make_world(11, n_structs=220, extent=160.0)
    jdb = JDB(cfg, capacity=16)
    for i, pose in enumerate(POSES):
        pts = pad_points(render_scan(world, pose, seed=500 + i),
                         cfg.cm.max_points)
        jdb.add_scan(build_descriptor(jnp.asarray(pts), cfg.cm, cfg.gmm),
                     i, 6.0 * i)
        jdb.push_and_balance(6.0 * i)
    qdesc = build_descriptor(jnp.asarray(pad_points(
        render_scan(world, QUERY_POSE, seed=777), cfg.cm.max_points)),
        cfg.cm, cfg.gmm)
    host = dict(store=jax.device_get(jdb.store),
                keys_q=np.asarray(jdb.keys_q),
                ts_store=np.asarray(jdb.ts_store),
                state=np.asarray(jdb.state), recs_store=None, n=jdb.n,
                seq_of_gidx=jdb.seq_of_gidx)
    return host, qdesc, jdb


def test_dynamic_thres_record_matches_jax(carried):
    from contour_context_tpu.db import _query_step

    host, qdesc, jdb = carried
    rec_j = np.asarray(_query_step(jdb.store, qdesc, jdb.state, JDYN,
                                   jdb.keys_q))
    db = tdb.ContourDB.from_numpy_state(TDYN, device="cpu", **host)
    q = scan_desc_from_numpy(jax.device_get(qdesc), device="cpu")
    rec_t = tdb.query_step(db.store, db.keys_q, q, db.state, TDYN).numpy()
    exact = [0, 1] + list(range(6, 18))
    np.testing.assert_array_equal(rec_t[exact], rec_j[exact])
    np.testing.assert_allclose(rec_t[2], rec_j[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rec_t[3:6], rec_j[3:6], rtol=1e-4, atol=2e-3)
    r = tdb.unpack_record(rec_j)
    assert r.found and host["seq_of_gidx"][r.gidx] == 1, r
    # the option bites on this query: fewer hints pass check 3 than under
    # the static bars, check 1 is untouched
    static = tdb.unpack_record(tdb.query_step(
        db.store, db.keys_q, q, db.state, _configs()[1]).numpy())
    assert r.aft1 == static.aft1 and 0 < r.aft3 < static.aft3


@pytest.mark.parametrize("keys_bf16", [True, False])
def test_range_search_matches_jax(carried, keys_bf16):
    from contour_context_tpu.db import ContourDB as JDB

    host, qdesc, jdb = carried
    jcfg, tcfg = _configs(keys_bf16=keys_bf16)
    if keys_bf16:
        jq = jdb
    else:       # the same store under an f32 search copy
        jq = JDB(jcfg, capacity=16)
        jq.store, jq.ts_store, jq.state, jq.n = (jdb.store, jdb.ts_store,
                                                 jdb.state, jdb.n)
        jq.keys_q = jnp.asarray(
            np.asarray(jdb.store.keys).transpose(1, 3, 0, 2).reshape(6, 10, -1))
        assert jq.keys_q.dtype == jnp.float32
    h = dict(host, keys_q=None)
    db = tdb.ContourDB.from_numpy_state(tcfg, device="cpu", **h)
    assert db.keys_q.dtype == (torch.bfloat16 if keys_bf16 else torch.float32)
    q = scan_desc_from_numpy(jax.device_get(qdesc), device="cpu")
    for radius, cap in ((3.0, 256), (60.0, 7), (1e9, 12), (1e-9, 8)):
        hits_j, n_j = jq.range_search(qdesc, radius, cap=cap)
        hits_t, n_t = db.range_search(q, radius, cap=cap)
        assert n_t == n_j and len(hits_t) == len(hits_j) == min(cap, n_t)
        assert [x[:4] for x in hits_t] == [x[:4] for x in hits_j], radius
        np.testing.assert_allclose([x[4] for x in hits_t],
                                   [x[4] for x in hits_j], rtol=1e-6, atol=0)
    hits, n = db.range_search(q, 60.0, cap=7)
    assert n > 7 and [x[4] for x in hits] == sorted(x[4] for x in hits)
    assert all(g < int(host["state"][1]) for g, *_ in hits)
    assert tdb.ContourDB(tcfg, 8, device="cpu").range_search(q, 1.0) == ([], 0)
