"""The bodies the port's new CUDA graphs capture, on the CPU: the unfused
API (the per-scan build, `query_async`, `add_scan`, `push_and_balance`),
the block's append and window pushes, and `dynamic_thres` on the device.

- The plain `dynamic_pass_scan` and `dynamic_post_scan` (the CPU path of
  the `dyn_pass_scan` / `dyn_post_scan` kernels) exactly against JAX's
  `lax.scan`s (`contour_context_tpu/ops/candidate.py:290`, `:322`) and
  against `host_pass_scan` / `host_post_scan` below, a numpy copy of the
  host loops the port ran before (the spec), at B = 1, 3 and 16 and at the
  edges: nothing passes, every row passes, the bars clamp at ub on the
  first row. Both run under a guard that makes every host read of a
  tensor raise (`.item`, `.cpu`, `.numpy`, `.tolist`, `bool()`, `int()`,
  `float()`): neither syncs the host.
- The graphed code paths of `ContourDB` run on the CPU through a stand-in
  for the device's graph pool (`torch_graph_stub`: a capture runs the
  body once, a replay runs it again on the static buffers), so every
  static buffer, copy and body the card's graphs use runs here: the
  unfused stream's records against the eager path's bit for bit and
  against JAX's `_query_step` on the same descriptors (found, gidx and
  counters exactly, corr and T in the record bands), with store, keys_q,
  timestamps and window state exact; the block step under `dynamic_thres` against the
  append + `replay_window` + `query_step_batch` it replaces; a
  QueryHandle keeps its record after a later `query_async`.
- The graph registry: two DBs on one device share one pool; a DB's
  `drop_graphs` leaves the other's graphs in place; the pool's handle is
  renewed only after its last graph is gone. A graph is captured again
  when a tensor it reads changes shape at the same address, and goes when
  the tensor it was captured for (its owner) is freed.
"""

import contextlib
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_world, render_scan
import torch_graph_stub

from contour_context_tpu import config as jconfig
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch import graphs
from contour_context_tpu_torch.ops import candidate as tcand
from contour_context_tpu_torch.ops.descriptor import build_descriptors
from contour_context_tpu_torch.types import ScanDesc
from contour_context_tpu_torch.utils.io import pad_points

torch.set_num_threads(2)

JCFG = jconfig.PipelineConfig(cm=jconfig.ContourManagerConfig(max_points=16384))
CFG = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(max_points=16384))
DYN = tconfig.PipelineConfig(
    cm=tconfig.ContourManagerConfig(max_points=16384),
    db=tconfig.ContourDBConfig(dynamic_thres=True))
POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
    (10.5, 0.8, 0.2), (30.0, -1.0, -0.15), (50.2, 0.7, 0.1),
    (20.3, 0.5, -0.1)]
N, DT = len(POSES), 6.0
EXACT = [0, 1] + list(range(6, 18))       # found, gidx, counters


# ---------------------------------------------------------------------------
# the spec: the host loops the port ran before, in numpy
# ---------------------------------------------------------------------------

def host_pass_scan(pass1, cols, lbv, ubv):
    """pass1 (R, H) bool, cols (5, R, H) ints, lbv / ubv 5 ints."""
    bars = np.tile(np.asarray(lbv, np.int64), (pass1.shape[0], 1))
    ubv = np.asarray(ubv, np.int64)
    sc = np.stack(cols, axis=-1).astype(np.int64)          # (R, H, 5)
    out = np.zeros(pass1.shape + (2,), np.bool_)
    for t in range(pass1.shape[1]):
        row = sc[:, t]
        p2 = pass1[:, t] & (row[:, 0:3] >= bars[:, 0:3]).all(axis=1)
        p3 = p2 & (row[:, 3:5] >= bars[:, 3:5]).all(axis=1)
        raised = np.minimum(np.maximum(bars, row[:, 4:5]), ubv)
        bars = np.where(p3[:, None], raised, bars)
        out[:, t, 0], out[:, t, 1] = p2, p3
    return out[..., 0], out[..., 1]


def host_post_scan(in_use, vals, lbv, ubv):
    """in_use (R, C) bool, vals (3, R, C) float32, lbv / ubv 3 floats."""
    f32 = np.float32
    bars = np.tile(np.asarray(lbv, f32), (in_use.shape[0], 1))
    ubv = np.asarray(ubv, f32)
    x = np.stack(vals, axis=-1).astype(f32)                # (R, C, 3)
    keep = np.zeros(in_use.shape, np.bool_)
    for t in range(in_use.shape[1]):
        k = in_use[:, t] & (x[:, t] >= bars).all(axis=1)
        bars = np.where(k[:, None], np.minimum(np.maximum(bars, x[:, t]),
                                               ubv), bars)
        keep[:, t] = k
    return keep


@contextlib.contextmanager
def no_host_reads():
    """Every host read of a tensor raises inside the block."""
    names = ("item", "cpu", "numpy", "tolist", "__bool__", "__int__",
             "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(*args, **kwargs):
        raise AssertionError("a host read of a tensor")

    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


def _pass_bars(e):
    return (e.sim_constell.i_ovlp_sum, e.sim_constell.i_ovlp_max_one,
            e.sim_constell.i_in_ang_rng, e.sim_pair.i_indiv_sim,
            e.sim_pair.i_orie_sim)


def _post_bars(e):
    return (e.sim_post.area_perc, e.sim_post.neg_est_dist,
            e.sim_post.correlation)


KINDS = ["random", "nothing passes", "every row passes",
         "clamp at ub on the first row"]


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_dynamic_scans_match_jax_and_the_host_loops(kind, B):
    from contour_context_tpu.ops.candidate import (dynamic_pass_scan,
                                                   dynamic_post_scan)

    rng = np.random.default_rng(KINDS.index(kind) * 7 + B)
    lb, ub = DYN.thres_lb, DYN.thres_ub
    jlb, jub = JCFG.thres_lb, JCFG.thres_ub
    H, C = 256, 64
    pass1 = rng.random((B, H)) < 0.8
    cols = [rng.integers(0, 10, (B, H)).astype(np.int32) for _ in range(5)]
    in_use = rng.random((B, C)) < 0.85
    vals = [rng.uniform(0.0, 0.3, (B, C)), rng.uniform(-8.0, -3.0, (B, C)),
            rng.uniform(0.1, 0.9, (B, C))]
    vals = [v.astype(np.float32) for v in vals]
    top_pass = max(_pass_bars(ub))
    top_post = np.asarray(_post_bars(ub), np.float32)
    if kind == "nothing passes":
        pass1[:] = False
        in_use[:] = False
    elif kind == "every row passes":
        pass1[:] = True
        in_use[:] = True
        for c in cols:
            c[:] = top_pass
        for v, top in zip(vals, top_post):
            v[:] = top
    elif kind == "clamp at ub on the first row":
        pass1[:, 0] = True
        in_use[:, 0] = True
        for c in cols:
            c[:, 0] = top_pass + 5
        for v, top in zip(vals, top_post):
            v[:, 0] = top + 1.0

    t_pass = (torch.from_numpy(pass1), *[torch.from_numpy(c) for c in cols])
    t_post = (torch.from_numpy(in_use), *[torch.from_numpy(v) for v in vals])
    with no_host_reads():
        p2, p3 = tcand.dynamic_pass_scan(*t_pass, lb, ub)
        keep = tcand.dynamic_post_scan(*t_post, lb.sim_post, ub.sim_post)
    assert p2.dtype == p3.dtype == keep.dtype == torch.bool
    assert p2.shape == (B, H) and keep.shape == (B, C)

    h2, h3 = host_pass_scan(pass1, cols, _pass_bars(lb), _pass_bars(ub))
    hk = host_post_scan(in_use, vals, _post_bars(lb), _post_bars(ub))
    np.testing.assert_array_equal(p2.numpy(), h2)
    np.testing.assert_array_equal(p3.numpy(), h3)
    np.testing.assert_array_equal(keep.numpy(), hk)

    j2, j3 = jax.vmap(lambda p, *c: dynamic_pass_scan(p, *c, jlb, jub))(
        jnp.asarray(pass1), *[jnp.asarray(c) for c in cols])
    jk = jax.vmap(lambda u, a, d, c: dynamic_post_scan(
        u, a, d, c, jlb.sim_post, jub.sim_post))(
        jnp.asarray(in_use), *[jnp.asarray(v) for v in vals])
    np.testing.assert_array_equal(p2.numpy(), np.asarray(j2))
    np.testing.assert_array_equal(p3.numpy(), np.asarray(j3))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))

    if kind == "nothing passes":
        assert not p3.any() and not keep.any()
    elif kind == "every row passes":
        assert p3.all() and keep.all()
    elif kind == "clamp at ub on the first row":
        # the bars sit at ub after row 0: only rows reaching every upper
        # bar pass after it
        assert p3[:, 0].all() and keep[:, 0].all()
        tops = np.stack(cols, -1)[:, 1:] >= np.asarray(_pass_bars(ub))
        assert not (p3[:, 1:].numpy() & ~tops.all(-1)).any()


@pytest.mark.parametrize("bars", [((5, 2, 7, 3, 9), (3, 8, 7, 1, 12)),
                                  ((4, 4, 4, 4, 4), (4, 4, 4, 4, 4))])
def test_dynamic_pass_scan_with_bars_out_of_order(bars):
    """Bars a config may hold though the defaults do not: lb above ub (the
    bars jump to ub at the first pass) and lb equal to ub; the plain scan
    against the host loop, under the no-host-read guard."""
    from contour_context_tpu_torch.ops import kernels

    rng = np.random.default_rng(sum(bars[0]))
    pass1 = rng.random((16, 256)) < 0.8
    cols = [rng.integers(0, 13, (16, 256)).astype(np.int32)
            for _ in range(5)]
    with no_host_reads():
        p2, p3 = kernels.dyn_pass_scan(
            torch.from_numpy(pass1), *[torch.from_numpy(c) for c in cols],
            *bars)
    h2, h3 = host_pass_scan(pass1, cols, *bars)
    np.testing.assert_array_equal(p2.numpy(), h2)
    np.testing.assert_array_equal(p3.numpy(), h3)
    assert 0 < int(p3.sum()) < int(p2.sum())


# ---------------------------------------------------------------------------
# the graphed code paths on the CPU, through a stand-in for the pool
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_pool():
    with torch_graph_stub.fake_pool():
        yield


def _graphed_db(cfg, capacity=8):
    """A CPU DB that takes its graphed code paths (through the pool the
    `fake_pool` fixture stands in)."""
    db = tdb.ContourDB(cfg, capacity=capacity, device="cpu")
    db._graphs.enabled = True
    return db


@pytest.fixture(scope="module")
def clouds():
    world = make_world(11, n_structs=220, extent=160.0)
    return np.stack([pad_points(render_scan(world, p, seed=500 + i),
                                CFG.cm.max_points)
                     for i, p in enumerate(POSES)])


@pytest.fixture(scope="module")
def descs(clouds):
    return build_descriptors(torch.from_numpy(clouds), CFG.cm, CFG.gmm)


@pytest.fixture(scope="module")
def jax_records(descs):
    """JAX's unfused stream on the port's descriptors: per scan the record
    of `query_async` (None on the empty DB), then add_scan and
    push_and_balance."""
    from contour_context_tpu.db import ContourDB as JDB
    from contour_context_tpu.types import ScanDesc as JScanDesc

    jdb = JDB(JCFG, capacity=8)
    recs = []
    for i in range(N):
        d = JScanDesc(*[jnp.asarray(x[i].numpy()) for x in descs])
        h = jdb.query_async(d)
        recs.append(None if h is None else np.asarray(h.rec))
        jdb.add_scan(d, i, DT * i)
        jdb.push_and_balance(DT * i)
    return recs, np.asarray(jdb.state)


def _stream(db, clouds, descs, own_desc):
    """The pipeline's unfused loop over the stream; `own_desc` queries and
    appends the DB's own build output, else the precomputed descriptors
    (copied into the static buffers). Returns the records."""
    recs = []
    for i in range(N):
        desc = db._build_one(torch.from_numpy(clouds[i])) if own_desc \
            else ScanDesc(*[x[i] for x in descs])
        h = db.query_async(desc)
        recs.append(None if h is None else h.rec.clone())
        db.add_scan(desc, i, DT * i)
        db.push_and_balance(DT * i)
    return recs


def _assert_same_db(a, b):
    n = a.n
    assert n == b.n and a.seq_of_gidx == b.seq_of_gidx and a.ts == b.ts
    for name, x, y in zip(a.store._fields, a.store, b.store):
        assert torch.equal(x[:n], y[:n]), name
    assert torch.equal(a.keys_q.view(torch.int16), b.keys_q.view(torch.int16))
    assert torch.equal(a.ts_store, b.ts_store)
    assert torch.equal(a.state, b.state)


def test_unfused_bodies_match_the_eager_path_and_jax(fake_pool, clouds,
                                                     descs, jax_records):
    eager = tdb.ContourDB(CFG, capacity=8, device="cpu")
    r_eager = _stream(eager, clouds, descs, own_desc=False)
    graphed = _graphed_db(CFG)
    r_own = _stream(graphed, clouds, descs, own_desc=True)
    copied = _graphed_db(CFG)
    r_copy = _stream(copied, clouds, descs, own_desc=False)
    # the stream grew the DBs from 8 rows to 16: the graphs were dropped and
    # captured again at the new tensors
    assert eager.capacity == graphed.capacity == copied.capacity == 16
    assert set(graphed._graphs.graphs) == {
        ("build", torch.float32, (1, CFG.cm.max_points, 4)), ("add_scan",),
        ("push",), ("query_step",)}
    _assert_same_db(graphed, eager)
    _assert_same_db(copied, eager)
    j_recs, j_state = jax_records
    assert r_eager[0] is None and r_own[0] is None and j_recs[0] is None
    rt = torch.stack(r_own[1:]).numpy()
    for other in (r_eager, r_copy):
        assert torch.equal(torch.stack(other[1:]).view(torch.int32),
                           torch.stack(r_own[1:]).view(torch.int32))
    rj = np.stack(j_recs[1:])
    np.testing.assert_array_equal(rt[:, EXACT], rj[:, EXACT])
    np.testing.assert_allclose(rt[:, 2], rj[:, 2], rtol=1e-4, atol=1e-4)
    found = rj[:, 0] > 0.5
    np.testing.assert_allclose(rt[found, 3:6], rj[found, 3:6], rtol=1e-4,
                               atol=2e-3)
    assert [int(g) for g in rj[7:, 1]] == [1, 3, 5, 2]
    np.testing.assert_array_equal(graphed.state.numpy(), j_state)
    # each record equals query_step at the window state of its scan
    state = torch.zeros(2, dtype=torch.int32)
    tb = CFG.db.tb
    for i in range(1, N):
        state[0] = i
        tdb.update_window(state, eager.ts_store, eager.ts_store[i - 1],
                          tb.min_elapse, tb.max_elapse)
        rec = tdb.query_step(eager.store, eager.keys_q,
                             ScanDesc(*[x[i] for x in descs]), state, CFG)
        assert torch.equal(rec.view(torch.int32),
                           r_own[i].view(torch.int32)), i


def test_query_handle_keeps_its_record(fake_pool, descs):
    db = _graphed_db(CFG, capacity=16)
    for i in range(8):
        db.add_scan(ScanDesc(*[x[i] for x in descs]), i, DT * i)
        db.push_and_balance(DT * i)
    q1, q2 = (ScanDesc(*[x[i] for x in descs]) for i in (8, 11))
    h1 = db.query_async(q1)
    rec1 = h1.rec.clone()
    h2 = db.query_async(q2)
    assert torch.equal(h1.rec, rec1)
    assert not torch.equal(h1.rec, h2.rec)
    for h, q in ((h1, q1), (h2, q2)):
        assert torch.equal(h.rec, tdb.query_step(db.store, db.keys_q, q,
                                                 db.state, CFG))
    assert h1.get()[0] == 1 and h2.get()[0] == 2


def test_block_append_body_matches_append_and_replay_window(fake_pool,
                                                            descs):
    """Three blocks of 4 under dynamic_thres through the append graph's and
    the query graph's bodies against the block step they replace: the
    appends, the window pushes replayed per query, the batched query."""
    B, tb = 4, DYN.db.tb
    db = _graphed_db(DYN)
    ref = tdb.ContourDB(DYN, capacity=16, device="cpu")
    ref._init_store()
    recs = []
    for k in range(0, N, B):
        d = ScanDesc(*[x[k:k + B] for x in descs])
        ts = [DT * i for i in range(k, k + B)]
        h = db.process_block_async(d, list(range(k, k + B)), ts)
        recs.append(h.recs)
        ts_t = torch.tensor(ts, dtype=torch.float32)
        ref._append(d, ts_t)
        sb = tdb.replay_window(ref.state, ref.ts_store, ts_t, tb.min_elapse,
                               tb.max_elapse)
        assert torch.equal(db._graphs.bufs[("sb", B)], sb)
        ref.recs_store[k:k + B] = tdb.query_step_batch(
            ref.store, ref.keys_q, d, sb, DYN)
    assert ("block_append", B) in db._graphs.graphs
    assert ("query", B) in db._graphs.graphs
    ref.seq_of_gidx = list(range(N))
    ref.ts = [DT * i for i in range(N)]
    _assert_same_db(db, ref)
    got = torch.cat(recs)
    assert torch.equal(got.view(torch.int32),
                       ref.recs_store[:N].view(torch.int32))
    assert int((got[8:, 0] > 0.5).sum()) >= 2


def test_registry_shares_one_pool_and_drops_per_db(fake_pool, descs):
    """Two DBs on one device: one pool, each DB its own graphs; one DB's
    drop_graphs leaves the other's graphs in place and replaying; the pool
    handle is renewed only after the last graph is gone."""
    a, b = _graphed_db(CFG, 16), _graphed_db(CFG, 16)
    pool = graphs.device_pool(a.device)
    assert graphs.device_pool(b.device) is pool
    for db in (a, b):
        for i in range(4):
            db.add_scan(ScanDesc(*[x[i] for x in descs]), i, DT * i)
            db.push_and_balance(DT * i)
    handle = pool.handle
    assert len(pool.live) == 4          # ("add_scan",) and ("push",) each
    a.drop_graphs()
    assert not a._graphs.graphs and len(pool.live) == 2
    assert set(b._graphs.graphs) == {("add_scan",), ("push",)}
    b.add_scan(ScanDesc(*[x[4] for x in descs]), 4, DT * 4)
    assert b.n == 5 and int(b.state[0]) == 5
    # a captures again into the same pool while b's graphs live
    a.add_scan(ScanDesc(*[x[4] for x in descs]), 4, DT * 4)
    assert pool.handle == handle and len(pool.live) == 3
    a.drop_graphs()
    b.drop_graphs()
    assert len(pool.live) == 0
    a.push_and_balance(DT * 5)
    assert pool.handle != handle and len(pool.live) == 1
    a.drop_graphs()


def test_graph_tag_and_owner(fake_pool):
    """A view of the owner at its address with another shape has another
    tag (a capture bakes the shape in), so the set captures again; a
    graph goes with its owner, static buffers and the holder's other
    graphs stay."""
    g = graphs.GraphSet(torch.device("cpu"))
    assert g.reason == "cpu" and not g.enabled
    owner, runs = torch.zeros(8), []

    def body(x):       # holds no tensor, as a real graph holds no body
        shape = tuple(x.shape)
        return lambda: runs.append(shape)

    g.run("a", body(owner), graphs.tensor_tag(owner), owner)
    g.run("a", body(owner), graphs.tensor_tag(owner), owner)
    first = g.graphs["a"]
    assert runs == [(8,), (8,)]
    view = owner[:5]
    assert view.data_ptr() == owner.data_ptr()
    g.run("a", body(view), graphs.tensor_tag(view), owner)
    assert runs[-1] == (5,) and g.graphs["a"] is not first
    g.run("b", lambda: None)
    g.static("buf", (2,), torch.int32)
    del owner, view, first
    gc.collect()
    assert list(g.graphs) == ["b"] and list(g.capture_s) == ["b"]
    assert list(g.bufs) == ["buf"]
