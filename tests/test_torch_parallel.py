"""The port's multi-GPU layer (contour_context_tpu_torch/parallel.py) on the
CPU: ranks spawned over gloo (a file store in a temporary directory), one
spawn a world size, each rank at one thread; what a rank runs is
tests/test_torch_parallel_ranks.py.

The configuration is `__graft_entry__.dryrun_multichip`'s small operating
point (100 x 100 BEV, 8192-point clouds, 32 contours a level, nnk 16, 128
hint slots) with f32 search keys (`keys_bf16=False`): the shards search f32
keys, as JAX's `sharded_search` does, so the single-device reference is the
f32 path. The clouds are dryrun_multichip's: 10 scans 6 s apart, revisits
of them at 0.5 m, one revisit query of scan 1.

- `pad_rows_to_mesh` and `shard_store` at world 1-4, even and uneven.
- `sharded_search` at world 2 and 4 on N = 2·world + 2 rows with a partial
  searchable_n against JAX's `sharded_search` on a 2- and a 4-device
  sub-mesh of the conftest's 8 CPU devices: gidx, seq_src and valid
  exactly, dist to 1e-5 (tests/test_torch_kernels.py's band);
  `sharded_search_batch` row by row equal to `sharded_search` at each
  query's limit.
- The sharded query step (B = 1, and B = 4 with per-query limits), the
  sharded localization of 6 clouds and the sharded block step of 4 at
  world 1, 2 and 3 (10 rows: uneven at 3, one shard wholly past the
  window) against the port's single-device f32 path: bit for bit (the
  same ops on the same rows of the same device); the block's shards,
  keys_q, window state, timestamps and record ring too. The block's store
  capacity puts a shard boundary inside the block at world 2 and 3.
- The B = 1 record against JAX's `_query_step(..., keys_q=None)`: found,
  gidx and counters exactly, corr and T to rtol 1e-4 (T atol 2e-3 cells,
  the LM band between float32 paths; tests/test_torch_gmm.py is its
  witness).
- `dp_build_descriptors` + `all_gather_desc` against JAX's
  `vmap(build_descriptor)` in the descriptor bands
  (tests/test_torch_descriptor.py's `assert_desc_close`), and a batch the
  world size does not divide raises.
- The block step writes at rows read from state[0] on the device: at
  world 2 the block wholly below and wholly above the shard boundary (the
  rank owning none of its rows leaves its shard as it was), besides
  across it, every result the single-device block's bit for bit.
- Every entry point's graphed code path (static inputs and outputs, one
  graph a call) through a stand-in for the graph pool (a capture runs the
  body, a replay runs it again) at world 1 and 2: two blocks in turn
  through one block graph, the query step, the batched query, serving and
  the search equal to the eager calls and the single-device results; a
  gloo mesh reports itself eager (`graphed` false, reason "gloo").
Every rank's results equal rank 0's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_world, render_scan
from test_torch_descriptor import assert_desc_close

from contour_context_tpu import config as jconfig
from contour_context_tpu.utils.io import pad_points
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch import parallel as par
from contour_context_tpu_torch.graphs import GraphSet
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.types import ScanDesc, scan_desc_from_numpy

import test_torch_parallel_ranks as ranks

torch.set_num_threads(2)


def _configs():
    return tuple(m.PipelineConfig(
        cm=m.ContourManagerConfig(n_row=100, n_col=100, max_points=8192,
                                  max_contours=32, keys_bf16=False),
        db=dataclasses.replace(m.ContourDBConfig(), nnk=16,
                               max_check_cands=128, max_pass_hints=64,
                               max_cand_poses=32))
        for m in (jconfig, tconfig))


JCFG, CFG = _configs()
N = 10                      # store rows of the query, localization, block
B = 4                       # the batched query and the block
N_LOC = 6                   # localized clouds: divisible by 1, 2 and 3
SEARCHABLE_B = [7, 4, 9, 2]
QUERY_WORLDS = (1, 2, 3)
SEARCH_WORLDS = (2, 4)
# block store capacity a world: a shard boundary inside rows 10..13 at
# world 2 (11 rows a shard) and 3 (6 rows a shard)
BLOCK_CAP = {1: 16, 2: 22, 3: 16}
# the block of 4 at rows 10..13 wholly below and wholly above world 2's
# shard boundary (14 and 10 rows a shard)
BLOCK_AT = {"below": 28, "above": 20}
# two blocks of 4 in turn through the graphed code path (a stand-in pool
# on the CPU): rows 10..13 across world 2's boundary, 14..17 above it
GRAPHED_CAP = 24
GRAPHED_WORLDS = (1, 2)


def _port_desc(x):
    """JAX-built descriptor leaves (numpy) -> the port's ScanDesc on the
    CPU with the port's own derived leaves (as its build packs them)."""
    d = scan_desc_from_numpy(x, device="cpu")
    return d._replace(tab12=td.tab12_of(d),
                      gmm_pack=td.gmm_pack_of(d, CFG.gmm))


def _rows(d, s):
    return ScanDesc(*[x[s] for x in d])


def _db(capacity, descs):
    db = tdb.ContourDB(CFG, capacity=capacity, device="cpu")
    for i in range(N):
        db.add_scan(_rows(descs, i), i, 6.0 * i)
        db.push_and_balance(6.0 * i)
    return db


@pytest.fixture(scope="module")
def built():
    """The clouds and their JAX-built descriptors (one jit(vmap) build)."""
    from contour_context_tpu.ops.descriptor import build_descriptor

    world = make_world(7, n_structs=160, extent=80.0)
    poses = ([(6.0 * i, 0.3 * (i % 3), 0.05 * (i % 5)) for i in range(N)]
             + [(6.0 * i, 0.5, 0.1) for i in range(N_LOC)]
             + [(6.0, 0.6, 0.15)])
    seeds = ([100 + i for i in range(N)] + [700 + i for i in range(N_LOC)]
             + [900])
    pts = np.stack([pad_points(render_scan(world, p, seed=s, max_range=48.0),
                               CFG.cm.max_points)
                    for p, s in zip(poses, seeds)])
    jd = jax.device_get(jax.jit(jax.vmap(
        lambda p: build_descriptor(p, JCFG.cm, JCFG.gmm)))(jnp.asarray(pts)))
    return pts, jd, _port_desc(jd)


@pytest.fixture(scope="module")
def refs(built):
    """The single-device f32 references and the inputs every rank gets."""
    pts, _, descs = built
    db = _db(N, descs)
    q = _rows(descs, N + N_LOC)
    qb = _rows(descs, slice(N, N + B))
    loc_pts = pts[N:N + N_LOC]
    sb = torch.tensor(SEARCHABLE_B, dtype=torch.int32)
    out = dict(
        query=tdb.query_step(db.store, db.keys_q, q, db.state, CFG),
        query_batch=tdb.query_step_batch(db.store, db.keys_q, qb, sb, CFG),
        localize=tdb.query_step_batch(
            db.store, db.keys_q, td.build_descriptors(
                torch.from_numpy(loc_pts), CFG.cm, CFG.gmm),
            db.state[1].expand(N_LOC).contiguous(), CFG))
    data = dict(cfg=CFG, store=db.store, state=db.state, q=q, qb=qb,
                searchable_b=sb, loc_pts=loc_pts, search={}, block={},
                query_worlds=QUERY_WORLDS)
    for w in SEARCH_WORLDS:
        n = 2 * w + 2
        data["search"][w] = (descs.keys[:n], n - 3, q.keys)
    ts_b = 6.0 * N + torch.arange(B, dtype=torch.float32)
    def block(cap, k=1):
        m = _db(cap, descs)
        before = dict(store=ScanDesc(*[x.clone() for x in m.store]),
                      ts_store=m.ts_store.clone(), state=m.state.clone(),
                      recs_store=m.recs_store.clone(), ts_b=ts_b, n=N)
        recs = [m.process_block_async(
            qb, list(range(N + i * B, N + (i + 1) * B)), ts_b + i * B).recs
            for i in range(k)]
        return before, (torch.cat(recs), m)

    for w, cap in BLOCK_CAP.items():
        data["block"][w], out[("block", w)] = block(cap)
    data["block_at"] = {}
    for where, cap in BLOCK_AT.items():
        data["block_at"][where], out[("block_at", where)] = block(cap)
    data["graphed"], out["graphed"] = block(GRAPHED_CAP, 2)
    data["graphed_worlds"] = GRAPHED_WORLDS
    return db, out, data


@pytest.fixture(scope="module")
def ranks_out(refs):
    """Every rank's results, each world size spawned once."""
    _, _, data = refs
    return {w: par.spawn_ranks(ranks.run_world, w, (data,), backend="gloo",
                               device="cpu")
            for w in sorted(set(QUERY_WORLDS) | set(SEARCH_WORLDS))}


def _equal(a, b, what):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    else:
        assert a == b, what


def _mesh(rank, world):
    """A rank's Mesh without a process group: pad_rows_to_mesh and
    shard_store communicate nothing."""
    cpu = torch.device("cpu")
    return par.Mesh(None, rank, world, cpu, "gloo", GraphSet(cpu, "gloo"))


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("rows", [8, 10])
def test_pad_rows_and_shard_store(built, world, rows):
    """Rank r keeps rows [r·N_loc, (r+1)·N_loc) of the zero-padded store,
    with the f32 search layout of its keys; the ranks' blocks in order are
    the padded store."""
    descs = _rows(built[2], slice(0, rows))
    n_loc = -(-rows // world)
    padded = [par.pad_rows_to_mesh(x, _mesh(0, world)) for x in descs]
    for x, p in zip(descs, padded):
        assert p.shape == (n_loc * world,) + x.shape[1:]
        assert torch.equal(p[:rows], x) and not p[rows:].any()
        if rows % world == 0:
            assert p is x
    blocks = []
    for r in range(world):
        sh = par.shard_store(descs, _mesh(r, world))
        assert (sh.base, sh.rows) == (r * n_loc, rows)
        assert sh.keys_q.dtype == torch.float32 and sh.keys_q.is_contiguous()
        assert torch.equal(sh.keys_q, tdb.keys_to_q_layout(sh.store.keys))
        blocks.append(sh.store)
    for i, p in enumerate(padded):
        assert torch.equal(torch.cat([b[i] for b in blocks]), p)


def _replicated(x):
    """A rank's results without its own shards (every "block_shard")."""
    if isinstance(x, dict):
        return {k: _replicated(v) for k, v in x.items()
                if not k.startswith("block_shard")}
    return x


def test_every_rank_has_the_same_results(ranks_out):
    for w, per_rank in ranks_out.items():
        for r in range(1, w):
            _equal(_replicated(per_rank[r]), _replicated(per_rank[0]),
                   f"world {w} rank {r}")


@pytest.mark.parametrize("world", SEARCH_WORLDS)
def test_sharded_search_matches_jax(refs, ranks_out, world):
    from jax.sharding import Mesh

    from contour_context_tpu.parallel import sharded_search

    keys, sn, q_keys = refs[2]["search"][world]
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    want = jax.device_get(sharded_search(
        jnp.asarray(keys.numpy()), jnp.asarray(q_keys.numpy()),
        jnp.int32(sn), tuple(CFG.db.q_levels), CFG.db.nnk, mesh))
    got = ranks_out[world][0]["search"]
    for name, g, j in zip(("gidx", "seq_src", "dist", "valid"), got, want):
        assert g.shape == j.shape, name
        if name == "dist":
            np.testing.assert_allclose(g.numpy(), j, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), j, err_msg=name)
    valid = got[3].numpy()
    assert 0 < valid.sum() < valid.size
    # the batched search's rows are the single searches at their limits
    lower = ranks_out[world][0]["search_lower"]
    for batched, at_sn, below in zip(ranks_out[world][0]["search_batch"],
                                     got, lower):
        assert torch.equal(batched[0], at_sn)
        assert torch.equal(batched[1], below)
    assert not torch.equal(lower[3], got[3])
    # the rows past searchable_n, the padded ones included, never hit
    assert (got[0].numpy()[valid] < sn).all()


@pytest.mark.parametrize("world", QUERY_WORLDS)
@pytest.mark.parametrize("what", ["query", "query_batch", "localize"])
def test_sharded_query_matches_single(refs, ranks_out, world, what):
    want = refs[1][what]
    got = ranks_out[world][0][what]
    assert torch.equal(got, want), (what, got, want)
    recs = want.reshape(-1, tdb.RECORD_WIDTH)
    assert (recs[:, 0] > 0.5).any() and (recs[:, 6] > 0).all()


def test_sharded_query_matches_jax(refs, ranks_out):
    from contour_context_tpu.db import _query_step
    from contour_context_tpu.types import ScanDesc as JScanDesc

    db, _, data = refs

    def jax_desc(d):
        return JScanDesc(*[jnp.asarray(x.numpy()) for x in d])

    rec_j = np.asarray(_query_step(jax_desc(db.store), jax_desc(data["q"]),
                                   jnp.asarray(db.state.numpy()), JCFG))
    exact = [0, 1] + list(range(6, 18))
    for w in QUERY_WORLDS:
        rec = ranks_out[w][0]["query"].numpy()
        np.testing.assert_array_equal(rec[exact], rec_j[exact])
        np.testing.assert_allclose(rec[2], rec_j[2], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(rec[3:6], rec_j[3:6], rtol=1e-4,
                                   atol=2e-3)
    assert rec_j[0] > 0.5 and rec_j[7] > 0


@pytest.mark.parametrize("world", QUERY_WORLDS)
def test_sharded_block_matches_single(refs, ranks_out, world):
    recs, m = refs[1][("block", world)]
    got = ranks_out[world]
    assert torch.equal(got[0]["block"], recs)
    assert (recs[:, 0] > 0.5).any()
    assert torch.equal(got[0]["block_state"], m.state)
    assert torch.equal(got[0]["block_ts_store"], m.ts_store)
    assert torch.equal(got[0]["block_recs_store"], m.recs_store)
    shards = [r["block_shard"] for r in got]
    for i, leaf in enumerate(m.store):
        whole = torch.cat([s.store[i] for s in shards])
        assert torch.equal(whole[:m.capacity], leaf), ScanDesc._fields[i]
        assert not whole[m.capacity:].any()
    kq = torch.cat([s.keys_q for s in shards], dim=2)
    assert torch.equal(kq[:, :, :m.keys_q.shape[2]], m.keys_q)
    n_loc = shards[0].store.keys.shape[0]
    assert (N // n_loc != (N + B - 1) // n_loc) == (world > 1)


@pytest.mark.parametrize("world", QUERY_WORLDS)
def test_dp_build_matches_jax_vmap(built, ranks_out, world):
    _, jd, _ = built
    assert ranks_out[world][0]["dp_uneven_raised"]
    assert_desc_close(type(jd)(*[np.asarray(x)[N:N + N_LOC] for x in jd]),
                      ranks_out[world][0]["dp_build"])


def _assert_block_equal(got, recs, m, what):
    """A rank's sharded block results (records, window state, timestamps,
    record ring, every rank's shard) bit for bit the single-device DB's."""
    assert torch.equal(got[0]["block"], recs), what
    assert torch.equal(got[0]["block_state"], m.state), what
    assert torch.equal(got[0]["block_ts_store"], m.ts_store), what
    assert torch.equal(got[0]["block_recs_store"], m.recs_store), what
    shards = [r["block_shard"] for r in got]
    for i, leaf in enumerate(m.store):
        whole = torch.cat([s.store[i] for s in shards])
        assert torch.equal(whole[:m.capacity], leaf), (what, i)
    kq = torch.cat([s.keys_q for s in shards], dim=2)
    assert torch.equal(kq[:, :, :m.keys_q.shape[2]], m.keys_q), what


@pytest.mark.parametrize("where", sorted(BLOCK_AT))
def test_sharded_block_below_and_above_a_shard_boundary(refs, ranks_out,
                                                        where):
    """World 2's block wholly in shard 0 or wholly in shard 1: the rank
    that owns none of its rows writes none (its shard is unchanged) and
    every result is the single-device block's."""
    recs, m = refs[1][("block_at", where)]
    got = [r["block_at"][where] for r in ranks_out[2]]
    _assert_block_equal(got, recs, m, where)
    before = refs[2]["block_at"][where]["store"]
    n_loc = got[0]["block_shard"].store.keys.shape[0]
    idle = 1 if where == "below" else 0
    assert (N + B <= n_loc) == (where == "below") and \
        (N >= n_loc) == (where == "above")
    base = idle * n_loc
    for i, leaf in enumerate(got[idle]["block_shard"].store):
        assert torch.equal(leaf[:max(0, m.capacity - base)],
                           before[i][base:base + n_loc]), i


@pytest.mark.parametrize("world", GRAPHED_WORLDS)
def test_sharded_graphed_paths_equal_eager_and_single(refs, ranks_out,
                                                      world):
    """The graphed code path of every sharded entry point on the CPU,
    through a stand-in pool (a capture runs the body, a replay runs it
    again): two blocks in turn through one block graph (one graph serves
    every n: rows 10..13, then 14..17), the single-device DB's two blocks
    bit for bit; the query step, the batched query, serving and the
    search equal to the eager calls and the single-device results."""
    recs, m = refs[1]["graphed"]
    g = [r["graphed"] for r in ranks_out[world]]
    _assert_block_equal([x["blocks"] for x in g], recs, m, "graphed")
    _assert_block_equal([x["blocks_eager"] for x in g], recs, m, "eager")
    for what in ("query", "query_batch", "localize"):
        assert torch.equal(g[0][what], refs[1][what]), what
    for a, b in zip(g[0]["search"], g[0]["search_eager"]):
        assert torch.equal(a, b)
    assert g[0]["graph_keys"] == ["block", "localize", "query_batch",
                                  "query_step", "search"]
    assert g[0]["captures"] == 5 and g[0]["stats"]["graphed"]
    assert ranks_out[world][0]["stats"] == {"graphed": False,
                                            "reason": "gloo"}


def test_sharded_graph_captured_again_on_a_recut_shard(ranks_out):
    """World 1: serving on a shard, then on views of its first half (a
    shard of another row count at the same addresses). The views' tag
    holds their shapes and row count, so the graph is captured again (a
    capture for the new full shard, one for the cut) rather than replayed
    with the full shard's sizes: each graphed result equals the eager call
    on its own shard, and the cut's differs from the full shard's."""
    g = ranks_out[1][0]["graphed"]
    assert g["recut_same_address"] and g["recut_captures"] == 2
    for name in ("full", "cut"):
        assert torch.equal(g[f"recut_{name}"], g[f"recut_{name}_eager"]), \
            name
    assert not torch.equal(g["recut_cut"], g["recut_full"])
