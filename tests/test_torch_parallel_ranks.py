"""What a spawned rank of tests/test_torch_parallel.py runs (this file holds
no test and imports no jax, so a rank starts with torch and the port only).

`run_world(mesh, data)` drives every sharded entry point the world size of
`mesh` is asked for in `data` on the rank's CPU shard and returns the
results as CPU tensors; the test compares every rank's with rank 0's and
rank 0's with the references.
"""

import torch

from contour_context_tpu_torch import parallel as par
from contour_context_tpu_torch.types import ScanDesc


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_cpu(v) for v in x])
    if isinstance(x, (tuple, list)):
        return [_cpu(v) for v in x]
    return x


def run_world(mesh, data):
    torch.set_num_threads(1)
    cfg, w, out = data["cfg"], mesh.world, {}
    ql, nnk = tuple(cfg.db.q_levels), cfg.db.nnk

    if w in data["search"]:
        keys, sn, q_keys = data["search"][w]
        store = ScanDesc(*[keys if f == "keys" else keys.new_zeros(
            (keys.shape[0], 0)) for f in ScanDesc._fields])
        shard = par.shard_store(store, mesh)
        out["search"] = par.sharded_search(shard.keys_q, q_keys, sn, ql, nnk,
                                           mesh)
        # two queries in one batched search: the query at sn, the same
        # keys at a smaller limit
        out["search_batch"] = par.sharded_search_batch(
            shard.keys_q, torch.stack([q_keys, q_keys]),
            torch.tensor([sn, sn - 2], dtype=torch.int32), ql, nnk, mesh)
        out["search_lower"] = par.sharded_search(shard.keys_q, q_keys,
                                                 sn - 2, ql, nnk, mesh)

    if w in data["query_worlds"]:
        store, state = data["store"], data["state"]
        shard = par.shard_store(store, mesh)
        out["query"] = par.sharded_query_step(shard, data["q"], state, cfg,
                                              mesh)
        out["query_batch"] = par.sharded_query_step_batch(
            shard, data["qb"], data["searchable_b"], cfg, mesh)
        pts = data["loc_pts"]
        out["dp_build"] = par.all_gather_desc(
            par.dp_build_descriptors(pts, cfg.cm, cfg.gmm, mesh), mesh)
        try:
            par.dp_build_descriptors(pts[:w + 1], cfg.cm, cfg.gmm, mesh)
            out["dp_uneven_raised"] = w == 1
        except ValueError:
            out["dp_uneven_raised"] = True
        out["localize"] = par.sharded_localize_block(shard, state, pts, cfg,
                                                     mesh)
        blk = data["block"][w]
        out.update(_block(mesh, blk, data["qb"], cfg))
        out["block_at"] = {k: _block(mesh, v, data["qb"], cfg)
                           for k, v in data["block_at"].items()} \
            if w == 2 else {}
        st = mesh.graph_stats()
        out["stats"] = {k: st[k] for k in ("graphed", "reason")}
    if w in data["graphed_worlds"]:
        out["graphed"] = _graphed(mesh, data)
    return _cpu(out)


def _block(mesh, blk, qb, cfg, k=1):
    """k blocks of qb in turn on a sharded copy of `blk`'s store."""
    bshard = par.shard_store(blk["store"], mesh)
    ts_store, st = blk["ts_store"].clone(), blk["state"].clone()
    recs_store = blk["recs_store"].clone()
    B = qb.keys.shape[0]
    recs = [par.sharded_process_block(bshard, ts_store, st, recs_store, qb,
                                      blk["ts_b"] + i * B, blk["n"] + i * B,
                                      cfg, mesh) for i in range(k)]
    return dict(block=torch.cat(recs), block_state=st,
                block_ts_store=ts_store, block_recs_store=recs_store,
                block_shard=bshard)


def _graphed(mesh, data):
    """Every sharded entry point through its graphed code path on the CPU:
    the graph pool stood in for by torch_graph_stub, the gloo mesh's graphs
    switched on for the block. Then, at world 1, serving on a shard cut to
    half its rows by views at the same addresses: its tag differs, so it
    is captured again and equals the eager call on the cut shard."""
    from torch_graph_stub import fake_pool

    cfg, out = data["cfg"], {}
    ql, nnk = tuple(cfg.db.q_levels), cfg.db.nnk
    blk, qb = data["graphed"], data["qb"]
    out["blocks_eager"] = _block(mesh, blk, qb, cfg, k=2)
    with fake_pool() as captures:
        mesh.graphs.enabled = True
        try:
            calls, shard = _graphed_calls(mesh, data, cfg, ql, nnk, blk, qb)
            out.update(calls)       # the shard's graphs live as it does
            out["captures"] = len(captures)
            out["stats"] = mesh.graph_stats()
            if mesh.world == 1:     # the views are a valid shard at world 1
                out.update(_recut(mesh, data, cfg))
                out["recut_captures"] = len(captures) - out["captures"]
        finally:
            mesh.graphs.enabled = False
    return out


def _graphed_calls(mesh, data, cfg, ql, nnk, blk, qb):
    out = {"blocks": _block(mesh, blk, qb, cfg, k=2)}
    shard = par.shard_store(data["store"], mesh)
    out["query"] = par.sharded_query_step(shard, data["q"], data["state"],
                                          cfg, mesh)
    out["query_batch"] = par.sharded_query_step_batch(
        shard, qb, data["searchable_b"], cfg, mesh)
    out["localize"] = par.sharded_localize_block(shard, data["state"],
                                                 data["loc_pts"], cfg, mesh)
    sn = int(data["state"][1])
    out["search"] = par.sharded_search(shard.keys_q, data["q"].keys, sn, ql,
                                       nnk, mesh)
    with mesh.eager():
        out["search_eager"] = par.sharded_search(
            shard.keys_q, data["q"].keys, sn, ql, nnk, mesh)
    out["graph_keys"] = sorted(k[0][0] for k in mesh.graphs.graphs)
    return out, shard


def _recut(mesh, data, cfg):
    """Serving on the full shard, then on views of its first half (the
    shard of a map of rows // 2 rows at world 1), graphed and eager."""
    full = par.shard_store(data["store"], mesh)
    pts, state = data["loc_pts"], data["state"]
    n_loc = full.store.keys.shape[0] // 2
    A = full.store.keys.shape[2]
    cut = par.ShardedStore(
        ScanDesc(*[x[:n_loc] for x in full.store]),
        full.keys_q[..., :n_loc * A], full.base, n_loc)
    got = {}
    for name, sh in (("full", full), ("cut", cut)):
        got[f"recut_{name}"] = par.sharded_localize_block(sh, state, pts,
                                                          cfg, mesh)
        with mesh.eager():
            got[f"recut_{name}_eager"] = par.sharded_localize_block(
                sh, state, pts, cfg, mesh)
    got["recut_same_address"] = \
        cut.keys_q.data_ptr() == full.keys_q.data_ptr()
    return got
