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
        bshard = par.shard_store(blk["store"], mesh)
        ts_store, st = blk["ts_store"].clone(), blk["state"].clone()
        recs_store = blk["recs_store"].clone()
        out["block"] = par.sharded_process_block(
            bshard, ts_store, st, recs_store, data["qb"], blk["ts_b"],
            blk["n"], cfg, mesh)
        out["block_state"] = st
        out["block_ts_store"] = ts_store
        out["block_recs_store"] = recs_store
        out["block_shard"] = bshard
    return _cpu(out)
