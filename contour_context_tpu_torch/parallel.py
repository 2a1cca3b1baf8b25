"""Multi-GPU over torch.distributed: the row-sharded key search and query,
the sharded block step and map serving, the data-parallel descriptor build.

Port of `contour_context_tpu/parallel.py`. One process per GPU (a rank of a
torch.distributed group) holds a contiguous block of the store's rows, as
JAX's `P("data")` lays a row-sharded store out over a mesh:

- **Row-sharded search** (`sharded_search`): each rank runs the tile-min
  kernel over its own rows (the single-query entry for one query, the
  batched entry for B), picks its local top k, shifts the row ids by its
  base, and an `all_gather` in rank order pools the candidates; a stable
  ascending sort of the pool takes the global top k, which is JAX's
  `lax.top_k` over the device-merged pool (ties to the lower pool index,
  i.e. the single-device (distance, column) order).
- **Sharded query** (`sharded_query_step`, `sharded_query_step_batch`): the
  sharded search, then the tail's candidate rows gathered to every rank,
  then `db.query_from_hits` on every rank. Only the leaves the tail reads
  (`TAIL_LEAVES`) move, only at the rows the hint cap keeps: each rank
  packs its own rows, an `all_gather` follows, and every row is taken from
  its owner's slot (bit-exact; no sum). The tail runs unchanged on that
  compact store, indexed by a monotone remap of the row ids (sorted unique
  -> 0..U-1), so every comparison the merge and the tidy make on row ids
  holds; the record's row id is mapped back.
- **Data-parallel build** (`dp_build_descriptors`, `all_gather_desc`):
  rank r builds its contiguous B/world clouds with
  `ops.descriptor.build_descriptors`.
- **Serving and the block step** (`sharded_localize_block`,
  `sharded_process_block`): the counterparts of `db._localize_block` and
  `db._process_block` on a sharded store; the timestamps, the window state
  and the record ring stay replicated.

Like JAX's `sharded_search`, the shards search float32 keys (each rank keeps
an f32 search-layout copy of its rows), not the single-device DB's bf16
`keys_q`: the single-device reference of every sharded result is the f32
path (`ContourManagerConfig(keys_bf16=False)`).

The collectives are `dist.all_gather` on the group's tensors: NCCL takes
them on the card; a gloo group moves a CUDA tensor through the host
(`_gloo_all_gather_via_host`), so several ranks can share one card.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from contour_context_tpu_torch.config import (
    ContourManagerConfig,
    GMMOptConfig,
    PipelineConfig,
)
from contour_context_tpu_torch.db import (
    hint_cap,
    keys_to_q_layout,
    query_from_hits,
    replay_window,
    search,
    search_batch,
    within_bound,
)
from contour_context_tpu_torch.ops.candidate import stable_argsort
from contour_context_tpu_torch.ops.descriptor import build_descriptors
from contour_context_tpu_torch.types import ScanDesc, device_const

# the store leaves the query tail reads at a hint's or a candidate's row:
# check 1 (tab12), the cascade (tab12, nei_*), the GMM gather (gmm_pack,
# auto_corr); db.check1, db.gather_and_cascade, db.gather_gmm
TAIL_LEAVES = ("tab12", "nei_valid", "nei_level", "nei_seq", "nei_bit",
               "nei_theta", "gmm_pack", "auto_corr")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of its process group (JAX: a 1-D device mesh over
    the "data" axis)."""
    group: Optional[dist.ProcessGroup]   # None: the default group
    rank: int
    world: int
    device: torch.device
    backend: str


def make_mesh(group=None, device=None) -> Mesh:
    """This rank's Mesh of an initialised process group. `device` defaults
    to the card of the local rank (`cuda:<LOCAL_RANK>`, else
    `cuda:<rank>`); a CUDA device without CUDA raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised")
    rank = dist.get_rank(group)
    if device is None:
        device = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", rank)))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh(device={device}): CUDA is not "
                               "available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return Mesh(group, rank, dist.get_world_size(group), device,
                str(dist.get_backend(group)))


def pad_rows_to_mesh(x, mesh: Mesh):
    """Zero-pad dim 0 to a multiple of the world size (zero rows are the
    store's invalid sentinel: zero keys never pass the search's masks)."""
    pad = (-x.shape[0]) % mesh.world
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


class ShardedStore(NamedTuple):
    """One rank's rows of a row-sharded store."""
    store: ScanDesc       # rows [base, base + N_loc) of the padded store
    keys_q: torch.Tensor  # (L, D, N_loc*A) f32 search layout of its keys
    base: int             # global id of its first row
    rows: int             # the store's row count before padding


def shard_store(store: ScanDesc, mesh: Mesh) -> ShardedStore:
    """Rank r's contiguous block of N_loc = ceil(N / world) rows of `store`
    (N rows on any device, the same on every rank), zero-padded past N,
    copied to the rank's device, with the f32 search-layout copy of its
    keys."""
    rows = store.keys.shape[0]
    n_loc = -(-rows // mesh.world)
    base = mesh.rank * n_loc
    m = max(0, min(n_loc, rows - base))

    def part(x):
        out = torch.zeros((n_loc,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=mesh.device)
        out[:m] = x[base:base + m]
        return out

    local = ScanDesc(*[part(x) for x in store])
    return ShardedStore(local, keys_to_q_layout(local.keys).contiguous(),
                        base, rows)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _all_gather(x, mesh: Mesh):
    """(world, *x.shape): every rank's x, in rank order."""
    if mesh.backend == "gloo" and x.is_cuda:
        return _gloo_all_gather_via_host(x, mesh)
    out = x.new_empty((mesh.world,) + tuple(x.shape))
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=mesh.group)
    return out


def _gloo_all_gather_via_host(x, mesh: Mesh):
    """`_all_gather` of a CUDA tensor over a gloo group: a copy to the host,
    the collective there, and one copy back."""
    host = x.cpu()
    out = host.new_empty((mesh.world,) + tuple(host.shape))
    dist.all_gather(list(out.unbind(0)), host, group=mesh.group)
    return out.to(x.device)


def _pack(leaves):
    """Leaves with a common leading axis R -> one (R, bytes) uint8 tensor,
    each row the bytes of every leaf's row in turn."""
    R = leaves[0].shape[0]
    return torch.cat([x.reshape(R, -1).contiguous().view(torch.uint8)
                      for x in leaves], dim=1)


def _unpack(buf, like):
    """`_pack` undone: (R, bytes) -> leaves shaped like `like`'s rows."""
    R, out, at = buf.shape[0], [], 0
    for x in like:
        row = tuple(x.shape[1:])
        nb = x[:1].numel() * x.element_size()
        out.append(buf[:, at:at + nb].contiguous().view(x.dtype)
                   .reshape((R,) + row))
        at += nb
    return out


def all_gather_desc(desc: ScanDesc, mesh: Mesh) -> ScanDesc:
    """Every rank's b-stacked ScanDesc -> the (world*b)-stacked ScanDesc in
    rank order, on every rank (one collective)."""
    pool = _all_gather(_pack(list(desc)), mesh)
    return ScanDesc(*_unpack(pool.reshape((-1,) + tuple(pool.shape[2:])),
                             list(desc)))


# ---------------------------------------------------------------------------
# the row-sharded search
# ---------------------------------------------------------------------------

def _sharded_hits(keys_local, q_keys_b, searchable_b, q_levels, k: int,
                  mesh: Mesh, single: bool):
    """The global top k hits of B queries over the row-sharded store:
    q_keys_b (B, L, A, D), searchable_b (B,) int32 global limits on the
    rank's device -> (gidx, seq_src, dist, valid), each (B, Q, A, k), the
    same on every rank. `single` runs the single-query kernel (B = 1)."""
    A = q_keys_b.shape[2]
    n_loc = keys_local.shape[2] // A
    base = mesh.rank * n_loc
    # rows [base, base + n_loc) below the global limit, in local ids
    lim = torch.clamp(searchable_b - base, 0, n_loc).to(torch.int32)
    if single:
        state = torch.stack([torch.full_like(lim[0], n_loc), lim[0]])
        hits = [h[None] for h in search(keys_local, q_keys_b[0], state,
                                        q_levels, k)]
    else:
        hits = search_batch(keys_local, q_keys_b, lim, q_levels, k)
    gidx, seq, dist, _ = hits
    # pool every rank's ascending (distance, column) list, rank-major, and
    # sort it stably: ties go to the lower rank, then the lower column
    mine = torch.stack([dist.view(torch.int32), gidx + base, seq])
    pool = _all_gather(mine, mesh).movedim(0, -2)       # (3, B, Q, A, W, k)
    pool = pool.reshape(pool.shape[:-2] + (-1,))
    d_all = pool[0].view(torch.float32)
    order = stable_argsort(d_all)[..., :k]
    dist = d_all.gather(-1, order)
    lv = device_const(tuple(q_levels), torch.long, keys_local.device)
    valid = within_bound(q_keys_b[:, lv].to(torch.float32), dist)
    return pool[1].gather(-1, order), pool[2].gather(-1, order), dist, valid


def sharded_search(keys_local, q_keys, searchable_n, q_levels, nnk: int,
                   mesh: Mesh):
    """Row-sharded key search of one query (JAX's `sharded_search`):
    keys_local (L, D, N_loc*A) f32 search layout of this rank's rows
    (`ShardedStore.keys_q`), q_keys (L, A, D), searchable_n the global
    limit (an int or a 0-d tensor) -> (gidx, seq_src, dist, valid), each
    (Q, A, k) with k = min(nnk, N_loc*A), the same on every rank: the
    single-device `db.search` result wherever k is the same."""
    sb = torch.as_tensor(searchable_n, dtype=torch.int32,
                         device=keys_local.device)
    hits = _sharded_hits(keys_local, q_keys[None], sb.reshape(1), q_levels,
                         min(nnk, keys_local.shape[2]), mesh, single=True)
    return tuple(h[0] for h in hits)


def sharded_search_batch(keys_local, q_keys_b, searchable_b, q_levels,
                         nnk: int, mesh: Mesh):
    """`sharded_search` of B queries in one batched tile-min launch a rank:
    q_keys_b (B, L, A, D), searchable_b (B,) int32 on the rank's device ->
    each (B, Q, A, k)."""
    return _sharded_hits(keys_local, q_keys_b, searchable_b, q_levels,
                         min(nnk, keys_local.shape[2]), mesh, single=False)


# ---------------------------------------------------------------------------
# the sharded query
# ---------------------------------------------------------------------------

def _candidate_store(shard: ShardedStore, hits, cfg: PipelineConfig,
                     mesh: Mesh):
    """The rows the query tail reads, gathered to every rank: the hint
    cap's valid rows of the B queries and row 0 (a masked hint reads row
    0), sorted and deduplicated into U = min(B*HC + 1, rows) slots (the
    last slots repeat the largest row). Returns (the compact ScanDesc, its
    TAIL_LEAVES filled and every other leaf an empty (U, 0) placeholder;
    the hits with row ids remapped into it; the (U,) int32 global row of
    each slot, ascending)."""
    gidx, seq, dist, valid = hits
    B = gidx.shape[0]
    perm, hv, _, _ = hint_cap(dist, valid, cfg)
    rows_sel = torch.where(hv, gidx.reshape(B, -1).gather(1, perm), 0)
    s = torch.sort(torch.cat([rows_sel.new_zeros(1),
                              rows_sel.reshape(-1)])).values
    U = min(s.numel(), shard.rows)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    slot = torch.cumsum(first, 0) - 1
    uniq = s[-1:].expand(U).clone().scatter_(0, slot, s)
    # a hit outside the set is never read (not kept, or masked to row 0)
    g_c = torch.searchsorted(uniq, gidx.reshape(-1).contiguous()) \
        .clamp_(max=U - 1).to(torch.int32).reshape(gidx.shape)

    n_loc = shard.store.keys.shape[0]
    owner = torch.div(uniq, n_loc, rounding_mode="floor").long()
    local = torch.where(owner == mesh.rank, uniq - shard.base, 0).long()
    leaves = [getattr(shard.store, f)[local] for f in TAIL_LEAVES]
    pool = _all_gather(_pack(leaves), mesh)             # (W, U, bytes)
    got = pool[owner, torch.arange(U, device=owner.device)]
    filled = dict(zip(TAIL_LEAVES, _unpack(got, leaves)))
    compact = ScanDesc(*[
        filled[f] if f in filled else x.new_empty((U, 0))
        for f, x in zip(ScanDesc._fields, shard.store)])
    return compact, (g_c, seq, dist, valid), uniq


def _query(shard: ShardedStore, descs: ScanDesc, searchable_b,
           cfg: PipelineConfig, mesh: Mesh, single: bool):
    A = descs.keys.shape[2]
    k = min(cfg.db.nnk, shard.rows * A)    # the single-device store's k
    hits = _sharded_hits(shard.keys_q, descs.keys, searchable_b,
                         tuple(cfg.db.q_levels), k, mesh, single)
    compact, hits_c, uniq = _candidate_store(shard, hits, cfg, mesh)
    recs = query_from_hits(compact, descs, hits_c, cfg)
    g = recs[:, 1]
    recs[:, 1] = torch.where(
        g >= 0, uniq[g.clamp(min=0).long()].to(recs.dtype), g)
    return recs


def sharded_query_step(shard: ShardedStore, query: ScanDesc, state,
                       cfg: PipelineConfig, mesh: Mesh):
    """The query step over a row-sharded store (JAX's `sharded_query_step`):
    `query` one ScanDesc and `state` the (2,) int32 window state, both
    replicated on the rank's device -> the (18,) f32 record, the same on
    every rank and equal to `db.query_step` over the unsharded store with
    f32 keys_q. The single-query tile-min runs on each rank's shard."""
    descs = ScanDesc(*[x[None] for x in query])
    return _query(shard, descs, state[1:2], cfg, mesh, single=True)[0]


def sharded_query_step_batch(shard: ShardedStore, descs: ScanDesc,
                             searchable_b, cfg: PipelineConfig, mesh: Mesh):
    """B queries (a B-stacked ScanDesc) over a row-sharded store, query b
    against the rows below searchable_b[b] ((B,) int32 on the rank's
    device) -> (B, 18) records, the same on every rank and equal to
    `db.query_step_batch` over the unsharded store with f32 keys_q. One
    batched tile-min launch a rank."""
    return _query(shard, descs, searchable_b, cfg, mesh, single=False)


# ---------------------------------------------------------------------------
# the data-parallel build, serving, the block step
# ---------------------------------------------------------------------------

def dp_build_descriptors(points_batch, cm: ContourManagerConfig,
                         gmm: GMMOptConfig, mesh: Mesh) -> ScanDesc:
    """Rank r's share of a data-parallel descriptor build: clouds
    [r*b, (r+1)*b) of `points_batch` ((B, max_points, 4), the same on
    every rank; b = B / world) built on the rank's device by
    `build_descriptors`. A B that the world size does not divide raises.
    `all_gather_desc` assembles the whole batch."""
    B = points_batch.shape[0]
    if B % mesh.world:
        raise ValueError(f"dp_build_descriptors: a batch of {B} over "
                         f"{mesh.world} ranks")
    b = B // mesh.world
    mine = torch.as_tensor(points_batch[mesh.rank * b:(mesh.rank + 1) * b])
    return build_descriptors(mine.to(mesh.device), cm, gmm)


def sharded_localize_block(shard: ShardedStore, state, points_b,
                           cfg: PipelineConfig, mesh: Mesh):
    """Map serving on a row-sharded store (db._localize_block): B clouds
    (the same on every rank) -> (B, 18) records at the map's searchable
    prefix state[1], nothing appended. The build is data-parallel, the
    descriptors are gathered, then `sharded_query_step_batch`."""
    descs = all_gather_desc(dp_build_descriptors(points_b, cfg.cm, cfg.gmm,
                                                 mesh), mesh)
    B = descs.keys.shape[0]
    return sharded_query_step_batch(shard, descs,
                                    state[1].expand(B).contiguous(), cfg,
                                    mesh)


def sharded_process_block(shard: ShardedStore, ts_store, state, recs_store,
                          descs: ScanDesc, ts_b, n: int, cfg: PipelineConfig,
                          mesh: Mesh):
    """The block step on a row-sharded store (db._process_block, as
    `ContourDB.process_block_async` runs it): append the B-stacked `descs`
    at rows n.. (`n` the host mirror of state[0]; each rank writes the rows
    it owns into its shard and its f32 keys_q), write the timestamps `ts_b`
    ((B,) f32) into the replicated `ts_store`, replay each query's
    searchable prefix from the window pushes, answer the B queries with
    `sharded_query_step_batch`, and write the records into the replicated
    `recs_store` at rows n... Updates every tensor in place; returns the
    (B, 18) records."""
    B = ts_b.shape[0]
    if n + B > shard.rows:
        raise ValueError(f"sharded_process_block: rows {n}..{n + B} past "
                         f"the store's {shard.rows}")
    n_loc = shard.store.keys.shape[0]
    lo, hi = max(n, shard.base), min(n + B, shard.base + n_loc)
    if lo < hi:
        for buf, x in zip(shard.store, descs):
            buf[lo - shard.base:hi - shard.base] = x[lo - n:hi - n]
        A = descs.keys.shape[2]
        shard.keys_q[:, :, (lo - shard.base) * A:(hi - shard.base) * A] = \
            keys_to_q_layout(descs.keys[lo - n:hi - n])
    ts_store[n:n + B] = ts_b
    state[0] += B
    tb = cfg.db.tb
    searchable_b = replay_window(state, ts_store, ts_b, tb.min_elapse,
                                 tb.max_elapse)
    recs = sharded_query_step_batch(shard, descs, searchable_b, cfg, mesh)
    recs_store[n:n + B] = recs
    return recs


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn, world: int, backend: str, init_file: str,
               device, out_dir: str, args) -> None:
    dist.init_process_group(backend, init_method="file://" + init_file,
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(device=device)
        result = fn(mesh, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn, world: int, args=(), *, backend: str = "nccl",
                device=None) -> list:
    """Run `fn(mesh, *args)` on `world` spawned ranks of a new process group
    (a file store in a fresh temporary directory) and return each rank's
    result, in rank order. `fn` is a module-level function and its result
    picklable (tensors on the CPU); `device` is each rank's (default
    `make_mesh`'s). A rank's exception fails the call."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank_main, args=(fn, world, backend,
                                   os.path.join(d, "init"), device, d, args),
                 nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
