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

The collectives gather into one preallocated tensor
(`dist.all_gather_into_tensor`) on an NCCL group; a gloo group moves a
CUDA tensor through the host (`_gloo_all_gather_via_host`), so several
ranks can share one card.

On an NCCL mesh (a CUDA device) every entry point is one CUDA graph replay
a call, the counterpart of JAX's jitted sharded programs: search, query,
serving (the data-parallel build, the descriptor all-gather and the
query) and the block step, each captured with its collectives at its first
call on every rank in the same order (`Mesh.graphs`, a `graphs.GraphSet`
as a DB has; a graph lives as long as the shard keys it reads, and its
graphs share the device's one pool with every DB of the process). Host
data goes up through pinned memory, and the block step writes at rows read
from state[0] on the device, so no call syncs the host. A gloo mesh stays
eager: its collectives run on the host and cannot be captured, which
`Mesh.graph_stats()` reports.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass, field
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
    upload,
    within_bound,
)
from contour_context_tpu_torch.graphs import GraphSet, tensor_tag
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
    the "data" axis), and the graphs of its sharded entry points (graphed
    on an NCCL group on a card; `graphs.reason` is "gloo" or the device
    type where not). Each graph lives as long as the shard keys it reads."""
    group: Optional[dist.ProcessGroup]   # None: the default group
    rank: int
    world: int
    device: torch.device
    backend: str
    graphs: GraphSet = field(compare=False, repr=False)

    @property
    def graphed(self) -> bool:
        """Whether the entry points run as CUDA graph replays: on an NCCL
        group, outside `eager()`."""
        return self.graphs.enabled

    def eager(self):
        """A block in which the entry points run their eager bodies."""
        return self.graphs.eager()

    def graph_stats(self) -> dict:
        """`GraphSet.stats` of the mesh's live graphs, each under its entry
        point's name."""
        return self.graphs.stats(name=lambda k: k[0][0])

    def drop_graphs(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)     # no replay in flight
        self.graphs.drop()


def _tree(f, x, key):
    """f(key + path, leaf) over x, a tensor or a tuple of them (a ScanDesc
    keeps its type)."""
    if isinstance(x, torch.Tensor):
        return f(key, x)
    items = [_tree(f, v, key + (i,)) for i, v in enumerate(x)]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def _run(mesh: Mesh, key, fn, inputs: tuple, owner, tag) -> tuple:
    """fn(*inputs), a tuple of tensors; each input a tensor or a ScanDesc.
    Graphed: one replay of the graph under `key` and the inputs' shapes
    and dtypes, captured at its first call and again when `tag` (the
    `tensor_tag` of every tensor it reads or writes in place, and the
    numbers its capture bakes in) changed, and dropped when `owner` (the
    shard's keys, which it reads) is freed. Its inputs are copied into
    static tensors and its outputs cloned from static ones (no host sync:
    inputs on the device). A capture that fails raises."""
    g = mesh.graphs
    if not g.enabled:
        return fn(*inputs)
    key = (key,) + tuple(_tree(lambda k, x: (tuple(x.shape), x.dtype), x,
                               ()) for x in inputs)
    ins = [_tree(lambda k, x: g.static(k, x.shape, x.dtype).copy_(x), x,
                 (key, "in", i)) for i, x in enumerate(inputs)]

    def body():
        for j, r in enumerate(fn(*ins)):
            g.static((key, "out", j), r.shape, r.dtype).copy_(r)

    g.run(key, body, tag, owner)
    outs, j = [], 0
    while (key, "out", j) in g.bufs:
        outs.append(g.bufs[(key, "out", j)].clone())
        j += 1
    return tuple(outs)


def _shard_tag(shard: "ShardedStore") -> tuple:
    return tensor_tag(*shard.store, shard.keys_q) + (shard.base, shard.rows)


def _limits(x, device: torch.device):
    """Searchable limits, an int, a sequence or a tensor, as an int32
    tensor of at least one dimension on `device` (a host int is filled in
    on the device, with no copy)."""
    if isinstance(x, int):
        return torch.full((1,), x, dtype=torch.int32, device=device)
    t = upload(torch.as_tensor(x), device).to(torch.int32)
    return t.reshape(-1) if t.dim() == 0 else t


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
    world, backend = dist.get_world_size(group), str(dist.get_backend(group))
    graphs = GraphSet(device, "gloo" if backend == "gloo" else None)
    if graphs.enabled:
        # the group's communicator is made at its first collective, which
        # no capture may hold
        dist.all_gather_into_tensor(torch.empty((world,), device=device),
                                    torch.zeros((1,), device=device),
                                    group=group)
        torch.cuda.synchronize(device)
    return Mesh(group, rank, world, device, backend, graphs)


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
    """(world, *x.shape): every rank's x, in rank order. On NCCL one
    collective into one tensor (capturable in a CUDA graph)."""
    if mesh.backend == "gloo" and x.is_cuda:
        return _gloo_all_gather_via_host(x, mesh)
    out = x.new_empty((mesh.world,) + tuple(x.shape))
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    else:
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
    single-device `db.search` result wherever k is the same. On an NCCL
    mesh one replay."""
    q_levels, k = tuple(q_levels), min(nnk, keys_local.shape[2])
    hits = _run(mesh, ("search", q_levels, k), lambda q, sb: _sharded_hits(
        keys_local, q[None], sb, q_levels, k, mesh, single=True),
        (q_keys, _limits(searchable_n, mesh.device)), keys_local,
        tensor_tag(keys_local))
    return tuple(h[0] for h in hits)


def sharded_search_batch(keys_local, q_keys_b, searchable_b, q_levels,
                         nnk: int, mesh: Mesh):
    """`sharded_search` of B queries in one batched tile-min launch a rank:
    q_keys_b (B, L, A, D), searchable_b (B,) int32 on the rank's device ->
    each (B, Q, A, k). On an NCCL mesh one replay."""
    q_levels, k = tuple(q_levels), min(nnk, keys_local.shape[2])
    return _run(mesh, ("search_batch", q_levels, k), lambda q, sb:
                _sharded_hits(keys_local, q, sb, q_levels, k, mesh,
                              single=False),
                (q_keys_b, _limits(searchable_b, mesh.device)), keys_local,
                tensor_tag(keys_local))


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
    f32 keys_q. The single-query tile-min runs on each rank's shard. On an
    NCCL mesh one replay."""
    return _run(mesh, ("query_step", cfg), lambda d, st: (_query(
        shard, d, st[1:2], cfg, mesh, single=True)[0],),
        (ScanDesc(*[x[None] for x in query]), state), shard.keys_q,
        _shard_tag(shard))[0]


def sharded_query_step_batch(shard: ShardedStore, descs: ScanDesc,
                             searchable_b, cfg: PipelineConfig, mesh: Mesh):
    """B queries (a B-stacked ScanDesc) over a row-sharded store, query b
    against the rows below searchable_b[b] ((B,) int32 on the rank's
    device) -> (B, 18) records, the same on every rank and equal to
    `db.query_step_batch` over the unsharded store with f32 keys_q. One
    batched tile-min launch a rank; on an NCCL mesh one replay."""
    return _run(mesh, ("query_batch", cfg), lambda d, sb: (_query(
        shard, d, sb, cfg, mesh, single=False),),
        (descs, _limits(searchable_b, mesh.device)), shard.keys_q,
        _shard_tag(shard))[0]


# ---------------------------------------------------------------------------
# the data-parallel build, serving, the block step
# ---------------------------------------------------------------------------

def _my_clouds(points_batch, mesh: Mesh):
    """Rank r's contiguous B/world clouds of `points_batch`, on its device
    (host data through pinned memory). A B that the world size does not
    divide raises."""
    B = points_batch.shape[0]
    if B % mesh.world:
        raise ValueError(f"dp_build_descriptors: a batch of {B} over "
                         f"{mesh.world} ranks")
    b = B // mesh.world
    return upload(points_batch[mesh.rank * b:(mesh.rank + 1) * b],
                   mesh.device)


def dp_build_descriptors(points_batch, cm: ContourManagerConfig,
                         gmm: GMMOptConfig, mesh: Mesh) -> ScanDesc:
    """Rank r's share of a data-parallel descriptor build: clouds
    [r*b, (r+1)*b) of `points_batch` ((B, max_points, 4), the same on
    every rank; b = B / world) built on the rank's device by
    `build_descriptors`. A B that the world size does not divide raises.
    `all_gather_desc` assembles the whole batch."""
    return build_descriptors(_my_clouds(points_batch, mesh), cm, gmm)


def _localize(shard: ShardedStore, state, pts, cfg: PipelineConfig,
              mesh: Mesh):
    descs = all_gather_desc(build_descriptors(pts, cfg.cm, cfg.gmm), mesh)
    B = descs.keys.shape[0]
    return _query(shard, descs, state[1].expand(B).contiguous(), cfg, mesh,
                  single=False)


def sharded_localize_block(shard: ShardedStore, state, points_b,
                           cfg: PipelineConfig, mesh: Mesh):
    """Map serving on a row-sharded store (db._localize_block): B clouds
    (the same on every rank) -> (B, 18) records at the map's searchable
    prefix state[1], nothing appended. The build is data-parallel, the
    descriptors are gathered, then the batched sharded query. On an NCCL
    mesh the three are one replay, the rank's clouds uploaded through
    pinned memory: no host sync."""
    return _run(mesh, ("localize", cfg), lambda p, st: (_localize(
        shard, st, p, cfg, mesh),), (_my_clouds(points_b, mesh), state),
        shard.keys_q, _shard_tag(shard))[0]


def _block_rows(state, base: int, n_loc: int, B: int):
    """Where a block of B rows appended at state[0] lands, read on the
    device: the (B,) global rows, and for this rank's shard of n_loc rows
    from `base` the (B,) local rows `dst` (clamped into the shard), the
    block row `src` that lands at each and whether one does (`has`). A
    block row the rank does not own is written to a clamped row with that
    row's own content (the block row landing there, else its old value),
    so the rank changes only the rows it owns and every write to one row
    writes the same bytes."""
    rows = state[:1].long() + torch.arange(B, device=state.device)
    local = rows - base
    dst = local.clamp(0, n_loc - 1)
    src = dst - local[:1]
    has = (src >= 0) & (src < B)
    return rows, dst, src.clamp(0, B - 1), has


def _owned_write(buf, dim: int, dst, new, has):
    """buf's slices `dst` along `dim` set to `new` where `has`, to their
    own content elsewhere."""
    shape = [1] * buf.dim()
    shape[dim] = -1
    keep = buf.index_select(dim, dst)
    buf.index_copy_(dim, dst, torch.where(has.reshape(shape), new, keep))


def _process_block(shard: ShardedStore, ts_store, state, recs_store,
                   descs: ScanDesc, ts_b, cfg: PipelineConfig, mesh: Mesh):
    B = ts_b.shape[0]
    n_loc = shard.store.keys.shape[0]
    rows, dst, src, has = _block_rows(state, shard.base, n_loc, B)
    for buf, x in zip(shard.store, descs):
        _owned_write(buf, 0, dst, x.index_select(0, src).to(buf.dtype), has)
    A = descs.keys.shape[2]
    cols = (dst[:, None] * A + torch.arange(A, device=dst.device)).reshape(-1)
    _owned_write(shard.keys_q, 2, cols, keys_to_q_layout(
        descs.keys.index_select(0, src)).to(shard.keys_q.dtype),
        has.repeat_interleave(A))
    ts_store.index_copy_(0, rows, ts_b)
    state[0] += B
    tb = cfg.db.tb
    searchable_b = replay_window(state, ts_store, ts_b, tb.min_elapse,
                                 tb.max_elapse)
    recs = _query(shard, descs, searchable_b, cfg, mesh, single=False)
    recs_store.index_copy_(0, rows, recs)
    return recs


def sharded_process_block(shard: ShardedStore, ts_store, state, recs_store,
                          descs: ScanDesc, ts_b, n: int, cfg: PipelineConfig,
                          mesh: Mesh):
    """The block step on a row-sharded store (db._process_block, as
    `ContourDB.process_block_async` runs it): append the B-stacked `descs`
    at rows state[0].. (each rank writes the rows it owns into its shard
    and its f32 keys_q, at rows read on the device), write the timestamps
    `ts_b` ((B,) f32) into the replicated `ts_store`, replay each query's
    searchable prefix from the window pushes, answer the B queries with
    the batched sharded query, and write the records into the replicated
    `recs_store` at the same rows. `n` is the host's mirror of state[0],
    which only bounds the block. Updates every tensor in place; returns
    the (B, 18) records. On an NCCL mesh one replay: one graph serves
    every n."""
    B = ts_b.shape[0]
    if n + B > shard.rows:
        raise ValueError(f"sharded_process_block: rows {n}..{n + B} past "
                         f"the store's {shard.rows}")
    return _run(mesh, ("block", cfg), lambda d, t: (_process_block(
        shard, ts_store, state, recs_store, d, t, cfg, mesh),),
        (descs, upload(ts_b, mesh.device)), shard.keys_q,
        _shard_tag(shard) + tensor_tag(ts_store, state, recs_store))[0]


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
