"""ContourDB in torch: device-resident descriptor store + the fused scan step.

Port of the main path of `contour_context_tpu/db.py`. Per scan:
descriptor build -> query against the window state before this scan (key
search -> hint cap -> check-1 prefilter -> chunked check cascade -> proposal
merge -> tidy screens -> GMM init + LM refinement -> packed 18-float record)
-> record-ring write -> append -> temporal-window update (the reference's
query -> addScan -> pushAndBalance order, batch_bin_test.cpp:105-238).

The store, its (L, D, capacity*A) bf16 search-layout key copy `keys_q`, the
timestamps, the window state [n, searchable_n] and the record ring all live
on the DB's device, written at rows read from state[0] on the device; the
host keeps a mirror of n for its handles. Nothing in a step syncs the host:
the CC labels and the proposal merge are one kernel launch each, the
cascade runs every chunk, and a host payload goes up through pinned memory.
On a CUDA device the step, a block step's build, append and window pushes
and queries, a serving chunk, each stage of the unfused API (the
per-scan build, `query_async`, `add_scan`, `push_and_balance`) and
`range_search` run as one
CUDA graph replay each (`graphs.GraphSet`), the port's counterpart of the
JAX package's one jitted dispatch, with `dynamic_thres` as well. One
switch, `graphed`, chooses: the CPU runs every body eagerly, and so does
the card inside `eager()` (the comparisons of a replay with the body it
captured).

The query behind its search carries a leading B axis (`stages_from_hits` ->
`refine_from_hits` -> `query_from_hits`), the counterpart of the JAX
package's jax.vmap(_query_step_impl): B queries are one batched program,
and the stream's query is its B = 1 case. A
`depth` (one of DEPTHS) stops it at one of _query_step_impl's stage gates
and returns that gate's probe, so a split times the production prefixes.

Beside the stream: chains of steps (`step_chain_async`,
`step_chain_dyn_async`: one BlockHandle over K record-ring rows), the
unfused API (`query_async` / `add_scan` / `push_and_balance`), the host
spec query (`query_ranged_knn_host` on `HostCandidateManager`), block mode
(`process_block_async`: B scans appended,
their B queries answered as one batch), map serving
(`localize_block_async`: B clouds against the frozen map), `range_search`,
and checkpoints (`save` / `load` / `load_chain` / `merge`) in the npz format
of `contour_context_tpu.db`, member for member.
"""

from __future__ import annotations

import io
import math
import zipfile
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from contour_context_tpu_torch.config import (
    DIST_BIN_LAYERS,
    LAYER_AREA_WEIGHTS,
    PipelineConfig,
)
from contour_context_tpu_torch.ops.candidate import (
    CandidateState,
    dynamic_pass_scan,
    dynamic_post_scan,
    merge_proposals,
    select_topk_stable,
    stable_argsort,
    take_rows,
    tidy_candidates,
)
from contour_context_tpu_torch.ops.cascade import (
    CascadeResult,
    check_sim_batched,
    empty_result,
    run_cascade,
)
from contour_context_tpu_torch.graphs import GraphSet, tensor_tag
from contour_context_tpu_torch.tracing import mark, span
from contour_context_tpu_torch.ops.descriptor import (
    build_descriptor,
    build_descriptors,
    gmm_pack_of,
    tab12_of,
)
from contour_context_tpu_torch.ops.gmm import (
    GmmScan,
    gmm_from_desc,
    init_correlation,
    optimize_correlation,
)
from contour_context_tpu_torch.ops.kernels import (
    MAX_DIST_SQ,
    TILE,
    cascade as cascade_kernel,
    masked_key_distances,
    search_tilemin,
    search_tilemin_batch,
)
from contour_context_tpu_torch.types import (
    ScanDesc,
    device_const,
    scan_desc_from_numpy,
    scan_desc_spec,
)

RECORD_WIDTH = 18
# the largest chunk a graphed localize_block_async serves in when given none
SERVE_CHUNK = 16


def serve_chunks(B: int, chunk: Optional[int] = None,
                 graphed: bool = True) -> List[int]:
    """The chunk sizes, in order, that `localize_block_async` serves a
    request of B clouds in; a sum above B is the zero clouds it pads with.

    Graphed and with no `chunk`: B // SERVE_CHUNK chunks of SERVE_CHUNK,
    then one chunk for each set bit of B % SERVE_CHUNK, largest first
    (a request of 21 is 16, 4, 1), so no request pads and one pair of
    graphs a power of two serves every size. With a `chunk`: whole chunks
    of it, the tail padded (eager, a request that fits one chunk is one
    chunk of B). Eager with no `chunk`: one chunk of B."""
    if B <= 0:
        return []
    if chunk is None:
        if not graphed:
            return [B]
        tail = B % SERVE_CHUNK
        return [SERVE_CHUNK] * (B // SERVE_CHUNK) + [
            1 << k for k in reversed(range(SERVE_CHUNK.bit_length()))
            if tail >> k & 1]
    if not graphed and B <= chunk:
        return [B]
    return [chunk] * -(-B // chunk)


def upload(x, device: torch.device):
    """Host data (numpy or a CPU tensor) as a tensor on `device`. To a
    CUDA device it goes through pinned memory, non_blocking: no host sync,
    and the pinned block is not reused before its copy ran. A tensor
    already on the device passes through."""
    with span("upload"):
        t = torch.as_tensor(x)
        if t.device == device:
            return t
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)


def keys_to_q_layout(keys, dtype=None):
    """(N, L, A, D) scan-major keys -> (L, D, N*A) search-layout copy."""
    N, L, A, D = keys.shape
    out = keys.permute(1, 3, 0, 2).reshape(L, D, N * A)
    return out if dtype is None else out.to(dtype)


# ---------------------------------------------------------------------------
# key search
# ---------------------------------------------------------------------------

def search(keys_q, q_keys, state, q_levels: Tuple[int, ...], nnk: int):
    """keys_q (L, D, NA) store, q_keys (L, A, D) query keys, state (2,)
    [n, searchable_n] -> (gidx, seq_src, dist, valid), each (Q, A, k) with
    k = min(nnk, NA): the k nearest searchable keys per (q_level, anchor),
    ascending (distance, column), within the adaptive distance bound
    (contour_db.h:733-749). Equal to `db._search_impl` element for element.

    Stage 1 is the `search_tilemin` kernel (the per-128-column tile minima,
    db._search_cover2); stage 2 picks the kt = min(k, ceil(NA/128)) tiles
    with the smallest (min, tile index), recomputes their columns'
    distances and sorts them by (distance, column). The cover proof
    (db.py:211-220) makes that identical to a full sort. When k exceeds the
    tile count every tile is taken, and the pad columns past NA are masked
    and numbered last, so k <= NA never picks one."""
    lv = device_const(q_levels, torch.long, keys_q.device)
    q = q_keys[lv].to(torch.float32).contiguous()          # (Q, A, D)
    tmin = search_tilemin(keys_q, q_levels, q, state)       # (Q, A, Bt)
    return _search_stage2(keys_q, lv, q, tmin, state[1], nnk)


def search_batch(keys_q, q_keys_b, searchable_b, q_levels: Tuple[int, ...],
                 nnk: int):
    """`search` for B queries: q_keys_b (B, L, A, D), searchable_b (B,)
    int32 on the device -> (gidx, seq_src, dist, valid), each (B, Q, A, k);
    row b equals `search` of q_keys_b[b] at searchable_n = searchable_b[b]
    bit for bit. Stage 1 is one `search_tilemin_batch` launch (the store is
    read once for the B queries); stage 2 runs with the B and Q axes folded
    into one, the same per-row tensor code."""
    B, _, A, D = q_keys_b.shape
    Q = len(q_levels)
    lv = device_const(q_levels, torch.long, keys_q.device)
    q = q_keys_b[:, lv].to(torch.float32).contiguous()      # (B, Q, A, D)
    tmin = search_tilemin_batch(keys_q, q_levels, q, searchable_b)
    out = _search_stage2(keys_q, lv.repeat(B), q.reshape(B * Q, A, D),
                         tmin.reshape(B * Q, A, -1),
                         searchable_b.repeat_interleave(Q)[:, None, None],
                         nnk)
    return tuple(x.reshape((B, Q) + x.shape[1:]) for x in out)


def _search_stage2(keys_q, lv, q, tmin, searchable_n, nnk: int):
    """Stage 2 of the search for R rows: lv (R,) level of each row, q
    (R, A, D), tmin (R, A, Bt), searchable_n a 0-d tensor or (R, 1, 1)."""
    L, D, NA = keys_q.shape
    R, A, _ = q.shape
    dev = keys_q.device
    k = min(nnk, NA)
    kt = min(k, -(-NA // TILE))
    tidx = stable_argsort(tmin)[..., :kt]
    cols = (tidx[..., None] * TILE
            + torch.arange(TILE, device=dev)).reshape(R, A, kt * TILE)
    kg = keys_q[lv[:, None, None, None],
                torch.arange(D, device=dev)[None, :, None, None],
                cols.clamp(max=NA - 1)[:, None]]            # (R, D, A, kT)
    vals = masked_key_distances(kg, q, searchable_n, NA, cols)
    o1 = stable_argsort(cols)
    vals, cols = vals.gather(-1, o1), cols.gather(-1, o1)
    o2 = stable_argsort(vals)[..., :k]
    dist, idx = vals.gather(-1, o2), cols.gather(-1, o2)
    idx = idx.to(torch.int32)
    return (torch.div(idx, A, rounding_mode="floor"), idx % A, dist,
            within_bound(q, dist))


def within_bound(q, dist):
    """The adaptive distance bound of the search (contour_db.h:733-749): q
    (..., A, D) f32 query keys at the searched levels, dist (..., A, k) ->
    (..., A, k) bool. A zero query anchor's distances are MAX_DIST_SQ, so
    they never pass."""
    def sq(x):
        return x * x

    k0, k1, k2 = q[..., 0], q[..., 1], q[..., 2]
    ub = (torch.maximum(sq(k0 - k0 * 0.8), sq(k0 - k0 / 0.8))
          + torch.maximum(sq(k1 - k1 * 0.8), sq(k1 - k1 / 0.8))
          + torch.maximum(sq(k2 - k2 * 0.8 * 0.75),
                          sq(k2 - k2 / (0.8 * 0.75))))
    return dist < torch.clamp(ub, max=MAX_DIST_SQ)[..., None]


# ---------------------------------------------------------------------------
# check cascade
# ---------------------------------------------------------------------------

def _anchor12(g):
    return dict(cnt=g[..., 0], eig=g[..., 1:3], h=g[..., 3], comr=g[..., 4])


def check1(store: ScanDesc, query: ScanDesc, gidx, level, seq_src, seq_tgt,
           hint_valid, cont_sim):
    """Check 1 (anchor checkSim) for every hint of B queries: the cascade's
    prefilter (db._check1_impl), read from the packed tab12 rows. `query` is
    a B-stacked ScanDesc, the hint arrays are (B, H)."""
    gi = torch.where(hint_valid, gidx, 0).long()
    li = torch.clamp(level - 1, 0, store.tab12.shape[1] - 1).long()
    js = torch.clamp(seq_src, 0, store.tab12.shape[2] - 1).long()
    jt = torch.clamp(seq_tgt, 0, query.tab12.shape[2] - 1).long()
    b = torch.arange(gidx.shape[0], device=gidx.device)[:, None]
    s = _anchor12(store.tab12[gi, li, js])
    t = _anchor12(query.tab12[b, li, jt])
    return hint_valid & check_sim_batched(
        s["cnt"], s["eig"], s["h"], s["comr"],
        t["cnt"], t["eig"], t["h"], t["comr"], cont_sim)


def gather_and_cascade(store: ScanDesc, query: ScanDesc, tgt_q, gidx, level,
                       seq_src, seq_tgt, hint_valid, thres_lb, cont_sim,
                       p_pot=None) -> CascadeResult:
    """The cascade over H flat hint rows (db._gather_and_cascade_impl):
    `query` is a B-stacked ScanDesc and tgt_q (H,) names the query of each
    row. CPU tensors take the plain twin (`gather_and_cascade_plain`), CUDA
    tensors one launch of the cascade kernel (`kernels.cascade`), which
    does the gathers itself."""
    if gidx.device.type == "cpu":
        return gather_and_cascade_plain(store, query, tgt_q, gidx, level,
                                        seq_src, seq_tgt, hint_valid,
                                        thres_lb, cont_sim, p_pot)
    return cascade_kernel(store, query, gidx, level, seq_src, seq_tgt,
                          hint_valid, thres_lb, cont_sim, p_pot, tgt_q=tgt_q)


def gather_and_cascade_plain(store: ScanDesc, query: ScanDesc, tgt_q, gidx,
                             level, seq_src, seq_tgt, hint_valid, thres_lb,
                             cont_sim, p_pot=None) -> CascadeResult:
    """Per-hint gathers of the candidate tables + run_cascade, in torch on
    any device: the cascade kernel's plain twin. Indices are clamped
    explicitly."""
    H = gidx.shape[0]
    gi = torch.where(hint_valid, gidx, 0).long()
    lvl = torch.clamp(level, 0, store.nei_valid.shape[1] - 1).long()
    ss = torch.clamp(seq_src, 0, store.nei_valid.shape[2] - 1).long()
    st = torch.clamp(seq_tgt, 0, query.nei_valid.shape[2] - 1).long()
    names = ("valid", "level", "seq", "bit", "theta")
    src_nei = {k: getattr(store, "nei_" + k)[gi, lvl, ss] for k in names}
    tgt_nei = {k: getattr(query, "nei_" + k)[tgt_q, lvl, st] for k in names}
    src_tab12 = store.tab12[gi]
    li = torch.clamp(level - 1, 0, src_tab12.shape[1] - 1).long()
    js = torch.clamp(seq_src, 0, src_tab12.shape[2] - 1).long()
    jt = torch.clamp(seq_tgt, 0, query.tab12.shape[2] - 1).long()
    src_anchor = _anchor12(src_tab12[torch.arange(H, device=gi.device), li,
                                     js])
    tgt_anchor = _anchor12(query.tab12[tgt_q, li, jt])
    return run_cascade(src_anchor, src_nei, src_tab12, tgt_anchor, tgt_nei,
                       query.tab12, tgt_q, hint_valid, level, seq_src,
                       seq_tgt, thres_lb, cont_sim, p_pot)


def cascade_chunked(store, query, gidx, level, seq_src, seq_tgt, hv, n_valid,
                    thres_lb, cont_sim, chunk: int, p_pot=None
                    ) -> CascadeResult:
    """The cascade of B queries ((B, HC) hint arrays, n_valid (B,), `query`
    B-stacked) as db._cascade_chunked leaves it: each query's columns past
    its own ceil(n_valid / W) * W (W = min(chunk, HC), or HC with no chunk)
    are zeros, what JAX's chunk loop leaves there and downstream reads as
    non-hints. CPU tensors take the plain twin (`cascade_chunked_plain`);
    CUDA tensors one launch of the cascade kernel (`kernels.cascade`) over
    the B * HC rows, which writes the idle columns' zeros without computing
    them, so the launch needs no chunk count from the host."""
    B, HC = gidx.shape
    W = min(chunk, HC) if chunk > 0 else HC
    if gidx.device.type == "cpu":
        return cascade_chunked_plain(store, query, gidx, level, seq_src,
                                     seq_tgt, hv, n_valid, thres_lb,
                                     cont_sim, chunk, p_pot)
    return cascade_kernel(store, query, gidx, level, seq_src, seq_tgt, hv,
                          thres_lb, cont_sim, p_pot,
                          n_valid=n_valid if W < HC else None, chunk=W)


def cascade_chunked_plain(store, query, gidx, level, seq_src, seq_tgt, hv,
                          n_valid, thres_lb, cont_sim, chunk: int, p_pot=None
                          ) -> CascadeResult:
    """`cascade_chunked` in torch on any device, in chunks of W hint
    columns: chunk i runs columns [s0, s0 + W) of every query at once as
    B*W flat rows (`gather_and_cascade_plain`). Every one of the ceil(HC /
    W) chunks runs, so the chunk count needs no host sync (JAX's while_loop
    stops at the busiest query's ceil(n_valid / W), a device scalar); then
    every query's columns past its own chunks are zeroed. Rows are
    independent, so neither chunking nor batching changes a result. The
    last chunk's start is clamped, so chunks may overlap and recompute rows
    identically."""
    B, HC = gidx.shape
    W = min(chunk, HC) if chunk > 0 else HC
    dev = gidx.device

    def run(s0, w):
        tgt_q = torch.arange(B, device=dev).repeat_interleave(w)
        flat = [x[:, s0:s0 + w].reshape(-1)
                for x in (gidx, level, seq_src, seq_tgt, hv)]
        r = gather_and_cascade_plain(store, query, tgt_q, *flat, thres_lb,
                                     cont_sim, p_pot)
        return CascadeResult(*[x.reshape((B, w) + x.shape[1:]) for x in r])

    if W >= HC:
        return run(0, HC)
    n_chunks = -(-HC // W)
    out = empty_result((B, HC), dev, zeros=True)
    for i in range(n_chunks):
        s0 = min(i * W, HC - W)
        for dst, src in zip(out, run(s0, W)):
            dst[:, s0:s0 + W] = src
    # a query keeps zeros past its own chunks, as JAX's loop leaves them
    own = torch.div(n_valid + (W - 1), W, rounding_mode="floor") * W
    idle = torch.arange(HC, device=dev) >= own[:, None]
    for x in out:
        x.masked_fill_(idle.reshape((B, HC) + (1,) * (x.dim() - 2)), 0)
    return out


def gather_gmm(store: ScanDesc, gidx, levels: Tuple[int, ...],
               max_k: int) -> GmmScan:
    """Candidate GmmScans for gidx of any shape (...): one row of the packed
    gmm_pack table each, (..., G, K, ·)."""
    G, K = len(levels), max_k
    if store.gmm_pack.shape[-1] != G * K * 8:
        raise ValueError("gmm_pack was built with a different GMMOptConfig")
    lead = tuple(gidx.shape)
    rows = store.gmm_pack[gidx].reshape(lead + (G, K, 8))
    return GmmScan(mus=rows[..., 0:2],
                   covs=rows[..., 2:6].reshape(lead + (G, K, 2, 2)),
                   ws=rows[..., 6], majax=rows[..., 7],
                   auto_corr=store.auto_corr[gidx])


# ---------------------------------------------------------------------------
# the query and the per-scan step
# ---------------------------------------------------------------------------

class QueryRecord(NamedTuple):
    found: bool
    gidx: int
    corr: float
    T: np.ndarray
    n_hints: int
    aft1: int
    aft2: int
    aft3: int
    n_cand: int
    overflow_hints: int
    overflow_pass: int
    overflow_cand: int
    overflow_pot: int
    overflow_win: int
    overflow_pix: int
    overflow_gmm: int


def unpack_record(v) -> QueryRecord:
    """Host view of one packed 18-float record (db._unpack_record)."""
    v = np.asarray(v)
    return QueryRecord(
        found=bool(v[0] > 0.5), gidx=int(v[1]), corr=float(v[2]),
        T=v[3:6].astype(np.float64), n_hints=int(v[6]), aft1=int(v[7]),
        aft2=int(v[8]), aft3=int(v[9]), n_cand=int(v[10]),
        overflow_hints=int(v[11]), overflow_pass=int(v[12]),
        overflow_cand=int(v[13]), overflow_pot=int(v[14]),
        overflow_win=int(v[15]), overflow_pix=int(v[16]),
        overflow_gmm=int(v[17]))


class QueryStages(NamedTuple):
    """What a query holds before the GMM stage (tests compare it). The
    shapes are one query's; the `*_from_hits` functions return B queries
    stacked, every leaf with a leading B axis."""
    n_valid: torch.Tensor         # () int32 valid key hits
    overflow_hints: torch.Tensor  # () int32
    aft1: torch.Tensor            # () int32 check-1 survivors
    gidx: torch.Tensor            # (HC,) hint rows as fed to the cascade
    res: CascadeResult
    st: CandidateState


def _search_query(keys_q, query: ScanDesc, state, cfg: PipelineConfig):
    return search(keys_q, query.keys, state, tuple(cfg.db.q_levels),
                  cfg.db.nnk)


def _as_batch(query: ScanDesc, hits):
    """One query and its search result as a batch of B = 1."""
    return (ScanDesc(*[x[None] for x in query]),
            tuple(h[None] for h in hits))


def _row0(x):
    """Row 0 of every tensor of a (nested) NamedTuple: a B = 1 batch's
    result as one query's."""
    if isinstance(x, torch.Tensor):
        return x[0]
    return type(x)(*[_row0(v) for v in x])


# the stage gates of db._query_step_impl's `depth`, in the order they cut
DEPTHS = ("search", "hints", "check1", "cascade", "merge", "init")


def _probe(*terms):
    """A depth gate's (B,) float32 probe: the sum of each term over all but
    its leading B axis, added in order (db._query_step_impl's
    `(a.sum() + b.sum() + ...).astype(float32)` under jax.vmap)."""
    out = None
    for t in terms:
        s = t.reshape(t.shape[0], -1).sum(dim=1)
        out = s if out is None else out + s
    return out.to(torch.float32)


def hint_cap(dist, valid, cfg: PipelineConfig):
    """The hint cap of B queries' hits (B, Q, A, K): the at most HC =
    min(max_check_cands, Q*A*K) nearest valid hits of each query, in hit
    order (db._select_hints) -> (perm, hint_valid, n_valid, overflow), the
    first two (B, HC)."""
    B, Q, A, K = dist.shape
    HC = min(cfg.db.max_check_cands, Q * A * K)
    return select_topk_stable(dist.reshape(B, -1), valid.reshape(B, -1), HC)


class CascadeRows(NamedTuple):
    """The cascade's input of B queries: the hint rows it checks, in the
    order it checks them (after the check-1 prefilter), and the counts the
    record keeps. Every leaf has a leading B axis."""
    gidx: torch.Tensor            # (B, HC) int32 hint rows
    level: torch.Tensor           # (B, HC) int32
    seq_src: torch.Tensor         # (B, HC) int32
    seq_tgt: torch.Tensor         # (B, HC) int32
    hv: torch.Tensor              # (B, HC) bool live hint
    n_run: torch.Tensor           # (B,) int32 live hints the cascade runs
    n_valid: torch.Tensor         # (B,) int32 valid key hits
    overflow_hints: torch.Tensor  # (B,) int32
    aft1: Optional[torch.Tensor]  # (B,) int32 check-1 survivors, or None


def cascade_rows(store: ScanDesc, descs: ScanDesc, hits, cfg: PipelineConfig,
                 depth: Optional[str] = None):
    """Hint cap -> check-1 prefilter (the part of db._query_step_impl
    between its search and its cascade) for B queries: the CascadeRows
    that `cascade_chunked` takes. With `depth` "search", "hints" or
    "check1", returns that gate's (B,) float32 probe instead."""
    gidx, seq_src, dist, valid = hits
    if depth == "search":
        return _probe(dist, gidx, valid)
    dev = gidx.device
    mark("check1", dev)
    i32, f32 = torch.int32, torch.float32
    q_levels = tuple(cfg.db.q_levels)
    B, Q, A, K = gidx.shape
    lv = device_const(q_levels, i32, dev)
    level_f = lv[:, None, None].expand(Q, A, K).reshape(-1)
    seq_tgt_f = torch.arange(A, dtype=i32, device=dev)[None, :, None] \
        .expand(Q, A, K).reshape(-1)

    perm, hv, n_valid, overflow_hints = hint_cap(dist, valid, cfg)
    HC = perm.shape[1]
    g_h = gidx.reshape(B, -1).gather(1, perm)
    ss_h = seq_src.reshape(B, -1).gather(1, perm)
    l_h, st_h = level_f[perm], seq_tgt_f[perm]
    if depth == "hints":
        return _probe(perm, g_h, n_valid)

    chunkw = cfg.db.cascade_chunk
    if cfg.db.check1_prefilter and 0 < chunkw < HC:
        pass1_all = check1(store, descs, g_h, l_h, ss_h, st_h, hv,
                           cfg.db.cont_sim)
        aft1 = pass1_all.sum(dim=1).to(i32)
        pos = torch.arange(HC, dtype=f32, device=dev)
        perm2, hv_run, n_run, _ = select_topk_stable(pos, pass1_all, HC)
        g_h, l_h = g_h.gather(1, perm2), l_h.gather(1, perm2)
        ss_h, st_h = ss_h.gather(1, perm2), st_h.gather(1, perm2)
    else:
        aft1 = None
        hv_run, n_run = hv, n_valid
    if depth == "check1":
        return _probe(n_run, hv_run, g_h)
    return CascadeRows(g_h, l_h, ss_h, st_h, hv_run, n_run, n_valid,
                       overflow_hints, aft1)


def stages_from_hits(store: ScanDesc, descs: ScanDesc, hits,
                     cfg: PipelineConfig, depth: Optional[str] = None):
    """Hint cap -> check-1 prefilter -> chunked cascade -> merge (the first
    half of db._query_step_impl behind its search) for B queries at once:
    `descs` is a B-stacked ScanDesc, `hits` their search results (B, Q, A,
    K) (`search_batch`'s output). No host sync whatever B (the cascade runs
    every chunk, the merge is one kernel launch). With `depth` one of
    DEPTHS but "init", returns that gate's (B,) float32 probe instead
    (db._query_step_impl's, of the same tensors)."""
    rows = cascade_rows(store, descs, hits, cfg, depth)
    if depth in ("search", "hints", "check1"):
        return rows
    mark("cascade", rows.gidx.device)
    res = cascade_chunked(store, descs, *rows[:6], cfg.thres_lb,
                          cfg.db.cont_sim, cfg.db.cascade_chunk, cfg.db.p_pot)
    if depth == "cascade":
        # the cascade's own pass3, before the dynamic re-gating
        return _probe(res.T_delta, res.pass3, res.pair_area_perc)
    aft1 = rows.aft1
    if aft1 is None:
        aft1 = res.pass1.sum(dim=1).to(torch.int32)
    if cfg.db.dynamic_thres:
        # DYNAMIC_THRES=1: sequential re-gating with rising bars
        pass2_d, pass3_d = dynamic_pass_scan(
            res.pass1, res.ovlp_sum, res.ovlp_max_one, res.in_ang_rng,
            res.i_indiv_sim, res.i_orie_sim, cfg.thres_lb, cfg.thres_ub)
        res = res._replace(pass2=pass2_d, pass3=pass3_d)

    mark("merge", rows.gidx.device)
    st = merge_proposals(
        res.pass3, rows.gidx, res.T_delta, res.pair_valid, res.pair_level,
        res.pair_seq_src, res.pair_seq_tgt, res.pair_area_perc,
        n_cand_max=cfg.db.max_cand_poses, n_pass_max=cfg.db.max_pass_hints)
    if depth == "merge":
        return _probe(st.prop_T, st.n_cand)
    return QueryStages(n_valid=rows.n_valid,
                       overflow_hints=rows.overflow_hints, aft1=aft1,
                       gidx=rows.gidx, res=res, st=st)


def query_stages(store: ScanDesc, keys_q, query: ScanDesc, state,
                 cfg: PipelineConfig) -> QueryStages:
    """One query: search at the window `state`, then `stages_from_hits` at
    B = 1."""
    return _row0(stages_from_hits(store, *_as_batch(
        query, _search_query(keys_q, query, state, cfg)), cfg))


class RefineInputs(NamedTuple):
    """A query just before the LM refinement (tests and the smoke replay the
    refinement from it). The shapes are one query's; `refine_from_hits`
    returns B queries stacked, every leaf with a leading B axis."""
    qs: QueryStages
    cand_gidx: torch.Tensor   # (C,) int32 candidate scans
    src: GmmScan              # the F best candidates' GMMs, (F, G, K, ...)
    tgt: GmmScan              # the query's GMM
    T0: torch.Tensor          # (F, 3) f32 starting poses
    sel: torch.Tensor         # (F, G, K, K) bool close pairs at T0
    topi: torch.Tensor        # (F,) rows of the candidate table
    valid: torch.Tensor       # (F,) bool: a live candidate above the gate


def per_query(tgt: GmmScan) -> GmmScan:
    """(B, ...) query GMMs, to broadcast against (B, C, ...) candidates."""
    return GmmScan(*[x[:, None] for x in tgt])


def refine_from_hits(store: ScanDesc, descs: ScanDesc, hits,
                     cfg: PipelineConfig, depth: Optional[str] = None):
    """stages_from_hits -> tidy screens -> GMM init correlation -> the F =
    max_fine_opt best candidates (db._query_step_impl up to its LM), for B
    queries at once: the init correlation runs over the B*C candidate rows,
    each against its own query's GMM. With `depth` one of DEPTHS, returns
    that gate's (B,) float32 probe instead."""
    if depth is not None and depth not in DEPTHS:
        raise ValueError(f"depth {depth!r}: not one of {DEPTHS}")
    N = store.keys.shape[0]
    qs = stages_from_hits(store, descs, hits, cfg,
                          None if depth == "init" else depth)
    if depth is not None and depth != "init":
        return qs
    st = qs.st
    mark("init", st.cand_gidx.device)
    post = cfg.thres_lb.sim_post
    tidy = tidy_candidates(st, post.area_perc, post.neg_est_dist,
                           cfg.cm.n_row, cfg.cm.n_col, cfg.cm.reso_row,
                           cfg.cm.reso_col)

    cg = torch.clamp(st.cand_gidx, 0, N - 1).long()
    src_gmm = gather_gmm(store, cg, tuple(cfg.gmm.levels),
                         cfg.gmm.max_gmm_ellipses)
    tgt_gmm = gmm_from_desc(descs, cfg.gmm)
    corr0, selp = init_correlation(src_gmm, per_query(tgt_gmm), tidy.T_sel,
                                   scale=cfg.gmm.cov_dilate_scale)
    if depth == "init":
        return _probe(corr0, tidy.T_sel)
    if cfg.db.dynamic_thres:
        keep = dynamic_post_scan(tidy.in_use, tidy.area, tidy.neg_d, corr0,
                                 post, cfg.thres_ub.sim_post)
    else:
        keep = tidy.alive & (corr0 >= post.correlation)

    C = st.cand_gidx.shape[1]
    F = min(cfg.db.max_fine_opt, C)
    rank = torch.where(keep, corr0, -math.inf)
    topi = stable_argsort(rank, descending=True)[:, :F]
    return RefineInputs(qs=qs, cand_gidx=st.cand_gidx,
                        src=GmmScan(*[take_rows(x, topi) for x in src_gmm]),
                        tgt=tgt_gmm, T0=take_rows(tidy.T_sel, topi),
                        sel=take_rows(selp, topi), topi=topi,
                        valid=torch.isfinite(rank.gather(1, topi)))


def refine_inputs(store: ScanDesc, keys_q, query: ScanDesc, state,
                  cfg: PipelineConfig) -> RefineInputs:
    """One query: search at the window `state`, then `refine_from_hits` at
    B = 1."""
    return _row0(refine_from_hits(store, *_as_batch(
        query, _search_query(keys_q, query, state, cfg)), cfg))


def query_from_hits(store: ScanDesc, descs: ScanDesc, hits,
                    cfg: PipelineConfig, depth: Optional[str] = None):
    """The B queries behind their search: refine_from_hits -> LM refinement
    over the B*F best candidates at once -> the packed (B, 18) f32
    records. With `depth` one of DEPTHS, the computation stops at that
    stage gate of db._query_step_impl and returns its (B,) float32 probe
    of the live tensors there (the split benchmarks time these exact
    prefixes); None returns the records."""
    f32 = torch.float32
    r = refine_from_hits(store, descs, hits, cfg, depth)
    if depth is not None:
        return r
    qs = r.qs
    res, st = qs.res, qs.st
    B = r.topi.shape[0]
    mark("lm", r.topi.device)
    corr_f, T_f = optimize_correlation(r.src, per_query(r.tgt), r.T0, r.sel,
                                       scale=cfg.gmm.cov_dilate_scale,
                                       iters=cfg.gmm.gn_iters)
    corr_fm = torch.where(r.valid, corr_f, -math.inf)
    best = torch.argmax(corr_fm, dim=1, keepdim=True)               # (B, 1)
    found = r.valid.any(dim=1, keepdim=True)

    def f(x):
        return x.to(f32).reshape(B, 1)

    return torch.cat([
        f(found),
        f(torch.where(found, r.cand_gidx.gather(1, r.topi.gather(1, best)),
                      -1)),
        f(torch.where(found, corr_fm.gather(1, best), 0.0)),
        take_rows(T_f, best).reshape(B, 3),
        f(qs.n_valid), f(qs.aft1), f(res.pass2.sum(dim=1)),
        f(res.pass3.sum(dim=1)), f(st.n_cand), f(qs.overflow_hints),
        f(st.overflow_pass), f(st.overflow_cand),
        f((res.pot_overflow & res.pass1).sum(dim=1)),
        f((res.win_overflow & res.pass1).sum(dim=1)), f(descs.pix_overflow),
        f(descs.gmm_overflow)], dim=1)


def query_step(store: ScanDesc, keys_q, query: ScanDesc, state,
               cfg: PipelineConfig, depth: Optional[str] = None):
    """queryRangedKNN (contour_db.h:698-811) = db._query_step_impl: the key
    search at the window `state` (the single-query tile-min), then
    `query_from_hits` at B = 1. Returns the packed (18,) f32 record, or
    with `depth` one of DEPTHS that stage gate's 0-d float32 probe."""
    mark("search", state.device)
    return query_from_hits(store, *_as_batch(
        query, _search_query(keys_q, query, state, cfg)), cfg, depth)[0]


def query_step_batch(store: ScanDesc, keys_q, descs: ScanDesc, searchable_b,
                     cfg: PipelineConfig, depth: Optional[str] = None):
    """B queries (a B-stacked ScanDesc), query b against the rows below
    searchable_b[b] ((B,) int32 on the device) -> (B, 18) records: the
    counterpart of jax.vmap(_query_step_impl), one batched program from the
    key search (one tile-min launch reads the store once for the B queries)
    to the records. Row b equals `query_step` of descs[b] at state[1] =
    searchable_b[b]: the exact columns exactly, the floats bit for bit on
    the CPU and within the record bands on a CUDA device (its reductions
    may split differently at another row count). With `depth`, the (B,)
    float32 probes of that stage gate (`query_from_hits`)."""
    mark("search", searchable_b.device)
    hits = search_batch(keys_q, descs.keys, searchable_b,
                        tuple(cfg.db.q_levels), cfg.db.nnk)
    return query_from_hits(store, descs, hits, cfg, depth)


def range_radius(max_dist_sq) -> float:
    """The radius `range_search` compares with: max_dist_sq in float32,
    clamped strictly below the masked-row sentinel (radii beyond it are
    meaningless, and the clamp keeps the mask value out of range), as
    db._range_search clamps it."""
    return float(min(np.float32(max_dist_sq),
                     np.float32(MAX_DIST_SQ * (1 - 1e-6))))


def _range_distances(keys_q, q_keys, searchable_n, max_dist_sq, q_levels):
    """The (Q*A, NA) masked squared distances of the query's (level,
    anchor) keys to the f32 search-layout store, MAX_DIST_SQ where out of
    range; the in-range mask; the radius; the (Q,) level ids."""
    L, D, NA = keys_q.shape
    dev = keys_q.device
    lv = device_const(q_levels, torch.long, dev)
    q = q_keys[lv].to(torch.float32)
    Q, A = q.shape[:2]
    cols = torch.arange(NA, dtype=torch.int32, device=dev)
    d2 = masked_key_distances(
        keys_q.index_select(0, lv).reshape(Q, D, 1, NA), q, searchable_n, NA,
        cols).reshape(Q * A, NA)
    thr = max_dist_sq if isinstance(max_dist_sq, torch.Tensor) \
        else range_radius(max_dist_sq)
    inr = d2 < thr
    return torch.where(inr, d2, MAX_DIST_SQ), inr, thr, lv


def _range_pack(order, vals, thr, inr, lv, A: int, cap: int):
    """The (cap + 1, 5) f64 result of a range search from the selected flat
    indices `order` into the (Q, A, NA) distances and their distances
    `vals` (MAX_DIST_SQ where out of range)."""
    NA = inr.shape[1]
    qi = torch.div(order, A * NA, rounding_mode="floor")
    rem = order % (A * NA)
    ai = torch.div(rem, NA, rounding_mode="floor")
    ri = rem % NA
    f64 = torch.float64
    hits = torch.stack([
        torch.div(ri, A, rounding_mode="floor").to(f64), lv[qi].to(f64),
        (ri % A).to(f64), ai.to(f64), vals.to(f64)], dim=1)
    hits = torch.where((vals < thr)[:, None], hits, -1.0)
    if hits.shape[0] < cap:     # tiny DBs: fewer rows than the cap
        hits = torch.cat([hits, hits.new_full((cap - hits.shape[0], 5), -1.0)])
    head = torch.zeros((1, 5), dtype=f64, device=order.device)
    head[0, 0] = inr.sum()
    return torch.cat([head, hits])


def range_search_impl(keys_q, q_keys, searchable_n, max_dist_sq,
                      q_levels: Tuple[int, ...], cap: int):
    """layerRangeSearch analog (db._range_search): every searchable key of
    the f32 search-layout store keys_q (L, D, NA) within max_dist_sq of any
    query (q_level, anchor) key, ascending (distance, flat index), at most
    `cap` rows. `max_dist_sq` is a host number, or a 0-d float32 tensor on
    the device that `range_radius` clamped. Returns one (cap + 1, 5) f64
    tensor (a single copy to the host; f64 holds the f32 distances and the
    count exactly): row 0 col 0 is the total in-range count, rows 1.. are
    (gidx, level, seq_src, seq_tgt, dist_sq), dist_sq -1 when unused.

    The selection is db._topk_min_cover's exact min-k over the flat
    (Q*A*NA) list, each (q, anchor) row tiled on its own (its end padded
    with MAX_DIST_SQ, no tile across two rows) so that the tiles in order
    follow the flat index: the minimum of each 128-column tile, the
    min(cap, tiles) tiles of the smallest (minimum, tile index), their
    columns sorted by (distance, index). The cover proof (db.py:211-220)
    makes that the first `cap` of one stable sort of the whole list
    (`range_search_sorted_plain`); a pad column is never in range, so a
    `cap` above the tile count, which takes every tile, is that sort too."""
    vals, inr, thr, lv = _range_distances(keys_q, q_keys, searchable_n,
                                          max_dist_sq, q_levels)
    A = q_keys.shape[1]
    R, NA = vals.shape
    Bt = -(-NA // TILE)
    W = Bt * TILE
    if W > NA:
        vals = torch.nn.functional.pad(vals, (0, W - NA), value=MAX_DIST_SQ)
    vp = vals.reshape(-1)
    tiles = stable_argsort(vp.reshape(R * Bt, TILE).amin(-1))[:cap]
    p = (tiles[:, None] * TILE
         + torch.arange(TILE, device=vp.device)).reshape(-1)
    v = vp[p]
    o1 = stable_argsort(p)
    p, v = p[o1], v[o1]
    o2 = stable_argsort(v)[:cap]
    p, v = p[o2], v[o2]
    # a pad column (>= NA) holds MAX_DIST_SQ: out of range, any index does
    order = torch.div(p, W, rounding_mode="floor") * NA \
        + (p % W).clamp(max=NA - 1)
    return _range_pack(order, v, thr, inr, lv, A, cap)


def range_search_sorted_plain(keys_q, q_keys, searchable_n, max_dist_sq,
                              q_levels: Tuple[int, ...], cap: int):
    """`range_search_impl` by one stable sort of all Q*A*NA distances: the
    reference the tile-min cover is held to."""
    vals, inr, thr, lv = _range_distances(keys_q, q_keys, searchable_n,
                                          max_dist_sq, q_levels)
    flat = vals.reshape(-1)
    order = stable_argsort(flat)[:cap]
    return _range_pack(order, flat[order], thr, inr, lv, q_keys.shape[1],
                       cap)


def update_window(state, ts_store, curr_ts, min_elapse: float,
                  max_elapse: float) -> None:
    """pushAndBalance replica on the device (db._update_window_impl): once
    the oldest unpopped scan is max_elapse old, every scan older than
    min_elapse becomes searchable. Updates state[1] in place."""
    n, pop = state[0], state[1]
    idx = torch.arange(ts_store.shape[0], dtype=torch.int32,
                       device=ts_store.device)
    oldest = ts_store[torch.clamp(pop, 0, ts_store.shape[0] - 1)
                      .long().reshape(1)].reshape(())
    trigger = (pop < n) & (oldest <= curr_ts - max_elapse)
    k = ((idx < n) & (ts_store < curr_ts - min_elapse)).sum().to(torch.int32)
    state[1] = torch.where(trigger, torch.maximum(k, pop), pop)


def replay_window(state, ts_store, ts_b, min_elapse: float,
                  max_elapse: float):
    """The window pushes of a block of B scans already appended, in scan
    order (db._process_block_impl's scan over _update_window_impl): query b
    sees the pushes of t_0..t_{b-1}. Returns each query's searchable_n, (B,)
    int32 on the device, and leaves state[1] after the B pushes."""
    B = ts_b.shape[0]
    searchable_b = torch.empty((B,), dtype=torch.int32, device=state.device)
    for b in range(B):
        searchable_b[b] = state[1]
        update_window(state, ts_store, ts_b[b], min_elapse, max_elapse)
    return searchable_b


# ---------------------------------------------------------------------------
# handles and the DB
# ---------------------------------------------------------------------------

class QueryHandle:
    """A query's record, still on the device: in the DB's record ring at
    `row` (the fused stream), or a standalone (18,) tensor `rec`
    (`query_async`, row None). Fetch one with `get()`, many with
    `drain_handles` (one copy of the ring per DB, one of the stacked
    standalone records)."""

    __slots__ = ("rec", "row", "_db", "_host")

    def __init__(self, db: "ContourDB", row: Optional[int] = None, rec=None):
        self.rec = rec
        self.row = row
        self._db = db
        self._host: Optional[QueryRecord] = None

    def _finish(self, vec) -> None:
        self._host = unpack_record(vec)
        self._db._accumulate(self._host)

    def record(self) -> QueryRecord:
        if self._host is None:
            drain_handles([self])
        return self._host

    def get(self) -> Optional[Tuple[int, float, np.ndarray]]:
        rec = self.record()
        return (rec.gidx, rec.corr, rec.T) if rec.found else None


class BlockHandle:
    """The (B, 18) records of a block, still on the device: rows row0.. of
    the DB's record ring (`process_block_async`) or a standalone tensor
    (`localize_block_async`, row0 None). `counters` names the DB's counter
    set the records go to: map-serving queries fill `serving_counters`, so
    serving traffic cannot skew the stream's diagnostics."""

    __slots__ = ("recs", "row0", "_db", "_host", "_counters")

    def __init__(self, recs, db: "ContourDB", counters: str = "counters",
                 row0: Optional[int] = None):
        self.recs = recs
        self.row0 = row0
        self._db = db
        self._host: Optional[list] = None
        self._counters = counters

    def _finish(self, mat) -> None:
        out = []
        for row in np.asarray(mat):
            rec = unpack_record(row)
            self._db._accumulate(rec, self._counters)
            out.append((rec.gidx, rec.corr, rec.T) if rec.found else None)
        self._host = out

    def get(self) -> list:
        """The block's results, one copy to the host: per scan (gidx, corr,
        T3) or None, in scan order."""
        if self._host is None:
            drain_block_handles([self])
        return self._host


def _fetch_rings(handles) -> dict:
    """{id(db): the DB's record ring on the host}, one copy per DB."""
    rings = {}
    for h in handles:
        if id(h._db) not in rings:
            rings[id(h._db)] = h._db.recs_store.cpu().numpy()
    return rings


def drain_handles(handles) -> list:
    """Fetch the records of QueryHandles: ring-backed ones from one copy of
    each DB's record ring, standalone ones from one stacked copy. Counters
    accumulate once per record: a handle fetched before keeps its cached
    record. None entries (queries against an empty DB) pass through.
    Returns per-handle None or (gidx, corr, T3), in order."""
    live = [h for h in handles if h is not None and h._host is None]
    ring = [h for h in live if h.row is not None]
    rest = [h for h in live if h.row is None]
    with span("record"):
        if ring:
            with span("fetch"):
                rings = _fetch_rings(ring)
            with span("unpack"):
                for h in ring:
                    h._finish(rings[id(h._db)][h.row])
        if rest:
            with span("fetch"):
                mats = torch.stack([h.rec for h in rest]).cpu().numpy()
            with span("unpack"):
                for h, vec in zip(rest, mats):
                    h._finish(vec)
    return [None if h is None else h.get() for h in handles]


def drain_block_handles(handles) -> None:
    """Fetch many BlockHandles' records: ring-backed blocks read their rows
    from one copy of each DB's record ring, standalone blocks from one
    concatenated copy. After this, `h.get()` costs nothing."""
    live = [h for h in handles if h is not None and h._host is None]
    ring = [h for h in live if h.row0 is not None]
    rest = [h for h in live if h.row0 is None]
    if ring:
        with span("fetch"):
            rings = _fetch_rings(ring)
        with span("unpack"):
            for h in ring:
                h._finish(rings[id(h._db)][h.row0:h.row0 + h.recs.shape[0]])
    if rest:
        with span("fetch"):
            mat = torch.cat([h.recs for h in rest]).cpu().numpy()
        with span("unpack"):
            at = 0
            for h in rest:
                h._finish(mat[at:at + h.recs.shape[0]])
                at += h.recs.shape[0]


_NP_OF = {torch.bool: np.bool_, torch.int8: np.int8, torch.int16: np.int16,
          torch.int32: np.int32, torch.float32: np.float32}
# leaves derived from the others: load_chain recomputes them, save skips them
_DERIVED = ("tab12", "gmm_pack")


def _stream_savez(path: str, scalars: dict, store: ScanDesc, since: int,
                  n: int, chunk_bytes: int) -> None:
    """Write an npz that np.load reads, the store leaves streamed in row
    blocks of at most chunk_bytes (device -> one pinned host buffer -> the
    zip member), so no whole leaf is ever held on the host. Members:
    the scalars by name and `store_<i>` by ScanDesc field position, the
    derived leaves left out. Every leaf's dtype is a numpy dtype (keys_q,
    the only bfloat16 tensor of the DB, is re-derived on load and never
    written)."""
    from numpy.lib import format as npf

    rows = n - since
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, val in scalars.items():
            buf = io.BytesIO()
            np.save(buf, np.asarray(val))
            zf.writestr(name + ".npy", buf.getvalue())
        for i, (field, leaf) in enumerate(zip(ScanDesc._fields, store)):
            if field in _DERIVED:
                continue
            row_shape = tuple(leaf.shape[1:])
            row_bytes = max(1, math.prod(row_shape) * leaf.element_size())
            step = max(1, chunk_bytes // row_bytes)
            pinned = None
            if leaf.is_cuda:
                pinned = torch.empty((min(step, max(rows, 1)),) + row_shape,
                                     dtype=leaf.dtype, pin_memory=True)
            header = {"descr": npf.dtype_to_descr(np.dtype(_NP_OF[leaf.dtype])),
                      "fortran_order": False, "shape": (rows,) + row_shape}
            with zf.open(f"store_{i}.npy", "w", force_zip64=True) as f:
                npf.write_array_header_2_0(f, header)
                for s0 in range(since, n, step):
                    block = leaf[s0:min(s0 + step, n)]
                    if pinned is not None:
                        host = pinned[:block.shape[0]]
                        host.copy_(block, non_blocking=True)
                        torch.cuda.current_stream(leaf.device).synchronize()
                        block = host
                    f.write(np.ascontiguousarray(block.numpy()).tobytes())


# ---------------------------------------------------------------------------
# host-side CandidateManager (readable spec replica of contour_db.h:264-656;
# query_ranged_knn_host runs on it, and the device merge is tested against it)
# ---------------------------------------------------------------------------

@dataclass
class AnchorProp:
    T: np.ndarray                      # (3,) x, y, theta
    constell: dict                     # {(lev, ss, st): perc} first-insert wins
    vote_cnt: int
    area_perc: float = 0.0
    correlation: float = 0.0


@dataclass
class CandidatePose:
    gidx: int
    props: List[AnchorProp] = field(default_factory=list)
    corr_init: float = 0.0
    sel: Optional[object] = None

    def add_proposal(self, T: np.ndarray, pairs, percs):
        """addProposal (contour_db.h:286-338): greedy merge within (2 m, 0.3
        rad)."""
        for p in self.props:
            # delta = T_prop^-1 * T_i
            c, s = math.cos(T[2]), math.sin(T[2])
            dx, dy = p.T[0] - T[0], p.T[1] - T[1]
            tx = c * dx + s * dy
            ty = -s * dx + c * dy
            dth = p.T[2] - T[2]
            dth = (dth + math.pi) % (2 * math.pi) - math.pi
            if math.hypot(tx, ty) < 2.0 and abs(dth) < 0.3:
                for pr, pc in zip(pairs, percs):
                    p.constell.setdefault(pr, pc)
                w1, w2 = p.vote_cnt, len(pairs)
                p.vote_cnt = w1 + w2
                trans = (np.array(p.T[:2]) * w1 + np.array(T[:2]) * w2) \
                    / (w1 + w2)
                diff = T[2] - p.T[2]
                if diff < 0:
                    diff += 2 * math.pi
                if diff > math.pi:
                    diff -= 2 * math.pi
                ang = diff * w2 / (w1 + w2) + p.T[2]
                p.T = np.array([trans[0], trans[1], ang])
                return
        if len(self.props) > 3:
            return
        self.props.append(AnchorProp(np.asarray(T, np.float64).copy(),
                                     {pr: pc for pr, pc in zip(pairs, percs)},
                                     len(pairs)))


class HostCandidateManager:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.order: List[int] = []         # gidx in first-seen order
        self.by_gidx = {}

    def add_passing_hint(self, gidx: int, T: np.ndarray, pairs, percs):
        cand = self.by_gidx.get(gidx)
        if cand is None:
            cand = CandidatePose(gidx)
            self.by_gidx[gidx] = cand
            self.order.append(gidx)
        cand.add_proposal(T, pairs, percs)

    def tidy_stats(self):
        """Per-candidate best-proposal selection + stats (tidyUpCandidates
        loop head, contour_db.h:503-545). Returns [(cand, area, neg_d), ...]
        in first-seen order; the caller applies the screens (rising bars
        under DYNAMIC_THRES)."""
        cfg = self.cfg
        out = []
        for gidx in self.order:
            cand = self.by_gidx[gidx]
            idx_sel = 0
            for i, p in enumerate(cand.props):
                lev_perc = {}
                for (lev, ss, st), perc in p.constell.items():
                    lev_perc[lev] = lev_perc.get(lev, 0.0) + perc
                p.area_perc = sum(
                    LAYER_AREA_WEIGHTS[j] * lev_perc.get(DIST_BIN_LAYERS[j],
                                                         0.0)
                    for j in range(len(DIST_BIN_LAYERS)))
                if p.vote_cnt > cand.props[idx_sel].vote_cnt:
                    idx_sel = i
            cand.props[0], cand.props[idx_sel] = \
                cand.props[idx_sel], cand.props[0]

            # distance censor in the sensor frame (getEstSensTF,
            # correlation.h:287-296)
            T = cand.props[0].T
            nr, nc = cfg.cm.n_row, cfg.cm.n_col
            ox = nr / 2 - 0.5
            oy = nc / 2 - 0.5
            c, s = math.cos(T[2]), math.sin(T[2])
            tx = c * ox - s * oy + T[0] - ox
            ty = s * ox + c * oy + T[1] - oy
            neg_d = -math.hypot(tx * cfg.cm.reso_row, ty * cfg.cm.reso_col)
            out.append((cand, cand.props[0].area_perc, neg_d))
        return out


class ContourDB:
    """Top-level database (reference ContourDB, contour_db.h:658-845) on an
    explicit torch device. A CUDA device without CUDA raises.

    With `cfg.db.dynamic_thres` every query runs the two sequential
    threshold recurrences (`dynamic_pass_scan`, `dynamic_post_scan`) on the
    device, as the `dyn_pass_scan` and `dyn_post_scan` kernels on a CUDA
    device: no host sync, so that mode runs as CUDA graph replays like the
    default one."""

    def __init__(self, cfg: PipelineConfig, capacity: int = 8192,
                 device="cuda"):
        self.device = self._checked_device(device)
        self.cfg = cfg
        self.capacity = capacity
        self.n = 0
        self.store: Optional[ScanDesc] = None
        self.keys_q = None
        self.ts_store = None
        self.state = None
        self.recs_store = None
        # host float64 timestamps, kept when the caller passes host floats:
        # the f32 ts_store rounds epoch-scale stamps by ~100 s (see save)
        self.ts: List[float] = []
        self.seq_of_gidx: List[int] = []
        # the host query's LM budget and GMM candidate padding
        self.max_fine = cfg.db.max_fine_opt
        self.gmm_pad = 32
        # check-cascade survivor counters (contour_db.h:356-359); map-serving
        # queries (localize_block_async) fill the separate set
        self.counters = self._zero_counters()
        self.serving_counters = self._zero_serving_counters()
        # the CUDA graphs of the step, the block step, the serving chunk and
        # the unfused API, and the tensors they read their inputs from and
        # write outputs to; `eager()` turns them off for a block
        self._graphs = GraphSet(self.device)

    @staticmethod
    def _checked_device(device) -> torch.device:
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("ContourDB(device='cuda'): CUDA is not "
                                   "available")
            if torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError("TF32 matmuls must stay off: the contour "
                                   "moments need full float32")
        return device

    @staticmethod
    def _zero_counters() -> dict:
        return dict(n_hints=0, cand_aft_check1=0, cand_aft_check2=0,
                    cand_aft_check3=0, overflow_hints=0, overflow_pass=0,
                    overflow_cand=0, overflow_pot=0, overflow_win=0,
                    overflow_pix=0, overflow_gmm=0)

    @classmethod
    def _zero_serving_counters(cls) -> dict:
        """The record counters, and the build slots that serving replayed
        (`localize_block_async`: one a cloud, and one a zero cloud it
        padded with)."""
        return dict(cls._zero_counters(), build_slots=0)

    def _kq_dtype(self):
        return torch.bfloat16 if self.cfg.cm.keys_bf16 else torch.float32

    def _init_store(self) -> None:
        spec = scan_desc_spec(self.cfg.cm, self.cfg.gmm)
        cap, dev = self.capacity, self.device
        self.store = ScanDesc(**{
            k: torch.zeros((cap,) + shape, dtype=dt, device=dev)
            for k, (shape, dt) in spec.items()})
        L, A, D = spec["keys"][0]
        self.keys_q = torch.zeros((L, D, cap * A), dtype=self._kq_dtype(),
                                  device=dev)
        self.ts_store = torch.zeros((cap,), dtype=torch.float32, device=dev)
        self.state = torch.zeros((2,), dtype=torch.int32, device=dev)
        self.recs_store = torch.zeros((cap, RECORD_WIDTH),
                                      dtype=torch.float32, device=dev)

    def store_bytes(self) -> int:
        """Bytes of the DB's device tensors."""
        ts = list(self.store) + [self.keys_q, self.ts_store, self.state,
                                 self.recs_store]
        return sum(t.numel() * t.element_size() for t in ts)

    @property
    def searchable_n(self) -> int:
        """Host view of the window state (syncs; not for the hot loop)."""
        return 0 if self.state is None else int(self.state[1])

    def _grow(self, new_capacity: int) -> None:
        """Re-allocate every store tensor at a larger capacity (zero pad)."""
        if new_capacity <= self.capacity:
            raise ValueError("_grow needs a larger capacity")
        pad = new_capacity - self.capacity

        def grow(t, rows):
            return torch.cat([t, t.new_zeros((rows,) + t.shape[1:])])

        self.store = ScanDesc(*[grow(t, pad) for t in self.store])
        A = self.store.keys.shape[2]
        self.keys_q = torch.cat(
            [self.keys_q, self.keys_q.new_zeros(self.keys_q.shape[:2]
                                                + (pad * A,))], dim=2)
        self.ts_store = grow(self.ts_store, pad)
        self.recs_store = grow(self.recs_store, pad)
        self.capacity = new_capacity
        self._graphs.drop()     # captured at the old tensors' addresses

    def _ensure_capacity(self, need: int) -> None:
        """Allocate the store at first use; grow it to hold `need` more
        rows (doubling amortizes the copy)."""
        if self.store is None:
            self._init_store()
        if self.n + need > self.capacity:
            self._grow(max(2 * self.capacity, self.n + need))

    def _upload(self, x):
        """`upload` to the DB's device."""
        return upload(x, self.device)

    def _scalar(self, x):
        """A host number or a tensor as a float32 tensor on the device."""
        if isinstance(x, torch.Tensor):
            return self._upload(x.to(torch.float32))
        # a fill kernel, not a host-to-device copy
        return torch.full((), float(x), dtype=torch.float32,
                          device=self.device)

    def _ts_tensor(self, ts, n: Optional[int] = None):
        """One timestamp, or n of them (a host sequence or a tensor), as a
        float32 tensor on the DB's device; host floats are also kept
        exactly in `self.ts`."""
        if isinstance(ts, torch.Tensor):
            return self._scalar(ts)
        if n is None:
            if isinstance(ts, (int, float, np.floating)):
                self.ts.append(float(ts))
            return self._scalar(ts)
        host = np.asarray(ts, np.float64).reshape(n)
        self.ts.extend(float(t) for t in host)
        return self._upload(torch.from_numpy(host.astype(np.float32)))

    def _rows(self, B: int):
        """(B,) int64 rows state[0].. on the device: where the next B rows
        of the store go (the JAX _append_impl's dynamic_update_slice at
        state[0]). Read on the device, so a captured write lands on the
        right rows at every replay."""
        return self.state[:1].long() + torch.arange(B, device=self.device)

    def _append_rows(self, descs: ScanDesc, ts_b) -> None:
        """Write the B-stacked descs at rows state[0].. on the device
        (db._append_impl, B rows at once): every store leaf, the (L, D,
        B*A) column block of keys_q (rounded to bf16 when keys_bf16), the
        timestamps, and state[0] += B. Pure copies, so B appends of one row
        write the same bits."""
        B = ts_b.shape[0]
        rows = self._rows(B)
        for buf, x in zip(self.store, descs):
            buf.index_copy_(0, rows, x.to(buf.device, buf.dtype))
        L, A, D = descs.keys.shape[1:]
        cols = (rows[:, None] * A
                + torch.arange(A, device=self.device)).reshape(-1)
        self.keys_q.index_copy_(
            2, cols, descs.keys.to(self.device).permute(1, 3, 0, 2)
            .reshape(L, D, B * A).to(self.keys_q.dtype))
        self.ts_store.index_copy_(0, rows, ts_b)
        self.state[0] += B

    def _append(self, descs: ScanDesc, ts_b) -> None:
        """`_append_rows`, and the host's mirror n += B."""
        self._append_rows(descs, ts_b)
        self.n += ts_b.shape[0]

    def _push(self, ts_t) -> None:
        tb = self.cfg.db.tb
        update_window(self.state, self.ts_store, ts_t, tb.min_elapse,
                      tb.max_elapse)

    # -- CUDA graphs ---------------------------------------------------------

    @property
    def graphed(self) -> bool:
        """Whether the entry points run as CUDA graph replays: on a CUDA
        device, `dynamic_thres` or not, outside `eager()`."""
        return self._graphs.enabled

    def eager(self):
        """A block in which every entry point runs its eager body, as on
        the CPU: the card's comparisons of a replay with the body it
        captured."""
        return self._graphs.eager()

    def _tag(self) -> tuple:
        """The tensors the graphs read and write (`graphs.tensor_tag`)."""
        return tensor_tag(*self.store, self.keys_q, self.ts_store,
                          self.state, self.recs_store)

    def _static(self, key, shape, dtype):
        """A graph's input or output buffer, kept for the DB's lifetime."""
        return self._graphs.static(key, shape, dtype)

    def _static_descs(self, B: int) -> ScanDesc:
        """A B-stacked ScanDesc of static buffers: the build graph's output
        and the query graph's input."""
        spec = scan_desc_spec(self.cfg.cm, self.cfg.gmm)
        return ScanDesc(**{k: self._static(("desc", B, k), (B,) + shape, dt)
                           for k, (shape, dt) in spec.items()})

    def _static_ts(self, ts_t):
        """The timestamp input of the step, append and push graphs, holding
        ts_t (a 0-d float32 tensor on the device)."""
        ts_in = self._static(("ts",), (), torch.float32)
        ts_in.copy_(ts_t)
        return ts_in

    def _static_descs_of(self, descs: ScanDesc) -> ScanDesc:
        """The static B-stacked ScanDesc holding `descs`: copied in unless
        `descs` is that buffer itself (the build graph's output)."""
        d_in = self._static_descs(descs.keys.shape[0])
        if any(a.data_ptr() != b.data_ptr() for a, b in zip(d_in, descs)):
            for dst, src in zip(d_in, descs):
                dst.copy_(src)
        return d_in

    def drop_graphs(self) -> None:
        """Drop the DB's CUDA graphs (another DB's stay). A graph's working
        set lives in the device's graph pool, which every DB of the process
        shares (`graphs.device_pool`); its memory goes back to the card
        when the last graph of the device is gone. The next graphed call of
        a shape captures it again."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)     # no replay in flight
        self._graphs.drop()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def graph_stats(self) -> dict:
        """Capture seconds of each of the DB's graphs, the launches of each
        kernel one replay makes, and the bytes the graph pool holds: the
        device's one pool, shared by the graphs of every DB of the process
        (`pool` says so)."""
        return self._graphs.stats()

    # -- the fused stream ---------------------------------------------------

    def _step_body(self, pts, ts_t) -> None:
        """One scan on the device: build -> query (window state before this
        scan) -> the record at row state[0] of the ring -> append -> window
        update. No host sync and no host-side index: the body a CUDA graph
        captures."""
        desc = build_descriptor(pts, self.cfg.cm, self.cfg.gmm)
        rec = query_step(self.store, self.keys_q, desc, self.state, self.cfg)
        mark("tail", self.device)
        self.recs_store.index_copy_(0, self._rows(1), rec[None])
        self._append_rows(ScanDesc(*[x[None] for x in desc]), ts_t.reshape(1))
        self._push(ts_t)
        mark("end", self.device)

    def step_async(self, points, seq: int, ts) -> QueryHandle:
        """One scan: build -> query (window state before this scan) ->
        record-ring write -> append -> window update. `points` is the
        (max_points, 4) f32 or int16 q16 payload, `ts` a float or a 0-d
        tensor. The record stays on the device until it is drained.

        On a CUDA device the step is one CUDA graph replay: the payload and
        the timestamp are copied into static buffers (one payload buffer a
        dtype; host payloads through pinned memory) and the captured body
        runs, with no host sync. The first step (and the first after a
        grow) runs the body eagerly and captures it. With `dynamic_thres`
        as well."""
        with span("step"):
            self._ensure_capacity(1)
            pts = self._upload(points)
            ts_t = self._ts_tensor(ts)
            if self.graphed:
                with span("stage_in"):
                    pts_in = self._static(("pts", pts.dtype,
                                           tuple(pts.shape)),
                                          pts.shape, pts.dtype)
                    pts_in.copy_(pts)
                    ts_in = self._static_ts(ts_t)
                self._graphs.run(("step", pts.dtype, tuple(pts.shape)),
                                 lambda: self._step_body(pts_in, ts_in),
                                 self._tag())
            else:
                self._step_body(pts, ts_t)
        row = self.n
        self.n += 1
        self.seq_of_gidx.append(int(seq))
        return QueryHandle(self, row)

    def step_chain_async(self, points_k, seqs, ts_k) -> BlockHandle:
        """K sequential steps (`points_k` (K, max_points, 4) f32 or q16,
        `ts_k` K timestamps): exact per-scan semantics at any timestamp
        spacing, unlike `process_block_async`. One upload for the K clouds;
        the K records come back through one BlockHandle over the record
        ring's rows. `step_chain_dyn_async` with k = K."""
        return self.step_chain_dyn_async(points_k, seqs, ts_k)

    def step_chain_scan_async(self, points_k, seqs, ts_k) -> BlockHandle:
        """The JAX package's lax.scan lowering of `step_chain_async`, kept
        there for a lowering A/B. The port has one lowering of a chain, so
        this is `step_chain_async` with JAX's check that the K timestamps
        name the K seqs."""
        if len(ts_k) != len(seqs):
            raise ValueError(f"{len(ts_k)} timestamps for {len(seqs)} seqs")
        return self.step_chain_async(points_k, seqs, ts_k)

    @staticmethod
    def stage_chain_k(k: int, *, device="cuda"):
        """A chain length for `step_chain_dyn_async(k_dev=...)`: `(k, int32
        tensor holding k on the device)`. The host half lets the call check
        the staged length against len(seqs) without a device fetch."""
        return int(k), torch.full((), int(k), dtype=torch.int32,
                                  device=torch.device(device))

    def step_chain_dyn_async(self, points_buf, seqs, ts_k,
                             k_dev=None) -> BlockHandle:
        """`step_chain_async` over the first k = len(seqs) rows of a buffer
        that may be longer: `points_buf` (K, max_points, 4), `ts_k` K
        timestamps covering the whole buffer (rows past k are ignored).
        `k_dev` is an optional `stage_chain_k` pair, checked against
        len(seqs) on the host. On a CUDA device the k steps are k replays
        of the step's graph issued back to back, with no host sync."""
        k = len(seqs)
        if k_dev is not None and int(k_dev[0]) != k:
            raise ValueError(f"staged k ({int(k_dev[0])}) != len(seqs) ({k})")
        rows = points_buf.shape[0]
        if k > rows:
            raise ValueError(f"{k} seqs for a buffer of {rows} rows")
        if len(ts_k) != rows:
            raise ValueError("ts_k must cover the full buffer (rows past k "
                             "are ignored)")
        self._ensure_capacity(k)
        pts = self._upload(points_buf[:k])
        row0 = self.n
        for i, s in enumerate(seqs):
            self.step_async(pts[i], s, ts_k[i])
        return BlockHandle(self.recs_store[row0:row0 + k], self, row0=row0)

    def drain(self, handles) -> list:
        """`drain_handles`: per-handle None or (gidx, corr, T3)."""
        return drain_handles(handles)

    def _accumulate(self, rec: QueryRecord, which: str = "counters") -> None:
        c = getattr(self, which)
        c["n_hints"] += rec.n_hints
        c["cand_aft_check1"] += rec.aft1
        c["cand_aft_check2"] += rec.aft2
        c["cand_aft_check3"] += rec.aft3
        for k in ("overflow_hints", "overflow_pass", "overflow_cand",
                  "overflow_pot", "overflow_win", "overflow_pix",
                  "overflow_gmm"):
            c[k] += getattr(rec, k)

    # -- the unfused API ----------------------------------------------------

    def _build_one(self, points) -> ScanDesc:
        """`build_descriptor` of one (max_points, 4) cloud: `_build_batch`
        at B = 1 (graphed: one replay of the build graph of 1) with the
        batch axis stripped. Graphed, the descriptor is a view of the
        static buffer the next build overwrites, which `query_async` and
        `add_scan` read without a copy."""
        return ScanDesc(*[x[0] for x in self._build_batch(
            self._upload(points)[None])])

    def add_scan(self, desc: ScanDesc, seq: int, ts) -> None:
        """Append one scan's descriptor. `ts` is a host float or a 0-d
        tensor. On a CUDA device one replay of the append graph (the
        descriptor and timestamp copied into static buffers, the rows
        read from state[0] on the device); `n`, `seq_of_gidx` and the
        exact host timestamps `ts` stay on the host."""
        self._ensure_capacity(1)
        ts_t = self._ts_tensor(ts).reshape(1)
        if not self.graphed:
            self._append(ScanDesc(*[x[None] for x in desc]), ts_t)
        else:
            d_in = self._static_descs_of(ScanDesc(*[x[None] for x in desc]))
            ts_in = self._static_ts(ts_t.reshape(()))
            self._graphs.run(("add_scan",), lambda: self._append_rows(
                d_in, ts_in.reshape(1)), self._tag())
            self.n += 1
        self.seq_of_gidx.append(int(seq))

    def push_and_balance(self, curr_ts) -> None:
        """Pop the buffer once the oldest unpopped scan exceeds max_elapse;
        everything older than min_elapse becomes searchable. On the
        device: on a CUDA device one replay of the push graph."""
        if self.state is None:
            return
        ts_t = self._scalar(curr_ts)
        if not self.graphed:
            self._push(ts_t)
            return
        ts_in = self._static_ts(ts_t)
        self._graphs.run(("push",), lambda: self._push(ts_in), self._tag())

    def query_async(self, query: ScanDesc) -> Optional[QueryHandle]:
        """The query step on a built descriptor, nothing appended; returns
        a standalone QueryHandle, or None when the DB is empty. An empty
        search window gives found=False on the device. On a CUDA device
        one replay of the query graph of 1 (`query_step` at the window
        state[1] on the device): the descriptor is copied into the static
        one-row buffer unless it is that buffer (the per-scan build's
        output), and the static record is cloned into the handle."""
        if self.store is None:
            return None
        if not self.graphed:
            return QueryHandle(self, rec=query_step(
                self.store, self.keys_q, query, self.state, self.cfg))
        d_in = self._static_descs_of(ScanDesc(*[x[None] for x in query]))
        d0 = ScanDesc(*[x[0] for x in d_in])
        out = self._static(("rec",), (RECORD_WIDTH,), torch.float32)

        def body():
            out.copy_(query_step(self.store, self.keys_q, d0, self.state,
                                 self.cfg))

        self._graphs.run(("query_step",), body, self._tag())
        return QueryHandle(self, rec=out.clone())

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def query_ranged_knn(self, query: ScanDesc, profiler=None):
        """queryRangedKNN (contour_db.h:698-811): at most one (cand_gidx,
        correlation, T_delta(3,)) or None. Blocking form of query_async;
        a `profiler` (utils.profiling.SequentialTimeProfiler) records the
        query's time, the device synchronised."""
        h = self.query_async(query)
        if profiler:
            self._sync()
            profiler.record("query (fused)")
        return None if h is None else h.get()

    def query_ranged_knn_host(self, query: ScanDesc, profiler=None):
        """The sequential host CandidateManager path, the readable spec of
        the query (db.query_ranged_knn_host): the key search through the
        maintained keys_q on the DB's device (one tile-min launch), the
        check cascade over every valid hit with no hint cap, the proposal
        merge, tidy statistics and the dynamic re-gating on the host, then
        the GMM init correlation (candidates padded to `gmm_pad` rows), the
        post screens and the LM over the `max_fine` best. Same semantics as
        `query_ranged_knn` wherever the device path's caps do not overflow.
        Returns (cand_gidx, correlation, T_delta(3,)) or None."""
        cfg = self.cfg
        if self.store is None or self.searchable_n == 0:
            return None
        dev = self.device
        gidx, seq_src, _, valid = search(self.keys_q, query.keys, self.state,
                                         tuple(cfg.db.q_levels), cfg.db.nnk)
        if profiler:
            self._sync()
            profiler.record("KNN search")

        Q, A, K = gidx.shape
        i32 = torch.int32
        level = device_const(tuple(cfg.db.q_levels), i32, dev)[:, None, None] \
            .expand(Q, A, K).reshape(-1)
        seq_tgt = torch.arange(A, dtype=i32, device=dev)[None, :, None] \
            .expand(Q, A, K).reshape(-1)
        gidx_f = gidx.reshape(-1)
        H = gidx_f.shape[0]
        query_b = ScanDesc(*[x[None] for x in query])     # a batch of one
        res = gather_and_cascade(
            self.store, query_b,
            torch.zeros(H, dtype=torch.long, device=dev), gidx_f, level,
            seq_src.reshape(-1), seq_tgt, valid.reshape(-1), cfg.thres_lb,
            cfg.db.cont_sim, cfg.db.p_pot)
        res = CascadeResult(*[x.cpu().numpy() for x in res])
        gidx_h = gidx_f.cpu().numpy()
        if profiler:
            profiler.record("Constell")

        if cfg.db.dynamic_thres:
            # sequential re-gating with rising bars (contour_db.h:439-458)
            lb, ub = cfg.thres_lb, cfg.thres_ub
            lbs = np.array([lb.sim_constell.i_ovlp_sum,
                            lb.sim_constell.i_ovlp_max_one,
                            lb.sim_constell.i_in_ang_rng,
                            lb.sim_pair.i_indiv_sim, lb.sim_pair.i_orie_sim])
            ubs = np.array([ub.sim_constell.i_ovlp_sum,
                            ub.sim_constell.i_ovlp_max_one,
                            ub.sim_constell.i_in_ang_rng,
                            ub.sim_pair.i_indiv_sim, ub.sim_pair.i_orie_sim])
            sc = np.stack([res.ovlp_sum, res.ovlp_max_one, res.in_ang_rng,
                           res.i_indiv_sim, res.i_orie_sim], axis=1)
            pass3 = np.zeros(H, bool)
            for h in range(H):
                if res.pass1[h] and (sc[h] >= lbs).all():
                    pass3[h] = True
                    lbs = np.minimum(np.maximum(lbs, sc[h, 4]), ubs)
        else:
            pass3 = res.pass3
        mgr = HostCandidateManager(cfg)
        for h in np.flatnonzero(pass3):
            sel = np.flatnonzero(res.pair_valid[h])
            pairs = [(int(res.pair_level[h, i]), int(res.pair_seq_src[h, i]),
                      int(res.pair_seq_tgt[h, i])) for i in sel]
            percs = [float(res.pair_area_perc[h, i]) for i in sel]
            mgr.add_passing_hint(int(gidx_h[h]),
                                 res.T_delta[h].astype(np.float64), pairs,
                                 percs)
        stats = mgr.tidy_stats()
        if not stats:
            if profiler:
                profiler.record("L2 opt")
            return None

        # batched GMM init correlation (screen 3/3 of tidyUpCandidates)
        C = len(stats)
        pad = max(self.gmm_pad, C)
        cg = np.zeros(pad, np.int64)
        Ti = np.zeros((pad, 3), np.float32)
        for i, (cand, _, _) in enumerate(stats):
            cg[i] = cand.gidx
            Ti[i] = cand.props[0].T
        src_gmm = gather_gmm(self.store, torch.from_numpy(cg).to(dev),
                             tuple(cfg.gmm.levels), cfg.gmm.max_gmm_ellipses)
        tgt_gmm = gmm_from_desc(query_b, cfg.gmm)        # broadcasts
        Ti_t = torch.from_numpy(Ti).to(dev)
        corr0, selp = init_correlation(src_gmm, tgt_gmm, Ti_t,
                                       scale=cfg.gmm.cov_dilate_scale)
        corr0 = corr0.cpu().numpy()

        post_lb = cfg.thres_lb.sim_post
        if cfg.db.dynamic_thres:
            post_ub = cfg.thres_ub.sim_post
            bars = np.array([post_lb.area_perc, post_lb.neg_est_dist,
                             post_lb.correlation])
            ubars = np.array([post_ub.area_perc, post_ub.neg_est_dist,
                              post_ub.correlation])
            keep = []
            for i, (_, area, neg_d) in enumerate(stats):
                v = np.array([area, neg_d, corr0[i]])
                if (v >= bars).all():
                    keep.append(i)
                    bars = np.minimum(np.maximum(bars, v), ubars)
        else:
            keep = [i for i, (_, area, neg_d) in enumerate(stats)
                    if area >= post_lb.area_perc
                    and neg_d >= post_lb.neg_est_dist
                    and corr0[i] >= post_lb.correlation]
        if not keep:
            if profiler:
                profiler.record("L2 opt")
            return None
        # fineOptimize (contour_db.h:604-648): refine up to max_fine_opt,
        # ranked by init correlation
        keep.sort(key=lambda i: -corr0[i])
        keep = keep[:self.max_fine]
        kidx = torch.tensor(keep, dtype=torch.long, device=dev)
        corr_f, T_f = optimize_correlation(
            GmmScan(*[x[kidx] for x in src_gmm]), tgt_gmm, Ti_t[kidx],
            selp[kidx], scale=cfg.gmm.cov_dilate_scale,
            iters=cfg.gmm.gn_iters)
        corr_f, T_f = corr_f.cpu().numpy(), T_f.cpu().numpy()
        best = int(np.argmax(corr_f))
        if profiler:
            profiler.record("L2 opt")
        return (int(cg[keep[best]]), float(corr_f[best]),
                T_f[best].astype(np.float64))

    def range_search(self, query: ScanDesc, max_dist_sq: float,
                     cap: int = 256):
        """layerRangeSearch analog (contour_db.h:204-216): all searchable
        keys within `max_dist_sq` of any of the query's (q_level, anchor)
        keys, ascending distance. Returns (hits, n_in_range): hits is a list
        of (gidx, level, seq_src, seq_tgt, dist_sq); n_in_range counts every
        in-range key and may exceed len(hits) when `cap` truncates. Radii
        are capped at MAX_DIST_SQ, the sentinel of unsearchable rows.
        Membership is exact: under keys_bf16 the f32 layout is derived from
        store.keys, not read from the rounded search copy.

        On a CUDA device one replay of the range graph of (cap, keys
        dtype, capacity): the query keys and the clamped radius are copied
        into static buffers, the graph writes the static (cap + 1, 5)
        result, and its copy to the host is the call's one host sync (JAX
        fetches its packed buffer the same way)."""
        if self.store is None:
            return [], 0
        ql, cap, thr = (tuple(self.cfg.db.q_levels), int(cap),
                        range_radius(max_dist_sq))

        def search(q_keys, radius):
            kq = self.keys_q if self.keys_q.dtype == torch.float32 else \
                keys_to_q_layout(self.store.keys)
            return range_search_impl(kq, q_keys, self.state[1], radius, ql,
                                     cap)

        if not self.graphed:
            out = search(query.keys, thr)
        else:
            shape = tuple(query.keys.shape)
            q_in = self._static(("range_q", shape), shape, torch.float32)
            q_in.copy_(self._upload(query.keys))
            r_in = self._static(("range_r",), (), torch.float32)
            r_in.fill_(thr)
            out = self._static(("range", cap), (cap + 1, 5), torch.float64)
            self._graphs.run(("range_search", cap, self.keys_q.dtype,
                              self.capacity),
                             lambda: out.copy_(search(q_in, r_in)),
                             self._tag())
        packed = out.cpu().numpy()
        rows = packed[1:][packed[1:, 4] >= 0.0].tolist()
        hits = [(int(g), int(lev), int(s), int(t), d)
                for g, lev, s, t, d in rows]
        return hits, int(packed[0, 0])

    # -- block mode and map serving -----------------------------------------

    def _query_batch(self, descs: ScanDesc, searchable_b):
        """query_step_batch of the B-stacked descs at searchable_b on the
        DB's map: (B, 18) records. Graphed, one replay of the query graph
        of B (search + tail), captured once for each (B, capacity), reading
        the static descriptor and limit buffers and writing a static record
        buffer (a later replay overwrites it: copy what is kept)."""
        if not self.graphed:
            return query_step_batch(self.store, self.keys_q, descs,
                                    searchable_b, self.cfg)
        B = searchable_b.shape[0]
        with span("stage_in"):
            d_in = self._static_descs_of(descs)
            sb_in = self._static(("sb", B), (B,), torch.int32)
            if sb_in.data_ptr() != searchable_b.data_ptr():
                sb_in.copy_(searchable_b)
        out = self._static(("recs", B), (B, RECORD_WIDTH), torch.float32)

        def body():
            recs = query_step_batch(self.store, self.keys_q, d_in, sb_in,
                                    self.cfg)
            mark("tail", self.device)
            out.copy_(recs)
            mark("end", self.device)

        self._graphs.run(("query", B), body, self._tag())
        return out

    def _build_batch(self, points_b) -> ScanDesc:
        """build_descriptors of the (B, max_points, 4) clouds (host data is
        uploaded through pinned memory). Graphed, one replay of the build
        graph of B, captured once for each (B, payload dtype), writing the
        static descriptor buffers of B (the query graph's input); it reads
        no DB tensor, so no grow drops it."""
        pts = self._upload(points_b)
        if not self.graphed:
            return build_descriptors(pts, self.cfg.cm, self.cfg.gmm)
        B = pts.shape[0]
        key = ("build", pts.dtype, tuple(pts.shape))
        with span("stage_in"):
            pts_in = self._static(("pts",) + key[1:], pts.shape, pts.dtype)
            pts_in.copy_(pts)
        d_in = self._static_descs(B)

        def body():
            for dst, src in zip(d_in, build_descriptors(pts_in, self.cfg.cm,
                                                        self.cfg.gmm)):
                dst.copy_(src)
            mark("end", self.device)

        self._graphs.run(key, body)
        return d_in

    def process_block_async(self, descs: ScanDesc, seqs, ts_b) -> BlockHandle:
        """Append and query a block of B scans: `descs` is a B-stacked
        ScanDesc (`build_descriptors`), `ts_b` B timestamps (a host sequence
        or a (B,) tensor).

        Exact parity with the per-scan order query_i -> add_i -> push(t_i)
        under one precondition: every timestamp of the block is newer than
        every query's min_elapse cut, so the block's own scans are invisible
        to its searches (true for a regular stream: the block spans less
        than min_elapse). The scans are appended first, each query's
        searchable prefix is replayed from the window pushes (query b sees
        the pushes of t_0..t_{b-1}), and the B queries share one batched key
        search. For arbitrary spacing use `step_chain_async`.

        On a CUDA device the append and the window pushes are one replay
        of the append graph of B (writing the B queries' static
        searchable_b) and the B queries one replay of the query graph of B
        (`_query_batch`), with no host sync."""
        B = len(seqs)
        self._ensure_capacity(B)
        ts_t = self._ts_tensor(ts_b, B)
        if ts_t.shape != (B,):
            raise ValueError(f"ts_b: shape {tuple(ts_t.shape)}, expected "
                             f"({B},)")
        row0 = self.n
        if not self.graphed:
            searchable_b = self._block_append(descs, ts_t)
        else:
            with span("stage_in"):
                descs = self._static_descs_of(descs)
                ts_in = self._static(("ts", B), (B,), torch.float32)
                ts_in.copy_(ts_t)
            searchable_b = self._static(("sb", B), (B,), torch.int32)
            self._graphs.run(("block_append", B), lambda: searchable_b.copy_(
                self._block_append(descs, ts_in)), self._tag())
        self.n += B
        recs = self._query_batch(descs, searchable_b)
        self.recs_store[row0:row0 + B] = recs
        self.seq_of_gidx.extend(int(s) for s in seqs)
        return BlockHandle(self.recs_store[row0:row0 + B], self, row0=row0)

    def _block_append(self, descs: ScanDesc, ts_b):
        """The append and window pushes of a block (db._process_block_impl
        before its queries): `_append_rows` of the B-stacked descs, then
        `replay_window`; returns each query's searchable_n, (B,) int32 on
        the device. The body of the append graph of B."""
        self._append_rows(descs, ts_b)
        tb = self.cfg.db.tb
        return replay_window(self.state, self.ts_store, ts_b, tb.min_elapse,
                             tb.max_elapse)

    def _block_chain(self, seqs, ts_nb, descs_of) -> BlockHandle:
        nb, b = len(ts_nb), len(ts_nb[0])
        if nb * b != len(seqs):
            raise ValueError("seqs must list the NB*B ids of ts_nb")
        row0 = self.n
        for i in range(nb):
            self.process_block_async(descs_of(i), seqs[i * b:(i + 1) * b],
                                     ts_nb[i])
        return BlockHandle(self.recs_store[row0:row0 + nb * b], self,
                           row0=row0)

    def block_chain_async(self, descs_nb: ScanDesc, seqs, ts_nb
                          ) -> BlockHandle:
        """NB block steps in sequence: `descs_nb` is (NB, B)-stacked,
        `ts_nb` (NB, B); `seqs` lists the NB*B sequence ids in order."""
        return self._block_chain(
            seqs, ts_nb, lambda i: ScanDesc(*[x[i] for x in descs_nb]))

    def block_chain_pts_async(self, points_nb, seqs, ts_nb) -> BlockHandle:
        """`block_chain_async` from raw clouds: `points_nb` is (NB, B,
        max_points, 4); each step builds its block's B descriptors (on a
        CUDA device one replay of the build graph of B), then runs the
        block step."""
        if len(points_nb) != len(ts_nb):
            raise ValueError("points_nb and ts_nb disagree on NB")
        return self._block_chain(
            seqs, ts_nb, lambda i: self._build_batch(points_nb[i]))

    def localize_block_async(self, points_b, chunk: Optional[int] = None
                             ) -> Optional[BlockHandle]:
        """Batched localization against the frozen map: B clouds in
        ((B, max_points, 4) f32 or q16), B records out, nothing appended,
        every query at the map's searchable prefix. Use after building,
        loading or merging a map. The request is served in the chunks of
        `serve_chunks`: with no `chunk`, on a CUDA device, chunks of
        SERVE_CHUNK and one of each power of two below it that B's
        remainder holds, so the upload carries exactly the B clouds; a
        `chunk` bounds the batch of one key search, and a tail that does
        not divide it is padded with zero clouds, which come back
        found=False and are sliced off. Returns None on an empty DB. The
        records count into `serving_counters`, and the build slots
        replayed (zero clouds included) into its `build_slots`. On a CUDA
        device each chunk is one replay of the build graph and one of the
        query graph of its size, each captured the first time a request
        needs it, with no host sync. `drop_graphs` gives their memory
        back."""
        if self.store is None:
            return None
        pts = torch.as_tensor(points_b)
        B = pts.shape[0]
        sizes = serve_chunks(B, chunk, self.graphed)
        if not sizes:
            return BlockHandle(
                torch.zeros((0, RECORD_WIDTH), dtype=torch.float32,
                            device=self.device), self,
                counters="serving_counters")
        pad = sum(sizes) - B
        if pad:
            pts = torch.cat([pts, pts.new_zeros((pad,) + pts.shape[1:])])
        recs, at = [], 0
        for c in sizes:
            with span(f"chunk.{c}"):
                descs = self._build_batch(pts[at:at + c])
                out = self._query_batch(
                    descs, self.state[1].expand(c).contiguous())
                with span("stage_out"):
                    recs.append(out.clone())
            at += c
        self.serving_counters["build_slots"] += at
        with span("stage_out"):
            recs = torch.cat(recs)[:B]
        return BlockHandle(recs, self, counters="serving_counters")

    # -- checkpoints and merge ----------------------------------------------

    def save(self, path: str, since: int = 0,
             chunk_bytes: int = 256 << 20) -> None:
        """Rows [since:n] + window state + metadata -> .npz, in the format
        of `contour_context_tpu.db.ContourDB.save`, member for member (a
        file of either package loads in the other). `since > 0` writes a
        delta holding only the rows appended after an earlier save;
        `load_chain` restores base + deltas. The store leaves are streamed
        in row blocks of at most `chunk_bytes`."""
        if self.store is None:
            raise ValueError("save: empty DB")
        n = self.n
        if not 0 <= since <= n:
            raise ValueError(f"save: since {since} outside 0..{n}")
        ts_store = self.ts_store[since:n].cpu().numpy()
        # the host f64 list is authoritative when it covers every row:
        # epoch-scale stamps (~1.7e9 s) round by ~100 s in the f32 ts_store
        ts_f64 = (np.asarray(self.ts[since:n], np.float64)
                  if len(self.ts) == n else ts_store.astype(np.float64))
        keys = sorted(self.counters)
        scalars = dict(
            n=n, since=since, capacity=self.capacity,
            state=self.state.cpu().numpy(), ts_store=ts_store,
            seq_of_gidx=np.asarray(self.seq_of_gidx[since:], np.int64),
            ts=ts_f64,
            counters=np.asarray([self.counters[k] for k in keys], np.int64),
            counter_keys=np.asarray(keys))
        _stream_savez(path, scalars, self.store, since, n, chunk_bytes)

    @classmethod
    def load(cls, path: str, cfg: PipelineConfig,
             capacity: Optional[int] = None, device="cuda") -> "ContourDB":
        """Restore a checkpoint; the capacity may be grown on load."""
        return cls.load_chain([path], cfg, capacity=capacity, device=device)

    @classmethod
    def load_chain(cls, paths: Sequence[str], cfg: PipelineConfig,
                   capacity: Optional[int] = None, device="cuda"
                   ) -> "ContourDB":
        """Restore a base checkpoint + delta chain (`save(path, since=k)`).
        The files must be contiguous: the first has since=0, each next
        file's `since` equals the previous file's `n`. Window state,
        counters and capacity come from the last file. Leaves a legacy file
        lacks are zero-filled and legacy dtypes cast to today's; `tab12`,
        `gmm_pack` and `keys_q` are recomputed from the other leaves
        (bit-equal to what build_descriptor and the appends wrote)."""
        cls._checked_device(device)     # before any file is read
        zs = [np.load(p) for p in paths]
        try:
            sinces = [int(z["since"]) if "since" in z.files else 0
                      for z in zs]
            ns = [int(z["n"]) for z in zs]
            if sinces[0] != 0:
                raise ValueError("first file of a chain must be a full save")
            for k in range(1, len(zs)):
                if sinces[k] != ns[k - 1]:
                    raise ValueError(
                        f"chain gap: {paths[k]} starts at row {sinces[k]}, "
                        f"previous file ends at {ns[k - 1]}")
            n = ns[-1]
            cap = capacity or max(int(zs[-1]["capacity"]), n)
            if cap < n:
                raise ValueError("capacity smaller than stored rows")
            db = cls(cfg, capacity=cap, device=device)
            db._init_store()
            spec = scan_desc_spec(cfg.cm, cfg.gmm)
            for i, (field, (shape, dt)) in enumerate(spec.items()):
                if field in _DERIVED:
                    continue
                at = 0
                for z, s, e in zip(zs, sinces, ns):
                    if f"store_{i}" in z.files:
                        part = torch.from_numpy(np.ascontiguousarray(
                            z[f"store_{i}"]).astype(_NP_OF[dt], copy=False))
                        getattr(db.store, field)[at:at + e - s] = \
                            part.to(db.device)
                    at += e - s
            db.store = db.store._replace(
                tab12=tab12_of(db.store),
                gmm_pack=gmm_pack_of(db.store, cfg.gmm))
            db.keys_q = keys_to_q_layout(db.store.keys, db._kq_dtype()) \
                .contiguous()
            db.ts_store[:n] = torch.from_numpy(np.concatenate(
                [np.asarray(z["ts_store"], np.float32) for z in zs]))
            db.state = torch.from_numpy(
                np.asarray(zs[-1]["state"], np.int32)).to(db.device)
            db.n = n
            db.seq_of_gidx = [int(x) for z in zs for x in z["seq_of_gidx"]]
            # prefer the f64 'ts' member (exact epoch-scale stamps)
            db.ts = [float(t) for z in zs for t in
                     (z["ts"] if "ts" in z.files
                      else np.asarray(z["ts_store"], np.float64))]
            # counters map by name; legacy files predate the key list and
            # hold the then-current 8 sorted names
            z_last = zs[-1]
            legacy = ["cand_aft_check1", "cand_aft_check2", "cand_aft_check3",
                      "n_hints", "overflow_cand", "overflow_hints",
                      "overflow_pass", "overflow_pot"]
            keys = ([str(k) for k in z_last["counter_keys"]]
                    if "counter_keys" in z_last.files else legacy)
            for k, v in zip(keys, z_last["counters"]):
                if k in db.counters:
                    db.counters[k] = int(v)
        finally:
            for z in zs:
                z.close()
        return db

    @classmethod
    def merge(cls, dbs: Sequence["ContourDB"],
              cfg: Optional[PipelineConfig] = None,
              capacity: Optional[int] = None) -> "ContourDB":
        """Compose several session maps into one frozen serving map: the
        row-wise concatenation of the sessions' rows, on the first DB's
        device. Every merged row is searchable at once (state = [n, n]) and
        the timestamps are restamped to a monotone index, so the result is
        for map serving (`localize_block_async`, `query_async`); streaming
        on into it would conflate the sessions' time axes.
        `session_of_gidx[g]` maps a result row back to (session index,
        original seq)."""
        dbs = [db for db in dbs if db.store is not None and db.n > 0]
        if not dbs:
            raise ValueError("merge: nothing to merge")
        layouts = {tuple((tuple(a.shape[1:]), a.dtype) for a in db.store)
                   for db in dbs}
        if len(layouts) != 1:
            raise ValueError(
                "merge: the sessions' store row layouts differ (built with "
                "different configs); rebuild with one ContourManagerConfig")
        n_total = sum(db.n for db in dbs)
        cap = capacity or n_total
        if cap < n_total:
            raise ValueError("merge: capacity smaller than merged rows")
        out = cls(dbs[0].cfg if cfg is None else cfg, capacity=cap,
                  device=dbs[0].device)
        out._init_store()
        for i, buf in enumerate(out.store):
            buf[:n_total] = torch.cat([db.store[i][:db.n].to(out.device)
                                       for db in dbs])
        out.keys_q = keys_to_q_layout(out.store.keys, out._kq_dtype()) \
            .contiguous()
        out.ts_store[:n_total] = torch.arange(n_total, dtype=torch.float32,
                                              device=out.device)
        out.state = torch.tensor([n_total, n_total], dtype=torch.int32,
                                 device=out.device)
        out.n = n_total
        out.seq_of_gidx = [s for db in dbs for s in db.seq_of_gidx[:db.n]]
        out.ts = [float(t) for t in range(n_total)]
        out.session_of_gidx = [(i, s) for i, db in enumerate(dbs)
                               for s in db.seq_of_gidx[:db.n]]
        return out

    @classmethod
    def from_numpy_state(cls, cfg: PipelineConfig, store, keys_q, ts_store,
                         state, recs_store, n: int, seq_of_gidx,
                         device="cuda") -> "ContourDB":
        """A DB holding another DB's state fetched as numpy (e.g. a JAX
        ContourDB's store, keys_q, ts_store, state and recs_store after
        np.asarray). `keys_q` may be an ml_dtypes bfloat16 array, its uint16
        view, f32, or None (re-derived from store.keys, bit-identical)."""
        db = cls(cfg, capacity=int(np.shape(store.keys)[0]), device=device)
        db.store = scan_desc_from_numpy(store, db.device)
        if keys_q is None:
            db.keys_q = keys_to_q_layout(db.store.keys, db._kq_dtype())
        else:
            kq = np.asarray(keys_q)
            if kq.dtype.name == "bfloat16" or kq.dtype == np.uint16:
                t = torch.from_numpy(kq.view(np.uint16).copy()) \
                    .view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(kq, np.float32))
            db.keys_q = t.to(db._kq_dtype()).to(db.device)
        db.ts_store = torch.from_numpy(
            np.array(ts_store, np.float32)).to(db.device)
        db.state = torch.from_numpy(np.array(state, np.int32)).to(db.device)
        if recs_store is None:
            db.recs_store = torch.zeros((db.capacity, RECORD_WIDTH),
                                        dtype=torch.float32, device=db.device)
        else:
            db.recs_store = torch.from_numpy(
                np.array(recs_store, np.float32)).to(db.device)
        db.n = int(n)
        db.seq_of_gidx = [int(s) for s in seq_of_gidx]
        return db
