"""The port's query path and store updates as plain torch, frozen for the
benchmark's reference: the key search, hint cap, check 1, the chunked
cascade, the proposal merge, the tidy screens, the GMM init and LM, and
the packed 18-float record; the append of rows at state[0] and the
window update (pushAndBalance). `PlainStore` holds a store the way the
port's ContourDB does, and runs the stream's and a map's steps eagerly.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from plainref.config import PipelineConfig
from plainref.candidate import (
    CandidateState,
    dynamic_pass_scan,
    dynamic_post_scan,
    merge_proposals,
    select_topk_stable,
    stable_argsort,
    take_rows,
    tidy_candidates,
)
from plainref.cascade import (
    P_MAX,
    CascadeResult,
    check_sim_batched,
    run_cascade,
)
from plainref.gmm import (
    GmmScan,
    gmm_from_desc,
    init_correlation,
    optimize_correlation,
)
from plainref.kernels import (
    MAX_DIST_SQ,
    TILE,
    masked_key_distances,
    search_tilemin,
    search_tilemin_batch,
)
from plainref.types import (
    ScanDesc,
    device_const,
    scan_desc_spec,
)

RECORD_WIDTH = 18


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
    """Per-hint gathers of the candidate tables + run_cascade
    (db._gather_and_cascade_impl) over H flat hint rows: `query` is a
    B-stacked ScanDesc and tgt_q (H,) names the query of each row. Indices
    are clamped explicitly."""
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
    B-stacked) in chunks of W hint columns (db._cascade_chunked): chunk i
    runs columns [s0, s0 + W) of every query at once as B*W flat rows.
    Every one of the ceil(HC / W) chunks runs, so the chunk count needs no
    host sync (JAX's while_loop stops at the busiest query's ceil(n_valid /
    W), a device scalar); then every query's columns past its own
    ceil(n_valid / W) * W are zeroed, which is what JAX leaves there (its
    zero init) and downstream reads as non-hints. Rows are independent, so
    neither chunking nor batching changes a result. The last chunk's start
    is clamped, so chunks may overlap and recompute rows identically."""
    B, HC = gidx.shape
    W = min(chunk, HC) if chunk > 0 else HC
    dev = gidx.device

    def run(s0, w):
        tgt_q = torch.arange(B, device=dev).repeat_interleave(w)
        flat = [x[:, s0:s0 + w].reshape(-1)
                for x in (gidx, level, seq_src, seq_tgt, hv)]
        r = gather_and_cascade(store, query, tgt_q, *flat, thres_lb, cont_sim,
                               p_pot)
        return CascadeResult(*[x.reshape((B, w) + x.shape[1:]) for x in r])

    if W >= HC:
        return run(0, HC)
    n_chunks = -(-HC // W)
    b, i32, f32 = torch.bool, torch.int32, torch.float32
    shapes = dict(pass1=((), b), pass2=((), b), pass3=((), b),
                  ovlp_sum=((), i32), ovlp_max_one=((), i32),
                  in_ang_rng=((), i32), i_indiv_sim=((), i32),
                  i_orie_sim=((), i32), pair_valid=((P_MAX,), b),
                  pair_level=((P_MAX,), i32), pair_seq_src=((P_MAX,), i32),
                  pair_seq_tgt=((P_MAX,), i32),
                  pair_area_perc=((P_MAX,), f32), T_delta=((3,), f32),
                  pot_overflow=((), b), win_overflow=((), b))
    out = CascadeResult(*[torch.zeros((B, HC) + shapes[f][0],
                                      dtype=shapes[f][1], device=dev)
                          for f in CascadeResult._fields])
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
    hits = search_batch(keys_q, descs.keys, searchable_b,
                        tuple(cfg.db.q_levels), cfg.db.nnk)
    return query_from_hits(store, descs, hits, cfg, depth)


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
# a store as the port's ContourDB holds it
# ---------------------------------------------------------------------------

class PlainStore:
    """The store, its (L, D, capacity*A) search-layout keys, the float32
    timestamps and the window state [n, searchable_n] on `device`, laid
    out and updated as the port's ContourDB does, every step eagerly."""

    def __init__(self, cfg: PipelineConfig, capacity: int, device):
        self.cfg, self.capacity = cfg, capacity
        self.device = torch.device(device)
        spec = scan_desc_spec(cfg.cm, cfg.gmm)
        self.store = ScanDesc(**{
            k: torch.zeros((capacity,) + shape, dtype=dt, device=self.device)
            for k, (shape, dt) in spec.items()})
        L, A, D = spec["keys"][0]
        kq = torch.bfloat16 if cfg.cm.keys_bf16 else torch.float32
        self.keys_q = torch.zeros((L, D, capacity * A), dtype=kq,
                                  device=self.device)
        self.ts_store = torch.zeros((capacity,), dtype=torch.float32,
                                    device=self.device)
        self.state = torch.zeros((2,), dtype=torch.int32, device=self.device)

    def _ts(self, ts) -> torch.Tensor:
        """Host float64 timestamps as the port stores them: float32."""
        return torch.from_numpy(np.asarray(ts, np.float64).reshape(-1)
                                .astype(np.float32)).to(self.device)

    def append(self, descs: ScanDesc, ts) -> None:
        """B-stacked descs at rows state[0].. (ContourDB._append_rows)."""
        ts_b = self._ts(ts)
        B = ts_b.shape[0]
        if int(self.state[0]) + B > self.capacity:
            raise ValueError("PlainStore: capacity exceeded")
        rows = self.state[:1].long() + torch.arange(B, device=self.device)
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

    def push(self, ts: float) -> None:
        """pushAndBalance at host timestamp `ts` (ContourDB._push)."""
        tb = self.cfg.db.tb
        update_window(self.state, self.ts_store,
                      torch.full((), float(ts), dtype=torch.float32,
                                 device=self.device),
                      tb.min_elapse, tb.max_elapse)

    def block_append(self, descs: ScanDesc, ts):
        """A block's append and window pushes
        (ContourDB._block_append): each query's searchable_n."""
        self.append(descs, ts)
        tb = self.cfg.db.tb
        return replay_window(self.state, self.ts_store, self._ts(ts),
                             tb.min_elapse, tb.max_elapse)

    def query(self, desc: ScanDesc):
        """One query (a 1-stacked ScanDesc) at the window state: the
        (18,) record (the step's `query_step`)."""
        return query_step(self.store, self.keys_q,
                          ScanDesc(*[x[0] for x in desc]), self.state,
                          self.cfg)

    def query_batch(self, descs: ScanDesc):
        """B queries at the searchable prefix: (B, 18) records (a serving
        chunk's `query_step_batch`)."""
        B = descs.keys.shape[0]
        return query_step_batch(self.store, self.keys_q, descs,
                                self.state[1].expand(B).contiguous(),
                                self.cfg)

    def freeze(self) -> None:
        """A frozen serving map, as ContourDB.merge leaves one: every row
        searchable, timestamps restamped to the row index."""
        n = int(self.state[0])
        self.ts_store[:n] = torch.arange(n, dtype=torch.float32,
                                         device=self.device)
        self.state[1] = n
