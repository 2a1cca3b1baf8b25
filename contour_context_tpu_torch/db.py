"""ContourDB in torch: device-resident descriptor store + the fused scan step.

Port of the main path of `contour_context_tpu/db.py`. Per scan:
descriptor build -> query against the window state before this scan (key
search -> hint cap -> check-1 prefilter -> chunked check cascade -> proposal
merge -> tidy screens -> GMM init + LM refinement -> packed 18-float record)
-> record-ring write -> append -> temporal-window update (the reference's
query -> addScan -> pushAndBalance order, batch_bin_test.cpp:105-238).

The store, its (L, D, capacity*A) bf16 search-layout key copy `keys_q`, the
timestamps, the window state [n, searchable_n] and the record ring all live
on the DB's device; the host keeps a mirror of n for indexing. The query
syncs the host three times per scan in eager torch (the CC fixpoint check,
the cascade chunk count, the merge trip count).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from contour_context_tpu_torch.config import PipelineConfig
from contour_context_tpu_torch.ops.candidate import (
    CandidateState,
    merge_proposals,
    select_topk_stable,
    stable_argsort,
    tidy_candidates,
)
from contour_context_tpu_torch.ops.cascade import (
    P_MAX,
    CascadeResult,
    check_sim_batched,
    run_cascade,
)
from contour_context_tpu_torch.ops.descriptor import build_descriptor
from contour_context_tpu_torch.ops.gmm import (
    GmmScan,
    gmm_from_desc,
    init_correlation,
    optimize_correlation,
)
from contour_context_tpu_torch.ops.kernels import (
    MAX_DIST_SQ,
    TILE,
    masked_key_distances,
    search_tilemin,
)
from contour_context_tpu_torch.types import (
    ScanDesc,
    device_const,
    scan_desc_from_numpy,
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
    L, D, NA = keys_q.shape
    A = q_keys.shape[1]
    dev = keys_q.device
    k = min(nnk, NA)
    kt = min(k, -(-NA // TILE))
    lv = device_const(q_levels, torch.long, dev)
    q = q_keys[lv].to(torch.float32).contiguous()          # (Q, A, D)
    Q = len(q_levels)
    tmin = search_tilemin(keys_q, q_levels, q, state)       # (Q, A, Bt)
    tidx = stable_argsort(tmin)[..., :kt]
    cols = (tidx[..., None] * TILE
            + torch.arange(TILE, device=dev)).reshape(Q, A, kt * TILE)
    kg = keys_q[lv[:, None, None, None],
                torch.arange(D, device=dev)[None, :, None, None],
                cols.clamp(max=NA - 1)[:, None]]            # (Q, D, A, kT)
    vals = masked_key_distances(kg, q, state[1], NA, cols)
    o1 = stable_argsort(cols)
    vals, cols = vals.gather(-1, o1), cols.gather(-1, o1)
    o2 = stable_argsort(vals)[..., :k]
    dist, idx = vals.gather(-1, o2), cols.gather(-1, o2)

    def sq(x):
        return x * x

    k0, k1, k2 = q[..., 0], q[..., 1], q[..., 2]
    ub = (torch.maximum(sq(k0 - k0 * 0.8), sq(k0 - k0 / 0.8))
          + torch.maximum(sq(k1 - k1 * 0.8), sq(k1 - k1 / 0.8))
          + torch.maximum(sq(k2 - k2 * 0.8 * 0.75),
                          sq(k2 - k2 / (0.8 * 0.75))))
    valid = dist < torch.clamp(ub, max=MAX_DIST_SQ)[..., None]
    idx = idx.to(torch.int32)
    return (torch.div(idx, A, rounding_mode="floor"), idx % A, dist, valid)


# ---------------------------------------------------------------------------
# check cascade
# ---------------------------------------------------------------------------

def _anchor12(g):
    return dict(cnt=g[..., 0], eig=g[..., 1:3], h=g[..., 3], comr=g[..., 4])


def check1(store: ScanDesc, query: ScanDesc, gidx, level, seq_src, seq_tgt,
           hint_valid, cont_sim):
    """Check 1 (anchor checkSim) for every hint: the cascade's prefilter
    (db._check1_impl), read from the packed tab12 rows."""
    gi = torch.where(hint_valid, gidx, 0).long()
    li = torch.clamp(level - 1, 0, store.tab12.shape[1] - 1).long()
    js = torch.clamp(seq_src, 0, store.tab12.shape[2] - 1).long()
    jt = torch.clamp(seq_tgt, 0, query.tab12.shape[1] - 1).long()
    s = _anchor12(store.tab12[gi, li, js])
    t = _anchor12(query.tab12[li, jt])
    return hint_valid & check_sim_batched(
        s["cnt"], s["eig"], s["h"], s["comr"],
        t["cnt"], t["eig"], t["h"], t["comr"], cont_sim)


def gather_and_cascade(store: ScanDesc, query: ScanDesc, gidx, level,
                       seq_src, seq_tgt, hint_valid, thres_lb, cont_sim,
                       p_pot=None) -> CascadeResult:
    """Per-hint gathers of the candidate tables + run_cascade
    (db._gather_and_cascade_impl). Indices are clamped explicitly."""
    H = gidx.shape[0]
    gi = torch.where(hint_valid, gidx, 0).long()
    lvl = torch.clamp(level, 0, store.nei_valid.shape[1] - 1).long()
    ss = torch.clamp(seq_src, 0, store.nei_valid.shape[2] - 1).long()
    st = torch.clamp(seq_tgt, 0, query.nei_valid.shape[1] - 1).long()
    names = ("valid", "level", "seq", "bit", "theta")
    src_nei = {k: getattr(store, "nei_" + k)[gi, lvl, ss] for k in names}
    tgt_nei = {k: getattr(query, "nei_" + k)[lvl, st] for k in names}
    src_tab12 = store.tab12[gi]
    li = torch.clamp(level - 1, 0, src_tab12.shape[1] - 1).long()
    js = torch.clamp(seq_src, 0, src_tab12.shape[2] - 1).long()
    jt = torch.clamp(seq_tgt, 0, query.tab12.shape[1] - 1).long()
    src_anchor = _anchor12(src_tab12[torch.arange(H, device=gi.device), li,
                                     js])
    tgt_anchor = _anchor12(query.tab12[li, jt])
    return run_cascade(src_anchor, src_nei, src_tab12, tgt_anchor, tgt_nei,
                       query.tab12, hint_valid, level, seq_src, seq_tgt,
                       thres_lb, cont_sim, p_pot)


def cascade_chunked(store, query, gidx, level, seq_src, seq_tgt, hv, n_valid,
                    thres_lb, cont_sim, chunk: int, p_pot=None
                    ) -> CascadeResult:
    """The cascade over ceil(n_valid / W) chunks of W hint rows
    (db._cascade_chunked; one host sync for the chunk count). Rows are
    independent, so chunking changes no result; rows never run stay zero,
    which downstream reads as non-hints. The last chunk's start is clamped,
    so chunks may overlap and recompute rows identically."""
    HC = gidx.shape[0]
    W = min(chunk, HC) if chunk > 0 else HC
    if W >= HC:
        return gather_and_cascade(store, query, gidx, level, seq_src, seq_tgt,
                                  hv, thres_lb, cont_sim, p_pot)
    n_chunks = -(-HC // W)
    nc = min(-(-int(n_valid) // W), n_chunks)            # host sync
    dev = gidx.device
    b, i32, f32 = torch.bool, torch.int32, torch.float32
    shapes = dict(pass1=((HC,), b), pass2=((HC,), b), pass3=((HC,), b),
                  ovlp_sum=((HC,), i32), ovlp_max_one=((HC,), i32),
                  in_ang_rng=((HC,), i32), i_indiv_sim=((HC,), i32),
                  i_orie_sim=((HC,), i32), pair_valid=((HC, P_MAX), b),
                  pair_level=((HC, P_MAX), i32),
                  pair_seq_src=((HC, P_MAX), i32),
                  pair_seq_tgt=((HC, P_MAX), i32),
                  pair_area_perc=((HC, P_MAX), f32), T_delta=((HC, 3), f32),
                  pot_overflow=((HC,), b), win_overflow=((HC,), b))
    out = CascadeResult(*[torch.zeros(shapes[f][0], dtype=shapes[f][1],
                                      device=dev)
                          for f in CascadeResult._fields])
    for i in range(nc):
        s0 = min(i * W, HC - W)
        sl = slice(s0, s0 + W)
        r = gather_and_cascade(store, query, gidx[sl], level[sl],
                               seq_src[sl], seq_tgt[sl], hv[sl], thres_lb,
                               cont_sim, p_pot)
        for dst, src in zip(out, r):
            dst[sl] = src
    return out


def gather_gmm(store: ScanDesc, gidx, levels: Tuple[int, ...],
               max_k: int) -> GmmScan:
    """Candidate GmmScans: one row of the packed gmm_pack table each."""
    G, K = len(levels), max_k
    if store.gmm_pack.shape[-1] != G * K * 8:
        raise ValueError("gmm_pack was built with a different GMMOptConfig")
    C = gidx.shape[0]
    rows = store.gmm_pack[gidx].reshape(C, G, K, 8)
    return GmmScan(mus=rows[..., 0:2],
                   covs=rows[..., 2:6].reshape(C, G, K, 2, 2),
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
    """What the query holds before the GMM stage (tests compare it)."""
    n_valid: torch.Tensor         # () int32 valid key hits
    overflow_hints: torch.Tensor  # () int32
    aft1: torch.Tensor            # () int32 check-1 survivors
    gidx: torch.Tensor            # (HC,) hint rows as fed to the cascade
    res: CascadeResult
    st: CandidateState


def query_stages(store: ScanDesc, keys_q, query: ScanDesc, state,
                 cfg: PipelineConfig) -> QueryStages:
    """Search -> hint cap -> check-1 prefilter -> chunked cascade -> merge
    (the first half of db._query_step_impl)."""
    dev = keys_q.device
    i32, f32 = torch.int32, torch.float32
    q_levels = tuple(cfg.db.q_levels)
    gidx, seq_src, dist, valid = search(keys_q, query.keys, state, q_levels,
                                        cfg.db.nnk)
    Q, A, K = gidx.shape
    lv = device_const(q_levels, i32, dev)
    level_f = lv[:, None, None].expand(Q, A, K).reshape(-1)
    seq_tgt_f = torch.arange(A, dtype=i32, device=dev)[None, :, None] \
        .expand(Q, A, K).reshape(-1)
    gidx_f, seq_src_f = gidx.reshape(-1), seq_src.reshape(-1)

    HC = min(cfg.db.max_check_cands, Q * A * K)
    perm, hv, n_valid, overflow_hints = select_topk_stable(
        dist.reshape(-1), valid.reshape(-1), HC)
    g_h, l_h = gidx_f[perm], level_f[perm]
    ss_h, st_h = seq_src_f[perm], seq_tgt_f[perm]

    chunkw = cfg.db.cascade_chunk
    if cfg.db.check1_prefilter and 0 < chunkw < HC:
        pass1_all = check1(store, query, g_h, l_h, ss_h, st_h, hv,
                           cfg.db.cont_sim)
        aft1 = pass1_all.sum().to(i32)
        pos = torch.arange(HC, dtype=f32, device=dev)
        perm2, hv_run, n_run, _ = select_topk_stable(pos, pass1_all, HC)
        g_h, l_h = g_h[perm2], l_h[perm2]
        ss_h, st_h = ss_h[perm2], st_h[perm2]
    else:
        aft1 = None
        hv_run, n_run = hv, n_valid
    res = cascade_chunked(store, query, g_h, l_h, ss_h, st_h, hv_run, n_run,
                          cfg.thres_lb, cfg.db.cont_sim, chunkw, cfg.db.p_pot)
    if aft1 is None:
        aft1 = res.pass1.sum().to(i32)

    st = merge_proposals(
        res.pass3, g_h, res.T_delta, res.pair_valid, res.pair_level,
        res.pair_seq_src, res.pair_seq_tgt, res.pair_area_perc,
        n_cand_max=cfg.db.max_cand_poses, n_pass_max=cfg.db.max_pass_hints)
    return QueryStages(n_valid=n_valid, overflow_hints=overflow_hints,
                       aft1=aft1, gidx=g_h, res=res, st=st)


class RefineInputs(NamedTuple):
    """The query just before the LM refinement (tests and the smoke replay
    the refinement from it)."""
    qs: QueryStages
    cand_gidx: torch.Tensor   # (C,) int32 candidate scans
    src: GmmScan              # the F best candidates' GMMs, (F, G, K, ...)
    tgt: GmmScan              # the query's GMM
    T0: torch.Tensor          # (F, 3) f32 starting poses
    sel: torch.Tensor         # (F, G, K, K) bool close pairs at T0
    topi: torch.Tensor        # (F,) rows of the candidate table
    valid: torch.Tensor       # (F,) bool: a live candidate above the gate


def refine_inputs(store: ScanDesc, keys_q, query: ScanDesc, state,
                  cfg: PipelineConfig) -> RefineInputs:
    """query_stages -> tidy screens -> GMM init correlation -> the F =
    max_fine_opt best candidates (db._query_step_impl up to its LM)."""
    N = store.keys.shape[0]
    qs = query_stages(store, keys_q, query, state, cfg)
    st = qs.st
    post = cfg.thres_lb.sim_post
    tidy = tidy_candidates(st, post.area_perc, post.neg_est_dist,
                           cfg.cm.n_row, cfg.cm.n_col, cfg.cm.reso_row,
                           cfg.cm.reso_col)

    cg = torch.clamp(st.cand_gidx, 0, N - 1).long()
    src_gmm = gather_gmm(store, cg, tuple(cfg.gmm.levels),
                         cfg.gmm.max_gmm_ellipses)
    tgt_gmm = gmm_from_desc(query, cfg.gmm)
    corr0, selp = init_correlation(src_gmm, tgt_gmm, tidy.T_sel,
                                   scale=cfg.gmm.cov_dilate_scale)
    keep = tidy.alive & (corr0 >= post.correlation)

    C = st.cand_gidx.shape[0]
    F = min(cfg.db.max_fine_opt, C)
    rank = torch.where(keep, corr0, -math.inf)
    topi = stable_argsort(rank, descending=True)[:F]
    return RefineInputs(qs=qs, cand_gidx=st.cand_gidx,
                        src=GmmScan(*[x[topi] for x in src_gmm]),
                        tgt=tgt_gmm, T0=tidy.T_sel[topi], sel=selp[topi],
                        topi=topi, valid=torch.isfinite(rank[topi]))


def query_step(store: ScanDesc, keys_q, query: ScanDesc, state,
               cfg: PipelineConfig):
    """queryRangedKNN (contour_db.h:698-811) = db._query_step_impl without
    the stage-split `depth` gates. Returns the packed (18,) f32 record."""
    f32 = torch.float32
    r = refine_inputs(store, keys_q, query, state, cfg)
    qs = r.qs
    res, st = qs.res, qs.st
    corr_f, T_f = optimize_correlation(r.src, r.tgt, r.T0, r.sel,
                                       scale=cfg.gmm.cov_dilate_scale,
                                       iters=cfg.gmm.gn_iters)
    corr_fm = torch.where(r.valid, corr_f, -math.inf)
    # a (1,) index, not a 0-d one: indexing with a 0-d tensor reads it on
    # the host
    best = torch.argmax(corr_fm).reshape(1)
    found = r.valid.any()

    def f(x):
        return x.to(f32).reshape(1)

    return torch.cat([
        f(found), f(torch.where(found, r.cand_gidx[r.topi[best]], -1)),
        f(torch.where(found, corr_fm[best], 0.0)), T_f[best].reshape(3),
        f(qs.n_valid), f(qs.aft1), f(res.pass2.sum()), f(res.pass3.sum()),
        f(st.n_cand), f(qs.overflow_hints), f(st.overflow_pass),
        f(st.overflow_cand), f((res.pot_overflow & res.pass1).sum()),
        f((res.win_overflow & res.pass1).sum()), f(query.pix_overflow),
        f(query.gmm_overflow)])


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


# ---------------------------------------------------------------------------
# handles and the DB
# ---------------------------------------------------------------------------

class QueryHandle:
    """A scan's record, still on the device in the DB's record ring."""

    __slots__ = ("row", "_db", "_host")

    def __init__(self, db: "ContourDB", row: int):
        self.row = row
        self._db = db
        self._host: Optional[QueryRecord] = None

    def record(self) -> QueryRecord:
        if self._host is None:
            self._db.drain([self])
        return self._host

    def get(self) -> Optional[Tuple[int, float, np.ndarray]]:
        rec = self.record()
        return (rec.gidx, rec.corr, rec.T) if rec.found else None


class ContourDB:
    """Top-level database (reference ContourDB, contour_db.h:658-845) on an
    explicit torch device. A CUDA device without CUDA raises."""

    def __init__(self, cfg: PipelineConfig, capacity: int = 8192,
                 device="cuda"):
        if cfg.db.dynamic_thres:
            raise NotImplementedError(
                "dynamic_thres is not ported yet (ROADMAP Queue 1)")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("ContourDB(device='cuda'): CUDA is not "
                                   "available")
            if torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError("TF32 matmuls must stay off: the contour "
                                   "moments need full float32")
        self.cfg = cfg
        self.capacity = capacity
        self.n = 0
        self.store: Optional[ScanDesc] = None
        self.keys_q = None
        self.ts_store = None
        self.state = None
        self.recs_store = None
        self.seq_of_gidx: List[int] = []
        self.counters = dict(n_hints=0, cand_aft_check1=0, cand_aft_check2=0,
                             cand_aft_check3=0, overflow_hints=0,
                             overflow_pass=0, overflow_cand=0,
                             overflow_pot=0, overflow_win=0, overflow_pix=0,
                             overflow_gmm=0)

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

    def _append(self, desc: ScanDesc, ts) -> None:
        """Write desc at row n (db._append_impl): every store leaf, the
        (L, D, A) column block of keys_q (rounded to bf16 when keys_bf16),
        the timestamp, and n += 1 on the device."""
        n = self.n
        for buf, x in zip(self.store, desc):
            buf[n] = x
        A = desc.keys.shape[1]
        self.keys_q[:, :, n * A:(n + 1) * A] = \
            desc.keys.permute(0, 2, 1).to(self.keys_q.dtype)
        self.ts_store[n] = ts
        self.state[0] += 1
        self.n += 1

    def step_async(self, points, seq: int, ts) -> QueryHandle:
        """One scan: build -> query (window state before this scan) ->
        record-ring write -> append -> window update. `points` is the
        (max_points, 4) f32 or int16 q16 payload, `ts` a float or a 0-d
        tensor. The record stays on the device until `drain`."""
        if self.store is None:
            self._init_store()
        if self.n + 1 > self.capacity:
            self._grow(max(2 * self.capacity, self.n + 1))
        pts = torch.as_tensor(points).to(self.device)
        if isinstance(ts, torch.Tensor):
            ts_t = ts.to(self.device, torch.float32)
        else:   # a fill kernel, not a host-to-device copy
            ts_t = torch.full((), float(ts), dtype=torch.float32,
                              device=self.device)
        desc = build_descriptor(pts, self.cfg.cm, self.cfg.gmm)
        rec = query_step(self.store, self.keys_q, desc, self.state, self.cfg)
        row = self.n
        self.recs_store[row] = rec
        self._append(desc, ts_t)
        tb = self.cfg.db.tb
        update_window(self.state, self.ts_store, ts_t, tb.min_elapse,
                      tb.max_elapse)
        self.seq_of_gidx.append(int(seq))
        return QueryHandle(self, row)

    def step_chain_async(self, points_k, seqs, ts_k) -> List[QueryHandle]:
        """K sequential steps; exact per-scan semantics at any spacing."""
        return [self.step_async(points_k[i], s, ts_k[i])
                for i, s in enumerate(seqs)]

    def drain(self, handles) -> list:
        """Fetch the records of `handles` with one copy of the record ring;
        accumulates the counters once per record. Returns per-handle None
        or (gidx, corr, T3)."""
        live = [h for h in handles if h is not None and h._host is None]
        if live:
            ring = self.recs_store.cpu().numpy()
            for h in live:
                rec = unpack_record(ring[h.row])
                h._host = rec
                self._accumulate(rec)
        return [None if h is None else h.get() for h in handles]

    def _accumulate(self, rec: QueryRecord) -> None:
        c = self.counters
        c["n_hints"] += rec.n_hints
        c["cand_aft_check1"] += rec.aft1
        c["cand_aft_check2"] += rec.aft2
        c["cand_aft_check3"] += rec.aft3
        for k in ("overflow_hints", "overflow_pass", "overflow_cand",
                  "overflow_pot", "overflow_win", "overflow_pix",
                  "overflow_gmm"):
            c[k] += getattr(rec, k)

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
