"""Frozen for the benchmark's reference: a copy of the port's
`contour_context_tpu_torch/ops/candidate.py`, importing nothing of the port (its
kernels are `plainref.kernels`' plain twins). Its own notes follow.

On-device CandidateManager: proposal merge + tidy screens, in torch.

Port of `contour_context_tpu/ops/candidate.py` (the fixed-shape replica of
the reference's addProposal and the first two tidyUpCandidates screens,
contour_db.h:286-338, :494-545). Candidate poses are rows keyed by scan index
in first-seen order; each row holds up to 4 proposals, and every proposal a
dense (level, seq_src, seq_tgt) constellation-pair map with first-insert-wins
percentages.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from plainref.config import DIST_BIN_LAYERS, LAYER_AREA_WEIGHTS
from plainref.kernels import (P_PROP, TF_ANG_MERGE, TF_TRANS_MERGE,
                              dyn_pass_scan, dyn_post_scan, merge_hints)
from plainref.types import device_const

N_LEV = 6
N_SEQ = 10
NUM_SLOTS = N_LEV * N_SEQ * N_SEQ


class CandidateState(NamedTuple):
    """One query's candidate table; `merge_proposals` returns B of them
    stacked, every leaf with a leading B axis."""
    cand_gidx: torch.Tensor    # (C,) int32, -1 when empty; first-seen order
    n_cand: torch.Tensor       # () int32
    prop_n: torch.Tensor       # (C,) int32 proposals in use
    prop_T: torch.Tensor       # (C, 4, 3) f32 (x, y, theta)
    prop_votes: torch.Tensor   # (C, 4) int32
    prop_taken: torch.Tensor   # (C, 4, NUM_SLOTS) bool
    prop_perc: torch.Tensor    # (C, 4, NUM_SLOTS) f32
    overflow_cand: torch.Tensor  # () int32
    overflow_pass: torch.Tensor  # () int32


def stable_argsort(x, dim: int = -1, descending: bool = False):
    """Stable argsort; float keys get +0.0 first so -0.0 and +0.0 tie (a
    radix sort would order them by bits)."""
    if x.is_floating_point():
        x = x + 0.0
    return torch.sort(x, dim=dim, stable=True, descending=descending).indices


def select_topk_stable(priority, mask, cap: int):
    """Budget-capped stable selection along the last dim (candidate.py:51-67),
    independently for every leading index: all masked items in input order
    when they fit `cap`, else the `cap` best by ascending priority (ties by
    position), in input order. `priority` broadcasts against `mask`.
    Returns (perm (..., cap), sel_at_perm (..., cap), n_masked (...),
    overflow (...))."""
    n = mask.shape[-1]
    order = stable_argsort(torch.where(mask, priority, math.inf))
    iota = torch.arange(n, dtype=torch.int32, device=mask.device)
    rank = torch.empty(mask.shape, dtype=torch.int32, device=mask.device) \
        .scatter_(-1, order, iota.expand(mask.shape))
    sel = mask & (rank < cap)
    perm = stable_argsort((~sel).to(torch.uint8))[..., :cap]
    n_masked = mask.sum(dim=-1).to(torch.int32)
    overflow = torch.clamp(n_masked - cap, min=0).to(torch.int32)
    return perm, sel.gather(-1, perm), n_masked, overflow


def take_rows(x, idx):
    """x (B, N, ...), idx (B, M) -> (B, M, ...): row idx[b, m] of x[b], as
    one gather."""
    tail = x.shape[2:]
    return x.gather(1, idx.reshape(idx.shape + (1,) * len(tail))
                    .expand(idx.shape + tail))


def _dense_pair_maps_rows(pair_valid, pair_level, pair_seq_src, pair_seq_tgt,
                          pair_perc):
    """(..., P) pair lists -> dense (..., NUM_SLOTS) perc/taken maps; a
    duplicate slot keeps its FIRST pair's perc (setdefault). The first pair
    of a slot is the minimum pair position scattered to it (order-free, so
    exact on any device); its perc is then one gather."""
    P = pair_valid.shape[-1]
    dev = pair_valid.device
    ids = pair_level * (N_SEQ * N_SEQ) + pair_seq_src * N_SEQ + pair_seq_tgt
    ids = torch.where(pair_valid & (ids >= 0) & (ids < NUM_SLOTS), ids,
                      NUM_SLOTS).long()
    pos = torch.arange(P, dtype=torch.int32, device=dev).expand(ids.shape)
    first_pos = torch.full(ids.shape[:-1] + (NUM_SLOTS + 1,), P,
                           dtype=torch.int32, device=dev) \
        .scatter_reduce_(-1, ids, pos, "amin")[..., :NUM_SLOTS]
    taken = first_pos < P
    perc = torch.where(
        taken, pair_perc.gather(-1, first_pos.clamp(max=P - 1).long()), 0.0)
    return perc, taken


class _HintRows(NamedTuple):
    """The passing hints of B queries assigned to candidate rows."""
    perm: torch.Tensor           # (B, MP) the MP hints kept, in input order
    before: torch.Tensor         # (MP, MP) [m, m']: m' before m
    hint_of: torch.Tensor        # (B, C, MP) hint arriving j-th at row c
    T: torch.Tensor              # (B, MP, 3) the hints' poses
    votes: torch.Tensor          # (B, MP) their pair counts
    cand_gidx: torch.Tensor
    n_cand: torch.Tensor
    overflow_cand: torch.Tensor
    overflow_pass: torch.Tensor


def _hint_rows(pass3, gidx, T_delta, pair_valid, C: int,
               n_pass_max: int) -> _HintRows:
    dev = pass3.device
    B, H = pass3.shape
    MP = min(n_pass_max, H)
    i32, f32 = torch.int32, torch.float32

    votes_h = pair_valid.sum(dim=-1).to(i32)
    perm, _, n_pass, overflow_pass = select_topk_stable(
        -votes_h.to(f32), pass3, MP)
    g = gidx.gather(1, perm).to(i32)
    T = take_rows(T_delta, perm)
    votes = votes_h.gather(1, perm)
    iota = torch.arange(MP, dtype=i32, device=dev)
    live = iota < torch.clamp(n_pass, max=MP)[:, None]          # (B, MP)
    before = iota[None, :] < iota[:, None]          # [m, m']: m' before m

    # candidate row of each hint = first-seen rank of its gidx
    same = (g[:, :, None] == g[:, None, :]) & live[:, :, None] \
        & live[:, None, :]
    first_m = torch.where(same, iota, MP).amin(dim=-1)
    is_first_m = live & (first_m == iota)
    rank_at_m = torch.cumsum(is_first_m.to(i32), 1).to(i32) - 1
    cidx_h = rank_at_m.gather(1, first_m.clamp(max=MP - 1).long())
    drop_h = live & (cidx_h >= C)
    overflow_cand = drop_h.sum(dim=1).to(i32)
    keep_h = live & ~drop_h
    n_cand = torch.clamp(is_first_m.sum(dim=1), max=C).to(i32)
    cand_gidx = torch.full((B, C + 1), -1, dtype=i32, device=dev).scatter_(
        1, torch.where(is_first_m & (rank_at_m < C), rank_at_m, C).long(),
        g)[:, :C]
    # arrival order j of a hint within its row
    j_h = (same & before).sum(dim=-1).to(i32)
    hint_of = torch.full((B, (C + 1) * MP), -1, dtype=i32, device=dev) \
        .scatter_(1, (torch.where(keep_h, cidx_h, C) * MP + j_h).long(),
                  iota.expand(B, MP)).view(B, C + 1, MP)[:, :C].contiguous()
    return _HintRows(perm, before, hint_of, T, votes, cand_gidx, n_cand,
                     overflow_cand, overflow_pass)


def merge_inputs(pass3, gidx, T_delta, pair_valid, n_cand_max: int = 32,
                 n_pass_max: int = 64):
    """(hint_of (B, C, MP), T (B, MP, 3), votes (B, MP)): what
    `merge_proposals` hands `kernels.merge_hints` for these cascade
    outputs (the kernel's inputs at the path's own shapes)."""
    r = _hint_rows(pass3, gidx, T_delta, pair_valid, n_cand_max, n_pass_max)
    return r.hint_of, r.T, r.votes


def merge_proposals(pass3, gidx, T_delta, pair_valid, pair_level,
                    pair_seq_src, pair_seq_tgt, pair_perc,
                    n_cand_max: int = 32, n_pass_max: int = 64
                    ) -> CandidateState:
    """Merge the passing hints' proposals of B queries at once: every input
    has a leading B axis (pass3 (B, H), pair_* (B, H, P), ...), and so has
    every leaf of the result. Per query it is identical to addProposal
    applied hint by hint in input order (candidate.py:95-287). Hints of
    different candidate rows never interact, so the addProposal loop is
    `kernels.merge_hints`: one launch on the card (a thread a row, the trip
    count read on the device), the plain loop over the j-th hint of every
    row at once on the CPU; the pair unions are order-free given the hint ->
    (row, proposal) assignment. Index writes that must go nowhere land in a
    dump slot of the query's own."""
    dev = pass3.device
    B = pass3.shape[0]
    C = n_cand_max
    f32 = torch.float32
    r = _hint_rows(pass3, gidx, T_delta, pair_valid, C, n_pass_max)
    perm, before = r.perm, r.before
    prop_T, prop_votes, prop_n, key_of_m = merge_hints(r.hint_of, r.T,
                                                       r.votes)

    # constellation unions: per (row, proposal) key, taken = OR over its
    # hints, perc = the perc of the first hint (in m order) taking the slot
    NK = C * P_PROP
    key_m = torch.where(key_of_m >= 0, key_of_m, NK).long()
    dperc, dtaken = _dense_pair_maps_rows(
        take_rows(pair_valid, perm), take_rows(pair_level, perm),
        take_rows(pair_seq_src, perm), take_rows(pair_seq_tgt, perm),
        take_rows(pair_perc, perm))                       # (B, MP, SLOTS)
    earlier = (key_m[:, :, None] == key_m[:, None, :]) & before
    # 0/1 values: the product is exact in any summation order
    taken_before = torch.bmm(earlier.to(f32), dtaken.to(f32)) > 0.5
    is_first = dtaken & ~taken_before
    # one accumulator row per (query, key) and a dump row per query; a slot
    # of perc_u receives one non-zero perc and zeros, so the sum is exact
    # whatever order the device adds in
    flat = (key_m + torch.arange(B, device=dev)[:, None] * (NK + 1)) \
        .reshape(-1)
    taken_u = torch.zeros((B * (NK + 1), NUM_SLOTS), dtype=f32, device=dev)
    taken_u.index_add_(0, flat, dtaken.to(f32).reshape(-1, NUM_SLOTS))
    perc_u = torch.zeros((B * (NK + 1), NUM_SLOTS), dtype=f32, device=dev)
    perc_u.index_add_(0, flat, torch.where(is_first, dperc, 0.0)
                      .reshape(-1, NUM_SLOTS))

    def rows_of(u):
        return u.view(B, NK + 1, NUM_SLOTS)[:, :NK] \
            .reshape(B, C, P_PROP, NUM_SLOTS)

    return CandidateState(
        cand_gidx=r.cand_gidx, n_cand=r.n_cand, prop_n=prop_n, prop_T=prop_T,
        prop_votes=prop_votes, prop_taken=rows_of(taken_u) > 0.5,
        prop_perc=rows_of(perc_u), overflow_cand=r.overflow_cand,
        overflow_pass=r.overflow_pass)


def dynamic_pass_scan(pass1, ovlp_sum, ovlp_max1, in_ang, indiv, orie,
                      lb, ub):
    """DYNAMIC_THRES re-gating of the check cascade (contour_db.h:439-458;
    candidate.py:290-319): hints are re-gated in order along the last dim,
    and each full pass raises the five working count bars to that hint's
    final pair count, clamped by the upper-bound ensemble. Every leading
    index (the B queries of a block) advances on its own. On the device
    with no host sync: the `dyn_pass_scan` kernel on a CUDA device, its
    plain version on the CPU. Returns (pass2, pass3) under the dynamic
    bars."""
    lbv = (lb.sim_constell.i_ovlp_sum, lb.sim_constell.i_ovlp_max_one,
           lb.sim_constell.i_in_ang_rng, lb.sim_pair.i_indiv_sim,
           lb.sim_pair.i_orie_sim)
    ubv = (ub.sim_constell.i_ovlp_sum, ub.sim_constell.i_ovlp_max_one,
           ub.sim_constell.i_in_ang_rng, ub.sim_pair.i_indiv_sim,
           ub.sim_pair.i_orie_sim)
    return dyn_pass_scan(pass1, ovlp_sum, ovlp_max1, in_ang, indiv, orie,
                         lbv, ubv)


def dynamic_post_scan(in_use, area, neg_d, corr0, lb_post, ub_post):
    """DYNAMIC_THRES post-processing screens (contour_db.h:532-574;
    candidate.py:322-344): candidates are screened in first-seen order along
    the last dim, and each one passing all three screens (area %, distance
    censor, init correlation) raises the working bars to its own scores,
    clamped by the upper bounds, in float32 (min, max and >= round
    nothing). On the device like `dynamic_pass_scan` (the `dyn_post_scan`
    kernel). Returns the keep mask."""
    return dyn_post_scan(
        in_use, area, neg_d, corr0,
        (lb_post.area_perc, lb_post.neg_est_dist, lb_post.correlation),
        (ub_post.area_perc, ub_post.neg_est_dist, ub_post.correlation))


def _area_weights(device) -> torch.Tensor:
    """(NUM_SLOTS,) LAYER_AREA_WEIGHTS of each dense slot's level."""
    w = [0.0] * N_LEV
    for j, lev in enumerate(DIST_BIN_LAYERS):
        w[lev] = LAYER_AREA_WEIGHTS[j]
    per_slot = tuple(w[s // (N_SEQ * N_SEQ)] for s in range(NUM_SLOTS))
    return device_const(per_slot, torch.float32, device)


class TidyResult(NamedTuple):
    alive: torch.Tensor
    in_use: torch.Tensor
    T_sel: torch.Tensor
    area: torch.Tensor
    neg_d: torch.Tensor
    votes: torch.Tensor
    sel: torch.Tensor


def tidy_candidates(st: CandidateState, area_perc_lb: float,
                    neg_est_dist_lb: float, n_row: int, n_col: int,
                    reso_row: float, reso_col: float) -> TidyResult:
    """Screens 1-2 of tidyUpCandidates (candidate.py:366-399) on a
    CandidateState with a leading B axis; every leaf of the result has it
    too. The area is a product and a sum along the slot dim, so a row's
    summation order does not depend on how many rows there are."""
    dev = st.cand_gidx.device
    C = st.cand_gidx.shape[-1]
    prop_use = torch.arange(P_PROP, device=dev) < st.prop_n[..., None]
    votes_m = torch.where(prop_use, st.prop_votes, -1)
    sel = torch.argmax(votes_m, dim=-1)
    pick = sel[..., None]
    area_all = (torch.where(st.prop_taken, st.prop_perc, 0.0)
                * _area_weights(dev)).sum(dim=-1)
    area = area_all.gather(-1, pick)[..., 0]
    T_sel = st.prop_T.gather(
        -2, pick[..., None].expand(pick.shape + (3,)))[..., 0, :]
    votes = st.prop_votes.gather(-1, pick)[..., 0]
    ox = n_row / 2 - 0.5
    oy = n_col / 2 - 0.5
    c, s = torch.cos(T_sel[..., 2]), torch.sin(T_sel[..., 2])
    tx = c * ox - s * oy + T_sel[..., 0] - ox
    ty = s * ox + c * oy + T_sel[..., 1] - oy
    neg_d = -torch.hypot(tx * reso_row, ty * reso_col)
    in_use = (torch.arange(C, device=dev) < st.n_cand[..., None]) \
        & (st.prop_n > 0)
    alive = in_use & (area >= area_perc_lb) & (neg_d >= neg_est_dist_lb)
    return TidyResult(alive=alive, in_use=in_use, T_sel=T_sel, area=area,
                      neg_d=neg_d, votes=votes, sel=sel)
