"""On-device CandidateManager: proposal merge + tidy screens, in torch.

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

from contour_context_tpu_torch.config import DIST_BIN_LAYERS, LAYER_AREA_WEIGHTS
from contour_context_tpu_torch.ops.cascade import clamp_ang
from contour_context_tpu_torch.types import device_const

P_PROP = 4
N_LEV = 6
N_SEQ = 10
NUM_SLOTS = N_LEV * N_SEQ * N_SEQ
TF_TRANS_MERGE = 2.0
TF_ANG_MERGE = 0.3


class CandidateState(NamedTuple):
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
    """Budget-capped stable selection (candidate.py:51-67): all masked items
    in input order when they fit `cap`, else the `cap` best by ascending
    priority (ties by position), in input order. Returns (perm,
    sel_at_perm, n_masked, overflow)."""
    n = mask.shape[0]
    order = stable_argsort(torch.where(mask, priority, math.inf))
    rank = torch.empty(n, dtype=torch.int32, device=mask.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=mask.device)
    sel = mask & (rank < cap)
    perm = stable_argsort((~sel).to(torch.uint8))[:cap]
    n_masked = mask.sum().to(torch.int32)
    overflow = torch.clamp(n_masked - cap, min=0).to(torch.int32)
    return perm, sel[perm], n_masked, overflow


def _dense_pair_maps_rows(pair_valid, pair_level, pair_seq_src, pair_seq_tgt,
                          pair_perc):
    """(MP, P) pair lists -> dense (MP, NUM_SLOTS) perc/taken maps; a
    duplicate slot keeps its FIRST pair's perc (setdefault)."""
    MP, P = pair_valid.shape
    dev = pair_valid.device
    ids = torch.where(
        pair_valid,
        pair_level * (N_SEQ * N_SEQ) + pair_seq_src * N_SEQ + pair_seq_tgt,
        NUM_SLOTS)
    hit = ids[:, :, None] == torch.arange(NUM_SLOTS, device=dev)[None, None]
    taken = hit.any(dim=1)
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None, :, None]
    first_pos = torch.where(hit, pos, P).amin(dim=1)
    is_first = hit & (pos == first_pos[:, None, :])
    perc = torch.where(is_first, pair_perc[:, :, None], 0.0).sum(dim=1)
    return perc, taken


def merge_proposals(pass3, gidx, T_delta, pair_valid, pair_level,
                    pair_seq_src, pair_seq_tgt, pair_perc,
                    n_cand_max: int = 32, n_pass_max: int = 64
                    ) -> CandidateState:
    """Merge the passing hints' proposals, identical to addProposal applied
    hint by hint in input order (candidate.py:95-287). Hints of different
    candidate rows never interact, so the loop runs over the j-th hint of
    every row at once (one host sync for its trip count); the pair unions
    are order-free given the hint -> (row, proposal) assignment."""
    dev = pass3.device
    H = pass3.shape[0]
    C = n_cand_max
    MP = min(n_pass_max, H)
    i32 = torch.int32

    votes_h = pair_valid.sum(dim=1).to(i32)
    perm, _, n_pass, overflow_pass = select_topk_stable(
        -votes_h.to(torch.float32), pass3, MP)
    g = gidx[perm].to(i32)
    T = T_delta[perm]
    votes = votes_h[perm]
    iota = torch.arange(MP, dtype=i32, device=dev)
    live = iota < torch.clamp(n_pass, max=MP)

    # candidate row of each hint = first-seen rank of its gidx
    same = (g[:, None] == g[None, :]) & live[:, None] & live[None, :]
    first_m = torch.where(same, iota[None, :], MP).amin(dim=1)
    is_first_m = live & (first_m == iota)
    rank_at_m = torch.cumsum(is_first_m.to(i32), 0).to(i32) - 1
    cidx_h = rank_at_m[first_m.clamp(max=MP - 1).long()]
    drop_h = live & (cidx_h >= C)
    overflow_cand = drop_h.sum().to(i32)
    keep_h = live & ~drop_h
    n_cand = torch.clamp(is_first_m.sum(), max=C).to(i32)
    cand_gidx = torch.full((C + 1,), -1, dtype=i32, device=dev)
    cand_gidx[torch.where(is_first_m & (rank_at_m < C), rank_at_m,
                          C).long()] = g
    cand_gidx = cand_gidx[:C]
    # arrival order j of a hint within its row
    j_h = (same & (iota[None, :] < iota[:, None])).sum(dim=1).to(i32)
    hint_of = torch.full(((C + 1) * MP,), -1, dtype=i32, device=dev)
    hint_of[(torch.where(keep_h, cidx_h, C) * MP + j_h).long()] = iota
    hint_of = hint_of.view(C + 1, MP)[:C]
    nj = int(torch.where(keep_h, j_h + 1, 0).max())      # host sync

    rows = torch.arange(C, dtype=i32, device=dev)
    slot_iota = torch.arange(P_PROP, dtype=i32, device=dev)[None, :]
    prop_T = torch.zeros((C, P_PROP, 3), dtype=torch.float32, device=dev)
    prop_votes = torch.zeros((C, P_PROP), dtype=i32, device=dev)
    prop_n = torch.zeros((C,), dtype=i32, device=dev)
    key_of_m = torch.full((MP + 1,), -1, dtype=i32, device=dev)
    for j in range(nj):
        m_c = hint_of[:, j]
        act = m_c >= 0
        mm = m_c.clamp(0, MP - 1).long()
        T_m = T[mm]
        w2 = votes[mm]
        c_m, s_m = torch.cos(T_m[:, 2:3]), torch.sin(T_m[:, 2:3])
        dx = prop_T[:, :, 0] - T_m[:, 0:1]
        dy = prop_T[:, :, 1] - T_m[:, 1:2]
        tx = c_m * dx + s_m * dy
        ty = -s_m * dx + c_m * dy
        dth = clamp_ang(prop_T[:, :, 2] - T_m[:, 2:3])
        in_use = slot_iota < prop_n[:, None]
        match = in_use & (torch.hypot(tx, ty) < TF_TRANS_MERGE) & \
            (dth.abs() < TF_ANG_MERGE)
        has_match = match.any(dim=1)
        first = torch.argmax(match.to(torch.uint8), dim=1).to(i32)
        can_append = prop_n < P_PROP
        slot = torch.where(has_match, first,
                           torch.clamp(prop_n, max=P_PROP - 1))
        write = act & (has_match | can_append)
        oh = slot_iota == slot[:, None]
        old_T = torch.where(oh[..., None], prop_T, 0.0).sum(dim=1)
        w1 = torch.where(oh, prop_votes, 0).sum(dim=1).to(i32)
        wsum = torch.clamp(w1 + w2, min=1).to(torch.float32)
        trans = (old_T[:, :2] * w1[:, None]
                 + T_m[:, :2] * w2[:, None]) / wsum[:, None]
        diff = T_m[:, 2] - old_T[:, 2]
        diff = torch.where(diff < 0, diff + 2 * math.pi, diff)
        diff = torch.where(diff > math.pi, diff - 2 * math.pi, diff)
        ang = diff * w2.to(torch.float32) / wsum + old_T[:, 2]
        T_merged = torch.cat([trans, ang[:, None]], dim=1)
        new_T = torch.where(has_match[:, None], T_merged, T_m)
        new_votes = torch.where(has_match, w1 + w2, w2)
        wsel = write[:, None] & oh
        prop_T = torch.where(wsel[..., None], new_T[:, None, :], prop_T)
        prop_votes = torch.where(wsel, new_votes[:, None], prop_votes)
        prop_n = prop_n + (write & ~has_match).to(i32)
        key_of_m[torch.where(write, mm, MP)] = rows * P_PROP + slot
    key_of_m = key_of_m[:MP]

    # constellation unions: per (row, proposal) key, taken = OR over its
    # hints, perc = the perc of the first hint (in m order) taking the slot
    NK = C * P_PROP
    key_m = torch.where(key_of_m >= 0, key_of_m, NK).long()
    dperc, dtaken = _dense_pair_maps_rows(
        pair_valid[perm], pair_level[perm], pair_seq_src[perm],
        pair_seq_tgt[perm], pair_perc[perm])                  # (MP, SLOTS)
    same_key = key_m[:, None] == key_m[None, :]
    earlier = same_key & (iota[None, :] < iota[:, None])      # (MP, MP)
    taken_before = (earlier.to(torch.float32)
                    @ dtaken.to(torch.float32)) > 0.5
    is_first = dtaken & ~taken_before
    taken_u = torch.zeros((NK + 1, NUM_SLOTS), dtype=torch.float32,
                          device=dev)
    taken_u.index_add_(0, key_m, dtaken.to(torch.float32))
    perc_u = torch.zeros((NK + 1, NUM_SLOTS), dtype=torch.float32, device=dev)
    perc_u.index_add_(0, key_m, torch.where(is_first, dperc, 0.0))
    return CandidateState(
        cand_gidx=cand_gidx, n_cand=n_cand, prop_n=prop_n, prop_T=prop_T,
        prop_votes=prop_votes,
        prop_taken=(taken_u[:NK] > 0.5).view(C, P_PROP, NUM_SLOTS),
        prop_perc=perc_u[:NK].view(C, P_PROP, NUM_SLOTS),
        overflow_cand=overflow_cand, overflow_pass=overflow_pass)


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
    """Screens 1-2 of tidyUpCandidates (candidate.py:366-399)."""
    dev = st.cand_gidx.device
    C = st.cand_gidx.shape[0]
    prop_use = torch.arange(P_PROP, device=dev)[None, :] < st.prop_n[:, None]
    votes_m = torch.where(prop_use, st.prop_votes, -1)
    sel = torch.argmax(votes_m, dim=1)
    rows = torch.arange(C, device=dev)
    area_all = torch.einsum(
        "cps,s->cp", torch.where(st.prop_taken, st.prop_perc, 0.0),
        _area_weights(dev))
    area = area_all[rows, sel]
    T_sel = st.prop_T[rows, sel]
    votes = st.prop_votes[rows, sel]
    ox = n_row / 2 - 0.5
    oy = n_col / 2 - 0.5
    c, s = torch.cos(T_sel[:, 2]), torch.sin(T_sel[:, 2])
    tx = c * ox - s * oy + T_sel[:, 0] - ox
    ty = s * ox + c * oy + T_sel[:, 1] - oy
    neg_d = -torch.hypot(tx * reso_row, ty * reso_col)
    in_use = (rows < st.n_cand) & (st.prop_n > 0)
    alive = in_use & (area >= area_perc_lb) & (neg_d >= neg_est_dist_lb)
    return TidyResult(alive=alive, in_use=in_use, T_sel=T_sel, area=area,
                      neg_d=neg_d, votes=votes, sel=sel)
