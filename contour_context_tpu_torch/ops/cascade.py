"""Batched candidate check cascade, in torch.

Port of `contour_context_tpu/ops/cascade.py`: for every hint of a query at
once, check 1 (anchor ellipse similarity, contour.h:278-329), check 2 (BCI
constellation consensus, contour_mng.h:288-388), check 3 (pairwise similarity
+ orientation, contour_mng.h:1124-1242) and the closed-form 2-D Umeyama
transform (contour_mng.h:1251-1277). Early exits are masks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from contour_context_tpu_torch.config import (
    CandidateScoreEnsemble,
    ContourSimThresConfig,
)

P_MAX = 64
P_POT = 512
ANG_RANGE = math.pi / 16
SHAFT_TOP = 10


class CascadeResult(NamedTuple):
    pass1: torch.Tensor        # (H,) bool
    pass2: torch.Tensor        # (H,) bool
    pass3: torch.Tensor        # (H,) bool
    ovlp_sum: torch.Tensor     # (H,) int32
    ovlp_max_one: torch.Tensor  # (H,) int32
    in_ang_rng: torch.Tensor   # (H,) int32
    i_indiv_sim: torch.Tensor  # (H,) int32
    i_orie_sim: torch.Tensor   # (H,) int32
    pair_valid: torch.Tensor   # (H, P) bool
    pair_level: torch.Tensor   # (H, P) int32
    pair_seq_src: torch.Tensor  # (H, P) int32
    pair_seq_tgt: torch.Tensor  # (H, P) int32
    pair_area_perc: torch.Tensor  # (H, P) f32
    T_delta: torch.Tensor      # (H, 3) f32
    pot_overflow: torch.Tensor  # (H,) bool
    win_overflow: torch.Tensor  # (H,) bool


def check_sim_batched(cnt_s, eig_s, h_s, comr_s, cnt_t, eig_t, h_t, comr_t,
                      th: ContourSimThresConfig):
    """Vectorized ContourView::checkSim (contour.h:278-329)."""
    cnt_s = cnt_s.to(torch.float32)
    cnt_t = cnt_t.to(torch.float32)

    def diff_perc(a, b, p):
        return ((a - b) / torch.maximum(a, b)).abs() > p

    def diff_delt(a, b, d):
        return (a - b).abs() > d

    fail = diff_perc(cnt_s, cnt_t, th.tp_cell_cnt) & \
        diff_delt(cnt_s, cnt_t, th.ta_cell_cnt)
    fail |= (torch.maximum(eig_s[..., 1], eig_t[..., 1]) > 2.0) & \
        diff_perc(eig_s[..., 1].sqrt(), eig_t[..., 1].sqrt(), th.tp_eigval)
    fail |= (torch.maximum(eig_s[..., 0], eig_t[..., 0]) > 2.0) & \
        diff_perc(eig_s[..., 0].sqrt(), eig_t[..., 0].sqrt(), th.tp_eigval)
    fail |= (torch.maximum(cnt_s, cnt_t) > 15) & \
        diff_delt(h_s, h_t, th.ta_h_bar)
    fail |= diff_delt(comr_s, comr_t, th.ta_rcom) & \
        diff_perc(comr_s, comr_t, th.tp_rcom)
    return ~fail


def clamp_ang(a):
    return a - torch.floor((a + math.pi) / (2 * math.pi)) * (2 * math.pi)


def _bits_from_nei(bit, valid):
    """(H, M) neighbour bit table -> (H, 256) bool mask."""
    ar = torch.arange(256, device=bit.device)
    return ((bit[..., None] == ar) & valid[..., None]).any(dim=-2)


def _norm2(x):
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])


def unpack12(g):
    """Channels of packed tab12 rows (descriptor.pack_tab12 order)."""
    return dict(cnt=g[..., 0], eig=g[..., 1:3], h=g[..., 3], comr=g[..., 4],
                mean=g[..., 5:7], vec1=g[..., 7:9], ecc=g[..., 9] > 0.5,
                perc=g[..., 10], ok=g[..., 11] > 0.5)


def run_cascade(src_anchor, src_nei, src_tab12, tgt_anchor, tgt_nei,
                tgt_tab12, hint_valid, anchor_level, anchor_seq_src,
                anchor_seq_tgt, thres_lb: CandidateScoreEnsemble,
                cont_sim: ContourSimThresConfig,
                p_pot: int | None = None) -> CascadeResult:
    """The whole cascade over H hints (cascade.py:98-342). src_* are per-hint
    gathers of the candidate scans, tgt_* the query's own tables."""
    dev = hint_valid.device
    H, M = src_nei["bit"].shape
    pot = P_POT if p_pot is None else p_pot
    i32 = torch.int32

    def widen(nei):      # int8/int16 tables widen before any arithmetic
        return dict(nei, level=nei["level"].to(i32), seq=nei["seq"].to(i32),
                    bit=nei["bit"].to(i32))

    src_nei = widen(src_nei)
    tgt_nei = widen(tgt_nei)

    # ---- check 1 --------------------------------------------------------
    pass1 = hint_valid & check_sim_batched(
        src_anchor["cnt"], src_anchor["eig"], src_anchor["h"],
        src_anchor["comr"], tgt_anchor["cnt"], tgt_anchor["eig"],
        tgt_anchor["h"], tgt_anchor["comr"], cont_sim)

    # ---- check 2 --------------------------------------------------------
    bits_s = _bits_from_nei(src_nei["bit"], src_nei["valid"])
    bits_t = _bits_from_nei(tgt_nei["bit"], tgt_nei["valid"])
    zcol = torch.zeros((H, 1), dtype=torch.bool, device=dev)
    shl = torch.cat([zcol, bits_s[:, :-1]], dim=1)
    shr = torch.cat([bits_s[:, 1:], zcol], dim=1)
    and1 = (bits_s & bits_t).sum(dim=1)
    and2 = (shl & bits_t).sum(dim=1)
    and3 = (shr & bits_t).sum(dim=1)
    ovlp_sum = (and1 + and2 + and3).to(i32)
    max_one = torch.maximum(and1, torch.maximum(and2, and3)).to(i32)
    gate2 = (ovlp_sum >= thres_lb.sim_constell.i_ovlp_sum) & \
        (max_one >= thres_lb.sim_constell.i_ovlp_max_one)

    close = ((src_nei["bit"][:, :, None] - tgt_nei["bit"][:, None, :]).abs()
             <= 1) & src_nei["valid"][:, :, None] & tgt_nei["valid"][:, None, :]
    orie = clamp_ang(tgt_nei["theta"][:, None, :]
                     - src_nei["theta"][:, :, None])
    # flat index f = tgt * M + src: the reference's insertion order
    orie = torch.where(close, orie, math.inf).transpose(1, 2).reshape(H, M * M)
    pot_overflow = close.reshape(H, -1).sum(dim=1) > pot
    sv, s_flat = torch.sort(orie + 0.0, dim=1, stable=True)
    sv, s_flat = sv[:, :pot], s_flat[:, :pot].to(i32)
    n_pot = torch.isfinite(sv).sum(dim=1).to(i32)

    # circular window of width ANG_RANGE starting at each sorted pair
    hi = sv + ANG_RANGE
    c_main = (sv[:, None, :] <= hi[:, :, None]).sum(dim=2)
    c_wrap = (sv[:, None, :] <= (hi - 2 * math.pi)[:, :, None]).sum(dim=2)
    idx = torch.arange(sv.shape[1], device=dev)[None, :]
    n_b = n_pot[:, None].to(torch.int64)
    counts = torch.minimum(c_main, n_b) - idx + torch.minimum(c_wrap, n_b)
    counts = torch.where(idx < n_b, counts, 0)
    longest = torch.clamp(counts.amax(dim=1), min=1).to(i32)
    best_beg = torch.argmax(counts, dim=1).to(i32)
    in_ang = torch.where(n_pot > 0, longest, 0).to(i32)
    pass2 = pass1 & gate2 & (n_pot > 0) & \
        (in_ang >= thres_lb.sim_constell.i_in_ang_rng)

    # window members -> fixed (H, P_MAX) constellation, anchor pair last
    ar_w = torch.arange(P_MAX - 1, dtype=i32, device=dev)[None, :]
    win_val = ar_w < torch.clamp(longest, max=P_MAX - 1)[:, None]
    win_pos = (best_beg[:, None] + ar_w) % torch.clamp(n_pot, min=1)[:, None]
    g_flat = torch.gather(s_flat, 1, win_pos.long())
    g_src_slot = (g_flat % M).long()
    g_tgt_slot = (g_flat // M).long()
    src_ls = src_nei["level"] * 64 + src_nei["seq"]
    g_ls = torch.gather(src_ls, 1, g_src_slot)
    pt = torch.gather(tgt_nei["seq"], 1, g_tgt_slot)
    pair_level = torch.cat([g_ls // 64, anchor_level[:, None].to(i32)], 1)
    pair_seq_src = torch.cat([g_ls % 64, anchor_seq_src[:, None].to(i32)], 1)
    pair_seq_tgt = torch.cat([pt, anchor_seq_tgt[:, None].to(i32)], 1)
    pair_valid0 = torch.cat(
        [win_val, torch.ones((H, 1), dtype=torch.bool, device=dev)], 1) \
        & pass2[:, None]
    rank0 = torch.cat([ar_w.expand(H, P_MAX - 1), longest[:, None]], 1)

    # ---- check 3 --------------------------------------------------------
    J = src_tab12.shape[2]
    li = torch.clamp(pair_level - 1, 0, src_tab12.shape[1] - 1).long()
    hrow = torch.arange(H, device=dev)[:, None]
    s = unpack12(src_tab12[hrow, li,
                           torch.clamp(pair_seq_src, 0, J - 1).long()])
    t = unpack12(tgt_tab12[li, torch.clamp(pair_seq_tgt, 0, J - 1).long()])
    indiv = check_sim_batched(s["cnt"], s["eig"], s["h"], s["comr"],
                              t["cnt"], t["eig"], t["h"], t["comr"], cont_sim)
    cstl1 = pair_valid0 & indiv & s["ok"] & t["ok"]
    i_indiv = cstl1.sum(dim=1).to(i32)
    gate3a = i_indiv >= thres_lb.sim_pair.i_indiv_sim

    big = 1 << 20
    order_rank = torch.where(cstl1, rank0, big)
    pos_sorted = torch.sort(order_rank, dim=1, stable=True).indices
    inv_pos = torch.sort(pos_sorted, dim=1, stable=True).indices.to(i32)
    cpos = torch.where(cstl1, inv_pos, big)

    # shaft selection quirk (contour_mng.h:1173-1184)
    mean_s, mean_t = s["mean"], t["mean"]
    pi_ = cpos[:, :, None]
    pj_ = cpos[:, None, :]
    elig = (pi_ < SHAFT_TOP) & (pj_ < pi_) & cstl1[:, :, None] & \
        cstl1[:, None, :]
    span_n = _norm2(mean_s[:, :, None, :] - mean_s[:, None, :, :])
    it_rank = pi_ * SHAFT_TOP + pj_
    best_gt1 = torch.where(elig & (span_n > 1.0), it_rank, -1) \
        .reshape(H, -1).amax(dim=1)
    best_gt0 = torch.where(elig & (span_n > 0.0), it_rank, big) \
        .reshape(H, -1).amin(dim=1)
    use_rank = torch.where(best_gt1 >= 0, best_gt1, best_gt0)
    pick_f = ((it_rank == use_rank[:, None, None]) & elig).reshape(H, -1)
    pick_idx = torch.argmax(pick_f.to(torch.uint8), dim=1)
    any_pick = pick_f.any(dim=1)
    P = cstl1.shape[1]
    i_slot, j_slot = pick_idx // P, pick_idx % P
    hidx = torch.arange(H, device=dev)
    sh_s = mean_s[hidx, i_slot] - mean_s[hidx, j_slot]
    sh_t = mean_t[hidx, i_slot] - mean_t[hidx, j_slot]
    sh_t_norm = _norm2(sh_t)
    sh_s = sh_s / torch.clamp(_norm2(sh_s), min=1e-12)[:, None]
    sh_t = sh_t / torch.clamp(sh_t_norm, min=1e-12)[:, None]
    sh_s = torch.where(any_pick[:, None], sh_s, 0.0)
    sh_t = torch.where(any_pick[:, None], sh_t, 0.0)
    tgt_shaft_nan = any_pick & (sh_t_norm <= 1e-12)

    # orientation screen (contour_mng.h:1186-1201)
    def dot2(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]

    th_s = torch.arccos(torch.clamp(dot2(sh_s[:, None, :], s["vec1"]), -1, 1))
    th_t = torch.arccos(torch.clamp(dot2(sh_t[:, None, :], t["vec1"]), -1, 1))
    bad = s["ecc"] & t["ecc"] & ((th_s - th_t).abs() > math.pi / 6) \
        & ((math.pi - th_s - th_t).abs() > math.pi / 6) \
        & ~tgt_shaft_nan[:, None]
    cstl2 = cstl1 & ~bad
    i_orie = cstl2.sum(dim=1).to(i32)
    pass3 = pass2 & gate3a & (i_orie >= thres_lb.sim_pair.i_orie_sim)
    area_perc = torch.where(cstl2, 0.5 * (s["perc"] + t["perc"]), 0.0)

    # Umeyama SE(2) (contour_mng.h:1251-1277)
    wm = cstl2.to(torch.float32)
    n = torch.clamp(wm.sum(dim=1, keepdim=True), min=1.0)
    mu_s = (mean_s * wm[..., None]).sum(dim=1) / n
    mu_t = (mean_t * wm[..., None]).sum(dim=1) / n
    dt = (mean_t - mu_t[:, None]) * wm[..., None]
    ds = mean_s - mu_s[:, None]
    Cm = (dt[:, :, :, None] * ds[:, :, None, :]).sum(dim=1)
    theta = torch.atan2(Cm[:, 1, 0] - Cm[:, 0, 1], Cm[:, 0, 0] + Cm[:, 1, 1])
    cth, sth = torch.cos(theta), torch.sin(theta)
    tx = mu_t[:, 0] - (cth * mu_s[:, 0] - sth * mu_s[:, 1])
    ty = mu_t[:, 1] - (sth * mu_s[:, 0] + cth * mu_s[:, 1])
    return CascadeResult(
        pass1=pass1, pass2=pass2, pass3=pass3, ovlp_sum=ovlp_sum,
        ovlp_max_one=max_one, in_ang_rng=in_ang, i_indiv_sim=i_indiv,
        i_orie_sim=i_orie, pair_valid=cstl2, pair_level=pair_level,
        pair_seq_src=pair_seq_src, pair_seq_tgt=pair_seq_tgt,
        pair_area_perc=area_perc, T_delta=torch.stack([tx, ty, theta], 1),
        pot_overflow=pot_overflow, win_overflow=longest > (P_MAX - 1))
