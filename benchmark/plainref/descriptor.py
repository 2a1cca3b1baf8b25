"""Frozen for the benchmark's reference: a copy of the port's
`contour_context_tpu_torch/ops/descriptor.py`, importing nothing of the port (its
kernels are `plainref.kernels`' plain twins). Its own notes follow.

Descriptor build: points -> ScanDesc, for one scan or a batch, in torch.

Port of `contour_context_tpu/ops/descriptor.py` (the reference's makeBEV +
makeContoursRecurs + key/BCI generation, contour_mng.h:505-960): BEV raster,
per-level 8-connected components, top-K contour tables with moments and a
closed-form eigen-decomposition, ring-histogram retrieval keys (through the
ring-key kernel), BCI neighbour tables and the GMM summary.

Every stage takes any leading axes (a scan is the empty batch), as the JAX
package's `jax.vmap(build_descriptor)` batches them: a batch of B scans runs
each stage once, with one CC-label launch and one ring-key launch for the
whole batch. Every reduction runs over the trailing
extents of one scan, so on the CPU a scan's row of a batch is bit-equal to
its build alone.
"""

from __future__ import annotations

import math

import torch

from plainref.config import (
    BITS_PER_LAYER,
    DIST_BIN_LAYERS,
    NUM_BIN_KEY_LAYER,
    RET_KEY_DIM,
    ContourManagerConfig,
    GMMOptConfig,
)
from plainref.candidate import select_topk_stable
from plainref.gmm import l2_pairwise
from plainref.kernels import cc_labels, ring_key_divs, ring_key_divs_batch
from plainref.types import ScanDesc, device_const

VAL_ABS_INF = 1e3
DESC_BATCH = 16      # scans a sub-batch of build_descriptors (db.DESC_BATCH)


# ---------------------------------------------------------------------------
# 1. BEV rasterization (contour_mng.h:505-556)
# ---------------------------------------------------------------------------

def rasterize_bev(points, cfg: ContourManagerConfig):
    """points (..., P, 4) f32 [x y z valid] -> (bev, rowf, colf), each
    (..., S) f32.

    Per-pixel max of z + lidar_height; the continuous (row, col) payload is
    that of the first point in array order reaching the max (the
    reference's strict `<` update). Each scan scatters into its own row of
    (B, S + 1) bins, and the winner is the least index of the scan's own
    points."""
    nr, nc = cfg.n_row, cfg.n_col
    S = nr * nc
    dev = points.device
    lead, P = points.shape[:-2], points.shape[-2]
    pts = points.reshape(-1, P, 4)
    B = pts.shape[0]
    x, y, z, flag = pts.unbind(-1)                          # (B, P) each
    pad = 1e-2
    x_min, x_max = -(nr // 2) * cfg.reso_row, (nr // 2) * cfg.reso_row
    y_min, y_max = -(nc // 2) * cfg.reso_col, (nc // 2) * cfg.reso_col
    ok = ((flag > 0) & (x >= x_min + pad) & (x <= x_max - pad)
          & (y >= y_min + pad) & (y <= y_max - pad)
          & (x * x + y * y >= cfg.blind_sq))
    row = torch.floor(x / cfg.reso_row)
    col = torch.floor(y / cfg.reso_col)
    ok &= torch.isfinite(row) & torch.isfinite(col)
    row = torch.where(ok, row, 0.0).to(torch.int32) + nr // 2
    col = torch.where(ok, col, 0.0).to(torch.int32) + nc // 2
    ok &= row > 0            # reference quirk: row 0 dropped
    h = z + cfg.lidar_height
    ok &= torch.isfinite(h)
    pid = torch.where(ok, row * nc + col, S).long()
    hm = torch.where(ok, h, -math.inf)
    best = torch.full((B, S + 1), -math.inf, dtype=torch.float32, device=dev)
    best.scatter_reduce_(1, pid, hm, reduce="amax", include_self=True)
    at_max = ok & (hm == best.gather(1, pid))
    idx = torch.where(at_max, torch.arange(P, device=dev), P)
    win = torch.full((B, S + 1), P, dtype=torch.long, device=dev)
    win.scatter_reduce_(1, pid, idx, reduce="amin", include_self=True)
    win = win[:, :S]
    has = win < P
    wi = win.clamp(max=P - 1)
    bev = torch.where(has, best[:, :S], -VAL_ABS_INF)
    rowf = torch.where(has, x.gather(1, wi) / cfg.reso_row + nr / 2 - 0.5,
                       -1.0)
    colf = torch.where(has, y.gather(1, wi) / cfg.reso_col + nc / 2 - 0.5,
                       -1.0)
    return tuple(t.reshape(lead + (S,)) for t in (bev, rowf, colf))


def level_masks(bev, cfg: ContourManagerConfig):
    """bev (..., S) -> (..., L, n_row, n_col) bool: the pixels above each
    level's height."""
    grads = device_const(tuple(cfg.lv_grads), torch.float32, bev.device)
    return bev.reshape(bev.shape[:-1] + (1, cfg.n_row, cfg.n_col)) > \
        grads[:, None, None]


# ---------------------------------------------------------------------------
# 2. Connected components per level
# ---------------------------------------------------------------------------

# `kernels.cc_labels`: masks (..., nr, nc) bool -> labels (..., nr*nc) int32,
# each 8-connected component labelled by its minimum linear pixel index,
# the background S; one kernel launch on the card, the plain propagation to
# its fixpoint (`kernels.cc_labels_plain`) on the CPU.


# ---------------------------------------------------------------------------
# 3. Contour tables
# ---------------------------------------------------------------------------

def component_tables(labels, masks_flat, bev, rowf, colf,
                     cfg: ContourManagerConfig,
                     moment_dtype=torch.float64) -> dict:
    """Per-level top-K contour statistics (descriptor.py:284-438): labels
    and masks_flat (..., L, S), bev/rowf/colf (..., S) -> (..., L, K, ...)
    tables."""
    S = labels.shape[-1]
    K = cfg.max_contours
    sc = cfg.view_stat
    dev = labels.device
    lab64 = labels.long()
    # cell count of each label (torch.bincount would sync the host to size
    # its output)
    counts = torch.zeros(labels.shape[:-1] + (S + 1,), dtype=torch.int32,
                         device=dev) \
        .scatter_add_(-1, lab64, torch.ones_like(labels))
    cnt_pix = torch.where(masks_flat, torch.gather(counts, -1, lab64), 0) \
        .to(torch.int32)
    min_ok = cnt_pix >= cfg.min_cont_cell_cnt
    # a pixel is valid while it is valid at every lower level
    valid_pix = torch.cummin(min_ok.to(torch.int32), -2).values > 0
    iota_s = torch.arange(S, dtype=torch.int32, device=dev)
    valid_rep = (labels == iota_s) & valid_pix
    layer_cell_cnt = valid_pix.sum(-1).to(torch.int32)
    n_cont = valid_rep.sum(-1).to(torch.int32)

    # top-K by (count desc, min pixel asc): stable sort, invalid last
    sort_key = torch.where(valid_rep, -cnt_pix, 1)
    order_k = torch.sort(sort_key, dim=-1, stable=True).indices[..., :K]
    sel_valid = torch.gather(valid_rep, -1, order_k)
    rep = torch.where(sel_valid, order_k.to(torch.int32), S)

    sel = (labels[..., None, :] == torch.clamp(rep, max=S - 1)[..., None]) \
        & (rep[..., None] < S)                          # (..., L, K, S)
    # the per-component sums accumulate in float64 over the S pixels of one
    # scan and round once: every float32 reduction order rounds differently,
    # and com_r and the off-diagonal covariance cancel large terms
    f64 = moment_dtype
    ch1 = torch.stack([rowf, colf, bev, bev * rowf, bev * colf], -2)
    sums = torch.einsum("...lks,...cs->...lkc", sel.to(f64), ch1.to(f64)) \
        .to(torch.float32)
    s_r, s_c, s_h, s_hr, s_hc = sums.unbind(-1)

    g_cnt = torch.where(sel_valid, torch.gather(cnt_pix, -1, order_k), 0)
    g_n = torch.clamp(g_cnt, min=1).to(torch.float32)
    mean_r = s_r / g_n
    mean_c = s_c / g_n
    g_mean = torch.stack([mean_r, mean_c], -1)
    g_com = torch.stack([s_hr, s_hc], -1) / \
        torch.clamp(s_h, min=1e-12)[..., None]
    g_vol3_mean = s_h / g_n

    dr = torch.where(sel, rowf[..., None, None, :] - mean_r[..., None], 0.0)
    dc = torch.where(sel, colf[..., None, None, :] - mean_c[..., None], 0.0)
    nm1 = torch.clamp(g_n - 1.0, min=1.0)
    a = (dr * dr).sum(-1, dtype=f64).to(torch.float32) / nm1
    b = (dr * dc).sum(-1, dtype=f64).to(torch.float32) / nm1
    c = (dc * dc).sum(-1, dtype=f64).to(torch.float32) / nm1

    m = 0.5 * (a + c)
    d = 0.5 * (a - c)
    disc = torch.sqrt(d * d + b * b)
    l0 = m - disc
    l1 = m + disc
    use_b = b.abs() > 1e-12
    ones, zeros = torch.ones_like(a), torch.zeros_like(a)
    v1r = torch.where(use_b, b, torch.where(a >= c, ones, zeros))
    v1c = torch.where(use_b, l1 - a, torch.where(a >= c, zeros, ones))
    nrm = torch.sqrt(v1r * v1r + v1c * v1c)
    v1r, v1c = v1r / nrm, v1c / nrm
    eig_vecs = torch.stack([torch.stack([-v1c, v1r], -1),
                            torch.stack([v1r, v1c], -1)], -1)

    small = g_cnt < sc.min_cell_cov
    ps = sc.point_sigma
    l0 = torch.where(small, ps, torch.clamp(l0, min=ps))
    l1 = torch.where(small, ps, torch.clamp(l1, min=ps))
    eye = torch.eye(2, dtype=torch.float32, device=dev).expand_as(eig_vecs)
    eig_vecs = torch.where(small[..., None, None], eye, eig_vecs)
    eig_vals = torch.stack([l0, l1], -1)
    # V diag(eig) V^T
    Vl = eig_vecs * eig_vals[..., None, :]
    manual_cov = (Vl[..., :, None, :] * eig_vecs[..., None, :, :]).sum(-1)

    perc = ((l0 - l1) / torch.maximum(l0, l1)).abs()
    ecc_feat = (~small) & (g_cnt > 5) & (perc > 0.2) & (l1 > 2.5)
    dcm = g_com - g_mean
    com_r = torch.sqrt(dcm[..., 0] * dcm[..., 0] + dcm[..., 1] * dcm[..., 1])
    cont_perc = g_cnt.to(torch.float32) / torch.clamp(
        layer_cell_cnt.to(torch.float32), min=1.0)[..., None]
    return dict(cnt=g_cnt, valid=sel_valid, mean=g_mean, eig_vals=eig_vals,
                eig_vecs=eig_vecs, manual_cov=manual_cov,
                vol3_mean=g_vol3_mean, com_r=com_r, ecc_feat=ecc_feat,
                cont_perc=cont_perc, layer_cell_cnt=layer_cell_cnt,
                n_cont=n_cont)


# ---------------------------------------------------------------------------
# 4. Retrieval keys (contour_mng.h:689-830)
# ---------------------------------------------------------------------------

def ring_inputs(tab: dict, bev, rowf, colf, cfg: ContourManagerConfig):
    """The ring contraction's inputs (descriptor.py:456-517), each scan's
    own: anchors (..., L*A, 8) [v0, v1, r_min, r_max, c_min, c_max, 1, 0],
    the compacted pixel pool (..., pix_pool, 8) [p_r, p_c, rowf, colf,
    higher, ok, 0, 0], the shared division centres (35,) and the pool's
    overflow count (...)."""
    L, A = cfg.n_levels, cfg.piv_firsts
    nr, nc = cfg.n_row, cfg.n_col
    S = nr * nc
    dev = bev.device
    num_bins = RET_KEY_DIM - 3
    div_len = cfg.roi_radius / (num_bins * 5)
    div_centers = (torch.arange(num_bins * 5, dtype=torch.float32, device=dev)
                   * div_len + 0.5 * div_len)
    roi_pad = int(math.ceil(cfg.roi_radius + 1))
    h_gate = cfg.lv_grads[DIST_BIN_LAYERS[0]]

    pvalid = bev > h_gate
    full_higher = torch.zeros_like(bev)
    for ele in range(DIST_BIN_LAYERS[0], L):
        full_higher = full_higher + (bev > cfg.lv_grads[ele]).to(torch.float32)
    order, p_ok, _, pix_overflow = select_topk_stable(
        -full_higher, pvalid, min(cfg.pix_pool, S))
    p_r = (order // nc).to(torch.float32)
    p_c = (order % nc).to(torch.float32)
    higher = torch.where(p_ok, full_higher.gather(-1, order), 0.0)
    zp = torch.zeros_like(higher)
    pool = torch.stack([p_r, p_c, rowf.gather(-1, order),
                        colf.gather(-1, order), higher,
                        p_ok.to(torch.float32), zp, zp], dim=-1)

    mean = tab["mean"][..., :A, :]
    v0 = mean[..., 0].flatten(-2)
    v1 = mean[..., 1].flatten(-2)
    r_cen = v0.to(torch.int32)                     # C trunc toward zero
    c_cen = v1.to(torch.int32)
    f32 = torch.float32
    anchors = torch.stack([
        v0, v1, torch.clamp(r_cen - roi_pad, min=0).to(f32),
        torch.clamp(r_cen + roi_pad, max=nr - 1).to(f32),
        torch.clamp(c_cen - roi_pad, min=0).to(f32),
        torch.clamp(c_cen + roi_pad, max=nc - 1).to(f32),
        torch.ones_like(v0), torch.zeros_like(v0)], dim=-1)
    return anchors, pool, div_centers, pix_overflow


def make_keys(tab: dict, bev, rowf, colf, cfg: ContourManagerConfig):
    """(..., L, A, 10) retrieval keys (zero for invalid anchors), the anchor
    validity (..., L, A) and the pixel-pool overflow count (...). The ring
    sums of all the scans are one kernel launch: `ring_key_divs_batch`, or
    `ring_key_divs` for a single scan (the stream)."""
    L, A = cfg.n_levels, cfg.piv_firsts
    num_bins = RET_KEY_DIM - 3
    bin_len = cfg.roi_radius / num_bins
    anchors, pool, centers, pix_overflow = ring_inputs(tab, bev, rowf, colf,
                                                       cfg)
    lead = anchors.shape[:-2]
    anchors_b = anchors.reshape((-1,) + anchors.shape[-2:])
    pool_b = pool.reshape((-1,) + pool.shape[-2:])
    if anchors_b.shape[0] == 1:
        divs, cnt_point = (x[None] for x in ring_key_divs(
            anchors_b[0], pool_b[0], centers, cfg.roi_radius))
    else:
        divs, cnt_point = ring_key_divs_batch(anchors_b, pool_b, centers,
                                              cfg.roi_radius)
    ring = divs.reshape(lead + (L * A, num_bins, 5)).sum(-1)
    cnt_point = cnt_point.reshape(lead + (L * A,))
    ring = torch.where(
        cnt_point[..., None] > 0,
        ring * bin_len / torch.sqrt(torch.clamp(cnt_point, min=1.0))[..., None],
        0.0)
    cnt = tab["cnt"][..., :A]
    anch_valid = tab["valid"][..., :A] & (cnt >= cfg.min_cont_key_cnt)
    cntf = cnt.to(torch.float32)
    k0 = torch.sqrt(tab["eig_vals"][..., :A, 1] * cntf)
    k1 = torch.sqrt(tab["eig_vals"][..., :A, 0] * cntf)
    k2 = torch.sqrt(torch.cumsum(cnt, -1).to(torch.float32))
    keys = torch.cat([torch.stack([k0, k1, k2], -1),
                      ring.reshape(lead + (L, A, num_bins))], -1)
    keys = torch.where(anch_valid[..., None], keys, 0.0)
    return keys, anch_valid, pix_overflow


# ---------------------------------------------------------------------------
# 5. BCIs (contour_mng.h:846-883)
# ---------------------------------------------------------------------------

def make_bcis(tab: dict, anch_valid, cfg: ContourManagerConfig) -> dict:
    """(..., L, A, M) neighbour tables of each scan's anchors over the
    DIST_BIN_LAYERS levels of the same scan."""
    L, A, J = cfg.n_levels, cfg.piv_firsts, cfg.dist_firsts
    M = NUM_BIN_KEY_LAYER * J
    dev = anch_valid.device
    i32 = torch.int32
    mean = tab["mean"]                                   # (..., L, K, 2)
    n_cont = tab["n_cont"]                               # (..., L)
    lay_idx = device_const(DIST_BIN_LAYERS, torch.long, dev)
    anchor_mean = mean[..., :A, :]
    # the level axis, not the batch's
    nei_mean = mean.index_select(-3, lay_idx)[..., :J, :]
    if nei_mean.shape[-2] < J:
        nei_mean = torch.nn.functional.pad(
            nei_mean, (0, 0, 0, J - nei_mean.shape[-2]))
    ar_j = torch.arange(J, dtype=i32, device=dev)
    nei_exists = ar_j < torch.clamp(n_cont.index_select(-1, lay_idx),
                                    max=J)[..., None]     # (..., 4, J)

    vec = nei_mean[..., None, None, :, :, :] - \
        anchor_mean[..., :, :, None, None, :]            # (..., L,A,4,J,2)
    d = torch.sqrt(vec[..., 0] * vec[..., 0] + vec[..., 1] * vec[..., 1])
    theta = torch.atan2(vec[..., 1], vec[..., 0])
    d_hi = (BITS_PER_LAYER - 1) * 1.01 + 5.43 - 1e-3
    in_rng = (d > 5.43) & (d <= d_hi)
    ll_ar = torch.arange(L, dtype=i32, device=dev)
    seq_ar = torch.arange(A, dtype=i32, device=dev)
    is_self = (lay_idx[None, None, :, None] == ll_ar[:, None, None, None]) & \
        (ar_j[None, None, None, :] == seq_ar[None, :, None, None])
    valid = nei_exists[..., None, None, :, :] & in_rng & ~is_self & \
        anch_valid[..., None, None]
    bit_local = torch.clamp(torch.floor((d - 5.43) / 1.01),
                            max=BITS_PER_LAYER - 1.0)
    bit = bit_local.to(i32) + (torch.arange(NUM_BIN_KEY_LAYER, dtype=i32,
                                            device=dev)
                               * BITS_PER_LAYER)[None, None, :, None]
    nei_level = lay_idx.to(i32)[None, None, :, None].expand(valid.shape)
    nei_seq = ar_j[None, None, None, :].expand(valid.shape)

    def flat(x):
        return x.reshape(x.shape[:-2] + (M,))

    valid, bit, theta, nei_level, nei_seq = map(
        flat, (valid, bit, theta, nei_level, nei_seq))
    slot = torch.arange(M, dtype=i32, device=dev)[None, None, :]
    sort_key = torch.where(valid, bit * M + slot, 1 << 20)
    order = torch.sort(sort_key, dim=-1, stable=True).indices

    def take(x):
        return torch.gather(x, -1, order)

    tv = take(valid)
    return dict(nei_valid=tv, nei_level=take(nei_level).to(torch.int8),
                nei_seq=take(nei_seq).to(torch.int8),
                nei_bit=torch.where(tv, take(bit), 256).to(torch.int16),
                nei_theta=take(theta))


# ---------------------------------------------------------------------------
# 6. GMM summary and packed tables
# ---------------------------------------------------------------------------

def gmm_summary(tab: dict, gmm_cfg: GMMOptConfig):
    """(gmm_mask (..., L, K), auto_corr (...), gmm_overflow (...)): the
    self-correlation and overflow are sums over each scan's own levels."""
    cnt = tab["cnt"].to(torch.float32)                   # (..., L, K)
    lcc = torch.clamp(tab["layer_cell_cnt"].to(torch.float32), min=1.0)
    ex_cum = torch.cumsum(cnt, -1) - cnt
    gmm_mask = tab["valid"] & (ex_cum / lcc[..., None] <
                               gmm_cfg.min_area_perc)
    lev = device_const(tuple(gmm_cfg.levels), torch.long, cnt.device)
    mus = tab["mean"].index_select(-3, lev)
    covs = tab["manual_cov"].index_select(-4, lev)
    mask_g = gmm_mask.index_select(-2, lev)
    ws = torch.where(mask_g, cnt.index_select(-2, lev), 0.0)
    auto_corr = l2_pairwise(mus, covs, ws, mus, covs, ws,
                            gmm_cfg.cov_dilate_scale).sum((-3, -2, -1))
    gmm_overflow = torch.clamp(mask_g.sum(-1) - gmm_cfg.max_gmm_ellipses,
                               min=0).sum(-1).to(torch.int32)
    return gmm_mask, auto_corr.to(torch.float32), gmm_overflow


def pack_tab12(cnt, valid, mean, eig_vals, eig_vecs, vol3_mean, com_r,
               ecc_feat, cont_perc):
    """(4, 10, 12) check-3 stats table over DIST_BIN_LAYERS x first 10 seqs:
    [cnt, eig0, eig1, h, comr, mean0, mean1, vec1x, vec1y, ecc, perc, ok].
    Leading batch axes (a stacked store) pass through."""
    lv = device_const(DIST_BIN_LAYERS, torch.long, mean.device)
    nb = cnt.dim() - 2

    def sl(a):
        return a.index_select(nb, lv).narrow(nb + 1, 0, 10)

    f32 = torch.float32
    return torch.stack([
        sl(cnt).to(f32), sl(eig_vals)[..., 0], sl(eig_vals)[..., 1],
        sl(vol3_mean), sl(com_r), sl(mean)[..., 0], sl(mean)[..., 1],
        sl(eig_vecs)[..., 0, 1], sl(eig_vecs)[..., 1, 1],
        sl(ecc_feat).to(f32), sl(cont_perc), sl(valid).to(f32)], dim=-1)


def pack_gmm(mean, manual_cov, cnt, eig_vals, gmm_mask, gmm_cfg) -> torch.Tensor:
    """Flat (G*K*8,) GMM source row: [mu0, mu1, cov00, cov01, cov10, cov11,
    w (masked cnt), majax] per (level, ellipse). Leading batch axes (a
    stacked store) pass through."""
    lev = device_const(tuple(gmm_cfg.levels), torch.long, mean.device)
    K = gmm_cfg.max_gmm_ellipses
    G = len(gmm_cfg.levels)
    nb = cnt.dim() - 2
    lead = tuple(cnt.shape[:nb])

    def sl(a):
        return a.index_select(nb, lev).narrow(nb + 1, 0, K)

    ws = torch.where(sl(gmm_mask), sl(cnt).to(torch.float32), 0.0)
    packed = torch.cat([
        sl(mean), sl(manual_cov).reshape(lead + (G, K, 4)),
        ws[..., None], torch.sqrt(sl(eig_vals)[..., 1])[..., None]],
        dim=-1)
    return packed.reshape(lead + (G * K * 8,))


def tab12_of(desc) -> torch.Tensor:
    """ScanDesc.tab12 recomputed from the other leaves of a scan or of a
    stacked store (checkpoints do not hold it); bit-equal to what
    build_descriptor packed."""
    return pack_tab12(desc.cnt, desc.valid, desc.mean, desc.eig_vals,
                      desc.eig_vecs, desc.vol3_mean, desc.com_r,
                      desc.ecc_feat, desc.cont_perc)


def gmm_pack_of(desc, gmm_cfg) -> torch.Tensor:
    """ScanDesc.gmm_pack recomputed from the other leaves (see tab12_of)."""
    return pack_gmm(desc.mean, desc.manual_cov, desc.cnt, desc.eig_vals,
                    desc.gmm_mask, gmm_cfg)


# ---------------------------------------------------------------------------
# Full build
# ---------------------------------------------------------------------------

def dequantize_points(points):
    """int16 q16 wire format (1/256 m steps, utils/io.quantize_points_q16)
    -> f32 [x y z valid], for (..., P, 4) points; f32 points pass
    through."""
    if points.dtype != torch.int16:
        return points
    pf = points.to(torch.float32)
    return torch.cat([pf[..., :3] * (1.0 / 256.0), pf[..., 3:4]], dim=-1)


def _build_batch(points_b, cfg: ContourManagerConfig,
                 gmm_cfg: GMMOptConfig,
                 moment_dtype=torch.float64) -> ScanDesc:
    """Every stage once over the B scans of points_b (B, P, 4)."""
    points_b = dequantize_points(points_b)
    bev, rowf, colf = rasterize_bev(points_b, cfg)
    masks = level_masks(bev, cfg)
    labels = cc_labels(masks)
    tab = component_tables(labels, masks.flatten(-2), bev, rowf, colf, cfg,
                           moment_dtype)
    keys, anch_valid, pix_overflow = make_keys(tab, bev, rowf, colf, cfg)
    bci = make_bcis(tab, anch_valid, cfg)
    gmm_mask, auto_corr, gmm_overflow = gmm_summary(tab, gmm_cfg)
    return ScanDesc(
        cnt=tab["cnt"].to(torch.int16), valid=tab["valid"], mean=tab["mean"],
        eig_vals=tab["eig_vals"], eig_vecs=tab["eig_vecs"],
        manual_cov=tab["manual_cov"], vol3_mean=tab["vol3_mean"],
        com_r=tab["com_r"], ecc_feat=tab["ecc_feat"],
        cont_perc=tab["cont_perc"], layer_cell_cnt=tab["layer_cell_cnt"],
        n_cont=tab["n_cont"], keys=keys, nei_valid=bci["nei_valid"],
        nei_level=bci["nei_level"], nei_seq=bci["nei_seq"],
        nei_bit=bci["nei_bit"], nei_theta=bci["nei_theta"],
        gmm_mask=gmm_mask, auto_corr=auto_corr,
        pix_overflow=pix_overflow.to(torch.int32),
        gmm_overflow=gmm_overflow,
        tab12=pack_tab12(tab["cnt"], tab["valid"], tab["mean"],
                         tab["eig_vals"], tab["eig_vecs"], tab["vol3_mean"],
                         tab["com_r"], tab["ecc_feat"], tab["cont_perc"]),
        gmm_pack=pack_gmm(tab["mean"], tab["manual_cov"], tab["cnt"],
                          tab["eig_vals"], gmm_mask, gmm_cfg))


def build_descriptors(points_b, cfg: ContourManagerConfig,
                      gmm_cfg: GMMOptConfig = GMMOptConfig(),
                      batch: int = DESC_BATCH,
                      moment_dtype=torch.float64) -> ScanDesc:
    """points_b (B, P, 4) f32 (or int16 q16) on any device -> the B-stacked
    ScanDesc there, in sub-batches of at most `batch` scans (the port's
    `build_descriptors`). `moment_dtype` is the type the contour moments
    accumulate in: float64 as the port states; the benchmark's control
    lowers it to float32."""
    B = points_b.shape[0]
    batch = max(1, batch)
    parts = [_build_batch(points_b[i:i + batch], cfg, gmm_cfg, moment_dtype)
             for i in range(0, B, batch)]
    if len(parts) == 1:
        return parts[0]
    return ScanDesc(*[torch.cat(xs) for xs in zip(*parts)])
