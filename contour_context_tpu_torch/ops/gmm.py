"""Batched GMM L2 correlation + fixed-iteration Levenberg-Marquardt, in torch.

Port of `contour_context_tpu/ops/gmm.py` (correlation.h:49-238). Every
function here carries an explicit leading candidate axis where the JAX code
vmaps. The refiner uses the analytic value/gradient/Hessian, so nothing here
needs autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from contour_context_tpu_torch.config import GMMOptConfig
from contour_context_tpu_torch.types import device_const


class GmmScan(NamedTuple):
    mus: torch.Tensor    # (..., G, K, 2)
    covs: torch.Tensor   # (..., G, K, 2, 2)
    ws: torch.Tensor     # (..., G, K)
    majax: torch.Tensor  # (..., G, K)
    auto_corr: torch.Tensor  # (...)


def l2_pairwise(mus1, covs1, ws1, mus2, covs2, ws2, scale: float):
    """w1_j w2_k det(S)^-1/2 exp(-mu^T S^-1 mu / 2), S = scale (C1_j + C2_k);
    (..., K, ·) inputs -> (..., K, K) (gmm.py:33-47)."""
    S = scale * (covs1[..., :, None, :, :] + covs2[..., None, :, :, :])
    det = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    dmu = mus1[..., :, None, :] - mus2[..., None, :, :]
    d0, d1 = dmu[..., 0], dmu[..., 1]
    q = (S[..., 1, 1] * (d0 * d0) - 2 * S[..., 0, 1] * d0 * d1
         + S[..., 0, 0] * (d1 * d1)) / torch.clamp(det, min=1e-12)
    return (ws1[..., :, None] * ws2[..., None, :]
            * torch.rsqrt(torch.clamp(det, min=1e-12)) * torch.exp(-0.5 * q))


def gmm_from_desc(desc, gmm_cfg: GMMOptConfig) -> GmmScan:
    lev = device_const(tuple(gmm_cfg.levels), torch.long, desc.mean.device)
    K = gmm_cfg.max_gmm_ellipses
    ws = torch.where(desc.gmm_mask[lev][:, :K],
                     desc.cnt[lev][:, :K].to(torch.float32), 0.0)
    return GmmScan(mus=desc.mean[lev][:, :K], covs=desc.manual_cov[lev][:, :K],
                   ws=ws, majax=torch.sqrt(desc.eig_vals[lev][:, :K][..., 1]),
                   auto_corr=desc.auto_corr)


def _c(x):     # (C,) -> broadcast over (C, G, K)
    return x[:, None, None]


def select_pairs(src: GmmScan, tgt: GmmScan, T):
    """(C, G, K, K) close-pair masks under T (C, 3) (correlation.h:85-96)."""
    c, s = torch.cos(T[:, 2]), torch.sin(T[:, 2])
    m0, m1 = src.mus[..., 0], src.mus[..., 1]
    tx = _c(c) * m0 - _c(s) * m1 + _c(T[:, 0])
    ty = _c(s) * m0 + _c(c) * m1 + _c(T[:, 1])
    dx = tx[..., :, None] - tgt.mus[..., 0][None, :, None, :]
    dy = ty[..., :, None] - tgt.mus[..., 1][None, :, None, :]
    d = torch.sqrt(dx * dx + dy * dy)
    thr = 3.0 * (src.majax[..., :, None] + tgt.majax[None, :, None, :])
    return (d < thr) & (src.ws[..., :, None] > 0) & \
        (tgt.ws[None, :, None, :] > 0)


def gmm_cost(T, src: GmmScan, tgt: GmmScan, sel, scale: float):
    """Negative L2 product of src under T (C, 3) with tgt (gmm.py:79-92)."""
    c, s = _c(torch.cos(T[:, 2])), _c(torch.sin(T[:, 2]))
    R = ((c, -s), (s, c))
    cv = src.covs
    RC = [[R[a][0] * cv[..., 0, k] + R[a][1] * cv[..., 1, k] for k in (0, 1)]
          for a in (0, 1)]
    RCRt = torch.stack([torch.stack(
        [RC[a][0] * R[b][0] + RC[a][1] * R[b][1] for b in (0, 1)], -1)
        for a in (0, 1)], -2)
    m0, m1 = src.mus[..., 0], src.mus[..., 1]
    tmus = torch.stack([c * m0 - s * m1 + _c(T[:, 0]),
                        s * m0 + c * m1 + _c(T[:, 1])], dim=-1)
    val = l2_pairwise(tmus, RCRt, src.ws, tgt.mus[None], tgt.covs[None],
                      tgt.ws[None], scale)
    return -torch.where(sel, val, 0.0).sum(dim=(1, 2, 3))


def _corr_norm(src: GmmScan, tgt: GmmScan):
    return torch.sqrt(torch.clamp(src.auto_corr * tgt.auto_corr, min=1e-12))


def _J(z):          # source ellipse j -> pair grid
    return z[..., :, None]


def _Kx(z):         # target ellipse k -> pair grid
    return z[None, ..., None, :]


def _value_terms(T, src: GmmScan, tgt: GmmScan, sel, scale: float) -> dict:
    """The per-pair terms of gmm_cost under T (C, 3) on the (C, G, K, K)
    grid: rotated source covariances E, S = scale (E + C_k), offsets m,
    S^-1, alpha = S^-1 m, q and the pair values v (gmm.py:120-170)."""
    x, y = _c(T[:, 0])[..., None], _c(T[:, 1])[..., None]
    c, s = _c(torch.cos(T[:, 2])), _c(torch.sin(T[:, 2]))
    g2 = scale
    muj = src.mus
    a, b, d = src.covs[..., 0, 0], src.covs[..., 0, 1], src.covs[..., 1, 1]
    u0 = c * muj[..., 0] - s * muj[..., 1]
    u1 = s * muj[..., 0] + c * muj[..., 1]
    E00 = c * c * a - 2 * c * s * b + s * s * d
    E01 = c * s * (a - d) + (c * c - s * s) * b
    E11 = s * s * a + 2 * c * s * b + c * c * d
    ck = tgt.covs
    S00 = g2 * (_J(E00) + _Kx(ck[..., 0, 0]))
    S01 = g2 * (_J(E01) + _Kx(ck[..., 0, 1]))
    S11 = g2 * (_J(E11) + _Kx(ck[..., 1, 1]))
    m0 = _J(u0) + x - _Kx(tgt.mus[..., 0])
    m1 = _J(u1) + y - _Kx(tgt.mus[..., 1])
    det = torch.clamp(S00 * S11 - S01 * S01, min=1e-12)
    inv_det = 1.0 / det
    I00 = S11 * inv_det
    I01 = -S01 * inv_det
    I11 = S00 * inv_det
    al0 = I00 * m0 + I01 * m1
    al1 = I01 * m0 + I11 * m1
    q = m0 * al0 + m1 * al1
    w = torch.where(sel, _J(src.ws) * _Kx(tgt.ws), 0.0)
    v = w * torch.rsqrt(det) * torch.exp(-0.5 * q)
    return dict(u0=u0, u1=u1, E00=E00, E01=E01, E11=E11, I00=I00, I01=I01,
                I11=I11, al0=al0, al1=al1, v=v)


def gmm_value(T, src: GmmScan, tgt: GmmScan, sel, scale: float):
    """gmm_cost (C,) alone, bit-identical to gmm_value_grad_hess's value."""
    return -_value_terms(T, src, tgt, sel, scale)["v"].sum(dim=(1, 2, 3))


def gmm_value_grad_hess(T, src: GmmScan, tgt: GmmScan, sel, scale: float):
    """Analytic (cost (C,), gradient (C, 3), Hessian (C, 3, 3)) of gmm_cost
    w.r.t. (x, y, theta); term by term the derivation of gmm.py:99-218."""
    t = _value_terms(T, src, tgt, sel, scale)
    g2 = scale
    u0, u1, E00, E01, E11 = t["u0"], t["u1"], t["E00"], t["E01"], t["E11"]
    I00, I01, I11 = t["I00"], t["I01"], t["I11"]
    al0, al1, v = t["al0"], t["al1"], t["v"]
    J = _J
    S00t = -2 * g2 * J(E01)
    S01t = g2 * J(E00 - E11)
    S11t = 2 * g2 * J(E01)
    S00tt = -2 * g2 * J(E00 - E11)
    S01tt = -4 * g2 * J(E01)
    S11tt = 2 * g2 * J(E00 - E11)
    mt0, mt1 = J(-u1), J(u0)
    mtt0, mtt1 = J(-u0), J(-u1)

    Lx, Ly = -al0, -al1
    Sta0 = S00t * al0 + S01t * al1
    Sta1 = S01t * al0 + S11t * al1
    trt = I00 * S00t + 2 * I01 * S01t + I11 * S11t
    qt = 2 * (mt0 * al0 + mt1 * al1) - (al0 * Sta0 + al1 * Sta1)
    Lt = -0.5 * trt - 0.5 * qt
    Lxx, Lxy, Lyy = -I00, -I01, -I11
    bt0 = I00 * mt0 + I01 * mt1
    bt1 = I01 * mt0 + I11 * mt1
    dl0 = I00 * Sta0 + I01 * Sta1
    dl1 = I01 * Sta0 + I11 * Sta1
    at0, at1 = bt0 - dl0, bt1 - dl1
    Lxt, Lyt = -at0, -at1
    Mt00 = I00 * S00t + I01 * S01t
    Mt01 = I00 * S01t + I01 * S11t
    Mt10 = I01 * S00t + I11 * S01t
    Mt11 = I01 * S01t + I11 * S11t
    trtt = -(Mt00 * Mt00 + 2 * Mt01 * Mt10 + Mt11 * Mt11) \
        + (I00 * S00tt + 2 * I01 * S01tt + I11 * S11tt)
    qtt = (2 * (mtt0 * al0 + mtt1 * al1)
           + 2 * (mt0 * at0 + mt1 * at1)
           - 2 * (at0 * Sta0 + at1 * Sta1)
           - (al0 * al0 * S00tt + 2 * al0 * al1 * S01tt
              + al1 * al1 * S11tt))
    Ltt = -0.5 * trtt - 0.5 * qtt

    def red(z):
        return (v * z).sum(dim=(1, 2, 3))

    f = -v.sum(dim=(1, 2, 3))
    grad = -torch.stack([red(Lx), red(Ly), red(Lt)], dim=1)
    hxx, hxy, hxt = red(Lx * Lx + Lxx), red(Lx * Ly + Lxy), red(Lx * Lt + Lxt)
    hyy, hyt, htt = red(Ly * Ly + Lyy), red(Ly * Lt + Lyt), red(Lt * Lt + Ltt)
    hess = -torch.stack([torch.stack([hxx, hxy, hxt], 1),
                         torch.stack([hxy, hyy, hyt], 1),
                         torch.stack([hxt, hyt, htt], 1)], 1)
    return f, grad, hess


def init_correlation(src: GmmScan, tgt: GmmScan, T_init, scale: float = 2.0):
    """Batched initProblem (correlation.h:175-202): src batched over C,
    T_init (C, 3) -> (corr (C,), sel (C, G, K, K))."""
    sel = select_pairs(src, tgt, T_init)
    cost = gmm_cost(T_init, src, tgt, sel, scale)
    return -cost / _corr_norm(src, tgt), sel


def _solve3(A, b):
    """Batched closed-form 3x3 solve by the adjugate (gmm.py:246-262)."""
    c00 = A[:, 1, 1] * A[:, 2, 2] - A[:, 1, 2] * A[:, 2, 1]
    c01 = A[:, 1, 2] * A[:, 2, 0] - A[:, 1, 0] * A[:, 2, 2]
    c02 = A[:, 1, 0] * A[:, 2, 1] - A[:, 1, 1] * A[:, 2, 0]
    c10 = A[:, 0, 2] * A[:, 2, 1] - A[:, 0, 1] * A[:, 2, 2]
    c11 = A[:, 0, 0] * A[:, 2, 2] - A[:, 0, 2] * A[:, 2, 0]
    c12 = A[:, 0, 1] * A[:, 2, 0] - A[:, 0, 0] * A[:, 2, 1]
    c20 = A[:, 0, 1] * A[:, 1, 2] - A[:, 0, 2] * A[:, 1, 1]
    c21 = A[:, 0, 2] * A[:, 1, 0] - A[:, 0, 0] * A[:, 1, 2]
    c22 = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    det = A[:, 0, 0] * c00 + A[:, 0, 1] * c01 + A[:, 0, 2] * c02
    adj = torch.stack([torch.stack([c00, c10, c20], 1),
                       torch.stack([c01, c11, c21], 1),
                       torch.stack([c02, c12, c22], 1)], 1)
    x = (adj * b[:, None, :]).sum(dim=2)
    return x / torch.where(det.abs() > 1e-30, det, 1e-30)[:, None]


def optimize_correlation(src: GmmScan, tgt: GmmScan, T_init, sel,
                         scale: float = 2.0, iters: int = 10):
    """Batched LM refinement of (x, y, theta), `iters` fixed iterations
    (gmm.py:237-291). Returns (corr (C,), T_opt (C, 3))."""
    eye = torch.eye(3, dtype=T_init.dtype, device=T_init.device)
    p = T_init
    f = gmm_value(p, src, tgt, sel, scale)
    lam = torch.full_like(f, 1e-3)
    for _ in range(iters):
        _, g, Hm = gmm_value_grad_hess(p, src, tgt, sel, scale)
        A = Hm + lam[:, None, None] * eye
        p_new = p + _solve3(A + 1e-9 * eye, -g)
        f_new = gmm_value(p_new, src, tgt, sel, scale)
        ok = (f_new < f) & torch.isfinite(p_new).all(dim=1)
        p = torch.where(ok[:, None], p_new, p)
        f = torch.where(ok, f_new, f)
        lam = torch.where(ok, lam * 0.33, lam * 10.0)
    return -f / _corr_norm(src, tgt), p
