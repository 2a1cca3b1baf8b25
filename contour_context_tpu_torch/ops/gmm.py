"""Batched GMM L2 correlation + fixed-iteration Levenberg-Marquardt, in torch.

Port of `contour_context_tpu/ops/gmm.py` (correlation.h:49-238). Every
function here carries explicit leading axes where the JAX code vmaps: the
candidates of a query, or the queries of a batch and their candidates. The refiner uses the analytic value/gradient/Hessian, so nothing here
needs autograd. On a CUDA device the LM refinement is one launch of the
kernel of csrc/gmm_lm.cu (`optimize_correlation`); its plain twin
`optimize_correlation_plain` sums over the pair grid in the kernel's order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from contour_context_tpu_torch.config import GMMOptConfig
from contour_context_tpu_torch.ops import kernels
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
    """The GmmScans (B, G, K, ...) of a B-stacked ScanDesc."""
    lev = device_const(tuple(gmm_cfg.levels), torch.long, desc.mean.device)
    K = gmm_cfg.max_gmm_ellipses
    ws = torch.where(desc.gmm_mask[:, lev][:, :, :K],
                     desc.cnt[:, lev][:, :, :K].to(torch.float32), 0.0)
    return GmmScan(mus=desc.mean[:, lev][:, :, :K],
                   covs=desc.manual_cov[:, lev][:, :, :K], ws=ws,
                   majax=torch.sqrt(desc.eig_vals[:, lev][:, :, :K][..., 1]),
                   auto_corr=desc.auto_corr)


# Every function below takes sources with any leading axes (..., G, K, ·),
# poses T (..., 3) and a target whose leading axes broadcast against the
# sources': one target for all rows (G, K, ·), or B targets (B, 1, G, K, ·)
# against (B, C, G, K, ·) sources, each row with its own query's GMM. Each
# reduction runs over the trailing (G, K, K) grid of one row, so a row's
# value does not depend on how many rows there are.

_GRID = (-3, -2, -1)


def _c(x):     # (...) -> broadcast over (..., G, K)
    return x[..., None, None]


def _J(z):          # source ellipse j -> pair grid
    return z[..., :, None]


def _Kx(z):         # target ellipse k -> pair grid
    return z[..., None, :]


def select_pairs(src: GmmScan, tgt: GmmScan, T):
    """(..., G, K, K) close-pair masks under T (..., 3)
    (correlation.h:85-96)."""
    c, s = torch.cos(T[..., 2]), torch.sin(T[..., 2])
    m0, m1 = src.mus[..., 0], src.mus[..., 1]
    tx = _c(c) * m0 - _c(s) * m1 + _c(T[..., 0])
    ty = _c(s) * m0 + _c(c) * m1 + _c(T[..., 1])
    dx = _J(tx) - _Kx(tgt.mus[..., 0])
    dy = _J(ty) - _Kx(tgt.mus[..., 1])
    d = torch.sqrt(dx * dx + dy * dy)
    thr = 3.0 * (_J(src.majax) + _Kx(tgt.majax))
    return (d < thr) & (_J(src.ws) > 0) & (_Kx(tgt.ws) > 0)


def gmm_cost(T, src: GmmScan, tgt: GmmScan, sel, scale: float):
    """Negative L2 product of src under T (..., 3) with tgt (gmm.py:79-92)."""
    c, s = _c(torch.cos(T[..., 2])), _c(torch.sin(T[..., 2]))
    R = ((c, -s), (s, c))
    cv = src.covs
    RC = [[R[a][0] * cv[..., 0, k] + R[a][1] * cv[..., 1, k] for k in (0, 1)]
          for a in (0, 1)]
    RCRt = torch.stack([torch.stack(
        [RC[a][0] * R[b][0] + RC[a][1] * R[b][1] for b in (0, 1)], -1)
        for a in (0, 1)], -2)
    m0, m1 = src.mus[..., 0], src.mus[..., 1]
    tmus = torch.stack([c * m0 - s * m1 + _c(T[..., 0]),
                        s * m0 + c * m1 + _c(T[..., 1])], dim=-1)
    val = l2_pairwise(tmus, RCRt, src.ws, tgt.mus, tgt.covs, tgt.ws, scale)
    return -torch.where(sel, val, 0.0).sum(dim=_GRID)


def _corr_norm(src: GmmScan, tgt: GmmScan):
    return torch.sqrt(torch.clamp(src.auto_corr * tgt.auto_corr, min=1e-12))


def _value_terms(T, src: GmmScan, tgt: GmmScan, sel, scale: float) -> dict:
    """The per-pair terms of gmm_cost under T (..., 3) on the (..., G, K, K)
    grid: rotated source covariances E, S = scale (E + C_k), offsets m,
    S^-1, alpha = S^-1 m, q and the pair values v (gmm.py:120-170)."""
    x, y = _c(T[..., 0])[..., None], _c(T[..., 1])[..., None]
    c, s = _c(torch.cos(T[..., 2])), _c(torch.sin(T[..., 2]))
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
    """gmm_cost (...) alone, bit-identical to gmm_value_grad_hess's value."""
    return -_value_terms(T, src, tgt, sel, scale)["v"].sum(dim=_GRID)


def _grad_hess_terms(T, src: GmmScan, tgt: GmmScan, sel, scale: float):
    """The per-pair terms of gmm_cost's gradient and Hessian under T (...,
    3) on the (..., G, K, K) grid: the pair values v and the nine products
    v * z whose sums are (minus) the gradient (x, y, theta) and the Hessian
    entries xx, xy, xt, yy, yt, tt; term by term the derivation of
    gmm.py:99-218."""
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
    return v, [v * z for z in (
        Lx, Ly, Lt, Lx * Lx + Lxx, Lx * Ly + Lxy, Lx * Lt + Lxt,
        Ly * Ly + Lyy, Ly * Lt + Lyt, Lt * Lt + Ltt)]


def _grad_hess(sums):
    """(gradient (..., 3), Hessian (..., 3, 3)) from the nine sums of
    `_grad_hess_terms`' products, (..., 9)."""
    gx, gy, gt, hxx, hxy, hxt, hyy, hyt, htt = sums.unbind(-1)
    grad = -torch.stack([gx, gy, gt], dim=-1)
    hess = -torch.stack([torch.stack([hxx, hxy, hxt], -1),
                         torch.stack([hxy, hyy, hyt], -1),
                         torch.stack([hxt, hyt, htt], -1)], -2)
    return grad, hess


def gmm_value_grad_hess(T, src: GmmScan, tgt: GmmScan, sel, scale: float):
    """Analytic (cost (...), gradient (..., 3), Hessian (..., 3, 3)) of
    gmm_cost w.r.t. (x, y, theta), each a torch sum over the pair grid."""
    v, terms = _grad_hess_terms(T, src, tgt, sel, scale)
    grad, hess = _grad_hess(torch.stack([z.sum(dim=_GRID) for z in terms],
                                        dim=-1))
    return -v.sum(dim=_GRID), grad, hess


def init_correlation(src: GmmScan, tgt: GmmScan, T_init, scale: float = 2.0):
    """Batched initProblem (correlation.h:175-202): T_init (..., 3) ->
    (corr (...), sel (..., G, K, K))."""
    sel = select_pairs(src, tgt, T_init)
    cost = gmm_cost(T_init, src, tgt, sel, scale)
    return -cost / _corr_norm(src, tgt), sel


def _solve3(A, b):
    """Batched closed-form 3x3 solve by the adjugate (gmm.py:246-262):
    A (..., 3, 3), b (..., 3); each entry of adj(A) b summed left to
    right, as csrc/gmm_lm.cu sums it."""
    def a(i, j):
        return A[..., i, j]

    c00 = a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)
    c01 = a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2)
    c02 = a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)
    c10 = a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2)
    c11 = a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0)
    c12 = a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1)
    c20 = a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)
    c21 = a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)
    c22 = a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)
    det = a(0, 0) * c00 + a(0, 1) * c01 + a(0, 2) * c02
    b0, b1, b2 = b.unbind(-1)
    x = torch.stack([c00 * b0 + c10 * b1 + c20 * b2,
                     c01 * b0 + c11 * b1 + c21 * b2,
                     c02 * b0 + c12 * b1 + c22 * b2], dim=-1)
    return x / torch.where(det.abs() > 1e-30, det, 1e-30)[..., None]


# csrc/gmm_lm.cu's CTA (kThreads there; a CPU test reads it out of the
# source): thread t of a row's CTA sums the row's pairs t, t + LM_THREADS,
# ... of the flattened (G, K, K) grid from 0 in that order, then the warps
# add their 32 sums in a shuffle tree and the 16 warps' sums in another
LM_THREADS = 512
_WARP = 32


def _halve(x):
    """Sum the last axis (a power of two long) by halving: entry i adds
    entry i + n/2, and again, down to one; the shuffle tree's order."""
    n = x.shape[-1]
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:2 * n]
    return x[..., 0]


def _kernel_sum(z):
    """(..., G, K, K) -> (...): the sum over the pair grid in the LM
    kernel's order, each add rounded on its own: each thread's strided
    sum from 0 (the grid padded with zeros to whole rounds of LM_THREADS,
    which leave a sum unchanged), then the tree in each warp, then the
    tree over the warps."""
    lead = z.shape[:-3]
    P = z.shape[-3] * z.shape[-2] * z.shape[-1]
    rounds = -(-P // LM_THREADS)
    z = torch.nn.functional.pad(z.reshape(lead + (P,)),
                                (0, rounds * LM_THREADS - P))
    z = z.reshape(lead + (rounds, LM_THREADS))
    acc = torch.zeros(lead + (LM_THREADS,), dtype=z.dtype, device=z.device)
    for i in range(rounds):
        acc = acc + z[..., i, :]
    acc = _halve(acc.reshape(lead + (LM_THREADS // _WARP, _WARP)))
    return _halve(acc)


def optimize_correlation_plain(src: GmmScan, tgt: GmmScan, T_init, sel,
                               scale: float = 2.0, iters: int = 10):
    """Batched LM refinement of (x, y, theta), `iters` fixed iterations
    (gmm.py:237-291), every row of T_init (..., 3) on its own. Returns
    (corr (...), T_opt (..., 3)). The plain twin of the LM kernel
    (csrc/gmm_lm.cu): its sums over the pair grid run in the kernel's order
    (`_kernel_sum`), so on the card the kernel equals it bit for bit."""
    eye = torch.eye(3, dtype=T_init.dtype, device=T_init.device)
    p = T_init
    f = -_kernel_sum(_value_terms(p, src, tgt, sel, scale)["v"])
    lam = torch.full_like(f, 1e-3)
    for _ in range(iters):
        _, terms = _grad_hess_terms(p, src, tgt, sel, scale)
        g, Hm = _grad_hess(_kernel_sum(torch.stack(terms, dim=-4)))
        A = Hm + lam[..., None, None] * eye
        p_new = p + _solve3(A + 1e-9 * eye, -g)
        f_new = -_kernel_sum(_value_terms(p_new, src, tgt, sel, scale)["v"])
        ok = (f_new < f) & torch.isfinite(p_new).all(dim=-1)
        p = torch.where(ok[..., None], p_new, p)
        f = torch.where(ok, f_new, f)
        lam = torch.where(ok, lam * 0.33, lam * 10.0)
    return -f / _corr_norm(src, tgt), p


def lm_rows(src: GmmScan, tgt: GmmScan, T_init, sel):
    """The LM kernel's rows: T_init's leading indices, R in all. Returns
    (src [mus, covs, ws, auto_corr] (R, ...), tgt the same (n, ...), T_init
    (R, 3), sel (R, G, K, K)), target i serving rows i R/n .. (i+1) R/n - 1:
    the query path's targets broadcast so, (B, 1) against (B, F) rows and
    one against (n,). Raises ValueError for targets of any other shape."""
    lead = tuple(T_init.shape[:-1])
    R = math.prod(lead)
    lead_t = tuple(tgt.ws.shape[:-2])
    lt = (1,) * (len(lead) - len(lead_t)) + lead_t
    i = len(lt)                 # the targets' axes before their trailing 1s
    while i > 0 and lt[i - 1] == 1:
        i -= 1
    # checked by hand: torch.broadcast_shapes imports sympy at its first
    # call (1-3 s)
    if len(lt) != len(lead) or lt[:i] != lead[:i]:
        raise ValueError(f"optimize_correlation: targets {lead_t} do not "
                         f"map onto rows {lead} (target i serving rows "
                         f"i R/n .. (i+1) R/n - 1)")
    n = math.prod(lt)

    def flat(scan, rows):
        return [x.reshape((rows,) + x.shape[x.dim() - t:]) for x, t in
                ((scan.mus, 3), (scan.covs, 4), (scan.ws, 2),
                 (scan.auto_corr, 0))]

    G, K = src.ws.shape[-2:]
    src = src._replace(auto_corr=torch.broadcast_to(src.auto_corr, lead))
    return (flat(src, R), flat(tgt, n), T_init.reshape(R, 3),
            sel.reshape(R, G, K, K))


def optimize_correlation(src: GmmScan, tgt: GmmScan, T_init, sel,
                         scale: float = 2.0, iters: int = 10):
    """Kernel wrapper of `optimize_correlation_plain` (same signature and
    outputs, bit-identical on the card): CPU tensors take the plain twin;
    CUDA tensors run every iteration of every row in one launch of the LM
    kernel (`kernels.gmm_lm`, on the rows of `lm_rows`)."""
    if T_init.device.type == "cpu":
        return optimize_correlation_plain(src, tgt, T_init, sel, scale, iters)
    if T_init.device.type != "cuda":
        raise ValueError(f"optimize_correlation: unsupported device "
                         f"{T_init.device}")
    lead = tuple(T_init.shape[:-1])
    corr, T = kernels.gmm_lm(*lm_rows(src, tgt, T_init, sel), scale, iters)
    return corr.reshape(lead), T.reshape(lead + (3,))
