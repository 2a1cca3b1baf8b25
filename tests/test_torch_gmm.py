"""The port's GMM refinement math against torch.autograd and against JAX.

- gmm_value_grad_hess vs autograd of gmm_cost in float64, where the closed
  form must agree to 1e-9 relative (the derivation, not rounding, is tested);
- gmm_value is bit-identical to gmm_value_grad_hess's value;
- init_correlation and optimize_correlation vs JAX on the same float32
  inputs: correlations to rtol 1e-4 (PARITY.md's record band), select_pairs
  masks exactly, and poses to atol 2e-3 cells: the cost is flat at the
  optimum, so float32 rounding in the cost moves the LM's end pose by up to
  ~1e-3 cells (the band the card-vs-CPU stream check uses too).
"""

import numpy as np
import pytest
import torch

from contour_context_tpu_torch.config import GMMOptConfig
from contour_context_tpu_torch.ops import gmm as tg

torch.set_num_threads(2)

SCALE = GMMOptConfig().cov_dilate_scale


def _rand_scans(rng, C, G=4, K=12):
    """(C, G, K, ...) numpy GMM tables: PD covariances with the point-sigma
    floor, 80% of ellipses weighted (test_gmm_grad.py's generator)."""
    mus = rng.uniform(10.0, 140.0, (C, G, K, 2)).astype(np.float32)
    th = rng.uniform(0, np.pi, (C, G, K))
    l0 = rng.uniform(1.0, 4.0, (C, G, K))
    l1 = l0 + rng.uniform(0.0, 20.0, (C, G, K))
    c, s = np.cos(th), np.sin(th)
    covs = np.empty((C, G, K, 2, 2), np.float32)
    covs[..., 0, 0] = c * c * l1 + s * s * l0
    covs[..., 0, 1] = covs[..., 1, 0] = c * s * (l1 - l0)
    covs[..., 1, 1] = s * s * l1 + c * c * l0
    ws = np.where(rng.random((C, G, K)) < 0.8,
                  rng.uniform(5.0, 400.0, (C, G, K)), 0.0).astype(np.float32)
    return dict(mus=mus, covs=covs, ws=ws,
                majax=np.sqrt(l1).astype(np.float32),
                auto_corr=rng.uniform(1e3, 1e4, C).astype(np.float32))


def _torch_scan(d, i=None, dtype=torch.float32):
    pick = (lambda x: x) if i is None else (lambda x: x[i])
    return tg.GmmScan(**{k: torch.from_numpy(np.asarray(pick(v))).to(dtype)
                         for k, v in d.items()})


def _overlapping(rng, C):
    """Sources that are the target seen from C poses near the identity
    (inverse-rotated and shifted, with 0.1-cell noise), and starting poses
    near each true pose, as the cascade's estimate hands them to the LM."""
    tgt = {k: v[0] for k, v in _rand_scans(rng, 1).items()}
    p_true = np.stack([rng.uniform(-2, 2, C), rng.uniform(-2, 2, C),
                       rng.uniform(-0.05, 0.05, C)], 1)
    c, s = np.cos(p_true[:, 2]), np.sin(p_true[:, 2])
    R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)  # (C,2,2)
    d = tgt["mus"][None] - p_true[:, None, None, :2]
    src = {k: np.repeat(v[None], C, 0) for k, v in tgt.items()}
    src["mus"] = (np.einsum("cba,cgkb->cgka", R, d)
                  + rng.normal(0, 0.1, d.shape)).astype(np.float32)
    src["covs"] = np.einsum("cba,gkbd,cde->cgkae", R, tgt["covs"],
                            R).astype(np.float32)
    T0 = p_true + np.stack([rng.normal(0, 0.3, C), rng.normal(0, 0.3, C),
                            rng.normal(0, 0.01, C)], 1)
    return src, tgt, T0.astype(np.float32)


def test_value_grad_hess_matches_autograd():
    rng = np.random.default_rng(11)
    C = 4
    src_np, tgt_np, T0 = _overlapping(rng, C)
    src = _torch_scan(src_np, dtype=torch.float64)
    tgt = _torch_scan(tgt_np, dtype=torch.float64)
    T = torch.from_numpy(T0).double()
    sel = tg.select_pairs(src, tgt, T)
    assert sel.sum() > 0
    f, g, H = tg.gmm_value_grad_hess(T, src, tgt, sel, SCALE)
    for c in range(C):
        one = tg.GmmScan(*[x[c:c + 1] for x in src])

        def cost(p):
            return tg.gmm_cost(p[None], one, tgt, sel[c:c + 1], SCALE)[0]

        p = T[c].clone()
        g_ref = torch.autograd.functional.jacobian(cost, p)
        H_ref = torch.autograd.functional.hessian(cost, p)
        torch.testing.assert_close(f[c], cost(p), rtol=1e-9, atol=0)
        torch.testing.assert_close(g[c], g_ref, rtol=1e-7,
                                   atol=1e-9 * float(g_ref.abs().max()))
        torch.testing.assert_close(H[c], H_ref, rtol=1e-7,
                                   atol=1e-9 * float(H_ref.abs().max()))


def test_value_only_is_bit_identical():
    rng = np.random.default_rng(3)
    src_np, tgt_np, T0 = _overlapping(rng, 6)
    src, tgt = _torch_scan(src_np), _torch_scan(tgt_np)
    T = torch.from_numpy(T0)
    sel = tg.select_pairs(src, tgt, T)
    f, _, _ = tg.gmm_value_grad_hess(T, src, tgt, sel, SCALE)
    assert torch.equal(tg.gmm_value(T, src, tgt, sel, SCALE), f)


@pytest.mark.parametrize("seed", [0, 1])
def test_init_and_optimize_match_jax(seed):
    import jax
    import jax.numpy as jnp

    from contour_context_tpu.ops import gmm as jg

    rng = np.random.default_rng(seed)
    C = 8
    src_np, tgt_np, T = _overlapping(rng, C)
    js = jg.GmmScan(**{k: jnp.asarray(v) for k, v in src_np.items()})
    jt = jg.GmmScan(**{k: jnp.asarray(v) for k, v in tgt_np.items()})
    c0_j, sel_j = jg.init_correlation(js, jt, jnp.asarray(T), scale=SCALE)
    c1_j, T1_j = jg.optimize_correlation(js, jt, jnp.asarray(T), sel_j,
                                         scale=SCALE, iters=10)
    c0_j, sel_j, c1_j, T1_j = jax.device_get((c0_j, sel_j, c1_j, T1_j))

    ts, tt = _torch_scan(src_np), _torch_scan(tgt_np)
    c0, sel = tg.init_correlation(ts, tt, torch.from_numpy(T), scale=SCALE)
    c1, T1 = tg.optimize_correlation(ts, tt, torch.from_numpy(T), sel,
                                     scale=SCALE, iters=10)
    np.testing.assert_array_equal(sel.numpy(), sel_j)
    np.testing.assert_allclose(c0.numpy(), c0_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(c1.numpy(), c1_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(T1.numpy(), T1_j, rtol=1e-4, atol=2e-3)
    assert (c1_j > c0_j).any() and sel_j.any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lm_float32_vs_float64(seed):
    """The witness for the 2e-3-cell pose band: on the same inputs, the
    float32 LM's end pose strays from a float64 LM's by that order (up to
    2.1e-3 cells over these seeds), while the correlations agree to 1e-4.
    So two float32 paths (JAX and the port, the card and the CPU) can differ
    by about 2e-3 cells in the pose without either being wrong."""
    rng = np.random.default_rng(seed)
    src_np, tgt_np, T = _overlapping(rng, 8)
    out = []
    for dt in (torch.float32, torch.float64):
        src, tgt = _torch_scan(src_np, dtype=dt), _torch_scan(tgt_np, dtype=dt)
        T0 = torch.from_numpy(T).to(dt)
        c0, sel = tg.init_correlation(src, tgt, T0, scale=SCALE)
        c1, T1 = tg.optimize_correlation(src, tgt, T0, sel, scale=SCALE,
                                         iters=10)
        assert T1.dtype == dt and (c1 > c0).any()
        out.append((c1.double().numpy(), T1.double().numpy()))
    (c32, T32), (c64, T64) = out
    np.testing.assert_allclose(c32, c64, rtol=1e-4, atol=1e-6)
    assert np.abs(T32 - T64).max() < 3e-3
