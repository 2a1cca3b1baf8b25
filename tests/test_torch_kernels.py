"""The port's two kernels (their plain torch twins on the CPU) against JAX.

- ring_key_divs_plain vs the Pallas ring kernel (interpret mode) and its XLA
  reference, on a random fixture and on a real scan's pixel pool: divisions
  to rtol/atol 1e-5 (float32 summation order), counts exact.
- The port's key search (plain stage 1 + stage 2) vs db._search_impl with
  strategy="cover2" at NA = 24576 (so JAX's cover2 really runs) on an
  adversarial store (zero rows, duplicated keys, a searchable cutoff, an
  invalid query anchor), and at a small store against JAX's single-stage
  top_k: gidx, seq_src and valid exact, dist within 1e-5.
- Hit sets vs the Pallas tile-min search kernel (interpret mode).
- The plain tile-min's masking past searchable_n, which the kernel's early
  exit relies on.
The kernels themselves run on the card in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu_torch.config import ContourManagerConfig
from contour_context_tpu_torch.utils.io import pad_points
from contour_context_tpu_torch.db import keys_to_q_layout, search
from contour_context_tpu_torch.ops import kernels

torch.set_num_threads(2)

QL = (1, 2, 3)
NNK = 50


def _ring_fixture():
    rng = np.random.default_rng(0)
    A8, P, D = 8, 256, 35
    anchors = np.zeros((A8, 8), np.float32)
    anchors[:, 0] = rng.uniform(20, 120, A8)
    anchors[:, 1] = rng.uniform(20, 120, A8)
    anchors[:, 2] = anchors[:, 0] - 11
    anchors[:, 3] = anchors[:, 0] + 11
    anchors[:, 4] = anchors[:, 1] - 11
    anchors[:, 5] = anchors[:, 1] + 11
    anchors[:, 6] = 1.0
    pool = np.zeros((P, 8), np.float32)
    pool[:, 2] = rng.uniform(0, 150, P)
    pool[:, 3] = rng.uniform(0, 150, P)
    pool[:, 0] = np.floor(pool[:, 2])
    pool[:, 1] = np.floor(pool[:, 3])
    pool[:, 4] = rng.integers(0, 5, P)
    pool[:, 5] = (rng.random(P) < 0.8)
    centers = (np.arange(D, dtype=np.float32) + 0.5) * (10.0 / D)
    return anchors, pool, centers


def _ring_real():
    """anchors/pool of a real scan's make_keys (36 anchors, 4096 pixels)."""
    from contour_context_tpu_torch.ops import descriptor as td

    cfg = ContourManagerConfig(max_points=16384)
    pts = torch.from_numpy(pad_points(
        render_scan(make_world(0), (0.0, 0.0, 0.0), seed=1), cfg.max_points))
    bev, rowf, colf = td.rasterize_bev(pts, cfg)
    masks = bev.reshape(cfg.n_row, cfg.n_col)[None] > \
        torch.tensor(cfg.lv_grads)[:, None, None]
    tab = td.component_tables(td.cc_labels(masks),
                              masks.reshape(cfg.n_levels, -1), bev, rowf,
                              colf, cfg)
    anchors, pool, centers, _ = td.ring_inputs(tab, bev, rowf, colf, cfg)
    assert anchors.shape == (36, 8) and pool.shape == (4096, 8)
    assert int(pool[:, 5].sum()) > 100          # a real, populated pool
    return anchors.numpy(), pool.numpy(), centers.numpy()


@pytest.mark.parametrize("which", ["fixture", "real_pool"])
def test_ring_plain_matches_pallas_and_reference(which):
    from contour_context_tpu.ops.pallas_kernels import (
        ring_key_divs_pallas, ring_key_divs_reference)

    anchors, pool, centers = (_ring_fixture() if which == "fixture"
                              else _ring_real())
    d_t, c_t = kernels.ring_key_divs_plain(
        torch.from_numpy(anchors), torch.from_numpy(pool),
        torch.from_numpy(centers), 10.0)
    d_p, c_p = ring_key_divs_pallas(jnp.asarray(anchors), jnp.asarray(pool),
                                    jnp.asarray(centers), 10.0,
                                    len(centers), interpret=True)
    d_r, c_r = ring_key_divs_reference(jnp.asarray(anchors),
                                       jnp.asarray(pool),
                                       jnp.asarray(centers), 10.0)
    for d_j, c_j in ((d_p, c_p), (d_r, c_r)):
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert float(c_t.sum()) > 0


def test_wrappers_take_plain_version_on_cpu():
    anchors, pool, centers = _ring_fixture()
    a, p, c = (torch.from_numpy(x) for x in (anchors, pool, centers))
    kernels.reset_launches()
    d0, n0 = kernels.ring_key_divs(a, p, c, 10.0)
    d1, n1 = kernels.ring_key_divs_plain(a, p, c, 10.0)
    assert torch.equal(d0, d1) and torch.equal(n0, n1)
    kq = torch.rand((6, 10, 1000)).to(torch.bfloat16)
    q = torch.rand((3, 6, 10))
    state = torch.tensor([150, 120], dtype=torch.int32)
    t0 = kernels.search_tilemin(kq, QL, q, state)
    assert torch.equal(t0, kernels.search_tilemin_plain(kq, QL, q, state))
    assert t0.shape == (3, 6, 8)
    assert kernels.ring_key_divs.launches == 0
    assert kernels.search_tilemin.launches == 0


@pytest.mark.parametrize("capacity", [65, 300])
@pytest.mark.parametrize("where", ["none", "one", "mid_tile", "all"])
def test_tilemin_plain_is_max_past_searchable(capacity, where):
    """The contract the kernel's early exit relies on: every tile wholly at
    or past searchable_n * A is exactly MAX_DIST_SQ, whatever the keys past
    that column hold, and the tiles before it do not change when those keys
    do. NA = 6 * capacity: 390 (not a multiple of 8) and 1800."""
    A = 6
    sn = {"none": 0, "one": 1, "mid_tile": 30, "all": capacity}[where]
    kb, qk = _search_fixture(400)
    kq = keys_to_q_layout(torch.from_numpy(kb[1:capacity + 1]),
                          torch.bfloat16).contiguous()
    NA = kq.shape[2]
    q = torch.from_numpy(qk[list(QL)])
    state = torch.tensor([capacity, sn], dtype=torch.int32)
    out = kernels.search_tilemin_plain(kq, QL, q, state)
    assert out.shape == (3, A, -(-NA // kernels.TILE))
    past = torch.arange(out.shape[2]) * kernels.TILE >= sn * A
    assert (out[..., past] == kernels.MAX_DIST_SQ).all()
    assert bool((out[..., ~past] < kernels.MAX_DIST_SQ).any()) == (sn > 0)
    noisy = kq.clone()
    noisy[:, :, sn * A:] = torch.rand(noisy[:, :, sn * A:].shape) * 9.0
    assert torch.equal(kernels.search_tilemin_plain(noisy, QL, q, state), out)


def _search_fixture(N):
    rng = np.random.default_rng(4)
    L, A, D = 6, 6, 10
    kb = rng.uniform(0.1, 5.0, (N, L, A, D)).astype(np.float32)
    kb[::7] = 0.0                       # invalid rows
    kb[100:200] = kb[300:400]           # duplicated keys -> distance ties
    qk = rng.uniform(0.1, 5.0, (L, A, D)).astype(np.float32)
    qk[2, 3] = 0.0                      # an invalid query anchor
    return kb, qk


@pytest.fixture(scope="module")
def big_store():
    """N = 4096 scans (NA = 24576 >= 4 * TOPK_BLOCK: JAX runs cover2)."""
    kb, qk = _search_fixture(4096)
    return kb, qk, 3600


def _jax_search(kq_np, qk, sn, nnk=NNK):
    from contour_context_tpu.db import _search_impl

    fn = jax.jit(_search_impl, static_argnames=("q_levels", "nnk",
                                                "strategy"))
    return [np.asarray(x) for x in fn(jnp.asarray(kq_np), jnp.asarray(qk),
                                      jnp.int32(sn), q_levels=QL, nnk=nnk,
                                      strategy="cover2")]


def _torch_search(kq_t, qk, sn, nnk=NNK):
    state = torch.tensor([kq_t.shape[2] // qk.shape[1], sn],
                         dtype=torch.int32)
    return [x.numpy() for x in search(kq_t, torch.from_numpy(qk), state, QL,
                                      nnk)]


@pytest.mark.parametrize("keys_dtype", ["f32", "bf16"])
def test_search_matches_jax_cover2(big_store, keys_dtype):
    from contour_context_tpu.db import _keys_to_q_layout

    kb, qk, sn = big_store
    jdt = jnp.bfloat16 if keys_dtype == "bf16" else None
    kq_j = np.asarray(_keys_to_q_layout(jnp.asarray(kb), jdt))
    kq_t = keys_to_q_layout(
        torch.from_numpy(kb),
        torch.bfloat16 if keys_dtype == "bf16" else None).contiguous()
    if keys_dtype == "bf16":     # both round to nearest-even: same bits
        np.testing.assert_array_equal(kq_t.view(torch.uint16).numpy(),
                                      kq_j.view(np.uint16))
    g0, s0, d0, v0 = _jax_search(kq_j, qk, sn)
    g1, s1, d1, v1 = _torch_search(kq_t, qk, sn)
    np.testing.assert_array_equal(g1, g0)
    np.testing.assert_array_equal(s1, s0)
    np.testing.assert_array_equal(v1, v0)
    np.testing.assert_allclose(d1, d0, rtol=0, atol=1e-5)
    assert v0.sum() > 30 and (g0[v0] < sn).all()
    assert not v0[np.abs(qk[list(QL)]).sum(-1) == 0].any()


def test_search_matches_jax_small_store():
    """NA = 240: JAX takes its single top_k; the port's tile path takes
    both tiles (k = nnk > ceil(NA/128)) and must give the same answer."""
    from contour_context_tpu.db import _keys_to_q_layout

    kb, qk = _search_fixture(400)
    kb, sn = kb[:40], 33
    kb[5:9] = kb[20:24]
    kq_j = np.asarray(_keys_to_q_layout(jnp.asarray(kb), jnp.bfloat16))
    kq_t = keys_to_q_layout(torch.from_numpy(kb), torch.bfloat16).contiguous()
    g0, s0, d0, v0 = _jax_search(kq_j, qk, sn)
    g1, s1, d1, v1 = _torch_search(kq_t, qk, sn)
    for a, b in ((g1, g0), (s1, s0), (v1, v0)):
        np.testing.assert_array_equal(a, b)
    # XLA fuses this branch's distance passes differently from cover2's
    # (FMA contraction), so distances agree to float32 rounding only
    np.testing.assert_allclose(d1, d0, rtol=0, atol=1e-5)
    assert v0.any()


def test_search_hits_match_pallas_tilemin(big_store):
    """Hit sets against the Pallas kernel (interpret mode), as
    test_pallas_kernels.py holds that kernel against _search_impl."""
    from contour_context_tpu.ops.pallas_kernels import search_tilemin_pallas

    kb, qk, sn = big_store
    g0, s0, d0, v0 = [np.asarray(x) for x in search_tilemin_pallas(
        jnp.asarray(kb), jnp.asarray(qk), jnp.int32(sn), QL, NNK,
        interpret=True, T=64, TC=1024)]
    kq_t = keys_to_q_layout(torch.from_numpy(kb)).contiguous()
    g1, s1, d1, v1 = _torch_search(kq_t, qk, sn)
    np.testing.assert_array_equal(v1, v0)
    hits0 = {(q, a, int(g0[q, a, k]), int(s0[q, a, k]))
             for q, a, k in zip(*np.nonzero(v0))}
    hits1 = {(q, a, int(g1[q, a, k]), int(s1[q, a, k]))
             for q, a, k in zip(*np.nonzero(v1))}
    assert hits0 == hits1 and len(hits0) > 30
    np.testing.assert_allclose(d1[v0], d0[v0], rtol=1e-4, atol=1e-4)
