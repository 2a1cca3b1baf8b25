"""The ring kernel's plain version in the order of the one-read-a-scan design
(csrc/ring_key.cu: one 8-CTA cluster a scan, the pool cut into 8-row
stripes dealt to the CTAs in turn), on the CPU against JAX.

- `ring_key_divs_batch_plain` against the Pallas ring kernel (interpret
  mode, one scan at a time) and `ring_key_divs_reference` on the smoke's
  shapes (36 anchors, a 4096-pixel pool) at B = 3: divisions to rtol/atol
  1e-5 (float32 summation order), counts exact.
- Row b of the batch bit-equal to the B = 1 call.
- The pool's edges: an empty pool (P = 0), a pool with no ok pixel, every
  pixel counting for every anchor, and P = 1, 4095 and 4097 (no multiple of
  the cluster's split): counts exact, divisions against the float64 sum of
  the same terms (the band stated in each test).
- The order: the plain version equals, bit for bit, a numpy sum in the
  order that the kernel's constants (kCluster, kStripe, read from the
  source) define, and the wrapper passes those constants to the launcher.
The kernel itself runs on the card in test_torch_cuda.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu_torch import kernel_times as kt
from contour_context_tpu_torch.config import ContourManagerConfig
from contour_context_tpu_torch.ops import kernels
from contour_context_tpu_torch.utils.io import pad_points

torch.set_num_threads(2)

ROI = 10.0
CU = Path(kernels.__file__).resolve().parent.parent / "csrc" / "ring_key.cu"


def _centers():
    return torch.arange(35, dtype=torch.float32) * (ROI / 35) + 0.5 * (ROI / 35)


@pytest.fixture(scope="module")
def real3():
    """anchors (3, 36, 8), pool (3, 4096, 8) of three rendered scans, built
    by the port's descriptor stages (tests/synth.py, seeds 1-3)."""
    cfg = ContourManagerConfig(max_points=16384)
    world = make_world(0)
    pts = np.stack([pad_points(render_scan(world, (6.0 * i, 1.0 * i, 0.1 * i),
                                           seed=1 + i), cfg.max_points)
                    for i in range(3)])
    from contour_context_tpu_torch.config import PipelineConfig

    anchors, pool, centers = kt.ring_inputs_of(
        torch.from_numpy(pts), PipelineConfig(cm=cfg))
    assert anchors.shape == (3, 36, 8) and pool.shape == (3, 4096, 8)
    return anchors, pool, centers


def _terms(anchors, pool, centers):
    """(B, A8, P) counted mask and (B, A8, P, 35) terms w * g, by the plain
    version's own elementwise ops."""
    an = anchors[..., None, :]
    pl = pool[:, None]
    in_box = ((pl[..., 0] >= an[..., 2]) & (pl[..., 0] <= an[..., 3])
              & (pl[..., 1] >= an[..., 4]) & (pl[..., 1] <= an[..., 5]))
    dr = pl[..., 2] - an[..., 0]
    dc = pl[..., 3] - an[..., 1]
    dist = torch.sqrt(dr * dr + dc * dc)
    lim = float(torch.tensor(ROI, dtype=torch.float32) - 1e-2)
    counted = in_box & (dist < lim) & (pl[..., 5] > 0)
    x = centers - dist[..., None]
    g = torch.exp(-0.5 * (x * x)) * kernels.INV_SQRT_2PI
    return counted, pl[..., 4][..., None] * g


def _f64_sum(anchors, pool, centers):
    counted, terms = _terms(anchors, pool, centers)
    return (terms.double() * counted[..., None]).sum(-2), counted.sum(-1)


def _cu_const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", CU.read_text())
    assert m, name
    return int(m.group(1))


def test_ring_batch_plain_matches_pallas_and_reference(real3):
    from contour_context_tpu.ops.pallas_kernels import (
        ring_key_divs_pallas, ring_key_divs_reference)

    anchors, pool, centers = real3
    d_t, c_t = kernels.ring_key_divs_batch_plain(anchors, pool, centers, ROI)
    for b in range(3):
        a_j, p_j, c_j = (jnp.asarray(x.numpy())
                         for x in (anchors[b], pool[b], centers))
        d_p, n_p = ring_key_divs_pallas(a_j, p_j, c_j, ROI, 35,
                                        interpret=True)
        d_r, n_r = ring_key_divs_reference(a_j, p_j, c_j, ROI)
        for d_j, n_j in ((d_p, n_p), (d_r, n_r)):
            np.testing.assert_allclose(d_t[b].numpy(), np.asarray(d_j),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(c_t[b].numpy(), np.asarray(n_j))
    assert (c_t.sum((1,)) > 100).all()


def test_ring_batch_rows_equal_single(real3):
    anchors, pool, centers = real3
    divs, counts = kernels.ring_key_divs_batch_plain(anchors, pool, centers,
                                                     ROI)
    for b in range(3):
        d1, c1 = kernels.ring_key_divs_plain(anchors[b], pool[b], centers,
                                             ROI)
        assert torch.equal(divs[b], d1) and torch.equal(counts[b], c1), b


@pytest.mark.parametrize("case", ["P 0", "no ok pixel", "all counting",
                                  "P 1", "P 4095", "P 4097"])
def test_ring_pool_edges(real3, case):
    """Counts exact; divisions against float64 sums of the same float32
    terms, to rtol 1e-5 (atol 1e-5) where an anchor sums tens of pixels and
    rtol 1e-4 where every one of 4096 pixels counts (a float32 sum of 4096
    positive terms, in any order, can be ~n * 2^-24 off)."""
    anchors, pool, centers = real3
    rtol = 1e-5
    if case == "P 0":
        pool = pool[:, :0]
    elif case == "no ok pixel":
        pool = pool.clone()
        pool[..., 5] = 0.0
    elif case == "all counting":
        anchors, pool, centers = kt.ring_worst_case("cpu", B=1)
        rtol = 1e-4
    else:
        P = int(case.split()[1])
        anchors, pool = kt.ring_random_case("cpu", 2, 36, P, seed=P)
    divs, counts = kernels.ring_key_divs_batch_plain(anchors, pool, centers,
                                                     ROI)
    d64, n = _f64_sum(anchors, pool, centers)
    assert torch.equal(counts, n.float())
    np.testing.assert_allclose(divs.double().numpy(), d64.numpy(), rtol=rtol,
                               atol=1e-5)
    for b in range(anchors.shape[0]):
        d1, c1 = kernels.ring_key_divs_plain(anchors[b], pool[b], centers,
                                             ROI)
        assert torch.equal(divs[b], d1) and torch.equal(counts[b], c1), b
    if case in ("P 0", "no ok pixel"):
        assert not divs.any() and not counts.any()
    if case == "all counting":
        assert (counts == pool.shape[1]).all()
    if case == "P 4097":
        assert counts.sum() > 0


def _ordered_sum(counted, terms, cluster: int, stripe: int):
    """numpy float32: rank r = (p // stripe) % cluster sums its counted
    terms from 0 in pixel order, then the ranks' sums are added from 0 in
    rank order."""
    counted, terms = counted.numpy(), terms.numpy()
    B, A8, P, D = terms.shape
    rank = np.arange(P) // stripe % cluster
    out = np.zeros((B, A8, D), np.float32)
    for b in range(B):
        for a in range(A8):
            part = np.zeros((cluster, D), np.float32)
            for p in np.nonzero(counted[b, a])[0]:
                part[rank[p]] = part[rank[p]] + terms[b, a, p]
            v = np.zeros(D, np.float32)
            for r in range(cluster):
                v = v + part[r]
            out[b, a] = v
    return out


def test_plain_order_matches_kernel_constants():
    """The plain version sums in the order the kernel's source defines, bit
    for bit, with the split the kernel's source defines (kCluster,
    kStripe); another split gives other bits on this input."""
    cluster, stripe = _cu_const("kCluster"), _cu_const("kStripe")
    assert (kernels.CLUSTER, kernels.RING_STRIPE) == (cluster, stripe)
    assert _cu_const("kRows") % stripe == 0
    anchors, pool, centers = kt.ring_worst_case("cpu", B=1, A8=4, P=700)
    counted, terms = _terms(anchors, pool, centers)
    divs, _ = kernels.ring_key_divs_batch_plain(anchors, pool, centers, ROI)
    want = _ordered_sum(counted, terms, cluster, stripe)
    np.testing.assert_array_equal(divs.numpy(), want)
    other = _ordered_sum(counted, terms, cluster // 2, stripe)
    assert not np.array_equal(other, want)
    assert np.array_equal(kernels.ring_ranks(20, "cpu").numpy(),
                          np.arange(20) // stripe % cluster)


def test_ring_many_anchors_plain():
    """65535 anchors a scan (the launcher's limit): rows equal single calls
    and counts equal a direct count."""
    anchors, pool = kt.ring_random_case("cpu", 2, 65535, 64, seed=5)
    centers = _centers()
    divs, counts = kernels.ring_key_divs_batch_plain(anchors, pool, centers,
                                                     ROI)
    counted, _ = _terms(anchors[:, :8], pool, centers)
    assert torch.equal(counts[:, :8], counted.sum(-1).float())
    assert counts.sum() > 1000
    d1, c1 = kernels.ring_key_divs_plain(anchors[1], pool[1], centers, ROI)
    assert torch.equal(divs[1], d1) and torch.equal(counts[1], c1)
