"""The port on the card (marked `cuda`; each test skips without a GPU).

This file imports no jax, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

- both kernels against their plain versions (ring divs to 1e-5 and counts
  exact; tile minima bit-equal), at the main path's shapes and at the edge
  shapes (a ragged pool, an empty anchor box; searchable_n 0, 1, mid-store
  and full, NA % 8 != 0 and an unaligned store on the scalar path);
- a short revisit stream on the card against the same stream on the CPU:
  records equal (found, gidx and counters exactly, corr to rtol and atol
  1e-4, T to rtol 1e-4 and atol 2e-3 cells), and the kernels launched once
  per scan; the LM's inputs of each found query, replayed on the card and
  on a CPU copy of the store, agree (indices and masks exactly, floats to
  1e-5), so the pose band covers the LM alone (tests/test_torch_gmm.py
  holds the float32 LM against float64 on the same inputs).
"""

import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu_torch.config import ContourManagerConfig, PipelineConfig
from contour_context_tpu_torch.utils.io import pad_points
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.ops import kernels

QL = (1, 2, 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _ring_inputs(device):
    cfg = ContourManagerConfig(max_points=16384)
    pts = torch.from_numpy(pad_points(
        render_scan(make_world(0), (0.0, 0.0, 0.0), seed=1),
        cfg.max_points)).to(device)
    bev, rowf, colf = td.rasterize_bev(pts, cfg)
    masks = bev.reshape(cfg.n_row, cfg.n_col)[None] > \
        torch.tensor(cfg.lv_grads, device=device)[:, None, None]
    tab = td.component_tables(td.cc_labels(masks),
                              masks.reshape(cfg.n_levels, -1), bev, rowf,
                              colf, cfg)
    return td.ring_inputs(tab, bev, rowf, colf, cfg)[:3]


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda):
    anchors, pool, centers = _ring_inputs(cuda)
    d0, n0 = kernels.ring_key_divs(anchors, pool, centers, 10.0)
    d1, n1 = kernels.ring_key_divs_plain(anchors, pool, centers, 10.0)
    torch.testing.assert_close(d0, d1, rtol=1e-5, atol=1e-5)
    assert torch.equal(n0, n1) and float(n1.sum()) > 0
    rng = np.random.default_rng(4)
    kb = rng.uniform(0.1, 5.0, (8192, 6, 6, 10)).astype(np.float32)
    kb[::7] = 0.0
    kb[100:200] = kb[300:400]
    qk = rng.uniform(0.1, 5.0, (6, 6, 10)).astype(np.float32)
    qk[2, 3] = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        kq = tdb.keys_to_q_layout(torch.from_numpy(kb), dtype) \
            .contiguous().to(cuda)
        q = torch.from_numpy(qk[list(QL)]).to(cuda)
        state = torch.tensor([8192, 7000], dtype=torch.int32, device=cuda)
        assert torch.equal(kernels.search_tilemin(kq, QL, q, state),
                           kernels.search_tilemin_plain(kq, QL, q, state))


@pytest.mark.cuda
@pytest.mark.parametrize("n_pool", [4096, 4001, 37])
def test_ring_edge_shapes_on_card(cuda, n_pool):
    """A pool length that is no multiple of the block (or of the cluster's
    slices), and an anchor whose box is empty: counts exact, divs 1e-5."""
    anchors, pool, centers = _ring_inputs(cuda)
    anchors = anchors.clone()
    anchors[0, 2], anchors[0, 3] = 1.0, 0.0        # r_min > r_max
    pool = pool[:n_pool].clone()
    d0, n0 = kernels.ring_key_divs(anchors, pool, centers, 10.0)
    d1, n1 = kernels.ring_key_divs_plain(anchors, pool, centers, 10.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(d0, d1, rtol=1e-5, atol=1e-5)
    assert torch.equal(n0, n1) and float(n0[0]) == 0.0
    with pytest.raises(ValueError):                # float4 rows need 16 B
        kernels.ring_key_divs(anchors, pool.reshape(-1)[1:1 + 8 * 30]
                              .view(30, 8), centers, 10.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("capacity,sn,offset,path", [
    (8192, 0, 0, "vector"), (8192, 1, 0, "vector"),
    (8192, 7000, 0, "vector"), (8192, 8192, 0, "vector"),
    (65, 0, 0, "scalar"), (65, 1, 0, "scalar"), (65, 33, 0, "scalar"),
    (65, 65, 0, "scalar"), (8192, 7000, 1, "scalar")])
def test_tilemin_edge_shapes_on_card(cuda, dtype, capacity, sn, offset,
                                     path):
    """searchable_n 0, 1, mid-store and full; NA = 390 (not a multiple of
    8) and a base off 16-byte alignment take the scalar path: tile minima
    bit-equal to the plain version on both paths."""
    from contour_context_tpu_torch import kernel_times as kt

    kb, qk = kt.tile_store(capacity, seed=capacity)
    kq = kt.q_layout(kb, torch.bfloat16 if dtype == "bf16" else
                     torch.float32, cuda, offset)
    q = torch.from_numpy(qk[list(QL)]).to(cuda)
    state = torch.tensor([capacity, sn], dtype=torch.int32, device=cuda)
    assert kernels.search_tilemin_path(kq) == path
    out = kernels.search_tilemin(kq, QL, q, state)
    assert torch.equal(out, kernels.search_tilemin_plain(kq, QL, q, state))


@pytest.mark.cuda
def test_stream_on_card_matches_cpu(cuda):
    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
        (10.5, 0.8, 0.2), (30.0, -1.0, -0.15), (50.2, 0.7, 0.1)]
    clouds = [pad_points(render_scan(world, p, seed=500 + i), cfg.cm.max_points)
              for i, p in enumerate(poses)]
    recs = {}
    for dev in ("cpu", "cuda"):
        db = tdb.ContourDB(cfg, capacity=16, device=dev)
        kernels.reset_launches()
        for i, pts in enumerate(clouds):
            db.step_async(pts, i, 6.0 * i)
        recs[dev] = db.recs_store[:len(clouds)].cpu().numpy()
        if dev == "cuda":
            assert kernels.ring_key_divs.launches == len(clouds)
            assert kernels.search_tilemin.launches == len(clouds)
    a, b = recs["cpu"], recs["cuda"]
    exact = [0, 1] + list(range(6, 18))
    np.testing.assert_array_equal(b[:, exact], a[:, exact])
    np.testing.assert_allclose(b[:, 2], a[:, 2], rtol=1e-4, atol=1e-4)
    # the 10 LM iterations amplify the card's last-ulp differences (exp,
    # summation order) in the pose: T to rtol 1e-4 and atol 2e-3 cells
    found = a[:, 0] > 0.5
    np.testing.assert_allclose(b[found, 3:6], a[found, 3:6], rtol=1e-4,
                               atol=2e-3)
    assert found.sum() >= 2

    # the second witness for that band: replayed on the card's store, the
    # LM's inputs of each found query agree on the card and on the CPU, so
    # the pose difference arises inside the LM
    store_c = type(db.store)(*[x.cpu() for x in db.store])
    ts_c, tb = db.ts_store.cpu(), cfg.db.tb
    for row in np.nonzero(found)[0]:
        state = torch.zeros(2, dtype=torch.int32)
        for j in range(row):
            state[0] = j + 1
            tdb.update_window(state, ts_c, ts_c[j], tb.min_elapse,
                              tb.max_elapse)
        desc = td.build_descriptor(torch.from_numpy(clouds[row]).to(cuda),
                                   cfg.cm, cfg.gmm)
        r_g = tdb.refine_inputs(db.store, db.keys_q, desc, state.to(cuda),
                                cfg)
        r_c = tdb.refine_inputs(store_c, db.keys_q.cpu(),
                                type(desc)(*[x.cpu() for x in desc]), state,
                                cfg)
        for name in ("cand_gidx", "topi", "valid", "sel"):
            assert torch.equal(getattr(r_g, name).cpu(), getattr(r_c, name))
        for x, y in zip((r_g.T0,) + tuple(r_g.src) + tuple(r_g.tgt),
                        (r_c.T0,) + tuple(r_c.src) + tuple(r_c.tgt)):
            torch.testing.assert_close(x.cpu(), y, rtol=1e-5, atol=1e-5)
