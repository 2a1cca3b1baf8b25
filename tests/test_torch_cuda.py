"""The port on the card (marked `cuda`; each test skips without a GPU).

This file imports no jax, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

- both kernels against their plain versions, bit for bit (the ring's plain
  version sums in the kernel's order), at the main path's shapes and at the
  edge shapes (a ragged pool, an empty anchor box; searchable_n 0, 1,
  mid-store and full, NA % 8 != 0 and an unaligned store on the scalar
  path);
- the batched ring key bit-equal to its plain version and to one single
  launch a scan at B = 1, 16 and 17, with a zero cloud's empty pool in the
  batch, and at B = 1, 2, 16, 17 and 64 on rendered clouds, an empty pool,
  a pool in which every pixel counts for every anchor, pools of 1, 4095
  and 4097 rows and 1, 49 and 150 anchors a scan; a block of 16 built
  batched on the card against the same block built on the CPU (ints
  exactly, floats in the descriptor bands), with one ring launch;
- the batched tile-min against its plain version at the smoke's shapes
  (bf16 and f32, the vector and the scalar path, mixed limits), B = 1 equal
  to the single-query kernel, a B that is no multiple of the kernel's query
  group; at B = 1, 3, 4, 5, 16, 17 and 33 with every limit 0, every limit
  full and mixed limits, bf16 and f32, on both paths;
- a map built in blocks on the card equal to the same map built on the CPU
  (store and keys_q bit for bit but for the float leaves' device bands, the
  records in the stream's bands), one batched launch a block, and its
  checkpoint reloaded on the card equal to it bit for bit (reloaded on the
  CPU: but for the last bit of the recomputed sqrt in gmm_pack);
- a ragged batch of queries through the batched tail on the card against
  the same queries one at a time (B = 1) on the card and against the batch
  on the CPU: found, gidx and counters exactly, corr and pose in the record
  bands (CUDA's reduce kernels may split a sum differently at another row
  count), with `dynamic_thres` too; the batched tail makes at most 2 host
  syncs a block whatever B (6 with `dynamic_thres`);
- `run_blocked` and `run_chained` on the card (their staging goes through
  pinned buffers guarded by CUDA events) against `run`: the same outcome
  lines, correlation to 1e-4;
- a short revisit stream on the card against the same stream on the CPU:
  records equal (found, gidx and counters exactly, corr to rtol and atol
  1e-4, T to rtol 1e-4 and atol 2e-3 cells), and the kernels launched once
  per scan; the LM's inputs of each found query, replayed on the card and
  on a CPU copy of the store, agree (indices and masks exactly, floats to
  1e-5), so the pose band covers the LM alone (tests/test_torch_gmm.py
  holds the float32 LM against float64 on the same inputs);
- chains on the card (`step_chain_dyn_async`, a staged k): one BlockHandle
  a chain, one launch of each kernel a scan, records equal to the CPU's in
  the record bands;
- the host spec query on the card equal to the same queries on the CPU,
  one tile-min launch a query;
- the online spinner on the card: its detections equal the found records
  of a step_async stream, and a kernel wrapper's error on the spin thread
  reaches finish();
- `run_chained` on the card staging its groups through the native block
  reader: the outcome of `run`;
- the multi-GPU layer at a world of one rank over NCCL in this process:
  `sharded_search`, `sharded_query_step` and `sharded_localize_block` on
  the card equal the single-device paths with f32 keys_q bit for bit (the
  same code on the same rows of the same card), through the tile-min and
  the batched ring kernels;
- one dispatch: the CC-label kernel bit-equal to its plain version on the
  adversarial masks (150 x 150, 37 x 41, 8 x 8 and 5 x 7: the cluster's
  strips of many rows, one row and none) and on a scan's and a block's
  level masks; the merge kernel bit-equal to its plain version on the
  inputs of B = 1 and B = 16 queries, on random rows and on rows made to
  stress its lanes; the LM kernel bit-equal to its plain twin on the
  inputs of B = 1 and B = 16 queries ((B, 10) rows), at the host spec
  query's broadcast, an odd K, empty close-pair masks and a non-finite
  trial step, near the torch chain it replaced (every row in bounds read
  on an H100, each query's best row the same), and its graphed replay
  bit-equal to the eager call; the stream as CUDA graph replays (f32 and
  q16 payloads, across two grows, each capturing again) bit-equal to the
  eager body it captured, each kernel counted once a step, replays
  included; 20 graphed steps and a chain of 16 with no host sync (sync
  debug mode "error"); blocks and serving chunks as build and query graph
  replays bit-equal to the eager calls, with no host sync.
- every stage a replay: the two dynamic-threshold kernels bit-equal to
  their plain versions at the edges and on revisit queries' inputs; the
  pipeline's default (unfused) path and `run_blocked`, with and without
  `dynamic_thres`, as replays writing the outcome file of the eager bodies
  bit for bit, with no host sync after the captures, a `query_async`
  record equal to `step_async`'s for the same scan and window state; two
  DBs with graphs of 8 holding one pool, and one DB's `drop_graphs`
  leaving the other's replays right.
- the last entry points as replays: `range_search` (bf16 and f32 keys_q,
  an 8-scan DB and its rows tiled 64 times, five radius / cap cases, a cap
  above the tile count among them) one replay of its cap's graph with one
  host sync, equal to the eager body and to a CPU copy; at world 1 over
  NCCL sharded serving, the query step and two block steps through one
  graph as replays with no host sync (sync debug mode "error"), bit-equal
  to their eager bodies and to the single-device f32 path.
- the check cascade as one kernel launch: bit-equal to its plain twin (run
  on the card) on the rows made to take each edge at p_pot 8, 128 and
  None, on the hint rows of B = 1, 4, 5 and 16 revisit queries at the
  default caps and of B = 5 at the squeezed caps (HC 96, W 40: a clamped
  last chunk), idle columns' zeros included; one launch a step and a
  serving chunk (counted with every kernel in the launch tests above); a
  refused launch raises.
"""

import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu_torch.config import (ContourDBConfig,
                                              ContourManagerConfig,
                                              PipelineConfig)
from contour_context_tpu_torch.utils.io import pad_points
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch import kernel_times as kt
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.ops import gmm as tg
from contour_context_tpu_torch.ops import kernels

QL = (1, 2, 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _ring_inputs(device):
    from contour_context_tpu_torch import kernel_times as kt

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    pts = torch.from_numpy(pad_points(
        render_scan(make_world(0), (0.0, 0.0, 0.0), seed=1),
        cfg.cm.max_points)).to(device)
    anchors, pool, centers = kt.ring_inputs_of(pts[None], cfg)
    return anchors[0], pool[0], centers


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda):
    anchors, pool, centers = _ring_inputs(cuda)
    d0, n0 = kernels.ring_key_divs(anchors, pool, centers, 10.0)
    d1, n1 = kernels.ring_key_divs_plain(anchors, pool, centers, 10.0)
    assert torch.equal(d0, d1)
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
    slices), and an anchor whose box is empty: bit-equal."""
    anchors, pool, centers = _ring_inputs(cuda)
    anchors = anchors.clone()
    anchors[0, 2], anchors[0, 3] = 1.0, 0.0        # r_min > r_max
    pool = pool[:n_pool].clone()
    d0, n0 = kernels.ring_key_divs(anchors, pool, centers, 10.0)
    d1, n1 = kernels.ring_key_divs_plain(anchors, pool, centers, 10.0)
    torch.cuda.synchronize()
    assert torch.equal(d0, d1)
    assert torch.equal(n0, n1) and float(n0[0]) == 0.0
    with pytest.raises(ValueError):                # float4 rows need 16 B
        kernels.ring_key_divs(anchors, pool.reshape(-1)[1:1 + 8 * 30]
                              .view(30, 8), centers, 10.0)


def _block_clouds(n=16):
    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(11, n_structs=220, extent=160.0)
    clouds = np.stack([pad_points(render_scan(
        world, (10.0 * (i % 8) + 0.4 * (i // 8), 0.3 * (i // 8), 0.0),
        seed=500 + i), 16384) for i in range(n)])
    return cfg, clouds


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 17])
def test_ring_batch_matches_plain_and_singles_on_card(cuda, B):
    """One batched launch bit-equal to its plain version and to one single
    launch a scan; for B > 1 row 1 is a zero cloud's pool (no pixel ok)."""
    from contour_context_tpu_torch import kernel_times as kt

    cfg, clouds = _block_clouds(B)
    if B > 1:
        clouds[1] = 0.0
    anchors, pool, centers = kt.ring_inputs_of(
        torch.from_numpy(clouds).to(cuda), cfg)
    kernels.reset_launches()
    kt.hold_ring_batch(anchors, pool, centers, cfg.cm.roi_radius, f"B {B}")
    assert kernels.ring_key_divs_batch.launches == 1
    assert kernels.ring_key_divs.launches == B
    assert B == 1 or not pool[1, :, 5].any()
    with pytest.raises(ValueError):                # float4 rows need 16 B
        kernels.ring_key_divs_batch(
            anchors[:1], pool.reshape(-1)[1:1 + 8 * 30].view(1, 30, 8),
            centers, 10.0)


RING_EDGES = ["real", "empty pool", "all counting", "P 1", "P 4095",
              "P 4097", "A8 1", "A8 49", "A8 150"]


@pytest.mark.cuda
@pytest.mark.parametrize("edge", RING_EDGES)
@pytest.mark.parametrize("B", [1, 2, 16, 17, 64])
def test_ring_pool_once_matches_plain_on_card(cuda, B, edge):
    """The one-read-a-scan ring kernel bit-equal to its plain version and to
    one single launch a scan, at B = 1, 2, 16, 17 and 64, on rendered
    clouds (a zero cloud in row 1), an empty pool, a pool in which every
    pixel counts for every anchor, pools of 1, 4095 and 4097 rows, and 1,
    49 and 150 anchors a scan (each pass of 48 re-arms the barriers the
    partials are pushed on)."""
    from contour_context_tpu_torch import kernel_times as kt

    centers = None
    if edge in ("real", "empty pool"):
        cfg, clouds = _block_clouds(min(B, 16))
        if B > 1:
            clouds[1] = 0.0
        anchors, pool, centers = kt.ring_inputs_of(
            torch.from_numpy(clouds).to(cuda), cfg)
        reps = -(-B // anchors.shape[0])
        anchors = anchors.repeat(reps, 1, 1)[:B].contiguous()
        pool = pool.repeat(reps, 1, 1)[:B].contiguous()
        if edge == "empty pool":
            pool = pool[:, :0].contiguous()
    elif edge == "all counting":
        anchors, pool, centers = kt.ring_worst_case(cuda, B=B)
    elif edge.startswith("P "):
        anchors, pool = kt.ring_random_case(cuda, B, 36, int(edge[2:]),
                                            seed=B)
    else:                                  # anchors around passes of 48
        anchors, pool = kt.ring_random_case(cuda, B, int(edge[3:]), 4096,
                                            seed=B)
    if centers is None:
        centers = (torch.arange(35, dtype=torch.float32, device=cuda) + 0.5) \
            * (10.0 / 35)
    kernels.reset_launches()
    kt.hold_ring_batch(anchors, pool, centers, 10.0, f"B {B} {edge}")
    torch.cuda.synchronize()
    assert kernels.ring_key_divs_batch.launches == 1
    assert kernels.ring_key_divs.launches == B
    _, counts = kernels.ring_key_divs_batch_plain(anchors, pool, centers, 10.0)
    if edge == "empty pool":
        assert not counts.any()
    if edge == "all counting":
        assert (counts == pool.shape[1]).all()


@pytest.mark.cuda
def test_block_built_batched_on_card_matches_cpu(cuda):
    """A block of 16 built in one batch on the card against the same block
    on the CPU: ints and bools exactly, floats in the descriptor bands of
    tests/test_torch_descriptor.py; one ring launch for the block."""
    cfg, clouds = _block_clouds(16)
    kernels.reset_launches()
    g = td.build_descriptors(torch.from_numpy(clouds).to(cuda), cfg.cm,
                             cfg.gmm)
    assert kernels.ring_key_divs_batch.launches == 1
    assert kernels.ring_key_divs.launches == 0
    c = td.build_descriptors(torch.from_numpy(clouds), cfg.cm, cfg.gmm)
    loose = ("com_r", "eig_vecs", "manual_cov", "gmm_pack", "tab12", "keys")
    for name, x, y in zip(c._fields, g, c):
        x = x.cpu()
        if name == "nei_theta":
            x, y = x[c.nei_valid], y[c.nei_valid]
        if x.is_floating_point():
            torch.testing.assert_close(
                x, y, rtol=1e-4 if name == "keys" else 1e-5,
                atol=1e-4 if name in loose else 1e-5, msg=name)
        else:
            assert torch.equal(x, y), name
    assert int(c.n_cont.sum()) > 16 * 20


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
def test_tilemin_batch_matches_plain_on_card(cuda):
    from contour_context_tpu_torch import kernel_times as kt
    from contour_context_tpu_torch.config import PipelineConfig

    for line in kt.batch_edge_cases(cuda, PipelineConfig()):
        assert "bit-equal" in line
    # a B that is no multiple of the kernel's query group, random limits
    kb, _ = kt.tile_store(300, seed=3)
    kq = kt.q_layout(kb, torch.bfloat16, cuda)
    q_b = torch.rand((70, 3, 6, 10), device=cuda) * 5.0
    sb = torch.randint(0, 320, (70,), dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    out = kernels.search_tilemin_batch(kq, QL, q_b, sb)
    assert torch.equal(out, kernels.search_tilemin_batch_plain(
        kq, QL, q_b, sb))
    assert kernels.search_tilemin_batch.launches == 1
    with pytest.raises(ValueError):
        kernels.search_tilemin_batch(kq, QL, q_b[:0], sb[:0])
    with pytest.raises(TypeError):
        kernels.search_tilemin_batch(kq, QL, q_b[:4], sb[:4].long())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["vector", "scalar"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("limits", ["all 0", "all full", "mixed"])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 16, 17, 33])
def test_tilemin_balanced_batch_matches_plain_on_card(cuda, B, limits, dtype,
                                                      path):
    """The balanced batched tile-min bit-equal to its plain version at B =
    1, 3, 4, 5, 16, 17 and 33, with every limit 0, every limit the whole
    store, or mixed limits (0, 1, mid-store, full and past it), in bf16 and
    f32, on the vector path (capacity 8192) and the scalar path (capacity
    65: NA = 390, no multiple of 8); one launch."""
    from contour_context_tpu_torch import kernel_times as kt

    N = 8192 if path == "vector" else 65
    kb, _ = kt.tile_store(N, seed=B)
    kq = kt.q_layout(kb, torch.bfloat16 if dtype == "bf16" else
                     torch.float32, cuda)
    assert kernels.search_tilemin_path(kq) == path
    q_b = torch.from_numpy(kt.batch_queries(B, seed=B)[:, list(QL)]) \
        .to(cuda).contiguous()
    if limits == "all 0":
        sn = [0] * B
    elif limits == "all full":
        sn = [N] * B
    else:
        pick = (0, 1, N // 2, N, N + 7, 33, N - 1)
        sn = [pick[(b * 5) % len(pick)] for b in range(B)]
    sb = torch.tensor(sn, dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    kt.hold_batch(kq, QL, q_b, sb, f"B {B} {limits} {dtype} {path}")
    assert kernels.search_tilemin_batch.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("A", [1, 5, 7, 16])
def test_tilemin_batch_other_anchor_counts_on_card(cuda, A):
    """Anchor counts other than the main path's 6 (the kernel's generic
    path: 8 anchors a reduction), bf16 keys, mixed limits: bit-equal to the
    plain version."""
    rng = np.random.default_rng(A)
    N, B = 300, 19
    kb = rng.uniform(0.1, 5.0, (N, 6, A, 10)).astype(np.float32)
    kb[::7] = 0.0
    kq = tdb.keys_to_q_layout(torch.from_numpy(kb), torch.bfloat16) \
        .contiguous().to(cuda)
    q_b = torch.from_numpy(rng.uniform(0.1, 5.0, (B, 3, A, 10))
                           .astype(np.float32)).to(cuda)
    q_b[2, 1, A - 1] = 0.0                     # an invalid query anchor
    sb = torch.from_numpy(rng.integers(0, N + 20, B).astype(np.int32)) \
        .to(cuda)
    out = kernels.search_tilemin_batch(kq, QL, q_b, sb)
    assert torch.equal(out, kernels.search_tilemin_batch_plain(
        kq, QL, q_b, sb))
    assert (out[2, 1, A - 1] == kernels.MAX_DIST_SQ).all()


@pytest.mark.cuda
def test_block_built_map_on_card_matches_cpu(cuda, tmp_path):
    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
        (10.5, 0.8, 0.2), (30.0, -1.0, -0.15), (50.2, 0.7, 0.1),
        (20.3, 0.5, -0.1)]
    clouds = np.stack([pad_points(render_scan(world, p, seed=500 + i),
                                  cfg.cm.max_points)
                       for i, p in enumerate(poses)])
    dbs = {}
    for dev in ("cpu", "cuda"):
        db = tdb.ContourDB(cfg, capacity=16, device=dev)
        kernels.reset_launches()
        db.block_chain_pts_async(
            torch.from_numpy(clouds).reshape(3, 4, -1, 4), list(range(12)),
            [[6.0 * (4 * k + i) for i in range(4)] for k in range(3)])
        if dev == "cuda":
            assert kernels.search_tilemin_batch.launches == 3
            assert kernels.search_tilemin.launches == 0
            assert kernels.ring_key_divs_batch.launches == 3
            assert kernels.ring_key_divs.launches == 0
        dbs[dev] = db
    c, g = dbs["cpu"], dbs["cuda"]
    a, b = c.recs_store[:12].numpy(), g.recs_store[:12].cpu().numpy()
    exact = [0, 1] + list(range(6, 18))
    np.testing.assert_array_equal(b[:, exact], a[:, exact])
    np.testing.assert_allclose(b[:, 2], a[:, 2], rtol=1e-4, atol=1e-4)
    found = a[:, 0] > 0.5
    np.testing.assert_allclose(b[found, 3:6], a[found, 3:6], rtol=1e-4,
                               atol=2e-3)
    assert [int(x) for x in a[8:, 1]] == [1, 3, 5, 2]
    assert torch.equal(g.state.cpu(), c.state)
    # the descriptor bands of tests/test_torch_descriptor.py
    for name, x, y in zip(g.store._fields, g.store, c.store):
        x = x.cpu()
        if name == "nei_theta":
            x, y = x[c.store.nei_valid], y[c.store.nei_valid]
        if x.is_floating_point():
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4, msg=name)
        else:
            assert torch.equal(x, y), name
    # a checkpoint of the card's map, reloaded on the card and on the CPU
    path = str(tmp_path / "map.npz")
    g.save(path, chunk_bytes=8192)
    for dev in ("cuda", "cpu"):
        back = tdb.ContourDB.load(path, cfg, device=dev)
        for name, x, y in zip(g.store._fields, back.store, g.store):
            if dev == "cpu" and name == "gmm_pack":
                # recomputed on load with the CPU's sqrt, which rounds
                # another last bit than the card's
                torch.testing.assert_close(x, y.cpu(), rtol=1e-6, atol=0)
            else:
                assert torch.equal(x.cpu(), y.cpu()), name
        assert torch.equal(back.keys_q.cpu().view(torch.int16),
                           g.keys_q.cpu().view(torch.int16))
        assert torch.equal(back.state.cpu(), g.state.cpu())
        assert back.ts == g.ts and back.seq_of_gidx == g.seq_of_gidx
    res = g.localize_block_async(clouds[8:12], chunk=3).get()
    assert [r[0] for r in res] == [8, 3, 5, 2]
    assert g.serving_counters["n_hints"] > 0


def _assert_records(b, a):
    exact = [0, 1] + list(range(6, 18))
    np.testing.assert_array_equal(b[:, exact], a[:, exact])
    np.testing.assert_allclose(b[:, 2], a[:, 2], rtol=1e-4, atol=1e-4)
    found = a[:, 0] > 0.5
    np.testing.assert_allclose(b[found, 3:6], a[found, 3:6], rtol=1e-4,
                               atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dynamic", [False, True])
def test_batched_tail_on_card_matches_single_and_cpu(cuda, dynamic):
    """The ragged batch of tests/test_torch_batch.py (a zero cloud, a query
    with no valid hit, caps that overflow for some queries only) on the
    card: the batch against each query alone, and against the CPU."""
    from contour_context_tpu_torch.config import ContourDBConfig
    from contour_context_tpu_torch.profile_step import host_syncs

    def cfg_of(**db):
        return PipelineConfig(cm=ContourManagerConfig(max_points=16384),
                              db=ContourDBConfig(dynamic_thres=dynamic, **db))

    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
        (10.5, 0.8, 0.2), (30.0, -1.0, -0.15), (50.2, 0.7, 0.1),
        (20.3, 0.5, -0.1)]
    clouds = np.stack([pad_points(render_scan(world, p, seed=500 + i), 16384)
                       for i, p in enumerate(poses)])
    db = tdb.ContourDB(cfg_of(), capacity=16, device="cuda")
    for i in range(12):
        db.step_async(clouds[i], i, 6.0 * i)
    queries = np.stack([clouds[8], np.zeros_like(clouds[0]), clouds[9],
                        clouds[10], clouds[7], clouds[11]])
    searchable = [12, 12, 0, 12, 5, 12]
    descs = td.build_descriptors(torch.from_numpy(queries).to(cuda),
                                 db.cfg.cm, db.cfg.gmm)
    descs_c = type(descs)(*[x.cpu() for x in descs])
    store_c = type(db.store)(*[x.cpu() for x in db.store])
    sb = torch.tensor(searchable, dtype=torch.int32, device=cuda)
    for cfg in (cfg_of(), cfg_of(max_check_cands=160, cascade_chunk=64,
                                 max_pass_hints=24, max_cand_poses=3)):
        recs = tdb.query_step_batch(db.store, db.keys_q, descs, sb, cfg)
        ones = torch.stack([tdb.query_step(
            db.store, db.keys_q, type(descs)(*[x[b] for x in descs]),
            torch.tensor([12, searchable[b]], dtype=torch.int32,
                         device=cuda), cfg) for b in range(len(searchable))])
        _assert_records(recs.cpu().numpy(), ones.cpu().numpy())
        recs_c = tdb.query_step_batch(store_c, db.keys_q.cpu(), descs_c,
                                      sb.cpu(), cfg)
        _assert_records(recs.cpu().numpy(), recs_c.numpy())
        assert recs[0, 0] == 1 and recs[1, 0] == 0 and recs[2, 0] == 0
        hits = tdb.search_batch(db.keys_q, descs.keys, sb,
                                tuple(cfg.db.q_levels), cfg.db.nnk)
        n_sync = host_syncs(lambda: tdb.query_from_hits(db.store, descs,
                                                        hits, cfg))
        assert n_sync <= (6 if dynamic else 2), n_sync
        one = host_syncs(lambda: tdb.query_from_hits(
            db.store, type(descs)(*[x[:1] for x in descs]),
            tuple(h[:1] for h in hits), cfg))
        assert one == n_sync, (one, n_sync)      # whatever B
    assert recs[:, 11].max() > 0 and recs[:, 13].max() > 0   # overflows ran


@pytest.mark.cuda
def test_blocked_and_chained_replays_on_card(cuda, tmp_path):
    from synth import se3_from_xyt

    from contour_context_tpu_torch.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu_torch.pipeline import LoopClosurePipeline

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
        (10.5, 0.8, 0.2), (30.0, -1.0, -0.15), (50.2, 0.7, 0.1),
        (20.3, 0.5, -0.1), (40.1, -0.4, 0.05), (60.0, 0.0, 0.0)]
    pl, ll = [], []
    for i, p in enumerate(poses):
        pts = render_scan(world, p, seed=500 + i)
        arr = np.zeros((len(pts), 4), np.float32)
        arr[:, :3] = pts
        bp = str(tmp_path / ("%06d.bin" % i))
        arr.tofile(bp)
        pl.append("%.6f %s" % (6.0 * i, " ".join(
            "%.6f" % v for v in se3_from_xyt(p)[:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (6.0 * i, i, bp))
    (tmp_path / "p.txt").write_text("\n".join(pl))
    (tmp_path / "l.txt").write_text("\n".join(ll))

    def replay(mode):
        ev = ContLCDEvaluator(str(tmp_path / "p.txt"), str(tmp_path / "l.txt"),
                              cfg.correlation_thres)
        pipe = LoopClosurePipeline(cfg, ev, capacity=16, device="cuda",
                                   fused_step=True)
        # 14 scans: three groups of 4 (both staging slots are reused) and a
        # 2-scan tail through the per-scan path
        {"run": pipe.run, "blocked": lambda: pipe.run_blocked(block=4),
         "chained": lambda: pipe.run_chained(chain=4)}[mode]()
        out = tmp_path / f"out_{mode}.txt"
        pipe.save_outcome(str(out))
        assert pipe.db.n == 14
        return [ln.split("\t") for ln in out.read_text().splitlines()]

    want = replay("run")
    assert len(want) == 14
    for mode in ("blocked", "chained"):
        got = replay(mode)
        assert len(got) == 14
        for a, b in zip(got, want):
            assert a[0] == b[0] and a[1] == b[1] and a[6:] == b[6:], (a, b)
            np.testing.assert_allclose(float(a[2]), float(b[2]), rtol=1e-4,
                                       atol=1e-4)
    assert sum(1 for ln in want if ln[0] == "0") >= 3     # revisits closed


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


def _revisit_clouds():
    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
        (10.5, 0.8, 0.2), (30.0, -1.0, -0.15), (50.2, 0.7, 0.1),
        (20.3, 0.5, -0.1)]
    return cfg, np.stack([pad_points(render_scan(world, p, seed=500 + i),
                                     16384) for i, p in enumerate(poses)])


@pytest.mark.cuda
def test_chain_block_handle_on_card(cuda):
    """A chain of 5 out of a 12-row buffer and one of 7 with a staged k:
    one BlockHandle each, each kernel launched once a scan, the records
    equal to the same chains on the CPU in the record bands."""
    cfg, clouds = _revisit_clouds()
    ts = np.cumsum([1.0, 2.0, 16.0, 1.0, 30.0, 1.5,
                    1.0, 20.0, 2.0, 16.0, 1.0, 25.0]).astype(np.float32)
    recs = {}
    for dev in ("cpu", "cuda"):
        db = tdb.ContourDB(cfg, capacity=16, device=dev)
        kernels.reset_launches()
        pts = torch.from_numpy(clouds).to(dev)
        h1 = db.step_chain_dyn_async(pts, list(range(5)), ts)
        h2 = db.step_chain_dyn_async(
            pts[5:], list(range(5, 12)), ts[5:],
            k_dev=tdb.ContourDB.stage_chain_k(7, device=dev))
        assert isinstance(h1, tdb.BlockHandle) and h2.row0 == 5
        assert len(h1.get() + h2.get()) == 12
        if dev == "cuda":
            assert kernels.ring_key_divs.launches == 12
            assert kernels.search_tilemin.launches == 12
        recs[dev] = db.recs_store[:12].cpu().numpy()
    _assert_records(recs["cuda"], recs["cpu"])
    assert (recs["cpu"][:, 0] > 0.5).sum() >= 2


@pytest.mark.cuda
def test_host_query_on_card_matches_cpu(cuda):
    """query_ranged_knn_host on the card against the same query on a CPU
    copy of the DB: one tile-min launch a query; found and gidx exactly,
    corr to 1e-4, T to 2e-3 cells (the record bands)."""
    from contour_context_tpu_torch.config import ContourDBConfig

    cfg, clouds = _revisit_clouds()
    cfg = PipelineConfig(cm=cfg.cm, db=ContourDBConfig(max_check_cands=1024))
    dbs = {d: tdb.ContourDB(cfg, capacity=16, device=d)
           for d in ("cpu", "cuda")}
    n_found = 0
    for i in range(12):
        res = {}
        for dev, db in dbs.items():
            desc = td.build_descriptor(torch.from_numpy(clouds[i]).to(dev),
                                       cfg.cm, cfg.gmm)
            kernels.reset_launches()
            res[dev] = db.query_ranged_knn_host(desc)
            if dev == "cuda" and db.searchable_n > 0:
                assert kernels.search_tilemin.launches == 1
            db.add_scan(desc, i, 6.0 * i)
            db.push_and_balance(6.0 * i)
        a, b = res["cpu"], res["cuda"]
        assert (a is None) == (b is None), (i, a, b)
        if a is not None:
            n_found += 1
            assert a[0] == b[0]
            np.testing.assert_allclose(b[1], a[1], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(b[2], a[2], rtol=1e-4, atol=2e-3)
    assert n_found >= 3


@pytest.mark.cuda
def test_online_spinner_on_card(cuda):
    """The spinner on the card (each scan uploaded on the spin thread):
    its detections equal the found records of a step_async stream of the
    same scans on the card; a launch failure on the spin thread reaches
    finish()."""
    from contour_context_tpu_torch.online import OnlineSpinner

    cfg, clouds = _revisit_clouds()
    ref = tdb.ContourDB(cfg, capacity=16, device="cuda")
    for i in range(12):
        ref.step_async(clouds[i], i, 6.0 * i)
    rec = ref.recs_store[:12].cpu().numpy()
    sp = OnlineSpinner(cfg, capacity=16, drain_block=2, device="cuda")
    sp.start()
    for i in range(12):
        assert sp.feed(clouds[i], i, 6.0 * i, timeout=120)
    sp.finish()
    assert sp.n_processed == 12 and sp.dropped == 0
    found = np.nonzero(rec[:, 0] > 0.5)[0]
    assert [d.q_seq for d in sp.detections] == list(found)
    for d in sp.detections:
        assert d.cand_seq == int(rec[d.q_seq, 1])
        np.testing.assert_allclose(d.correlation, rec[d.q_seq, 2], rtol=1e-4,
                                   atol=1e-4)
    # a search store the kernel refuses (float16): its wrapper raises on
    # the spin thread, and finish() re-raises it
    sp2 = OnlineSpinner(cfg, capacity=16, device="cuda")
    sp2.db._ensure_capacity(1)
    sp2.db.keys_q = sp2.db.keys_q.to(torch.float16)
    sp2.start()
    sp2.feed(clouds[0], 0, 0.0)
    with pytest.raises((TypeError, ValueError), match="search_tilemin"):
        sp2.finish()
    assert sp2.n_processed == 0


@pytest.mark.cuda
def test_native_loader_stages_groups_on_card(cuda, tmp_path, monkeypatch):
    """run_chained on the card reads each group through the native block
    reader into a pinned slot: the outcome equals run()'s."""
    from synth import se3_from_xyt

    from contour_context_tpu_torch.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu_torch.pipeline import LoopClosurePipeline
    from contour_context_tpu_torch.utils import native_loader

    assert native_loader.native_available()
    cfg, clouds = _revisit_clouds()
    pl, ll = [], []
    for i in range(12):
        c = clouds[i][clouds[i][:, 3] > 0].copy()
        bp = str(tmp_path / ("%06d.bin" % i))
        c.tofile(bp)
        pl.append("%.6f %s" % (6.0 * i, " ".join("%.6f" % v for v in
                                                  se3_from_xyt((0, 0, 0))
                                                  [:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (6.0 * i, i, bp))
    (tmp_path / "p.txt").write_text("\n".join(pl))
    (tmp_path / "l.txt").write_text("\n".join(ll))
    calls = []
    real = native_loader.read_block_into
    monkeypatch.setattr(native_loader, "read_block_into",
                        lambda paths, out, **kw: calls.append(len(paths))
                        or real(paths, out, **kw))
    outs = []
    for mode in ("run", "chained"):
        ev = ContLCDEvaluator(str(tmp_path / "p.txt"),
                              str(tmp_path / "l.txt"), cfg.correlation_thres)
        pipe = LoopClosurePipeline(cfg, ev, 16, fused_step=True,
                                   device="cuda")
        pipe.run() if mode == "run" else pipe.run_chained(chain=5)
        pipe.save_outcome(str(tmp_path / f"{mode}.txt"))
        outs.append([ln.split("\t")[:2] for ln in
                     (tmp_path / f"{mode}.txt").read_text().splitlines()])
    assert calls == [5, 5]
    assert outs[0] == outs[1] and len(outs[0]) == 12


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A world of one rank over NCCL in this process, on the card."""
    import torch.distributed as dist

    from contour_context_tpu_torch import parallel as par

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    mesh = None
    try:
        mesh = par.make_mesh(device=cuda)
        yield mesh
    finally:
        if mesh is not None:
            mesh.drop_graphs()      # before the communicator goes
        dist.destroy_process_group()


def _f32_map(cuda):
    """The revisit world's first 8 scans in a card DB with f32 keys_q (the
    sharded path's single-device reference), and the config."""
    cfg, clouds = _revisit_clouds()
    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384,
                                                 keys_bf16=False))
    db = tdb.ContourDB(cfg, capacity=16, device="cuda")
    for i in range(8):
        db.step_async(clouds[i], i, 6.0 * i)
    assert db.keys_q.dtype == torch.float32 and db.searchable_n > 0
    return cfg, clouds, db


@pytest.mark.cuda
def test_sharded_search_on_card_matches_single(nccl_mesh):
    from contour_context_tpu_torch import parallel as par

    cfg, clouds, db = _f32_map(nccl_mesh.device)
    desc = td.build_descriptor(torch.from_numpy(clouds[8]).to("cuda"),
                               cfg.cm, cfg.gmm)
    shard = par.shard_store(db.store, nccl_mesh)
    kernels.reset_launches()
    got = par.sharded_search(shard.keys_q, desc.keys, db.state[1],
                             tuple(cfg.db.q_levels), cfg.db.nnk, nccl_mesh)
    assert kernels.search_tilemin.launches == 1
    want = tdb.search(db.keys_q, desc.keys, db.state,
                      tuple(cfg.db.q_levels), cfg.db.nnk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[3].sum()) > 0


@pytest.mark.cuda
def test_sharded_query_step_on_card_matches_single(nccl_mesh):
    from contour_context_tpu_torch import parallel as par

    cfg, clouds, db = _f32_map(nccl_mesh.device)
    shard = par.shard_store(db.store, nccl_mesh)
    n_found = 0
    for i in (8, 10, 11):
        desc = td.build_descriptor(torch.from_numpy(clouds[i]).to("cuda"),
                                   cfg.cm, cfg.gmm)
        kernels.reset_launches()
        got = par.sharded_query_step(shard, desc, db.state, cfg, nccl_mesh)
        assert kernels.search_tilemin.launches == 1
        want = tdb.query_step(db.store, db.keys_q, desc, db.state, cfg)
        assert torch.equal(got, want), (i, got, want)
        n_found += int(want[0] > 0.5)
    assert n_found >= 1


@pytest.mark.cuda
def test_sharded_localize_block_on_card_matches_single(nccl_mesh):
    from contour_context_tpu_torch import parallel as par

    cfg, clouds, db = _f32_map(nccl_mesh.device)
    shard = par.shard_store(db.store, nccl_mesh)
    kernels.reset_launches()
    got = par.sharded_localize_block(shard, db.state, clouds[8:12], cfg,
                                     nccl_mesh)
    assert kernels.ring_key_divs_batch.launches == 1
    assert kernels.search_tilemin_batch.launches == 1
    descs = td.build_descriptors(torch.from_numpy(clouds[8:12]).to("cuda"),
                                 cfg.cm, cfg.gmm)
    want = tdb.query_step_batch(db.store, db.keys_q, descs,
                                db.state[1].expand(4).contiguous(), cfg)
    assert torch.equal(got, want), (got, want)
    assert int((want[:, 0] > 0.5).sum()) >= 1


# ---------------------------------------------------------------------------
# one dispatch: the CC and merge kernels, the steps as CUDA graph replays
# ---------------------------------------------------------------------------

def _no_syncs(fn):
    """fn under torch's sync debug mode "error": any host sync raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _launch_delta(fn):
    before = kernels.launch_counts()
    fn()
    after = kernels.launch_counts()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(kt.adversarial_masks(8, 8))
                         + ["one scan", "a block of 16", "37 x 41", "8 x 8",
                            "5 x 7"])
def test_cc_labels_kernel_matches_plain_on_card(cuda, name):
    """The CC kernel bit-equal to its plain version on the masks made to
    stress a labelling (150 x 150, alone and all in one launch), on the
    level masks of a scan (B = 1: 6 masks) and of a block (B = 16: 96), and
    on every adversarial mask at 37 x 41 (strips of 5 rows, the last of 2),
    8 x 8 (a row a strip) and 5 x 7 (three strips with no rows)."""
    cfg, clouds = _revisit_clouds()
    if name == "one scan":
        masks = kt.masks_of(torch.from_numpy(clouds[8:9]).to(cuda), cfg)
    elif name == "a block of 16":
        masks = kt.masks_of(torch.from_numpy(np.concatenate(
            [clouds, clouds[:4]])).to(cuda), cfg)
    elif " x " in name:
        # odd pixel counts, strip starts off any 4-byte boundary, strips of
        # one row and strips with none
        nr, nc = (int(v) for v in name.split(" x "))
        masks = torch.from_numpy(np.stack(list(
            kt.adversarial_masks(nr, nc).values()))).to(cuda)
    else:
        adv = kt.adversarial_masks(cfg.cm.n_row, cfg.cm.n_col)
        masks = torch.from_numpy(adv[name])[None].to(cuda)
        kt.hold_cc(torch.from_numpy(np.stack(list(adv.values()))).to(cuda),
                   "every adversarial mask in one launch")
    kernels.reset_launches()
    assert kt.hold_cc(masks, name) == 0.0
    assert kernels.cc_labels.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
def test_merge_hints_kernel_matches_plain_on_card(cuda, B):
    """The merge kernel bit-equal to its plain version (run on the card) on
    the inputs the query path gives it: B revisit queries against a card
    DB of the revisit world; and on random rows made to merge, open and
    drop proposals across the angle wrap (64 hints a query at B = 16, 30 at
    B = 1)."""
    cfg, clouds = _revisit_clouds()
    db = tdb.ContourDB(cfg, capacity=16, device="cuda")
    for i in range(8):
        db.step_async(clouds[i], i, 6.0 * i)
    pts = torch.from_numpy(np.concatenate([clouds[8:]] * 4)[:B]).to(cuda)
    hint_of, T, votes = kt.merge_case(db, pts, cfg)
    assert int((hint_of >= 0).sum()) > 0
    kernels.reset_launches()
    assert kt.hold_merge(hint_of, T, votes, f"B {B}") == 0.0
    assert kernels.merge_hints.launches == 1
    rng = np.random.default_rng(B)
    # MP 30 is no multiple of 4: the kernel reads hint ids one at a time
    C, MP = 32, 64 if B == 16 else 30
    T = np.zeros((B, MP, 3), np.float32)
    T[..., :2] = rng.integers(0, 3, (B, MP, 2)) * 3.0 + \
        rng.normal(0, 0.6, (B, MP, 2))
    T[..., 2] = rng.choice([-3.1, 0.0, 3.1], (B, MP)) + \
        rng.normal(0, 0.12, (B, MP))
    hint_of = np.full((B, C, MP), -1, np.int32)
    for b in range(B):
        row = rng.integers(0, 6, MP)
        for c in range(6):
            ms = np.flatnonzero(row == c)
            hint_of[b, c, :len(ms)] = ms
    kt.hold_merge(torch.from_numpy(hint_of).to(cuda),
                  torch.from_numpy(T).to(cuda),
                  torch.from_numpy(rng.integers(1, 9, (B, MP))
                                   .astype(np.int32)).to(cuda), "random")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(kt.merge_stress_cases()))
def test_merge_hints_kernel_matches_plain_on_stress_rows(cuda, name):
    """The merge kernel bit-equal to its plain version (run on the card) on
    the rows made to stress its lanes: trip counts from 0 to MP in one
    warp, full rows of MP hints, angles across the wrap; one launch."""
    hint_of, T, votes = (torch.from_numpy(x).to(cuda)
                         for x in kt.merge_stress_cases()[name])
    kernels.reset_launches()
    assert kt.hold_merge(hint_of, T, votes, name) == 0.0
    assert kernels.merge_hints.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
def test_gmm_lm_kernel_matches_plain_on_card(cuda, B):
    """The LM kernel bit-equal to its plain twin (run on the card) on the
    inputs the query path gives it: B revisit queries against a card DB of
    the revisit world, (B, 10) rows against (B, 1) targets (the stream's
    and the serving chunk's shapes); one launch a call. Against the torch
    chain it replaced (the same float32 terms, summed in torch's order):
    each query's best row, the one its record carries, is the same row and
    within rtol 1e-5 (corr) and 2e-3 cells (pose); every row within rtol
    2e-4 and 3e-3 cells. The LM carries a reordered sum's last bit into a
    row that ends far from converged: on an H100 these inputs read at most
    1.27e-4 relative and 1.51e-3 cells at B 1, 1.82e-5 and 8.0e-4 at B
    16."""
    cfg, clouds = _revisit_clouds()
    db = tdb.ContourDB(cfg, capacity=16, device="cuda")
    for i in range(8):
        db.step_async(clouds[i], i, 6.0 * i)
    pts = torch.from_numpy(np.concatenate([clouds[8:]] * 4)[:B]).to(cuda)
    src, tgt, T0, sel = kt.lm_case(db, pts, cfg)
    assert tuple(T0.shape) == (B, cfg.db.max_fine_opt, 3) and sel.any()
    g = cfg.gmm
    kernels.reset_launches()
    assert kt.hold_lm(src, tgt, T0, sel, f"B {B}", g.cov_dilate_scale,
                      g.gn_iters) == 0.0
    assert kernels.gmm_lm.launches == 1
    c_k, T_k = tg.optimize_correlation(src, tgt, T0, sel,
                                       g.cov_dilate_scale, g.gn_iters)
    c_t, T_t = kt.lm_torch_chain(src, tgt, T0, sel, g.cov_dilate_scale,
                                 g.gn_iters)
    best = c_k.argmax(dim=1, keepdim=True)
    assert torch.equal(best, c_t.argmax(dim=1, keepdim=True))
    torch.testing.assert_close(c_k.gather(1, best), c_t.gather(1, best),
                               rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(T_k.gather(1, best[..., None].expand(B, 1, 3)),
                               T_t.gather(1, best[..., None].expand(B, 1, 3)),
                               rtol=0, atol=2e-3)
    torch.testing.assert_close(c_k, c_t, rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(T_k, T_t, rtol=0, atol=3e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(kt.LM_EDGE_CASES))
def test_gmm_lm_kernel_edge_cases_on_card(cuda, name):
    """The LM kernel bit-equal to its plain twin at the edges: the host
    spec query's rows against one target (unbatched and (1,)), an odd K
    (12) with G 2 and 3 iterations, rows with no close pair, a row whose
    trial step is non-finite (never taken); one launch each."""
    src, tgt, T0, sel, iters = kt.lm_edge_case(name, cuda)
    kernels.reset_launches()
    assert kt.hold_lm(src, tgt, T0, sel, name, 2.0, iters) == 0.0
    assert kernels.gmm_lm.launches == 1
    c, T = tg.optimize_correlation(src, tgt, T0, sel, 2.0, iters)
    if name.startswith("empty sel"):
        assert (c[:, 0::2] == 0).all() and torch.equal(T[:, 0::2],
                                                      T0[:, 0::2])
    if name.startswith("a non-finite"):
        assert torch.equal(T[:, 1], T0[:, 1]) and torch.isfinite(T).all()


@pytest.mark.cuda
def test_gmm_lm_graphed_replay_equals_eager_on_card(cuda):
    """The LM captured in a CUDA graph (one kernel node and the wrapper's
    copies) replays to the eager call's outputs bit for bit, on the serving
    shape's inputs; each eager call counts one gmm_lm launch."""
    cfg, clouds = _revisit_clouds()
    db = tdb.ContourDB(cfg, capacity=16, device="cuda")
    for i in range(8):
        db.step_async(clouds[i], i, 6.0 * i)
    pts = torch.from_numpy(np.concatenate([clouds[8:]] * 4)[:16]).to(cuda)
    args = kt.lm_case(db, pts, cfg)
    kernels.reset_launches()
    want = tg.optimize_correlation(*args)
    assert kernels.gmm_lm.launches == 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tg.optimize_correlation(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tg.optimize_correlation(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert kernels.gmm_lm.launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("p_pot", [8, 128, None])
def test_cascade_kernel_matches_plain_at_the_edges_on_card(cuda, p_pot):
    """The cascade kernel bit-equal to its plain twin (run on the card) on
    the flat hint rows made to take each edge of the cascade
    (`kernel_times.cascade_edge_world`: no close pair, more close pairs
    than p_pot, a window longer than 63, the +-pi wrap, equal angles,
    hint_valid false, no shaft, a degenerate target shaft, the orientation
    screen, negative and out-of-range indices); one launch a call."""
    cfg = PipelineConfig()
    store, query, tgt_q, hints = kt.cascade_edge_case(cuda)
    kernels.reset_launches()
    assert kt.hold_cascade(store, query, tgt_q, hints, cfg,
                           f"edges, p_pot {p_pot}", p_pot) == 0.0
    assert kernels.cascade.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,caps", [(1, "default"), (4, "default"),
                                    (5, "default"), (16, "default"),
                                    (5, "squeezed")])
def test_cascade_kernel_matches_plain_on_card(cuda, B, caps):
    """The cascade kernel bit-equal to its plain twin (run on the card) on
    the hint rows the query path gives it (`kernel_times.cascade_inputs`:
    B revisit queries against a card DB of the revisit world, after the
    hint cap and check 1): the stream's B = 1, the serving chunks of 4, 5
    and 16, and the squeezed caps (HC 96 in chunks of 40, the last chunk's
    start clamped), each query's idle columns zero; one launch a call."""
    cfg, clouds = _revisit_clouds()
    if caps == "squeezed":
        cfg = PipelineConfig(cm=cfg.cm, db=ContourDBConfig(
            max_check_cands=96, cascade_chunk=40, max_pass_hints=16,
            max_cand_poses=2, p_pot=8))
    db = tdb.ContourDB(cfg, capacity=16, device="cuda")
    for i in range(8):
        db.step_async(clouds[i], i, 6.0 * i)
    pts = torch.from_numpy(np.concatenate([clouds[8:]] * 4)[:B]).to(cuda)
    descs, rows = kt.cascade_inputs(db, pts, cfg)
    assert int(rows.n_run.max()) > 0
    kernels.reset_launches()
    assert kt.hold_cascade_chunked(db.store, descs, rows, cfg,
                                   f"B {B}, {caps}") == 0.0
    assert kernels.cascade.launches == 1


@pytest.mark.cuda
def test_cascade_refused_launch_raises_on_card(cuda, monkeypatch):
    """A launch the library refuses raises: the C entry returns
    cudaErrorInvalidValue for M > 40 and launches nothing, and the wrapper
    raises on a non-zero return; shapes it cannot take raise before."""
    import ctypes

    cfg = PipelineConfig()
    store, query, tgt_q, hints = kt.cascade_edge_case(cuda)
    lib = kernels.build()
    dims = (ctypes.c_int * 16)(1, 1, 6, 6, 41, 4, 10, 1, 1, 0, 128, 3, 3, 3,
                               3, 4)
    ptrs = (ctypes.c_void_p * 35)(*([hints[0].data_ptr()] * 35))
    th = (ctypes.c_float * 6)(6.0, 0.2, 0.2, 0.3, 0.4, 0.25)
    rc = lib.cc_cascade(*[ctypes.cast(a, ctypes.c_void_p)
                          for a in (ptrs, dims, th)], kernels._stream(cuda))
    assert rc != 0
    with pytest.raises(RuntimeError, match="cascade: CUDA launch failed"):
        kernels._raise_on(rc, "cascade")
    torch.cuda.synchronize()

    class Refusing:
        @staticmethod
        def cc_cascade(*args):
            return 9            # cudaErrorInvalidConfiguration

    monkeypatch.setattr(kernels, "build", lambda: Refusing)
    n = kernels.cascade.launches
    with pytest.raises(RuntimeError, match="cascade: CUDA launch failed"):
        tdb.gather_and_cascade(store, query, tgt_q, *hints, cfg.thres_lb,
                               cfg.db.cont_sim, 128)
    assert kernels.cascade.launches == n
    with pytest.raises(ValueError, match="p_pot"):
        kernels.cascade(store, query, *hints, cfg.thres_lb, cfg.db.cont_sim,
                        1024, tgt_q=tgt_q)


def _stream_db(cfg, clouds, graphed, n, q16=False, capacity=8):
    """n steps of the revisit world (6 s apart) into a card DB of
    `capacity` (it grows past it), graphed or through the eager body."""
    from contour_context_tpu_torch.utils.io import quantize_points_q16

    db = tdb.ContourDB(cfg, capacity=capacity, device="cuda")
    db._graphs.enabled = graphed
    for i in range(n):
        pts = clouds[i % len(clouds)]
        if q16:
            pts = quantize_points_q16(pts)
        db.step_async(pts, i, 6.0 * i)
    return db


def _assert_same_db(a, b, n):
    for name, x, y in zip(a.store._fields, a.store, b.store):
        assert torch.equal(x[:n], y[:n]), name
    A = a.store.keys.shape[2]
    assert torch.equal(a.keys_q.view(torch.int16)[..., :n * A],
                       b.keys_q.view(torch.int16)[..., :n * A])
    for name in ("ts_store", "state"):
        assert torch.equal(getattr(a, name)[:n], getattr(b, name)[:n]), name
    assert torch.equal(a.recs_store[:n].view(torch.int32),
                       b.recs_store[:n].view(torch.int32))
    assert a.n == b.n == n and a.seq_of_gidx == b.seq_of_gidx


@pytest.mark.cuda
@pytest.mark.parametrize("payload", ["f32", "q16"])
def test_graphed_stream_equals_eager_body_on_card(cuda, payload):
    """20 steps through the step's graph (a DB of capacity 8: it grows
    twice, and each grow captures the graph again) write the store,
    keys_q, timestamps, window state and records bit for bit as the eager
    body does; each kernel's count grows by one a step, replays
    included."""
    cfg, clouds = _revisit_clouds()
    q16 = payload == "q16"
    kernels.reset_launches()
    g = _stream_db(cfg, clouds, True, 20, q16)
    counts = kernels.launch_counts()
    for name in ("ring_key_divs", "search_tilemin", "cc_labels",
                 "merge_hints", "gmm_lm", "cascade"):
        assert counts[name] == 20, counts
    assert counts["ring_key_divs_batch"] == counts["search_tilemin_batch"] \
        == 0
    e = _stream_db(cfg, clouds, False, 20, q16)
    assert g.capacity == e.capacity == 32
    _assert_same_db(g, e, 20)
    assert int((g.recs_store[:20, 0] > 0.5).sum()) >= 3
    stats = g.graph_stats()
    assert len(stats["capture_s"]) == 1 and stats["pool_bytes"] > 0


@pytest.mark.cuda
def test_graphed_stream_and_chain_make_no_host_sync_on_card(cuda):
    """After the capture: 20 step_async calls (host payloads, uploaded
    through pinned memory) and a chain of 16 make no host sync (torch's
    sync debug mode raises on one), and the records equal the eager
    body's; each replay counts one launch of each kernel."""
    cfg, clouds = _revisit_clouds()
    db = tdb.ContourDB(cfg, capacity=64, device="cuda")
    db.step_async(clouds[0], 0, 0.0)            # the warm-up and capture
    delta = _launch_delta(lambda: _no_syncs(lambda: [
        db.step_async(clouds[i % 12], i, 6.0 * i) for i in range(1, 21)]))
    assert delta == {"ring_key_divs": 20, "ring_key_divs_batch": 0,
                     "search_tilemin": 20, "search_tilemin_batch": 0,
                     "cc_labels": 20, "merge_hints": 20, "dyn_pass_scan": 0,
                     "dyn_post_scan": 0, "gmm_lm": 20, "cascade": 20}, delta
    buf = np.concatenate([clouds, clouds[:4]])
    ts = [6.0 * i for i in range(21, 37)]
    h = _no_syncs(lambda: db.step_chain_dyn_async(buf, list(range(21, 37)),
                                                  ts))
    assert h.row0 == 21 and h.recs.shape == (16, 18)
    e = tdb.ContourDB(cfg, capacity=64, device="cuda")
    e._graphs.enabled = False
    for i in range(37):
        e.step_async(buf[i - 21] if i >= 21 else clouds[i % 12], i, 6.0 * i)
    _assert_same_db(db, e, 37)
    assert len(h.get()) == 16


@pytest.mark.cuda
def test_graphed_block_and_serving_equal_eager_on_card(cuda):
    """Blocks of 8 from raw clouds (the build graph and the query graph of
    8) and serving chunks of 8 (the padded tail too) against the same
    calls run eagerly: records, store and window bit for bit; after the
    captures, a block and a serving call make no host sync; one batched
    launch of each kernel, and one CC and one merge launch, a block."""
    cfg, clouds = _revisit_clouds()
    pts = np.concatenate([clouds, clouds[:4]])
    dbs = {}
    for graphed in (True, False):
        db = tdb.ContourDB(cfg, capacity=32, device="cuda")
        db._graphs.enabled = graphed
        db.block_chain_pts_async(torch.from_numpy(pts[:8])[None],
                                 list(range(8)),
                                 [[6.0 * i for i in range(8)]])
        dbs[graphed] = db
    g, e = dbs[True], dbs[False]
    step = (lambda db: db.block_chain_pts_async(
        pts[8:16][None], list(range(8, 16)), [[6.0 * i for i in
                                                range(8, 16)]]))
    delta = _launch_delta(lambda: _no_syncs(lambda: step(g)))
    assert delta == {"ring_key_divs": 0, "ring_key_divs_batch": 1,
                     "search_tilemin": 0, "search_tilemin_batch": 1,
                     "cc_labels": 1, "merge_hints": 1, "dyn_pass_scan": 0,
                     "dyn_post_scan": 0, "gmm_lm": 1, "cascade": 1}, delta
    step(e)
    _assert_same_db(g, e, 16)
    assert int((g.recs_store[8:16, 0] > 0.5).sum()) >= 2
    recs = {}
    for graphed, db in dbs.items():
        db.localize_block_async(pts[8:14], 4)           # captures at B = 4
        recs[graphed] = db.localize_block_async(pts[2:12], 4)
    delta = _launch_delta(lambda: _no_syncs(
        lambda: g.localize_block_async(pts[2:12], chunk=4)))
    assert delta["ring_key_divs_batch"] == delta["search_tilemin_batch"] \
        == delta["cc_labels"] == delta["merge_hints"] == delta["gmm_lm"] \
        == delta["cascade"] \
        == 3, delta
    a, b = (recs[k].recs for k in (True, False))
    assert a.shape == (10, 18) and torch.equal(a.view(torch.int32),
                                               b.view(torch.int32))


@pytest.mark.cuda
def test_graphed_serving_pads_to_its_chunk_and_drops_its_graphs_on_card(
        cuda):
    """Graphed serving with a chunk pads a request to whole chunks: requests
    of 3, 10 and 20 clouds at chunk 8 capture one build and one query
    graph; a request of 20 with no chunk is served at its size, in chunks
    of 16 and 4, one more pair each; every record equals the eager body's
    on the same chunks (a padded tail with zero clouds). drop_graphs
    empties the DB's graphs; the device's pool, shared by every DB, goes
    back to the card once no other DB's graph lives; the next call
    captures again and its records are the same."""
    import gc

    from contour_context_tpu_torch import graphs

    gc.collect()
    live = graphs.device_pool(cuda).live
    assert not len(live), "graphs of another test's DBs are still alive"
    cfg, clouds = _revisit_clouds()
    pts = np.concatenate([clouds, clouds[:8]])
    db = tdb.ContourDB(cfg, capacity=32, device="cuda")
    with db.eager():
        db.block_chain_pts_async(torch.from_numpy(clouds[:8])[None],
                                 list(range(8)),
                                 [[6.0 * i for i in range(8)]])

    def same(B, chunk):
        a = db.localize_block_async(pts[:B], chunk=chunk).recs
        parts, at = [], 0
        for c in tdb.serve_chunks(B, chunk):
            x = pts[at:at + c]
            x = np.concatenate([x, np.zeros((c - len(x),) + pts.shape[1:],
                                            pts.dtype)])
            with db.eager():
                parts.append(db.localize_block_async(x, c).recs)
            at += c
        b = torch.cat(parts)[:B]
        assert a.shape == (B, 18)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), B

    for B in (3, 10, 20):
        same(B, 8)
    assert sorted(k[0] for k in db._graphs.graphs) == ["build", "query"]
    same(20, None)
    assert sorted(k[-1] if k[0] == "query" else k[-1][0]
                  for k in db._graphs.graphs) == [
        4, 4, 8, 8, tdb.SERVE_CHUNK, tdb.SERVE_CHUNK]
    pool = db.graph_stats()["pool_bytes"]
    assert pool > 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    db.drop_graphs()
    assert not db._graphs.graphs and not len(live)
    assert db.graph_stats()["pool_bytes"] == 0
    assert torch.cuda.memory_reserved() <= before - pool
    same(10, 8)
    assert len(db._graphs.graphs) == 2


@pytest.mark.cuda
def test_serving_sized_to_the_request_on_card(cuda):
    """Requests of 1 and 5 clouds with no chunk replay graphs of their own
    size (1; 4 and 1), each captured once over repeated requests, with no
    host sync and one launch of each kernel a chunk; their records match
    the same clouds' records inside one 16-cloud request: found, gidx and
    every counter exactly, correlation and pose bit for bit or far inside
    the benchmark's limits (1e-5, 0.05), the widest gap printed. A
    16-cloud request captures the build and query graphs of 16 and no
    other, and replays them after the small requests with the same
    records."""
    cfg, clouds = _revisit_clouds()
    pts = np.concatenate([clouds, clouds[:8]])
    P = pts.shape[1]
    db = tdb.ContourDB(cfg, capacity=32, device="cuda")
    with db.eager():
        db.block_chain_pts_async(torch.from_numpy(clouds[:8])[None],
                                 list(range(8)),
                                 [[6.0 * i for i in range(8)]])
    whole = db.localize_block_async(pts[:16]).recs.clone()
    assert set(db._graphs.graphs) == {("build", torch.float32, (16, P, 4)),
                                      ("query", 16)}
    assert int((whole[:, 0] > 0.5).sum()) >= 8
    exact = [0, 1] + list(range(6, tdb.RECORD_WIDTH))
    gaps = [0.0, 0.0]
    requests = ((8, 1), (9, 1), (11, 1), (8, 5), (3, 5), (0, 5))
    for rep in range(2):
        for lo, B in requests:
            if rep:
                recs = _no_syncs(
                    lambda: db.localize_block_async(pts[lo:lo + B]).recs)
            else:
                recs = db.localize_block_async(pts[lo:lo + B]).recs
            want = whole[lo:lo + B]
            assert torch.equal(recs[:, exact], want[:, exact]), (lo, B)
            d = (recs[:, 2:6] - want[:, 2:6]).abs()
            gaps = [max(gaps[0], float(d[:, 0].max())),
                    max(gaps[1], float(d[:, 1:].max()))]
    print(f"serving at the request's size against a request of 16: "
          f"widest corr gap {gaps[0]!r}, widest pose gap {gaps[1]!r}")
    assert gaps[0] <= 1e-6 and gaps[1] <= 5e-3, gaps
    delta = _launch_delta(lambda: db.localize_block_async(pts[3:8]))
    for names in (("ring_key_divs", "ring_key_divs_batch"),
                  ("search_tilemin", "search_tilemin_batch"),
                  ("cc_labels",), ("merge_hints",), ("gmm_lm",),
                  ("cascade",)):
        assert sum(delta[k] for k in names) == 2, (names, delta)
    stats = db.graph_stats()
    assert set(stats["captures"].values()) == {1}, stats["captures"]
    assert sorted(k[-1] for k in db._graphs.graphs if k[0] == "query") \
        == [1, 4, 16]
    again = db.localize_block_async(pts[:16]).recs
    assert torch.equal(again.view(torch.int32), whole.view(torch.int32))
    assert set(db.graph_stats()["captures"].values()) == {1}
    assert db.serving_counters["build_slots"] == 16 * 2 + 2 * (
        3 * 1 + 3 * 5) + 5


def _dyn(cfg):
    return PipelineConfig(cm=cfg.cm, db=ContourDBConfig(dynamic_thres=True))


@pytest.mark.cuda
def test_dyn_thres_kernels_match_plain_on_card(cuda):
    """dyn_pass_scan and dyn_post_scan bit-equal to their plain versions at
    the edges (nothing passes, every row passes, the bars clamp at ub on
    the first row; B = 1, 16 and 17; H at its cap and rows of 2500; counts
    and bars at the int32 extremes; every step a rise; a NaN upper bar,
    which the kernel before the warp walk got wrong; NaN scores; signed
    zeros at the bars) and on the inputs the query path gives them for 4
    revisit queries; one launch each a call. The walks' ballot rounds (the
    measurement entries' count): at most 4 a row at the default bars, one
    a lane of 8 steps plus one where every step is a rise."""
    cfg, clouds = _revisit_clouds()
    dyn = _dyn(cfg)
    assert len(kt.dyn_edge_cases(cuda, dyn)) == 2
    db = tdb.ContourDB(dyn, capacity=16, device="cuda")
    for i in range(8):
        db.step_async(clouds[i], i, 6.0 * i)
    pa, po = kt.dyn_cases(db, torch.from_numpy(clouds[8:12]).to(cuda), dyn)
    assert pa[0].shape == (4, 256) and po[0].shape == (4, 64)
    kernels.reset_launches()
    kt.hold_dyn_pass(pa, "4 revisit queries")
    kt.hold_dyn_post(po, "4 revisit queries")
    assert kernels.dyn_pass_scan.launches == kernels.dyn_post_scan.launches \
        == 1
    assert int(kernels.dyn_pass_scan_plain(*pa)[1].sum()) > 0
    assert kt.dyn_phase_split("dyn_pass_scan", pa, reps=2)["count_max"] <= 4
    wp, wo = kt.dyn_worst_cases(cuda)
    kt.hold_dyn_pass(wp, "every hint a rise")
    kt.hold_dyn_post(wo, "every candidate a rise")
    for name, args in (("dyn_pass_scan", wp), ("dyn_post_scan", wo)):
        assert kt.dyn_phase_split(name, args, reps=2)["count_max"] == \
            args[0].shape[-1] // kt.DYN_LANE_STEPS + 1, name


def _write_dataset(d, poses, dt=6.0):
    from synth import se3_from_xyt

    world = make_world(11, n_structs=220, extent=160.0)
    pl, ll = [], []
    for i, p in enumerate(poses):
        pts = render_scan(world, p, seed=500 + i)
        arr = np.zeros((len(pts), 4), np.float32)
        arr[:, :3] = pts
        bp = str(d / ("%06d.bin" % i))
        arr.tofile(bp)
        pl.append("%.6f %s" % (dt * i, " ".join(
            "%.6f" % v for v in se3_from_xyt(p)[:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (dt * i, i, bp))
    (d / "p.txt").write_text("\n".join(pl))
    (d / "l.txt").write_text("\n".join(ll))
    return str(d / "p.txt"), str(d / "l.txt")


UNFUSED_POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
    (10.5, 0.8, 0.2), (30.0, -1.0, -0.15), (50.2, 0.7, 0.1),
    (20.3, 0.5, -0.1), (40.1, -0.4, 0.05), (60.0, 0.0, 0.0),
    (12.0, -0.6, 0.1), (31.0, 0.4, -0.05)]


@pytest.mark.cuda
@pytest.mark.parametrize("dynamic", [False, True])
def test_unfused_pipeline_replays_equal_eager_on_card(cuda, tmp_path,
                                                      dynamic):
    """The pipeline's default path on the card, every stage a replay (the
    per-scan build, query_async, add_scan, push_and_balance), and
    `run_blocked` (the build graph of 4, the append graph, the query graph
    of 4), each writing the outcome file of the same run through the eager
    bodies bit for bit; after the captures of the first two scans the
    default path makes no host sync; a query_async record equals the
    step_async record of the same scan at the same window state."""
    from contour_context_tpu_torch.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu_torch.pipeline import LoopClosurePipeline

    base, _ = _revisit_clouds()
    cfg = _dyn(base) if dynamic else base
    f_pose, f_laser = _write_dataset(tmp_path, UNFUSED_POSES)

    def pipeline(graphed):
        p = LoopClosurePipeline(cfg, ContLCDEvaluator(
            f_pose, f_laser, cfg.correlation_thres), 32, device="cuda")
        p.db._graphs.enabled = graphed
        return p

    outs = {}
    for mode, graphed in (("graphed", True), ("eager", False)):
        p = pipeline(graphed)
        assert p.spin_once() and p.spin_once()      # the captures
        launches = _launch_delta(lambda: _no_syncs(
            lambda: [p.spin_once() for _ in range(len(UNFUSED_POSES) - 2)]))
        p.drain()
        out = tmp_path / f"{mode}.txt"
        p.save_outcome(str(out))
        outs[mode] = out.read_text()
        n = len(UNFUSED_POSES) - 2
        assert launches["ring_key_divs"] == launches["search_tilemin"] == n
        assert launches["dyn_pass_scan"] == (n if dynamic else 0)
        if graphed:
            keys = set(p.db._graphs.graphs)
            assert {("add_scan",), ("push",), ("query_step",)} <= keys
    assert outs["graphed"] == outs["eager"]
    assert sum(1 for ln in outs["graphed"].splitlines()
               if ln.startswith("0\t")) >= 3
    for mode, graphed in (("blocked", True), ("blocked eager", False)):
        p = pipeline(graphed)
        p.run_blocked(block=4)
        out = tmp_path / "blocked.txt"
        p.save_outcome(str(out))
        outs[mode] = out.read_text()
    assert outs["blocked"] == outs["blocked eager"]

    # query_async against step_async: the same scan at the same state
    db_q = tdb.ContourDB(cfg, capacity=32, device="cuda")
    db_s = tdb.ContourDB(cfg, capacity=32, device="cuda")
    _, clouds = _revisit_clouds()
    for i in range(12):
        desc = db_q._build_one(clouds[i])
        h = db_q.query_async(desc)
        db_q.add_scan(desc, i, 6.0 * i)
        db_q.push_and_balance(6.0 * i)
        db_s.step_async(clouds[i], i, 6.0 * i)
        if h is not None:
            assert torch.equal(h.rec.view(torch.int32),
                               db_s.recs_store[i].view(torch.int32)), i
    for name, x, y in zip(db_q.store._fields, db_q.store, db_s.store):
        assert torch.equal(x, y), name
    for name in ("keys_q", "ts_store", "state"):
        assert torch.equal(getattr(db_q, name), getattr(db_s, name)), name


@pytest.mark.cuda
def test_two_dbs_share_one_pool_on_card(cuda):
    """Two block-built DBs with the build, append and query graphs of 8 hold
    one graph pool: every graph of both carries the same pool id, which is
    the id of the pool's segments in the allocator's snapshot, and the
    second DB's captures grow the card's reserved memory by less than half
    the pool the first one filled (a pool of its own would add about as
    much again). drop_graphs on the first leaves the second's replays
    bit-equal to its eager calls; once the second's graphs go too, the
    pool's memory goes back to the card."""
    import gc

    from contour_context_tpu_torch import graphs

    gc.collect()
    pool = graphs.device_pool(cuda)
    assert not len(pool.live), "graphs of another test's DBs are still alive"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg, clouds = _revisit_clouds()
    pts = torch.from_numpy(np.concatenate([clouds, clouds[:4]]))
    ts = [[6.0 * i for i in range(k, k + 8)] for k in (0, 8)]

    def block_map():
        m = tdb.ContourDB(cfg, capacity=32, device="cuda")
        m.block_chain_pts_async(pts.reshape(2, 8, *pts.shape[1:]),
                                list(range(16)), ts)
        torch.cuda.synchronize()
        return m

    def pool_ids(m):
        return {tuple(g.graph.pool()) for g in m._graphs.graphs.values()}

    a = block_map()
    pool_a = a.graph_stats()["pool_bytes"]
    # a capture empties the allocator's cache as it starts: empty it here
    # too, so the growth is what the second DB holds
    torch.cuda.empty_cache()
    reserved_a = torch.cuda.memory_reserved()
    b = block_map()
    grown = torch.cuda.memory_reserved() - reserved_a
    assert pool_a > 0 and grown < pool_a // 2, (grown, pool_a)
    assert len(a._graphs.graphs) == len(b._graphs.graphs) == 3
    ids = pool_ids(a) | pool_ids(b)
    assert len(ids) == 1, ids
    (pid,) = ids
    segs = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pid]
    assert segs and sum(segs) == b.graph_stats()["pool_bytes"] >= pool_a
    assert len(pool.live) == 6          # build, append, query of 8, twice
    reserved = torch.cuda.memory_reserved()
    a.drop_graphs()
    assert not a._graphs.graphs and len(b._graphs.graphs) == 3
    assert b.graph_stats()["pool_bytes"] > 0
    assert torch.cuda.memory_reserved() <= reserved
    serve = torch.from_numpy(clouds[8:12])
    g = _no_syncs(lambda: b.localize_block_async(serve, chunk=8).recs.clone())
    with b.eager():
        e = b.localize_block_async(serve, 8).recs
    assert torch.equal(g.view(torch.int32), e.view(torch.int32))
    assert (g[:, 0] > 0.5).sum() >= 2
    pool_b = b.graph_stats()["pool_bytes"]
    reserved = torch.cuda.memory_reserved()
    b.drop_graphs()
    assert not len(pool.live) and b.graph_stats()["pool_bytes"] == 0
    assert torch.cuda.memory_reserved() <= reserved - pool_b


# ---------------------------------------------------------------------------
# the last eager entry points as replays: range_search, the sharded paths
# ---------------------------------------------------------------------------

def _tiled_db(m, reps: int, device):
    """A DB on `device` whose store is m's n rows tiled `reps` times (every
    key tied `reps` ways, the ties across tiles of the search), the window
    over all of it."""
    n = m.n
    db = tdb.ContourDB(m.cfg, capacity=n * reps, device=device)
    db.store = type(m.store)(*[
        x[:n].repeat((reps,) + (1,) * (x.dim() - 1)).to(device)
        for x in m.store])
    db.keys_q = tdb.keys_to_q_layout(db.store.keys,
                                     db._kq_dtype()).contiguous()
    db.ts_store = torch.zeros((n * reps,), device=device)
    db.recs_store = torch.zeros((n * reps, tdb.RECORD_WIDTH), device=device)
    db.state = torch.tensor([n * reps, n * reps], dtype=torch.int32,
                            device=device)
    db.n = n * reps
    return db


def _cpu_db(db):
    c = tdb.ContourDB(db.cfg, capacity=db.capacity, device="cpu")
    c.store = type(db.store)(*[x.cpu() for x in db.store])
    c.keys_q, c.state, c.n = db.keys_q.cpu(), db.state.cpu(), db.n
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("keys_bf16", [True, False])
def test_range_search_graphed_equals_eager_and_cpu_on_card(cuda, keys_bf16):
    """`range_search` on an 8-scan card DB and on its rows tiled 64 times:
    each call one replay of the range graph of its cap (the first captures),
    with one host sync (the fetch), the hits and count equal to the eager
    body's and to a CPU copy's (ints exactly, distances to rtol 1e-6)."""
    from contour_context_tpu_torch.profile_step import host_syncs

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384,
                                                 keys_bf16=keys_bf16))
    clouds = _revisit_clouds()[1]
    m = tdb.ContourDB(cfg, capacity=16, device="cuda")
    for i in range(8):
        m.step_async(clouds[i], i, 6.0 * i)
    q = td.build_descriptor(torch.from_numpy(clouds[8]).to("cuda"), cfg.cm,
                            cfg.gmm)
    q_c = type(q)(*[x.cpu() for x in q])
    cases = ((3.0, 256), (60.0, 7), (1e12, 4096), (1e-9, 8), (60.0, 9000))
    for db in (m, _tiled_db(m, 64, "cuda")):
        c = _cpu_db(db)
        for radius, cap in cases:
            got = db.range_search(q, radius, cap)
            calls = []
            syncs = host_syncs(lambda: calls.append(
                db.range_search(q, radius, cap)))
            assert syncs == 1 and calls[0] == got, (radius, cap, syncs)
            with db.eager():
                assert db.range_search(q, radius, cap) == got
            hits_c, n_c = c.range_search(q_c, radius, cap)
            assert got[1] == n_c and [h[:4] for h in got[0]] == \
                [h[:4] for h in hits_c], (radius, cap)
            np.testing.assert_allclose([h[4] for h in got[0]],
                                       [h[4] for h in hits_c], rtol=1e-6,
                                       atol=0)
            if radius == 1e12 and db is not m:      # 64 ties a key
                assert n_c > cap
        assert sorted(k[1] for k in db._graphs.graphs
                      if k[0] == "range_search") == sorted(
                          cap for _, cap in cases)
        db.drop_graphs()


@pytest.mark.cuda
def test_sharded_graphed_paths_equal_eager_and_single_on_card(nccl_mesh):
    """World 1 over NCCL: serving, the query step and two block steps (one
    block graph for both: rows 8..11, then 12..15) as one replay a call
    with no host sync after the captures (sync debug mode "error"), bit for
    bit the eager calls; serving and the query step bit for bit the
    single-device f32 path, the blocks its records (ints exactly, floats in
    the record bands), window state and store."""
    from contour_context_tpu_torch import parallel as par

    mesh = nccl_mesh
    assert mesh.graphed and mesh.graph_stats()["reason"] is None
    cfg, clouds, db = _f32_map(mesh.device)
    shard = par.shard_store(db.store, mesh)
    serve = clouds[8:12]
    got = par.sharded_localize_block(shard, db.state, serve, cfg, mesh)
    again = _no_syncs(lambda: par.sharded_localize_block(
        shard, db.state, serve, cfg, mesh))
    with mesh.eager():
        eager = par.sharded_localize_block(shard, db.state, serve, cfg, mesh)
    want = db.localize_block_async(serve, chunk=4).recs
    for x in (again, eager, want):
        assert torch.equal(got, x)
    desc = td.build_descriptor(torch.from_numpy(clouds[10]).to("cuda"),
                               cfg.cm, cfg.gmm)
    rec = par.sharded_query_step(shard, desc, db.state, cfg, mesh)
    assert torch.equal(_no_syncs(lambda: par.sharded_query_step(
        shard, desc, db.state, cfg, mesh)), rec)
    assert torch.equal(rec, tdb.query_step(db.store, db.keys_q, desc,
                                           db.state, cfg))
    descs = td.build_descriptors(torch.from_numpy(serve).to("cuda"), cfg.cm,
                                 cfg.gmm)
    ts = [torch.tensor([6.0 * i for i in range(k, k + 4)], device="cuda")
          for k in (8, 12)]
    single = tdb.ContourDB(cfg, capacity=16, device="cuda")
    for i in range(8):
        single.step_async(clouds[i], i, 6.0 * i)
    recs_1 = torch.cat([single.process_block_async(
        descs, list(range(k, k + 4)), t).recs for k, t in zip((8, 12), ts)])
    out = {}
    for graphed in (True, False):
        sh = par.shard_store(db.store, mesh)
        ts_store, st, rs = (db.ts_store.clone(), db.state.clone(),
                            db.recs_store.clone())

        def block(i):
            return par.sharded_process_block(sh, ts_store, st, rs, descs,
                                             ts[i], 8 + 4 * i, cfg, mesh)

        if graphed:
            recs = torch.cat([block(0), _no_syncs(lambda: block(1))])
        else:
            with mesh.eager():
                recs = torch.cat([block(0), block(1)])
        out[graphed] = (recs, sh, ts_store, st, rs)
    (g, sh_g, ts_g, st_g, rs_g), (e, sh_e, ts_e, st_e, rs_e) = \
        out[True], out[False]
    assert torch.equal(g, e) and torch.equal(rs_g, rs_e)
    assert torch.equal(st_g, st_e) and torch.equal(st_g, single.state)
    assert torch.equal(ts_g, ts_e) and torch.equal(ts_g, single.ts_store)
    for a, b, c in zip(sh_g.store, sh_e.store, single.store):
        assert torch.equal(a, b) and torch.equal(a[:16], c[:16])
    assert torch.equal(sh_g.keys_q, sh_e.keys_q)
    _assert_records(g.cpu().numpy(), recs_1.cpu().numpy())
    stats = mesh.graph_stats()
    assert sorted(stats["capture_s"]) == [
        "block", "localize", "query_step"], stats["capture_s"]
    assert stats["pool_bytes"] > 0
