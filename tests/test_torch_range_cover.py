"""`range_search` on the tile-min cover against the full sort and JAX.

The port's `db.range_search_impl` selects its `cap` rows by the exact
two-stage min-k of `db._topk_min_cover` (each (q, anchor) row tiled on its
own); `db.range_search_sorted_plain` is the one stable sort of all Q*A*NA
distances it replaced. Both are held against each other and against the
JAX package's `_range_search` on one seeded store of 4850 rows: NA = 29100
columns (not a multiple of 128), M = Q*A*NA = 523,800 flat distances, so
JAX takes its multi-stage `_topk_min` (M >= 4*TOPK_BLOCK), and 18 * 228 =
4104 tiles, so caps of 1, 7, 256 and 4096 take the cover and 5000 the
full sort (JAX: one top_k above TOPK_BLOCK). The store holds invalid
(zero) rows, a zero query anchor, two query anchors with equal keys (equal
rows of distances across (q, anchor) rows) and copies of one row and of a
query anchor's keys spread so that their equal distances straddle tile
boundaries (distance 0 for the copies of the query's keys, so a radius of
1e-9 keeps exactly those). Radii 1e-9, 3.0 and 1e12; searchable_n 0 and a
partial window; the port's DB with bf16 and with f32 `keys_q` (membership
comes from the f32 keys either way). Ints and the count exactly, the
distances to rtol 1e-6 (as tests/test_torch_dynamic.py: XLA contracts the
squared differences into FMAs on the CPU, torch does not); cover and full
sort bit for bit. The DB's graphed code path (the static query and
radius buffers, the range graph of each cap, its retag on a grow) runs on
the CPU through the stand-in pool of tests/test_torch_unfused_graphs.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contour_context_tpu import config as jconfig
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch.ops.kernels import TILE
from contour_context_tpu_torch.types import ScanDesc

from test_torch_unfused_graphs import fake_pool  # noqa: F401 (a fixture)

torch.set_num_threads(2)

N, L, A, D = 4850, 6, 6, 10
QL = (1, 2, 3)
SEARCHABLE = 3001
CAPS = (1, 7, 256, 4096, 5000)
RADII = (1e-9, 3.0, 1e12)
JCFG = jconfig.PipelineConfig()


@pytest.fixture(scope="module")
def store():
    """Keys (N, L, A, D) and query keys (L, A, D): uniform keys, every 9th
    row zero, query anchor 5 of level 2 zero, anchors 0 and 1 equal; row
    17's keys copied to rows that straddle or open tiles, and query anchor
    3's keys (every level) copied into rows across tiles."""
    rng = np.random.default_rng(14)
    keys = rng.uniform(0.5, 1.5, (N, L, A, D)).astype(np.float32)
    keys[::9] = 0.0
    qk = rng.uniform(0.5, 1.5, (L, A, D)).astype(np.float32)
    qk[:, 1] = qk[:, 0]
    qk[2, 5] = 0.0
    # column c = row * A + anchor; a tile is 128 columns: rows 21 (cols
    # 126..131), 42 (252..257) and 85 (510..515) straddle a boundary, row
    # 64 opens tile 3, row 2986 straddles one inside the window, 3500 past it
    for g in (21, 42, 64, 85, 2986, 3500):
        keys[g] = keys[17]
    for g, a in ((21, 2), (43, 5), (64, 0), (106, 4), (2986, 1)):
        keys[g, :, a] = qk[:, 3]
    return keys, qk


def _port_db(keys, keys_bf16: bool, searchable: int):
    cfg = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(
        keys_bf16=keys_bf16))
    db = tdb.ContourDB(cfg, capacity=N, device="cpu")
    k = torch.from_numpy(keys)
    db.store = ScanDesc(*[k if f == "keys" else k.new_zeros((N, 0))
                          for f in ScanDesc._fields])
    db.keys_q = tdb.keys_to_q_layout(k, db._kq_dtype()).contiguous()
    db.state = torch.tensor([N, searchable], dtype=torch.int32)
    db.ts_store = torch.zeros((N,))
    db.recs_store = torch.zeros((N, tdb.RECORD_WIDTH))
    db.n = N
    return db


def _jax_hits(keys, qk, searchable, radius, cap):
    from contour_context_tpu.db import MAX_DIST_SQ, _range_search

    packed = np.asarray(_range_search(
        jnp.asarray(keys), jnp.asarray(qk), jnp.int32(searchable),
        jnp.float32(min(float(radius), MAX_DIST_SQ)), QL, cap,
        JCFG.db.topk_strategy))
    n = (int(packed[0, 0]) << 20) + int(packed[0, 1])
    return [tuple(r) for r in packed[1:] if r[4] >= 0.0], n


def test_the_store_is_what_the_cases_need(store):
    keys, qk = store
    NA = N * A
    assert NA % TILE and len(QL) * A * NA >= 4 * 4096
    tiles = len(QL) * A * -(-NA // TILE)
    assert max(c for c in CAPS if c <= tiles) == 4096 < tiles < 5000
    # the copies of query anchor 3's keys sit in 5 tiles, at distance 0
    kq = tdb.keys_to_q_layout(torch.from_numpy(keys)).contiguous()
    packed = tdb.range_search_impl(kq, torch.from_numpy(qk),
                                   torch.tensor(N, dtype=torch.int32), 1e-9,
                                   QL, 64).numpy()
    hits = packed[1:][packed[1:, 4] >= 0]
    assert int(packed[0, 0]) == len(hits) == 15 and not hits[:, 4].any()
    cols = {int(g) * A + int(s) for g, _, s, _, _ in hits}
    assert len({c // TILE for c in cols}) == 5


@pytest.mark.parametrize("keys_bf16", [False, True])
@pytest.mark.parametrize("cap", CAPS)
def test_cover_equals_full_sort_and_jax(store, cap, keys_bf16):
    keys, qk = store
    q = torch.from_numpy(qk)
    kq = tdb.keys_to_q_layout(torch.from_numpy(keys)).contiguous()
    for searchable in (0, SEARCHABLE):
        db = _port_db(keys, keys_bf16, searchable)
        sn = torch.tensor(searchable, dtype=torch.int32)
        for radius in RADII:
            cover = tdb.range_search_impl(kq, q, sn, radius, QL, cap)
            full = tdb.range_search_sorted_plain(kq, q, sn, radius, QL, cap)
            assert torch.equal(cover, full), (searchable, radius)
            hits, n = db.range_search(_query(qk), radius, cap=cap)
            hits_j, n_j = _jax_hits(keys, qk, searchable, radius, cap)
            assert n == n_j and len(hits) == len(hits_j) == min(cap, n), \
                (searchable, radius)
            assert [h[:4] for h in hits] == \
                [tuple(int(x) for x in h[:4]) for h in hits_j], \
                (searchable, radius)
            np.testing.assert_allclose([h[4] for h in hits],
                                       [h[4] for h in hits_j], rtol=1e-6,
                                       atol=0)
            if searchable == 0:
                assert n == 0 and not hits
            elif radius == 1e12:
                assert n > cap


@pytest.mark.parametrize("seed", range(6))
def test_cover_equals_full_sort_on_small_stores_with_ties(seed):
    """Small stores (1-60 rows, so fewer tiles than most caps: the
    cover taking every tile, and taking some), every row of the store duplicated at
    random: the cover is the full sort bit for bit."""
    rng = np.random.default_rng(seed)
    for _ in range(8):
        n = int(rng.integers(1, 61))
        keys = rng.uniform(0.5, 1.5, (n, L, A, D)).astype(np.float32)
        keys[rng.random(n) < 0.2] = 0.0
        keys = keys[rng.integers(0, n, n)]
        qk = rng.uniform(0.5, 1.5, (L, A, D)).astype(np.float32)
        kq = tdb.keys_to_q_layout(torch.from_numpy(keys)).contiguous()
        sn = torch.tensor(int(rng.integers(0, n + 1)), dtype=torch.int32)
        for radius in (1e-9, 3.0, 8.0, 1e12):
            for cap in (1, 7, 64, 256, 4096):
                a = tdb.range_search_impl(kq, torch.from_numpy(qk), sn,
                                          radius, QL, cap)
                b = tdb.range_search_sorted_plain(kq, torch.from_numpy(qk),
                                                  sn, radius, QL, cap)
                assert torch.equal(a, b), (n, radius, cap)


def _query(qk):
    q = torch.from_numpy(qk)
    return ScanDesc(*[q if f == "keys" else None for f in ScanDesc._fields])


def test_graphed_range_search_equals_eager_and_regraphs_on_grow(fake_pool,
                                                                 store):
    keys, qk = store
    db = _port_db(keys, True, SEARCHABLE)
    db._graphs.enabled = True
    q = _query(qk)
    for _ in range(2):          # capture, then replay
        for cap in (7, 256):
            for radius in RADII:
                got = db.range_search(q, radius, cap)
                with db.eager():
                    assert db.range_search(q, radius, cap) == got
    assert sorted(db._graphs.graphs) == [
        ("range_search", c, torch.bfloat16, N) for c in (7, 256)]
    db._grow(N + 100)
    assert not db._graphs.graphs
    with db.eager():
        want = db.range_search(q, 3.0, 7)
    assert db.range_search(q, 3.0, 7) == want
    assert list(db._graphs.graphs) == [("range_search", 7, torch.bfloat16,
                                        N + 100)]
