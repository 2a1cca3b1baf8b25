"""Map serving sized to the request (`db.serve_chunks`,
`ContourDB.localize_block_async`): the chunk plan of a request, and a
cloud's record the same whatever chunk it rode in.

No jax. The graphed cases take the graphed code path on the CPU through
the stand-in pool of `torch_graph_stub` (a capture runs the body, a replay
runs it again).
"""

import numpy as np
import pytest
import torch

from synth import make_world, render_scan
import torch_graph_stub

from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch.config import (ContourManagerConfig,
                                              PipelineConfig)
from contour_context_tpu_torch.utils.io import pad_points

torch.set_num_threads(2)

CFG = PipelineConfig(cm=ContourManagerConfig(max_points=4096))
N_MAP = 8


@pytest.mark.parametrize("B", [1, 2, 3, 5, 15, 16, 17, 21, 33])
def test_serve_chunks_cover_a_request_in_powers_of_two(B):
    sizes = tdb.serve_chunks(B)
    assert sum(sizes) == B
    assert all(c & (c - 1) == 0 and 1 <= c <= tdb.SERVE_CHUNK
               for c in sizes)
    assert sizes == sorted(sizes, reverse=True)
    assert len(sizes) == B // tdb.SERVE_CHUNK + bin(B % 16).count("1")
    assert tdb.serve_chunks(B, graphed=False) == [B]


def test_serve_chunks_with_a_chunk_pad_to_whole_chunks():
    assert tdb.serve_chunks(16) == [16]
    assert tdb.serve_chunks(21) == [16, 4, 1]
    assert tdb.serve_chunks(3, 2) == [2, 2]
    assert tdb.serve_chunks(3, 8) == [8]
    assert tdb.serve_chunks(3, 8, graphed=False) == [3]
    assert tdb.serve_chunks(10, 4, graphed=False) == [4, 4, 4]
    assert tdb.serve_chunks(0) == tdb.serve_chunks(0, 4) == []


@pytest.fixture(scope="module")
def scene():
    """A map of N_MAP scans 8 m apart, built in one block, and 16 query
    clouds: the map's places seen 0.7 m to the side, then fresh places."""
    world = make_world(5, n_structs=60, extent=80.0)

    def cloud(pose, seed):
        return pad_points(render_scan(world, pose, seed=seed,
                                      pts_per_struct=60), CFG.cm.max_points)

    maps = np.stack([cloud((8.0 * i, 0.0, 0.0), i) for i in range(N_MAP)])
    queries = np.stack([cloud((8.0 * (i % N_MAP) + 0.3, 0.7, 0.05 * i),
                              100 + i) for i in range(16)])
    db = tdb.ContourDB(CFG, capacity=N_MAP, device="cpu")
    db.block_chain_pts_async(torch.from_numpy(maps)[None],
                             list(range(N_MAP)),
                             [[6.0 * i for i in range(N_MAP)]])
    return db, torch.from_numpy(queries)


@pytest.mark.parametrize("graphed", [False, True])
def test_a_clouds_record_does_not_depend_on_its_request(scene, graphed):
    """One-cloud and three-cloud requests (graphed: chunks 1, and 2 + 1)
    give the records the same clouds get inside one 16-cloud request, bit
    for bit; the build slots count the clouds and nothing else."""
    db, queries = scene
    db.serving_counters = db._zero_serving_counters()
    with torch_graph_stub.fake_pool():
        db._graphs.enabled = graphed
        whole = db.localize_block_async(queries).recs
        assert db.serving_counters["build_slots"] == 16
        found = (whole[:, 0] > 0.5).nonzero().flatten().tolist()
        assert len(found) >= 4
        at = min(found[1], 13)
        for lo, hi in ((found[0], found[0] + 1), (at, at + 3), (13, 16)):
            part = db.localize_block_async(queries[lo:hi]).recs
            assert torch.equal(part.view(torch.int32),
                               whole[lo:hi].view(torch.int32)), (lo, hi)
        assert db.serving_counters["build_slots"] == 16 + 1 + 3 + 3
        if graphed:
            assert sorted({k[-1] for k in db._graphs.graphs
                           if k[0] == "query"}) == [1, 2, 16]
        db._graphs.drop()
