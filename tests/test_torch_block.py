"""Block mode, map serving and the unfused API of the port against JAX.

One synth world, 12 scans 6 s apart (scans 8-11 revisit scans 1, 3, 5, 2):
- JAX `process_block_async` in blocks of B = 4 against the port's on the same
  clouds, and JAX `localize_block_async` (B = 4, chunk = 3, so the tail is
  padded) against the port's: found, gidx and counters exactly, corr and T to
  rtol 1e-4 with atol 1e-4 for corr and 2e-3 cells for the pose (two float32
  LM paths meet there; tests/test_torch_gmm.py holds the LM against float64);
- inside the port, bit for bit: the block records, store, keys_q and window
  state equal those of `step_async` on the same stream; `search_batch` and
  `query_step_batch` row b equal `search` and `query_step` at
  searchable_b[b]; the unfused query_async -> add_scan -> push_and_balance
  loop equals `step_async`; `block_chain_async` and `block_chain_pts_async`
  equal the block steps;
- `run_blocked`, `run_chained`, the unfused `run` and the CLI's `--chain`
  write the outcome file `run` writes.
A block of 4 at 6 s spans 18 s, and a query sees at most the pushes of the 3
scans before it (12 s < min_elapse 15 s): the block precondition holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_world, render_scan, se3_from_xyt

from contour_context_tpu import config as jconfig
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch.ops.descriptor import (build_descriptor,
                                                      build_descriptors)
from contour_context_tpu_torch.types import ScanDesc
from contour_context_tpu_torch.utils.io import pad_points

torch.set_num_threads(2)

JCFG = jconfig.PipelineConfig(cm=jconfig.ContourManagerConfig(max_points=16384))
CFG = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(max_points=16384))
POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
    (10.5, 0.8, 0.2), (30.0, -1.0, -0.15), (50.2, 0.7, 0.1),
    (20.3, 0.5, -0.1)]
N, B, DT = len(POSES), 4, 6.0
EXACT = [0, 1] + list(range(6, 18))       # found, gidx, counters


@pytest.fixture(scope="module")
def clouds():
    world = make_world(11, n_structs=220, extent=160.0)
    return np.stack([pad_points(render_scan(world, p, seed=500 + i),
                                CFG.cm.max_points)
                     for i, p in enumerate(POSES)])


@pytest.fixture(scope="module")
def descs(clouds):
    """The port's B-stacked descriptors of the 3 blocks."""
    return [build_descriptors(torch.from_numpy(clouds[k:k + B]), CFG.cm,
                              CFG.gmm) for k in range(0, N, B)]


@pytest.fixture(scope="module")
def port_stream(clouds):
    db = tdb.ContourDB(CFG, capacity=16, device="cpu")
    hs = [db.step_async(clouds[i], i, DT * i) for i in range(N)]
    return db, hs


@pytest.fixture(scope="module")
def port_block(descs):
    db = tdb.ContourDB(CFG, capacity=16, device="cpu")
    hs = [db.process_block_async(d, list(range(k * B, k * B + B)),
                                 [DT * i for i in range(k * B, k * B + B)])
          for k, d in enumerate(descs)]
    return db, hs


@pytest.fixture(scope="module")
def jax_block(clouds):
    """The JAX DB after the same 3 blocks, and its serving records of the 4
    revisit clouds (chunk 3)."""
    from contour_context_tpu.db import ContourDB as JDB
    from contour_context_tpu.ops.descriptor import build_descriptor as jbuild

    build_b = jax.jit(jax.vmap(lambda p: jbuild(p, JCFG.cm, JCFG.gmm)))
    jdb = JDB(JCFG, capacity=16)
    for k in range(0, N, B):
        jdb.process_block_async(
            build_b(jnp.asarray(clouds[k:k + B])), list(range(k, k + B)),
            np.asarray([DT * i for i in range(k, k + B)], np.float32))
    h = jdb.localize_block_async(jnp.asarray(clouds[8:12]), chunk=3)
    serving = np.asarray(h.recs)
    h.get()
    return jdb, serving


def _assert_records(rt, rj):
    np.testing.assert_array_equal(rt[:, EXACT], rj[:, EXACT])
    np.testing.assert_allclose(rt[:, 2], rj[:, 2], rtol=1e-4, atol=1e-4)
    found = rj[:, 0] > 0.5        # T is read only when found
    np.testing.assert_allclose(rt[found, 3:6], rj[found, 3:6], rtol=1e-4,
                               atol=2e-3)


def test_block_records_match_jax(port_block, jax_block):
    db, hs = port_block
    jdb, _ = jax_block
    rj = np.asarray(jdb.recs_store)[:N]
    _assert_records(db.recs_store[:N].numpy(), rj)
    assert (rj[8:, 0] > 0.5).all()
    assert [int(g) for g in rj[8:, 1]] == [1, 3, 5, 2]
    np.testing.assert_array_equal(db.state.numpy(), np.asarray(jdb.state))
    np.testing.assert_array_equal(db.ts_store.numpy(),
                                  np.asarray(jdb.ts_store))
    assert db.n == jdb.n == N and db.seq_of_gidx == jdb.seq_of_gidx


def test_block_equals_the_ports_stream(port_block, port_stream):
    db, hs = port_block
    ds, hss = port_stream
    assert torch.equal(db.recs_store, ds.recs_store)
    assert torch.equal(db.state, ds.state)
    assert torch.equal(db.ts_store, ds.ts_store)
    for name, x, y in zip(ScanDesc._fields, db.store, ds.store):
        assert torch.equal(x, y), name
    assert torch.equal(db.keys_q.view(torch.int16),
                       ds.keys_q.view(torch.int16))
    assert db.ts == ds.ts == [DT * i for i in range(N)]
    # one copy of the ring serves every block handle; the records count once
    tdb.drain_block_handles(hs)
    flat = [r for h in hs for r in h.get()]
    got = ds.drain(hss)
    assert [r and r[0] for r in flat] == [r and r[0] for r in got]
    assert db.counters == ds.counters and db.counters["n_hints"] > 0
    hs[0].get(), hss[0].get(), ds.drain(hss)
    assert db.counters == ds.counters


def test_localize_block_matches_jax(port_stream, jax_block, clouds):
    ds, _ = port_stream
    jdb, serving_j = jax_block
    before = dict(ds.counters)
    h = ds.localize_block_async(clouds[8:12], chunk=3)
    assert h.recs.shape == (4, tdb.RECORD_WIDTH) and h.row0 is None
    _assert_records(h.recs.numpy(), serving_j)
    res = h.get()
    # every query at the map's state: scan 8 finds itself, 9-11 their places
    assert [r[0] for r in res] == [8, 3, 5, 2]
    assert ds.n == N and ds.counters == before
    # the record counters as JAX's; the port also counts the build slots
    # it served in (two chunks of 3: one zero cloud of pad)
    assert ds.serving_counters == dict(jdb.serving_counters, build_slots=6)
    assert ds.serving_counters["n_hints"] > 0
    assert tdb.ContourDB(CFG, 8, device="cpu").localize_block_async(
        clouds[:2]) is None


def test_padded_serving_clouds_come_back_not_found(port_stream, clouds):
    ds, _ = port_stream
    zero = np.zeros_like(clouds[:1])
    h = ds.localize_block_async(np.concatenate([clouds[9:10], zero]))
    assert h.get()[0][0] == 3 and h.get()[1] is None


def test_localizing_no_cloud_gives_an_empty_block(port_stream, clouds):
    ds, _ = port_stream
    before = dict(ds.serving_counters)
    for chunk in (None, 3):
        h = ds.localize_block_async(clouds[:0], chunk=chunk)
        assert h.recs.shape == (0, tdb.RECORD_WIDTH) and h.get() == []
    assert ds.serving_counters == before


def test_search_batch_rows_equal_search(port_stream, descs):
    ds, _ = port_stream
    ql = tuple(CFG.db.q_levels)
    sb = torch.tensor([0, 3, 9, 12], dtype=torch.int32)
    hits = tdb.search_batch(ds.keys_q, descs[2].keys, sb, ql, CFG.db.nnk)
    for b in range(B):
        state = torch.tensor([N, int(sb[b])], dtype=torch.int32)
        one = tdb.search(ds.keys_q, descs[2].keys[b], state, ql, CFG.db.nnk)
        for x, y in zip(hits, one):
            assert torch.equal(x[b], y)
    assert int(hits[3][0].sum()) == 0 and int(hits[3][3].sum()) > 10


def test_query_step_batch_rows_equal_query_step(port_stream, descs):
    ds, _ = port_stream
    sb = torch.tensor([9, 4, 9, 0], dtype=torch.int32)
    recs = tdb.query_step_batch(ds.store, ds.keys_q, descs[2], sb, CFG)
    assert recs.shape == (B, tdb.RECORD_WIDTH)
    for b in range(B):
        state = torch.tensor([N, int(sb[b])], dtype=torch.int32)
        one = tdb.query_step(ds.store, ds.keys_q,
                             ScanDesc(*[x[b] for x in descs[2]]), state, CFG)
        assert torch.equal(recs[b], one), b
    assert recs[0, 0] == 1 and recs[2, 0] == 1 and recs[3, 0] == 0


def test_unfused_api_equals_step_async(port_stream, clouds):
    ds, hss = port_stream
    db = tdb.ContourDB(CFG, capacity=16, device="cpu")
    hs = []
    for i in range(N):
        desc = build_descriptor(torch.from_numpy(clouds[i]), CFG.cm, CFG.gmm)
        hs.append(db.query_async(desc))
        db.add_scan(desc, i, DT * i)
        db.push_and_balance(DT * i)
    assert hs[0] is None and hs[1].row is None
    for i in range(1, N):
        assert torch.equal(hs[i].rec, ds.recs_store[i]), i
    assert torch.equal(db.state, ds.state) and db.ts == ds.ts
    for name, x, y in zip(ScanDesc._fields, db.store, ds.store):
        assert torch.equal(x, y), name
    # drain takes ring-backed and standalone handles at once, and a handle
    # fetched by get() before is not counted again
    first = hs[8].get()
    mixed = tdb.drain_handles(hs + [hss[8]])
    assert mixed[8] == first and mixed[-1][0] == first[0] == 1
    ds.drain(hss)
    stream = dict(ds.counters)
    for k in ("n_hints", "cand_aft_check1", "cand_aft_check3"):
        assert db.counters[k] == stream[k] > 0
    assert db.query_ranged_knn(
        build_descriptor(torch.from_numpy(clouds[9]), CFG.cm, CFG.gmm))[0] \
        in (3, 9)


@pytest.mark.parametrize("from_points", [False, True])
def test_block_chains_equal_block_steps(port_block, descs, clouds,
                                        from_points):
    ref, _ = port_block
    db = tdb.ContourDB(CFG, capacity=16, device="cpu")
    ts_nb = [[DT * i for i in range(k, k + B)] for k in range(0, N, B)]
    if from_points:
        h = db.block_chain_pts_async(
            torch.from_numpy(clouds).reshape(N // B, B, -1, 4),
            list(range(N)), ts_nb)
    else:
        stacked = ScanDesc(*[torch.stack(xs) for xs in zip(*descs)])
        h = db.block_chain_async(stacked, list(range(N)), ts_nb)
    assert h.row0 == 0 and torch.equal(h.recs, ref.recs_store[:N])
    assert torch.equal(db.recs_store, ref.recs_store)
    assert torch.equal(db.state, ref.state)
    assert [r and r[0] for r in h.get()][8:] == [1, 3, 5, 2]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, clouds):
    """The 12 scans in the KITTI two-file format, and `run`'s outcome."""
    from contour_context_tpu_torch.pipeline import run_batch

    d = tmp_path_factory.mktemp("block")
    pl, ll = [], []
    for i, p in enumerate(POSES):
        c = clouds[i][clouds[i][:, 3] > 0].copy()
        c[:, 3] = 0.0
        bp = str(d / ("%06d.bin" % i))
        c.tofile(bp)
        pl.append("%.6f %s" % (DT * i, " ".join(
            "%.6f" % v for v in se3_from_xyt(p)[:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (DT * i, i, bp))
    (d / "p.txt").write_text("\n".join(pl))
    (d / "l.txt").write_text("\n".join(ll))
    f_pose, f_laser = str(d / "p.txt"), str(d / "l.txt")
    pipe = run_batch(f_pose, f_laser, str(d / "out_run.txt"), cfg=CFG,
                     device="cpu", fused_step=True)
    found = {r.q_seq: r.cand_seq for r in pipe.results
             if r.correlation >= CFG.correlation_thres}
    assert found == {8: 1, 9: 3, 10: 5, 11: 2}
    return f_pose, f_laser, d


@pytest.mark.parametrize("mode", ["blocked", "chained", "unfused"])
def test_other_replays_write_runs_outcome(dataset, mode):
    """10 of the 12 scans: two full groups of 4 and a 2-scan tail through
    the per-scan path."""
    from contour_context_tpu_torch.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu_torch.pipeline import LoopClosurePipeline

    f_pose, f_laser, d = dataset
    ev = ContLCDEvaluator(f_pose, f_laser, CFG.correlation_thres)
    pipe = LoopClosurePipeline(CFG, ev, capacity=16, device="cpu",
                               fused_step=mode != "unfused")
    if mode == "blocked":
        pipe.run_blocked(block=4, max_scans=10)
    elif mode == "chained":
        pipe.run_chained(chain=4, max_scans=10)
    else:
        pipe.run(max_scans=10)
    out = d / f"out_{mode}.txt"
    pipe.save_outcome(str(out))
    assert pipe.db.n == 10 and len(pipe.results) == 10
    want = (d / "out_run.txt").read_text().splitlines()[:10]
    assert out.read_text().splitlines() == want


def test_cli_chain_writes_runs_outcome(dataset):
    from contour_context_tpu_torch.__main__ import main

    f_pose, f_laser, d = dataset
    out = d / "out_cli_chain.txt"
    main(["--pose", f_pose, "--laser", f_laser, "--outcome", str(out),
          "--device", "cpu", "--chain", "5"])
    assert out.read_text() == (d / "out_run.txt").read_text()
    out = d / "out_cli_fused.txt"
    main(["--pose", f_pose, "--laser", f_laser, "--outcome", str(out),
          "--device", "cpu", "--fused-step", "--max-scans", "9"])
    assert out.read_text().splitlines() == \
        (d / "out_run.txt").read_text().splitlines()[:9]
