"""Chains of fused steps: `step_chain_async`, `step_chain_dyn_async` and
`stage_chain_k` against the JAX package's, and `run_chained` (mirrors
tests/test_block_mode.py:286-372).

Twelve scans at irregular gaps (1 s to 30 s, so the window pops at uneven
points; scans 6-11 revisit 5-0) go through a dynamic-length chain of 5 out
of a 12-row buffer, then 7 out of a second 12-row buffer (its last 5 rows
are filler) with the length staged by `stage_chain_k`, in both packages on
the CPU. Each chain returns one BlockHandle over its record-ring rows. The
port's chain records equal its own per-scan `step_async` stream bit for bit
(the same code), and the JAX chain's records in the record bands: found,
gidx and counters exactly, corr to rtol and atol 1e-4, T of found rows to
rtol 1e-4 and atol 2e-3 cells (where two float32 LM paths meet).
`run_chained` queues each chain as one block and writes the outcome file of
`run`.
"""

import numpy as np
import pytest
import torch

from synth import make_world, render_scan, se3_from_xyt

from contour_context_tpu import config as jconfig
from contour_context_tpu.utils.io import pad_points
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb

torch.set_num_threads(2)

JCFG = jconfig.PipelineConfig(cm=jconfig.ContourManagerConfig(max_points=16384))
CFG = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(max_points=16384))
POSES = [(10.0 * i, 0.0, 0.0) for i in range(6)] + [
    (10.0 * (5 - i) + 0.5, 0.8, 0.15) for i in range(6)]
TS = np.cumsum([1.0, 2.0, 16.0, 1.0, 30.0, 1.5,
                1.0, 20.0, 2.0, 16.0, 1.0, 25.0]).astype(np.float32)
EXACT = [0, 1] + list(range(6, 18))


@pytest.fixture(scope="module")
def buffers():
    """Two 12-row buffers with their timestamps: the stream, and the
    stream's scans 5-11 followed by 5 filler rows."""
    world = make_world(12, n_structs=220, extent=160.0)
    clouds = np.stack([pad_points(render_scan(world, p, seed=800 + i), 16384)
                       for i, p in enumerate(POSES)])
    buf_b = np.concatenate([clouds[5:], clouds[:5]])
    ts_b = np.concatenate([TS[5:], np.zeros(5, np.float32)])
    return clouds, (clouds, TS), (buf_b, ts_b)


@pytest.fixture(scope="module")
def jax_chain(buffers):
    import jax.numpy as jnp

    from contour_context_tpu.db import ContourDB as JDB

    _, (buf_a, ts_a), (buf_b, ts_b) = buffers
    jdb = JDB(JCFG, capacity=32)
    h1 = jdb.step_chain_dyn_async(jnp.asarray(buf_a), list(range(5)), ts_a)
    h2 = jdb.step_chain_dyn_async(jnp.asarray(buf_b), list(range(5, 12)),
                                  ts_b, k_dev=JDB.stage_chain_k(7))
    return jdb, h1.get() + h2.get()


@pytest.fixture(scope="module")
def port_chain(buffers):
    _, (buf_a, ts_a), (buf_b, ts_b) = buffers
    db = tdb.ContourDB(CFG, capacity=32, device="cpu")
    h1 = db.step_chain_dyn_async(torch.from_numpy(buf_a), list(range(5)),
                                 ts_a)
    h2 = db.step_chain_dyn_async(
        torch.from_numpy(buf_b), list(range(5, 12)), ts_b,
        k_dev=tdb.ContourDB.stage_chain_k(7, device="cpu"))
    return db, (h1, h2)


def test_chain_returns_one_block_handle(port_chain):
    db, (h1, h2) = port_chain
    for h, row0, k in ((h1, 0, 5), (h2, 5, 7)):
        assert isinstance(h, tdb.BlockHandle)
        assert h.row0 == row0 and tuple(h.recs.shape) == (k, 18)
        assert len(h.get()) == k
    assert db.n == 12 and db.seq_of_gidx == list(range(12))
    # step_chain_async is the chain of the whole buffer, .get() as in JAX
    clouds = port_chain[1][0].recs.new_zeros((2, 16384, 4))
    db2 = tdb.ContourDB(CFG, capacity=4, device="cpu")
    h = db2.step_chain_async(clouds, [0, 1], [0.0, 1.0])
    assert isinstance(h, tdb.BlockHandle) and h.get() == [None, None]


def test_chain_equals_the_step_stream(buffers, port_chain):
    clouds = buffers[0]
    db, _ = port_chain
    ref = tdb.ContourDB(CFG, capacity=32, device="cpu")
    for i in range(12):
        ref.step_async(clouds[i], i, float(TS[i]))
    assert torch.equal(db.recs_store[:12], ref.recs_store[:12])
    assert torch.equal(db.state, ref.state)
    for a, b in zip(db.store, ref.store):
        assert torch.equal(a[:12], b[:12])
    assert db.ts == ref.ts and db.seq_of_gidx == ref.seq_of_gidx


def test_chain_matches_jax(jax_chain, port_chain):
    jdb, jres = jax_chain
    db, (h1, h2) = port_chain
    a = np.asarray(jdb.recs_store)[:12]
    b = db.recs_store[:12].numpy()
    np.testing.assert_array_equal(b[:, EXACT], a[:, EXACT])
    np.testing.assert_allclose(b[:, 2], a[:, 2], rtol=1e-4, atol=1e-4)
    found = a[:, 0] > 0.5
    np.testing.assert_allclose(b[found, 3:6], a[found, 3:6], rtol=1e-4,
                               atol=2e-3)
    assert found.sum() >= 2
    assert db.searchable_n == jdb.searchable_n and db.n == jdb.n
    got = h1.get() + h2.get()
    assert [r is None for r in got] == [r is None for r in jres]
    assert [r[0] for r in got if r] == [r[0] for r in jres if r]


def test_staged_k_is_checked_on_the_host(buffers):
    _, (buf_a, ts_a), _ = buffers
    k, k_dev = tdb.ContourDB.stage_chain_k(3, device="cpu")
    assert k == 3 and k_dev.dtype == torch.int32 and int(k_dev) == 3
    assert k_dev.dim() == 0 and k_dev.device.type == "cpu"
    db = tdb.ContourDB(CFG, capacity=8, device="cpu")
    pts = torch.from_numpy(buf_a[:4])
    with pytest.raises(ValueError, match="staged k"):
        db.step_chain_dyn_async(pts, [0, 1], ts_a[:4], k_dev=(k, k_dev))
    with pytest.raises(ValueError):
        db.step_chain_dyn_async(pts, list(range(5)), ts_a[:4])
    with pytest.raises(ValueError, match="full buffer"):
        db.step_chain_dyn_async(pts, [0, 1], ts_a[:2])
    assert db.n == 0 and db.store is None           # nothing was stepped


def _write_dataset(d, clouds):
    pl, ll = [], []
    for i, p in enumerate(POSES):
        c = clouds[i][clouds[i][:, 3] > 0].copy()
        bp = str(d / ("%06d.bin" % i))
        c.tofile(bp)
        pl.append("%.6f %s" % (TS[i], " ".join(
            "%.6f" % v for v in se3_from_xyt(p)[:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (TS[i], i, bp))
    (d / "p.txt").write_text("\n".join(pl))
    (d / "l.txt").write_text("\n".join(ll))
    return str(d / "p.txt"), str(d / "l.txt")


def test_run_chained_queues_one_block_a_chain(buffers, tmp_path):
    from contour_context_tpu_torch.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu_torch.pipeline import LoopClosurePipeline

    f_pose, f_laser = _write_dataset(tmp_path, buffers[0])

    def pipe():
        ev = ContLCDEvaluator(f_pose, f_laser, CFG.correlation_thres)
        return LoopClosurePipeline(CFG, ev, 16, fused_step=True,
                                   device="cpu")

    ref = pipe()
    ref.run()
    ref.save_outcome(str(tmp_path / "run.txt"))
    p = pipe()
    p.run_chained(chain=5, drain_at_end=False)    # 2 chains + a 2-scan tail
    kinds = [type(h).__name__ for _, h in p._pending]
    assert kinds == ["BlockHandle", "BlockHandle", "QueryHandle",
                     "QueryHandle"], kinds
    assert [len(i) for i, _ in list(p._pending)[:2]] == [5, 5]
    p.drain()
    p.save_outcome(str(tmp_path / "chained.txt"))
    assert (tmp_path / "chained.txt").read_text() == \
        (tmp_path / "run.txt").read_text()
    assert torch.equal(p.db.recs_store[:12], ref.db.recs_store[:12])


def test_step_chain_scan_matches_jax(buffers):
    """`step_chain_scan_async` (JAX's lax.scan lowering; the port's one
    chain) on the stream's first 5 scans against JAX's, and its check that
    the K timestamps name the K seqs."""
    import jax.numpy as jnp

    from contour_context_tpu.db import ContourDB as JDB

    clouds = buffers[0]
    jdb = JDB(JCFG, capacity=8)
    hj = jdb.step_chain_scan_async(jnp.asarray(clouds[:5]), list(range(5)),
                                   jnp.asarray(TS[:5]))
    db = tdb.ContourDB(CFG, capacity=8, device="cpu")
    h = db.step_chain_scan_async(torch.from_numpy(clouds[:5]),
                                 list(range(5)), TS[:5])
    assert isinstance(h, tdb.BlockHandle) and (h.row0, db.n) == (0, 5)
    a, b = np.asarray(hj.recs), h.recs.numpy()
    np.testing.assert_array_equal(b[:, EXACT], a[:, EXACT])
    np.testing.assert_allclose(b[:, 2], a[:, 2], rtol=1e-4, atol=1e-4)
    assert db.searchable_n == jdb.searchable_n
    with pytest.raises(ValueError, match="timestamps"):
        db.step_chain_scan_async(torch.from_numpy(clouds[5:7]), [5, 6],
                                 TS[5:8])
    assert db.n == 5
