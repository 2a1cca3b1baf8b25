"""The `depth` stage gates of the port's query (`db.query_step`,
`db.query_step_batch`, `db.query_from_hits`) against JAX's
`_query_step_impl(..., depth=d)`.

tests/test_torch_query.py's carried-across store (11 synth scans, a revisit
world, 6 s apart, bf16 keys_q) and its revisit query of scan 1; the default
caps and the "squeezed" ones that make every overflow path run;
`dynamic_thres` off and on. At each of the six depths the probe is the
same sum of the same live tensors as JAX's: the integer-valued probes
("hints", "check1") exactly, the float ones to rtol 1e-4 (float32 sums
taken in another order). Three queries at B = 3 give, row by row, the
probes of the same queries at B = 1, and `depth=None` gives the record.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu import config as jconfig
from contour_context_tpu.utils.io import pad_points
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch.types import ScanDesc, scan_desc_from_numpy

torch.set_num_threads(2)

POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
    (30.0, -1.0, -0.15), (110.0, 40.0, 0.6), (50.2, 0.7, 0.1)]
# the revisit of scan 1, then two more queries for the batch
QUERY_POSES = [(10.5, 0.8, 0.2), (40.4, -0.5, -0.1), (70.2, 0.6, 0.05)]
INT_DEPTHS = ("hints", "check1")


def _configs(**db):
    return tuple(m.PipelineConfig(cm=m.ContourManagerConfig(max_points=16384),
                                  db=m.ContourDBConfig(**db))
                 for m in (jconfig, tconfig))


SQUEEZED = dict(max_check_cands=96, cascade_chunk=40, max_pass_hints=16,
                max_cand_poses=2, p_pot=8)
CASES = {(name, dyn): _configs(dynamic_thres=dyn, **caps)
         for name, caps in (("default", {}), ("squeezed", SQUEEZED))
         for dyn in (False, True)}


@pytest.fixture(scope="module")
def carried():
    """The seeded JAX DB and the JAX-built query descriptors."""
    from contour_context_tpu.db import ContourDB as JDB
    from contour_context_tpu.ops.descriptor import build_descriptor

    cfg = CASES[("default", False)][0]
    world = make_world(11, n_structs=220, extent=160.0)
    jdb = JDB(cfg, capacity=16)
    for i, pose in enumerate(POSES):
        pts = pad_points(render_scan(world, pose, seed=500 + i),
                         cfg.cm.max_points)
        jdb.add_scan(build_descriptor(jnp.asarray(pts), cfg.cm, cfg.gmm),
                     i, 6.0 * i)
        jdb.push_and_balance(6.0 * i)
    queries = [build_descriptor(jnp.asarray(pad_points(
        render_scan(world, p, seed=777 + k), cfg.cm.max_points)),
        cfg.cm, cfg.gmm) for k, p in enumerate(QUERY_POSES)]
    return jdb, queries


def _port_db(jdb, tcfg):
    return tdb.ContourDB.from_numpy_state(
        tcfg, store=jax.device_get(jdb.store), keys_q=np.asarray(jdb.keys_q),
        ts_store=np.asarray(jdb.ts_store), state=np.asarray(jdb.state),
        recs_store=None, n=jdb.n, seq_of_gidx=jdb.seq_of_gidx, device="cpu")


def _port_q(q):
    return scan_desc_from_numpy(jax.device_get(q), device="cpu")


def _close(got, want, depth, what):
    if depth in INT_DEPTHS:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0,
                                   err_msg=what)


@pytest.fixture(scope="module")
def jax_probes(carried):
    """{(case, dyn): {depth: JAX's probe of the revisit query}}."""
    from contour_context_tpu.db import _query_step_impl

    jdb, queries = carried
    step = jax.jit(_query_step_impl, static_argnames=("pcfg", "depth"))
    return {key: {d: float(step(jdb.store, queries[0], jdb.state[1], jcfg,
                                jdb.keys_q, depth=d))
                  for d in tdb.DEPTHS}
            for key, (jcfg, _) in CASES.items()}


@pytest.mark.parametrize("depth", tdb.DEPTHS)
@pytest.mark.parametrize("key", sorted(CASES), ids=lambda k: f"{k[0]}-"
                         f"{'dynamic' if k[1] else 'static'}")
def test_probe_matches_jax(carried, jax_probes, key, depth):
    jdb, queries = carried
    tcfg = CASES[key][1]
    db = _port_db(jdb, tcfg)
    got = tdb.query_step(db.store, db.keys_q, _port_q(queries[0]), db.state,
                         tcfg, depth=depth)
    assert got.shape == () and got.dtype == torch.float32
    _close(float(got), jax_probes[key][depth], depth, f"{key} {depth}")


@pytest.mark.parametrize("key", sorted(CASES), ids=lambda k: f"{k[0]}-"
                         f"{'dynamic' if k[1] else 'static'}")
def test_batch_probes_are_the_single_ones(carried, key):
    """Three queries at different window limits: row b of each batched
    probe is query b's probe at B = 1."""
    jdb, queries = carried
    tcfg = CASES[key][1]
    db = _port_db(jdb, tcfg)
    qs = [_port_q(q) for q in queries]
    descs = ScanDesc(*[torch.stack(x) for x in zip(*qs)])
    sb = torch.tensor([int(db.state[1]), 9, 6], dtype=torch.int32)
    for depth in tdb.DEPTHS:
        got = tdb.query_step_batch(db.store, db.keys_q, descs, sb, tcfg,
                                   depth=depth)
        assert got.shape == (3,) and got.dtype == torch.float32
        for b, q in enumerate(qs):
            state = db.state.clone()
            state[1] = sb[b]
            one = tdb.query_step(db.store, db.keys_q, q, state, tcfg,
                                 depth=depth)
            _close(float(got[b]), float(one), depth, f"{key} {depth} {b}")


def test_no_depth_gives_the_record(carried):
    from contour_context_tpu.db import _query_step

    jdb, queries = carried
    jcfg, tcfg = CASES[("default", False)]
    db = _port_db(jdb, tcfg)
    q = _port_q(queries[0])
    rec = tdb.query_step(db.store, db.keys_q, q, db.state, tcfg)
    assert torch.equal(rec, tdb.query_step(db.store, db.keys_q, q, db.state,
                                           tcfg, depth=None))
    rec_j = np.asarray(_query_step(jdb.store, queries[0], jdb.state, jcfg,
                                   jdb.keys_q))
    exact = [0, 1] + list(range(6, 18))
    np.testing.assert_array_equal(rec.numpy()[exact], rec_j[exact])
    np.testing.assert_allclose(rec.numpy()[2:6], rec_j[2:6], rtol=1e-4,
                               atol=1e-4)
    assert rec_j[0] > 0.5
    with pytest.raises(ValueError):
        tdb.query_step(db.store, db.keys_q, q, db.state, tcfg,
                       depth="tidy")
