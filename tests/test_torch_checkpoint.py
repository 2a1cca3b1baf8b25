"""Checkpoints and merge of the port against the JAX package's.

A JAX ContourDB of 9 synth scans (scan 8 revisits scan 1) is saved; the file
loads in the port and a file saved by the port loads in JAX, with the same
npz members and dtypes. Everything a checkpoint carries is a copy, so stores,
timestamps, window state, counters and ids are compared exactly; the derived
leaves (`tab12`, `gmm_pack`) and `keys_q` are recomputed on load and must be
bit-equal to what the descriptor build and the appends wrote. A query on the
merged map is held to the record band (found, gidx and counters exactly, corr
and T to rtol 1e-4, atol 1e-4 for corr and 2e-3 cells for the pose, where two
float32 LM paths meet). One leaf differs between the packages by a last
bit: `gmm_pack` holds sqrt(eig_vals), and XLA's and torch's CPU sqrt round
differently; across packages it is held to rtol 1e-6, inside the port to
bit-equality with the port's own descriptor build.
"""

import zipfile

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
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.types import (ScanDesc, scan_desc_from_numpy,
                                             scan_desc_spec)

torch.set_num_threads(2)

JCFG = jconfig.PipelineConfig(cm=jconfig.ContourManagerConfig(max_points=16384))
CFG = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(max_points=16384))
POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [(10.5, 0.8, 0.2)]
DERIVED = ("tab12", "gmm_pack")


@pytest.fixture(scope="module")
def jax_db(tmp_path_factory):
    """(JAX DB of the 9 scans with counters from one query, its descriptors
    as numpy, its query descriptor, its saved file)."""
    from contour_context_tpu.db import ContourDB as JDB
    from contour_context_tpu.ops.descriptor import build_descriptor

    world = make_world(11, n_structs=220, extent=160.0)
    jdb = JDB(JCFG, capacity=16)
    descs = []
    for i, pose in enumerate(POSES):
        pts = pad_points(render_scan(world, pose, seed=500 + i),
                         JCFG.cm.max_points)
        desc = build_descriptor(jnp.asarray(pts), JCFG.cm, JCFG.gmm)
        descs.append(jax.device_get(desc))
        jdb.add_scan(desc, i, 6.0 * i)
        jdb.push_and_balance(6.0 * i)
    q = build_descriptor(jnp.asarray(pad_points(
        render_scan(world, (20.3, 0.5, -0.1), seed=900),
        JCFG.cm.max_points)), JCFG.cm, JCFG.gmm)
    assert jdb.query_ranged_knn(q)[0] == 2
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jdb.save(path)
    return jdb, descs, q, path


def _assert_store_equals_jax(store, store_j):
    for name, x, y in zip(ScanDesc._fields, store, jax.device_get(store_j)):
        if name == "gmm_pack":
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                       atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                          err_msg=name)


def _assert_db_equals_jax(db, jdb):
    _assert_store_equals_jax(db.store, jdb.store)
    kq_j = np.asarray(jdb.keys_q)
    assert torch.equal(db.keys_q.view(torch.int16),
                       torch.from_numpy(kq_j.view(np.int16).copy()))
    np.testing.assert_array_equal(db.ts_store.numpy(),
                                  np.asarray(jdb.ts_store))
    np.testing.assert_array_equal(db.state.numpy(), np.asarray(jdb.state))
    assert db.n == jdb.n and db.capacity == jdb.capacity
    assert db.seq_of_gidx == jdb.seq_of_gidx and db.ts == jdb.ts
    assert db.counters == jdb.counters


def test_a_jax_checkpoint_loads_in_the_port(jax_db):
    jdb, _, _, path = jax_db
    db = tdb.ContourDB.load(path, CFG, device="cpu")
    _assert_db_equals_jax(db, jdb)
    assert db.counters["n_hints"] > 0 and db.searchable_n == 6


def test_a_port_checkpoint_loads_in_jax(jax_db, tmp_path):
    from contour_context_tpu.db import ContourDB as JDB

    jdb, _, _, path = jax_db
    db = tdb.ContourDB.load(path, CFG, device="cpu")
    p2 = str(tmp_path / "port.npz")
    db.save(p2, chunk_bytes=4096)        # several row blocks a leaf
    with np.load(path) as a, np.load(p2) as b:
        assert sorted(a.files) == sorted(b.files)
        assert not [f for f in b.files if f in ("store_22", "store_23")]
        for f in a.files:
            assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    with zipfile.ZipFile(p2) as zf:
        assert all(i.compress_type == zipfile.ZIP_DEFLATED
                   for i in zf.infolist())
    back = JDB.load(p2, JCFG)
    for name, x, y in zip(ScanDesc._fields, jax.device_get(back.store),
                          jax.device_get(jdb.store)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)
    assert back.n == jdb.n and back.counters == jdb.counters
    assert back.ts == jdb.ts and back.searchable_n == jdb.searchable_n


def _desc(descs, i):
    """Scan i's JAX-built descriptor with the port's own derived leaves (as
    the port's build packs them)."""
    d = scan_desc_from_numpy(descs[i], device="cpu")
    return d._replace(tab12=td.tab12_of(d),
                      gmm_pack=td.gmm_pack_of(d, CFG.gmm))


def _port_db(descs, n):
    db = tdb.ContourDB(CFG, capacity=16, device="cpu")
    for i in range(n):
        db.add_scan(_desc(descs, i), i, 6.0 * i)
        db.push_and_balance(6.0 * i)
    return db


def test_base_and_delta_chain(jax_db, tmp_path):
    from contour_context_tpu.db import ContourDB as JDB

    jdb, descs, _, _ = jax_db
    db = _port_db(descs, 5)
    base, delta, late = (str(tmp_path / f) for f in
                         ("base.npz", "delta.npz", "late.npz"))
    db.save(base)
    for i in range(5, 9):
        db.add_scan(_desc(descs, i), i, 6.0 * i)
        db.push_and_balance(6.0 * i)
    db.counters["n_hints"] = 7
    db.save(delta, since=5)
    db.save(late, since=6)
    with np.load(delta) as z:
        assert int(z["since"]) == 5 and z["store_12"].shape[0] == 4
    got = tdb.ContourDB.load_chain([base, delta], CFG, capacity=32,
                                   device="cpu")
    assert got.capacity == 32 and got.n == 9 and got.counters == db.counters
    for name, x, y in zip(ScanDesc._fields, got.store, db.store):
        assert torch.equal(x[:16], y), name
    assert torch.equal(got.keys_q[:, :, :16 * 6].view(torch.int16),
                       db.keys_q.view(torch.int16))
    assert torch.equal(got.state, db.state) and got.ts == db.ts
    assert torch.equal(got.ts_store[:16], db.ts_store)
    assert got.seq_of_gidx == db.seq_of_gidx
    # the chain the port wrote restores in JAX too, equal to its own DB
    back = JDB.load_chain([base, delta], JCFG)
    np.testing.assert_array_equal(np.asarray(back.store.keys),
                                  np.asarray(jdb.store.keys))
    np.testing.assert_array_equal(np.asarray(back.state),
                                  np.asarray(jdb.state))
    with pytest.raises(ValueError, match="chain gap"):
        tdb.ContourDB.load_chain([base, late], CFG, device="cpu")
    with pytest.raises(ValueError, match="full save"):
        tdb.ContourDB.load_chain([delta], CFG, device="cpu")
    # the restored DB keeps streaming
    got.add_scan(_desc(descs, 0), 9, 54.0)
    got.push_and_balance(54.0)
    assert got.n == 10 and got.searchable_n >= db.searchable_n > 0


def test_epoch_scale_timestamps_survive(jax_db, tmp_path):
    """Stamps of ~1.7e9 s round by ~100 s in the f32 ts_store; the host f64
    list keeps them through save, delta and load."""
    _, descs, _, _ = jax_db
    stamps = [1.7e9 + 0.1 * i for i in range(4)]
    db = tdb.ContourDB(CFG, capacity=8, device="cpu")
    for i, t in enumerate(stamps[:3]):
        db.add_scan(_desc(descs, i), i, t)
    base, delta = str(tmp_path / "b.npz"), str(tmp_path / "d.npz")
    db.save(base)
    db.step_async(np.zeros((CFG.cm.max_points, 4), np.float32), 3, stamps[3])
    db.save(delta, since=3)
    assert tdb.ContourDB.load(base, CFG, device="cpu").ts == stamps[:3]
    got = tdb.ContourDB.load_chain([base, delta], CFG, device="cpu")
    assert got.ts == stamps and float(got.ts_store[1]) != stamps[1]
    with np.load(delta) as z:
        assert z["ts"].dtype == np.float64 and z["ts_store"].dtype == np.float32
    # a device timestamp leaves no host copy: save falls back to ts_store
    db.add_scan(_desc(descs, 4), 4, torch.tensor(5.0))
    db.save(base)
    assert tdb.ContourDB.load(base, CFG, device="cpu").ts == \
        [float(t) for t in db.ts_store[:5]]


def test_derived_leaves_are_recomputed_bit_equal(jax_db, tmp_path):
    _, descs, _, _ = jax_db
    world = make_world(11, n_structs=220, extent=160.0)
    pts = pad_points(render_scan(world, POSES[3], seed=503),
                     CFG.cm.max_points)
    desc = td.build_descriptor(torch.from_numpy(pts), CFG.cm, CFG.gmm)
    assert torch.equal(td.tab12_of(desc), desc.tab12)
    assert torch.equal(td.gmm_pack_of(desc, CFG.gmm), desc.gmm_pack)
    assert float(desc.tab12.abs().sum()) > 0 < float(desc.gmm_pack.abs().sum())
    # over a stacked store, and through a file that holds neither leaf
    db = _port_db(descs, 4)
    db.add_scan(desc, 4, 24.0)
    assert torch.equal(td.tab12_of(db.store), db.store.tab12)
    assert torch.equal(td.gmm_pack_of(db.store, CFG.gmm), db.store.gmm_pack)
    path = str(tmp_path / "d.npz")
    db.save(path)
    with np.load(path) as z:
        idx = [ScanDesc._fields.index(f) for f in DERIVED]
        assert not any(f"store_{i}" in z.files for i in idx)
        assert "keys_q" not in z.files
    got = tdb.ContourDB.load(path, CFG, device="cpu")
    assert torch.equal(got.store.tab12, db.store.tab12)
    assert torch.equal(got.store.gmm_pack, db.store.gmm_pack)


def test_legacy_files_are_migrated(jax_db, tmp_path):
    """A file without the trailing leaves, with a wider legacy dtype and no
    counter_keys: zero-filled, cast, counters by the legacy names."""
    jdb, _, _, path = jax_db
    legacy = str(tmp_path / "legacy.npz")
    i_pix = ScanDesc._fields.index("pix_overflow")
    i_gmm = ScanDesc._fields.index("gmm_overflow")
    with np.load(path) as z:
        members = {f: z[f] for f in z.files
                   if f not in (f"store_{i_pix}", f"store_{i_gmm}",
                                "counter_keys", "ts", "since")}
    members["store_0"] = members["store_0"].astype(np.int32)
    members["counters"] = np.arange(1, 9, dtype=np.int64)
    np.savez(legacy, **members)
    db = tdb.ContourDB.load(legacy, CFG, device="cpu")
    spec = scan_desc_spec(CFG.cm, CFG.gmm)
    for name, x in zip(ScanDesc._fields, db.store):
        assert x.dtype == spec[name][1], name
    np.testing.assert_array_equal(db.store.cnt.numpy(),
                                  np.asarray(jdb.store.cnt))
    assert int(db.store.pix_overflow.abs().sum()) == 0
    assert db.counters["cand_aft_check1"] == 1 and db.counters["n_hints"] == 4
    assert db.counters["overflow_pot"] == 8 and db.counters["overflow_win"] == 0
    assert db.ts == [float(t) for t in np.asarray(jdb.ts_store)[:9]]


def test_merge_matches_jax(jax_db):
    from contour_context_tpu.db import ContourDB as JDB
    from contour_context_tpu.db import _query_step

    jdb, _, q, path = jax_db
    jm = JDB.merge([jdb, JDB.load(path, JCFG)])
    a = tdb.ContourDB.load(path, CFG, device="cpu")
    m = tdb.ContourDB.merge([a, tdb.ContourDB.load(path, CFG, device="cpu"),
                             tdb.ContourDB(CFG, 4, device="cpu")])
    assert m.n == jm.n == 18 and m.capacity == jm.capacity == 18
    np.testing.assert_array_equal(m.state.numpy(), np.asarray(jm.state))
    np.testing.assert_array_equal(m.state.numpy(), [18, 18])
    np.testing.assert_array_equal(m.ts_store.numpy(), np.asarray(jm.ts_store))
    assert m.session_of_gidx == jm.session_of_gidx
    assert m.session_of_gidx[8:10] == [(0, 8), (1, 0)]
    assert m.seq_of_gidx == jm.seq_of_gidx and m.ts == jm.ts
    _assert_store_equals_jax(m.store, jm.store)
    assert torch.equal(m.keys_q.view(torch.int16), torch.from_numpy(
        np.asarray(jm.keys_q).view(np.int16).copy()))
    rec_j = np.asarray(_query_step(jm.store, q, jm.state, JCFG, jm.keys_q))
    rec_t = tdb.query_step(m.store, m.keys_q,
                           scan_desc_from_numpy(jax.device_get(q), "cpu"),
                           m.state, CFG).numpy()
    exact = [0, 1] + list(range(6, 18))
    np.testing.assert_array_equal(rec_t[exact], rec_j[exact])
    np.testing.assert_allclose(rec_t[2], rec_j[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rec_t[3:6], rec_j[3:6], rtol=1e-4, atol=2e-3)
    # all 18 rows are searchable, so the revisit scan 8 of either session
    # may win over scan 2's neighbourhood; the row maps back to a session
    assert rec_j[0] > 0.5 and m.session_of_gidx[int(rec_j[1])][1] in (2, 8)


def test_merge_refuses_mixed_layouts_and_nothing(jax_db):
    _, _, _, path = jax_db
    a = tdb.ContourDB.load(path, CFG, device="cpu")
    other = tconfig.PipelineConfig(
        cm=tconfig.ContourManagerConfig(max_points=16384, max_contours=24))
    b = tdb.ContourDB(other, capacity=4, device="cpu")
    b._init_store()
    b.n = 1
    b.seq_of_gidx = [0]
    assert b.store.cnt.shape[1:] != a.store.cnt.shape[1:]
    with pytest.raises(ValueError, match="layouts differ"):
        tdb.ContourDB.merge([a, b])
    with pytest.raises(ValueError, match="nothing to merge"):
        tdb.ContourDB.merge([tdb.ContourDB(CFG, 4, device="cpu")])
    with pytest.raises(ValueError, match="empty DB"):
        tdb.ContourDB(CFG, 4, device="cpu").save("unused.npz")


def test_scan_desc_from_numpy_defaults_to_the_card(jax_db):
    """Carrying a JAX descriptor into the port lands on the card unless the
    caller asks for another device, like every other entry point: where
    CUDA is missing the default raises instead of taking the CPU."""
    import inspect

    assert inspect.signature(scan_desc_from_numpy).parameters[
        "device"].default == "cuda"
    desc = jax_db[1][0]
    if torch.cuda.is_available():
        assert scan_desc_from_numpy(desc).keys.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            scan_desc_from_numpy(desc)
    assert scan_desc_from_numpy(desc, device="cpu").keys.device.type == "cpu"
