"""The plain reference against the port's CPU path at a tiny size, and the
import guard: no JAX or JAX package in a run, nothing of the port in the
reference."""

import os
import subprocess
import sys

import pytest
import torch

from harness import guard

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_guard_compares_top_level_names_whole():
    mods = {"contour_context_tpu_torch": 1, "contour_context_tpu_torch.db": 1,
            "jax_like": 1, "numpy": 1}
    assert guard.loaded(guard.FORBIDDEN, mods) == []
    mods.update({"contour_context_tpu.ops.descriptor": 1, "jaxlib": 1,
                 "jax": 1, "flax.linen": 1})
    assert guard.loaded(guard.FORBIDDEN, mods) == [
        "contour_context_tpu.ops.descriptor", "flax.linen", "jax", "jaxlib"]


def test_guard_refuses_a_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(RuntimeError, match="jax"):
        guard.check(guard.FORBIDDEN, "the run")


def test_the_reference_loads_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import plainref.query, plainref.descriptor, harness.check\n"
            "from harness import guard\n"
            "print(guard.loaded((guard.PROGRAM,) + guard.FORBIDDEN))\n"
            % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd="/")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax(tmp_path):
    """run.py's own imports, with the port, in a fresh process."""
    code = ("import sys; sys.argv = ['run.py']; sys.path[:0] = [%r]\n"
            "import run\n"
            "import contour_context_tpu_torch.db, "
            "contour_context_tpu_torch.pipeline\n"
            "from harness import guard\n"
            "print(guard.loaded(guard.FORBIDDEN))\n" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(BENCH))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_build_and_query_equal_the_ports_on_the_cpu(spec, tiny):
    """The descriptors of a block, and a query against a small store, bit
    for bit."""
    from contour_context_tpu_torch.config import PipelineConfig
    from contour_context_tpu_torch.db import ContourDB
    from contour_context_tpu_torch.ops.descriptor import build_descriptors
    from harness import check, drive
    from harness.spec import dataclass_from_dict, merge
    from plainref.descriptor import build_descriptors as ref_build
    from plainref.query import PlainStore
    cell = "k08-revisit-10hz"
    wl = spec.workload(cell)
    cfg_file = merge(spec.config(wl["config"]), tiny[cell]["config"])
    traffic = merge(spec.traffic(wl["traffic"]), tiny[cell]["traffic"])
    p = drive.plan(cfg_file, traffic, 0.5, 11, "cpu")
    cfg = dataclass_from_dict(PipelineConfig(), cfg_file["pipeline"])
    rcfg = check.ref_config(cfg_file)
    pts = p["hist"].clouds(0, 16)
    a = build_descriptors(pts, cfg.cm, cfg.gmm)
    b = ref_build(pts, rcfg.cm, rcfg.gmm)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    db = ContourDB(cfg, capacity=64, device="cpu")
    st = PlainStore(rcfg, 64, "cpu")
    for blk in range(2):
        pts = p["hist"].clouds(16 * blk, 16 * blk + 16)
        ts = p["ts_hist"][16 * blk:16 * blk + 16]
        db.block_chain_pts_async(pts[None], list(range(16)), [ts.tolist()])
        st.block_append(ref_build(pts, rcfg.cm, rcfg.gmm), ts)
    q = p["post"].clouds(0, len(p["post"]))[0]
    for t in (40.0, 50.0):                  # pushes that open the window
        db.push_and_balance(t)
        st.push(t)
    rec = db.query_async(ScanDescOf(db, q)).rec
    ref = st.query(ref_build(q[None], rcfg.cm, rcfg.gmm))
    assert torch.equal(rec, ref)
    assert int(ref[0]) == 1                  # the revisit is found
    parts = check.snapshot_parts(check.snapshot(db, 32, db.n),
                                 check.snapshot(st, 32))
    assert not any(parts.values()), parts


def ScanDescOf(db, points):
    """The port's one-scan descriptor of `points`."""
    return db._build_one(points)


@pytest.mark.parametrize("cell", ["k08-revisit-10hz", "kaist-serve-b16"])
def test_a_whole_run_on_the_cpu_agrees_to_the_bit(spec, tiny, cell):
    import run
    res = run.run_cell(spec, cell, 2 ** 31 + 99, 0.3, False, "cpu",
                       tiny[cell])
    assert res["correct"]
    assert {k: v["value"] for k, v in res["checks"].items()} == {
        "mismatch": 0, "corr_gap": 0.0, "pose_gap": 0.0, "desc_gap": 0.0}
    assert list(res)[-1] == "checks"
    assert res["notes"]["compared"] >= 3
