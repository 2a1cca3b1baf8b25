"""The port's fused stream as a whole against JAX's, through the file pipeline.

The 9-scan revisit dataset of test_pipeline_e2e.py (scan 8 revisits scan 1,
6 s per scan) goes through JAX's run_batch(fused_step=True) and the port's
run_batch(device="cpu"): the outcome files match line by line (ids and
TP/FP/FN exactly, correlation to 1e-4), and so do the per-scan records in
both DBs' record rings (found, gidx and counters exactly, corr and T to rtol
and atol 1e-4, PARITY.md's record band). The port's CLI writes the same outcome
file, and a process that can import neither jax nor the JAX package
imports every port module and builds a descriptor.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from synth import make_world, render_scan, se3_from_xyt

from contour_context_tpu import config as jconfig
from contour_context_tpu_torch import config as tconfig

torch.set_num_threads(2)

# one config per package, from the same arguments
JCFG = jconfig.PipelineConfig(cm=jconfig.ContourManagerConfig(max_points=16384))
CFG = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(max_points=16384))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [(10.5, 0.8, 0.2)]
    pl, ll = [], []
    for i, p in enumerate(poses):
        pts = render_scan(world, p, seed=500 + i)
        arr = np.zeros((len(pts), 4), np.float32)
        arr[:, :3] = pts
        bp = str(d / ("%06d.bin" % i))
        arr.tofile(bp)
        T = se3_from_xyt(p)
        pl.append("%.6f %s" % (6.0 * i, " ".join(
            "%.6f" % v for v in T[:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (6.0 * i, i, bp))
    (d / "p.txt").write_text("\n".join(pl))
    (d / "l.txt").write_text("\n".join(ll))
    return str(d / "p.txt"), str(d / "l.txt"), d


@pytest.fixture(scope="module")
def runs(dataset):
    from contour_context_tpu.pipeline import run_batch as jax_run_batch
    from contour_context_tpu_torch.pipeline import run_batch

    f_pose, f_laser, d = dataset
    pj = jax_run_batch(f_pose, f_laser, str(d / "out_jax.txt"), cfg=JCFG,
                       fused_step=True)
    pt = run_batch(f_pose, f_laser, str(d / "out_torch.txt"), cfg=CFG,
                   device="cpu")
    return pj, pt


def _outcome(path):
    return [ln.split("\t") for ln in open(path).read().splitlines()]


def _assert_outcomes_match(a_path, b_path):
    """TP/FP/FN, ids and paths exact, correlation to 1e-4. The pose error
    columns are differences of T and the ground truth in metres, so they
    carry T's band as an absolute error: T (~15 cells here) to rtol 1e-4
    is up to 2e-3."""
    a, b = _outcome(a_path), _outcome(b_path)
    assert len(a) == len(b) == 9
    for la, lb in zip(a, b):
        assert la[0] == lb[0] and la[1] == lb[1] and la[6:] == lb[6:], (la, lb)
        np.testing.assert_allclose(float(lb[2]), float(la[2]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose([float(x) for x in lb[3:6]],
                                   [float(x) for x in la[3:6]],
                                   rtol=0, atol=2e-3)


def test_outcome_files_match_jax(dataset, runs):
    _, _, d = dataset
    _assert_outcomes_match(d / "out_jax.txt", d / "out_torch.txt")
    pj, pt = runs
    found = {r.q_seq: r for r in pt.results
             if r.correlation >= CFG.correlation_thres}
    assert set(found) == {8} and found[8].cand_seq == 1 and \
        found[8].tfpn == 0, pt.results


def test_records_match_jax(runs):
    pj, pt = runs
    rj = np.asarray(pj.db.recs_store)[:9]
    rt = pt.db.recs_store[:9].numpy()
    exact = [0, 1] + list(range(6, 18))
    np.testing.assert_array_equal(rt[:, exact], rj[:, exact])
    np.testing.assert_allclose(rt[:, 2], rj[:, 2], rtol=1e-4, atol=1e-4)
    # T is read only when found: otherwise it is the refinement of a
    # candidate that failed the screens, which nothing consumes
    found = rj[:, 0] > 0.5
    np.testing.assert_allclose(rt[found, 3:6], rj[found, 3:6], rtol=1e-4,
                               atol=1e-4)
    assert found.sum() == 1 and rj[:, 6].sum() > 0
    assert pt.db.counters == pj.db.counters


def test_cli_writes_the_same_outcome(dataset, runs):
    from contour_context_tpu_torch.__main__ import main

    f_pose, f_laser, d = dataset
    out = d / "out_cli.txt"
    main(["--pose", f_pose, "--laser", f_laser, "--outcome", str(out),
          "--device", "cpu"])
    assert out.read_text() == (d / "out_torch.txt").read_text()


def test_port_never_imports_jax():
    """A process where neither jax nor the JAX package can be imported
    imports every port module, builds its config from the port's copy and a
    descriptor, and ends with no module of either loaded."""
    mods = ["config", "types", "utils.io", "utils.se2", "utils.profiling",
            "eval.evaluator", "ops.kernels", "ops.cascade", "ops.candidate",
            "ops.gmm", "ops.descriptor", "db", "pipeline", "__main__",
            "profile_step", "kernel_times"]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['contour_context_tpu'] = None\n"
        "import importlib\n"
        "import numpy as np, torch\n"
        "import contour_context_tpu_torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module('contour_context_tpu_torch.' + m)\n"
        "from contour_context_tpu_torch.ops.descriptor import "
        "build_descriptor\n"
        "from contour_context_tpu_torch.config import ContourManagerConfig\n"
        "torch.set_num_threads(2)\n"
        "cfg = ContourManagerConfig(max_points=4096)\n"
        "rng = np.random.default_rng(0)\n"
        "pts = np.zeros((4096, 4), np.float32)\n"
        "pts[:, :3] = rng.uniform(-60, 60, (4096, 3))\n"
        "pts[:, 2] = rng.uniform(-2, 6, 4096)\n"
        "pts[:, 3] = 1\n"
        "d = build_descriptor(torch.from_numpy(pts), cfg)\n"
        "loaded = {m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None}\n"
        "assert not loaded & {'jax', 'contour_context_tpu'}, loaded\n"
        "print('ok', int(d.n_cont.sum()))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")
