"""What the port's pipeline tests share (tests/test_torch_pipeline.py,
tests/test_torch_pipeline_q16.py; this file holds no test): the 10-scan
KITTI-format dataset (scans 8 and 9 revisit scans 1 and 3, 6 s a scan,
16384-point clouds) and the outcome-file comparison with the JAX package's.
"""

import numpy as np
import pytest

from synth import make_world, render_scan, se3_from_xyt

from contour_context_tpu import config as jconfig
from contour_context_tpu_torch import config as tconfig

JCFG = jconfig.PipelineConfig(cm=jconfig.ContourManagerConfig(max_points=16384))
CFG = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(max_points=16384))
POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
    (10.5, 0.8, 0.2), (30.0, -1.0, -0.15)]
N = len(POSES)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    world = make_world(11, n_structs=220, extent=160.0)
    pl, ll = [], []
    for i, p in enumerate(POSES):
        pts = render_scan(world, p, seed=500 + i)
        arr = np.zeros((len(pts), 4), np.float32)
        arr[:, :3] = pts
        bp = str(d / ("%06d.bin" % i))
        arr.tofile(bp)
        pl.append("%.6f %s" % (6.0 * i, " ".join(
            "%.6f" % v for v in se3_from_xyt(p)[:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (6.0 * i, i, bp))
    (d / "p.txt").write_text("\n".join(pl))
    (d / "l.txt").write_text("\n".join(ll))
    return str(d / "p.txt"), str(d / "l.txt"), d


def evaluator(dataset):
    from contour_context_tpu_torch.eval.evaluator import ContLCDEvaluator

    return ContLCDEvaluator(dataset[0], dataset[1], CFG.correlation_thres)


def outcome(path):
    return [ln.split("\t") for ln in open(path).read().splitlines()]


def assert_outcomes_match(got_path, want_path):
    a, b = outcome(want_path), outcome(got_path)
    assert len(a) == len(b) == N
    for la, lb in zip(a, b):
        assert la[0] == lb[0] and la[1] == lb[1] and la[6:] == lb[6:], (la, lb)
        np.testing.assert_allclose(float(lb[2]), float(la[2]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose([float(x) for x in lb[3:6]],
                                   [float(x) for x in la[3:6]], rtol=0,
                                   atol=2e-3)
    # the revisits close on the right scans (TP lines), nothing else does,
    # and the pose is good (tests/test_pipeline_e2e.py's 1 m and 0.1 rad)
    tp = {ln[1]: ln for ln in b if ln[0] == "0"}
    assert set(tp) == {"8-1", "9-3"}, b
    for ln in tp.values():
        assert np.hypot(float(ln[3]), float(ln[4])) < 1.0
        assert abs(float(ln[5])) < 0.1
    assert all(ln[0] in ("0", "2") for ln in b)          # TP or TN


