"""The port's own copies of the JAX package's jax-free modules, held against
the originals so that a copy cannot drift.

- config: every default config class, field by field (names in order and
  `dataclasses.asdict` values), the module constants the port reads, the
  checks in `__post_init__`, and `load_pipeline_config_yaml` on a
  reference-format file;
- utils.io, utils.se2 and eval.evaluator: the same outputs on the same
  inputs (scan reading and padding, gt association, the SE(2) error and the
  outcome file).
"""

import dataclasses

import numpy as np
import pytest

from synth import make_world, render_scan, se3_from_xyt

from contour_context_tpu import config as jconfig
from contour_context_tpu.eval import evaluator as jev
from contour_context_tpu.utils import io as jio
from contour_context_tpu.utils import se2 as jse2
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch.eval import evaluator as tev
from contour_context_tpu_torch.utils import io as tio
from contour_context_tpu_torch.utils import se2 as tse2

CLASSES = ["ContourViewStatConfig", "ContourSimThresConfig",
           "ContourManagerConfig", "TreeBucketConfig", "GMMOptConfig",
           "ScoreConstellSim", "ScorePairwiseSim", "ScorePostProc",
           "CandidateScoreEnsemble", "ContourDBConfig", "PipelineConfig"]
CONSTANTS = ["MAX_CONTOURS_PER_LEVEL", "BITS_PER_LAYER", "DIST_BIN_LAYERS",
             "LAYER_AREA_WEIGHTS", "NUM_BIN_KEY_LAYER", "RET_KEY_DIM",
             "DEFAULT_THRES_LB", "DEFAULT_THRES_UB"]


@pytest.mark.parametrize("name", CLASSES)
def test_default_config_matches_jax(name):
    a, b = getattr(jconfig, name), getattr(tconfig, name)
    assert [f.name for f in dataclasses.fields(b)] == \
        [f.name for f in dataclasses.fields(a)]
    assert dataclasses.asdict(b()) == dataclasses.asdict(a())
    assert b.__dataclass_params__.frozen


@pytest.mark.parametrize("name", CONSTANTS)
def test_config_constant_matches_jax(name):
    a, b = getattr(jconfig, name), getattr(tconfig, name)
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    assert b == a


@pytest.mark.parametrize("cls,kwargs", [
    ("ContourManagerConfig", {"dist_firsts": 11}),
    ("ContourManagerConfig", {"piv_firsts": 11}),
    ("ContourManagerConfig", {"n_row": 200, "n_col": 200}),
    ("ContourDBConfig", {"q_levels": (0, 1)}),
])
def test_config_checks_match_jax(cls, kwargs):
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError):
            getattr(mod, cls)(**kwargs)


def test_yaml_config_matches_jax(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(
        "%YAML:1.0\n"
        "fpath_sens_gt_pose: \"/data/p.txt\"\n"
        "fpath_lidar_bins: \"/data/l.txt\"\n"
        "correlation_thres: 0.6\n"
        "ContourManagerConfig:\n"
        "  lv_grads_: [1.0, 2.5, 4.0, 5.5, 7.0, 8.5]\n"
        "  roi_radius_: 12.5\n"
        "  piv_firsts_: 5\n"
        "ContourDBConfig:\n"
        "  nnk_: 40\n"
        "  q_levels_: [1, 2]\n"
        "  ContourSimThresConfig:\n"
        "    ta_h_bar: 0.75\n"
        "  TreeBucketConfig:\n"
        "    min_elapse_: 12.0\n"
        "thres_lb_:\n"
        "  i_ovlp_sum: 2\n"
        "  correlation: 0.25\n")
    ca, ia = jconfig.load_pipeline_config_yaml(str(p))
    cb, ib = tconfig.load_pipeline_config_yaml(str(p))
    assert isinstance(cb, tconfig.PipelineConfig)
    assert dataclasses.asdict(cb) == dataclasses.asdict(ca) and ib == ia
    assert cb.cm.roi_radius == 12.5 and cb.db.q_levels == (1, 2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Six scans in the KITTI two-file format (scan 5 revisits scan 0, 6 s
    a scan), one scan list entry without a gt pose."""
    d = tmp_path_factory.mktemp("copies")
    world = make_world(3, n_structs=60, extent=100.0)
    poses = [(8.0 * i, 0.0, 0.1 * i) for i in range(5)] + [(0.7, 0.4, 0.2)]
    pl, ll = [], []
    for i, p in enumerate(poses):
        pts = render_scan(world, p, seed=40 + i)
        arr = np.zeros((len(pts), 4), np.float32)
        arr[:, :3] = pts
        arr[:, 3] = 0.5
        bp = str(d / ("%06d.bin" % i))
        arr.tofile(bp)
        T = se3_from_xyt(p)
        pl.append("%.6f %s" % (6.0 * i, " ".join(
            "%.6f" % v for v in T[:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (6.0 * i, i, bp))
    ll.append("%.6f %d %s" % (99.0, 6, d / "000000.bin"))
    (d / "p.txt").write_text("\n".join(pl))
    (d / "l.txt").write_text("\n".join(ll))
    return str(d / "p.txt"), str(d / "l.txt"), d


def test_io_matches_jax(dataset):
    f_pose, f_laser, d = dataset
    path = str(d / "000002.bin")
    for n in (None, 500):
        np.testing.assert_array_equal(tio.read_kitti_bin(path, n),
                                      jio.read_kitti_bin(path, n))
    pts = tio.read_kitti_bin(path)
    for m in (4096, len(pts) - 7):
        padded = tio.pad_points(pts, m)
        np.testing.assert_array_equal(padded, jio.pad_points(pts, m))
        np.testing.assert_array_equal(tio.quantize_points_q16(padded),
                                      jio.quantize_points_q16(padded))
    for a, b in zip(tio.load_gt_poses(f_pose), jio.load_gt_poses(f_pose)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tio.load_scan_list(f_laser), jio.load_scan_list(f_laser)):
        np.testing.assert_array_equal(a, b)
    ia = jio.associate_scans_with_gt(f_pose, f_laser)
    ib = tio.associate_scans_with_gt(f_pose, f_laser)
    assert len(ib) == len(ia) == 6 and ib[5].has_gt_positive_lc
    for a, b in zip(ia, ib):
        assert (b.seq, b.ts, b.fpath, b.has_gt_positive_lc) == \
            (a.seq, a.ts, a.fpath, a.has_gt_positive_lc)
        np.testing.assert_array_equal(b.sens_pose, a.sens_pose)


def test_se2_and_evaluator_match_jax(dataset):
    f_pose, f_laser, d = dataset
    rng = np.random.default_rng(5)
    for _ in range(4):
        x, y, th = rng.uniform(-20, 20), rng.uniform(-20, 20), rng.uniform(-3, 3)
        np.testing.assert_array_equal(tse2.se2_mat(x, y, th),
                                      jse2.se2_mat(x, y, th))
        g0, g1 = se3_from_xyt((x, y, th)), se3_from_xyt((y, x, -th))
        T = jse2.se2_mat(rng.uniform(-5, 5), rng.uniform(-5, 5), th)
        np.testing.assert_array_equal(
            tse2.eval_metric_est(T, g0, g1, 150, 150, 1.0),
            jse2.eval_metric_est(T, g0, g1, 150, 150, 1.0))
    outs = []
    for mod, name in ((jev, "jax"), (tev, "torch")):
        ev = mod.ContLCDEvaluator(f_pose, f_laser, 0.6)
        preds = [(0, 0.0, None), (1, 0.3, 0), (2, 0.7, 0), (5, 0.9, 0),
                 (4, 0.65, 1)]
        while ev.load_new_scan():
            pass
        for q, corr, cand in preds:
            T = None if cand is None else jse2.se2_mat(0.3, -0.2, 0.05)
            r = ev.add_prediction(q, corr, cand, T)
            outs.append((name, r.tfpn, r.est_err))
        out = d / f"outcome_{name}.txt"
        ev.save_prediction_results(str(out))
    assert [o[1:] for o in outs[:5]] == [o[1:] for o in outs[5:]]
    assert (d / "outcome_torch.txt").read_text() == \
        (d / "outcome_jax.txt").read_text()
    assert outs[3][1] == jev.TP == tev.TP
