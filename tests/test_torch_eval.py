"""The port's scoring and sweep harness against the JAX package's
(mirrors tests/test_pr_mpe.py:32-44 and tests/test_sweep.py:37-90).

- `eval.pr_mpe`: a synthetic 400-pose drive with a revisiting second lap
  and a synthetic outcome file (TP, FP, FN and TN lines, some scans absent)
  are scored by both packages: every field of the result (the PR curve
  point by point, max-F1 and its threshold, recall at P = 1, the TP count
  and pose errors) is equal, as are the gt labels, the parsed lines and the
  report `main` prints; `plot_pr_curves` needs matplotlib and skips without
  it.
- `eval.sweep`: the threshold cfg parser, both grid generators (the same
  files byte for byte), and one `run_sweep_id` over a 7-scan dataset (the
  planted revisit found) with its resume and missing-config codes, the
  brief file equal to JAX's and the outcome file held to it (TP/FP/FN, ids
  and paths exactly, correlation to rtol and atol 1e-4, pose errors to atol
  2e-3).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from synth import make_world, render_scan, se3_from_xyt

from contour_context_tpu import config as jconfig
from contour_context_tpu.eval import pr_mpe as jpr
from contour_context_tpu.eval import sweep as jsw
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch.eval import pr_mpe as tpr
from contour_context_tpu_torch.eval import sweep as tsw

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A gt pose file (two laps of a 200-pose loop, the second 1.5 m
    aside) and an outcome file over it."""
    d = tmp_path_factory.mktemp("prmpe")
    rng = np.random.default_rng(7)
    n = 400
    ang = 2 * np.pi * (np.arange(n) % 200) / 200
    rad = 60.0 + 1.5 * (np.arange(n) >= 200)
    rows = []
    for i in range(n):
        T = se3_from_xyt((rad[i] * np.cos(ang[i]), rad[i] * np.sin(ang[i]),
                          ang[i]))
        rows.append("%.6f %s" % (0.1 * i, " ".join(
            "%.6f" % v for v in T[:3, :4].reshape(-1))))
    (d / "gt.txt").write_text("\n".join(rows))
    lines = []
    for i in range(n):
        if rng.random() < 0.05:
            continue                       # a scan without an outcome line
        corr = float(rng.uniform(0.0, 1.0))
        if i >= 200 and rng.random() < 0.8:
            best = i - 200 + int(rng.integers(-2, 3))        # near revisit
        elif rng.random() < 0.5:
            best = int(rng.integers(0, max(i, 1)))           # anywhere
        else:
            best = -1
        pair = "%d-x" % i if best < 0 else "%d-%d" % (i, best)
        err = rng.normal(0, 0.2, 3)
        lines.append("%d\t%s\t%g\t%g\t%g\t%g\ta.bin\tb.bin" % (
            int(rng.integers(0, 4)), pair, corr, *err))
    (d / "outcome.txt").write_text("\n".join(lines) + "\n")
    return str(d / "gt.txt"), str(d / "outcome.txt")


@pytest.mark.parametrize("thres_dist,excl", [(5.0, 150), (3.0, 2)])
def test_score_outcome_matches_jax(scored, thres_dist, excl):
    gt, oc = scored
    a = jpr.score_outcome(gt, oc, thres_dist=thres_dist, excl_frames=excl)
    b = tpr.score_outcome(gt, oc, thres_dist=thres_dist, excl_frames=excl)
    np.testing.assert_array_equal(b.pr_points, a.pr_points)
    for f in dataclasses.fields(a):
        if f.name != "pr_points":
            assert getattr(b, f.name) == getattr(a, f.name), f.name
    assert a.tp_count > 10 and 0 < a.max_f1 < 1


def test_labels_and_parsing_match_jax(scored):
    gt, oc = scored
    pj, pt = jpr.load_gt_sens_poses(gt), tpr.load_gt_sens_poses(gt)
    np.testing.assert_array_equal(pt, pj)
    lab = tpr.gt_positive_labels(pt)
    np.testing.assert_array_equal(lab, jpr.gt_positive_labels(pj))
    assert lab[:150].sum() == 0 and lab[250:].all()
    assert [dataclasses.astuple(x) for x in tpr.parse_outcome_file(oc)] == \
        [dataclasses.astuple(x) for x in jpr.parse_outcome_file(oc)]


def test_main_prints_what_jax_prints(scored, capsys):
    gt, oc = scored
    outs = []
    for mod in (jpr, tpr):
        mod.main([gt, oc, oc, "--excl-frames", "2"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Max F1 score" in outs[1]


def test_plot_pr_curves(scored, tmp_path):
    pytest.importorskip("matplotlib")
    r = tpr.score_outcome(*scored)
    out = str(tmp_path / "pr.png")
    tpr.plot_pr_curves([r, r], ["a", "b"], out)
    assert os.path.getsize(out) > 1000


def test_load_check_thres_matches_jax(tmp_path):
    p = tmp_path / "t.cfg"
    p.write_text("# a comment line\n"
                 "i_ovlp_sum 3 6\ni_ovlp_max_one 2 5\ni_in_ang_rng 3 6\n"
                 "i_indiv_sim 3 6\ni_orie_sim 4 6\nbogus 1 2\n"
                 "correlation 0.3 0.75\narea_perc 0.03 0.15\n")
    a = jsw.load_check_thres(str(p))
    b = tsw.load_check_thres(str(p), tconfig.CandidateScoreEnsemble(),
                             tconfig.CandidateScoreEnsemble())
    assert [dataclasses.asdict(x) for x in b] == \
        [dataclasses.asdict(x) for x in a]
    assert b[0].sim_constell.i_ovlp_max_one == 2
    assert b[1].sim_post.neg_est_dist == \
        tconfig.CandidateScoreEnsemble().sim_post.neg_est_dist


def _tree(root):
    return {os.path.relpath(os.path.join(dp, f), root):
            open(os.path.join(dp, f)).read()
            for dp, _, fs in os.walk(root) for f in fs}


def test_grid_generators_match_jax(tmp_path):
    for mod, name in ((jsw, "jax"), (tsw, "torch")):
        assert mod.gen_thres_dirs(str(tmp_path / name / "grid")) == 108
        with pytest.raises(FileExistsError):
            mod.gen_thres_dirs(str(tmp_path / name / "grid"))
        assert mod.gen_thres_dirs_manual(
            str(tmp_path / name / "manual"),
            [[3, 0.1, 0.01, -10], [7, 0.75, 0.15, -4]], beg_idx=5) == 7
    a, b = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert len(a) == 110 and b == a
    tsw.main(["gen", "--root", str(tmp_path / "cli"), "--beg-idx", "3"])
    assert len(_tree(tmp_path / "cli")) == 108


@pytest.fixture(scope="module")
def sweep_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep")
    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(6)] + [(10.5, 0.8, 0.2)]
    pl, ll = [], []
    for i, p in enumerate(poses):
        pts = render_scan(world, p, seed=500 + i)
        arr = np.zeros((len(pts), 4), np.float32)
        arr[:, :3] = pts
        bp = str(d / ("%06d.bin" % i))
        arr.tofile(bp)
        pl.append("%.6f %s" % (6.0 * i, " ".join(
            "%.6f" % v for v in se3_from_xyt(p)[:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (6.0 * i, i, bp))
    (d / "pose.txt").write_text("\n".join(pl))
    (d / "laser.txt").write_text("\n".join(ll))
    return str(d / "pose.txt"), str(d / "laser.txt"), d


def test_run_sweep_id_matches_jax(sweep_data):
    f_pose, f_laser, d = sweep_data
    for mod, name, base, kw in (
            (jsw, "jax", jconfig.PipelineConfig(
                cm=jconfig.ContourManagerConfig(max_points=16384)), {}),
            (tsw, "torch", tconfig.PipelineConfig(
                cm=tconfig.ContourManagerConfig(max_points=16384)),
             {"device": "cpu"})):
        root = str(d / name)
        mod.gen_thres_dirs_manual(root, [[3, 0.1, 0.01, -10.01]])
        assert mod.run_sweep_id(root, 0, f_pose, f_laser, "synth",
                                cfg_base=base, **kw) == 0
        # resume: a brief exists -> 1; a missing config -> 2
        assert mod.run_sweep_id(root, 0, f_pose, f_laser, "synth",
                                cfg_base=base, **kw) == 1
        assert mod.run_sweep_id(root, 7, f_pose, f_laser, "synth",
                                cfg_base=base, **kw) == 2
    brief = [(d / n / "000" / "brief-synth.txt").read_text()
             for n in ("jax", "torch")]
    assert brief[1] == brief[0] == "1\t0\t0"     # the planted revisit found
    a, b = [[ln.split("\t") for ln in (d / n / "000" / "outcome-synth.txt")
             .read_text().splitlines()] for n in ("jax", "torch")]
    assert len(a) == len(b) == 7
    for la, lb in zip(a, b):
        assert la[0] == lb[0] and la[1] == lb[1] and la[6:] == lb[6:]
        np.testing.assert_allclose(float(lb[2]), float(la[2]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose([float(x) for x in lb[3:6]],
                                   [float(x) for x in la[3:6]], rtol=0,
                                   atol=2e-3)
