"""Threshold-sweep harness: config grids, per-run runner, resume logic.

The port's own copy of `contour_context_tpu/eval/sweep.py`; each run replays
the sequence on `--device` (default cuda) through the port's `run_batch`.

Reproduces the reference's parameter-sweep tooling:
- the plain-text check-threshold `.cfg` format and its parser
  (ContLCDEvaluator::loadCheckThres, evaluator.cpp:7-64;
  config/score_thres_kitti_bag_play.cfg);
- the config-grid generators (scripts/gen_thres_dirs.py) writing
  `<root>/NNN/batch_pr.cfg` directories;
- the per-runid sweep runner (test/batch_para_bin_test.cpp:189-287): skip if
  the config is missing, skip if `brief-<seq>.txt` already exists (resume),
  replay the sequence, write `outcome-<seq>.txt` + `brief-<seq>.txt`
  (`tp\\tfn\\tfp`).

CLI:
  python -m contour_context_tpu_torch.eval.sweep gen --root results/batch_pr_tests
  python -m contour_context_tpu_torch.eval.sweep run --root ... --runid 3 \\
      --pose ts-sens_pose-kitti08.txt --laser ts-lidar_bins-kitti08.txt --seq kitti08 \\
      [--device cuda]
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

from contour_context_tpu_torch.config import (
    CandidateScoreEnsemble,
    PipelineConfig,
    ScoreConstellSim,
    ScorePairwiseSim,
    ScorePostProc,
)

CONFIG_TEMPLATE = """
i_ovlp_sum          %d       %d
i_ovlp_max_one      %d       %d
i_in_ang_rng        %d       %d

i_indiv_sim         %d       %d
i_orie_sim          %d       %d

correlation         %f    %f
area_perc           %f    %f
neg_est_dist        %f    %f
"""


def load_check_thres(fpath: str,
                     lb: Optional[CandidateScoreEnsemble] = None,
                     ub: Optional[CandidateScoreEnsemble] = None
                     ) -> Tuple[CandidateScoreEnsemble, CandidateScoreEnsemble]:
    """Parse the check-threshold cfg (loadCheckThres, evaluator.cpp:7-64).

    Each line: `<name> <lb> <ub>`; `#` lines are comments; unknown names are
    ignored; missing names keep the passed-in (or default) values.
    """
    lb = lb or CandidateScoreEnsemble()
    ub = ub or CandidateScoreEnsemble()
    vals = {}
    with open(fpath) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3 or parts[0].startswith("#"):
                continue
            try:
                vals[parts[0]] = (float(parts[1]), float(parts[2]))
            except ValueError:
                continue

    def g(name, cur_lb, cur_ub, cast):
        if name in vals:
            return cast(vals[name][0]), cast(vals[name][1])
        return cur_lb, cur_ub

    cs_lb, cs_ub = lb.sim_constell, ub.sim_constell
    sp_lb, sp_ub = lb.sim_pair, ub.sim_pair
    po_lb, po_ub = lb.sim_post, ub.sim_post
    o_sum = g("i_ovlp_sum", cs_lb.i_ovlp_sum, cs_ub.i_ovlp_sum, int)
    o_max = g("i_ovlp_max_one", cs_lb.i_ovlp_max_one, cs_ub.i_ovlp_max_one, int)
    o_ang = g("i_in_ang_rng", cs_lb.i_in_ang_rng, cs_ub.i_in_ang_rng, int)
    p_ind = g("i_indiv_sim", sp_lb.i_indiv_sim, sp_ub.i_indiv_sim, int)
    p_ori = g("i_orie_sim", sp_lb.i_orie_sim, sp_ub.i_orie_sim, int)
    c_cor = g("correlation", po_lb.correlation, po_ub.correlation, float)
    c_are = g("area_perc", po_lb.area_perc, po_ub.area_perc, float)
    c_dis = g("neg_est_dist", po_lb.neg_est_dist, po_ub.neg_est_dist, float)

    mk = lambda i: CandidateScoreEnsemble(
        sim_constell=ScoreConstellSim(o_sum[i], o_max[i], o_ang[i]),
        sim_pair=ScorePairwiseSim(p_ind[i], p_ori[i]),
        sim_post=ScorePostProc(c_cor[i], c_are[i], c_dis[i]))
    return mk(0), mk(1)


def _write_cfg(root: str, idx: int, constell: int, corr: float, area: float,
               ndist: float, overwrite: bool = False) -> str:
    cfg = CONFIG_TEMPLATE % (
        constell, constell + 3, constell, constell + 3, constell, constell + 3,
        constell, constell + 3, constell, constell + 3,
        corr, corr + 0.15, area, area + 0.1, ndist, ndist + 0.01)
    cfg_dir = os.path.join(root, "%03d" % idx)
    os.makedirs(cfg_dir, exist_ok=True)
    path = os.path.join(cfg_dir, "batch_pr.cfg")
    if os.path.isfile(path) and not overwrite:
        raise FileExistsError(path)
    with open(path, "w") as f:
        f.write(cfg)
    return path


def gen_thres_dirs(root: str, beg_idx: int = 0) -> int:
    """The staircase grid of gen_thres_dirs.py create_config_folders."""
    cfg_constell = [3, 4, 5, 6]
    cfg_corr = [0.3, 0.4, 0.5, 0.55, 0.6, 0.65, 0.7]
    cfg_area = [0.01, 0.03, 0.05, 0.10]
    cfg_ndist = [-10.01, -8.01, -6.01, -4.01, -3.01]
    idx = beg_idx
    rng = [3, 3, 3]
    divs = len(cfg_constell)
    for i in range(divs):
        beg_corr = min(int(len(cfg_corr) / divs * i), len(cfg_corr) - rng[0])
        for i1 in range(beg_corr, beg_corr + rng[0]):
            beg_area = min(int(len(cfg_area) / divs * i), len(cfg_area) - rng[1])
            for i2 in range(beg_area, beg_area + rng[1]):
                beg_nd = min(int(len(cfg_ndist) / divs * i), len(cfg_ndist) - rng[2])
                for i3 in range(beg_nd, beg_nd + rng[2]):
                    _write_cfg(root, idx, cfg_constell[i], cfg_corr[i1],
                               cfg_area[i2], cfg_ndist[i3])
                    idx += 1
    return idx


def gen_thres_dirs_manual(root: str, threses: Sequence[Sequence[float]],
                          beg_idx: int = 0) -> int:
    """The manual list variant (gen_thres_dirs.py create_config_folders_manual)."""
    idx = beg_idx
    for t in threses:
        _write_cfg(root, idx, int(t[0]), t[1], t[2], t[3])
        idx += 1
    return idx


def run_sweep_id(root: str, runid: int, fpath_pose: str, fpath_laser: str,
                 seq: str, cfg_base: Optional[PipelineConfig] = None,
                 max_scans: Optional[int] = None, *, device="cuda") -> int:
    """One sweep run (a_thread, batch_para_bin_test.cpp:189-258).

    Returns 0 = ran, 1 = brief exists (resume skip), 2 = config missing.
    """
    cfg_dir = os.path.join(root, "%03d" % runid)
    f_cfg = os.path.join(cfg_dir, "batch_pr.cfg")
    f_outcome = os.path.join(cfg_dir, "outcome-%s.txt" % seq)
    f_brief = os.path.join(cfg_dir, "brief-%s.txt" % seq)
    if not os.path.isfile(f_cfg):
        print("%s does not exist, skipping" % f_cfg)
        return 2
    if os.path.isfile(f_brief):
        print("%s exists, skipping" % f_brief)
        return 1

    base = cfg_base or PipelineConfig()
    lb, ub = load_check_thres(f_cfg, base.thres_lb, base.thres_ub)
    # the reference sweep classifies TFPN at the fixed evaluator threshold
    # 0.76543 (batch_para_bin_test.cpp:34), NOT the yaml correlation_thres —
    # brief files are only grid-comparable at the same fixed threshold
    cfg = dataclasses.replace(base, thres_lb=lb, thres_ub=ub,
                              correlation_thres=0.76543)

    from contour_context_tpu_torch.pipeline import run_batch
    pipe = run_batch(fpath_pose, fpath_laser, f_outcome, cfg=cfg,
                     max_scans=max_scans, device=device)
    tp = sum(1 for r in pipe.results if r.tfpn == 0)
    fp = sum(1 for r in pipe.results if r.tfpn == 1)
    fn = sum(1 for r in pipe.results if r.tfpn == 3)
    with open(f_brief, "w") as f:
        f.write("%d\t%d\t%d" % (tp, fn, fp))
    return 0


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gen", help="generate the threshold config grid")
    g.add_argument("--root", required=True)
    g.add_argument("--beg-idx", type=int, default=0)
    r = sub.add_parser("run", help="run one sweep id (resumable)")
    r.add_argument("--root", required=True)
    r.add_argument("--runid", type=int, required=True)
    r.add_argument("--pose", required=True)
    r.add_argument("--laser", required=True)
    r.add_argument("--seq", default="kitti00")
    r.add_argument("--max-scans", type=int, default=None)
    r.add_argument("--device", default="cuda",
                   help="torch device of the replay (default cuda)")
    args = ap.parse_args(argv)

    if args.cmd == "gen":
        n = gen_thres_dirs(args.root, args.beg_idx)
        print("wrote configs up to %03d" % (n - 1))
    else:
        rc = run_sweep_id(args.root, args.runid, args.pose, args.laser,
                          args.seq, max_scans=args.max_scans,
                          device=args.device)
        raise SystemExit(rc)


if __name__ == "__main__":
    main()
