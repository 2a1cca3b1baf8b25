"""Online evaluation harness: gt association, TFPN classification, outcome files.

The port's own copy of `contour_context_tpu/eval/evaluator.py`.

Parity with ContLCDEvaluator (evaluator.h:53-440):
- scan<->gt association within 10 ms, gt-positive marking (>=15 s older, <5 m);
- per-prediction TP/FP/TN/FN at a fixed similarity threshold with SE(2) error;
- outcome file writer whose lines are byte-compatible with what
  scripts/pr_mpe.py consumes: `tfpn  tgt-src  corr  dx dy dth  path_tgt path_src`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from contour_context_tpu_torch.utils.io import LaserScanInfo, associate_scans_with_gt
from contour_context_tpu_torch.utils.se2 import eval_metric_est

TP, FP, TN, FN = 0, 1, 2, 3  # PredictionOutcome::Res (evaluator.h:36-38)


@dataclass
class PredictionOutcome:
    id_src: int = -1
    id_tgt: int = -1
    tfpn: int = TN
    est_err: tuple = (0.0, 0.0, 0.0)
    correlation: float = 0.0


class SimpleRMSE:
    """Running mean/RMSE of error-vector norms (evaluator.h:12-33)."""

    def __init__(self):
        self.sum_sqs = 0.0
        self.sum_abs = 0.0
        self.cnt = 0

    def add(self, err) -> None:
        self.cnt += 1
        tmp = float(sum(e * e for e in err))
        self.sum_sqs += tmp
        self.sum_abs += math.sqrt(tmp)

    def rmse(self) -> float:
        return math.sqrt(self.sum_sqs / self.cnt) if self.cnt else -1.0

    def mean(self) -> float:
        return self.sum_abs / self.cnt if self.cnt else -1.0


def _shorten(path: str, max_len: int = 32) -> str:
    """Last max_len chars of a path (savePredictionResults, evaluator.h:404-408)."""
    return path[-max_len:] if len(path) > max_len else path


class ContLCDEvaluator:
    """Sequence cursor + TFPN recorder (evaluator.h:53-440)."""

    def __init__(self, fpath_pose: str, fpath_laser: str, sim_thres: float,
                 ts_diff_tol: float = 10e-3, min_time_excl: float = 15.0):
        self.sim_thres = sim_thres
        self.laser_info: List[LaserScanInfo] = associate_scans_with_gt(
            fpath_pose, fpath_laser, ts_diff_tol, min_time_excl)
        self._seq_to_addr = {s.seq: i for i, s in enumerate(self.laser_info)}
        self.p_lidar_curr = -1
        self.tp_trans = SimpleRMSE()
        self.tp_rot = SimpleRMSE()
        self.all_trans = SimpleRMSE()
        self.all_rot = SimpleRMSE()
        self.pred_records: List[PredictionOutcome] = []

    def __len__(self) -> int:
        return len(self.laser_info)

    def load_new_scan(self) -> bool:
        self.p_lidar_curr += 1
        return self.p_lidar_curr < len(self.laser_info)

    @property
    def curr_scan(self) -> LaserScanInfo:
        return self.laser_info[self.p_lidar_curr]

    def peek_next(self) -> Optional[LaserScanInfo]:
        """The scan after the cursor, if any (for loader prefetching)."""
        i = self.p_lidar_curr + 1
        return self.laser_info[i] if i < len(self.laser_info) else None

    def add_prediction(self, q_seq: int, est_corr: float,
                       cand_seq: Optional[int] = None,
                       T_est_delta_2d: Optional[np.ndarray] = None,
                       n_row: int = 150, n_col: int = 150, reso: float = 1.0,
                       reso_col: Optional[float] = None
                       ) -> PredictionOutcome:
        """Classify one prediction (addPrediction, evaluator.h:305-366).

        q_seq: the query scan's assigned seq id; cand_seq: predicted match (or
        None for a negative prediction); T_est_delta_2d: 3x3 SE(2) BEV delta.
        """
        addr_tgt = self._seq_to_addr[q_seq]
        info_tgt = self.laser_info[addr_tgt]
        res = PredictionOutcome(id_tgt=q_seq, correlation=est_corr)

        if cand_seq is not None:
            addr_src = self._seq_to_addr[cand_seq]
            info_src = self.laser_info[addr_src]
            res.id_src = cand_seq

            T_err = eval_metric_est(T_est_delta_2d, info_src.sens_pose, info_tgt.sens_pose,
                                    n_row, n_col, reso, reso_col)
            err_vec = (float(T_err[0, 2]), float(T_err[1, 2]),
                       math.atan2(T_err[1, 0], T_err[0, 0]))
            res.est_err = err_vec
            gt_trans_norm3d = float(np.linalg.norm(
                info_src.sens_pose[:3, 3] - info_tgt.sens_pose[:3, 3]))

            if est_corr >= self.sim_thres:
                if info_tgt.has_gt_positive_lc and gt_trans_norm3d < 5.0:
                    res.tfpn = TP
                    self.tp_trans.add(err_vec[:2])
                    self.tp_rot.add(err_vec[2:])
                else:
                    res.tfpn = FP
            else:
                res.tfpn = FN if info_tgt.has_gt_positive_lc else TN
            self.all_trans.add(err_vec[:2])
            self.all_rot.add(err_vec[2:])
        else:
            res.tfpn = FN if info_tgt.has_gt_positive_lc else TN

        self.pred_records.append(res)
        return res

    def save_prediction_results(self, sav_path: str) -> None:
        """Write the outcome file (savePredictionResults, evaluator.h:370-425).

        Numbers are rendered with '%g' (6 significant digits), matching C++
        default stream precision.
        """
        with open(sav_path, "w") as f:
            for rec in self.pred_records:
                addr_tgt = self._seq_to_addr[rec.id_tgt]
                path_tgt = _shorten(self.laser_info[addr_tgt].fpath)
                if rec.id_src < 0:
                    pair = "%d-x" % rec.id_tgt
                    path_src = "x"
                else:
                    pair = "%d-%d" % (rec.id_tgt, rec.id_src)
                    path_src = _shorten(self.laser_info[self._seq_to_addr[rec.id_src]].fpath)
                f.write("%d\t%s\t%g\t%g\t%g\t%g\t%s\t%s\n" % (
                    rec.tfpn, pair, rec.correlation,
                    rec.est_err[0], rec.est_err[1], rec.est_err[2], path_tgt, path_src))

    def save_reindexed_dataset(self, sav_pose: str, sav_laser: str,
                               hz: float = 10.0) -> int:
        """MulRan stationary-time reindexing (the reference's commented
        "save gt pose and bin path" block, evaluator.h:201-232 + README
        "Additional steps"): rewrite the ASSOCIATED scan list with uniform
        i/hz timestamps. MulRan vehicles idle at red lights, so wall-clock
        gaps make the >=15 s exclusion window inconsistent in frame terms;
        after reindexing the window is a fixed frame gap. Returns the scan
        count; feed the two new files back as fpath_sens_gt_pose /
        fpath_lidar_bins."""
        # %.6f (not the reference dump's %.2f) so high-rate reindexing never
        # collides adjacent timestamps under the 10 ms association tolerance
        with open(sav_laser, "w") as f4, open(sav_pose, "w") as f5:
            for i, info in enumerate(self.laser_info):
                f4.write("%.6f %d %s\n" % (i / hz, i, info.fpath))
                f5.write("%.6f %s\n" % (i / hz, " ".join(
                    "%.6f" % info.sens_pose[j // 4, j % 4] for j in range(12))))
        return len(self.laser_info)
