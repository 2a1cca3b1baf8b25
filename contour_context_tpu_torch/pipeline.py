"""End-to-end loop-closure pipeline on the fused per-scan step, in torch.

Replays a sequence (test/batch_bin_test.cpp:105-248): per scan, one
`ContourDB.step_async` (build -> query -> append -> window) on the DB's
device. Records stay on the device and are drained once at the end of the
stream; TP/FP/FN classification then happens in scan order and the outcome
file is written by the evaluator (eval/evaluator.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from contour_context_tpu_torch.config import PipelineConfig
from contour_context_tpu_torch.db import ContourDB
from contour_context_tpu_torch.eval.evaluator import ContLCDEvaluator
from contour_context_tpu_torch.utils.io import pad_points, read_kitti_bin
from contour_context_tpu_torch.utils.profiling import SequentialTimeProfiler
from contour_context_tpu_torch.utils.se2 import se2_mat


@dataclass
class LoopResult:
    q_seq: int
    cand_seq: Optional[int]
    correlation: float
    tfpn: int


class LoopClosurePipeline:
    """Streaming per-scan loop (the reference's BatchBinSpinner)."""

    def __init__(self, cfg: PipelineConfig, evaluator: ContLCDEvaluator,
                 capacity: int = 8192, device="cuda"):
        self.cfg = cfg
        self.evaluator = evaluator
        self.db = ContourDB(cfg, capacity, device=device)
        self.stp = SequentialTimeProfiler("cont2-torch batch")
        self.results: List[LoopResult] = []
        self._pending = []          # (LaserScanInfo, QueryHandle)

    def spin_once(self) -> bool:
        """Process the next scan; returns False when the sequence ends."""
        ev = self.evaluator
        if not ev.load_new_scan():
            return False
        info = ev.curr_scan
        self.stp.lap()
        self.stp.start()
        max_points = self.cfg.cm.max_points
        pts = pad_points(read_kitti_bin(info.fpath, max_points), max_points)
        handle = self.db.step_async(pts, info.seq, info.ts)
        self.stp.record("scan step (fused)")
        self._pending.append((info, handle))
        return True

    def drain(self) -> None:
        """Fetch every pending record and classify it, in scan order."""
        if not self._pending:
            return
        res = self.db.drain([h for _, h in self._pending])
        cm = self.cfg.cm
        for (info, _), r in zip(self._pending, res):
            if r is None:
                pred = self.evaluator.add_prediction(info.seq, 0.0)
                self.results.append(LoopResult(info.seq, None, 0.0,
                                               pred.tfpn))
                continue
            gidx, corr, T3 = r
            cand_seq = self.db.seq_of_gidx[gidx]
            pred = self.evaluator.add_prediction(
                info.seq, corr, cand_seq, se2_mat(T3[0], T3[1], T3[2]),
                cm.n_row, cm.n_col, cm.reso_row, cm.reso_col)
            self.results.append(LoopResult(info.seq, cand_seq, corr,
                                           pred.tfpn))
        self._pending = []

    def run(self, max_scans: Optional[int] = None) -> None:
        """Replay the sequence (or its first max_scans scans), then drain."""
        n = 0
        while (max_scans is None or n < max_scans) and self.spin_once():
            n += 1
        self.drain()

    def save_outcome(self, path: str) -> None:
        self.evaluator.save_prediction_results(path)


def run_batch(fpath_pose: str, fpath_laser: str, outcome_path: str,
              cfg: Optional[PipelineConfig] = None,
              max_scans: Optional[int] = None,
              device="cuda") -> LoopClosurePipeline:
    """The cont2_batch_bin_test entry point (batch_bin_test.cpp:261-307)."""
    cfg = cfg or PipelineConfig()
    ev = ContLCDEvaluator(fpath_pose, fpath_laser, cfg.correlation_thres)
    pipe = LoopClosurePipeline(cfg, ev, capacity=max(len(ev) + 8, 64),
                               device=device)
    pipe.run(max_scans=max_scans)
    pipe.save_outcome(outcome_path)
    pipe.stp.print_screen()
    return pipe
