"""End-to-end loop-closure pipeline, in torch.

Replays a sequence (test/batch_bin_test.cpp:105-248) on the DB's device, in
one of four ways that write the same outcome file:
- `run` (the default, as in the JAX package and both CLIs): per scan through
  the unfused API (`build_descriptor`, `query_async`, `add_scan`,
  `push_and_balance`), with a per-stage timing report;
- `run` with `fused_step=True`: the same order in one `ContourDB.step_async`
  a scan (build -> query -> append -> window), which also writes the DB's
  record ring;
- `run_blocked`: `block` scans at a time through `process_block_async` (one
  batched key search a block; needs regularly spaced timestamps);
- `run_chained`: `chain` scans staged at a time, then stepped one by one
  (exact at any timestamp spacing).
Records stay on the device and are drained once at the end of the stream;
TP/FP/FN classification then happens in scan order and the outcome file is
written by the evaluator (eval/evaluator.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from contour_context_tpu_torch.config import PipelineConfig
from contour_context_tpu_torch.db import (
    ContourDB,
    drain_block_handles,
    drain_handles,
)
from contour_context_tpu_torch.eval.evaluator import ContLCDEvaluator
from contour_context_tpu_torch.ops.descriptor import (
    build_descriptor,
    build_descriptors,
)
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
                 capacity: int = 8192, device="cuda",
                 fused_step: bool = False):
        self.cfg = cfg
        self.evaluator = evaluator
        self.db = ContourDB(cfg, capacity, device=device)
        self.stp = SequentialTimeProfiler("cont2-torch batch")
        self.results: List[LoopResult] = []
        self.fused_step = fused_step
        # (LaserScanInfo, QueryHandle or None), or for a block
        # (list of LaserScanInfo, BlockHandle), in scan order
        self._pending = []
        self._stage = None          # two staging slots of run_blocked/chained

    def _load(self, info) -> np.ndarray:
        max_points = self.cfg.cm.max_points
        return pad_points(read_kitti_bin(info.fpath, max_points), max_points)

    def spin_once(self) -> bool:
        """Process the next scan; returns False when the sequence ends."""
        ev = self.evaluator
        if not ev.load_new_scan():
            return False
        self._spin_info(ev.curr_scan)
        return True

    def _spin_info(self, info) -> None:
        """The per-scan step for one LaserScanInfo."""
        self.stp.lap()
        self.stp.start()
        pts = self._load(info)
        if self.fused_step:
            handle = self.db.step_async(pts, info.seq, info.ts)
            self.stp.record("scan step (fused)")
            self._pending.append((info, handle))
            return
        cfg = self.cfg
        desc = build_descriptor(torch.from_numpy(pts).to(self.db.device),
                                cfg.cm, cfg.gmm)
        self.stp.record("make bev")
        handle = self.db.query_async(desc)
        self.stp.record("query")
        self._pending.append((info, handle))
        self.stp.start()
        self.db.add_scan(desc, info.seq, info.ts)
        self.db.push_and_balance(info.ts)
        self.stp.record("Update database")

    def _process(self, info, res) -> None:
        cm = self.cfg.cm
        if res is None:
            pred = self.evaluator.add_prediction(info.seq, 0.0)
            self.results.append(LoopResult(info.seq, None, 0.0, pred.tfpn))
            return
        gidx, corr, T3 = res
        cand_seq = self.db.seq_of_gidx[gidx]
        pred = self.evaluator.add_prediction(
            info.seq, corr, cand_seq, se2_mat(T3[0], T3[1], T3[2]),
            cm.n_row, cm.n_col, cm.reso_row, cm.reso_col)
        self.results.append(LoopResult(info.seq, cand_seq, corr, pred.tfpn))

    def drain(self) -> None:
        """Fetch every pending record and classify it, in scan order."""
        if not self._pending:
            return
        scalars = iter(drain_handles(
            [h for info, h in self._pending if not isinstance(info, list)]))
        drain_block_handles(
            [h for info, h in self._pending if isinstance(info, list)])
        for info, h in self._pending:
            if isinstance(info, list):
                for i, res in zip(info, h.get()):
                    self._process(i, res)
            else:
                self._process(info, next(scalars))
        self._pending = []

    def run(self, max_scans: Optional[int] = None) -> None:
        """Replay the sequence (or its first max_scans scans), then drain."""
        n = 0
        while (max_scans is None or n < max_scans) and self.spin_once():
            n += 1
        self.drain()

    def _next_group(self, size: int, n_done: int, max_scans: Optional[int]):
        ev = self.evaluator
        infos = []
        while len(infos) < size and \
                (max_scans is None or n_done + len(infos) < max_scans) \
                and ev.load_new_scan():
            infos.append(ev.curr_scan)
        return infos

    def _stage_group(self, infos, slot: int):
        """Read `infos` into the staging buffer of `slot` and start its copy
        to the device; returns the (group, max_points, 4) device tensor. On a
        CUDA device each of the two slots is one pinned host buffer, copied
        with non_blocking on the current stream; a slot is written again
        only after an event recorded behind its last copy has passed."""
        group, dev = len(infos), self.db.device
        shape = (group, self.cfg.cm.max_points, 4)
        if self._stage is None or self._stage[0][0].shape != shape:
            pin = dev.type == "cuda"
            self._stage = [[torch.empty(shape, dtype=torch.float32,
                                        pin_memory=pin), None]
                           for _ in range(2)]
        buf, copied = self._stage[slot]
        if copied is not None:
            copied.synchronize()
        host = buf.numpy()
        for j, info in enumerate(infos):
            host[j] = self._load(info)
        if dev.type != "cuda":
            return buf.clone()      # .to() of a CPU tensor would alias it
        dev_pts = buf.to(dev, non_blocking=True)
        self._stage[slot][1] = torch.cuda.Event()
        self._stage[slot][1].record()
        return dev_pts

    def run_blocked(self, block: int = 16, max_scans: Optional[int] = None,
                    drain_at_end: bool = True) -> None:
        """Batched replay, `block` scans a step: their descriptors are built,
        then the whole block is appended and queried by
        `ContourDB.process_block_async` with exact sequential-window parity
        (its docstring has the precondition on the timestamps). A tail
        shorter than a block goes through the per-scan path: padding it with
        duplicate scans would pollute the searchable store."""
        n_done = 0
        while max_scans is None or n_done < max_scans:
            infos = self._next_group(block, n_done, max_scans)
            if len(infos) < block:
                for info in infos:
                    self._spin_info(info)
                break
            self.stp.lap()
            self.stp.start()
            dev_pts = self._stage_group(infos, (n_done // block) % 2)
            descs = build_descriptors(dev_pts, self.cfg.cm, self.cfg.gmm)
            self.stp.record("make bev")
            self.stp.start()
            h = self.db.process_block_async(descs, [i.seq for i in infos],
                                            [i.ts for i in infos])
            self.stp.record("block append+query")
            self._pending.append((infos, h))
            n_done += block
        if drain_at_end:
            self.drain()

    def run_chained(self, chain: int = 16, max_scans: Optional[int] = None,
                    drain_at_end: bool = True) -> None:
        """Chained replay: `chain` scans are staged and copied to the device
        together, then stepped one after another
        (`ContourDB.step_chain_async`), so query i sees every append and
        window update of the scans before it at any timestamp spacing,
        unlike `run_blocked`. For irregular streams."""
        n_done = 0
        while max_scans is None or n_done < max_scans:
            infos = self._next_group(chain, n_done, max_scans)
            if len(infos) < chain:
                for info in infos:
                    self._spin_info(info)
                break
            self.stp.lap()
            self.stp.start()
            dev_pts = self._stage_group(infos, (n_done // chain) % 2)
            self.stp.record("stage+upload")
            self.stp.start()
            hs = self.db.step_chain_async(dev_pts, [i.seq for i in infos],
                                          [i.ts for i in infos])
            self.stp.record("chain step")
            self._pending.extend(zip(infos, hs))
            n_done += chain
        if drain_at_end:
            self.drain()

    def save_outcome(self, path: str) -> None:
        self.evaluator.save_prediction_results(path)


def run_batch(fpath_pose: str, fpath_laser: str, outcome_path: str,
              cfg: Optional[PipelineConfig] = None,
              max_scans: Optional[int] = None,
              device="cuda", fused_step: bool = False,
              chain: Optional[int] = None) -> LoopClosurePipeline:
    """The cont2_batch_bin_test entry point (batch_bin_test.cpp:261-307):
    the per-scan replay (fused or not), or `run_chained` when `chain` is
    given."""
    cfg = cfg or PipelineConfig()
    ev = ContLCDEvaluator(fpath_pose, fpath_laser, cfg.correlation_thres)
    pipe = LoopClosurePipeline(cfg, ev, capacity=max(len(ev) + 8, 64),
                               device=device, fused_step=fused_step)
    if chain:
        pipe.run_chained(chain=chain, max_scans=max_scans)
    else:
        pipe.run(max_scans=max_scans)
    pipe.save_outcome(outcome_path)
    pipe.stp.print_screen()
    return pipe
