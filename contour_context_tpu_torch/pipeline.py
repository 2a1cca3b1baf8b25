"""End-to-end loop-closure pipeline, in torch.

Replays a sequence (test/batch_bin_test.cpp:105-248) on the DB's device, in
one of four ways that write the same outcome file:
- `run` (the default, as in the JAX package and both CLIs): per scan through
  the unfused API (the DB's per-scan build, `query_async`, `add_scan`,
  `push_and_balance`; on a CUDA device one CUDA graph replay each), with a
  per-stage timing report;
- `run` with `fused_step=True`: the same order in one `ContourDB.step_async`
  a scan (build -> query -> append -> window), which also writes the DB's
  record ring;
- `run_blocked`: `block` scans at a time, built by one batched build (on a
  CUDA device one replay of the DB's build graph of `block`), then
  `process_block_async` (one batched key search a block; needs regularly
  spaced timestamps);
- `run_chained`: `chain` scans staged and copied at a time, then stepped one
  by one (`step_chain_async`, exact at any timestamp spacing).
Scans are read by the native loader (utils/native_loader.py) unless
`set_point_loader` replaces it. In `run` the next scan's upload is issued
before this scan's step (a 1-deep prefetch); on a CUDA device uploads go
through pinned host slots, each reused only after a CUDA event recorded
behind its last copy has passed. Records stay on the device and are drained
at the end of the stream (or `DRAIN_BLOCK` at a time once twice that many
are pending); TP/FP/FN classification then happens in scan order and the
outcome file is written by the evaluator (eval/evaluator.py).
"""

from __future__ import annotations

import contextlib
import os
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

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
    dequantize_points,
    rasterize_bev,
)
from contour_context_tpu_torch.types import scan_desc_to_numpy
from contour_context_tpu_torch.utils.io import pad_points, quantize_points_q16
from contour_context_tpu_torch.utils.profiling import SequentialTimeProfiler
from contour_context_tpu_torch.utils.se2 import se2_mat

DRAIN_BLOCK = 4096   # pending-record bound before a mid-stream drain
TRACE_FILE = "cont2_trace.json"


@dataclass
class LoopResult:
    q_seq: int
    cand_seq: Optional[int]
    correlation: float
    tfpn: int


@contextlib.contextmanager
def torch_trace(trace_dir: Optional[str], device):
    """A torch.profiler trace (host ops, and the CUDA kernels on a CUDA
    device) of the block, exported as Chrome JSON to
    `trace_dir/cont2_trace.json`; nothing when trace_dir is None."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


class LoopClosurePipeline:
    """Streaming per-scan loop (the reference's BatchBinSpinner). The
    positional parameters are the JAX package's; the device is a keyword."""

    def __init__(self, cfg: PipelineConfig, evaluator: ContLCDEvaluator,
                 capacity: int = 8192, block_for_timing: bool = False,
                 save_mid_dir: Optional[str] = None,
                 q16_transport: bool = False, fused_step: bool = False, *,
                 device="cuda"):
        self.cfg = cfg
        self.evaluator = evaluator
        self.db = ContourDB(cfg, capacity, device=device)
        # the report's header names how the stages run on the card
        mode = ""
        if self.db.device.type == "cuda":
            mode = (" (unfused stages: one CUDA graph replay each; fused "
                    "step: one CUDA graph replay)" if self.db.graphed else
                    " (unfused stages and fused step: eager bodies)")
        self.stp = SequentialTimeProfiler("cont2-torch batch" + mode)
        self.results: List[LoopResult] = []
        # synchronise after each stage, so the timing report holds device
        # time
        self.block = block_for_timing
        # SAVE_MID_FILE (contour_mng.h:547-555): per-scan contour dumps and
        # BEV images; fetches the descriptor to the host every scan
        self.save_mid_dir = save_mid_dir
        # int16 fixed-point wire format (1/256 m): half the upload bytes,
        # dequantized on the device
        self.q16_transport = q16_transport
        if fused_step and save_mid_dir is not None:
            print("warning: fused_step disabled — save_mid_dir needs the "
                  "descriptor on host (falling back to the 4-dispatch path)")
        self.fused_step = fused_step and save_mid_dir is None
        # (LaserScanInfo, QueryHandle or None), or for a block or chain
        # (list of LaserScanInfo, BlockHandle), in scan order
        self._pending: deque = deque()
        self._prefetched = None     # (seq, device points) of the next scan
        self._slots = None          # pinned single-scan upload slots
        self._n_up = 0
        self._stage = None          # two staging slots of run_blocked/chained
        from contour_context_tpu_torch.utils.native_loader import (
            read_bin_padded)
        self._load_points: Callable[[str], np.ndarray] = \
            lambda p: read_bin_padded(p, cfg.cm.max_points)
        self._default_loader = True   # block staging reads into its buffer

    def set_point_loader(self, fn: Callable[[str], np.ndarray]) -> None:
        """Override the scan loader; may return (N,3) xyz or padded (P,4)."""
        self._load_points = fn
        self._default_loader = False

    def _ensure_padded(self, pts: np.ndarray) -> np.ndarray:
        if pts.ndim != 2 or pts.shape != (self.cfg.cm.max_points, 4):
            pts = pad_points(pts, self.cfg.cm.max_points)
        return pts

    def _sync(self) -> None:
        if self.block and self.db.device.type == "cuda":
            torch.cuda.synchronize(self.db.device)

    def _upload(self, info):
        """Load one scan and start its copy to the device. On a CUDA device
        the scan goes through one of two pinned slots, non_blocking; a slot
        is written again only after the event behind its last copy passed.
        On the CPU the tensor is a copy (a loader may reuse its buffer)."""
        pts = self._ensure_padded(self._load_points(info.fpath))
        if self.q16_transport:
            pts = quantize_points_q16(pts)
        dev = self.db.device
        if dev.type != "cuda":
            return torch.from_numpy(pts).clone()
        dt = torch.int16 if self.q16_transport else torch.float32
        if self._slots is None or self._slots[0][0].dtype != dt:
            self._slots = [[torch.empty(pts.shape, dtype=dt,
                                        pin_memory=True), None]
                           for _ in range(2)]
        slot = self._slots[self._n_up % 2]
        self._n_up += 1
        if slot[1] is not None:
            slot[1].synchronize()
        slot[0].numpy()[:] = pts
        dev_pts = slot[0].to(dev, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return dev_pts

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

    def _drain_block(self, k: int) -> None:
        """Fetch and classify the k oldest pending records, in scan order."""
        batch = [self._pending.popleft() for _ in range(k)]
        scalars = iter(drain_handles(
            [h for info, h in batch if not isinstance(info, list)]))
        drain_block_handles([h for info, h in batch if isinstance(info, list)])
        for info, h in batch:
            if isinstance(info, list):
                for i, res in zip(info, h.get()):
                    self._process(i, res)
            else:
                self._process(info, next(scalars))

    def drain(self) -> None:
        """Fetch every pending record and classify it, in scan order."""
        if self._pending:
            self._drain_block(len(self._pending))

    def _push_pending(self, item) -> None:
        self._pending.append(item)
        if len(self._pending) >= 2 * DRAIN_BLOCK:
            self._drain_block(DRAIN_BLOCK)

    def spin_once(self) -> bool:
        """Process the next scan; returns False when the sequence ends."""
        ev = self.evaluator
        if not ev.load_new_scan():
            return False
        self._spin_info(ev.curr_scan)
        return True

    def _spin_info(self, info, prefetch: bool = True) -> None:
        """The per-scan step for one LaserScanInfo (cursor already advanced).
        With `prefetch` the next scan's upload is issued before this scan's
        step; block and chain tails pass False (the cursor is past them)."""
        cfg = self.cfg
        self.stp.lap()
        self.stp.start()
        if self._prefetched is not None and self._prefetched[0] == info.seq:
            dev_pts = self._prefetched[1]
        else:
            dev_pts = self._upload(info)
        self._prefetched = None
        nxt = self.evaluator.peek_next() if prefetch else None
        if nxt is not None:
            self._prefetched = (nxt.seq, self._upload(nxt))
        if self.fused_step:
            handle = self.db.step_async(dev_pts, info.seq, info.ts)
            self._sync()
            self.stp.record("scan step (fused)")
            self._push_pending((info, handle))
            return
        desc = self.db._build_one(dev_pts)
        self._sync()
        self.stp.record("make bev")
        if self.save_mid_dir is not None:
            # fetched now: on a CUDA device `desc` is the build graph's
            # static output, which the next scan's replay overwrites
            from contour_context_tpu_torch.utils.dumps import (
                save_bev_image, save_contours)

            save_contours(os.path.join(
                self.save_mid_dir, "contours-%06d.txt" % info.seq),
                scan_desc_to_numpy(desc), cfg.cm)
            bev, _, _ = rasterize_bev(dequantize_points(dev_pts), cfg.cm)
            save_bev_image(os.path.join(
                self.save_mid_dir, "bev-%06d.png" % info.seq),
                bev.cpu().numpy().reshape(cfg.cm.n_row, cfg.cm.n_col))
        handle = self.db.query_async(desc)
        self._sync()
        self.stp.record("query (fused)")
        self.stp.start()
        self.db.add_scan(desc, info.seq, info.ts)
        self.db.push_and_balance(info.ts)
        self._sync()
        self.stp.record("Update database")
        self._push_pending((info, handle))

    def run(self, max_scans: Optional[int] = None, progress_every: int = 0,
            trace_dir: Optional[str] = None) -> None:
        """Replay the sequence (or its first max_scans scans), then drain;
        `trace_dir` wraps the replay in a torch.profiler trace
        (`torch_trace`)."""
        with torch_trace(trace_dir, self.db.device):
            n = 0
            while (max_scans is None or n < max_scans) and self.spin_once():
                n += 1
                if progress_every and n % progress_every == 0:
                    # results fill only at a drain: report the pending depth
                    # so that all-zero counts are not read as "no loops"
                    tfpn = [r.tfpn for r in self.results]
                    print("[%d] drained: tp=%d fp=%d fn=%d (pending on "
                          "device: %d)" % (n, tfpn.count(0), tfpn.count(1),
                                           tfpn.count(3), len(self._pending)),
                          flush=True)
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
        to the device; returns the (group, max_points, 4) device tensor. The
        default loader reads straight into the buffer on native threads. On
        a CUDA device each of the two slots is one pinned host buffer,
        copied with non_blocking on the current stream; a slot is written
        again only after an event recorded behind its last copy has passed.
        With q16_transport the quantized block is a fresh array."""
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
        if self._default_loader:
            from contour_context_tpu_torch.utils.native_loader import (
                read_block_into)

            read_block_into([i.fpath for i in infos], host)
        else:
            for j, info in enumerate(infos):
                host[j] = self._ensure_padded(self._load_points(info.fpath))
        if self.q16_transport:
            return torch.from_numpy(quantize_points_q16(
                host.reshape(-1, 4)).reshape(shape)).to(dev)
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
                    self._spin_info(info, prefetch=False)
                break
            self.stp.lap()
            self.stp.start()
            dev_pts = self._stage_group(infos, (n_done // block) % 2)
            descs = self.db._build_batch(dev_pts)
            self.stp.record("make bev")
            self.stp.start()
            h = self.db.process_block_async(descs, [i.seq for i in infos],
                                            [i.ts for i in infos])
            self.stp.record("block append+query")
            self._push_pending((infos, h))
            n_done += block
        if drain_at_end:
            self.drain()

    def run_chained(self, chain: int = 16, max_scans: Optional[int] = None,
                    drain_at_end: bool = True) -> None:
        """Chained replay: `chain` scans are staged and copied to the device
        together, then stepped one after another
        (`ContourDB.step_chain_async`, queued as one block), so query i sees
        every append and window update of the scans before it at any
        timestamp spacing, unlike `run_blocked`. For irregular streams."""
        n_done = 0
        while max_scans is None or n_done < max_scans:
            infos = self._next_group(chain, n_done, max_scans)
            if len(infos) < chain:
                for info in infos:
                    self._spin_info(info, prefetch=False)
                break
            self.stp.lap()
            self.stp.start()
            dev_pts = self._stage_group(infos, (n_done // chain) % 2)
            self.stp.record("stage+upload")
            self.stp.start()
            h = self.db.step_chain_async(dev_pts, [i.seq for i in infos],
                                         [i.ts for i in infos])
            self.stp.record("chain step")
            self._push_pending((infos, h))
            n_done += chain
        if drain_at_end:
            self.drain()

    def save_outcome(self, path: str) -> None:
        self.evaluator.save_prediction_results(path)


def run_batch(fpath_pose: str, fpath_laser: str, outcome_path: str,
              cfg: Optional[PipelineConfig] = None,
              max_scans: Optional[int] = None, fused_step: bool = False, *,
              device="cuda", chain: Optional[int] = None
              ) -> LoopClosurePipeline:
    """The cont2_batch_bin_test entry point (batch_bin_test.cpp:261-307):
    the per-scan replay (fused or not), or `run_chained` when `chain` is
    given. The positional parameters are the JAX package's."""
    cfg = cfg or PipelineConfig()
    ev = ContLCDEvaluator(fpath_pose, fpath_laser, cfg.correlation_thres)
    pipe = LoopClosurePipeline(cfg, ev, capacity=max(len(ev) + 8, 64),
                               fused_step=fused_step, device=device)
    if chain:
        pipe.run_chained(chain=chain, max_scans=max_scans)
    else:
        pipe.run(max_scans=max_scans, progress_every=200)
    pipe.save_outcome(outcome_path)
    pipe.stp.print_screen()
    return pipe
