"""Timing: TicToc stopwatch and a named-section sequential profiler.

The port's own copy of `contour_context_tpu/utils/profiling.py`
(bm_util.h:19-218). The profiler keeps the reference's report layout
(Index/Name/Count/Average/Stddev/Per-loop/Loop%/Accum%). The device runs
asynchronously, so a section measures the device's work only where the
caller synchronises before `record()`.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple


class TicToc:
    """Monotonic stopwatch (bm_util.h:19-43)."""

    def __init__(self):
        self.tic()

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        return time.perf_counter() - self._t0


@dataclass
class _OneLog:
    idx: int
    cnt: int = 0
    samps: float = 0.0
    autocorrs: float = 0.0


class SequentialTimeProfiler:
    """Named-section profiler with per-loop statistics (bm_util.h:45-218)."""

    def __init__(self, desc: str = ""):
        self.desc = desc
        self.logs: Dict[str, _OneLog] = {}
        self.cnt_loops = 0
        self._clk = TicToc()

    def start(self) -> None:
        self._clk.tic()

    def record(self, name: str) -> float:
        dt = self._clk.toc()
        lg = self.logs.get(name)
        if lg is None:
            lg = _OneLog(idx=len(self.logs))
            self.logs[name] = lg
        lg.cnt += 1
        lg.samps += dt
        lg.autocorrs += dt * dt
        self._clk.tic()
        return dt

    def lap(self) -> None:
        self.cnt_loops += 1

    # --- reporting ---------------------------------------------------------

    def _rows(self, sort_by_cost: bool) -> List[Tuple[str, _OneLog]]:
        rows = list(self.logs.items())
        rows.sort(key=(lambda kv: -kv[1].samps) if sort_by_cost else (lambda kv: kv[1].idx))
        return rows

    def report(self, sort_by_cost: bool = False) -> str:
        rows = self._rows(sort_by_cost)
        max_len = max([5] + [len(k) for k in self.logs])
        t_total = sum(lg.samps for _, lg in rows) or 1e-30
        lines = [
            "\n=== Time Profiling @%s ===" % time.strftime("%Y-%m-%d %a %X %z"),
            "=== Description: %s" % self.desc,
            "%5s %s %10s %10s %10s %10s %10s %10s"
            % ("Index", " " * (max_len - 4) + "Name", "Count", "Average", "Stddev",
               "Per loop", "Loop %", "Accum %"),
        ]
        t_accum = 0.0
        for name, lg in rows:
            x_bar = lg.samps / lg.cnt
            stddev = 0.0
            if lg.cnt > 1:
                var = (lg.autocorrs + lg.cnt * x_bar * x_bar - 2 * x_bar * lg.samps) / (lg.cnt - 1)
                stddev = math.sqrt(max(0.0, var))
            t_accum += lg.samps
            lines.append(
                "%5d %s %10d %10.2e %10.2e %10.2e %10.2f %10.2f"
                % (lg.idx, " " * (max_len - len(name)) + name, lg.cnt, x_bar, stddev,
                   lg.samps / self.cnt_loops if self.cnt_loops else 0.0,
                   lg.samps / t_total * 100, t_accum / t_total * 100))
        lines.append(
            "%5s %s %10d %10s %10s %10.2e %10s %10s"
            % ("*", " " * (max_len - 4) + "*sum", self.cnt_loops, "*", "*",
               t_total / self.cnt_loops if self.cnt_loops else 0.0, "*", "*"))
        return "\n".join(lines)

    def print_screen(self, sort_by_cost: bool = False) -> None:
        print(self.report(sort_by_cost))

    def print_file(self, fpath: str, sort_by_cost: bool = False) -> None:
        with open(fpath, "a") as f:
            f.write(self.report(sort_by_cost) + "\n")
