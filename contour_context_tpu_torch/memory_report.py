"""Device memory of the port's DB paths: the stream, the block build, map
serving, and two maps in one process, each path in a process of its own.

    python contour_context_tpu_torch/memory_report.py [--root DIR] [--out FILE]

Each path runs in a fresh process (the caching allocator starts empty) at
the default `PipelineConfig()` on `ContourDB(capacity=8192)`, over scans of
`profile_step`'s world (`tests/synth.py`; lane 0, and lane 0 again 1.5 m
over for the revisits):

- stream: `step_async` over 48 scans;
- block: `block_chain_pts_async` over 3 blocks of 16;
- serving: that block-built map serves the 48 revisit clouds through
  `localize_block_async(chunk=16)`; its peaks are read from the start of
  serving;
- two_maps: two DBs in one process, each built through
  `block_chain_pts_async` over the same 3 blocks of 16 (each holding the
  build and query graphs of 16), then the second serves the 48 revisit
  clouds.

Each path prints one JSON line: the bytes allocated after it (resident),
the peak allocated during it, the bytes reserved after it and at most
during it, the bytes of the process's CUDA graph pools (`pool`: one pool a
device shared by every DB where `pool_scope` is "process", the sum of the
DBs' own pools where a tree keeps one a DB; None where no DB has graphs),
and the bytes reserved and allocated after every DB's graphs are dropped
and the allocator's cache is emptied. `--root` imports the package
and `tests/synth.py` from another checkout, so two trees are read in one
call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("stream", "block", "serving", "two_maps")
N_SCANS, BLOCK = 48, 16


def lane_poses(lane: int, n: int, dy: float = 0.0):
    """bench.py's lane geometry (as `profile_step.lane_poses`)."""
    y0 = -300.0 + 120.0 * lane + dy
    return [(-264.0 + 4.0 * i, y0 + 0.5 * (i % 7), 0.05 * (i % 11))
            for i in range(n)]


def run_path(path: str, root: str) -> dict:
    """One path's numbers (bytes), the package imported from `root`."""
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import numpy as np
    import torch
    from synth import make_world, render_scan
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch.config import PipelineConfig
    from contour_context_tpu_torch.utils.io import pad_points

    if not torch.cuda.is_available():
        raise SystemExit("memory_report: no CUDA device")
    cfg = PipelineConfig()
    world = make_world(1, n_structs=300, extent=400.0)
    rng = np.random.default_rng(0)

    def clouds(poses):
        return np.stack([pad_points(render_scan(
            world, p, seed=int(rng.integers(1 << 30))), cfg.cm.max_points)
            for p in poses])

    pts = clouds(lane_poses(0, N_SCANS))
    torch.cuda.reset_peak_memory_stats()

    def block_map():
        m = tdb.ContourDB(cfg, capacity=8192, device="cuda")
        nb = N_SCANS // BLOCK
        m.block_chain_pts_async(
            torch.from_numpy(pts).reshape((nb, BLOCK) + pts.shape[1:]),
            list(range(N_SCANS)),
            [[0.1 * i for i in range(k, k + BLOCK)]
             for k in range(0, N_SCANS, BLOCK)])
        return m

    if path == "stream":
        dbs = [tdb.ContourDB(cfg, capacity=8192, device="cuda")]
        for i in range(N_SCANS):
            dbs[0].step_async(pts[i], i, 0.1 * i)
    else:
        dbs = [block_map() for _ in range(2 if path == "two_maps" else 1)]
        if path != "block":
            rev = clouds(lane_poses(0, N_SCANS, dy=1.5))
            torch.cuda.synchronize()
            if path == "serving":
                torch.cuda.reset_peak_memory_stats()
            dbs[-1].localize_block_async(rev, chunk=BLOCK)
    torch.cuda.synchronize()
    db = dbs[-1]
    stats = [m.graph_stats() for m in dbs] \
        if hasattr(db, "graph_stats") else None
    # a tree whose graph_stats names the pool shares one a device
    shared = stats is not None and "pool" in stats[0]
    out = dict(path=path, root=root, dbs=len(dbs),
               store=db.store_bytes() if hasattr(db, "store_bytes") else None,
               resident=torch.cuda.memory_allocated(),
               peak=torch.cuda.max_memory_allocated(),
               reserved=torch.cuda.memory_reserved(),
               peak_reserved=torch.cuda.max_memory_reserved(),
               pool=None if stats is None else
               stats[0]["pool_bytes"] if shared else
               sum(st["pool_bytes"] for st in stats),
               pool_scope=None if stats is None else
               "process" if shared else "db")
    for m in dbs:
        if hasattr(m, "drop_graphs"):
            m.drop_graphs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out.update(reserved_after_drop=torch.cuda.memory_reserved(),
               resident_after_drop=torch.cuda.memory_allocated())
    return out


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(
        prog="python contour_context_tpu_torch/memory_report.py",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package is measured")
    ap.add_argument("--path", choices=PATHS,
                    help="run one path in this process (default: each path "
                         "in a process of its own)")
    ap.add_argument("--out", help="also append the JSON lines here")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    if args.path:
        rows = [run_path(args.path, root)]
    else:
        rows = []
        for path in PATHS:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--root", root, "--path", path],
                               capture_output=True, text=True, check=False)
            if r.returncode:
                raise SystemExit(f"memory_report: {path} failed "
                                 f"({r.returncode}):\n{r.stderr[-4000:]}")
            rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
    for row in rows:
        print(json.dumps(row))
    if args.out and not args.path:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
