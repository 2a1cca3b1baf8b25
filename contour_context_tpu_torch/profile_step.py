"""Stage split and device profile of the fused scan step.

    python -m contour_context_tpu_torch.profile_step [--device cuda]
        [--lane-scans 132] [--reps 20] [--profile-scans 100] [--out FILE]

Run from the repository root (it renders scans with `tests/synth.py`). It
drives the stream of `chip_smoke.py` (bench.py's world and lane geometry:
lanes 0 and 1, then lane 0 again 1.5 m over, 10 Hz timestamps) at the
default `PipelineConfig()` through `ContourDB(capacity=8192).step_async`
up to the revisits, then on revisit scans 4.. it reports:

- per stage, the median over `--reps` scans of the time with a device
  synchronisation before and after the stage: the point upload, the
  descriptor build (split into raster, CC labels, contour tables, keys,
  BCIs and GMM summary + packing), the key search, search -> hints ->
  check 1 -> cascade -> merge, the whole query, and the whole step;
- `torch.profiler` over `--profile-scans` scans: device-busy ms and kernel
  launches per scan, the top operators, and each CUDA kernel of the port
  (`ring_key_divs_kernel`, `search_tilemin_kernel`) with its launches and
  mean device time per launch, beside the window's searchable_n (CUDA
  only);
- the host synchronisations per scan by call site, from torch's sync debug
  mode (CUDA only).

The stage split syncs between stages, so its parts do not add up to the
unsynchronised step. Each stage is run on the DB state of the scan before
the real `step_async` of that scan, so the stream's state is unchanged.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback
import warnings
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from contour_context_tpu_torch.config import ContourManagerConfig, PipelineConfig
from contour_context_tpu_torch.utils.io import pad_points
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch.kernel_times import kernel_durations_us
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.ops import kernels
from contour_context_tpu_torch.types import device_const

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "contour_context_tpu_torch")


def lane_poses(lane: int, n: int, dy: float = 0.0):
    """bench.py's lane geometry: poses 4 m apart, lanes 120 m apart."""
    y0 = -300.0 + 120.0 * lane + dy
    return [(-264.0 + 4.0 * i, y0 + 0.5 * (i % 7), 0.05 * (i % 11))
            for i in range(n)]


def build_split(points, cfg: PipelineConfig, sync) -> dict:
    """build_descriptor's stages, timed one by one (ms)."""
    cm = cfg.cm
    out = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        out[name] = 1e3 * (time.perf_counter() - t0)
        return r

    pts = td.dequantize_points(points)
    bev, rowf, colf = timed("raster", lambda: td.rasterize_bev(pts, cm))

    def cc():
        grads = device_const(tuple(cm.lv_grads), torch.float32, bev.device)
        masks = bev.reshape(cm.n_row, cm.n_col)[None] > grads[:, None, None]
        return masks, td.cc_labels(masks)

    masks, labels = timed("cc", cc)
    tab = timed("tables", lambda: td.component_tables(
        labels, masks.reshape(cm.n_levels, -1), bev, rowf, colf, cm))
    _, anch_valid, _ = timed("keys", lambda: td.make_keys(tab, bev, rowf,
                                                          colf, cm))
    timed("bcis", lambda: td.make_bcis(tab, anch_valid, cm))

    def gmm():
        gmm_mask, _, _ = td.gmm_summary(tab, cfg.gmm)
        td.pack_tab12(tab["cnt"], tab["valid"], tab["mean"], tab["eig_vals"],
                      tab["eig_vecs"], tab["vol3_mean"], tab["com_r"],
                      tab["ecc_feat"], tab["cont_perc"])
        td.pack_gmm(tab["mean"], tab["manual_cov"], tab["cnt"],
                    tab["eig_vals"], gmm_mask, cfg.gmm)

    timed("gmm", gmm)
    return out


def _device_busy(prof, n_scans: int):
    """(device-busy ms per scan, kernel launches per scan) of a profile."""
    busy_us, kernels = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            kernels += not e.name.startswith("Memcpy") and \
                not e.name.startswith("Memset")
    return busy_us / 1e3 / n_scans, kernels / n_scans


def _kernel_us(prof, n_scans: int) -> dict:
    """{kernel: {launches, mean device us per launch}} of the port's CUDA
    kernels in a profile of n_scans scans. Each wrapper must have launched
    its kernel once a scan (its own count) and the profile must hold a
    record of every launch; raises otherwise."""
    wrappers = {"ring_key_divs_kernel": kernels.ring_key_divs,
                "search_tilemin_kernel": kernels.search_tilemin}
    out = {}
    for name, wrapper in wrappers.items():
        durs = kernel_durations_us(prof, name)
        if wrapper.launches != n_scans or len(durs) != n_scans:
            raise RuntimeError(
                f"{name}: {wrapper.launches} launches counted and {len(durs)} "
                f"profiled in {n_scans} scans, expected one a scan")
        out[name] = {"launches": len(durs), "mean_us": float(np.mean(durs))}
    return out


def _sync_sites(step, n_scans: int) -> Counter:
    """Host synchronisations per scan by call site (innermost port frame
    and its caller in the port), from torch's sync debug mode."""
    sites = Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(PKG)]
        key = " <- ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} "
                          f"{(f.line or '').strip()}"
                          for f in frames[::-1][:2])
        sites[key] += 1

    with warnings.catch_warnings():
        # switching the mode on warns of a sync of its own: not the step's
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        warnings.simplefilter("always")
        warnings.showwarning = hook
        try:
            for _ in range(n_scans):
                step()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return Counter({k: v / n_scans for k, v in sites.items()})


def run(device: str = "cuda", lane_scans: int = 132, reps: int = 20,
        profile_scans: int = 100, sync_scans: int = 4,
        max_points: Optional[int] = None, capacity: int = 8192) -> dict:
    """Drive the stream and measure it; returns the numbers as a dict."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_world, render_scan

    cfg = PipelineConfig() if max_points is None else PipelineConfig(
        cm=ContourManagerConfig(max_points=max_points))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rev0 = 2 * lane_scans
    plan = (lane_poses(0, lane_scans) + lane_poses(1, lane_scans)
            + lane_poses(0, lane_scans, dy=1.5))
    first = rev0 + 4
    need = first + reps + profile_scans + (sync_scans if cuda else 0)
    if need > len(plan):
        raise ValueError(f"{need} scans needed, the stream has {len(plan)}")
    world = make_world(1, n_structs=300, extent=400.0)
    rng = np.random.default_rng(0)
    clouds = [pad_points(render_scan(world, p, seed=int(rng.integers(1 << 30))),
                         cfg.cm.max_points) for p in plan[:need]]
    db = tdb.ContourDB(cfg, capacity=capacity, device=dev)
    k = 0

    def step():
        nonlocal k
        db.step_async(clouds[k], k, 0.1 * k)
        k += 1

    while k < first:
        step()
    sync()

    names = ("upload", "build", "search", "stages(search..merge)",
             "query_step", "step_async")
    times = {n: [] for n in names}
    split = []

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        times[name].append(1e3 * (time.perf_counter() - t0))
        return r

    for _ in range(reps):
        pts = timed("upload", lambda: torch.as_tensor(clouds[k]).to(dev))
        desc = timed("build", lambda: td.build_descriptor(pts, cfg.cm,
                                                          cfg.gmm))
        split.append(build_split(pts, cfg, sync))
        timed("search", lambda: tdb.search(
            db.keys_q, desc.keys, db.state, tuple(cfg.db.q_levels),
            cfg.db.nnk))
        timed("stages(search..merge)", lambda: tdb.query_stages(
            db.store, db.keys_q, desc, db.state, cfg))
        timed("query_step", lambda: tdb.query_step(
            db.store, db.keys_q, desc, db.state, cfg))
        timed("step_async", step)
    res = {"device": str(dev), "scans": [first, first + reps - 1],
           "stage_ms": {n: statistics.median(v) for n, v in times.items()},
           "build_split_ms": {n: statistics.median(s[n] for s in split)
                              for n in split[0]}}

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sn0 = db.searchable_n
    kernels.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(profile_scans):
            step()
        sync()
    res["profile_searchable_n"] = [sn0, db.searchable_n]
    sort = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    res["profile_table"] = prof.key_averages().table(sort_by=sort,
                                                     row_limit=25)
    if cuda:
        busy, launches = _device_busy(prof, profile_scans)
        res["device_busy_ms_per_scan"] = busy
        res["kernel_launches_per_scan"] = launches
        res["kernel_device_us"] = _kernel_us(prof, profile_scans)
        res["host_syncs_per_scan"] = dict(_sync_sites(step, sync_scans))
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m contour_context_tpu_torch.profile_step",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lane-scans", type=int, default=132)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile-scans", type=int, default=100)
    ap.add_argument("--max-points", type=int, default=None,
                    help="scan width (default: PipelineConfig's)")
    ap.add_argument("--capacity", type=int, default=8192)
    ap.add_argument("--out", help="also write the numbers here as JSON")
    args = ap.parse_args(argv)
    res = run(args.device, args.lane_scans, args.reps, args.profile_scans,
              max_points=args.max_points, capacity=args.capacity)
    for name, ms in res["stage_ms"].items():
        print(f"{name:>24}: {ms:9.3f} ms median over {args.reps}")
    print("build split ms: " + " ".join(
        f"{n} {ms:.3f}" for n, ms in res["build_split_ms"].items()))
    print(res["profile_table"])
    if "device_busy_ms_per_scan" in res:
        print(f"device busy per scan ms: {res['device_busy_ms_per_scan']} "
              f"kernel launches per scan: {res['kernel_launches_per_scan']}")
        for name, kd in res["kernel_device_us"].items():
            print(f"{name}: {kd['launches']} launches, mean {kd['mean_us']} "
                  f"us device time (searchable_n "
                  f"{res['profile_searchable_n']})")
        print(f"host syncs per scan: "
              f"{sum(res['host_syncs_per_scan'].values()):g}")
        for site, n in sorted(res["host_syncs_per_scan"].items()):
            print(f"{n:5.2f}/scan  {site}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: v for k, v in res.items() if k != "profile_table"},
                      f, indent=1)
    return res


if __name__ == "__main__":
    main()
