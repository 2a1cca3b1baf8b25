"""Stage split and device profile of the fused scan step.

    python -m contour_context_tpu_torch.profile_step [--device cuda]
        [--lane-scans 132] [--reps 20] [--profile-scans 50] [--dynamic]
        [--out FILE]

Run from the repository root (it renders scans with `tests/synth.py`). It
drives the stream of `chip_smoke.py` (bench.py's world and lane geometry:
lanes 0 and 1, then lane 0 again 1.5 m over, 10 Hz timestamps) at the
default `PipelineConfig()` through `ContourDB(capacity=8192).step_async`
up to the revisits, then on revisit scans 4.. it reports:

- per stage, the median over `--reps` scans of the time with a device
  synchronisation before and after the stage: the point upload, the
  descriptor build (split into raster, CC labels, contour tables, keys,
  BCIs and GMM summary + packing), the key search, search -> hints ->
  check 1 -> cascade -> merge, the whole query, and the whole step: every
  other scan's step through `step_async` (on a CUDA device one replay of
  the step's graph), the others' through the eager body the graph
  captured (`step_eager_ms`);
- the same scans' query cut at each `depth` stage gate of `db.query_step`
  (search, hints, check1, cascade, merge, init, then the whole record):
  the median time of each exact production prefix and the difference
  between successive prefixes, the method of the JAX package's
  scripts/headline_split_bench.py;
- `torch.profiler` over `--profile-scans` scans of graph replays, then on
  CUDA over as many scans through the eager body (under "eager"):
  device-busy ms and kernel launches per scan (the profiler records the
  kernels inside a graph replay), the top operators, and each CUDA kernel
  of the step (`ring_key_divs_kernel`, `search_tilemin_kernel`,
  `cc_labels_kernel`, `merge_hints_kernel`, `cascade_kernel`, and with
  `--dynamic` the
  `dyn_pass_scan_kernel` and `dyn_post_scan_kernel`) with its launches and
  mean device time per launch, beside the window's searchable_n (CUDA
  only);
- the host synchronisations per scan by call site, from torch's sync debug
  mode (CUDA only).

`--dynamic` runs the same stream with `dynamic_thres` on (the stream of
`chip_smoke.py` phase 9 is its first 64 scans).

The stage split syncs between stages, so its parts do not add up to the
unsynchronised step. Each stage is run on the DB state of the scan before
the real `step_async` of that scan, so the stream's state is unchanged.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
import traceback
import warnings
from collections import Counter
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from contour_context_tpu_torch.config import ContourManagerConfig, PipelineConfig
from contour_context_tpu_torch.utils.io import pad_points
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch.kernel_times import kernel_durations_us
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.ops import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "contour_context_tpu_torch")


def lane_poses(lane: int, n: int, dy: float = 0.0):
    """bench.py's lane geometry: poses 4 m apart, lanes 120 m apart."""
    y0 = -300.0 + 120.0 * lane + dy
    return [(-264.0 + 4.0 * i, y0 + 0.5 * (i % 7), 0.05 * (i % 11))
            for i in range(n)]


def build_split(points, cfg: PipelineConfig, sync) -> dict:
    """build_descriptor's stages on one scan (P, 4), as it runs them (a
    batch of one), timed one by one (ms)."""
    cm = cfg.cm
    out = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        out[name] = 1e3 * (time.perf_counter() - t0)
        return r

    pts = td.dequantize_points(points[None])
    bev, rowf, colf = timed("raster", lambda: td.rasterize_bev(pts, cm))

    def cc():
        masks = td.level_masks(bev, cm)
        return masks, td.cc_labels(masks)

    masks, labels = timed("cc", cc)
    tab = timed("tables", lambda: td.component_tables(
        labels, masks.flatten(-2), bev, rowf, colf, cm))
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


def device_ops(fn) -> Tuple[int, float]:
    """(kernel launches and copies fn puts on the card, the ms the card is
    busy with them), from torch.profiler."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    durs = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(durs), sum(durs) / 1e3


def host_syncs(fn) -> int:
    """Host syncs inside fn, by torch's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        caught.clear()   # switching the mode on warns of a sync of its own
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def block_split(db, points_b, cfg: PipelineConfig) -> dict:
    """The query side of one block step on `db`'s state, with a device
    synchronisation around each part, in ms: the batched descriptor build
    of the B clouds (one `build_descriptors` call), the batched key search
    (one tile-min launch and its stage 2), the batched tail (hint cap ->
    check 1 -> cascade -> merge -> GMM -> LM, one `query_from_hits` call for
    the B queries) and, beside the build and the tail, the same B clouds and
    queries through the same functions one at a time (B = 1 each), with the
    descriptors and records of both. On a CUDA device also each part's
    device operations (kernel launches and copies), the ms the card is busy
    with them under the profiler, and the host syncs of the batched build,
    of the B single builds (in all and the most of one), of the batched
    tail and of the B single tails; None on the CPU. Every query runs at the
    DB's searchable prefix; nothing is appended."""
    dev = db.device
    cuda = dev.type == "cuda"

    def timed(fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    pts = torch.as_tensor(points_b).to(dev)
    B = pts.shape[0]

    def build():
        return td.build_descriptors(pts, cfg.cm, cfg.gmm)

    def builds_one_by_one():
        return [td.build_descriptor(p, cfg.cm, cfg.gmm) for p in pts]

    build()                # first use of the batch's shapes: allocator
    descs, t_build = timed(build)
    ones, t_builds = timed(builds_one_by_one)
    sb = db.state[1].expand(B).contiguous()

    def search():
        return tdb.search_batch(db.keys_q, descs.keys, sb,
                                tuple(cfg.db.q_levels), cfg.db.nnk)

    hits, t_search = timed(search)

    def tail():
        return tdb.query_from_hits(db.store, descs, hits, cfg)

    def tails_one_by_one():
        return torch.cat([tdb.query_from_hits(
            db.store, type(descs)(*[x[b:b + 1] for x in descs]),
            tuple(h[b:b + 1] for h in hits), cfg) for b in range(B)])

    tail()                 # first use of the batch's shapes: allocator, caches
    recs, t_tail = timed(tail)
    recs_1, t_ones = timed(tails_one_by_one)
    out = {"B": B, "build_ms": t_build, "builds_one_by_one_ms": t_builds,
           "search_ms": t_search, "tails_ms": t_tail,
           "tails_one_by_one_ms": t_ones, "descs": descs,
           "descs_one_by_one": type(descs)(*[torch.stack(xs)
                                             for xs in zip(*ones)]),
           "records": recs, "records_one_by_one": recs_1}
    for name, fn in (("build", build), ("builds_one_by_one",
                                        builds_one_by_one),
                     ("search", search), ("tail", tail),
                     ("one_by_one", tails_one_by_one)):
        out[name + "_device_ops"], out[name + "_device_busy_ms"] = \
            device_ops(fn) if cuda else (None, None)
        if fn is not search:
            out[name + "_host_syncs"] = host_syncs(fn) if cuda else None
    out["single_build_host_syncs_max"] = max(
        host_syncs(lambda: td.build_descriptor(p, cfg.cm, cfg.gmm))
        for p in pts) if cuda else None
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


def _kernel_us(prof, n_scans: int, dynamic: bool = False) -> dict:
    """{kernel: {launches, mean device us per launch}} of the port's CUDA
    kernels in a profile of n_scans scans (with `dynamic`, the two dynamic
    scans too). Each wrapper must have launched its kernel once a scan (its
    own count) and the profile must hold a record of every launch; raises
    otherwise."""
    wrappers = {"ring_key_divs_kernel": kernels.ring_key_divs,
                "search_tilemin_kernel": kernels.search_tilemin,
                "cc_labels_kernel": kernels.cc_labels,
                "merge_hints_kernel": kernels.merge_hints,
                "cascade_kernel": kernels.cascade}
    if dynamic:
        wrappers["dyn_pass_scan_kernel"] = kernels.dyn_pass_scan
        wrappers["dyn_post_scan_kernel"] = kernels.dyn_post_scan
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
        profile_scans: int = 50, sync_scans: int = 4,
        max_points: Optional[int] = None, capacity: int = 8192,
        dynamic: bool = False) -> dict:
    """Drive the stream (with `dynamic_thres` when `dynamic`) and measure
    it; returns the numbers as a dict."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_world, render_scan

    cfg = PipelineConfig() if max_points is None else PipelineConfig(
        cm=ContourManagerConfig(max_points=max_points))
    if dynamic:
        cfg = dataclasses.replace(
            cfg, db=dataclasses.replace(cfg.db, dynamic_thres=True))
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
    need = first + reps + profile_scans + (
        profile_scans + sync_scans if cuda else 0)
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

    def step_eager():
        """The next scan through the eager body the step's graph captured
        (the same records and state: the stream goes on whole)."""
        nonlocal k
        with db.eager():
            db.step_async(clouds[k], k, 0.1 * k)
        k += 1

    while k < first:
        step()
    sync()

    names = ("upload", "build", "search", "stages(search..merge)",
             "query_step", "step_async")
    times = {n: [] for n in names}
    split = []
    prefixes = tdb.DEPTHS + ("record",)
    depth_times = {d: [] for d in prefixes}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        times[name].append(1e3 * (time.perf_counter() - t0))
        return r

    eager_ms = []
    for rep in range(reps):
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
        for d in prefixes:
            sync()
            t0 = time.perf_counter()
            tdb.query_step(db.store, db.keys_q, desc, db.state, cfg,
                           depth=None if d == "record" else d)
            sync()
            depth_times[d].append(1e3 * (time.perf_counter() - t0))
        if rep % 2 == 0:
            timed("step_async", step)
        else:
            sync()
            t0 = time.perf_counter()
            step_eager()
            sync()
            eager_ms.append(1e3 * (time.perf_counter() - t0))
    res = {"device": str(dev), "dynamic_thres": dynamic,
           "scans": [first, first + reps - 1],
           "stage_ms": {n: statistics.median(v) for n, v in times.items()},
           "stage_reps": {n: len(v) for n, v in times.items()},
           "step_eager_ms": statistics.median(eager_ms) if eager_ms
           else None,
           "depth_ms": {d: statistics.median(v)
                        for d, v in depth_times.items()},
           "build_split_ms": {n: statistics.median(s[n] for s in split)
                              for n in split[0]}}

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # the graphed step (its replays), then on CUDA the eager body it
    # captured, each over profile_scans scans of the stream
    for mode, fn in (("graphed", step), ("eager", step_eager)):
        if mode == "eager" and not cuda:
            break
        sn0 = db.searchable_n
        kernels.reset_launches()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(profile_scans):
                fn()
            sync()
        out = res if mode == "graphed" else res.setdefault("eager", {})
        out["profile_searchable_n"] = [sn0, db.searchable_n]
        sort = "self_cuda_time_total" if cuda else "self_cpu_time_total"
        out["profile_table"] = prof.key_averages().table(sort_by=sort,
                                                         row_limit=25)
        if cuda:
            busy, launches = _device_busy(prof, profile_scans)
            out["device_busy_ms_per_scan"] = busy
            out["kernel_launches_per_scan"] = launches
            out["kernel_device_us"] = _kernel_us(prof, profile_scans,
                                                 dynamic)
    if cuda:
        res["host_syncs_per_scan"] = dict(_sync_sites(step, sync_scans))
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m contour_context_tpu_torch.profile_step",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lane-scans", type=int, default=132)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile-scans", type=int, default=50)
    ap.add_argument("--max-points", type=int, default=None,
                    help="scan width (default: PipelineConfig's)")
    ap.add_argument("--capacity", type=int, default=8192)
    ap.add_argument("--dynamic", action="store_true",
                    help="the stream with dynamic_thres on")
    ap.add_argument("--out", help="also write the numbers here as JSON")
    args = ap.parse_args(argv)
    res = run(args.device, args.lane_scans, args.reps, args.profile_scans,
              max_points=args.max_points, capacity=args.capacity,
              dynamic=args.dynamic)
    for name, ms in res["stage_ms"].items():
        print(f"{name:>24}: {ms:9.3f} ms median over "
              f"{res['stage_reps'][name]}")
    prev = 0.0
    for d, ms in res["depth_ms"].items():
        print(f"query prefix to {d:>7}: {ms:9.3f} ms median over "
              f"{args.reps}, stage delta {ms - prev:+9.3f} ms")
        prev = ms
    print("build split ms: " + " ".join(
        f"{n} {ms:.3f}" for n, ms in res["build_split_ms"].items()))
    print(res["profile_table"])
    if res["step_eager_ms"] is not None:
        print(f"{'step (eager body)':>24}: {res['step_eager_ms']:9.3f} ms "
              f"median over {args.reps // 2} (the other reps' scans)")
    for mode, r in (("graphed", res), ("eager", res.get("eager", {}))):
        if "device_busy_ms_per_scan" not in r:
            continue
        print(f"{mode}: device busy per scan ms: "
              f"{r['device_busy_ms_per_scan']} kernel launches per scan: "
              f"{r['kernel_launches_per_scan']}")
        for name, kd in r["kernel_device_us"].items():
            print(f"{mode}: {name}: {kd['launches']} launches, mean "
                  f"{kd['mean_us']} us device time (searchable_n "
                  f"{r['profile_searchable_n']})")
    if "host_syncs_per_scan" in res:
        print(f"host syncs per scan: "
              f"{sum(res['host_syncs_per_scan'].values()):g}")
        for site, n in sorted(res["host_syncs_per_scan"].items()):
            print(f"{n:5.2f}/scan  {site}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: v for k, v in res.items() if k != "profile_table"},
                      f, indent=1, default=str)
    return res


if __name__ == "__main__":
    main()
