"""The one general generator of traffic, and the timed window.

A traffic file's `kind` picks the loop; every other number of a mix is a
parameter of that file:

- `stream`: open loop at the sensor rate. The configuration's history is
  built first (the port's block chain, `history_block` scans a block),
  then `warmup_scans` steps, then one scan is due every 1/`rate_hz` s of
  wall clock for the window, through `ContourDB.step_async` and
  `QueryHandle.record`. After the history the drive either revisits it
  (`after_history` "revisit": from `revisit_back_scans` behind its end,
  backwards, `lateral_m` off, heading reversed when `reverse`) or goes on
  into new territory ("explore"). Each scan's latency runs from its due
  time to its record on the host, so a stall delays every scan behind it.
- `serve`: closed loop, one client. The configuration's map is built in
  blocks of `map_block` and frozen (`ContourDB.merge`); a pool of
  `pool_clouds` query clouds from a second pass over the route
  (`lateral_m` off, fresh sensor noise) is cycled, `request_clouds` host
  clouds a request through `ContourDB.localize_block_async` and
  `BlockHandle.get`, until the window's seconds are over.

Every shape the window uses is warmed up in set-up; the clouds the window
sends are pageable host tensors, as a sensor driver or a client hands
them over.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from harness import world as W
from harness.trace import ITEM, MARGIN

STREAM_HISTORY, STREAM_AFTER, SERVE_MAP, SERVE_QUERIES = 0, 1, 2, 3


class Refused(RuntimeError):
    """The cell cannot be run as stated: no fallback, no result."""


def sleep_until(t: float) -> None:
    """Sleep to 20 ms before t, then spin: a sleep can overrun by
    milliseconds on a shared host, and the due time is the latency's
    start."""
    left = t - time.perf_counter()
    if left > 0.02:
        time.sleep(left - 0.02)
    while time.perf_counter() < t:
        pass


def plan(cfg_file: dict, traffic: dict, seconds: float, seed: int,
         device) -> dict:
    """The scans of a cell: poses, timestamps and the drives that render
    their clouds, and the counts the window will run."""
    route = cfg_file["route"]
    sp = float(cfg_file["scan_spacing_m"])
    rate = float(cfg_file["sensor_hz"])
    kind = traffic["kind"]
    if kind == "stream":
        H = int(cfg_file["history_scans"])
        Wu = int(traffic["warmup_scans"])
        n_win = int(round(seconds * float(traffic["rate_hz"])))
        if n_win < 1 or n_win > int(traffic["max_window_scans"]):
            raise Refused(f"{n_win} window scans: the mix allows 1 to "
                          f"{traffic['max_window_scans']}")
        need = H + Wu + n_win
        if need > int(cfg_file["capacity"]):
            raise Refused(f"the DB would grow inside the window: {H} history "
                          f"+ {Wu} warm-up + {n_win} window scans > capacity "
                          f"{cfg_file['capacity']}")
        if H % int(traffic["history_block"]):
            raise Refused("history_scans is not a whole number of blocks")
        n_post = Wu + n_win
        hist = W.route_poses(H, sp, route["amplitude_m"],
                             route["wavelength_m"])
        if traffic["after_history"] == "revisit":
            back = int(traffic["revisit_back_scans"])
            idx = H - back - np.arange(n_post)
            if idx.min() < 0:
                raise Refused("the revisit runs off the start of the history")
            age = (H + np.arange(n_post) - idx) / rate
            if age.min() <= cfg_file["pipeline"]["db"]["tb"]["min_elapse"]:
                raise Refused("a revisit is not older than the window's "
                              "min_elapse")
            post = W.offset_poses(hist[idx], float(traffic["lateral_m"]),
                                  bool(traffic["reverse"]))
        elif traffic["after_history"] == "explore":
            post = W.route_poses(n_post, sp, route["amplitude_m"],
                                 route["wavelength_m"], start=H)
        else:
            raise Refused(f"after_history {traffic['after_history']!r}")
        world = W.make_world(seed, np.concatenate([hist, post]),
                             cfg_file["world"], device)
        return dict(kind=kind, H=H, Wu=Wu, n_win=n_win, rate=rate,
                    rate_hz=float(traffic["rate_hz"]),
                    hist=W.Drive(seed, hist, world, cfg_file, STREAM_HISTORY),
                    post=W.Drive(seed, post, world, cfg_file, STREAM_AFTER),
                    ts_hist=np.arange(H) / rate,
                    ts_post=(H + np.arange(n_post)) / rate)
    if kind == "serve":
        M = int(cfg_file["map_scans"])
        if M > int(cfg_file["capacity"]) or M % int(traffic["map_block"]):
            raise Refused("map_scans must fit the capacity in whole blocks")
        n_pool = int(traffic["pool_clouds"])
        req = int(traffic["request_clouds"])
        if n_pool % req:
            raise Refused("pool_clouds is not a whole number of requests")
        mp = W.route_poses(M, sp, route["amplitude_m"], route["wavelength_m"])
        at = ((np.arange(n_pool) + 0.5) * M / n_pool).astype(np.int64)
        qp = W.offset_poses(mp[at], float(traffic["lateral_m"]),
                            bool(traffic["reverse"]))
        world = W.make_world(seed, np.concatenate([mp, qp]),
                             cfg_file["world"], device)
        return dict(kind=kind, M=M, req=req, n_pool=n_pool, rate=rate,
                    map=W.Drive(seed, mp, world, cfg_file, SERVE_MAP),
                    queries=W.Drive(seed, qp, world, cfg_file, SERVE_QUERIES),
                    ts_map=np.arange(M) / rate, at=at)
    raise Refused(f"traffic kind {kind!r}")


class Window:
    """What the window did: per item (scan or request) its due time, the
    call's start and end and the wait's end (host clock, s); the records;
    the profile of the traced slice."""

    def __init__(self):
        self.due, self.start, self.called, self.done = [], [], [], []
        self.results = []
        self.pool_of = []         # serving: each request's first pool cloud
        self.items = 0            # scans or requests
        self.clouds = 0           # clouds served
        self.seconds = 0.0
        self.raw_profile = None   # the torch.profiler of the slice
        self.profile = None       # harness.trace.Profile of the slice
        self.slice = (0, 0)       # items [lo, hi) the profile covers
        self.prof_wall_s = 0.0    # the profiled slice's wall time

    def read_profile(self) -> None:
        """Parse the slice's profile, once the window has closed."""
        from harness.trace import Profile
        if self.raw_profile is not None:
            self.profile = Profile.of(self.raw_profile)
            self.raw_profile = None


def _build_in_blocks(db, drive, ts, block: int) -> None:
    for b in range(0, len(drive), block):
        pts = drive.clouds(b, b + block)
        db.block_chain_pts_async(pts[None], list(range(b, b + block)),
                                 [ts[b:b + block].tolist()])


def setup_stream(p: dict, cfg, cfg_file: dict, traffic: dict, device,
                 profile_warmup: bool):
    """The DB with its history built and warmed up, and the window's host
    clouds."""
    from contour_context_tpu_torch.db import ContourDB
    db = ContourDB(cfg, capacity=int(cfg_file["capacity"]), device=device)
    _build_in_blocks(db, p["hist"], p["ts_hist"],
                     int(traffic["history_block"]))
    host = p["post"].clouds(0, len(p["post"])).cpu()
    H = p["H"]
    for j in range(p["Wu"]):
        if profile_warmup and j == p["Wu"] - 1:
            # the profiler's first start is slow: pay it in set-up
            with torch.profiler.profile(activities=_activities(device)):
                db.step_async(host[j], H + j, float(p["ts_post"][j])).record()
        else:
            db.step_async(host[j], H + j, float(p["ts_post"][j])).record()
    return db, host


def setup_serve(p: dict, cfg, cfg_file: dict, traffic: dict, device,
                profile_warmup: bool):
    """The frozen map with its serving graphs captured, and the pool."""
    from contour_context_tpu_torch.db import ContourDB
    session = ContourDB(cfg, capacity=p["M"], device=device)
    _build_in_blocks(session, p["map"], p["ts_map"], int(traffic["map_block"]))
    served = ContourDB.merge([session])
    session.drop_graphs()
    del session
    pool = p["queries"].clouds(0, p["n_pool"]).cpu()
    req = p["req"]
    for k in range(2 if not profile_warmup else 3):
        if k == 2:
            with torch.profiler.profile(activities=_activities(device)):
                served.localize_block_async(pool[:req]).get()
        else:
            served.localize_block_async(pool[k * req:(k + 1) * req]).get()
    return served, pool


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _spans(prof, traced: bool):
    """An item's outer span: ITEM in the traced slice, MARGIN for the
    untraced items the profiler also sees, none outside the profile."""
    if traced:
        return torch.profiler.record_function(ITEM)
    if prof is not None:
        return torch.profiler.record_function(MARGIN)
    return contextlib.nullcontext()


def _span(traced: bool, name: str):
    """An inner span of a traced item."""
    return (torch.profiler.record_function(name) if traced
            else contextlib.nullcontext())


def run_stream(db, host, p: dict, trace: dict, device) -> Window:
    """The open-loop window: scan j due at t0 + j / rate_hz."""
    w = Window()
    H, off = p["H"], p["Wu"]
    n = p["n_win"]
    # the traced slice nearly ends the window, so the profiler's cost
    # delays no scan but the last; the profiler runs one scan before and
    # after the slice, so a late start or an early stop drops no record
    hi = max(1, n - 1)
    lo = max(1, hi - int(trace.get("items", 0))) if trace else hi
    period = 1.0 / float(p["rate_hz"])
    prof = None
    _sync(device)
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter() + 0.02
    for j in range(n):
        k = off + j
        if j == lo - 1 and hi > lo:
            prof = torch.profiler.profile(activities=_activities(device))
            prof.__enter__()
            prof_t0 = time.perf_counter()
        due = t0 + j * period
        sleep_until(due)
        traced = lo <= j < hi
        with _spans(prof, traced):
            c0 = time.perf_counter()
            with _span(traced, "bench.step_call"):
                h = db.step_async(host[k], H + k, float(p["ts_post"][k]))
            c1 = time.perf_counter()
            with _span(traced, "bench.record_wait"):
                r = h.record()
            c2 = time.perf_counter()
        w.due.append(due)
        w.start.append(c0)
        w.called.append(c1)
        w.done.append(c2)
        w.results.append(r)
        if prof is not None and j == hi:
            w.prof_wall_s = time.perf_counter() - prof_t0
            prof.__exit__(None, None, None)
            w.raw_profile = prof
            prof = None
    w.seconds = w.done[-1] - t0
    w.items = w.clouds = n
    w.slice = (lo, hi)
    w.read_profile()
    return w


def run_serve(served, pool, p: dict, seconds: float, trace: dict,
              device) -> Window:
    """The closed-loop window: the next request as soon as the last one's
    records are on the host, until `seconds` have passed."""
    w = Window()
    req, n_req_pool = p["req"], p["n_pool"] // p["req"]
    lo = max(1, int(trace.get("start", 0))) if trace else 0
    hi = lo + int(trace.get("items", 0)) if trace else 0
    prof = None
    _sync(device)
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    k = 0
    while True:
        if k == lo - 1 and hi > lo:
            prof = torch.profiler.profile(activities=_activities(device))
            prof.__enter__()
            prof_t0 = time.perf_counter()
        i = (k % n_req_pool) * req
        traced = lo <= k < hi
        with _spans(prof, traced):
            c0 = time.perf_counter()
            with _span(traced, "bench.serve_call"):
                bh = served.localize_block_async(pool[i:i + req])
            c1 = time.perf_counter()
            with _span(traced, "bench.records_wait"):
                res = bh.get()
            c2 = time.perf_counter()
        w.due.append(c0)
        w.start.append(c0)
        w.called.append(c1)
        w.done.append(c2)
        w.results.append(res)
        w.pool_of.append(i)
        k += 1
        if prof is not None and k == hi + 1:
            w.prof_wall_s = time.perf_counter() - prof_t0
            prof.__exit__(None, None, None)
            w.raw_profile = prof
            prof = None
        if c2 - t0 >= seconds and prof is None:
            break
    w.seconds = w.done[-1] - t0
    w.items = k
    w.clouds = k * req
    w.slice = (lo, min(hi, k))
    w.read_profile()
    return w
