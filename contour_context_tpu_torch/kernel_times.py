"""Device times of the port's CUDA kernels beside their bounds.

    python -m contour_context_tpu_torch.kernel_times [--reps 200]
        [--out FILE] [--compare ROOT ...] [--only cc_merge|dyn|lm|cascade]

Run from the repository root on a machine with a CUDA card (it renders a
scan with `tests/synth.py`). `chip_smoke.py` runs the same measurement in
its phase 3. For each kernel, at the main path's shapes:

- **device us, warm and cold**: the kernel's own duration, taken by name
  from torch.profiler's kernel records, mean over `--reps` launches; warm
  is back to back (the inputs stay in the 50 MB L2), cold has a 64 MB
  write between launches (the stream finds the store cold). The flush
  kernel has another name and is not counted;
- **call ms**: one wrapper call between two CUDA events after a sync,
  median of 20: the host (Python, ctypes) and the launch, not the kernel;
- **plain ms**: the plain torch version, timed the same way;
- **bound us**: the least time the card could take for the same work, the
  larger of the bytes the function must move (each input once, each output
  once) over 3.35 TB/s and its operations over their peak rate (fp32
  67 TFLOP/s; expf at the MUFU rate of 16 a clock on each SM, at the card's
  maximum SM clock from nvidia-smi), and the share of it each device time
  reaches;
- **launch floor**: the device time of a one-element fill, the least any
  launch costs on the device; beside it each kernel's own floor, its
  device time with nothing to do (an empty pool; searchable_n 0).

Ring: the 36 anchors x 4096-pixel pool of a scan of the smoke stream's
first pose. Batched ring (`measure_ring_batch`): the 16 scans of the smoke
stream's first block, B = 16 in one launch, beside the summed device time
of the 16 single launches of the same scans; `ring_batch_edge_cases` holds
it bit-equal to its plain version and to the single launches at B = 1, with
a zero cloud (a serving pad: an empty pool) in the batch, at B = 17, with
every pixel counting for every anchor, at pools of 1, 4095 and 4097 rows
and at 65535 anchors a scan.
Tile-min: a bf16 (6, 10, 49152) store (capacity 8192) at searchable_n 7000
(the fixture, a long drive) and 246 (the smoke stream's last scans, 3% of
capacity). Batched tile-min (`measure_batch`): the same store, B = 16
queries with searchable_b spread over 0, 246, 7000 and values between, its
device time beside the summed device time of the 16 single-query launches
that answer the same queries. `edge_cases` holds each kernel against its
plain version at the edge shapes and names the path each took.

The two kernels that take the JAX package's while-loops off the host
(`measure_cc`, `measure_merge`; `chip_smoke.py` phase 3d): the CC labels
of a scan's and a block's level masks and the proposal merge of one and of
16 revisit queries' inputs (`merge_case`, on a DB the caller holds), each
held bit-equal to its plain version first (`hold_cc`, `hold_merge`, also
on `adversarial_masks` and `merge_stress_cases`); the CC bound is its
bytes (masks in, labels out), the merge's the larger of its bytes (hint
rows and poses in, proposals out) and its serial chain (the longest row's
hints, MERGE_CHAIN_STEPS dependent steps each, one a clock:
`merge_chain_bound`). `cc_merge_rows` runs both on the smoke stream's
inputs (`cc_merge_cases`: the stream is rebuilt here, `stream_case`) for
this checkout and every `--compare` checkout in turns, and splits each by
phase (`cc_phase_split`, `merge_phase_split`: clock64 stamps that thread
0 of each CTA writes at the phase boundaries, from the measurement-only C
entry `cc_<kernel>_phases` built from the same source; the main path
never calls it; a checkout without it gets no split); `--only cc_merge`
stops there. `cascade_case` counts what the cascade's columns past each
query's own chunks cost a call (device ops and busy time of every column
against the own chunks' columns).

The two `dynamic_thres` kernels (`measure_dyn_pass`, `measure_dyn_post`;
`chip_smoke.py` phase 9): the inputs the query path hands them for a
revisit query and a block of 16 (`dyn_cases`, on a DB the caller holds),
each held bit-equal to its plain version first (`hold_dyn_pass`,
`hold_dyn_post`, also at `dyn_edge_cases`); their bound is the larger of
their bytes and ceil(log2 H) dependent steps (H hints or candidates a
row: a row's last output depends on all H steps' inputs), one a clock at
the card's maximum SM clock (`dyn_bound`). `dyn_rows` runs
both on phase 9's inputs (`dyn_stream_cases`: its 64-scan DB is rebuilt
here) and on the rows where every step is a rise (`dyn_worst_cases`), for
this checkout and every `--compare` checkout in turns, and splits each by
phase with the walk's ballot rounds (`dyn_phase_split`: clock64 stamps of
lane 0 of each row's warp from the measurement-only entries
`cc_dyn_pass_scan_phases` / `cc_dyn_post_scan_phases`); `--only dyn`
stops there.

The LM kernel (`measure_lm`, `lm_rows`; `--only lm` stops there): the
inputs the query path hands `optimize_correlation` (`lm_case`) for one
revisit query (10 rows) and for 16 (160 rows) on the smoke stream's DB,
held bit-equal to the plain twin run on the card (`hold_lm`), timed beside
the twin's call and the call of the torch chain it replaced
(`lm_torch_chain`); its bound is the larger of its bytes, its operations
(flops at the fp32 rate plus expf at the MUFU rate, over the close pairs
that the function needs) and the chain of its iterations (`lm_bound`). A `--compare` checkout has no LM kernel: the
chain's time stands for it.

The cascade kernel (`measure_cascade`, `cascade_rows_of`; `--only
cascade` stops there): held bit-equal to its plain twin run on the card
at the rows made to take each edge (`cascade_edge_case`, p_pot 8, 128 and
None), then on the hint rows of one revisit query (B 1, 256 rows) and of
16 (B 16, 4,096 rows) on the smoke stream's DB (`cascade_inputs`), timed
beside the twin's call, with the device ops and busy ms of a call against
the twin's; its bound (`cascade_bound`) is the larger of its bytes (each
computed row's hint values, two neighbour rows and two tab12 tables read
once, every row's outputs written once), its operations and its chain of
CASCADE_CHAIN_STEPS dependent steps.

Then `scaling_rows`: both batched kernels across the sizes their paths
give them (the ring at B = 1-64 and at 9-36 anchors, the tile-min at B =
4-64 and on a capacity-65536 map), each beside its bytes, operations,
bound and share. `--compare ROOT ...` times the kernels of other
checkouts (an unpacked commit: `git archive <commit> | tar -x -C ROOT`, in
a gitignored directory) through the same scaling, CC, merge and dynamic
scan rows in the same process, in turns, for an A/B on one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from contour_context_tpu_torch.config import PipelineConfig
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.ops import gmm
from contour_context_tpu_torch.ops import kernels
from contour_context_tpu_torch.ops.cascade import P_POT
from contour_context_tpu_torch.utils.io import pad_points

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
MUFU_PER_CLK_SM = 16          # expf (ex2) results a clock on each SM, cc 9.0
FLUSH_BYTES = 64 << 20        # > the 50 MB L2
TILE_SN = (7000, 246)         # searchable_n: the fixture, the stream's end
REPLACES = "contour_context_tpu/ops/pallas_kernels.py"


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def call_ms(fn, reps: int = 20) -> float:
    """Median over reps of one call of fn between two CUDA events, after a
    sync and 3 warm-up calls: host + launch for a small kernel."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_durations_us(prof, name: str, window: Optional[str] = None) -> list:
    """Device durations (us) of the CUDA kernels whose name holds *name* in
    a torch.profiler profile, one per launch the profiler recorded, in the
    order the launches started. With *window*, the name of a
    `torch.profiler.record_function` range of the profile, only the kernels
    that started inside that range count: the profiler can hand a record
    of an earlier profile to a later one, and such a record lies outside."""
    evs = prof.events()
    lo, hi = -np.inf, np.inf
    if window is not None:
        span = next(e.time_range for e in evs if e.name == window and
                    e.device_type == torch.autograd.DeviceType.CPU)
        lo, hi = span.start, span.end
    ks = sorted((e for e in evs
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and name in e.name and lo <= e.time_range.start <= hi),
                key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() for e in ks]


LEAD_CALLS = 10          # calls of fn that open each profiled window
WINDOW = "kernel_times.window"


def device_us(fn, name: str, reps: int, cold: bool, per_call: int = 1) -> float:
    """Mean device duration (us) a call of fn spends in the kernels named
    *name* (per_call launches a call, summed), over reps calls, from
    torch.profiler's kernel records; cold writes 64 MB between calls. Each
    profiled window opens with lead calls made the same way, and only
    records that started inside the window count. The profiler can lose
    records (seen on the H100: 199 or 10 of 200 kept; 49 of 50 again and
    again in one short window), so only whole calls are averaged: at
    per_call 1 a record is a whole call, and the mean is over the last reps
    records if the window kept at least reps; at per_call > 1 a lost record
    cannot be told to its call, and a window is taken only if it kept every
    record of its lead + reps calls. Any other window is reported on
    stderr, never averaged, and profiled again, at most five times, each
    time with LEAD_CALLS more lead calls (one H100 run kept 197 of a fast
    kernel's 210 records again and again: a longer window keeps more)."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda") \
        if cold else None
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(5):
        lead = LEAD_CALLS * (1 + attempt)
        n_all = (lead + reps) * per_call
        least = reps if per_call == 1 else n_all
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                for i in range(lead + reps):
                    if flush is not None:
                        flush.fill_(i)
                    fn()
                torch.cuda.synchronize()
        durs = kernel_durations_us(prof, name, WINDOW)
        if least <= len(durs) <= n_all:
            return float(np.sum(durs[-reps * per_call:])) / reps
        n_out = len(kernel_durations_us(prof, name)) - len(durs)
        print(f"torch.profiler kept {len(durs)} records of {name} in the "
              f"window ({n_out} outside), {least}-{n_all} wanted: profiling "
              "again", file=sys.stderr, flush=True)
    raise RuntimeError(f"profiler saw {len(durs)} launches of {name} in the "
                       f"window, wanted {least}-{n_all}")


def _bound(n_bytes: float, t_ops_s: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (1e6 * max(t_bytes, t_ops_s),
            "bytes" if t_bytes >= t_ops_s else "operations")


def ring_bound(anchors, pool, centers, counts, sms: int, clk_hz: float):
    """(bound us, bound_by, exps, bytes) of ring_key_divs or, for (B, ...)
    inputs, ring_key_divs_batch: each input read once, divs and counts
    written once; one expf per (counted pixel, division), summed over the
    batch."""
    out_bytes = 4 * (anchors.numel() // 8) * (kernels.N_DIV + 1)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (anchors, pool, centers)) + out_bytes
    exps = float(counts.sum()) * kernels.N_DIV
    return _bound(n_bytes, exps / (MUFU_PER_CLK_SM * sms * clk_hz)) + (
        exps, n_bytes)


def tilemin_bound(keys_q, q, state):
    """(bound us, bound_by) of search_tilemin: only the searchable columns'
    keys need reading (Q levels x 10 dims), the query and the state once,
    the tile minima written once; 30 flops per (level, anchor, column)."""
    L, D, NA = keys_q.shape
    Q, A, _ = q.shape
    cols = min(NA, int(state[1]) * A)
    n_tiles = -(-NA // kernels.TILE)
    n_bytes = (Q * D * cols * keys_q.element_size() + q.numel() * 4 + 8
               + Q * A * n_tiles * 4)
    return _bound(n_bytes, 3 * D * Q * A * cols / FP32_FLOPS)


def tilemin_batch_bound(keys_q, q_b, searchable_b):
    """(bound us, bound_by, bytes, flops) of search_tilemin_batch: the keys
    of the columns searchable for any query read once (Q levels x 10 dims),
    the B queries and limits once, the B outputs written once; 30 flops per
    (query, level, anchor, column searchable for that query)."""
    L, D, NA = keys_q.shape
    B, Q, A, _ = q_b.shape
    cols_b = [min(NA, max(0, int(sn)) * A) for sn in searchable_b.tolist()]
    n_tiles = -(-NA // kernels.TILE)
    n_bytes = (Q * D * max(cols_b) * keys_q.element_size() + q_b.numel() * 4
               + 4 * B + B * Q * A * n_tiles * 4)
    flops = 3 * D * Q * A * sum(cols_b)
    return _bound(n_bytes, flops / FP32_FLOPS) + (n_bytes, flops)


BATCH_SN = (0, 246, 7000, 1, 100, 500, 1000, 2000, 3000, 4000, 5000, 6000,
            6500, 6999, 7000, 7000)   # searchable_b of the B = 16 fixture


def batch_queries(B: int, seed: int = 1):
    """(B, 6, 6, 10) f32 query keys with one invalid anchor in query 1."""
    qk = np.random.default_rng(seed).uniform(
        0.1, 5.0, (B, 6, 6, 10)).astype(np.float32)
    qk[1 % B, 2, 3] = 0.0
    return qk


def hold_batch(keys_q, q_levels, q_b, searchable_b, what: str) -> float:
    """One `search_tilemin_batch` launch against its plain version on the
    same tensors: raises unless the two are bit-equal, returns the largest
    absolute difference it measured (0.0 then)."""
    t_k = kernels.search_tilemin_batch(keys_q, q_levels, q_b, searchable_b)
    t_p = kernels.search_tilemin_batch_plain(keys_q, q_levels, q_b,
                                             searchable_b)
    err = float((t_k - t_p).abs().max())
    assert torch.equal(t_k, t_p), \
        f"batched tile minima differ ({what}): max abs err {err}"
    return err


def ring_inputs_of(points_b, cfg: PipelineConfig):
    """anchors (B, 36, 8), pool (B, 4096, 8) and the centres (35,) of the
    clouds points_b (B, P, 4), built on their device by the port's
    descriptor stages."""
    cm = cfg.cm
    bev, rowf, colf = td.rasterize_bev(points_b, cm)
    masks = td.level_masks(bev, cm)
    tab = td.component_tables(td.cc_labels(masks), masks.flatten(-2), bev,
                              rowf, colf, cm)
    return td.ring_inputs(tab, bev, rowf, colf, cm)[:3]


def _world():
    """bench.py's world and tests/synth.py's render_scan."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_world, render_scan

    return make_world(1, n_structs=300, extent=400.0), render_scan


def ring_case(dev, cfg: PipelineConfig):
    """anchors (36, 8), pool (4096, 8), centres of a scan of the smoke
    stream's first pose (seed 1), built on dev by the port's descriptor
    stages."""
    from contour_context_tpu_torch.profile_step import lane_poses

    world, render_scan = _world()
    pts = torch.from_numpy(pad_points(
        render_scan(world, lane_poses(0, 1)[0], seed=1), cfg.cm.max_points))
    anchors, pool, centers = ring_inputs_of(pts[None].to(dev), cfg)
    return anchors[0], pool[0], centers


def ring_block_case(dev, cfg: PipelineConfig, B: int = 16):
    """anchors (B, 36, 8), pool (B, 4096, 8), centres of the smoke stream's
    first B scans (`stream_clouds`, B at most a lane's 132), and the same
    of one all-zero cloud (a serving pad), built on dev."""
    pts = np.stack(stream_clouds(cfg, range(B)))
    block = ring_inputs_of(torch.from_numpy(pts).to(dev), cfg)
    zero = ring_inputs_of(torch.zeros((1,) + pts.shape[1:], device=dev), cfg)
    return block, zero


def hold_ring_batch(anchors_b, pool_b, centers, roi: float,
                    what: str) -> float:
    """One `ring_key_divs_batch` launch against its plain version and
    against one `ring_key_divs` launch a scan, on the same tensors: raises
    unless all three are bit-equal (divs and counts), returns the largest
    absolute difference it measured (0.0 then)."""
    d_k, c_k = kernels.ring_key_divs_batch(anchors_b, pool_b, centers, roi)
    d_p, c_p = kernels.ring_key_divs_batch_plain(anchors_b, pool_b, centers,
                                                 roi)
    ones = [kernels.ring_key_divs(a, p, centers, roi)
            for a, p in zip(anchors_b, pool_b)]
    err = float((d_k - d_p).abs().max())
    assert torch.equal(d_k, d_p) and torch.equal(c_k, c_p), \
        f"batched ring sums differ from the plain version ({what}): " \
        f"max abs err {err}"
    for b, (d1, c1) in enumerate(ones):
        assert torch.equal(d_k[b], d1) and torch.equal(c_k[b], c1), \
            f"batched ring row {b} differs from its single launch ({what})"
    return err


def tile_store(N: int, seed: int = 0):
    """(N, 6, 6, 10) f32 keys with zero rows and duplicated keys, and a
    (6, 6, 10) query with one invalid anchor (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    kb = rng.uniform(0.1, 5.0, (N, 6, 6, 10)).astype(np.float32)
    kb[::7] = 0.0                       # zero rows
    if N >= 400:
        kb[100:200] = kb[300:400]       # duplicated keys -> distance ties
    qk = rng.uniform(0.1, 5.0, (6, 6, 10)).astype(np.float32)
    qk[2, 3] = 0.0                      # an invalid query anchor
    return kb, qk


def q_layout(kb, dtype, dev, offset: int = 0):
    """keys_to_q_layout of kb on dev; offset > 0 starts the store that many
    elements into its buffer, so its base is not 16-byte aligned."""
    from contour_context_tpu_torch.db import keys_to_q_layout

    kq = keys_to_q_layout(torch.from_numpy(kb), dtype).contiguous()
    if not offset:
        return kq.to(dev)
    buf = torch.empty(kq.numel() + offset, dtype=kq.dtype, device=dev)
    out = buf[offset:].view(kq.shape)
    out.copy_(kq)
    return out


def _measure(kernel_fn, plain_fn, name, reps):
    return {"device_us_warm": device_us(kernel_fn, name, reps, cold=False),
            "device_us_cold": device_us(kernel_fn, name, reps, cold=True),
            "ms": call_ms(kernel_fn), "plain_ms": call_ms(plain_fn)}


def _shares(row):
    row["share_of_bound"] = row["bound_us"] / row["device_us_cold"]
    row["share_of_bound_warm"] = row["bound_us"] / row["device_us_warm"]
    row["bound_ms"] = row["bound_us"] / 1e3
    return row


def launch_floor_us(dev, reps: int = 200) -> float:
    """Device time of a near-empty kernel (a one-element fill): the
    device-side cost of any launch, beside which the kernels are read."""
    x = torch.zeros(1, device=dev)
    return device_us(lambda: x.fill_(1.0), "elementwise_kernel", reps,
                     cold=False)


def measure(dev, cfg: PipelineConfig, reps: int = 200) -> list:
    """The kernel rows (dicts) at the main path's shapes; each kernel is
    held against its plain version first."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clk = max_sm_clock_hz()
    roi = cfg.cm.roi_radius
    anchors, pool, centers = ring_case(dev, cfg)
    d_k, c_k = kernels.ring_key_divs(anchors, pool, centers, roi)
    d_p, c_p = kernels.ring_key_divs_plain(anchors, pool, centers, roi)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p) and torch.equal(c_k, c_p)
    assert float(c_p.sum()) > 0
    b_us, b_by, exps, _ = ring_bound(anchors, pool, centers, c_p, sms, clk)
    empty = pool[:0]
    ring_empty_us = device_us(
        lambda: kernels.ring_key_divs(anchors, empty, centers, roi),
        "ring_key_divs_kernel", reps, cold=False)
    ring = dict(
        name="ring_key_divs", route="cuda",
        source="contour_context_tpu_torch/csrc/ring_key.cu",
        replaces=REPLACES + ":40", shape=f"anchors {tuple(anchors.shape)} "
        f"pool {tuple(pool.shape)}", counted_pixels=int(c_p.sum()),
        exps=exps, max_abs_err=float((d_k - d_p).abs().max()),
        bound_us=b_us, bound_by=b_by, library_ms=None,
        empty_pool_us_warm=ring_empty_us,
        **_measure(lambda: kernels.ring_key_divs(anchors, pool, centers, roi),
                   lambda: kernels.ring_key_divs_plain(anchors, pool,
                                                       centers, roi),
                   "ring_key_divs_kernel", reps))

    kb, qk = tile_store(8192)
    ql = tuple(cfg.db.q_levels)
    kq = q_layout(kb, torch.bfloat16, dev)
    q = torch.from_numpy(qk[list(ql)]).to(dev)
    rows = {}
    for sn in TILE_SN:
        state = torch.tensor([8192, sn], dtype=torch.int32, device=dev)
        t_k = kernels.search_tilemin(kq, ql, q, state)
        t_p = kernels.search_tilemin_plain(kq, ql, q, state)
        torch.cuda.synchronize()
        assert torch.equal(t_k, t_p), f"tile minima differ at sn {sn}"
        b_us, b_by = tilemin_bound(kq, q, state)
        rows[sn] = _shares(dict(
            shape=f"keys_q {tuple(kq.shape)} bf16, searchable_n {sn}",
            path=kernels.search_tilemin_path(kq),
            max_abs_err=float((t_k - t_p).abs().max()),
            bound_us=b_us, bound_by=b_by,
            **_measure(lambda: kernels.search_tilemin(kq, ql, q, state),
                       lambda: kernels.search_tilemin_plain(kq, ql, q, state),
                       "search_tilemin_kernel", reps)))
    tile = dict(name="search_tilemin", route="cuda",
                source="contour_context_tpu_torch/csrc/search_tilemin.cu",
                replaces=REPLACES + ":112", library_ms=None,
                **rows[TILE_SN[0]])
    tile["stream"] = rows[TILE_SN[1]]
    state = torch.tensor([8192, 0], dtype=torch.int32, device=dev)
    tile["empty_us_warm"] = device_us(
        lambda: kernels.search_tilemin(kq, ql, q, state),
        "search_tilemin_kernel", reps, cold=False)
    return [_shares(ring), tile]


def measure_batch(dev, cfg: PipelineConfig, reps: int = 200) -> dict:
    """The batched tile-min's row at the fixture (bf16 capacity 8192, B = 16,
    searchable_b = BATCH_SN), held bit-equal to its plain version first,
    with the 16 single-query launches of the same queries beside it."""
    kb, _ = tile_store(8192)
    ql = tuple(cfg.db.q_levels)
    kq = q_layout(kb, torch.bfloat16, dev)
    B = len(BATCH_SN)
    q_b = torch.from_numpy(batch_queries(B)[:, list(ql)]).to(dev).contiguous()
    sb = torch.tensor(BATCH_SN, dtype=torch.int32, device=dev)
    states = [torch.tensor([8192, sn], dtype=torch.int32, device=dev)
              for sn in BATCH_SN]
    err = hold_batch(kq, ql, q_b, sb, "fixture")

    def singles():
        for b in range(B):
            kernels.search_tilemin(kq, ql, q_b[b], states[b])

    def batch():
        kernels.search_tilemin_batch(kq, ql, q_b, sb)

    b_us, b_by, n_bytes, flops = tilemin_batch_bound(kq, q_b, sb)
    row = dict(
        name="search_tilemin_batch", route="cuda",
        source="contour_context_tpu_torch/csrc/search_tilemin.cu",
        replaces=REPLACES + ":112", library_ms=None,
        shape=f"keys_q {tuple(kq.shape)} bf16, B {B}, searchable_b "
        f"{min(BATCH_SN)}..{max(BATCH_SN)}",
        path=kernels.search_tilemin_path(kq), max_abs_err=err,
        bytes=n_bytes, flops=flops, bound_us=b_us, bound_by=b_by,
        **_measure(batch, lambda: kernels.search_tilemin_batch_plain(
            kq, ql, q_b, sb), "search_tilemin_batch_kernel", reps),
        singles_us_warm=device_us(singles, "search_tilemin_kernel", reps,
                                  cold=False, per_call=B),
        singles_us_cold=device_us(singles, "search_tilemin_kernel", reps,
                                  cold=True, per_call=B),
        singles_ms=call_ms(singles))
    return _shares(row)


def measure_ring_batch(dev, cfg: PipelineConfig, case=None,
                       reps: int = 200) -> dict:
    """The batched ring's row at the smoke stream's first block of 16
    (`ring_block_case`, or `case` as it returns), held bit-equal to its
    plain version and to the 16 single launches first, with the 16 single
    launches' device and call times beside it."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clk = max_sm_clock_hz()
    roi = cfg.cm.roi_radius
    (anchors, pool, centers), _ = case or ring_block_case(dev, cfg)
    B = anchors.shape[0]
    err = hold_ring_batch(anchors, pool, centers, roi,
                          "the smoke stream's first block")
    _, c_p = kernels.ring_key_divs_batch_plain(anchors, pool, centers, roi)
    b_us, b_by, exps, n_bytes = ring_bound(anchors, pool, centers, c_p, sms,
                                           clk)

    def batch():
        kernels.ring_key_divs_batch(anchors, pool, centers, roi)

    def singles():
        for b in range(B):
            kernels.ring_key_divs(anchors[b], pool[b], centers, roi)

    row = dict(
        name="ring_key_divs_batch", route="cuda",
        source="contour_context_tpu_torch/csrc/ring_key.cu",
        replaces=REPLACES + ":40", library_ms=None,
        shape=f"anchors {tuple(anchors.shape)} pool {tuple(pool.shape)}",
        counted_pixels=int(c_p.sum()), exps=exps, bytes=n_bytes,
        max_abs_err=err, bound_us=b_us, bound_by=b_by,
        **_measure(batch, lambda: kernels.ring_key_divs_batch_plain(
            anchors, pool, centers, roi), "ring_key_divs_kernel", reps),
        singles_us_warm=device_us(singles, "ring_key_divs_kernel", reps,
                                  cold=False, per_call=B),
        singles_us_cold=device_us(singles, "ring_key_divs_kernel", reps,
                                  cold=True, per_call=B),
        singles_ms=call_ms(singles))
    return _shares(row)


def ring_worst_case(dev, B: int = 2, A8: int = 36, P: int = 4096):
    """anchors (B, A8, 8), pool (B, P, 8) in which every pixel counts for
    every anchor (all ok, all inside every box and within the radius), and
    ring_inputs' centres: the most hits the kernel can meet (numpy, from a
    seed)."""
    rng = np.random.default_rng(7)
    an = np.zeros((B, A8, 8), np.float32)
    an[..., :2] = 75.0 + rng.uniform(-0.5, 0.5, (B, A8, 2))
    an[..., 3] = an[..., 5] = 149.0
    an[..., 6] = 1.0
    pool = np.zeros((B, P, 8), np.float32)
    pool[..., 2:4] = 75.0 + rng.uniform(-6.0, 6.0, (B, P, 2))
    pool[..., :2] = np.floor(pool[..., 2:4])
    pool[..., 4] = rng.integers(1, 5, (B, P))
    pool[..., 5] = 1.0
    centers = (np.arange(kernels.N_DIV, dtype=np.float32) + 0.5) * \
        np.float32(10.0 / kernels.N_DIV)
    return tuple(torch.from_numpy(x).to(dev) for x in (an, pool, centers))


def ring_random_case(dev, B: int, A8: int, P: int, seed: int = 0):
    """anchors (B, A8, 8) with 22x22 boxes and a pool (B, P, 8) of random
    pixels, 80% ok, on the 150x150 grid (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    an = np.zeros((B, A8, 8), np.float32)
    an[..., :2] = rng.uniform(20, 130, (B, A8, 2))
    an[..., 2], an[..., 3] = an[..., 0] - 11, an[..., 0] + 11
    an[..., 4], an[..., 5] = an[..., 1] - 11, an[..., 1] + 11
    an[..., 6] = 1.0
    pool = np.zeros((B, P, 8), np.float32)
    pool[..., 2:4] = rng.uniform(0, 150, (B, P, 2))
    pool[..., :2] = np.floor(pool[..., 2:4])
    pool[..., 4] = rng.integers(0, 5, (B, P))
    pool[..., 5] = rng.random((B, P)) < 0.8
    return torch.from_numpy(an).to(dev), torch.from_numpy(pool).to(dev)


def ring_batch_edge_cases(dev, cfg: PipelineConfig, case=None) -> list:
    """The batched ring against its plain version and its single launches,
    bit for bit: B = 1, a zero cloud (an empty pool) inside a batch, B = 17
    (the block and the zero cloud), every pixel counting for every anchor,
    pools of 1, 4095 and 4097 rows (no multiple of the cluster's split) and
    65535 anchors a scan. Raises on the first mismatch; returns one line
    per case."""
    roi = cfg.cm.roi_radius
    (anchors, pool, centers), (za, zp, _) = case or ring_block_case(dev, cfg)
    cases = [("B 1", anchors[:1], pool[:1], centers),
             ("B 3, a zero cloud in row 1", torch.cat([anchors[:1], za,
                                                       anchors[1:2]]),
              torch.cat([pool[:1], zp, pool[1:2]]), centers),
             ("B 17", torch.cat([anchors, za]), torch.cat([pool, zp]),
              centers)]
    wa, wp, wc = ring_worst_case(dev)
    cases.append(("B 2, every pixel counting for every anchor", wa, wp, wc))
    for P in (1, 4095, 4097):
        a, p = ring_random_case(dev, 2, 36, P, seed=P)
        cases.append((f"B 2, P {P}", a, p, centers))
    a, p = ring_random_case(dev, 2, 65535, 64, seed=5)
    cases.append(("B 2, 65535 anchors, P 64", a, p, centers))
    lines = []
    for label, a, p, c in cases:
        hold_ring_batch(a, p, c, roi, label)
        torch.cuda.synchronize()
        lines.append(f"ring_key_divs_batch {label}: bit-equal to the plain "
                     "version and to one single launch a scan")
    assert not zp[0, :, 5].any()
    return lines


def batch_edge_cases(dev, cfg: PipelineConfig) -> list:
    """The batched tile-min against its plain version at the edge shapes:
    bf16 and f32, the vector path and the scalar path (NA 390), B = 1 equal
    to the single-query kernel, B = 16 with mixed limits. Raises on the
    first mismatch; returns one line per case."""
    ql = tuple(cfg.db.q_levels)
    lines = []
    for N, sns in ((8192, BATCH_SN), (65, (0, 1, 33, 65, 64, 2))):
        kb, _ = tile_store(N, seed=N)
        q_b = torch.from_numpy(batch_queries(len(sns), seed=N)[:, list(ql)]) \
            .to(dev).contiguous()
        sb = torch.tensor(sns, dtype=torch.int32, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            kq = q_layout(kb, dtype, dev)
            t_k = kernels.search_tilemin_batch(kq, ql, q_b, sb)
            t_p = kernels.search_tilemin_batch_plain(kq, ql, q_b, sb)
            one = kernels.search_tilemin_batch(kq, ql, q_b[2:3], sb[2:3])
            single = kernels.search_tilemin(
                kq, ql, q_b[2], torch.tensor([N, sns[2]], dtype=torch.int32,
                                             device=dev))
            torch.cuda.synchronize()
            label = f"NA {kq.shape[2]} {str(dtype)[6:]} B {len(sns)}"
            assert torch.equal(t_k, t_p), f"batched tile minima differ: {label}"
            assert torch.equal(one[0], single) and torch.equal(one[0], t_k[2]), \
                f"B = 1 differs from the single-query kernel: {label}"
            lines.append(f"search_tilemin_batch {label}: "
                         f"{kernels.search_tilemin_path(kq)} path, bit-equal "
                         "to the plain version; B 1 equals the single-query "
                         "kernel")
    return lines


def edge_cases(dev, cfg: PipelineConfig) -> list:
    """Each kernel against its plain version at the edge shapes (ring: a
    pool length that is no multiple of the block, an anchor whose box is
    empty; tile-min: searchable_n 0, 1, mid-store and full, NA % 8 != 0
    and a base off 16-byte alignment, bf16 and f32). Raises on the first
    mismatch; returns one line per case naming the path it took."""
    roi = cfg.cm.roi_radius
    anchors, pool, centers = ring_case(dev, cfg)
    empty = anchors.clone()
    empty[0, 2], empty[0, 3] = 1.0, 0.0          # r_min > r_max: no pixel
    lines = []
    for label, a, p in (("P 4096", anchors, pool),
                        ("P 4001, anchor 0 box empty", empty, pool[:4001]),
                        ("P 37", anchors, pool[:37].clone())):
        d_k, c_k = kernels.ring_key_divs(a, p, centers, roi)
        d_p, c_p = kernels.ring_key_divs_plain(a, p, centers, roi)
        torch.cuda.synchronize()
        assert torch.equal(d_k, d_p) and torch.equal(c_k, c_p), label
        lines.append(f"ring_key_divs {label}: bit-equal to the plain "
                     "version")
    ql = tuple(cfg.db.q_levels)
    for N, sns, offset in ((8192, (0, 1, 7000, 8192), 0), (65, (0, 1, 33, 65), 0),
                           (8192, (7000,), 1)):
        kb, qk = tile_store(N, seed=N)
        q = torch.from_numpy(qk[list(ql)]).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            kq = q_layout(kb, dtype, dev, offset)
            for sn in sns:
                state = torch.tensor([N, sn], dtype=torch.int32, device=dev)
                t_k = kernels.search_tilemin(kq, ql, q, state)
                t_p = kernels.search_tilemin_plain(kq, ql, q, state)
                torch.cuda.synchronize()
                label = (f"NA {kq.shape[2]} {str(dtype)[6:]} base+{offset} "
                         f"searchable_n {sn}")
                assert torch.equal(t_k, t_p), f"tile minima differ: {label}"
                lines.append(f"search_tilemin {label}: "
                             f"{kernels.search_tilemin_path(kq)} path, "
                             "bit-equal")
    return lines


# ---------------------------------------------------------------------------
# the two kernels that take the JAX package's while-loops off the host
# ---------------------------------------------------------------------------

CC_REPLACES = "contour_context_tpu/ops/descriptor.py:280"
MERGE_REPLACES = "contour_context_tpu/ops/candidate.py:234"


def adversarial_masks(nr: int = 150, nc: int = 150) -> dict:
    """{name: (nr, nc) bool} masks that stress a CC labelling (numpy): a
    spiral one pixel wide (one component whose path winds through the
    whole mask), a comb (teeth joined by a spine along the last row), a
    checkerboard (8-connected: one component), full, empty, a diagonal
    staircase (8-connected steps only), a random field at density 0.5, and
    three that stress the kernel's strips of rows: a U whose two arms join
    only in the last rows (the minimum in the first strip, the join in the
    last), a vertical serpentine one pixel wide whose every turn crosses
    all strips, and two interleaved combs (teeth on alternate columns, one
    comb's spine on the first row, the other's on the last): two
    components that both cross every strip."""
    spiral = np.zeros((nr, nc), bool)
    r0, c0, r1, c1 = 0, 0, nr - 1, nc - 1
    while r0 <= r1 and c0 <= c1:
        spiral[r0, c0:c1 + 1] = True
        spiral[r0:r1 + 1, c1] = True
        if r1 - r0 >= 2:
            spiral[r1, c0:c1 + 1] = True
        if c1 - c0 >= 2:
            spiral[r0 + 2:r1 + 1, c0] = True
        if r0 + 2 <= r1 and c0 + 2 <= c1:
            spiral[r0 + 2, c0:c0 + 2] = True
        r0, c0, r1, c1 = r0 + 2, c0 + 2, r1 - 2, c1 - 2
    comb = np.zeros((nr, nc), bool)
    comb[:, ::2] = True
    comb[-1] = True
    ii, jj = np.indices((nr, nc))
    stair = (ii == jj) | (ii == jj + 1)
    stair[:, 1::2] &= ii[:, 1::2] == jj[:, 1::2]
    u = np.zeros((nr, nc), bool)
    w = max(1, nc // 16)
    a, b = nc // 4, max(nc // 4 + w + 1, 3 * nc // 4)
    u[:, a:a + w] = u[:, b:b + w] = True
    u[nr - max(1, nr // 16):, a:b + w] = True
    serp = np.zeros((nr, nc), bool)
    serp[:, ::2] = True
    serp[-1, 1::4] = True                   # turns at the bottom
    serp[0, 3::4] = True                    # and at the top
    combs = np.zeros((nr, nc), bool)
    combs[:nr - 2, ::4] = True              # comb 1: teeth from the top
    combs[0] = True                         # and its spine
    combs[2:, 2::4] = True                  # comb 2: teeth to the bottom
    combs[-1] = True                        # and its spine
    return {"spiral": spiral, "comb": comb,
            "checkerboard": (ii + jj) % 2 == 0,
            "full": np.ones((nr, nc), bool),
            "empty": np.zeros((nr, nc), bool),
            "staircase": ii == jj,
            "staircase, two wide": stair,
            "random": np.random.default_rng(5).random((nr, nc)) < 0.5,
            "U, joined in the last rows": u, "serpentine": serp,
            "two interleaved combs": combs}


def merge_stress_cases(MP: int = 128, C: int = 32) -> dict:
    """{name: (hint_of (B, C, MP) int32, T (B, MP, 3) f32, votes (B, MP)
    int32)} (numpy) merge inputs that stress the walk's lanes: C = 32 rows
    is one warp a query, each hint in one row, poses in clusters a few
    cells apart (some merge, some open a proposal, some overflow the four
    slots), votes 1-8:
    - "ragged warp": the lanes' trip counts far apart: query 0's rows hold
      0, 1, ..., 15 hints and the rest; query 1's rows lengths halving
      from MP / 2 (64, 32, ..., 1, 0, ...); query 2 one row of all MP;
    - "full row": query 0's first row and query 1's last row hold all MP
      hints (the walk reads every id of the row), every other row none;
    - "across the wrap": every hint's angle within 0.1 of +-pi, the sign
      drawn at random, so matches and merged angles cross the wrap;
    - "at the radius": rows of four hints, the last three within 2^-16 of
      the merge radius (2 cells) from the first, so their squared norms
      fall in the band where the kernel asks hypotf itself;
    - "subnormal poses": the ragged rows with every position under 2^-126,
      so the merged poses are subnormal and the kernel divides with
      __fdiv_rn itself."""
    rng = np.random.default_rng(MP + C)

    def poses(B, theta, scale=1.0):
        T = np.zeros((B, MP, 3), np.float32)
        T[..., :2] = (rng.integers(0, 3, (B, MP, 2)) * 3.0 +
                      rng.normal(0, 0.6, (B, MP, 2))) * scale
        T[..., 2] = theta(B)
        return T, rng.integers(1, 9, (B, MP)).astype(np.int32)

    def rows_of(lengths):
        """hint_of (C, MP) whose row c holds lengths[c] hints, drawn
        without replacement"""
        perm = rng.permutation(MP)
        h = np.full((C, MP), -1, np.int32)
        at = 0
        for c, n in enumerate(lengths):
            h[c, :n] = perm[at:at + n]
            at += n
        return h

    def lengths(ns):
        return list(ns) + [0] * (C - len(ns))

    near0 = lambda B: rng.choice([-3.1, 0.0, 3.1], (B, MP)) + \
        rng.normal(0, 0.12, (B, MP))
    ramp = list(range(16))
    ragged = np.stack([
        rows_of(lengths(ramp + [MP - sum(ramp)])),
        rows_of(lengths([MP >> (k + 1) for k in range(8)])),
        rows_of(lengths([0, 0, 0, MP]))])
    full = np.stack([rows_of(lengths([MP])), rows_of([0] * (C - 1) + [MP])])
    wrap = np.stack([rows_of(lengths([MP // 8] * 8)) for _ in range(2)])
    sign = lambda B: np.where(rng.random((B, MP)) < 0.5, -1.0, 1.0)
    rad = rows_of(lengths([4] * min(C, MP // 4)))[None]
    T_rad, v_rad = poses(1, near0)
    for ids in rad[0, :, :4]:
        if ids[0] < 0:
            continue
        x0, y0 = T_rad[0, ids[0], :2]
        for i in ids[1:]:
            phi = rng.uniform(-np.pi, np.pi)
            d = kernels.TF_TRANS_MERGE * (1 + rng.uniform(-1, 1) * 2.0 ** -16)
            T_rad[0, i] = (x0 + d * np.cos(phi), y0 + d * np.sin(phi),
                           T_rad[0, ids[0], 2] + rng.normal(0, 0.05))
    return {
        "ragged warp": (ragged, *poses(3, near0)),
        "full row": (full, *poses(2, near0)),
        "across the wrap": (wrap, *poses(2, lambda B: sign(B) * (
            np.pi - rng.uniform(0.0, 0.1, (B, MP))))),
        "at the radius": (rad, T_rad, v_rad),
        "subnormal poses": (ragged, *poses(3, near0, 1e-39)),
    }


def masks_of(points_b, cfg: PipelineConfig):
    """(B, L, nr, nc) level masks of the clouds (B, P, 4), on their device:
    the CC kernel's input on the build path."""
    bev, _, _ = td.rasterize_bev(td.dequantize_points(points_b), cfg.cm)
    return td.level_masks(bev, cfg.cm)


def hold_cc(masks, what: str, kmod=None) -> float:
    """One `cc_labels` launch (of `kmod`, default this checkout's kernels)
    against its plain version on the same masks: raises unless the two are
    bit-equal, returns the largest absolute difference it measured (0.0
    then)."""
    lab_k = (kmod or kernels).cc_labels(masks)
    lab_p = kernels.cc_labels_plain(masks)
    err = float((lab_k - lab_p).abs().max())
    assert torch.equal(lab_k, lab_p), \
        f"CC labels differ from the plain version ({what}): max abs err {err}"
    return err


def merge_case(db, points_b, cfg: PipelineConfig):
    """The merge kernel's inputs (hint_of, T, votes) of the clouds (B, P, 4)
    queried as a batch against `db`'s map at its searchable prefix: the
    tensors the query path hands `merge_hints` (eagerly: search, hint cap,
    check 1, cascade)."""
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch.ops.candidate import merge_inputs

    descs = td.build_descriptors(points_b, cfg.cm, cfg.gmm)
    B = points_b.shape[0]
    hits = tdb.search_batch(db.keys_q, descs.keys,
                            db.state[1].expand(B).contiguous(),
                            tuple(cfg.db.q_levels), cfg.db.nnk)
    qs = tdb.stages_from_hits(db.store, descs, hits, cfg)
    return merge_inputs(qs.res.pass3, qs.gidx, qs.res.T_delta,
                        qs.res.pair_valid, cfg.db.max_cand_poses,
                        cfg.db.max_pass_hints)


def cascade_inputs(db, points_b, cfg: PipelineConfig):
    """The clouds (B, P, 4) queried as a batch against `db`'s map up to the
    cascade: (their B-stacked descriptors, `db.cascade_rows`: the query
    path's own hint cap and check 1), the inputs `db.cascade_chunked`
    takes."""
    from contour_context_tpu_torch import db as tdb

    descs = td.build_descriptors(points_b, cfg.cm, cfg.gmm)
    B = points_b.shape[0]
    hits = tdb.search_batch(db.keys_q, descs.keys,
                            db.state[1].expand(B).contiguous(),
                            tuple(cfg.db.q_levels), cfg.db.nnk)
    return descs, tdb.cascade_rows(db.store, descs, hits, cfg)


def cascade_case(db, points_b, cfg: PipelineConfig):
    """What the cascade costs a call: the clouds (B, P, 4) queried against
    `db`'s map up to the cascade (`cascade_inputs`), then the cascade of
    every hint column (`db.cascade_chunked`) and the cascade of only the
    columns of the busiest query's own ceil(n_valid / W) chunks (what JAX's
    loop runs), each under torch.profiler. Returns ((device ops, busy ms)
    of every column, (device ops, busy ms) of the own chunks' columns,
    n_valid of the busiest query)."""
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch.profile_step import device_ops

    descs, rows = cascade_inputs(db, points_b, cfg)
    HC = rows.gidx.shape[1]
    W = cfg.db.cascade_chunk
    n_run = int(rows.n_run.max())
    own = min(HC, -(-n_run // W) * W)

    def cascade(cols):
        return tdb.cascade_chunked(
            db.store, descs, *[x[:, :cols] for x in rows[:5]], rows.n_run,
            cfg.thres_lb, cfg.db.cont_sim, W, cfg.db.p_pot)

    return (device_ops(lambda: cascade(HC)),
            device_ops(lambda: cascade(own)) if own else (0, 0.0), n_run)


def hold_merge(hint_of, T, votes, what: str, kmod=None) -> float:
    """One `merge_hints` launch (of `kmod`, default this checkout's
    kernels) against its plain version on the same inputs: raises unless
    every output is bit-equal, returns the largest absolute difference of
    the poses (0.0 then)."""
    out_k = (kmod or kernels).merge_hints(hint_of, T, votes)
    out_p = kernels.merge_hints_plain(hint_of, T, votes)
    err = float((out_k[0] - out_p[0]).abs().max())
    for name, a, b in zip(("prop_T", "prop_votes", "prop_n", "key_of_m"),
                          out_k, out_p):
        assert torch.equal(a, b), \
            f"merge {name} differs from the plain version ({what})"
    assert torch.equal(out_k[0].view(torch.int32), out_p[0].view(torch.int32))
    return err


def cc_bound(masks):
    """(bound us, bound_by, bytes): each mask byte read once, each int32
    label written once."""
    n_bytes = masks.numel() * 5
    return _bound(n_bytes, 0.0) + (n_bytes,)


def merge_bound(hint_of, T, votes):
    """(bound us, bound_by, bytes) of what this input's walk needs: each
    candidate row's hint ids read up to and including its first -1 (all MP
    of a full row), the pose and votes of each hint present read once (a
    hint sits in one row), prop_T, prop_votes, prop_n and key_of_m written
    once (a few dozen flops a hint: nothing next to the bytes)."""
    B, C, MP = hint_of.shape
    lead = (hint_of >= 0).to(torch.int32).cumprod(-1).sum(-1)  # (B, C)
    ids = int(torch.clamp(lead + 1, max=MP).sum())
    hints = int((hint_of >= 0).sum())
    n_bytes = 4 * ids + hints * (3 * T.element_size() + votes.element_size()) \
        + 4 * (B * C * kernels.P_PROP * 4 + B * C + B * MP)
    return _bound(n_bytes, 0.0) + (n_bytes,)


# dependent steps of one hint on the merge walk's serial chain, as the
# source writes them, floorf and a division counted as one step each: the
# clamped angle difference of a slot (sub, add, mul, floor, mul, sub, abs,
# compare: 8; its radius test beside it is shorter), the slot's match (and:
# 1), the first match over the four slots (4 selects), the slot (1), the
# old proposal's values (2 selects), the merged angle (sub, two
# compare-and-selects, mul, div, add: 8) and the write into the slot
# (compare, select: 2)
MERGE_CHAIN_STEPS = 26


def merge_chain_bound(hint_of, clk_hz: float) -> float:
    """The merge walk's serial chain (us): the longest row's hints, each
    MERGE_CHAIN_STEPS dependent steps, one step a clock at the card's
    maximum SM clock; the rows run side by side, a row's hints one after
    another."""
    longest = int((hint_of >= 0).sum(-1).max()) if hint_of.numel() else 0
    return 1e6 * longest * MERGE_CHAIN_STEPS / clk_hz


def measure_cc(masks, label: str, reps: int = 200, kmod=None) -> dict:
    """The CC kernel's row on `masks` (N, nr, nc): held against its plain
    version, then timed (device us warm and cold, call and plain ms).
    `kmod` is the kernel module to time (default this checkout's; see
    `other_kernels`), held against this checkout's plain version."""
    kmod = kmod or kernels
    err = hold_cc(masks, label, kmod)
    b_us, b_by, n_bytes = cc_bound(masks)
    lab = kernels.cc_labels_plain(masks)
    S = masks.shape[-1] * masks.shape[-2]
    return _shares(dict(
        name="cc_labels", route="cuda",
        source="contour_context_tpu_torch/csrc/cc_labels.cu",
        replaces=CC_REPLACES, shape=f"masks {tuple(masks.shape)} ({label})",
        components=int((lab == torch.arange(S, device=lab.device)).sum()),
        max_abs_err=err, bound_us=b_us, bound_by=b_by, bytes=n_bytes,
        library_ms=None,
        **_measure(lambda: kmod.cc_labels(masks),
                   lambda: kernels.cc_labels_plain(masks),
                   "cc_labels_kernel", reps)))


def measure_merge(hint_of, T, votes, label: str, reps: int = 200,
                  kmod=None) -> dict:
    """The merge kernel's row on its inputs: held against its plain
    version, then timed; its bound is the larger of its bytes and its
    serial chain (`merge_chain_bound`)."""
    kmod = kmod or kernels
    err = hold_merge(hint_of, T, votes, label, kmod)
    b_us, b_by, n_bytes = merge_bound(hint_of, T, votes)
    chain_us = merge_chain_bound(hint_of, max_sm_clock_hz())
    if chain_us > b_us:
        b_us, b_by = chain_us, "operations"
    return _shares(dict(
        name="merge_hints", route="cuda",
        source="contour_context_tpu_torch/csrc/merge_hints.cu",
        replaces=MERGE_REPLACES,
        shape=f"hint_of {tuple(hint_of.shape)} ({label})",
        hints=int((hint_of >= 0).sum()),
        rows_walked=int((hint_of[..., 0] >= 0).sum()),
        longest_row=int((hint_of >= 0).sum(-1).max()),
        max_abs_err=err, bound_us=b_us, bound_by=b_by, bytes=n_bytes,
        chain_bound_us=chain_us, library_ms=None,
        **_measure(lambda: kmod.merge_hints(hint_of, T, votes),
                   lambda: kernels.merge_hints_plain(hint_of, T, votes),
                   "merge_hints_kernel", reps)))


LM_REPLACES = "contour_context_tpu/ops/gmm.py:287"
LM_SOURCE = "contour_context_tpu_torch/csrc/gmm_lm.cu"
# floating-point operations of one pair in the LM kernel, as its source
# writes them (the products, sums and differences, the clamp, the division
# 1 / det and the add into the thread's sum; expf and rsqrtf apart): the
# trial value's pass, and the gradient and Hessian pass (the value's terms
# and 119 more for the nine products); and of one source ellipse's terms
# at a pose (`pose_terms`, twice an iteration)
LM_VALUE_FLOPS = 30
LM_GRAD_FLOPS = 148
LM_POSE_FLOPS = 35
# dependent steps of one LM iteration as the source writes them, one a
# clock: a pair's gradient terms from the per-source terms (S, det, 1 /
# det, I, alpha, q, exp, v: 17; then Sigma alpha, a_t, q_tt, L_tt and the
# product into the sum: 15), a thread's 8 pairs (8 adds at 4,096 pairs),
# the two shuffle trees (5 + 4), the solve (the damped diagonal, a
# cofactor, the determinant and the division: 9), cos and sin of the new
# angle (1), the trial pose's per-source terms (5), a pair's trial value
# (17), the thread's adds (8), the trees (9) and the accept test (2)
LM_CHAIN_STEPS = 100


def _solve3_torch(A, b):
    """The adjugate solve as the port ran it before the LM kernel: adj(A) b
    as a torch sum over the last axis (gmm._solve3 now sums it left to
    right, as the kernel does)."""
    def a(i, j):
        return A[..., i, j]

    c00 = a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)
    c01 = a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2)
    c02 = a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)
    c10 = a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2)
    c11 = a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0)
    c12 = a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1)
    c20 = a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)
    c21 = a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)
    c22 = a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)
    det = a(0, 0) * c00 + a(0, 1) * c01 + a(0, 2) * c02
    adj = torch.stack([torch.stack([c00, c10, c20], -1),
                       torch.stack([c01, c11, c21], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    x = (adj * b[..., None, :]).sum(dim=-1)
    return x / torch.where(det.abs() > 1e-30, det, 1e-30)[..., None]


def lm_torch_chain(src, tgt, T_init, sel, scale: float = 2.0,
                   iters: int = 10):
    """The port's LM as it ran before the kernel, the chain of torch ops
    the kernel replaced (~3,550 device ops a call at any shape): each
    iteration's value, gradient and Hessian as torch sums over the pair
    grid (gmm.gmm_value_grad_hess, gmm.gmm_value), then the solve with its
    torch sum (`_solve3_torch`). The yardstick that gmm_lm's time is read
    against, and what its twin's reordered sums are held to."""
    eye = torch.eye(3, dtype=T_init.dtype, device=T_init.device)
    p = T_init
    f = gmm.gmm_value(p, src, tgt, sel, scale)
    lam = torch.full_like(f, 1e-3)
    for _ in range(iters):
        _, g, Hm = gmm.gmm_value_grad_hess(p, src, tgt, sel, scale)
        A = Hm + lam[..., None, None] * eye
        p_new = p + _solve3_torch(A + 1e-9 * eye, -g)
        f_new = gmm.gmm_value(p_new, src, tgt, sel, scale)
        ok = (f_new < f) & torch.isfinite(p_new).all(dim=-1)
        p = torch.where(ok[..., None], p_new, p)
        f = torch.where(ok, f_new, f)
        lam = torch.where(ok, lam * 0.33, lam * 10.0)
    return -f / gmm._corr_norm(src, tgt), p


def lm_case(db, points_b, cfg: PipelineConfig):
    """The LM's inputs (src, tgt, T0, sel) of the clouds (B, P, 4) queried
    as a batch against `db`'s map at its searchable prefix: what the query
    path hands `optimize_correlation` (eagerly: search, the query tail up
    to the F best candidates a query)."""
    from contour_context_tpu_torch import db as tdb

    descs = td.build_descriptors(points_b, cfg.cm, cfg.gmm)
    B = points_b.shape[0]
    hits = tdb.search_batch(db.keys_q, descs.keys,
                            db.state[1].expand(B).contiguous(),
                            tuple(cfg.db.q_levels), cfg.db.nnk)
    r = tdb.refine_from_hits(db.store, descs, hits, cfg)
    return r.src, tdb.per_query(r.tgt), r.T0, r.sel


def lm_random_case(dev, lead, lead_t, G: int = 4, K: int = 32,
                   seed: int = 0):
    """Random LM inputs (src, tgt, T0, sel) on `dev`: targets of leading
    shape lead_t (broadcasting against the rows' `lead`), each G levels x K
    ellipses (positive-definite covariances, 80% weighted); each row's
    source its target seen from a pose near the identity with 0.1-cell
    noise, T0 near that pose, sel the init correlation's close pairs."""
    rng = np.random.default_rng(seed)
    t_sh = tuple(lead_t) + (G, K)
    th = rng.uniform(0, np.pi, t_sh)
    l0 = rng.uniform(1.0, 4.0, t_sh)
    l1 = l0 + rng.uniform(0.0, 20.0, t_sh)
    c, s = np.cos(th), np.sin(th)
    covs = np.stack([np.stack([c * c * l1 + s * s * l0, c * s * (l1 - l0)],
                              -1),
                     np.stack([c * s * (l1 - l0), s * s * l1 + c * c * l0],
                              -1)], -2)
    tgt = dict(mus=rng.uniform(10.0, 140.0, t_sh + (2,)), covs=covs,
               ws=np.where(rng.random(t_sh) < 0.8,
                           rng.uniform(5.0, 400.0, t_sh), 0.0),
               majax=np.sqrt(l1),
               auto_corr=rng.uniform(1e3, 1e4, tuple(lead_t)))
    lead = tuple(lead)
    pose = np.stack([rng.uniform(-2, 2, lead), rng.uniform(-2, 2, lead),
                     rng.uniform(-0.05, 0.05, lead)], -1)
    ca, sa = np.cos(pose[..., 2]), np.sin(pose[..., 2])
    Rm = np.stack([np.stack([ca, -sa], -1), np.stack([sa, ca], -1)], -2)
    Rm = Rm[..., None, None, :, :]                        # (*lead, 1, 1, 2, 2)
    d = np.broadcast_to(tgt["mus"], lead + (G, K, 2)) \
        - pose[..., None, None, :2]
    src = {k: np.broadcast_to(v, lead + v.shape[len(lead_t):])
           for k, v in tgt.items()}
    src["mus"] = np.einsum("...ba,...b->...a", Rm, d) \
        + rng.normal(0, 0.1, d.shape)
    src["covs"] = np.swapaxes(Rm, -1, -2) @ src["covs"] @ Rm
    src["auto_corr"] = rng.uniform(1e3, 1e4, lead)
    T0 = pose + np.stack([rng.normal(0, 0.3, lead), rng.normal(0, 0.3, lead),
                          rng.normal(0, 0.01, lead)], -1)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    src, tgt = (gmm.GmmScan(**{k: t(v) for k, v in x.items()})
                for x in (src, tgt))
    T0 = t(T0)
    return src, tgt, T0, gmm.init_correlation(src, tgt, T0)[1]


# the LM kernel's edge cases (`lm_edge_case`): name -> (rows, targets, G,
# K, iters)
LM_EDGE_CASES = {
    "host spec: 7 rows against one unbatched target": ((7,), (), 4, 32, 10),
    "host spec: 5 rows against a (1,) target": ((5,), (1,), 4, 32, 10),
    "odd K: G 2, K 12, iters 3": ((3, 4), (3, 1), 2, 12, 3),
    "empty sel rows (the explore case)": ((2, 5), (2, 1), 4, 32, 10),
    "a non-finite trial step": ((1, 3), (1, 1), 4, 32, 10),
}


def lm_edge_case(name: str, dev, seed: int = 0):
    """The LM inputs (src, tgt, T0, sel, iters) of LM_EDGE_CASES[name]:
    `lm_random_case` at its shapes; empty sel rows have no close pair at
    all (rows 0, 2 and 4 of each query), and a non-finite trial step comes
    from row 1's weights of 1e37 (their products overflow, so its
    gradient, its step and its trial pose are NaN, and no step is taken)."""
    lead, lead_t, G, K, iters = LM_EDGE_CASES[name]
    src, tgt, T0, sel = lm_random_case(dev, lead, lead_t, G, K, seed)
    if name.startswith("empty sel"):
        sel[:, 0::2] = False
    if name.startswith("a non-finite"):
        ws = src.ws.clone()
        ws[:, 1] = torch.where(ws[:, 1] > 0, 1e37, 0.0)
        src = src._replace(ws=ws)
    return src, tgt, T0, sel, iters


def hold_lm(src, tgt, T0, sel, what: str, scale: float = 2.0,
            iters: int = 10) -> float:
    """One `optimize_correlation` call on the card (one gmm_lm launch)
    against its plain twin run on the card on the same inputs: raises
    unless the correlations and poses are bit-equal (NaN, of any payload,
    where the twin has NaN), returns the largest absolute difference (0.0
    then)."""
    n = kernels.gmm_lm.launches
    out_k = gmm.optimize_correlation(src, tgt, T0, sel, scale, iters)
    assert kernels.gmm_lm.launches == n + 1, "no gmm_lm launch"
    out_p = gmm.optimize_correlation_plain(src, tgt, T0, sel, scale, iters)
    err = max(float((a - b).abs().nan_to_num(0.0).max()) if a.numel() else
              0.0 for a, b in zip(out_k, out_p))
    for name, a, b in zip(("corr", "T"), out_k, out_p):
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan) and torch.equal(
            a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]), \
            f"LM {name} differs from the plain twin ({what}): max abs err {err}"
    return err


def lm_bound(src, tgt, T0, sel, iters: int, clk_hz: float):
    """(bound us, bound_by, bytes, flops, exps, chain us) of one LM call:
    each input read once (the two GMMs' means, covariances and weights, the
    masks, the poses, the auto-correlations), corr and T written once; the
    operations of `iters` gradient passes and iters + 1 value passes over
    the close pairs (`sel`: a pair outside it adds an exact 0, so the
    function needs none of its work) at the fp32 rate, plus their expf at
    the MUFU rate; the chain of `iters` dependent iterations,
    LM_CHAIN_STEPS dependent steps each at the card's maximum SM clock."""
    R = T0.numel() // 3
    G, K = src.ws.shape[-2:]
    n_t = tgt.ws.numel() // (G * K)
    P = G * K * K
    n_sel = int(sel.sum())
    n_bytes = 4 * (R + n_t) * (G * K * 7 + 1) + R * P + 4 * R * 3 \
        + 4 * R * 4
    flops = n_sel * (LM_VALUE_FLOPS * (iters + 1) + LM_GRAD_FLOPS * iters) \
        + R * G * K * LM_POSE_FLOPS * (2 * iters + 1)
    exps = n_sel * (2 * iters + 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_ops = flops / FP32_FLOPS + exps / (MUFU_PER_CLK_SM * sms * clk_hz)
    chain_us = 1e6 * iters * LM_CHAIN_STEPS / clk_hz
    b_us, b_by = _bound(n_bytes, t_ops)
    if chain_us > b_us:
        b_us, b_by = chain_us, "chain"
    return b_us, b_by, n_bytes, flops, exps, chain_us


def measure_lm(src, tgt, T0, sel, label: str, reps: int = 200,
               scale: float = 2.0, iters: int = 10) -> dict:
    """The LM kernel's row on its inputs: held bit-equal to its twin, then
    timed (device us warm and cold, call ms), beside the twin's call ms
    (`plain_ms`) and the call ms of the torch chain it replaced
    (`replaces_ms`, `lm_torch_chain`); its bound `lm_bound`."""
    err = hold_lm(src, tgt, T0, sel, label, scale, iters)
    b_us, b_by, n_bytes, flops, exps, chain_us = lm_bound(
        src, tgt, T0, sel, iters, max_sm_clock_hz())
    row = dict(
        name="gmm_lm", route="cuda", source=LM_SOURCE, replaces=LM_REPLACES,
        shape=f"rows {tuple(T0.shape[:-1])}, sel {tuple(sel.shape)} "
        f"({label})", sel_pairs=int(sel.sum()), max_abs_err=err,
        bound_us=b_us, bound_by=b_by, bytes=n_bytes, flops=flops, exps=exps,
        chain_bound_us=chain_us, library_ms=None,
        **_measure(lambda: gmm.optimize_correlation(src, tgt, T0, sel, scale,
                                                    iters),
                   lambda: gmm.optimize_correlation_plain(
                       src, tgt, T0, sel, scale, iters),
                   "gmm_lm_kernel", reps))
    row["replaces_ms"] = call_ms(lambda: lm_torch_chain(src, tgt, T0, sel,
                                                        scale, iters))
    return _shares(row)


def lm_rows(dev, cfg: PipelineConfig, reps: int = 200) -> list:
    """The LM kernel on the smoke stream's DB (`stream_case`) at the
    stream's shape (one revisit query: F = 10 rows) and the serving shape
    (16 revisit queries: 160 rows), each held and timed (`measure_lm`)."""
    db, clouds = stream_case(dev, cfg)
    rev0 = 2 * LANE_SCANS
    one = torch.from_numpy(clouds[rev0 + 10]).to(dev)[None]
    revs16 = torch.from_numpy(np.stack(clouds[rev0 + 16:rev0 + 32])).to(dev)
    g = cfg.gmm
    return [measure_lm(*lm_case(db, pts, cfg), label, reps,
                       g.cov_dilate_scale, g.gn_iters)
            for label, pts in (("a revisit query, B 1", one),
                               ("16 revisit queries, B 16", revs16))]


CASCADE_SOURCE = "contour_context_tpu_torch/csrc/cascade.cu"
CASCADE_REPLACES = ("contour_context_tpu/ops/cascade.py:98 and db.py "
                    "_gather_and_cascade_impl / _cascade_chunked")
# dependent steps of one hint row of the cascade, one a clock, as the
# function needs them: the pair test and its angle (9), a sort of the close
# pairs by a rank tree (11 at M*M = 1600), the window ends' two binary
# searches (2 x 9) and the longest window's max tree (9), the member's
# gather and check 3 (12), the compacted order's count tree (6), the shaft
# (span, compare, pick: 8), the orientation screen (acos and compares: 6),
# two rounds of the Umeyama sums (2 x 7) and the fit (atan2, cos and sin,
# the pose: 6)
CASCADE_CHAIN_STEPS = 99
# the edge rows of the cascade's tests (`cascade_edge_world`)
CASCADE_KINDS = ("plain", "no close", "none valid", "pot overflow",
                 "win overflow", "wrap", "ties", "hv false", "no shaft",
                 "tgt shaft degenerate", "screen", "indiv", "negative slots",
                 "odd indices")
_NEI = ("nei_valid", "nei_level", "nei_seq", "nei_bit", "nei_theta")


def _wrap_ang(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _cascade_tables(rng, n, L12, J, rot, shift):
    """n scans' tab12 (n, L12, J, 12) and the matching query side: the
    check-1 channels depend on the level only, the means and vec1 are the
    source's turned by `rot` and moved by `shift`."""
    t = np.zeros((n, L12, J, 12), np.float32)
    t[..., 0] = rng.uniform(20, 60, (n, L12, 1))
    t[..., 1] = rng.uniform(1, 5, (n, L12, 1))
    t[..., 2] = t[..., 1] + rng.uniform(1, 8, (n, L12, 1))
    t[..., 3] = rng.uniform(1, 3, (n, L12, 1))
    t[..., 4] = rng.uniform(1, 5, (n, L12, 1))
    t[..., 5:7] = rng.uniform(-20, 20, (n, L12, J, 2))
    phi = rng.uniform(-np.pi, np.pi, (n, L12, J))
    t[..., 7], t[..., 8] = np.cos(phi), np.sin(phi)
    t[..., 9] = rng.random((n, L12, J)) < 0.5
    t[..., 10] = rng.uniform(0.01, 0.2, (n, L12, J))
    t[..., 11] = 1.0
    q = t.copy()
    c, s = np.cos(rot), np.sin(rot)
    x, y = t[..., 5].copy(), t[..., 6].copy()
    q[..., 5], q[..., 6] = c * x - s * y + shift[0], s * x + c * y + shift[1]
    q[..., 5:7] += rng.normal(0, 0.05, q[..., 5:7].shape)
    vx, vy = t[..., 7].copy(), t[..., 8].copy()
    q[..., 7], q[..., 8] = c * vx - s * vy, s * vx + c * vy
    return t, q


def _cascade_nei(rng, shape, J, rot):
    """Neighbour tables of `shape` (n, L, A, M) and the query side's: each
    target row a noisy permutation of its source row, its angles turned by
    `rot`."""
    sv = rng.random(shape) < 0.8
    sl = rng.integers(1, 4, shape).astype(np.int8)
    sq = rng.integers(0, J, shape).astype(np.int8)
    sb = rng.integers(0, 256, shape).astype(np.int16)
    st = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    perm = np.argsort(rng.random(shape), axis=-1)

    def tk(x):
        return np.take_along_axis(x, perm, axis=-1)

    tb = np.clip(tk(sb) + rng.integers(-1, 2, shape), 0, 255)
    tt = _wrap_ang(tk(st) + rot + rng.normal(0, 0.01, shape))
    src = dict(nei_valid=sv, nei_level=sl, nei_seq=sq, nei_bit=sb,
               nei_theta=st)
    tgt = dict(nei_valid=tk(sv), nei_level=tk(sl), nei_seq=tk(sq),
               nei_bit=tb.astype(np.int16), nei_theta=tt.astype(np.float32))
    return src, tgt


def _cascade_edge(rng, kind, src, tgt, stab, qtab, h, lev, ss, st):
    """Rewrite hint h's neighbour rows (store row h at (lev, ss), query row
    h at (lev, st)) and tables so that the cascade takes the `kind` path;
    returns the row's (level, seq_src, seq_tgt, hint_valid)."""
    M = src["nei_bit"].shape[-1]
    s = {k: v[h, lev, ss] for k, v in src.items()}       # views
    t = {k: v[h, lev, st] for k, v in tgt.items()}
    hv = True
    if kind == "no close":
        s["nei_bit"][:] = np.arange(M) * 2
        t["nei_bit"][:] = 120 + np.arange(M) * 3
    elif kind == "none valid":
        s["nei_valid"][:] = False
    elif kind == "pot overflow":
        s["nei_valid"][:] = t["nei_valid"][:] = True
        s["nei_bit"][:] = 50
        t["nei_bit"][:] = 49 + rng.integers(0, 3, M)
    elif kind == "win overflow":
        s["nei_valid"][:] = t["nei_valid"][:] = True
        s["nei_bit"][:] = 70 + rng.integers(0, 2, M)
        t["nei_bit"][:] = 70 + rng.integers(0, 2, M)
        s["nei_theta"][:] = 0.0
        t["nei_theta"][:] = 0.4 + rng.uniform(0, 0.1, M)
    elif kind == "wrap":
        t["nei_bit"][:] = s["nei_bit"]
        t["nei_theta"][:] = _wrap_ang(s["nei_theta"] + np.pi
                                      + rng.choice([-0.02, 0.02], M))
    elif kind == "ties":
        s["nei_theta"][:] = 0.25
        t["nei_theta"][:] = 1.0
        t["nei_bit"][:] = s["nei_bit"]
    elif kind == "hv false":
        hv = False
    elif kind == "no shaft":
        stab[h, ..., 5:7] = 3.0
        qtab[h, ..., 5:7] = 1.0
    elif kind == "tgt shaft degenerate":
        qtab[h, ..., 5:7] = 2.0
        stab[h, ..., 9] = qtab[h, ..., 9] = 1.0
    elif kind == "screen":
        stab[h, ..., 9] = qtab[h, ..., 9] = 1.0
        phi = rng.uniform(-np.pi, np.pi, qtab.shape[1:3])
        qtab[h, ..., 7], qtab[h, ..., 8] = np.cos(phi), np.sin(phi)
    elif kind == "indiv":
        qtab[h, :, ::2, 0] *= 3.0
        qtab[h, :, 1::3, 11] = 0.0
    elif kind == "negative slots":
        s["nei_level"][::3] = -1
        s["nei_seq"][::4] = -7
        t["nei_seq"][::5] = -2
        s["nei_bit"][::6] = -1
        t["nei_bit"][::7] = 300
    elif kind == "odd indices":
        J = stab.shape[2]
        return 9, J + 4, -3, True
    return lev, ss, st, hv


def cascade_edge_world(seed: int, kinds=CASCADE_KINDS, L: int = 6,
                       A: int = 6, M: int = 40, J: int = 10, L12: int = 4):
    """Hint rows made to take each edge of the cascade, as numpy: (store,
    query, hints), store and query {leaf: (H, ...)} of the five neighbour
    tables (H, L, A, M) and tab12 (H, L12, J, 12), hint h reading store
    scan h against query scan h (tgt_q = h) under path kinds[h]: no close
    pair (n_pot 0), no valid slot, more close pairs than any p_pot, a window
    longer than 63, angles across the +-pi wrap, equal angles (ties in the
    stable sort), hint_valid false, no shaft pick, a degenerate target shaft,
    the orientation screen and check 3 removing pairs, negative levels, seqs
    and bits, out-of-range indices; hints {gidx, level, seq_src, seq_tgt,
    hv} (H,)."""
    rng = np.random.default_rng(seed)
    H = len(kinds)
    rot, shift = 0.3, (2.0, -1.0)
    stab, qtab = _cascade_tables(rng, H, L12, J, rot, shift)
    src, tgt = _cascade_nei(rng, (H, L, A, M), J, rot)
    rows = [_cascade_edge(rng, kind, src, tgt, stab, qtab, h,
                          int(rng.integers(1, 4)), int(rng.integers(0, A)),
                          int(rng.integers(0, A)))
            for h, kind in enumerate(kinds)]
    level, seq_src, seq_tgt, hv = (np.array(x) for x in zip(*rows))
    hints = dict(gidx=np.arange(H, dtype=np.int32),
                 level=level.astype(np.int32),
                 seq_src=seq_src.astype(np.int32),
                 seq_tgt=seq_tgt.astype(np.int32), hv=hv.astype(bool))
    return dict(src, tab12=stab), dict(tgt, tab12=qtab), hints


def cascade_edge_rows(seeds=(3, 4)):
    """`cascade_edge_world` of each seed, concatenated (hint h still reads
    store scan h against query scan h): (store, query, hints)."""
    worlds = [cascade_edge_world(s) for s in seeds]
    store, query, hints = (
        {k: np.concatenate([w[i][k] for w in worlds]) for k in worlds[0][i]}
        for i in range(3))
    hints["gidx"] = np.arange(len(hints["gidx"]), dtype=np.int32)
    return store, query, hints


def cascade_edge_case(dev, seeds=(3, 4)):
    """`cascade_edge_rows` as tensors on `dev`: (store, query, tgt_q,
    hints (gidx, level, seq_src, seq_tgt, hv)), store and query namespaces
    of the six tables."""
    from types import SimpleNamespace

    store, query, hints = cascade_edge_rows(seeds)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    store, query = (SimpleNamespace(**{k: t(v) for k, v in d.items()})
                    for d in (store, query))
    hints = tuple(t(hints[k]) for k in ("gidx", "level", "seq_src",
                                        "seq_tgt", "hv"))
    return store, query, t(np.arange(len(hints[0]))), hints


def _same_bits(a, b) -> bool:
    if a.dtype.is_floating_point:
        nan = torch.isnan(b)
        return torch.equal(torch.isnan(a), nan) and torch.equal(
            a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])
    return torch.equal(a, b)


def _hold(out_k, out_p, what: str) -> float:
    err = 0.0
    for field, a, b in zip(out_k._fields, out_k, out_p):
        if a.dtype.is_floating_point and a.numel():
            err = max(err, float((a - b).abs().nan_to_num(0.0).max()))
        assert _same_bits(a, b), \
            f"cascade {field} differs from the plain twin ({what})"
    return err


def hold_cascade(store, query, tgt_q, hints, cfg: PipelineConfig, what: str,
                 p_pot="cfg") -> float:
    """One `db.gather_and_cascade` call on the card (one cascade launch) on
    the flat hint rows against its plain twin run on the card on the same
    inputs: raises unless every field is bit-equal (NaN where the twin has
    NaN), returns the largest absolute float difference (0.0 then)."""
    from contour_context_tpu_torch import db as tdb

    pot = cfg.db.p_pot if p_pot == "cfg" else p_pot
    n = kernels.cascade.launches
    out_k = tdb.gather_and_cascade(store, query, tgt_q, *hints, cfg.thres_lb,
                                   cfg.db.cont_sim, pot)
    assert kernels.cascade.launches == n + 1, "no cascade launch"
    out_p = tdb.gather_and_cascade_plain(store, query, tgt_q, *hints,
                                         cfg.thres_lb, cfg.db.cont_sim, pot)
    return _hold(out_k, out_p, what)


def hold_cascade_chunked(store, descs, rows, cfg: PipelineConfig,
                         what: str) -> float:
    """One `db.cascade_chunked` call on the card (one cascade launch) on
    (B, HC) hint rows and n_valid (`rows`: the first six fields of
    `db.CascadeRows`) against `db.cascade_chunked_plain` run on the card:
    raises unless bit-equal, idle columns' zeros included."""
    from contour_context_tpu_torch import db as tdb

    args = (store, descs, *rows[:6], cfg.thres_lb, cfg.db.cont_sim,
            cfg.db.cascade_chunk, cfg.db.p_pot)
    n = kernels.cascade.launches
    out_k = tdb.cascade_chunked(*args)
    assert kernels.cascade.launches == n + 1, "no cascade launch"
    return _hold(out_k, tdb.cascade_chunked_plain(*args), what)


def cascade_close_counts(store, descs, rows) -> torch.Tensor:
    """(B, HC) int64: the close pairs (|bit_s - bit_t| <= 1, both valid) of
    each hint row of `rows` (`db.CascadeRows`), 0 for the columns past each
    query's own chunks, which the kernel does not compute."""
    gidx, level, seq_src, seq_tgt, hv = rows[:5]
    B, HC = gidx.shape
    L, A = store.nei_valid.shape[1:3]
    gi = torch.where(hv, gidx, 0).long()
    lvl = level.clamp(0, L - 1).long()
    ss, st = seq_src.clamp(0, A - 1).long(), seq_tgt.clamp(0, A - 1).long()
    b = torch.arange(B, device=gidx.device)[:, None]
    sv, sb = store.nei_valid[gi, lvl, ss], store.nei_bit[gi, lvl, ss].int()
    tv, tb = descs.nei_valid[b, lvl, st], descs.nei_bit[b, lvl, st].int()
    close = ((sb[..., :, None] - tb[..., None, :]).abs() <= 1) & \
        sv[..., :, None] & tv[..., None, :]
    return close.flatten(-2).sum(-1)


def cascade_bound(store, descs, rows, cfg: PipelineConfig, clk_hz: float):
    """(bound us, bound_by, bytes, ops, chain us, computed rows, close
    pairs) of one cascade call on `rows` (`db.CascadeRows`): each computed
    row reads its five hint values, its two neighbour rows (9 bytes a slot)
    and the two tab12 tables its slots index, once, and every row writes
    its outputs once; the operations the function needs (the M*M pair
    tests, 6 for each close pair's angle, a sort of the close pairs at n
    log2 n compares and two binary searches for each kept pair, ~40 for
    each of the 64 constellation slots); the chain of CASCADE_CHAIN_STEPS
    dependent steps at the card's maximum SM clock."""
    W = cfg.db.cascade_chunk
    gidx = rows[0]
    B, HC = gidx.shape
    M = store.nei_valid.shape[-1]
    L12, J = store.tab12.shape[1:3]
    own = (rows[5].long() + W - 1) // W * W if 0 < W < HC else \
        torch.full((B,), HC, device=gidx.device)
    live = torch.arange(HC, device=gidx.device)[None] < own[:, None]
    nc = torch.where(live, cascade_close_counts(store, descs, rows), 0)
    pot = P_POT if cfg.db.p_pot is None else cfg.db.p_pot
    kept = nc.clamp(max=min(pot, M * M)).double()
    n_rows = int(live.sum())
    n_bytes = n_rows * (17 + 2 * 9 * M + 2 * L12 * J * 48) \
        + B * HC * (25 + 64 * 17 + 12)
    log2 = torch.log2(torch.clamp(nc.double(), min=2))
    ops = float(n_rows * (3 * M * M + 64 * 40) + (6 * nc).sum()
                + (nc * log2).sum() + (2 * kept * log2).sum())
    chain_us = 1e6 * CASCADE_CHAIN_STEPS / clk_hz
    b_us, b_by = _bound(n_bytes, ops / FP32_FLOPS)
    if chain_us > b_us:
        b_us, b_by = chain_us, "chain"
    return b_us, b_by, n_bytes, ops, chain_us, n_rows, int(nc.sum())


def measure_cascade(db, points_b, cfg: PipelineConfig, label: str,
                    reps: int = 200) -> dict:
    """The cascade kernel's row on the clouds' hint rows (`cascade_inputs`
    on `db`): held bit-equal to its twin, then timed (device us warm and
    cold, call ms), beside the twin's call ms (`plain_ms`); its bound
    `cascade_bound`; and `cascade_case`'s device ops and busy ms of the
    call (every column; the twin's beside it)."""
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch.profile_step import device_ops

    descs, rows = cascade_inputs(db, points_b, cfg)
    err = hold_cascade_chunked(db.store, descs, rows, cfg, label)
    b_us, b_by, n_bytes, ops, chain_us, n_rows, n_close = cascade_bound(
        db.store, descs, rows, cfg, max_sm_clock_hz())
    args = (db.store, descs, *rows[:6], cfg.thres_lb, cfg.db.cont_sim,
            cfg.db.cascade_chunk, cfg.db.p_pot)
    B, HC = rows[0].shape
    row = dict(
        name="cascade", route="cuda", source=CASCADE_SOURCE,
        replaces=CASCADE_REPLACES, shape=f"rows ({B}, {HC}) ({label})",
        rows_computed=n_rows, close_pairs=n_close,
        n_run=rows[5].tolist(), max_abs_err=err, bound_us=b_us,
        bound_by=b_by, bytes=n_bytes, ops=ops, chain_bound_us=chain_us,
        library_ms=None,
        **_measure(lambda: tdb.cascade_chunked(*args),
                   lambda: tdb.cascade_chunked_plain(*args),
                   "cascade_kernel", reps))
    row["device_ops"], row["busy_ms"] = device_ops(
        lambda: tdb.cascade_chunked(*args))
    row["plain_device_ops"], row["plain_busy_ms"] = device_ops(
        lambda: tdb.cascade_chunked_plain(*args))
    return _shares(row)


def cascade_rows_of(dev, cfg: PipelineConfig, reps: int = 200,
                    db_clouds=None) -> list:
    """The cascade kernel at the edges (`cascade_edge_case` at p_pot 8,
    128 and None; bit-equal to the twin) and on the smoke stream's DB
    (`stream_case`) at the stream's shape (one revisit query: B 1, 256
    rows) and the serving shape (16 revisit queries: B 16, 4,096 rows),
    each held and timed (`measure_cascade`)."""
    store, query, tgt_q, hints = cascade_edge_case(dev)
    for pot in (8, 128, None):
        hold_cascade(store, query, tgt_q, hints, cfg, f"edges, p_pot {pot}",
                     pot)
    db, clouds = db_clouds or stream_case(dev, cfg)
    rev0 = 2 * LANE_SCANS
    one = torch.from_numpy(clouds[rev0 + 10]).to(dev)[None]
    revs16 = torch.from_numpy(np.stack(clouds[rev0 + 16:rev0 + 32])).to(dev)
    return [measure_cascade(db, pts, cfg, label, reps)
            for label, pts in (("a revisit query, B 1", one),
                               ("16 revisit queries, B 16", revs16))]


LANE_SCANS = 132          # the smoke stream's lane length


def stream_clouds(cfg: PipelineConfig, idx=None) -> list:
    """The smoke's stream (`chip_smoke.py` phase 4) as padded clouds: lane
    0, lane 1 and lane 0 again 1.5 m aside, 132 scans each, the seeds drawn
    in order from default_rng(0) for the whole stream; the scans at the
    indices `idx` (default: all of them, in order)."""
    from contour_context_tpu_torch.profile_step import lane_poses

    world, render_scan = _world()
    rng = np.random.default_rng(0)
    plan = (lane_poses(0, LANE_SCANS) + lane_poses(1, LANE_SCANS)
            + lane_poses(0, LANE_SCANS, dy=1.5))
    seeds = [int(rng.integers(1 << 30)) for _ in plan]
    return [pad_points(render_scan(world, plan[i], seed=seeds[i]),
                       cfg.cm.max_points)
            for i in (range(len(plan)) if idx is None else idx)]


def stream_case(dev, cfg: PipelineConfig):
    """The smoke's stream (`stream_clouds`) stepped into a card DB of
    capacity 8192 at 10 Hz. Returns (db, clouds)."""
    from contour_context_tpu_torch import db as tdb

    clouds = stream_clouds(cfg)
    db = tdb.ContourDB(cfg, capacity=8192, device=dev)
    for k, c in enumerate(clouds):
        db.step_async(c, k, 0.1 * k)
    torch.cuda.synchronize()
    return db, clouds


def cc_merge_cases(dev, cfg: PipelineConfig):
    """The inputs `chip_smoke.py` phase 3d times the CC and merge kernels
    on: ({label: masks}, {label: (hint_of, T, votes)}), the level masks of
    a revisit scan (1, 6, 150, 150) and of the stream's first block (16,
    6, 150, 150), and the merge inputs of that revisit query and of 16
    revisit queries on the stream's DB (`stream_case`)."""
    db, clouds = stream_case(dev, cfg)
    rev0 = 2 * LANE_SCANS
    one = torch.from_numpy(clouds[rev0 + 10]).to(dev)[None]
    block0 = torch.from_numpy(np.stack(clouds[:16])).to(dev)
    revs16 = torch.from_numpy(np.stack(clouds[rev0 + 16:rev0 + 32])).to(dev)
    cc = {"a revisit scan": masks_of(one, cfg),
          "the stream's first block of 16": masks_of(block0, cfg)}
    merge = {"a revisit query on the stream's DB": merge_case(db, one, cfg),
             "16 revisit queries on the stream's DB":
                 merge_case(db, revs16, cfg)}
    del db
    return cc, merge


STAMP_SLOTS = 16          # clock64 slots a CTA of a *_phases entry writes


def _phase_split(lib, kernel: str, n_ctas: int, call, reps: int,
                 count_slot: Optional[int] = None) -> dict:
    """Run the measurement entry `cc_<kernel>_phases` (thread 0 of each CTA
    writes clock64() at each phase boundary) reps times after 5 warm-ups:
    each phase's cycles, mean over CTAs and launches, and the slowest CTA's
    (mean over launches), in us at the card's maximum SM clock; with
    `count_slot`, also the count each CTA wrote there ("count_mean" over
    CTAs and launches, "count_max"). None when the library has no such
    entry (an older checkout)."""
    try:
        entry = getattr(lib, f"cc_{kernel}_phases")
        names_fn = getattr(lib, f"cc_{kernel}_phase_names")
    except AttributeError:
        return None
    names_fn.restype = ctypes.c_char_p
    names = names_fn().decode().split(",")
    entry.restype = ctypes.c_int
    n = len(names)
    stamps = torch.zeros((n_ctas, STAMP_SLOTS), dtype=torch.int64,
                         device="cuda")
    mean = torch.zeros(n + 1, dtype=torch.float64, device="cuda")
    worst = torch.zeros(n + 1, dtype=torch.float64, device="cuda")
    count = torch.zeros(2, dtype=torch.float64, device="cuda")
    for i in range(5 + reps):
        stamps.zero_()
        rc = call(entry, ctypes.c_void_p(stamps.data_ptr()))
        if rc != 0:
            raise RuntimeError(f"cc_{kernel}_phases failed: CUDA error {rc}")
        if i >= 5:
            d = torch.cat([stamps[:, 1:n + 1] - stamps[:, :n],
                           stamps[:, n:n + 1] - stamps[:, :1]], 1).double()
            mean += d.mean(0)
            worst += d.max(0).values
            if count_slot is not None:
                c = stamps[:, count_slot].double()
                count += torch.stack([c.mean(), c.max()])
    clk = max_sm_clock_hz()
    mean, worst = (mean / reps).tolist(), (worst / reps).tolist()
    out = {"phases": names, "ctas": n_ctas,
           "cycles_mean": mean[:n], "cycles_slowest_cta": worst[:n],
           "us_slowest_cta": [1e6 * c / clk for c in worst[:n]],
           "total_us_slowest_cta": 1e6 * worst[n] / clk}
    if count_slot is not None:
        out["count_mean"], out["count_max"] = (count / reps).tolist()
    return out


def cc_phase_split(masks, kmod=None, reps: int = 50):
    """`_phase_split` of the CC kernel of `kmod` on masks (N, nr, nc)."""
    lib = (kmod or kernels).build()
    N, nr, nc = masks.reshape(-1, *masks.shape[-2:]).shape
    labels = torch.empty((N, nr * nc), dtype=torch.int32, device="cuda")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    try:
        per_mask = lib.cc_cc_labels_ctas_per_mask
    except AttributeError:
        return None
    per_mask.restype = ci

    def call(entry, stamps):
        entry.argtypes = [vp, vp, ci, ci, ci, vp, vp]
        return entry(masks.data_ptr(), labels.data_ptr(), N, nr, nc, stamps,
                     torch.cuda.current_stream().cuda_stream)

    return _phase_split(lib, "cc_labels", N * per_mask(), call, reps)


def cc_max_active_clusters(masks, kmod=None):
    """How many of the CC kernel's clusters the card holds at once at this
    mask size (cudaOccupancyMaxActiveClusters, through the library's
    measurement entry), None for a checkout without it."""
    lib = (kmod or kernels).build()
    try:
        fn = lib.cc_cc_labels_max_active_clusters
    except AttributeError:
        return None
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    n = fn(*masks.shape[-2:])
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: {-n}")
    return n


def merge_phase_split(hint_of, T, votes, kmod=None, reps: int = 50):
    """`_phase_split` of the merge kernel of `kmod` on its inputs."""
    kmod = kmod or kernels
    lib = kmod.build()
    B, C, MP = hint_of.shape
    outs = [torch.empty(s, dtype=d, device="cuda") for s, d in (
        ((B, C, kernels.P_PROP, 3), torch.float32),
        ((B, C, kernels.P_PROP), torch.int32), ((B, C), torch.int32),
        ((B, MP), torch.int32))]
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    two_pi = np.float32(2 * math.pi)

    def call(entry, stamps):
        entry.argtypes = [vp] * 7 + [ci] * 3 + [cf] * 5 + [vp, vp]
        return entry(hint_of.data_ptr(), T.data_ptr(), votes.data_ptr(),
                     *[o.data_ptr() for o in outs], B, C, MP,
                     float(np.float32(math.pi)), float(two_pi),
                     float(np.float32(1.0) / two_pi), kernels.TF_TRANS_MERGE,
                     kernels.TF_ANG_MERGE, stamps,
                     torch.cuda.current_stream().cuda_stream)

    return _phase_split(lib, "merge_hints", B, call, reps)


def _root_of(kmod) -> str:
    """The checkout a kernel module builds from, relative to this one."""
    return os.path.relpath(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(kmod.__file__)))), ROOT)


def cc_merge_rows(dev, cfg: PipelineConfig, kmods, reps: int = 200) -> list:
    """The CC and merge kernels of each module in `kmods` (in that order:
    turns for an A/B) on `cc_merge_cases`' inputs: each row held bit-equal
    to this checkout's plain version, timed (`measure_cc`,
    `measure_merge`) and split by phase where the checkout has the
    measurement entry (`cc_phase_split`, `merge_phase_split`), its
    `turn` and `source` root named."""
    cc, merge = cc_merge_cases(dev, cfg)
    rows = []
    for turn, kmod in enumerate(kmods):
        for label, masks in cc.items():
            r = measure_cc(masks, label, reps, kmod)
            r["phase_split"] = cc_phase_split(masks, kmod)
            r["max_active_clusters"] = cc_max_active_clusters(masks, kmod)
            rows.append(r)
        for label, args in merge.items():
            r = measure_merge(*args, label, reps, kmod)
            r["phase_split"] = merge_phase_split(*args, kmod)
            rows.append(r)
        for r in rows[-len(cc) - len(merge):]:
            r["turn"], r["root"] = turn, _root_of(kmod)
    return rows


DYN_REPLACES = "contour_context_tpu/ops/candidate.py"
DYN_SOURCE = "contour_context_tpu_torch/csrc/dyn_thres.cu"


def dyn_cases(db, points_b, cfg: PipelineConfig):
    """The inputs the query path hands the two dynamic scans (the args of
    `kernels.dyn_pass_scan` and of `kernels.dyn_post_scan`, bars included)
    when the clouds (B, P, 4) are queried as one batch against `db`'s map
    at its searchable prefix under `cfg` (`dynamic_thres` on), eagerly;
    recorded where `ops/candidate.py` calls the wrappers."""
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch.ops import candidate

    seen = {}
    orig = candidate.dyn_pass_scan, candidate.dyn_post_scan

    def recorder(name, fn):
        def call(*args):
            seen[name] = args
            return fn(*args)
        return call

    candidate.dyn_pass_scan = recorder("pass", orig[0])
    candidate.dyn_post_scan = recorder("post", orig[1])
    try:
        descs = td.build_descriptors(points_b, cfg.cm, cfg.gmm)
        B = points_b.shape[0]
        tdb.query_step_batch(db.store, db.keys_q, descs,
                             db.state[1].expand(B).contiguous(), cfg)
    finally:
        candidate.dyn_pass_scan, candidate.dyn_post_scan = orig
    return seen["pass"], seen["post"]


def hold_dyn_pass(args, what: str, kmod=None) -> float:
    """One `dyn_pass_scan` launch (of `kmod`, default this checkout's)
    against this checkout's plain version on `args`: raises unless both
    masks are bit-equal; returns the largest absolute difference (0.0
    then)."""
    k2, k3 = (kmod or kernels).dyn_pass_scan(*args)
    p2, p3 = kernels.dyn_pass_scan_plain(*args)
    err = float(max((k2 != p2).sum(), (k3 != p3).sum()))
    assert torch.equal(k2, p2) and torch.equal(k3, p3), \
        f"dyn_pass_scan differs from the plain version ({what})"
    return err


def hold_dyn_post(args, what: str, kmod=None) -> float:
    """One `dyn_post_scan` launch against its plain version on `args`."""
    k = (kmod or kernels).dyn_post_scan(*args)
    p = kernels.dyn_post_scan_plain(*args)
    err = float((k != p).sum())
    assert torch.equal(k, p), \
        f"dyn_post_scan differs from the plain version ({what})"
    return err


def dyn_bound(masks_in, ints_in, masks_out, n: int, clk_hz: float):
    """(bound us, bound_by, bytes, dependent steps) of a dynamic scan on
    rows of n hints or candidates: each input byte read once, each output
    mask written once, over 3.35 TB/s; against ceil(log2 n) dependent
    steps, one a clock at the card's maximum SM clock. A row's last output
    depends on the inputs of all n of its steps, and operations of two
    operands join n inputs in no fewer levels (the clamped running max
    composes as a parallel prefix in that many); the rows run side by
    side."""
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (*masks_in, *ints_in, *masks_out))
    steps = math.ceil(math.log2(n)) if n > 1 else 1
    return _bound(n_bytes, steps / clk_hz) + (n_bytes, steps)


def dyn_phase_split(name: str, args, kmod=None, reps: int = 50):
    """`_phase_split` of the dynamic scan `name` ("dyn_pass_scan" or
    "dyn_post_scan") of `kmod` on its wrapper's args: each row's load (and
    thresholds), walk and write, stamped by lane 0 of the row's warp
    through the measurement entry `cc_<name>_phases`, and the walk's ballot
    rounds a row ("count_mean", "count_max"). None for a checkout without
    the entries."""
    lib = (kmod or kernels).build()
    try:
        slot = lib.cc_dyn_round_slot()
    except AttributeError:
        return None
    pass_scan = name == "dyn_pass_scan"
    n_in = 6 if pass_scan else 4
    val = torch.int32 if pass_scan else torch.float32
    ins = [args[0].contiguous()] + [x.to(val).contiguous()
                                    for x in args[1:n_in]]
    bars = (*args[n_in], *args[n_in + 1])
    shape = tuple(ins[0].shape)
    outs = [torch.empty(shape, dtype=torch.bool, device=ins[0].device)
            for _ in range(2 if pass_scan else 1)]
    rows = math.prod(shape[:-1])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    bar_t, bar_of = (ci, int) if pass_scan else (ctypes.c_float, float)

    def call(entry, stamps):
        entry.argtypes = ([vp] * (len(ins) + len(outs)) + [ci, ci]
                          + [bar_t] * len(bars) + [vp, vp])
        return entry(*[x.data_ptr() for x in ins + outs], rows, shape[-1],
                     *[bar_of(v) for v in bars], stamps,
                     torch.cuda.current_stream().cuda_stream)

    return _phase_split(lib, name, rows, call, reps, count_slot=slot)


def _dyn_row(name, line, args, label, kmod, ins, ints, outs, reps, clk):
    hold = hold_dyn_pass if name == "dyn_pass_scan" else hold_dyn_post
    err = hold(args, label, kmod)
    b_us, b_by, n_bytes, steps = dyn_bound(ins, ints, outs,
                                           ins[0].shape[-1], clk)
    split = dyn_phase_split(name, args, kmod)
    return _shares(dict(
        name=name, route="cuda", source=DYN_SOURCE,
        replaces=f"{DYN_REPLACES}:{line}",
        shape=f"{tuple(ins[0].shape)} ({label})", steps=steps,
        passed=int(outs[-1].sum()),
        rounds=None if split is None else split["count_max"],
        phase_split=split, max_abs_err=err, bound_us=b_us, bound_by=b_by,
        bytes=n_bytes, library_ms=None,
        **_measure(lambda: getattr(kmod, name)(*args),
                   lambda: getattr(kernels, name + "_plain")(*args),
                   name + "_kernel", reps)))


def measure_dyn_pass(args, label: str, reps: int = 200, kmod=None) -> dict:
    """The pass scan's row on its inputs: held against its plain version,
    then timed (device us warm and cold, call and plain ms), split by phase
    with its ballot rounds where the checkout has the measurement entry.
    `kmod` is the kernel module to time (default this checkout's)."""
    p2, p3 = kernels.dyn_pass_scan_plain(*args)
    return _dyn_row("dyn_pass_scan", 290, args, label, kmod or kernels,
                    [args[0]], [x.to(torch.int32) for x in args[1:6]],
                    [p2, p3], reps, max_sm_clock_hz())


def measure_dyn_post(args, label: str, reps: int = 200, kmod=None) -> dict:
    """The post scan's row on its inputs."""
    keep = kernels.dyn_post_scan_plain(*args)
    return _dyn_row("dyn_post_scan", 322, args, label, kmod or kernels,
                    [args[0]], [x.to(torch.float32) for x in args[1:4]],
                    [keep], reps, max_sm_clock_hz())


RISE_UB = 10 ** 6         # the upper bars of the every-step-a-rise rows
DYN_LANE_STEPS = 8        # steps a lane of the walks (csrc/dyn_thres.cu)


def dyn_worst_cases(dev, H: int = 256, C: int = 64):
    """The wrapper args on which each walk takes the most ballot rounds,
    one row each: the pass scan with every hint passing and orie rising 1,
    2, ..., H under lower bars 0 and upper bars RISE_UB; the post scan with
    every candidate in use and its three scores rising under upper bars
    RISE_UB. Every step is a rise: a round for each lane's
    DYN_LANE_STEPS steps, plus one (33 at H 256, 9 at C 64)."""
    p1 = torch.ones((1, H), dtype=torch.bool, device=dev)
    full = torch.full((1, H), RISE_UB, dtype=torch.int32, device=dev)
    orie = torch.arange(1, H + 1, dtype=torch.int32, device=dev)[None]
    use = torch.ones((1, C), dtype=torch.bool, device=dev)
    up = torch.arange(C, dtype=torch.float32, device=dev)[None] / C
    return ((p1, full, full, full, full, orie, (0,) * 5, (RISE_UB,) * 5),
            (use, up, up - 8.0, up, (-1.0, -9.0, -1.0),
             (float(RISE_UB),) * 3))


def dyn_stream_cases(dev, cfg: PipelineConfig) -> list:
    """The inputs `chip_smoke.py` phase 9 times the dynamic scans on, and
    the worst-case rows: [(kernel name, label, wrapper args)]. The DB is
    phase 9's: the smoke stream's first 32 scans of lane 0 and their 32
    revisits (`stream_clouds`), stepped 1 s apart into a card DB of
    capacity 128 under `dynamic_thres`; the args are those of its 59th
    scan's query and of a block of its last 16 (`dyn_cases`)."""
    import dataclasses

    from contour_context_tpu_torch import db as tdb

    rev0 = 2 * LANE_SCANS
    seq = stream_clouds(cfg, list(range(32)) + list(range(rev0, rev0 + 32)))
    dyn = dataclasses.replace(
        cfg, db=dataclasses.replace(cfg.db, dynamic_thres=True))
    db = tdb.ContourDB(dyn, capacity=128, device=dev)
    for k, c in enumerate(seq):
        db.step_async(c, k, 1.0 * k)
    pa1, po1 = dyn_cases(db, torch.from_numpy(seq[-5])[None].to(dev), dyn)
    pa16, po16 = dyn_cases(db, torch.from_numpy(np.stack(seq[-16:])).to(dev),
                           dyn)
    wp, wo = dyn_worst_cases(dev)
    del db
    return [("dyn_pass_scan", "a revisit query of the stream", pa1),
            ("dyn_pass_scan", "the block of 16", pa16),
            ("dyn_pass_scan", "every hint a rise", wp),
            ("dyn_post_scan", "a revisit query of the stream", po1),
            ("dyn_post_scan", "the block of 16", po16),
            ("dyn_post_scan", "every candidate a rise", wo)]


def dyn_rows(dev, cfg: PipelineConfig, kmods, reps: int = 200) -> list:
    """Both dynamic scans of each module in `kmods` (in that order: turns
    for an A/B) on `dyn_stream_cases`' inputs, each row held bit-equal to
    this checkout's plain version, timed and split by phase
    (`measure_dyn_pass`, `measure_dyn_post`), its `turn` and `root`
    named."""
    cases = dyn_stream_cases(dev, cfg)
    rows = []
    for turn, kmod in enumerate(kmods):
        for name, label, args in cases:
            measure = measure_dyn_pass if name == "dyn_pass_scan" \
                else measure_dyn_post
            r = measure(args, label, reps, kmod)
            r["turn"], r["root"] = turn, _root_of(kmod)
            rows.append(r)
    return rows


I32 = np.iinfo(np.int32)


def dyn_edge_cases(dev, cfg: PipelineConfig) -> list:
    """Both dynamic scans bit-equal to their plain versions at the edges,
    under cfg's bars: nothing passes (every pass1 / in_use False); every
    row passes (every count and score at the upper bar, so the bars end at
    ub); the bars clamp at ub on the first row (its orie, or its scores,
    above every upper bar) and then gate the rest; random inputs at B = 1,
    16 and 17; H at its cap (min(max_check_cands, Q*A*K)) and C at
    max_cand_poses, rows of 2500 (several windows of the walk, unaligned
    rows); bars out of order; counts at INT32_MIN / INT32_MAX under cfg's
    bars and under bars at the int32 extremes; every step a rise
    (`dyn_worst_cases`); a NaN upper bar (the first kept row makes the bar
    NaN, and nothing is kept after it: one row kept of each); NaN scores;
    scores of -0.0 and +0.0 at bars of +0.0 and -0.0. Returns one line
    for each kernel."""
    from contour_context_tpu_torch.ops.candidate import (dynamic_pass_scan,
                                                         dynamic_post_scan)

    lb, ub = cfg.thres_lb, cfg.thres_ub
    Q, A, K = len(cfg.db.q_levels), cfg.cm.piv_firsts, cfg.db.nnk
    HC = min(cfg.db.max_check_cands, Q * A * K)
    C = cfg.db.max_cand_poses
    rng = np.random.default_rng(11)

    def pass_bars(e):
        return (e.sim_constell.i_ovlp_sum, e.sim_constell.i_ovlp_max_one,
                e.sim_constell.i_in_ang_rng, e.sim_pair.i_indiv_sim,
                e.sim_pair.i_orie_sim)

    def post_bars(e):
        return (e.sim_post.area_perc, e.sim_post.neg_est_dist,
                e.sim_post.correlation)

    ub_pass, ub_post = pass_bars(ub), post_bars(ub)
    lines = []

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    def pass_case(B, H, kind):
        p1 = rng.random((B, H)) < 0.7
        cnt = rng.integers(0, 9, (5, B, H))
        if kind == "nothing passes":
            p1[:] = False
        elif kind == "every row passes":
            p1[:] = True
            cnt[:] = max(ub_pass)
        elif kind == "bars clamp at ub on the first row":
            p1[:, 0] = True
            cnt[:, :, 0] = max(ub_pass) + 5
        elif kind == "counts at the int32 extremes":
            cnt = rng.choice([I32.min, I32.min + 1, -1, 0, 3, 4, 5, 6, 7,
                              I32.max - 1, I32.max], (5, B, H))
        args = (t(p1, torch.bool), *[t(c, torch.int32) for c in cnt])
        p2, p3 = dynamic_pass_scan(*args, lb, ub)     # the query path's call
        k2, k3 = dynamic_pass_scan(*[a.cpu() for a in args], lb, ub)
        assert torch.equal(p2.cpu(), k2) and torch.equal(p3.cpu(), k3), kind
        hold_dyn_pass(args + (pass_bars(lb), ub_pass),
                      f"{kind}, B {B}, H {H}")
        if kind == "nothing passes":
            assert not p2.any() and not p3.any()
        if kind == "every row passes":
            assert p3.all()
        return f"{kind}, B {B}, H {H}: {int(p3.sum())} of {p3.numel()} pass"

    def post_case(B, n, kind):
        use = rng.random((B, n)) < 0.8
        sc = np.stack([rng.uniform(0.0, 0.2, (B, n)),
                       rng.uniform(-8.0, -3.0, (B, n)),
                       rng.uniform(0.1, 0.9, (B, n))]).astype(np.float32)
        if kind == "nothing kept":
            use[:] = False
        elif kind == "every row kept":
            use[:] = True
            sc[:] = np.asarray(ub_post, np.float32)[:, None, None]
        elif kind == "bars clamp at ub on the first row":
            use[:, 0] = True
            sc[:, :, 0] = np.asarray(ub_post, np.float32)[:, None] + 1.0
        elif kind == "NaN scores":
            sc[rng.random(sc.shape) < 0.2] = np.nan
        args = (t(use, torch.bool), *[t(x, torch.float32) for x in sc])
        keep = dynamic_post_scan(*args, lb.sim_post, ub.sim_post)
        keep_c = dynamic_post_scan(*[a.cpu() for a in args], lb.sim_post,
                                   ub.sim_post)
        assert torch.equal(keep.cpu(), keep_c), kind
        hold_dyn_post(args + (post_bars(lb), ub_post), f"{kind}, B {B}, C {n}")
        if kind == "nothing kept":
            assert not keep.any()
        if kind == "every row kept":
            assert keep.all()
        return f"{kind}, B {B}, C {n}: {int(keep.sum())} of {keep.numel()} kept"

    kinds = ("random", "nothing passes", "every row passes",
             "bars clamp at ub on the first row",
             "counts at the int32 extremes")
    pass_lines = [pass_case(B, HC, k) for B in (1, 16, 17) for k in kinds]
    pass_lines.append(pass_case(3, 2500, "random"))
    pass_lines.append(pass_case(3, 2500, "counts at the int32 extremes"))
    # bars out of order: lb above ub (the bars jump to ub at the first
    # pass) and lb equal to ub, on counts around them; bars at the int32
    # extremes, on counts at them
    odd = ((5, 2, 7, 3, 9), (3, 8, 7, 1, 12))
    ext = ((I32.min, 0, I32.max, 4, I32.min + 1),
           (I32.max, I32.min, I32.max - 1, 6, I32.max))
    for what, bars, vals in (("bars out of order", odd, None),
                             ("bars at the int32 extremes", ext,
                              [I32.min, I32.min + 1, -1, 0, 4, 6,
                               I32.max - 1, I32.max])):
        cnt = rng.integers(0, 13, (5, 16, HC)) if vals is None \
            else rng.choice(vals, (5, 16, HC))
        args = (t(rng.random((16, HC)) < 0.8, torch.bool),
                *[t(c, torch.int32) for c in cnt])
        hold_dyn_pass(args + bars, what)
        p3 = kernels.dyn_pass_scan(*args, *bars)[1]
        pass_lines.append(f"{what} {bars}, B 16, H {HC}: "
                          f"{int(p3.sum())} of {p3.numel()} pass")
    wp, wo = dyn_worst_cases(dev, HC, C)
    hold_dyn_pass(wp, "every hint a rise")
    assert kernels.dyn_pass_scan(*wp)[1].all()
    pass_lines.append(f"every hint a rise (orie 1..{HC} under ub "
                      f"{RISE_UB}), B 1, H {HC}: all pass")
    post_kinds = ("random", "nothing kept", "every row kept",
                  "bars clamp at ub on the first row", "NaN scores")
    post_lines = [post_case(B, C, k) for B in (1, 16, 17) for k in post_kinds]
    post_lines.append(post_case(3, 2500, "random"))
    hold_dyn_post(wo, "every candidate a rise")
    assert kernels.dyn_post_scan(*wo).all()
    post_lines.append(f"every candidate a rise, B 1, C {C}: all kept")
    # a NaN upper bar: torch.minimum makes the first kept row's bar NaN,
    # and no score reaches a NaN bar (contour_context_tpu's scan, and a
    # config's `.nan`, do the same)
    for B in (1, 16):
        use = np.ones((B, C), bool)
        sc = rng.uniform(0.2, 0.9, (3, B, C)).astype(np.float32)
        args = (t(use, torch.bool), *[t(x, torch.float32) for x in sc])
        bars = ((0.1, 0.1, 0.1), (float("nan"), 0.95, 0.95))
        hold_dyn_post(args + bars, f"a NaN upper bar, B {B}")
        keep = kernels.dyn_post_scan(*args, *bars)
        assert (keep.sum(-1) == 1).all(), keep.sum(-1)
        post_lines.append(f"a NaN upper bar {bars}, B {B}, C {C}: one row "
                          "of each kept")
    # -0.0 and +0.0 at the bars: one value to >=, min and max
    zs = rng.choice(np.array([0.0, -0.0, 0.25], np.float32), (3, 16, C))
    args = (t(rng.random((16, C)) < 0.9, torch.bool),
            *[t(x, torch.float32) for x in zs])
    for bars in (((0.0, -0.0, 0.0), (-0.0, 0.0, 0.5)),
                 ((-0.0, -0.0, 0.0), (0.0, 0.25, -0.0))):
        hold_dyn_post(args + bars, f"signed zeros at the bars {bars}")
        keep = kernels.dyn_post_scan(*args, *bars)
        post_lines.append(f"signed zeros at the bars {bars}, B 16, C {C}: "
                          f"{int(keep.sum())} of {keep.numel()} kept")
    lines.append("dyn_pass_scan at the edges (the wrapper through "
                 "candidate.dynamic_pass_scan, card == CPU, kernel == plain "
                 "version bit for bit): " + "; ".join(pass_lines))
    lines.append("dyn_post_scan at the edges (the same): "
                 + "; ".join(post_lines))
    return lines


def _row(kmod, label, fn, name, reps, b_us, b_by, n_bytes, ops, ops_name):
    warm = device_us(fn, name, reps, cold=False)
    cold = device_us(fn, name, reps, cold=True)
    return dict(kernel=name, case=label, device_us_warm=warm,
                device_us_cold=cold, bytes=n_bytes, **{ops_name: ops},
                bound_us=b_us, bound_by=b_by, share_of_bound=b_us / cold,
                share_of_bound_warm=b_us / warm,
                source=os.path.relpath(kmod.__file__, ROOT) if
                kmod.__file__.startswith(ROOT) else kmod.__file__)


def scaling_rows(dev, cfg: PipelineConfig, case=None, kmod=None,
                 reps: int = 50) -> list:
    """The two batched kernels across the sizes their paths give them, each
    row's device time warm and cold (mean of `reps`) beside its bytes,
    operations, bound and share, computed as `ring_bound` and
    `tilemin_batch_bound` compute them:
    - the ring at B = 1, 4, 16 and 64 (the smoke stream's first 16 scans,
      repeated), and at B = 16 with the first 9, 18 and 36 anchors a scan;
    - the batched tile-min on the bf16 capacity-8192 fixture at B = 4, 16
      and 64 (searchable_b BATCH_SN, cut or repeated), at B = 16 with every
      limit 0 (the kernel's floor: no live tile), and at B = 16 on a
      capacity-65536 map (keys_q (6, 10, 393216) bf16, 47 MB, random keys
      from a seeded generator), every query at searchable 60000.
    `kmod` is the kernel module to time (default this checkout's; see
    `other_kernels`); the bounds come from this checkout's plain versions."""
    kmod = kmod or kernels
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clk = max_sm_clock_hz()
    roi = cfg.cm.roi_radius
    (anchors, pool, centers), _ = case or ring_block_case(dev, cfg)
    rows = []
    ring_cases = [(f"B {B}", anchors.repeat(4, 1, 1)[:B].contiguous(),
                   pool.repeat(4, 1, 1)[:B].contiguous())
                  for B in (1, 4, 16, 64)]
    ring_cases += [(f"B 16, {n} anchors", anchors[:, :n].contiguous(), pool)
                   for n in (9, 18)]
    for label, a, p in ring_cases:
        _, c_p = kernels.ring_key_divs_batch_plain(a, p, centers, roi)
        b_us, b_by, exps, n_bytes = ring_bound(a, p, centers, c_p, sms, clk)
        rows.append(_row(kmod, "ring " + label,
                         lambda: kmod.ring_key_divs_batch(a, p, centers, roi),
                         "ring_key_divs_kernel", reps, b_us, b_by, n_bytes,
                         exps, "exps"))
    ql = tuple(cfg.db.q_levels)
    kb, _ = tile_store(8192)
    kq = q_layout(kb, torch.bfloat16, dev)
    tile_cases = []
    for B in (4, 16, 64):
        sn = (BATCH_SN * 4)[:B]
        tile_cases.append((f"fixture B {B}", kq, torch.from_numpy(
            batch_queries(B)[:, list(ql)]).to(dev).contiguous(),
            torch.tensor(sn, dtype=torch.int32, device=dev)))
    tile_cases.append(("fixture B 16, every limit 0", kq, tile_cases[1][2],
                       torch.zeros(16, dtype=torch.int32, device=dev)))
    gen = torch.Generator(device=dev).manual_seed(3)
    big = (torch.rand((6, 10, 65536 * 6), generator=gen, device=dev) * 4.9
           + 0.1).to(torch.bfloat16)
    tile_cases.append(("capacity 65536, B 16, searchable 60000", big,
                       tile_cases[1][2],
                       torch.full((16,), 60000, dtype=torch.int32,
                                  device=dev)))
    for label, k, q_b, sb in tile_cases:
        b_us, b_by, n_bytes, flops = tilemin_batch_bound(k, q_b, sb)
        rows.append(_row(kmod, "tile-min " + label,
                         lambda: kmod.search_tilemin_batch(k, ql, q_b, sb),
                         "search_tilemin_batch_kernel", reps, b_us, b_by,
                         n_bytes, flops, "flops"))
    del big
    return rows


def other_kernels(root: str):
    """The `ops/kernels.py` of another checkout at `root` (an unpacked
    commit), loaded as a module of its own: it builds from that checkout's
    csrc/ into that checkout's build/torch_kernels/."""
    import importlib.util

    path = os.path.join(root, "contour_context_tpu_torch", "ops",
                        "kernels.py")
    spec = importlib.util.spec_from_file_location("other_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m contour_context_tpu_torch.kernel_times",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", help="also write the rows here as JSON")
    ap.add_argument("--compare", metavar="ROOT", nargs="+", default=[],
                    help="time the scaling, CC, merge and dynamic scan rows "
                    "of the checkouts at ROOT ... too, in turns (each ROOT, "
                    "this, this, each ROOT again)")
    ap.add_argument("--only", choices=["cc_merge", "dyn", "lm", "cascade"],
                    help="cc_merge: only the CC and merge rows (with their "
                    "phase split), in turns with --compare; dyn: only the "
                    "two dynamic scans' rows (phase 9's inputs and the "
                    "worst-case rows, with their phase split and rounds), "
                    "the same way; lm: only the LM kernel's rows; cascade: "
                    "only the cascade kernel's rows")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    smi = card()
    kernels.build()
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig()
    others = [other_kernels(root) for root in args.compare]
    for other in others:
        other.build()
    order = others + [kernels, kernels] + others[::-1] if others \
        else [kernels]
    if args.only == "cascade":
        casc = cascade_rows_of(dev, cfg, args.reps)
        for r in casc:
            print(json.dumps(r), flush=True)
        print(f"card: {smi}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": smi, "cascade": casc}, f, indent=1)
        return casc
    if args.only == "lm":
        lm = lm_rows(dev, cfg, args.reps)
        for r in lm:
            print(json.dumps(r), flush=True)
        print(f"card: {smi}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": smi, "lm": lm}, f, indent=1)
        return lm
    if args.only == "dyn":
        dyn = dyn_rows(dev, cfg, order, args.reps)
        for r in dyn:
            print(json.dumps(r), flush=True)
        print(f"card: {smi}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": smi, "dyn": dyn}, f, indent=1)
        return dyn
    cc_merge = cc_merge_rows(dev, cfg, order, args.reps)
    for r in cc_merge:
        print(json.dumps(r), flush=True)
    if args.only == "cc_merge":
        print(f"card: {smi}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": smi, "cc_merge": cc_merge}, f, indent=1)
        return cc_merge
    case = ring_block_case(dev, cfg)
    for line in edge_cases(dev, cfg) + batch_edge_cases(dev, cfg) + \
            ring_batch_edge_cases(dev, cfg, case) + dyn_edge_cases(dev, cfg):
        print(line, flush=True)
    rows = measure(dev, cfg, args.reps) + [
        measure_batch(dev, cfg, args.reps),
        measure_ring_batch(dev, cfg, case, args.reps)]
    for r in rows:
        print(json.dumps(r), flush=True)
    dyn = dyn_rows(dev, cfg, order, args.reps)
    lm = lm_rows(dev, cfg, args.reps)
    casc = cascade_rows_of(dev, cfg, args.reps)
    for r in dyn + lm + casc:
        print(json.dumps(r), flush=True)
    scaling = []
    for turn, kmod in enumerate(order):
        for r in scaling_rows(dev, cfg, case, kmod):
            r["turn"] = turn
            scaling.append(r)
            print(json.dumps(r), flush=True)
    floor = launch_floor_us(dev, args.reps)
    print(f"launch floor: {floor:.3f} us (a one-element fill)", flush=True)
    print(f"card: {smi}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows, "scaling": scaling,
                       "cc_merge": cc_merge, "dyn": dyn, "lm": lm,
                       "cascade": casc,
                       "launch_floor_us": floor}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
