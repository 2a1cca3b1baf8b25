"""Device times of the port's two CUDA kernels beside their bounds.

    python -m contour_context_tpu_torch.kernel_times [--reps 200]
        [--out FILE]

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

Ring: the 36 anchors x 4096-pixel pool of the smoke stream's first scan.
Tile-min: a bf16 (6, 10, 49152) store (capacity 8192) at searchable_n 7000
(the fixture, a long drive) and 246 (the smoke stream's last scans, 3% of
capacity). `edge_cases` holds each kernel against its plain version at the
edge shapes and names the path each took.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from contour_context_tpu_torch.config import PipelineConfig
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.ops import kernels
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


def kernel_durations_us(prof, name: str) -> list:
    """Device durations (us) of the CUDA kernels whose name holds *name* in
    a torch.profiler profile, one per launch the profiler recorded."""
    return [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and name in e.name]


def device_us(fn, name: str, reps: int, cold: bool) -> float:
    """Mean device duration (us) of the kernels named *name* over reps calls
    of fn, from torch.profiler's kernel records; cold writes 64 MB between
    calls. The profiler can lose records (seen on the H100: 199 or 10 of
    200 kept): a window that lost any is reported on stderr and profiled
    again, at most three times, and never averaged."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda") \
        if cold else None
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(reps):
                if flush is not None:
                    flush.fill_(i)
                fn()
            torch.cuda.synchronize()
        durs = kernel_durations_us(prof, name)
        if len(durs) == reps:
            return float(np.mean(durs))
        print(f"torch.profiler kept {len(durs)} of {reps} records of {name}: "
              "profiling again", file=sys.stderr, flush=True)
    raise RuntimeError(f"profiler saw {len(durs)} launches of {name}, "
                       f"expected {reps}")


def _bound(n_bytes: float, t_ops_s: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (1e6 * max(t_bytes, t_ops_s),
            "bytes" if t_bytes >= t_ops_s else "operations")


def ring_bound(anchors, pool, centers, counts, sms: int, clk_hz: float):
    """(bound us, bound_by, exps) of ring_key_divs: each input read once,
    divs and counts written once; one expf per (counted pixel, division)."""
    out_bytes = 4 * anchors.shape[0] * (kernels.N_DIV + 1)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (anchors, pool, centers)) + out_bytes
    exps = float(counts.sum()) * kernels.N_DIV
    return _bound(n_bytes, exps / (MUFU_PER_CLK_SM * sms * clk_hz)) + (exps,)


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


def ring_case(dev, cfg: PipelineConfig):
    """anchors (36, 8), pool (4096, 8), centres of the smoke stream's first
    scan, built on dev by the port's descriptor stages."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_world, render_scan

    from contour_context_tpu_torch.profile_step import lane_poses

    cm = cfg.cm
    world = make_world(1, n_structs=300, extent=400.0)
    pts = torch.from_numpy(pad_points(
        render_scan(world, lane_poses(0, 1)[0], seed=1), cm.max_points)).to(dev)
    bev, rowf, colf = td.rasterize_bev(pts, cm)
    masks = bev.reshape(cm.n_row, cm.n_col)[None] > \
        torch.tensor(cm.lv_grads, device=dev)[:, None, None]
    tab = td.component_tables(td.cc_labels(masks),
                              masks.reshape(cm.n_levels, -1), bev, rowf,
                              colf, cm)
    anchors, pool, centers, _ = td.ring_inputs(tab, bev, rowf, colf, cm)
    return anchors, pool, centers


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
    torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(c_k, c_p) and float(c_p.sum()) > 0
    b_us, b_by, exps = ring_bound(anchors, pool, centers, c_p, sms, clk)
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
            path=kernels.search_tilemin_path(kq), max_abs_err=0.0,
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
        torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-5)
        assert torch.equal(c_k, c_p), label
        lines.append(f"ring_key_divs {label}: counts exact, divs max err "
                     f"{float((d_k - d_p).abs().max()):.3g}")
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


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m contour_context_tpu_torch.kernel_times",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", help="also write the rows here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    smi = card()
    kernels.build()
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig()
    for line in edge_cases(dev, cfg):
        print(line, flush=True)
    rows = measure(dev, cfg, args.reps)
    for r in rows:
        print(json.dumps(r), flush=True)
    floor = launch_floor_us(dev, args.reps)
    print(f"launch floor: {floor:.3f} us (a one-element fill)", flush=True)
    print(f"card: {smi}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows,
                       "launch_floor_us": floor}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
