"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix,
its limits and its metrics are found by name (`harness/spec.py`). Set-up
builds the history or the map and warms every shape the window uses;
then the window runs for `--seconds`; then the program's outputs are held
against the plain reference (`harness/check.py`). The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` a `breakdown`, and last the numbers
compared beside their limits (`checks`), which also end standard error.

Exits with another code than 0, printing no result, when there is no CUDA
card or fewer cards than the cell asks for, when TF32 is on, when the
cell's DB would grow inside the window, or when a module of JAX or of the
JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import check, guard  # noqa: E402
from harness.drive import (Refused, plan, run_serve, run_stream,  # noqa: E402
                           setup_serve, setup_stream)
from harness.spec import Spec, dataclass_from_dict, merge  # noqa: E402
from harness.trace import ITEM  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def _check_precision() -> None:
    torch.backends.cudnn.allow_tf32 = False
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise Refused("TF32 is on: the port and the reference need full "
                      "float32 matmuls")


def _check_trace(profile, bounds) -> None:
    """The profile must hold a record of every launch of the port's
    kernels that the reference counts in the traced slice: a profiler
    that drops records reads busy time and launches short."""
    from harness.roofline import PORT_KERNELS
    from harness.trace import union, inside
    w = union(profile.item_windows())
    seen = [n for n, st, _ in profile.device_ops
            if any(k in n for k in PORT_KERNELS) and inside(st, w)]
    if len(seen) != len(bounds):
        from collections import Counter
        raise RuntimeError(
            f"the trace holds {len(seen)} launches of the port's kernels "
            f"where the reference counts {len(bounds)}: the profiler "
            f"dropped records ({dict(Counter(n[:40] for n in seen))}; "
            f"{dict(Counter(k for k, _ in bounds))})")


def host_threads(spec: Spec, workload: str):
    """The host threads for torch's CPU work that the cell's deployment
    states (`host_threads` in its configuration), or None: torch's
    default."""
    n = spec.config(spec.workload(workload)["config"]).get("host_threads")
    return None if n is None else int(n)


class Run:
    """What a metric reader reads: the window, set-up, the trace, the
    reference's record of the kernels' work in the traced slice."""

    def __init__(self, kind, window, setup_s, kernel_calls):
        self.kind = kind
        self.window = window
        self.setup_s = setup_s
        self.kernel_calls = kernel_calls

    def latencies_s(self) -> list:
        w = self.window
        return [d - due for d, due in zip(w.done, w.due)]

    def untraced(self) -> list:
        """Items outside the profiled slice (their host times carry no
        profiler cost)."""
        lo, hi = self.window.slice
        return [j for j in range(self.window.items) if not lo <= j < hi]

    def item_windows(self) -> list:
        """The traced items' windows on the profile's clock
        (`Profile.item_windows`)."""
        p = self.window.profile
        return [] if p is None else p.item_windows()


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", overrides=None,
             t_start: float = None) -> dict:
    """One run of a cell: set-up, the window, the comparison, the metrics.
    Returns the result object. `overrides` patches the configuration
    file, the traffic mix and the limits ({"config": {...}, "traffic":
    {...}, "limits": {...}}: small sizes for tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    ov = overrides or {}
    wl = spec.workload(workload)
    cfg_file = merge(spec.config(wl["config"]), ov.get("config"))
    traffic = merge(spec.traffic(wl["traffic"]), ov.get("traffic"))
    limits = merge(spec.limits(workload), ov.get("limits"))
    from contour_context_tpu_torch.config import PipelineConfig
    cfg = dataclass_from_dict(PipelineConfig(), cfg_file["pipeline"])
    if torch.device(device).type == "cuda":
        _check_precision()
        torch.cuda.reset_peak_memory_stats(device)
    p = plan(cfg_file, traffic, seconds, seed, device)
    kind = p["kind"]
    trace_cfg = ({"start": traffic.get("profile_start", 0),
                  "items": traffic["profile_items"]} if trace else {})
    if kind == "stream":
        db, host = setup_stream(p, cfg, cfg_file, traffic, device, trace)
        setup_s = time.perf_counter() - t_start
        w = run_stream(db, host, p, trace_cfg, device)
    else:
        db, host = setup_serve(p, cfg, cfg_file, traffic, device, trace)
        setup_s = time.perf_counter() - t_start
        w = run_serve(db, host, p, seconds, trace_cfg, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    guard.check(guard.FORBIDDEN, "the run")
    counters = db.counters if kind == "stream" else db.serving_counters
    hints = counters["n_hints"] / max(1, w.clouds + (p["Wu"] if kind ==
                                                     "stream" else 0))
    rows = p["H"] + len(p["post"]) if kind == "stream" else p["M"]
    prog = check.snapshot(db, rows, db.n)
    db.drop_graphs()
    del db
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if kind == "stream":
        numbers, parts, bounds, n_cmp = check.compare_stream(
            p, cfg_file, traffic, w, prog, host, device, seed)
    else:
        numbers, parts, bounds, n_cmp = check.compare_serve(
            p, cfg_file, w, prog, host, device)
    ref_s = time.perf_counter() - t_ref
    if w.profile is not None and torch.device(device).type == "cuda":
        _check_trace(w.profile, bounds)
    correct = check.verdict(numbers, limits)
    run = Run(kind, w, setup_s, bounds)
    kinds = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(workload, kinds):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": w.clouds, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace and w.profile is not None:
        spans = w.profile.spans(ITEM)
        from harness.trace import length
        dev["busy_s"] = length(w.profile.device_intervals()) / 1e6
        dev["window_s"] = w.prof_wall_s
        result["breakdown"] = w.profile.breakdown(spans)
    late = [s - d for s, d in zip(w.start, w.due)]
    lat = sorted(1e3 * (d - s) for d, s in zip(w.done, w.due))
    q = {f"p{int(100 * x)}": lat[min(len(lat) - 1, int(x * len(lat)))]
         for x in (0.5, 0.9, 0.99)}
    result["notes"] = {
        "kind": kind, "items": w.items, "window_s": w.seconds,
        "setup_s": setup_s, "compared": n_cmp, "reference_s": ref_s,
        "parts": parts, "late_ms_max": 1e3 * max(late), "late_ms_mean":
        1e3 * float(np.mean(late)), "hints_per_cloud": hints,
        "latency_ms": dict(q, max=lat[-1], over_30=sum(x > 30 for x in lat),
                           slowest_at=int(np.argmax([d - s for d, s in
                                                     zip(w.done, w.due)])))}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in check.NUMBERS}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec(ROOT, BENCH)
    wl = spec.workload(args.workload)
    if not torch.cuda.is_available():
        log("refused: CUDA is not available")
        return 2
    if torch.cuda.device_count() < int(wl["chips"]):
        log(f"refused: {torch.cuda.device_count()} cards, the cell asks "
            f"for {wl['chips']}")
        return 2
    log(f"card: {card_line()}")
    threads = host_threads(spec, args.workload)
    if threads is not None:
        torch.set_num_threads(threads)
    log(f"host threads: {torch.get_num_threads()}")
    # the reference loads before the program, and loads none of it
    import plainref.query  # noqa: F401
    guard.check((guard.PROGRAM,) + guard.FORBIDDEN, "the reference")
    try:
        result = run_cell(spec, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_start=T_START)
    except Refused as e:
        log(f"refused: {e}")
        return 2
    n = result["notes"]
    what = "scans" if n["kind"] == "stream" else "requests"
    log(f"window: {n['items']} {what} in {n['window_s']:.3f} s; the "
        f"generator ran late by "
        f"{n['late_ms_mean']:.4f} ms on average, {n['late_ms_max']:.4f} ms "
        f"at most; hints per cloud {n['hints_per_cloud']:.2f}; "
        f"set-up {n['setup_s']:.3f} s; {n['compared']} answers compared "
        f"against the reference in {n['reference_s']:.3f} s")
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
