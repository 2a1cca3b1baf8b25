"""The control of the comparison that decides `correct`: the plain
reference put in the program's place, with its contour moments
accumulated in float32 instead of the float64 that the port states (the
step below it; the one a faster build would be tempted to take). For each
seed it prints the numbers compared, control against reference, as a JSON
line; the limits in `limits/<cell>.json` lie below the smallest of them.

    python3 benchmark/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

The benchmark's own runs never run it. It renders the cell's inputs from
each seed as a run does and compares as many answers as a run compares
(the stream: the same sample of the window's scans; serving: every pool
cloud), at the cell's own sizes, on the card it starts on.

With `--witness <n>` it also prints the numbers of the reference on the
host's CPU against the reference on the card (`witness_numbers`): sound
arithmetic in another order of operations, which the limits leave room
for.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from harness import check  # noqa: E402
from harness.drive import plan  # noqa: E402
from harness.spec import Spec, merge  # noqa: E402


def _parts_of(a, recs_a, b, recs_b) -> dict:
    """The parts of a comparison of snapshot `a` and its records against
    snapshot `b` and its records."""
    parts = check.snapshot_parts(a, b)
    parts.update(check.record_parts(recs_a, recs_b))
    return parts


def _merge_parts(x: dict, y: dict) -> dict:
    """Two comparisons' parts as one: counts add, gaps take the wider."""
    out = dict(x)
    for k, v in y.items():
        out[k] = (max(out.get(k, 0.0), v) if "gap" in k
                  else out.get(k, 0) + v)
    return out


def control_numbers(spec: Spec, workload: str, seed: int, seconds: float,
                    device, overrides=None) -> dict:
    """The numbers compared of the float32-moment reference against the
    float64 one, on one seed, and the parts they are made of."""
    ov = overrides or {}
    wl = spec.workload(workload)
    cfg_file = merge(spec.config(wl["config"]), ov.get("config"))
    traffic = merge(spec.traffic(wl["traffic"]), ov.get("traffic"))
    p = plan(cfg_file, traffic, seconds, seed, device)
    if p["kind"] == "stream":
        host = p["post"].clouds(0, len(p["post"])).cpu()
        picks = [p["Wu"] + j for j in check.sample(
            seed, p["n_win"], int(traffic["check_sample"]))]
        rows = p["H"] + len(p["post"])
        runs = {}
        for name, dt in (("reference", torch.float64),
                         ("control", torch.float32)):
            st, recs, _ = check.reference_stream(p, cfg_file, host, device,
                                                 picks, dt)
            runs[name] = (check.snapshot(st, rows),
                          [check.as_answer(recs[j]) for j in picks])
            del st
    else:
        pool = p["queries"].clouds(0, p["n_pool"]).cpu()
        runs = {}
        for name, dt in (("reference", torch.float64),
                         ("control", torch.float32)):
            st, recs, _ = check.reference_serve(p, cfg_file, pool, device,
                                                dt)
            runs[name] = (check.snapshot(st, p["M"]),
                          [check.as_answer(r) for r in recs])
            del st
    parts = _parts_of(*runs["control"], *runs["reference"])
    return dict(check.numbers_of(parts), parts=parts,
                answers=len(runs["control"][1]))


def copy_store(st, device):
    """A PlainStore's copy on another device."""
    from plainref.query import PlainStore
    out = PlainStore.__new__(PlainStore)
    out.cfg, out.capacity, out.device = st.cfg, st.capacity, torch.device(
        device)
    out.store = type(st.store)(*[x.to(device, copy=True)
                                 for x in st.store])
    out.keys_q, out.ts_store, out.state = (
        x.to(device, copy=True)
        for x in (st.keys_q, st.ts_store, st.state))
    return out


def witness_numbers(spec: Spec, workload: str, seed: int, seconds: float,
                    device, overrides=None, items: int = 24,
                    blocks: int = 2) -> dict:
    """The numbers compared of the reference on the host's CPU against the
    reference on `device`: the same sound arithmetic in another order of
    operations (the CPU's kernels reduce in other orders than the card's),
    at the cell's sizes but on part of its work: the first `blocks`
    blocks of 16 of the history or map built on both, and, from the
    device's store at the window's start, the first `items` scans of the
    window (build, query, append, window update) or requests of the pool
    (build and query) on both."""
    from plainref.descriptor import build_descriptors
    from plainref.query import PlainStore
    ov = overrides or {}
    wl = spec.workload(workload)
    cfg_file = merge(spec.config(wl["config"]), ov.get("config"))
    traffic = merge(spec.traffic(wl["traffic"]), ov.get("traffic"))
    p = plan(cfg_file, traffic, seconds, seed, device)
    cfg = check.ref_config(cfg_file)
    cpu = torch.device("cpu")

    def build(pts):
        return build_descriptors(pts, cfg.cm, cfg.gmm)

    stream = p["kind"] == "stream"
    drive, ts_all = (p["hist"], p["ts_hist"]) if stream else (
        p["map"], p["ts_map"])
    n_rows = len(drive)
    blocks = min(blocks, n_rows // 16)
    dev_b = PlainStore(cfg, 16 * blocks, device)
    cpu_b = PlainStore(cfg, 16 * blocks, cpu)
    for i in range(blocks):
        pts = drive.clouds(16 * i, 16 * i + 16)
        ts = ts_all[16 * i:16 * i + 16]
        for st, x in ((dev_b, pts), (cpu_b, pts.to(cpu))):
            (st.block_append if stream else st.append)(build(x), ts)
    parts = _parts_of(check.snapshot(cpu_b, 16 * blocks), [],
                      check.snapshot(dev_b, 16 * blocks), [])
    del dev_b, cpu_b
    st = PlainStore(cfg, int(cfg_file["capacity"]) if stream else p["M"],
                    device)
    for b in range(0, n_rows, 16):
        pts = drive.clouds(b, b + 16)
        (st.block_append if stream else st.append)(build(pts),
                                                   ts_all[b:b + 16])
    recs_dev, recs_cpu = [], []
    if stream:
        host = p["post"].clouds(0, len(p["post"])).cpu()
        ts_post = p["ts_post"]
        for j in range(p["Wu"]):
            st.append(build(host[j].to(device)[None]), ts_post[j:j + 1])
            st.push(float(ts_post[j]))
        st_cpu = copy_store(st, cpu)
        last = min(len(host), p["Wu"] + items)
        for j in range(p["Wu"], last):
            for s, recs, x in ((st, recs_dev, host[j].to(device)),
                               (st_cpu, recs_cpu, host[j])):
                d = build(x[None])
                recs.append(check.as_answer(s.query(d).cpu().numpy()))
                s.append(d, ts_post[j:j + 1])
                s.push(float(ts_post[j]))
        rows = p["H"] + last
    else:
        st.freeze()
        st_cpu = copy_store(st, cpu)
        pool = p["queries"].clouds(0, p["n_pool"]).cpu()
        req = p["req"]
        for r in range(min(items, p["n_pool"] // req)):
            x = pool[r * req:(r + 1) * req]
            for s, recs, xx in ((st, recs_dev, x.to(device)),
                                (st_cpu, recs_cpu, x)):
                out = s.query_batch(build(xx)).cpu().numpy()
                recs.extend(check.as_answer(v) for v in out)
        rows = p["M"]
    parts = _merge_parts(parts, _parts_of(
        check.snapshot(st_cpu, rows), recs_cpu, check.snapshot(st, rows),
        recs_dev))
    return dict(check.numbers_of(parts), parts=parts, answers=len(recs_cpu))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--witness", type=int, default=0,
                    help="also the reference on the CPU against the "
                         "reference on the card, over this many window "
                         "scans or pool requests")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("refused: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    spec = Spec(ROOT, BENCH)
    limits = spec.limits(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(spec, args.workload, seed, args.seconds,
                               "cuda")
        fails = [k for k in check.NUMBERS if nums[k] > limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "what": "control", "numbers": nums,
                          "fails": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
        if args.witness:
            t0 = time.perf_counter()
            nums = witness_numbers(spec, args.workload, seed, args.seconds,
                                   "cuda", items=args.witness)
            fails = [k for k in check.NUMBERS if nums[k] > limits[k]]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "what": "witness", "numbers": nums,
                              "fails": fails,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
