"""Smoke run of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases (each one raises on failure, so the
exit code is not 0):
1. CUDA required; the card: name and power limit from nvidia-smi; TF32 off;
2. build both CUDA kernels from the sources in the checkout (timed);
3. each kernel against its plain torch version on the card at the edge
   shapes, naming the path each took, then at the main path's shapes (ring:
   36 anchors x a 4096-pixel pool of a real scan; tile-min: a bf16
   (6, 10, 49152) store with zero rows, duplicated keys and an invalid query
   anchor, at searchable_n 7000 and 246) with its device time warm and cold
   from torch.profiler, its bound and share, its call time (host + launch)
   and its plain version's time (contour_context_tpu_torch/kernel_times.py);
   the key search on the card equals the CPU's;
4. the fused stream at the default PipelineConfig (131072-point scans) with
   ContourDB(capacity=8192, device="cuda"): two lanes of 132 scans, then a
   revisit of lane 0 at 1.5 m lateral offset, 10 Hz timestamps; the launch
   counts must show both kernels ran once per scan, at least half of the
   revisits must close on the right place, and two found revisit queries
   must match the same queries on a CPU copy of the store, with the LM's
   inputs equal on both devices and the float32 LM held against a float64
   one on the same inputs;
5. the CLI on 24 scans written in the KITTI two-file format.
The last three lines are the kernel JSON, the card's nvidia-smi name and
power limit, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
LANE_SCANS = 132
WARMUP = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def lm_witness(cfg, r_g, r_c, row: int) -> None:
    """The second witness for the 2e-3-cell pose band between the card and
    the CPU: the LM's inputs (db.refine_inputs) on the card and on the CPU
    agree (indices and masks exactly, floats to 1e-5); then the LM runs on
    the same (CPU-built) inputs as float32 on the card, float32 on the CPU
    and float64 on the CPU. The float32 runs must stray from float64 by the
    same order, which puts the band on float32 conditioning."""
    from contour_context_tpu_torch.ops.gmm import GmmScan, optimize_correlation

    for name in ("cand_gidx", "topi", "valid", "sel"):
        assert torch.equal(getattr(r_g, name).cpu(), getattr(r_c, name)), name
    for name, x, y in zip(("T0",) + tuple("src." + f for f in GmmScan._fields)
                          + tuple("tgt." + f for f in GmmScan._fields),
                          (r_g.T0,) + tuple(r_g.src) + tuple(r_g.tgt),
                          (r_c.T0,) + tuple(r_c.src) + tuple(r_c.tgt)):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-5, atol=1e-5, msg=name)

    def lm(dtype, device):
        def cast(x):
            return x.to(device, dtype)
        src = GmmScan(*[cast(x) for x in r_c.src])
        tgt = GmmScan(*[cast(x) for x in r_c.tgt])
        corr, T = optimize_correlation(src, tgt, cast(r_c.T0),
                                       r_c.sel.to(device),
                                       scale=cfg.gmm.cov_dilate_scale,
                                       iters=cfg.gmm.gn_iters)
        return corr.cpu().double()[r_c.valid], T.cpu().double()[r_c.valid]

    c_g, T_g = lm(torch.float32, torch.device("cuda", 0))
    c_c, T_c = lm(torch.float32, torch.device("cpu"))
    c_64, T_64 = lm(torch.float64, torch.device("cpu"))
    assert len(T_64) > 0, f"scan {row}: no candidate reached the LM"

    def dev(a, b):
        return float((a - b).abs().max())

    log(f"LM witness: scan {row}, {len(T_64)} candidates, inputs agree on "
        f"card and CPU; max |dT| cells: card f32 vs CPU f32 "
        f"{dev(T_g, T_c):.3g}, CPU f32 vs f64 {dev(T_c, T_64):.3g}, card "
        f"f32 vs f64 {dev(T_g, T_64):.3g}; max |dcorr|: card vs CPU "
        f"{dev(c_g, c_c):.3g}, CPU f32 vs f64 {dev(c_c, c_64):.3g}")
    assert dev(T_g, T_c) < 2e-3 and dev(c_g, c_c) < 1e-4


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    sys.path.insert(0, os.path.join(ROOT, "tests"))

    from synth import make_world, render_scan, se3_from_xyt

    from contour_context_tpu_torch import PipelineConfig, pad_points
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch import kernel_times as kt
    from contour_context_tpu_torch.ops import descriptor as td
    from contour_context_tpu_torch.ops import kernels
    from contour_context_tpu_torch.profile_step import lane_poses

    smi = kt.card()
    log(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    dev = torch.device("cuda", 0)
    cfg = PipelineConfig()
    cm = cfg.cm
    rng = np.random.default_rng(0)
    world = make_world(1, n_structs=300, extent=400.0)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.2f} s ({smi})")

    # ---- 3. kernels vs plain on the card, device times and bounds -------
    for line in kt.edge_cases(dev, cfg):
        log(line)
    rows = kt.measure(dev, cfg)
    for r in [rows[0], rows[1], rows[1]["stream"]]:
        log(f"{r.get('name', 'search_tilemin (stream)')}: {r['shape']}: "
            f"device {r['device_us_warm']:.3f} us warm, "
            f"{r['device_us_cold']:.3f} us cold (torch.profiler, mean of "
            f"200); bound {r['bound_us']:.4f} us by {r['bound_by']}, share "
            f"{r['share_of_bound']:.4f} cold; call {r['ms']:.4f} ms "
            f"(host + launch), plain {r['plain_ms']:.4f} ms ({smi})")
    log(f"launch floor: {kt.launch_floor_us(dev):.3f} us device time of a "
        f"one-element fill ({smi})")
    kb, qk = kt.tile_store(8192)
    kq = kt.q_layout(kb, torch.bfloat16, dev)
    ql = tuple(cfg.db.q_levels)
    state = torch.tensor([8192, 7000], dtype=torch.int32, device=dev)
    s_gpu = tdb.search(kq, torch.from_numpy(qk).to(dev), state, ql,
                       cfg.db.nnk)
    s_cpu = tdb.search(kq.cpu(), torch.from_numpy(qk), state.cpu(), ql,
                       cfg.db.nnk)
    for a, b in zip(s_gpu, s_cpu):
        assert torch.equal(a.cpu(), b), "search output differs"
    assert int(s_cpu[3].sum()) > 30
    log("search: the card's output equals the CPU's")

    # ---- 4. the stream --------------------------------------------------
    t0 = time.perf_counter()
    plan = (lane_poses(0, LANE_SCANS) + lane_poses(1, LANE_SCANS)
            + lane_poses(0, LANE_SCANS, dy=1.5))
    clouds = [pad_points(render_scan(world, p, seed=int(rng.integers(1 << 30))),
                         cm.max_points) for p in plan]
    log(f"rendered {len(clouds)} scans in {time.perf_counter() - t0:.1f} s")
    db = tdb.ContourDB(cfg, capacity=8192, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    handles = []
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    for k, pts in enumerate(clouds):
        if k == WARMUP:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
            ev0.record()
        handles.append(db.step_async(pts, k, 0.1 * k))
    ev1.record()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {"ring_key_divs": kernels.ring_key_divs.launches,
                "search_tilemin": kernels.search_tilemin.launches}
    n_scans = len(clouds)
    assert launches["ring_key_divs"] == n_scans, launches
    assert launches["search_tilemin"] == n_scans, launches
    ms_scan = ev0.elapsed_time(ev1) / (n_scans - WARMUP)
    wall_ms = 1e3 * (t_end - t_warm) / (n_scans - WARMUP)
    peak = torch.cuda.max_memory_allocated()
    store_b = db.store_bytes()
    recs = db.drain(handles)
    ring = db.recs_store[:n_scans].cpu().numpy()
    assert np.isfinite(ring).all() and ring.shape == (n_scans, 18)
    rev0 = 2 * LANE_SCANS
    right = elsewhere = 0
    for i in range(LANE_SCANS):
        r = recs[rev0 + i]
        if r is None:
            continue
        if abs(db.seq_of_gidx[r[0]] - i) <= 3:
            right += 1
        else:
            elsewhere += 1
    log(f"stream: {n_scans} scans, launches {launches}, revisits found in "
        f"the right place {right}/{LANE_SCANS}, elsewhere {elsewhere}; "
        f"first {WARMUP} scans {1e3 * (t_warm - t0) / WARMUP:.2f} ms/scan "
        f"(warm-up)")
    log(f"stream: {ms_scan:.3f} ms/scan (CUDA events), {wall_ms:.3f} ms/scan "
        f"(host clock), store {store_b} bytes, peak allocated {peak} bytes "
        f"({smi})")
    log(f"counters: {db.counters}")
    assert right >= LANE_SCANS // 2, (right, elsewhere)

    # reference check: revisit scans' descriptors built on the card and on
    # the CPU, and their queries replayed on the card and on a CPU copy of
    # the store at the window state the stream had then (replayed from the
    # timestamps); all must agree with the records the stream wrote
    store_c = type(db.store)(*[x.cpu() for x in db.store])
    kq_c, ts_c, tb = db.keys_q.cpu(), db.ts_store.cpu(), cfg.db.tb
    found_rows = [r for r in range(rev0, n_scans) if recs[r] is not None]
    for row in (found_rows[len(found_rows) // 3],
                found_rows[3 * len(found_rows) // 4]):
        qpts = torch.from_numpy(clouds[row])
        desc_g = td.build_descriptor(qpts.to(dev), cm, cfg.gmm)
        desc_c = td.build_descriptor(qpts, cm, cfg.gmm)
        # the bands of tests/test_torch_descriptor.py: ints exact, floats
        # 1e-5, keys 1e-4, eigen-derived leaves and com_r atol 1e-4,
        # nei_theta on valid slots
        loose = ("com_r", "eig_vecs", "manual_cov", "gmm_pack", "tab12",
                 "keys")
        for name, x, y in zip(desc_g._fields, desc_g, desc_c):
            x = x.cpu()
            if name == "nei_theta":
                x, y = x[desc_c.nei_valid], y[desc_c.nei_valid]
            if x.is_floating_point():
                torch.testing.assert_close(
                    x, y, rtol=1e-4 if name == "keys" else 1e-5,
                    atol=1e-4 if name in loose else 1e-5, msg=name)
            else:
                assert torch.equal(x, y), name
        state = torch.zeros(2, dtype=torch.int32)
        for j in range(row):
            state[0] = j + 1
            tdb.update_window(state, ts_c, ts_c[j], tb.min_elapse,
                              tb.max_elapse)
        desc_gc = type(desc_g)(*[x.cpu() for x in desc_g])
        rec_g = tdb.query_step(db.store, db.keys_q, desc_g, state.to(dev),
                               cfg).cpu()
        rec_c = tdb.query_step(store_c, kq_c, desc_gc, state, cfg)
        rec_s = db.recs_store[row].cpu()
        exact = [0, 1] + list(range(6, 18))
        for rec in (rec_g, rec_c):
            assert torch.equal(rec[exact], rec_s[exact]), (rec, rec_s)
            torch.testing.assert_close(rec[2], rec_s[2], rtol=1e-4,
                                       atol=1e-4)
            # the LM refinement amplifies last-ulp differences into the pose
            torch.testing.assert_close(rec[3:6], rec_s[3:6], rtol=1e-4,
                                       atol=2e-3)
        log(f"reference check: scan {row}: card and CPU descriptors agree; "
            f"card query == CPU query == stream record {rec_s.tolist()}")
        lm_witness(cfg, tdb.refine_inputs(db.store, db.keys_q, desc_g,
                                          state.to(dev), cfg),
                   tdb.refine_inputs(store_c, kq_c, desc_gc, state, cfg), row)

    # host syncs of the step, counted by torch's sync debug mode
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        caught.clear()   # switching the mode on warns of a sync of its own
        try:
            for i in range(4):
                db.step_async(clouds[rev0 + i], n_scans + i,
                              0.1 * (n_scans + i))
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught) / 4
    log(f"host syncs per scan: {syncs:g} (torch sync debug mode, 4 scans)")

    # ---- 5. the CLI -----------------------------------------------------
    from contour_context_tpu_torch.__main__ import main as cli_main

    with tempfile.TemporaryDirectory() as d:
        pl, ll = [], []
        for i, p in enumerate(lane_poses(0, 24)):
            cloud = clouds[i]
            cloud = cloud[cloud[:, 3] > 0].copy()
            cloud[:, 3] = 0.0
            bp = os.path.join(d, "%06d.bin" % i)
            cloud.tofile(bp)
            T = se3_from_xyt(p)
            pl.append("%.6f %s" % (0.1 * i, " ".join(
                "%.6f" % v for v in T[:3, :4].reshape(-1))))
            ll.append("%.6f %d %s" % (0.1 * i, i, bp))
        f_pose, f_laser = os.path.join(d, "p.txt"), os.path.join(d, "l.txt")
        f_out = os.path.join(d, "outcome.txt")
        open(f_pose, "w").write("\n".join(pl))
        open(f_laser, "w").write("\n".join(ll))
        cli_main(["--pose", f_pose, "--laser", f_laser, "--outcome", f_out,
                  "--device", "cuda"])
        lines = open(f_out).read().splitlines()
        assert len(lines) == 24, len(lines)
    log("cli: 24 outcome lines")

    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(kt.card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
