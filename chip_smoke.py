"""Smoke run of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases (each one raises on failure, so the
exit code is not 0):
1. the card: name and power limit from nvidia-smi; CUDA required; TF32 off;
2. build both CUDA kernels from the sources in the checkout (timed);
3. each kernel against its plain torch version on the card, at the main
   path's shapes (ring: 36 anchors x a 4096-pixel pool of a real scan;
   tile-min: a bf16 (6, 10, 49152) store with zero rows, duplicated keys, a
   searchable cutoff and an invalid query anchor), timed with CUDA events;
4. the fused stream at the default PipelineConfig (131072-point scans) with
   ContourDB(capacity=8192, device="cuda"): two lanes of 132 scans, then a
   revisit of lane 0 at 1.5 m lateral offset, 10 Hz timestamps; the launch
   counts must show both kernels ran once per scan, at least half of the
   revisits must close on the right place, and two found revisit queries
   must match the same queries on a CPU copy of the store, with the LM's
   inputs equal on both devices and the float32 LM held against a float64
   one on the same inputs;
5. the CLI on 24 scans written in the KITTI two-file format.
The last two lines are the kernel JSON and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
LANE_SCANS = 132
WARMUP = 8
REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median of REPS CUDA-event timings of fn() after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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
    smi = card()
    log(f"card: {smi}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    sys.path.insert(0, os.path.join(ROOT, "tests"))

    from synth import make_world, render_scan, se3_from_xyt

    from contour_context_tpu_torch import PipelineConfig, pad_points
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch.ops import descriptor as td
    from contour_context_tpu_torch.ops import kernels
    from contour_context_tpu_torch.profile_step import lane_poses

    dev = torch.device("cuda", 0)
    cfg = PipelineConfig()
    cm = cfg.cm

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.2f} s ({smi})")

    # ---- 3. kernels vs plain on the card --------------------------------
    rng = np.random.default_rng(0)
    world = make_world(1, n_structs=300, extent=400.0)
    pts0 = torch.from_numpy(pad_points(
        render_scan(world, lane_poses(0, 1)[0], seed=1),
        cm.max_points)).to(dev)
    bev, rowf, colf = td.rasterize_bev(pts0, cm)
    masks = bev.reshape(cm.n_row, cm.n_col)[None] > \
        torch.tensor(cm.lv_grads, device=dev)[:, None, None]
    tab = td.component_tables(td.cc_labels(masks),
                              masks.reshape(cm.n_levels, -1), bev, rowf,
                              colf, cm)
    anchors, pool, centers, _ = td.ring_inputs(tab, bev, rowf, colf, cm)
    assert anchors.shape == (36, 8) and pool.shape == (4096, 8)
    d_k, c_k = kernels.ring_key_divs(anchors, pool, centers, cm.roi_radius)
    d_p, c_p = kernels.ring_key_divs_plain(anchors, pool, centers,
                                           cm.roi_radius)
    torch.cuda.synchronize()
    torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(c_k, c_p) and float(c_p.sum()) > 0
    ring_err = float((d_k - d_p).abs().max())
    ring_ms = time_ms(lambda: kernels.ring_key_divs(anchors, pool, centers,
                                                    cm.roi_radius))
    ring_plain_ms = time_ms(lambda: kernels.ring_key_divs_plain(
        anchors, pool, centers, cm.roi_radius))
    log(f"ring_key_divs: max_abs_err {ring_err:.3g}, kernel {ring_ms:.4f} ms,"
        f" plain {ring_plain_ms:.4f} ms ({smi})")

    N, L, A, D = 8192, cm.n_levels, cm.piv_firsts, 10
    kb = rng.uniform(0.1, 5.0, (N, L, A, D)).astype(np.float32)
    kb[::7] = 0.0                       # zero rows
    kb[100:200] = kb[300:400]           # duplicated keys -> distance ties
    qk = rng.uniform(0.1, 5.0, (L, A, D)).astype(np.float32)
    qk[2, 3] = 0.0                      # an invalid query anchor
    kq = tdb.keys_to_q_layout(torch.from_numpy(kb), torch.bfloat16) \
        .contiguous().to(dev)
    ql = tuple(cfg.db.q_levels)
    q = torch.from_numpy(qk[list(ql)]).to(dev)
    state = torch.tensor([N, 7000], dtype=torch.int32, device=dev)
    t_k = kernels.search_tilemin(kq, ql, q, state)
    t_p = kernels.search_tilemin_plain(kq, ql, q, state)
    torch.cuda.synchronize()
    assert t_k.shape == (3, A, -(-N * A // 128))
    assert torch.equal(t_k, t_p), "tile minima differ"
    tile_err = float((t_k - t_p).abs().max())
    s_gpu = tdb.search(kq, torch.from_numpy(qk).to(dev), state, ql,
                       cfg.db.nnk)
    s_cpu = tdb.search(kq.cpu(), torch.from_numpy(qk), state.cpu(), ql,
                       cfg.db.nnk)
    for a, b in zip(s_gpu, s_cpu):
        assert torch.equal(a.cpu(), b), "search output differs"
    assert int(s_cpu[3].sum()) > 30
    tile_ms = time_ms(lambda: kernels.search_tilemin(kq, ql, q, state))
    tile_plain_ms = time_ms(lambda: kernels.search_tilemin_plain(
        kq, ql, q, state))
    log(f"search_tilemin: bit-equal tile minima, equal search output, "
        f"kernel {tile_ms:.4f} ms, plain {tile_plain_ms:.4f} ms ({smi})")

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

    here = "contour_context_tpu/ops/pallas_kernels.py"
    print(json.dumps({"kernels": [
        {"name": "ring_key_divs", "route": "cuda",
         "source": "contour_context_tpu_torch/csrc/ring_key.cu",
         "replaces": here + ":40", "launches": launches["ring_key_divs"],
         "max_abs_err": ring_err, "ms": ring_ms, "plain_ms": ring_plain_ms},
        {"name": "search_tilemin", "route": "cuda",
         "source": "contour_context_tpu_torch/csrc/search_tilemin.cu",
         "replaces": here + ":112", "launches": launches["search_tilemin"],
         "max_abs_err": tile_err, "ms": tile_ms,
         "plain_ms": tile_plain_ms}]}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
