"""Smoke run of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases (each one raises on failure, so the
exit code is not 0):
1. CUDA required; the card: name and power limit from nvidia-smi; TF32 off;
2. build the CUDA kernels from the sources in the checkout, one nvcc a
   source, all started together (timed);
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
   revisit of lane 0 at 1.5 m lateral offset, 10 Hz timestamps, every step
   a replay of the step's CUDA graph (the first step runs the body eagerly
   and captures it; the replays after the warm-up run under torch's sync
   debug mode "error", so a host sync fails the phase); the capture time,
   ms/scan and the graph pool's bytes, beside the same scans through the
   eager body the graph captured (ms/scan; store, window and records bit
   for bit equal); the launch counts must show each of the five kernels of
   the step (ring, tile-min, CC labels, merge, LM) ran once per scan,
   replays counted; at least half of the revisits must close on the right
   place, and two found revisit queries must match the same queries on a
   CPU copy of the store, with the LM's inputs equal on both devices; the
   LM of every found revisit query on the same inputs as float32 on the
   card and on the CPU, within LM_BAND cells of each other, each beside a
   float64 LM; 0 host syncs a scan;
3d. (after 4) the CC-label kernel bit-equal to its plain version on masks
   made to stress it (a spiral, a comb, a checkerboard, full, empty,
   staircases, a random field, a U joined in its last rows, a serpentine,
   two interleaved combs; at 150 x 150 and, for the cluster's strips, at
   37 x 41, 8 x 8 and 5 x 7) and at the main path's shapes (a revisit
   scan's 6 level masks, the stream's first block's 96), the merge kernel
   on rows made to stress its lanes and at a revisit query's and 16
   revisit queries' inputs on the stream's DB, each with its device time
   warm and cold, bound and share, call and plain ms, and its split by
   phase (clock64 stamps of the kernel's measurement entry); what the
   cascade's columns past each query's own chunks cost 8 queries of the
   stream;
4b. (after 4's stream, before its reference check) the LM kernel
   bit-equal to its plain twin at its edge cases and at a revisit query's
   (10 rows) and 16 revisit queries' (160 rows) inputs on the stream's DB,
   with its times beside its twin's and the torch chain's it replaced;
4c. (after 4b) the cascade kernel bit-equal to its plain twin on the rows
   made to take each edge (p_pot 8, 128 and None) and at a revisit
   query's (256 rows) and 16 revisit queries' (4,096 rows) hint rows on
   the stream's DB, with its times, bound and device ops beside its
   twin's;
5. the CLI's default (unfused) path on 24 scans written in the KITTI
   two-file format, every stage a replay of one of the DB's graphs (the
   per-scan build, query_async, add_scan, push_and_balance): the CLI's
   launches; the same run through `LoopClosurePipeline` graphed, through
   the eager bodies and graphed again, each timed by stage with a sync
   after each stage and again without the syncs (the scans after the
   first two, which capture, under sync debug mode "error"), every outcome
   file bit-equal to the CLI's; then 32 scans and their 32 revisits
   through query_async / add_scan / push_and_balance beside step_async on
   a DB of its own, each query_async record bit-equal to the step's at
   the same window state;
3b. (after 3) the batched tile-min against its plain version on the card:
   bf16 and f32, the vector and the scalar path, B = 1 equal to the
   single-query kernel; its device time at B = 16 beside its bound and the
   16 single launches that answer the same queries;
3c. the batched ring key (one launch for the B scans of a block) bit-equal
   to its plain version and to one single launch a scan, at B = 1, with a
   zero cloud (an empty pool) in the batch, at B = 17, with every pixel
   counting for every anchor, at pools of 1, 4095 and 4097 rows and at
   65535 anchors a scan; its device time at the stream's first block of 16
   beside its bound and the 16 single launches of the same scans; then
   both batched kernels across sizes (kernel_times.scaling_rows: the ring
   at B = 1, 4, 16, 64 and at 9 and 18 anchors, the tile-min at B = 4, 16,
   64, with every limit 0 and on a capacity-65536 map), each beside its
   bytes, operations, bound and share;
6. a map built in blocks: the stream's first 264 clouds through
   `block_chain_pts_async` in 16 blocks of 16 and an 8-scan tail through
   `step_async`; records and window state must equal the stream's first 264
   rows (found, gidx and counters exactly), the store and keys_q too, bit
   for bit but for float leaves the script names, held in the descriptor
   bands; each block a replay of the build graph, of the append graph
   (the appends and the window pushes) and of the query graph of 16 (the
   blocks after the capture under sync debug mode "error"), beside
   the same map built through the eager calls (ms/scan; store, window and
   records bit for bit equal), the capture times and pool bytes; one
   batched ring launch, one batched tile-min launch, one CC and one merge
   launch a block, one launch of each single kernel a tail scan; the CC and
   merge kernels bit-equal to their plain versions on the last full block's
   and on 16 revisit clouds' tensors; both batched kernels bit-equal to
   their plain versions on what the block build gave them (the last full
   block's anchors and pools; the map's keys_q with that block's query keys
   and replayed limits); its ms/scan is printed between the stream's over
   the same scans before and after it; one block step of 16 revisit
   queries is split into build, batched search and the batched tail, the
   build and the tail each beside the same 16 clouds or queries run one at
   a time through the same code (B = 1), with the device operations and
   host syncs of both: the descriptors must agree (ints exactly, floats in
   the descriptor bands), the records too, the batched build must make no
   more host syncs than the slowest single build and the batched tail at
   most 2; then the same block step of 16 as replays of the block-built
   map's build and query graphs beside the eager bodies (ms, 0 host syncs,
   launches, the device ops torch.profiler sees in each; records bit for
   bit equal);
7. checkpoints: the block-built map saved and loaded on the card, the
   stream DB as a base + a delta of 16 more scans through `load_chain`, each
   equal to its original bit for bit; the block-built map merged with its
   reloaded copy into a serving map of 528 rows;
8. serving: the 132 revisit clouds through `localize_block_async` in chunks
   of 16 (the 4-cloud tail padded) against the merged map, each chunk a
   replay of the serving map's build and query graphs (captured by a first
   chunk before the timing), beside the eager calls (ms/query, records bit
   for bit equal), a chunk under sync debug mode "error", the capture times
   and pool bytes; one batched ring launch, one batched tile-min launch,
   one CC and one merge launch a chunk (the CC and merge kernels bit-equal
   to their plain versions on the first and the padded last chunk; the
   tile-min
   bit-equal to its plain version on the merged map's keys_q with the first
   chunk's keys and with the padded last chunk's, the ring on the padded
   chunk's anchors and pools), at least half found at the right place, two
   records equal to `query_async` on the card and on a CPU copy of the map,
   one `range_search` equal on both; ms/query, device operations and host
   syncs of one chunk, peak allocated bytes beside f96694d's, and the bytes
   one batched build of 16 adds at its peak; the block-built map and the
   serving map, each with the graphs of 16, hold one graph pool (one pool
   id on every graph, that id's segments the pool's bytes, and the serving
   map's captures growing the reserved memory by less than half of it);
   then `range_search` (the tile-min cover, one replay of the range graph
   of its cap) on the merged map, the stream DB and 65,536 rows tiled
   from the merged map (every key tied with its copies), at radius 60 and
   cap 256 and at radius 1e12 and cap 4096: graphed, through the eager
   body and on a CPU copy, hits and counts equal across the three; ms/call
   graphed and eager (CUDA events, medians of 15 in turns), the capture
   time, one host sync a call (the fetch);
9. `dynamic_thres=True`: both dynamic kernels bit-equal to their plain
   versions at the edges (nothing passes, every row passes, the bars clamp
   at ub on the first row; B = 1, 16 and 17; H at its cap and rows of
   2500; counts and bars at the int32 extremes; every step a rise; a NaN
   upper bar, NaN scores, signed zeros at the bars), a 64-scan stream as
   replays of the step's graph (the scans after the first under sync
   debug mode "error"; one launch of each dynamic kernel a scan) against
   the eager body bit for bit and the CPU in the record bands, ms/scan
   graphed and eager; one block of 16
   revisit queries as the build and query graphs of 16, against the eager
   bodies and the CPU; each kernel at the stream's and the block's inputs
   and on a row where every step is a rise, with its device time warm and
   cold, its ballot rounds and split by phase, bound, call and plain ms;
10. the user-facing surface, each path's launches counted from 0 just
   before it: the stream's first 80 clouds in chains (`step_chain_async`, 4
   of 16, then 5 + 11 of a 16-row buffer through `step_chain_dyn_async`, the
   second with a staged `stage_chain_k`; every chain after the first under
   sync debug mode "error"), one BlockHandle each, records equal to the
   stream's, one launch of each kernel a scan; the host spec
   query (`query_ranged_knn_host`) on 8 revisits at their replayed window
   states on the card and on a CPU copy, one tile-min launch a query, equal
   to each other and (found, gidx) to the fused query wherever its hint cap
   did not overflow, both paths' ms/query; the CLI on phase 5's dataset with
   `--save-mid-dir`, `--timing-log` and `--trace-dir` (24 dumps and BEV
   images, a Chrome trace naming both kernels, the native loader built),
   `eval.pr_mpe.score_outcome` of its outcome, `eval.sweep.run_sweep_id`
   over two threshold dirs, and `q16_transport`, `block_for_timing` and a
   mid-stream drain every 8 writing the plain run's outcome file; the
   online spinner fed 80 scans from a thread, paused and resumed through
   its control file, its detections equal to the found records of a
   `step_async` stream of the same scans, nothing dropped, its launches
   counted alone; then the same feed while the main thread replays the
   serving map's graphs of 16 (the same pool), the spinner's launches
   counted and the serving thread's recorded apart, the same detections,
   every serving chunk bit-equal to its eager calls;
11. sharded serving and search (contour_context_tpu_torch/parallel.py),
   the launches of each path counted from 0 just before it: a world of one
   rank over NCCL in this process, every entry point one CUDA graph
   replay a call (the first captures), each replay under sync debug mode
   "error" and bit-equal to the eager body (`sharded_search` and
   `sharded_search_batch` on phase 3's tile-min fixture with f32 keys,
   `sharded_query_step` on the stream's first two found revisits,
   `sharded_query_step_batch` on the first chunk, the 132 revisit clouds
   served by `sharded_localize_block` in chunks of 16 on the merged map,
   graphed and eager in turns, and two `sharded_process_block` of 16
   revisit descriptors in turn through one graph on the sharded stream
   DB; each equal to the single-device f32-key path; 0 host syncs a
   chunk; the capture seconds, the launches of one replay and the shared
   pool's bytes; no graph left once its shard is gone), then a
   world of two ranks over gloo (eager: its collectives run on the host),
   both on this card, spawned: each loads
   the merged map from its checkpoint, shards it and serves the 132
   clouds, serves the first chunk again from the map cut to an odd row
   count, and runs one `sharded_process_block` of 16 revisit descriptors
   over the sharded stream DB; every rank's records equal the
   single-device f32-key ones, and each rank reports its launches of each
   kernel, its shard bytes and its peak allocated bytes; ms/query of both
   worlds beside the single-device serving of this call.
The last three lines are the kernel JSON, the card's nvidia-smi name and
power limit, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
LANE_SCANS = 132
WARMUP = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def lm_inputs_agree(r_g, r_c, row: int) -> None:
    """The LM's inputs (db.refine_inputs) of one query on the card and on
    the CPU agree: indices and masks exactly, floats to 1e-5."""
    from contour_context_tpu_torch.ops.gmm import GmmScan

    for name in ("cand_gidx", "topi", "valid", "sel"):
        assert torch.equal(getattr(r_g, name).cpu(), getattr(r_c, name)), name
    for name, x, y in zip(("T0",) + tuple("src." + f for f in GmmScan._fields)
                          + tuple("tgt." + f for f in GmmScan._fields),
                          (r_g.T0,) + tuple(r_g.src) + tuple(r_g.tgt),
                          (r_c.T0,) + tuple(r_c.src) + tuple(r_c.tgt)):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-5, atol=1e-5, msg=name)
    log(f"LM witness: scan {row}: the LM's inputs agree on card and CPU")


# the LM's pose band (cells) between float32 runs on the card and on the
# CPU on the same inputs. Over the 352 candidates of this stream's 132
# found revisit queries an H100 read up to 2.74e-3, with the LM kernel and
# with the torch chain it replaced alike, and each float32 run strays as
# far from a float64 one (up to 2.61e-3 on the CPU, 2.74e-3 on the card):
# float32 conditioning of the LM at a flat optimum, not its order of sums
LM_BAND = 4e-3


def lm_witness(cfg, db, clouds, rows, ts_c) -> None:
    """The witness for the LM's pose band between the card and the CPU:
    the LM inputs of each found revisit query in `rows` (ascending; built
    on the card at the window state replayed from the timestamps ts_c) run
    as float32 on the card (the kernel), float32 on the CPU (the plain
    twin) and float64 on the CPU. Card and CPU agree within LM_BAND cells
    and 1e-4 in correlation on every candidate; logs the largest
    deviations, all candidates' and the records' rows'."""
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch.ops import descriptor as td
    from contour_context_tpu_torch.ops.gmm import GmmScan, optimize_correlation

    dev = db.keys_q.device
    tb, g = cfg.db.tb, cfg.gmm
    state = torch.zeros(2, dtype=torch.int32)
    j = n_cand = 0
    worst = {k: (0.0, -1) for k in ("card-CPU", "CPU-f64", "card-f64",
                                   "record card-CPU", "corr")}
    for row in rows:
        while j < row:
            state[0] = j + 1
            tdb.update_window(state, ts_c, ts_c[j], tb.min_elapse,
                              tb.max_elapse)
            j += 1
        desc = td.build_descriptor(torch.from_numpy(clouds[row]).to(dev),
                                   cfg.cm, g)
        r = tdb.refine_inputs(db.store, db.keys_q, desc, state.to(dev), cfg)
        valid = r.valid.cpu()

        def lm(dtype, device):
            def cast(x):
                return x.to(device, dtype)
            corr, T = optimize_correlation(
                GmmScan(*[cast(x) for x in r.src]),
                GmmScan(*[cast(x) for x in r.tgt]), cast(r.T0),
                r.sel.to(device), scale=g.cov_dilate_scale, iters=g.gn_iters)
            return corr.cpu().double()[valid], T.cpu().double()[valid]

        c_g, T_g = lm(torch.float32, dev)
        c_c, T_c = lm(torch.float32, torch.device("cpu"))
        c_64, T_64 = lm(torch.float64, torch.device("cpu"))
        n_cand += len(T_g)
        best = int(c_g.argmax())
        for key, x in (("card-CPU", (T_g - T_c).abs().max()),
                       ("CPU-f64", (T_c - T_64).abs().max()),
                       ("card-f64", (T_g - T_64).abs().max()),
                       ("record card-CPU", (T_g[best] - T_c[best]).abs().max()),
                       ("corr", (c_g - c_c).abs().max())):
            if float(x) > worst[key][0]:
                worst[key] = (float(x), row)
    log(f"LM witness over {len(rows)} found revisit queries, {n_cand} "
        f"candidates, each on the same inputs on card and CPU; largest "
        f"deviation (scan): " + ", ".join(
            f"{k} {v:.3g} ({r})" for k, (v, r) in worst.items())
        + f"; band {LM_BAND} cells")
    assert worst["card-CPU"][0] < LM_BAND and worst["corr"][0] < 1e-4, worst


EXACT = [0, 1] + list(range(6, 18))      # found, gidx, counters of a record
# descriptor leaves in the 1e-4 bands of tests/test_torch_descriptor.py
LOOSE = ("com_r", "eig_vecs", "manual_cov", "gmm_pack", "tab12", "keys")


def desc_leaves_close(fields, xs, ys, valid_nei, what: str) -> list:
    """Descriptor leaves (any leading axes, on any devices): ints and bools
    exactly; a float leaf bit for bit or else in the bands of
    tests/test_torch_descriptor.py (floats 1e-5, keys rtol 1e-4, LOOSE atol
    1e-4, nei_theta on valid slots). Returns [(leaf, max abs difference)]
    of the float leaves that are not bit-equal."""
    off = []
    for name, x, y in zip(fields, xs, ys):
        x, y = x.cpu(), y.cpu()
        if torch.equal(x, y):
            continue
        assert x.is_floating_point(), f"{what}: {name}"
        if name == "nei_theta":
            x, y = x[valid_nei], y[valid_nei]
        torch.testing.assert_close(
            x, y, rtol=1e-4 if name == "keys" else 1e-5,
            atol=1e-4 if name in LOOSE else 1e-5, msg=f"{what}: {name}")
        off.append((name, float((x - y).abs().max())))
    return off


def assert_records_close(a, b, what: str) -> None:
    """Two (n, 18) record arrays in the stream's bands: found, gidx and
    counters exactly, corr to 1e-4, the pose of found rows to rtol 1e-4 and
    atol 2e-3 cells (the LM amplifies last-ulp differences)."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(a[:, EXACT], b[:, EXACT], err_msg=what)
    np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=1e-4, atol=1e-4,
                               err_msg=what)
    found = b[:, 0] > 0.5
    np.testing.assert_allclose(a[found, 3:6], b[found, 3:6], rtol=1e-4,
                               atol=2e-3, err_msg=what)


def assert_dbs_equal(a, b, n: int, what: str) -> None:
    """The first n rows of two DBs' stores, keys_q and timestamps, bit for
    bit (the DBs may live on different devices)."""
    for name, x, y in zip(a.store._fields, a.store, b.store):
        assert torch.equal(x[:n].cpu(), y[:n].cpu()), f"{what}: {name}"
    A = a.store.keys.shape[2]
    assert torch.equal(a.keys_q[:, :, :n * A].cpu().view(torch.int16),
                       b.keys_q[:, :, :n * A].cpu().view(torch.int16)), \
        f"{what}: keys_q"
    assert torch.equal(a.ts_store[:n].cpu(), b.ts_store[:n].cpu()), \
        f"{what}: ts_store"


def assert_dbs_close(a, b, n: int, what: str) -> list:
    """`assert_dbs_equal` for two DBs whose descriptors were built at
    different batch sizes: store leaves by `desc_leaves_close`; keys_q bit
    for bit unless the keys differ, then each bf16 key within one bf16 step
    (2^-8 relative); timestamps exactly. Returns the leaves that are not
    bit-equal with their largest difference."""
    off = desc_leaves_close(a.store._fields, [x[:n] for x in a.store],
                            [x[:n] for x in b.store],
                            b.store.nei_valid[:n].cpu(), what)
    A = a.store.keys.shape[2]
    ka, kb = (m.keys_q[:, :, :n * A].cpu() for m in (a, b))
    if not torch.equal(ka.view(torch.int16), kb.view(torch.int16)):
        assert "keys" in [o[0] for o in off], f"{what}: keys_q"
        torch.testing.assert_close(ka.float(), kb.float(), rtol=2 ** -8,
                                   atol=0, msg=f"{what}: keys_q")
        off.append(("keys_q", float((ka.float() - kb.float()).abs().max())))
    assert torch.equal(a.ts_store[:n].cpu(), b.ts_store[:n].cpu()), \
        f"{what}: ts_store"
    return off


def write_kitti(d: str, clouds, poses) -> tuple:
    """The clouds (their valid rows, reflectance 0) and poses in the KITTI
    two-file format under d, 10 Hz timestamps: (pose file, scan list)."""
    from synth import se3_from_xyt

    pl, ll = [], []
    for i, p in enumerate(poses):
        cloud = clouds[i][clouds[i][:, 3] > 0].copy()
        cloud[:, 3] = 0.0
        bp = os.path.join(d, "%06d.bin" % i)
        cloud.tofile(bp)
        T = se3_from_xyt(p)
        pl.append("%.6f %s" % (0.1 * i, " ".join(
            "%.6f" % v for v in T[:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (0.1 * i, i, bp))
    f_pose, f_laser = os.path.join(d, "p.txt"), os.path.join(d, "l.txt")
    with open(f_pose, "w") as f:
        f.write("\n".join(pl))
    with open(f_laser, "w") as f:
        f.write("\n".join(ll))
    return f_pose, f_laser


def launch_counts(kernels) -> dict:
    """Every kernel's launches counted (graph replays included)."""
    return kernels.launch_counts()


def one_a_scan(n: int, dyn: bool = False) -> dict:
    """The launches of n scans stepped one at a time (with `dynamic_thres`:
    one of each dynamic scan a query too)."""
    return {"ring_key_divs": n, "ring_key_divs_batch": 0,
            "search_tilemin": n, "search_tilemin_batch": 0,
            "cc_labels": n, "merge_hints": n,
            "dyn_pass_scan": n if dyn else 0,
            "dyn_post_scan": n if dyn else 0, "gmm_lm": n, "cascade": n}


def one_a_block(n: int, dyn: bool = False) -> dict:
    """The launches of n blocks (or serving chunks): one batched launch of
    each kernel, one CC and one merge launch (and one of each dynamic scan
    with `dynamic_thres`)."""
    return {"ring_key_divs": 0, "ring_key_divs_batch": n,
            "search_tilemin": 0, "search_tilemin_batch": n,
            "cc_labels": n, "merge_hints": n,
            "dyn_pass_scan": n if dyn else 0,
            "dyn_post_scan": n if dyn else 0, "gmm_lm": n, "cascade": n}


def add_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def no_syncs(fn):
    """fn under torch's sync debug mode "error": any host sync raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def outcome_lines(path: str) -> list:
    with open(path) as f:
        return [ln.split("\t") for ln in f.read().splitlines()]


def assert_outcomes_close(a_path: str, b_path: str, what: str) -> None:
    """Two outcome files line by line: TP/FP/FN, ids and paths exactly,
    correlation to 1e-4, the pose-error columns to 2e-3 (T's band)."""
    a, b = outcome_lines(a_path), outcome_lines(b_path)
    assert len(a) == len(b) > 0, (what, len(a), len(b))
    for la, lb in zip(a, b):
        assert la[:2] == lb[:2] and la[6:] == lb[6:], (what, la, lb)
        np.testing.assert_allclose(
            [float(x) for x in lb[2:6]], [float(x) for x in la[2:6]],
            rtol=1e-4, atol=2e-3, err_msg=what)


def phase_5(cfg, clouds, rev0: int, smi: str) -> dict:
    """The CLI's default path (the unfused API: the per-scan build,
    query_async, add_scan, push_and_balance), every stage a replay: the CLI
    on 24 scans; the same run through LoopClosurePipeline graphed and
    through the eager bodies, each timed by stage (a sync after each) and
    without the syncs (host clock; the graphed run's scans after the first
    two, which capture, under sync debug mode "error"), every outcome file
    bit-equal to the CLI's; then query_async's record against step_async's
    for the same scan and window state, bit for bit, on a stream of 32
    scans and their 32 revisits. Returns the CLI's launches."""
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch import pipeline as tpipe
    from contour_context_tpu_torch.__main__ import main as cli_main
    from contour_context_tpu_torch.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu_torch.ops import kernels
    from contour_context_tpu_torch.profile_step import lane_poses
    from contour_context_tpu_torch.utils.profiling import (
        SequentialTimeProfiler)

    n_cli = 24
    with tempfile.TemporaryDirectory() as d:
        f_pose, f_laser = write_kitti(d, clouds, lane_poses(0, n_cli))
        f_out = os.path.join(d, "outcome.txt")
        kernels.reset_launches()
        cli_main(["--pose", f_pose, "--laser", f_laser, "--outcome", f_out,
                  "--device", "cuda"])
        launches = launch_counts(kernels)
        # no query against the empty DB of the first scan
        assert launches == dict(one_a_scan(n_cli), search_tilemin=n_cli - 1,
                                merge_hints=n_cli - 1, gmm_lm=n_cli - 1,
                                cascade=n_cli - 1), launches
        want = open(f_out).read()
        assert len(want.splitlines()) == n_cli

        def pipeline(graphed, block):
            p = tpipe.LoopClosurePipeline(cfg, ContLCDEvaluator(
                f_pose, f_laser, cfg.correlation_thres), 64, block,
                device="cuda")
            p.db._graphs.enabled = graphed
            return p

        def outcome(p):
            out = os.path.join(d, "pipe.txt")
            p.save_outcome(out)
            return open(out).read()

        stage_ms, wall_ms = {}, {}
        for mode, graphed in (("graphed", True), ("eager", False),
                              ("graphed again", True)):
            # by stage: a sync after each, over the scans after the first
            # two (the graphed run captures its four graphs there)
            p = pipeline(graphed, True)
            assert p.spin_once() and p.spin_once()
            p.stp = SequentialTimeProfiler(p.stp.desc)
            p.run()
            assert outcome(p) == want, mode
            stage_ms[mode] = {k: 1e3 * lg.samps / lg.cnt
                              for k, lg in p.stp.logs.items()}
            # no sync between stages; the graphed run with none at all
            p = pipeline(graphed, False)
            assert p.spin_once() and p.spin_once()
            torch.cuda.synchronize()
            t0 = time.perf_counter()

            def rest():
                while p.spin_once():
                    pass

            no_syncs(rest)
            torch.cuda.synchronize()
            wall_ms[mode] = 1e3 * (time.perf_counter() - t0) / (n_cli - 2)
            p.drain()
            assert outcome(p) == want, mode
            if graphed:
                graphs_ = sorted(str(k[0]) for k in p.db._graphs.graphs)
                assert graphs_ == ["add_scan", "build", "push", "query_step"], \
                    graphs_
                header = p.stp.desc
    log(f"cli (the default unfused path): {n_cli} outcome lines; launches "
        f"{launches}; '{header}'; every stage a replay of the DB's graphs "
        f"{graphs_}; the scans after the first two (the captures) under "
        f"sync debug mode \"error\": 0 host syncs a scan; outcome files of "
        f"the CLI, of the pipeline graphed and of its eager bodies "
        f"bit-equal ({smi})")
    for mode in stage_ms:
        log(f"cli stages, {mode} (ms/scan over scans 3-{n_cli}, a sync after "
            f"each stage, host clock): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms[mode].items())
            + f", sum {sum(stage_ms[mode].values()):.3f}; without the syncs "
            f"{wall_ms[mode]:.3f} ms/scan ({smi})")

    # query_async against step_async at the same scan and window state
    seq = clouds[:32] + clouds[rev0:rev0 + 32]
    db_q = tdb.ContourDB(cfg, capacity=64, device="cuda")
    db_s = tdb.ContourDB(cfg, capacity=64, device="cuda")
    n_eq = n_found = 0
    for k, pts in enumerate(seq):
        desc = db_q._build_one(pts)
        h = db_q.query_async(desc)
        db_q.add_scan(desc, k, 1.0 * k)
        db_q.push_and_balance(1.0 * k)
        db_s.step_async(pts, k, 1.0 * k)
        if h is not None:
            assert torch.equal(h.rec.view(torch.int32),
                               db_s.recs_store[k].view(torch.int32)), \
                (k, h.rec.tolist(), db_s.recs_store[k].tolist())
            n_eq += 1
            n_found += int(h.rec[0] > 0.5)
    assert n_found >= 8, n_found
    for name in ("keys_q", "ts_store", "state"):
        assert torch.equal(getattr(db_q, name), getattr(db_s, name)), name
    for name, x, y in zip(db_q.store._fields, db_q.store, db_s.store):
        assert torch.equal(x, y), name
    log(f"query_async vs step_async: {n_eq} queries ({n_found} found) of 32 "
        f"scans and their 32 revisits, each record bit-equal to the step's "
        f"at the same window state; store, keys_q and window equal")
    return launches


def _keys_only_db(m, rows: int, device):
    """A DB on `device` whose store is `rows` rows tiled from m's n rows
    (row i holds row i % n: every key tied with its copies, across the
    search's tiles), keys only (range_search reads no other leaf), the
    window over all of it."""
    from contour_context_tpu_torch import db as tdb

    idx = torch.arange(rows, device=m.store.keys.device) % m.n
    keys = m.store.keys.index_select(0, idx).to(device)
    t = tdb.ContourDB(m.cfg, capacity=rows, device=device)
    t.store = type(m.store)(*[keys if f == "keys" else
                              keys.new_zeros((rows, 0))
                              for f in m.store._fields])
    t.keys_q = tdb.keys_to_q_layout(keys, t._kq_dtype()).contiguous()
    t.ts_store = torch.zeros((rows,), device=device)
    t.recs_store = torch.zeros((rows, tdb.RECORD_WIDTH), device=device)
    t.state = torch.tensor([rows, rows], dtype=torch.int32, device=device)
    t.n = rows
    return t


def phase_8_range(served, served_c, db, desc_g, smi: str) -> dict:
    """range_search as one replay of the range graph on three stores: the
    merged map, the stream DB and 65,536 rows tiled from the merged map;
    graphed, through the eager body and on a CPU copy, hits and counts
    equal across the three; ms/call graphed and eager (CUDA events, the
    median of REPS in turns), the capture time, the host syncs of one
    call (one: the fetch)."""
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch.profile_step import host_syncs

    REPS = 15
    desc_c = type(desc_g)(*[x.cpu() for x in desc_g])
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    tiled = _keys_only_db(served, 65536, "cuda")
    stores = (("the merged map", served, served_c),
              ("the stream DB", db, None),
              ("65536 rows tiled from the merged map", tiled, None))
    out = {}
    for what, m, m_c in stores:
        if m_c is None:
            m_c = _keys_only_db(m, m.n, "cpu")
            if m is db:     # the stream DB's window, not all its rows
                m_c.state = m.state.cpu()
        Q, (L, D, NA) = len(m.cfg.db.q_levels), m.keys_q.shape
        A = m.store.keys.shape[2]
        row = {"rows": m.n, "capacity": m.capacity,
               "distances": Q * A * NA}
        for radius, cap in ((60.0, 256), (1e12, 4096)):
            got = m.range_search(desc_g, radius, cap)     # the capture
            key = ("range_search", cap, m.keys_q.dtype, m.capacity)
            cap_s = m._graphs.capture_s[key]
            with m.eager():
                eager = m.range_search(desc_g, radius, cap)
            cpu = m_c.range_search(desc_c, radius, cap)
            assert got == eager, (what, radius, cap)
            assert got[1] == cpu[1] > 0 and \
                [h[:4] for h in got[0]] == [h[:4] for h in cpu[0]], \
                (what, radius, cap)
            np.testing.assert_allclose([h[4] for h in got[0]],
                                       [h[4] for h in cpu[0]], rtol=1e-6,
                                       atol=0)
            syncs = host_syncs(lambda: m.range_search(desc_g, radius, cap))
            assert syncs == 1, (what, syncs)
            ms = {True: [], False: []}
            for _ in range(REPS):
                for graphed in (True, False):
                    torch.cuda.synchronize()
                    ev0.record()
                    if graphed:
                        m.range_search(desc_g, radius, cap)
                    else:
                        with m.eager():
                            m.range_search(desc_g, radius, cap)
                    ev1.record()
                    torch.cuda.synchronize()
                    ms[graphed].append(ev0.elapsed_time(ev1))
            row[f"cap {cap}"] = dict(
                radius=radius, in_range=got[1], hits=len(got[0]),
                graphed_ms=float(np.median(ms[True])),
                eager_ms=float(np.median(ms[False])), capture_s=cap_s,
                host_syncs=syncs)
            log(f"range_search on {what} ({m.n} rows, capacity "
                f"{m.capacity}, {Q * A * NA} distances, keys_q "
                f"{str(m.keys_q.dtype)[6:]}), radius {radius}, cap {cap}: "
                f"{got[1]} in range, {len(got[0])} hits equal graphed, "
                f"eager and on the CPU; {row[f'cap {cap}']['graphed_ms']:.3f}"
                f" ms/call graphed against "
                f"{row[f'cap {cap}']['eager_ms']:.3f} eager (CUDA events, "
                f"median of {REPS} in turns; the tile-min cover, not a full "
                f"sort), captured in {cap_s:.3f} s; {syncs} host sync a "
                f"call (the fetch) ({smi})")
        out[what] = row
    tiled.drop_graphs()
    del tiled
    torch.cuda.empty_cache()
    return out


def phase_9(cfg, clouds, rev0: int, smi: str):
    """`dynamic_thres` on the card as replays: a 64-scan stream (16 + 16
    lane-0 scans, then their 32 revisits, 1 s apart) graphed, its scans
    after the first under sync debug mode "error", against the eager body
    (bit for bit) and the CPU (the record bands); one block of 16 revisit
    clouds as the build and query graphs of 16 on that DB against the eager
    bodies and the CPU copy; both dynamic kernels bit-equal to their plain
    versions at the edges and at the stream's and the block's inputs, each
    timed. Returns the stream's launches and the two kernel rows."""
    import dataclasses

    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch import kernel_times as kt
    from contour_context_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    dyn = dataclasses.replace(
        cfg, db=dataclasses.replace(cfg.db, dynamic_thres=True))
    for line in kt.dyn_edge_cases(dev, dyn):
        log(line)
    n_dyn = 32
    seq = clouds[:n_dyn] + clouds[rev0:rev0 + n_dyn]
    n = len(seq)
    recs, ms = {}, {}
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    dbs = {}
    for mode in ("graphed", "eager", "cpu"):
        device = "cpu" if mode == "cpu" else "cuda"
        m = tdb.ContourDB(dyn, capacity=128, device=device)
        m._graphs.enabled = mode == "graphed"
        if mode == "graphed":
            kernels.reset_launches()
        t0 = time.perf_counter()
        m.step_async(seq[0], 0, 0.0)        # graphed: the capture

        def rest():
            if device == "cuda":
                ev0.record()
            for k in range(1, n):
                m.step_async(seq[k], k, 1.0 * k)
            if device == "cuda":
                ev1.record()

        no_syncs(rest) if mode == "graphed" else rest()
        if device == "cuda":
            torch.cuda.synchronize()
            ms[mode] = ev0.elapsed_time(ev1) / (n - 1)
        else:
            ms[mode] = 1e3 * (time.perf_counter() - t0) / n
        if mode == "graphed":
            launches = launch_counts(kernels)
            assert launches == one_a_scan(n, dyn=True), launches
        recs[mode] = m.recs_store[:n].cpu()
        dbs[mode] = m
    assert torch.equal(recs["graphed"].view(torch.int32),
                       recs["eager"].view(torch.int32)), \
        "dynamic stream: graphed vs the eager body"
    assert_dbs_equal(dbs["graphed"], dbs["eager"], n,
                     "dynamic stream: graphed vs eager")
    assert_records_close(recs["graphed"].numpy(), recs["cpu"].numpy(),
                         "dynamic stream: card vs CPU")
    n_found = int((recs["cpu"][n_dyn:, 0] > 0.5).sum())
    assert n_found >= n_dyn // 2, n_found
    log(f"dynamic_thres stream: {n} scans as replays of the step's graph, "
        f"{ms['graphed']:.3f} ms/scan graphed against {ms['eager']:.3f} "
        f"ms/scan for the eager body (CUDA events, scans 2-{n}) and "
        f"{ms['cpu']:.1f} ms/scan on the CPU (host clock); 0 host syncs a "
        f"scan after the capture (sync debug mode \"error\"); launches "
        f"{launches}; records bit-equal to the eager body's and equal to "
        f"the CPU's ({n_found}/{n_dyn} revisits found); "
        f"graph captures {dbs['graphed'].graph_stats()['capture_s']} s "
        f"({smi})")

    # one block of 16 revisit queries: the build and query graphs of 16
    db_dg, db_dc = dbs["graphed"], dbs["cpu"]
    pts16 = np.stack(seq[-16:])

    def block(m, graphed):
        with contextlib.nullcontext() if graphed else m.eager():
            return m._query_batch(m._build_batch(pts16),
                                  m.state[1].expand(16).contiguous()).clone()

    block(db_dg, True)                  # the captures
    t0 = time.perf_counter()
    b_launch = launch_counts(kernels)
    rec_g = no_syncs(lambda: block(db_dg, True))
    torch.cuda.synchronize()
    g_ms = 1e3 * (time.perf_counter() - t0)
    b_launch = {k: v - b_launch[k] for k, v in launch_counts(kernels).items()}
    assert b_launch == one_a_block(1, dyn=True), b_launch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec_e = block(db_dg, False)
    torch.cuda.synchronize()
    e_ms = 1e3 * (time.perf_counter() - t0)
    assert torch.equal(rec_g.view(torch.int32), rec_e.view(torch.int32)), \
        "dynamic block: graphed vs eager"
    rec_c = block(db_dc, False)
    assert_records_close(rec_g.cpu().numpy(), rec_c.numpy(),
                         "dynamic block: card vs CPU")
    assert int((rec_c[:, 0] > 0.5).sum()) >= 8
    log(f"dynamic_thres block of 16 revisit queries as replays (the build "
        f"and query graphs of 16 on the stream's DB): {g_ms:.2f} ms graphed "
        f"against {e_ms:.2f} ms for the eager bodies (host clock, a sync "
        f"around); 0 host syncs; launches {b_launch}; records bit-equal to "
        f"the eager bodies' and equal to the CPU's ({smi})")

    # the kernels at the inputs the stream and the block gave them (behind
    # the launch counts)
    pa1, po1 = kt.dyn_cases(db_dg, torch.from_numpy(seq[-5])[None].to(dev),
                            dyn)
    pa16, po16 = kt.dyn_cases(db_dg, torch.from_numpy(pts16).to(dev), dyn)
    # a mean of 100: the profiler kept 197 of these kernels' 210 records
    # in one run, again and again
    reps = 100
    pass_row = kt.measure_dyn_pass(pa1, "a revisit query of the stream", reps)
    pass_row["block"] = kt.measure_dyn_pass(pa16, "the block of 16", reps)
    post_row = kt.measure_dyn_post(po1, "a revisit query of the stream", reps)
    post_row["block"] = kt.measure_dyn_post(po16, "the block of 16", reps)
    # the rows on which every step is a rise: the walks' most rounds
    wp, wo = kt.dyn_worst_cases(dev)
    pass_row["every_rise"] = kt.measure_dyn_pass(wp, "every hint a rise", reps)
    post_row["every_rise"] = kt.measure_dyn_post(wo, "every candidate a rise",
                                                 reps)
    # at the default bars a row's bars rise at most 3 times (the clamped
    # orie takes the values 4, 5 and 6): at most 4 ballot rounds a row
    assert pass_row["rounds"] <= 4 and pass_row["block"]["rounds"] <= 4, \
        (pass_row["rounds"], pass_row["block"]["rounds"])
    # every step a rise: a round for each lane's steps, and the last
    for r, args in ((pass_row, wp), (post_row, wo)):
        assert r["every_rise"]["rounds"] == \
            args[0].shape[-1] // kt.DYN_LANE_STEPS + 1, r["every_rise"]
    for r in (pass_row, pass_row["block"], pass_row["every_rise"], post_row,
              post_row["block"], post_row["every_rise"]):
        ps = r["phase_split"]
        log(f"{r['name']}: {r['shape']}, {r['passed']} passing: device "
            f"{r['device_us_warm']:.3f} us warm, {r['device_us_cold']:.3f} "
            f"us cold (torch.profiler, mean of {reps}); {r['rounds']:g} "
            f"ballot rounds (the most of a row; mean "
            f"{ps['count_mean']:.2f}); split by phase (clock64, the slowest "
            f"row) " + ", ".join(f"{n} {us:.3f}" for n, us in zip(
                ps["phases"], ps["us_slowest_cta"])) + " us; bound "
            f"{r['bound_us']:.4f} us by {r['bound_by']} ({r['bytes']} B, "
            f"{r['steps']} dependent steps, ceil(log2) of a row); call "
            f"{r['ms']:.4f} ms "
            f"(host + launch), plain {r['plain_ms']:.4f} ms; bit-equal to "
            f"the plain version ({smi})")
    for r in (pass_row, post_row):
        r["held_on_paths"] = [{"path": "the stream's revisit query",
                               "max_abs_err": r["max_abs_err"]},
                              {"path": "the block of 16",
                               "max_abs_err": r["block"]["max_abs_err"]}]
    return launches, [pass_row, post_row]


def phase_10(cfg, clouds, ring, db, rev0: int, smi: str, served) -> dict:
    """The user-facing surface on the card: chains, the host spec query,
    the full CLI with dumps, timing log and trace, scoring and a sweep, the
    pipeline options, and the online spinner. Returns the launches of each
    path, each counted from 0 just before it."""
    import threading

    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch.__main__ import main as cli_main
    from contour_context_tpu_torch.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu_torch.eval.pr_mpe import score_outcome
    from contour_context_tpu_torch.eval.sweep import (gen_thres_dirs_manual,
                                                      run_sweep_id)
    from contour_context_tpu_torch.online import OnlineSpinner
    from contour_context_tpu_torch.ops import descriptor as td
    from contour_context_tpu_torch.ops import kernels
    from contour_context_tpu_torch import pipeline as tpipe
    from contour_context_tpu_torch.profile_step import lane_poses
    from contour_context_tpu_torch.utils.native_loader import (
        library_path, native_available)

    dev = torch.device("cuda", 0)
    by_path = {}

    # ---- chains: 4 chains of 16, then 5 + 11 of a 16-row buffer ---------
    n_ch = 80
    db_c = tdb.ContourDB(cfg, capacity=8192, device="cuda")
    ts = [0.1 * i for i in range(n_ch)]
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = []

    def chain(k):
        h = db_c.step_chain_async(torch.from_numpy(np.stack(
            clouds[k:k + 16])), list(range(k, k + 16)), ts[k:k + 16])
        assert isinstance(h, tdb.BlockHandle) and h.row0 == k, h
        handles.append(h)

    chain(0)                # the first step captures the step's graph
    buf = torch.from_numpy(np.stack(clouds[64:80])).to(dev)
    buf2 = torch.cat([buf[5:], buf[:5]])
    ts2 = ts[69:80] + [0.0] * 5
    k11 = tdb.ContourDB.stage_chain_k(11, device="cuda")

    def rest():
        for k in range(16, 64, 16):     # host clouds: a pinned upload each
            chain(k)
        handles.append(db_c.step_chain_dyn_async(buf, list(range(64, 69)),
                                                 ts[64:80]))
        handles.append(db_c.step_chain_dyn_async(
            buf2, list(range(69, 80)), ts2, k_dev=k11))

    # chains of 16 (and of 5 and 11) after the capture: no host sync
    no_syncs(rest)
    torch.cuda.synchronize()
    chain_ms = 1e3 * (time.perf_counter() - t0) / n_ch
    by_path["chains"] = launch_counts(kernels)
    assert by_path["chains"] == one_a_scan(n_ch), by_path["chains"]
    tdb.drain_block_handles(handles)
    assert [h.row0 for h in handles] == [0, 16, 32, 48, 64, 69]
    got = sum((h.get() for h in handles), [])
    assert len(got) == n_ch and db_c.n == n_ch
    ring_c = db_c.recs_store[:n_ch].cpu().numpy()
    assert_records_close(ring_c, ring[:n_ch], "chains vs the stream")
    bit = bool(np.array_equal(ring_c, ring[:n_ch]))
    log(f"chains: {n_ch} clouds in 4 chains of 16 and 5 + 11 of a 16-row "
        f"buffer (the second with a staged k): 6 BlockHandles, launches "
        f"{by_path['chains']}; records equal the stream's first {n_ch} rows "
        f"(found, gidx and counters exactly, "
        f"{'bit for bit' if bit else 'floats in the record bands'}); "
        f"{chain_ms:.3f} ms/scan (host clock) ({smi})")

    # ---- the host spec query on 8 revisits, card and CPU ----------------
    store_c = type(db.store)(*[x.cpu() for x in db.store])
    kq_c, ts_c, tb = db.keys_q.cpu(), db.ts_store.cpu(), cfg.db.tb
    # 4 found revisits, and 4 scans whose stream query kept every valid
    # hit (overflow_hints 0), found ones first, once the window has opened
    revisits = [r for r in range(rev0, rev0 + LANE_SCANS) if ring[r, 0] > 0.5]
    opened = [r for r in range(len(ring)) if ring[r, 6] > 0
              and ring[r, 11] == 0]
    opened = sorted(opened, key=lambda r: (ring[r, 0] < 0.5, r))
    rows = revisits[::max(1, len(revisits) // 4)][:4] + opened[:4]
    assert len(rows) == 8, rows

    def view(store, kq, ts_store, state, n, device):
        """A DB sharing the stream's tensors, at window state `state`."""
        v = tdb.ContourDB(cfg, capacity=db.capacity, device=device)
        v.store, v.keys_q, v.ts_store, v.state, v.n = (store, kq, ts_store,
                                                        state, n)
        v.recs_store = torch.zeros((db.capacity, 18), device=device)
        v.seq_of_gidx = list(db.seq_of_gidx)
        return v

    host_ms, fused_ms, n_held, n_tm = [], [], 0, 0
    kernels.reset_launches()
    for row in rows:
        state = torch.zeros(2, dtype=torch.int32)
        for j in range(row):
            state[0] = j + 1
            tdb.update_window(state, ts_c, ts_c[j], tb.min_elapse,
                              tb.max_elapse)
        v_g = view(db.store, db.keys_q, db.ts_store, state.to(dev), row,
                   "cuda")
        v_c = view(store_c, kq_c, ts_c, state.clone(), row, "cpu")
        q_g = td.build_descriptor(torch.from_numpy(clouds[row]).to(dev),
                                  cfg.cm, cfg.gmm)
        q_c = type(q_g)(*[x.cpu() for x in q_g])
        torch.cuda.synchronize()
        before = kernels.search_tilemin.launches
        t0 = time.perf_counter()
        r_g = v_g.query_ranged_knn_host(q_g)
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        assert kernels.search_tilemin.launches == before + 1
        n_tm += 1
        r_c = v_c.query_ranged_knn_host(q_c)
        assert (r_g is None) == (r_c is None), (row, r_g, r_c)
        if r_g is not None:
            assert r_g[0] == r_c[0], (row, r_g, r_c)
            np.testing.assert_allclose(r_g[1], r_c[1], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(r_g[2], r_c[2], rtol=1e-4, atol=2e-3)
        t0 = time.perf_counter()
        rec = v_g.query_async(q_g).record()
        torch.cuda.synchronize()
        fused_ms.append(1e3 * (time.perf_counter() - t0))
        n_tm += 1
        if rec.overflow_hints == 0:
            # the host path caps no hints: held only where the fused
            # path's cap kept every valid hit
            n_held += 1
            assert rec.found == (r_g is not None), (row, rec, r_g)
            if rec.found:
                assert rec.gidx == r_g[0], (row, rec, r_g)
    by_path["host_query"] = launch_counts(kernels)
    assert by_path["host_query"]["search_tilemin"] == n_tm
    assert n_held >= 4, n_held
    log(f"host spec query: {len(rows)} queries (4 found revisits, 4 whose "
        f"hint cap kept every hit) at their replayed "
        f"window states, one search_tilemin launch each; card == CPU copy "
        f"(found and gidx exactly, corr and T in the record bands); found "
        f"and gidx equal the fused query's on the {n_held} queries whose "
        f"hint cap did not overflow; host path {np.median(host_ms):.3f} "
        f"ms/query, fused path {np.median(fused_ms):.3f} ms/query (medians "
        f"of {len(rows)}, host clock, synchronised) ({smi})")

    # ---- the full CLI, scoring, a sweep, the pipeline options -----------
    assert native_available(), "the native loader did not build"
    with tempfile.TemporaryDirectory() as d:
        f_pose, f_laser = write_kitti(d, clouds, lane_poses(0, 24))
        f_out = os.path.join(d, "outcome.txt")
        mid, trace = os.path.join(d, "mid"), os.path.join(d, "trace")
        log_path = os.path.join(d, "timing.txt")
        os.makedirs(mid)
        kernels.reset_launches()
        cli_main(["--pose", f_pose, "--laser", f_laser, "--outcome", f_out,
                  "--device", "cuda", "--save-mid-dir", mid, "--timing-log",
                  log_path, "--trace-dir", trace])
        by_path["cli"] = launch_counts(kernels)
        # the unfused path: no query against the empty DB of the first scan
        assert by_path["cli"] == dict(one_a_scan(24), search_tilemin=23,
                                      merge_hints=23, gmm_lm=23,
                                      cascade=23), \
            by_path["cli"]
        files = os.listdir(mid)
        dumps = [f for f in files if f.startswith("contours-")]
        bevs = [f for f in files if f.startswith("bev-")]
        assert len(dumps) == 24 and len(bevs) == 24, files
        assert os.path.getsize(log_path) > 0
        with open(os.path.join(trace, tpipe.TRACE_FILE)) as f:
            trace_txt = f.read()
        assert "ring_key_divs_kernel" in trace_txt
        assert "search_tilemin_kernel" in trace_txt
        res = score_outcome(f_pose, f_out, excl_frames=2)
        log(f"cli: --save-mid-dir wrote {len(dumps)} contour dumps and "
            f"{len(bevs)} BEV images ({sorted({b[-3:] for b in bevs})}), "
            f"timing log {os.path.getsize(log_path)} bytes, a Chrome trace "
            f"of {len(trace_txt)} bytes naming both kernels; native loader "
            f"{library_path().name}; launches {by_path['cli']}; pr_mpe: "
            f"max F1 {res.max_f1:.4f}, tp {res.tp_count}")
        root = os.path.join(d, "sweep")
        gen_thres_dirs_manual(root, [[3, 0.3, 0.03, -5.01],
                                     [4, 0.5, 0.05, -4.01]])
        briefs = []
        for runid in (0, 1):
            assert run_sweep_id(root, runid, f_pose, f_laser, "smoke",
                                device="cuda") == 0
            with open(os.path.join(root, "%03d" % runid,
                                   "brief-smoke.txt")) as f:
                briefs.append(f.read())
        log(f"sweep: two threshold dirs on the card, briefs (tp fn fp) "
            f"{briefs}")
        # the options: their outcome files equal the plain run's
        ev_args = (f_pose, f_laser, cfg.correlation_thres)
        plain = os.path.join(d, "plain.txt")
        p = tpipe.LoopClosurePipeline(cfg, ContLCDEvaluator(*ev_args), 64,
                                      device="cuda")
        p.run()
        p.save_outcome(plain)
        drain_at = tpipe.DRAIN_BLOCK
        for name, args, patch in (("q16", (False, None, True), None),
                                  ("block_for_timing", (True,), None),
                                  ("DRAIN_BLOCK 8", (), 8)):
            if patch:
                tpipe.DRAIN_BLOCK = patch
            try:
                p = tpipe.LoopClosurePipeline(
                    cfg, ContLCDEvaluator(*ev_args), 64, *args,
                    device="cuda")
                p.run()
            finally:
                tpipe.DRAIN_BLOCK = drain_at
            out = os.path.join(d, "opt.txt")
            p.save_outcome(out)
            if name == "q16":
                assert_outcomes_close(plain, out, name)
            else:
                with open(plain) as fa, open(out) as fb:
                    assert fa.read() == fb.read(), name
        log("pipeline options: q16_transport, block_for_timing and a "
            "mid-stream drain every 8 write the plain run's outcome file")

    # ---- the online spinner on the card, alone, then beside serving ------
    side_pts = np.stack(clouds[rev0:rev0 + 16])
    served.localize_block_async(side_pts, chunk=16)     # captured already
    feed = [(clouds[i], i, 0.1 * i) for i in range(64)] + [
        (clouds[rev0 + i], 64 + i, 0.1 * (rev0 + i)) for i in range(16)]
    ref = tdb.ContourDB(cfg, capacity=8192, device="cuda")
    for pts, seq, t in feed:
        ref.step_async(pts, seq, t)
    rec_ref = ref.recs_store[:len(feed)].cpu().numpy()
    found = [k for k in range(len(feed)) if rec_ref[k, 0] > 0.5]
    assert len(found) >= 8, found

    def spin(serve: bool):
        """The spinner fed `feed` from a thread, paused and resumed through
        its control file; ms/scan from feed to finish (host clock). With
        `serve`, the main thread meanwhile replays the serving map's build
        and query graphs of 16 (the same pool, another thread), a chunk
        every 50 ms; their launches are recorded apart (the recording is
        this thread's), so the counts, reset here, are the spinner's
        alone. Returns the spinner, its ms/scan, the chunks' records and
        their launches, and the counts read just after."""
        with tempfile.TemporaryDirectory() as d:
            ctrl = os.path.join(d, "status")
            sp = OnlineSpinner(cfg, capacity=8192, control_file=ctrl,
                               device="cuda")
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp.start()

            def feeder():
                for k, (pts, seq, t) in enumerate(feed):
                    assert sp.feed(pts, seq, t, timeout=300)
                    if k == 40:
                        with open(ctrl, "w") as f:
                            f.write("pause")
                        deadline = time.time() + 120
                        while not sp._paused.is_set() and \
                                time.time() < deadline:
                            time.sleep(0.01)
                        with open(ctrl, "w") as f:
                            f.write("resume")

            th = threading.Thread(target=feeder)
            th.start()
            side = []
            with kernels.recording_launches() as side_launches:
                deadline = time.time() + 600
                while serve and (th.is_alive() or not sp._q.empty()
                                 or len(side) < 4):
                    assert time.time() < deadline, \
                        "the spinner made no progress"
                    side.append(served.localize_block_async(
                        side_pts, chunk=16).recs.clone())
                    time.sleep(0.05)
            th.join()
            sp.finish()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / len(feed)
        launches = launch_counts(kernels)
        assert launches == one_a_scan(len(feed)), launches
        assert sp.dropped == 0 and sp.n_processed == len(feed)
        assert [d.q_seq for d in sp.detections] == found, sp.detections
        for det in sp.detections:
            assert det.cand_seq == int(rec_ref[det.q_seq, 1]), det
            np.testing.assert_allclose(det.correlation,
                                       rec_ref[det.q_seq, 2],
                                       rtol=1e-4, atol=1e-4)
        return sp, ms, side, side_launches, launches

    sp, online_ms, _, _, by_path["online"] = spin(False)
    sp2, shared_ms, side, side_launches, _ = spin(True)
    want_side = {k: v for k, v in one_a_block(len(side)).items() if v}
    assert {k: v for k, v in side_launches.items() if v} == want_side, \
        side_launches
    with served.eager():
        side_eager = served.localize_block_async(side_pts, 16).recs
    for r in side:
        assert torch.equal(r.view(torch.int32),
                           side_eager.view(torch.int32)), \
            "serving beside the spinner vs its eager calls"
    log(f"online: {len(feed)} scans fed from a thread, paused and resumed "
        f"through the control file; {len(found)} detections equal the "
        f"found records of a step_async stream of the same scans; dropped "
        f"{sp.dropped}; launches {by_path['online']}; {online_ms:.3f} "
        f"ms/scan alone (host clock, feed to finish) ({smi})")
    log(f"online beside serving: the same feed while the main thread served "
        f"{len(side)} chunks of 16 from the serving map's graphs (one pool, "
        f"one replay stream), a chunk every 50 ms: the same detections, "
        f"dropped {sp2.dropped}; the spinner's launches counted alone "
        f"{one_a_scan(len(feed))}, the serving thread's recorded apart "
        f"{side_launches}; each chunk's records bit-equal to its eager "
        f"calls; {shared_ms:.3f} ms/scan under that contention (host "
        f"clock, feed to finish) ({smi})")
    return by_path


def _chunks(points, B: int):
    """The clouds padded with zero clouds to whole chunks of B, as
    `localize_block_async` pads its tail."""
    n = points.shape[0]
    out = np.zeros((-(-n // B) * B,) + points.shape[1:], points.dtype)
    out[:n] = points
    return out


def _phase11_rank(mesh, job: dict) -> dict:
    """One spawned rank of phase 11 (world 2 over gloo, on the one card):
    the merged map loaded from its checkpoint and sharded, the revisit
    clouds served in chunks, an uneven shard of the map cut to an odd row
    count, one block step over the sharded stream DB. Returns the records,
    the rank's launches of each kernel, its shard and peak bytes."""
    import torch.distributed as dist

    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch import kernel_times as kt
    from contour_context_tpu_torch import parallel as par
    from contour_context_tpu_torch.ops import descriptor as td
    from contour_context_tpu_torch.ops import kernels

    cfg, B, dev = job["cfg"], job["chunk"], mesh.device
    ql = tuple(cfg.db.q_levels)
    out = {}
    m = tdb.ContourDB.load(job["map"], cfg, device=dev)
    shard = par.shard_store(m.store, mesh)
    cut = job["cut"]
    shard_u = par.shard_store(type(m.store)(*[x[:cut] for x in m.store]),
                              mesh)
    state, state_u = m.state, torch.tensor([cut, cut], dtype=torch.int32,
                                           device=dev)
    del m
    torch.cuda.empty_cache()
    pts = _chunks(np.load(job["clouds"]), B)
    n = job["n_clouds"]
    par.sharded_localize_block(shard, state, pts[:B], cfg, mesh)  # warm-up
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    recs = [par.sharded_localize_block(shard, state, pts[i:i + B], cfg, mesh)
            for i in range(0, len(pts), B)]
    torch.cuda.synchronize()
    dist.barrier()
    out["ms_per_query"] = 1e3 * (time.perf_counter() - t0) / n
    out["launches"] = launch_counts(kernels)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["records"] = torch.cat(recs)[:n].cpu()
    out["shard_bytes"] = (sum(x.nbytes for x in shard.store)
                          + shard.keys_q.nbytes)
    out["n_loc"] = shard.store.keys.shape[0]
    out["uneven"] = par.sharded_localize_block(shard_u, state_u, pts[:B],
                                               cfg, mesh).cpu()
    out["uneven_n_loc"] = shard_u.store.keys.shape[0]
    # the batched tile-min against its plain version on this rank's f32
    # shard, with the first chunk's query keys (after the counts)
    descs = td.build_descriptors(torch.from_numpy(pts[:B]).to(dev), cfg.cm,
                                 cfg.gmm)
    lv = list(ql)
    out["held_err"] = kt.hold_batch(
        shard.keys_q, ql, descs.keys[:, lv].to(torch.float32).contiguous(),
        state[1].expand(B).contiguous(), f"rank {mesh.rank}'s map shard")
    del shard, shard_u, descs
    torch.cuda.empty_cache()
    s = tdb.ContourDB.load(job["stream"], cfg, capacity=job["capacity"],
                           device=dev)
    bshard = par.shard_store(s.store, mesh)
    ts_store, st, recs_store, n0 = s.ts_store, s.state, s.recs_store, s.n
    del s
    descs = type(bshard.store)(*[x.to(dev) for x in job["block_descs"]])
    kernels.reset_launches()
    out["block"] = par.sharded_process_block(
        bshard, ts_store, st, recs_store, descs,
        torch.tensor(job["block_ts"], dtype=torch.float32, device=dev), n0,
        cfg, mesh).cpu()
    out["block_launches"] = launch_counts(kernels)
    out["block_state"] = st.cpu()
    out["block_rows"] = (bshard.base, bshard.store.keys.shape[0])
    out["graph_stats"] = mesh.graph_stats()
    return out


def phase_11(cfg, clouds, db, served, rev0: int, smi: str) -> dict:
    """Sharded serving and search on the card (contour_context_tpu_torch/
    parallel.py): a world of one rank over NCCL in this process, then a
    world of two ranks over gloo, both on the one card, spawned. Returns
    the launches of each kernel on the sharded paths, by world and rank."""
    import dataclasses

    import torch.distributed as dist

    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch import kernel_times as kt
    from contour_context_tpu_torch import parallel as par
    from contour_context_tpu_torch.ops import descriptor as td
    from contour_context_tpu_torch.ops import kernels
    from contour_context_tpu_torch.profile_step import host_syncs

    dev = torch.device("cuda", 0)
    B = 16
    ql = tuple(cfg.db.q_levels)
    cfg32 = dataclasses.replace(cfg, cm=dataclasses.replace(
        cfg.cm, keys_bf16=False))
    revisit = np.stack(clouds[rev0:])
    n_rev = revisit.shape[0]
    pts = _chunks(revisit, B)
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        f_map, f_stream = (os.path.join(d, f) for f in ("map.npz",
                                                         "stream.npz"))
        served.save(f_map)
        db.save(f_stream)
        np.save(os.path.join(d, "revisit.npy"), revisit)
        # the single-device references: the same checkpoints with f32 keys_q
        map32 = tdb.ContourDB.load(f_map, cfg32, device="cuda")
        assert map32.keys_q.dtype == torch.float32
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)

        def serve_single():
            """The single-device f32-key serving: ms/query, records."""
            torch.cuda.synchronize()
            ev0.record()
            recs = map32.localize_block_async(revisit, chunk=B).recs
            ev1.record()
            torch.cuda.synchronize()
            return ev0.elapsed_time(ev1) / n_rev, recs.cpu().numpy()

        def right_place(recs):
            return sum(1 for i in range(n_rev) if recs[i, 0] > 0.5 and abs(
                served.session_of_gidx[int(recs[i, 1])][1] - i) <= 3)

        single_ms, recs32 = serve_single()

        # the single-device block step of the sharded paths: B revisit
        # descriptors on the stream DB with f32 keys, twice in turn
        block_rows = list(range(len(clouds) - B, len(clouds)))
        block_descs = td.build_descriptors(torch.from_numpy(
            np.stack([clouds[r] for r in block_rows])).to(dev), cfg.cm,
            cfg.gmm)
        n0 = db.n
        block_ts = [0.1 * (n0 + i) for i in range(2 * B)]
        ts_dev = [torch.tensor(block_ts[k * B:(k + 1) * B], device=dev)
                  for k in (0, 1)]
        s32 = tdb.ContourDB.load(f_stream, cfg32, capacity=db.capacity,
                                 device="cuda")
        rec_b = s32.process_block_async(
            block_descs, [n0 + i for i in range(B)], block_ts[:B]).recs
        state_b = s32.state.cpu()
        rec_b2 = torch.cat([rec_b, s32.process_block_async(
            block_descs, [n0 + B + i for i in range(B)], block_ts[B:]).recs])
        ref_b2 = (s32.state.clone(), s32.ts_store.clone(),
                  s32.recs_store.clone(), type(s32.store)(*[
                      x[:n0 + 2 * B].clone() for x in s32.store]))
        del s32

        # ---- world 1 over NCCL, in this process: every entry point one
        # replay a call (its first call captures), held against its eager
        # body ------------------------------------------------------------
        dist.init_process_group("nccl", init_method="file://"
                                + os.path.join(d, "init1"), rank=0,
                                world_size=1)
        mesh = None
        try:
            mesh = par.make_mesh(device=dev)
            assert mesh.graphed, mesh.graph_stats()

            def flat(x):
                return [x] if isinstance(x, torch.Tensor) else list(x)

            gs = {"capture_s": {}, "launches": {}, "pool_bytes": 0}

            def keep_stats():
                """The mesh's graphs before a shard goes (its graphs go
                with it)."""
                st = mesh.graph_stats()
                gs["capture_s"].update(st["capture_s"])
                gs["launches"].update(st["launches"])
                gs["pool_bytes"] = max(gs["pool_bytes"], st["pool_bytes"])
                gs["pool"] = st["pool"]

            def replayed(fn, what):
                """fn() captured (its first call), replayed under sync debug
                mode "error" and run eagerly, the three bit for bit equal:
                the replay's result and its launches."""
                first = fn()
                kernels.reset_launches()
                again = no_syncs(fn)
                n = launch_counts(kernels)
                with mesh.eager():
                    eager = fn()
                for x, y, z in zip(flat(first), flat(again), flat(eager)):
                    assert torch.equal(x, y) and torch.equal(x, z), what
                return again, n

            # the tile-min fixture of phase 3 with f32 keys at
            # searchable_n 7000
            kb, qk = kt.tile_store(8192)
            kq32 = kt.q_layout(kb, torch.float32, dev)
            keys = torch.from_numpy(kb).to(dev)
            fixture = type(db.store)(*[
                keys if f == "keys" else keys.new_zeros((keys.shape[0], 0))
                for f in db.store._fields])
            sh_fix = par.shard_store(fixture, mesh)
            state = torch.tensor([8192, 7000], dtype=torch.int32, device=dev)
            q = torch.from_numpy(qk).to(dev)
            got, launches["search_fixture"] = replayed(
                lambda: par.sharded_search(sh_fix.keys_q, q, state[1], ql,
                                           cfg.db.nnk, mesh), "search")
            want = tdb.search(kq32, q, state, ql, cfg.db.nnk)
            for a, b in zip(got, want):
                assert torch.equal(a, b), "sharded search on the fixture"
            assert torch.equal(sh_fix.keys_q, kq32)
            sb2 = torch.tensor([7000, 246], dtype=torch.int32, device=dev)
            got_b, launches["search_batch_fixture"] = replayed(
                lambda: par.sharded_search_batch(
                    sh_fix.keys_q, torch.stack([q, q]), sb2, ql, cfg.db.nnk,
                    mesh), "search batch")
            for a, b in zip(got_b, want):
                assert torch.equal(a[0], b), "sharded batched search"
            keep_stats()
            del sh_fix, fixture, keys, kq32
            log(f"sharded search (world 1, NCCL, graphed): the tile-min "
                f"fixture (6, 10, 49152) f32 at searchable_n 7000, "
                f"{int(want[3].sum())} valid hits: bit-equal to the "
                f"single-device search with f32 keys_q, the batched search "
                f"(limits 7000 and 246) row 0 too; each one replay a call "
                f"with 0 host syncs, bit-equal to its eager body; launches "
                f"of a replay {launches['search_fixture']}, batched "
                f"{launches['search_batch_fixture']}")

            # two found revisits of the stream at their replayed window
            # states, on the sharded stream DB
            sh_s = par.shard_store(db.store, mesh)
            kq_s = tdb.keys_to_q_layout(db.store.keys).contiguous()
            ts_c, tb = db.ts_store.cpu(), cfg.db.tb
            ring = db.recs_store.cpu().numpy()
            rows = [r for r in range(rev0, rev0 + LANE_SCANS)
                    if ring[r, 0] > 0.5][:2]
            cases = []
            for row in rows:
                st = torch.zeros(2, dtype=torch.int32)
                for j in range(row):
                    st[0] = j + 1
                    tdb.update_window(st, ts_c, ts_c[j], tb.min_elapse,
                                      tb.max_elapse)
                st = st.to(dev)
                desc = td.build_descriptor(torch.from_numpy(clouds[row])
                                           .to(dev), cfg.cm, cfg.gmm)
                cases.append((row, desc, st, tdb.query_step(
                    db.store, kq_s, desc, st, cfg32)))
            recs_q, counts = [], []
            for _, desc, st, _ in cases:
                rec, n = replayed(lambda: par.sharded_query_step(
                    sh_s, desc, st, cfg32, mesh), "query step")
                recs_q.append(rec)
                counts.append(n)
            launches["query_step"] = add_counts(*counts)
            assert launches["query_step"] == dict(
                one_a_scan(len(rows)), ring_key_divs=0, cc_labels=0), \
                launches
            n_bit = 0
            for (row, _, _, ref), rec in zip(cases, recs_q):
                assert_records_close(rec.cpu()[None], ref.cpu()[None],
                                     f"sharded query of scan {row}")
                assert rec[0] > 0.5, row
                n_bit += int(torch.equal(rec, ref))
            log(f"sharded query step (world 1, NCCL, graphed): the stream's "
                f"first two found revisits {rows} on the sharded stream DB "
                f"equal the single-device f32-key records ({n_bit} of "
                f"{len(rows)} bit for bit; found, gidx and counters "
                f"exactly), each one replay with 0 host syncs, bit-equal to "
                f"its eager body; launches of the replays "
                f"{launches['query_step']}")
            keep_stats()
            del sh_s, kq_s

            # serving: the 132 revisit clouds in chunks on the sharded map,
            # graphed and eager in turns
            sh_m = par.shard_store(map32.store, mesh)
            descs0 = td.build_descriptors(torch.from_numpy(pts[:B]).to(dev),
                                          cfg.cm, cfg.gmm)
            sb0 = map32.state[1].expand(B).contiguous()
            got_q, launches["query_batch"] = replayed(
                lambda: par.sharded_query_step_batch(sh_m, descs0, sb0,
                                                     cfg32, mesh),
                "batched query")
            assert_records_close(got_q.cpu().numpy(), recs32[:B],
                                 "sharded batched query, first chunk")
            got0 = par.sharded_localize_block(sh_m, map32.state, pts[:B],
                                              cfg32, mesh)   # the capture
            assert_records_close(got0.cpu().numpy(), recs32[:B],
                                 "sharded localization, first chunk")
            bit0 = bool(np.array_equal(got0.cpu().numpy(), recs32[:B]))
            turns, recs_t = [], []
            for graphed in (True, False, True, False):
                ctx = contextlib.nullcontext() if graphed else mesh.eager()
                if graphed and not turns:
                    kernels.reset_launches()
                torch.cuda.synchronize()
                with ctx:
                    ev0.record()
                    r1 = [par.sharded_localize_block(
                        sh_m, map32.state, pts[i:i + B], cfg32, mesh)
                        for i in range(0, len(pts), B)]
                    ev1.record()
                torch.cuda.synchronize()
                if graphed and not turns:
                    launches["world1"] = launch_counts(kernels)
                turns.append((graphed, ev0.elapsed_time(ev1) / n_rev))
                recs_t.append(torch.cat(r1)[:n_rev])
            for r1 in recs_t[1:]:
                assert torch.equal(r1, recs_t[0]), "graphed vs eager serving"
            w1_ms = float(np.mean([t for g, t in turns if g]))
            w1_eager_ms = float(np.mean([t for g, t in turns if not g]))
            n_chunks = len(pts) // B
            assert launches["world1"] == one_a_block(n_chunks), \
                launches["world1"]
            recs1 = recs_t[0].cpu().numpy()
            assert_records_close(recs1, recs32, "sharded serving, world 1")
            bit1 = bool(np.array_equal(recs1, recs32))
            syncs = host_syncs(lambda: par.sharded_localize_block(
                sh_m, map32.state, pts[:B], cfg32, mesh))
            assert syncs == 0, syncs
            no_syncs(lambda: par.sharded_localize_block(
                sh_m, map32.state, pts[:B], cfg32, mesh))
            err = kt.hold_batch(
                sh_m.keys_q, ql, descs0.keys[:, list(ql)].to(torch.float32)
                .contiguous(), sb0, "world 1's map shard")
            keep_stats()
            del sh_m

            # the block step, twice in turn through one graph, graphed and
            # eager, on the sharded stream DB (f32 keys)
            blocks = {}
            for graphed in (True, False):
                s = tdb.ContourDB.load(f_stream, cfg32, capacity=db.capacity,
                                       device="cuda")
                sh_b = par.shard_store(s.store, mesh)
                ts_s, st_s, rs_s = s.ts_store, s.state, s.recs_store
                del s
                ctx = contextlib.nullcontext() if graphed else mesh.eager()
                with ctx:
                    r_a = par.sharded_process_block(
                        sh_b, ts_s, st_s, rs_s, block_descs, ts_dev[0], n0,
                        cfg32, mesh)
                    if graphed:
                        kernels.reset_launches()
                        r_b = no_syncs(lambda: par.sharded_process_block(
                            sh_b, ts_s, st_s, rs_s, block_descs, ts_dev[1],
                            n0 + B, cfg32, mesh))
                        launches["world1_block"] = launch_counts(kernels)
                    else:
                        r_b = par.sharded_process_block(
                            sh_b, ts_s, st_s, rs_s, block_descs, ts_dev[1],
                            n0 + B, cfg32, mesh)
                blocks[graphed] = (torch.cat([r_a, r_b]), st_s, ts_s, rs_s,
                                   sh_b)
            (g_r, g_st, g_ts, g_rs, g_sh), (e_r, e_st, e_ts, e_rs, e_sh) = \
                blocks[True], blocks[False]
            assert torch.equal(g_r, e_r) and torch.equal(g_st, e_st)
            assert torch.equal(g_ts, e_ts) and torch.equal(g_rs, e_rs)
            for x, y in zip((*g_sh.store, g_sh.keys_q),
                            (*e_sh.store, e_sh.keys_q)):
                assert torch.equal(x, y), "graphed vs eager block shards"
            st_ref, ts_ref, rs_ref, store_ref = ref_b2
            assert torch.equal(g_st, st_ref) and torch.equal(g_ts, ts_ref)
            for x, y in zip(g_sh.store, store_ref):
                assert torch.equal(x[:n0 + 2 * B], y), "block store"
            assert_records_close(g_r.cpu().numpy(), rec_b2.cpu().numpy(),
                                 "sharded block steps, world 1")
            assert launches["world1_block"] == dict(
                one_a_block(1), ring_key_divs_batch=0, cc_labels=0), \
                launches["world1_block"]
            bit_b = bool(torch.equal(g_r, rec_b2))
            keep_stats()
            del blocks, g_sh, e_sh
            gc.collect()
            left = mesh.graph_stats()["capture_s"]
            assert not left, f"graphs outlived their shards: {left}"
            log(f"sharded block step (world 1, NCCL, graphed): two blocks "
                f"of {B} revisit descriptors in turn (rows {n0}.. and "
                f"{n0 + B}..) on the sharded stream DB through one graph, "
                f"the second with 0 host syncs: records, window state "
                f"{g_st.tolist()}, timestamps, record ring and shard bit-equal"
                f" to the eager calls'; the single-device f32 blocks' store "
                f"and window state bit for bit, their records "
                f"{'bit for bit' if bit_b else 'in the record bands'}; "
                f"launches of a replay {launches['world1_block']}")
            log(f"sharded graphs (world 1, NCCL): capture s "
                f"{ {k: round(v, 3) for k, v in gs['capture_s'].items()} }; "
                f"launches of one replay {gs['launches']}; the device's "
                f"shared graph pool {gs['pool_bytes']} bytes ({gs['pool']})")
        finally:
            if mesh is not None:
                mesh.drop_graphs()      # before the communicator goes
            dist.destroy_process_group()
        # the single-device serving again, after world 1: the two bracket it
        single_ms_after, again = serve_single()
        assert_records_close(again, recs32, "single-device serving again")
        log(f"sharded serving (world 1, NCCL): {n_rev} revisit clouds in "
            f"{n_chunks} chunks of {B} on the {map32.n}-row merged map "
            f"sharded to one rank, each chunk one replay (the data-parallel "
            f"build, the descriptor all-gather and the query): launches "
            f"{launches['world1']}; graphed and eager in turns "
            f"({', '.join(f'{t:.3f}' for _, t in turns)} ms/query), every "
            f"turn's records bit-equal; records equal the single-device "
            f"f32-key serving's (the first chunk "
            f"{'bit for bit' if bit0 else 'in the record bands'}, all "
            f"{'bit for bit' if bit1 else 'in the record bands'}); "
            f"{syncs} host syncs a chunk (sync debug mode \"error\"); the "
            f"batched tile-min bit-equal to its plain version on the shard "
            f"(max abs err {err})")

        # ---- world 2 over gloo, both ranks on this card, spawned -------
        cut = served.n - 1
        job = dict(cfg=cfg32, chunk=B, map=f_map, stream=f_stream,
                   clouds=os.path.join(d, "revisit.npy"), n_clouds=n_rev,
                   cut=cut, capacity=db.capacity, block_ts=block_ts[:B],
                   block_descs=type(block_descs)(*[x.cpu()
                                                   for x in block_descs]))
        kernels.build()     # the ranks load the library built here
        t0 = time.perf_counter()
        per_rank = par.spawn_ranks(_phase11_rank, 2, (job,),
                                   backend="gloo", device="cuda:0")
        spawn_s = time.perf_counter() - t0
        # the single-device references of the uneven map and the block
        u = type(map32.store)(*[x[:cut] for x in map32.store])
        rec_u = tdb.query_step_batch(
            u, tdb.keys_to_q_layout(u.keys).contiguous(), descs0,
            torch.full((B,), cut, dtype=torch.int32, device=dev), cfg32)
        del u
    rec_u, rec_b = rec_u.cpu().numpy(), rec_b.cpu().numpy()
    bits = {}
    for r, res in enumerate(per_rank):
        got = res["records"].numpy()
        assert_records_close(got, recs32, f"world 2 rank {r} serving")
        assert_records_close(res["uneven"].numpy(), rec_u,
                             f"world 2 rank {r}, map cut to {cut} rows")
        assert_records_close(res["block"].numpy(), rec_b,
                             f"world 2 rank {r} block step")
        assert torch.equal(res["block_state"], state_b), r
        assert res["launches"] == launches["world1"], (r, res["launches"])
        assert res["block_launches"] == dict(
            one_a_block(1), ring_key_divs_batch=0, cc_labels=0), res
        assert res["held_err"] == 0.0
        assert not res["graph_stats"]["graphed"] and \
            res["graph_stats"]["reason"] == "gloo", res["graph_stats"]
        bits[r] = [bool(np.array_equal(got, recs32)),
                   bool(np.array_equal(res["uneven"].numpy(), rec_u)),
                   bool(np.array_equal(res["block"].numpy(), rec_b))]
        launches[f"world2_rank{r}"] = {
            k: res["launches"][k] + res["block_launches"][k]
            for k in res["launches"]}
    for a, b in (("records", "records"), ("uneven", "uneven"),
                 ("block", "block")):
        assert torch.equal(per_rank[0][a], per_rank[1][b]), a
    right = right_place(per_rank[0]["records"].numpy())
    assert right >= n_rev // 2, right
    # why world 2's serving floats are not bit-equal: each rank builds 8
    # clouds of a chunk where the single device builds 16
    halves = [td.build_descriptors(torch.from_numpy(pts[i:i + B // 2])
                                   .to(dev), cfg.cm, cfg.gmm)
              for i in (0, B // 2)]
    whole = td.build_descriptors(torch.from_numpy(pts[:B]).to(dev), cfg.cm,
                                 cfg.gmm)
    off_8 = desc_leaves_close(
        whole._fields, [torch.cat(x) for x in zip(*halves)], whole,
        whole.nei_valid.cpu(), "two builds of 8 vs one of 16")
    found_b = int((rec_b[:, 0] > 0.5).sum())
    assert found_b >= B // 2, found_b
    row_bytes = sum(getattr(map32.store, f)[:1].nbytes
                    for f in par.TAIL_LEAVES)
    Q, A = len(ql), map32.store.keys.shape[2]
    hc = min(cfg.db.max_check_cands, Q * A * min(cfg.db.nnk, map32.n * A))
    u_rows = min(B * hc + 1, map32.n)
    for r, res in enumerate(per_rank):
        log(f"world 2 rank {r} (gloo, cuda:0): rows "
            f"[{r * res['n_loc']}, {(r + 1) * res['n_loc']}) of the map, "
            f"shard {res['shard_bytes']} bytes, peak allocated "
            f"{res['peak_bytes']} bytes while serving; launches serving "
            f"{res['launches']}, block step {res['block_launches']} (eager:"
            f" graphed {res['graph_stats']['graphed']}, reason "
            f"{res['graph_stats']['reason']!r}, gloo's collectives run on "
            f"the host); "
            f"records bit-equal to the single-device f32 ones (serving, "
            f"uneven, block): {bits[r]}")
    log(f"sharded serving (world 2, gloo, both ranks on one card, "
        f"spawned in {spawn_s:.1f} s): {n_rev} revisit clouds in chunks of "
        f"{B}, each rank building {B // 2} a chunk: records equal the "
        f"single-device f32-key serving's on both ranks (found, gidx and "
        f"counters exactly, floats in the record bands: two builds of "
        f"{B // 2} give one of {B}'s descriptors bit for bit but for "
        f"{off_8 or 'no leaf'}), found at the right place {right}/{n_rev} "
        f"(the single-device f32-key serving {right_place(recs32)}); the map "
        f"cut to {cut} rows "
        f"({per_rank[0]['uneven_n_loc']} a shard, padded) equals the "
        f"single-device records of the cut map; one sharded_process_block "
        f"of {B} revisit descriptors over the sharded stream DB ({n0} rows "
        f"of {db.capacity}) equals the single-device block with "
        f"keys_bf16=False ({found_b}/{B} found), window state "
        f"{state_b.tolist()}")
    log(f"sharded serving ms/query: world 1 (NCCL) {w1_ms:.3f} graphed, "
        f"{w1_eager_ms:.3f} eager (the mean of two turns each), world 2 "
        f"(gloo, through the host) {per_rank[0]['ms_per_query']:.3f} "
        f"(rank 0, host clock between barriers), the single-device f32-key "
        f"serving {single_ms:.3f} before world 1 and {single_ms_after:.3f} "
        f"after it (CUDA events), all in this call; the row "
        f"gather moves {u_rows} rows x {row_bytes} bytes from each of the "
        f"world's ranks a chunk of {B} ({u_rows * row_bytes} bytes a rank) "
        f"({smi})")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    sys.path.insert(0, os.path.join(ROOT, "tests"))

    from synth import make_world, render_scan

    from contour_context_tpu_torch import PipelineConfig, pad_points
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch import kernel_times as kt
    from contour_context_tpu_torch.ops import descriptor as td
    from contour_context_tpu_torch.ops import kernels
    from contour_context_tpu_torch.profile_step import (block_split,
                                                        device_ops,
                                                        host_syncs,
                                                        lane_poses)

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
    # ---- 3b. the batched tile-min ---------------------------------------
    for line in kt.batch_edge_cases(dev, cfg):
        log(line)
    brow = kt.measure_batch(dev, cfg)
    rows.append(brow)
    log(f"search_tilemin_batch: {brow['shape']}: device "
        f"{brow['device_us_warm']:.3f} us warm, {brow['device_us_cold']:.3f} "
        f"us cold (torch.profiler, mean of 200); bound {brow['bound_us']:.4f} "
        f"us by {brow['bound_by']} ({brow['bytes']} B, {brow['flops']} flop), "
        f"share {brow['share_of_bound']:.4f} cold; the 16 single launches of "
        f"the same queries {brow['singles_us_warm']:.3f} us warm, "
        f"{brow['singles_us_cold']:.3f} us cold in all; call {brow['ms']:.4f} "
        f"ms against {brow['singles_ms']:.4f} ms for the 16 (host + launch), "
        f"plain {brow['plain_ms']:.4f} ms ({smi})")
    # ---- 3c. the batched ring key --------------------------------------
    ring_case = kt.ring_block_case(dev, cfg)
    for line in kt.ring_batch_edge_cases(dev, cfg, ring_case):
        log(line)
    rrow = kt.measure_ring_batch(dev, cfg, ring_case)
    rows.append(rrow)
    log(f"ring_key_divs_batch: {rrow['shape']}, the stream's first block: "
        f"device {rrow['device_us_warm']:.3f} us warm, "
        f"{rrow['device_us_cold']:.3f} us cold (torch.profiler, mean of "
        f"200); bound {rrow['bound_us']:.4f} us by {rrow['bound_by']} "
        f"({rrow['bytes']} B, {rrow['exps']:.0f} expf), share "
        f"{rrow['share_of_bound']:.4f} cold; the 16 single launches of the "
        f"same scans {rrow['singles_us_warm']:.3f} us warm, "
        f"{rrow['singles_us_cold']:.3f} us cold in all; call "
        f"{rrow['ms']:.4f} ms against {rrow['singles_ms']:.4f} ms for the 16 "
        f"(host + launch), plain {rrow['plain_ms']:.4f} ms; bit-equal to "
        f"the plain version and to the single launches ({smi})")
    for r in kt.scaling_rows(dev, cfg, ring_case):
        ops = (f"{r['exps']:.0f} expf" if "exps" in r
               else f"{r['flops']} flop")
        log(f"scaling: {r['case']}: device {r['device_us_warm']:.3f} us warm, "
            f"{r['device_us_cold']:.3f} us cold (torch.profiler, mean of 50); "
            f"{r['bytes']} B, {ops}, bound {r['bound_us']:.4f} us by "
            f"{r['bound_by']}, share {r['share_of_bound']:.4f} cold ({smi})")
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
    ev_map = torch.cuda.Event(enable_timing=True)   # behind the two lanes
    t0 = time.perf_counter()
    for k in range(WARMUP):         # the first step captures the graph
        handles.append(db.step_async(clouds[k], k, 0.1 * k))
    torch.cuda.synchronize()
    t_warm = time.perf_counter()

    def stream_rest():
        ev0.record()
        for k in range(WARMUP, len(clouds)):
            if k == 2 * LANE_SCANS:
                ev_map.record()
            handles.append(db.step_async(clouds[k], k, 0.1 * k))
        ev1.record()

    # every replay after the capture under sync debug mode "error"
    no_syncs(stream_rest)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = launch_counts(kernels)
    n_scans = len(clouds)
    assert launches == one_a_scan(n_scans), launches
    log(f"stream launches {launches}: gmm_lm and cascade once a step, as "
        f"every kernel of the step")
    graph_stream = db.graph_stats()
    ms_scan = ev0.elapsed_time(ev1) / (n_scans - WARMUP)
    ms_scan_map = ev0.elapsed_time(ev_map) / (2 * LANE_SCANS - WARMUP)
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
    # the same scans through the eager body the graph captured, on a DB of
    # its own: the graphed records and store must equal it bit for bit
    db_e = tdb.ContourDB(cfg, capacity=8192, device="cuda")
    db_e._graphs.enabled = False
    for k in range(WARMUP):
        db_e.step_async(clouds[k], k, 0.1 * k)
    torch.cuda.synchronize()
    ev0.record()
    for k in range(WARMUP, n_scans):
        db_e.step_async(clouds[k], k, 0.1 * k)
    ev1.record()
    torch.cuda.synchronize()
    ms_scan_eager = ev0.elapsed_time(ev1) / (n_scans - WARMUP)
    assert_dbs_equal(db, db_e, n_scans, "graphed stream vs the eager body")
    assert torch.equal(db.state, db_e.state)
    assert torch.equal(db.recs_store.view(torch.int32),
                       db_e.recs_store.view(torch.int32)), \
        "graphed records vs the eager body's"
    del db_e
    log(f"stream graphed: the step's graph captured in "
        f"{list(graph_stream['capture_s'].values())[0]:.3f} s (the first "
        f"step runs the body eagerly, then captures it); "
        f"{ms_scan:.3f} ms/scan graphed against {ms_scan_eager:.3f} ms/scan "
        f"for the eager body it captured, over scans {WARMUP}..{n_scans - 1} "
        f"(CUDA events); 0 host syncs a scan (sync debug mode \"error\" "
        f"over {n_scans - WARMUP} replays); launches {launches} (one of "
        f"each kernel a scan, replays counted); graph pool "
        f"{graph_stream['pool_bytes']} bytes; store, keys_q, window and "
        f"records bit-equal to the eager body's ({smi})")
    log(f"stream: {n_scans} scans, launches {launches}, revisits found in "
        f"the right place {right}/{LANE_SCANS}, elsewhere {elsewhere}; "
        f"first {WARMUP} scans {1e3 * (t_warm - t0) / WARMUP:.2f} ms/scan "
        f"(warm-up)")
    log(f"stream: {ms_scan:.3f} ms/scan (CUDA events), {wall_ms:.3f} ms/scan "
        f"(host clock), store {store_b} bytes, peak allocated {peak} bytes "
        f"({smi})")
    log(f"counters: {db.counters}")
    assert right >= LANE_SCANS // 2, (right, elsewhere)

    # ---- 4b. the LM kernel: its twin at the edges, then the stream's and
    # the serving chunk's shapes on the stream's DB, each with its times
    one_rev = torch.from_numpy(clouds[rev0 + 10]).to(dev)[None]
    revs16 = torch.from_numpy(np.stack(clouds[rev0 + 16:rev0 + 32])).to(dev)
    for name in kt.LM_EDGE_CASES:
        kt.hold_lm(*kt.lm_edge_case(name, dev)[:4], name, 2.0,
                   kt.LM_EDGE_CASES[name][4])
    log(f"gmm_lm at the edges {list(kt.LM_EDGE_CASES)}: bit-equal to the "
        f"plain twin")
    g = cfg.gmm
    lm_row = kt.measure_lm(*kt.lm_case(db, one_rev, cfg),
                           "a revisit query on the stream's DB", 200,
                           g.cov_dilate_scale, g.gn_iters)
    lm_row["block"] = kt.measure_lm(*kt.lm_case(db, revs16, cfg),
                                    "16 revisit queries on the stream's DB",
                                    200, g.cov_dilate_scale, g.gn_iters)
    for r in (lm_row, lm_row["block"]):
        log(f"gmm_lm: {r['shape']}, {r['sel_pairs']} close pairs: device "
            f"{r['device_us_warm']:.3f} us warm, {r['device_us_cold']:.3f} us "
            f"cold (torch.profiler, mean of 200); bound {r['bound_us']:.4f} "
            f"us by {r['bound_by']} ({r['bytes']} B, {r['flops']} flops, "
            f"{r['exps']} expf, chain {r['chain_bound_us']:.4f} us), share "
            f"{r['share_of_bound']:.4f} cold; call {r['ms']:.4f} ms (host + "
            f"launch), plain twin {r['plain_ms']:.4f} ms, the torch chain it "
            f"replaced {r['replaces_ms']:.4f} ms; bit-equal to the plain "
            f"twin ({smi})")
    rows.append(lm_row)

    # ---- 4c. the cascade kernel: its twin at the edges, then the stream's
    # and the serving chunk's shapes on the stream's DB, each with its times
    c_store, c_query, c_tq, c_hints = kt.cascade_edge_case(dev)
    for pot in (8, 128, None):
        kt.hold_cascade(c_store, c_query, c_tq, c_hints, cfg,
                        f"edges, p_pot {pot}", pot)
    log(f"cascade at the edges {list(kt.CASCADE_KINDS)}, p_pot 8, 128 and "
        f"None: bit-equal to the plain twin")
    casc_row = kt.measure_cascade(db, one_rev, cfg,
                                  "a revisit query on the stream's DB", 200)
    casc_row["block"] = kt.measure_cascade(
        db, revs16, cfg, "16 revisit queries on the stream's DB", 200)
    for r in (casc_row, casc_row["block"]):
        log(f"cascade: {r['shape']}, {r['rows_computed']} rows computed, "
            f"{r['close_pairs']} close pairs: device "
            f"{r['device_us_warm']:.3f} us warm, {r['device_us_cold']:.3f} us "
            f"cold (torch.profiler, mean of 200); bound {r['bound_us']:.4f} "
            f"us by {r['bound_by']} ({r['bytes']} B, {r['ops']:.0f} ops, "
            f"chain {r['chain_bound_us']:.4f} us), share "
            f"{r['share_of_bound']:.4f} cold; call {r['ms']:.4f} ms (host + "
            f"launch), plain twin {r['plain_ms']:.4f} ms; a call "
            f"{r['device_ops']} device ops and {r['busy_ms']:.4f} busy ms "
            f"against the twin's {r['plain_device_ops']} and "
            f"{r['plain_busy_ms']:.4f}; bit-equal to the plain twin ({smi})")
    rows.append(casc_row)

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
        desc_leaves_close(desc_g._fields, desc_g, desc_c, desc_c.nei_valid,
                          f"scan {row} on the card vs the CPU")
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
        lm_inputs_agree(tdb.refine_inputs(db.store, db.keys_q, desc_g,
                                          state.to(dev), cfg),
                        tdb.refine_inputs(store_c, kq_c, desc_gc, state, cfg),
                        row)
    lm_witness(cfg, db, clouds, found_rows, ts_c)

    # host syncs of the step, counted by torch's sync debug mode
    def four_more():
        for i in range(4):
            db.step_async(clouds[rev0 + i], n_scans + i, 0.1 * (n_scans + i))

    syncs = host_syncs(four_more) / 4
    log(f"host syncs per scan: {syncs:g} (torch sync debug mode, 4 scans)")
    assert syncs == 0, syncs

    # ---- 3d. the CC and merge kernels at the main path's shapes ---------
    adv = kt.adversarial_masks(cm.n_row, cm.n_col)
    for name, m in adv.items():
        kt.hold_cc(torch.from_numpy(m)[None].to(dev), name)
    kt.hold_cc(torch.from_numpy(np.stack(list(adv.values()))).to(dev),
               "every adversarial mask in one launch")
    # the cluster's strips: 5 rows and a last of 2, one row, none
    for nr, nc in ((37, 41), (8, 8), (5, 7)):
        kt.hold_cc(torch.from_numpy(np.stack(list(
            kt.adversarial_masks(nr, nc).values()))).to(dev), f"{nr} x {nc}")
    log(f"cc_labels on {sorted(adv)} (150 x 150), each alone and all in "
        f"one launch, and all at 37 x 41, 8 x 8 and 5 x 7 in one launch "
        f"each: bit-equal to the plain version")
    stress = kt.merge_stress_cases()
    for name, args in stress.items():
        kt.hold_merge(*(torch.from_numpy(x).to(dev) for x in args), name)
    log(f"merge_hints on the rows made to stress its lanes {sorted(stress)}: "
        f"bit-equal to the plain version")
    block0 = torch.from_numpy(np.stack(clouds[:16])).to(dev)
    cc_row = kt.measure_cc(kt.masks_of(one_rev, cfg), "a revisit scan")
    cc_row["block"] = kt.measure_cc(kt.masks_of(block0, cfg),
                                    "the stream's first block of 16")
    merge_row = kt.measure_merge(*kt.merge_case(db, one_rev, cfg),
                                 "a revisit query on the stream's DB")
    merge_row["block"] = kt.measure_merge(
        *kt.merge_case(db, revs16, cfg),
        "16 revisit queries on the stream's DB")
    cc_row["max_active_clusters"] = kt.cc_max_active_clusters(
        kt.masks_of(block0, cfg))
    cc_row["phase_split"] = kt.cc_phase_split(kt.masks_of(one_rev, cfg))
    cc_row["block"]["phase_split"] = kt.cc_phase_split(
        kt.masks_of(block0, cfg))
    merge_row["phase_split"] = kt.merge_phase_split(
        *kt.merge_case(db, one_rev, cfg))
    merge_row["block"]["phase_split"] = kt.merge_phase_split(
        *kt.merge_case(db, revs16, cfg))
    for r in (cc_row, cc_row["block"], merge_row, merge_row["block"]):
        extra = (f"{r['components']} components, clusters of 8 CTAs, "
                 f"{cc_row['max_active_clusters']} resident at once"
                 if "components" in r else
                 f"{r['hints']} hints in {r['rows_walked']} rows, the "
                 f"longest {r['longest_row']}, chain bound "
                 f"{r['chain_bound_us']:.4f} us")
        ps = r["phase_split"]
        log(f"{r['name']}: {r['shape']}, {extra}: device "
            f"{r['device_us_warm']:.3f} us warm, {r['device_us_cold']:.3f} us "
            f"cold (torch.profiler, mean of 200); bound {r['bound_us']:.4f} "
            f"us by {r['bound_by']} ({r['bytes']} B), share "
            f"{r['share_of_bound']:.4f} cold; call {r['ms']:.4f} ms (host + "
            f"launch), plain {r['plain_ms']:.4f} ms; bit-equal to the plain "
            f"version; by phase (clock64, the slowest of {ps['ctas']} CTAs, "
            f"us at the maximum SM clock) "
            + ", ".join(f"{n} {u:.3f}" for n, u in
                        zip(ps["phases"], ps["us_slowest_cta"]))
            + f" ({smi})")
    rows += [cc_row, merge_row]
    # the cascade of 8 queries across the stream over every hint column (one
    # kernel launch that zeroes the idle columns) against only the columns
    # of the chunks JAX's loop would run
    casc = []
    for k in range(20, n_scans, n_scans // 8):
        (o_all, b_all), (o_own, b_own), n_run = kt.cascade_case(
            db, torch.from_numpy(clouds[k]).to(dev)[None], cfg)
        casc.append((k, n_run, o_all, o_own, b_all, b_own))
    log(f"cascade, every chunk against the query's own chunks (chunks of "
        f"{cfg.db.cascade_chunk} of {cfg.db.max_check_cands} hint columns), "
        f"8 queries on the stream's DB (scan, n_valid after check 1, device "
        f"ops every / own, busy us every / own): "
        + "; ".join(f"{k} {n} {a} / {o} {1e3 * ba:.1f} / {1e3 * bo:.1f}"
                    for k, n, a, o, ba, bo in casc)
        + f"; mean {np.mean([c[2] - c[3] for c in casc]):.1f} ops and "
        f"{1e3 * np.mean([c[4] - c[5] for c in casc]):.1f} us more a query "
        f"(torch.profiler) ({smi})")

    # ---- 5. the CLI's default (unfused) path --------------------------
    cli_path = phase_5(cfg, clouds, rev0, smi)

    # ---- 6. a map built in blocks ----------------------------------------
    BLOCK, N_MAP = 16, 2 * LANE_SCANS
    n_full = N_MAP // BLOCK * BLOCK
    def build_map(m, graphed):
        """The map in blocks of BLOCK and a tail of single steps, graphed
        or through the eager bodies; returns the handles, the ms/scan of
        blocks 2.. (CUDA events: the first block captures the graphs) and
        the ms/scan of the whole map (every block and the tail over N_MAP
        scans, the captures included)."""
        m._graphs.enabled = graphed
        e_all = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        e_all[0].record()
        hs = [m.block_chain_pts_async(
            torch.from_numpy(np.stack(clouds[0:BLOCK]))[None],
            list(range(BLOCK)), [[0.1 * i for i in range(BLOCK)]])]
        torch.cuda.synchronize()

        def rest():
            ev0.record()
            for k in range(BLOCK, n_full, BLOCK):
                hs.append(m.block_chain_pts_async(
                    torch.from_numpy(np.stack(clouds[k:k + BLOCK]))[None],
                    list(range(k, k + BLOCK)),
                    [[0.1 * i for i in range(k, k + BLOCK)]]))
            ev1.record()

        # the graphed block steps after the capture under sync debug mode
        # "error": the build, append-and-window and query replays make no
        # sync
        no_syncs(rest) if graphed else rest()
        torch.cuda.synchronize()
        hs += [m.step_async(clouds[i], i, 0.1 * i)
               for i in range(n_full, N_MAP)]
        e_all[1].record()
        torch.cuda.synchronize()
        return (hs, ev0.elapsed_time(ev1) / (n_full - BLOCK),
                e_all[0].elapsed_time(e_all[1]) / N_MAP)

    db_b = tdb.ContourDB(cfg, capacity=8192, device="cuda")
    kernels.reset_launches()
    block_handles, block_ms, map_ms = build_map(db_b, True)
    tail = block_handles[n_full // BLOCK:]
    block_handles = block_handles[:n_full // BLOCK]
    torch.cuda.synchronize()
    launches_block = launch_counts(kernels)
    assert launches_block == add_counts(one_a_block(n_full // BLOCK),
                                        one_a_scan(N_MAP - n_full)), \
        launches_block
    graph_block = db_b.graph_stats()
    db_be = tdb.ContourDB(cfg, capacity=8192, device="cuda")
    _, block_ms_eager, map_ms_eager = build_map(db_be, False)
    assert_dbs_equal(db_b, db_be, N_MAP, "graphed block build vs eager")
    assert torch.equal(db_b.state, db_be.state)
    assert torch.equal(db_b.recs_store.view(torch.int32),
                       db_be.recs_store.view(torch.int32)), \
        "graphed block records vs the eager calls'"
    del db_be
    ring_b = db_b.recs_store[:N_MAP].cpu().numpy()
    assert_records_close(ring_b, ring[:N_MAP], "block-built ring")
    off_map = assert_dbs_close(db_b, db, N_MAP,
                               "block-built map vs the stream")
    state = torch.zeros(2, dtype=torch.int32)
    sb_last = []        # the last full block's searchable_b, replayed
    for j in range(N_MAP):
        if n_full - BLOCK <= j < n_full:
            sb_last.append(int(state[1]))
        state[0] = j + 1
        tdb.update_window(state, ts_c, ts_c[j], tb.min_elapse, tb.max_elapse)
    assert torch.equal(db_b.state.cpu(), state), (db_b.state, state)
    # the batched kernel against its plain version on what the block build
    # gave it: the map's keys_q, the last full block's query keys and limits
    # (behind the launch counts, so these launches count for no path)
    lv = list(cfg.db.q_levels)

    def block_keys(points_b):
        descs = td.build_descriptors(torch.from_numpy(points_b).to(dev), cm,
                                     cfg.gmm)
        return descs.keys[:, lv].to(torch.float32).contiguous()

    held = []

    def hold(m, q_b, sb, what):
        err = kt.hold_batch(m.keys_q, ql, q_b, sb, what)
        held.append({"path": what, "keys_q": list(m.keys_q.shape),
                     "kernel_path": kernels.search_tilemin_path(m.keys_q),
                     "B": int(sb.shape[0]), "searchable_b":
                     [int(sb.min()), int(sb.max())], "max_abs_err": err})
        log(f"search_tilemin_batch on the {what}: keys_q "
            f"{tuple(m.keys_q.shape)} {str(m.keys_q.dtype)[6:]}, "
            f"{held[-1]['kernel_path']} path, B {held[-1]['B']}, searchable_b "
            f"{held[-1]['searchable_b']}: bit-equal to the plain version, "
            f"max abs err {err}")

    assert max(sb_last) > 0, sb_last
    hold(db_b, block_keys(np.stack(clouds[n_full - BLOCK:n_full])),
         torch.tensor(sb_last, dtype=torch.int32, device=dev),
         "block build's last full block")
    held_ring = []

    def hold_ring(points_b, what):
        anchors_b, pool_b, centers = kt.ring_inputs_of(
            torch.from_numpy(points_b).to(dev), cfg)
        err = kt.hold_ring_batch(anchors_b, pool_b, centers, cm.roi_radius,
                                 what)
        _, counts = kernels.ring_key_divs_batch_plain(anchors_b, pool_b,
                                                      centers, cm.roi_radius)
        held_ring.append({"path": what, "anchors": list(anchors_b.shape),
                          "pool": list(pool_b.shape),
                          "counted_pixels": int(counts.sum()),
                          "max_abs_err": err})
        log(f"ring_key_divs_batch on the {what}: anchors "
            f"{tuple(anchors_b.shape)}, pool {tuple(pool_b.shape)}, "
            f"{held_ring[-1]['counted_pixels']} counted pixels: bit-equal to "
            f"the plain version and to one single launch a scan, max abs "
            f"err {err}")

    hold_ring(np.stack(clouds[n_full - BLOCK:n_full]),
              "block build's last full block")
    tdb.drain_block_handles(block_handles)
    db_b.drain(tail)
    assert db_b.n == N_MAP and db_b.ts == [0.1 * i for i in range(N_MAP)]
    # the same scans through the stream once more, behind the block build:
    # the step is host-bound and the host's speed drifts within a call, so
    # the block build is read between a stream before it and one after it
    db_s = tdb.ContourDB(cfg, capacity=8192, device="cuda")
    db_s.step_async(clouds[0], 0, 0.0)          # the capture
    torch.cuda.synchronize()
    ev0.record()
    for i in range(1, N_MAP):
        db_s.step_async(clouds[i], i, 0.1 * i)
    ev1.record()
    torch.cuda.synchronize()
    ms_scan_after = ev0.elapsed_time(ev1) / (N_MAP - 1)
    assert torch.equal(db_s.state, db_b.state)
    del db_s
    log(f"block build: {N_MAP} scans in {n_full // BLOCK} blocks of {BLOCK} "
        f"and a tail of {N_MAP - n_full}: launches {launches_block}; "
        f"records and window state {state.tolist()} equal the stream's "
        f"first {N_MAP} rows; store and keys_q bit-equal to them but for "
        f"{off_map or 'no leaf'} (leaf, max abs difference: in the "
        f"descriptor bands); blocks 2-{n_full // BLOCK}: {block_ms:.3f} "
        f"ms/scan graphed, {block_ms_eager:.3f} ms/scan for the eager calls "
        f"(CUDA events; store, window and records bit-equal); the whole "
        f"map (every block and the {N_MAP - n_full}-scan tail over {N_MAP} "
        f"scans, captures included): {map_ms:.3f} ms/scan graphed, "
        f"{map_ms_eager:.3f} eager; captures {graph_block['capture_s']} s, "
        f"graph pool {graph_block['pool_bytes']} bytes; the stream over the "
        f"same scans in this call: {ms_scan_map:.3f} ms/scan before it "
        f"(after its {WARMUP}-scan warm-up), {ms_scan_after:.3f} ms/scan "
        f"after it (steps 2-{N_MAP}: the first captures) ({smi})")
    # one block of 16 revisit queries on the block-built map: the batched
    # tail against the same 16 queries through the same code at B = 1
    split = block_split(db_b, np.stack(clouds[rev0:rev0 + BLOCK]), cfg)
    assert_records_close(split["records"].cpu().numpy(),
                         split["records_one_by_one"].cpu().numpy(),
                         "batched tail vs the same queries at B = 1")
    assert int((split["records"][:, 0] > 0.5).sum()) >= BLOCK // 2
    assert split["tail_host_syncs"] == 0, split["tail_host_syncs"]
    assert split["build_host_syncs"] <= \
        split["single_build_host_syncs_max"], split
    descs_1 = split["descs_one_by_one"]
    off_build = desc_leaves_close(descs_1._fields, split["descs"], descs_1,
                                  descs_1.nei_valid.cpu(),
                                  "batched build vs the 16 single builds")
    block_ops = sum(split[k] for k in ("build_device_ops",
                                       "search_device_ops",
                                       "tail_device_ops"))
    log(f"block build split, {BLOCK} revisit clouds, a sync around each: "
        f"one batched build {split['build_ms']:.2f} ms "
        f"({split['build_device_ops']} device ops, the card busy "
        f"{split['build_device_busy_ms']:.2f} ms, "
        f"{split['build_host_syncs']} host syncs); the same {BLOCK} clouds "
        f"built one at a time {split['builds_one_by_one_ms']:.2f} ms "
        f"({split['builds_one_by_one_device_ops']} device ops, busy "
        f"{split['builds_one_by_one_device_busy_ms']:.2f} ms, "
        f"{split['builds_one_by_one_host_syncs']} host syncs, the slowest "
        f"single build {split['single_build_host_syncs_max']}); the "
        f"descriptors of both agree, bit for bit but for "
        f"{off_build or 'no leaf'} (leaf, max abs difference: in the "
        f"descriptor bands) ({smi})")
    log(f"block step split, {BLOCK} revisit queries on the block-built map, "
        f"a sync around each part: build {split['build_ms']:.2f} ms "
        f"({split['build_device_ops']} device ops), batched search "
        f"{split['search_ms']:.2f} ms ({split['search_device_ops']}), the "
        f"batched tail {split['tails_ms']:.2f} ms "
        f"({split['tail_device_ops']} device ops keeping the card busy "
        f"{split['tail_device_busy_ms']:.2f} ms under the profiler, "
        f"{split['tail_host_syncs']} host syncs); {block_ops} device ops a "
        f"block, the card busy {split['build_device_busy_ms']:.2f} ms with "
        f"the builds; the same {BLOCK} tails one query at a time "
        f"{split['tails_one_by_one_ms']:.2f} ms "
        f"({split['one_by_one_device_ops']} device ops, busy "
        f"{split['one_by_one_device_busy_ms']:.2f} ms, "
        f"{split['one_by_one_host_syncs']} host syncs); the records of both "
        f"agree: found, gidx and counters exactly, corr and pose in the "
        f"stream's bands ({smi})")

    # the same block step of 16 revisit clouds as replays of the block-built
    # map's graphs (the build graph and the query graph of 16), nothing
    # appended, beside the eager bodies they captured
    pts16 = np.stack(clouds[rev0:rev0 + BLOCK])
    sb16 = db_b.state[1].expand(BLOCK).contiguous()

    def block_parts(graphed):
        with contextlib.nullcontext() if graphed else db_b.eager():
            return db_b._query_batch(db_b._build_batch(pts16), sb16).clone()

    def timed_ms(fn, reps=5):
        ts_ = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts_.append(1e3 * (time.perf_counter() - t0))
        return out, float(np.median(ts_))

    recs_g, g_ms = timed_ms(lambda: block_parts(True))
    recs_e, e_ms = timed_ms(lambda: block_parts(False))
    assert torch.equal(recs_g.view(torch.int32), recs_e.view(torch.int32)), \
        "graphed block step vs the eager bodies"
    assert_records_close(recs_g.cpu().numpy(),
                         split["records"].cpu().numpy(),
                         "graphed block step vs the split's")
    g_launch = launch_counts(kernels)
    no_syncs(lambda: block_parts(True))
    torch.cuda.synchronize()
    g_launch = {k: v - g_launch[k] for k, v in launch_counts(kernels).items()}
    assert g_launch == one_a_block(1), g_launch
    g_ops, g_busy = device_ops(lambda: block_parts(True))
    e_ops, e_busy = device_ops(lambda: block_parts(False))
    log(f"block step of {BLOCK} revisit clouds as graph replays (the build "
        f"graph and the query graph of {BLOCK} on the block-built map, a "
        f"sync around): {g_ms:.2f} ms graphed against {e_ms:.2f} ms for the "
        f"eager bodies (median of 5, host clock); 0 host syncs (sync debug "
        f"mode \"error\"); launches {g_launch}; records bit-equal; "
        f"torch.profiler sees {g_ops} device ops (busy {g_busy:.2f} ms) in "
        f"the replays and {e_ops} (busy {e_busy:.2f} ms) in the eager "
        f"bodies ({smi})")
    held_cc, held_merge = [], []

    def hold_new(points_b, m, what):
        pts_d = torch.from_numpy(points_b).to(dev)
        masks = kt.masks_of(pts_d, cfg)
        held_cc.append({"path": what, "masks": list(masks.shape),
                        "max_abs_err": kt.hold_cc(masks, what)})
        hint_of, T, votes = kt.merge_case(m, pts_d, cfg)
        held_merge.append({"path": what, "hint_of": list(hint_of.shape),
                           "hints": int((hint_of >= 0).sum()),
                           "max_abs_err": kt.hold_merge(hint_of, T, votes,
                                                        what)})
        log(f"cc_labels and merge_hints on the {what}: masks "
            f"{tuple(masks.shape)}, hint_of {tuple(hint_of.shape)} "
            f"({held_merge[-1]['hints']} hints): bit-equal to their plain "
            f"versions")

    hold_new(np.stack(clouds[n_full - BLOCK:n_full]), db_b,
             "block build's last full block")
    hold_new(pts16, db_b, "block step's 16 revisit clouds")

    # ---- 7. checkpoint, reload, merge ------------------------------------
    def assert_restored(back, orig, what):
        assert_dbs_equal(back, orig, orig.n, what)
        assert torch.equal(back.state.cpu(), orig.state.cpu()), what
        assert back.n == orig.n and back.seq_of_gidx == orig.seq_of_gidx
        assert back.ts == orig.ts and back.counters == orig.counters, what

    with tempfile.TemporaryDirectory() as d:
        f_map, f_base, f_delta, f_merged = (
            os.path.join(d, f) for f in ("map.npz", "base.npz", "delta.npz",
                                         "merged.npz"))
        t0 = time.perf_counter()
        db_b.save(f_map)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        db_l = tdb.ContourDB.load(f_map, cfg, device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        assert_restored(db_l, db_b, "reloaded block-built map")
        db.save(f_base)
        n_base = db.n
        more = [db.step_async(clouds[rev0 + 4 + i], n_base + i,
                              0.1 * (n_base + i)) for i in range(16)]
        db.drain(more)
        db.save(f_delta, since=n_base)
        db_chain = tdb.ContourDB.load_chain([f_base, f_delta], cfg,
                                            device="cuda")
        assert_restored(db_chain, db, "base + delta chain")
        assert db_chain.n == n_base + 16 and db.counters["n_hints"] > 0
        sizes = {os.path.basename(f): os.path.getsize(f)
                 for f in (f_map, f_base, f_delta)}
        served = tdb.ContourDB.merge([db_b, db_l])
        served.save(f_merged)
        served_c = tdb.ContourDB.load(f_merged, cfg, device="cpu")
    assert served.n == 2 * N_MAP and served.state.tolist() == [2 * N_MAP] * 2
    assert served.session_of_gidx[N_MAP + 5] == (1, 5)
    log(f"checkpoints: block-built map ({N_MAP} rows) saved in {t_save:.2f} s "
        f"and loaded in {t_load:.2f} s; base ({n_base} rows) + delta (16 "
        f"rows) chain restored; every store leaf, keys_q, ts_store, state, "
        f"seq_of_gidx, ts and counters equal their originals; file bytes "
        f"{sizes}; merged serving map {served.n} rows, all searchable ({smi})")

    # ---- 8. serving ------------------------------------------------------
    revisit = np.stack(clouds[rev0:])
    torch.cuda.synchronize()
    mem_held = torch.cuda.memory_allocated()  # the DBs of the phases above
    torch.cuda.reset_peak_memory_stats()
    # a capture empties the allocator's cache as it starts: empty it here
    # too, so the growth is what the serving map's graphs hold
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    # the first chunk captures the build and query graphs of 16
    served.localize_block_async(revisit[:BLOCK], chunk=BLOCK).get()
    torch.cuda.synchronize()
    serve_grown = torch.cuda.memory_reserved() - reserved0
    graph_serve = served.graph_stats()
    served.serving_counters = tdb.ContourDB._zero_serving_counters()
    kernels.reset_launches()
    torch.cuda.synchronize()
    ev0.record()
    h_serve = served.localize_block_async(revisit, chunk=BLOCK)
    ev1.record()
    torch.cuda.synchronize()
    serve_ms = ev0.elapsed_time(ev1) / LANE_SCANS
    peak_serve = torch.cuda.max_memory_allocated()
    n_chunks = -(-LANE_SCANS // BLOCK)
    launches_serve = launch_counts(kernels)
    # one batched build a chunk: the pad clouds build in the last one
    assert launches_serve == one_a_block(n_chunks), launches_serve
    ev0.record()
    with served.eager():
        h_eager = served.localize_block_async(revisit, BLOCK)
    ev1.record()
    torch.cuda.synchronize()
    serve_ms_eager = ev0.elapsed_time(ev1) / LANE_SCANS
    assert torch.equal(h_serve.recs.view(torch.int32),
                       h_eager.recs.view(torch.int32)), \
        "graphed serving vs the eager calls"
    no_syncs(lambda: served.localize_block_async(revisit[:BLOCK],
                                                 chunk=BLOCK))
    tail_pts_ = np.concatenate([
        revisit[(n_chunks - 1) * BLOCK:],
        np.zeros((n_chunks * BLOCK - LANE_SCANS,) + revisit.shape[1:],
                 revisit.dtype)])
    hold_new(revisit[:BLOCK], served, "serving map, first chunk")
    hold_new(tail_pts_, served, "serving map, padded last chunk")
    # the batched kernel against its plain version on what serving gave it:
    # the merged map's keys_q (a partial last tile), every limit the map's
    # n; the first chunk, and the last with its zero pad clouds
    sb_serve = served.state[1].expand(BLOCK).contiguous()
    hold(served, block_keys(revisit[:BLOCK]), sb_serve,
         "serving map, first chunk")
    tail_pts = np.concatenate([
        revisit[(n_chunks - 1) * BLOCK:],
        np.zeros((n_chunks * BLOCK - LANE_SCANS,) + revisit.shape[1:],
                 revisit.dtype)])
    hold(served, block_keys(tail_pts), sb_serve,
         "serving map, padded last chunk")
    hold_ring(tail_pts, "serving's padded last chunk")
    res = h_serve.get()
    assert len(res) == LANE_SCANS and served.n == 2 * N_MAP
    assert served.counters == tdb.ContourDB._zero_counters()
    assert served.serving_counters["n_hints"] > 0
    right = sum(1 for i, r in enumerate(res) if r is not None
                and abs(served.session_of_gidx[r[0]][1] - i) <= 3)
    assert right >= LANE_SCANS // 2, right
    recs_serve = h_serve.recs.cpu()
    found_rows = [i for i, r in enumerate(res) if r is not None]
    for i in (found_rows[len(found_rows) // 3],
              found_rows[3 * len(found_rows) // 4]):
        desc_g = td.build_descriptor(torch.from_numpy(revisit[i]).to(dev),
                                     cm, cfg.gmm)
        desc_c = type(desc_g)(*[x.cpu() for x in desc_g])
        for m, q in ((served, desc_g), (served_c, desc_c)):
            rec = m.query_async(q).rec.cpu()
            assert_records_close(rec[None], recs_serve[i][None],
                                 f"serving record {i}")
    hits_g, n_g = served.range_search(desc_g, 60.0, cap=64)
    hits_c, n_c = served_c.range_search(desc_c, 60.0, cap=64)
    assert n_g == n_c > 0 and [h[:4] for h in hits_g] == [h[:4] for h in hits_c]
    np.testing.assert_allclose([h[4] for h in hits_g], [h[4] for h in hits_c],
                               rtol=1e-6, atol=0)
    range_rows = phase_8_range(served, served_c, db, desc_g, smi)
    chunk_ops, chunk_busy = device_ops(lambda: served.localize_block_async(
        revisit[:BLOCK], chunk=BLOCK))
    chunk_syncs = host_syncs(lambda: served.localize_block_async(
        revisit[:BLOCK], chunk=BLOCK))
    assert chunk_syncs == 0, chunk_syncs
    # the device memory one batched build of a chunk adds at its peak
    pts_chunk = torch.from_numpy(revisit[:BLOCK]).to(dev)
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    td.build_descriptors(pts_chunk, cm, cfg.gmm)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() - mem_before
    log(f"serving: {LANE_SCANS} revisit clouds in {n_chunks} chunks of "
        f"{BLOCK} (tail padded): launches {launches_serve}, "
        f"found at the right place {right}/{LANE_SCANS}; two records equal "
        f"query_async on the card and on a CPU copy of the map; "
        f"range_search {n_g} in range, equal on both; {serve_ms:.3f} "
        f"ms/query graphed against {serve_ms_eager:.3f} ms/query for the "
        f"eager calls (CUDA events; records bit-equal; captures "
        f"{graph_serve['capture_s']} s, graph pool "
        f"{graph_serve['pool_bytes']} bytes), {chunk_ops} device ops (the "
        f"card busy "
        f"{chunk_busy:.2f} ms under the profiler) and {chunk_syncs} host "
        f"syncs a chunk of {BLOCK} (builds included), peak allocated "
        f"{peak_serve} bytes, of which {mem_held} held before by this "
        f"script's DBs; one batched build of {BLOCK} adds {build_peak} "
        f"bytes at its peak ({smi})")
    log(f"serving counters: {served.serving_counters}")
    # two DBs with graphs of 16 (the block-built map and the serving map)
    # hold the device's one pool: every graph of both carries one pool id,
    # the id of the pool's segments in the allocator's snapshot, and the
    # serving map's captures grew the card's reserved memory by less than
    # half that pool (a pool of its own would add about as much again)
    st_b, st_s = db_b.graph_stats(), served.graph_stats()
    assert st_b["pool_bytes"] == st_s["pool_bytes"] \
        == graph_serve["pool_bytes"] > 0, (st_b, st_s)
    assert {k[0] for k in map(eval, st_b["capture_s"])} >= {"build",
                                                             "query"}
    pool_ids = {tuple(g.graph.pool()) for m in (db_b, served)
                for g in m._graphs.graphs.values()}
    assert len(pool_ids) == 1, pool_ids
    (pool_id,) = pool_ids
    pool_segs = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                    if tuple(seg.get("segment_pool_id", ())) == pool_id)
    assert pool_segs == st_s["pool_bytes"], (pool_segs, st_s)
    assert serve_grown < st_s["pool_bytes"] // 2, (serve_grown, st_s)
    log(f"graph pool: the block-built map ({len(st_b['capture_s'])} graphs) "
        f"and the serving map ({len(st_s['capture_s'])} graphs), both with "
        f"the build and query graphs of {BLOCK}, share one pool of "
        f"{st_s['pool_bytes']} bytes ({st_s['pool']}; one pool id "
        f"{pool_id} on all {len(st_b['capture_s']) + len(st_s['capture_s'])}"
        f" graphs, its segments {pool_segs} bytes; the serving map's "
        f"captures grew the reserved memory by {serve_grown} bytes); "
        f"f96694d held "
        f"3275751424 bytes a DB for each; serving peak allocated "
        f"{peak_serve} bytes against f96694d's 5276009472 ({smi})")

    # ---- 9. dynamic_thres ------------------------------------------------
    dyn_path, dyn_rows = phase_9(cfg, clouds, rev0, smi)
    rows += dyn_rows

    # ---- 10. the user-facing surface ------------------------------------
    by_path = phase_10(cfg, clouds, ring, db, rev0, smi, served)

    # ---- 11. sharded serving and search ---------------------------------
    sharded = phase_11(cfg, clouds, db, served, rev0, smi)

    batched = ("ring_key_divs_batch", "search_tilemin_batch")
    dynamic = ("dyn_pass_scan", "dyn_post_scan")
    for r in rows:
        # the stream launches the single entries and the CC and merge
        # kernels, the block build the batched ones, the dynamic_thres
        # stream the two dynamic scans
        r["launches"] = (launches_block if r["name"] in batched
                         else dyn_path if r["name"] in dynamic
                         else launches)[r["name"]]
        assert r["launches"] > 0, r["name"]
        r["launches_by_path"] = {
            "stream": launches[r["name"]],
            "cli_default": cli_path[r["name"]],
            "block_build": launches_block[r["name"]],
            "serving": launches_serve[r["name"]],
            "dynamic_thres": dyn_path[r["name"]],
            **{path: n[r["name"]] for path, n in by_path.items()},
            "sharded": sum(n[r["name"]] for n in sharded.values())}
        r["sharded_launches"] = {k: n[r["name"]] for k, n in sharded.items()}
    for r, h in ((brow, held), (rrow, held_ring), (cc_row, held_cc),
                 (merge_row, held_merge)) + tuple(
                     (d, d["held_on_paths"]) for d in dyn_rows):
        r["held_on_paths"] = h
        r["max_abs_err"] = max([r["max_abs_err"]]
                               + [x["max_abs_err"] for x in h])
    print(json.dumps({"kernels": rows}), flush=True)
    print(kt.card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
