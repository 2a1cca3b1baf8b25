"""CLI batch entry point of the torch port (the cont2_batch_bin_test executable).

    python -m contour_context_tpu_torch --pose ts-sens_pose.txt \\
        --laser ts-lidar_bins.txt --outcome outcome.txt [--max-scans N] \\
        [--device cuda] [--config batch_bin_test_config.yaml] \\
        [--fused-step] [--chain K] [--timing-log log/timing.txt] \\
        [--save-mid-dir DIR] [--trace-dir DIR]

Same inputs, flags and outcome-file format as `python -m contour_context_tpu`.
The replay runs on `--device`: per scan through the unfused API (build,
query, add, push; a per-stage timing report), with `--fused-step` through
one `step_async` a scan, with `--chain K` staged K scans at a time.
`--save-mid-dir` writes each scan's contour dump and BEV image (and turns
`--fused-step` off), `--timing-log` appends the timing report to a file and
`--trace-dir` writes a torch.profiler trace of the replay as Chrome JSON
(`cont2_trace.json`).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from contour_context_tpu_torch.config import PipelineConfig, load_pipeline_config_yaml


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m contour_context_tpu_torch",
                                 description=__doc__)
    ap.add_argument("--config", help="reference-format YAML config")
    ap.add_argument("--pose", help="gt sensor pose file (13 cols/line)")
    ap.add_argument("--laser", help="scan list file (ts seq path)")
    ap.add_argument("--outcome", help="outcome file to write")
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the DB and the step (default cuda)")
    ap.add_argument("--timing-log", help="append the stage-timing report here")
    ap.add_argument("--save-mid-dir",
                    help="write per-scan contour dumps + BEV images here")
    ap.add_argument("--fused-step", action="store_true",
                    help="one step_async per scan (collapses the per-stage "
                         "timing report into one row; ignored when "
                         "--save-mid-dir is set, which needs the descriptor "
                         "on the host)")
    ap.add_argument("--trace-dir",
                    help="write a torch.profiler trace of the replay (host "
                         "ops and CUDA kernels) into this directory as "
                         "Chrome JSON")
    ap.add_argument("--chain", type=int, default=None, metavar="K",
                    help="stage K scans per host-to-device copy and step "
                         "them one by one (exact per-scan semantics at any "
                         "timestamp spacing, unlike the batched block mode)")
    args = ap.parse_args(argv)

    cfg = PipelineConfig()
    io_paths = {}
    if args.config:
        cfg, io_paths = load_pipeline_config_yaml(args.config)
    fpath_pose = args.pose or io_paths.get("fpath_sens_gt_pose")
    fpath_laser = args.laser or io_paths.get("fpath_lidar_bins")
    fpath_outcome = args.outcome or io_paths.get("fpath_outcome_sav")
    if not (fpath_pose and fpath_laser and fpath_outcome):
        ap.error("need --pose/--laser/--outcome (or a --config providing "
                 "fpath_sens_gt_pose/fpath_lidar_bins/fpath_outcome_sav)")

    from contour_context_tpu_torch.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu_torch.pipeline import (LoopClosurePipeline,
                                                    torch_trace)

    ev = ContLCDEvaluator(fpath_pose, fpath_laser, cfg.correlation_thres)
    pipe = LoopClosurePipeline(cfg, ev, capacity=max(len(ev) + 8, 64),
                               save_mid_dir=args.save_mid_dir,
                               fused_step=args.fused_step, device=args.device)
    with torch_trace(args.trace_dir, pipe.db.device):
        if args.chain:
            pipe.run_chained(chain=args.chain, max_scans=args.max_scans)
        else:
            pipe.run(max_scans=args.max_scans, progress_every=200)
    pipe.save_outcome(fpath_outcome)
    pipe.stp.print_screen()
    if args.timing_log:
        pipe.stp.print_file(args.timing_log)
    tp = sum(1 for r in pipe.results if r.tfpn == 0)
    fp = sum(1 for r in pipe.results if r.tfpn == 1)
    fn = sum(1 for r in pipe.results if r.tfpn == 3)
    print("done: %d scans, tp=%d fp=%d fn=%d -> %s"
          % (len(pipe.results), tp, fp, fn, fpath_outcome))


if __name__ == "__main__":
    main()
