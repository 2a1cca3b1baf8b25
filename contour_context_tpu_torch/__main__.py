"""CLI batch entry point of the torch port (the cont2_batch_bin_test executable).

    python -m contour_context_tpu_torch --pose ts-sens_pose.txt \\
        --laser ts-lidar_bins.txt --outcome outcome.txt [--max-scans N] \\
        [--device cuda] [--config batch_bin_test_config.yaml] \\
        [--fused-step] [--chain K]

Same inputs, flags and outcome-file format as `python -m contour_context_tpu`.
The replay runs on `--device`: per scan through the unfused API (build,
query, add, push; a per-stage timing report), with `--fused-step` through
one `step_async` a scan, with `--chain K` staged K scans at a time.
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
    ap.add_argument("--fused-step", action="store_true",
                    help="one step_async per scan (collapses the per-stage "
                         "timing report into one row)")
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

    from contour_context_tpu_torch.pipeline import run_batch

    pipe = run_batch(fpath_pose, fpath_laser, fpath_outcome, cfg,
                     max_scans=args.max_scans, device=args.device,
                     fused_step=args.fused_step, chain=args.chain)
    tp = sum(1 for r in pipe.results if r.tfpn == 0)
    fp = sum(1 for r in pipe.results if r.tfpn == 1)
    fn = sum(1 for r in pipe.results if r.tfpn == 3)
    print("done: %d scans, tp=%d fp=%d fn=%d -> %s"
          % (len(pipe.results), tp, fp, fn, fpath_outcome))


if __name__ == "__main__":
    main()
