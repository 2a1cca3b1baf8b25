"""The metric of record: PR curve, max-F1, recall@P=1 and TP pose error (MPE).

The port's own copy of `contour_context_tpu/eval/pr_mpe.py`:

    python -m contour_context_tpu_torch.eval.pr_mpe GT_POSES OUTCOME... [--plot PNG]

Exact-parity, vectorized reimplementation of the reference scorer
(scripts/pr_mpe.py:29-163).  Semantics reproduced:

- gt-positive label: scan i is positive iff some scan j with j < i - 150 lies
  within 5 m (pr_mpe.py:84-89; 150-frame exclusion, not seconds).
- one est row per outcome line: [corr, within-5m-of-predicted, gt_positive, idx]
  (pr_mpe.py:94-111).
- PR sweep: sort rows by corr desc; walking down, tp/fp from the "within 5 m"
  flag and fn = gt-positives strictly below the cut (pr_mpe.py:117-133).
- max F1 over the sweep; its threshold = corr of the line indexed by the scan id
  at the max point (pr_mpe.py:141-146).
- MPE: mean/RMSE of translation (cols 3,4) and rotation (col 5) over lines with
  corr >= thres AND within-5m AND gt-positive (pr_mpe.py:148-163).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

THRES_DIST = 5.0
EXCL_RECENT_FRAMES = 150


def load_gt_sens_poses(fpath: str) -> np.ndarray:
    """(N, 12) pose rows from the 13-column gt file (pr_mpe.py:12-26)."""
    raw = np.loadtxt(fpath, dtype=np.float64)
    if raw.ndim == 1:
        raw = raw[None]
    assert raw.shape[1] == 13
    return raw[:, 1:]


def gt_positive_labels(gt_pose: np.ndarray,
                       thres_dist: float = THRES_DIST,
                       excl_frames: int = EXCL_RECENT_FRAMES) -> np.ndarray:
    """Scan i is gt-positive iff exists j < i - excl_frames within thres_dist."""
    pts = gt_pose[:, [3, 7, 11]]
    n = len(pts)
    labels = np.zeros(n, dtype=bool)
    try:
        from scipy.spatial import cKDTree
        tree = cKDTree(pts)
        for i in range(n):
            for j in tree.query_ball_point(pts[i], thres_dist):
                if j < i - excl_frames:
                    labels[i] = True
                    break
    except ImportError:  # pure-numpy fallback
        for i in range(excl_frames + 1, n):
            d = np.linalg.norm(pts[: i - excl_frames] - pts[i], axis=1)
            if (d < thres_dist).any():
                labels[i] = True
    return labels


@dataclass
class OutcomeLine:
    tfpn: int
    idx_curr: int
    idx_best: int  # -1 for 'x'
    corr: float
    err: Tuple[float, float, float]


def parse_outcome_file(fpath: str) -> List[OutcomeLine]:
    out: List[OutcomeLine] = []
    with open(fpath) as f:
        for line in f:
            p = line.split()
            if len(p) < 6:
                continue
            pairing = p[1].split("-")
            out.append(OutcomeLine(
                tfpn=int(p[0]),
                idx_curr=int(pairing[0]),
                idx_best=-1 if pairing[1] == "x" else int(pairing[1]),
                corr=float(p[2]),
                err=(float(p[3]), float(p[4]), float(p[5])),
            ))
    return out


@dataclass
class PRResult:
    pr_points: np.ndarray        # (N, 2) [recall, precision] in sweep order
    max_f1: float
    max_f1_thres: float
    recall_at_p1: float
    tp_count: int
    trans_mean: float
    trans_rmse: float
    rot_mean_deg: float
    rot_rmse_deg: float


def score_outcome(fp_gt_sens_poses: str, fp_outcome: str,
                  thres_dist: float = THRES_DIST,
                  excl_frames: int = EXCL_RECENT_FRAMES) -> PRResult:
    gt_pose = load_gt_sens_poses(fp_gt_sens_poses)
    gt_positive = gt_positive_labels(gt_pose, thres_dist, excl_frames)
    lines = parse_outcome_file(fp_outcome)

    pts = gt_pose[:, [3, 7, 11]]
    corr = np.array([l.corr for l in lines])
    idx_curr = np.array([l.idx_curr for l in lines])
    idx_best = np.array([l.idx_best for l in lines])

    within5 = np.zeros(len(lines), dtype=np.float64)
    has_best = idx_best >= 0
    if has_best.any():
        d = np.linalg.norm(pts[idx_curr[has_best]] - pts[idx_best[has_best]], axis=1)
        within5[has_best] = (d < thres_dist).astype(np.float64)
    gt_pos = gt_positive[idx_curr].astype(np.float64)

    # PR sweep, vectorized (pr_mpe.py:117-133).  Stable sort for determinism
    # among tied correlations.
    order = np.argsort(-corr, kind="stable")
    w5 = within5[order]
    gp = gt_pos[order]
    tp = np.cumsum(w5)
    fp = np.cumsum(1.0 - w5)
    # fn_i = number of gt-positive rows strictly after i in sorted order
    fn = np.concatenate([np.cumsum(gp[::-1])[::-1][1:], [0.0]])
    denom_r = tp + fn
    recall = np.divide(tp, denom_r, out=np.zeros_like(tp), where=denom_r > 0)
    precision = tp / (tp + fp)
    pr_points = np.stack([recall, precision], axis=1)

    f1_den = recall + precision
    f1 = np.divide(2 * recall * precision, f1_den, out=np.zeros_like(recall), where=f1_den > 0)
    # reference keeps the FIRST max with strict '>' (pr_mpe.py:33-39)
    best_i = int(np.flatnonzero(f1 == f1.max())[0])
    max_f1 = float(f1[best_i])
    # the "pose idx" at the max point is the scan seq id (pr_mpe.py:133,145);
    # the reference indexes `lines[idx]` directly, valid only when seq ids are
    # dense 0..N-1 — look the line up by seq for identical results on dense
    # data and correct behavior when scans were dropped (sparse seqs)
    f1_pose_idx = int(idx_curr[order][best_i])
    line_by_seq = {l.idx_curr: l for l in lines}
    max_f1_thres = float(line_by_seq[f1_pose_idx].corr)

    p1 = precision >= 1.0
    recall_at_p1 = float(recall[p1].max()) if p1.any() else 0.0

    # TP pose errors at the max-F1 threshold (pr_mpe.py:148-163)
    is_tp = (corr >= max_f1_thres) & (within5 == 1) & (gt_pos == 1)
    errs = np.array([l.err for l in lines])
    te = errs[is_tp][:, :2]
    re = errs[is_tp][:, 2]
    tn = np.sqrt((te ** 2).sum(axis=1))
    if len(tn):
        trans_mean = float(tn.mean())
        trans_rmse = float(np.sqrt((tn ** 2).mean()))
        rot_mean = float(np.abs(re).mean())
        rot_rmse = float(np.sqrt((re ** 2).mean()))
    else:
        trans_mean = trans_rmse = rot_mean = rot_rmse = -1.0

    return PRResult(
        pr_points=pr_points,
        max_f1=max_f1,
        max_f1_thres=max_f1_thres,
        recall_at_p1=recall_at_p1,
        tp_count=int(is_tp.sum()),
        trans_mean=trans_mean,
        trans_rmse=trans_rmse,
        rot_mean_deg=rot_mean / np.pi * 180 if rot_mean >= 0 else -1.0,
        rot_rmse_deg=rot_rmse / np.pi * 180 if rot_rmse >= 0 else -1.0,
    )


def plot_pr_curves(results, labels, out_path: str) -> None:
    """PR-curve figure (reference pr_mpe.py:169-207): one curve per outcome
    file, recall on x, precision on y."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1, figsize=(7, 5))
    for j, (r, lab) in enumerate(zip(results, labels)):
        ax.plot(r.pr_points[:, 0], r.pr_points[:, 1], color="C%d" % (j % 10),
                label="%s (maxF1 %.4f)" % (lab, r.max_f1))
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1.02)
    ax.set_ylim(0, 1.02)
    ax.grid(True, alpha=0.3)
    ax.legend(loc="lower left")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="PR / max-F1 / MPE scorer (pr_mpe.py parity)")
    ap.add_argument("gt_poses")
    ap.add_argument("outcome", nargs="+",
                    help="one or more outcome files (curves overlay)")
    ap.add_argument("--plot", help="save the PR curve(s) to this image path")
    ap.add_argument("--thres-dist", type=float, default=THRES_DIST,
                    help="gt-positive ball radius, m (reference: 5)")
    ap.add_argument("--excl-frames", type=int, default=EXCL_RECENT_FRAMES,
                    help="exclude this many most-recent frames from gt "
                         "positives (reference: 150; use ~2 for the "
                         "6 s/scan synthetic trajectories)")
    args = ap.parse_args(argv)
    results = [score_outcome(args.gt_poses, oc, thres_dist=args.thres_dist,
                             excl_frames=args.excl_frames)
               for oc in args.outcome]
    for oc, r in zip(args.outcome, results):
        if len(results) > 1:
            print("==", oc)
        print("Max F1 score: %f @thres %f" % (r.max_f1, r.max_f1_thres))
        print("Recall @ P=1: %f" % r.recall_at_p1)
        print("TP count: ", r.tp_count)
        print("Rot mean err: ", r.rot_mean_deg)
        print("Rot rmse    : ", r.rot_rmse_deg)
        print("Trans mean err: ", r.trans_mean)
        print("Trans rmse    : ", r.trans_rmse)
    if args.plot:
        plot_pr_curves(results, [os.path.basename(o) for o in args.outcome],
                       args.plot)
        print("PR curve ->", args.plot)


if __name__ == "__main__":
    main()
