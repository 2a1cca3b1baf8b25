"""Debug artifact writers: contour dumps and BEV images.

The port's own copy of `contour_context_tpu/utils/dumps.py`.

Parity with the reference's offline debugging outputs:
- `save_contours`: the 20-column text dump (ContourManager::saveContours,
  contour_mng.cpp:7-47) wrapped in DATA_START/DATA_END, readable by
  scripts/plot_contours.py (both theirs and ours). Columns:
  0 level, 1 cell_cnt, 2-3 pos_mean, 4-7 pos_cov (column-major), 8-9 eig_vals,
  10-13 eig_vecs (column-major), 14 eccen, 15 vol3_mean, 16-17 com,
  18 ecc_feat, 19 com_feat.
  NOTE: the cov columns carry the reconstructed V diag(clamped eig) V^T
  (contour.h:376-378 getManualCov); for contours whose small eigenvalue sits
  below the point_sigma floor this differs from the raw sample covariance the
  C++ dumps — the ellipse drawn from it matches what the pipeline actually
  uses.
- `save_bev_image`: the SAVE_MID_FILE BEV visualization (contour_mng.h:547-555)
  as a PNG (matplotlib, if present) or portable .pgm fallback.
"""

from __future__ import annotations

import math

import numpy as np

from contour_context_tpu_torch.config import ContourManagerConfig


def save_contours(fpath: str, desc, cfg: ContourManagerConfig) -> None:
    """Write the 20-column contour dump for one ScanDesc on the host (numpy
    arrays or CPU tensors)."""
    cnt = np.asarray(desc.cnt)
    valid = np.asarray(desc.valid)
    mean = np.asarray(desc.mean)
    cov = np.asarray(desc.manual_cov)
    eig = np.asarray(desc.eig_vals)
    vecs = np.asarray(desc.eig_vecs)
    vol3 = np.asarray(desc.vol3_mean)
    com_r = np.asarray(desc.com_r)
    ecc_feat = np.asarray(desc.ecc_feat)
    sigma = cfg.view_stat.point_sigma

    with open(fpath, "w") as f:
        f.write("\nDATA_START\n")
        for lev in range(cnt.shape[0]):
            for k in range(cnt.shape[1]):
                if not valid[lev, k]:
                    continue
                small = cnt[lev, k] < cfg.view_stat.min_cell_cov
                l0, l1 = float(eig[lev, k, 0]), float(eig[lev, k, 1])
                eccen = 0.0 if (small or l1 <= 0) else \
                    math.sqrt(max(l1 * l1 - l0 * l0, 0.0)) / l1
                com_feat = (not small) and \
                    float(com_r[lev, k]) > cfg.view_stat.com_bias_thres
                # com = mean + com_r * unit; the exact com vector is not kept
                # in ScanDesc — reconstruct along the major axis is wrong, so
                # dump mean + (com_r, 0) which preserves |com - mean| (the
                # quantity every downstream consumer uses).
                comx = float(mean[lev, k, 0]) + float(com_r[lev, k])
                comy = float(mean[lev, k, 1])
                row = [
                    lev, int(cnt[lev, k]),
                    float(mean[lev, k, 0]), float(mean[lev, k, 1]),
                    float(cov[lev, k, 0, 0]), float(cov[lev, k, 1, 0]),
                    float(cov[lev, k, 0, 1]), float(cov[lev, k, 1, 1]),
                    l0, l1,
                    float(vecs[lev, k, 0, 0]), float(vecs[lev, k, 1, 0]),
                    float(vecs[lev, k, 0, 1]), float(vecs[lev, k, 1, 1]),
                    eccen, float(vol3[lev, k]), comx, comy,
                    int(bool(ecc_feat[lev, k])), int(com_feat),
                ]
                f.write("\t".join(str(v) for v in row) + "\t\n")
        f.write("DATA_END\n")


def load_contours(fpath: str) -> np.ndarray:
    """Parse a 20-column dump (ours or the reference's) -> (N, 20) float."""
    rows = []
    armed = False
    with open(fpath) as f:
        for line in f:
            s = line.strip()
            if s == "DATA_START":
                armed = True
                continue
            if s == "DATA_END":
                break
            if not armed or not s:
                continue
            rows.append([float(x) for x in s.split()])
    return np.asarray(rows) if rows else np.zeros((0, 20))


def save_bev_image(fpath: str, bev: np.ndarray,
                   v_min: float = -1.0, v_max: float = 5.0) -> None:
    """BEV max-height image dump (SAVE_MID_FILE, contour_mng.h:547-555).

    PNG via matplotlib when importable, else a binary .pgm written next to
    the requested path.
    """
    bev = np.asarray(bev, np.float32)
    img = np.clip((bev - v_min) / max(v_max - v_min, 1e-6), 0.0, 1.0)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(fpath, img, cmap="viridis")
    except Exception:
        pgm = fpath.rsplit(".", 1)[0] + ".pgm"
        data = (img * 255).astype(np.uint8)
        with open(pgm, "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (data.shape[1], data.shape[0]))
            f.write(data.tobytes())
