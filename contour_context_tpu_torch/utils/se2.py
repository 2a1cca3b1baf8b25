"""Small SE(2)/SE(3) host helpers (numpy, float64) for the evaluation.

The port's own copy of what it uses of `contour_context_tpu/utils/se2.py`.
"""

from __future__ import annotations

import math

import numpy as np


def se2_mat(x: float, y: float, theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s, x], [s, c, y], [0.0, 0.0, 1.0]])


def se2_inv(T: np.ndarray) -> np.ndarray:
    R = T[:2, :2]
    out = np.eye(3)
    out[:2, :2] = R.T
    out[:2, 2] = -R.T @ T[:2, 2]
    return out


def bev_T_delta_to_sensor(T_delta: np.ndarray, n_row: int, n_col: int,
                          reso_row: float, reso_col: float = None) -> np.ndarray:
    """BEV-origin-frame delta -> sensor-frame delta (getEstSensTF, correlation.h:287-296).

    T_so_ssen translates by (n_row/2-0.5, n_col/2-0.5); the result's
    translation is scaled per axis by the grid resolutions.
    """
    if reso_col is None:
        reso_col = reso_row
    T_so_ssen = se2_mat(n_row / 2 - 0.5, n_col / 2 - 0.5, 0.0)
    out = se2_inv(T_so_ssen) @ T_delta @ T_so_ssen
    out[0, 2] *= reso_row
    out[1, 2] *= reso_col
    return out


def eval_metric_est(T_delta: np.ndarray, gt_src_3d: np.ndarray, gt_tgt_3d: np.ndarray,
                    n_row: int, n_col: int, reso_row: float,
                    reso_col: float = None) -> np.ndarray:
    """SE(2) error of an estimated BEV delta vs 3-D gt poses (evalMetricEst,
    correlation.h:241-280).  Returns T_gt^-1 @ T_est as a 3x3 SE(2) matrix.

    The gt 3-D relative pose is flattened to 2-D by rotating so the two z axes
    align, then taking the xy translation and yaw.
    """
    T_est_sens = bev_T_delta_to_sensor(T_delta, n_row, n_col, reso_row,
                                       reso_col)

    T_rel = np.linalg.inv(gt_tgt_3d) @ gt_src_3d
    z0 = np.array([0.0, 0.0, 1.0])
    z1 = T_rel[:3, 2]
    cross = np.cross(z0, z1)
    nrm = np.linalg.norm(cross)
    if nrm < 1e-12:
        R_rect = T_rel[:3, :3]
    else:
        ax = cross / nrm
        ang = math.acos(min(1.0, max(-1.0, z0 @ z1)))
        K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
        d_rot = np.eye(3) + math.sin(-ang) * K + (1 - math.cos(-ang)) * (K @ K)
        R_rect = d_rot @ T_rel[:3, :3]

    T_gt_2d = se2_mat(T_rel[0, 3], T_rel[1, 3], math.atan2(R_rect[1, 0], R_rect[0, 0]))
    return se2_inv(T_gt_2d) @ T_est_sens
