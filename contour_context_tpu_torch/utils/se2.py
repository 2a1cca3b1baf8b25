"""Small SE(2)/SE(3) host helpers (numpy, float64).

The port's own copy of `contour_context_tpu/utils/se2.py`.

The pipeline's heavy math runs on device; these are for host-side bookkeeping
(evaluation, proposal clustering) where exactness matters more than speed.
"""

from __future__ import annotations

import math

import numpy as np


def se2_mat(x: float, y: float, theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s, x], [s, c, y], [0.0, 0.0, 1.0]])


def se2_params(T: np.ndarray):
    return float(T[0, 2]), float(T[1, 2]), math.atan2(T[1, 0], T[0, 0])


def se2_inv(T: np.ndarray) -> np.ndarray:
    R = T[:2, :2]
    out = np.eye(3)
    out[:2, :2] = R.T
    out[:2, 2] = -R.T @ T[:2, 2]
    return out


def clamp_ang(ang: float) -> float:
    """Wrap to [-pi, pi) (algos.h:48-51)."""
    return ang - math.floor((ang + math.pi) / (2 * math.pi)) * 2 * math.pi


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


def estimate_tf_2pt(s1, s2, t1, t2) -> np.ndarray:
    """Closed-form SE(2) from two point correspondences (algos.h:29-43).

    Rotation aligns the segment s1->s2 with t1->t2; translation places the
    segment midpoints onto each other. Used by the reference's legacy
    (non-umeyama) path; provided for completeness."""
    s1, s2, t1, t2 = (np.asarray(v, np.float64) for v in (s1, s2, t1, t2))
    vs = s2 - s1
    vt = t2 - t1
    ang = math.atan2(vs[0] * vt[1] - vs[1] * vt[0], float(vs @ vt))
    T = se2_mat(0.0, 0.0, ang)
    T[:2, 2] = 0.5 * (t1 + t2 - T[:2, :2] @ (s1 + s2))
    return T


def umeyama_2d(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """Rigid (no-scale) 2-D umeyama: T with tgt ~= T @ src (contour_mng.h:1267).

    Closed-form Kabsch on 2x2; numpy float64 host version (the device twin is
    the atan2 closed form inline in ops/cascade.run_cascade).
    """
    mu_s = src.mean(axis=0)
    mu_t = tgt.mean(axis=0)
    H = (tgt - mu_t).T @ (src - mu_s)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ Vt))
    S = np.diag([1.0, d])
    R = U @ S @ Vt
    t = mu_t - R @ mu_s
    out = np.eye(3)
    out[:2, :2] = R
    out[:2, 2] = t
    return out
