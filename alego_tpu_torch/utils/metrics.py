"""Trajectory accuracy metrics (ATE / RPE).

The reference publishes no numeric accuracy — trajectories were judged from
rviz screenshots (README.md:9-12).  BASELINE.json makes "ATE parity" the
acceptance metric, so the evaluation lives here as a first-class utility.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment est -> gt.

    est, gt: [N, 3] translations. Returns (R, t, s)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (D * S.diagonal()).sum() / (xe ** 2).sum() * len(est) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE (metres) after optional rigid alignment."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    if align:
        R, t, s = umeyama_alignment(est, gt)
        est = est @ R.T * s + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(-1).mean()))


def rpe_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> float:
    """Relative pose error over ``delta``-frame windows (translation RMSE)."""
    def rel(poses):
        a = poses[:-delta]
        b = poses[delta:]
        return np.linalg.inv(a) @ b

    e = rel(np.asarray(est_poses, np.float64))
    g = rel(np.asarray(gt_poses, np.float64))
    d = np.linalg.inv(g) @ e
    return float(np.sqrt((d[:, :3, 3] ** 2).sum(-1).mean()))
