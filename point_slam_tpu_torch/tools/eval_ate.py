"""Absolute trajectory error (ATE) with Horn closed-form SE(3) alignment.

A copy of the library part of ``point_slam_tpu.tools.eval_ate``: zero-centre
both trajectories, SVD of the correlation with a det-correction reflection
guard, then RMSE/mean/median/std/min/max of the translational residuals.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray):
    """Least-squares rigid alignment model -> data. Inputs (3, n).

    Returns (rot (3,3), trans (3,1), trans_error (n,)).
    """
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    w = (model - model_mean) @ (data - data_mean).T
    u, _, vh = np.linalg.svd(w.T)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vh) < 0:
        s[2, 2] = -1
    rot = u @ s @ vh
    trans = data_mean - rot @ model_mean
    aligned = rot @ model + trans
    err = np.sqrt(np.sum((aligned - data) ** 2, axis=0))
    return rot, trans, err


def pose_translations(c2w_list: np.ndarray) -> np.ndarray:
    return np.asarray(c2w_list)[:, :3, 3].T  # (3, n)


def evaluate_ate(gt_c2w_list, est_c2w_list, align: bool = True
                 ) -> Dict[str, float]:
    gt = np.asarray(gt_c2w_list, np.float64)
    est = np.asarray(est_c2w_list, np.float64)
    ok = np.isfinite(gt.reshape(len(gt), -1)).all(1) & \
        np.isfinite(est.reshape(len(est), -1)).all(1)
    model = pose_translations(est[ok])
    data = pose_translations(gt[ok])
    if align:
        _, _, err = horn_align(model, data)
    else:
        err = np.sqrt(np.sum((model - data) ** 2, axis=0))
    return {
        "compared_pose_pairs": int(ok.sum()),
        "absolute_translational_error.rmse": float(np.sqrt(np.mean(err ** 2))),
        "absolute_translational_error.mean": float(np.mean(err)),
        "absolute_translational_error.median": float(np.median(err)),
        "absolute_translational_error.std": float(np.std(err)),
        "absolute_translational_error.min": float(np.min(err)),
        "absolute_translational_error.max": float(np.max(err)),
    }
