"""Absolute trajectory error (ATE) with Horn closed-form SE(3) alignment.

A copy of the library part of ``point_slam_tpu.tools.eval_ate``: zero-centre
both trajectories, SVD of the correlation with a det-correction reflection
guard, then RMSE/mean/median/std/min/max of the translational residuals;
and the trajectory plot, which needs matplotlib.
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


def plot_traj(gt_c2w_list, est_c2w_list, path: str) -> bool:
    """Save a top-down (x-y) trajectory comparison plot: ground truth,
    estimate and the per-pose difference segments. Without matplotlib it
    prints that it skipped the plot and returns False."""
    try:
        import matplotlib
    except ImportError:
        print(f"plot_traj: matplotlib is not installed; skipped {path}")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gt = np.asarray(gt_c2w_list, np.float64)
    est = np.asarray(est_c2w_list, np.float64)
    ok = np.isfinite(gt.reshape(len(gt), -1)).all(1) & \
        np.isfinite(est.reshape(len(est), -1)).all(1)
    g = pose_translations(gt[ok])
    e = pose_translations(est[ok])
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(g[0], g[1], "-", color="black", label="ground truth")
    ax.plot(e[0], e[1], "-", color="blue", label="estimated")
    for i in range(g.shape[1]):
        ax.plot([g[0, i], e[0, i]], [g[1, i], e[1, i]],
                "-", color="red", alpha=0.3, linewidth=0.5,
                label="difference" if i == 0 else None)
    ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal", adjustable="datalim")
    fig.savefig(path, dpi=90)
    plt.close(fig)
    return True
