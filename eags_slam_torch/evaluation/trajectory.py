"""Trajectory evaluation: ATE with Horn alignment and RPE (port of
eags_slam_tpu.evaluation.trajectory; pure numpy on the host)."""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray):
    """Least-squares rigid alignment model->data, both (3, N).

    Returns (R, t, trans_error per point)."""
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    W = (model - model_mean) @ (data - data_mean).T
    U, _, Vt = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = data_mean - R @ model_mean
    aligned = R @ model + t
    err = np.sqrt(np.sum((aligned - data) ** 2, axis=0))
    return R, t, err


def ate_stats(trans_error: np.ndarray) -> Dict[str, float]:
    return {
        "rmse": float(np.sqrt(np.mean(trans_error**2))),
        "mean": float(np.mean(trans_error)),
        "median": float(np.median(trans_error)),
        "std": float(np.std(trans_error)),
        "min": float(np.min(trans_error)),
        "max": float(np.max(trans_error)),
    }


def evaluate_rpe(
    estimated_c2ws: np.ndarray, gt_c2ws: np.ndarray, delta: int = 1
) -> Dict[str, float]:
    """Relative pose error over frame pairs (i, i+delta) — the TUM-benchmark
    RPE metric (reference carries the upstream tool at
    VO/scripts/evaluate_rpe.py). Returns translational RMSE (m/frame) and
    rotational RMSE (deg/frame)."""
    est = np.asarray(estimated_c2ws, np.float64)
    gt = np.asarray(gt_c2ws, np.float64)
    n = min(len(est), len(gt))
    t_errs, r_errs = [], []
    for i in range(n - delta):
        rel_est = np.linalg.inv(est[i]) @ est[i + delta]
        rel_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        err = np.linalg.inv(rel_gt) @ rel_est
        t_errs.append(np.linalg.norm(err[:3, 3]))
        cosang = (np.trace(err[:3, :3]) - 1.0) / 2.0
        r_errs.append(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))))
    t = np.asarray(t_errs)
    r = np.asarray(r_errs)
    return {
        "rpe_trans_rmse": float(np.sqrt(np.mean(t**2))) if t.size else 0.0,
        "rpe_rot_rmse_deg": float(np.sqrt(np.mean(r**2))) if r.size else 0.0,
        "delta": delta,
    }


def evaluate_trajectory(
    estimated_c2ws: np.ndarray,
    gt_c2ws: np.ndarray,
    output_path: Optional[str] = None,
) -> Dict[str, Dict[str, float]]:
    """Raw + Horn-aligned ATE (meters). Writes ate.json / ate_aligned.json
    like the reference (:110-130)."""
    est = np.asarray(estimated_c2ws)[:, :3, 3].T  # (3, N)
    gt = np.asarray(gt_c2ws)[:, :3, 3].T
    raw_err = np.sqrt(np.sum((est - gt) ** 2, axis=0))
    _, _, aligned_err = horn_align(est, gt)
    out = {
        "ate": ate_stats(raw_err),
        "ate_aligned": ate_stats(aligned_err),
        "rpe": evaluate_rpe(estimated_c2ws, gt_c2ws),
    }
    if output_path is not None:
        os.makedirs(output_path, exist_ok=True)
        with open(os.path.join(output_path, "ate.json"), "w") as f:
            json.dump(out["ate"], f, indent=2)
        with open(os.path.join(output_path, "ate_aligned.json"), "w") as f:
            json.dump(out["ate_aligned"], f, indent=2)
    return out
