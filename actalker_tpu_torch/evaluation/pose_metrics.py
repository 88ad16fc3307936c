"""Head-pose / motion evaluation, twin of
``actalker_tpu/evaluation/pose_metrics.py`` (reference: ``eval/eval_pm.py``).

The reference's pose-metric tree depends on packages absent from its repo
(``modules.*``, ``motion_diffusion`` — ``eval/eval_pm.py:15-26``; SURVEY
§2.9 flags it broken/external).  What it *measures* is how well generated
head motion tracks the driving signal using the VASA pose tower
(``HeadPose_train``, ``src/dataset/vasa_feature_v2.py:9-22``).  This module
provides that measurement with the port's ``models/vasa.HeadPose``
(``pose_apply``, ``expr_apply``: callables over numpy batches, e.g.
``tower_apply(HeadPose on its device)``):

  * ``pose_trajectory``   — per-frame 3-d rotation (deg) + 3-d translation;
  * ``pose_metrics``      — trajectory comparison between generated and
    driving clips: rotation RMSE (deg), translation RMSE, per-axis Pearson
    correlation, and motion *dynamics* correlation (frame-to-frame deltas),
    the standard talking-head pose-fidelity measures;
  * ``expression_distance`` — mean L2 between VASA expression codes
    (``HeadExpression``, ``vasa_feature_v2.py:107-121``) of two clips.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def tower_apply(net: torch.nn.Module):
    """A numpy-in, numpy-out callable over ``net`` (``HeadPose`` /
    ``HeadExpression``, NHWC input) on its device."""
    dev = next(net.parameters()).device

    @torch.no_grad()
    def apply(x: np.ndarray):
        out = net(torch.from_numpy(np.asarray(x, np.float32)).to(dev))
        if isinstance(out, dict):
            return {k: v.float().cpu().numpy() for k, v in out.items()}
        return out.float().cpu().numpy()

    return apply


def _batched(fn, x: np.ndarray, batch: int):
    outs = [fn(x[i:i + batch]) for i in range(0, len(x), batch)]
    if not outs:
        raise ValueError("empty clip: no frames to evaluate")
    if isinstance(outs[0], dict):
        return {k: np.concatenate([np.asarray(o[k]) for o in outs])
                for k in outs[0]}
    return np.concatenate([np.asarray(o) for o in outs])


def pose_trajectory(frames: np.ndarray, pose_apply, batch: int = 8) -> Dict:
    """frames: (F, 256, 256, 3) float in [0, 1] (face/pose crops).

    ``pose_apply`` maps a (B, 256, 256, 3) batch in [-1, 1] (the reference
    feeds ``tensor * 2 - 1``, ``eval_pm.py:109``) to {'rotation',
    'translation'}. Returns {'rotation': (F, 3) deg, 'translation': (F,
    3)}.
    """
    x = np.asarray(frames, np.float32) * 2.0 - 1.0
    return _batched(pose_apply, x, batch)


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    if denom < 1e-8:
        return 0.0
    return float((a * b).sum() / denom)


def pose_metrics(gen_traj: Dict, drv_traj: Dict) -> Dict[str, float]:
    """Compare generated vs driving pose trajectories (truncated to the
    shorter clip). Rotation in degrees; correlations averaged over the
    three rotation axes."""
    n = min(len(gen_traj["rotation"]), len(drv_traj["rotation"]))
    gr = np.asarray(gen_traj["rotation"][:n], np.float64)
    dr = np.asarray(drv_traj["rotation"][:n], np.float64)
    gt = np.asarray(gen_traj["translation"][:n], np.float64)
    dt = np.asarray(drv_traj["translation"][:n], np.float64)
    out = {
        "rotation_rmse_deg": float(np.sqrt(np.mean((gr - dr) ** 2))),
        "translation_rmse": float(np.sqrt(np.mean((gt - dt) ** 2))),
        "rotation_corr": float(np.mean(
            [_pearson(gr[:, i], dr[:, i]) for i in range(3)])),
    }
    if n >= 3:  # frame-to-frame dynamics (motion, not absolute pose)
        gd, dd = np.diff(gr, axis=0), np.diff(dr, axis=0)
        out["motion_corr"] = float(np.mean(
            [_pearson(gd[:, i], dd[:, i]) for i in range(3)]))
        out["motion_intensity_ratio"] = float(
            (np.abs(gd).mean() + 1e-8) / (np.abs(dd).mean() + 1e-8))
    return out


def expression_distance(gen_faces: np.ndarray, drv_faces: np.ndarray,
                        expr_apply, batch: int = 8) -> float:
    """Mean per-frame L2 between VASA expression codes of two aligned
    face-crop clips ((F, 256, 256, 3) in [0, 1]; the expression tower takes
    [0, 1] inputs, ``vasa_feature_v2.py:162-213``)."""
    n = min(len(gen_faces), len(drv_faces))
    ge = _batched(expr_apply, np.asarray(gen_faces[:n], np.float32), batch)
    de = _batched(expr_apply, np.asarray(drv_faces[:n], np.float32), batch)
    return float(np.mean(np.linalg.norm(ge - de, axis=-1)))


def evaluate_pose(gen_crops: np.ndarray, drv_crops: np.ndarray, pose_apply,
                  expr_apply=None, gen_faces: Optional[np.ndarray] = None,
                  drv_faces: Optional[np.ndarray] = None) -> Dict[str, float]:
    """One-call driver: pose trajectories + metrics (+ expression distance
    when the expression tower and face crops are supplied)."""
    m = pose_metrics(pose_trajectory(gen_crops, pose_apply),
                     pose_trajectory(drv_crops, pose_apply))
    if expr_apply is not None and gen_faces is not None \
            and drv_faces is not None:
        m["expression_l2"] = expression_distance(gen_faces, drv_faces,
                                                 expr_apply)
    return m
