"""Evaluation metrics: 3-D PCK curves, AUC, MPJPE, MPVPE.

Counterpart of ``ev2hands_tpu/metrics.py``, on tensors of any device, batched
over the leading axes. Conventions (the reference's):

* joints arrive as [..., 2, 21, 3] (left, right) in millimeters;
* PCK counts strict ``dist < threshold`` over ``num_steps + 1`` thresholds
  spaced linearly on [0, dist_max_mm], averaged over the 42 joints;
* AUC is the trapezoidal area of the PCK curve over its index range divided
  by the number of points, rounded to 2 decimals (``get_auc``, numpy);
* "relative" subtracts each hand's root joint; "right-root-relative"
  subtracts the right hand's root from both hands.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _pck_from_dists(dists: torch.Tensor, num_steps: int,
                    dist_max_mm: float) -> torch.Tensor:
    """dists [..., J] -> pck [..., num_steps + 1], the mean over joints."""
    thresholds = torch.linspace(0.0, dist_max_mm, num_steps + 1,
                                dtype=dists.dtype, device=dists.device)
    hit = (dists[..., None] < thresholds).to(dists.dtype)
    return hit.mean(dim=-2)


def _joint_dists(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """[..., 2, 21, 3] pairs -> [..., 42] distances, both hands stacked."""
    d = torch.linalg.vector_norm(pred - gt, dim=-1)
    return d.reshape(*d.shape[:-2], -1)


def absolute_pck3d(pred, gt, num_steps=50, dist_max_mm=50.0) -> torch.Tensor:
    return _pck_from_dists(_joint_dists(pred, gt), num_steps, dist_max_mm)


def relative_pck3d(pred, gt, num_steps=50, dist_max_mm=50.0) -> torch.Tensor:
    """Root-relative per hand."""
    p = pred - pred[..., :, :1, :]
    g = gt - gt[..., :, :1, :]
    return _pck_from_dists(_joint_dists(p, g), num_steps, dist_max_mm)


def right_root_relative_pck3d(pred, gt, num_steps=50,
                              dist_max_mm=50.0) -> torch.Tensor:
    """Both hands relative to the right hand's root."""
    p = pred - pred[..., 1:, :1, :]
    g = gt - gt[..., 1:, :1, :]
    return _pck_from_dists(_joint_dists(p, g), num_steps, dist_max_mm)


def mpjpe(pred, gt) -> torch.Tensor:
    """Root-relative mean per-joint position error, in the input unit."""
    p = pred - pred[..., :, :1, :]
    g = gt - gt[..., :, :1, :]
    return torch.linalg.vector_norm(p - g, dim=-1).mean(dim=(-2, -1))


def mpvpe(pred_verts, gt_verts) -> torch.Tensor:
    """Mean per-vertex position error over both hands, [..., 2, V, 3]."""
    return torch.linalg.vector_norm(pred_verts - gt_verts, dim=-1).mean(dim=(-2, -1))


def get_auc(pck) -> float:
    """Normalised trapezoidal AUC of a PCK curve, rounded to 2 decimals."""
    pck = np.asarray(pck)
    n = pck.shape[-1]
    return round(float(np.trapezoid(pck, np.arange(n)) / n), 2)


class PckAccumulator:
    """Sums the three PCK curves over batches of (pred, gt) joints [B, 2, 21,
    3] in mm, and counts the frames."""

    def __init__(self, num_steps: int = 50, dist_max_mm: float = 50.0):
        self.num_steps = num_steps
        self.dist_max_mm = dist_max_mm
        self.absolute = np.zeros(num_steps + 1)
        self.relative = np.zeros(num_steps + 1)
        self.right_root_relative = np.zeros(num_steps + 1)
        self.frames = 0

    def update(self, pred_mm: torch.Tensor, gt_mm: torch.Tensor) -> None:
        kw = dict(num_steps=self.num_steps, dist_max_mm=self.dist_max_mm)
        sums = torch.stack([
            f(pred_mm, gt_mm, **kw).sum(dim=0)
            for f in (absolute_pck3d, relative_pck3d, right_root_relative_pck3d)
        ]).cpu().numpy()
        self.absolute += sums[0]
        self.relative += sums[1]
        self.right_root_relative += sums[2]
        self.frames += pred_mm.shape[0]

    def result(self) -> Tuple[Dict, float]:
        """({'pck3d': curves, 'auc': AUCs}, the eval score = relative AUC)."""
        f = max(self.frames, 1)
        curves = {
            "absolute": self.absolute / f,
            "relative": self.relative / f,
            "right_root_relative": self.right_root_relative / f,
        }
        aucs = {k: get_auc(v) for k, v in curves.items()}
        return {"pck3d": curves, "auc": aucs}, aucs["relative"]
