"""The training losses, in PyTorch.

Counterpart of ``ev2hands_tpu/losses.py``: ``mano_losses`` (the loss dict
of the reference's synthetic-data branch) and ``real_losses`` (finetuning
on real recordings), with the same keys, reductions and weights. Masked
reductions average over the elements of the valid samples and give 0 when
no sample is valid. The synthetic regulariser keeps the reference's
effective weight 0 by default.

Under a data mesh (``mesh``, ``parallel/mesh.py``) each rank holds its rows
of the global batch, and every reduction divides this rank's sum by the
global batch's denominator (the count of valid elements, the class weights'
sum, the positive penetrations), all-reduced over the data ranks without a
gradient. Each rank's loss is then its share of the global loss: the
shares sum to the one-device loss, and the gradients over the ranks sum to
its gradient. One rank gives the bits of no mesh.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import torch

from ev2hands_tpu_torch.camera import opengl_projection_transform
from ev2hands_tpu_torch.config import LossConfig
from ev2hands_tpu_torch.mano.layer import ManoParams, mano_forward
from ev2hands_tpu_torch.ops.collision import collision_loss
from ev2hands_tpu_torch.parallel.mesh import DATA_AXIS, all_sum


def masked_mean(elem_loss: torch.Tensor, valid: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """Mean over all elements of the samples where ``valid`` ([B]); 0 when
    none is valid. Under a data mesh, this rank's share of the global
    batch's mean."""
    B = elem_loss.shape[0]
    flat = elem_loss.reshape(B, -1)
    v = valid.reshape(B, 1).to(flat.dtype)
    denom = all_sum(v.sum() * flat.shape[1], mesh, DATA_AXIS)
    return torch.where(denom > 0, (flat * v).sum() / torch.clamp(denom, min=1.0),
                       0.0)


def mse(a, b):
    return (a - b) ** 2


def l1(a, b):
    return torch.abs(a - b)


def weighted_cross_entropy(
    logits: torch.Tensor,         # [B, N, C]
    targets: torch.Tensor,        # [B, N] int
    class_weights: torch.Tensor,  # [C]
    ignore_index: int = 0,
    mesh=None,
) -> torch.Tensor:
    """torch ``F.cross_entropy(weight=..., ignore_index=...)``:
    sum(w[y] * nll) / sum(w[y]) over the targets that are not ignored (under
    a data mesh, sum(w[y]) over the global batch)."""
    targets = targets.long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    w = class_weights.to(logits.dtype)[targets] * (targets != ignore_index)
    denom = all_sum(w.sum(), mesh, DATA_AXIS)
    return torch.where(denom > 0, (w * nll).sum() / torch.clamp(denom, min=1.0),
                       0.0)


class CollisionContext(NamedTuple):
    """Fixed mesh topology of the collision loss."""

    faces: torch.Tensor      # [2F, 3] int64 two-hand faces
    adjacency: torch.Tensor  # [2F, 2F] bool


def _interpen(outputs, ctx: CollisionContext, cfg: LossConfig, mesh) -> torch.Tensor:
    return collision_loss(
        outputs["left"]["vertices"], outputs["right"]["vertices"],
        ctx.faces, ctx.adjacency, max_pairs=cfg.collision_max_pairs,
        sigma=cfg.collision_sigma, weight=cfg.collision_weight, mesh=mesh)


def global_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``torch.mean(x)``; under a data mesh this rank's share of the global
    batch's mean (its sum over the global element count)."""
    if mesh is None or mesh.data_group is None:
        return torch.mean(x)
    return x.sum() / (x.numel() * mesh.data_size)


def recompute_gt_joints(hands: Dict[str, ManoParams], targets: Dict) -> Dict:
    """GT joints and vertices from the GT MANO parameters; PCA components
    beyond the layer's are ignored."""
    out = dict(targets)
    for side in ("left", "right"):
        t = targets[side]
        res = mano_forward(
            hands[side], t["global_orient"],
            t["hand_pose"][..., :hands[side].pose_basis.shape[0]],
            t["shape"], t["trans"])
        out[side] = dict(t, j3d=res.joints, vertices=res.vertices)
    return out


def mano_losses(
    outputs: Dict,
    targets: Dict,
    hands: Dict[str, ManoParams],
    ctx: CollisionContext,
    cfg: LossConfig = LossConfig(),
    n_pose_comps: int = 6,
    reg_weight: float = 0.0,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """The synthetic-data loss dict. ``outputs`` is the TEHNet + MANO
    forward result; ``targets`` the batch dict (per hand global_orient,
    hand_pose, shape, trans, valid; handedness [B, 2]; class_logits, the
    per-event labels). Under a data mesh, this rank's shares."""
    losses: Dict[str, torch.Tensor] = {}
    targets = recompute_gt_joints(hands, targets)

    mean = functools.partial(masked_mean, mesh=mesh)

    losses["loss_interpen"] = _interpen(outputs, ctx, cfg, mesh)

    interacting = targets["handedness"].sum(dim=1) == 2

    losses["loss_inter_shape"] = mean(
        mse(outputs["left"]["betas"], outputs["right"]["betas"]), interacting)
    losses["loss_inter_transl"] = mean(
        mse(outputs["left"]["transl"] - outputs["right"]["transl"],
            targets["left"]["trans"] - targets["right"]["trans"]),
        interacting) * 100.0
    losses["loss_inter_j3d"] = mean(
        mse(outputs["left"]["j3d"] - outputs["right"]["j3d"],
            targets["left"]["j3d"] - targets["right"]["j3d"]),
        interacting) * 100.0

    for k in ("loss_global_orient", "loss_hand_pose", "loss_rj3d", "loss_j3d",
              "loss_shape", "loss_transl", "regularizer_loss"):
        losses.setdefault(k, 0.0)

    for side in ("left", "right"):
        o, t = outputs[side], targets[side]
        valid = t["valid"]
        losses["loss_global_orient"] += mean(
            mse(o["global_orient"], t["global_orient"]), valid) * 10.0
        gt_pose = t["hand_pose"][..., :n_pose_comps]
        losses["loss_hand_pose"] += mean(mse(o["hand_pose"], gt_pose),
                                                valid) * 10.0
        rj_o = (o["j3d"][:, 1:, :] - o["j3d"][:, :1, :]) * 1000.0
        rj_t = (t["j3d"][:, 1:, :] - t["j3d"][:, :1, :]) * 1000.0
        losses["loss_rj3d"] += mean(l1(rj_o, rj_t), valid) * 0.01
        losses["loss_j3d"] += mean(
            l1(o["j3d"] * 1000.0, t["j3d"] * 1000.0), valid) * 0.01
        losses["loss_shape"] += mean(mse(o["betas"], t["shape"]), valid) * 10.0
        losses["loss_transl"] += mean(l1(o["transl"], t["trans"]), valid) * 10.0
        # the reference's regulariser is mse(x, x) == 0; reg_weight 0 keeps it
        losses["regularizer_loss"] += reg_weight * (
            0.1 * mean(o["betas"] ** 2, valid)
            + mean(o["hand_pose"] ** 2, valid))

    losses["loss_class_logits"] = weighted_cross_entropy(
        outputs["class_logits"], targets["class_logits"],
        torch.as_tensor(cfg.ce_class_weights, device=outputs["class_logits"].device),
        cfg.ce_ignore_index, mesh)
    return losses


def real_losses(
    outputs: Dict,
    targets: Dict,
    ctx: CollisionContext,
    projection_matrix: torch.Tensor,
    width: int,
    height: int,
    cfg: LossConfig = LossConfig(),
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """The real-data loss dict: no MANO ground truth; root-relative joints,
    the 2-D reprojection of the joints through ``projection_matrix``
    ([4, 4]), inter-hand consistency and the collision term. ``targets``
    carries per hand 'j3d' [B, 21, 3] (m), 'j2d' [B, 21, >= 2] (pixels) and
    'valid' [B], and 'handedness' [B, 2]. Under a data mesh, this rank's
    shares."""
    losses: Dict[str, torch.Tensor] = {}

    mean = functools.partial(masked_mean, mesh=mesh)

    losses["loss_interpen"] = _interpen(outputs, ctx, cfg, mesh)
    interacting = targets["handedness"].sum(dim=1) == 2
    losses["loss_inter_shape"] = mean(
        mse(outputs["left"]["betas"], outputs["right"]["betas"]), interacting) * 1e3
    losses["loss_inter_j3d"] = mean(
        l1((outputs["left"]["j3d"] - outputs["right"]["j3d"]) * 1000.0,
           (targets["left"]["j3d"] - targets["right"]["j3d"]) * 1000.0),
        interacting)
    losses["loss_rj3d"] = 0.0
    losses["loss_j2d"] = 0.0
    reg = 0.0
    for side in ("left", "right"):
        o, t = outputs[side], targets[side]
        valid = t["valid"]
        # the reference's quirk: the running regulariser is scaled by 0.025
        # inside the loop, so the left hand's share is scaled twice
        reg = (reg + global_mean(o["betas"] ** 2, mesh) * 1e3
               + global_mean(o["hand_pose"] ** 2, mesh)) * 0.025
        rj_o = (o["j3d"][:, 1:, :] - o["j3d"][:, :1, :]) * 1000.0
        rj_t = (t["j3d"][:, 1:, :] - t["j3d"][:, :1, :]) * 1000.0
        losses["loss_rj3d"] += mean(l1(rj_o, rj_t), valid) * 10.0
        j2d = opengl_projection_transform(projection_matrix, width, height,
                                          o["j3d"] * 1000.0)
        losses["loss_j2d"] += mean(mse(j2d, t["j2d"][..., :2]), valid)
    losses["regularizer_loss"] = reg
    return losses


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sum of every loss term."""
    return sum(losses.values())
