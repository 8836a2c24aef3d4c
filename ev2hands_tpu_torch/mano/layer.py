"""MANO hand layer in PyTorch.

Counterpart of ``ev2hands_tpu/mano/layer.py``: PCA pose space (6
components, non-flat mean), shape and pose-corrective blend shapes, linear
blend skinning, 16 joints + 5 fingertip vertices in the 21-joint layout, in
meters. The batch dimension is written out where the JAX package used
``vmap``. Differentiable end to end: every tensor is built out of place.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ev2hands_tpu_torch.mano.model_data import (
    JOINT_REORDER,
    KINTREE_PARENTS,
    ManoModelData,
)


class ManoParams(NamedTuple):
    """Constants of one MANO hand, as tensors on one device."""

    v_template: torch.Tensor    # [V, 3]
    shapedirs: torch.Tensor     # [V, 3, 10]
    posedirs: torch.Tensor      # [V*3, 135]
    J_regressor: torch.Tensor   # [16, V]
    lbs_weights: torch.Tensor   # [V, 16]
    pose_basis: torch.Tensor    # [ncomps, 45]
    hands_mean: torch.Tensor    # [45]
    tip_ids: torch.Tensor       # [5] int64
    faces: torch.Tensor         # [F, 3] int64
    parent_ids: torch.Tensor    # [15] int64: the parents of joints 1..15
    joint_reorder: torch.Tensor  # [21] int64: 16 joints + 5 tips -> 21-joint order


class ManoOutput(NamedTuple):
    vertices: torch.Tensor  # [..., 778, 3] meters
    joints: torch.Tensor    # [..., 21, 3] meters


def create_mano_params(data: ManoModelData, n_pose_comps: int = 6,
                       device="cuda") -> ManoParams:
    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return ManoParams(
        v_template=t(data.v_template),
        shapedirs=t(data.shapedirs),
        posedirs=t(data.posedirs.reshape(-1, data.posedirs.shape[-1])),
        J_regressor=t(data.J_regressor),
        lbs_weights=t(data.lbs_weights),
        pose_basis=t(data.hands_components[:n_pose_comps]),
        hands_mean=t(data.hands_mean),
        tip_ids=t(data.tip_vertex_ids, torch.long),
        faces=t(data.faces, torch.long),
        parent_ids=t(KINTREE_PARENTS[1:], torch.long),
        joint_reorder=t(JOINT_REORDER, torch.long),
    )


def rodrigues(rotvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3], through the
    quaternion form (smooth at the origin)."""
    angle = torch.sqrt(torch.sum(rotvec ** 2, dim=-1, keepdim=True) + 1e-16)
    half = angle * 0.5
    axis = rotvec / angle
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    return quat_to_rotmat(quat)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) quaternion -> [..., 3, 3]."""
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    r = torch.stack(
        [
            w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (w * y + x * z),
            2 * (w * z + x * y), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (w * x + y * z), w * w - x * x - y * y + z * z,
        ],
        dim=-1,
    )
    return r.reshape(*quat.shape[:-1], 3, 3)


def _rigid_transform_chain(
    rot_mats: torch.Tensor, joints: torch.Tensor, parent_ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics along the MANO tree.

    rot_mats [B, 16, 3, 3] local rotations (root first), joints [B, 16, 3]
    rest joints, parent_ids [15] the parents of joints 1..15 (on the
    joints' device: an exported program keeps it there as a constant) ->
    (posed joints [B, 16, 3], skinning transforms [B, 16, 4, 4] with the
    rest pose removed)."""
    B = rot_mats.shape[0]
    parents = KINTREE_PARENTS
    rel_pos = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parent_ids]],
                        dim=1)
    # built out of place, so autograd sees no write into a saved tensor
    bottom = rot_mats.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, 16, 1, 4)
    T = torch.cat([torch.cat([rot_mats, rel_pos[..., None]], dim=-1), bottom],
                  dim=-2)
    transforms = [T[:, 0]]
    for k in range(1, len(parents)):
        transforms.append(transforms[parents[k]] @ T[:, k])
    G = torch.stack(transforms, dim=1)  # [B, 16, 4, 4]

    posed_joints = G[:, :, :3, 3]
    correction = torch.einsum("bkij,bkj->bki", G[:, :, :3, :3], joints)
    top = torch.cat([G[:, :, :3, :3], (posed_joints - correction)[..., None]],
                    dim=-1)
    return posed_joints, torch.cat([top, G[:, :, 3:]], dim=-2)


def mano_forward(
    params: ManoParams,
    global_orient: torch.Tensor,  # [..., 3] axis-angle root rotation
    hand_pose: torch.Tensor,      # [..., ncomps] PCA pose coefficients
    betas: torch.Tensor,          # [..., 10]
    transl: torch.Tensor,         # [..., 3] meters
) -> ManoOutput:
    """MANO forward over any leading batch dims."""
    batch_shape = global_orient.shape[:-1]
    go = global_orient.reshape(-1, 3)
    hp = hand_pose.reshape(-1, hand_pose.shape[-1])
    be = betas.reshape(-1, betas.shape[-1])
    tr = transl.reshape(-1, 3)
    B = go.shape[0]
    V = params.v_template.shape[0]

    full_finger_pose = params.hands_mean + hp @ params.pose_basis  # [B, 45]
    pose = torch.cat([go, full_finger_pose], dim=-1).reshape(B, 16, 3)
    rot_mats = rodrigues(pose)  # [B, 16, 3, 3]

    v_shaped = params.v_template + torch.einsum("vcs,bs->bvc", params.shapedirs, be)
    joints_rest = torch.einsum("jv,bvc->bjc", params.J_regressor, v_shaped)

    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)  # [B, 135]
    v_posed = v_shaped + (pose_feature @ params.posedirs.t()).reshape(B, V, 3)

    joints, rel_transforms = _rigid_transform_chain(rot_mats, joints_rest,
                                                    params.parent_ids)

    T = torch.einsum("vk,bkij->bvij", params.lbs_weights, rel_transforms)
    v_hom = torch.cat([v_posed, v_posed.new_ones(B, V, 1)], dim=-1)
    verts = torch.einsum("bvij,bvj->bvi", T, v_hom)[..., :3]

    tips = verts[:, params.tip_ids]
    joints21 = torch.cat([joints, tips], dim=1)[:, params.joint_reorder]

    verts = verts + tr[:, None]
    joints21 = joints21 + tr[:, None]
    return ManoOutput(
        vertices=verts.reshape(*batch_shape, V, 3),
        joints=joints21.reshape(*batch_shape, 21, 3),
    )
