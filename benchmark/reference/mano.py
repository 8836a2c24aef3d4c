"""The MANO hand layer in plain PyTorch, and the hands the benchmark uses.

MANO (Romero et al., SIGGRAPH Asia 2017) with a 6-component PCA pose space
and a non-flat pose mean: shape and pose-corrective blend shapes, linear
blend skinning along the kinematic tree, 16 joints plus 5 fingertip
vertices in the 21-joint order, in meters.

The licensed MANO pickles are not available, so the hands are synthetic
models of MANO's shapes made from a seed (``synthetic_hands``): a
hand-sized blob of 778 vertices around five three-segment fingers, a
softmax joint regressor, distance-based skinning weights and random
blend shapes, the same construction as the port's stand-in models.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

KINTREE_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
TIP_VERTEX_IDS = {"right": (745, 317, 444, 556, 673), "left": (745, 317, 445, 556, 673)}
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)
N_VERTICES, N_FACES, N_JOINTS, N_POSE_FULL, N_POSE_BLEND = 778, 1538, 16, 45, 135


def synthetic_hands(seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """Both hands' MANO arrays (float32, faces int32) from ``seed``; the
    left hand mirrors the right one's template in x."""
    rng = np.random.RandomState(seed % 2 ** 32)
    joints = np.zeros((N_JOINTS, 3), np.float64)
    for fi, root in enumerate([1, 4, 7, 10, 13]):
        direction = np.array([0.02 * (fi - 2), 0.09, 0.002 * fi])
        for s in range(3):
            joints[root + s] = direction * (1.0 + 0.35 * s)
    owner = rng.randint(0, N_JOINTS, size=N_VERTICES)
    v_template = joints[owner] + rng.randn(N_VERTICES, 3) * 0.012
    d2 = ((joints[:, None, :] - v_template[None, :, :]) ** 2).sum(-1)
    logits = -d2 / 1e-4
    J = np.exp(logits - logits.max(axis=1, keepdims=True))
    J /= J.sum(axis=1, keepdims=True)
    w = -d2.T / 2e-3
    lbs = np.exp(w - w.max(axis=1, keepdims=True))
    lbs /= lbs.sum(axis=1, keepdims=True)
    shapedirs = rng.randn(N_VERTICES, 3, 10) * 0.004
    posedirs = rng.randn(N_VERTICES, 3, N_POSE_BLEND) * 0.0015
    q, _ = np.linalg.qr(rng.randn(N_POSE_FULL, N_POSE_FULL))
    hands_mean = rng.randn(N_POSE_FULL) * 0.1
    faces = rng.randint(0, N_VERTICES, size=(N_FACES, 3))
    out = {}
    for side in ("left", "right"):
        vt = v_template.copy()
        vt[:, 0] *= -1.0 if side == "left" else 1.0
        out[side] = {
            "v_template": vt, "shapedirs": shapedirs, "posedirs": posedirs,
            "J_regressor": J, "lbs_weights": lbs, "hands_components": q * 2.0,
            "hands_mean": hands_mean}
        out[side] = {k: v.astype(np.float32) for k, v in out[side].items()}
        out[side]["faces"] = faces.astype(np.int32)
    return out


class Hand(NamedTuple):
    v_template: torch.Tensor   # [V, 3]
    shapedirs: torch.Tensor    # [V, 3, 10]
    posedirs: torch.Tensor     # [V*3, 135]
    J_regressor: torch.Tensor  # [16, V]
    lbs_weights: torch.Tensor  # [V, 16]
    pose_basis: torch.Tensor   # [6, 45]
    hands_mean: torch.Tensor   # [45]
    tip_ids: torch.Tensor      # [5]
    faces: torch.Tensor        # [F, 3]


def hand(arrays: Dict[str, np.ndarray], side: str, device, n_pose: int = 6) -> Hand:
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return Hand(t(arrays["v_template"]), t(arrays["shapedirs"]),
                t(arrays["posedirs"].reshape(-1, arrays["posedirs"].shape[-1])),
                t(arrays["J_regressor"]), t(arrays["lbs_weights"]),
                t(arrays["hands_components"][:n_pose]), t(arrays["hands_mean"]),
                t(TIP_VERTEX_IDS[side], torch.long), t(arrays["faces"], torch.long))


def rodrigues(rotvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3] through the unit
    quaternion (smooth at the origin)."""
    angle = torch.sqrt(torch.sum(rotvec ** 2, dim=-1, keepdim=True) + 1e-16)
    axis = rotvec / angle
    q = torch.cat([torch.cos(angle * 0.5), torch.sin(angle * 0.5) * axis], dim=-1)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (w * y + x * z),
        2 * (w * z + x * y), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (w * x + y * z), w * w - x * x - y * y + z * z,
    ], dim=-1)
    return r.reshape(*q.shape[:-1], 3, 3)


def forward(h: Hand, global_orient, hand_pose, betas, transl):
    """-> (vertices [B, 778, 3], joints [B, 21, 3]), meters."""
    B, V = global_orient.shape[0], h.v_template.shape[0]
    pose = torch.cat([global_orient, h.hands_mean + hand_pose @ h.pose_basis], -1)
    rot = rodrigues(pose.reshape(B, 16, 3))
    v_shaped = h.v_template + torch.einsum("vcs,bs->bvc", h.shapedirs, betas)
    j_rest = torch.einsum("jv,bvc->bjc", h.J_regressor, v_shaped)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    v_posed = v_shaped + ((rot[:, 1:] - eye).reshape(B, -1) @ h.posedirs.t()).reshape(B, V, 3)

    parents = torch.as_tensor(KINTREE_PARENTS[1:], device=rot.device)
    rel = torch.cat([j_rest[:, :1], j_rest[:, 1:] - j_rest[:, parents]], dim=1)
    bottom = rot.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, 16, 1, 4)
    T = torch.cat([torch.cat([rot, rel[..., None]], -1), bottom], -2)
    chain = [T[:, 0]]
    for k in range(1, 16):
        chain.append(chain[KINTREE_PARENTS[k]] @ T[:, k])
    G = torch.stack(chain, 1)
    posed = G[:, :, :3, 3]
    corr = torch.einsum("bkij,bkj->bki", G[:, :, :3, :3], j_rest)
    A = torch.cat([torch.cat([G[:, :, :3, :3], (posed - corr)[..., None]], -1), G[:, :, 3:]], -2)

    Tv = torch.einsum("vk,bkij->bvij", h.lbs_weights, A)
    v_hom = torch.cat([v_posed, v_posed.new_ones(B, V, 1)], -1)
    verts = torch.einsum("bvij,bvj->bvi", Tv, v_hom)[..., :3]
    joints = torch.cat([posed, verts[:, h.tip_ids]], 1)[:, list(JOINT_REORDER)]
    return verts + transl[:, None], joints + transl[:, None]
