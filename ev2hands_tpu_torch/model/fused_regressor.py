"""Both MANO regressor heads in one pass, for eval on the dense route.

Counterpart of ``ev2hands_tpu/model/fused_regressor.py``. The two
``ManoRegressor`` heads of ``TEHNet`` have the same structure and sample the
same event positions, so in eval:

* one FPS draw (the FPS kernel) and one [B, S, N] distance tensor serve
  both heads, with one selection mask per radius (the first K in-radius
  points, point 0 for an empty ball);
* each conv is folded with its eval BatchNorm (``fold_bn_dense``) and the
  two heads' weights are stacked on a leading axis of 2, so every layer is
  one batched matrix product;
* the first conv splits into a per-point half u and a per-centroid half v,
  as the dense route's ``_dense_scale`` does.

The heads' modules own the parameters: this function reads them, so the
state dict and the training path are unchanged. It computes in the
parameters' dtype whatever ``bf16_eval`` says, as the JAX function, which
takes no dtype.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ev2hands_tpu_torch.ops.fps import fps_unchecked
from ev2hands_tpu_torch.ops.grouping import dense_selection_mask
from ev2hands_tpu_torch.ops.pointnet import index_points, square_distance
from ev2hands_tpu_torch.parallel.event_parallel import fold_bn_dense

# centroids a chunk of the pair tensors [2, B, chunk, N, C]
S_CHUNK = 16


def _folded(convs, bns) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of both heads, eval BatchNorm folded in -> (W [2, C_in,
    C_out], b [2, C_out])."""
    pairs = [fold_bn_dense(c.kernel, c.bias, bn.weight, bn.bias, bn.running_mean,
                           bn.running_var, bn.eps) for c, bn in zip(convs, bns)]
    return torch.stack([w for w, _ in pairs]), torch.stack([b for _, b in pairs])


def _hdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [2, ..., C_in] @ w [2, C_in, C_out] -> [2, ..., C_out], one batched
    product over the leading head axis."""
    out = torch.bmm(x.reshape(2, -1, x.shape[-1]), w)
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def _split(out: torch.Tensor, n_pose: int, n_shape: int) -> Dict[str, torch.Tensor]:
    return {"global_orient": out[:, :3], "hand_pose": out[:, 3:3 + n_pose],
            "betas": out[:, 3 + n_pose:3 + n_pose + n_shape], "transl": out[:, -3:]}


def fused_two_hand_regressor(
    heads: Sequence[torch.nn.Module], xyz: torch.Tensor,
    features_left: torch.Tensor, features_right: torch.Tensor,
    s_chunk: int = S_CHUNK,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``heads`` (the left and the right ``ManoRegressor``, in eval) on the
    shared event positions ``xyz`` [B, N, 3] and their attention features
    [B, N, 4] -> (left, right) dicts of the regressed MANO parameters, the
    values of running each head on its own."""
    left, right = heads
    sa1 = left.sa1
    feats = torch.stack([features_left, features_right]).to(xyz.dtype)  # [2, B, N, D]
    B, N, _ = xyz.shape
    D = feats.shape[-1]
    S = sa1.npoint

    # shared geometry: one FPS draw, one distance tensor, a selection a radius
    new_xyz = index_points(xyz, fps_unchecked(xyz, S))              # [B, S, 3]
    d2 = square_distance(new_xyz, xyz)                              # [B, S, N]
    src = torch.cat([feats, xyz.expand(2, B, N, 3)], dim=-1)        # [2, B, N, D+3]
    cent = torch.cat([xyz.new_zeros(B, S, D), new_xyz], dim=-1)     # [B, S, D+3]

    # sa1: every scale's chain on both heads at once
    chunk = max(1, min(s_chunk, S))
    scale_outs = []
    for i, (radius, k) in enumerate(zip(sa1.radius_list, sa1.nsample_list)):
        sel = dense_selection_mask(d2, radius, k) > 0.5
        layers = [_folded([h.sa1.conv_blocks[i][j] for h in heads],
                          [h.sa1.bn_blocks[i][j] for h in heads])
                  for j in range(len(sa1.mlps[i]))]
        W0, b0 = layers[0]
        u = _hdot(src, W0)                                          # [2, B, N, C1]
        v = _hdot(cent.expand(2, B, S, D + 3), W0)                  # [2, B, S, C1]
        chunks = []
        for s0 in range(0, S, chunk):
            z = torch.relu(u[:, :, None] - v[:, :, s0:s0 + chunk, None]
                           + b0[:, None, None, None])               # [2, B, c, N, C1]
            for W, b in layers[1:]:
                z = torch.relu(_hdot(z, W) + b[:, None, None, None])
            m = sel[None, :, s0:s0 + chunk, :, None]
            chunks.append(torch.where(m, z, -torch.inf).amax(dim=3))
        scale_outs.append(torch.cat(chunks, dim=2))                 # [2, B, S, C]

    # sa2: the global group [xyz, features], its chain and the max
    x = torch.cat([new_xyz.expand(2, B, S, 3)] + scale_outs, dim=-1)
    sa2 = left.sa2
    for j in range(len(sa2.mlp_convs)):
        W, b = _folded([h.sa2.mlp_convs[j] for h in heads],
                       [h.sa2.mlp_bns[j] for h in heads])
        x = torch.relu(_hdot(x, W) + b[:, None, None])
    x = x.amax(dim=2)                                               # [2, B, C]

    # fc_0 -> ReLU -> BatchNorm (an affine in eval) -> fc_1; the BatchNorm
    # follows the ReLU, so it cannot fold into fc_0
    fc0 = [h.mano_regressor[0] for h in heads]
    bns = [h.mano_regressor[2] for h in heads]
    fc1 = [h.mano_regressor[4] for h in heads]
    x = torch.relu(_hdot(x, torch.stack([f.kernel for f in fc0]))
                   + torch.stack([f.bias for f in fc0])[:, None])
    inv = [bn.weight * torch.rsqrt(bn.running_var + bn.eps) for bn in bns]
    scale = torch.stack(inv)
    shift = torch.stack([bn.bias - bn.running_mean * s for bn, s in zip(bns, inv)])
    x = x * scale[:, None] + shift[:, None]
    out = (_hdot(x, torch.stack([f.kernel for f in fc1]))
           + torch.stack([f.bias for f in fc1])[:, None])           # [2, B, 22]
    n_pose, n_shape = left.n_pose_params, left.n_shape_params
    return _split(out[0], n_pose, n_shape), _split(out[1], n_pose, n_shape)
