"""The training losses of TEHNet on Ev2Hands-S in plain PyTorch, with the
two-hand collision term.

Each masked term averages over the elements of the samples where its mask
holds (0 when none does); the weights are the published trainer's. The
collision term keeps, per sample, the ``max_pairs`` deepest overlapping
bounding boxes of triangle pairs that share no vertex, confirms them with a
separating-axis test, and penalises each vertex behind the other triangle's
plane with a conical distance field; its mean over the positive
penetrations is weighted by 1e2.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import mano

CE_WEIGHTS = (1.0, 30.0, 30.0, 10.0)
CE_IGNORE = 0
COLLISION = dict(weight=1e2, sigma=0.5, max_pairs=128)


def masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(x.shape[0], -1)
    v = valid.reshape(-1, 1).to(flat.dtype)
    denom = v.sum() * flat.shape[1]
    return torch.where(denom > 0, (flat * v).sum() / torch.clamp(denom, min=1.0), 0.0)


def cross_entropy(logits, targets) -> torch.Tensor:
    targets = targets.long()
    nll = -torch.gather(torch.log_softmax(logits, -1), -1, targets[..., None])[..., 0]
    w = torch.as_tensor(CE_WEIGHTS, dtype=logits.dtype, device=logits.device)[targets]
    w = w * (targets != CE_IGNORE)
    denom = w.sum()
    return torch.where(denom > 0, (w * nll).sum() / torch.clamp(denom, min=1.0), 0.0)


def two_hand_faces(hands: Dict[str, mano.Hand]):
    """(faces [2F, 3], adjacency [2F, 2F] bool): the right hand's vertex
    ids offset by 778; a pair is adjacent when it shares a vertex."""
    faces = torch.cat([hands["left"].faces, hands["right"].faces + mano.N_VERTICES])
    adj = torch.zeros((faces.shape[0],) * 2, dtype=torch.bool, device=faces.device)
    for k in range(3):
        for m in range(3):
            adj |= faces[:, k][:, None] == faces[None, :, m]
    return faces, adj


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _top(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def intersects(ta, tb, eps=1e-12):
    """Separating-axis test of triangles [..., 3, 3]: both normals, the 9
    edge cross products and the 6 in-plane edge normals."""
    ea, eb = ta - torch.roll(ta, -1, dims=-2), tb - torch.roll(tb, -1, dims=-2)
    na = _cross(ea[..., 0, :], ea[..., 1, :])[..., None, :]
    nb = _cross(eb[..., 0, :], eb[..., 1, :])[..., None, :]
    axes = torch.cat([na, nb,
                      _cross(ea[..., :, None, :], eb[..., None, :, :]).reshape(*ta.shape[:-2], 9, 3),
                      _cross(na.expand(ea.shape), ea), _cross(nb.expand(eb.shape), eb)], -2)
    pa = torch.einsum("...kc,...vc->...kv", axes, ta)
    pb = torch.einsum("...kc,...vc->...kv", axes, tb)
    sep = (pa.amin(-1) > pb.amax(-1) + eps) | (pb.amin(-1) > pa.amax(-1) + eps)
    return ~(sep & ~((axes ** 2).sum(-1) < eps)).any(-1)


def collision(verts_left, verts_right, faces, adjacency) -> torch.Tensor:
    verts = torch.cat([verts_left, verts_right], 1)
    tri = verts[:, faces]                                  # [B, T, 3, 3]
    B, T = tri.shape[:2]
    K = COLLISION["max_pairs"]
    with torch.no_grad():
        d = tri.detach()
        lo, hi = d.amin(-2), d.amax(-2)
        depth = None
        for a in range(3):
            o = (torch.minimum(hi[:, :, None, a], hi[:, None, :, a])
                 - torch.maximum(lo[:, :, None, a], lo[:, None, :, a]))
            depth = o if depth is None else torch.minimum(depth, o)
        keep = torch.ones((T, T), dtype=torch.bool, device=d.device).triu(1) & ~adjacency
        score = torch.where(keep & (depth >= 0), depth, -1e30)
        R = min(2 * K, T)
        _, rows = _top(score.amax(2), R)
        top, idx = _top(torch.gather(score, 1, rows[..., None].expand(B, R, T)).reshape(B, R * T), K)
        pairs = torch.stack([torch.gather(rows, 1, idx // T), idx % T], -1)
        b = torch.arange(B, device=d.device)[:, None]
        hit = intersects(d[b, pairs[..., 0]], d[b, pairs[..., 1]]) & (top > -0.5e30)
    b = torch.arange(B, device=tri.device)[:, None]
    ta, tb = tri[b, pairs[..., 0]], tri[b, pairs[..., 1]]

    def field(src, pts):
        c = src.mean(-2, keepdim=True)
        n = _cross(src[..., 1, :] - src[..., 0, :], src[..., 2, :] - src[..., 0, :])
        n = n / torch.sqrt((n ** 2).sum(-1, keepdim=True) + 1e-20)
        dd = pts - c
        behind = torch.relu(-torch.einsum("...vc,...c->...v", dd, n))
        return (behind * torch.exp(-(dd ** 2).sum(-1) / (2.0 * COLLISION["sigma"] ** 2))).sum(-1)

    pen = torch.where(hit, field(ta, tb) + field(tb, ta), 0.0)
    count = (pen > 0).sum().to(pen.dtype)
    return torch.where(count > 0, pen.sum() / torch.clamp(count, min=1.0) * COLLISION["weight"], 0.0)


def gt_mesh(hands, target, side):
    t = target[side]
    return mano.forward(hands[side], t["global_orient"],
                        t["hand_pose"][..., :hands[side].pose_basis.shape[0]], t["shape"], t["trans"])


def losses(out: Dict, target: Dict, hands, faces, adjacency, n_pose: int = 6) -> Dict[str, torch.Tensor]:
    """The loss terms of one batch, by the published trainer's names."""
    L: Dict[str, torch.Tensor] = {}
    gt = {s: dict(target[s], vertices=v, j3d=j)
          for s in ("left", "right") for v, j in [gt_mesh(hands, target, s)]}
    L["loss_interpen"] = collision(out["left"]["vertices"], out["right"]["vertices"], faces, adjacency)
    both = target["handedness"].sum(1) == 2
    o_l, o_r = out["left"], out["right"]
    L["loss_inter_shape"] = masked_mean((o_l["betas"] - o_r["betas"]) ** 2, both)
    L["loss_inter_transl"] = masked_mean(
        ((o_l["transl"] - o_r["transl"]) - (gt["left"]["trans"] - gt["right"]["trans"])) ** 2, both) * 100.0
    L["loss_inter_j3d"] = masked_mean(
        ((o_l["j3d"] - o_r["j3d"]) - (gt["left"]["j3d"] - gt["right"]["j3d"])) ** 2, both) * 100.0
    for k in ("loss_global_orient", "loss_hand_pose", "loss_rj3d", "loss_j3d",
              "loss_shape", "loss_transl", "regularizer_loss"):
        L[k] = 0.0
    for side in ("left", "right"):
        o, t = out[side], gt[side]
        v = t["valid"]
        L["loss_global_orient"] += masked_mean((o["global_orient"] - t["global_orient"]) ** 2, v) * 10.0
        L["loss_hand_pose"] += masked_mean((o["hand_pose"] - t["hand_pose"][..., :n_pose]) ** 2, v) * 10.0
        rj_o = (o["j3d"][:, 1:] - o["j3d"][:, :1]) * 1000.0
        rj_t = (t["j3d"][:, 1:] - t["j3d"][:, :1]) * 1000.0
        L["loss_rj3d"] += masked_mean(torch.abs(rj_o - rj_t), v) * 0.01
        L["loss_j3d"] += masked_mean(torch.abs(o["j3d"] * 1000.0 - t["j3d"] * 1000.0), v) * 0.01
        L["loss_shape"] += masked_mean((o["betas"] - t["shape"]) ** 2, v) * 10.0
        L["loss_transl"] += masked_mean(torch.abs(o["transl"] - t["trans"]), v) * 10.0
        # the published regulariser is mse(x, x): zero
        L["regularizer_loss"] += 0.0 * (0.1 * masked_mean(o["betas"] ** 2, v)
                                        + masked_mean(o["hand_pose"] ** 2, v))
    L["loss_class_logits"] = cross_entropy(out["class_logits"], target["class_logits"])
    return L
