"""The reference's entry points: eval outputs of a batch of raw windows, and
one pretraining step (ERPC with augmentation, TEHNet in training mode,
MANO, the losses, the gradient, Adam)."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import erpc, mano
from .losses import losses as loss_terms, two_hand_faces
from .model import Net, is_statistic

SENSOR = (346, 260)


def apply_mano(hands, out: Dict) -> Dict:
    out = dict(out)
    for side in ("left", "right"):
        p = out[side]
        v, j = mano.forward(hands[side], p["global_orient"], p["hand_pose"], p["betas"], p["transl"])
        out[side] = dict(p, vertices=v, j3d=j)
    return out


@torch.no_grad()
def infer(P, hands, events, labels, uniforms, n_points: int,
          record: Optional[List] = None) -> Dict:
    """Raw windows [B, N, 4] and labels -> class logits and both hands' MANO
    parameters, vertices and joints (eval; the resample from ``uniforms``
    [B, n_points] float64)."""
    cloud, _ = erpc.transform(events, labels, None, *SENSOR, n_points, uniforms=uniforms)
    return apply_mano(hands, Net(P, record=record)(cloud))


def gt_mm(hands, target) -> Dict[str, torch.Tensor]:
    """The ground truth's joints and vertices [B, 2, ., 3] in mm."""
    from .losses import gt_mesh

    with torch.no_grad():
        vj = [gt_mesh(hands, target, s) for s in ("left", "right")]
    return {"vertices": torch.stack([vj[0][0], vj[1][0]], 1) * 1000,
            "j3d": torch.stack([vj[0][1], vj[1][1]], 1) * 1000}


class Trainer:
    """TEHNet's parameters, BatchNorm statistics and Adam state (lr 1e-3,
    betas 0.9 / 0.999, eps 1e-8, no weight decay), stepped one batch at a
    time."""

    lr, beta1, beta2, eps = 1e-3, 0.9, 0.999, 1e-8

    def __init__(self, state: Dict[str, torch.Tensor], hands, n_points: int):
        self.P = {k: v.detach().clone().requires_grad_(not is_statistic(k))
                  for k, v in state.items()}
        self.hands = hands
        self.faces, self.adjacency = two_hand_faces(hands)
        self.n_points = n_points
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p for k, p in self.P.items() if p.requires_grad}

    def step(self, batch: Dict, generator: torch.Generator) -> Dict[str, float]:
        """One step on ``batch`` (raw events, labels, per hand the MANO
        ground truth and 'valid', 'handedness') -> the loss terms and the
        total as 'loss'."""
        cloud, labels = erpc.transform(batch["events"], batch["labels"], generator,
                                       *SENSOR, self.n_points, augment=True)
        out = apply_mano(self.hands, Net(self.P, train=True, generator=generator)(cloud))
        target = dict(batch, class_logits=labels)
        terms = loss_terms(out, target, self.hands, self.faces, self.adjacency)
        total = sum(terms.values())
        names = list(self.params())
        grads = torch.autograd.grad(total, [self.P[k] for k in names])
        self.t += 1
        b1, b2 = self.beta1, self.beta2
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for k, g in zip(names, grads):
                m = self.m.setdefault(k, torch.zeros_like(g))
                v = self.v.setdefault(k, torch.zeros_like(g))
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / c2 ** 0.5).add_(self.eps)
                self.P[k].addcdiv_(m, denom, value=-self.lr / c1)
        vals = {k: float(torch.as_tensor(v).detach()) for k, v in terms.items()}
        vals["loss"] = float(total.detach())
        return vals

    def first_moment(self) -> Dict[str, torch.Tensor]:
        """Adam's first moment by parameter name."""
        return dict(self.m)
