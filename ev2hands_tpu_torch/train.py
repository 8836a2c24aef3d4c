"""The TEHNet training step: raw event windows and MANO ground truth in, one
Adam update out.

Counterpart of ``make_train_step`` in ``ev2hands_tpu/train.py``: ERPC with
augmentation -> ``TEHNet`` in training mode -> ``apply_mano`` ->
``mano_losses`` with the collision term -> backward -> Adam. The hands are
the synthetic MANO models (``build_hands``); the reader, the training loop
with eval and checkpointing, and multi-device runs are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ev2hands_tpu_torch.config import Config, TrainConfig
from ev2hands_tpu_torch.events.erpc import NoiseDraws, erpc_batch_transform
from ev2hands_tpu_torch.losses import CollisionContext, mano_losses, total_loss
from ev2hands_tpu_torch.mano.layer import ManoParams, create_mano_params
from ev2hands_tpu_torch.mano.model_data import synthetic_mano_models
from ev2hands_tpu_torch.model.tehnet import TEHNet, apply_mano
from ev2hands_tpu_torch.ops.collision import (
    build_adjacency_mask,
    build_two_hand_faces,
)


def build_hands(cfg: Config, device="cuda") -> Dict[str, ManoParams]:
    """Both hands' MANO constants from the synthetic models (seed 0)."""
    return {side: create_mano_params(m, cfg.mano.n_pose_comps, device=device)
            for side, m in synthetic_mano_models(0).items()}


def build_collision_context(hands: Dict[str, ManoParams]) -> CollisionContext:
    faces = build_two_hand_faces(hands["left"].faces.cpu().numpy(),
                                 hands["right"].faces.cpu().numpy())
    device = hands["left"].faces.device
    return CollisionContext(
        faces=torch.as_tensor(faces, device=device),
        adjacency=torch.as_tensor(build_adjacency_mask(faces), device=device))


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with the weight decay added to the gradient before the moments
    (``optax.chain(add_decayed_weights(wd), adam(lr))``, not AdamW)."""
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            weight_decay=cfg.weight_decay)


def forward_losses(
    net: TEHNet, hands: Dict[str, ManoParams], ctx: CollisionContext,
    cfg: Config, events: torch.Tensor, targets: Dict,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one batch of ERPC clouds: ``net`` (in the mode it is in)
    -> MANO -> ``mano_losses`` -> (total, loss dict). ``targets`` carries
    'left', 'right', 'handedness' and the per-event labels as
    'class_logits'."""
    outputs = apply_mano(hands, net(events, generator))
    losses = mano_losses(outputs, targets, hands, ctx, cfg.loss,
                         n_pose_comps=cfg.mano.n_pose_comps)
    return total_loss(losses), losses


def _to(x, device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return torch.as_tensor(x, device=device)


def make_train_step(
    net: TEHNet,
    hands: Dict[str, ManoParams],
    ctx: CollisionContext,
    cfg: Config,
    optimizer: torch.optim.Optimizer,
    augment: bool = True,
    device="cuda",
):
    """-> ``step(batch, generator=None, *, draws=None, noise=None)`` that
    runs one training step and returns its losses as a dict of floats
    (with the total as 'loss').

    ``net``, ``hands`` and ``ctx`` live on ``device``, which defaults to the
    card and raises when there is none; ``device="cpu"`` runs the kernels'
    plain versions. ``batch`` holds raw windows 'events' [B, N, 4] (x, y, t
    in ns, polarity) and 'labels' [B, N], per hand 'global_orient',
    'hand_pose', 'shape', 'trans' and 'valid', and 'handedness' [B, 2]
    (numpy arrays or tensors). The ERPC draws, FPS starts and dropout come
    from ``generator`` (on ``device``); ``draws`` and ``noise`` give the ERPC
    resample and noise draws instead.

    A step mutates in place: ``net``'s parameters (the Adam update), its
    BatchNorm running statistics (the forward in training mode) and the
    optimizer's state."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_train_step: no CUDA device is available")
    sensor = cfg.sensor

    def step(batch: Dict, generator: Optional[torch.Generator] = None, *,
             draws: Optional[torch.Tensor] = None,
             noise: Optional[NoiseDraws] = None) -> Dict[str, float]:
        batch = _to(batch, device)
        erpc = erpc_batch_transform(
            batch["events"], batch["labels"], generator, draws=draws,
            width=sensor.width, height=sensor.height,
            n_out=cfg.model.n_points, augment=augment, noise=noise)
        targets = {"left": batch["left"], "right": batch["right"],
                   "handedness": batch["handedness"],
                   "class_logits": erpc.labels}
        net.train()
        loss, losses = forward_losses(net, hands, ctx, cfg, erpc.events,
                                      targets, generator)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        names = list(losses) + ["loss"]
        values = torch.stack([torch.as_tensor(v, dtype=loss.dtype, device=device)
                              .detach() for v in losses.values()] + [loss.detach()])
        return dict(zip(names, values.tolist()))

    return step
