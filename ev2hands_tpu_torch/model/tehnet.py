"""TEHNet's forward in PyTorch, channels-last, in eval and in training.

Counterpart of ``ev2hands_tpu/model/tehnet.py``: a PointNet++
encoder-decoder over the ERPC cloud, a 4-class per-event segmentation head,
class-space attention and two MANO parameter regressors. Module names follow
the reference's torch state dict (``sa1``, ``fp3``, ``classifier.N``,
``left_query_conv.N``, ``left_mano_regressor.mano_regressor.N``, ...).

Eval samples every FPS from index 0 and shares one draw between the two
regressor heads. Training (``net.train()``) draws a random FPS start per
layer unless ``fps_deterministic`` is set, with the JAX package's sharing
rule for the heads, and dropout; every draw comes from the generator given
to ``forward``.

Multi-device (``parallel/``): under a data mesh (``TEHNet(mesh=...)`` or
``set_mesh``) each rank runs its rows of the global batch, BatchNorm reduces
its statistics over the data ranks and every draw is made at the global
batch's shape, this rank's rows kept. With ``cfg.event_parallel`` and an
event mesh (``TEHNet(event_mesh=...)``), FPS and the dense set-abstraction
scales of sa1, sa2 and the heads' sa1 shard the event axis over the event
ranks (eval, and training with ``dense_train``); the event mesh's data ranks
are the data mesh.

The default-off switches of ``ModelConfig``: ``bf16_train`` and
``bf16_eval`` (``set_precision``), ``uv_split_gather`` (the set-abstraction
layers' gather route) and ``fused_regressors`` (eval on the dense route
without an event mesh runs both heads in one pass,
``model/fused_regressor.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ev2hands_tpu_torch.config import ModelConfig
from ev2hands_tpu_torch.mano.layer import ManoParams, mano_forward
from ev2hands_tpu_torch.model.fused_regressor import fused_two_hand_regressor
from ev2hands_tpu_torch.model.layers import (
    BatchNorm,
    Chain,
    Conv1dK3,
    Dropout,
    FeaturePropagation,
    Pointwise,
    QueryConv,
    SetAbstractionAll,
    SetAbstractionMsg,
    attention_block,
    set_mesh,
)
from ev2hands_tpu_torch.ops.fps import fps_unchecked
from ev2hands_tpu_torch.parallel.event_parallel import event_sharded_fps
from ev2hands_tpu_torch.parallel.mesh import Mesh, global_randint

# Centroids of the regressor heads' sa1; one FPS draw of this size feeds both
# in eval.
REGRESSOR_NPOINT = 128


class ManoRegressor(nn.Module):
    """Per-hand regressor: event positions + the 4 attention features ->
    3 global_orient + 6 PCA pose + 10 betas + 3 transl."""

    def __init__(self, in_channel: int = 4, n_pose_params: int = 6,
                 n_shape_params: int = 10, dropout: float = 0.3,
                 device="cuda", **sa_options):
        super().__init__()
        self.n_pose_params = n_pose_params
        self.n_shape_params = n_shape_params
        self.sa1 = SetAbstractionMsg(
            REGRESSOR_NPOINT, (0.4, 0.8), (64, 128), in_channel,
            ((128, 128, 256), (128, 196, 256)), device=device, **sa_options)
        self.sa2 = SetAbstractionAll(512 + 3, (256, 512), device)
        n_out = 3 + n_pose_params + n_shape_params + 3
        self.mano_regressor = Chain(
            Pointwise(512, 1024, 0, device), nn.ReLU(),
            BatchNorm(1024, device), Dropout(dropout),
            Pointwise(1024, n_out, 0, device),
        )

    def forward(self, xyz, features, fps_idx=None, fps_start=None,
                generator=None) -> Dict[str, torch.Tensor]:
        l1_xyz, l1_points = self.sa1(xyz, features, fps_idx, fps_start)
        _, l2_points = self.sa2(l1_xyz, l1_points)
        out = self.mano_regressor(l2_points[:, 0, :], generator)
        np_, ns = self.n_pose_params, self.n_shape_params
        return {
            "global_orient": out[:, :3],
            "hand_pose": out[:, 3:3 + np_],
            "betas": out[:, 3 + np_:3 + np_ + ns],
            "transl": out[:, -3:],
        }


class TEHNet(nn.Module):
    """events [B, N, C_in] normalised ERPC cloud -> segmentation logits
    [B, N, num_classes] and per-hand MANO parameters."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), device="cuda",
                 mesh: Optional[Mesh] = None, event_mesh: Optional[Mesh] = None):
        super().__init__()
        self.cfg = cfg

        def sa_options(grouping, dense_chunk):
            return dict(
                grouping=grouping or cfg.grouping, dense_chunk=dense_chunk,
                pallas_grouping=cfg.pallas_grouping, pallas_nb=cfg.pallas_nb,
                pallas_gather=cfg.pallas_gather,
                pallas_gather_nb=cfg.pallas_gather_nb,
                pallas_gather_bwd=cfg.pallas_gather_bwd,
                pallas_gather_wide=cfg.pallas_gather_wide,
                rank_ball_query=cfg.rank_ball_query,
                pallas_fused=cfg.pallas_fused_msg, dense_train=cfg.dense_train,
                uv_split_gather=cfg.uv_split_gather,
            )

        self.sa1 = SetAbstractionMsg(
            512, (0.1, 0.2, 0.4), (32, 64, 128), cfg.in_channels,
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)), device=device,
            **sa_options(cfg.grouping_sa1, cfg.dense_chunk),
        )
        self.sa2 = SetAbstractionMsg(
            128, (0.4, 0.8), (64, 128), 320,
            ((128, 128, 256), (128, 196, 256)), device=device,
            **sa_options(cfg.grouping_sa2, cfg.dense_chunk),
        )
        self.sa3 = SetAbstractionAll(512 + 3, (256, 512, 1024), device)
        self.fp3 = FeaturePropagation(512 + 1024, (256, 256), device)
        self.fp2 = FeaturePropagation(320 + 256, (256, 128), device)
        self.fp1 = FeaturePropagation(128, (128, 128, 256), device)
        self.classifier = Chain(
            Pointwise(256, 256, 1, device), nn.ReLU(), BatchNorm(256, device),
            Dropout(cfg.dropout_classifier),
            Pointwise(256, cfg.num_classes, 1, device),
        )
        self.left_query_conv = QueryConv(dropout=cfg.dropout_query, device=device)
        self.right_query_conv = QueryConv(dropout=cfg.dropout_query, device=device)
        reg = dict(in_channel=cfg.num_classes, dropout=cfg.dropout_regressor,
                   device=device,
                   **sa_options(cfg.grouping_regressor, cfg.regressor_dense_chunk))
        self.left_mano_regressor = ManoRegressor(**reg)
        self.right_mano_regressor = ManoRegressor(**reg)
        self.regressor_grouping = cfg.grouping_regressor or cfg.grouping
        set_precision(self, cfg.bf16_train, cfg.bf16_eval)
        self.set_mesh(mesh, event_mesh)

    def set_mesh(self, mesh: Optional[Mesh] = None,
                 event_mesh: Optional[Mesh] = None) -> "TEHNet":
        """Run under a data mesh (``mesh``) or a (data, event) mesh
        (``event_mesh``, which shards the event axis when
        ``cfg.event_parallel`` is set; its data ranks are the data mesh), or
        on one device (neither)."""
        self.mesh = event_mesh if event_mesh is not None else mesh
        self.event_mesh = event_mesh if self.cfg.event_parallel else None
        set_mesh(self, self.mesh, self.event_mesh)
        return self

    def fps_starts(self, B: int, N: int,
                   generator: Optional[torch.Generator]) -> list:
        """The FPS start rows [B] of sa1, sa2 and the two regressor heads
        (None = index 0). Training draws them unless ``fps_deterministic``;
        with ``shared_head_fps`` one draw serves both heads. Under a data
        mesh, B is this rank's rows and the draws the global batch's."""
        if not self.training or self.cfg.fps_deterministic:
            return [None] * 4
        if generator is None:
            raise ValueError("TEHNet: training with random FPS starts needs a generator")

        def draw(n):
            return global_randint(n, (B,), generator, self.mesh, dtype=torch.int32)

        starts = [draw(N), draw(self.sa1.npoint), draw(N)]
        starts.append(starts[2] if self.cfg.shared_head_fps else draw(N))
        return starts

    def forward(self, events: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict:
        """``generator`` gives the training draws (FPS starts, dropout); eval
        and draw-free training take none."""
        cfg = self.cfg
        l0_points = events
        l0_xyz = events[..., :3]
        if cfg.mhlnes:
            # the time coordinate becomes the mean polarity channel
            l0_xyz = torch.cat(
                [l0_xyz[..., :2], events[..., 3:].mean(dim=-1, keepdim=True)], -1)
        starts = self.fps_starts(events.shape[0], events.shape[1], generator)
        shared_head = starts[2] is starts[3]
        starts = [None if s is None else s.to(events.device) for s in starts]
        l1_xyz, l1_points = self.sa1(l0_xyz, l0_points, fps_start=starts[0])
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points, fps_start=starts[1])
        l3_xyz, l3_points = self.sa3(l2_xyz, l2_points)
        l2_points = self.fp3(l2_xyz, l3_xyz, l2_points, l3_points)
        l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points)
        l0_feats = self.fp1(l0_xyz, l1_xyz, None, l1_points)

        seg_logits = self.classifier(l0_feats, generator)
        left_query = self.left_query_conv(l0_feats, generator)
        right_query = self.right_query_conv(l0_feats, generator)
        left_features = attention_block(seg_logits, l0_feats, left_query)
        right_features = attention_block(seg_logits, l0_feats, right_query)

        if (cfg.fused_regressors and not self.training and self.event_mesh is None
                and self.regressor_grouping == "dense"):
            left, right = fused_two_hand_regressor(
                (self.left_mano_regressor, self.right_mano_regressor), l0_xyz,
                left_features, right_features)
            return {"class_logits": seg_logits, "left": left, "right": right}

        # one FPS for both heads when they start alike (eval, deterministic
        # training) or share a draw; independent draws otherwise
        reg_fps_idx = None
        if shared_head and self.event_mesh is not None:
            reg_fps_idx = event_sharded_fps(self.event_mesh, l0_xyz, REGRESSOR_NPOINT,
                                            starts[2])
        elif shared_head:
            reg_fps_idx = fps_unchecked(l0_xyz, REGRESSOR_NPOINT, starts[2])
        left = self.left_mano_regressor(l0_xyz, left_features, reg_fps_idx,
                                        starts[2], generator)
        right = self.right_mano_regressor(l0_xyz, right_features, reg_fps_idx,
                                          starts[3], generator)
        return {"class_logits": seg_logits, "left": left, "right": right}


def set_precision(net: "TEHNet", bf16_train: bool, bf16_eval: bool) -> None:
    """The layers that compute in bfloat16 under ``bf16_train`` (in
    training) and ``bf16_eval`` (in eval), as the JAX package routes its
    ``dtype``: the convs of the set-abstraction layers (their gather and
    dense routes), sa3 and the heads' global layer, feature propagation,
    the query heads and the classifier's first conv; under ``bf16_eval``
    also those layers' eval BatchNorm output. The classifier's last conv and
    the heads' fc stack stay in the parameters' dtype, and every BatchNorm
    normalises in it."""
    layers = [net.sa1, net.sa2, net.sa3, net.fp3, net.fp2, net.fp1,
              net.left_query_conv, net.right_query_conv, net.classifier[0],
              net.classifier[2]]
    for head in (net.left_mano_regressor, net.right_mano_regressor):
        layers += [head.sa1, head.sa2]
    for layer in layers:
        set_layer_precision(layer, bf16_train, bf16_eval)


def set_layer_precision(layer: nn.Module, bf16_train: bool, bf16_eval: bool) -> None:
    """Every conv of ``layer`` computes in bfloat16 under ``bf16_train`` (in
    training) and ``bf16_eval`` (in eval), and under ``bf16_eval`` every eval
    BatchNorm of it outputs bfloat16."""
    for m in layer.modules():
        if isinstance(m, (Pointwise, Conv1dK3)):
            m.bf16_train, m.bf16_eval = bf16_train, bf16_eval
        elif isinstance(m, BatchNorm):
            m.bf16_eval = bf16_eval


def apply_mano(hands: Dict[str, ManoParams], outputs: Dict) -> Dict:
    """Attach MANO vertices and 21 joints (``j3d``) to each hand's regressed
    parameters."""
    out = dict(outputs)
    for side in ("left", "right"):
        p = outputs[side]
        res = mano_forward(hands[side], p["global_orient"], p["hand_pose"],
                           p["betas"], p["transl"])
        out[side] = dict(p, vertices=res.vertices, j3d=res.joints)
    return out


def batchnorm_cancelled_biases(net: nn.Module) -> set:
    """Names of the biases in ``net`` (a TEHNet or one of its layers) whose
    gradient is zero in a training step, because a train-mode BatchNorm
    subtracts the batch mean after them: every conv bias that feeds a
    BatchNorm directly (the set-abstraction and propagation chains, the
    query heads' second conv), and sa3's last BatchNorm bias, which reaches
    fp3's BatchNorm as a shift shared by every point of the batch (the
    global max is positive in every channel). A framework computes
    rounding noise there, so gradient comparisons leave these out."""
    names = set()
    for prefix, m in net.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(m, SetAbstractionMsg):
            names |= {f"{p}conv_blocks.{i}.{j}.bias"
                      for i, convs in enumerate(m.conv_blocks) for j in range(len(convs))}
        elif isinstance(m, (SetAbstractionAll, FeaturePropagation)):
            names |= {f"{p}mlp_convs.{j}.bias" for j in range(len(m.mlp_convs))}
        elif isinstance(m, Chain):
            names |= {f"{p}{j}.bias" for j in range(len(m) - 1)
                      if isinstance(m[j + 1], BatchNorm) and hasattr(m[j], "bias")}
        if isinstance(m, TEHNet):
            names.add(f"{p}sa3.mlp_bns.{len(m.sa3.mlp_bns) - 1}.bias")
    return names
