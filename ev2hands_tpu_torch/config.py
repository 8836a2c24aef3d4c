"""Configuration of the PyTorch port: the fields of ``ev2hands_tpu.config``
that the inference, training, finetuning, evaluation and data-generation
paths read, copied
so that the port imports nothing of the JAX package. Field names and
defaults are the JAX package's."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Event-camera sensor geometry (DAVIS346)."""

    width: int = 346
    height: int = 260

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


@dataclasses.dataclass(frozen=True)
class EsimConfig:
    """Event-simulator thresholds and rates of the data generator."""

    positive_threshold: float = 0.4
    negative_threshold: float = 0.4
    # per-pixel dead time between emitted events, ns (0: none)
    refractory_period_ns: int = 0
    simulator_fps: int = 1000
    interpolation_fps: int = 30
    # bound on the events a pixel emits between two frames
    max_events_per_pixel: int = 25


@dataclasses.dataclass(frozen=True)
class ManoConfig:
    """MANO hand-model hyperparameters read by training and the entry
    points."""

    n_pose_comps: int = 6        # PCA pose components fed to the network
    # the directory of MANO_{LEFT,RIGHT}.pkl (or of mano/MANO_*.pkl)
    model_path: str = "data/models"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """TEHNet architecture switches read by the inference and training
    paths."""

    num_classes: int = 4           # bg / left / right / noise
    n_points: int = 2048           # events per window
    erpc: bool = True              # 5-channel ERPC input (x, y, t_avg, #pos, #neg)
    mhlnes: bool = False           # replace the t coordinate with mean polarity
    # Training draws a random FPS start per layer unless this is set; eval
    # always samples from index 0.
    fps_deterministic: bool = False
    # One random FPS draw for both regressor heads in training (the
    # reference draws one per head).
    shared_head_fps: bool = False
    # Neighborhood grouping of the set-abstraction blocks in eval: 'dense'
    # (masked pairs, the block-sparse kernel on the large scales) or
    # 'gather' (ball query + neighbor gather). Training always gathers.
    grouping: str = "dense"
    grouping_sa1: Optional[str] = None
    grouping_sa2: Optional[str] = None
    grouping_regressor: Optional[str] = None
    # Centroids per chunk of the dense pair tensors [B, chunk, N, C].
    dense_chunk: int = 64
    regressor_dense_chunk: int = 32
    # Route the large three-layer sa1 scales through the block-sparse grouping
    # kernel (ops/grouping.msg_scale_sparse); the name is the JAX package's.
    pallas_grouping: bool = True
    # Point-tile size of the block-sparse grouping (points per activity bit).
    pallas_nb: int = 256
    # Gather the grouped neighbors with the one-hot gather kernel
    # (ops/gather.grouped_gather) over a Morton-ordered source, ball queries
    # in the permuted column order; the names are the JAX package's.
    pallas_gather: bool = False
    # Sort-free cumsum-rank ball query on the gather route (same indices as
    # the top-k form).
    rank_ball_query: bool = True
    # Point-tile size of the one-hot gather's activity map.
    pallas_gather_nb: int = 128
    # Backward of the one-hot gather: the scatter-add kernel (True) or the
    # plain scatter-add (False).
    pallas_gather_bwd: bool = False
    # Take the one-hot gather for wide sources too (3 * (D + 3) > 128, sa2).
    pallas_gather_wide: bool = True
    # Run all scales of a set-abstraction layer in one block-sparse pass
    # (ops/grouping.msg_fused_scales_sparse: block-diagonal stacked weights,
    # union tile activity) when every scale takes the block-sparse route.
    pallas_fused_msg: bool = False
    # Training on the dense route too ('dense' grouping), with BatchNorm
    # statistics weighted by each pair's multiplicity in the gather route's
    # selected-neighbor multiset (SetAbstractionMsg._dense_train_scale). Off
    # by default; the route of event-sharded training.
    dense_train: bool = False
    # Shard the event axis N of the dense set-abstraction scales and of FPS
    # over the 'event' ranks of the mesh given as TEHNet(event_mesh=...)
    # (parallel/event_parallel.py).
    event_parallel: bool = False
    # Gather route in training: apply each scale's first conv per point,
    # gather those rows ([B, S, K, C1] instead of [points, xyz]) and rebuild
    # the pair activation as u_n - v_s + b, with v_s the conv of [0, c_s].
    # BatchNorm sees the same selected-neighbor multiset. Ignored where the
    # one-hot gather kernel takes the layer (pallas_gather).
    uv_split_gather: bool = False
    # Mixed-precision training: the Dense/Conv chains of the set-abstraction
    # gather route, sa3 and the regressors' global layer, feature
    # propagation, the query heads and the classifier's first conv compute
    # in bfloat16. Parameters, Adam state, BatchNorm statistics and
    # normalisation, the output heads, MANO and the losses stay float32.
    # Eval is unchanged.
    bf16_train: bool = False
    # Mixed-precision eval: the Dense/Conv layers and the eval BatchNorm of
    # the dense set-abstraction scales (not the block-sparse ones), sa3 and
    # the regressors' global layer, feature propagation, the query heads and
    # the classifier trunk compute in bfloat16. Selection (FPS, distances,
    # ball-query masks, 3-NN) stays float32, so every index is unchanged;
    # the output heads, MANO and the metrics stay float32. Training is
    # unchanged.
    bf16_eval: bool = False
    # Eval on the dense route without an event mesh: both regressor heads in
    # one pass (model/fused_regressor.py): one FPS draw and one selection per
    # radius shared, eval BatchNorm folded into the convs and the two heads'
    # weights stacked on a leading axis.
    fused_regressors: bool = False
    dropout_classifier: float = 0.3
    dropout_query: float = 0.1
    dropout_regressor: float = 0.3

    @property
    def in_channels(self) -> int:
        return 5 if self.erpc else 4


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights."""

    collision_weight: float = 1e2
    collision_sigma: float = 0.5
    collision_max_pairs: int = 128      # colliding pairs kept per sample
    ce_class_weights: Tuple[float, ...] = (1.0, 30.0, 30.0, 10.0)
    ce_ignore_index: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop, finetuning and evaluation hyperparameters."""

    batch_size: int = 8
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    max_iter: int = 800_000
    save_iter: int = 10_000
    msg_iter: int = 50
    max_eval_iters: int = 8192
    eval_batch_size: int = 32
    seed: int = 0
    checkpoint_path: str = ""
    data_root: str = "data/Ev2Hands-S"
    # Data-parallel ranks (torch.distributed processes); 1 = one device.
    data_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """The rendering camera of the 2-D reprojection loss: a perspective
    projection with a 30 degree vertical field of view at the sensor's
    aspect ratio."""

    yfov_deg: float = 30.0
    znear: float = 0.05
    zfar: Optional[float] = None

    def projection_matrix(self, width: int, height: int):
        """[4, 4] float64 OpenGL projection matrix
        (``pyrender.PerspectiveCamera.get_projection_matrix``'s)."""
        import numpy as np

        aspect = width / height
        t = 1.0 / math.tan(math.radians(self.yfov_deg) / 2.0)
        p = np.zeros((4, 4), dtype=np.float64)
        p[0, 0] = t / aspect
        p[1, 1] = t
        p[3, 2] = -1.0
        if self.zfar is None:
            p[2, 2] = -1.0
            p[2, 3] = -2.0 * self.znear
        else:
            n, f = self.znear, self.zfar
            p[2, 2] = (f + n) / (n - f)
            p[2, 3] = (2 * f * n) / (n - f)
        return p


@dataclasses.dataclass(frozen=True)
class DatagenConfig:
    """Scene dressing of the synthetic generator: Gouraud vertex colours,
    forearms, per-frame point lights and a per-sequence background
    (``realistic_scene``), or flat-shaded hands on a grey background."""

    realistic_scene: bool = True
    add_forearms: bool = True
    ambient: float = 0.1
    background_cells: int = 8    # grid of the background's low-frequency field


@dataclasses.dataclass(frozen=True)
class Config:
    sensor: SensorConfig = SensorConfig()
    esim: EsimConfig = EsimConfig()
    mano: ManoConfig = ManoConfig()
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    camera: CameraConfig = CameraConfig()
    datagen: DatagenConfig = DatagenConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = Config()

# the hands' base skin colour (RGB in [0, 1])
HAND_COLOR = (198 / 255, 134 / 255, 66 / 255)
