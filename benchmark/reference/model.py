"""TEHNet in plain PyTorch over a state dict, in eval and in training.

Layout and widths are the published ones (Millerdurai et al., 3DV 2024;
``Chris10M/Ev2Hands`` ``src/Ev2Hands/model/TEHNet.py``): a PointNet++
encoder-decoder over the 5-channel ERPC cloud (sa1, sa2 with multi-scale
grouping, sa3 over all points, fp3-fp1), a 4-class segmentation head,
class-space attention with two query heads, and one MANO regressor per hand
(its own multi-scale sa1 and a global sa2). ``forward`` reads parameters and
BatchNorm statistics from ``P`` by name; in training it moves the running
statistics in ``P`` in place.

BatchNorm: eval ``(x - mean) * (rsqrt(var + eps) * weight) + bias``;
training takes the batch mean and the biased variance ``sum(x * x) / n -
mean^2`` (clipped at 0) over every axis but the last and moves the running
statistics to ``0.9 * running + 0.1 * batch``. Dropout keeps an element
where a uniform draw is below 1 - p and scales it by 1 / (1 - p).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import ops

NUM_CLASSES = 4
N_POSE = 6
N_SHAPE = 10
REGRESSOR_NPOINT = 128
EPS = 1e-5
MOMENTUM = 0.9

# (npoint, radii, nsamples, in_channel, mlps) of the multi-scale layers
SA1 = (512, (0.1, 0.2, 0.4), (32, 64, 128), 5,
       ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
SA2 = (128, (0.4, 0.8), (64, 128), 320, ((128, 128, 256), (128, 196, 256)))
HEAD_SA1 = (REGRESSOR_NPOINT, (0.4, 0.8), (64, 128), NUM_CLASSES,
            ((128, 128, 256), (128, 196, 256)))
SA3 = (512 + 3, (256, 512, 1024))
HEAD_SA2 = (512 + 3, (256, 512))
FP = {"fp3": (512 + 1024, (256, 256)), "fp2": (320 + 256, (256, 128)),
      "fp1": (128, (128, 128, 256))}
DROPOUT = {"classifier": 0.3, "query": 0.1, "regressor": 0.3}


def layout(in_channels: int = 5) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and BatchNorm statistic of TEHNet -> its shape."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{leaf}"] = (c,)

    def conv(name, cin, cout, *k):
        shapes[f"{name}.weight"] = (cout, cin, *k)
        shapes[f"{name}.bias"] = (cout,)

    def msg(prefix, spec):
        _, _, _, cin, mlps = spec
        for i, mlp in enumerate(mlps):
            last = cin + 3
            for j, w in enumerate(mlp):
                conv(f"{prefix}.conv_blocks.{i}.{j}", last, w, 1, 1)
                bn(f"{prefix}.bn_blocks.{i}.{j}", w)
                last = w

    def chain(prefix, cin, mlp, *k):
        for j, w in enumerate(mlp):
            conv(f"{prefix}.mlp_convs.{j}", cin, w, *k)
            bn(f"{prefix}.mlp_bns.{j}", w)
            cin = w

    msg("sa1", SA1[:3] + (in_channels,) + SA1[4:])
    msg("sa2", SA2)
    chain("sa3", *SA3, 1, 1)
    for name, (cin, mlp) in FP.items():
        chain(name, cin, mlp, 1)
    conv("classifier.0", 256, 256, 1)
    bn("classifier.2", 256)
    conv("classifier.4", 256, NUM_CLASSES, 1)
    for side in ("left", "right"):
        q = f"{side}_query_conv"
        conv(f"{q}.0", 256, 256, 3)
        bn(f"{q}.2", 256)
        conv(f"{q}.4", 256, 256, 3)
        bn(f"{q}.5", 256)
        r = f"{side}_mano_regressor"
        msg(f"{r}.sa1", HEAD_SA1)
        chain(f"{r}.sa2", *HEAD_SA2, 1, 1)
        conv(f"{r}.mano_regressor.0", 512, 1024)
        bn(f"{r}.mano_regressor.2", 1024)
        conv(f"{r}.mano_regressor.4", 1024, 3 + N_POSE + N_SHAPE + 3)
    return shapes


def is_statistic(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


class Net:
    """The forward of TEHNet over the state dict ``P`` (parameters and
    running statistics, by name). ``train`` selects the mode; ``generator``
    gives the training draws. ``record``, when a list, receives for each sa1
    scale the selected pairs of each window, ``min(in-radius, K)`` summed
    over the centroids ([B] tensors, in scale order)."""

    def __init__(self, P: Dict[str, torch.Tensor], train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 record: Optional[List] = None):
        self.P = P
        self.train = train
        self.generator = generator
        self.record = record

    # --- layers ---------------------------------------------------------
    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        P = self.P
        if self.train:
            dims = tuple(range(x.dim() - 1))
            n = x.numel() // x.shape[-1]
            mean = x.sum(dim=dims) / n
            var = torch.clamp((x * x).sum(dim=dims) / n - mean * mean, min=0.0)
            with torch.no_grad():
                for key, batch in (("running_mean", mean), ("running_var", var)):
                    r = P[f"{name}.{key}"]
                    r.copy_(MOMENTUM * r + (1 - MOMENTUM) * batch)
        else:
            mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
        return (x - mean) * (torch.rsqrt(var + EPS) * P[f"{name}.weight"]) + P[f"{name}.bias"]

    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return ops.linear(x, self.P[f"{name}.weight"], self.P[f"{name}.bias"])

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if not self.train:
            return x
        keep = 1.0 - p
        u = torch.rand(x.shape, generator=self.generator,
                       device=self.generator.device, dtype=x.dtype).to(x.device)
        return torch.where(u < keep, x / keep, 0.0)

    def msg(self, prefix: str, spec, xyz, points, fps_idx=None, start=None):
        """Multi-scale grouping: FPS centroids, per scale the ball query's
        K neighbors of ``[points, xyz - centroid]`` through conv/BN/ReLU and
        a max over the K slots."""
        npoint, radii, nsamples, _, mlps = spec
        if fps_idx is None:
            fps_idx = ops.farthest_point_sample(xyz, npoint, start)
        new_xyz = ops.index_points(xyz, fps_idx)
        sqrd = ops.square_distance(new_xyz, xyz)
        src = torch.cat([points, xyz], dim=-1)
        D = points.shape[-1]
        outs = []
        for i, (r, k, mlp) in enumerate(zip(radii, nsamples, mlps)):
            if self.record is not None and prefix == "sa1":
                self.record.append(ops.in_radius_counts(r, k, sqrd).sum(-1))
            g = ops.index_points(src, ops.ball_query(r, k, sqrd))   # [B, S, K, D+3]
            x = torch.cat([g[..., :D], g[..., D:] - new_xyz[:, :, None]], dim=-1)
            for j in range(len(mlp)):
                x = torch.relu(self.bn(f"{prefix}.bn_blocks.{i}.{j}",
                                       self.lin(f"{prefix}.conv_blocks.{i}.{j}", x)))
            outs.append(torch.amax(x, dim=2))
        return new_xyz, torch.cat(outs, dim=-1)

    def group_all(self, prefix: str, depth: int, xyz, points):
        x = torch.cat([xyz, points], dim=-1)[:, None]     # raw xyz, then features
        for j in range(depth):
            x = torch.relu(self.bn(f"{prefix}.mlp_bns.{j}", self.lin(f"{prefix}.mlp_convs.{j}", x)))
        return torch.amax(x, dim=2)                        # [B, 1, C]

    def fp(self, prefix: str, xyz1, xyz2, points1, points2):
        if xyz2.shape[1] == 1:
            x = points2.expand(-1, xyz1.shape[1], -1)
        else:
            x = ops.three_nn_interpolate(xyz1, xyz2, points2)
        if points1 is not None:
            x = torch.cat([points1, x], dim=-1)
        for j in range(len(FP[prefix][1])):
            x = torch.relu(self.bn(f"{prefix}.mlp_bns.{j}", self.lin(f"{prefix}.mlp_convs.{j}", x)))
        return x

    def query(self, prefix: str, x):
        P = self.P
        x = torch.relu(ops.conv_k3(x, P[f"{prefix}.0.weight"], P[f"{prefix}.0.bias"]))
        x = self.dropout(self.bn(f"{prefix}.2", x), DROPOUT["query"])
        return self.bn(f"{prefix}.5", ops.conv_k3(x, P[f"{prefix}.4.weight"],
                                                  P[f"{prefix}.4.bias"]))

    def regressor(self, side: str, xyz, features, fps_idx, start):
        r = f"{side}_mano_regressor"
        l1_xyz, l1 = self.msg(f"{r}.sa1", HEAD_SA1, xyz, features, fps_idx, start)
        g = self.group_all(f"{r}.sa2", len(HEAD_SA2[1]), l1_xyz, l1)[:, 0]
        h = self.bn(f"{r}.mano_regressor.2", torch.relu(self.lin(f"{r}.mano_regressor.0", g)))
        out = self.lin(f"{r}.mano_regressor.4", self.dropout(h, DROPOUT["regressor"]))
        return {"global_orient": out[:, :3], "hand_pose": out[:, 3:3 + N_POSE],
                "betas": out[:, 3 + N_POSE:3 + N_POSE + N_SHAPE], "transl": out[:, -3:]}

    # --- the whole net --------------------------------------------------
    def __call__(self, events: torch.Tensor) -> Dict:
        B, N = events.shape[:2]
        xyz = events[..., :3]
        starts: Sequence[Optional[torch.Tensor]] = [None] * 4
        if self.train:
            g = self.generator

            def draw(n):
                return torch.randint(0, n, (B,), generator=g, device=g.device,
                                     dtype=torch.int32).to(events.device)

            starts = [draw(N), draw(SA1[0]), draw(N), draw(N)]
        l1_xyz, l1 = self.msg("sa1", SA1, xyz, events, start=starts[0])
        l2_xyz, l2 = self.msg("sa2", SA2, l1_xyz, l1, start=starts[1])
        l3 = self.group_all("sa3", len(SA3[1]), l2_xyz, l2)
        l3_xyz = torch.zeros((B, 1, 3), dtype=xyz.dtype, device=xyz.device)
        l2 = self.fp("fp3", l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp("fp2", l1_xyz, l2_xyz, l1, l2)
        l0 = self.fp("fp1", xyz, l1_xyz, None, l1)

        h = self.bn("classifier.2", torch.relu(self.lin("classifier.0", l0)))
        seg = self.lin("classifier.4", self.dropout(h, DROPOUT["classifier"]))
        queries = {s: self.query(f"{s}_query_conv", l0) for s in ("left", "right")}
        feats = {s: attention(seg, l0, q) for s, q in queries.items()}
        # eval shares one FPS draw between the heads; training draws a start each
        shared = None if self.train else ops.farthest_point_sample(xyz, REGRESSOR_NPOINT)
        out = {"class_logits": seg}
        for side, start in (("left", starts[2]), ("right", starts[3])):
            out[side] = self.regressor(side, xyz, feats[side], shared, start)
        return out


def attention(key: torch.Tensor, value: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Class-space attention: softmax over the class axis of key^T query
    scaled by C**-0.5 (C the value width), applied to the value."""
    sim = torch.einsum("bnk,bnc->bkc", key, query) * (value.shape[-1] ** -0.5)
    return torch.einsum("bkc,bnc->bnk", torch.softmax(sim, dim=1), value)


def init_state(seed: int, device, in_channels: int = 5) -> Dict[str, torch.Tensor]:
    """Seeded TEHNet weights made on ``device`` in two draws (one normal,
    one uniform) from a generator there: conv and linear weights N(0,
    1/fan_in), the heads' output layer 100x smaller, biases 0.1 N, BatchNorm
    weight 1 + 0.1 N and bias 0.1 N, running mean 0.1 N, running variance
    U[0.5, 1.5]."""
    shapes = layout(in_channels)
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for name, n in zip(names, sizes):
        shape = shapes[name]
        z, u = normal[off:off + n].view(shape), uniform[off:off + n].view(shape)
        off += n
        if name.endswith("running_var"):
            t = 0.5 + u
        elif name.endswith("running_mean") or name.endswith(".bias"):
            t = 0.1 * z
        elif len(shape) == 1:                       # BatchNorm weight
            t = 1.0 + 0.1 * z
        else:
            scale = math.sqrt(1.0 / math.prod(shape[1:]))
            if name.endswith("mano_regressor.4.weight"):
                scale *= 0.01
            t = scale * z
        out[name] = t.clone()
    return out
