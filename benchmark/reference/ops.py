"""Point-cloud operations and the precision switch of the reference."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

_MODE = {"precision": "float32"}


@contextlib.contextmanager
def precision(mode: str):
    """Run the reference in ``mode``: "float32" (TF32 off) or "tf32" (the
    control). On the card the TF32 flags of matmul and cuDNN follow the
    mode; on the CPU "tf32" rounds the operands of ``linear`` and
    ``conv_k3`` to TF32."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"precision {mode!r}: want 'float32' or 'tf32'")
    saved = (_MODE["precision"], torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _MODE["precision"] = mode
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (_MODE["precision"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (TF32), as a
    float32 tensor; the gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def _operands(*ts):
    if _MODE["precision"] == "tf32" and ts[0].device.type == "cpu":
        return [round_tf32(t) for t in ts]
    return list(ts)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution or a linear layer over the last axis of a
    channels-last tensor; ``weight`` in the torch layout [out, in, 1, ...]."""
    x, w = _operands(x, weight.reshape(weight.shape[0], -1))
    return x @ w.t() + bias


def conv_k3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """k=3 SAME convolution along the point axis of [B, N, C]."""
    x, w = _operands(x, weight)
    return F.conv1d(x.transpose(1, 2), w, bias, padding=1).transpose(1, 2)


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[B, N, C] x [B, M, C] -> [B, N, M]: ``-2 <a, b> + |a|^2 + |b|^2``,
    each channel sum taken left to right with elementwise operations, so the
    same coordinates give the same bits on any device."""
    dot = src[:, :, None, 0] * dst[:, None, :, 0]
    for c in range(1, src.shape[-1]):
        dot = dot + src[:, :, None, c] * dst[:, None, :, c]
    d = -2.0 * dot
    d = d + _sum_sq(src)[:, :, None]
    return d + _sum_sq(dst)[:, None, :]


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c] * x[..., c]
    return s


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] -> [B, ..., C]."""
    B = points.shape[0]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(*idx.shape, points.shape[-1])


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy farthest-point sampling [B, N, 3] -> [B, npoint]: the running
    minimum distance starts at 1e10, a distance is ``(dx*dx + dy*dy) +
    dz*dz``, the next point is the first maximum; row b starts at
    ``start[b]`` (default 0)."""
    B, N, _ = xyz.shape
    far = (torch.zeros(B, dtype=torch.long, device=xyz.device) if start is None
           else start.to(device=xyz.device, dtype=torch.long))
    rows = torch.arange(B, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    dist = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.long, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]
        dx, dy, dz = x - c[:, 0:1], y - c[:, 1:2], z - c[:, 2:3]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        far = torch.argmax(dist, dim=-1)
    return out


def ball_query(radius: float, nsample: int, sqrdists: torch.Tensor) -> torch.Tensor:
    """[B, S, N] squared distances -> [B, S, nsample]: each centroid's first
    ``nsample`` in-radius points by index, the slots past the in-radius
    count filled with the first one (N - 1 for an empty ball)."""
    N = sqrdists.shape[-1]
    inside = sqrdists <= radius ** 2
    ar = torch.arange(N, device=sqrdists.device)
    scores = torch.where(inside, ar, N)
    k = min(nsample, N)
    idx = torch.sort(scores, dim=-1).values[..., :k]
    first = idx[..., :1]
    idx = torch.where(idx == N, first, idx)
    if k < nsample:
        idx = torch.cat([idx, first.expand(*idx.shape[:-1], nsample - k)], dim=-1)
    return torch.clamp(idx, max=N - 1)


def in_radius_counts(radius: float, nsample: int, sqrdists: torch.Tensor) -> torch.Tensor:
    """[B, S] ``min(in-radius points, nsample)``: the pairs a scale selects,
    with no backfilled slot."""
    return torch.clamp((sqrdists <= radius ** 2).sum(-1), max=nsample)


def three_nn_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         points2: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weights of the 3 nearest points of xyz2 (first
    minimum on ties, eps 1e-8) applied to points2 -> [B, N, D]."""
    d = square_distance(xyz1, xyz2)
    ar = torch.arange(xyz2.shape[1], device=d.device)
    idxs, ds = [], []
    for _ in range(3):
        i = torch.argmin(d, dim=-1)
        ds.append(torch.amin(d, dim=-1))
        idxs.append(i)
        d = torch.where(ar == i[..., None], torch.inf, d)
    recip = 1.0 / (torch.stack(ds, -1) + 1e-8)
    weight = recip / torch.sum(recip, dim=-1, keepdim=True)
    out = weight[..., 0:1] * index_points(points2, idxs[0])
    for j in (1, 2):
        out = out + weight[..., j:j + 1] * index_points(points2, idxs[j])
    return out
