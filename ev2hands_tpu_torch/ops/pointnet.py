"""Point-cloud ops of the inference and training paths in plain PyTorch,
channels-last.

Counterpart of ``ev2hands_tpu/ops/pointnet.py``. Every function keeps the JAX
package's formula and operand order, so neighbor selection (which compares
squared distances against a radius) picks the same points.

Selection inputs are computed with elementwise ops only, one rounding per
op and no fused multiply-add, so the same coordinates give the same bits on
the CPU and on the card: a matrix product would sum in a device-dependent
order, and a one-ulp difference can flip a point at the radius boundary.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distance, [B, N, C] x [B, M, C] -> [B, N, M].

    ``-2 * <a, b> + |a|^2 + |b|^2`` in the JAX package's order, each sum over
    channels taken left to right."""
    C = src.shape[-1]
    dot = src[:, :, None, 0] * dst[:, None, :, 0]
    for c in range(1, C):
        dot = dot + src[:, :, None, c] * dst[:, None, :, c]
    d = -2.0 * dot
    d = d + _sum_sq(src)[:, :, None]
    d = d + _sum_sq(dst)[:, None, :]
    return d


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c] * x[..., c]
    return s


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: points [B, N, C], idx [B, ...] -> [B, ..., C]."""
    B = points.shape[0]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(
        points, 1, flat[..., None].expand(-1, -1, points.shape[-1])
    )
    return out.reshape(*idx.shape, points.shape[-1])


def query_ball_point(
    radius: float, nsample: int, sqrdists: torch.Tensor, rank: bool = True,
) -> torch.Tensor:
    """Radius neighborhood query from [B, S, N] squared distances ->
    [B, S, nsample] int64 indices: each query's ``nsample`` lowest-index
    in-radius points in ascending order, the slots past the in-radius count
    backfilled with the first one, and N - 1 for a query with no in-radius
    point.

    ``rank=True`` reads the j-th selected index off the inclusive in-radius
    rank (the count of points whose rank is still <= j, a ``searchsorted``
    on the non-decreasing rank); ``rank=False`` takes the ``nsample``
    smallest of the scores ``where(in radius, index, N)``. Both give the
    same indices."""
    B, S, N = sqrdists.shape
    mask = sqrdists <= radius ** 2
    j = torch.arange(nsample, device=sqrdists.device)
    if rank:
        ranks = torch.cumsum(mask, dim=-1)                  # [B, S, N]
        cnt = ranks[..., -1:]
        idx = torch.searchsorted(ranks, j.expand(B, S, nsample).contiguous(),
                                 right=True)
        idx = torch.where(j < cnt, idx, idx[..., :1])
        return torch.clamp(idx, max=N - 1)
    arange = torch.arange(N, device=sqrdists.device)
    scores = torch.where(mask, arange, N)
    k = min(nsample, N)
    idx = torch.topk(scores, k, dim=-1, largest=False, sorted=True).values
    first = idx[..., :1]
    idx = torch.where(idx == N, first, idx)
    if k < nsample:
        idx = torch.cat([idx, first.expand(B, S, nsample - k)], dim=-1)
    return torch.clamp(idx, max=N - 1)


def query_ball_point_permuted(
    radius: float, nsample: int, perm: torch.Tensor, sqrdists_p: torch.Tensor,
) -> torch.Tensor:
    """Ball query over a permuted point axis -> [B, S, nsample] int64
    positions into that axis.

    ``perm`` [B, N] maps a permuted position to its original index;
    ``sqrdists_p`` holds the squared distances with columns in permuted
    order. The selection is ``query_ball_point``'s by original index: the
    score of an in-radius point is its original index (N otherwise), and a
    stable ascending sort puts the ``nsample`` lowest first, ties in
    position order as ``lax.top_k`` leaves them. The positions the scores
    sit at are returned, backfilled with the first one."""
    B, S, N = sqrdists_p.shape
    scores = torch.where(sqrdists_p <= radius ** 2, perm.long()[:, None, :], N)
    vals, pos = torch.sort(scores, dim=-1, stable=True)
    k = min(nsample, N)
    vals, pos = vals[..., :k], pos[..., :k]
    first = pos[..., :1]
    pos = torch.where(vals == N, first, pos)
    if k < nsample:
        pos = torch.cat([pos, first.expand(B, S, nsample - k)], dim=-1)
    return torch.clamp(pos, max=N - 1)


def farthest_point_sample(
    xyz: torch.Tensor, npoint: int, start: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Greedy farthest-point sampling, [B, N, 3] -> [B, npoint] int32.

    The plain version of the FPS kernel (``ops/fps.py``): running min
    distance from 1e10, distance ``(dx*dx + dy*dy) + dz*dz``, next point the
    first maximum. ``start`` [B] gives each row's first index (default 0)."""
    B, N, _ = xyz.shape
    if start is None:
        start = torch.zeros(B, dtype=torch.int32, device=xyz.device)
    far = start.to(device=xyz.device, dtype=torch.long)
    rows = torch.arange(B, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    dist = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]  # [B, 3]
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        far = torch.argmax(dist, dim=-1)
    return out


def group_all(
    xyz: torch.Tensor, points: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One global group: new_xyz is the origin; grouped features are the raw
    (not centred) xyz concatenated with the features, [B, 1, N, 3+D]."""
    B, N, C = xyz.shape
    new_xyz = torch.zeros((B, 1, C), dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None]
    if points is not None:
        grouped = torch.cat([grouped, points[:, None]], dim=-1)
    return new_xyz, grouped


def three_nn_interpolate(
    xyz1: torch.Tensor, xyz2: torch.Tensor, points2: torch.Tensor
) -> torch.Tensor:
    """Inverse-distance-weighted 3-NN interpolation of (xyz2, points2) onto
    xyz1: [B, N, C], [B, S, C], [B, S, D] -> [B, N, D].

    The weighted sum gathers the three neighbors' rows directly (the JAX
    package built a dense one-hot weight matrix for the TPU's matrix unit);
    its backward is ``_Interpolate3``'s."""
    return _Interpolate3.apply(points2, *three_nn(xyz1, xyz2))


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three nearest points of xyz2 [B, S, C] to each of xyz1 [B, N, C]
    and their inverse-distance weights -> (idx [B, N, 3] int64, weight
    [B, N, 3]): three argmin passes with first-minimum tie-break, eps
    1e-8."""
    d = square_distance(xyz1, xyz2)  # [B, N, S]
    S = xyz2.shape[1]
    ar = torch.arange(S, device=d.device)
    idxs, ds = [], []
    for _ in range(3):
        i = torch.argmin(d, dim=-1)
        ds.append(torch.amin(d, dim=-1))
        idxs.append(i)
        d = torch.where(ar == i[..., None], torch.inf, d)
    d3 = torch.stack(ds, -1)  # [B, N, 3]
    recip = 1.0 / (d3 + 1e-8)
    weight = recip / torch.sum(recip, dim=-1, keepdim=True)
    return torch.stack(idxs, -1), weight


class _Interpolate3(torch.autograd.Function):
    """``sum_j weight[..., j] * points2[idx[..., j]]``, points2 [B, S, D],
    idx and weight [B, N, 3] -> [B, N, D], with a backward whose sums run
    in an order fixed by the shapes.

    The forward gathers the three rows. The gradient of ``points2`` is the
    product of the transposed dense weight matrix W [B, N, S] (the JAX
    package's formulation, ``W = sum_j weight_j * onehot(idx_j)``) with the
    cotangent: one batched matrix product. A gather's own backward adds
    each source row's contributions with atomics, in an order that changes
    from run to run on CUDA, and makes the training step irreproducible."""

    @staticmethod
    def forward(ctx, points2, idx, weight):
        ctx.save_for_backward(points2, idx, weight)
        out = weight[..., 0:1] * index_points(points2, idx[..., 0])
        for j in (1, 2):
            out = out + weight[..., j:j + 1] * index_points(points2, idx[..., j])
        return out

    @staticmethod
    def backward(ctx, g):
        points2, idx, weight = ctx.saved_tensors
        g_points = g_weight = None
        if ctx.needs_input_grad[0]:
            ar = torch.arange(points2.shape[1], device=idx.device)
            W = weight[..., 0:1] * (ar == idx[..., 0:1])
            for j in (1, 2):
                W = W + weight[..., j:j + 1] * (ar == idx[..., j:j + 1])
            g_points = W.transpose(1, 2) @ g
        if ctx.needs_input_grad[2]:
            g_weight = torch.stack([(g * index_points(points2, idx[..., j])).sum(-1)
                                    for j in range(3)], dim=-1)
        return g_points, None, g_weight
