"""Event-axis sharding: the event axis N of the dense set-abstraction scales
and of farthest-point sampling split over the ``event`` ranks of a mesh.

Counterpart of ``ev2hands_tpu/parallel/event_parallel.py``. There, each
function is a ``shard_map`` over global arrays; here each rank calls it on
its data rows with every event of them, and the function works on this
event rank's N / E block of the points (``_shard``). The layers around
those functions run alike on every event rank of a data row, so their
outputs are copies; only the quadratic [S, N] pair work and the O(S * N)
FPS scan are divided by E. The collectives, all over the event ranks:

* the global rank of an in-radius point is the local exclusive cumsum plus
  the in-radius counts of the lower shards, from an all-gather of the
  per-shard counts [E, b, S];
* the masked max-pool takes the max over the shards of [b, S, C]
  (``all_max``; in training an all-gather of the per-shard max and min,
  differentiable);
* the empty-neighborhood fallback, point 0's features, lives on shard 0 and
  counts only when no shard saw an in-radius point;
* FPS gathers each shard's best (distance, index) once a step; the lowest
  shard wins ties, which is the first-maximum rule over N. Each rank holds
  every point of its rows, so the centroid's coordinates need no
  collective.

In training (``event_sharded_train_msg_scale``) the BatchNorm statistics
are multiplicity-weighted sums (``weighted_msg_sweeps``) all-reduced over
every rank of the mesh, data and event, as the JAX package's ``stat_axes``.
The event ranks' losses are copies of one: the training step divides its
gradients by E before summing them over every rank (``all_sum_grads``),
which gives the one-device gradient.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ev2hands_tpu_torch.ops.grouping import selection_weights
from ev2hands_tpu_torch.ops.pointnet import square_distance
from ev2hands_tpu_torch.parallel.mesh import (
    EVENT_AXIS,
    WORLD_AXIS,
    Mesh,
    all_gather,
    all_gather_grad,
    all_max,
    all_sum_grad,
    create_event_mesh,
    installed_mesh,
)

__all__ = ["create_event_mesh", "fold_bn_dense", "event_sharded_dense_scale",
           "event_sharded_msg_scale", "event_sharded_fps",
           "event_sharded_train_msg_scale", "weighted_msg_sweeps"]


def fold_bn_dense(kernel: torch.Tensor, bias: torch.Tensor, bn_scale: torch.Tensor,
                  bn_bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """An eval BatchNorm folded into the preceding layer: BN(x W + b) =
    x W' + b' with W' = W * s, b' = (b - mean) * s + bn_bias, s = bn_scale
    / sqrt(var + eps). ``kernel`` is [C_in, C_out]."""
    s = bn_scale * torch.rsqrt(var + eps)
    return kernel * s[None, :], (bias - mean) * s + bn_bias


def _shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This event rank's block of axis 1 (the event axis)."""
    E, N = mesh.event_size, x.shape[1]
    if N % E:
        raise ValueError(f"{N} events do not split over {E} event ranks")
    if mesh.program:
        return torch.ops.ev2hands.event_shard(x, E)
    n = N // E
    return x[:, mesh.event_rank * n:(mesh.event_rank + 1) * n]


def _event_rank(mesh: Mesh, like: torch.Tensor):
    """This event rank: an int, or in an exported program (``mesh.program``)
    the registered op's int64 scalar on ``like``'s device."""
    if mesh.program:
        return torch.ops.ev2hands.event_rank(like, mesh.event_size)
    return mesh.event_rank


def _global_rank(mask: torch.Tensor, mesh: Mesh, dtype) -> Tuple[torch.Tensor,
                                                                   torch.Tensor]:
    """[b, S, n] in-radius mask of this shard -> (the global exclusive rank
    of each in-radius point [b, S, n], the global in-radius count [b, S])."""
    local_rank = torch.cumsum(mask, dim=-1) - mask.long()
    counts = all_gather(mask.sum(dim=-1).to(dtype), mesh, EVENT_AXIS).long()
    lower = torch.arange(counts.shape[0], device=mask.device) < _event_rank(mesh, mask)
    offset = (counts * lower[:, None, None]).sum(dim=0)
    return local_rank + offset[..., None], counts.sum(dim=0)


def _selection(xyz_s: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int, mesh: Mesh):
    """(in-radius mask, selection, global exclusive rank, global count) of
    this shard: the selection is the first ``nsample`` in-radius points by
    global index."""
    mask = square_distance(new_xyz, xyz_s) <= radius * radius
    rank, total = _global_rank(mask, mesh, xyz_s.dtype)
    return mask, mask & (rank < nsample), rank, total


def event_sharded_dense_scale(mesh: Mesh, xyz: torch.Tensor, u: torch.Tensor,
                              new_xyz: torch.Tensor, v: torch.Tensor,
                              W2: torch.Tensor, b2: torch.Tensor, W3: torch.Tensor,
                              b3: torch.Tensor, radius: float,
                              nsample: int) -> torch.Tensor:
    """A dense grouping scale, ``relu(relu(relu(u_n - v_s) W2 + b2) W3 + b3)``
    max-pooled over each centroid's first ``nsample`` in-radius points, with
    the event axis sharded -> [b, S, C3] on every event rank. ``xyz`` [b, N,
    3] and ``u`` [b, N, C1] hold every event of this rank's rows; the
    centroids ``new_xyz`` and ``v`` [b, S, C1] are the same on every event
    rank."""
    xyz_s, u_s = _shard(xyz, mesh), _shard(u, mesh)
    _, sel, _, total = _selection(xyz_s, new_xyz, radius, nsample, mesh)
    z = torch.relu(u_s[:, None] - v[:, :, None])
    h = torch.relu(z @ W2 + b2)
    h = torch.relu(h @ W3 + b3)
    pooled = torch.where(sel[..., None], h, -torch.inf).amax(dim=2)
    fallback = torch.where(((total == 0) & (_event_rank(mesh, total) == 0))[..., None],
                           h[:, :, 0], -torch.inf)
    return all_max(torch.maximum(pooled, fallback), mesh, EVENT_AXIS)


def event_sharded_msg_scale(mesh: Mesh, xyz: torch.Tensor, points: torch.Tensor,
                            new_xyz: torch.Tensor,
                            layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                            radius: float, nsample: int,
                            s_chunk: int = 64) -> torch.Tensor:
    """One dense MSG scale of TEHNet in eval, with the event axis sharded
    -> [b, S, C_last] on every event rank. ``layers`` are the (W [C_in,
    C_out], b) of the chain with eval BatchNorm folded in
    (``fold_bn_dense``). Layer 0 splits as the dense route's does: the
    per-point half u_n = [f_n, x_n] W0 on this shard, the per-centroid half
    v_s = [0, c_s] W0, z = u - v + b0."""
    xyz_s, pts_s = _shard(xyz, mesh), _shard(points, mesh)
    b, S, D = new_xyz.shape[0], new_xyz.shape[1], points.shape[-1]
    _, sel, _, total = _selection(xyz_s, new_xyz, radius, nsample, mesh)
    fb_rows = ((total == 0) & (_event_rank(mesh, total) == 0))[..., None]
    W0, b0 = layers[0]
    u = torch.cat([pts_s, xyz_s], dim=-1) @ W0
    v = torch.cat([xyz.new_zeros(b, S, D), new_xyz], dim=-1) @ W0
    chunk = max(1, min(s_chunk, S))
    outs = []
    for s0 in range(0, S, chunk):
        z = torch.relu(u[:, None] - v[:, s0:s0 + chunk, None] + b0)
        for W, bias in layers[1:]:
            z = torch.relu(z @ W + bias)
        pooled = torch.where(sel[:, s0:s0 + chunk, :, None], z, -torch.inf).amax(dim=2)
        fb = torch.where(fb_rows[:, s0:s0 + chunk], z[:, :, 0], -torch.inf)
        outs.append(torch.maximum(pooled, fb))
    return all_max(torch.cat(outs, dim=1), mesh, EVENT_AXIS)


def event_sharded_fps(mesh: Mesh, xyz: torch.Tensor, npoint: int,
                      start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Farthest-point sampling with the event axis sharded -> [b, npoint]
    int32, the indices of ``ops.pointnet.farthest_point_sample`` (and of the
    FPS kernel) exactly: each rank keeps the running minimum distance of its
    N / E block, in the plain version's formula; a step's next point is the
    largest of the shards' first maxima, the lowest shard on ties, from one
    all-gather of (distance, index) [E, b, 2]. ``start`` [b] is each row's
    first index (default 0). In an exported program the whole loop is one
    registered op, ``torch.ops.ev2hands.event_fps``."""
    if mesh.program:
        return torch.ops.ev2hands.event_fps(xyz, npoint, start, mesh.event_size)
    B, N, _ = xyz.shape
    xyz_s = _shard(xyz, mesh)
    n = xyz_s.shape[1]
    base = _event_rank(mesh, xyz) * n
    if start is None:
        start = torch.zeros(B, dtype=torch.int32, device=xyz.device)
    far = start.to(device=xyz.device, dtype=torch.long)
    rows = torch.arange(B, device=xyz.device)
    x, y, z = xyz_s[..., 0], xyz_s[..., 1], xyz_s[..., 2]
    dist = torch.full((B, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    # the gathered index travels in the distances' dtype: exact below 2^24
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        best = torch.argmax(dist, dim=-1)
        cand = torch.stack([dist[rows, best], (best + base).to(dist.dtype)], dim=-1)
        every = all_gather(cand, mesh, EVENT_AXIS)              # [E, B, 2]
        win = torch.argmax(every[..., 0], dim=0)
        far = every[win, rows, 1].long()
    return out


@torch.library.custom_op("ev2hands::event_fps", mutates_args=())
def event_fps_op(xyz: torch.Tensor, npoint: int, start: Optional[torch.Tensor],
                 size: int) -> torch.Tensor:
    """``event_sharded_fps`` over the installed mesh (``parallel/mesh.py``),
    as one node of an exported program."""
    return event_sharded_fps(installed_mesh(size), xyz, npoint, start)


@event_fps_op.register_fake
def _event_fps_fake(xyz, npoint, start, size):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


def weighted_msg_sweeps(
    u: torch.Tensor, v: torch.Tensor, zb: Optional[torch.Tensor], sel: torch.Tensor,
    w: torch.Tensor, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    finalize: Callable[[int, torch.Tensor, torch.Tensor], Tuple[torch.Tensor,
                                                                torch.Tensor]],
    s_chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The L chunked sweeps of a training MSG scale on the dense route.

    The pre-BN activation of layer 0 at pair (s, n) is ``u_n - v_s (+
    zb)``; layer j >= 1 applies ``relu(a z + b) W_j + b_j`` (``layers``) to
    the previous one, with (a, b) the previous BatchNorm's affine. Sweep l
    sums ``w * z`` and ``w * z^2`` of layer l over every pair, centroid
    chunk by chunk (each chunk checkpointed), and ``finalize(l, wsum,
    wsqsum)`` turns them into layer l's affine. The last sweep also keeps
    the max and min over the selected pairs (``sel``) of the last pre-BN
    layer. -> (max [b, S, C], min [b, S, C], the affines)."""
    S = v.shape[1]
    L = len(layers) + 1
    chunk = max(1, min(s_chunk, S))

    def sweep_chunk(l, s0, *affine):
        z = u[:, None] - v[:, s0:s0 + chunk, None]
        if zb is not None:
            z = z + zb
        for j in range(l):
            W, bias = layers[j]
            z = torch.relu(affine[2 * j] * z + affine[2 * j + 1]) @ W + bias
        wc = w[:, s0:s0 + chunk, :, None]
        sums = ((wc * z).sum(dim=(0, 1, 2)), (wc * (z * z)).sum(dim=(0, 1, 2)))
        if l < L - 1:
            return sums
        m = sel[:, s0:s0 + chunk, :, None]
        return sums + (torch.where(m, z, -torch.inf).amax(dim=2),
                       torch.where(m, z, torch.inf).amin(dim=2))

    affines: List[Tuple[torch.Tensor, torch.Tensor]] = []
    mx, mn = [], []
    for l in range(L):
        flat = [t for ab in affines for t in ab]
        acc_s = acc_q = None
        for s0 in range(0, S, chunk):
            if torch.is_grad_enabled():
                res = checkpoint(sweep_chunk, l, s0, *flat, use_reentrant=False)
            else:
                res = sweep_chunk(l, s0, *flat)
            acc_s = res[0] if acc_s is None else acc_s + res[0]
            acc_q = res[1] if acc_q is None else acc_q + res[1]
            if l == L - 1:
                mx.append(res[2])
                mn.append(res[3])
        affines.append(finalize(l, acc_s, acc_q))
    return torch.cat(mx, dim=1), torch.cat(mn, dim=1), affines


def pool_by_sign(mx: torch.Tensor, mn: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """``relu(a * z + b)`` of the pooled pre-BN extreme: BatchNorm's affine is
    monotone, increasing where a >= 0, so the max of the normalised
    activation is at the max of z there and at its min elsewhere."""
    return F.relu(a * torch.where(a >= 0, mx, mn) + b)


def event_sharded_train_msg_scale(
    mesh: Mesh, xyz: torch.Tensor, points: torch.Tensor, new_xyz: torch.Tensor,
    conv_params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    bn_params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    radius: float, nsample: int, s_chunk: int = 64, eps: float = 1e-5,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """One dense MSG scale in training, event-sharded and differentiable ->
    (pooled [b, S, C_last], [(batch mean, batch var)] a layer; the caller
    moves the running statistics).

    The BatchNorm statistics are the multiplicity-weighted mean and
    variance over the gather route's neighbor multiset
    (``weighted_msg_sweeps``, ``selection_weights`` with the global ranks
    and counts), their sums all-reduced differentiably over every rank of
    the mesh: the event ranks hold the rows' shards, the data ranks the
    other rows. The pool all-gathers each shard's max and min of the last
    pre-BN layer (differentiable) and applies the affine by its sign.
    ``conv_params`` are the raw (W [C_in, C_out], b), ``bn_params`` the
    (scale, bias)."""
    xyz_s, pts_s = _shard(xyz, mesh), _shard(points, mesh)
    b, S, D = new_xyz.shape[0], new_xyz.shape[1], points.shape[-1]
    mask, _, rank, total = _selection(xyz_s, new_xyz, radius, nsample, mesh)
    at0 = (torch.arange(xyz_s.shape[1], device=xyz.device) == 0) & (mesh.event_rank == 0)
    sel, w = selection_weights(mask, rank, total, nsample, at0, xyz.dtype)
    W0, b0 = conv_params[0]
    u = torch.cat([pts_s, xyz_s], dim=-1) @ W0 + b0
    v = torch.cat([xyz.new_zeros(b, S, D), new_xyz], dim=-1) @ W0
    count = b * mesh.data_size * S * nsample
    stats: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def finalize(l, wsum, wsqsum):
        C = wsum.shape[0]
        both = all_sum_grad(torch.cat([wsum, wsqsum]), mesh, WORLD_AXIS)
        mean = both[:C] / count
        var = torch.clamp(both[C:] / count - mean * mean, min=0.0)
        stats.append((mean.detach(), var.detach()))
        scale, shift = bn_params[l]
        a = scale / torch.sqrt(var + eps)
        return a, shift - mean * a

    mx, mn, affines = weighted_msg_sweeps(u, v, None, sel, w, conv_params[1:],
                                          finalize, s_chunk)
    mx = all_gather_grad(mx, mesh, EVENT_AXIS).amax(dim=0)
    mn = all_gather_grad(mn, mesh, EVENT_AXIS).amin(dim=0)
    return pool_by_sign(mx, mn, *affines[-1]), stats
