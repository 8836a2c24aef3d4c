"""Two-hand mesh collision: candidate pairs, an exact triangle-triangle
test, the differentiable penetration loss and the share of colliding
triangles that evaluation scores, in plain PyTorch.

Counterpart of ``ev2hands_tpu/ops/collision.py``. The two MANO meshes have
a fixed topology (2 x 1538 faces), so a dense AABB broad phase over all
[T, T] triangle pairs keeps the ``max_pairs`` deepest overlaps per sample,
a separating-axis test confirms the real intersections, and a conical
distance field penalises the vertices behind the other triangle's plane.
Pairs of triangles that share a mesh vertex are excluded.

The pair selection is the JAX package's two-stage top-k: the 2 * max_pairs
rows with the largest row maximum, then the ``max_pairs`` largest scores
of those rows, each ordered with equal values by ascending index as
``lax.top_k`` orders them. ``torch.topk`` promises no order among equal
values, so both stages take a stable descending sort and slice it. The
rows are read by index, not by the JAX package's one-hot matrix product:
the same values. Selection carries no gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ev2hands_tpu_torch.parallel.mesh import DATA_AXIS, all_sum


def build_two_hand_faces(faces_left: np.ndarray, faces_right: np.ndarray,
                         n_verts: int = 778) -> np.ndarray:
    """The two hands' faces in one list, the right hand's vertex indices
    offset by ``n_verts``."""
    return np.concatenate([faces_left, faces_right + n_verts], 0).astype(np.int64)


def build_adjacency_mask(faces: np.ndarray) -> np.ndarray:
    """[T, T] bool: the triangle pairs that share at least one vertex
    (self-pairs included)."""
    T = faces.shape[0]
    shares = np.zeros((T, T), bool)
    for k in range(3):
        for l in range(3):
            shares |= faces[:, k][:, None] == faces[None, :, l]
    return shares


class CollisionPairs(NamedTuple):
    pairs: torch.Tensor         # [B, K, 2] int64 triangle indices
    intersecting: torch.Tensor  # [B, K] bool: confirmed intersections


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (size 3), written out."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, equal values by ascending index
    (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def find_collision_pairs(
    triangles: torch.Tensor,   # [B, T, 3, 3]
    adjacency: torch.Tensor,   # [T, T] bool
    max_pairs: int,
) -> CollisionPairs:
    """AABB broad phase -> the ``max_pairs`` deepest candidates -> exact
    separating-axis test, per sample."""
    B, T = triangles.shape[:2]
    lo = triangles.amin(dim=-2)   # [B, T, 3]
    hi = triangles.amax(dim=-2)
    # per-axis interval overlap; its minimum over the axes is the AABB
    # overlap depth (negative: separated)
    depth = None
    for a in range(3):
        d = (torch.minimum(hi[:, :, None, a], hi[:, None, :, a])
             - torch.maximum(lo[:, :, None, a], lo[:, None, :, a]))
        depth = d if depth is None else torch.minimum(depth, d)
    keep = torch.ones((T, T), dtype=torch.bool, device=triangles.device).triu(1)
    keep = keep & ~adjacency
    # depth 0 (touching boxes, flat triangles) stays; the exact test below
    # rejects the false positives. A finite sentinel keeps sums NaN-free.
    neg = -1e30
    score = torch.where(keep & (depth >= 0), depth, neg)
    del depth

    R = min(2 * max_pairs, T)
    _, top_rows = _top(score.amax(dim=2), R)                  # [B, R]
    sub = torch.gather(score, 1, top_rows[..., None].expand(B, R, T))
    top, idx = _top(sub.reshape(B, R * T), max_pairs)
    pairs = torch.stack([torch.gather(top_rows, 1, idx // T), idx % T], dim=-1)
    candidate = top > neg * 0.5

    rows = torch.arange(B, device=triangles.device)[:, None]
    hit = tri_tri_intersect(triangles[rows, pairs[..., 0]],
                            triangles[rows, pairs[..., 1]]) & candidate
    return CollisionPairs(pairs=pairs, intersecting=hit)


def tri_tri_intersect(tri_a: torch.Tensor, tri_b: torch.Tensor,
                      eps: float = 1e-12) -> torch.Tensor:
    """Exact triangle-triangle intersection by the separating-axis theorem,
    tri_a, tri_b [..., 3, 3] -> [...] bool. Candidate axes: both normals,
    the 9 edge-edge cross products and the 6 in-plane edge normals (the
    coplanar case); near-zero axes are skipped."""
    ea = tri_a - torch.roll(tri_a, -1, dims=-2)
    eb = tri_b - torch.roll(tri_b, -1, dims=-2)
    n_a = _cross(ea[..., 0, :], ea[..., 1, :])[..., None, :]
    n_b = _cross(eb[..., 0, :], eb[..., 1, :])[..., None, :]
    cross_axes = _cross(ea[..., :, None, :], eb[..., None, :, :]).reshape(
        *tri_a.shape[:-2], 9, 3)
    inplane_a = _cross(n_a.expand(ea.shape), ea)
    inplane_b = _cross(n_b.expand(eb.shape), eb)
    axes = torch.cat([n_a, n_b, cross_axes, inplane_a, inplane_b], dim=-2)

    pa = torch.einsum("...kc,...vc->...kv", axes, tri_a)    # [..., 17, 3]
    pb = torch.einsum("...kc,...vc->...kv", axes, tri_b)
    sep = ((pa.amin(-1) > pb.amax(-1) + eps)
           | (pb.amin(-1) > pa.amax(-1) + eps))
    degenerate = (axes ** 2).sum(-1) < eps
    return ~(sep & ~degenerate).any(dim=-1)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for x [B, R, ...] and idx [B, K] -> [B, K, ...],
    with a backward that sums repeated rows in a fixed order on both
    devices: advanced indexing on the card (its backward, index_put with
    accumulate, sorts the indices), ``torch.gather`` on the CPU (its
    backward, scatter_add, sums each destination serially; the CPU's
    index_put accumulates with atomics across threads)."""
    if x.is_cuda:
        return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]
    tail = x.shape[2:]
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * len(tail))).expand(
        *idx.shape, *tail))


def penetration_penalty(
    triangles: torch.Tensor,   # [B, T, 3, 3]
    pairs: torch.Tensor,       # [B, K, 2]
    active: torch.Tensor,      # [B, K] bool
    sigma: float = 0.5,
) -> torch.Tensor:
    """Differentiable conical distance-field penetration per pair, [B, K]:
    each vertex of B behind A's plane contributes
    ``relu(-(v - c_A).n_A) * exp(-|v - c_A|^2 / (2 sigma^2))``, plus the
    symmetric term; vertices in front contribute nothing."""
    tri_a = take_rows(triangles, pairs[..., 0])   # [B, K, 3, 3]
    tri_b = take_rows(triangles, pairs[..., 1])

    def field(src, pts):
        c = src.mean(dim=-2, keepdim=True)
        n = _cross(src[..., 1, :] - src[..., 0, :], src[..., 2, :] - src[..., 0, :])
        # sqrt(x + 1e-20) keeps the gradient of a zero-area triangle's normal
        # finite: an infinite one would reach the masked pairs as 0 * inf
        n = n / torch.sqrt((n ** 2).sum(-1, keepdim=True) + 1e-20)
        d = pts - c
        behind = torch.relu(-torch.einsum("...vc,...c->...v", d, n))
        radial = torch.exp(-(d ** 2).sum(-1) / (2.0 * sigma ** 2))
        return (behind * radial).sum(-1)

    pen = field(tri_a, tri_b) + field(tri_b, tri_a)
    return torch.where(active, pen, 0.0)


def collision_loss(
    verts_left: torch.Tensor,    # [B, V, 3]
    verts_right: torch.Tensor,   # [B, V, 3]
    faces: torch.Tensor,         # [2F, 3] two-hand faces
    adjacency: torch.Tensor,     # [2F, 2F] bool
    max_pairs: int = 128,
    sigma: float = 0.5,
    weight: float = 1e2,
    mesh=None,
) -> torch.Tensor:
    """The mean positive penetration over the batch's colliding pairs,
    times ``weight``; 0 when nothing collides. Under a data mesh
    (``parallel/mesh.py``), this rank's share: its sum over the global
    batch's count of positive penetrations."""
    verts = torch.cat([verts_left, verts_right], dim=1)   # [B, 2V, 3]
    if verts.is_cuda:
        triangles = verts[:, faces]                         # [B, T, 3, 3]
    else:
        B, T = verts.shape[0], faces.shape[0]
        triangles = take_rows(verts, faces.reshape(1, -1).expand(B, -1)).reshape(
            B, T, 3, 3)
    cp = find_collision_pairs(triangles.detach(), adjacency, max_pairs)
    pen = penetration_penalty(triangles, cp.pairs, cp.intersecting, sigma)
    count = all_sum((pen > 0).sum().to(pen.dtype), mesh, DATA_AXIS)
    return torch.where(count > 0, pen.sum() / torch.clamp(count, min=1.0) * weight,
                       0.0)


@torch.no_grad()
def collision_percentage(
    verts_left: torch.Tensor,    # [B, V, 3]
    verts_right: torch.Tensor,   # [B, V, 3]
    faces: torch.Tensor,         # [2F, 3] two-hand faces
    adjacency: torch.Tensor,     # [2F, 2F] bool
    max_pairs: int = 256,
) -> torch.Tensor:
    """[B] percentage of the two-hand triangles that take part in at least
    one confirmed intersection among the ``max_pairs`` candidates; the
    non-collision score of an evaluation is 100 minus this."""
    verts = torch.cat([verts_left, verts_right], dim=1)
    triangles = verts[:, faces]
    B, T = triangles.shape[:2]
    cp = find_collision_pairs(triangles, adjacency, max_pairs)
    hit = cp.intersecting.to(verts.dtype)
    flags = torch.zeros((B, T), dtype=verts.dtype, device=verts.device)
    for side in range(2):
        flags.scatter_reduce_(1, cp.pairs[..., side], hit, reduce="amax")
    return flags.sum(dim=-1) / T * 100.0
