"""Block-sparse multi-scale grouping: its preparation, the CUDA kernel and
the kernel's plain version.

Counterpart of the parts of ``ev2hands_tpu/ops/pallas_grouping.py`` that the
eval path runs for the large sa1 scales:

* ``fold_scale_params`` folds eval BatchNorm into the three-layer conv chain
  and splits the first layer into a per-point half ``u`` and a
  per-centroid half ``v``: layer one is ``relu(u_n - v_s)``;
* ``dense_selection_mask`` marks each centroid's first ``nsample`` in-radius
  points by original index, with point 0 as the fallback of an empty ball;
* ``morton_perm`` orders the points along a Z-order curve, so a ball covers
  a few contiguous point tiles; ``permute_columns`` and ``tile_activity``
  bring the mask into that order and mark the tiles that hold a selected
  point;
* ``msg_scale_sparse`` pools ``relu(relu(relu(u - v) W2 + b2) W3 + b3)``
  over the selected points of one scale (``msg_scale_sparse_plain`` on a
  CPU tensor);
* ``stack_folded_scales`` and ``msg_fused_scales_sparse`` do the same for
  all scales of a layer in one launch over the union of their tile
  activities, each output section pooled under its own scale's mask
  (``msg_fused_scales_sparse_plain`` on a CPU tensor).

On a CUDA tensor both wrappers launch the block-sparse kernel of
``csrc/msg_dense.cu``, ``msg_scale_sparse`` as its one-scale case. Both go
through registered ops, ``torch.ops.ev2hands.msg_scale_sparse`` and
``torch.ops.ev2hands.msg_fused_scales_sparse`` (the plain version for a CPU
tensor, the kernel for a CUDA one, a shape function for ``torch.export``),
which take the ``FoldedScale`` as its six tensors, so an exported program
keeps each call as one node.

The dense counterparts pool one scale over every point in original order,
with no Morton order and no tile skip. The JAX package keeps them as
measured explorations that no model path calls; they port as ops, each
wrapper named after its Pallas function:

* ``dense_msg_scale_2d`` (``dense_msg_scale_pallas_2d``) and
  ``dense_msg_scale_2d_batched`` (``dense_msg_scale_pallas_2d_batched``)
  take the selection as a mask from ``dense_selection_mask``
  (``dense_msg_scale_2d_plain`` on a CPU tensor);
* ``fused_msg_scale`` (``fused_msg_scale_pallas``) and ``dense_msg_scale``
  (``dense_msg_scale_pallas``) select in the kernel, as
  ``ball_selection_mask`` does from elementwise f32 distances
  (``dense_msg_scale_plain`` on a CPU tensor).

On a CUDA tensor all four launch ``csrc/msg_ball.cu``, one chain on
tensor cores in the 3xTF32 split behind two selection stages: the first
two its mask mode, which reads the mask (any number of rows a centroid,
-1e30 where a row selects nothing), the last two its ball mode. On the
same rows both modes give the same bits, and they agree with the
block-sparse kernel of ``csrc/msg_dense.cu`` within 1e-4 (an f32 FMA
chain), not bitwise. Both kernels take the same widths (``_MAX_WIDTHS``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ev2hands_tpu_torch.ops import _build

# Shared memory a CTA can use on Hopper.
_MAX_SMEM = 232448


class FoldedScale(NamedTuple):
    u: torch.Tensor    # [B, N, C1] per-point first layer (BN folded)
    v: torch.Tensor    # [B, S, C1] per-centroid first layer (BN folded)
    W2: torch.Tensor   # [C1, C2]
    b2: torch.Tensor   # [C2]
    W3: torch.Tensor   # [C2, C3]
    b3: torch.Tensor   # [C3]


def fold_bn_affine(scale, bias, mean, var, eps=1e-5):
    """BN(x) = a*x + c with a = scale/sqrt(var+eps), c = bias - a*mean."""
    a = scale / torch.sqrt(var + eps)
    return a, bias - a * mean


def fold_scale_params(
    points: torch.Tensor, xyz: torch.Tensor, new_xyz: torch.Tensor,
    conv_params: Sequence[dict], bn_params: Sequence[dict], eps: float = 1e-5,
) -> FoldedScale:
    """FoldedScale of one scale from its raw parameters.

    ``conv_params``: three dicts with 'kernel' [in, out] and 'bias';
    ``bn_params``: three dicts with 'scale', 'bias', 'mean', 'var'. The
    first kernel's rows are the feature channels, then x, y, z."""
    c1, c2, c3 = conv_params
    n1, n2, n3 = bn_params
    a1, d1 = fold_bn_affine(n1["scale"], n1["bias"], n1["mean"], n1["var"], eps)
    D = points.shape[-1]
    Wf, Wx = c1["kernel"][:D], c1["kernel"][D:]
    u = points @ Wf + xyz @ Wx
    u = a1 * (u + c1["bias"]) + d1
    v = a1 * (new_xyz @ Wx)
    a2, d2 = fold_bn_affine(n2["scale"], n2["bias"], n2["mean"], n2["var"], eps)
    a3, d3 = fold_bn_affine(n3["scale"], n3["bias"], n3["mean"], n3["var"], eps)
    return FoldedScale(
        u=u, v=v,
        W2=c2["kernel"] * a2[None, :], b2=a2 * c2["bias"] + d2,
        W3=c3["kernel"] * a3[None, :], b3=a3 * c3["bias"] + d3,
    )


def dense_selection_mask(
    sqrdists: torch.Tensor, radius: float, nsample: int
) -> torch.Tensor:
    """[B, S, N] squared distances -> [B, S, N] float32 0/1 mask of the first
    ``nsample`` in-radius points by index, point 0 for an empty ball."""
    return _first_in_radius(sqrdists <= radius * radius, nsample)


def _first_in_radius(mask: torch.Tensor, nsample: int) -> torch.Tensor:
    """[B, S, N] in-radius mask -> [B, S, N] float32 0/1 mask of its first
    ``nsample`` points by index, point 0 for a row with none."""
    rank = torch.cumsum(mask, dim=-1) - mask.long()
    sel = mask & (rank < nsample)
    empty = ~mask.any(dim=-1)
    at0 = torch.arange(mask.shape[-1], device=mask.device) == 0
    sel = sel | (empty[..., None] & at0)
    return sel.float()


def selection_weights(mask: torch.Tensor, rank: torch.Tensor, total: torch.Tensor,
                      nsample: int, at0: torch.Tensor, dtype) -> Tuple[torch.Tensor,
                                                                     torch.Tensor]:
    """The gather route's neighbor multiset as pair weights, for the
    ``dense_train`` statistics -> (selection [B, S, n] bool, weights
    [B, S, n]). ``mask`` is the in-radius mask, ``rank`` each point's
    exclusive rank among the in-radius points of its row, ``total`` [B, S]
    their count, ``at0`` [n] marks point 0 (these may be one shard's, with
    the global ranks and counts). A selected point weighs 1, the first
    in-radius point ``nsample - total`` more when the ball underfills (the
    ball query's backfill), and point 0 ``nsample`` for an empty ball."""
    sel = mask & (rank < nsample)
    first = mask & (rank == 0)
    fallback = (total == 0)[..., None] & at0
    sel = sel | fallback
    w = sel.to(dtype) + first.to(dtype) * torch.clamp(
        nsample - total, min=0)[..., None].to(dtype)
    return sel, torch.where(fallback, float(nsample), w)


def ball_selection_mask(
    xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, nsample: int
) -> torch.Tensor:
    """xyz [B, N, 3], new_xyz [B, S, 3] -> the selection of
    ``dense_selection_mask`` from distances computed as the in-kernel
    selecting TPU kernels do: ``((cx - x)^2 + (cy - y)^2) + (cz - z)^2``
    elementwise in f32, compared with ``radius * radius`` rounded once to
    f32 (as JAX rounds a weak-typed Python scalar). ``square_distance``'s
    expanded formula can put a point on the radius one ulp to the other
    side."""
    d = new_xyz[:, :, None, :] - xyz[:, None, :, :]            # [B, S, N, 3]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=xyz.device)
    return _first_in_radius(d2 <= r2, nsample)


def morton_perm(xyz: torch.Tensor, bits: int = 6) -> torch.Tensor:
    """[B, N, 3] coordinates (about [-1, 1]) -> [B, N] int32 permutation in
    3-D Morton order. The sort key is the packed int32
    ``(morton << idx_bits) | index``, so equal cells keep index order."""
    N = xyz.shape[-2]
    idx_bits = max(1, (N - 1).bit_length())
    bits = min(bits, (31 - idx_bits) // 3)
    if bits < 1:
        raise ValueError(f"N={N} leaves no int32 room for a Morton key")
    hi = (1 << bits) - 1
    q = torch.clamp(((xyz + 1.0) * (0.5 * hi)).to(torch.int32), 0, hi)

    def spread(v):  # two zero bits between each of the low bits
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    key = spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)
    iota = torch.arange(N, dtype=torch.int32, device=xyz.device)
    packed = (key << idx_bits) | iota
    return torch.sort(packed, dim=-1).values & ((1 << idx_bits) - 1)


def permute_columns(sel: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """sel [B, S, N], perm [B, N] -> sel[b, s, perm[b]] (a column gather)."""
    B, S, N = sel.shape
    return torch.gather(sel, 2, perm.long()[:, None, :].expand(B, S, N))


def tile_activity(sel_p: torch.Tensor, nb: int) -> torch.Tensor:
    """sel_p [B, S, N] -> [B, S, N // nb] int32: 1 where the nb-point tile
    holds a selected point."""
    B, S, N = sel_p.shape
    return (sel_p.reshape(B, S, N // nb, nb).amax(dim=-1) > 0.5).to(torch.int32)


def msg_scale_sparse_plain(
    folded: FoldedScale, sel_p: torch.Tensor, act: torch.Tensor, nb: int,
    chunk: int = 64,
) -> torch.Tensor:
    """Plain version of the kernel: the same function over all point pairs,
    masked, in chunks of ``chunk`` centroids -> [B, S, C3]."""
    keep = (sel_p > 0.5) & (act.repeat_interleave(nb, dim=-1) > 0)
    return _pooled_chain(folded, keep, chunk)


def _pooled_chain(folded: FoldedScale, keep: torch.Tensor, chunk: int) -> torch.Tensor:
    """The folded chain of every (point, centroid) pair, max-pooled over the
    points that ``keep`` [B, S, N] marks (-1e30 where it marks none), in
    chunks of ``chunk`` centroids -> [B, S, C3]."""
    u, v = folded.u, folded.v
    outs = []
    for s0 in range(0, v.shape[1], chunk):
        z = torch.relu(u[:, None] - v[:, s0:s0 + chunk, None])
        h = torch.relu(z @ folded.W2 + folded.b2)
        h = torch.relu(h @ folded.W3 + folded.b3)
        m = keep[:, s0:s0 + chunk, :, None]
        outs.append(torch.where(m, h, -1e30).amax(dim=2))
    return torch.cat(outs, dim=1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("msg_dense")
    ints = ctypes.POINTER(ctypes.c_int)
    lib.msg_sparse_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ints] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.msg_sparse_launch.restype = ctypes.c_int
    lib.msg_sparse_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ints]
    lib.msg_sparse_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _ball_lib() -> ctypes.CDLL:
    lib = _build.load("msg_ball")
    lib.msg_ball_plan.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
    lib.msg_ball_plan.restype = ctypes.c_int
    lib.msg_ball_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.msg_ball_launch.restype = ctypes.c_int
    lib.msg_ball_mask_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.msg_ball_mask_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def ball_plan(widths: Tuple[int, int, int], B: int, S: int, N: int, nsample: int,
              tile: int = 0) -> Optional[dict]:
    """The layout of ``csrc/msg_ball.cu`` for these widths, B x S centroids,
    N points and nsample (0: the mask mode): the centroids a CTA (``tile``,
    at most 32, or for 0 the kernel's choice from B and S, the most that
    still fill the SMs; fewer where shared memory is short), whether the
    weights stream through shared memory in panels or stay resident, the
    points of a walk chunk (0 in the mask mode), the shared memory in bytes,
    the rows of a row tile and the rows a centroid's segment holds
    (``capacity``; in the mask mode a pass's, and a centroid that selects
    more takes several passes); None when it does not fit. Cached: callers
    do not edit the dict."""
    info = (ctypes.c_int * 6)()
    if not _ball_lib().msg_ball_plan(*widths, B, S, N, nsample, tile, info):
        return None
    return {"tile": info[0], "streamed": bool(info[1]), "chunk": info[2],
            "smem_bytes": info[3], "rows": info[4], "capacity": info[5]}


# Most scales the block-sparse kernel takes, and the widest (C1, C2, C3) of a
# scale that the chains of csrc/msg_dense.cu and csrc/msg_ball.cu take;
# TEHNet's widest MSG scale is (128, 196, 256).
_MAX_SCALES = 3
_MAX_WIDTHS = (128, 256, 256)


def _widths_fit(widths: Tuple[int, int, int]) -> bool:
    return all(0 < c <= m for c, m in zip(widths, _MAX_WIDTHS))


def _check_inputs(name: str, f: FoldedScale, sel: torch.Tensor, act: torch.Tensor,
                  nb: int, R: int) -> None:
    """Raise unless ``f`` (stacked or one scale), ``sel`` [B, R, S, N] and
    ``act`` [B, S, N // nb] fit each other and the kernel."""
    B, N, C1 = f.u.shape
    S = f.v.shape[1]
    C2, C3 = f.W2.shape[1], f.W3.shape[1]
    want = {"v": (B, S, C1), "W2": (C1, C2), "b2": (C2,), "W3": (C2, C3), "b3": (C3,)}
    for field, shape in want.items():
        t = getattr(f, field)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {field} is {tuple(t.shape)}, want {shape}")
    if nb <= 0 or N % nb:
        raise ValueError(f"{name}: nb={nb} must divide N={N}")
    if tuple(sel.shape) != (B, R, S, N) or tuple(act.shape) != (B, S, N // nb):
        raise ValueError(f"{name}: mask/act shapes do not match u, v and the scales")
    tensors = [f.u, f.v, sel, f.W2, f.b2, f.W3, f.b3]
    if any(t.dtype != torch.float32 or t.device != f.u.device for t in tensors):
        raise ValueError(f"{name}: want float32 tensors on one device")
    if act.dtype != torch.int32 or act.device != f.u.device:
        raise ValueError(f"{name}: act must be int32 on the same device")


def _launch(name: str, f: FoldedScale, sel: torch.Tensor, act: torch.Tensor,
            nb: int, widths: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
    """Run the kernel on inputs ``_check_inputs`` accepted; ``widths`` holds
    each scale's (C1, C2, C3), the kernel's block bounds."""
    B, N, C1t = f.u.shape
    S = f.v.shape[1]
    R = len(widths)
    lib = _lib()
    c_widths = (ctypes.c_int * (3 * R))(*[c for w in widths for c in w])
    if lib.msg_sparse_smem_bytes(N, R, c_widths) > _MAX_SMEM:
        raise ValueError(f"{name}: widths {tuple(widths)} at N={N} exceed the "
                         "kernel's shared memory")
    u, v, sel_c, W2, b2, W3, b3 = (
        t.contiguous() for t in (f.u, f.v, sel, f.W2, f.b2, f.W3, f.b3))
    act_c = act.contiguous()
    out = torch.empty((B, S, f.W3.shape[1]), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.msg_sparse_launch(
            u.data_ptr(), v.data_ptr(), sel_c.data_ptr(), act_c.data_ptr(),
            W2.data_ptr(), b2.data_ptr(), W3.data_ptr(), b3.data_ptr(),
            out.data_ptr(), c_widths, B, S, N, R, nb, C1t,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def msg_scale_sparse(
    folded: FoldedScale, sel_p: torch.Tensor, act: torch.Tensor, nb: int
) -> torch.Tensor:
    """-> [B, S, C3] pooled features of one scale. ``folded.u`` rows and
    ``sel_p`` columns in Morton order, ``act`` from ``tile_activity``.
    Calls the registered op ``torch.ops.ev2hands.msg_scale_sparse``."""
    return msg_scale_sparse_op(*folded, sel_p, act, nb)


msg_scale_sparse.launches = 0


@torch.library.custom_op("ev2hands::msg_scale_sparse", mutates_args=(),
                         device_types="cpu")
def msg_scale_sparse_op(
    u: torch.Tensor, v: torch.Tensor, W2: torch.Tensor, b2: torch.Tensor,
    W3: torch.Tensor, b3: torch.Tensor, sel_p: torch.Tensor, act: torch.Tensor,
    nb: int,
) -> torch.Tensor:
    """``msg_scale_sparse`` with the ``FoldedScale`` as its six tensors:
    the plain version on the CPU, the kernel on the card."""
    return msg_scale_sparse_plain(FoldedScale(u, v, W2, b2, W3, b3), sel_p, act, nb)


@msg_scale_sparse_op.register_kernel("cuda")
def _msg_scale_sparse_cuda(u, v, W2, b2, W3, b3, sel_p, act, nb):
    folded = FoldedScale(u, v, W2, b2, W3, b3)
    C1, C2, C3 = W2.shape[0], W2.shape[1], W3.shape[1]
    if not _widths_fit((C1, C2, C3)):
        raise ValueError(f"msg_scale_sparse: widths {(C1, C2, C3)} exceed the "
                         f"kernel's {_MAX_WIDTHS}")
    sel = sel_p[:, None]   # [B, 1, S, N]: the kernel's one-scale mask
    _check_inputs("msg_scale_sparse", folded, sel, act, nb, 1)
    out = _launch("msg_scale_sparse", folded, sel, act, nb, [(C1, C2, C3)])
    msg_scale_sparse.launches += 1
    return out


@msg_scale_sparse_op.register_fake
def _msg_scale_sparse_fake(u, v, W2, b2, W3, b3, sel_p, act, nb):
    return u.new_empty((u.shape[0], v.shape[1], W3.shape[1]))


def stack_folded_scales(
    folded_list: Sequence[FoldedScale],
) -> Tuple[FoldedScale, Tuple[int, ...], Tuple[Tuple[int, int], ...]]:
    """Per-scale ``FoldedScale`` -> (one stacked scale, the C3 width of each
    scale's output section, each scale's (C1, C2) block widths).

    ``u``, ``v`` and the biases concatenate along the features; ``W2`` and
    ``W3`` become block-diagonal, so the stacked chain computes every scale
    at once and its off-diagonal zeros add exact +0.0 terms. The block
    widths let the kernel visit only the diagonal blocks."""
    C1s = [f.W2.shape[0] for f in folded_list]
    C2s = [f.W2.shape[1] for f in folded_list]
    C3s = [f.W3.shape[1] for f in folded_list]
    stacked = FoldedScale(
        u=torch.cat([f.u for f in folded_list], dim=-1),
        v=torch.cat([f.v for f in folded_list], dim=-1),
        W2=torch.block_diag(*[f.W2 for f in folded_list]),
        b2=torch.cat([f.b2 for f in folded_list]),
        W3=torch.block_diag(*[f.W3 for f in folded_list]),
        b3=torch.cat([f.b3 for f in folded_list]),
    )
    return stacked, tuple(C3s), tuple(zip(C1s, C2s))


def msg_fused_scales_sparse_plain(
    stacked: FoldedScale, sel_all: torch.Tensor, act: torch.Tensor,
    sections: Sequence[int], nb: int, chunk: int = 64,
) -> torch.Tensor:
    """Plain version of the fused kernel: the stacked chain over all point
    pairs, column section r masked by scale r's selection inside the union
    active tiles, in chunks of ``chunk`` centroids -> [B, S, sum(sections)]."""
    u, v = stacked.u, stacked.v
    S = v.shape[1]
    tiles = act.repeat_interleave(nb, dim=-1) > 0                 # [B, S, N]
    # col_scale[c]: the scale whose section holds output column c
    col_scale = torch.repeat_interleave(
        torch.arange(len(sections), device=u.device),
        torch.as_tensor(sections, device=u.device))
    outs = []
    for s0 in range(0, S, chunk):
        z = torch.relu(u[:, None] - v[:, s0:s0 + chunk, None])
        h = torch.relu(z @ stacked.W2 + stacked.b2)
        h = torch.relu(h @ stacked.W3 + stacked.b3)
        keep = (sel_all[:, :, s0:s0 + chunk] > 0.5) & tiles[:, None, s0:s0 + chunk]
        m = keep.permute(0, 2, 3, 1)[..., col_scale]
        outs.append(torch.where(m, h, -1e30).amax(dim=2))
    return torch.cat(outs, dim=1)


def msg_fused_scales_sparse(
    stacked: FoldedScale, sel_all: torch.Tensor, act: torch.Tensor,
    sections: Sequence[int], nb: int, blocks: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """-> [B, S, sum(sections)] pooled features of every scale of a layer, in
    the layer's concatenation order. ``stacked`` and ``blocks`` from
    ``stack_folded_scales`` (``u`` rows in Morton order), ``sel_all``
    [B, R, S, N] the per-scale masks with Morton columns, ``act`` the union
    of the scales' ``tile_activity``. Calls the registered op
    ``torch.ops.ev2hands.msg_fused_scales_sparse``, ``blocks`` flattened."""
    return msg_fused_scales_sparse_op(
        *stacked, sel_all, act, [int(c) for c in sections], nb,
        [int(c) for block in blocks for c in block])


msg_fused_scales_sparse.launches = 0


@torch.library.custom_op("ev2hands::msg_fused_scales_sparse", mutates_args=(),
                         device_types="cpu")
def msg_fused_scales_sparse_op(
    u: torch.Tensor, v: torch.Tensor, W2: torch.Tensor, b2: torch.Tensor,
    W3: torch.Tensor, b3: torch.Tensor, sel_all: torch.Tensor, act: torch.Tensor,
    sections: List[int], nb: int, blocks: List[int],
) -> torch.Tensor:
    """``msg_fused_scales_sparse`` with the stacked ``FoldedScale`` as its
    six tensors and ``blocks`` as the flat list C1, C2 of each scale: the
    plain version on the CPU, the kernel on the card."""
    return msg_fused_scales_sparse_plain(
        FoldedScale(u, v, W2, b2, W3, b3), sel_all, act, sections, nb)


@msg_fused_scales_sparse_op.register_kernel("cuda")
def _msg_fused_scales_sparse_cuda(u, v, W2, b2, W3, b3, sel_all, act, sections,
                                  nb, blocks):
    stacked = FoldedScale(u, v, W2, b2, W3, b3)
    R = len(sections)
    if not 1 <= R <= _MAX_SCALES or len(blocks) != 2 * R:
        raise ValueError(f"msg_fused_scales_sparse: {R} sections and "
                         f"{len(blocks) / 2:g} blocks; want 1 to {_MAX_SCALES} of each")
    widths = [(blocks[2 * r], blocks[2 * r + 1], sections[r]) for r in range(R)]
    if (tuple(sum(w[i] for w in widths) for i in range(3))
            != (W2.shape[0], W2.shape[1], W3.shape[1])
            or not all(_widths_fit(w) for w in widths)):
        raise ValueError(f"msg_fused_scales_sparse: blocks {tuple(blocks)} and sections "
                         f"{tuple(sections)} do not fit the stacked weights or the "
                         f"kernel (each scale at most {_MAX_WIDTHS})")
    _check_inputs("msg_fused_scales_sparse", stacked, sel_all, act, nb, R)
    out = _launch("msg_fused_scales_sparse", stacked, sel_all, act, nb, widths)
    msg_fused_scales_sparse.launches += 1
    return out


@msg_fused_scales_sparse_op.register_fake
def _msg_fused_scales_sparse_fake(u, v, W2, b2, W3, b3, sel_all, act, sections,
                                  nb, blocks):
    return u.new_empty((u.shape[0], v.shape[1], sum(sections)))


def dense_msg_scale_2d_plain(
    folded: FoldedScale, sel: torch.Tensor, chunk: int = 64
) -> torch.Tensor:
    """Plain version of the mask mode: ``sel`` [B, S, N] (original point
    order, the fallback already in it) -> [B, S, C3], -1e30 for a row that
    selects nothing."""
    return _pooled_chain(folded, sel > 0.5, chunk)


def dense_msg_scale_plain(
    xyz: torch.Tensor, new_xyz: torch.Tensor, folded: FoldedScale,
    radius: float, nsample: int, chunk: int = 64,
) -> torch.Tensor:
    """Plain version of the ball mode -> [B, S, C3]: the
    chain pooled over ``ball_selection_mask``, so an empty ball pools point
    0's chain."""
    return _pooled_chain(
        folded, ball_selection_mask(xyz, new_xyz, radius, nsample) > 0.5, chunk)


def _check_blocks(name: str, S: int, sb: int, N: Optional[int] = None,
                  nb: Optional[int] = None) -> None:
    """Raise where the Pallas function's assert on its block sizes fires."""
    if sb <= 0 or S % sb or (nb is not None and (nb <= 0 or N % nb)):
        raise ValueError(f"{name}: want S % sb == 0 and N % nb == 0, got S={S}, "
                         f"sb={sb}, N={N}, nb={nb}")


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    """True on the CPU (plain version), False on a CUDA device (kernel)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cpu"


def _dense_operands(name: str, f: FoldedScale, extra: dict):
    """Check ``f`` and the ``extra`` tensors (name -> (tensor, wanted
    shape)) against the dense kernels -> the contiguous operands by name."""
    B, N, C1 = f.u.shape
    S = f.v.shape[1]
    C2, C3 = f.W2.shape[1], f.W3.shape[1]
    want = {"v": (B, S, C1), "W2": (C1, C2), "b2": (C2,), "W3": (C2, C3), "b3": (C3,)}
    named = {**f._asdict(), **{k: t for k, (t, _) in extra.items()}}
    want.update({k: shape for k, (_, shape) in extra.items()})
    for field, shape in want.items():
        if tuple(named[field].shape) != shape:
            raise ValueError(f"{name}: {field} is {tuple(named[field].shape)}, want {shape}")
    if any(t.dtype != torch.float32 or t.device != f.u.device for t in named.values()):
        raise ValueError(f"{name}: want float32 tensors on one device")
    if not _widths_fit((C1, C2, C3)):
        raise ValueError(f"{name}: widths {(C1, C2, C3)} exceed the kernel's "
                         f"{_MAX_WIDTHS}")
    return {k: t.contiguous() for k, t in named.items()}


def _launch_mask(name: str, f: FoldedScale, sel: torch.Tensor,
                 tile: int = 0) -> torch.Tensor:
    """The mask mode of ``csrc/msg_ball.cu`` at ``tile`` centroids a CTA
    (0, the kernel's choice, for the wrappers; chip_smoke.py's sweep sets
    others)."""
    B, N, C1 = f.u.shape
    S = f.v.shape[1]
    C2, C3 = f.W2.shape[1], f.W3.shape[1]
    t = _dense_operands(name, f, {"sel": (sel, (B, S, N))})
    if ball_plan((C1, C2, C3), B, S, N, 0, tile) is None:
        raise ValueError(f"{name}: N={N} at tile {tile} does not fit the kernel")
    out = torch.empty((B, S, C3), dtype=torch.float32, device=f.u.device)
    with torch.cuda.device(out.device):
        err = _ball_lib().msg_ball_mask_launch(
            *(t[k].data_ptr() for k in ("sel", "u", "v", "W2", "b2", "W3", "b3")),
            out.data_ptr(), B, S, N, C1, C2, C3, tile,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _launch_ball(name: str, xyz: torch.Tensor, new_xyz: torch.Tensor,
                 f: FoldedScale, radius: float, nsample: int,
                 tile: int = 0) -> torch.Tensor:
    """The ball mode of ``csrc/msg_ball.cu`` at ``tile`` centroids a CTA
    (0, the kernel's choice, for the wrappers; chip_smoke.py's sweep sets
    others)."""
    B, N, C1 = f.u.shape
    S = f.v.shape[1]
    C2, C3 = f.W2.shape[1], f.W3.shape[1]
    t = _dense_operands(
        name, f, {"xyz": (xyz, (B, N, 3)), "new_xyz": (new_xyz, (B, S, 3))})
    if ball_plan((C1, C2, C3), B, S, N, nsample, tile) is None:
        raise ValueError(f"{name}: N={N}, nsample={nsample} do not fit the kernel's "
                         f"shared memory")
    out = torch.empty((B, S, C3), dtype=torch.float32, device=f.u.device)
    with torch.cuda.device(out.device):
        err = _ball_lib().msg_ball_launch(
            *(t[k].data_ptr() for k in ("xyz", "new_xyz", "u", "v", "W2", "b2", "W3", "b3")),
            out.data_ptr(), B, S, N, C1, C2, C3,
            radius * radius,   # ctypes rounds it once to f32
            nsample, tile, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _check_nsample(name: str, nsample: int) -> None:
    if nsample < 1:
        raise ValueError(f"{name}: nsample={nsample}, want at least 1")


def dense_msg_scale_2d(folded: FoldedScale, sel: torch.Tensor, sb: int = 8) -> torch.Tensor:
    """-> [B, S, C3] pooled features of one scale from the mask ``sel``
    [B, S, N] of ``dense_selection_mask`` (original point order).
    Counterpart of ``dense_msg_scale_pallas_2d``; ``sb`` is its centroid
    block, checked as it asserts it."""
    _check_blocks("dense_msg_scale_2d", folded.v.shape[1], sb)
    if _on_cpu("dense_msg_scale_2d", folded.u):
        return dense_msg_scale_2d_plain(folded, sel)
    out = _launch_mask("dense_msg_scale_2d", folded, sel)
    dense_msg_scale_2d.launches += 1
    return out


dense_msg_scale_2d.launches = 0


def dense_msg_scale_2d_batched(
    folded: FoldedScale, sel: torch.Tensor, sb: int = 4
) -> torch.Tensor:
    """The same function as ``dense_msg_scale_2d``. Counterpart of
    ``dense_msg_scale_pallas_2d_batched``, which on the TPU gathered a
    block's pairs into one scratch matrix; here it launches the same
    kernel, the mask mode of ``csrc/msg_ball.cu``."""
    _check_blocks("dense_msg_scale_2d_batched", folded.v.shape[1], sb)
    if _on_cpu("dense_msg_scale_2d_batched", folded.u):
        return dense_msg_scale_2d_plain(folded, sel)
    out = _launch_mask("dense_msg_scale_2d_batched", folded, sel)
    dense_msg_scale_2d_batched.launches += 1
    return out


dense_msg_scale_2d_batched.launches = 0


def fused_msg_scale(
    xyz: torch.Tensor, new_xyz: torch.Tensor, folded: FoldedScale,
    radius: float, nsample: int, sb: int = 8, nb: int = 512,
) -> torch.Tensor:
    """-> [B, S, C3] pooled features of one scale over the first ``nsample``
    points by index within ``radius`` of each centroid, point 0's chain for
    an empty ball; the selection in the kernel. Counterpart of
    ``fused_msg_scale_pallas``; ``sb`` and ``nb`` are its blocks, checked as
    it asserts them."""
    _check_blocks("fused_msg_scale", new_xyz.shape[1], sb, xyz.shape[1], nb)
    _check_nsample("fused_msg_scale", nsample)
    if _on_cpu("fused_msg_scale", folded.u):
        return dense_msg_scale_plain(xyz, new_xyz, folded, radius, nsample)
    out = _launch_ball("fused_msg_scale", xyz, new_xyz, folded, radius, nsample)
    fused_msg_scale.launches += 1
    return out


fused_msg_scale.launches = 0


def dense_msg_scale(
    xyz: torch.Tensor, new_xyz: torch.Tensor, folded: FoldedScale,
    radius: float, nsample: int, sb: int = 32, nb: int = 256,
) -> torch.Tensor:
    """The same function as ``fused_msg_scale``. Counterpart of
    ``dense_msg_scale_pallas``, whose 3-D tiles blend point 0's chain into
    an empty ball's result; here it launches the same kernel."""
    _check_blocks("dense_msg_scale", new_xyz.shape[1], sb, xyz.shape[1], nb)
    _check_nsample("dense_msg_scale", nsample)
    if _on_cpu("dense_msg_scale", folded.u):
        return dense_msg_scale_plain(xyz, new_xyz, folded, radius, nsample)
    out = _launch_ball("dense_msg_scale", xyz, new_xyz, folded, radius, nsample)
    dense_msg_scale.launches += 1
    return out


dense_msg_scale.launches = 0
