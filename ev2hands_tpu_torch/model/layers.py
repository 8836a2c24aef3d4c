"""PointNet++ building blocks of TEHNet, channels-last ``[B, N, C]``, in
eval and in training.

Counterpart of ``ev2hands_tpu/model/layers.py``. Parameters carry the
reference's torch names and shapes (``conv_blocks.i.j`` Conv2d 1x1,
``mlp_convs.j``, BatchNorm ``weight``/``bias``/``running_mean``/
``running_var``), so a state dict from ``weights.flax_to_torch`` or the
reference loads with ``strict=True``.

Training follows the JAX package, which this port is held against:
BatchNorm normalises with the biased batch variance and moves its running
statistics flax's way (the biased variance for both, where torch's own
BatchNorm stores the unbiased one); dropout draws from an explicit
``torch.Generator``, never the global one; the set-abstraction layers
group by gathering each centroid's selected neighbors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ev2hands_tpu_torch.ops.fps import fps_unchecked
from ev2hands_tpu_torch.ops.gather import grouped_gather, pos_tile_activity
from ev2hands_tpu_torch.ops.grouping import (
    dense_selection_mask,
    fold_scale_params,
    morton_perm,
    msg_fused_scales_sparse,
    msg_scale_sparse,
    permute_columns,
    selection_weights,
    stack_folded_scales,
    tile_activity,
)
from ev2hands_tpu_torch.ops.pointnet import (
    group_all,
    index_points,
    query_ball_point,
    query_ball_point_permuted,
    square_distance,
    three_nn_interpolate,
)
from ev2hands_tpu_torch.parallel.event_parallel import (
    event_sharded_fps,
    event_sharded_msg_scale,
    event_sharded_train_msg_scale,
    fold_bn_dense,
    pool_by_sign,
    weighted_msg_sweeps,
)
from ev2hands_tpu_torch.parallel.mesh import DATA_AXIS, all_sum_grad, global_rand

# Smallest S*N that takes the block-sparse grouping kernel: the sa1 scales
# (512 centroids over 2048 points); sa2 and the regressor heads stay dense.
SPARSE_MIN_PAIRS = 512 * 2048


class Pointwise(nn.Module):
    """A 1x1 convolution (``dims`` = 2 for Conv2d, 1 for Conv1d) or a linear
    layer (``dims`` = 0) applied over the last axis of a channels-last
    tensor. ``weight`` has the torch layout [out, in, 1, ...]."""

    # compute in bfloat16 in training / in eval (``set_precision``)
    bf16_train = False
    bf16_eval = False

    def __init__(self, in_ch: int, out_ch: int, dims: int, device="cuda"):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros((out_ch, in_ch) + (1,) * dims, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    @property
    def kernel(self) -> torch.Tensor:
        """The weight as an [in, out] matrix."""
        return self.weight.reshape(self.weight.shape[0], -1).t()

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """``x @ kernel + bias`` in ``dtype``: by default bfloat16 where this
        mode's switch is on, else the promotion of x's and the weight's
        dtypes (flax's ``Dense(dtype=...)``: input, weight and bias cast,
        the product and the bias add in that dtype)."""
        x, w, b = _cast(dtype or _compute_dtype(self, x), x, self.kernel, self.bias)
        return x @ w + b


def _promote(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    return a if a == b else torch.promote_types(a, b)


def _compute_dtype(layer: nn.Module, x: torch.Tensor) -> torch.dtype:
    """bfloat16 where ``layer``'s switch for its mode is on, else the
    promotion of x's and its weight's dtypes."""
    if layer.bf16_train if layer.training else layer.bf16_eval:
        return torch.bfloat16
    return _promote(x.dtype, layer.weight.dtype)


def _cast(dtype: torch.dtype, *tensors: torch.Tensor):
    """``tensors`` in ``dtype``; the ones already there as they are (no
    node in an exported graph)."""
    return [t if t.dtype == dtype else t.to(dtype) for t in tensors]


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax's formulas, eps 1e-5:
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``.

    Eval uses the running statistics. Training uses the batch mean and the
    biased batch variance, ``sum(x) / n`` and ``sum(x * x) / n - mean^2``
    (clipped at 0) over every axis but the last, and moves the running
    statistics to ``0.9 * running + (1 - 0.9) * batch``, in place. Under a
    data mesh (``mesh``) the two sums and the count are the global
    batch's: the sums are all-reduced over the data ranks, differentiably,
    so the gradient reaches every rank's rows through the statistics, as in
    the JAX package's one program. One rank under a mesh gives the bits of
    no mesh."""

    momentum = 0.9
    # eval output in bfloat16 (``set_precision``)
    bf16_eval = False

    def __init__(self, features: int, device="cuda", eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.mesh = None
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a bfloat16 input is promoted to the parameters' dtype, as flax
        # does: the statistics and the normalisation run in float32
        (x,) = _cast(_promote(x.dtype, self.weight.dtype), x)
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean, var = self.finalize_sums(x.sum(dim=dims), (x * x).sum(dim=dims),
                                           x.numel() // x.shape[-1])
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean) * mul + self.bias
        if self.bf16_eval and not self.training:
            y = y.to(torch.bfloat16)
        return y

    def finalize_sums(self, total, total_sq, count: int):
        """Batch (mean, var) from the per-channel sum, sum of squares and
        count of this rank's rows, all-reduced over the data ranks under a
        mesh; the running statistics move."""
        if self.mesh is not None and self.mesh.data_group is not None:
            C = total.shape[0]
            both = all_sum_grad(torch.cat([total, total_sq]), self.mesh, DATA_AXIS)
            total, total_sq = both[:C], both[C:]
            count *= self.mesh.data_size
        mean = total / count
        var = torch.clamp(total_sq / count - mean * mean, min=0.0)
        self.update_stats(mean, var)
        return mean, var

    def update_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold batch statistics into the running ones (no gradient)."""
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def affine(self) -> dict:
        return {"scale": self.weight, "bias": self.bias,
                "mean": self.running_mean, "var": self.running_var}


class PairBatchNorm(BatchNorm):
    """The BatchNorm of a set-abstraction scale on the ``dense_train``
    route (``model/layers.py:53 PairBatchNorm`` of the JAX package): the
    same parameters, buffers and state-dict names as ``BatchNorm``, but it
    normalises nothing itself. ``finalize`` turns the multiplicity-weighted
    sums of a layer's pre-BN activations, accumulated over centroid chunks,
    into the batch statistics and the affine ``y = a * z + b`` of the
    normalisation."""

    def finalize(self, wsum: torch.Tensor, wsqsum: torch.Tensor, count: int):
        """(sum w z, sum w z^2, sum w) of this rank's pairs -> (a, b), the
        running statistics moved (``finalize_sums``)."""
        mean, var = self.finalize_sums(wsum, wsqsum, count)
        a = self.weight / torch.sqrt(var + self.eps)
        return a, self.bias - mean * a


class Dropout(nn.Module):
    """flax's dropout: in training keep each element with probability
    1 - p, drawn from ``generator``, and scale the kept ones by 1/(1 - p).
    The identity in eval or at p = 0. Under a data mesh the draws are made
    at the global batch's shape and each rank keeps its rows."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.mesh = None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout: training needs a generator")
        keep = 1.0 - self.p
        u = global_rand(x.shape, generator, self.mesh, dtype=x.dtype).to(x.device)
        return torch.where(u < keep, x / keep, 0.0)


class Chain(nn.Sequential):
    """A Sequential whose Dropout slots draw from the generator given to
    ``forward``."""

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for module in self:
            x = module(x, generator) if isinstance(module, Dropout) else module(x)
        return x


class Conv1dK3(nn.Module):
    """k=3 SAME convolution along the point axis of [B, N, C]; ``weight`` is
    the torch Conv1d layout [out, in, 3]. Computes in ``Pointwise``'s
    dtype."""

    bf16_train = False
    bf16_eval = False

    def __init__(self, in_ch: int, out_ch: int, device="cuda"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, 3, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ConvK3.apply(*_cast(_compute_dtype(self, x), x, self.weight, self.bias))


class _ConvK3(torch.autograd.Function):
    """``Conv1dK3``'s convolution, x [B, N, C] -> [B, N, out], with a
    backward whose sums run in an order fixed by the shapes.

    The forward is ``F.conv1d``. The backward is written as matrix
    products: the weight gradient is the cotangent's product with the three
    shifted copies of x side by side, the input gradient the sum, in tap
    order, of the cotangent's products with the three taps, shifted back.
    cuDNN's own convolution backward picks algorithms that add with
    atomics, in an order that changes from run to run, and makes the
    training step irreproducible."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.conv1d(x.transpose(1, 2), weight, bias, padding=1).transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        B, N, C = x.shape
        out = weight.shape[0]
        g2 = g.reshape(B * N, out)
        g_x = g_w = g_b = None
        if ctx.needs_input_grad[0]:
            # h[b, n, k] = g[b, n] @ weight[:, :, k]; x[m] feeds y[m - k + 1]
            h = (g2 @ weight.permute(0, 2, 1).reshape(out, 3 * C)).reshape(B, N, 3, C)
            hp = F.pad(h, (0, 0, 0, 0, 1, 1))
            g_x = hp[:, 2:, 0] + hp[:, 1:-1, 1] + hp[:, :-2, 2]
        if ctx.needs_input_grad[1]:
            xp = F.pad(x, (0, 0, 1, 1))
            cols = torch.cat([xp[:, k:k + N] for k in range(3)], dim=-1)
            g_w = (g2.t() @ cols.reshape(B * N, 3 * C)).reshape(out, 3, C)
            g_w = g_w.permute(0, 2, 1).contiguous()
        if ctx.needs_input_grad[2]:
            g_b = g2.sum(dim=0)
        return g_x, g_w, g_b


class SetAbstractionMsg(nn.Module):
    """Multi-scale-grouping set abstraction.

    xyz [B, N, 3], points [B, N, D] -> (new_xyz [B, S, 3],
    new_points [B, S, sum(mlp[-1])]). One FPS and one squared-distance tensor
    are shared by the scales. A scale pools, over each centroid's first
    ``nsample`` in-radius points, the conv/BN/ReLU chain of
    ``[points_n, xyz_n - c_s]``. Two formulations:

    * dense (eval with ``grouping="dense"``): masked pairs; large
      three-layer scales run the block-sparse kernel (``_sparse_scale``),
      the others masked dense pairs in centroid chunks (``_dense_scale``).
      With ``pallas_fused`` and every scale on the block-sparse route, one
      fused kernel runs all scales (``_fused_scales``). All give the same
      values.
    * gather (training, or eval with ``grouping="gather"``): the ball query
      selects K neighbors per scale and one gather of ``[points, xyz]`` rows
      serves every scale, so BatchNorm sees the selected-neighbor multiset,
      backfill duplicates included. Behind ``use_pallas_gather`` the rows
      are gathered in Morton order by the one-hot gather kernel
      (``_pallas_gathered``), else by ``index_points`` (``_gathered``):
      the same rows either way. With ``uv_split_gather`` (and no one-hot
      gather) each scale's first conv runs per point before the gather
      (``_uv_scales``).

    The layers' dtypes follow ``set_precision``; the dense-train, event
    and block-sparse routes take the weights directly and stay in the
    parameters' dtype.
    """

    def __init__(
        self, npoint: int, radius_list: Sequence[float],
        nsample_list: Sequence[int], in_channel: int,
        mlps: Sequence[Sequence[int]], grouping: str = "dense",
        dense_chunk: int = 64, pallas_grouping: bool = True,
        pallas_nb: int = 256, pallas_gather: bool = False,
        pallas_gather_nb: int = 128, pallas_gather_bwd: bool = False,
        pallas_gather_wide: bool = True, rank_ball_query: bool = True,
        pallas_fused: bool = False, dense_train: bool = False,
        uv_split_gather: bool = False, device="cuda",
    ):
        super().__init__()
        if grouping not in ("dense", "gather"):
            raise ValueError(f"grouping={grouping!r}: want 'dense' or 'gather'")
        self.npoint = npoint
        self.radius_list = tuple(radius_list)
        self.nsample_list = tuple(nsample_list)
        self.mlps = tuple(tuple(m) for m in mlps)
        self.grouping = grouping
        self.dense_chunk = dense_chunk
        self.pallas_grouping = pallas_grouping
        self.pallas_nb = pallas_nb
        self.pallas_gather = pallas_gather
        self.pallas_gather_nb = pallas_gather_nb
        self.pallas_gather_bwd = pallas_gather_bwd
        self.pallas_gather_wide = pallas_gather_wide
        self.rank_ball_query = rank_ball_query
        self.pallas_fused = pallas_fused
        self.dense_train = dense_train
        self.uv_split_gather = uv_split_gather
        # the data mesh (dense_train's sums) and the event mesh (FPS and the
        # dense scales sharded over the event axis); set by TEHNet.set_mesh
        self.mesh = None
        self.event_mesh = None
        self.conv_blocks = nn.ModuleList()
        self.bn_blocks = nn.ModuleList()
        for mlp in self.mlps:
            convs, bns = nn.ModuleList(), nn.ModuleList()
            last = in_channel + 3
            for width in mlp:
                convs.append(Pointwise(last, width, 2, device))
                bns.append((PairBatchNorm if dense_train else BatchNorm)(width, device))
                last = width
            self.conv_blocks.append(convs)
            self.bn_blocks.append(bns)

    def use_sparse_scale(self, i: int, n_points: int) -> bool:
        """The shape terms of the JAX package's ``_use_pallas_scale``."""
        return (
            self.pallas_grouping
            and len(self.mlps[i]) == 3
            and n_points % self.pallas_nb == 0
            and n_points <= 8192          # full-resolution Morton keys
            and self.npoint % 8 == 0
            and n_points * self.npoint >= SPARSE_MIN_PAIRS
        )

    def use_pallas_gather(self, n_points: int, d: int) -> bool:
        """The shape terms of the JAX package's ``_use_pallas_gather``. Its
        test for a TPU backend and its two VMEM-size terms are dropped: they
        size the TPU's on-chip memory, and TEHNet's four layers pass them
        at their shapes anyway."""
        nb = self.pallas_gather_nb
        return (
            self.pallas_gather
            and (3 * (d + 3) <= 128 or self.pallas_gather_wide)
            and n_points % nb == 0
            and n_points >= 2 * nb        # no tile to skip below two tiles
            and n_points <= 8192          # full-resolution Morton keys
            and self.npoint % 8 == 0
        )

    def forward(
        self, xyz: torch.Tensor, points: torch.Tensor,
        fps_idx: Optional[torch.Tensor] = None,
        fps_start: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``fps_idx`` [B, S] gives the centroids; otherwise FPS samples
        them, each row from ``fps_start`` [B] (default index 0), which must
        lie in [0, N): TEHNet draws it so, and it is not checked here (a
        check reads it back on the host)."""
        if points is None:
            raise NotImplementedError("SetAbstractionMsg without point features")
        N = xyz.shape[1]
        emesh = self.event_mesh
        if fps_idx is None:
            if emesh is not None:
                fps_idx = event_sharded_fps(emesh, xyz, self.npoint, fps_start)
            else:
                fps_idx = fps_unchecked(xyz, self.npoint, fps_start)
        new_xyz = index_points(xyz, fps_idx)
        dense = self.grouping == "dense"
        dense_train = self.training and self.dense_train and dense
        if emesh is not None and (dense_train or (dense and not self.training)):
            scale = self._event_train_scale if self.training else self._event_scale
            return new_xyz, torch.cat([
                scale(i, xyz, points, new_xyz, r, k) for i, (r, k) in
                enumerate(zip(self.radius_list, self.nsample_list))], dim=-1)
        if dense_train:
            sqrdists = square_distance(new_xyz, xyz)
            return new_xyz, torch.cat([
                self._dense_train_scale(i, xyz, points, new_xyz, sqrdists, r, k)
                for i, (r, k) in enumerate(zip(self.radius_list, self.nsample_list))],
                dim=-1)
        if self.training or self.grouping == "gather":
            if self.use_pallas_gather(N, points.shape[-1]):
                gathered = self._pallas_gathered(xyz, points, new_xyz)
            elif self.uv_split_gather:
                return new_xyz, self._uv_scales(xyz, points, new_xyz)
            else:
                gathered = self._gathered(xyz, points, new_xyz)
            return new_xyz, self._gather_scales(gathered, new_xyz,
                                                points.shape[-1])
        sqrdists = square_distance(new_xyz, xyz)  # [B, S, N], shared
        sparse = [self.use_sparse_scale(i, N) for i in range(len(self.mlps))]
        perm = xyz_p = points_p = None
        if any(sparse):
            # one Morton order for every sparse scale of the layer
            perm = morton_perm(xyz)
            xyz_p = index_points(xyz, perm)
            points_p = index_points(points, perm)
        if self.pallas_fused and all(sparse):
            # one kernel pass over every scale, already in concatenation order
            return new_xyz, self._fused_scales(new_xyz, sqrdists, perm, xyz_p,
                                               points_p)
        outs = []
        for i, radius in enumerate(self.radius_list):
            k = self.nsample_list[i]
            if sparse[i]:
                outs.append(self._sparse_scale(
                    i, new_xyz, sqrdists, radius, k, perm, xyz_p, points_p))
            else:
                outs.append(self._dense_scale(
                    i, xyz, points, new_xyz, sqrdists, radius, k))
        return new_xyz, torch.cat(outs, dim=-1)

    def _ball_query(self, xyz, new_xyz):
        """[B, S, sum(K)] indices of every scale's ball query."""
        sqrdists = square_distance(new_xyz, xyz)
        return torch.cat([
            query_ball_point(r, k, sqrdists, rank=self.rank_ball_query)
            for r, k in zip(self.radius_list, self.nsample_list)], dim=-1)

    def _gathered(self, xyz, points, new_xyz):
        """[B, S, sum(K), D + 3] rows of ``[points, xyz]`` at every scale's
        ball query, one ``index_points`` for all scales."""
        return index_points(torch.cat([points, xyz], dim=-1),
                            self._ball_query(xyz, new_xyz))

    def _uv_scales(self, xyz, points, new_xyz):
        """The gather route with each scale's first conv split
        (``uv_split_gather``; ``model/layers.py:261-298, 415-430`` of the JAX
        package): u_n = conv0([f_n, x_n]) of every scale per point, one
        gather of the concatenated u at every scale's ball query, and
        z = u_g - v_s + zb, with v_s = conv0([0, c_s]) and zb = conv0(0)
        the bias that u - v cancels. BatchNorm sees the gather route's
        neighbor multiset."""
        B, S, D = new_xyz.shape[0], new_xyz.shape[1], points.shape[-1]
        src = torch.cat([points, xyz], dim=-1)
        u = index_points(torch.cat([convs[0](src) for convs in self.conv_blocks], dim=-1),
                         self._ball_query(xyz, new_xyz))
        cent = torch.cat([xyz.new_zeros(B, S, D), new_xyz], dim=-1)
        zero = xyz.new_zeros(1, 1, D + 3)
        outs = []
        k_off = c_off = 0
        for convs, bns, k in zip(self.conv_blocks, self.bn_blocks, self.nsample_list):
            c1 = convs[0].weight.shape[0]
            z = (u[:, :, k_off:k_off + k, c_off:c_off + c1]
                 - convs[0](cent)[:, :, None] + convs[0](zero))
            k_off += k
            c_off += c1
            x = torch.relu(bns[0](z))
            for conv, bn in zip(convs[1:], bns[1:]):
                x = torch.relu(bn(conv(x)))
            outs.append(torch.amax(x, dim=2))
        return torch.cat(outs, dim=-1)

    def _pallas_gathered(self, xyz, points, new_xyz):
        """The same rows as ``_gathered``, gathered by the one-hot gather
        kernel from a Morton-ordered source. The ball queries run on the
        distances in permuted column order; ``square_distance`` is
        elementwise, so those are the exact permutation of the unpermuted
        ones and the selection is the same."""
        nb = self.pallas_gather_nb
        perm = morton_perm(xyz)
        xyz_p = index_points(xyz, perm)
        sqrdists_p = square_distance(new_xyz, xyz_p)
        pos = torch.cat([
            query_ball_point_permuted(r, k, perm, sqrdists_p)
            for r, k in zip(self.radius_list, self.nsample_list)], dim=-1)
        src_p = torch.cat([index_points(points, perm), xyz_p], dim=-1)
        act = pos_tile_activity(pos, nb, xyz.shape[1])
        return grouped_gather(src_p, pos, act, nb=nb,
                              bwd="pallas" if self.pallas_gather_bwd else "xla")

    def _gather_scales(self, gathered, new_xyz, D):
        """Per scale: its K slots, centred xyz, the conv/BN/ReLU chain and
        the max over the slots (ties share the gradient, as in JAX)."""
        outs = []
        k_off = 0
        for convs, bns, k in zip(self.conv_blocks, self.bn_blocks,
                                 self.nsample_list):
            g = gathered[:, :, k_off:k_off + k]
            k_off += k
            x = torch.cat([g[..., :D], g[..., D:] - new_xyz[:, :, None, :]], dim=-1)
            for conv, bn in zip(convs, bns):
                x = torch.relu(bn(conv(x)))
            outs.append(torch.amax(x, dim=2))
        return torch.cat(outs, dim=-1)

    def sparse_scale_inputs(self, i, new_xyz, sqrdists, radius, k, perm,
                            xyz_p, points_p):
        """(FoldedScale, sel_p, act) of scale ``i`` for ``msg_scale_sparse``:
        BN folded into the weights, points in the layer's Morton order
        ``perm``, the selection mask column-permuted, per-tile activity."""
        folded = self.folded_scale(i, xyz_p, points_p, new_xyz)
        sel_p = permute_columns(dense_selection_mask(sqrdists, radius, k), perm)
        return folded, sel_p, tile_activity(sel_p, self.pallas_nb)

    def folded_scale(self, i, xyz, points, new_xyz):
        """Scale ``i``'s ``FoldedScale`` with eval BatchNorm folded in, its
        ``u`` rows in the order of ``xyz`` and ``points``."""
        return fold_scale_params(
            points, xyz, new_xyz,
            [{"kernel": c.kernel, "bias": c.bias} for c in self.conv_blocks[i]],
            [bn.affine() for bn in self.bn_blocks[i]],
        )

    def _sparse_scale(self, i, new_xyz, sqrdists, radius, k, perm, xyz_p,
                      points_p):
        """One scale through the block-sparse kernel, which skips the point
        tiles that hold no selected point."""
        folded, sel_p, act = self.sparse_scale_inputs(
            i, new_xyz, sqrdists, radius, k, perm, xyz_p, points_p)
        return msg_scale_sparse(folded, sel_p, act, self.pallas_nb)

    def fused_scale_inputs(self, new_xyz, sqrdists, perm, xyz_p, points_p):
        """(stacked, sel_all, act_union, sections, blocks) of every scale for
        ``msg_fused_scales_sparse``: each scale prepared as for
        ``msg_scale_sparse`` on the shared Morton order, the folded scales
        stacked (``stack_folded_scales``), the masks stacked [B, R, S, N] and
        the union of their tile activities."""
        folded_list, sels, acts = [], [], []
        for i, (radius, k) in enumerate(zip(self.radius_list, self.nsample_list)):
            folded, sel_p, act = self.sparse_scale_inputs(
                i, new_xyz, sqrdists, radius, k, perm, xyz_p, points_p)
            folded_list.append(folded)
            sels.append(sel_p)
            acts.append(act)
        stacked, sections, blocks = stack_folded_scales(folded_list)
        act_union = torch.stack(acts, dim=1).amax(dim=1)
        return stacked, torch.stack(sels, dim=1), act_union, sections, blocks

    def _fused_scales(self, new_xyz, sqrdists, perm, xyz_p, points_p):
        """All scales in one block-sparse kernel pass over the union of
        their tile activities."""
        stacked, sel_all, act, sections, blocks = self.fused_scale_inputs(
            new_xyz, sqrdists, perm, xyz_p, points_p)
        return msg_fused_scales_sparse(stacked, sel_all, act, sections,
                                       self.pallas_nb, blocks)

    def _event_scale(self, i, xyz, points, new_xyz, radius, k):
        """Scale ``i`` in eval with the event axis sharded over the event
        ranks: eval BatchNorm folded into the weights
        (``event_parallel.fold_bn_dense``), the pair work on this rank's
        N / E points."""
        layers = [fold_bn_dense(c.kernel, c.bias, bn.weight, bn.bias, bn.running_mean,
                                bn.running_var, bn.eps)
                  for c, bn in zip(self.conv_blocks[i], self.bn_blocks[i])]
        return event_sharded_msg_scale(self.event_mesh, xyz, points, new_xyz, layers,
                                       radius, k, s_chunk=self.dense_chunk)

    def _event_train_scale(self, i, xyz, points, new_xyz, radius, k):
        """Scale ``i`` in training with the event axis sharded: the
        differentiable, multiplicity-weighted route of ``_dense_train_scale``
        (``event_parallel.event_sharded_train_msg_scale``); its global batch
        statistics move the running ones."""
        convs, bns = self.conv_blocks[i], self.bn_blocks[i]
        pooled, stats = event_sharded_train_msg_scale(
            self.event_mesh, xyz, points, new_xyz,
            [(c.kernel, c.bias) for c in convs], [(bn.weight, bn.bias) for bn in bns],
            radius, k, s_chunk=self.dense_chunk, eps=bns[0].eps)
        for bn, (mean, var) in zip(bns, stats):
            bn.update_stats(mean, var)
        return pooled

    def _dense_train_scale(self, i, xyz, points, new_xyz, sqrdists, radius, k):
        """Scale ``i`` in training on the dense route, with the gather
        route's BatchNorm statistics (``model/layers.py:639`` of the JAX
        package).

        Each selected (centroid, point) pair carries its multiplicity in the
        gather route's neighbor multiset (``selection_weights``: 1, plus
        ``k - count`` on the first in-radius point when the ball underfills,
        ``k`` on point 0 for an empty ball), so every BatchNorm's weighted
        mean and variance over all pairs equal the gather route's over its
        K slots (sum w = B * S * k). A layer's statistics gate the next
        layer's input, so the chain runs as L sweeps over centroid chunks:
        sweep l recomputes layers < l with their final affines and sums
        layer l's pre-BN activations. The last sweep also keeps the masked
        max and min of the last pre-BN layer; BatchNorm's affine is
        monotone, so the pooled value is ``relu(a * max + b)`` where
        a >= 0 and ``relu(a * min + b)`` elsewhere. Chunks are
        checkpointed: the backward holds one [B, chunk, N, C] tile a layer.
        Under a data mesh the weighted sums are all-reduced over the data
        ranks."""
        convs, bns = self.conv_blocks[i], self.bn_blocks[i]
        B, N, _ = xyz.shape
        S, D = new_xyz.shape[1], points.shape[-1]
        mask = sqrdists <= radius ** 2
        rank = torch.cumsum(mask, dim=-1) - mask.long()
        at0 = torch.arange(N, device=xyz.device) == 0
        sel, w = selection_weights(mask, rank, mask.sum(-1), k, at0, xyz.dtype)
        dt = convs[0].weight.dtype   # this route stays in the parameters' dtype
        u = convs[0](torch.cat([points, xyz], dim=-1), dt)
        v = convs[0](torch.cat([xyz.new_zeros(B, S, D), new_xyz], dim=-1), dt)
        mx, mn, affines = weighted_msg_sweeps(
            u, v, convs[0].bias, sel, w, [(c.kernel, c.bias) for c in convs[1:]],
            lambda l, wsum, wsqsum: bns[l].finalize(wsum, wsqsum, B * S * k),
            self.dense_chunk)
        return pool_by_sign(mx, mn, *affines[-1])

    def _dense_scale(self, i, xyz, points, new_xyz, sqrdists, radius, k):
        """Masked dense pairs in centroid chunks. The first conv splits into
        a per-point half u_n = conv0([f_n, x_n]) and a per-centroid half
        v_s = conv0([0, c_s]); z[s, n] = u_n - v_s + b."""
        convs, bns = self.conv_blocks[i], self.bn_blocks[i]
        B, N, _ = xyz.shape
        S, D = new_xyz.shape[1], points.shape[-1]
        sel = dense_selection_mask(sqrdists, radius, k) > 0.5
        u = convs[0](torch.cat([points, xyz], dim=-1))
        v = convs[0](torch.cat([xyz.new_zeros(B, S, D), new_xyz], dim=-1))
        chunk = max(1, min(self.dense_chunk, S))
        outs = []
        (bias,) = _cast(u.dtype, convs[0].bias)
        for s0 in range(0, S, chunk):
            z = u[:, None] - v[:, s0:s0 + chunk, None] + bias
            h = torch.relu(bns[0](z))
            for conv, bn in zip(convs[1:], bns[1:]):
                h = torch.relu(bn(conv(h)))
            m = sel[:, s0:s0 + chunk, :, None]
            outs.append(torch.where(m, h, -torch.inf).amax(dim=2))
        return torch.cat(outs, dim=1)


def set_mesh(module: nn.Module, mesh=None, event_mesh=None) -> None:
    """Put every BatchNorm, Dropout and set-abstraction layer of ``module``
    under the data mesh ``mesh``; the set-abstraction layers also under
    ``event_mesh`` (None: no event sharding)."""
    for m in module.modules():
        if isinstance(m, (BatchNorm, Dropout)):
            m.mesh = mesh
        elif isinstance(m, SetAbstractionMsg):
            m.mesh, m.event_mesh = mesh, event_mesh


class SetAbstractionAll(nn.Module):
    """Global set abstraction: one group over all points (raw xyz + features),
    conv/BN/ReLU stack, max-pool -> (zeros [B, 1, 3], [B, 1, mlp[-1]])."""

    def __init__(self, in_channel: int, mlp: Sequence[int], device="cuda"):
        super().__init__()
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        last = in_channel
        for width in mlp:
            self.mlp_convs.append(Pointwise(last, width, 2, device))
            self.mlp_bns.append(BatchNorm(width, device))
            last = width

    def forward(self, xyz, points):
        new_xyz, x = group_all(xyz, points)  # [B, 1, N, 3+D]
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            x = torch.relu(bn(conv(x)))
        return new_xyz, torch.amax(x, dim=2)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance propagation (a broadcast when S == 1), then a
    pointwise conv/BN/ReLU stack."""

    def __init__(self, in_channel: int, mlp: Sequence[int], device="cuda"):
        super().__init__()
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        last = in_channel
        for width in mlp:
            self.mlp_convs.append(Pointwise(last, width, 1, device))
            self.mlp_bns.append(BatchNorm(width, device))
            last = width

    def forward(self, xyz1, xyz2, points1, points2):
        if xyz2.shape[1] == 1:
            interpolated = points2.expand(-1, xyz1.shape[1], -1)
        else:
            interpolated = three_nn_interpolate(xyz1, xyz2, points2)
        x = (torch.cat([points1, interpolated], dim=-1)
             if points1 is not None else interpolated)
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            x = torch.relu(bn(conv(x)))
        return x


def attention_block(key: torch.Tensor, value: torch.Tensor,
                    query: torch.Tensor) -> torch.Tensor:
    """Class-space attention: key [B, N, KC], value and query [B, N, C] ->
    [B, N, KC]. The scale is C**-0.5 (the value width, the reference's
    quirk) and the softmax runs over the class axis. Computes in the
    promotion of the three dtypes."""
    key, value, query = _cast(_promote(_promote(key.dtype, value.dtype), query.dtype),
                              key, value, query)
    c = value.shape[-1]
    sim = torch.einsum("bnk,bnc->bkc", key, query) * (c ** -0.5)
    sim = torch.softmax(sim, dim=1)
    return torch.einsum("bkc,bnc->bnk", sim, value)


class QueryConv(Chain):
    """Per-hand query head over the event axis; slots conv0, relu, bn0,
    drop, conv1, bn1 as in the reference's Sequential."""

    def __init__(self, in_channel: int = 256, features: int = 256,
                 dropout: float = 0.1, device="cuda"):
        super().__init__(
            Conv1dK3(in_channel, features, device),
            nn.ReLU(),
            BatchNorm(features, device),
            Dropout(dropout),
            Conv1dK3(features, features, device),
            BatchNorm(features, device),
        )
