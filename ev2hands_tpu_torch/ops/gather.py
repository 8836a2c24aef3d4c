"""Grouped-neighbor gather of the training path: the one-hot gather kernel,
its scatter-add backward kernel, their plain versions and the
differentiable ``grouped_gather``.

Counterpart of ``ev2hands_tpu/ops/pallas_gather.py``:

* ``pos_tile_activity`` marks the ``nb``-point tiles that hold a slot of a
  centroid (positions into a Morton-ordered point axis);
* ``onehot_gather`` (``_onehot_gather``) copies the rows of a source at
  [B, S, K] positions into [B, S, K, C]: ``csrc/gather.cu`` on a CUDA
  tensor, ``onehot_gather_plain`` (``index_points``) on a CPU tensor; the
  two are bitwise equal;
* ``onehot_scatter_add`` (``_onehot_scatter_add``) is the gather's VJP, the
  sum of the slot cotangents that hit each source row: the kernel on a CUDA
  tensor, which sums each row's slots in an order fixed by the inputs and so
  gives the same bits run to run, within 1e-5 * (1 + the sum of
  |contributions|) of ``onehot_scatter_add_plain`` (one ``index_add_``,
  another order), which runs on a CPU tensor;
* ``grouped_gather`` is the gather as an ``autograd.Function`` whose
  backward is the scatter-add kernel (``bwd="pallas"``) or the plain
  scatter-add (``bwd="xla"``), the JAX package's switch names.

The TPU kernels split each f32 value into three bf16 terms (``split3_bf16``,
``_seg_width``) so that a one-hot product on the bf16 matrix unit copies
it exactly. A copy on the card is exact by itself, so neither is
ported. ``act``, ``nb`` and ``sb`` keep the JAX signatures: the kernels
walk the slots themselves, so they do not read ``act``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ev2hands_tpu_torch.ops import _build
from ev2hands_tpu_torch.ops.pointnet import index_points

onehot_gather_plain = index_points

# Source rows the scatter-add counts in shared memory (csrc/gather.cu kMaxN).
_MAX_N = 56 * 1024
_INT_MAX = 2**31 - 1


def pos_tile_activity(pos: torch.Tensor, nb: int, n: int) -> torch.Tensor:
    """pos [B, S, K] positions into an n-point axis -> [B, S, n // nb]
    int32: 1 where the nb-point tile holds at least one of the slots."""
    B, S, _ = pos.shape
    act = torch.zeros((B, S, n // nb), dtype=torch.int32, device=pos.device)
    return act.scatter_(2, pos.long() // nb, 1)


def onehot_scatter_add_plain(g: torch.Tensor, idx: torch.Tensor,
                             n: int) -> torch.Tensor:
    """Plain version of the scatter-add kernel: g [B, S, K, C], idx
    [B, S, K] -> [B, n, C], one ``index_add_`` over the flattened batch."""
    B, C = g.shape[0], g.shape[-1]
    rows = idx.reshape(B, -1).long() + n * torch.arange(B, device=g.device)[:, None]
    out = torch.zeros((B * n, C), dtype=g.dtype, device=g.device)
    return out.index_add_(0, rows.reshape(-1), g.reshape(-1, C)).view(B, n, C)


def _check(name, idx, act, n, nb, sb):
    B, S, _ = idx.shape
    if nb <= 0 or n % nb or sb <= 0 or S % sb:
        raise ValueError(f"{name}: want N % nb == 0 and S % sb == 0, got "
                         f"N={n}, nb={nb}, S={S}, sb={sb}")
    if tuple(act.shape) != (B, S, n // nb):
        raise ValueError(f"{name}: act is {tuple(act.shape)}, want {(B, S, n // nb)}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    lib.onehot_gather_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.onehot_scatter_add_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    for fn in (lib.onehot_gather_launch, lib.onehot_scatter_add_launch):
        fn.restype = ctypes.c_int
    lib.onehot_scatter_add_scratch_ints.argtypes = [ctypes.c_int] * 5
    lib.onehot_scatter_add_scratch_ints.restype = ctypes.c_longlong
    return lib


def _launch(fn, device: torch.device, *args) -> int:
    """Call the C launcher ``fn`` with ``args`` and the raw handle of the
    current stream of ``device``, made current for the call where it is not
    (at the narrow training shapes the host's time is what a call costs)."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(fn, device, *args)
    return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))


def _cuda_operands(name, data, idx, n):
    """Check a CUDA operand ``data`` ([B, N, C] or [B, S, K, C]) and ``idx``
    [B, S, K] against the kernels -> both contiguous, idx as int64 (the
    ball query's own type; any other is converted)."""
    if data.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {data.device}")
    if data.dtype != torch.float32:
        raise ValueError(f"{name}: want float32, got {data.dtype}")
    if idx.device != data.device:
        raise ValueError(f"{name}: idx must be on {data.device}")
    B, S, K = idx.shape
    C = data.shape[-1]
    if n > _MAX_N or max(B * S * K * C, B * n * C) > _INT_MAX:
        raise ValueError(f"{name}: N={n} (at most {_MAX_N}) or B*S*K*C={B * S * K * C} "
                         "too large for the kernel's int32 indexing")
    return data.contiguous(), idx.long().contiguous()


def onehot_gather(src: torch.Tensor, idx: torch.Tensor, act: torch.Tensor,
                  nb: int = 128, sb: int = 8) -> torch.Tensor:
    """src [B, N, C], idx [B, S, K] positions into N -> [B, S, K, C],
    bitwise equal to ``index_points(src, idx)``."""
    B, N, C = src.shape
    _check("onehot_gather", idx, act, N, nb, sb)
    if src.device.type == "cpu":
        return onehot_gather_plain(src, idx)
    src, idx_c = _cuda_operands("onehot_gather", src, idx, N)
    S, K = idx.shape[1], idx.shape[2]
    out = torch.empty((B, S, K, C), dtype=torch.float32, device=src.device)
    err = _launch(_lib().onehot_gather_launch, src.device, src.data_ptr(),
                  idx_c.data_ptr(), out.data_ptr(), B, N, S, K, C)
    if err != 0:
        raise RuntimeError(f"onehot_gather kernel launch failed: CUDA error {err}")
    onehot_gather.launches += 1
    return out


onehot_gather.launches = 0


def onehot_scatter_add(g: torch.Tensor, idx: torch.Tensor, act: torch.Tensor,
                       n: int, nb: int = 128, sb: int = 8) -> torch.Tensor:
    """g [B, S, K, C] slot cotangents, idx [B, S, K] positions into n ->
    [B, n, C]: for each source row, the sum of the cotangents of the slots
    that hold it (the VJP of ``onehot_gather``). On the card each row's sum
    runs in an order fixed by the inputs (its slots in ascending order
    s * K + k, split into segments and streams as ``csrc/gather.cu`` says),
    so it has the same bits every run."""
    B, S, K, C = g.shape
    _check("onehot_scatter_add", idx, act, n, nb, sb)
    if g.device.type == "cpu":
        return onehot_scatter_add_plain(g, idx, n)
    g, idx_c = _cuda_operands("onehot_scatter_add", g, idx, n)
    lib = _lib()
    out = torch.empty((B, n, C), dtype=torch.float32, device=g.device)
    scratch = torch.empty(lib.onehot_scatter_add_scratch_ints(B, n, S, K, C),
                          dtype=torch.int32, device=g.device)
    err = _launch(lib.onehot_scatter_add_launch, g.device, g.data_ptr(),
                  idx_c.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, n, S, K, C)
    if err != 0:
        raise RuntimeError(f"onehot_scatter_add kernel launch failed: CUDA error {err}")
    onehot_scatter_add.launches += 1
    return out


onehot_scatter_add.launches = 0


class _GroupedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx, act, nb, sb, bwd):
        ctx.save_for_backward(idx, act)
        ctx.n, ctx.nb, ctx.sb, ctx.bwd = src.shape[1], nb, sb, bwd
        return onehot_gather(src, idx, act, nb=nb, sb=sb)

    @staticmethod
    def backward(ctx, g):
        idx, act = ctx.saved_tensors
        if ctx.bwd == "pallas":
            d = onehot_scatter_add(g, idx, act, ctx.n, nb=ctx.nb, sb=ctx.sb)
        else:
            d = onehot_scatter_add_plain(g, idx, ctx.n)
        return d, None, None, None, None, None


def grouped_gather(src: torch.Tensor, idx: torch.Tensor, act: torch.Tensor,
                   nb: int = 128, sb: int = 8, bwd: str = "xla") -> torch.Tensor:
    """Differentiable one-hot gather: forward ``onehot_gather``; backward
    ``onehot_scatter_add`` (``bwd="pallas"``) or the plain scatter-add
    (``bwd="xla"``). idx and act are not differentiated."""
    if bwd not in ("xla", "pallas"):
        raise ValueError(f"grouped_gather: bwd must be 'xla' or 'pallas', got {bwd!r}")
    return _GroupedGather.apply(src, idx, act, nb, sb, bwd)
