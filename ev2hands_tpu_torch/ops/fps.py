"""Farthest-point sampling: the CUDA kernel and its plain version.

Counterpart of ``ev2hands_tpu/ops/pallas_ops.py`` (``fps_pallas``, and
``fps_auto``'s dispatch: eval draws no random start, so the platform choice
is all that is left of it). ``fps`` launches ``csrc/fps.cu`` for a CUDA
tensor and runs the plain version, ``ops.pointnet.farthest_point_sample``,
for a CPU tensor. Both give identical indices.

``fps`` checks a caller's ``start`` against [0, N), which reads it back on
the host. The model draws its starts in range by construction and calls
``fps_unchecked``, which makes no host sync.

The model's FPS goes through the registered op ``torch.ops.ev2hands.fps``
(``fps_op``: the plain version for a CPU tensor, the kernel for a CUDA
one, a shape function for ``torch.export``), so an exported program keeps
the call as one node and launches the kernel when it runs on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ev2hands_tpu_torch.ops import _build
from ev2hands_tpu_torch.ops.pointnet import farthest_point_sample

fps_plain = farthest_point_sample

# Largest cloud the kernel takes: one CTA keeps every point in registers,
# at most 1024 threads x 8 points.
MAX_N = 8192

# Built instantiations of csrc/fps.cu: threads -> largest points a thread
CONFIGS = {128: 32, 256: 32, 512: 16, 1024: 8}


def _lib() -> ctypes.CDLL:
    lib = _build.load("fps")
    if lib.fps_launch.argtypes is None:
        lib.fps_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.fps_launch.restype = ctypes.c_int
    return lib


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def kernel_config(N: int) -> Tuple[int, int]:
    """(threads, points a thread) of the kernel for an N-point cloud, the
    fastest of chip_smoke's sweep on the H100 at N = 512, 1024, 2048, 4096
    and 8192 (``PERF.md``, K1's sweep): one point a thread up to 512 points,
    128 threads x 8 up to 1024, then 256 threads and as many points a
    thread as N needs. A step is the latency of its distance work (issued
    by the CTA's four schedulers) plus the barrier and the reductions,
    which grow with the number of warps."""
    if N <= 512:
        return max(128, _pow2_at_least(N)), 1
    if N <= 1024:
        return 128, 8
    return 256, _pow2_at_least(-(-N // 256))


def fps(
    xyz: torch.Tensor, npoint: int, start: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[B, N, 3] float32 -> [B, npoint] int32 farthest-point indices, each
    row starting at ``start`` [B] (default 0), which must lie in [0, N)."""
    N = xyz.shape[1]
    if start is not None and bool(((start < 0) | (start >= N)).any()):
        raise ValueError(f"fps: start must be [B] indices in [0, {N})")
    return fps_unchecked(xyz, npoint, start)


def fps_unchecked(
    xyz: torch.Tensor, npoint: int, start: Optional[torch.Tensor] = None,
    config: Optional[Tuple[int, int]] = None, redux: bool = True,
    work: bool = True,
) -> torch.Tensor:
    """``fps`` for a ``start`` that is in range by construction: no host
    sync (the kernel clamps a start outside [0, N) into the row). It calls
    the registered op ``torch.ops.ev2hands.fps``, which ``torch.export``
    records as one node.

    ``config`` (threads, points a thread), ``redux`` (the two redux.sync,
    else the 64-bit butterfly) and ``work`` (False: the chain floor, no
    distance work and meaningless indices) choose another instantiation of
    the kernel, for measurement; they launch it directly, and do not apply
    on the CPU."""
    B, N, _ = xyz.shape
    if start is not None and tuple(start.shape) != (B,):
        raise ValueError(f"fps: start must be [B] indices in [0, {N})")
    if xyz.device.type == "cuda" and (config is not None or not redux or not work):
        return _launch(xyz, npoint, start, config, redux, work)
    return fps_op(xyz, npoint, start)


def _launch(
    xyz: torch.Tensor, npoint: int, start: Optional[torch.Tensor],
    config: Optional[Tuple[int, int]] = None, redux: bool = True,
    work: bool = True,
) -> torch.Tensor:
    """The kernel on a CUDA tensor; counts the launch on ``fps``."""
    B, N, C = xyz.shape
    if C != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"fps: want [B, N, 3] float32, got {tuple(xyz.shape)} {xyz.dtype}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"fps: N={N} outside the kernel's 1..{MAX_N}")
    threads, ppt = config or kernel_config(N)
    if CONFIGS.get(threads, 0) < ppt or threads * ppt < N or ppt & (ppt - 1):
        raise ValueError(f"fps: no kernel of {threads} threads x {ppt} points for N={N}")
    xyz = xyz.contiguous()
    if start is not None:   # None: every row from index 0
        start = start.to(device=xyz.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(xyz.device):
        err = lib.fps_launch(
            xyz.data_ptr(), None if start is None else start.data_ptr(),
            out.data_ptr(), B, N, npoint,
            threads, ppt, int(redux), int(work),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed: CUDA error {err}")
    fps.launches += 1
    return out


fps.launches = 0


@torch.library.custom_op("ev2hands::fps", mutates_args=(), device_types="cpu")
def fps_op(xyz: torch.Tensor, npoint: int,
           start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The model's FPS as a registered op, ``torch.ops.ev2hands.fps``:
    the plain version on the CPU, the kernel on the card."""
    return fps_plain(xyz, npoint, start)


@fps_op.register_kernel("cuda")
def _fps_cuda(xyz, npoint, start=None):
    return _launch(xyz, npoint, start)


@fps_op.register_fake
def _fps_fake(xyz, npoint, start=None):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)
