#!/usr/bin/env python3
"""Cycles a CTA of csrc/msg_ball.cu by phase, both modes, on the card.

    python3 ball_phases.py

Builds the kernel's source with -DMSG_BALL_PHASES, which turns on the
clock64() counters at its PHASE marks (into build/), runs it once in each
mode at chip_smoke.py phase 4c's inputs (B=16, N=2048, seeded weights,
request 0's ERPC cloud) on sa1's three scales and a regressor head's two,
at the centroids a CTA that the wrappers choose: the ball mode, and the
mask mode on dense_selection_mask's mask. It checks each output bitwise
against the wrappers' launch and prints for each scale and mode thread 0's
cycles a CTA in each phase, summed over the CTA's row tiles (and over the
mask mode's passes): the set-up (copies issued, weights loaded), the walk
(in the mask mode the read of the mask rows), the packing, the wait at
each row tile's start (the gather and the slowest warp of the previous
tile), the z pass, layer 1, its epilogue with the next row tile's gather
issued, layer 2, its epilogue (the max) and the output. Barrier waits fall
in the phase that ends at the barrier. Needs a CUDA device and nvcc.
"""

import ctypes
import os
import subprocess
import sys

PHASES = ("set-up", "walk", "pack", "tile wait", "z pass", "layer 1",
          "epilogue 1 + gather", "layer 2", "epilogue 2", "output")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ball_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.events.erpc import (
        erpc_batch_transform,
        rasterize_erpc,
        resample_draws,
    )
    from ev2hands_tpu_torch.model.tehnet import TEHNet
    from ev2hands_tpu_torch.ops import _build
    from ev2hands_tpu_torch.ops import fps as kfps
    from ev2hands_tpu_torch.ops import grouping as kgrp
    from ev2hands_tpu_torch.ops.pointnet import index_points, square_distance
    from ev2hands_tpu_torch.weights import init_weights

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libmsg_ball_phases.so")
    subprocess.run([_build.nvcc_path()] + _build._ARCH + _build._COMMON
                   + ["-DMSG_BALL_PHASES", "-o", lib_path,
                      os.path.join(_build.CSRC, "msg_ball.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.msg_ball_launch.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p])
    lib.msg_ball_mask_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                         + [ctypes.c_void_p])
    lib.msg_ball_phases.argtypes = [ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())

    dev = torch.device("cuda")
    B, N = cs.B, cs.N
    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N))
    net = TEHNet(cfg.model, device="cuda")
    net.load_state_dict(init_weights(torch.Generator().manual_seed(0), cfg.model))
    net.eval()
    raw, lab = cs.raw_request(np, 0)
    _, _, n_valid = rasterize_erpc(torch.from_numpy(raw), torch.from_numpy(lab),
                                   cfg.sensor.width, cfg.sensor.height)
    draws = resample_draws(n_valid, N, torch.Generator().manual_seed(100))
    with torch.inference_mode():
        events = erpc_batch_transform(
            torch.from_numpy(raw).to(dev), torch.from_numpy(lab).to(dev), draws=draws,
            width=cfg.sensor.width, height=cfg.sensor.height, n_out=N).events
        l0 = events[..., :3].contiguous()
        feats = torch.randn((B, N, cfg.model.num_classes), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(5))
        heads = net.left_mano_regressor.sa1
        for name, sa, pts in (("sa1", net.sa1, events), ("heads sa1", heads, feats)):
            new_xyz = index_points(l0, kfps.fps(l0, sa.npoint)).contiguous()
            S = new_xyz.shape[1]
            sq = square_distance(new_xyz, l0)
            stream = torch.cuda.current_stream().cuda_stream
            for i, (r, k) in enumerate(zip(sa.radius_list, sa.nsample_list)):
                f = sa.folded_scale(i, l0, pts, new_xyz)
                widths = (*f.W2.shape, f.W3.shape[1])
                folded = [t.contiguous() for t in f]
                sel = kgrp.dense_selection_mask(sq, r, k).contiguous()
                modes = (
                    ("ball", k, lambda out: lib.msg_ball_launch(
                        *(t.data_ptr() for t in (l0, new_xyz, *folded)), out.data_ptr(),
                        B, S, N, *widths, r * r, k, 0, stream),
                     lambda: kgrp.fused_msg_scale(l0, new_xyz, f, r, k)),
                    ("mask", 0, lambda out: lib.msg_ball_mask_launch(
                        *(t.data_ptr() for t in (sel, *folded)), out.data_ptr(),
                        B, S, N, *widths, 0, stream),
                     lambda: kgrp.dense_msg_scale_2d(f, sel)),
                )
                for mode, nsample, run, wrapper in modes:
                    out = torch.empty((B, S, widths[2]), device=dev)
                    err = run(out)
                    torch.cuda.synchronize()
                    if err != 0:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                    if not torch.equal(out, wrapper()):
                        raise AssertionError("the instrumented kernel differs from the kernel")
                    counts = (ctypes.c_ulonglong * 16)()
                    lib.msg_ball_phases(counts)
                    ctas = counts[10]
                    plan = kgrp.ball_plan(widths, B, S, N, nsample)
                    total = sum(counts[j] for j in range(10)) / ctas
                    route = "streamed" if plan["streamed"] else "resident"
                    print(f"{name} scale {i} {widths} r={r} K={k}, {mode} mode: {ctas} CTAs "
                          f"of {plan['tile']} centroids, {route} weights, cycles a CTA "
                          f"{total:.0f}: " + ", ".join(
                              f"{PHASES[j]} {counts[j] / ctas:.0f} "
                              f"({100 * counts[j] / ctas / total:.1f}%)" for j in range(10)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
