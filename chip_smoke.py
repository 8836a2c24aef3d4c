#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the port from ev2hands_tpu_torch/csrc with nvcc
     for sm_90a, one process per source, timed, and print each kernel
     function's registers, stack frame and spill bytes from ptxas (a spill
     in csrc/msg_ball.cu, either mode, fails), and the tensor-core MMA
     instructions in csrc/msg_ball.cu's SASS (cuobjdump; none fails); then
     the host batch loader (csrc/ev2hands_loader.cpp) with g++;
  3. the FPS kernel against its plain version on ERPC clouds at its three
     shapes (2048->512, 512->128, 2048->128) at the serving batch (B=16),
     the training batch (B=8, random starts) and the evaluation batch
     (B=32): equal indices; each timed with its microseconds a greedy step
     and its chain floor (the same kernel with no distance work: only the
     steps' barriers and reductions); then the sweep of the kernel's
     instantiations at N = 8192, 2048 and 512 (each thread count that holds
     N, with the two redux.sync and with the 64-bit butterfly, equal
     indices, and the floor), timed;
  4. the block-sparse grouping kernel (csrc/msg_dense.cu's sparse kernel),
     one scale a launch (msg_scale_sparse),
     against its plain version on the three sa1 scales, inputs from the real
     preparation at B=16, S=512, N=2048, nb=256: max abs diff <= 1e-4;
     prints each scale's tile activity;
 4b. the same kernel with all three sa1 scales in one launch
     (msg_fused_scales_sparse) on the same inputs through the layer's fused
     preparation
     (stacked scales, union tile activity): max abs diff <= 1e-4 against its
     plain version, and its difference from phase 4's three sections;
     prints the union activity and each scale's selected pairs;
 4c. the dense grouping ops (csrc/msg_ball.cu, one tensor-core chain behind
     its mask mode and its ball mode; no model path runs them) on the same
     sa1 inputs, each scale folded in original point order: each of the
     four wrappers once a scale, counted (3 launches each), within 1e-4 of
     its plain version; the mask ops (dense_msg_scale_2d,
     dense_msg_scale_2d_batched, the mask mode) within 1e-4 of phase 4's
     K2 output (an f32 FMA chain: not bitwise) and bitwise equal to each
     other; the in-kernel-selection ops (fused_msg_scale, dense_msg_scale,
     the ball mode) bitwise equal to the mask ops on every (b, s) whose
     selection equals dense_selection_mask's (the others are counted and
     printed), and to each other; each timed with its plain version and its
     bound at the tensor cores' rate (three TF32 products for each f32
     product), with the f32 bound beside it; each mode timed at 4, 8, 16
     and 32 centroids a CTA, every tile the same bits; then
     dense_msg_scale_2d and fused_msg_scale at the regressor heads' two
     sa1 scales beside the model's dense route (_dense_scale) on the same
     inputs, each within 1e-4 of its plain version, the mask mode bitwise
     the ball mode where the selections agree, with the selected pairs,
     both bounds and the sweep;
  5. serving: InferencePipeline at full TEHNet width (B=16, N=2048, seeded
     weights, synthetic MANO) answers 4 requests with exactly 3 FPS and 3
     grouping launches per request and finite outputs; then 2 windows of one
     request against the same port on the CPU (plain versions) with the same
     weights and draws: atol 1e-3 on logits and MANO parameters, 1e-4 m on
     vertices and joints (f32 on both; sums in another order);
  6. the pipeline's windows/s at B=16 (CUDA events, a new polarity flip per
     request);
  7. where the time goes: the device time of each top-level TEHNet module
     (CUDA events from forward hooks) and of the ERPC + MANO remainder, and
     the busiest CUDA kernels from torch.profiler with their sum as a share
     of the unprofiled request time (the device's busy share);
  8. training (make_train_step at full width, B=8, N=2048, augment=True,
     pallas_gather=True, pallas_gather_bwd=True, seeded weights, synthetic
     MANO, batches made like the JAX package's synthetic ones): a first step
     records the inputs of the four one-hot gathers (sa1, sa2, both
     regressor heads' sa1); the gather kernel against its plain version on
     them (bitwise) and the scatter-add kernel on seeded cotangents (within
     1e-5 * (1 + sum of |contributions|): its sums run in an order fixed
     by the inputs, index_add_'s in another), launched twice at each shape with
     bitwise-equal outputs, and grouped_gather's backward through it run
     twice at each shape that needs a gradient, bitwise equal; each timed
     beside torch.gather / index_add and its bound, per call (the host's
     time between launches included) and on the device alone (calls queued
     behind a spin kernel), with the slots per source row it sums;
  9. 4 training steps through the entry point with exactly 4 FPS, 4 gather
     and 3 scatter-add launches a step (sa1 gathers the input cloud, which
     needs no gradient) and no grouping launch, counted by layer too, finite
     losses, the collision term computed, every parameter and BatchNorm
     statistic moved by the first step;
 10. two kernel-route steps from the same weights and draws (deterministic
     FPS, no dropout): every loss term, gradient, BatchNorm statistic and
     parameter after Adam bitwise equal; the cotangent at every boundary the
     backward crosses (each module's output, three_nn_interpolate,
     attention, MANO, the collision term) is recorded, and where the steps
     differ the first boundary in backward order whose cotangent differs is
     named; then the kernel route against the plain route on the card, one
     step each from the same weights and draws, and the card against the
     CPU port at B=2, tolerances stated at each check;
 11. training windows/s at B=8 (CUDA events over 10 steps after 2 warm-ups,
     a new polarity flip per step), the peak device memory of those steps,
     the host syncs of one step by site (none from ops/fps.py; and the
     count with the checked public fps in the model's place), and the top
     device kernels of one step;
 12. Ev2Hands-S evaluation: evaluate_dataset at full TEHNet width in the
     fused configuration (pallas_fused_msg=True, B=32, N=2048, seeded
     weights, synthetic MANO) on synthetic rows held in memory (65,536
     events, 16 frames), 8 batches, with exactly 3 FPS, 1 fused grouping and
     no per-scale grouping launch a batch, a finite report over 256 frames,
     the first batch's predicted joints and vertices of 2 windows against
     the port on the CPU with the same weights and draws (atol 1e-4 m), and
     the evaluation windows/s;
 13. Ev2Hands-R evaluation: evaluate_recording on a synthetic recording
     written to a temporary directory, B=32, 96 windows, with the same
     launch counts a batch, a non-collision score in [0, 100], a finite
     MPJPE, the end-to-end windows/s and the shares of the wall time spent
     in host windowing and in the collision score;
 14. the training loop: train() at full TEHNet width (B=8, N=2048, the
     kernel route of phase 8, warm-started from the seeded weights) on
     synthetic Ev2Hands-S rows held in memory through the native loader,
     which must be the source used; 6 steps with an evaluation of 2 batches
     at B=32 every 3 steps, with exactly 4 FPS, 4 gather and 3 scatter-add
     launches a step and 3 FPS and 3 grouping launches an evaluation
     batch, finite losses and a checkpoint at step 3; a fresh model and
     Adam restored from that checkpoint take steps 3-5 with the loop's
     batches and draws to the loop's bits (every model tensor and Adam
     state tensor); the loop's windows/s and the shares of its wall time
     spent waiting on the loader, evaluating and saving; the native
     loader's host time a batch beside the Python reader's;
 15. finetuning: finetune() on a synthetic Ev2Hands-R recording in a
     temporary directory (B=8, 4 steps, an evaluation of 2 batches at B=8
     every 2 steps, warm-started from the seeded weights) with the same
     launch counts a step and an evaluation batch, finite losses,
     windows/s and shares; then one finetuning step on the card against
     the port on the CPU at B=2 with the same weights and resample draws
     (deterministic FPS, no dropout), the regressors' translation bias
     raised by 0.4 m in z so that the 2-D term's projection is not at the
     camera centre: every loss term within 1e-4 relative (at the seeded
     weights, where depths near 0 amplify rounding, the pair is logged);
 16. serving export: export.export_serving at full TEHNet width (B=16,
     8,192 padded events a window, n_points=2048, seeded weights) on the
     card, timed, saved and loaded (.pt2, bytes and seconds printed); the
     graph holds exactly 3 ev2hands.fps and 3 ev2hands.msg_scale_sparse
     nodes; every loaded parameter, buffer and constant is on the card and
     equal to the live one; 4 requests through the loaded program with
     exactly 3 FPS and 3 grouping launches each, bitwise equal to the live
     serving function on the same inputs and uniforms; both timed
     (windows/s); then the same with pallas_fused_msg=True (1 fused
     grouping node and launch a request);
 17. the demo: demo.run_demo on a synthetic recording, B=8, 50 windows (the
     tail batch holds 2), weights with the hands at 0.4 m in front of the
     camera, once with the splat pane and once with the device pane, into
     an in-memory sink: 50 frames of [260, 1038, 3] uint8, exactly 3 FPS
     and 3 grouping launches a batch, inference and steady-state windows/s;
     then the tail batch's windows through the demo step on the card and
     on the CPU with the same weights and uniforms: xy, polarity and the
     segmentation bitwise, vertices within 1e-4 m, projected vertices
     within the pixel bound of that gate (stated in the log), the
     rasterised pane equal but on at most 1% of its covered pixels (the
     differing ones counted and printed);
 18. the 4-channel input: raw_window_transform -> TEHNet(erpc=False) ->
     MANO at B=16, N=2048, 4 requests with exactly 3 FPS and 3 grouping
     launches each, windows/s, and 2 windows against the CPU (atol 1e-3 on
     logits and MANO parameters, 1e-4 m on vertices and joints);
 19. the MANO loader: official-layout MANO pickles (chumpy objects, a scipy
     sparse J_regressor) written from synthetic_mano_models(0) and read
     back through cfg.mano.model_path; one serving request with those hands
     bitwise equal to one with the synthetic models (the left-hand
     shapedirs fix applied, as the loader applies it); then the device
     memory statistics (utils/device.get_device_memory_usage);
 20. data generation: Ev2Hands-S generated on the card at the full sensor
     (346x260) in the realistic scene with the JAX defaults of EsimConfig
     and DatagenConfig: two augmented copies (seeds 0 and 1) of a
     synthetic two-hand sequence of 10 annotation frames at 5 fps,
     interpolated to 30 fps (120 frames), through datagen.generate into
     pickle parts, stitch_rows and Ev2HandSReader.from_rows; frames/s end
     to end, events a frame, peak device memory; the split of a frame's
     time (MANO and forearms, rasterize_scene, log intensity with
     esim_step from CUDA events; the copy to the host, the expansion with
     the labels and the part write on the host clock) and the device's
     busy share; the first 3 frames of copy 0 on the card and on the CPU
     with the same draws: class ids differ on at most 0.1% of pixels, RGB
     within 1e-5 where they agree, esim_step on the card from the CPU's
     log frames bitwise equal in the four compact fields and the state,
     event counts within 1%; 2 training steps at B=8, N=2048 on the kernel
     route on generated windows (4 FPS, 4 gather, 3 scatter-add launches a
     step, finite losses) and one serving request of 16 generated windows
     (3 FPS, 3 grouping launches);
 21. data parallel at world size 1 over NCCL (parallel/mesh.py): 2
     kernel-route training steps at B=8 (phase 10's configuration, batches
     and given draws) through the mesh route, every loss term, gradient,
     BatchNorm statistic and parameter after Adam bitwise equal to the same
     steps without a mesh, counted (3 FPS, 4 gather, 3 scatter-add a step:
     deterministic FPS shares the heads' draw); windows/s from a second,
     warm run, and the collectives' calls and share of the wall time from
     a third run of the same steps under torch.profiler (as for every
     multi-device run);
 22. data parallel over two gloo ranks, both on the card (started once for
     phases 22 and 24a, the kernels built by this process): the same 2
     steps at a global B=8, the first against the one-process step within
     STEP_BOUNDS["data_parallel"] (f32 sums in another order); the second
     step again, from the one-process state after the first, within
     STEP_BOUNDS["data_parallel_resync"] (the free-running second step is
     only logged beside its first-order prediction and must be finite:
     Adam's first update turns rounding in near-zero gradients into 2 lr);
     the sharded mid-run evaluation (train.evaluate, 4 batches of 32, 16 a
     rank, predictions all-gathered) with the unsharded score and AUCs
     within rtol 1e-5; one finetuning step (finite losses); launches
     counted on each rank; windows/s and collectives; which ops gloo
     carries for CUDA tensors on this build;
 23. dense_train: one step on the dense route (multiplicity-weighted
     BatchNorm sums) against the gather route's first step of phase 21,
     within STEP_BOUNDS["dense_train"]; 3 FPS launches and no other;
 24. event parallel (parallel/event_parallel.py), over NCCL at world size
     1 and over gloo at (data 1, event 2) with both ranks on the card: the
     eval forward at B=16 against the one-process forward (K1, K2) on the
     same ERPC clouds, every FPS index equal and every output within 1e-4,
     and one dense_train step against phase 23's, within
     STEP_BOUNDS["event_parallel"]; no kernel launch (the event route
     shards FPS and the pair work in plain torch, as the JAX package does);
     STEP_BOUNDS come from chip_smoke_tolerances.py;
 25. the split export: export_serving(data_parallel=2) and load_serving on
     [card, card], one request of B=16 split over both, each shard bitwise
     equal to the one-device program, 3 FPS and 3 grouping launches a
     shard, windows/s; then loaded on [CPU, card], which moves the first
     shard's program to the CPU: that shard within phase 5's card-against-
     CPU limits, the other bitwise;
 26. fused regressor heads (ModelConfig.fused_regressors): 4 serving
     requests at B=16, N=2048 (3 FPS and 3 grouping launches each) against
     the separate heads on the same draws: the ERPC cloud exact, logits
     within 1e-3, every hand output within 1e-4;
 27. bf16 eval (ModelConfig.bf16_eval), the same requests: the 12 FPS
     indices and selection masks of a forward equal to the float32
     forward's, every conv and BatchNorm output in the dtype that the CPU
     port gives it (tests/test_torch_bf16_routing.py holds that against
     JAX), no request's logits the float32 bits, logits cosine > 0.999,
     argmax agreement > 0.98 and the MANO parameters within 3e-2
     (tests/test_bf16.py:219's bound); windows/s and peak memory of the
     default, fused and bf16 pipelines, in turns;
 28. bf16 training (ModelConfig.bf16_train; B=8, augment, the one-hot
     gather): 2 steps counted (4 FPS, 4 gather, 3 scatter-add a step),
     every conv and BatchNorm output in the CPU port's dtype, parameters,
     BatchNorm statistics and Adam state float32, two steps from one state
     bitwise equal, the first step not the float32 step's bits and within
     STEP_BOUNDS["bf16_train"] of it (losses and statistics; the gradients
     decorrelate at random init and go unchecked), the loss falling over
     TRAJECTORY_STEPS steps on one batch (tests/test_bf16.py:137's
     criterion); windows/s and peak memory beside float32, in turns;
 29. uv_split_gather with the one-hot gather off: one step, every gather
     layer on the u/v route and no one-hot gather launched, within
     STEP_BOUNDS["uv_split"] of the index route's step;
 30. the serving export with an event mesh: rank 0 of two gloo ranks on the
     card, a (data 1, event 2) mesh, exports and saves; both load it and
     serve phase 16's first request: every output within rtol = atol = 1e-5
     of phase 16's one-device program, the sharded FPS indices equal to
     K1's, no kernel launched; export, save and load seconds and the event
     ops in the graph;
 31. a `kernels` JSON line (times from CUDA events, bounds from this run's
     inputs), the gather and scatter-add also by training shape, FPS with
     its chain floor, every phase-3 shape and the sweep;
 32. last line: {"ok": true, "device": {...}}.

Exits non-zero and prints no result without a CUDA device, or without the
repository's package beside it.
"""

import collections
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) flop/s
# and dense TF32 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# csrc/msg_ball.cu (both modes): TF32 products for each f32 product (the
# 3xTF32 split), and the centroids a CTA that phase 4c sweeps
BALL_SPLIT = 3
BALL_TILES = (4, 8, 16, 32)
B, N = 16, 2048
REQUESTS = 4
TRAIN_B = 8
TRAIN_STEPS = 4
EVAL_B = 32
EVAL_BATCHES = 8
REAL_WINDOWS = 96
# the training loop (phase 14) and finetuning (phase 15): steps, the
# evaluation interval, the evaluation's frames and batch
LOOP_STEPS, LOOP_SAVE_ITER, LOOP_EVAL_FRAMES = 6, 3, 64
FT_STEPS, FT_SAVE_ITER, FT_EVAL_FRAMES, FT_EVAL_B = 4, 2, 16, 8
TRAIN_PER_STEP = {"fps": 4, "onehot_gather": 4, "onehot_scatter_add": 3}
EVAL_PER_BATCH = {"fps": 3, "msg_sparse": 3}
# the one-hot gathers of a training step, in call order
GATHER_LAYERS = ("sa1", "sa2", "left regressor sa1", "right regressor sa1")
# the dense grouping ops: wrapper, the JAX function it ports, takes a mask
# (the mask mode of csrc/msg_ball.cu) or selects in the kernel (its ball
# mode)
DENSE_OPS = (
    ("dense_msg_scale", "ev2hands_tpu/ops/pallas_grouping.py:203", False),
    ("dense_msg_scale_2d", "ev2hands_tpu/ops/pallas_grouping.py:304", True),
    ("fused_msg_scale", "ev2hands_tpu/ops/pallas_grouping.py:440", False),
    ("dense_msg_scale_2d_batched", "ev2hands_tpu/ops/pallas_grouping.py:673", True),
)


def log(*a):
    print(*a, flush=True)


def kernel_counters():
    """Every kernel wrapper of the port, by its name in the kernels line;
    each counts its own launches."""
    from ev2hands_tpu_torch.ops import fps as kfps
    from ev2hands_tpu_torch.ops import gather as kga
    from ev2hands_tpu_torch.ops import grouping as kgrp

    return {"fps": kfps.fps, "msg_sparse": kgrp.msg_scale_sparse,
            "msg_fused_sparse": kgrp.msg_fused_scales_sparse,
            "onehot_gather": kga.onehot_gather,
            "onehot_scatter_add": kga.onehot_scatter_add,
            **{name: getattr(kgrp, name) for name, _, _ in DENSE_OPS}}


def reset_launches():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def check_launches(what, launches, per_unit, units):
    """Every kernel launched exactly ``per_unit`` times per unit of work
    (0 where ``per_unit`` does not name it)."""
    for name, n in launches.items():
        want = per_unit.get(name, 0) * units
        if n != want:
            raise AssertionError(f"{what}: {name} launched {n} times, want {want}")


def demangle(names, nvcc):
    """``names`` demangled by the toolkit's ``cu++filt`` (beside ``nvcc``),
    without parameter lists; the mangled names where it cannot."""
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    for flags in (["-p"], []):
        try:
            out = subprocess.run([filt] + flags, input="\n".join(names) + "\n",
                                 capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.SubprocessError):
            return list(names)
        lines = out.stdout.splitlines()
        if out.returncode == 0 and len(lines) == len(names):
            return lines
    return list(names)


def ptxas_report(build_logs, nvcc):
    """One line per kernel function of each source built in this run: its
    name (each template instance apart), registers, stack frame and spill
    bytes from ptxas' report -> [(source, name, spill bytes)]."""
    rows = []
    for source, text in sorted(build_logs.items()):
        fn, frame = None, ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
            elif "spill" in line:
                frame = line.strip()
            elif fn and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line)
                rows.append((source, fn, regs.group(1) if regs else "?", frame))
                fn, frame = None, ""
    names = demangle([r[1] for r in rows], nvcc) if rows else []
    spills = []
    for (source, _, regs, frame), name in zip(rows, names):
        log(f"  ptxas {source} {name}: {regs} registers, {frame}")
        spills.append((source, name, sum(
            int(n) for n in re.findall(r"(\d+) bytes spill", frame))))
    return spills


def sass_mma_count(lib_path, nvcc):
    """(tensor-core MMA instructions (HMMA, HGMMA) in the SASS of a built
    library, {kernel function: the instructions of each loop that holds an
    MMA}), from the toolkit's cuobjdump beside ``nvcc``. A loop's length
    shows what ptxas put beside its MMAs (csrc/msg_ball.cu: the 3xTF32
    split once a k-step, or again for each output tile)."""
    out = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                          lib_path], capture_output=True, text=True, check=True,
                         timeout=120).stdout
    loops = {}
    for text in re.split(r"\n\s*Function : ", out)[1:]:
        ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", text)]
        at = {a: i for i, (a, _) in enumerate(ins)}
        sizes = set()
        backs = [i for i, (a, op) in enumerate(ins)
                 if (m := re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op))
                 and int(m.group(1), 16) < a]
        for i in backs:   # innermost loops that hold an MMA
            start = at.get(int(re.search(r"0x([0-9a-f]+)", ins[i][1]).group(1), 16), i)
            if (not any(start <= j < i for j in backs)
                    and any(re.search(r"\bHG?MMA\.", o) for _, o in ins[start:i])):
                sizes.add(i + 1 - start)
        if sizes:
            loops[text.split("\n", 1)[0].strip()] = sorted(sizes)
    return sum(1 for line in out.splitlines() if re.search(r"\bHG?MMA\.", line)), loops


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean ms of ``fn`` over ``iters`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def raw_request(np, seed, width=346, height=260):
    """bench.py-style raw windows [B, N, 4] and labels from a numpy seed."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.randint(0, int(5e6), (B, N))).astype(np.float32)
    raw = np.stack([
        rng.randint(0, width, (B, N)).astype(np.float32),
        rng.randint(0, height, (B, N)).astype(np.float32),
        t,
        rng.randint(0, 2, (B, N)).astype(np.float32),
    ], axis=-1)
    return raw, rng.randint(0, 4, (B, N)).astype(np.int32)


def profiled_kernels(torch, fn, reps, what):
    """The device kernels of ``fn()`` under the profiler, by name, largest
    first: (name, device ms a rep, launches a rep) over ``reps`` reps in the
    call; raises where the profiler records no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []   # device-side events only (operators would count twice)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            kernels.append((e.key, dev_us / 1e3 / reps, e.count // reps))
    if not kernels:
        raise AssertionError(f"{what}: the profiler recorded no device time")
    return sorted(kernels, key=lambda k: -k[1])


def where_the_time_goes(torch, pipe, requests):
    """Phase 7: per-module device times of one request (CUDA events from
    forward hooks on TEHNet's top-level children), then the profiler's
    device kernels over the same requests with the hooks removed."""
    pending, opened, handles = [], {}, []

    def pre(name):
        def hook(module, args):
            opened[name] = torch.cuda.Event(enable_timing=True)
            opened[name].record()
        return hook

    def post(name):
        def hook(module, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pending.append((name, opened.pop(name), ev))
        return hook

    for name, child in pipe.net.named_children():
        handles.append(child.register_forward_pre_hook(pre(name)))
        handles.append(child.register_forward_hook(post(name)))
    R = len(requests)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for raw, lab, gen in requests:
        pipe(raw, lab, gen)
    end.record()
    end.synchronize()
    for h in handles:
        h.remove()
    total_ms = start.elapsed_time(end) / R
    stages = collections.defaultdict(float)
    for name, a, b in pending:
        stages[name] += a.elapsed_time(b) / R
    stages["rest (ERPC, attention, regressor FPS, MANO)"] = \
        total_ms - sum(stages.values())
    log(f"breakdown: {total_ms:.3f} ms per request of {B} windows (CUDA "
        f"events, {R} requests, hooks on)")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        log(f"  stage {name:45s} {ms:9.3f} ms  {100 * ms / total_ms:5.1f}%")

    def run():
        for raw, lab, gen in requests:
            pipe(raw, lab, gen)

    kernels = profiled_kernels(torch, run, R, "breakdown")
    busy_ms = sum(k[1] for k in kernels)
    # the profiler slows the host, so the busy share is taken against the
    # request time measured above
    log(f"breakdown: device kernels {busy_ms:.3f} ms per request = "
        f"{100 * busy_ms / total_ms:.1f}% busy of {total_ms:.3f} ms")
    for name, ms, count in kernels[:12]:
        log(f"  kernel {ms:9.3f} ms x{count:<5d} {name[:100]}")


def fps_phase(torch, np, kfps, index_points, l0, l1, dev):
    """Phase 3: the FPS kernel against its plain version (equal indices) at
    the serving (B=16, start 0), training (B=8, random starts) and
    evaluation (B=32, start 0) shapes, each timed with its microseconds a
    greedy step, its chain floor (the same kernel with no distance work) and
    its bound; then the sweep of the kernel's instantiations at N = 8192,
    2048 and 512. -> (the serving rows, which make the kernels line's pass,
    the sweep's rows)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    tb = l0[:TRAIN_B].contiguous()
    t_start = [torch.randint(0, n, (TRAIN_B,), generator=gen, device=dev,
                             dtype=torch.int32) for n in (N, 512, N)]
    tb1 = index_points(tb, kfps.fps(tb, 512, t_start[0])).contiguous()
    eb = torch.cat([l0, l0.flip(1)]).contiguous()      # B=32, rows differ
    eb1 = index_points(eb, kfps.fps(eb, 512)).contiguous()
    shapes = [
        ("serving", "sa1 2048->512", l0, 512, None),
        ("serving", "sa2 512->128", l1, 128, None),
        ("serving", "regressor 2048->128", l0, 128, None),
        ("training", "sa1 2048->512", tb, 512, t_start[0]),
        ("training", "sa2 512->128", tb1, 128, t_start[1]),
        ("training", "regressor 2048->128", tb, 128, t_start[2]),
        ("evaluation", "sa1 2048->512", eb, 512, None),
        ("evaluation", "sa2 512->128", eb1, 128, None),
        ("evaluation", "regressor 2048->128", eb, 128, None),
    ]
    rows = []
    for path, name, xyz, npoint, start in shapes:
        Bx, n = xyz.shape[:2]
        got = kfps.fps(xyz, npoint, start)
        ref = kfps.fps_plain(xyz, npoint, start)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not torch.equal(got, ref):
            bad = (got != ref).nonzero()[:5].tolist()
            raise AssertionError(f"FPS {path} {name}: indices differ at {bad}")
        def run(work=True):
            return kfps.fps_unchecked(xyz, npoint, start, work=work)

        ms = cuda_ms(torch, run, 20)
        floor_ms = cuda_ms(torch, lambda: run(False), 20)
        dev_ms = device_ms(torch, run)
        floor_dev_ms = device_ms(torch, lambda: run(False))
        plain_ms = cuda_ms(torch, lambda: kfps.fps_plain(xyz, npoint, start), 3, 1)
        # 9 f32 ops per distance update (3 sub, 3 mul, 2 add, 1 min)
        ops = Bx * npoint * n * 9
        nbytes = Bx * n * 3 * 4 + Bx * 4 + Bx * npoint * 4
        row = dict(path=path, shape=name, B=Bx, config=list(kfps.kernel_config(n)),
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, chain_floor_ms=floor_ms,
                   device_ms=dev_ms, floor_device_ms=floor_dev_ms,
                   us_per_step=1e3 * dev_ms / npoint,
                   floor_us_per_step=1e3 * floor_dev_ms / npoint, library_ms=None)
        row["bound_ms"], row["bound_by"] = bound(ops, nbytes)
        rows.append(row)
        log(f"fps {path} B={Bx} {name} (threads x points {row['config']}): indices "
            f"equal; kernel {ms:.4f} ms per call, {dev_ms:.4f} ms on the device = "
            f"{row['us_per_step']:.4f} us a step; chain floor {floor_ms:.4f} ms per "
            f"call, {floor_dev_ms:.4f} ms on the device = "
            f"{row['floor_us_per_step']:.4f} us a step; plain {plain_ms:.3f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']})")

    # the sweep: each thread count that holds N with its points a thread,
    # with the two redux.sync, with the 64-bit butterfly, and the floor; on
    # the device alone (calls queued behind a spin kernel)
    sweep = []
    rng = np.random.RandomState(7)
    big = torch.from_numpy(rng.uniform(-1, 1, (B, 8192, 3)).astype(np.float32)).to(dev)
    for xyz in (big, big[:, :4096].contiguous(), l0, big[:, :1024].contiguous(), l1):
        n = xyz.shape[1]
        npoint = n // 4
        ref = kfps.fps_plain(xyz, npoint)
        for threads, most in kfps.CONFIGS.items():
            ppt = 1
            while threads * ppt < n:
                ppt *= 2
            if ppt > most:
                continue
            row = dict(N=n, B=B, npoint=npoint, threads=threads, ppt=ppt,
                       chosen=kfps.kernel_config(n) == (threads, ppt))
            for key, redux, work in (("redux_ms", True, True),
                                     ("butterfly_ms", False, True),
                                     ("floor_ms", True, False)):
                def run():
                    return kfps.fps_unchecked(xyz, npoint, config=(threads, ppt),
                                              redux=redux, work=work)
                if work and not torch.equal(run(), ref):
                    raise AssertionError(f"FPS sweep N={n} {threads}x{ppt} "
                                         f"redux={redux}: indices differ")
                row[key] = device_ms(torch, run)
            sweep.append(row)
            log(f"fps sweep N={n} B={B} npoint={npoint} {threads} threads x {ppt} "
                f"points{' (chosen)' if row['chosen'] else ''}, on the device: redux "
                f"{row['redux_ms']:.4f} ms = {1e3 * row['redux_ms'] / npoint:.4f} us a "
                f"step, butterfly {row['butterfly_ms']:.4f} ms = "
                f"{1e3 * row['butterfly_ms'] / npoint:.4f} us, floor "
                f"{row['floor_ms']:.4f} ms = {1e3 * row['floor_ms'] / npoint:.4f} us")
    return rows, sweep


def fused_check(torch, kgrp, sa1, new_xyz, sq, perm, xyz_p, pts_p, k2_cat):
    """Phase 4b: the fused multi-scale kernel against its plain version and
    against the per-scale kernel's sections ``k2_cat`` -> its kernels-line
    row."""
    stacked, sel_all, act, sections, blocks = sa1.fused_scale_inputs(
        new_xyz, sq, perm, xyz_p, pts_p)
    nb = sa1.pallas_nb

    def kernel():
        return kgrp.msg_fused_scales_sparse(stacked, sel_all, act, sections, nb,
                                            blocks)

    def plain():
        return kgrp.msg_fused_scales_sparse_plain(stacked, sel_all, act, sections, nb)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    vs_k2 = (got - k2_cat).abs().max().item()
    log(f"msg_fused_sparse: max abs diff {err:.3g} from its plain version, "
        f"{vs_k2:.3g} from the per-scale kernel's three sections")
    if not err <= 1e-4:
        raise AssertionError(f"fused grouping: max abs diff {err}")
    selected = [int(sel_all[:, r].sum().item()) for r in range(len(sections))]
    ops = sum(n * 2 * (c1 * c2 + c2 * c3)
              for n, (c1, c2), c3 in zip(selected, blocks, sections))
    # R mask slices of nb floats per union-active tile; u, v, the diagonal
    # weight blocks, the biases, act and the output once each
    active_tiles = int(act.sum().item())
    weights = sum(c1 * c2 + c2 * c3 for (c1, c2), c3 in zip(blocks, sections))
    nbytes = 4 * (len(sections) * nb * active_tiles + weights
                  + sum(t.numel() for t in (stacked.u, stacked.v, stacked.b2,
                                            stacked.b3, act, got)))
    row = dict(widths=[[c1, c2, c3] for (c1, c2), c3 in zip(blocks, sections)],
               union_tile_activity=act.float().mean().item(),
               selected_pairs=selected, max_abs_err=err, max_abs_diff_vs_k2=vs_k2,
               ms=cuda_ms(torch, kernel, 20), plain_ms=cuda_ms(torch, plain, 3, 1),
               ops=ops, bytes=nbytes)
    row["bound_ms"], row["bound_by"] = bound(ops, nbytes)
    log(f"msg_fused_sparse {row['widths']}: union tile activity "
        f"{row['union_tile_activity']:.4f}, selected pairs per scale {selected}; "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    return row


def dense_ops_phase(torch, kgrp, sa1, l0, events, new_xyz, sq, k2_outs):
    """Phase 4c: the four dense grouping ops on sa1's scales, folded in
    original point order -> (their rows by name, the launches of the
    counted run)."""
    scales = []
    for i, (r, k) in enumerate(zip(sa1.radius_list, sa1.nsample_list)):
        scales.append((sa1.folded_scale(i, l0, events, new_xyz),
                       kgrp.dense_selection_mask(sq, r, k), r, k))

    def call(name, s, plain=False):
        """Wrapper ``name`` (its default blocks) or its plain version on
        scale s, as a function of nothing."""
        folded, sel, r, k = scales[s]
        if name.startswith("dense_msg_scale_2d"):
            fn = kgrp.dense_msg_scale_2d_plain if plain else getattr(kgrp, name)
            return lambda: fn(folded, sel)
        fn = kgrp.dense_msg_scale_plain if plain else getattr(kgrp, name)
        return lambda: fn(l0, new_xyz, folded, r, k)

    reset_launches()
    outs = {name: [call(name, s)() for s in range(len(scales))]
            for name, _, _ in DENSE_OPS}
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"dense ops: launches {launches}")
    check_launches("dense ops", launches,
                   {name: len(scales) for name, _, _ in DENSE_OPS}, 1)

    rows = {name: [] for name, _, _ in DENSE_OPS}
    for s, (folded, sel, r, k) in enumerate(scales):
        ball = kgrp.ball_selection_mask(l0, new_xyz, r, k)
        same = ~(ball != sel).any(dim=-1)                      # [B, S]
        log(f"dense ops scale {s} r={r} K={k}: the in-kernel selection differs "
            f"from dense_selection_mask's on {int((~same).sum().item())} of "
            f"{same.numel()} (b, s) pairs")
        C1, C2 = folded.W2.shape
        C3 = folded.W3.shape[1]
        mask_out = outs["dense_msg_scale_2d"][s]
        for name, _, takes_mask in DENSE_OPS:
            got = outs[name][s]
            err = (got - call(name, s, plain=True)()).abs().max().item()
            if takes_mask:   # the same function as K2 on the same selection
                versus, vs_err, exact = "K2", (got - k2_outs[s]).abs().max().item(), True
            else:   # the mask mode's rows where the selections agree: its bits
                versus = "dense_msg_scale_2d where the selections agree"
                vs_err = torch.where(same[..., None], got - mask_out, 0.0).abs().max().item()
                exact = torch.equal(torch.where(same[..., None], got, 0.0),
                                    torch.where(same[..., None], mask_out, 0.0))
            if not (err <= 1e-4 and vs_err <= 1e-4 and exact):
                raise AssertionError(f"{name} scale {s}: max abs diff {err} from its "
                                     f"plain version, {vs_err} from {versus} "
                                     f"({'bitwise equal' if exact else 'not bitwise'})")
            n_sel = int((sel if takes_mask else ball).sum().item())
            ops = n_sel * 2 * (C1 * C2 + C2 * C3)
            # every input once: the folded scale, the output, and the mask
            # or the coordinates
            reads = (sel,) if takes_mask else (l0, new_xyz)
            nbytes = 4 * sum(t.numel() for t in (*folded, got, *reads))
            row = dict(scale=s, widths=[C1, C2, C3], radius=r, nsample=k,
                       selected_pairs=n_sel, max_abs_err=err, vs=vs_err,
                       ms=cuda_ms(torch, call(name, s), 20),
                       plain_ms=cuda_ms(torch, call(name, s, plain=True), 3, 1),
                       ops=ops, bytes=nbytes)
            # both modes run their chain on the tensor cores: each is held
            # to that rate, the f32 bound beside it
            row["bound_ms"], row["bound_by"] = tc_bound(ops, nbytes)
            row["tc_bound_ms"] = row["bound_ms"]
            row["f32_bound_ms"] = bound(ops, nbytes)[0]
            rows[name].append(row)
            log(f"{name} scale {s} {C1, C2, C3}: {n_sel} selected pairs, max abs "
                f"diff {err:.3g} from its plain version, {vs_err:.3g} from {versus}"
                f"{' (bitwise equal)' if not takes_mask else ''}; "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}), f32 bound "
                f"{row['f32_bound_ms']:.5f} ms")
        for pair in (("fused_msg_scale", "dense_msg_scale"),
                     ("dense_msg_scale_2d", "dense_msg_scale_2d_batched")):
            if not torch.equal(outs[pair[0]][s], outs[pair[1]][s]):
                raise AssertionError(f"scale {s}: {pair[0]} and {pair[1]} differ")
        ball_out = outs["fused_msg_scale"][s]
        sweeps = {
            False: tile_sweep(torch, kgrp, folded, ball_out, k, lambda t: kgrp._launch_ball(
                "ball sweep", l0, new_xyz, folded, r, k, tile=t)),
            True: tile_sweep(torch, kgrp, folded, mask_out, 0, lambda t: kgrp._launch_mask(
                "mask sweep", folded, sel, tile=t)),
        }
        for name, _, takes_mask in DENSE_OPS:
            rows[name][-1]["tile_ms"] = sweeps[takes_mask]
    return rows, launches


def heads_dense_timing(torch, kgrp, sa, l0, feats, new_xyz):
    """Phase 4c, end: the two modes of csrc/msg_ball.cu, fused_msg_scale
    (ball) and dense_msg_scale_2d (mask, on dense_selection_mask's mask), at
    a regressor head's sa1 scales beside the model's dense route on the
    same inputs, ``feats`` standing in for the attention features
    (measurements only: the heads' path stays on the dense route); each
    within 1e-4 of its plain version, the mask mode bitwise equal to the
    ball mode where the selections agree, each swept over BALL_TILES ->
    rows by wrapper name, one a scale (pairs, times, bounds)."""
    from ev2hands_tpu_torch.ops.pointnet import square_distance

    sq = square_distance(new_xyz, l0)
    rows = {"fused_msg_scale": [], "dense_msg_scale_2d": []}
    for i, (r, k) in enumerate(zip(sa.radius_list, sa.nsample_list)):
        folded = sa.folded_scale(i, l0, feats, new_xyz)
        sel = kgrp.dense_selection_mask(sq, r, k)
        ball = kgrp.ball_selection_mask(l0, new_xyz, r, k)
        same = ~(ball != sel).any(dim=-1)                      # [B, S]
        runs = {
            "dense_msg_scale_2d": lambda: kgrp.dense_msg_scale_2d(folded, sel),
            "fused_msg_scale": lambda: kgrp.fused_msg_scale(l0, new_xyz, folded, r, k),
            "_dense_scale": lambda: sa._dense_scale(i, l0, feats, new_xyz, sq, r, k),
        }
        outs = {name: fn() for name, fn in runs.items()}
        diffs = {name: (outs[name] - outs["_dense_scale"]).abs().max().item()
                 for name in rows}
        errs = {
            "fused_msg_scale": (outs["fused_msg_scale"] - kgrp.dense_msg_scale_plain(
                l0, new_xyz, folded, r, k)).abs().max().item(),
            "dense_msg_scale_2d": (outs["dense_msg_scale_2d"] - kgrp.dense_msg_scale_2d_plain(
                folded, sel)).abs().max().item(),
        }
        for name, err in errs.items():
            if not err <= 1e-4:
                raise AssertionError(f"heads sa1 scale {i}: {name} max abs diff {err} "
                                     f"from its plain version")
        if not torch.equal(torch.where(same[..., None], outs["dense_msg_scale_2d"], 0.0),
                           torch.where(same[..., None], outs["fused_msg_scale"], 0.0)):
            raise AssertionError(f"heads sa1 scale {i}: the mask mode is not the ball "
                                 f"mode's bits where the selections agree")
        ms = {name: cuda_ms(torch, fn, 3 if name == "_dense_scale" else 20, 1)
              for name, fn in runs.items()}
        C1, C2 = folded.W2.shape
        C3 = folded.W3.shape[1]
        log(f"heads sa1 scale {i} {C1, C2, C3} r={r} K={k} S={new_xyz.shape[1]}: "
            f"the selections differ on {int((~same).sum().item())} of {same.numel()} "
            f"(b, s) pairs, the mask mode the ball mode's bits on the others; "
            + ", ".join(f"{name} {t:.4f} ms" for name, t in ms.items())
            + "; max abs diff from the plain version " + ", ".join(
                f"{name} {e:.3g}" for name, e in errs.items())
            + "; from _dense_scale " + ", ".join(
                f"{name} {d:.3g}" for name, d in diffs.items()))
        modes = (("fused_msg_scale", ball, (l0, new_xyz), k,
                  lambda t: kgrp._launch_ball("ball sweep", l0, new_xyz, folded, r, k,
                                              tile=t)),
                 ("dense_msg_scale_2d", sel, (sel,), 0,
                  lambda t: kgrp._launch_mask("mask sweep", folded, sel, tile=t)))
        for name, picked, reads, nsample, launch in modes:
            pairs = int(picked.sum().item())
            ops = pairs * 2 * (C1 * C2 + C2 * C3)
            nbytes = 4 * sum(t.numel() for t in (*folded, outs[name], *reads))
            row = dict(scale=i, widths=[C1, C2, C3], radius=r, nsample=k,
                       S=new_xyz.shape[1], selected_pairs=pairs, max_abs_err=errs[name],
                       ms=ms[name], dense_scale_ms=ms["_dense_scale"], ops=ops,
                       bytes=nbytes, f32_bound_ms=bound(ops, nbytes)[0])
            row["bound_ms"], row["bound_by"] = tc_bound(ops, nbytes)
            row["tc_bound_ms"] = row["bound_ms"]
            log(f"  {name}: {pairs} selected pairs; bound (tensor cores) "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}), f32 bound "
                f"{row['f32_bound_ms']:.5f} ms")
            row["tile_ms"] = tile_sweep(torch, kgrp, folded, outs[name], nsample, launch)
            rows[name].append(row)
    return rows


def bound(ops, nbytes):
    """(least ms, what bounds it) for ``ops`` f32 operations and ``nbytes``
    bytes on the card's published peaks."""
    t_ops, t_bytes = ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def tc_bound(ops, nbytes):
    """(least ms, what bounds it) for csrc/msg_ball.cu: its ``ops`` f32
    operations as BALL_SPLIT TF32 products each at the dense TF32 peak, or
    ``nbytes`` at the HBM rate, whichever is longer."""
    t_ops, t_bytes = BALL_SPLIT * ops / TF32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def tile_sweep(torch, kgrp, folded, want, nsample, launch):
    """csrc/msg_ball.cu at each of BALL_TILES centroids a CTA, ``launch(t)``
    running its ball mode (``nsample``) or its mask mode (``nsample`` 0) on
    ``folded`` -> ms by tile; every tile's output must be ``want``'s bits (a
    row's chain does not depend on the rows packed beside it; the max is
    exact)."""
    widths = (*folded.W2.shape, folded.W3.shape[1])
    B, N = folded.u.shape[:2]
    S = folded.v.shape[1]
    tile_ms, plans = {}, []
    for t in BALL_TILES:
        if not torch.equal(launch(t), want):
            raise AssertionError(f"msg_ball.cu at tile {t}: not the bits of the "
                                 f"wrappers' launch")
        tile_ms[t] = cuda_ms(torch, lambda t=t: launch(t), 20)
        plan = kgrp.ball_plan(widths, B, S, N, nsample, t)
        plans.append(f"{t}: {tile_ms[t]:.4f} ms ({plan['tile']} a CTA, "
                     f"{'streamed' if plan['streamed'] else 'resident'} weights, "
                     f"{plan['capacity']} rows a centroid, {plan['smem_bytes']} B)")
    chosen = kgrp.ball_plan(widths, B, S, N, nsample)
    log(f"  {'mask' if nsample == 0 else 'ball'} mode by centroids a CTA (the wrappers' "
        f"choice {chosen['tile']}): " + "; ".join(plans))
    return tile_ms


def fake_batch(np, seed, batch_size, n=N, width=346, height=260):
    """Raw windows and MANO ground truth made like the JAX package's
    synthetic training batches (__graft_entry__._fake_batch) from a numpy
    seed."""
    rng = np.random.RandomState(seed)

    def hand():
        return {
            "global_orient": rng.randn(batch_size, 3).astype(np.float32) * 0.1,
            "hand_pose": rng.randn(batch_size, 45).astype(np.float32) * 0.1,
            "shape": rng.randn(batch_size, 10).astype(np.float32) * 0.1,
            "trans": rng.randn(batch_size, 3).astype(np.float32) * 0.1,
            "valid": np.ones(batch_size, np.float32),
        }

    t = np.sort(rng.randint(0, int(5e6), (batch_size, n))).astype(np.float32)
    return {
        "events": np.stack([
            rng.randint(0, width, (batch_size, n)).astype(np.float32),
            rng.randint(0, height, (batch_size, n)).astype(np.float32),
            t,
            rng.randint(0, 2, (batch_size, n)).astype(np.float32),
        ], axis=-1),
        "labels": rng.randint(0, 4, (batch_size, n)).astype(np.int32),
        "left": hand(),
        "right": hand(),
        "handedness": np.ones((batch_size, 2), np.int32),
    }


def given_draws(torch, batch, cfg, seed):
    """The ERPC noise and resample draws of ``batch``, made on the CPU from
    a seed, so that runs on any device take the same ones."""
    from ev2hands_tpu_torch.events.erpc import (
        noise_draws,
        rasterize_erpc,
        resample_draws,
    )

    s, n = cfg.sensor, cfg.model.n_points
    _, _, n_valid = rasterize_erpc(torch.from_numpy(batch["events"]),
                                   torch.from_numpy(batch["labels"]),
                                   s.width, s.height)
    g = torch.Generator().manual_seed(seed)
    noise = noise_draws(n_valid, n // 32, s.width, s.height, g)
    total = n_valid + torch.where(noise.gate, n // 32, 0).to(n_valid.dtype)
    return resample_draws(total, n, g), noise


def step_state(net):
    """(gradients, BatchNorm buffers, parameters after the update) of
    ``net`` after a step, on the CPU."""
    grads = {k: p.grad.detach().cpu().clone() for k, p in net.named_parameters()}
    bufs = {k: b.detach().cpu().clone() for k, b in net.named_buffers()}
    params = {k: p.detach().cpu().clone() for k, p in net.named_parameters()}
    return grads, bufs, params


def compare_steps(torch, name, a, b, loss_rtol, cos_min, norm_tol, buf_rtol,
                  skip):
    """Hold step ``a`` = (losses, gradients, buffers) against step ``b``:
    every loss term within ``loss_rtol`` relative; per tensor a gradient
    cosine >= ``cos_min`` and a norm ratio within ``norm_tol`` of 1 (None:
    read and printed, unchecked); every BatchNorm statistic within
    ``buf_rtol`` * max(1, |b|). The gradients
    named in ``skip`` (``batchnorm_cancelled_biases``: zero by construction,
    rounding noise on both sides) are left out. -> the readings: the largest
    loss and BatchNorm deviations, the least cosine (with its tensor and
    the tensor's two norms), the largest norm deviation, and, unchecked,
    the cosine of the whole gradient (every tensor but ``skip``'s, end to
    end)."""
    (la, ga, ba), (lb, gb, bb) = a, b
    loss_dev, loss_key = max((abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-30)
                              if la[k] != lb[k] else 0.0, k) for k in lb)
    cos_lo, cos_key, cos_norms, norm_dev, bad = 1.0, None, None, 0.0, []
    for k in sorted(set(gb) - skip):
        x, y = ga[k].double().ravel(), gb[k].double().ravel()
        nx, ny = x.norm().item(), y.norm().item()
        cos = (x @ y).item() / max(nx * ny, 1e-300)
        dev = abs(nx / max(ny, 1e-300) - 1)
        if cos < cos_lo:
            cos_lo, cos_key, cos_norms = cos, k, (nx, ny)
        norm_dev = max(norm_dev, dev)
        if (cos_min is not None and cos < cos_min) or (norm_tol is not None
                                                       and dev > norm_tol):
            bad.append((k, cos, dev))
    keys = sorted(set(gb) - skip)
    x = torch.cat([ga[k].double().ravel() for k in keys])
    y = torch.cat([gb[k].double().ravel() for k in keys])
    cos_all = (x @ y).item() / max(x.norm().item() * y.norm().item(), 1e-300)
    buf_dev, buf_key = max(
        (((ba[k] - bb[k]).abs() / bb[k].abs().clamp(min=1.0)).max().item(), k)
        for k in bb)
    def limit(x):
        return "unchecked" if x is None else f"limit {x}"

    log(f"{name}: loss terms max rel diff {loss_dev:.3g} at {loss_key} (limit "
        f"{loss_rtol}); gradients min cosine {cos_lo:.9f} at {cos_key} ({limit(cos_min)}), "
        f"max norm ratio deviation {norm_dev:.3g} ({limit(norm_tol)}), "
        f"{len(skip)} BatchNorm-cancelled biases left out; whole gradient cosine "
        f"{cos_all:.9f}; BatchNorm statistics max rel diff {buf_dev:.3g} at {buf_key} "
        f"(limit {buf_rtol})")
    if loss_dev > loss_rtol or bad or buf_dev > buf_rtol:
        raise AssertionError(f"{name}: out of tolerance; gradients {bad[:5]}")
    return dict(loss=loss_dev, cos=cos_lo, norm=norm_dev, buf=buf_dev, cos_key=cos_key,
                cos_norms=cos_norms, cos_all=cos_all)


def tapped_step(torch, net, step, *args, **kwargs):
    """One training step with the cotangent recorded at every boundary the
    backward crosses: the output of each module of ``net``, the inputs and
    output of ``three_nn_interpolate`` and ``attention_block``, the outputs
    of ``apply_mano``, the vertices and output of ``collision_loss`` and the
    triangles it scores. -> (losses, {boundary: cotangent}, boundaries in
    the order their cotangents arrived). The taps are views with a hook:
    they change no value."""
    from ev2hands_tpu_torch import losses as klosses
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.model import layers as klayers
    from ev2hands_tpu_torch.model import tehnet as ktehnet
    from ev2hands_tpu_torch.ops import collision as kcoll

    cot, order, seen = {}, [], collections.Counter()

    def tap(name, x):
        if isinstance(x, dict):
            return {k: tap(f"{name}.{k}", v) for k, v in x.items()}
        if type(x) is tuple:   # a layer's outputs; named tuples hold constants
            return tuple(tap(f"{name}[{i}]", v) for i, v in enumerate(x))
        if not (isinstance(x, torch.Tensor) and x.requires_grad):
            return x
        seen[name] += 1
        key = f"{name}#{seen[name]}" if seen[name] > 1 else name
        x = x.view_as(x)

        def hook(g):
            cot[key] = g.detach().clone()
            order.append(key)
        x.register_hook(hook)
        return x

    def wrap(mod, attr, label):
        real = getattr(mod, attr)

        def tapped(*a, **k):
            a = tuple(tap(f"{label}(arg{i})", v) for i, v in enumerate(a))
            return tap(label, real(*a, **k))
        setattr(mod, attr, tapped)
        return mod, attr, real

    patched = [wrap(klayers, "three_nn_interpolate", "three_nn_interpolate"),
               wrap(ktehnet, "attention_block", "attention_block"),
               wrap(ktrain, "apply_mano", "apply_mano"),
               wrap(klosses, "collision_loss", "collision_loss"),
               wrap(kcoll, "penetration_penalty", "penetration_penalty")]
    handles = [m.register_forward_hook(
        lambda mod, a, out, name=name: tap(name or "net", out))
        for name, m in net.named_modules()]
    try:
        losses = step(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
        for mod, attr, real in patched:
            setattr(mod, attr, real)
    return losses, cot, order


def first_difference(torch, a, b):
    """(boundaries in backward order whose cotangents are not bitwise equal
    in two tapped steps, the number of boundaries); ``a`` and ``b`` are
    ``tapped_step``'s (cotangents, order)."""
    (ca, oa), (cb, _) = a, b
    differ = [k for k in oa if k not in cb or not torch.equal(ca[k], cb[k])]
    return differ, len(oa)


def host_syncs(torch, fn, checked_fps=False):
    """The host syncs of one call of ``fn``, counted under
    ``torch.cuda.set_sync_debug_mode("warn")`` -> {"file:line": count} of
    the Python lines that made them. ``checked_fps``: the model's FPS calls
    go through the public ``fps``, which checks the start on the host."""
    import warnings

    from ev2hands_tpu_torch.model import layers as klayers
    from ev2hands_tpu_torch.model import tehnet as ktehnet
    from ev2hands_tpu_torch.ops import fps as kfps

    root = os.path.dirname(os.path.abspath(__file__))
    patched = [(m, m.fps_unchecked) for m in (klayers, ktehnet)] if checked_fps else []
    for m, _ in patched:
        m.fps_unchecked = kfps.fps
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        for m, real in patched:
            m.fps_unchecked = real
    return collections.Counter(
        f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def device_ms(torch, fn, iters=20):
    """Mean device ms of ``fn`` over ``iters`` calls queued behind a spin
    kernel of about 10 ms (torch.cuda._sleep), so the host has queued them
    all before the first runs: the calls' device time without the host's
    time between launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def top_device_kernels(torch, fn, reps):
    """Device kernels of ``reps`` calls of ``fn`` under torch.profiler ->
    [(name, ms per call, launches per call)], busiest first."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        # device kernels only: a user annotation (Adam's step range) spans
        # kernels that are counted on their own
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            kernels.append((e.key, dev_us / 1e3 / reps, e.count // reps))
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    return sorted(kernels, key=lambda k: -k[1])


def training_phases(torch, np, dev, state):
    """Phases 8-11: the training step on the card -> (gather rows, scatter
    rows, launches of the training run)."""
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.model import layers as klayers
    from ev2hands_tpu_torch.model.tehnet import TEHNet, batchnorm_cancelled_biases
    from ev2hands_tpu_torch.ops import gather as kga

    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(
        n_points=N, pallas_gather=True, pallas_gather_bwd=True))
    hands = {}

    def build_step(model_cfg, device):
        c = cfg.replace(model=model_cfg)
        if device not in hands:
            h = ktrain.build_hands(c, synthetic=True, device=device)
            hands[device] = (h, ktrain.build_collision_context(h))
        net = TEHNet(model_cfg, device=device)
        net.load_state_dict(state, strict=True)
        opt = ktrain.make_optimizer(net.parameters(), c.train)
        return net, ktrain.make_train_step(net, *hands[device], c, opt,
                                           augment=True, device=device)

    net, step = build_step(cfg.model, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    batches = [fake_batch(np, 10 + i, TRAIN_B) for i in range(TRAIN_STEPS + 1)]

    # 8. a first step records the one-hot gathers' real inputs
    captured = []
    real_gather = klayers.grouped_gather

    def recording(src, idx, act, nb=128, sb=8, bwd="xla"):
        captured.append((src.detach().clone(), idx.clone(), act.clone(), nb, sb,
                         src.requires_grad))
        return real_gather(src, idx, act, nb=nb, sb=sb, bwd=bwd)

    klayers.grouped_gather = recording
    try:
        step(batches[0], gen)
    finally:
        klayers.grouped_gather = real_gather
    if len(captured) != len(GATHER_LAYERS):
        raise AssertionError(f"training step made {len(captured)} one-hot gathers")

    gather_rows, scatter_rows = [], []
    # sa1 gathers the input cloud, which carries no gradient: autograd (as
    # JAX's) runs no scatter-add for it, so a step launches three. The
    # scatter-add is checked at all four shapes and timed on the three.
    for i, (layer, (src, idx, act, nb, sb, on_path)) in enumerate(
            zip(GATHER_LAYERS, captured)):
        Bt, Nt, C = src.shape
        S, K = idx.shape[1:]
        got = kga.onehot_gather(src, idx, act, nb, sb)
        ref = kga.onehot_gather_plain(src, idx)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not torch.equal(got, ref):
            raise AssertionError(f"onehot_gather {layer}: rows differ from "
                                 f"index_points, max abs diff {err}")
        flat_idx = idx.long().reshape(Bt, -1, 1).expand(-1, -1, C)
        nbytes = sum(t.numel() * t.element_size() for t in (src, idx, got))
        row = dict(layer=layer, shape=[Bt, Nt, C, S, K], max_abs_err=err,
                   on_path=True,
                   ms=cuda_ms(torch, lambda: kga.onehot_gather(src, idx, act, nb, sb), 20),
                   plain_ms=cuda_ms(torch, lambda: kga.onehot_gather_plain(src, idx), 20),
                   library_ms=cuda_ms(torch, lambda: torch.gather(src, 1, flat_idx), 20))
        row["bound_ms"], row["bound_by"] = bound(0, nbytes)
        row["device_ms"] = device_ms(torch, lambda: kga.onehot_gather(src, idx, act, nb, sb))
        row["library_device_ms"] = device_ms(torch, lambda: torch.gather(src, 1, flat_idx))
        gather_rows.append(row)
        log(f"onehot_gather {layer} src {[Bt, Nt, C]} -> {[Bt, S, K, C]}: rows "
            f"bitwise equal (max abs diff {err}); kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
            f"ms, torch.gather {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}); device time alone: kernel "
            f"{row['device_ms']:.4f} ms, torch.gather {row['library_device_ms']:.4f} ms")

        g = torch.randn(got.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(20 + i))
        got = kga.onehot_scatter_add(g, idx, act, Nt, nb, sb)
        ref = kga.onehot_scatter_add_plain(g, idx, Nt)
        limit = 1e-5 * (1 + kga.onehot_scatter_add_plain(g.abs(), idx, Nt))
        err = (got - ref).abs()
        torch.cuda.synchronize()
        if not (err <= limit).all():
            raise AssertionError(f"onehot_scatter_add {layer}: max diff {err.max().item()}")
        # the same bits on a second launch, and through grouped_gather's
        # backward twice where the layer needs a gradient
        again = kga.onehot_scatter_add(g, idx, act, Nt, nb, sb)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"onehot_scatter_add {layer}: two launches differ by "
                                 f"{(got - again).abs().max().item()}")
        if on_path:
            grads = []
            for _ in range(2):
                leaf = src.clone().requires_grad_(True)
                kga.grouped_gather(leaf, idx, act, nb=nb, sb=sb, bwd="pallas").backward(g)
                grads.append(leaf.grad)
            torch.cuda.synchronize()
            if not torch.equal(*grads):
                raise AssertionError(f"grouped_gather {layer}: two backward runs differ")
            del grads, leaf
        rows = (idx.long().reshape(Bt, -1)
                + Nt * torch.arange(Bt, device=dev)[:, None]).reshape(-1)
        zeros, g_flat = torch.zeros((Bt * Nt, C), device=dev), g.reshape(-1, C)
        hits = torch.bincount(rows, minlength=Bt * Nt)
        nbytes = sum(t.numel() * t.element_size() for t in (g, idx, got))
        row = dict(layer=layer, shape=[Bt, Nt, C, S, K], on_path=on_path,
                   max_abs_err=err.max().item(),
                   max_err_over_limit=(err / limit).max().item(),
                   ms=cuda_ms(torch, lambda: kga.onehot_scatter_add(g, idx, act, Nt, nb, sb), 20),
                   plain_ms=cuda_ms(torch, lambda: kga.onehot_scatter_add_plain(g, idx, Nt), 20),
                   library_ms=cuda_ms(torch, lambda: torch.index_add(zeros, 0, rows, g_flat), 20))
        row["bound_ms"], row["bound_by"] = bound(g.numel(), nbytes)
        row["max_slots_per_row"] = int(hits.max().item())
        row["mean_slots_per_held_row"] = hits[hits > 0].float().mean().item()
        row["device_ms"] = device_ms(
            torch, lambda: kga.onehot_scatter_add(g, idx, act, Nt, nb, sb))
        row["library_device_ms"] = device_ms(
            torch, lambda: torch.index_add(zeros, 0, rows, g_flat))
        scatter_rows.append(row)
        log(f"onehot_scatter_add {layer} {[Bt, S, K, C]} -> {[Bt, Nt, C]}: slots per "
            f"held source row {row['mean_slots_per_held_row']:.1f} on average, "
            f"{row['max_slots_per_row']} at most; max abs "
            f"diff {row['max_abs_err']:.3g} ({row['max_err_over_limit']:.3g} of the "
            f"limit), two launches bitwise equal"
            + (", grouped_gather's backward twice bitwise equal" if on_path else "")
            + f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"index_add {row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}); device time alone: kernel {row['device_ms']:.4f} ms, "
            f"index_add {row['library_device_ms']:.4f} ms")
        del g, got, again, ref, limit, err, zeros, g_flat, hits
    del captured

    # 9. the training run through the entry point, counted; the gathers'
    # launches are also counted by layer (the i-th gather of a step is
    # GATHER_LAYERS[i]), the scatter-adds' by hooks on the gather's
    # backward node
    by_layer = collections.Counter()
    calls = [0]

    def counting(src, idx, act, nb=128, sb=8, bwd="xla"):
        layer = GATHER_LAYERS[calls[0] % len(GATHER_LAYERS)]
        calls[0] += 1
        n0 = kga.onehot_gather.launches
        out = real_gather(src, idx, act, nb=nb, sb=sb, bwd=bwd)
        by_layer["onehot_gather", layer] += kga.onehot_gather.launches - n0
        if out.grad_fn is not None:
            mark = {}

            def pre(grad_outputs):
                mark["n"] = kga.onehot_scatter_add.launches

            def post(grad_inputs, grad_outputs):
                by_layer["onehot_scatter_add", layer] += (
                    kga.onehot_scatter_add.launches - mark["n"])

            out.grad_fn.register_prehook(pre)
            out.grad_fn.register_hook(post)
        return out

    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    reset_launches()
    klayers.grouped_gather = counting
    t0 = time.perf_counter()
    try:
        for i in range(TRAIN_STEPS):
            losses = step(batches[1 + i], gen)
            if i == 0:
                after = net.state_dict()
                still = [k for k, v in before.items() if torch.equal(v, after[k])]
                if still:
                    raise AssertionError(f"the first step left {still[:5]} unchanged")
            log(f"train step {i}: " + json.dumps(losses))
            if not all(np.isfinite(v) for v in losses.values()):
                raise AssertionError(f"train step {i}: a loss term is not finite")
            if not losses["loss_interpen"] > 0:
                raise AssertionError(f"train step {i}: no collision term")
    finally:
        klayers.grouped_gather = real_gather
    train_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"training: {TRAIN_STEPS} steps of {TRAIN_B} windows in {train_s:.3f} s; "
        f"launches {launches}")
    # sa1's source is the input cloud: no scatter-add for it, three a step
    check_launches("training", launches,
                   {"fps": 4, "onehot_gather": 4, "onehot_scatter_add": 3},
                   TRAIN_STEPS)
    for row in gather_rows:
        row["launches"] = by_layer["onehot_gather", row["layer"]]
    for row in scatter_rows:
        row["launches"] = by_layer["onehot_scatter_add", row["layer"]]
    log("training: launches by layer " + json.dumps(
        {f"{name} {layer}": n for (name, layer), n in sorted(by_layer.items())}))
    for name, rows in (("onehot_gather", gather_rows),
                       ("onehot_scatter_add", scatter_rows)):
        want = [TRAIN_STEPS if name == "onehot_gather" or r["on_path"] else 0
                for r in rows]
        if [r["launches"] for r in rows] != want:
            raise AssertionError(f"training: {name} launches by layer "
                                 f"{[r['launches'] for r in rows]}, want {want}")

    # 10. kernel route vs plain route, and card vs CPU: one step each from the
    # same weights and given draws, deterministic FPS, no dropout
    def route_cfg(pallas_gather):
        return ModelConfig(n_points=N, fps_deterministic=True,
                           pallas_gather=pallas_gather, pallas_gather_bwd=pallas_gather,
                           dropout_classifier=0.0, dropout_query=0.0,
                           dropout_regressor=0.0)

    skip = batchnorm_cancelled_biases(net)
    draws, noise = given_draws(torch, batches[0], cfg, seed=7)
    runs, taps = {}, {}
    for key, pallas_gather in (("kernel", True), ("plain", False), ("kernel again", True)):
        net_r, step_r = build_step(route_cfg(pallas_gather), dev)
        if pallas_gather:
            losses, *taps[key] = tapped_step(torch, net_r, step_r, batches[0],
                                             draws=draws, noise=noise)
        else:
            losses = step_r(batches[0], draws=draws, noise=noise)
        runs[key] = (losses, *step_state(net_r))
        del net_r, step_r
    # two kernel-route steps from the same weights and draws: every loss
    # term, gradient, BatchNorm statistic and parameter after Adam bitwise
    # equal; where one is not, the first boundary (in backward order) whose
    # cotangent differs names the op that added in another order
    (la, ga, ba, pa), (lb, gb, bb, pb) = runs["kernel"], runs.pop("kernel again")
    differ = {"loss terms": [k for k in la if la[k] != lb[k]],
              "gradients": sorted(k for k in ga if not torch.equal(ga[k], gb[k])),
              "BatchNorm statistics": sorted(k for k in ba if not torch.equal(ba[k], bb[k])),
              "parameters after Adam": sorted(k for k in pa if not torch.equal(pa[k], pb[k]))}
    boundaries, n_taps = first_difference(torch, taps["kernel"], taps["kernel again"])
    for cot, _ in taps.values():   # held by a reference cycle of the taps' closures
        cot.clear()
    del taps
    log(f"kernel route, two steps from the same weights and draws: "
        f"{len(la) - len(differ['loss terms'])} of {len(la)} loss terms, "
        f"{len(ga) - len(differ['gradients'])} of {len(ga)} gradients, "
        f"{len(ba) - len(differ['BatchNorm statistics'])} of {len(ba)} BatchNorm "
        f"statistics, {len(pa) - len(differ['parameters after Adam'])} of {len(pa)} "
        f"parameters after Adam and {n_taps - len(boundaries)} of {n_taps} boundary "
        f"cotangents bitwise equal")
    if any(differ.values()) or boundaries:
        raise AssertionError(
            "two kernel-route steps differ: " + "; ".join(
                f"{what} {names[:8]}" for what, names in differ.items() if names)
            + f"; first boundaries whose cotangents differ (backward order): "
            f"{boundaries[:8]}")
    runs[True], runs[False] = runs.pop("kernel")[:3], runs.pop("plain")[:3]
    # The gather is an exact copy, so the forward is the same on both routes;
    # the backward sums the slot cotangents in another order (one fixed by
    # the inputs in the kernel, index_add_'s atomics on the plain route), and
    # the gradients of earlier layers inherit that rounding.
    compare_steps(torch, "kernel route vs plain route (card, B=8)", runs[True],
                  runs[False], loss_rtol=1e-6, cos_min=1 - 1e-6, norm_tol=1e-4,
                  buf_rtol=1e-6, skip=skip)

    two = {k: ({kk: vv[:2] for kk, vv in v.items()} if isinstance(v, dict) else v[:2])
           for k, v in batches[0].items()}
    draws2, noise2 = given_draws(torch, two, cfg, seed=8)
    runs = {}
    for device in ("cuda", "cpu"):
        net_r, step_r = build_step(route_cfg(True), device)
        t0 = time.perf_counter()
        losses = step_r(two, draws=draws2, noise=noise2)
        secs = time.perf_counter() - t0
        runs[device] = (losses, *step_state(net_r)[:2])
        del net_r, step_r
    log(f"card vs CPU: the CPU step (plain versions, B=2) took {secs:.1f} s")
    # f32 on both, sums in other orders (cuBLAS vs the CPU's BLAS, atomics):
    # loss terms within 1e-4, gradient directions within cosine 0.999 and
    # norms within 5%. BatchNorm statistics within 1e-4: the batch variance
    # is mean(x * x) - mean(x)^2 (the JAX package's formula), so a channel
    # whose mean is large against its spread loses digits to cancellation,
    # and the two devices round its inputs differently.
    compare_steps(torch, "card vs CPU (B=2)", runs["cuda"], runs["cpu"],
                  loss_rtol=1e-4, cos_min=0.999, norm_tol=0.05, buf_rtol=1e-4,
                  skip=skip)
    del runs

    # 11. training throughput at B=8, a new polarity flip per step
    batch = {k: ({kk: torch.from_numpy(vv).to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.from_numpy(v).to(dev))
             for k, v in batches[1].items()}
    raw_d = batch["events"]
    flip_gen = torch.Generator(device=dev).manual_seed(4)

    def one_step():
        flip = torch.rand((TRAIN_B, 1), generator=flip_gen, device=dev) < 0.5
        p = raw_d[..., 3]
        ev = torch.cat([raw_d[..., :3], torch.where(flip, 1.0 - p, p)[..., None]], -1)
        return step(dict(batch, events=ev), gen)

    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(torch, one_step, 10, warmup=2)
    log(f"training: {step_ms:.3f} ms per step of {TRAIN_B} windows, "
        f"{TRAIN_B / (step_ms / 1e3):.2f} windows/s (augment, kernel route); "
        f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    # the host syncs of one step, by site; the model's FPS calls make none.
    # With the public fps (which checks a caller's start on the host) in
    # their place, as the model called it before, each of the step's four
    # FPS calls adds one.
    syncs = host_syncs(torch, one_step)
    with_checked = host_syncs(torch, one_step, checked_fps=True)
    log(f"training: {sum(syncs.values())} host syncs a step "
        f"{json.dumps(dict(sorted(syncs.items())))}; with the checked fps in the "
        f"model's place {sum(with_checked.values())}, by site "
        f"{json.dumps(dict(sorted((with_checked - syncs).items())))} more, "
        f"{json.dumps(dict(sorted((syncs - with_checked).items())))} fewer")
    in_fps = [site for site in syncs if site.startswith("ev2hands_tpu_torch/ops/fps.py")]
    if in_fps:
        raise AssertionError(f"training: the model's FPS calls sync the host at {in_fps}")
    kernels = top_device_kernels(torch, one_step, 2)
    busy = sum(k[1] for k in kernels)
    log(f"training: device kernels {busy:.3f} ms per step = "
        f"{100 * busy / step_ms:.1f}% busy of {step_ms:.3f} ms; top 10 "
        f"{sum(k[1] for k in kernels[:10]):.3f} ms")
    for name, ms, count in kernels[:10]:
        log(f"  kernel {ms:9.3f} ms x{count:<5d} {name[:100]}")
    return gather_rows, scatter_rows, launches


def evaluation_phases(torch, np, dev, state):
    """Phases 12-13: both evaluation entry points on the card in the fused
    configuration -> their launches, summed."""
    import dataclasses

    from ev2hands_tpu_torch import evaluate as kev
    from ev2hands_tpu_torch import evaluate_real as kevr
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.events.erpc import rasterize_erpc, resample_draws
    from ev2hands_tpu_torch.events.real_streams import (
        RealStream,
        sliding_window_batches,
        write_synthetic_ev2hands_r,
    )
    from ev2hands_tpu_torch.events.streams import (
        Ev2HandSReader,
        synthetic_ev2hands_s,
    )
    from ev2hands_tpu_torch.model.tehnet import TEHNet
    from ev2hands_tpu_torch.train import build_collision_context, build_hands

    cfg = DEFAULT_CONFIG.replace(
        model=ModelConfig(n_points=N, pallas_fused_msg=True),
        train=dataclasses.replace(DEFAULT_CONFIG.train, eval_batch_size=EVAL_B))
    nets, hands = {}, {}
    for device in ("cuda", "cpu"):
        nets[device] = TEHNet(cfg.model, device=device)
        nets[device].load_state_dict(state, strict=True)
        hands[device] = build_hands(cfg, synthetic=True, device=device)
    per_batch = {"fps": 3, "msg_fused_sparse": 1}
    rows, annotations = synthetic_ev2hands_s(n_events=65536, n_frames=16)
    reader = Ev2HandSReader.from_rows(rows, annotations, N)

    # 12. Ev2Hands-S: 8 batches through the entry point, counted
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = kev.evaluate_dataset(nets["cuda"], hands["cuda"], reader, cfg,
                                  max_frames=EVAL_B * EVAL_BATCHES, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = read_launches()
    frames = report["frames"]
    log(f"evaluation (Ev2Hands-S): {frames} windows in {eval_s:.3f} s = "
        f"{frames / eval_s:.2f} windows/s at B={EVAL_B} (host reader and metrics "
        f"included); launches {launches}")
    log("evaluation report: " + json.dumps(
        {k: report[k] for k in ("auc", "eval_score", "mpjpe_mm", "mpvpe_mm", "frames")}))
    check_launches("evaluation (Ev2Hands-S)", launches, per_batch, EVAL_BATCHES)
    if frames != EVAL_B * EVAL_BATCHES or not all(
            np.isfinite(v) for v in (report["mpjpe_mm"], report["mpvpe_mm"],
                                     *report["auc"].values(),
                                     *sum(report["pck3d"].values(), []))):
        raise AssertionError("evaluation (Ev2Hands-S): the report is not finite "
                             f"over {EVAL_B * EVAL_BATCHES} frames")

    # the card against the port on the CPU: the first batch, given draws
    batch = next(reader.batches(EVAL_B, shuffle=False, max_batches=1))
    _, _, n_valid = rasterize_erpc(torch.from_numpy(batch["events"]),
                                   torch.from_numpy(batch["labels"]),
                                   cfg.sensor.width, cfg.sensor.height)
    draws = resample_draws(n_valid, N, torch.Generator().manual_seed(101))
    steps = {d: kev.make_full_eval_step(nets[d], hands[d], cfg, device=d)
             for d in ("cuda", "cpu")}
    card = steps["cuda"](batch, draws=draws)
    step_ms = cuda_ms(torch, lambda: steps["cuda"](batch, draws=draws), 3, 1)
    log(f"evaluation step (Ev2Hands-S): {step_ms:.3f} ms per batch of {EVAL_B} = "
        f"{EVAL_B / (step_ms / 1e3):.2f} windows/s (CUDA events, given draws)")
    two = {k: ({kk: vv[:2] for kk, vv in v.items()} if isinstance(v, dict) else v[:2])
           for k, v in batch.items()}
    t0 = time.perf_counter()
    cpu = steps["cpu"](two, draws=draws[:2])
    cpu_s = time.perf_counter() - t0
    diffs = {name: ((c[:2].cpu() - p) / 1000).abs().max().item()
             for name, c, p in zip(("pred joints", "pred vertices"),
                                   (card[0], card[2]), (cpu[0], cpu[2]))}
    log(f"evaluation card vs CPU (2 windows, CPU run {cpu_s:.1f} s): " + ", ".join(
        f"{k} {v:.3g} m" for k, v in diffs.items()))
    for k, v in diffs.items():
        if not v <= 1e-4:
            raise AssertionError(f"evaluation card vs CPU: {k} differ by {v} m")
    del card, cpu, nets["cpu"]

    # 13. Ev2Hands-R: a synthetic recording, 96 windows, counted; the
    # collision score's device time from CUDA events around each call
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = write_synthetic_ev2hands_r(os.path.join(tmp, "subject.pickle"))
        stream = RealStream(path, cfg.sensor.width, cfg.sensor.height)
        t0 = time.perf_counter()
        host = list(sliding_window_batches(stream, EVAL_B, REAL_WINDOWS))
        host_s = time.perf_counter() - t0
        ctx = build_collision_context(hands["cuda"])
        step = kevr.make_real_eval_step(nets["cuda"], hands["cuda"], ctx, cfg,
                                        device="cuda")
        timed = []
        real_collision = kevr.collision_percentage

        def collision_timed(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = real_collision(*args, **kwargs)
            b.record()
            timed.append((a, b))
            return out

        kevr.collision_percentage = collision_timed
        reset_launches()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real = kevr.evaluate_recording(step, stream, cfg, EVAL_B,
                                           max_windows=REAL_WINDOWS, device="cuda")
            torch.cuda.synchronize()
            real_s = time.perf_counter() - t0
        finally:
            kevr.collision_percentage = real_collision
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    real_launches = read_launches()
    collision_s = sum(a.elapsed_time(b) for a, b in timed) / 1e3
    log(f"evaluation (Ev2Hands-R): {real['frames']} windows in {real_s:.3f} s, "
        f"{real['windows_per_sec_end_to_end']:.2f} windows/s end to end at "
        f"B={EVAL_B}; host windowing alone {host_s:.3f} s "
        f"({100 * host_s / real_s:.1f}% of the wall time, overlapped by the "
        f"prefetcher), collision score {collision_s:.3f} s of device time "
        f"({100 * collision_s / real_s:.1f}%); launches {real_launches}")
    log("evaluation report (Ev2Hands-R): " + json.dumps(
        {k: real[k] for k in ("frames", "mpjpe_mm", "non_collision_pct", "auc")}))
    n_batches = len(host)
    check_launches("evaluation (Ev2Hands-R)", real_launches, per_batch, n_batches)
    if real["frames"] != REAL_WINDOWS or not np.isfinite(real["mpjpe_mm"]) \
            or not 0.0 <= real["non_collision_pct"] <= 100.0:
        raise AssertionError(f"evaluation (Ev2Hands-R): bad report {real['frames']} "
                             f"frames, MPJPE {real['mpjpe_mm']}, non-collision "
                             f"{real['non_collision_pct']}")
    return {k: launches[k] + real_launches[k] for k in launches}

def loop_config(eval_b, **train):
    """The loops' configuration: full TEHNet width, the kernel route of the
    training step (one-hot gather and its scatter-add), the default
    (per-scale) evaluation grouping."""
    import dataclasses

    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig

    return DEFAULT_CONFIG.replace(
        model=ModelConfig(n_points=N, pallas_gather=True, pallas_gather_bwd=True),
        train=dataclasses.replace(DEFAULT_CONFIG.train, batch_size=TRAIN_B,
                                  eval_batch_size=eval_b, msg_iter=1, **train))


def loop_shares(name, stats, wall_s):
    """Log a loop's windows/s and where its wall time went -> the numbers."""
    work_s = stats.wall_s - stats.eval_s - stats.save_s
    out = {
        "steps": stats.steps, "batch": TRAIN_B, "wall_s": wall_s,
        "loop_s": stats.wall_s,
        "windows_per_s": stats.steps * TRAIN_B / work_s,
        "windows_per_s_end_to_end": stats.steps * TRAIN_B / wall_s,
        "loader_wait_share": stats.loader_wait_s / stats.wall_s,
        "eval_share": stats.eval_s / stats.wall_s,
        "save_share": stats.save_s / stats.wall_s,
        "evals": stats.evals, "saves": stats.saves,
    }
    log(f"{name}: {stats.steps} steps of {TRAIN_B} windows in {stats.wall_s:.3f} s "
        f"({wall_s:.3f} s with set-up); {out['windows_per_s']:.2f} windows/s over the "
        f"steps (host loader, prefetch and logging included), "
        f"{out['windows_per_s_end_to_end']:.2f} windows/s end to end; shares of the "
        f"loop's wall time: waiting on the loader {100 * out['loader_wait_share']:.2f}%, "
        f"evaluation {100 * out['eval_share']:.2f}% ({stats.evals}), checkpoint save "
        f"{100 * out['save_share']:.2f}% ({stats.saves})")
    return out


def expect_launches(what, launches, steps, eval_batches):
    want = {k: TRAIN_PER_STEP.get(k, 0) * steps + EVAL_PER_BATCH.get(k, 0) * eval_batches
            for k in launches}
    for k, n in launches.items():
        if n != want[k]:
            raise AssertionError(f"{what}: {k} launched {n} times, want {want[k]} "
                                 f"({steps} steps, {eval_batches} evaluation batches)")


def training_loop_phase(torch, np, dev, state):
    """Phase 14: the training loop (train) on synthetic rows in memory
    through the native loader, warm-started from the seeded weights,
    counted; a step-level resume from its step-3 checkpoint bitwise equal
    to its step 6; windows/s and shares; the native loader's host time a
    batch beside the Python reader's. -> launches."""
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.checkpoint import Checkpointer
    from ev2hands_tpu_torch.events.native_loader import NativeEv2HandSLoader
    from ev2hands_tpu_torch.events.streams import Ev2HandSReader, synthetic_ev2hands_s
    from ev2hands_tpu_torch.model.tehnet import TEHNet

    tmp = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        pth = os.path.join(tmp, "seeded.pth")
        torch.save(state, pth)
        cfg = loop_config(EVAL_B, save_iter=LOOP_SAVE_ITER,
                          max_eval_iters=LOOP_EVAL_FRAMES, checkpoint_path=pth)
        rows = synthetic_ev2hands_s(n_events=65536, n_frames=16, seed=0)
        val = synthetic_ev2hands_s(n_events=65536, n_frames=16, seed=1)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = ktrain.train(cfg, synthetic_mano=True, max_iter=LOOP_STEPS, device=dev,
                           train_data=rows, val_data=val, base_dir=tmp)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        log(f"training loop: launches {launches}; last step's losses "
            + json.dumps(run.stats.losses))
        if run.source != "native":
            raise AssertionError(f"training loop: the batches came from {run.source}, "
                                 "not the native loader")
        eval_batches = (LOOP_STEPS // LOOP_SAVE_ITER) * (LOOP_EVAL_FRAMES // EVAL_B)
        expect_launches("training loop", launches, LOOP_STEPS, eval_batches)
        if run.step != LOOP_STEPS or run.stats.evals != LOOP_STEPS // LOOP_SAVE_ITER \
                or not all(np.isfinite(v) for v in run.stats.losses.values()):
            raise AssertionError(f"training loop: step {run.step}, "
                                 f"{run.stats.evals} evaluations, losses {run.stats.losses}")
        ckpt = os.path.join(run.run_dir, "ckpt")
        saved = sorted(os.listdir(ckpt))
        log(f"training loop: checkpoints {saved}; best score {run.max_eval_score}")
        if f"step_{LOOP_SAVE_ITER:09d}.pt" not in saved:
            raise AssertionError(f"training loop: no checkpoint at step {LOOP_SAVE_ITER}")
        shares = loop_shares("training loop", run.stats, wall_s)

        # the step-level resume: a fresh model and Adam restored from the
        # step-3 checkpoint take steps 3-5 with the loop's batches (the
        # native loader's fill_random) and draws
        net = TEHNet(cfg.model, device=dev)
        opt = ktrain.make_optimizer(net.parameters(), cfg.train)
        Checkpointer(ckpt).restore_into(net, opt, step=LOOP_SAVE_ITER)
        hands = ktrain.build_hands(cfg, synthetic=True, device=dev)
        step = ktrain.make_train_step(net, hands, ktrain.build_collision_context(hands),
                                      cfg, opt, device=dev)
        loader = NativeEv2HandSLoader.from_rows(*rows, N, n_threads=1,
                                                seed=cfg.train.seed)
        for it in range(LOOP_SAVE_ITER, LOOP_STEPS):
            step(loader.fill_batch(TRAIN_B, step=it),
                 ktrain.seeded_generator(cfg.train.seed + 1, it, dev))
        torch.cuda.synchronize()
        a, b = net.state_dict(), run.net.state_dict()
        sa, sb = opt.state_dict()["state"], run.optimizer.state_dict()["state"]
        differ = [k for k in a if not torch.equal(a[k], b[k])] + [
            f"adam {i}.{k}" for i in sa for k in sa[i] if not torch.equal(sa[i][k], sb[i][k])]
        log(f"training loop: resumed from step {LOOP_SAVE_ITER} to {LOOP_STEPS}: "
            f"{len(a) - len([d for d in differ if not d.startswith('adam')])} of {len(a)} "
            f"model tensors and {sum(len(v) for v in sa.values())} Adam state tensors "
            f"checked, {len(differ)} differ")
        if differ:
            raise AssertionError(f"training loop: the resumed run differs at {differ[:8]}")
        del net, opt, step, run

        # the native loader's host time a batch (one thread, as the loop
        # runs it, and a pool of every hardware thread) beside the Python
        # reader's
        pool = NativeEv2HandSLoader.from_rows(*rows, N, n_threads=0, seed=cfg.train.seed)
        reader = Ev2HandSReader.from_rows(*rows, N)
        batches = reader.batches(TRAIN_B, shuffle=True)
        host = {}
        for name, fn in (("native", lambda i: loader.fill_batch(TRAIN_B, step=i)),
                         ("native_pool", lambda i: pool.fill_batch(TRAIN_B, step=i)),
                         ("python", lambda i: next(batches))):
            fn(0)
            t0 = time.perf_counter()
            for i in range(20):
                fn(i)
            host[name] = 1e3 * (time.perf_counter() - t0) / 20
        log(f"training loop: host ms a batch of {TRAIN_B} x {N} events: native loader "
            f"{host['native']:.3f} (one thread), {host['native_pool']:.3f} (a pool of "
            f"{os.cpu_count()} hardware threads), Python reader {host['python']:.3f}")
        shares["host_ms_per_batch"] = host
        log("training loop numbers: " + json.dumps(shares))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def finetune_phase(torch, np, dev, state):
    """Phase 15: finetuning (finetune) on a synthetic Ev2Hands-R recording
    in a temporary directory, warm-started from the seeded weights,
    counted, finite losses, windows/s; then one finetuning step on the card
    against the port on the CPU at B=2 with the same weights and draws,
    with the hands at the recording's depth.
    -> launches."""
    import dataclasses

    from ev2hands_tpu_torch import finetune as kft
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.events.erpc import rasterize_erpc, resample_draws
    from ev2hands_tpu_torch.events.real_streams import (
        Ev2HandRReader,
        write_synthetic_ev2hands_r,
    )
    from ev2hands_tpu_torch.model.tehnet import TEHNet

    tmp = tempfile.mkdtemp(prefix="chip_smoke_finetune_")
    try:
        pth = os.path.join(tmp, "seeded.pth")
        torch.save(state, pth)
        rec = os.path.join(tmp, "recordings")
        write_synthetic_ev2hands_r(os.path.join(rec, "subject.pickle"))
        cfg = loop_config(FT_EVAL_B)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = kft.finetune(cfg, rec, pth, max_iter=FT_STEPS, save_iter=FT_SAVE_ITER,
                           synthetic_mano=True, max_eval_iters=FT_EVAL_FRAMES,
                           device=dev, base_dir=tmp)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        log(f"finetune: launches {launches}; last step's losses "
            + json.dumps(run.stats.losses))
        eval_batches = (FT_STEPS // FT_SAVE_ITER) * (FT_EVAL_FRAMES // FT_EVAL_B)
        expect_launches("finetune", launches, FT_STEPS, eval_batches)
        if run.step != FT_STEPS or not all(np.isfinite(v)
                                           for v in run.stats.losses.values()):
            raise AssertionError(f"finetune: step {run.step}, losses {run.stats.losses}")
        numbers = loop_shares("finetune", run.stats, wall_s)
        log("finetune numbers: " + json.dumps(numbers))
        del run

        # one step on the card against the CPU: deterministic FPS, no
        # dropout, the resample draws given
        c = cfg.replace(model=dataclasses.replace(
            cfg.model, fps_deterministic=True, dropout_classifier=0.0,
            dropout_query=0.0, dropout_regressor=0.0))
        batch = next(Ev2HandRReader(rec, seed=4).batches(2))
        _, _, n_valid = rasterize_erpc(
            torch.from_numpy(batch["events"]), torch.zeros(batch["events"].shape[:2],
                                                           dtype=torch.int32),
            c.sensor.width, c.sensor.height, time_scale=1.0,
            event_valid=torch.from_numpy(batch["event_valid"]),
            max_pixels=min(batch["events"].shape[1], max(2 * N, 2048)))
        draws = resample_draws(n_valid, N, torch.Generator().manual_seed(9))
        # The seeded weights regress translations near 0, so the predicted
        # joints sit at the camera's centre, where the 2-D term divides by
        # depths near 0 and amplifies rounding without bound: that pair is
        # logged. The gate holds the pair whose regressors put the hands at
        # the recording's depth, 0.4 m (the transl bias's z raised by 0.4).
        at_depth = dict(state)
        for side in ("left", "right"):
            key = f"{side}_mano_regressor.mano_regressor.4.bias"
            at_depth[key] = state[key].clone()
            at_depth[key][-1] += 0.4
        for name, weights, gate in (("seeded weights", state, False),
                                    ("hands at 0.4 m", at_depth, True)):
            losses = {}
            for device in (dev, "cpu"):
                net = TEHNet(c.model, device=device)
                net.load_state_dict(weights, strict=True)
                hands = ktrain.build_hands(c, synthetic=True, device=device)
                step = kft.make_finetune_step(
                    net, hands, ktrain.build_collision_context(hands), c,
                    ktrain.make_optimizer(net.parameters(), c.train),
                    c.camera.projection_matrix(c.sensor.width, c.sensor.height), device)
                t0 = time.perf_counter()
                losses[str(device)] = step(batch, draws=draws)
                log(f"finetune step on {device}, {name} (B=2, given draws) in "
                    f"{time.perf_counter() - t0:.2f} s: " + json.dumps(losses[str(device)]))
            card, cpu = losses[str(dev)], losses["cpu"]
            worst = max((abs(card[k] - v) / max(abs(v), 1e-30), k) for k, v in cpu.items())
            log(f"finetune card vs CPU, {name}: loss terms max rel diff {worst[0]:.3g} "
                f"at {worst[1]}" + (" (limit 1e-4)" if gate else " (logged, no gate)"))
            if gate and not worst[0] <= 1e-4:
                raise AssertionError(f"finetune card vs CPU, {name}: {worst[1]} "
                                     f"differs by {worst[0]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches

# the export (phase 16): padded window capacity; the demo (phase 17):
# batch and windows (50 = 6 batches of 8 and a tail of 2)
EXPORT_EVENTS = 8192
DEMO_B, DEMO_WINDOWS = 8, 50
# the vertex gate of phases 5 and 18, in meters
VERTEX_TOL = 1e-4


def real_request(np, seed, n_events=EXPORT_EVENTS, width=346, height=260):
    """Padded real windows [B, n_events, 4] (x, y, t in ms over 2 ms,
    polarity), each with 2,048 to n_events real events, and the mask."""
    rng = np.random.RandomState(seed)
    ev = np.stack([
        rng.randint(0, width, (B, n_events)), rng.randint(0, height, (B, n_events)),
        np.sort(rng.uniform(0, 2, (B, n_events))), rng.randint(0, 2, (B, n_events)),
    ], -1).astype(np.float32)
    valid = np.arange(n_events)[None] < rng.randint(2048, n_events + 1, (B, 1))
    return ev, valid


def at_depth(state, z=-0.4):
    """The seeded weights with both regressors' translation bias at ``z`` m
    in z: the seeded heads regress translations near 0, which put the
    meshes at the camera's centre; at -0.4 m they are in front of the
    OpenGL camera (-z forward) and project into the image."""
    out = dict(state)
    for side in ("left", "right"):
        key = f"{side}_mano_regressor.mano_regressor.4.bias"
        out[key] = state[key].clone()
        out[key][-1] = z
    return out


def export_phase(torch, np, dev, state, tmp):
    """Phase 16: the serving function exported on the card, saved, loaded;
    its graph's kernel ops; 4 requests through the loaded program, counted,
    bitwise equal to the live function; windows/s of both; then the same
    with pallas_fused_msg=True. -> (launches, numbers, (request 0, the
    default program's outputs on it), both on the CPU)."""
    from ev2hands_tpu_torch import export as kex
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.model.tehnet import TEHNet

    requests = [real_request(np, 30 + j, EXPORT_EVENTS) for j in range(REQUESTS)]
    requests = [(torch.from_numpy(e).to(dev), torch.from_numpy(v).to(dev),
                 torch.rand((B, N), generator=torch.Generator().manual_seed(40 + j),
                            dtype=torch.float64).to(dev))
                for j, (e, v) in enumerate(requests)]
    launches, numbers = {}, {}
    for name, fused, per_request in (
            ("default", False, {"fps": 3, "msg_sparse": 3}),
            ("fused", True, {"fps": 3, "msg_fused_sparse": 1})):
        cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N, pallas_fused_msg=fused))
        net = TEHNet(cfg.model, device=dev)
        net.load_state_dict(state, strict=True)
        hands = ktrain.build_hands(cfg, synthetic=True, device=dev)
        path = os.path.join(tmp, f"serving_{name}.pt2")
        t0 = time.perf_counter()
        program = kex.export_serving(net, hands, cfg, B, EXPORT_EVENTS)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.export.save(program, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = kex.load_serving(path)
        load_s = time.perf_counter() - t0
        loaded_program = torch.export.load(path)
        counts = kex.op_counts(program)
        want = ({"fps": 3, "msg_fused_scales_sparse": 1} if fused
                else {"fps": 3, "msg_scale_sparse": 3})
        n_nodes = len(program.graph.nodes)
        log(f"export ({name}): torch.export {export_s:.2f} s, {n_nodes} graph nodes, "
            f"ops {counts}; save {save_s:.2f} s, {os.path.getsize(path)} bytes; "
            f"load {load_s:.2f} s")
        if counts != want or kex.op_counts(loaded_program) != want:
            raise AssertionError(f"export ({name}): kernel ops {counts}, want {want}")
        # the loaded program's weights and constants on the card, equal to
        # the live ones
        live_state = {f"net.{k}": v for k, v in net.state_dict().items()}
        bad = []
        for kind, tensors, ref in (
                ("parameter or buffer", loaded_program.state_dict, live_state),
                ("constant", loaded_program.constants, program.constants)):
            for k, v in tensors.items():
                if torch.is_tensor(v) and (v.device.type != dev.type
                                           or not torch.equal(v, ref[k])):
                    bad.append(f"{kind} {k} {tuple(v.shape)} {v.dtype} on {v.device}")
        log(f"export ({name}): loaded {len(loaded_program.state_dict)} parameters and "
            f"buffers and {len(loaded_program.constants)} constants; off the card or "
            f"not equal to the live ones: {bad or 'none'}")
        if bad:
            raise AssertionError(f"export ({name}): {len(bad)} loaded tensors off the "
                                 "card or not equal to the live ones")
        live_fn = kex.make_serving_fn(net, hands, cfg)
        reset_launches()
        torch.cuda.synchronize()
        outs = [loaded(*r) for r in requests]
        torch.cuda.synchronize()
        launches[name] = read_launches()
        check_launches(f"export ({name})", launches[name], per_request, REQUESTS)
        if name == "default":
            first = (tuple(t.cpu() for t in requests[0]),
                     {k: v.cpu() for k, v in outs[0].items()})
        with torch.inference_mode():
            for j, r in enumerate(requests):
                want_out = live_fn(*r)
                for k, v in want_out.items():
                    if not torch.equal(outs[j][k], v):
                        raise AssertionError(f"export ({name}): request {j} {k} is not "
                                             "bitwise equal to the live function's")
        flip = torch.Generator(device=dev).manual_seed(3)

        def request_of(fn):
            def one():
                e, v, u = requests[0]
                f = torch.rand((B, 1), generator=flip, device=dev) < 0.5
                p = e[..., 3]
                ev = torch.cat([e[..., :3], torch.where(f, 1.0 - p, p)[..., None]], -1)
                return fn(ev, v, u)
            return one

        with torch.inference_mode():
            ms = {"live": cuda_ms(torch, request_of(live_fn), 10),
                  "loaded": cuda_ms(torch, request_of(loaded), 10)}
        wps = {k: B / (v / 1e3) for k, v in ms.items()}
        log(f"export ({name}): all {REQUESTS} requests bitwise equal to the live "
            f"function; loaded {ms['loaded']:.3f} ms a request, {wps['loaded']:.2f} "
            f"windows/s; live {ms['live']:.3f} ms, {wps['live']:.2f} windows/s (B={B}, "
            f"{EXPORT_EVENTS} events a window)")
        numbers[name] = dict(export_s=export_s, save_s=save_s, load_s=load_s,
                             bytes=os.path.getsize(path), nodes=n_nodes,
                             loaded_windows_per_s=wps["loaded"],
                             live_windows_per_s=wps["live"])
        del program, loaded_program, loaded, net
    total = {k: sum(l[k] for l in launches.values()) for k in launches["default"]}
    return total, numbers, first


class FrameSink:
    """An in-memory video writer: keeps every frame."""

    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(frame)


def pixel_tolerance(np, verts_m, cfg, tol_m=VERTEX_TOL):
    """A first-order bound on how far a vertex moved by ``tol_m`` in each
    coordinate moves its projected pixel: ``0.5 * size * p * tol * (1 / |z|
    + (|x| + |y|) / z^2)``, ``p`` the projection's focal term, in mm."""
    v = np.asarray(verts_m, np.float64).reshape(-1, 3) * 1e3
    p = cfg.camera.projection_matrix(cfg.sensor.width, cfg.sensor.height)
    scale = 0.5 * max(cfg.sensor.width * p[0, 0], cfg.sensor.height * p[1, 1])
    z = np.abs(v[:, 2])
    return float(np.max(scale * tol_m * 1e3 * (1 / z + (np.abs(v[:, 0]) + np.abs(v[:, 1]))
                                               / z ** 2)))


def demo_phase(torch, np, dev, state, tmp):
    """Phase 17: run_demo on a synthetic recording with each mesh pane into
    an in-memory sink, counted; then the tail batch's real windows through
    the demo step on the card and on the CPU. -> (launches, numbers)."""
    from ev2hands_tpu_torch import demo as kdemo
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.events.real_streams import (
        RealStream,
        sliding_window_batches,
        write_synthetic_ev2hands_r,
    )
    from ev2hands_tpu_torch.model.tehnet import TEHNet

    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N))
    W, H = cfg.sensor.width, cfg.sensor.height
    rec = write_synthetic_ev2hands_r(os.path.join(tmp, "demo", "subject.pickle"))
    weights = at_depth(state)
    pth = os.path.join(tmp, "demo_weights.pth")
    torch.save(weights, pth)
    n_batches = -(-DEMO_WINDOWS // DEMO_B)
    launches, numbers = {}, {}
    for pane in ("splat", "device"):
        sink = FrameSink()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = kdemo.run_demo(rec, sink, pth, DEMO_B, DEMO_WINDOWS, synthetic_mano=True,
                                mesh_render=pane, cfg=cfg, device=dev)
        wall_s = time.perf_counter() - t0
        launches[pane] = read_launches()
        check_launches(f"demo ({pane})", launches[pane], EVAL_PER_BATCH, n_batches)
        if report["frames"] != DEMO_WINDOWS or len(sink.frames) != DEMO_WINDOWS:
            raise AssertionError(f"demo ({pane}): {len(sink.frames)} frames, want "
                                 f"{DEMO_WINDOWS}")
        if any(f.shape != (H, 3 * W, 3) or f.dtype != np.uint8 for f in sink.frames):
            raise AssertionError(f"demo ({pane}): a frame is not [{H}, {3 * W}, 3] uint8")
        lit = float(np.mean([(f[:, 2 * W:] > 0).any(-1).mean() for f in sink.frames]))
        log(f"demo ({pane}): {report['frames']} frames of {H}x{3 * W} in {wall_s:.2f} s "
            f"({n_batches} batches of {DEMO_B}, the tail partial); inference "
            f"{report['inference_windows_per_s']:.2f} windows/s, steady state "
            f"{report['steady_state_windows_per_s']:.2f} windows/s over "
            f"{report['steady_state_windows']} windows; mesh pane lit on "
            f"{100 * lit:.2f}% of its pixels; launches {launches[pane]}")
        numbers[pane] = dict(report, wall_s=wall_s, mesh_pane_lit=lit)
        del sink

    # the tail batch's real windows, card against CPU, the same uniforms
    tail = list(sliding_window_batches(RealStream(rec, W, H), DEMO_B, DEMO_WINDOWS,
                                       with_gt=False))[-1]
    k = tail["n_valid"]
    inputs = (torch.from_numpy(tail["events"][:k]), torch.from_numpy(tail["event_valid"][:k]),
              torch.rand((k, N), generator=torch.Generator().manual_seed(11),
                         dtype=torch.float64))
    outs = {}
    for device in (dev, "cpu"):
        net = TEHNet(cfg.model, device=device)
        net.load_state_dict(weights, strict=True)
        step = kdemo.make_demo_step(net.eval(), ktrain.build_hands(cfg, synthetic=True,
                                                                  device=device),
                                    cfg, "device")
        t0 = time.perf_counter()
        outs[str(device)] = {key: v.cpu().numpy() for key, v in step(*inputs).items()}
        log(f"demo step on {device} ({k} windows, device pane) in "
            f"{time.perf_counter() - t0:.2f} s")
    card, cpu = outs[str(dev)], outs["cpu"]
    for key in ("xy", "polarity", "seg"):
        if not np.array_equal(card[key], cpu[key]):
            raise AssertionError(f"demo card vs CPU: {key} is not bitwise equal")
    report = {}
    for side in ("left", "right"):
        vdiff = float(np.abs(card[f"verts_{side}"] - cpu[f"verts_{side}"]).max())
        tol = pixel_tolerance(np, cpu[f"verts_{side}"], cfg)
        pdiff = float(np.abs(card[f"px_{side}"] - cpu[f"px_{side}"]).max())
        report[side] = (vdiff, pdiff, tol)
        if not (vdiff <= VERTEX_TOL and pdiff <= tol):
            raise AssertionError(f"demo card vs CPU: {side} vertices {vdiff} m (limit "
                                 f"{VERTEX_TOL}), pixels {pdiff} (limit {tol})")
    covered = int((cpu["mesh_cls"] > 0).sum())
    differ = int((card["mesh_cls"] != cpu["mesh_cls"]).sum())
    same = card["mesh_cls"] == cpu["mesh_cls"]
    shade = float(np.abs(card["mesh_shade"][same] - cpu["mesh_shade"][same]).max())
    log("demo card vs CPU (tail batch, %d windows): xy, polarity and seg bitwise; "
        % k + "; ".join(f"{s} vertices {v:.3g} m, pixels {p:.3g} (limit {t:.3g}, the "
                        f"{VERTEX_TOL} m gate projected)" for s, (v, p, t) in report.items())
        + f"; mesh_cls differs on {differ} of {covered} covered pixels (edge pixels "
          f"whose centre the two sides' vertices put on either side of a triangle "
          f"edge), shading {shade:.3g} where it agrees")
    if covered < 100 or differ > 0.01 * covered or not shade <= 1e-4:
        raise AssertionError(f"demo card vs CPU: mesh pane {differ} of {covered} "
                             f"pixels differ (limit 1%), shading {shade}")
    numbers["card_vs_cpu"] = dict(mesh_cls_differ=differ, mesh_covered=covered,
                                  **{f"{s}_px_diff": p for s, (_, p, _) in report.items()})
    total = {key: sum(l[key] for l in launches.values()) for key in launches["splat"]}
    return total, numbers


def four_channel_phase(torch, np, dev):
    """Phase 18: raw_window_transform -> TEHNet(erpc=False) -> MANO at B=16,
    N=2048, counted, timed, and 2 windows against the CPU.
    -> (launches, windows/s)."""
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.events.erpc import raw_window_transform
    from ev2hands_tpu_torch.model.tehnet import TEHNet, apply_mano
    from ev2hands_tpu_torch.weights import init_weights

    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N, erpc=False))
    state = init_weights(torch.Generator().manual_seed(3), cfg.model)
    nets, hands = {}, {}
    for device in (dev, "cpu"):
        nets[str(device)] = TEHNet(cfg.model, device=device)
        nets[str(device)].load_state_dict(state, strict=True)
        nets[str(device)].eval()
        hands[str(device)] = ktrain.build_hands(cfg, synthetic=True, device=device)

    def forward(device, raw, lab, uniforms):
        c = cfg.sensor
        win = raw_window_transform(raw.to(device), lab.to(device), uniforms=uniforms,
                                   width=c.width, height=c.height, n_out=N)
        return apply_mano(hands[str(device)], nets[str(device)](win.events))

    reqs = [raw_request(np, 50 + j) for j in range(REQUESTS)]
    reqs = [(torch.from_numpy(r).to(dev), torch.from_numpy(lab).to(dev),
             torch.rand((B, N), generator=torch.Generator().manual_seed(60 + j),
                        dtype=torch.float64).to(dev)) for j, (r, lab) in enumerate(reqs)]
    with torch.inference_mode():
        reset_launches()
        torch.cuda.synchronize()
        outs = [forward(dev, *r) for r in reqs]
        torch.cuda.synchronize()
        launches = read_launches()
        check_launches("4-channel", launches, EVAL_PER_BATCH, REQUESTS)
        for out in outs:
            if not all(torch.isfinite(out[s]["vertices"]).all() for s in ("left", "right")) \
                    or not torch.isfinite(out["class_logits"]).all():
                raise AssertionError("4-channel output is not finite")
        ms = cuda_ms(torch, lambda: forward(dev, *reqs[1]), 10)
        wps = B / (ms / 1e3)
        t0 = time.perf_counter()
        ref = forward("cpu", *(t[:2].cpu() for t in reqs[0]))
        cpu_s = time.perf_counter() - t0
    got = outs[0]
    diffs = {"class_logits": (got["class_logits"][:2].cpu() - ref["class_logits"]).abs().max().item()}
    for side in ("left", "right"):
        for key in ("global_orient", "hand_pose", "betas", "transl", "vertices", "j3d"):
            diffs[f"{side}_{key}"] = (got[side][key][:2].cpu() - ref[side][key]).abs().max().item()
    limits = {k: VERTEX_TOL if k.endswith(("vertices", "j3d")) else 1e-3 for k in diffs}
    log(f"4-channel: {REQUESTS} requests of {B} windows, launches {launches}; "
        f"{ms:.3f} ms a request, {wps:.2f} windows/s; card vs CPU (2 windows, CPU run "
        f"{cpu_s:.1f} s): " + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()))
    for k, v in diffs.items():
        if not v <= limits[k]:
            raise AssertionError(f"4-channel card vs CPU: {k} differs by {v} > {limits[k]}")
    return launches, wps


class _Ch:
    """Stands in for chumpy's Ch in the MANO pickles that phase 19 writes."""

    def __init__(self, x):
        self.x = x


def write_official_mano(np, root, models):
    """{root}/mano/MANO_{LEFT,RIGHT}.pkl in the official layout: v_template
    and shapedirs as chumpy objects, J_regressor as a scipy sparse matrix,
    faces uint32 as 'f', the rest numpy."""
    import pickle
    import types

    import scipy.sparse

    _Ch.__module__, _Ch.__qualname__ = "chumpy.ch", "Ch"
    mod = types.ModuleType("chumpy.ch")
    mod.Ch = _Ch
    saved = {k: sys.modules.get(k) for k in ("chumpy", "chumpy.ch")}
    sys.modules["chumpy"], sys.modules["chumpy.ch"] = types.ModuleType("chumpy"), mod
    try:
        os.makedirs(os.path.join(root, "mano"), exist_ok=True)
        for side, m in models.items():
            data = {"v_template": _Ch(m.v_template.astype(np.float64)),
                    "shapedirs": _Ch(m.shapedirs.astype(np.float64)),
                    "posedirs": m.posedirs.astype(np.float64),
                    "J_regressor": scipy.sparse.csc_matrix(m.J_regressor.astype(np.float64)),
                    "weights": m.lbs_weights.astype(np.float64),
                    "hands_components": m.hands_components.astype(np.float64),
                    "hands_mean": m.hands_mean.astype(np.float64),
                    "f": m.faces.astype(np.uint32)}
            with open(os.path.join(root, "mano", f"MANO_{side.upper()}.pkl"), "wb") as f:
                pickle.dump(data, f, protocol=2)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def mano_loader_phase(torch, np, dev, state, tmp, raw0, lab0, draws0):
    """Phase 19: official-layout MANO pickles written from the synthetic
    models, loaded; one serving request with those hands bitwise equal to
    one with the synthetic models (the left-hand shapedirs fix applied, as
    the loader applies it: the synthetic hands share their shapedirs)."""
    import dataclasses

    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.mano.layer import create_mano_params
    from ev2hands_tpu_torch.mano.model_data import (
        apply_shapedirs_fix,
        load_mano_models,
        synthetic_mano_models,
    )
    from ev2hands_tpu_torch.serve import InferencePipeline

    root = os.path.join(tmp, "mano_assets")
    write_official_mano(np, root, synthetic_mano_models(0))
    expected = synthetic_mano_models(0)
    if not apply_shapedirs_fix(expected["left"], expected["right"]):
        raise AssertionError("mano loader: the synthetic hands should need the fix")
    cfg = DEFAULT_CONFIG.replace(
        mano=dataclasses.replace(DEFAULT_CONFIG.mano, model_path=root),
        model=ModelConfig(n_points=N))
    hands = ktrain.build_hands(cfg, synthetic=False, device=dev)   # reads model_path
    outs = {}
    with torch.inference_mode():
        for name, models in (("loaded", load_mano_models(root)), ("synthetic", expected)):
            pipe = InferencePipeline(cfg, state, models, device=dev)
            outs[name] = pipe(torch.from_numpy(raw0), torch.from_numpy(lab0), draws=draws0)
    for side in ("left", "right"):
        for a, b in zip(hands[side], create_mano_params(expected[side], device=dev)):
            if not torch.equal(a, b):
                raise AssertionError(f"mano loader: build_hands' {side} hand differs")
    for k, v in outs["loaded"].items():
        if not torch.equal(v, outs["synthetic"][k]):
            raise AssertionError(f"mano loader: {k} differs from the synthetic hands'")
    log(f"mano loader: MANO_{{LEFT,RIGHT}}.pkl (chumpy objects, a scipy sparse "
        f"J_regressor) loaded; one serving request of {B} windows with the loaded "
        f"hands bitwise equal to the synthetic models' (left-hand fix applied) in all "
        f"{len(outs['loaded'])} outputs")


# the data generation (phase 20): annotation frames of the sequence and
# their rate, its augmented copies, the frames held card vs CPU, training
# steps on the generated windows
DATAGEN_FRAMES, DATAGEN_FPS, DATAGEN_COPIES, DATAGEN_CHECKED = 10, 5, 2, 3
DATAGEN_TRAIN_STEPS = 2
DATAGEN_SPLIT = ("mano_forearms", "rasterize_scene", "log_intensity_esim",
                 "copy_to_host", "expand_labels", "part_write")


def datagen_sequence(np):
    """Annotations of a two-hand motion 0.45 m in front of the camera at
    ``DATAGEN_FPS``: each hand sweeps sideways and back, turns about the
    vertical and flexes its fingers -> {frame: {side: {pose, shape, trans}}}."""
    seq = {}
    for f in range(DATAGEN_FRAMES):
        phase = 2.0 * np.pi * f / DATAGEN_FRAMES
        entry = {}
        for side, x0, sgn in (("left", -0.07, 1.0), ("right", 0.07, -1.0)):
            pose = np.zeros(48, np.float32)
            pose[:3] = [0.2 * np.sin(phase), 0.5 * sgn * np.sin(phase), 0.0]
            pose[3:] = 0.15 * (1.0 - np.cos(phase))
            entry[side] = {
                "pose": pose, "shape": np.zeros(10, np.float32),
                "trans": np.float32([x0 + 0.04 * sgn * np.sin(phase),
                                     0.02 * np.cos(phase), -0.45]),
            }
        seq[f] = entry
    return seq


def datagen_phase(torch, np, dev, state, pipe):
    """Phase 20: Ev2Hands-S generation at the full sensor in the realistic
    scene (generate, stitch_rows, Ev2HandSReader.from_rows), frames/s and
    events a frame, the split of a frame's time, the device's busy share
    and peak memory; card vs CPU on copy 0's first frames; training steps
    and a serving request on the generated windows, counted.
    -> (launches, numbers)."""
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.datagen import generate as kgen
    from ev2hands_tpu_torch.datagen.interhand import AxisAngleToPca
    from ev2hands_tpu_torch.datagen.interpolate import augment_sequence, interpolate_sequence
    from ev2hands_tpu_torch.datagen.meshes import random_skin_vertex_colors
    from ev2hands_tpu_torch.datagen.stitch import stitch_rows
    from ev2hands_tpu_torch.events.streams import Ev2HandSReader
    from ev2hands_tpu_torch.mano.layer import create_mano_params
    from ev2hands_tpu_torch.mano.model_data import synthetic_mano_models
    from ev2hands_tpu_torch.model.tehnet import TEHNet
    from ev2hands_tpu_torch.ops.esim import CompactEvents, EsimState, esim_init

    cfg = DEFAULT_CONFIG
    W, H = cfg.sensor.width, cfg.sensor.height
    models = synthetic_mano_models(0)
    frames = interpolate_sequence(datagen_sequence(np), DATAGEN_FPS,
                                  cfg.esim.interpolation_fps)
    copies = [augment_sequence(frames, np.random.RandomState(s))
              for s in range(DATAGEN_COPIES)]
    n_frames = sum(len(c) for c in copies)
    numbers = {"frames": n_frames, "sensor": [W, H]}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_datagen_")
    try:
        # generate end to end: the copies are sequences 0 and 1 (seeds 0, 1)
        torch.cuda.synchronize()
        base_mb = torch.cuda.memory_allocated() / 2 ** 20
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        parts = kgen.generate(iter(copies), models, os.path.join(tmp, "parts"), cfg=cfg,
                              frames_per_part=30, verbose=False, device=dev)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        rows, annos = stitch_rows(parts)
        per_frame = np.bincount(rows[:, 4], minlength=len(annos))
        numbers.update(parts=len(parts), seconds=gen_s, frames_per_s=n_frames / gen_s,
                       events=len(rows), events_per_frame=len(rows) / n_frames,
                       events_per_frame_max=int(per_frame.max()),
                       label_shares=[float((rows[:, 5] == c).mean()) for c in range(3)],
                       peak_mb=peak_mb, peak_above_base_mb=peak_mb - base_mb)
        log(f"datagen: {n_frames} frames ({DATAGEN_COPIES} copies of {len(frames)} at "
            f"{W}x{H}) in {gen_s:.2f} s = {numbers['frames_per_s']:.2f} frames/s end to "
            f"end; {len(rows)} events, {numbers['events_per_frame']:.1f} a frame (max "
            f"{numbers['events_per_frame_max']}), labels bg/left/right "
            f"{numbers['label_shares']}; peak device memory {peak_mb:.1f} MB "
            f"({peak_mb - base_mb:.1f} MB above the {base_mb:.1f} MB held before)")
        if len(annos) != n_frames or len(rows) < 8 * N:
            raise AssertionError(f"datagen: {len(annos)} frames, {len(rows)} events")
        if not (set(np.unique(rows[:, 5])) == {0, 1, 2} and rows[:, 0].max() < W
                and rows[:, 1].max() < H and rows[:, 0].min() >= 0):
            raise AssertionError("datagen: event rows out of range or a class missing")

        # the split of a frame's time over copy 0, stage by stage: CUDA
        # events on the device stages, the host clock (after a sync) on the
        # copy, the expansion and the part write
        n_comps = cfg.mano.n_pose_comps
        faces = models["left"].faces
        to_pca = {s: AxisAngleToPca(models[s]) for s in ("left", "right")}
        n_total = kgen.scene_topology(faces, cfg)[2]

        def simulator(device):
            hands = {s: create_mano_params(models[s], n_comps, device=device)
                     for s in ("left", "right")}
            colors = random_skin_vertex_colors(n_total, np.random.RandomState(0))
            return kgen.FrameSimulator(hands, faces, cfg, colors)

        draws = kgen.sequence_draws(0, len(copies[0]), cfg)
        dt_ns = 1e9 / cfg.esim.simulator_fps
        sim, bg = simulator(dev), draws.background.to(dev)
        st = esim_init(H, W, device=dev)
        split = collections.defaultdict(float)
        out = []
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for fi, hand_list in enumerate(copies[0]):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            params, info = kgen.hand_params(hand_list, to_pca, n_comps, dev)
            lp, li = (x.to(dev) for x in draws.lights[fi])
            ev[0].record()
            verts = sim.meshes(params)
            ev[1].record()
            raster = sim.render(verts, lp, li)
            ev[2].record()
            st, compact = sim.integrate(st, sim.log_frame(raster, bg), np.float32(fi * dt_ns))
            ev[3].record()
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            host = [x.cpu().numpy() for x in (*compact, raster.class_id)]
            t_b = time.perf_counter()
            events, labels = kgen.events_and_labels(CompactEvents(*host[:4]), host[4])
            t_c = time.perf_counter()
            out.append({"events": events, "event_labels": labels, "camera_hand_info": info})
            split["mano_forearms"] += ev[0].elapsed_time(ev[1])
            split["rasterize_scene"] += ev[1].elapsed_time(ev[2])
            split["log_intensity_esim"] += ev[2].elapsed_time(ev[3])
            split["copy_to_host"] += 1e3 * (t_b - t_a)
            split["expand_labels"] += 1e3 * (t_c - t_b)
        t_a = time.perf_counter()
        with open(os.path.join(tmp, "split.pickle"), "wb") as f:
            pickle.dump(out, f)
        split["part_write"] = 1e3 * (time.perf_counter() - t_a)
        wall_ms = 1e3 * (time.perf_counter() - t_start) / len(out)
        split = {k: split[k] / len(out) for k in DATAGEN_SPLIT}
        numbers.update(split_ms=split, split_wall_ms=wall_ms,
                       split_frames_per_s=1e3 / wall_ms)
        log(f"datagen split, ms a frame over copy 0's {len(out)} frames (device stages "
            f"from CUDA events, host stages on the host clock, a sync after the device "
            f"stages): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f"; {wall_ms:.3f} ms a frame on the wall ({1e3 / wall_ms:.2f} frames/s)")
        if sum(len(f["events"]) for f in out) != int(per_frame[:len(out)].sum()):
            raise AssertionError("datagen split: copy 0 re-run gave other events")

        # the device's busy share over 10 frames of copy 0 (simulate_sequence
        # end to end; the profiler's kernel time against the same run's wall
        # time without the profiler)
        def ten():
            list(kgen.simulate_sequence(copies[0][:10], models, cfg, seed=0, device=dev))

        ten()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ten()
        torch.cuda.synchronize()
        ten_ms = 1e3 * (time.perf_counter() - t0) / 10
        kernels = profiled_kernels(torch, ten, 10, "datagen")
        busy = sum(k[1] for k in kernels) / ten_ms
        numbers.update(busy_share=busy, device_ms_per_frame=sum(k[1] for k in kernels),
                       launches_per_frame=sum(k[2] for k in kernels))
        log(f"datagen: device kernels {sum(k[1] for k in kernels):.3f} ms a frame of "
            f"{ten_ms:.3f} ms = {100 * busy:.1f}% busy, {numbers['launches_per_frame']} "
            f"kernel launches a frame")
        for name, ms, count in kernels[:8]:
            log(f"  kernel {ms:9.3f} ms x{count:<5d} {name[:100]}")

        # card vs CPU on copy 0's first frames, the same draws: the
        # rasteriser, then esim_step on the card from the CPU's log frames
        # (bitwise), then the card's own log frames (event counts)
        sim_cpu = simulator("cpu")
        s_cpu = esim_init(H, W, device="cpu")
        s_from_cpu, s_own = esim_init(H, W, device=dev), esim_init(H, W, device=dev)
        fields = CompactEvents._fields + EsimState._fields
        worst = {"class_share": 0.0, "rgb": 0.0, "count_rel": 0.0}
        for fi in range(DATAGEN_CHECKED):
            t = np.float32(fi * dt_ns)
            r = {}
            for name, s_, device in (("cpu", sim_cpu, "cpu"), ("card", sim, dev)):
                params, _ = kgen.hand_params(copies[0][fi], to_pca, n_comps, device)
                lp, li = (x.to(device) for x in draws.lights[fi])
                r[name] = s_.render(s_.meshes(params), lp, li)
            same = r["cpu"].class_id == r["card"].class_id.cpu()
            share = 1.0 - same.float().mean().item()
            rgb = (r["card"].rgb.cpu()[same] - r["cpu"].rgb[same]).abs().max().item()
            log_cpu = sim_cpu.log_frame(r["cpu"], draws.background)
            s_cpu, e_cpu = sim_cpu.integrate(s_cpu, log_cpu, t)
            s_from_cpu, e_card = sim.integrate(s_from_cpu, log_cpu.to(dev), t)
            differ = [k for k, a, b in zip(fields, (*e_cpu, *s_cpu), (*e_card, *s_from_cpu))
                      if not torch.equal(a, b.cpu())]
            s_own, e_own = sim.integrate(s_own, sim.log_frame(r["card"], bg), t)
            n_cpu, n_card = int(e_cpu.count.sum()), int(e_own.count.sum())
            rel = abs(n_card - n_cpu) / max(n_cpu, 1)
            log(f"datagen card vs CPU, frame {fi}: class ids differ on {100 * share:.4f}% "
                f"of pixels, RGB {rgb:.3g} where they agree; esim_step from the CPU's log "
                f"frame: {len(fields) - len(differ)} of {len(fields)} fields bitwise; "
                f"events {n_card} on the card, {n_cpu} on the CPU")
            if share > 1e-3 or not rgb <= 1e-5 or differ or rel > 0.01:
                raise AssertionError(f"datagen card vs CPU, frame {fi}: class share {share}, "
                                     f"rgb {rgb}, fields differ {differ}, events "
                                     f"{n_card} / {n_cpu}")
            worst = {"class_share": max(worst["class_share"], share),
                     "rgb": max(worst["rgb"], rgb), "count_rel": max(worst["count_rel"], rel)}
        numbers["card_vs_cpu"] = worst

        # training steps and a serving request on the generated windows
        reader = Ev2HandSReader.from_rows(rows, annos, n_events=N)
        tcfg = cfg.replace(model=ModelConfig(n_points=N, pallas_gather=True,
                                             pallas_gather_bwd=True))
        hands = ktrain.build_hands(tcfg, synthetic=True, device=dev)
        net = TEHNet(tcfg.model, device=dev)
        net.load_state_dict(state, strict=True)
        step = ktrain.make_train_step(net, hands, ktrain.build_collision_context(hands),
                                      tcfg, ktrain.make_optimizer(net.parameters(), tcfg.train),
                                      augment=True, device=dev)
        batches = reader.batches(TRAIN_B, shuffle=True)
        gen = torch.Generator(device=dev).manual_seed(30)
        reset_launches()
        losses = [step(next(batches), gen) for _ in range(DATAGEN_TRAIN_STEPS)]
        torch.cuda.synchronize()
        train_launches = read_launches()
        log(f"datagen training: {DATAGEN_TRAIN_STEPS} steps at B={TRAIN_B}, N={N} on the "
            f"generated windows; launches {train_launches}; losses "
            + json.dumps([{k: round(v, 4) for k, v in l.items()} for l in losses]))
        check_launches("datagen training", train_launches, TRAIN_PER_STEP,
                       DATAGEN_TRAIN_STEPS)
        if not all(np.isfinite(v) for l in losses for v in l.values()):
            raise AssertionError("datagen training: a loss is not finite")
        del net, step

        batch = next(reader.batches(B, shuffle=False))
        reset_launches()
        with torch.inference_mode():
            served = pipe(torch.from_numpy(batch["events"]), torch.from_numpy(batch["labels"]),
                          torch.Generator(device=dev).manual_seed(31))
        torch.cuda.synchronize()
        serve_launches = read_launches()
        log(f"datagen serving: one request of {B} generated windows; launches "
            f"{serve_launches}")
        check_launches("datagen serving", serve_launches, EVAL_PER_BATCH, 1)
        for key, val in served.items():
            if not torch.isfinite(val).all():
                raise AssertionError(f"datagen serving: {key} is not finite")
        numbers["losses"] = losses[-1]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("datagen numbers: " + json.dumps(numbers))
    return {k: train_launches[k] + serve_launches[k] for k in train_launches}, numbers


# the multi-device phases (21-25): the data-parallel steps at a global batch
# of TRAIN_B and its sharded evaluation's batches; the event-parallel
# forward's batch is B, its training step's TRAIN_B
DP_STEPS, DP_EVAL_BATCHES = 2, 4
DP_RANKS = 2
# compare_steps' bounds for two float32 steps whose sums run in another
# order (two ranks' halves, the dense route's weighted sums, the event
# shards), one set per comparison: chip_smoke_tolerances.bounds_from_readings
# of that comparison's readings over the seeds of chip_smoke_tolerances.py on the
# H100 (five times the largest, rounded up to two significant digits); the
# readings stand in PERF.md. In float64 the same routes agree within 1e-8
# (tests/test_torch_event_parallel_model.py).
STEP_BOUNDS = {   # 8 seeds; 7 for the resynced step (seed 3's state is
    # ill-conditioned: one process's two routes turn a gradient around there)
    "data_parallel": dict(loss_rtol=4.4e-4, cos_min=0.9979, norm_tol=0.054,
                          buf_rtol=1.6e-4),
    "data_parallel_resync": dict(loss_rtol=6.1e-5, cos_min=0.9988, norm_tol=0.033,
                                 buf_rtol=9.1e-5),
    "dense_train": dict(loss_rtol=2.4e-5, cos_min=0.989, norm_tol=0.09, buf_rtol=1.6e-4),
    "event_parallel": dict(loss_rtol=2.7e-5, cos_min=0.989, norm_tol=0.17,
                           buf_rtol=2.1e-4),
    # bf16 against float32, 8 seeds: the gradients decorrelate at random
    # init (per tensor down to cosine -0.71, the whole gradient 0.19-0.59;
    # tests/test_bf16.py:10 says the same of JAX's), so the rule gives no
    # gradient bound (a cosine below -1) and the gradients go unchecked;
    # the loss is held to fall over TRAJECTORY_STEPS steps instead
    "bf16_train": dict(loss_rtol=0.21, cos_min=None, norm_tol=None, buf_rtol=1.8),
    "uv_split": dict(loss_rtol=1.8e-5, cos_min=0.9957, norm_tol=0.064, buf_rtol=1.4e-4),
}
# bf16 training learns: over TRAJECTORY_STEPS steps on one batch with the
# same draws, the mean of the last four total losses below the first
# four's (tests/test_bf16.py:137's check of JAX's bf16 training). Against
# float32's losses step by step it is read and not bounded: at random init
# the loss after a step is chaotic in either precision (largest relative
# difference 0.19-0.47 a seed, that of the last four's means 0.03-0.28,
# over chip_smoke_tolerances.py's 8 seeds; the last four over the first
# four 0.41-0.61, float32's 0.39-0.54)
TRAJECTORY_STEPS = 12
# a step with deterministic FPS: one draw serves both regressor heads
DET_PER_STEP = {"fps": 3, "onehot_gather": 4, "onehot_scatter_add": 3}


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def timed(torch, dev, fn):
    """``fn()`` between two syncs of ``dev`` -> (its result, seconds)."""
    sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    return out, time.perf_counter() - t0


def profile_collectives(torch, dev, fn):
    """``fn()`` under torch.profiler -> the collectives of that run: the
    calls (the dispatcher's "c10d::*" operations, one a call), the seconds
    covered on the host by them and by the backend's operations ("gloo:*",
    which include gloo's copies of CUDA tensors, and "nccl:*"), and the
    seconds of NCCL's device kernels, each also as a share of the profiled
    run's wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = timed(torch, dev, fn)
    events = prof.events()
    host = [e for e in events if e.name.startswith(("gloo:", "nccl:", "c10d::"))]
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and "nccl" in e.name.lower()]
    host_s = covered([(e.time_range.start, e.time_range.end) for e in host])
    dev_s = covered([(e.time_range.start, e.time_range.end) for e in kernels])
    calls = sum(e.name.startswith("c10d::") for e in host)
    return dict(calls=calls, events=dict(collections.Counter(e.name for e in host)),
                host_s=host_s / 1e6, host_share=host_s / 1e6 / wall, kernels=len(kernels),
                device_s=dev_s / 1e6, device_share=dev_s / 1e6 / wall, wall_s=wall)


def covered(spans):
    """The length of the union of [start, end) spans: the caller's span of
    a collective and its backend's spans (gloo records two a call on CUDA
    tensors, in its worker threads) count their overlap once."""
    total, end = 0, None
    for a, b in sorted(spans):
        if end is not None and b <= end:
            continue
        total += b - max(a, end) if end is not None and a < end else b - a
        end = b
    return total


def collectives_text(c):
    return (f"collectives {c['calls']} calls ({c['events']} events): "
            f"{100 * c['host_share']:.2f}% of "
            f"the profiled run's {c['wall_s']:.3f} s on the host, {c['kernels']} NCCL "
            f"kernels {100 * c['device_share']:.2f}%")


def counted_run(torch, dev, fn, profile=True):
    """``fn() -> (result, seconds)`` once with its kernel launches counted:
    its result is what the phase checks. With ``profile``, then once more
    for the seconds (warm: a rank's first run pays its process's first
    CUDA work; no instrumentation) and once under torch.profiler for its
    collectives. -> (result, {"secs", "launches", "collectives"})."""
    reset_launches()
    res, secs = fn()
    info = dict(secs=secs, launches=read_launches(), collectives=None)
    if profile:
        _, info["secs"] = fn()
        info["collectives"] = profile_collectives(torch, dev, fn)
    return res, info


def route_config(**model):
    """Phase 10's kernel route with deterministic FPS and no dropout, at
    full width; ``model`` overrides."""
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig

    kw = dict(n_points=N, fps_deterministic=True, pallas_gather=True,
              pallas_gather_bwd=True, dropout_classifier=0.0, dropout_query=0.0,
              dropout_regressor=0.0)
    return DEFAULT_CONFIG.replace(model=ModelConfig(**{**kw, **model}))


def dp_inputs(torch, np, seed=0):
    """The training batches of the multi-device steps (at ``seed`` 0 phase
    10's first batch and the next), each with draws made on the CPU from a
    seed."""
    cfg = route_config()
    batches = [fake_batch(np, 10 + i + 100 * seed, TRAIN_B) for i in range(DP_STEPS)]
    return batches, [given_draws(torch, b, cfg, seed=7 + i + 100 * seed)
                     for i, b in enumerate(batches)]


def multi_steps(torch, dev, state, cfg, batches, draws, mesh=None, event_mesh=None):
    """Training steps from the weights ``state`` through the entry point,
    the batches and draws given (global ones under a mesh) -> ([(losses,
    gradients, BatchNorm buffers, parameters after Adam) after each step],
    the steps' seconds)."""
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.model.tehnet import TEHNet

    hands = ktrain.build_hands(cfg, synthetic=True, device=dev)
    net = TEHNet(cfg.model, device=dev, mesh=mesh, event_mesh=event_mesh)
    net.load_state_dict(state, strict=True)
    step = ktrain.make_train_step(net, hands, ktrain.build_collision_context(hands), cfg,
                                  ktrain.make_optimizer(net.parameters(), cfg.train),
                                  device=dev)
    runs = []
    sync(torch, dev)
    t0 = time.perf_counter()
    for batch, (d, nz) in zip(batches, draws):
        losses = step(batch, draws=d, noise=nz)
        runs.append((losses, *step_state(net)))
    sync(torch, dev)
    return runs, time.perf_counter() - t0


def loss_trajectory(torch, dev, state, cfg, batch, draws, steps=TRAJECTORY_STEPS):
    """The total loss of ``steps`` training steps through the entry point,
    from the weights ``state``, each on ``batch`` with the draws ``draws``
    -> [loss]."""
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.model.tehnet import TEHNet

    hands = ktrain.build_hands(cfg, synthetic=True, device=dev)
    net = TEHNet(cfg.model, device=dev)
    net.load_state_dict(state, strict=True)
    step = ktrain.make_train_step(net, hands, ktrain.build_collision_context(hands), cfg,
                                  ktrain.make_optimizer(net.parameters(), cfg.train),
                                  device=dev)
    d, nz = draws
    return [step(batch, draws=d, noise=nz)["loss"] for _ in range(steps)]


def trajectory_reading(bf16, f32):
    """bf16's loss trajectory against float32's -> (the largest relative
    difference of a step's loss, the mean of the last four bf16 losses over
    the mean of the first four)."""
    dev = max(abs(a - b) / abs(b) for a, b in zip(bf16, f32))
    return dev, fall(bf16)


def fall(losses):
    """The mean of the last four losses over the mean of the first four."""
    return sum(losses[-4:]) / sum(losses[:4])


def layer_dtypes(net):
    """Hooks on every Pointwise, Conv1dK3 and BatchNorm of ``net`` that
    record the dtypes of their outputs -> ({module name: dtype names}, a
    function that removes the hooks)."""
    from ev2hands_tpu_torch.model import layers as klayers

    seen, handles = {}, []
    for name, m in net.named_modules():
        if isinstance(m, (klayers.Pointwise, klayers.Conv1dK3, klayers.BatchNorm)):
            handles.append(m.register_forward_hook(
                lambda m, a, out, name=name: seen.setdefault(name, set()).add(
                    str(out.dtype).split(".")[-1])))
    return seen, lambda: [h.remove() for h in handles]


def cpu_layer_dtypes(torch, np, state, train, **model):
    """``layer_dtypes``'s record of the port's forward on the CPU, one cloud
    of 256 events, in training or eval, deterministic and without dropout;
    in eval sa1's scales take the block-sparse route, as at N=2048 (its
    pair threshold lowered to its 512 x 256 pairs, above every other
    layer's). tests/test_torch_bf16_routing.py holds this record against
    the JAX package's routing."""
    from ev2hands_tpu_torch.config import ModelConfig
    from ev2hands_tpu_torch.model import layers as klayers
    from ev2hands_tpu_torch.model.tehnet import TEHNet

    n = 256
    rng = np.random.RandomState(0)
    cloud = np.concatenate([rng.rand(1, n, 2) * 2 - 1, np.sort(rng.rand(1, n, 1) * 2 - 1, 1),
                            rng.randint(1, 5, (1, n, 2))], -1).astype(np.float32)
    net = TEHNet(ModelConfig(n_points=n, fps_deterministic=True, dropout_classifier=0.0,
                             dropout_query=0.0, dropout_regressor=0.0, **model),
                 device="cpu")
    net.load_state_dict(state, strict=True)
    net.train(train)
    seen, remove = layer_dtypes(net)
    threshold = klayers.SPARSE_MIN_PAIRS
    klayers.SPARSE_MIN_PAIRS = 512 * n
    try:
        with torch.no_grad():
            net(torch.from_numpy(cloud))
    finally:
        klayers.SPARSE_MIN_PAIRS = threshold
        remove()
    return seen


def check_layer_dtypes(what, got, want):
    """The card's layer dtypes ``got`` equal the CPU port's ``want``, and
    some layer ran in bfloat16."""
    n16 = sum(d == {"bfloat16"} for d in got.values())
    log(f"{what}: {len(got)} conv and BatchNorm layers called, {n16} with bfloat16 "
        f"outputs, {len(got) - n16} float32; the CPU port's routing "
        + ("matches" if got == want else "differs"))
    if got != want or not n16:
        bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        raise AssertionError(f"{what}: layer dtypes differ from the CPU port's at {bad[:8]}"
                             if bad else f"{what}: no layer ran in bfloat16")


def state_after(run):
    """The state dict of a net after a step of ``multi_steps``: its
    parameters after Adam and its BatchNorm buffers."""
    _, _, bufs, params = run
    return {**params, **bufs}


def bitwise_differ(torch, a, b):
    """The names that differ between two step records (losses, gradients,
    buffers, parameters)."""
    (la, *ta), (lb, *tb) = a, b
    out = [f"loss {k}" for k in la if la[k] != lb[k]]
    for what, x, y in zip(("gradient", "buffer", "parameter"), ta, tb):
        out += [f"{what} {k}" for k in x if not torch.equal(x[k], y[k])]
    return out


def capturing(modules, names):
    """Patch the functions ``names`` of ``modules`` (where a module has one)
    to record a CPU copy of each result -> (the record, a function that
    undoes the patch)."""
    record, undo = [], []
    for m in modules:
        for name in names:
            if not hasattr(m, name):
                continue
            real = getattr(m, name)

            def wrapped(*a, _real=real, **k):
                idx = _real(*a, **k)
                record.append(idx.detach().cpu().clone())
                return idx
            setattr(m, name, wrapped)
            undo.append((m, name, real))
    return record, lambda: [setattr(m, n, r) for m, n, r in undo]


def event_forward(torch, dev, state, events, event_mesh):
    """The eval forward of the ERPC clouds ``events`` [B, N, 5], one process
    (``event_mesh`` None: the default route, K1 and K2) or event-sharded
    -> ((outputs on the CPU, the FPS indices in call order), seconds)."""
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.model import layers as klayers
    from ev2hands_tpu_torch.model import tehnet as ktehnet

    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N, event_parallel=True))
    net = ktehnet.TEHNet(cfg.model, device=dev, event_mesh=event_mesh)
    net.load_state_dict(state, strict=True)
    net.eval()
    name = "fps_unchecked" if event_mesh is None else "event_sharded_fps"
    record, undo = capturing((klayers, ktehnet), (name,))
    try:
        with torch.inference_mode():
            out, secs = timed(torch, dev, lambda: net(events.to(dev)))
    finally:
        undo()
    flat = {"class_logits": out["class_logits"].cpu()}
    flat.update({f"{s}_{k}": out[s][k].cpu() for s in ("left", "right") for k in out[s]})
    return (flat, record), secs


def check_event_forward(torch, name, got, secs, ref, ref_secs):
    """Phase 24's forward check: every FPS index equal, every output within
    1e-4 of the one-process forward's."""
    (out, fps), (ref_out, ref_fps) = got, ref
    if len(fps) != len(ref_fps) or not all(torch.equal(a, b) for a, b in zip(fps, ref_fps)):
        raise AssertionError(f"{name}: FPS indices differ from the one-process forward's")
    diffs = {k: (out[k] - v).abs().max().item() for k, v in ref_out.items()}
    log(f"{name}: {len(fps)} FPS calls with the one-process forward's indices, "
        f"{sum(f.numel() for f in fps)} indices; outputs max abs diff "
        + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
        + f" (limit 1e-4); {B / secs:.2f} windows/s (one process: {B / ref_secs:.2f})")
    bad = {k: v for k, v in diffs.items() if not v <= 1e-4}
    if bad:
        raise AssertionError(f"{name}: outputs differ beyond 1e-4: {bad}")


def two_rank_work(device, sizes, state, resync, batches, draws, eval_rows, events, rec):
    """Phases 22 and 24a on one rank of two over gloo, both on ``device``
    (the card): the data-parallel steps, their second step again from the
    one-process route's state ``resync`` after its first, the sharded
    evaluation and a finetuning step, then the event-parallel forward and
    training step at (data 1, event 2). Each counted; each but the resynced
    step then run again, timed and under the profiler (``counted_run``).
    ``sizes`` are the parent's batch and cloud sizes (a CPU rehearsal
    shrinks them). -> what the parent checks, on the CPU."""
    import torch
    import torch.distributed as dist

    from ev2hands_tpu_torch import finetune as kft
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.events.real_streams import Ev2HandRReader
    from ev2hands_tpu_torch.events.streams import Ev2HandSReader
    from ev2hands_tpu_torch.model.tehnet import TEHNet
    from ev2hands_tpu_torch.ops import _build
    from ev2hands_tpu_torch.parallel import mesh as pm

    globals().update(sizes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = pm.local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        for name in _build.KERNELS:   # built by the parent; loaded here
            _build.load(name)
    out = {"device": str(dev)}
    mesh = pm.create_mesh(DP_RANKS, dev)

    def run(key, fn, profile=True):
        res, out[key] = counted_run(torch, dev, fn, profile)
        return res

    # 22a. the data-parallel steps; the second again from the one-process state
    for key, start, part, prof in (("steps", state, slice(None), True),
                                   ("resync_step", resync, slice(1, None), False)):
        runs = run(key, lambda: multi_steps(torch, dev, start, route_config(),
                                            batches[part], draws[part], mesh), prof)
        out[key]["runs"] = runs if mesh.is_main else None
    # 22b. the sharded mid-run evaluation
    cfg = loop_config(EVAL_B, max_eval_iters=DP_EVAL_BATCHES * EVAL_B)
    net = TEHNet(cfg.model, device=dev, mesh=mesh)
    net.load_state_dict(state, strict=True)
    hands = ktrain.build_hands(cfg, synthetic=True, device=dev)
    estep = ktrain.make_eval_step(net, hands, cfg, dev)
    out["metrics"] = run("eval", lambda: timed(torch, dev, lambda: ktrain.evaluate(
        estep, Ev2HandSReader.from_rows(*eval_rows, N), cfg, device=dev)))
    # 22c. one finetuning step
    proj = cfg.camera.projection_matrix(cfg.sensor.width, cfg.sensor.height)
    batch = next(Ev2HandRReader(rec, seed=4).batches(TRAIN_B))

    def finetune_step():
        net.load_state_dict(state, strict=True)
        fstep = kft.make_finetune_step(
            net, hands, ktrain.build_collision_context(hands), cfg,
            ktrain.make_optimizer(net.parameters(), cfg.train), proj, dev)
        return timed(torch, dev, lambda: fstep(batch, ktrain.seeded_generator(2, 0, dev)))

    out["finetune_losses"] = run("finetune", finetune_step)
    del net, estep

    # 24a. event parallel at (data 1, event 2)
    emesh = pm.create_event_mesh(DP_RANKS, 1, dev)
    out["event_out"] = run("event_forward",
                           lambda: event_forward(torch, dev, state, events, emesh))
    runs = run("event_step", lambda: multi_steps(
        torch, dev, state, route_config(dense_train=True, event_parallel=True),
        batches[:1], draws[:1], event_mesh=emesh))
    out["event_step"]["runs"] = runs if mesh.is_main else None

    # what gloo carries for CUDA tensors on this build
    ops = {}
    for name, dtype, op in (("all_reduce SUM float32", torch.float32, dist.ReduceOp.SUM),
                            ("all_reduce SUM float64", torch.float64, dist.ReduceOp.SUM),
                            ("all_reduce SUM int64", torch.int64, dist.ReduceOp.SUM),
                            ("all_reduce MAX float32", torch.float32, dist.ReduceOp.MAX),
                            ("broadcast float32", torch.float32, None)):
        t = torch.full((4,), mesh.rank + 1, dtype=dtype, device=dev)
        try:
            if op is None:
                dist.broadcast(t, 0)
                want = 1
            else:
                dist.all_reduce(t, op=op)
                want = 3 if op == dist.ReduceOp.SUM else 2
            ops[name] = "ok" if (t == want).all().item() else f"wrong result {t.tolist()}"
        except Exception as e:  # the record names what failed
            ops[name] = f"{type(e).__name__}: {str(e)[:100]}"
    out["gloo_cuda_ops"] = ops
    return out


def free_second_step(name, ranks, plain, lr):
    """Log the second step of free-running data-parallel steps against the
    one-process route's; its losses must be finite. Adam's first update
    moves every parameter by about lr * sign(gradient), so a gradient entry
    near 0 that rounding flipped moves its parameter by 2 lr, and the second
    step starts elsewhere: the log gives the parameters that moved apart by
    more than lr, and the first-order change of the total loss that their
    difference dθ predicts, g · dθ with g the one-process route's gradient
    at the second step. No bound holds this step (Cauchy-Schwarz's
    |g| |dθ| stands orders above the loss); the resynced second step is
    held instead."""
    theta_r, theta_p, grads = ranks[0][3], plain[0][3], plain[1][1]
    dtheta = {k: theta_r[k].double() - theta_p[k].double() for k in theta_p}
    flips = sum(int((d.abs() > lr).sum()) for d in dtheta.values())
    pred = sum((grads[k].double() * d).sum().item() for k, d in dtheta.items())
    got, want = ranks[1][0], plain[1][0]
    log(f"{name}: {flips} parameters differ by more than lr after the first step; total "
        f"loss {got['loss']!r} against {want['loss']!r}, diff "
        f"{got['loss'] - want['loss']:.4g}, first-order prediction {pred:.4g}")
    if not all(math.isfinite(v) for v in got.values()):
        raise AssertionError(f"{name}: a loss term is not finite")


def multi_device_phases(torch, np, dev, state, raw0, lab0, draws0):
    """Phases 21-24: data parallel at world size 1 over NCCL (bitwise against
    the plain route) and at world size 2 over gloo with both ranks on the
    card (steps, the sharded evaluation, a finetuning step), dense_train
    against the gather route, and event parallel over gloo at (data 1,
    event 2) and over NCCL at world size 1. The one-process references run
    uncounted. -> (launches by path, numbers)."""
    import torch.distributed as dist

    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.events.erpc import erpc_batch_transform
    from ev2hands_tpu_torch.events.real_streams import write_synthetic_ev2hands_r
    from ev2hands_tpu_torch.events.streams import Ev2HandSReader, synthetic_ev2hands_s
    from ev2hands_tpu_torch.model.tehnet import TEHNet, batchnorm_cancelled_biases
    from ev2hands_tpu_torch.parallel import mesh as pm

    cuda = torch.device(dev).type == "cuda"
    batches, draws = dp_inputs(torch, np)
    skip = batchnorm_cancelled_biases(TEHNet(route_config().model, device="cpu"))
    launches, numbers = {}, {}
    t_phase = time.perf_counter()

    # 21. data parallel at world size 1 over NCCL against the plain route
    plain, plain_s = multi_steps(torch, dev, state, route_config(), batches, draws)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{os.path.join(tmp, 'init')}",
                            world_size=1, rank=0)
    try:
        mesh = pm.create_mesh(1, dev)
        one, info = counted_run(torch, dev, lambda: multi_steps(
            torch, dev, state, route_config(), batches, draws, mesh))
        launches["data_parallel_ws1"] = info["launches"]
        check_launches("data parallel (world size 1)", info["launches"], DET_PER_STEP,
                       DP_STEPS)
        differ = [d for a, b in zip(one, plain) for d in bitwise_differ(torch, a, b)]
        coll = info["collectives"]
        log(f"data parallel, world size 1 over {dist.get_backend()}: {DP_STEPS} steps of "
            f"{TRAIN_B} windows, every loss term, gradient, BatchNorm statistic and "
            f"parameter after Adam against the plain route: {len(differ)} differ; "
            f"{DP_STEPS * TRAIN_B / info['secs']:.2f} windows/s (plain "
            f"{DP_STEPS * TRAIN_B / plain_s:.2f}); " + collectives_text(coll))
        if differ:
            raise AssertionError(f"data parallel (world size 1): {differ[:8]}")
        numbers["data_parallel_ws1"] = dict(
            windows_per_s=DP_STEPS * TRAIN_B / info["secs"],
            plain_windows_per_s=DP_STEPS * TRAIN_B / plain_s, collectives=coll)

        # 23. dense_train against the gather route (plain's first step)
        dense, info = counted_run(torch, dev, lambda: multi_steps(
            torch, dev, state, route_config(dense_train=True), batches[:1], draws[:1]),
            profile=False)
        launches["dense_train"] = info["launches"]
        check_launches("dense_train", launches["dense_train"], {"fps": 3}, 1)
        compare_steps(torch, "dense_train vs the gather route (B=8)", dense[0][:3],
                      plain[0][:3], skip=skip, **STEP_BOUNDS["dense_train"])
        log(f"dense_train: one step of {TRAIN_B} windows in {info['secs']:.3f} s, "
            f"{TRAIN_B / info['secs']:.2f} windows/s; peak device memory "
            + (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB" if cuda else "-"))
        numbers["dense_train"] = dict(windows_per_s=TRAIN_B / info["secs"])

        # 24b. event parallel at world size 1 over NCCL
        events = erpc_batch_transform(torch.from_numpy(raw0), torch.from_numpy(lab0),
                                      draws=draws0, n_out=N).events
        ref_fwd, ref_s = event_forward(torch, dev, state, events, None)
        emesh = pm.create_event_mesh(1, 1, dev)
        got, fwd = counted_run(torch, dev,
                               lambda: event_forward(torch, dev, state, events, emesh))
        check_launches("event parallel forward (world size 1)", fwd["launches"], {}, 1)
        check_event_forward(torch, f"event parallel forward, world size 1 over "
                                   f"{dist.get_backend()}, B={B}", got, fwd["secs"],
                            ref_fwd, ref_s)
        ev1, step = counted_run(torch, dev, lambda: multi_steps(
            torch, dev, state, route_config(dense_train=True, event_parallel=True),
            batches[:1], draws[:1], event_mesh=emesh))
        check_launches("event parallel step (world size 1)", step["launches"], {}, 1)
        launches["event_parallel_ws1"] = {k: fwd["launches"][k] + step["launches"][k]
                                          for k in step["launches"]}
        compare_steps(torch, "event parallel dense_train step, world size 1, vs one "
                             "process", ev1[0][:3], dense[0][:3], skip=skip,
                      **STEP_BOUNDS["event_parallel"])
        log(f"event parallel, world size 1: forward {B / fwd['secs']:.2f} windows/s, "
            + collectives_text(fwd["collectives"]) + f"; dense_train step "
            f"{TRAIN_B / step['secs']:.2f} windows/s, " + collectives_text(step["collectives"]))
        numbers["event_parallel_ws1"] = dict(
            forward_windows_per_s=B / fwd["secs"], forward_collectives=fwd["collectives"],
            step_windows_per_s=TRAIN_B / step["secs"], step_collectives=step["collectives"])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    # 22 and 24a. two ranks over gloo, both on the card
    eval_rows = synthetic_ev2hands_s(n_events=65536, n_frames=DP_EVAL_BATCHES * EVAL_B,
                                     seed=1)
    cfg = loop_config(EVAL_B, max_eval_iters=DP_EVAL_BATCHES * EVAL_B)
    net = TEHNet(cfg.model, device=dev)
    net.load_state_dict(state, strict=True)
    hands = ktrain.build_hands(cfg, synthetic=True, device=dev)
    ref_metrics = ktrain.evaluate(ktrain.make_eval_step(net, hands, cfg, dev),
                                  Ev2HandSReader.from_rows(*eval_rows, N), cfg, device=dev)
    del net
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        rec = write_synthetic_ev2hands_r(os.path.join(tmp, "subject.pickle"))
        sizes = dict(N=N, B=B, TRAIN_B=TRAIN_B, EVAL_B=EVAL_B)
        results, ranks_s = timed(torch, dev, lambda: pm.run_ranks(
            two_rank_work, DP_RANKS, torch.device(dev).type, sizes, state,
            state_after(plain[0]), batches, draws, eval_rows, events, rec,
            backend="gloo", timeout=900))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = results[0]
    log(f"two ranks over gloo on {[r['device'] for r in results]}: {ranks_s:.1f} s with "
        f"their start-up; gloo on CUDA tensors: " + json.dumps(r0["gloo_cuda_ops"]))
    for r in results:
        for key, per, units in (("steps", DET_PER_STEP, DP_STEPS),
                                ("resync_step", DET_PER_STEP, 1),
                                ("eval", EVAL_PER_BATCH, DP_EVAL_BATCHES),
                                ("finetune", TRAIN_PER_STEP, 1),
                                ("event_forward", {}, 1), ("event_step", {}, 1)):
            check_launches(f"two ranks: {key}", r[key]["launches"], per, units)

    def total(keys):
        return {k: sum(r[key]["launches"][k] for r in results for key in keys)
                for k in r0["steps"]["launches"]}

    launches["data_parallel_ws2"] = total(("steps", "resync_step", "eval", "finetune"))
    launches["event_parallel_ws2"] = total(("event_forward", "event_step"))
    # f32 sums in another order (each rank's half, then the all-reduce)
    compare_steps(torch, "data parallel, 2 ranks vs one process, step 0",
                  r0["steps"]["runs"][0][:3], plain[0][:3], skip=skip,
                  **STEP_BOUNDS["data_parallel"])
    compare_steps(torch, "data parallel, 2 ranks vs one process, step 1 from the one-process "
                         "state after step 0", r0["resync_step"]["runs"][0][:3],
                  plain[1][:3], skip=skip, **STEP_BOUNDS["data_parallel_resync"])
    free_second_step("data parallel, 2 ranks vs one process, step 1 from the ranks' own "
                     "state", r0["steps"]["runs"], plain, route_config().train.learning_rate)
    (m1, s1), (m2, s2) = ref_metrics, r0["metrics"]
    auc_dev = max(abs(m2["auc"][k] - v) / max(abs(v), 1e-30) for k, v in m1["auc"].items())
    log(f"sharded evaluation ({DP_EVAL_BATCHES} batches of {EVAL_B}, {EVAL_B // DP_RANKS} "
        f"a rank): score {s2} against {s1} unsharded, AUC max rel diff {auc_dev:.3g} "
        f"(limit 1e-5)")
    if not (abs(s2 - s1) <= 1e-5 * abs(s1) and auc_dev <= 1e-5):
        raise AssertionError("sharded evaluation: metrics differ from the unsharded")
    ft = r0["finetune_losses"]
    log("finetuning, 2 ranks, one step: " + json.dumps(ft))
    if not all(np.isfinite(v) for v in ft.values()):
        raise AssertionError("finetuning (2 ranks): a loss term is not finite")
    check_event_forward(torch, f"event parallel forward, (data 1, event 2) over gloo, "
                               f"B={B}", r0["event_out"], r0["event_forward"]["secs"],
                        ref_fwd, ref_s)
    compare_steps(torch, "event parallel dense_train step, 2 ranks, vs one process",
                  r0["event_step"]["runs"][0][:3], dense[0][:3], skip=skip,
                  **STEP_BOUNDS["event_parallel"])
    st, ev, fs = r0["steps"], r0["eval"], r0["finetune"]
    ef, es = r0["event_forward"], r0["event_step"]
    for what, part in (("steps", st), ("evaluation", ev), ("finetuning", fs),
                       ("event forward", ef), ("event step", es)):
        log(f"two ranks, {what}: " + collectives_text(part["collectives"]))
    numbers["data_parallel_ws2"] = dict(
        step_windows_per_s=DP_STEPS * TRAIN_B / st["secs"], step_collectives=st["collectives"],
        eval_windows_per_s=DP_EVAL_BATCHES * EVAL_B / ev["secs"],
        eval_collectives=ev["collectives"],
        finetune_windows_per_s=TRAIN_B / fs["secs"], finetune_collectives=fs["collectives"],
        gloo_cuda_ops=r0["gloo_cuda_ops"], ranks_s=ranks_s)
    numbers["event_parallel_ws2"] = dict(
        forward_windows_per_s=B / ef["secs"], forward_collectives=ef["collectives"],
        step_windows_per_s=TRAIN_B / es["secs"], step_collectives=es["collectives"])
    log(f"phases 21-24 took {time.perf_counter() - t_phase:.1f} s")
    return launches, numbers


def card_vs_cpu_limit(key):
    """The largest abs difference allowed between an output ``key`` of the
    card and of the port on the CPU: the ERPC events exact, the hands' 3D
    points 1e-4, every other output 1e-3."""
    return 0.0 if key == "events" else 1e-4 if key.endswith(("vertices", "j3d")) else 1e-3


def split_export_phase(torch, np, dev, state, tmp):
    """Phase 25: the serving export for two devices (data_parallel=2: the
    one-device program at B/2) loaded on [dev, dev]; one request of B
    windows split over both, each shard bitwise equal to the one-device
    program on its windows, counted. Then the artifact loaded on [CPU,
    dev], which moves the first shard's program to the CPU: that shard
    within phase 5's card-against-CPU limits of the one-device program, the
    other bitwise. -> (launches, numbers)."""
    from ev2hands_tpu_torch import export as kex
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.model.tehnet import TEHNet

    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N))
    net = TEHNet(cfg.model, device=dev)
    net.load_state_dict(state, strict=True)
    hands = ktrain.build_hands(cfg, synthetic=True, device=dev)
    path = os.path.join(tmp, "serving_split.pt2")
    program = kex.export_serving(net, hands, cfg, B, EXPORT_EVENTS, path=path,
                                 data_parallel=DP_RANKS)
    shape = tuple(program.example_inputs[0][0].shape)
    split = kex.load_serving(path, devices=[dev] * DP_RANKS)
    single = kex.load_serving(path)
    e, v = real_request(np, 50, EXPORT_EVENTS)
    u = torch.rand((B, N), generator=torch.Generator().manual_seed(51), dtype=torch.float64)
    req = tuple(torch.from_numpy(x).to(dev) for x in (e, v)) + (u.to(dev),)
    reset_launches()
    out = split(*req)
    sync(torch, dev)
    launches = read_launches()
    check_launches("split export", launches, EVAL_PER_BATCH, DP_RANKS)
    b = B // DP_RANKS
    refs = [single(*(t[i * b:(i + 1) * b] for t in req)) for i in range(DP_RANKS)]
    for i, ref in enumerate(refs):
        bad = [k for k, t in ref.items() if not torch.equal(out[k][i * b:(i + 1) * b], t)]
        if bad:
            raise AssertionError(f"split export: shard {i} differs from the one-device "
                                 f"program in {bad}")
    ms = {"split": cuda_ms(torch, lambda: split(*req), 5),
          "one program": cuda_ms(torch, lambda: [single(*(t[i * b:(i + 1) * b] for t in req))
                                                 for i in range(DP_RANKS)], 5)}
    log(f"split export: program input {list(shape)}, {DP_RANKS} shards on "
        f"{[str(dev)] * DP_RANKS}, each bitwise equal to the one-device program; "
        f"{B / (ms['split'] / 1e3):.2f} windows/s split, "
        f"{B / (ms['one program'] / 1e3):.2f} windows/s the shards one after the other "
        f"through one loaded program (B={B}, {EXPORT_EVENTS} events a window)")

    # the program moved to the CPU by load_serving
    devices = ["cpu"] + [dev] * (DP_RANKS - 1)
    mixed = kex.load_serving(path, devices=devices)
    moved, secs = timed(torch, dev, lambda: mixed(*req))
    diffs = {k: (moved[k][:b].double() - t.double()).abs().max().item()
             for k, t in refs[0].items() if k != "seg"}
    seg_differ = int((moved["seg"][:b] != refs[0]["seg"]).sum())
    log(f"split export on {devices}: the CPU shard against the one-device program on the "
        f"card, max abs diff " + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
        + f"; {seg_differ} of {refs[0]['seg'].numel()} seg labels differ; {secs:.1f} s")
    for k, d in diffs.items():
        limit = card_vs_cpu_limit(k)
        if not d <= limit:
            raise AssertionError(f"split export on {devices}: {k} differs by {d} > {limit}")
    for i in range(1, DP_RANKS):
        bad = [k for k, t in refs[i].items()
               if not torch.equal(moved[k][i * b:(i + 1) * b], t)]
        if bad:
            raise AssertionError(f"split export on {devices}: shard {i} differs in {bad}")
    return launches, {k: B / (v / 1e3) for k, v in ms.items()}


# the default-off switches (phases 26-29) and the event-mesh export (phase
# 30): the timing repetitions of each A/B, interleaved (A, B, A, B)
AB_REPS, AB_ITERS = 2, 10
# tests/test_bf16.py:219, the bound between JAX's bf16 and float32 forwards
BF16_EVAL_BOUND = dict(cos_min=0.999, agree_min=0.98, params_abs=3e-2)
# the event-mesh export against phase 16's one-device program (the JAX
# package's tests/test_export.py:149-153)
EVENT_EXPORT_TOL = 1e-5


def request_draws(torch, raw, lab, cfg, seed):
    """The resample draws of a serving request, made on the CPU from a
    seed, so that every pipeline takes the same ones."""
    from ev2hands_tpu_torch.events.erpc import rasterize_erpc, resample_draws

    _, _, n_valid = rasterize_erpc(torch.from_numpy(raw), torch.from_numpy(lab),
                                   cfg.sensor.width, cfg.sensor.height)
    return resample_draws(n_valid, cfg.model.n_points, torch.Generator().manual_seed(seed))


def interleaved_ms(torch, fns, iters=AB_ITERS, reps=AB_REPS):
    """ms a call of each of ``fns`` (name -> fn), timed in turns (A, B, A,
    B, ...), with the peak device memory of each -> {name: (ms list, peak
    GiB)}."""
    out = {name: ([], 0.0) for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(torch, fn, iters, warmup=2)
            peak = torch.cuda.max_memory_allocated() / 2**30
            out[name] = (out[name][0] + [ms], max(out[name][1], peak))
    return out


def serving_requests(torch, np, cfg, seed0):
    """REQUESTS raw serving requests with their draws."""
    reqs = []
    for j in range(REQUESTS):
        raw, lab = raw_request(np, seed0 + j)
        reqs.append((torch.from_numpy(raw), torch.from_numpy(lab),
                     request_draws(torch, raw, lab, cfg, seed0 + 100 + j)))
    return reqs


def flip_request(torch, dev, pipe, req, seed):
    """A serving call of ``pipe`` on ``req`` with a new polarity flip each
    time (as phase 6)."""
    raw_d, lab_d = req[0].to(dev), req[1].to(dev)
    flip_gen = torch.Generator(device=dev).manual_seed(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def one():
        flip = torch.rand((B, 1), generator=flip_gen, device=dev) < 0.5
        p = raw_d[..., 3]
        ev = torch.cat([raw_d[..., :3], torch.where(flip, 1.0 - p, p)[..., None]], -1)
        return pipe(ev, lab_d, gen)
    return one


def switch_serving_phases(torch, np, dev, state):
    """Phases 26-27: serving at B=16, N=2048 with fused_regressors and with
    bf16_eval, each against the default pipeline on the same requests and
    draws, counted and timed beside it. -> (launches by path, numbers)."""
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.mano.model_data import synthetic_mano_models
    from ev2hands_tpu_torch.model import fused_regressor as kfused
    from ev2hands_tpu_torch.model import layers as klayers
    from ev2hands_tpu_torch.model import tehnet as ktehnet
    from ev2hands_tpu_torch.serve import InferencePipeline

    mano = synthetic_mano_models(0)
    pipes = {name: InferencePipeline(DEFAULT_CONFIG.replace(model=ModelConfig(
        n_points=N, **model)), state, mano, device="cuda")
        for name, model in (("default", {}), ("fused", dict(fused_regressors=True)),
                            ("bf16_eval", dict(bf16_eval=True)))}
    reqs = serving_requests(torch, np, pipes["default"].cfg, 60)
    launches, numbers, outs = {}, {}, {}
    for name in ("fused", "bf16_eval", "default"):
        reset_launches()
        outs[name] = [pipes[name](raw, lab, draws=d) for raw, lab, d in reqs]
        torch.cuda.synchronize()
        launches[name] = read_launches()
        check_launches(f"serving ({name})", launches[name], EVAL_PER_BATCH, REQUESTS)
    launches.pop("default")   # the reference run
    for name in ("fused", "bf16_eval"):
        for j, out in enumerate(outs[name]):
            for key, val in out.items():
                if val.dtype != torch.float32 or not torch.isfinite(val).all():
                    raise AssertionError(f"serving ({name}): request {j} {key} is "
                                         f"{val.dtype} or not finite")

    # 26. the fused heads against the separate heads: the ERPC cloud and the
    # logits as the trunk leaves them, the hands within 1e-4
    diffs = {k: max((a[k] - b[k]).abs().max().item()
                    for a, b in zip(outs["fused"], outs["default"]))
             for k in outs["default"][0]}
    limits = {k: 0.0 if k == "events" else 1e-3 if k == "class_logits" else VERTEX_TOL
              for k in diffs}
    log(f"fused regressor heads vs separate heads ({REQUESTS} requests of {B}): max abs "
        "diff " + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()))
    bad = {k: v for k, v in diffs.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"fused regressor heads: beyond the limits {bad}")

    # 27. bf16 eval: every FPS index and selection mask of the float32
    # forward, outputs within the JAX package's bf16 bound
    seen = {}
    dtypes, remove = layer_dtypes(pipes["bf16_eval"].net)
    for name in ("default", "bf16_eval"):
        record, undo = capturing((klayers, ktehnet, kfused),
                                ("fps_unchecked", "dense_selection_mask"))
        try:
            pipes[name](*reqs[0][:2], draws=reqs[0][2])
        finally:
            undo()
        seen[name] = record
    remove()
    a, b = seen["default"], seen["bf16_eval"]
    # 3 FPS draws (sa1, sa2, the heads' shared one) and a selection mask for
    # each of the 3 + 2 + 2 x 2 scales
    if len(a) != 12 or len(b) != 12:
        raise AssertionError(f"bf16 eval: {len(a)} and {len(b)} FPS index and selection "
                             "tensors recorded, want 12 a forward each")
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("bf16 eval: FPS indices or selection masks differ from the "
                             "float32 forward's")
    del seen, a, b
    check_layer_dtypes("bf16 eval", dtypes,
                       cpu_layer_dtypes(torch, np, state, False, bf16_eval=True))
    same = sum(torch.equal(x["class_logits"], y["class_logits"])
               for x, y in zip(outs["default"], outs["bf16_eval"]))
    if same:
        raise AssertionError(f"bf16 eval: {same} requests' logits are the float32 bits")
    cos_lo, agree_lo, par_hi = 1.0, 1.0, 0.0
    for x, y in zip(outs["default"], outs["bf16_eval"]):
        p, q = x["class_logits"].double(), y["class_logits"].double()
        cos_lo = min(cos_lo, ((p * q).sum() / (p.norm() * q.norm())).item())
        agree_lo = min(agree_lo, (p.argmax(-1) == q.argmax(-1)).double().mean().item())
        par_hi = max(par_hi, max((x[f"{s}_{k}"] - y[f"{s}_{k}"]).abs().max().item()
                                 for s in ("left", "right")
                                 for k in ("global_orient", "hand_pose", "betas",
                                           "transl")))
    log(f"bf16 eval vs float32 ({REQUESTS} requests of {B}): {len(record)} FPS index "
        f"and selection tensors equal; no request's logits the float32 bits; logits cosine {cos_lo:.7f} (limit "
        f"{BF16_EVAL_BOUND['cos_min']}), argmax agreement {agree_lo:.5f} (limit "
        f"{BF16_EVAL_BOUND['agree_min']}), MANO parameters max abs diff {par_hi:.3g} "
        f"(limit {BF16_EVAL_BOUND['params_abs']})")
    if not (cos_lo > BF16_EVAL_BOUND["cos_min"] and agree_lo > BF16_EVAL_BOUND["agree_min"]
            and par_hi < BF16_EVAL_BOUND["params_abs"]):
        raise AssertionError("bf16 eval: outputs beyond the JAX package's bf16 bound")
    del outs

    # windows/s and peak memory of the three pipelines, in turns
    with torch.inference_mode():
        timing = interleaved_ms(torch, {name: flip_request(torch, dev, pipe, reqs[0], 70)
                                        for name, pipe in pipes.items()})
    for name, (ms, peak) in timing.items():
        numbers[name] = dict(windows_per_s=[B / (m / 1e3) for m in ms], peak_gib=peak)
    log("serving A/B (B=16, N=2048, in turns): " + "; ".join(
        f"{name} " + "/".join(f"{w:.2f}" for w in n["windows_per_s"])
        + f" windows/s, peak {n['peak_gib']:.2f} GiB" for name, n in numbers.items()))
    del pipes
    return launches, numbers


def switch_training_phases(torch, np, dev, state):
    """Phases 28-29: the training step with bf16_train (B=8, augment, the
    one-hot gather) counted, its parameters and Adam state float32, two
    steps from one state bitwise equal, the first step within
    STEP_BOUNDS["bf16_train"] of the float32 step and not its bits, the loss
    falling over TRAJECTORY_STEPS steps on one batch, each conv and
    BatchNorm in the CPU port's dtype, windows/s beside float32;
    then the uv_split_gather step (the one-hot gather off) within
    STEP_BOUNDS["uv_split"] of the index route's step, with no one-hot
    gather. -> (launches by path, numbers)."""
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.model import layers as klayers
    from ev2hands_tpu_torch.model.tehnet import TEHNet, batchnorm_cancelled_biases

    skip = batchnorm_cancelled_biases(TEHNet(route_config().model, device="cpu"))
    launches, numbers = {}, {}
    batches, draws = dp_inputs(torch, np)

    # 28. bf16 training through the entry point, counted
    steps = {}
    for name, bf16 in (("float32", False), ("bf16_train", True)):
        cfg = DEFAULT_CONFIG.replace(model=ModelConfig(
            n_points=N, pallas_gather=True, pallas_gather_bwd=True, bf16_train=bf16))
        hands = ktrain.build_hands(cfg, synthetic=True, device=dev)
        net = TEHNet(cfg.model, device=dev)
        net.load_state_dict(state, strict=True)
        opt = ktrain.make_optimizer(net.parameters(), cfg.train)
        steps[name] = (net, opt, ktrain.make_train_step(
            net, hands, ktrain.build_collision_context(hands), cfg, opt, augment=True,
            device=dev))
    net, opt, step = steps["bf16_train"]
    gen = torch.Generator(device=dev).manual_seed(9)
    dtypes, remove = layer_dtypes(net)
    reset_launches()
    for i in range(2):
        losses = step(batches[i], gen)
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"bf16 training step {i}: a loss term is not finite")
    torch.cuda.synchronize()
    launches["bf16_train"] = read_launches()
    remove()
    check_launches("bf16 training", launches["bf16_train"], TRAIN_PER_STEP, 2)
    not32 = [k for k, p in net.named_parameters() if p.dtype != torch.float32]
    not32 += [k for k, b in net.named_buffers() if b.dtype != torch.float32]
    not32 += [f"Adam {k}" for st in opt.state.values() for k, v in st.items()
              if torch.is_tensor(v) and v.is_floating_point() and v.dtype != torch.float32]
    n_adam = sum(len(st) for st in opt.state.values())
    log(f"bf16 training: 2 steps of {TRAIN_B} windows, launches {launches['bf16_train']}; "
        f"{len(list(net.parameters()))} parameters, {len(list(net.buffers()))} BatchNorm "
        f"statistics and {n_adam} Adam tensors, not float32: {not32 or 'none'}; losses "
        + json.dumps(losses))
    if not32:
        raise AssertionError(f"bf16 training: not float32: {not32[:8]}")
    check_layer_dtypes("bf16 training", dtypes, cpu_layer_dtypes(
        torch, np, state, True, pallas_gather=True, pallas_gather_bwd=True, bf16_train=True))

    # two steps from one state bitwise; the first against float32
    cfg16 = route_config(bf16_train=True)
    first, again = (multi_steps(torch, dev, state, cfg16, batches[:1], draws[:1])[0][0]
                    for _ in range(2))
    differ = bitwise_differ(torch, first, again)
    log(f"bf16 training, two steps from the same weights and draws: {len(differ)} loss "
        f"terms, gradients, BatchNorm statistics or parameters after Adam differ")
    if differ:
        raise AssertionError(f"bf16 training: two steps differ in {differ[:8]}")
    f32 = multi_steps(torch, dev, state, route_config(), batches[:1], draws[:1])[0][0]
    differ = bitwise_differ(torch, first, f32)
    log(f"bf16 training step vs float32: {len(differ)} loss terms, gradients, BatchNorm "
        f"statistics or parameters after Adam differ in their bits")
    if not any(d.startswith("loss") for d in differ):
        raise AssertionError("bf16 training: the step's losses are the float32 bits")
    numbers["bf16_train_vs_float32"] = compare_steps(
        torch, "bf16 training step vs float32 (B=8)", first[:3], f32[:3], skip=skip,
        **STEP_BOUNDS["bf16_train"])

    # the loss over several steps on one batch, against float32's
    trajs = {name: loss_trajectory(torch, dev, state, route_config(bf16_train=bf16),
                                   batches[0], draws[0])
             for name, bf16 in (("bf16_train", True), ("float32", False))}
    dev_hi, fell = trajectory_reading(trajs["bf16_train"], trajs["float32"])
    log(f"bf16 training, {TRAJECTORY_STEPS} steps on one batch: losses "
        + "/".join(f"{v:.5g}" for v in trajs["bf16_train"]) + " against float32's "
        + "/".join(f"{v:.5g}" for v in trajs["float32"])
        + f"; max rel diff {dev_hi:.3g} (unchecked); last four over first four "
        f"{fell:.4f} (limit < 1), float32's {fall(trajs['float32']):.4f}")
    numbers["bf16_train_trajectory"] = dict(dev=dev_hi, fall=fell, **trajs)
    if not fell < 1:
        raise AssertionError("bf16 training: the loss did not fall over "
                             f"{TRAJECTORY_STEPS} steps on one batch")

    # windows/s of both steps, in turns, a new polarity flip per step
    def one_step(name):
        _, _, stp = steps[name]
        batch = {k: ({kk: torch.from_numpy(vv).to(dev) for kk, vv in v.items()}
                     if isinstance(v, dict) else torch.from_numpy(v).to(dev))
                 for k, v in batches[1].items()}
        raw_d, flip_gen = batch["events"], torch.Generator(device=dev).manual_seed(4)
        g = torch.Generator(device=dev).manual_seed(5)

        def run():
            flip = torch.rand((TRAIN_B, 1), generator=flip_gen, device=dev) < 0.5
            p = raw_d[..., 3]
            ev = torch.cat([raw_d[..., :3], torch.where(flip, 1.0 - p, p)[..., None]], -1)
            return stp(dict(batch, events=ev), g)
        return run

    timing = interleaved_ms(torch, {name: one_step(name) for name in steps}, iters=5)
    for name, (ms, peak) in timing.items():
        numbers[f"train_{name}"] = dict(windows_per_s=[TRAIN_B / (m / 1e3) for m in ms],
                                        peak_gib=peak)
    log("training A/B (B=8, augment, one-hot gather, in turns): " + "; ".join(
        f"{name} " + "/".join(f"{w:.2f}" for w in numbers[f"train_{name}"]["windows_per_s"])
        + f" windows/s, peak {numbers[f'train_{name}']['peak_gib']:.2f} GiB"
        for name in steps))
    del steps, net, opt, step

    # 29. uv_split_gather on the index route: the layers' _uv_scales ran and
    # the one-hot gather did not
    uv_calls = []
    real_uv = klayers.SetAbstractionMsg._uv_scales

    def counting(self, *a, **k):
        uv_calls.append(1)
        return real_uv(self, *a, **k)

    plain_cfg = dict(pallas_gather=False, pallas_gather_bwd=False)
    klayers.SetAbstractionMsg._uv_scales = counting
    try:
        reset_launches()
        uv, uv_s = multi_steps(torch, dev, state,
                               route_config(uv_split_gather=True, **plain_cfg),
                               batches[:1], draws[:1])
        launches["uv_split"] = read_launches()
    finally:
        klayers.SetAbstractionMsg._uv_scales = real_uv
    check_launches("uv_split_gather step", launches["uv_split"], {"fps": 3}, 1)
    if len(uv_calls) != len(GATHER_LAYERS):
        raise AssertionError(f"uv_split_gather step: {len(uv_calls)} layers took the "
                             f"u/v route, want {len(GATHER_LAYERS)}")
    index, index_s = multi_steps(torch, dev, state, route_config(**plain_cfg),
                                 batches[:1], draws[:1])
    log(f"uv_split_gather: one step, {len(uv_calls)} layers on the u/v route, launches "
        f"{launches['uv_split']}; {TRAIN_B / uv_s:.2f} windows/s against the index "
        f"route's {TRAIN_B / index_s:.2f} (one step each, with their first calls)")
    numbers["uv_split_vs_index"] = compare_steps(
        torch, "uv_split_gather step vs the index route (B=8)", uv[0][:3], index[0][:3],
        skip=skip, **STEP_BOUNDS["uv_split"])
    return launches, numbers


def event_export_work(device, sizes, state, request, path):
    """Phase 30 on one rank of two over gloo, both on ``device``: rank 0
    exports the event-mesh serving program of a (data 1, event 2) mesh and
    saves it; both load it and serve ``request``, counted, with the sharded
    FPS indices recorded, then timed. -> what the parent checks, on the
    CPU."""
    import torch
    import torch.distributed as dist

    from ev2hands_tpu_torch import export as kex
    from ev2hands_tpu_torch import train as ktrain
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.model.tehnet import TEHNet
    from ev2hands_tpu_torch.ops import _build
    from ev2hands_tpu_torch.parallel import event_parallel as kep
    from ev2hands_tpu_torch.parallel import mesh as pm

    globals().update(sizes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = pm.local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        for name in _build.KERNELS:   # built by the parent; loaded here
            _build.load(name)
    mesh = pm.create_event_mesh(DP_RANKS, 1, dev)
    out = {"device": str(dev)}
    if mesh.is_main:
        cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N, event_parallel=True))
        net = TEHNet(cfg.model, device=dev, event_mesh=mesh)
        net.load_state_dict(state, strict=True)
        hands = ktrain.build_hands(cfg, synthetic=True, device=dev)
        t0 = time.perf_counter()
        program = kex.export_serving(net, hands, cfg, B, request[0].shape[1],
                                     event_mesh=mesh)
        out["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.export.save(program, path)
        out["save_s"] = time.perf_counter() - t0
        out.update(ops=kex.op_counts(program), nodes=len(program.graph.nodes),
                   bytes=os.path.getsize(path))
        del program, net
    dist.barrier()
    t0 = time.perf_counter()
    serve = kex.load_serving(path, event_mesh=mesh)
    out["load_s"] = time.perf_counter() - t0
    req = tuple(t.to(dev) for t in request)
    record, undo = capturing((kep,), ("event_sharded_fps",))
    reset_launches()
    try:
        got, secs = timed(torch, dev, lambda: serve(*req))
    finally:
        undo()
    out.update(launches=read_launches(), fps=record, first_s=secs,
               outputs={k: v.cpu() for k, v in got.items()})
    ms = []
    for _ in range(3):
        ms.append(1e3 * timed(torch, dev, lambda: serve(*req))[1])
    out["ms"] = ms
    out["collectives"] = profile_collectives(torch, dev, lambda: timed(
        torch, dev, lambda: serve(*req)))
    return out


def event_export_phase(torch, np, dev, state, tmp, first):
    """Phase 30: the serving export with an event mesh, exported by rank 0
    of a (data 1, event 2) mesh of two gloo ranks on the card and loaded by
    both, on phase 16's first request: every output within 1e-5 of phase
    16's one-device program, the sharded FPS indices equal to K1's on the
    same ERPC clouds, no kernel launch; export, save and load seconds and
    the event ops in the graph. -> (launches, numbers)."""
    from ev2hands_tpu_torch.config import ModelConfig
    from ev2hands_tpu_torch.model import layers as klayers
    from ev2hands_tpu_torch.model import tehnet as ktehnet
    from ev2hands_tpu_torch.parallel import mesh as pm

    request, ref = first
    # K1's indices on the program's own ERPC clouds, through the live net
    net = ktehnet.TEHNet(ModelConfig(n_points=N), device=dev)
    net.load_state_dict(state, strict=True)
    net.eval()
    record, undo = capturing((klayers, ktehnet), ("fps_unchecked",))
    try:
        with torch.inference_mode():
            net(ref["events"].to(dev))
    finally:
        undo()
    del net
    if len(record) != 3:   # sa1, sa2, the heads' shared draw
        raise AssertionError(f"event-mesh export: {len(record)} FPS calls recorded on "
                             "one device, want 3")
    sizes = dict(N=N, B=B)
    path = os.path.join(tmp, "serving_event.pt2")
    results, ranks_s = timed(torch, dev, lambda: pm.run_ranks(
        event_export_work, DP_RANKS, torch.device(dev).type, sizes, state, request,
        path, backend="gloo", timeout=600))
    r0 = results[0]
    log(f"event-mesh export: two ranks over gloo on {[r['device'] for r in results]}, "
        f"{ranks_s:.1f} s with their start-up; rank 0 exported in {r0['export_s']:.2f} s "
        f"({r0['nodes']} graph nodes, ops {r0['ops']}), saved in {r0['save_s']:.2f} s "
        f"({r0['bytes']} bytes); loaded in "
        + "/".join(f"{r['load_s']:.2f}" for r in results) + " s")
    want_ops = {"event_fps": 3, "event_all_gather": 18, "event_shard": 18, "event_rank": 18}
    if r0["ops"] != want_ops:
        raise AssertionError(f"event-mesh export: graph ops {r0['ops']}, want {want_ops}")
    for i, r in enumerate(results):
        check_launches(f"event-mesh export, rank {i}", r["launches"], {}, 1)
        if len(r["fps"]) != 3 or not all(
                torch.equal(a, b) for a, b in zip(r["fps"], record)):
            raise AssertionError(f"event-mesh export, rank {i}: FPS indices differ from "
                                 "K1's")
        diffs = {k: (r["outputs"][k].double() - v.double()).abs().max().item()
                 for k, v in ref.items()}
        rel = {k: ((r["outputs"][k].double() - v.double()).abs()
                   - EVENT_EXPORT_TOL * v.double().abs()).max().item() for k, v in ref.items()}
        log(f"event-mesh export, rank {i}: {len(record)} FPS calls with K1's indices; "
            f"outputs against phase 16's one-device program, max abs diff "
            + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
            + f" (limit {EVENT_EXPORT_TOL} + {EVENT_EXPORT_TOL} relative); first request "
            f"{r['first_s']:.2f} s, then " + "/".join(f"{m:.1f}" for m in r["ms"])
            + f" ms a request of {B}; " + collectives_text(r["collectives"]))
        bad = {k: v for k, v in rel.items() if not v <= EVENT_EXPORT_TOL}
        if bad:
            raise AssertionError(f"event-mesh export, rank {i}: beyond 1e-5: {bad}")
    launches = {k: sum(r["launches"][k] for r in results) for k in r0["launches"]}
    return launches, dict(export_s=r0["export_s"], save_s=r0["save_s"],
                          load_s=[r["load_s"] for r in results], nodes=r0["nodes"],
                          ops=r0["ops"], windows_per_s=[B / (m / 1e3) for m in r0["ms"]],
                          collectives=r0["collectives"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # f32 on the card, for the pipeline and for every plain version that
    # a kernel is held against
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.events.erpc import (
        erpc_batch_transform,
        rasterize_erpc,
        resample_draws,
    )
    from ev2hands_tpu_torch.mano.model_data import synthetic_mano_models
    from ev2hands_tpu_torch.ops import _build
    from ev2hands_tpu_torch.ops import fps as kfps
    from ev2hands_tpu_torch.ops import grouping as kgrp
    from ev2hands_tpu_torch.ops.pointnet import index_points, square_distance
    from ev2hands_tpu_torch.serve import InferencePipeline
    from ev2hands_tpu_torch.weights import init_weights

    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    build_s = time.perf_counter() - t0
    log(f"build: {', '.join(f'csrc/{k}.cu' for k in _build.KERNELS)} -> sm_90a "
        f"in {build_s:.1f} s")
    t0 = time.perf_counter()
    _build.load_host("ev2hands_loader")
    log(f"build: csrc/ev2hands_loader.cpp (the host batch loader) -> g++ in "
        f"{time.perf_counter() - t0:.1f} s")
    spilled = [name for source, name, n in ptxas_report(_build.build_logs, _build.nvcc_path())
               if source == "msg_ball" and n]
    if spilled:
        raise AssertionError(f"csrc/msg_ball.cu: spills in {spilled}")
    n_mma, mma_loops = sass_mma_count(_build._target("msg_ball"), _build.nvcc_path())
    log(f"sass csrc/msg_ball.cu: {n_mma} tensor-core MMA instructions")
    for (name, sizes), shown in zip(mma_loops.items(),
                                    demangle(list(mma_loops), _build.nvcc_path())):
        log(f"  sass {shown}: MMA loops of {sizes} instructions")
    if n_mma == 0:
        raise AssertionError("csrc/msg_ball.cu: no tensor-core MMA instruction in its SASS")

    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N))
    state = init_weights(torch.Generator().manual_seed(0), cfg.model)
    mano = synthetic_mano_models(0)
    pipe = InferencePipeline(cfg, state, mano, device="cuda")

    with torch.inference_mode():
        raw0, lab0 = raw_request(np, 0)
        # request 0's resample draws, made once on the CPU and given to the
        # card and to the CPU run alike
        _, _, n_valid0 = rasterize_erpc(
            torch.from_numpy(raw0), torch.from_numpy(lab0),
            cfg.sensor.width, cfg.sensor.height)
        draws0 = resample_draws(n_valid0, N, torch.Generator().manual_seed(100))
        events = erpc_batch_transform(
            torch.from_numpy(raw0).to(dev), torch.from_numpy(lab0).to(dev),
            draws=draws0, width=cfg.sensor.width, height=cfg.sensor.height,
            n_out=N).events
        torch.cuda.synchronize()

        # 3. FPS kernel vs plain at the serving, training and evaluation
        # shapes; the sweep of instantiations and the chain floor
        l0 = events[..., :3].contiguous()
        l1 = index_points(l0, kfps.fps(l0, 512)).contiguous()
        fps_all, fps_sweep = fps_phase(torch, np, kfps, index_points, l0, l1, dev)
        fps_rows = [r for r in fps_all if r["path"] == "serving"]

        # 4. grouping kernel vs plain on the sa1 scales, real preparation
        sa1 = pipe.net.sa1
        new_xyz = index_points(l0, kfps.fps(l0, sa1.npoint))
        sq = square_distance(new_xyz, l0)
        perm = kgrp.morton_perm(l0)
        xyz_p, pts_p = index_points(l0, perm), index_points(events, perm)
        grp_rows, k2_outs = [], []
        for i, (r, k) in enumerate(zip(sa1.radius_list, sa1.nsample_list)):
            folded, sel_p, act = sa1.sparse_scale_inputs(
                i, new_xyz, sq, r, k, perm, xyz_p, pts_p)
            nb = sa1.pallas_nb
            got = kgrp.msg_scale_sparse(folded, sel_p, act, nb)
            ref = kgrp.msg_scale_sparse_plain(folded, sel_p, act, nb)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"grouping scale {i}: max abs diff {err}")
            k2_outs.append(got)
            C1, C2 = folded.W2.shape
            C3 = folded.W3.shape[1]
            n_sel = int(sel_p.sum().item())
            activity = act.float().mean().item()
            ms = cuda_ms(torch, lambda: kgrp.msg_scale_sparse(folded, sel_p, act, nb), 20)
            plain_ms = cuda_ms(
                torch, lambda: kgrp.msg_scale_sparse_plain(folded, sel_p, act, nb), 3, 1)
            ops = n_sel * 2 * (C1 * C2 + C2 * C3)
            # the work depends on the data: of the [B, S, N] mask only the
            # nb-wide rows of active tiles are read; every other input and
            # the output once
            active_tiles = int(act.sum().item())
            nbytes = 4 * (nb * active_tiles
                          + sum(t.numel() for t in (*folded, act, got)))
            row = dict(scale=i, widths=[C1, C2, C3], radius=r, nsample=k,
                       tile_activity=activity, selected_pairs=n_sel,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, ops=ops,
                       bytes=nbytes,
                       bound_ms=1e3 * max(ops / F32_FLOP_PER_S,
                                          nbytes / HBM_BYTES_PER_S),
                       bound_by="operations" if ops / F32_FLOP_PER_S
                       > nbytes / HBM_BYTES_PER_S else "bytes")
            grp_rows.append(row)
            log(f"msg_sparse scale {i} {C1, C2, C3} r={r} K={k}: tile activity "
                f"{activity:.4f}, {n_sel} selected pairs, max abs diff {err:.3g}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']})")

        # 4b. the fused kernel on the same inputs, the layer's fused preparation
        fused_rows = [fused_check(torch, kgrp, sa1, new_xyz, sq, perm, xyz_p, pts_p,
                                  torch.cat(k2_outs, dim=-1))]

        # 4c. the dense grouping ops on the same inputs in original order,
        # counted; then at the regressor heads' sa1 scales (timed only)
        dense_rows, ops_launches = dense_ops_phase(torch, kgrp, sa1, l0, events,
                                                   new_xyz, sq, k2_outs)
        del k2_outs
        heads_sa1 = pipe.net.left_mano_regressor.sa1
        feats = torch.randn((B, N, cfg.model.num_classes), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(5))
        heads_rows = heads_dense_timing(torch, kgrp, heads_sa1, l0, feats,
                                        index_points(l0, kfps.fps(l0, heads_sa1.npoint)))
        del feats

        # 5. serving: 4 requests through the entry point, counted
        gen = torch.Generator(device=dev).manual_seed(1)
        requests = [(raw0, lab0, None)] + [raw_request(np, s) + (gen,)
                                           for s in range(1, REQUESTS)]
        reset_launches()
        outs = []
        t0 = time.perf_counter()
        for j, (raw, lab, g) in enumerate(requests):
            outs.append(pipe(torch.from_numpy(raw), torch.from_numpy(lab), g,
                             draws=draws0 if j == 0 else None))
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = read_launches()
        log(f"serving: {REQUESTS} requests of {B} windows in {serve_s:.3f} s; "
            f"launches {launches}")
        check_launches("serving", launches, {"fps": 3, "msg_sparse": 3}, REQUESTS)
        for out in outs:
            for key, val in out.items():
                if not torch.isfinite(val).all():
                    raise AssertionError(f"serving output {key} is not finite")
            if tuple(out["class_logits"].shape) != (B, N, cfg.model.num_classes) \
                    or tuple(out["left_vertices"].shape) != (B, 778, 3):
                raise AssertionError("serving output shapes are wrong")

        # the card against the port on the CPU, 2 windows of request 0
        t0 = time.perf_counter()
        cpu = InferencePipeline(cfg, state, mano, device="cpu")
        ref = cpu(torch.from_numpy(raw0[:2]), torch.from_numpy(lab0[:2]),
                  draws=draws0[:2])
        cpu_s = time.perf_counter() - t0
        diffs = {}
        for key, val in ref.items():
            diffs[key] = (outs[0][key][:2].cpu() - val).abs().max().item()
        limits = {k: card_vs_cpu_limit(k) for k in diffs}
        log(f"card vs CPU (2 windows, CPU run {cpu_s:.1f} s): " + ", ".join(
            f"{k} {v:.3g}" for k, v in diffs.items()))
        for k, v in diffs.items():
            if not v <= limits[k]:
                raise AssertionError(f"card vs CPU: {k} differs by {v} > {limits[k]}")

        # 6. throughput at B=16: a new polarity flip per iteration
        raw_d = torch.from_numpy(raw0).to(dev)
        lab_d = torch.from_numpy(lab0).to(dev)
        flip_gen = torch.Generator(device=dev).manual_seed(2)

        def one_request():
            flip = torch.rand((B, 1), generator=flip_gen, device=dev) < 0.5
            p = raw_d[..., 3]
            ev = torch.cat([raw_d[..., :3],
                            torch.where(flip, 1.0 - p, p)[..., None]], -1)
            return pipe(ev, lab_d, gen)

        iters = 10
        req_ms = cuda_ms(torch, one_request, iters, warmup=2)
        wps = B / (req_ms / 1e3)
        log(f"pipeline: {req_ms:.3f} ms per request of {B} windows, "
            f"{wps:.2f} windows/s")

        # 7. where the time goes, on the serving requests
        where_the_time_goes(torch, pipe, [
            (torch.from_numpy(raw).to(dev), torch.from_numpy(lab).to(dev), gen)
            for raw, lab, _ in requests])

    # 8-11. training
    gather_rows, scatter_rows, train_launches = training_phases(torch, np, dev, state)

    # 12-13. evaluation
    eval_launches = evaluation_phases(torch, np, dev, state)

    # 14-15. the training loop and finetuning
    loop_launches = training_loop_phase(torch, np, dev, state)
    ft_launches = finetune_phase(torch, np, dev, state)

    # 16-19. serving export, the demo, the 4-channel input, the MANO loader
    from ev2hands_tpu_torch.utils.device import get_device_memory_usage

    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_demo_")
    try:
        export_launches, export_numbers, export_first = export_phase(torch, np, dev,
                                                                     state, tmp)
        demo_launches, demo_numbers = demo_phase(torch, np, dev, state, tmp)
        four_launches, four_wps = four_channel_phase(torch, np, dev)
        mano_loader_phase(torch, np, dev, state, tmp, raw0, lab0, draws0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("export, demo, 4-channel: " + json.dumps({"export": export_numbers, "demo": demo_numbers,
                                  "four_channel_windows_per_s": four_wps}))
    log("device memory: " + json.dumps(get_device_memory_usage()))

    # 20. Ev2Hands-S generation, its windows trained on and served
    datagen_launches, _ = datagen_phase(torch, np, dev, state, pipe)

    # 21-24. multi-device: data parallel (world size 1 over NCCL, two gloo
    # ranks on the card), dense_train, event parallel
    mdev, mdev_numbers = multi_device_phases(torch, np, dev, state, raw0, lab0, draws0)

    def add(*parts):
        return {k: sum(p[k] for p in parts) for k in parts[0]}

    # 25. the split export
    tmp = tempfile.mkdtemp(prefix="chip_smoke_split_")
    try:
        split_launches, split_numbers = split_export_phase(torch, np, dev, state, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("multi-device numbers: " + json.dumps({**mdev_numbers,
                                               "split_export_windows_per_s": split_numbers}))

    # 26-29. the default-off switches: fused regressor heads and bf16 eval
    # (serving), bf16 training and the u/v-split gather (training)
    t0 = time.perf_counter()
    serve_switch_launches, serve_switch_numbers = switch_serving_phases(torch, np, dev,
                                                                        state)
    train_switch_launches, train_switch_numbers = switch_training_phases(torch, np, dev,
                                                                         state)

    # 30. the serving export with an event mesh on two gloo ranks
    tmp = tempfile.mkdtemp(prefix="chip_smoke_event_export_")
    try:
        event_export_launches, event_export_numbers = event_export_phase(
            torch, np, dev, state, tmp, export_first)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("switch and event-export numbers: " + json.dumps(
        {**serve_switch_numbers, **train_switch_numbers,
         "event_export": event_export_numbers}))
    log(f"phases 26-30 took {time.perf_counter() - t0:.1f} s")

    # 31. the kernels line. ms, plain_ms, bound_ms and library_ms add the
    # calls of one pass: the three serving FPS shapes and sa1 scales of a
    # forward, the fused sa1 call of an evaluation forward, the four gathers
    # and three scatter-adds of a training step, a dense op's three sa1
    # scales; then one entry per training shape of the gather and the
    # scatter-add. launches: every driven path (serving's 4 requests, training's
    # 4 steps, the evaluations' 8 + 3 batches, phase 4c's ops, the training
    # loop's 6 steps and 4 evaluation batches, finetuning's 4 steps and 4
    # evaluation batches, the loaded exports' 4 + 4 requests, the demo's 7 +
    # 7 batches, the 4-channel forward's 4 requests, the generated data's 2
    # training steps and 1 serving request, the data-parallel steps,
    # evaluations and finetuning step on every rank of world sizes 1 and 2,
    # the dense_train step, the event-parallel forwards and steps (which
    # launch no kernel: the event mesh takes FPS and the grouping to its
    # sharded functions, as in the JAX package), the split export's 2
    # shards, the fused-heads and bf16-eval serving requests, the bf16
    # training steps, the uv-split step, the loaded event-mesh program on
    # both ranks (which launches no kernel); the one-process references that
    # these are held against are not counted), also listed by path.
    by_path = {"serving": launches, "training": train_launches,
               "evaluation": eval_launches, "ops": ops_launches,
               "training_loop": loop_launches, "finetune": ft_launches,
               "export": export_launches, "demo": demo_launches,
               "four_channel": four_launches, "datagen": datagen_launches,
               "data_parallel": add(mdev["data_parallel_ws1"], mdev["data_parallel_ws2"]),
               "dense_train": mdev["dense_train"],
               "event_parallel": add(mdev["event_parallel_ws1"],
                                     mdev["event_parallel_ws2"]),
               "split_export": split_launches,
               "fused_serving": serve_switch_launches["fused"],
               "bf16_eval": serve_switch_launches["bf16_eval"],
               "bf16_train": train_switch_launches["bf16_train"],
               "uv_split": train_switch_launches["uv_split"],
               "event_export": event_export_launches}

    def entry(name, source, replaces, rows, err, library=False):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(path[name] for path in by_path.values()),
            "launches_by_path": {k: path[name] for k, path in by_path.items()},
            "max_abs_err": err,
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": sum(r["library_ms"] for r in rows) if library else None,
        }

    kernels = [
        entry("fps", "ev2hands_tpu_torch/csrc/fps.cu",
              "ev2hands_tpu/ops/pallas_ops.py:56", fps_rows,
              max(r["max_abs_err"] for r in fps_all)),
        entry("msg_sparse", "ev2hands_tpu_torch/csrc/msg_dense.cu",
              "ev2hands_tpu/ops/pallas_grouping.py:595", grp_rows,
              max(r["max_abs_err"] for r in grp_rows)),
        entry("msg_fused_sparse", "ev2hands_tpu_torch/csrc/msg_dense.cu",
              "ev2hands_tpu/ops/pallas_grouping.py:823", fused_rows,
              fused_rows[0]["max_abs_err"]),
        entry("onehot_gather", "ev2hands_tpu_torch/csrc/gather.cu",
              "ev2hands_tpu/ops/pallas_gather.py:142", gather_rows,
              max(r["max_abs_err"] for r in gather_rows), library=True),
        entry("onehot_scatter_add", "ev2hands_tpu_torch/csrc/gather.cu",
              "ev2hands_tpu/ops/pallas_gather.py:230",
              [r for r in scatter_rows if r["on_path"]],
              max(r["max_abs_err"] for r in scatter_rows), library=True),
    ] + [entry(name, "ev2hands_tpu_torch/csrc/msg_ball.cu", replaces, dense_rows[name],
               max(r["max_abs_err"] for r in dense_rows[name]))
         for name, replaces, _ in DENSE_OPS]
    # csrc/msg_ball.cu, both modes: the bound is the tensor-core one
    # (tc_bound_ms, the same number); beside it the f32 bound over the same
    # pass, the sweep of centroids a CTA by scale, the mode (mask or ball)
    # and the heads' two scales in that mode
    for kern in kernels:
        for name, _, takes_mask in DENSE_OPS:
            if kern["name"] != name:
                continue
            rows = dense_rows[name]
            heads = heads_rows["dense_msg_scale_2d" if takes_mask else "fused_msg_scale"]
            kern.update(mode="mask" if takes_mask else "ball",
                        tc_bound_ms=kern["bound_ms"],
                        f32_bound_ms=sum(r["f32_bound_ms"] for r in rows),
                        tile_ms=[r["tile_ms"] for r in rows],
                        heads=[{key: r[key] for key in (
                            "widths", "S", "selected_pairs", "max_abs_err", "ms",
                            "bound_ms", "bound_by", "f32_bound_ms", "tile_ms")}
                            for r in heads])
    # K1's chain floor over the same pass, every shape of phase 3 and the
    # sweep
    kernels[0].update(
        chain_floor_ms=sum(r["chain_floor_ms"] for r in fps_rows),
        device_ms=sum(r["device_ms"] for r in fps_rows),
        chain_floor_device_ms=sum(r["floor_device_ms"] for r in fps_rows),
        by_shape=[{k: r[k] for k in ("path", "shape", "B", "config", "ms",
                                     "device_ms", "chain_floor_ms", "floor_device_ms",
                                     "us_per_step", "floor_us_per_step", "plain_ms",
                                     "bound_ms")} for r in fps_all],
        sweep=fps_sweep)
    # the gather and the scatter-add by training shape, each with the
    # launches the counted training run made at that shape
    for name, replaces, rows, library in (
            ("onehot_gather", "ev2hands_tpu/ops/pallas_gather.py:142", gather_rows,
             "torch.gather"),
            ("onehot_scatter_add", "ev2hands_tpu/ops/pallas_gather.py:230",
             scatter_rows, "index_add")):
        for r in rows:
            if not r["on_path"]:
                continue
            kernels.append({
                "name": f"{name}[{r['layer']}]", "route": "cuda",
                "source": "ev2hands_tpu_torch/csrc/gather.cu", "replaces": replaces,
                "launches": r["launches"],
                "launches_by_path": {"training": r["launches"]},
                "shape": r["shape"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "library": library})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
