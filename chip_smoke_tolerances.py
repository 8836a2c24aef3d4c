"""The readings behind chip_smoke.py's STEP_BOUNDS, on the card.

chip_smoke.py holds float32 training steps whose sums run in another order
against one process with compare_steps. This script makes the same
comparisons from several seeds (weights and batches; seed 0 is
chip_smoke.py's own inputs) and prints each reading, the largest of each
comparison, and the bounds that bounds_from_readings derives from them
(chip_smoke.STEP_BOUNDS holds them):

* data_parallel: two gloo ranks on the card against one process, the first
  step;
* data_parallel_resync: the same, the second step from the one-process
  state after the first;
* dense_train: the dense_train step against the gather route;
* event_parallel: the event-sharded dense_train step at world size 1 over
  NCCL and at (data 1, event 2) over gloo against the one-process
  dense_train step;
* dense_train_resync: one process's dense_train step from the state of
  data_parallel_resync against its gather-route step: two one-process
  routes whose sums run in another order, the floor of that state. Where
  it breaks dense_train's own bounds the state is ill-conditioned for
  float32 (a gradient that rounding alone turns around), and its
  data_parallel_resync reading is listed but left out of that bound;
* bf16_train: the first step with ModelConfig.bf16_train against the float32
  step (the kernel route);
* uv_split: the first step with uv_split_gather on the index_points gather
  route (pallas_gather off) against that route's step;
* bf16_trajectory: chip_smoke.TRAJECTORY_STEPS bf16_train steps on one
  batch with the same draws against the float32 steps: the largest
  relative difference of a step's total loss, and the mean of the last four
  losses over the first four's in each precision (chip_smoke.py bounds only
  bf16's, below 1; the readings stand beside TRAJECTORY_STEPS).

    python chip_smoke_tolerances.py [--seeds 8] [--only bf16_train,bf16_trajectory]

``--only`` makes the named comparisons alone (the two-rank ones need none
of the others).

One card holds both ranks.
"""

import argparse
import json
import math
import os
import shutil
import sys
import tempfile

import chip_smoke as cs

HEADROOM = 5


def bounds_from_readings(readings, headroom=HEADROOM):
    """compare_steps' bounds from its readings of one comparison (a list of
    the dicts it returns): ``headroom`` times the largest (for the cosine,
    of 1 - cosine), rounded up to two significant digits."""
    def up(x):
        step = 10.0 ** (math.floor(math.log10(x)) - 1)
        return float(f"{math.ceil(x / step - 1e-9) * step:.2g}")

    top = {k: max(r[k] for r in readings) for k in ("loss", "norm", "buf")}
    return dict(loss_rtol=up(headroom * top["loss"]),
                cos_min=1 - up(headroom * max(1 - r["cos"] for r in readings)),
                norm_tol=up(headroom * top["norm"]), buf_rtol=up(headroom * top["buf"]))



def sweep_rank(cases):
    """On one rank of two over gloo, for each case (weights, the one-process
    state after its first step, batches, draws): the data-parallel first
    step, the second from that state, and the event-parallel dense_train
    step at (data 1, event 2) on the card -> rank 0's step records."""
    import torch

    from ev2hands_tpu_torch.ops import _build
    from ev2hands_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = pm.local_device("cuda")
    torch.cuda.set_device(dev)
    for name in _build.KERNELS:   # built by the parent; loaded here
        _build.load(name)
    mesh = pm.create_mesh(cs.DP_RANKS, dev)
    emesh = pm.create_event_mesh(cs.DP_RANKS, 1, dev)
    out = []
    for state, resync, batches, draws in cases:
        first, _ = cs.multi_steps(torch, dev, state, cs.route_config(), batches[:1],
                                  draws[:1], mesh)
        second, _ = cs.multi_steps(torch, dev, resync, cs.route_config(), batches[1:2],
                                   draws[1:2], mesh)
        event, _ = cs.multi_steps(torch, dev, state,
                                  cs.route_config(dense_train=True, event_parallel=True),
                                  batches[:1], draws[:1], event_mesh=emesh)
        out.append([r[0][:3] for r in (first, second, event)])
    return out if mesh.is_main else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--only", default="",
                    help="comma-separated comparisons to make (default: all)")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))

    import numpy as np
    import torch
    import torch.distributed as dist

    from ev2hands_tpu_torch.config import ModelConfig
    from ev2hands_tpu_torch.model.tehnet import TEHNet, batchnorm_cancelled_biases
    from ev2hands_tpu_torch.ops import _build
    from ev2hands_tpu_torch.parallel import mesh as pm
    from ev2hands_tpu_torch.weights import init_weights

    if not torch.cuda.is_available():
        print("chip_smoke_tolerances: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build(_build.KERNELS)
    skip = batchnorm_cancelled_biases(TEHNet(cs.route_config().model, device="cpu"))
    kinds = list(cs.STEP_BOUNDS) + ["dense_train_resync", "bf16_trajectory"]
    if only - set(kinds):
        raise SystemExit(f"--only: unknown comparisons {sorted(only - set(kinds))}")
    wants = {k for k in kinds if not only or k in only}
    readings = {k: [] for k in wants - {"bf16_trajectory"}}
    trajectories = []
    one_process = wants & {"dense_train", "event_parallel", "dense_train_resync"}
    two_ranks = wants & {"data_parallel", "data_parallel_resync", "event_parallel"}

    def reading(kind, name, a, b):
        if kind not in readings:
            return
        r = cs.compare_steps(torch, name, a, b, loss_rtol=float("inf"), cos_min=-1.0,
                             norm_tol=float("inf"), buf_rtol=float("inf"), skip=skip)
        readings[kind].append(dict(r, name=name))

    cases, refs = [], []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tolerances_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'init')}",
                            world_size=1, rank=0)
    try:
        emesh = pm.create_event_mesh(1, 1, dev)
        for seed in range(args.seeds):
            state = init_weights(torch.Generator().manual_seed(seed),
                                 ModelConfig(n_points=cs.N))
            batches, draws = cs.dp_inputs(torch, np, seed)
            plain, _ = cs.multi_steps(torch, dev, state, cs.route_config(), batches, draws)
            if "bf16_train" in wants:
                bf16, _ = cs.multi_steps(torch, dev, state,
                                         cs.route_config(bf16_train=True), batches[:1],
                                         draws[:1])
                reading("bf16_train", f"seed {seed}: bf16_train vs float32", bf16[0][:3],
                        plain[0][:3])
            if "bf16_trajectory" in wants:
                bf16, f32 = (cs.loss_trajectory(torch, dev, state,
                                                cs.route_config(bf16_train=b), batches[0],
                                                draws[0]) for b in (True, False))
                dev_hi, fall = cs.trajectory_reading(bf16, f32)
                trajectories.append(dict(seed=seed, dev=dev_hi, fall=fall,
                                         fall_float32=cs.fall(f32), bf16=bf16, float32=f32))
                cs.log(json.dumps(trajectories[-1]))
            if "uv_split" in wants:
                index, uv = (cs.multi_steps(torch, dev, state, cs.route_config(
                    pallas_gather=False, pallas_gather_bwd=False, uv_split_gather=u),
                    batches[:1], draws[:1])[0] for u in (False, True))
                reading("uv_split", f"seed {seed}: uv_split_gather vs the index route",
                        uv[0][:3], index[0][:3])
            if not one_process and not two_ranks:
                continue
            dense, _ = cs.multi_steps(torch, dev, state, cs.route_config(dense_train=True),
                                      batches[:1], draws[:1])
            reading("dense_train", f"seed {seed}: dense_train vs the gather route",
                    dense[0][:3], plain[0][:3])
            event, _ = cs.multi_steps(torch, dev, state,
                                      cs.route_config(dense_train=True, event_parallel=True),
                                      batches[:1], draws[:1], event_mesh=emesh)
            reading("event_parallel", f"seed {seed}: event parallel, world size 1",
                    event[0][:3], dense[0][:3])
            resync = cs.state_after(plain[0])
            dense1, _ = cs.multi_steps(torch, dev, resync, cs.route_config(dense_train=True),
                                       batches[1:2], draws[1:2])
            reading("dense_train_resync", f"seed {seed}: dense_train vs the gather route, "
                                          "step 1", dense1[0][:3], plain[1][:3])
            cases.append((state, resync, batches, draws))
            refs.append((plain, dense))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    ranks = (pm.run_ranks(sweep_rank, cs.DP_RANKS, cases, backend="gloo", timeout=1200)
             if two_ranks else [[]])
    for seed, ((first, second, event), (plain, dense)) in enumerate(zip(ranks[0], refs)):
        reading("data_parallel", f"seed {seed}: 2 ranks, step 0", first, plain[0][:3])
        reading("data_parallel_resync", f"seed {seed}: 2 ranks, step 1 from the one-process "
                                        "state", second, plain[1][:3])
        if "data_parallel_resync" in readings:
            worst = readings["data_parallel_resync"][-1]["cos_key"]
            readings["data_parallel_resync"][-1]["step0_norm"] = \
                plain[0][1][worst].norm().item()
        reading("event_parallel", f"seed {seed}: event parallel, 2 ranks", event,
                dense[0][:3])
    cs.log(json.dumps({"readings": readings}))
    cs.log(json.dumps(summary(readings)))
    if trajectories:
        cs.log(json.dumps({"bf16_trajectory": {
            k: [min(t[k] for t in trajectories), max(t[k] for t in trajectories)]
            for k in ("dev", "fall", "fall_float32")}}))
    return 0


def within(reading, bounds):
    return (reading["loss"] <= bounds["loss_rtol"] and reading["cos"] >= bounds["cos_min"]
            and reading["norm"] <= bounds["norm_tol"] and reading["buf"] <= bounds["buf_rtol"])


def summary(readings):
    """The largest readings of each comparison and the bounds derived from
    them; data_parallel_resync without the seeds whose one-process floor
    (dense_train_resync) breaks dense_train's bounds."""
    ill = []
    if readings.get("dense_train") and readings.get("dense_train_resync"):
        dense = bounds_from_readings(readings["dense_train"])
        ill = [f["name"] for f in readings["dense_train_resync"] if not within(f, dense)]
    out = {}
    for kind, rs in readings.items():
        kept = rs
        if kind == "data_parallel_resync" and "dense_train_resync" in readings:
            kept = [r for r, f in zip(rs, readings["dense_train_resync"])
                    if f["name"] not in ill]
        out[kind] = dict(
            runs=len(kept), loss=max(r["loss"] for r in kept),
            cos=min(r["cos"] for r in kept), norm=max(r["norm"] for r in kept),
            buf=max(r["buf"] for r in kept), cos_all=min(r["cos_all"] for r in kept),
            bounds=bounds_from_readings(kept) if kind in cs.STEP_BOUNDS else None)
    return {"largest": out, "headroom": HEADROOM, "ill_conditioned": ill}


if __name__ == "__main__":
    sys.exit(main())
