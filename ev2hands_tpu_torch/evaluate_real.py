"""Ev2Hands-R evaluation on real recordings: sliding 2 ms windows (1 ms
advance), three PCK curves (0-100 mm) and their AUCs, root-relative MPJPE
and the non-collision score of the predicted meshes.

Counterpart of ``ev2hands_tpu/evaluate_real.py``: padded windows from a
``RealStream`` -> ``erpc_real_batch_transform`` -> ``TEHNet`` eval -> MANO
-> metrics, and 100 - ``collision_percentage`` of the two meshes in mm. It
runs on the card unless asked for the CPU, in the fused grouping
configuration (``evaluate.EVAL_CONFIG``); host windowing runs in a
background thread (``Prefetcher``) beside the device's work.

    python -m ev2hands_tpu_torch.evaluate_real --data_root recordings/ \\
        --checkpoint_path best.pth [--mano_dir data/models | --synthetic_mano]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ev2hands_tpu_torch.config import Config
from ev2hands_tpu_torch.evaluate import DrawsFn
from ev2hands_tpu_torch.events.erpc import erpc_real_batch_transform
from ev2hands_tpu_torch.events.real_streams import RealStream, sliding_window_batches
from ev2hands_tpu_torch.events.streams import Prefetcher
from ev2hands_tpu_torch.losses import CollisionContext
from ev2hands_tpu_torch.mano.layer import ManoParams
from ev2hands_tpu_torch.metrics import (
    absolute_pck3d,
    get_auc,
    mpjpe,
    relative_pck3d,
    right_root_relative_pck3d,
)
from ev2hands_tpu_torch.model.tehnet import TEHNet, apply_mano
from ev2hands_tpu_torch.ops.collision import collision_percentage


def make_real_eval_step(net: TEHNet, hands: Dict[str, ManoParams],
                        ctx: CollisionContext, cfg: Config, device="cuda"):
    """-> ``step(events, event_valid, generator=None, *, draws=None)`` ->
    (pred joints [B, 2, 21, 3] in mm, non-collision score [B] in %), the
    ERPC resample draws from ``generator`` or given as ``draws``.

    ``net`` (put in eval mode), ``hands`` and ``ctx`` live on ``device``,
    which defaults to the card and raises when there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_real_eval_step: no CUDA device is available")
    sensor = cfg.sensor
    net.eval()

    @torch.inference_mode()
    def step(events, event_valid, generator: Optional[torch.Generator] = None, *,
             draws: Optional[torch.Tensor] = None):
        erpc = erpc_real_batch_transform(
            torch.as_tensor(events, device=device),
            torch.as_tensor(event_valid, device=device), generator, draws=draws,
            width=sensor.width, height=sensor.height, n_out=cfg.model.n_points)
        outputs = apply_mano(hands, net(erpc.events))
        pred_j = torch.stack([outputs["left"]["j3d"], outputs["right"]["j3d"]], 1)
        noncol = 100.0 - collision_percentage(
            outputs["left"]["vertices"] * 1000, outputs["right"]["vertices"] * 1000,
            ctx.faces, ctx.adjacency, max_pairs=256)
        return pred_j * 1000.0, noncol

    return step


def evaluate_recording(
    eval_step, stream: RealStream, cfg: Config, batch_size: int = 32,
    num_steps: int = 100, max_windows: Optional[int] = None, device="cuda",
    draws: Optional[DrawsFn] = None,
) -> Dict:
    """Every sliding window of ``stream`` (up to ``max_windows``) through
    ``eval_step`` -> per-recording report, with the end-to-end windows/s
    (host windowing, device inference and metric accumulation). Resample
    draws come from a generator seeded 0 on ``device``, or from
    ``draws(i, batch)`` for batch ``i`` where that is given."""
    pck = {k: np.zeros(num_steps + 1)
           for k in ("absolute", "relative", "right_root_relative")}
    curves = {"absolute": absolute_pck3d, "relative": relative_pck3d,
              "right_root_relative": right_root_relative_pck3d}
    mpjpe_vals: List[float] = []
    noncol_vals: List[float] = []
    root_distances: List[float] = []  # least GT inter-hand joint distance (mm)
    frames = 0
    generator = torch.Generator(device=device).manual_seed(0)
    t_start = time.perf_counter()
    batches = Prefetcher(sliding_window_batches(stream, batch_size, max_windows,
                                                with_gt=True))
    for i, b in enumerate(batches):
        k = b["n_valid"]
        pred, noncol = eval_step(b["events"], b["event_valid"], generator,
                                 draws=None if draws is None else draws(i, b))
        gt = torch.as_tensor(b["j3d"], device=pred.device) * 1000.0  # m -> mm
        pred, gt, noncol = pred[:k], gt[:k], noncol[:k]
        for name, fn in curves.items():
            pck[name] += fn(pred, gt, num_steps, 100.0).sum(dim=0).cpu().numpy()
        mpjpe_vals.extend(mpjpe(pred, gt).cpu().tolist())
        noncol_vals.extend(noncol.cpu().tolist())
        gt_np = gt.cpu().numpy()
        root_distances.extend(
            np.linalg.norm(gt_np[:, 0] - gt_np[:, 1], axis=-1).min(-1).tolist())
        frames += k
    elapsed = time.perf_counter() - t_start
    f = max(frames, 1)
    return {
        "frames": frames,
        "windows_per_sec_end_to_end": frames / max(elapsed, 1e-9),
        "mpjpe_mm": float(np.mean(mpjpe_vals)) if mpjpe_vals else float("nan"),
        "non_collision_pct": float(np.mean(noncol_vals)) if noncol_vals else float("nan"),
        "root_distance_mm": root_distances,
        "auc": {name: get_auc(v / f) for name, v in pck.items()},
        "pck3d": {name: (v / f).tolist() for name, v in pck.items()},
    }


def main(argv=None) -> Dict:
    from ev2hands_tpu_torch.evaluate import EVAL_CONFIG, load_net
    from ev2hands_tpu_torch.train import add_mano_args, build_collision_context, build_hands

    ap = argparse.ArgumentParser(description="Evaluate on Ev2Hands-R recordings")
    ap.add_argument("--data_root", required=True,
                    help="a .pickle recording or a directory of them")
    ap.add_argument("--checkpoint_path", required=True,
                    help="a .pth file or a checkpoint directory of the port")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--max_windows", type=int, default=None)
    ap.add_argument("--out_dir", default="outputs/ev2hands_r")
    add_mano_args(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = EVAL_CONFIG.replace(
        mano=dataclasses.replace(EVAL_CONFIG.mano, model_path=args.mano_dir))
    hands = build_hands(cfg, args.synthetic_mano, args.device)
    ctx = build_collision_context(hands)
    net = load_net(cfg, args.checkpoint_path, args.device)
    eval_step = make_real_eval_step(net, hands, ctx, cfg, args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    paths = ([args.data_root] if not os.path.isdir(args.data_root) else
             [os.path.join(args.data_root, p) for p in sorted(os.listdir(args.data_root))])
    results = {}
    for path in paths:
        subject = os.path.splitext(os.path.basename(path))[0]
        stream = RealStream(path, cfg.sensor.width, cfg.sensor.height)
        results[subject] = evaluate_recording(
            eval_step, stream, cfg, args.batch_size, max_windows=args.max_windows,
            device=args.device)
        with open(os.path.join(args.out_dir, f"{subject}.pickle"), "wb") as f:
            pickle.dump(results[subject], f)
        print(json.dumps({subject: {k: results[subject][k] for k in
                                    ("frames", "mpjpe_mm", "non_collision_pct", "auc")}}))
    summary = {
        "mean_mpjpe_mm": float(np.nanmean([r["mpjpe_mm"] for r in results.values()])),
        "mean_non_collision_pct": float(
            np.nanmean([r["non_collision_pct"] for r in results.values()])),
    }
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
