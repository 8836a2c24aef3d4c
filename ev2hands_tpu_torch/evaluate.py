"""Ev2Hands-S test evaluation: 3-D PCK curves and AUC, MPJPE and MPVPE.

Counterpart of ``ev2hands_tpu/evaluate.py``: raw windows from an
``Ev2HandSReader`` -> ``erpc_batch_transform`` -> ``TEHNet`` eval -> MANO,
held against the ground truth that the annotations' MANO parameters give.
It runs on the card unless asked for the CPU, in the fused grouping
configuration (``EVAL_CONFIG``: ``pallas_fused_msg=True``). It reads the
reference's ``.pth`` checkpoints and the port's own checkpoint directories
(``checkpoint.load_model_state``); native JAX (orbax) checkpoints need orbax
and are not read.

    python -m ev2hands_tpu_torch.evaluate --checkpoint_path best.pth \\
        --data_root data/Ev2Hands-S [--mano_dir data/models | --synthetic_mano]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ev2hands_tpu_torch.config import DEFAULT_CONFIG, Config
from ev2hands_tpu_torch.events.erpc import erpc_batch_transform
from ev2hands_tpu_torch.events.streams import Ev2HandSReader
from ev2hands_tpu_torch.losses import recompute_gt_joints
from ev2hands_tpu_torch.mano.layer import ManoParams
from ev2hands_tpu_torch.metrics import PckAccumulator, mpjpe, mpvpe
from ev2hands_tpu_torch.model.tehnet import TEHNet, apply_mano
from ev2hands_tpu_torch.parallel.mesh import gather_rows, local_rows, shard_batch

# The evaluation configuration: all sa1 scales in one fused grouping launch.
EVAL_CONFIG = DEFAULT_CONFIG.replace(
    model=dataclasses.replace(DEFAULT_CONFIG.model, pallas_fused_msg=True))

# A batch's resample draws: (batch index, host batch) -> [B, n_points] ints
# or None for draws from the evaluation's generator.
DrawsFn = Callable[[int, Dict], Optional[torch.Tensor]]


def _on(x, device):
    if isinstance(x, dict):
        return {k: _on(v, device) for k, v in x.items()}
    return torch.as_tensor(x, device=device)


def make_full_eval_step(net: TEHNet, hands: Dict[str, ManoParams], cfg: Config,
                        device="cuda"):
    """-> ``step(batch, generator=None, *, draws=None)`` -> (pred joints,
    GT joints, pred vertices, GT vertices), each [B, 2, ., 3] in mm.

    ``net`` (put in eval mode) and ``hands`` live on ``device``, which
    defaults to the card and raises when there is none. ``batch`` is a
    reader batch: raw windows 'events' [B, N, 4] and 'labels', per hand the
    MANO ground truth. The ERPC resample draws come from ``generator`` or
    are given.

    Under the net's data mesh each rank runs its rows of the global batch
    (the generator's draws the global batch's, this rank's rows kept) and
    the four results are gathered, so every rank returns the global batch's;
    a batch that does not split over the data ranks runs whole on every
    rank, as the JAX package's evaluation does."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_full_eval_step: no CUDA device is available")
    sensor = cfg.sensor
    net.eval()

    @torch.inference_mode()
    def step(batch: Dict, generator: Optional[torch.Generator] = None, *,
             draws: Optional[torch.Tensor] = None):
        mesh = net.mesh
        if mesh is not None and len(batch["events"]) % mesh.data_size:
            mesh = None
        batch, draws = _on(shard_batch(batch, mesh), device), local_rows(draws, mesh)
        erpc = erpc_batch_transform(
            batch["events"], batch["labels"], generator, draws=draws,
            width=sensor.width, height=sensor.height, n_out=cfg.model.n_points,
            mesh=mesh)
        outputs = apply_mano(hands, net(erpc.events))
        targets = recompute_gt_joints(hands, {"left": batch["left"],
                                              "right": batch["right"]})
        pairs = []
        for key in ("j3d", "vertices"):
            pred = torch.stack([outputs["left"][key], outputs["right"][key]], 1)
            gt = torch.stack([targets["left"][key], targets["right"][key]], 1)
            pairs += [pred * 1000, gt * 1000]
        return tuple(gather_rows(p, mesh) for p in pairs)

    return step


def evaluate_dataset(
    net: TEHNet, hands: Dict[str, ManoParams], reader: Ev2HandSReader,
    cfg: Config, max_frames: int = 8192, full_split: bool = False,
    stride: int = 1, device="cuda", draws: Optional[DrawsFn] = None,
) -> Dict:
    """The report: PCK curves and AUC (0-50 mm), the eval score (relative
    AUC), MPJPE and MPVPE in mm, and the frame count.

    By default ``max_frames`` windows, ``cfg.train.eval_batch_size`` at a
    time, from ``reader.batches(shuffle=False)``; ``full_split`` takes every
    window start at ``stride`` (``reader.sequential_batches``) and masks the
    padding of the last batch. Resample draws come from a generator seeded
    0 on ``device``, or from ``draws``."""
    step = make_full_eval_step(net, hands, cfg, device)
    generator = torch.Generator(device=device).manual_seed(0)
    acc = PckAccumulator(num_steps=50, dist_max_mm=50.0)
    mpjpe_sum = mpvpe_sum = 0.0
    bs = cfg.train.eval_batch_size
    if full_split:
        batches = reader.sequential_batches(bs, stride=stride)
    else:
        batches = ((b, bs) for b in reader.batches(
            bs, shuffle=False, max_batches=max(1, max_frames // bs)))
    for i, (batch, n_real) in enumerate(batches):
        given = draws(i, batch) if draws is not None else None
        pj, gj, pv, gv = (t[:n_real] for t in step(batch, generator, draws=given))
        acc.update(pj, gj)
        mpjpe_sum += float(mpjpe(pj, gj).sum())
        mpvpe_sum += float(mpvpe(pv, gv).sum())
        if not full_split and acc.frames >= max_frames:
            break
    metrics, score = acc.result()
    n = max(acc.frames, 1)
    return {
        "pck3d": {k: v.tolist() for k, v in metrics["pck3d"].items()},
        "auc": metrics["auc"],
        "eval_score": score,
        "mpjpe_mm": mpjpe_sum / n,
        "mpvpe_mm": mpvpe_sum / n,
        "frames": acc.frames,
    }


def save_artifacts(report: Dict, out_dir: str) -> None:
    """metrics.npy and metrics.json in ``out_dir``, and a PCK plot per curve
    where matplotlib is installed (plots are best-effort)."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "metrics.npy"), report, allow_pickle=True)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(report, f, indent=2)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for name, curve in report["pck3d"].items():
            plt.figure()
            plt.plot(np.arange(len(curve)), curve)
            plt.xlabel("error threshold (mm)")
            plt.ylabel("3D PCK")
            plt.title(f"{name} (AUC {report['auc'][name]})")
            plt.grid(True)
            plt.savefig(os.path.join(out_dir, f"pck3d_{name}.png"), dpi=120)
            plt.close()
    except Exception:
        pass  # plots are best-effort


def load_net(cfg: Config, checkpoint_path: str, device) -> TEHNet:
    """TEHNet on ``device`` with the weights of a reference ``.pth`` file or
    of the latest entry of a port checkpoint directory."""
    from ev2hands_tpu_torch.checkpoint import load_model_state

    net = TEHNet(cfg.model, device=device)
    net.load_state_dict(load_model_state(checkpoint_path), strict=True)
    return net.eval()


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description="Evaluate on Ev2Hands-S test")
    ap.add_argument("--data_root", default=DEFAULT_CONFIG.train.data_root)
    ap.add_argument("--split", default="test")
    ap.add_argument("--checkpoint_path", required=True,
                    help="a .pth file or a checkpoint directory of the port")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--max_frames", type=int, default=8192)
    ap.add_argument("--full_split", action="store_true",
                    help="evaluate every window start (the reference's coverage)")
    ap.add_argument("--stride", type=int, default=1,
                    help="window-start stride with --full_split")
    ap.add_argument("--out_dir", default="outputs")
    from ev2hands_tpu_torch.train import add_mano_args, build_hands

    add_mano_args(ap)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = EVAL_CONFIG.replace(
        mano=dataclasses.replace(EVAL_CONFIG.mano, model_path=args.mano_dir),
        train=dataclasses.replace(EVAL_CONFIG.train, eval_batch_size=args.batch_size))
    hands = build_hands(cfg, args.synthetic_mano, args.device)
    net = load_net(cfg, args.checkpoint_path, args.device)
    reader = Ev2HandSReader(f"{args.data_root}/{args.split}", cfg.model.n_points)
    report = evaluate_dataset(net, hands, reader, cfg, args.max_frames,
                              full_split=args.full_split, stride=args.stride,
                              device=args.device)
    save_artifacts(report, args.out_dir)
    print(json.dumps({k: report[k] for k in
                      ("auc", "eval_score", "mpjpe_mm", "mpvpe_mm", "frames")}))
    return report


if __name__ == "__main__":
    main()
