"""Finetuning TEHNet on real Ev2Hands-R recordings.

Counterpart of ``ev2hands_tpu/finetune.py``: warm start from a pretrained
checkpoint, then train on random real windows (``Ev2HandRReader``) with the
real-data loss (no MANO ground truth: root-relative joints, the 2-D
reprojection, inter-hand consistency and the collision term). A step:
``erpc_real_batch_transform`` on the masked variable-length windows ->
``TEHNet`` in training mode -> ``apply_mano`` -> ``real_losses`` -> backward
-> Adam. The loop is the training loop's (``train.run_loop``): an
evaluation every ``save_iter`` steps, a checkpoint on a new best score, and
resume. It runs on the card unless asked for the CPU.

    python -m ev2hands_tpu_torch.finetune --data_root recordings/ \\
        --val_data_root held_out/ --checkpoint_path best.pth \\
        [--mano_dir data/models | --synthetic_mano]

Step ``it`` draws from ``train.seeded_generator(seed + 2, it)``, the
evaluation's batch ``i`` from ``seeded_generator(0, i)``. Data parallel
(``--data_parallel N``, as in ``train``): each rank takes its rows of the
global batch and of its draws, and the evaluation gathers the predictions.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ev2hands_tpu_torch.config import DEFAULT_CONFIG, Config
from ev2hands_tpu_torch.evaluate import DrawsFn
from ev2hands_tpu_torch.events.erpc import erpc_real_batch_transform
from ev2hands_tpu_torch.events.real_streams import Ev2HandRReader
from ev2hands_tpu_torch.events.streams import Prefetcher
from ev2hands_tpu_torch.losses import CollisionContext, real_losses, total_loss
from ev2hands_tpu_torch.mano.layer import ManoParams
from ev2hands_tpu_torch.metrics import PckAccumulator
from ev2hands_tpu_torch.model.tehnet import TEHNet, apply_mano
from ev2hands_tpu_torch.parallel.mesh import gather_rows, shard_batch
from ev2hands_tpu_torch.train import (
    TrainRun,
    add_mano_args,
    add_parallel_args,
    check_device,
    finish_step,
    join_ranks,
    loop_mesh,
    run_loop,
    seeded_generator,
    shard_step_inputs,
    start_run,
    to_device,
)


def make_finetune_step(net: TEHNet, hands: Dict[str, ManoParams],
                       ctx: CollisionContext, cfg: Config,
                       optimizer: torch.optim.Optimizer, projection_matrix,
                       device="cuda"):
    """-> ``step(batch, generator=None, *, draws=None)`` that runs one
    finetuning step and returns its losses as a dict of floats (with the
    total as 'loss'); it mutates ``net``, its BatchNorm statistics and the
    optimizer's state.

    ``batch`` is an ``Ev2HandRReader`` batch: padded windows 'events' [B, N,
    4] (x, y, t in ms, polarity) with 'event_valid' [B, N], per hand 'j3d',
    'j2d' and 'valid', and 'handedness'. ``projection_matrix`` [4, 4] is
    the camera's (``cfg.camera.projection_matrix``). The ERPC resample, FPS
    starts and dropout draw from ``generator``; ``draws`` gives the
    resample instead. Under the net's mesh, the batch and the draws are the
    global batch's (``train.make_train_step``)."""
    device = check_device(device, "make_finetune_step")
    sensor = cfg.sensor
    proj = torch.as_tensor(np.asarray(projection_matrix), dtype=torch.float32,
                           device=device)

    def step(batch: Dict, generator: Optional[torch.Generator] = None, *,
             draws: Optional[torch.Tensor] = None) -> Dict[str, float]:
        batch, draws, _ = shard_step_inputs(net.mesh, batch, draws)
        batch = to_device(batch, device)
        erpc = erpc_real_batch_transform(
            batch["events"], batch["event_valid"], generator, draws=draws,
            width=sensor.width, height=sensor.height, n_out=cfg.model.n_points,
            mesh=net.mesh)
        targets = {"left": batch["left"], "right": batch["right"],
                   "handedness": batch["handedness"]}
        net.train()
        outputs = apply_mano(hands, net(erpc.events, generator))
        losses = real_losses(outputs, targets, ctx, proj, sensor.width,
                             sensor.height, cfg.loss, mesh=net.mesh)
        return finish_step(net, optimizer, total_loss(losses), losses, device)

    return step


def make_finetune_eval_step(net: TEHNet, hands: Dict[str, ManoParams],
                            cfg: Config, device="cuda"):
    """-> ``step(events, event_valid, generator=None, *, draws=None)`` ->
    predicted joints [B, 2, 21, 3] in mm, ``net`` in eval mode. Under the
    net's data mesh each rank runs its rows of the global batch (the
    generator's draws the global batch's) and every rank returns the
    global batch's joints; a batch that does not split runs whole."""
    device = check_device(device, "make_finetune_eval_step")
    sensor = cfg.sensor

    @torch.inference_mode()
    def step(events, event_valid, generator: Optional[torch.Generator] = None, *,
             draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        net.eval()
        mesh = net.mesh
        if mesh is not None and len(events) % mesh.data_size:
            mesh = None
        events, event_valid, draws = shard_batch((events, event_valid, draws), mesh)
        erpc = erpc_real_batch_transform(
            torch.as_tensor(events, device=device),
            torch.as_tensor(event_valid, device=device), generator, draws=draws,
            width=sensor.width, height=sensor.height, n_out=cfg.model.n_points,
            mesh=mesh)
        outputs = apply_mano(hands, net(erpc.events))
        pred = torch.stack([outputs["left"]["j3d"], outputs["right"]["j3d"]], 1) * 1000.0
        return gather_rows(pred, mesh)

    return step


def evaluate_finetune(eval_step, reader: Ev2HandRReader, cfg: Config,
                      max_frames: int = 8192, device="cuda",
                      draws: Optional[DrawsFn] = None):
    """PCK curves and AUC (0-50 mm over 51 steps) on ``max(1, max_frames //
    bs)`` reader batches, the ground truth the batch's joints -> (metrics,
    score = the relative AUC). Batch ``i`` draws from
    ``seeded_generator(0, i)``, or takes ``draws(i, batch)`` where that is
    not None."""
    acc = PckAccumulator(num_steps=50, dist_max_mm=50.0)
    bs = cfg.train.eval_batch_size
    for i, batch in enumerate(reader.batches(bs, max_batches=max(1, max_frames // bs))):
        given = draws(i, batch) if draws is not None else None
        pred = eval_step(batch["events"], batch["event_valid"],
                         seeded_generator(0, i, device), draws=given)
        gt = np.stack([batch["left"]["j3d"], batch["right"]["j3d"]], axis=1) * 1000.0
        acc.update(pred, torch.as_tensor(gt, device=pred.device))
        if acc.frames >= max_frames:
            break
    return acc.result()


def finetune(
    cfg: Config = DEFAULT_CONFIG, data_root: str = "", checkpoint_path: str = "",
    max_iter: int = 15_000, save_iter: int = 5_000, synthetic_mano: bool = False,
    val_data_root: str = "", max_eval_iters: int = 8192, resume_dir: str = "", *,
    device="cuda", base_dir: str = "runs", tensorboard: bool = False,
) -> TrainRun:
    """The finetuning loop on the recordings at ``data_root`` (a recording
    or a directory of them), its run directory under ``base_dir``.
    ``checkpoint_path`` (a ``.pth`` file or a checkpoint directory) only
    warm-starts the weights; ``resume_dir`` (a previous finetuning run's
    ``ckpt`` directory) restores the model, Adam, the step and the best
    score of its latest checkpoint. Save-on-best scores ``val_data_root``,
    or the training recordings (with a warning) where none is given. With
    ``cfg.train.data_parallel`` > 1 this process is one rank of a
    data-parallel run."""
    mesh, device = loop_mesh(cfg, device)
    run = start_run("finetune", cfg, synthetic_mano, checkpoint_path, resume_dir,
                    device, base_dir, tensorboard, mesh)
    projection = cfg.camera.projection_matrix(cfg.sensor.width, cfg.sensor.height)
    step = make_finetune_step(run.net, run.hands, run.ctx, cfg, run.optimizer,
                              projection, device)
    eval_step = make_finetune_eval_step(run.net, run.hands, cfg, device)
    reader = Ev2HandRReader(data_root, seed=cfg.train.seed)
    if not val_data_root:
        run.logger.info(
            "WARNING: no --val_data_root given: save-on-best will select on the "
            "training recordings, which is self-selecting and not the reference's "
            "held-out validation. Pass a held-out recordings directory.")
    val_reader = Ev2HandRReader(val_data_root or data_root, seed=cfg.train.seed + 100)
    it, best_score, stats = run_loop(
        step, Prefetcher(reader.batches(cfg.train.batch_size)),
        lambda: evaluate_finetune(eval_step, val_reader, cfg, max_eval_iters, device),
        run, max_iter=max_iter, seed=cfg.train.seed + 2, save_iter=save_iter,
        msg_iter=cfg.train.msg_iter, device=device)
    return TrainRun(run.net, run.optimizer, it, best_score, run.logger.run_dir,
                    "Ev2HandRReader", stats)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser(description="Finetune TEHNet on Ev2Hands-R")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--val_data_root", default="",
                    help="held-out recordings (defaults to data_root)")
    ap.add_argument("--checkpoint_path", default="",
                    help="warm start: a .pth file or a checkpoint directory")
    ap.add_argument("--resume_dir", default="",
                    help="a previous finetuning run's ckpt directory to resume "
                         "from (restores Adam and the step, unlike checkpoint_path)")
    ap.add_argument("--max_iter", type=int, default=15_000)
    ap.add_argument("--save_iter", type=int, default=5_000)
    ap.add_argument("--max_eval_iters", type=int, default=8192)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--eval_batch_size", type=int,
                    default=DEFAULT_CONFIG.train.eval_batch_size)
    ap.add_argument("--n_points", type=int, default=DEFAULT_CONFIG.model.n_points)
    ap.add_argument("--msg_iter", type=int, default=DEFAULT_CONFIG.train.msg_iter)
    add_mano_args(ap)
    ap.add_argument("--tensorboard", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed-precision training: the conv chains in bfloat16, "
                         "parameters, BatchNorm statistics and losses float32 "
                         "(ModelConfig.bf16_train)")
    add_parallel_args(ap)
    args = ap.parse_args(argv)
    join_ranks(args)
    cfg = DEFAULT_CONFIG.replace(
        mano=dataclasses.replace(DEFAULT_CONFIG.mano, model_path=args.mano_dir),
        model=dataclasses.replace(DEFAULT_CONFIG.model, n_points=args.n_points,
                                  bf16_train=args.bf16),
        train=dataclasses.replace(
            DEFAULT_CONFIG.train, batch_size=args.batch_size,
            eval_batch_size=args.eval_batch_size, msg_iter=args.msg_iter,
            data_parallel=args.data_parallel))
    return finetune(cfg, args.data_root, args.checkpoint_path, args.max_iter,
                    args.save_iter, args.synthetic_mano,
                    val_data_root=args.val_data_root,
                    max_eval_iters=args.max_eval_iters, resume_dir=args.resume_dir,
                    device=args.device, tensorboard=args.tensorboard)


if __name__ == "__main__":
    main()
