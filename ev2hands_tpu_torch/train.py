"""TEHNet training: the step and the loop.

Counterpart of ``ev2hands_tpu/train.py``. A step (``make_train_step``): ERPC
with augmentation -> ``TEHNet`` in training mode -> ``apply_mano`` ->
``mano_losses`` with the collision term -> backward -> Adam. The loop
(``train``): batches from the native loader (or the Python reader) through
a ``Prefetcher``, losses logged every ``msg_iter`` steps, an evaluation every
``save_iter`` steps with a checkpoint on a new best score, warm start from a
``.pth`` file or a checkpoint directory, and resume. It runs on the card
unless asked for the CPU. The hands are the MANO pickles under
``--mano_dir`` (``cfg.mano.model_path``) or, with ``--synthetic_mano``,
the synthetic models (``build_hands``).

    python -m ev2hands_tpu_torch.train --data_root data/Ev2Hands-S \
        [--mano_dir data/models | --synthetic_mano] [--device cpu] \
        [--max_iter 100] [--resume_dir DIR]

Data parallel (``TrainConfig.data_parallel``, ``--data_parallel N``): N
processes, one a device, each with its rows of the global batch
(``parallel/mesh.py``): BatchNorm statistics and the losses' denominators
are the global batch's, every draw is the global batch's with this rank's
rows kept, the gradients are summed over the ranks, so N ranks take the
one-device step; the evaluation shards its batches and gathers the
predictions; only rank 0 writes the logs and checkpoints. Start it with
``torchrun --nproc_per_node N -m ev2hands_tpu_torch.train --data_parallel
N ...``, or pass ``--coordinator host:port --num_processes N --process_id
i`` to each process.

Randomness: the step ``it`` draws from a generator seeded by ``(seed + 1,
it)`` and the evaluation's batch ``i`` from one seeded by ``(0, i)``
(``seeded_generator``), so a resumed run draws what the uninterrupted run
drew and a checkpoint holds no generator state. As in the JAX package, a
resumed loop restarts its batch source at batch 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ev2hands_tpu_torch.checkpoint import Checkpointer, load_model_state
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, Config, TrainConfig
from ev2hands_tpu_torch.events.erpc import NoiseDraws, erpc_batch_transform
from ev2hands_tpu_torch.evaluate import make_full_eval_step
from ev2hands_tpu_torch.events.streams import Ev2HandSReader, Prefetcher
from ev2hands_tpu_torch.losses import CollisionContext, mano_losses, total_loss
from ev2hands_tpu_torch.mano.layer import ManoParams, create_mano_params
from ev2hands_tpu_torch.mano.model_data import load_mano_models, synthetic_mano_models
from ev2hands_tpu_torch.metrics import PckAccumulator
from ev2hands_tpu_torch.model.tehnet import TEHNet, apply_mano
from ev2hands_tpu_torch.ops.collision import (
    build_adjacency_mask,
    build_two_hand_faces,
)
from ev2hands_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_sum,
    all_sum_grads,
    create_mesh,
    initialize_distributed,
    local_rows,
    replicate,
    shard_batch,
)
from ev2hands_tpu_torch.utils.logging import RunLogger

# event rows [n, 6] and their per-frame annotations, held in memory
Rows = Tuple[np.ndarray, List[Dict]]


def build_hands(cfg: Config, synthetic: bool = False,
                device="cuda") -> Dict[str, ManoParams]:
    """Both hands' MANO constants on ``device``: from the MANO pickles under
    ``cfg.mano.model_path``, or from the synthetic models (seed 0)."""
    models = (synthetic_mano_models(0) if synthetic
              else load_mano_models(cfg.mano.model_path))
    return {side: create_mano_params(m, cfg.mano.n_pose_comps, device=device)
            for side, m in models.items()}


def add_mano_args(ap: argparse.ArgumentParser) -> None:
    """The CLIs' choice of hands: ``--mano_dir`` (``cfg.mano.model_path``)
    or ``--synthetic_mano``."""
    ap.add_argument("--mano_dir", default=DEFAULT_CONFIG.mano.model_path,
                    help="directory of MANO_{LEFT,RIGHT}.pkl (or mano/MANO_*.pkl)")
    ap.add_argument("--synthetic_mano", action="store_true",
                    help="the synthetic MANO models in place of the pickles")


def build_collision_context(hands: Dict[str, ManoParams]) -> CollisionContext:
    faces = build_two_hand_faces(hands["left"].faces.cpu().numpy(),
                                 hands["right"].faces.cpu().numpy())
    device = hands["left"].faces.device
    return CollisionContext(
        faces=torch.as_tensor(faces, device=device),
        adjacency=torch.as_tensor(build_adjacency_mask(faces), device=device))


def check_device(device, what: str) -> torch.device:
    """``device`` as a torch.device; raises when it is the card and there
    is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device is available")
    return device


def seeded_generator(seed: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` whose seed is a hash of ``(seed, index)``:
    the draws of step (or batch) ``index`` of a run seeded ``seed``."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with the weight decay added to the gradient before the moments
    (``optax.chain(add_decayed_weights(wd), adam(lr))``, not AdamW)."""
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            weight_decay=cfg.weight_decay)


def forward_losses(
    net: TEHNet, hands: Dict[str, ManoParams], ctx: CollisionContext,
    cfg: Config, events: torch.Tensor, targets: Dict,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one batch of ERPC clouds: ``net`` (in the mode it is in)
    -> MANO -> ``mano_losses`` -> (total, loss dict). ``targets`` carries
    'left', 'right', 'handedness' and the per-event labels as
    'class_logits'. Under the net's data mesh, this rank's shares."""
    outputs = apply_mano(hands, net(events, generator))
    losses = mano_losses(outputs, targets, hands, ctx, cfg.loss,
                         n_pose_comps=cfg.mano.n_pose_comps, mesh=net.mesh)
    return total_loss(losses), losses


def shard_step_inputs(mesh: Optional[Mesh], batch: Dict, draws=None, noise=None):
    """This rank's rows of a global batch and of the draws given for it."""
    if mesh is None:
        return batch, draws, noise
    return (shard_batch(batch, mesh), local_rows(draws, mesh),
            None if noise is None else shard_batch(noise, mesh))


def finish_step(net, optimizer, loss: torch.Tensor, losses: Dict,
                device) -> Dict[str, float]:
    """Backward, the gradients summed over the ranks of the net's mesh
    (divided by its event ranks, whose losses are copies), Adam -> the loss
    terms with the total as 'loss', the global batch's."""
    mesh = net.mesh
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if mesh is not None:
        all_sum_grads(list(net.parameters()), mesh, 1.0 / mesh.event_size)
    optimizer.step()
    names = list(losses) + ["loss"]
    values = torch.stack([torch.as_tensor(v, dtype=loss.dtype, device=device)
                          .detach() for v in losses.values()] + [loss.detach()])
    return dict(zip(names, all_sum(values, mesh, DATA_AXIS).tolist()))


def to_device(x, device):
    """A (nested dict of) numpy arrays or tensors as tensors on ``device``."""
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    return torch.as_tensor(x, device=device)


def make_train_step(
    net: TEHNet,
    hands: Dict[str, ManoParams],
    ctx: CollisionContext,
    cfg: Config,
    optimizer: torch.optim.Optimizer,
    augment: bool = True,
    device="cuda",
):
    """-> ``step(batch, generator=None, *, draws=None, noise=None)`` that
    runs one training step and returns its losses as a dict of floats
    (with the total as 'loss').

    ``net``, ``hands`` and ``ctx`` live on ``device``, which defaults to the
    card and raises when there is none; ``device="cpu"`` runs the kernels'
    plain versions. ``batch`` holds raw windows 'events' [B, N, 4] (x, y, t
    in ns, polarity) and 'labels' [B, N], per hand 'global_orient',
    'hand_pose', 'shape', 'trans' and 'valid', and 'handedness' [B, 2]
    (numpy arrays or tensors). The ERPC draws, FPS starts and dropout come
    from ``generator`` (on ``device``); ``draws`` and ``noise`` give the ERPC
    resample and noise draws instead.

    A step mutates in place: ``net``'s parameters (the Adam update), its
    BatchNorm running statistics (the forward in training mode) and the
    optimizer's state.

    Under the net's mesh (``TEHNet.set_mesh``) ``batch``, ``draws`` and
    ``noise`` are the global batch's, the same on every rank; each rank
    takes its rows, the generator's draws are the global batch's, and the
    step is the one-device step of the global batch (``finish_step``)."""
    device = check_device(device, "make_train_step")
    sensor = cfg.sensor

    def step(batch: Dict, generator: Optional[torch.Generator] = None, *,
             draws: Optional[torch.Tensor] = None,
             noise: Optional[NoiseDraws] = None) -> Dict[str, float]:
        batch, draws, noise = shard_step_inputs(net.mesh, batch, draws, noise)
        batch = to_device(batch, device)
        erpc = erpc_batch_transform(
            batch["events"], batch["labels"], generator, draws=draws,
            width=sensor.width, height=sensor.height,
            n_out=cfg.model.n_points, augment=augment, noise=noise, mesh=net.mesh)
        targets = {"left": batch["left"], "right": batch["right"],
                   "handedness": batch["handedness"],
                   "class_logits": erpc.labels}
        net.train()
        # the float32 ERPC cloud in the weights' dtype (a float64 net in tests)
        events = erpc.events.to(net.classifier[0].weight.dtype)
        loss, losses = forward_losses(net, hands, ctx, cfg, events, targets, generator)
        return finish_step(net, optimizer, loss, losses, device)

    return step


def make_eval_step(net: TEHNet, hands: Dict[str, ManoParams], cfg: Config,
                   device="cuda"):
    """-> ``step(batch, generator=None, *, draws=None)`` -> (predicted,
    ground-truth joints), each [B, 2, 21, 3] in mm: the joints of
    ``evaluate.make_full_eval_step`` (no second forward), with ``net`` put
    in eval mode at every call, so that it can run between training
    steps. Under the net's data mesh each rank evaluates its rows and every
    rank returns the global batch's joints."""
    full = make_full_eval_step(net, hands, cfg, device)

    def step(batch: Dict, generator: Optional[torch.Generator] = None, *,
             draws: Optional[torch.Tensor] = None):
        net.eval()
        pred_j, gt_j, _, _ = full(batch, generator, draws=draws)
        return pred_j, gt_j

    return step


def evaluate(eval_step, reader: Ev2HandSReader, cfg: Config,
             max_frames: Optional[int] = None, device="cuda") -> Tuple[Dict, float]:
    """PCK curves and AUC (0-50 mm over 51 steps) over ``max(1, max_frames
    // bs)`` batches of ``reader.batches(shuffle=False)`` (``max_frames``
    defaults to ``cfg.train.max_eval_iters``, bs is
    ``cfg.train.eval_batch_size``), stopping once ``max_frames`` frames are
    in -> (metrics, score = the relative AUC). Batch ``i`` draws from
    ``seeded_generator(0, i)``."""
    acc = PckAccumulator(num_steps=50, dist_max_mm=50.0)
    max_frames = max_frames or cfg.train.max_eval_iters
    bs = cfg.train.eval_batch_size
    for i, batch in enumerate(reader.batches(bs, shuffle=False,
                                             max_batches=max(1, max_frames // bs))):
        pred, gt = eval_step(batch, seeded_generator(0, i, device))
        acc.update(pred, gt)
        if acc.frames >= max_frames:
            break
    return acc.result()


class LoopStats(NamedTuple):
    """Where a loop's wall time went, in s; the ``steps`` taken in this run,
    the evaluations and saves made, and the last step's losses."""

    steps: int
    wall_s: float
    loader_wait_s: float
    eval_s: float
    save_s: float
    evals: int
    saves: int
    losses: Dict[str, float]


class TrainRun(NamedTuple):
    """What a training or finetuning run leaves: the model and optimizer
    (on their device), the step count, the best evaluation score, the run
    directory, the batch source used and the loop's timings."""

    net: TEHNet
    optimizer: torch.optim.Optimizer
    step: int
    max_eval_score: float
    run_dir: str
    source: str
    stats: LoopStats


def run_loop(step, batches: Iterator[Dict], evaluate_fn: Callable[[], Tuple[Dict, float]],
             run: "RunStart", *, max_iter: int, seed: int, save_iter: int,
             msg_iter: int, device) -> Tuple[int, float, LoopStats]:
    """The loop of training and finetuning: step ``it`` (from ``run.step``
    to ``max_iter``) takes the next batch and ``seeded_generator(seed,
    it)``; the mean losses are logged every ``msg_iter`` steps; every
    ``save_iter`` steps ``evaluate_fn()`` scores the model and a new best
    score saves a checkpoint in the run directory's ``ckpt``
    (asynchronously; joined before returning, and the log closed).
    -> (steps done, best score, timings)."""
    logger, start_it, best_score = run.logger, run.step, run.best_score
    ckptr = Checkpointer(f"{logger.run_dir}/ckpt") if logger.run_dir else None
    loss_log: Dict[str, float] = {}
    losses: Dict[str, float] = {}
    loader_s = eval_s = save_s = 0.0
    evals = saves = 0
    it = start_it
    st = glob_st = time.perf_counter()
    while it < max_iter:
        t0 = time.perf_counter()
        batch = next(batches, None)
        loader_s += time.perf_counter() - t0
        if batch is None:
            break
        losses = step(batch, seeded_generator(seed, it, device))
        for k, v in losses.items():
            loss_log[k] = loss_log.get(k, 0.0) + v
        it += 1
        if it % msg_iter == 0:
            ed = time.perf_counter()
            eta = int((max_iter - it + 1) * (ed - glob_st) / max(it - 1, 1))
            logger.info(", ".join(
                [f"it: {it}/{max_iter}"]
                + [f"{k}: {v / msg_iter:.3f}" for k, v in loss_log.items()]
                + [f"time: {ed - st:.2f}s", f"eta: {eta}s"]))
            loss_log, st = {}, ed
        if it % save_iter == 0:
            t0 = time.perf_counter()
            metrics, score = evaluate_fn()
            eval_s += time.perf_counter() - t0
            evals += 1
            logger.info(f"eval@{it}: score={score} auc={metrics['auc']}")
            logger.scalar("relative_auc", score, it)
            if score > best_score:
                best_score = score
                if ckptr is not None:
                    t0 = time.perf_counter()
                    ckptr.save(it, run.net, run.optimizer, best_score)
                    save_s += time.perf_counter() - t0
                    saves += 1
                    logger.info(f"saved best checkpoint at {it}")
    t0 = time.perf_counter()
    if ckptr is not None:
        ckptr.wait()  # join the save in flight
    save_s += time.perf_counter() - t0
    stats = LoopStats(it - start_it, time.perf_counter() - glob_st, loader_s,
                      eval_s, save_s, evals, saves, losses)
    logger.info(f"{stats.steps} steps in {stats.wall_s:.2f} s: waiting on the "
                f"loader {stats.loader_wait_s:.2f} s, evaluating {stats.eval_s:.2f} s "
                f"({stats.evals}), saving {stats.save_s:.2f} s ({stats.saves})")
    logger.close()
    return it, best_score, stats


class QuietLogger:
    """The run logger of a rank other than 0: it writes nothing."""

    run_dir = None

    def info(self, msg: str):
        pass

    def scalar(self, tag: str, value: float, step: int):
        pass

    def log_run_config(self, cfg, net=None):
        pass

    def close(self):
        pass


class RunStart(NamedTuple):
    """A run's logger, hands, collision context, model and Adam, and the
    step and best score it starts from."""

    logger: RunLogger
    hands: Dict[str, ManoParams]
    ctx: CollisionContext
    net: TEHNet
    optimizer: torch.optim.Optimizer
    step: int
    best_score: float


def start_run(name: str, cfg: Config, synthetic_mano: bool, checkpoint_path: str,
              resume_dir: Optional[str], device, base_dir: str,
              tensorboard: bool, mesh: Optional[Mesh] = None) -> RunStart:
    """The set-up that training and finetuning share: the run directory
    ``{base_dir}/{name}_<stamp>`` with the config and the model, the model
    and Adam on ``device``, warm-started from ``checkpoint_path`` (a
    ``.pth`` file or a checkpoint directory) and then resumed from the
    latest checkpoint in ``resume_dir`` (model, Adam, step, best score)
    where it has one. The hands are the synthetic MANO models with
    ``synthetic_mano``, else the pickles under ``cfg.mano.model_path``.
    Under a data mesh every rank starts alike and then takes rank 0's
    weights; only rank 0 has a run directory."""
    hands = build_hands(cfg, synthetic_mano, device)
    logger = (RunLogger(name, base_dir, tensorboard)
              if mesh is None or mesh.is_main else QuietLogger())
    net = TEHNet(cfg.model, device=device, mesh=mesh)
    optimizer = make_optimizer(net.parameters(), cfg.train)
    logger.log_run_config(cfg, net)
    if checkpoint_path:
        net.load_state_dict(load_model_state(checkpoint_path), strict=True)
        logger.info(f"warm-started from {checkpoint_path}")
    step, best_score = 0, -float("inf")
    if resume_dir:
        prev = Checkpointer(resume_dir)
        if prev.latest_step() is not None:
            blob = prev.restore_into(net, optimizer)
            step, best_score = blob["step"], blob["max_eval_score"]
            logger.info(f"resumed from {resume_dir} at step {step} "
                        f"(best score {best_score})")
    replicate(net, mesh)
    return RunStart(logger, hands, build_collision_context(hands), net, optimizer,
                    step, best_score)


def open_train_source(cfg: Config, train_data: Optional[Rows] = None
                      ) -> Tuple[Iterator[Dict], str]:
    """The training batches, random windows of ``cfg.train.batch_size``,
    and the name of their source: the native loader where its library
    builds, else the Python reader; over ``train_data`` or over
    ``{data_root}/train``."""
    from ev2hands_tpu_torch.events.native_loader import (
        NativeEv2HandSLoader,
        native_available,
    )

    n, bs, seed = cfg.model.n_points, cfg.train.batch_size, cfg.train.seed
    root = f"{cfg.train.data_root}/train"
    if native_available():
        # One thread: a batch of B x N rows copies in well under a
        # millisecond, less than starting a pool of threads for it costs
        # (chip_smoke.py phase 14 times both). The batches do not depend on
        # the thread count.
        kw = dict(n_threads=1, seed=seed)
        loader = (NativeEv2HandSLoader.from_rows(*train_data, n, **kw)
                  if train_data is not None else NativeEv2HandSLoader(root, n, **kw))
        return loader.batches(bs), "native"
    reader = (Ev2HandSReader.from_rows(*train_data, n) if train_data is not None
              else Ev2HandSReader(root, n))
    return reader.batches(bs, shuffle=True), "python"


def loop_mesh(cfg: Config, device) -> Tuple[Optional[Mesh], torch.device]:
    """The data mesh of ``cfg.train.data_parallel`` ranks (None for one)
    and this rank's device. The ranks must have joined their process group
    (``initialize_distributed``)."""
    device = check_device(device, "the training loop")
    if cfg.train.data_parallel <= 1:
        return None, device
    mesh = create_mesh(cfg.train.data_parallel, device)
    return mesh, mesh.device


def train(cfg: Config = DEFAULT_CONFIG, synthetic_mano: bool = False,
          max_iter: Optional[int] = None, resume_dir: Optional[str] = None, *,
          device="cuda", train_data: Optional[Rows] = None,
          val_data: Optional[Rows] = None, base_dir: str = "runs",
          tensorboard: bool = False) -> TrainRun:
    """The pretraining loop on Ev2Hands-S (``run_loop``) with its run
    directory under ``base_dir``. ``cfg.train.checkpoint_path`` (a ``.pth``
    file or a checkpoint directory) warm-starts the weights; ``resume_dir``
    (a previous run's ``ckpt`` directory) restores the model, Adam, the step
    and the best score of its latest checkpoint. The splits are
    ``{data_root}/train`` and ``/val``, or the rows given as ``train_data``
    and ``val_data``. With ``cfg.train.data_parallel`` > 1 this process is
    one rank of a data-parallel run: every rank reads the same global
    batches and takes its rows."""
    mesh, device = loop_mesh(cfg, device)
    run = start_run("train", cfg, synthetic_mano, cfg.train.checkpoint_path,
                    resume_dir, device, base_dir, tensorboard, mesh)
    step = make_train_step(run.net, run.hands, run.ctx, cfg, run.optimizer,
                           device=device)
    eval_step = make_eval_step(run.net, run.hands, cfg, device)
    n = cfg.model.n_points
    val_reader = (Ev2HandSReader.from_rows(*val_data, n) if val_data is not None
                  else Ev2HandSReader(f"{cfg.train.data_root}/val", n))
    source, name = open_train_source(cfg, train_data)
    run.logger.info("using the native C++ batch loader" if name == "native"
                    else "native loader unavailable; using the Python reader")
    it, best_score, stats = run_loop(
        step, Prefetcher(source),
        lambda: evaluate(eval_step, val_reader, cfg, device=device), run,
        max_iter=max_iter or cfg.train.max_iter, seed=cfg.train.seed + 1,
        save_iter=cfg.train.save_iter, msg_iter=cfg.train.msg_iter, device=device)
    return TrainRun(run.net, run.optimizer, it, best_score, run.logger.run_dir, name,
                    stats)


def add_parallel_args(ap: argparse.ArgumentParser) -> None:
    """The CLIs' data-parallel flags: ``--data_parallel`` and the three
    multi-host ones (all three, or torchrun's environment)."""
    ap.add_argument("--data_parallel", type=int, default=1,
                    help="data-parallel ranks (processes, one a device)")
    ap.add_argument("--coordinator", default=None, help="host:port of process 0")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)


def join_ranks(args) -> None:
    """Join the process group of ``add_parallel_args``' flags, or of
    torchrun's environment; nothing for one process."""
    if args.num_processes or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                               backend="gloo" if args.device == "cpu" else None)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser(description="Pretrain TEHNet on Ev2Hands-S")
    ap.add_argument("--data_root", default=DEFAULT_CONFIG.train.data_root)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--checkpoint_path", default="",
                    help="warm start: a .pth file or a checkpoint directory")
    ap.add_argument("--max_iter", type=int, default=None)
    ap.add_argument("--save_iter", type=int, default=DEFAULT_CONFIG.train.save_iter)
    ap.add_argument("--max_eval_iters", type=int,
                    default=DEFAULT_CONFIG.train.max_eval_iters)
    ap.add_argument("--resume_dir", default=None,
                    help="a previous run's ckpt directory to resume from")
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
            DEFAULT_CONFIG.train, data_root=args.data_root,
            batch_size=args.batch_size, eval_batch_size=args.eval_batch_size,
            checkpoint_path=args.checkpoint_path, save_iter=args.save_iter,
            msg_iter=args.msg_iter, max_eval_iters=args.max_eval_iters,
            data_parallel=args.data_parallel))
    return train(cfg, synthetic_mano=args.synthetic_mano, max_iter=args.max_iter,
                 resume_dir=args.resume_dir, device=args.device,
                 tensorboard=args.tensorboard)


if __name__ == "__main__":
    main()
