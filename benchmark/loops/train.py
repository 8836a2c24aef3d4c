"""Pretraining steps through ``train.make_train_step``, as the training
CLI runs them: ERPC with the noise augmentation, TEHNet in training mode,
MANO, the losses with the collision term, backward, Adam.

Each step takes ``batch`` windows it has not seen, in the training batch
layout (raw events and labels, per hand the MANO ground truth and 'valid',
'handedness'), and a generator seeded from the run's seed and the step's
index (the augmentation, resample, FPS start and dropout draws), as the
training loop seeds its steps. Set-up builds one step object and drives
it through its first three steps; the window goes on with the same object.
End to end: windows stepped over the window's seconds.

The check runs the reference's step from the same weights on the same
three batches and draws and compares each step's loss terms, the first
gradient as Adam holds it after one step (its first moment), the BatchNorm
running statistics' change after one step, and the parameters' and
statistics' change after the three steps, by the worst leaf and by the
median leaf. A non-finite loss of any step of the window makes the run
incorrect.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

import common
import compare
import generator
from reference import model as ref_model
from reference import ops as ref_ops
from reference.step import Trainer

CHECKED_STEPS = 3


@torch.no_grad()
def _norms(tensors: Dict[str, torch.Tensor], base: Dict[str, torch.Tensor] = None):
    if base is None:
        return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}
    return {k: float(torch.linalg.vector_norm(v.float() - base[k].float()))
            for k, v in tensors.items()}


class Loop(common.LoopBase):
    kind = "train"

    def setup(self) -> None:
        ctx = self.ctx
        B, dev = ctx.batch, ctx.device
        self.pool = ctx.pool_iters()
        pool = common.Background(self.windows_for, "data", B * self.pool)
        self.checked = self.windows_for("data-checked", B * CHECKED_STEPS)
        self.build_state()
        n_pose = ctx.config["mano"]["n_pose_comps"]
        if ctx.control:
            self.trainer = Trainer(self.state, common.reference_hands(self.hand_arrays, n_pose, dev),
                                   ctx.n_points)

            def step(batch, gen):
                with ref_ops.precision("tf32"):
                    return self.trainer.step(common.to_device(batch, dev), gen)

            self.step = step
        else:
            from ev2hands_tpu_torch import train
            from ev2hands_tpu_torch.model.tehnet import TEHNet

            pcfg = common.program_config(ctx.config)
            self.net = TEHNet(pcfg.model, device=dev)
            self.net.load_state_dict(self.state, strict=True)
            hands = common.program_hands(self.hand_arrays, n_pose, dev)
            self.opt = train.make_optimizer(self.net.parameters(), pcfg.train)
            self.step = train.make_train_step(self.net, hands, train.build_collision_context(hands),
                                              pcfg, self.opt, augment=True, device=dev)
        self.mark("weights and program")
        # the checked steps: set-up drives the step object through them
        self.losses = []
        for i in range(CHECKED_STEPS):
            self.losses.append(self.step(self.batch(i), self.generator(i)))
            if i == 0:
                self.first_moment = _norms(self._first_moment())
                self.stats_first = _norms(self._leaves()[1], self.state)
        params, stats = self._leaves()
        self.change = _norms(params, self.state)
        self.stats_change = _norms(stats, self.state)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.mark("checked steps")
        self.win = pool.result()
        self.mark("inputs")

    def _first_moment(self) -> Dict[str, torch.Tensor]:
        if self.ctx.control:
            return self.trainer.first_moment()
        # a parameter that Adam never stepped has no moment: zero
        return {k: self.opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                for k, p in self.net.named_parameters()}

    @staticmethod
    def _statistics(P: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in P.items() if ref_model.is_statistic(k)}

    def _leaves(self):
        """(parameters, running statistics) of the stepped side, by name."""
        if self.ctx.control:
            P = self.trainer.P
            return ({k: v for k, v in P.items() if not ref_model.is_statistic(k)},
                    self._statistics(P))
        return dict(self.net.named_parameters()), dict(self.net.named_buffers())

    def batch(self, i: int) -> Dict:
        """Step i's batch: the checked steps' own windows, then the pool's."""
        B = self.ctx.batch
        if i < CHECKED_STEPS:
            return generator.batch(self.checked, slice(i * B, (i + 1) * B))
        j = (i - CHECKED_STEPS) % self.pool
        return generator.batch(self.win, slice(j * B, (j + 1) * B))

    def generator(self, i: int) -> torch.Generator:
        return self.ctx.generator(f"step{i}")

    def run_one(self) -> int:
        i = CHECKED_STEPS + self.iters
        with torch.profiler.record_function("bench.batch"):
            batch, gen = self.batch(i), self.generator(i)
        with torch.profiler.record_function("bench.step"):
            losses = self.step(batch, gen)
        self.nonfinite += sum(not math.isfinite(v) for v in losses.values())
        self.iters += 1
        self.windows += self.ctx.batch
        return self.ctx.batch

    def e2e(self, elapsed_s: float) -> Dict[str, float]:
        return {"train_windows_per_s": self.windows / elapsed_s}

    def release(self) -> None:
        self.step = self.net = self.opt = self.trainer = None
        common.free_device()

    def check(self) -> Dict[str, float]:
        ctx = self.ctx
        dev = ctx.device
        hands = common.reference_hands(self.hand_arrays, ctx.config["mano"]["n_pose_comps"], dev)
        ref = Trainer(self.state, hands, ctx.n_points)
        ref_losses = []
        for i in range(CHECKED_STEPS):
            ref_losses.append(ref.step(common.to_device(self.batch(i), dev), self.generator(i)))
            if i == 0:
                ref_moment = _norms(ref.first_moment())
                ref_stats_first = _norms(self._statistics(ref.P), self.state)
        ref_change = _norms({k: v for k, v in ref.P.items() if not ref_model.is_statistic(k)},
                            self.state)
        ref_stats = _norms(self._statistics(ref.P), self.state)
        steps = []
        for got, want in zip(self.losses, ref_losses):
            scale = max(abs(want["loss"]), 1e-30)
            d = [abs(got.get(k, math.nan) - v) for k, v in want.items()]
            steps.append(max(x / scale if x == x else math.inf for x in d))
        keep = compare.moving_leaves(ref_moment)
        return {"loss1_gap": steps[0], "loss_gap": max(steps),
                "grad_gap": compare.leaf_gap(self.first_moment, ref_moment, keep),
                "change_gap": compare.leaf_gap(self.change, ref_change, keep),
                "change_median_gap": compare.median_leaf_gap(self.change, ref_change, keep),
                "stats1_gap": compare.leaf_gap(self.stats_first, ref_stats_first),
                "stats_gap": compare.leaf_gap(self.stats_change, ref_stats),
                "stats_median_gap": compare.median_leaf_gap(self.stats_change, ref_stats)}
