"""Streaming inference in a closed loop with one client.

Each request is ``batch`` windows the loop has not sent before, handed
from the host to ``serve.InferencePipeline.__call__`` with the run's
generator (the ERPC resample draws); its latency runs from the hand-off to
the outputs on the card, synchronised. The next request goes when the last
one is back. End to end: windows completed over the window's seconds, and
the 95th percentile of every request's latency.

The check runs the reference on every request of the window, its draws
replayed from the same generator, and compares the class logits, both
hands' MANO parameters and their vertices and joints.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

import common
import compare
import generator
from reference import ops as ref_ops
from reference.step import infer

HAND_KEYS = ("global_orient", "hand_pose", "betas", "transl")
MESH_KEYS = ("vertices", "j3d")


class Loop(common.LoopBase):
    kind = "stream"

    def setup(self) -> None:
        ctx = self.ctx
        B, dev = ctx.batch, ctx.device
        self.warm = int(ctx.mix["warmup"])
        self.pool = ctx.pool_iters()
        pool = common.Background(self._requests, "data", self.pool)
        warm = self._requests("data-warmup", self.warm)
        self.build_state()
        n_pose = ctx.config["mano"]["n_pose_comps"]
        if ctx.control:
            self.call = self._control(common.reference_hands(self.hand_arrays, n_pose, dev))
        else:
            from ev2hands_tpu_torch.mano.model_data import ManoModelData
            from ev2hands_tpu_torch.serve import InferencePipeline

            self.pipe = InferencePipeline(
                common.program_config(ctx.config), self.state,
                {s: ManoModelData(side=s, **self.hand_arrays[s]) for s in ("left", "right")},
                device=dev)
            self.call = self.pipe
        self.mark("weights and program")
        warm_gen = ctx.generator("warmup")
        for raw, lab in warm:
            self.call(raw, lab, warm_gen)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.mark("warm-up")
        self.requests = pool.result()
        self.mark("inputs")
        self.gen = ctx.generator("draws")
        self.latencies, self.outputs, self.pair_counts = [], [], []

    def _requests(self, tag: str, count: int):
        """``count`` requests of ``batch`` windows: (raw events, labels) as
        CPU tensors."""
        B = self.ctx.batch
        win = self.windows_for(tag, B * count)
        events = torch.from_numpy(generator.raw_events(win))
        labels = torch.from_numpy(win["labels"])
        return [(events[i * B:(i + 1) * B], labels[i * B:(i + 1) * B]) for i in range(count)]

    def _control(self, hands):
        """The reference in TF32 in the program's place."""
        ctx = self.ctx

        def call(raw, lab, gen):
            u = torch.rand((raw.shape[0], ctx.n_points), generator=gen,
                           device=gen.device, dtype=torch.float64)
            with ref_ops.precision("tf32"):
                out = infer(self.state, hands, raw.to(ctx.device), lab.to(ctx.device),
                            u, ctx.n_points)
            flat = {"class_logits": out["class_logits"]}
            for s in ("left", "right"):
                flat.update({f"{s}_{k}": v for k, v in out[s].items()})
            return flat

        return call

    def request(self, i: int):
        return self.requests[i % self.pool]

    def run_one(self) -> int:
        raw, lab = self.request(self.iters)
        cuda = self.ctx.device.type == "cuda"
        with torch.profiler.record_function("bench.request"):
            t = time.perf_counter()
            out = self.call(raw, lab, self.gen)
            if cuda:
                torch.cuda.synchronize()
            self.latencies.append(time.perf_counter() - t)
        keys = ["class_logits"] + [f"{s}_{k}" for s in ("left", "right")
                                   for k in HAND_KEYS + MESH_KEYS]
        self.outputs.append({k: out[k] for k in keys})
        self.iters += 1
        self.windows += raw.shape[0]
        return raw.shape[0]

    def e2e(self, elapsed_s: float) -> Dict[str, float]:
        return {"infer_windows_per_s": self.windows / elapsed_s,
                "infer_p95_ms": float(np.percentile(self.latencies, 95)) * 1e3}

    def head_modules(self):
        if self.ctx.control:
            return []
        return [self.pipe.net.left_mano_regressor, self.pipe.net.right_mano_regressor]

    def release(self) -> None:
        self.call = self.pipe = None
        common.free_device()

    def check(self) -> Dict[str, float]:
        ctx = self.ctx
        dev, B = ctx.device, ctx.batch
        hands = common.reference_hands(self.hand_arrays, ctx.config["mano"]["n_pose_comps"], dev)
        gen = ctx.generator("draws")
        gaps = compare.Gaps()
        per_call = max(1, int(ctx.mix["check_windows"]) // B)
        for r0 in range(0, self.iters, per_call):
            idx = range(r0, min(self.iters, r0 + per_call))
            u = torch.cat([torch.rand((B, ctx.n_points), generator=gen, device=gen.device,
                                      dtype=torch.float64) for _ in idx])
            raw = torch.cat([self.request(i)[0] for i in idx]).to(dev)
            lab = torch.cat([self.request(i)[1] for i in idx]).to(dev)
            record = []
            ref = infer(self.state, hands, raw, lab, u, ctx.n_points, record=record)
            pairs = torch.stack(record).reshape(len(record), len(idx), B).sum(-1)
            self.pair_counts += pairs.t().tolist()
            prog = {k: torch.cat([self.outputs[i][k] for i in idx]) for k in self.outputs[0]}
            gaps.add("class_logits", prog["class_logits"], ref["class_logits"])
            for s in ("left", "right"):
                for k in HAND_KEYS + MESH_KEYS:
                    gaps.add(f"{s}_{k}", prog[f"{s}_{k}"], ref[s][k])
        self.nonfinite = gaps.nonfinite
        return {
            "logits_gap": gaps.gap(["class_logits"]),
            "mano_gap": gaps.gap([f"{s}_{k}" for s in ("left", "right") for k in HAND_KEYS]),
            "mesh_gap": gaps.gap([f"{s}_{k}" for s in ("left", "right") for k in MESH_KEYS]),
        }

    def pairs(self, first: int, count: int):
        rows = self.pair_counts[first:first + count]
        return [sum(r[i] for r in rows) for i in range(len(rows[0]))] if rows else None
