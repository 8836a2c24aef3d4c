"""Offline scoring of a checkpoint on Ev2Hands-S, as ``evaluate.py`` runs
it.

The benchmark writes its windows as Ev2Hands-S rows in memory (x, y, t, p,
annotation, label; one annotation a window) and the loop reads them
through ``Ev2HandSReader.from_rows(...).batches(batch, shuffle=False)``:
each batch pays its host reads. ``evaluate.make_full_eval_step`` runs it
with one generator for the whole pass (the ERPC resample draws), and the
host accumulates PCK, MPJPE and MPVPE as ``evaluate_dataset`` does. End to
end: windows scored over the window's seconds.

The check runs the reference on every batch of the window and compares the
predicted joints and vertices and the ground truth's, in mm, that the step
recomputes from the annotations.
"""

from __future__ import annotations

from typing import Dict

import torch

import common
import compare
import generator
from reference import ops as ref_ops
from reference.step import gt_mm, infer


class Loop(common.LoopBase):
    kind = "eval"

    def setup(self) -> None:
        ctx = self.ctx
        B, dev = ctx.batch, ctx.device
        self.warm = int(ctx.mix["warmup"])
        # a reader's window starts wrap at (windows - 1) * E: one spare window
        # keeps every batch on whole windows
        self.n_main = B * ctx.pool_iters() + 1
        main = common.Background(self._reader, "data", self.n_main)
        warm_reader, _ = self._reader("data-warmup", B * self.warm + 1)
        self.build_state()
        n_pose = ctx.config["mano"]["n_pose_comps"]
        from ev2hands_tpu_torch.metrics import PckAccumulator, mpjpe, mpvpe

        self.mpjpe, self.mpvpe = mpjpe, mpvpe
        if ctx.control:
            self.step = self._control(common.reference_hands(self.hand_arrays, n_pose, dev))
        else:
            from ev2hands_tpu_torch.evaluate import make_full_eval_step
            from ev2hands_tpu_torch.model.tehnet import TEHNet

            pcfg = common.program_config(ctx.config)
            self.net = TEHNet(pcfg.model, device=dev)
            self.net.load_state_dict(self.state, strict=True)
            self.step = make_full_eval_step(
                self.net, common.program_hands(self.hand_arrays, n_pose, dev), pcfg, dev)
        self.mark("weights and program")
        self.acc = PckAccumulator(num_steps=50, dist_max_mm=50.0)
        self.sums = [0.0, 0.0]
        warm_gen = ctx.generator("warmup")
        warm_batches = warm_reader.batches(B, shuffle=False)
        for _ in range(self.warm):
            self._score(self.step(next(warm_batches), warm_gen))
        self.acc = PckAccumulator(num_steps=50, dist_max_mm=50.0)
        self.sums = [0.0, 0.0]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.mark("warm-up")
        reader, self.main = main.result()
        self.mark("inputs")
        self.batches = reader.batches(B, shuffle=False)
        self.gen = ctx.generator("draws")
        self.outputs, self.pair_counts = [], []

    def _reader(self, tag: str, count: int):
        """(a reader over ``count`` windows written as Ev2Hands-S rows, the
        windows)."""
        from ev2hands_tpu_torch.events.streams import Ev2HandSReader

        win = self.windows_for(tag, count)
        return Ev2HandSReader.from_rows(*generator.rows(win),
                                        n_events=int(self.ctx.mix["events_per_window"])), win

    def _control(self, hands):
        """The reference in TF32 in the program's place."""
        ctx = self.ctx

        def step(batch, gen):
            b = common.to_device(batch, ctx.device)
            u = torch.rand((b["events"].shape[0], ctx.n_points), generator=gen,
                           device=gen.device, dtype=torch.float64)
            with ref_ops.precision("tf32"):
                out = infer(self.state, hands, b["events"], b["labels"], u, ctx.n_points)
                gt = gt_mm(hands, b)
            pred = {k: torch.stack([out["left"][k], out["right"][k]], 1) * 1000
                    for k in ("j3d", "vertices")}
            return pred["j3d"], gt["j3d"], pred["vertices"], gt["vertices"]

        return step

    def _score(self, out):
        pj, gj, pv, gv = out
        self.acc.update(pj, gj)
        self.sums[0] += float(self.mpjpe(pj, gj).sum())
        self.sums[1] += float(self.mpvpe(pv, gv).sum())

    def run_one(self) -> int:
        with torch.profiler.record_function("bench.read_batch"):
            batch = next(self.batches)
        with torch.profiler.record_function("bench.step"):
            out = self.step(batch, self.gen)
        with torch.profiler.record_function("bench.scores"):
            self._score(out)
        self.outputs.append(out)
        self.iters += 1
        self.windows += out[0].shape[0]
        return out[0].shape[0]

    def e2e(self, elapsed_s: float) -> Dict[str, float]:
        return {"infer_windows_per_s": self.windows / elapsed_s}

    def head_modules(self):
        if self.ctx.control:
            return []
        return [self.net.left_mano_regressor, self.net.right_mano_regressor]

    def release(self) -> None:
        self.step = self.net = None
        common.free_device()

    def window_ids(self, k: int):
        """The main windows of batch k: the reader's starts (k B + j) E,
        wrapped at (windows - 1) E."""
        B = self.ctx.batch
        return [(k * B + j) % (self.n_main - 1) for j in range(B)]

    def check(self) -> Dict[str, float]:
        ctx = self.ctx
        dev, B = ctx.device, ctx.batch
        hands = common.reference_hands(self.hand_arrays, ctx.config["mano"]["n_pose_comps"], dev)
        gen = ctx.generator("draws")
        gaps = compare.Gaps()
        per_call = max(1, int(ctx.mix["check_windows"]) // B)
        names = ("pred_j3d", "gt_j3d", "pred_vertices", "gt_vertices")
        for k0 in range(0, self.iters, per_call):
            ks = range(k0, min(self.iters, k0 + per_call))
            u = torch.cat([torch.rand((B, ctx.n_points), generator=gen, device=gen.device,
                                      dtype=torch.float64) for _ in ks])
            ids = [w for k in ks for w in self.window_ids(k)]
            b = common.to_device(generator.batch(self.main, ids), dev)
            record = []
            out = infer(self.state, hands, b["events"], b["labels"], u, ctx.n_points,
                        record=record)
            pairs = torch.stack(record).reshape(len(record), len(ks), B).sum(-1)
            self.pair_counts += pairs.t().tolist()
            gt = gt_mm(hands, b)
            ref = (torch.stack([out["left"]["j3d"], out["right"]["j3d"]], 1) * 1000, gt["j3d"],
                   torch.stack([out["left"]["vertices"], out["right"]["vertices"]], 1) * 1000,
                   gt["vertices"])
            for i, name in enumerate(names):
                gaps.add(name, torch.cat([self.outputs[k][i] for k in ks]), ref[i])
        self.nonfinite = gaps.nonfinite
        return {"joints_gap": gaps.gap(["pred_j3d"]), "verts_gap": gaps.gap(["pred_vertices"]),
                "gt_gap": gaps.gap(["gt_j3d", "gt_vertices"])}

    def pairs(self, first: int, count: int):
        rows = self.pair_counts[first:first + count]
        return [sum(r[i] for r in rows) for i in range(len(rows[0]))] if rows else None
