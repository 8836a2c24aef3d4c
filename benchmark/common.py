"""What every loop of the benchmark shares: the files a cell is made of,
seeds, the program's configuration, the hands and the weights, and the
loop's base class.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its loop
(``loops/<kind>.py``), and ``limits/<cell>.json`` holds the limits of the
comparison that decides ``correct``. Everything is found by name: a new
cell is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

import generator

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_file() -> Dict:
    return load_json(ROOT, "BENCHMARK.json")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def derive_seed(seed: int, tag: str) -> int:
    """A seed for one stream of draws of a run seeded ``seed``."""
    words = [seed & 0xFFFFFFFF, seed >> 32] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


class Context:
    """One run of one cell: its configuration and mix (with any overrides,
    which the CPU tests use to shrink them), its seed and window, its device,
    and whether the control stands in the program's place."""

    def __init__(self, cell: Dict, seed: int, seconds: float, device="cuda",
                 control: bool = False,
                 model_overrides: Optional[Dict] = None,
                 mix_overrides: Optional[Dict] = None):
        self.cell = cell
        self.config = load_json(HERE, "configs", f"{cell['config']}.json")
        self.config["model"].update(model_overrides or {})
        self.mix = load_json(HERE, "traffic", f"{cell['traffic']}.json")
        self.mix.update(mix_overrides or {})
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.control = control

    @property
    def batch(self) -> int:
        return int(self.mix["batch"])

    @property
    def n_points(self) -> int:
        return int(self.config["model"]["n_points"])

    @property
    def sensor(self):
        s = self.config["sensor"]
        return s["width"], s["height"]

    def pool_iters(self) -> int:
        """Iterations whose inputs are made ahead: enough for the window at
        ``max_windows_per_s``, or for the traced segments; later ones reuse
        the pool from its start."""
        n = math.ceil(self.seconds * self.mix["max_windows_per_s"] / self.batch)
        return max(n, 4 * int(self.mix["trace_iters"]) + 2)

    def generator(self, tag: str) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, tag))


class Background:
    """``fn(*args)`` on a thread of this process (numpy's bulk work lets
    the GIL go), so the host makes inputs while the card is set up;
    ``result`` joins the thread and raises what it raised."""

    def __init__(self, fn, *args):
        self._out = self._err = None
        self._thread = threading.Thread(target=self._run, args=(fn,) + args, daemon=True)
        self._thread.start()

    def _run(self, fn, *args):
        try:
            self._out = fn(*args)
        except BaseException as e:     # re-raised by result()
            self._err = e

    def result(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._out


def program_config(config: Dict):
    """The program's ``Config`` of a configuration file."""
    from ev2hands_tpu_torch import config as pc

    c = pc.DEFAULT_CONFIG
    return c.replace(
        sensor=pc.SensorConfig(**config["sensor"]),
        model=pc.ModelConfig(**config["model"]),
        mano=pc.ManoConfig(**config["mano"]),
        loss=pc.LossConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in config["loss"].items()}),
        train=pc.TrainConfig(**config["train"]),
        camera=pc.CameraConfig(**config["camera"]))


def program_hands(arrays: Dict, n_pose: int, device):
    """The program's MANO constants of the benchmark's hands."""
    from ev2hands_tpu_torch.mano.layer import create_mano_params
    from ev2hands_tpu_torch.mano.model_data import ManoModelData

    return {side: create_mano_params(ManoModelData(side=side, **arrays[side]), n_pose,
                                     device=device)
            for side in ("left", "right")}


def reference_hands(arrays: Dict, n_pose: int, device):
    from reference import mano

    return {side: mano.hand(arrays[side], side, device, n_pose) for side in ("left", "right")}


def to_device(x, device):
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    return torch.as_tensor(x, device=device)


def free_device():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class LoopBase:
    """A cell's loop. ``setup`` builds the program from the seed, makes the
    inputs and warms up; ``run_one`` drives one request, batch or step
    through the program's entry point and returns the windows it
    completed; ``e2e`` turns the window's records into end-to-end metrics;
    ``release`` frees the program's state; ``check`` then runs the
    reference on what the timed path saw and returns the compared numbers.
    ``head_modules`` are the regressor heads (empty where there are none)."""

    kind = ""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.iters = 0
        self.windows = 0
        self.nonfinite = 0
        self.phases = []            # set-up's phases: [name, seconds]
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        """Close a phase of set-up."""
        t = time.perf_counter()
        self.phases.append([name, t - self._t])
        self._t = t

    def windows_for(self, tag: str, count: int) -> Dict:
        """``count`` windows of this run's ``tag`` stream of the mix."""
        ctx = self.ctx
        return generator.make_windows(derive_seed(ctx.seed, tag), count, ctx.mix, ctx.sensor,
                                      ctx.config["camera"]["yfov_deg"])

    def build_state(self):
        """The seeded weights and hands of this run."""
        from reference import mano, model

        ctx = self.ctx
        self.hand_arrays = mano.synthetic_hands(derive_seed(ctx.seed, "hands"))
        self.state = model.init_state(derive_seed(ctx.seed, "weights"), ctx.device,
                                      5 if ctx.config["model"]["erpc"] else 4)

    def setup(self) -> None:
        raise NotImplementedError

    def run_one(self) -> int:
        raise NotImplementedError

    def e2e(self, elapsed_s: float) -> Dict[str, float]:
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    def check(self) -> Dict[str, float]:
        raise NotImplementedError

    def head_modules(self):
        return []

    def pairs(self, first: int, count: int):
        """sa1's selected pairs by scale over iterations [first, first +
        count), from the reference's record (None where not recorded)."""
        return None
