"""Run logging: a timestamped run directory with the log, the config, the
model and the scalars, and TensorBoard scalars on request.

Counterpart of ``ev2hands_tpu/utils/logging.py``: ``{base_dir}/{name}_{stamp}``
holds ``log.txt`` (also echoed to stdout), ``config.json``, ``model.txt``
and ``scalars.jsonl`` (one ``{"tag", "value", "step"}`` line per scalar).
With ``tensorboard=True`` the scalars also go to TensorBoard event files
under ``tb/``. That is opt-in: importing ``torch.utils.tensorboard`` can
take seconds (it may pull in TensorFlow).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
import sys


class RunLogger:
    def __init__(self, name: str, base_dir: str = "runs", tensorboard: bool = False):
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self.run_dir = os.path.join(base_dir, f"{name}_{stamp}")
        # a second run started in the same second gets a directory of its own
        for i in range(1, 1000):
            try:
                os.makedirs(self.run_dir)
                break
            except FileExistsError:
                self.run_dir = os.path.join(base_dir, f"{name}_{stamp}_{i}")
        self._logger = logging.getLogger(f"ev2hands_torch.{name}.{self.run_dir}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        fmt = logging.Formatter("[%(asctime)s] %(message)s")
        for handler in (logging.FileHandler(os.path.join(self.run_dir, "log.txt")),
                        logging.StreamHandler(sys.stdout)):
            handler.setFormatter(fmt)
            self._logger.addHandler(handler)
        self._tb = None
        if tensorboard:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(self.run_dir, "tb"))

    def info(self, msg: str):
        self._logger.info(msg)

    def scalar(self, tag: str, value: float, step: int):
        with open(os.path.join(self.run_dir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps({"tag": tag, "value": value, "step": step}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def log_run_config(self, cfg, net=None):
        """The whole config tree as ``config.json`` and, given ``net``, its
        ``repr`` as ``model.txt``, so a run can be rebuilt from its
        directory."""
        def as_dict(obj):
            if dataclasses.is_dataclass(obj):
                return {f.name: as_dict(getattr(obj, f.name))
                        for f in dataclasses.fields(obj)}
            return obj

        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(as_dict(cfg), f, indent=2, default=str)
        if net is not None:
            with open(os.path.join(self.run_dir, "model.txt"), "w") as f:
                f.write(repr(net))
        self.info(f"run config recorded in {self.run_dir}/config.json")

    def close(self):
        """Flush and release the log file and the TensorBoard writer."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        for handler in list(self._logger.handlers):
            handler.close()
            self._logger.removeHandler(handler)
