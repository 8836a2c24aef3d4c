"""Training checkpoints: save-on-best and resume, on ``torch.save``.

Counterpart of ``NativeCheckpointer`` in ``ev2hands_tpu/checkpoint.py``. One
entry ``step_{step:09d}.pt`` in the checkpoint directory holds:
  * 'model': TEHNet's state dict, with the reference's names (those that
    ``weights.py`` emits and ``TEHNet`` loads with ``strict=True``);
  * 'optimizer': the Adam ``state_dict()`` (moments and step counts);
  * 'step': the number of steps taken;
  * 'max_eval_score': the best evaluation score so far.

Saves are asynchronous, as in the JAX package: ``save`` copies every tensor
to host memory and returns, and a thread writes the entry to a temporary
name and renames it, so ``latest_step`` never sees a partial file. At most
one save is in flight: ``save``, ``wait``, ``latest_step`` and ``restore``
join the previous one first. The JAX package's orbax checkpoints are not
read (that needs orbax); its ``.pth`` format is (``load_model_state``).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional

import torch

_ENTRY = re.compile(r"step_(\d+)\.pt")


def _to_host(obj: Any) -> Any:
    """``obj`` with every tensor copied to host memory (a copy also of CPU
    tensors: a training step changes the live ones in place)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class Checkpointer:
    """Numbered checkpoint entries in ``directory`` (created if missing)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def save(self, step: int, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None,
             max_eval_score: float = float("-inf")) -> None:
        """Stage the model's and the optimizer's state to the host, then
        write them on a thread."""
        self.wait()
        blob = _to_host({
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict() if optimizer is not None else None,
            "step": int(step),
            "max_eval_score": float(max_eval_score),
        })
        self._thread = threading.Thread(target=self._write,
                                        args=(blob, self.path(step)), daemon=True)
        self._thread.start()

    def _write(self, blob: Dict, path: str) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(blob, tmp)
            os.replace(tmp, path)
        except Exception as e:  # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Join the save in flight, if any; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = [int(m.group(1)) for name in os.listdir(self.directory)
                 if (m := _ENTRY.fullmatch(name))]
        return max(steps) if steps else None

    def restore(self, step: int) -> Dict[str, Any]:
        """The entry of ``step`` as saved, every tensor on the CPU. Load
        'optimizer' into an optimizer whose parameters are already on their
        device: ``Optimizer.load_state_dict`` moves the state to them."""
        self.wait()
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore_into(self, model: torch.nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None,
                     step: Optional[int] = None) -> Dict[str, Any]:
        """Load the latest entry (or ``step``'s) into ``model`` and
        ``optimizer``; -> the entry. Raises FileNotFoundError when there is
        none."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        blob = self.restore(step)
        model.load_state_dict(blob["model"], strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(blob["optimizer"])
        return blob


def load_model_state(path: str) -> Dict[str, torch.Tensor]:
    """TEHNet's state dict from a reference ``.pth`` file or from the latest
    entry of a port checkpoint directory (CPU tensors)."""
    if path.endswith(".pth"):
        from ev2hands_tpu_torch.weights import load_pth_state_dict

        return load_pth_state_dict(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: neither a .pth file nor a checkpoint "
                                "directory")
    ckptr = Checkpointer(path)
    step = ckptr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    return ckptr.restore(step)["model"]
