"""Faults planted in the program, to show that the check fails them.

Each fault patches one function of the program where its work is done and
returns a function that undoes the patch. ``calibrate.py --fault NAME``
reads a fault on the card; ``tests/test_bench_faults.py`` drives a run with
each fault on the CPU and sees ``correct`` come out false. The benchmark's
own runs plant nothing.

* ``state_unchanged``: the training step skips Adam's update, so the
  parameters keep their values.
* ``half_batch``: the training step drops the second half of its batch
  and takes its means over the rest.
* ``statistics_frozen``: BatchNorm's running statistics are never
  updated in training.
* ``loss_nonfinite_late``: from the fourth step after the fault is
  planted, the step's loss terms come back NaN: after the steps that the
  reference follows.
* ``answer_altered``: MANO's output gets a 1 mm shift on one vertex
  coordinate of every batch, where the model's answer is produced.
"""

from __future__ import annotations

from typing import Callable, Dict


def _patch(module, name: str, fn) -> Callable[[], None]:
    real = getattr(module, name)
    setattr(module, name, fn(real))
    return lambda: setattr(module, name, real)


def state_unchanged() -> Callable[[], None]:
    from ev2hands_tpu_torch import train

    def wrap(real):
        def finish_step(net, optimizer, loss, losses, device):
            step = optimizer.step
            optimizer.step = lambda *a, **k: None
            try:
                return real(net, optimizer, loss, losses, device)
            finally:
                optimizer.step = step
        return finish_step

    return _patch(train, "finish_step", wrap)


def half_batch() -> Callable[[], None]:
    from ev2hands_tpu_torch import train

    def half(x):
        if isinstance(x, dict):
            return {k: half(v) for k, v in x.items()}
        return x[:len(x) // 2]

    def wrap(real):
        def shard_step_inputs(mesh, batch, draws=None, noise=None):
            batch, draws, noise = real(mesh, batch, draws, noise)
            return half(batch), draws, noise
        return shard_step_inputs

    return _patch(train, "shard_step_inputs", wrap)


def statistics_frozen() -> Callable[[], None]:
    from ev2hands_tpu_torch.model import layers

    return _patch(layers.BatchNorm, "update_stats", lambda real: lambda self, mean, var: None)


def loss_nonfinite_late() -> Callable[[], None]:
    from ev2hands_tpu_torch import train

    calls = [0]

    def wrap(real):
        def finish_step(net, optimizer, loss, losses, device):
            out = real(net, optimizer, loss, losses, device)
            calls[0] += 1
            return {k: float("nan") for k in out} if calls[0] > 3 else out
        return finish_step

    return _patch(train, "finish_step", wrap)


def answer_altered() -> Callable[[], None]:
    # the entry points bind apply_mano by name when imported: import them
    # before the patch, so that each keeps the real function to go back to
    from ev2hands_tpu_torch import evaluate, serve, train
    from ev2hands_tpu_torch.model import tehnet

    def wrap(real):
        def apply_mano(hands, outputs):
            out = real(hands, outputs)
            v = out["right"]["vertices"].clone()
            v[0, 0, 0] += 1e-3
            out["right"] = dict(out["right"], vertices=v)
            return out
        return apply_mano

    undo = [_patch(tehnet, "apply_mano", wrap)]
    for m in (serve, evaluate, train):
        undo.append(_patch(m, "apply_mano", lambda real: tehnet.apply_mano))
    return lambda: [u() for u in reversed(undo)]


FAULTS: Dict[str, Callable[[], Callable[[], None]]] = {
    "state_unchanged": state_unchanged, "half_batch": half_batch,
    "statistics_frozen": statistics_frozen, "loss_nonfinite_late": loss_nonfinite_late,
    "answer_altered": answer_altered}
