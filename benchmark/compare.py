"""The numbers the comparison with the reference yields.

An output's gap is the largest absolute difference between the program's
value and the reference's, over every element compared, divided by the
largest absolute reference value of that output: a relative error that a
single wrong element moves. A non-finite program value makes the gap
infinite.

A training leaf's gap is ``| |p| - |r| | / max(|r|, median leaf |r|)``
for the norms of that leaf on the program's side and the reference's;
the worst leaf counts.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch


class Gaps:
    """Largest difference and largest reference magnitude by output name,
    accumulated over blocks; ``result`` groups outputs under a number."""

    def __init__(self):
        self.diff: Dict[str, float] = {}
        self.scale: Dict[str, float] = {}
        self.nonfinite = 0

    def add(self, name: str, prog: torch.Tensor, ref: torch.Tensor) -> None:
        prog, ref = prog.detach().float(), ref.detach().float().to(prog.device)
        if prog.shape != ref.shape:
            raise ValueError(f"{name}: program {tuple(prog.shape)} vs reference {tuple(ref.shape)}")
        bad = ~torch.isfinite(prog)
        if bool(bad.any()):
            self.nonfinite += int(bad.sum())
            d = math.inf
        else:
            d = float((prog - ref).abs().max()) if prog.numel() else 0.0
        self.diff[name] = max(self.diff.get(name, 0.0), d)
        self.scale[name] = max(self.scale.get(name, 0.0),
                               float(ref.abs().max()) if ref.numel() else 0.0)

    def gap(self, names: Iterable[str]) -> float:
        """The worst relative gap of ``names``."""
        worst = 0.0
        for n in names:
            s = self.scale.get(n, 0.0)
            d = self.diff.get(n, math.inf)
            worst = max(worst, d / s if s > 0 else (0.0 if d == 0 else math.inf))
        return worst


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> float:
    """Worst ``| |p| - |r| | / max(|r|, median |r|)`` over the leaves
    ``keep`` (default all) of two dicts of leaf norms."""
    names = sorted(keep if keep is not None else ref)
    if not names:
        return 0.0
    vals = sorted(ref[n] for n in names)
    median = vals[len(vals) // 2]
    worst = 0.0
    for n in names:
        p = prog.get(n, math.nan)
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - ref[n]) / max(ref[n], median, 1e-30))
    return worst


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keep: Optional[Iterable[str]] = None) -> float:
    """The median over the leaves ``keep`` (default all) of
    ``| |p| - |r| | / max(|r|, median |r|)``: a reading that one leaf's
    noise does not move."""
    names = sorted(keep if keep is not None else ref)
    vals = sorted(ref[n] for n in names)
    median = vals[len(vals) // 2]
    gaps = sorted(abs(prog.get(n, math.inf) - ref[n]) / max(ref[n], median, 1e-30)
                  for n in names)
    return gaps[len(gaps) // 2]


def moving_leaves(grad_norms: Dict[str, float], rel: float = 1e-3):
    """The leaves whose reference gradient norm is at least ``rel`` of the
    median leaf's: the others (biases whose shift a training-mode BatchNorm
    removes) move under Adam by rounding alone."""
    vals = sorted(grad_norms.values())
    median = vals[len(vals) // 2]
    return [n for n, v in grad_norms.items() if v >= rel * median]
