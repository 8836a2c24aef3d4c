"""Tests of the benchmark. They import neither JAX nor the JAX package.

The CPU tests run the harness at small sizes (``small_run``); the tests
marked ``cuda`` need the card and skip without one, decided inside a
fixture."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# a size a CPU test can hold: 256 ERPC points, 512 events a window
SMALL_MODEL = {"n_points": 256}
SMALL_MIX = {"events_per_window": 512, "max_windows_per_s": 2, "trace_iters": 2,
             "check_windows": 8, "warmup": 1}

# cells whose files the benchmark keeps but that BENCHMARK.json does not
# list yet: the evaluation and training entry points run cuDNN's
# convolutions in TF32 (PERF.md, Open questions); their loops, limits and
# faults are tested here all the same
UNLISTED = {"eval-s-b32": {"name": "eval-s-b32", "config": "tehnet-erpc-eval",
                           "traffic": "eval-s-b32", "chips": 1},
            "train-b8": {"name": "train-b8", "config": "tehnet-erpc", "traffic": "train-b8",
                         "chips": 1}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def small_run(cell_name, batch=2, seed=2 ** 31 + 5, control=False, trace=False):
    """One run of a cell on the CPU at a small size, with the cell's limits."""
    import torch

    import common
    import run

    torch.set_num_threads(4)
    bench = common.benchmark_file()
    listed = {c["name"]: c for c in bench["workloads"]}
    cell = listed[cell_name] if cell_name in listed else UNLISTED[cell_name]
    return run.run_cell(cell, bench, seed, 0.5, trace, "cpu", control=control,
                        model_overrides=SMALL_MODEL, mix_overrides=dict(SMALL_MIX, batch=batch))
