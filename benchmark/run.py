"""The benchmark of the PyTorch/CUDA port, one cell a process.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``. The run builds
the program and its inputs from the seed, warms up every shape the cell
uses (all of it counted as ``setup_s``), then measures: with ``--trace 0``
it drives the cell's loop for ``--seconds`` and reports the cell's
end-to-end metrics; with ``--trace 1`` it drives traced segments
(``tracing.py``) and reports the cell's per-layer metrics. Once the window
has closed and the peak memory is read, the program's state is freed and
the plain reference (``reference/``) is run on what the timed path saw;
``correct`` says whether every compared number is within its limit
(``limits/<cell>.json``). The last line of standard output is the result
as one JSON object; the compared numbers and their limits are the last
lines of standard error and the last key of that object.

The run needs as many CUDA devices as the cell asks for, and exits with a
code other than 0, printing no result, without them, without the program
beside the benchmark, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache of the program at a fixed place in the checkout,
# Python's compiled modules too: an environment that writes no bytecode, or
# an installation whose own caches cannot be written, would otherwise
# compile every module it imports in every run
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
sys.dont_write_bytecode = False
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]

import torch  # noqa: E402

import common  # noqa: E402
import tracing  # noqa: E402
from reference import ops as ref_ops  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ev2hands_tpu")


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's or the JAX
    package's (names compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def find_cell(bench, name):
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")


def _for_cell(metrics, cell):
    return [m for m in metrics if "workloads" not in m or cell["name"] in m["workloads"]]


def load_loop(ctx):
    path = os.path.join(HERE, "loops", f"{ctx.mix['loop']}.py")
    return common.load_module(path, f"bench_loop_{ctx.mix['loop']}").Loop(ctx)


def run_cell(cell, bench, seed, seconds, trace=False, device="cuda", t0=None,
             control=False, model_overrides=None, mix_overrides=None, limits=None):
    """One run of ``cell`` -> the result object (``checks`` last)."""
    t0 = time.perf_counter() if t0 is None else t0
    ctx = common.Context(cell, seed, seconds, device, control, model_overrides, mix_overrides)
    cuda = ctx.device.type == "cuda"
    loop = load_loop(ctx)
    loop.setup()
    setup_s = time.perf_counter() - t0
    if not trace:
        if cuda:
            torch.cuda.synchronize()
        start = time.perf_counter()
        while time.perf_counter() - start < ctx.seconds:
            loop.run_one()
        if cuda:
            torch.cuda.synchronize()
        e2e = dict(loop.e2e(time.perf_counter() - start), setup_s=setup_s)
    else:
        tr = tracing.Trace(loop.kind, ctx.config["model"], ctx.batch)
        n = int(ctx.mix["trace_iters"])

        def segment():
            w0 = loop.windows
            for _ in range(n):
                loop.run_one()
            return loop.windows - w0

        w0 = loop.windows
        tr.plain_s = tracing.timed(segment, ctx.device)
        tr.plain_windows = loop.windows - w0
        first, w0 = loop.iters, loop.windows
        tracing.device_profiled(segment, tr, ctx.device)
        tr.iters, tr.windows = n, loop.windows - w0
        tracing.host_profiled(segment, tr, ctx.device)
        heads = loop.head_modules()
        if heads and cuda:
            close = tracing.head_hooks(heads, tr)
            tr.heads_windows = segment()
            close()
        if loop.kind == "train" and cuda:
            tr.sync_sites = tracing.host_syncs(loop.run_one)
            tr.syncs, tr.sync_steps = sum(tr.sync_sites.values()), 1
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
                   "count": int(cell.get("chips", 1)),
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(ctx.device))
                   if cuda else 0}
    attempted = loop.iters
    loop.release()
    with ref_ops.precision("float32"):
        checks = loop.check()
    if limits is None:
        path = os.path.join(HERE, "limits", f"{cell['name']}.json")
        limits = common.load_json(path)["limits"] if os.path.exists(path) else {}
    # the readings that have a limit are compared; the others are reported
    readings = {k: v for k, v in checks.items() if k not in limits}
    checks = {k: v for k, v in checks.items() if k in limits}
    result = {"correct": bool(loop.nonfinite == 0 and checks and all(
        v <= limits[k] for k, v in checks.items())),
        "attempted": attempted, "failed": 0, "setup_phases": loop.phases}
    if trace:
        tr.pairs = loop.pairs(first, n)
        tr.device_name = device_info["kind"]
        metrics = {}
        for m in _for_cell(bench["per_layer"], cell):
            mod = common.load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                                     "bench_metric_" + m["name"].replace(".", "_"))
            value = mod.read(tr)
            if value is None:
                print(f"run.py: metric {m['name']} found nothing to read", file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["metrics"] = metrics
        result["device"] = device_info
        result["breakdown"] = tr.breakdown()
        if tr.sync_sites:
            result["sync_sites"] = tr.sync_sites
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in _for_cell(bench["end_to_end"], cell)}
        result["device"] = device_info
    # a non-finite reading prints as the largest float, so the line stays JSON
    def finite(v):
        return v if math.isfinite(v) else 1.7976931348623157e308

    result["readings"] = {k: finite(v) for k, v in readings.items()}
    result["checks"] = {k: {"value": finite(v), "limit": limits[k]} for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = common.benchmark_file()
    cell = find_cell(bench, args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        import ev2hands_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"run.py: the program is not beside the benchmark: {e}", file=sys.stderr)
        return 2
    seed = args.seed % 2 ** 64
    result = run_cell(cell, bench, seed, args.seconds, bool(args.trace), "cuda", t0=T0)
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
