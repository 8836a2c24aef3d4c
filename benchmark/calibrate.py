"""The readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        --seconds 30 [--first-seed N] [--fault NAME] [--serve-flags] \
        [--config C --traffic T] [--out chiprun_out/calibrate.jsonl]

Runs the cell's timed path and its check in one process for each of
``--seeds`` seeds (the program's readings: the lower ones), then the
control for ``--control-seeds`` seeds: the reference in TF32 put in the
program's place, the same check against the float32 reference (the upper
readings). ``--fault NAME`` plants a fault of ``faults.py`` in the program
for every run, whose readings are then upper ones too. ``--serve-flags``
imports the program's ``serve.py`` first, which turns TF32 off for the
process as serving does: run beside a plain calibration on the same seeds,
it shows what an entry point's own precision changes. A cell that
``BENCHMARK.json`` does not list is named by ``--config`` and ``--traffic``.
Each run is one JSON line (in ``--out`` too); the last line gives each
number's largest program reading and smallest control reading. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import run  # noqa: E402  (sets the cache directories first)
import torch  # noqa: E402
import common  # noqa: E402
import faults  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--fault", default="", choices=[""] + sorted(faults.FAULTS))
    ap.add_argument("--serve-flags", action="store_true")
    ap.add_argument("--config", default="")
    ap.add_argument("--traffic", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.serve_flags:
        import ev2hands_tpu_torch.serve  # noqa: F401  (sets the TF32 flags)
    if args.fault:
        faults.FAULTS[args.fault]()
    bench = common.benchmark_file()
    if args.config and args.traffic:
        cell = {"name": args.workload, "config": args.config, "traffic": args.traffic,
                "chips": 1}
    else:
        cell = run.find_cell(bench, args.workload)
    out = open(args.out, "a") if args.out else None
    lower, upper = {}, {}
    plan = ([(args.first_seed + i, False) for i in range(args.seeds)]
            + [(args.first_seed + 1000 + i, True) for i in range(args.control_seeds)])
    for seed, control in plan:
        t = time.perf_counter()
        res = run.run_cell(cell, bench, seed, args.seconds, False, "cuda", control=control,
                           limits={})
        line = {"workload": cell["name"], "seed": seed, "control": control,
                "fault": args.fault, "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                "readings": res["readings"], "metrics": res["metrics"],
                "attempted": res["attempted"], "setup_phases": res["setup_phases"],
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        high = control or bool(args.fault)    # a control's or a fault's reading
        side = upper if high else lower
        for k, v in res["readings"].items():
            side[k] = (min if high else max)(side.get(k, v), v)
    summary = {"workload": cell["name"], "fault": args.fault, "lower": lower, "upper": upper,
               "ratio": {k: upper[k] / lower[k] if lower.get(k) else None for k in upper}}
    print(json.dumps(summary))
    if out:
        out.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
