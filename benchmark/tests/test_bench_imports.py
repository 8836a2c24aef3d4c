"""What the benchmark runs loads neither JAX nor the JAX package, and the
reference loads nothing of the program either. Each check runs in a fresh
interpreter and compares top-level module names whole (the program's
name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT

CHECK = r"""
import json, os, sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", CHECK.format(bench=BENCH, root=ROOT, body=body)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded("""
import glob
import run, common
for p in glob.glob(os.path.join(common.HERE, "loops", "*.py")):
    common.load_module(p, "loop_" + os.path.basename(p)[:-3])
for p in glob.glob(os.path.join(common.HERE, "metrics", "*.py")):
    common.load_module(p, "metric_" + os.path.basename(p)[:-3].replace(".", "_"))
import calibrate, faults
bench = common.benchmark_file()
cell = run.find_cell(bench, "stream-b8")
run.run_cell(cell, bench, 5, 0.2, False, "cpu", model_overrides={"n_points": 64},
             mix_overrides={"batch": 1, "events_per_window": 128, "max_windows_per_s": 1,
                            "trace_iters": 1, "check_windows": 1, "warmup": 1})
from ev2hands_tpu_torch import evaluate, train  # noqa: F401
""")
    assert "ev2hands_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "ev2hands_tpu"}, names


def test_reference_loads_nothing_of_the_program():
    names = loaded("import reference.step, reference.model, reference.ops, reference.mano")
    assert not names & {"jax", "jaxlib", "flax", "ev2hands_tpu", "ev2hands_tpu_torch"}, names
