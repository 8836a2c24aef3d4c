"""Limits of the test run under ``tests/``: a time limit on each test's
setup, call and teardown, PyTorch's share of the cores in each pytest-xdist
worker, and the ``slow`` marker with the tests that carry it.

``tests/conftest.py`` sets up JAX's virtual devices and the shared fixtures.
"""

import contextlib
import faulthandler
import hashlib
import os
import signal
import tempfile
import threading
import time

import pytest

# A little over twice the slowest test of the port with six test files
# running at a time; it holds each of a test's setup, call and teardown.
TEST_TIME_LIMIT_S = 420
# The slow set runs outside the tier-1 run, and two of its tests take longer
# than TEST_TIME_LIMIT_S even one at a time.
SLOW_TEST_TIME_LIMIT_S = 3600

# Frozen JAX-package tests too long for the tier-1 run, as (file under
# tests/, test). README, Tests, has the rule for this list; CHANGES.md
# (PR 18) has each one's seconds and what still runs its JAX path.
SLOW_TESTS = frozenset({
    ("test_dist.py", "test_dryrun_multichip_full_train_step"),
    ("test_event_parallel.py", "test_tehnet_event_sharded_full_model"),
    ("test_event_parallel.py", "test_tehnet_event_sharded_train_step"),
    ("test_model.py", "test_dense_train_full_model_matches_gather"),
    ("test_model.py", "test_uv_gather_full_model_train_step_close"),
})

# A copy of the stream that fd 2 is before capture takes it for a test, so
# that the backstop's dump is seen.
_stderr_fd = None


def pytest_configure(config):
    global _stderr_fd
    config.addinivalue_line(
        "markers",
        "slow: a frozen JAX-package test too long for the tier-1 run; "
        "run with -m slow (README, Tests)",
    )
    _stderr_fd = os.dup(2)
    # Each pytest-xdist worker's PyTorch takes its share of the cores.
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is not None:
        import torch

        torch.set_num_threads(max(1, os.cpu_count() // int(workers)))


def pytest_unconfigure(config):
    os.close(_stderr_fd)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    for item in items:
        if (item.path.name, getattr(item, "originalname", item.name)) in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@contextlib.contextmanager
def time_limit(seconds):
    """Fail the block with every thread's stack once it has run ``seconds``.

    SIGALRM reaches Python only between bytecodes, so a call stuck in native
    code never sees it. As a backstop, ``seconds + 60`` in, faulthandler
    writes the stacks to stderr and ends the process; pytest-xdist then
    reports the test as crashed and the run goes on. An exception raised
    inside ``subprocess.run`` kills the child as well. An enclosing limit
    goes on afterwards with the time it had left. Only the main thread
    takes signals: elsewhere the block runs without a limit.
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    stderr = 2 if _stderr_fd is None else _stderr_fd

    def on_alarm(signum, frame):
        with tempfile.TemporaryFile() as f:
            faulthandler.dump_traceback(f, all_threads=True)
            f.seek(0)
            stacks = f.read().decode(errors="replace")
        pytest.fail(f"ran past its time limit of {seconds} s\n{stacks}")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    start = time.monotonic()
    enclosing, _ = signal.setitimer(signal.ITIMER_REAL, seconds)
    faulthandler.dump_traceback_later(seconds + 60, exit=True, file=stderr)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)
        if enclosing:
            left = max(enclosing - (time.monotonic() - start), 1e-3)
            faulthandler.dump_traceback_later(left + 60, exit=True, file=stderr)
            signal.setitimer(signal.ITIMER_REAL, left)


def _limit(item):
    if item.get_closest_marker("slow") is not None:
        return SLOW_TEST_TIME_LIMIT_S
    return TEST_TIME_LIMIT_S


def _running_marker(item):
    """A file that stands while ``item`` runs under pytest-xdist, or None.

    A worker that the backstop ends leaves it behind. Under ``--dist
    loadfile`` pytest-xdist hands the crashed test to the replacement worker
    again, which finds the file and fails the test at once instead of
    hanging once more.
    """
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        return None
    digest = hashlib.sha1(item.nodeid.encode()).hexdigest()[:16]
    return os.path.join(tempfile.gettempdir(), f"pytest-running-{run}-{digest}")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    marker = _running_marker(item)
    if marker is not None:
        if os.path.exists(marker):
            pytest.fail("ended its worker at the time limit's backstop; not run again",
                        pytrace=False)
        open(marker, "w").close()
    with time_limit(_limit(item)):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with time_limit(_limit(item)):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    try:
        with time_limit(_limit(item)):
            return (yield)
    finally:
        marker = _running_marker(item)
        if marker is not None and os.path.exists(marker):
            os.remove(marker)
