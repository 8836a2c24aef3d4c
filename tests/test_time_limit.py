"""The per-test time limit and the ``slow`` list of the repo root's
``conftest.py``."""

import ast
import os
import signal
import subprocess
import sys
import time

import pytest

ROOT_CONFTEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conftest.py")


@pytest.fixture
def limits(request):
    """The repo root's conftest.py, as pytest loaded it."""
    return next(p for p in request.config.pluginmanager.get_plugins()
                if os.path.samefile(getattr(p, "__file__", None) or os.devnull,
                                    ROOT_CONFTEST))


def test_time_limit_fails_a_sleep_with_every_stack(limits):
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception) as failed:
        with limits.time_limit(1):
            time.sleep(5)
    assert time.monotonic() - start < 3
    message = str(failed.value)
    assert "ran past its time limit of 1 s" in message
    assert "Current thread" in message
    assert "test_time_limit_fails_a_sleep_with_every_stack" in message


def test_call_hook_gives_back_the_enclosing_limit(limits, request):
    """The call hook, driven by hand inside a 30 s limit inside this test's
    own: it arms the whole limit, and after a pass the 30 s limit goes on
    with what it had left, then this test's own limit, each with its
    handler."""
    own_handler = signal.getsignal(signal.SIGALRM)
    own_left = signal.getitimer(signal.ITIMER_REAL)[0]
    with limits.time_limit(30):
        handler = signal.getsignal(signal.SIGALRM)
        hook = limits.pytest_runtest_call(request.node)
        next(hook)
        assert 30 < signal.getitimer(signal.ITIMER_REAL)[0] <= limits.TEST_TIME_LIMIT_S
        with pytest.raises(StopIteration):
            hook.send(None)
        assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 30
        assert signal.getsignal(signal.SIGALRM) is handler
    assert 30 < signal.getitimer(signal.ITIMER_REAL)[0] <= own_left
    assert signal.getsignal(signal.SIGALRM) is own_handler


def test_time_limit_alone_leaves_no_timer():
    """In a fresh interpreter, with no enclosing limit: after a pass the
    timer is off and the old handler is back."""
    code = (
        "import importlib.util, signal, sys\n"
        "spec = importlib.util.spec_from_file_location('limits', sys.argv[1])\n"
        "limits = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(limits)\n"
        "with limits.time_limit(60):\n"
        "    assert signal.getitimer(signal.ITIMER_REAL)[0] > 0\n"
        "assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)\n"
        "assert signal.getsignal(signal.SIGALRM) is signal.SIG_DFL\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, ROOT_CONFTEST],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_every_test_runs_under_the_limit(limits):
    remaining = signal.getitimer(signal.ITIMER_REAL)[0]
    assert 0 < remaining <= limits.TEST_TIME_LIMIT_S


def test_a_test_that_ended_its_worker_is_not_run_again(limits, request, monkeypatch):
    monkeypatch.setenv("PYTEST_XDIST_TESTRUNUID", "test-time-limit")
    marker = limits._running_marker(request.node)
    open(marker, "w").close()
    try:
        hook = limits.pytest_runtest_setup(request.node)
        with pytest.raises(pytest.fail.Exception, match="not run again"):
            next(hook)
    finally:
        os.remove(marker)


def test_slow_tests_name_tests_that_exist(limits):
    """Every entry of SLOW_TESTS is a test function of its file."""
    tests = os.path.dirname(os.path.abspath(__file__))
    for file, name in limits.SLOW_TESTS:
        with open(os.path.join(tests, file)) as f:
            tree = ast.parse(f.read())
        assert any(isinstance(node, ast.FunctionDef) and node.name == name
                   for node in tree.body), (file, name)
