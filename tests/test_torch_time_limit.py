"""The port tests' guard (``torch_port_util.module_time_limit`` / ``time_limit``).

A stall in a module fixture's set-up (before the first test or between two
tests) or teardown, or in a test, fails that module's tests with every
thread's stack printed; a thread that outlives its module fails it too; and
a run under ``-p xdist --dist loadfile`` goes on to its end with no worker
down. A main thread stuck in C code past the grace exits the process. Each
case runs pytest on a few small files in a subprocess.
"""

import os
import subprocess
import sys
import textwrap
import time
import xml.etree.ElementTree as ET
from pathlib import Path

from torch_port_util import module_time_limit, time_limit  # noqa: F401

TIME_LIMIT_S = 180  # each test's own limit (torch_port_util.time_limit)

HEADER = """
import signal
import time

import pytest

from torch_port_util import module_time_limit, time_limit  # noqa: F401

TIME_LIMIT_S = 2
"""

FILES = {
    "test_a_setup_stall.py": """
@pytest.fixture(scope="module")
def slow():
    time.sleep(60)

def test_one(slow):
    pass

def test_two(slow):
    pass
""",
    "test_b_test_stall.py": """
def test_stalls():
    time.sleep(60)

def test_after():
    pass
""",
    "test_c_teardown_stall.py": """
@pytest.fixture(scope="module")
def slow_teardown():
    yield
    time.sleep(60)

def test_uses(slow_teardown):
    pass
""",
    "test_e_lazy_fixture.py": """
def test_first():
    pass

@pytest.fixture(scope="module")
def slow():
    time.sleep(60)

def test_second(slow):
    pass
""",
    "test_g_leaves_a_thread.py": """
import threading

TIME_LIMIT_S = 30  # past the 10 s the module's end waits for its threads

def test_starts_a_thread():
    threading.Thread(target=time.sleep, args=(60,), name="sleeper", daemon=True).start()
""",
    "test_d_quick.py": """
@pytest.mark.parametrize("i", range(3))
def test_quick(i):
    time.sleep(0.2)
""",
}


def _pytest(tmp_path, args, files, timeout):
    for name, body in files.items():
        (tmp_path / name).write_text(textwrap.dedent(HEADER) + textwrap.dedent(body))
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parent))
    start = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         f"--junitxml={tmp_path / 'junit.xml'}", *args, *files],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=timeout)
    return out, time.monotonic() - start


def _outcomes(junit):
    """{test name: sorted outcomes} from a junit file ("passed" when none)."""
    got = {}
    for case in ET.parse(junit).getroot().iter("testcase"):
        kinds = sorted(c.tag for c in case if c.tag in ("failure", "error", "skipped"))
        got.setdefault(f"{case.get('classname')}.{case.get('name')}", []).extend(kinds or ["passed"])
    return {k: sorted(v) for k, v in got.items()}


def test_stalls_fail_their_module_and_the_run_goes_on(tmp_path):
    out, seconds = _pytest(tmp_path, ["-p", "xdist", "-n", "2", "--dist", "loadfile"], FILES,
                           timeout=90)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "node down" not in out.stdout + out.stderr
    assert seconds < 45
    assert _outcomes(tmp_path / "junit.xml") == {
        "test_a_setup_stall.test_one": ["error"],
        "test_a_setup_stall.test_two": ["error"],
        "test_b_test_stall.test_stalls": ["failure"],
        "test_b_test_stall.test_after": ["passed"],
        "test_c_teardown_stall.test_uses": ["error"],  # passed, then its teardown
        "test_e_lazy_fixture.test_first": ["passed"],
        "test_e_lazy_fixture.test_second": ["error"],
        "test_g_leaves_a_thread.test_starts_a_thread": ["error"],  # passed, then its module's end
        **{f"test_d_quick.test_quick[{i}]": ["passed"] for i in range(3)},
    }
    assert "test_g_leaves_a_thread.py left running: thread sleeper (Thread)" in out.stdout
    said = out.stdout + out.stderr
    for what in ("module set-up of test_a_setup_stall.py", "test_b_test_stall.py::test_stalls",
                 "module fixtures after test_c_teardown_stall.py::test_uses",
                 "module fixtures after test_e_lazy_fixture.py::test_first"):
        assert f"{what} exceeded its 2 s time limit" in said
    assert 'in slow\n' in said and 'in test_stalls\n' in said and 'in slow_teardown\n' in said


def test_a_main_thread_stuck_in_c_exits_after_the_grace(tmp_path):
    """SIGALRM blocked stands for a main thread that never returns to Python."""
    body = """
import torch_port_util

torch_port_util.GRACE_S = 1

def test_blocked():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(60)
"""
    out, seconds = _pytest(tmp_path, [], {"test_f_blocked.py": body}, timeout=60)
    assert out.returncode != 0 and seconds < 30
    assert "Timeout (0:00:03)!" in out.stderr and "in test_blocked" in out.stderr
