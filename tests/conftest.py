"""Shared test plumbing.

1. ``run_child`` — the subprocess runner for multi-device tests.  The host
   device count must be baked into XLA_FLAGS *before* jax initializes, so
   every multi-device test spawns a child interpreter; this helper owns the
   env handling (append to any inherited XLA_FLAGS instead of clobbering,
   replace a stale device-count flag, prepend src/ to PYTHONPATH) and the
   run-assert-parse-last-json-line protocol.  Also exposed as the
   ``subprocess_runner`` fixture for new tests.

2. Hypothesis fallbacks — ``given``/``settings``/``st`` stand-ins imported by
   test modules when ``hypothesis`` is not installed (minimal environments):
   property-based tests collect as skipped, deterministic tests run.
"""

import json
import os
import subprocess
import sys

import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

_DEVCOUNT_FLAG = "--xla_force_host_platform_device_count"


def child_env(devices: int) -> dict:
    """os.environ with the forced host device count and src/ importable."""
    env = dict(os.environ)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if not f.startswith(_DEVCOUNT_FLAG)]
    flags.append(f"{_DEVCOUNT_FLAG}={devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    tail = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = SRC + (os.pathsep + tail if tail else "")
    return env


def run_child(code: str, devices: int = 8, argv=(), timeout: int = 420) -> dict:
    """Run ``code`` in a fresh interpreter; return its last stdout line as JSON."""
    res = subprocess.run([sys.executable, "-c", code, *map(str, argv)],
                         capture_output=True, text=True,
                         env=child_env(devices), timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture
def subprocess_runner():
    return run_child


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (torch.cuda); skipped with a "
                   "reason where none is present")


# ---------------------------------------------------------------------------
# hypothesis fallbacks (imported via ``from conftest import given, ...`` in
# the except-ImportError branch of property-test modules)
# ---------------------------------------------------------------------------

def settings(*_a, **_kw):
    return lambda f: f


def given(*_a, **_kw):
    def deco(f):
        placeholder = lambda: None      # noqa: E731 - keeps original test id
        placeholder.__name__ = f.__name__
        placeholder.__doc__ = f.__doc__
        return pytest.mark.skip(reason="hypothesis not installed")(placeholder)
    return deco


class _StrategyStub:
    """st.* lookalike: decorator arguments evaluate, nothing ever draws."""

    def __getattr__(self, _name):
        return lambda *a, **k: None


st = _StrategyStub()
