"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q`` from
the repository's root.  Tests marked ``card`` need a CUDA device and skip
without one, deciding inside the test."""

import importlib
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def small_constants(monkeypatch):
    """The harness's check and input sizes cut to the small cells."""
    from small_cells import SMALL_CONSTANTS
    for kind, consts in SMALL_CONSTANTS.items():
        mod = importlib.import_module(f"portbench.harness.{kind}")
        for name, value in consts.items():
            monkeypatch.setattr(mod, name, value)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")
