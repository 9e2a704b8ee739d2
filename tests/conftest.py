"""Shared pytest config.

NOTE: no XLA device-count flags here — smoke tests and benches must see the
real single CPU device; only launch/dryrun.py (and the subprocess-based
integration tests) request 512/16 virtual devices, per the assignment.

The multi-device integration tests (marked ``slow``) run in subprocesses
and take a few minutes; they run by default and can be skipped with
``--skipslow`` for quick iteration.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "slow: long-running integration test")
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device (skips without one)")


def pytest_addoption(parser):
    parser.addoption("--skipslow", action="store_true", default=False,
                     help="skip slow multi-device integration tests")


def pytest_collection_modifyitems(config, items):
    if not config.getoption("--skipslow"):
        return
    skip = pytest.mark.skip(reason="--skipslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
