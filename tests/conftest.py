import faulthandler
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))          # prop / md_helper


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-device subprocess tests and the aggregate_sort "
        "argsort cross-check oracles (CI fast tier runs -m 'not slow'; "
        "a plain local `python -m pytest` still runs everything)")
    config.addinivalue_line(
        "markers",
        "card: needs a CUDA card (a hand-written kernel with no CPU "
        "build); skips with a reason where torch sees none. On the card: "
        "`python -m pytest -m card tests/`")
    config.addinivalue_line(
        "markers",
        "timeout(seconds): hard wall-clock limit for the test call. "
        "Required on every test that starts threads (the serve engine's "
        "ingest/device loops): a deadlocked queue join would otherwise "
        "hang the whole suite. Implemented with "
        "faulthandler.dump_traceback_later (pytest-timeout is not a "
        "dependency): on expiry every thread's traceback is dumped and "
        "the process exits hard.")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    marker = item.get_closest_marker("timeout")
    if marker is not None:
        seconds = float(marker.args[0]) if marker.args else 300.0
        faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        if marker is not None:
            faulthandler.cancel_dump_traceback_later()
