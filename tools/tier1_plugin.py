"""A pytest plugin that logs when and where each test ran, for
``tools/tier1_times.py``.

Load it with ``-p`` and name the log in ``TIER1_TIMES_LOG``, e.g. from the
root of the repository::

    TIER1_TIMES_LOG=/tmp/t1_times.jsonl PYTHONPATH=tools \\
        python -m pytest tests/ -p xdist -n 6 --dist loadfile \\
        --junitxml=/tmp/t1.xml -p tier1_plugin

Under xdist only the controller writes: one JSON line when the session
starts (``{"event": "start", "t": epoch}``), one with the collected test
ids (``{"event": "collected", "ids": [...]}``), and one for each phase report
(``setup``, ``call``, ``teardown``) of each test, with its node id, worker
(``report.node.gateway.id``; ``"main"`` without xdist), outcome, duration
and the epoch seconds at which the phase started and ended on the worker.
Lines are flushed as they come, so a run cut by ``timeout`` keeps what it
reached.  Without ``TIER1_TIMES_LOG`` the plugin does nothing.
"""

from __future__ import annotations

import json
import os
import time

import pytest

_LOG = None
_COLLECTED = False


def _is_worker(config) -> bool:
    return hasattr(config, "workerinput")


def _write(entry: dict) -> None:
    if _LOG is not None:
        _LOG.write(json.dumps(entry) + "\n")
        _LOG.flush()


def pytest_sessionstart(session):
    global _LOG
    path = os.environ.get("TIER1_TIMES_LOG")
    if path and not _is_worker(session.config):
        _LOG = open(path, "a")
        _write({"event": "start", "t": time.time()})


def pytest_collection_finish(session):
    if not _is_worker(session.config) and session.items:
        _write({"event": "collected", "ids": [i.nodeid for i in session.items]})


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_node_collection_finished(node, ids):
    global _COLLECTED
    if not _COLLECTED:
        _COLLECTED = True
        _write({"event": "collected", "ids": list(ids)})


def pytest_runtest_logreport(report):
    node = getattr(report, "node", None)
    worker = node.gateway.id if node is not None else "main"
    _write({
        "event": "report",
        "nodeid": report.nodeid,
        "when": report.when,
        "outcome": report.outcome,
        "worker": worker,
        "duration": report.duration,
        "start": getattr(report, "start", None),
        "stop": getattr(report, "stop", None),
        "t": time.time(),
    })


def pytest_sessionfinish(session):
    global _LOG
    if _LOG is not None:
        _write({"event": "finish", "t": time.time()})
        _LOG.close()
        _LOG = None
