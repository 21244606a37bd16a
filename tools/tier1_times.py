#!/usr/bin/env python3
"""Where a Tier-1 run's time went, file by file.

Usage, from the root of the repository::

    python3 tools/tier1_times.py report [--junit RUN.xml] [--log TIMES.jsonl]
    python3 tools/tier1_times.py cpu [--json OUT.json] tests/test_torch_*.py [-- PYTEST OPTIONS]

``--junit`` is the junit XML of a pytest run (``--junitxml``; a run that
``timeout`` cut writes none); ``--log`` is the log that
``tools/tier1_plugin.py`` wrote in the same run (its docstring says how to
load it with ``-p``).  Give either or both; the log's test ids and times
win where both are given.  Prints:

* each file's tests (collected), passes and seconds (setup, call and
  teardown of each test, summed), the files that took longest first;
* the dispatch order that ``--dist loadfile`` derives from the counts
  (pytest-xdist 3.x with ``--loadscope-reorder``, its default: the files
  with the most tests first, ties by file name), and the start second
  and worker that a replay of its scheduler gives each file from the
  measured test times (each worker is handed a file, then another
  whenever two or fewer of its tests are still to run);
* with ``--log``, each file's measured start and end second (from the
  session's start) and worker, and the collected tests that the run never
  reported: the tests a cut run did not reach.

The replay knows no contention: a test takes its measured seconds
whatever runs beside it.

``cpu`` runs each test file alone (``python -m pytest FILE`` with the
options after ``--``, ``JAX_PLATFORMS=cpu``), one after another, and
prints each one's CPU seconds (user and system time of the pytest process
and every process it waited for: its threads, and the ranks it spawned)
beside its wall seconds, its exit code and its summary line; ``--json``
keeps each file's whole output.  To run the files as the Tier-1 command
runs its tests, give that command's pytest options but xdist's, e.g.
``-- -m 'not slow' -p no:cacheprovider -p no:randomly``; add
``--durations=0`` to split a file's time by test.

Imports no jax: it reads files and starts pytest.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import resource
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from collections import OrderedDict


class Test:
    __slots__ = ("file", "seconds", "outcome", "start", "end", "worker")

    def __init__(self, file: str):
        self.file = file
        self.seconds = 0.0
        self.outcome = None           # None: never reported
        self.start = self.end = math.nan
        self.worker = ""


def _nodeid_of(classname: str, name: str) -> str:
    """junit's ``tests.test_x`` / ``tests.test_x.TestC`` and name -> node id."""
    parts = classname.split(".")
    i = max((k for k, p in enumerate(parts) if p.startswith("test_")), default=len(parts) - 1)
    return "::".join(["/".join(parts[:i + 1]) + ".py", *parts[i + 1:], name])


def read_junit(path: str, tests: "OrderedDict[str, Test]") -> None:
    for case in ET.parse(path).getroot().iter("testcase"):
        nodeid = _nodeid_of(case.get("classname", ""), case.get("name", ""))
        t = tests.setdefault(nodeid, Test(nodeid.split("::", 1)[0]))
        t.seconds = float(case.get("time", 0.0))
        t.outcome = "passed"
        for tag in ("failure", "error", "skipped"):
            if case.find(tag) is not None:
                t.outcome = tag


def read_log(path: str, tests: "OrderedDict[str, Test]") -> None:
    t0, reports = None, []
    with open(path) as f:
        for line in f:
            entry = json.loads(line)
            if entry["event"] == "start" and t0 is None:
                t0 = entry["t"]
            elif entry["event"] == "collected":
                for nodeid in entry["ids"]:
                    tests.setdefault(nodeid, Test(nodeid.split("::", 1)[0]))
            elif entry["event"] == "report":
                reports.append(entry)
    if t0 is None:
        sys.exit(f"{path}: no session start")
    fresh = set()
    for r in reports:
        t = tests.setdefault(r["nodeid"], Test(r["nodeid"].split("::", 1)[0]))
        if r["nodeid"] not in fresh:            # the log's times replace the XML's
            fresh.add(r["nodeid"])
            t.seconds = 0.0
        t.seconds += r["duration"]
        begin = (r["start"] if r["start"] is not None else r["t"] - r["duration"]) - t0
        end = (r["stop"] if r["stop"] is not None else r["t"]) - t0
        t.start = begin if math.isnan(t.start) else min(t.start, begin)
        t.end = end if math.isnan(t.end) else max(t.end, end)
        t.worker = r["worker"]
        if r["when"] == "call" or (r["when"] == "setup" and r["outcome"] != "passed"):
            t.outcome = r["outcome"]
        elif r["when"] == "teardown" and r["outcome"] == "failed":
            t.outcome = "error"


def dispatch_order(counts: "OrderedDict[str, int]") -> list[str]:
    """The order in which ``--dist loadfile`` hands files out: most tests
    first, ties in collection order (a stable sort; pytest collects a
    directory's files by name)."""
    return sorted(counts, key=lambda f: (-counts[f], f))


def replay(order: list[str], seconds: dict[str, list[float]], workers: int) -> dict:
    """A replay of the loadfile scheduler on ``workers`` workers with the
    given per-test seconds: file -> (start second, worker index)."""
    queue = list(order)
    pending = [[] for _ in range(workers)]       # per worker: [(file, seconds)]
    clock = [0.0] * workers
    placed: dict[str, tuple[float, int]] = {}

    def assign(w: int) -> None:
        f = queue.pop(0)
        pending[w].extend((f, s) for s in seconds[f])

    for w in range(min(workers, len(queue))):
        assign(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            assign(w)
    while any(pending):
        w = min((w for w in range(workers) if pending[w]), key=lambda w: clock[w])
        f, s = pending[w].pop(0)
        placed.setdefault(f, (clock[w], w))
        clock[w] += s
        if queue and len(pending[w]) <= 2:
            assign(w)
    return placed


def cpu_seconds(files: list[str], out: str | None, extra: list[str]) -> int:
    """Each file alone under pytest: CPU and wall seconds."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    rows = []
    print(f"{'file':48s} {'CPU s':>8s} {'wall s':>8s} {'rc':>3s}  summary")
    for f in files:
        before = resource.getrusage(resource.RUSAGE_CHILDREN)
        t0 = time.monotonic()
        run = subprocess.run([sys.executable, "-m", "pytest", f, *extra],
                             env=env, capture_output=True, text=True)
        wall = time.monotonic() - t0
        after = resource.getrusage(resource.RUSAGE_CHILDREN)
        cpu = (after.ru_utime - before.ru_utime) + (after.ru_stime - before.ru_stime)
        lines = run.stdout.strip().splitlines()
        rows.append(dict(file=f, cpu_s=cpu, wall_s=wall, rc=run.returncode,
                         summary=lines[-1] if lines else "", output=run.stdout))
        print(f"{f:48s} {cpu:8.1f} {wall:8.1f} {run.returncode:3d}  {rows[-1]['summary']}",
              flush=True)
    print(f"{'all':48s} {sum(r['cpu_s'] for r in rows):8.1f} "
          f"{sum(r['wall_s'] for r in rows):8.1f}")
    if out:
        with open(out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return max((r["rc"] for r in rows), default=0)


# the Tier-1 command's ``-n 6``
WORKERS = 6


def report(junit: str | None, log: str | None) -> int:
    tests: OrderedDict[str, Test] = OrderedDict()
    if junit:
        read_junit(junit, tests)
    if log:
        read_log(log, tests)
    files: OrderedDict[str, list[Test]] = OrderedDict()
    for t in tests.values():
        files.setdefault(t.file, []).append(t)

    print(f"{'file':48s} {'tests':>5s} {'passed':>6s} {'seconds':>9s}")
    secs = {f: sum(t.seconds for t in ts) for f, ts in files.items()}
    for f in sorted(secs, key=lambda f: -secs[f]):
        ok = sum(t.outcome == "passed" for t in files[f])
        print(f"{f:48s} {len(files[f]):5d} {ok:6d} {secs[f]:9.1f}")
    ok = sum(t.outcome == "passed" for t in tests.values())
    print(f"{'all':48s} {len(tests):5d} {ok:6d} {sum(secs.values()):9.1f}")

    order = dispatch_order(OrderedDict((f, len(ts)) for f, ts in files.items()))
    placed = replay(order, {f: [t.seconds for t in files[f]] for f in order}, WORKERS)
    print()
    head = f"{'#':>3s} {'file':48s} {'tests':>5s} {'replay start':>12s} {'gw':>3s}"
    print(head + (f" {'start':>8s} {'end':>8s} {'worker':>6s}" if log else ""))
    for i, f in enumerate(order):
        start, w = placed[f]
        line = f"{i:3d} {f:48s} {len(files[f]):5d} {start:12.1f} {w:3d}"
        if log:
            ran = [t for t in files[f] if t.outcome is not None]
            if ran:
                line += (f" {min(t.start for t in ran):8.1f} {max(t.end for t in ran):8.1f}"
                         f" {ran[0].worker:>6s}")
            else:
                line += f" {'-':>8s} {'-':>8s} {'-':>6s}"
        print(line)
    if log:
        unreached = [n for n, t in tests.items() if t.outcome is None]
        print()
        print(f"collected tests the run never reported: {len(unreached)}")
        for n in unreached:
            print("  " + n)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="seconds, dispatch order and starts per file")
    rep.add_argument("--junit", help="the run's junit XML")
    rep.add_argument("--log", help="the run's tier1_plugin log")
    cpu = sub.add_parser("cpu", help="CPU and wall seconds of each file run alone")
    cpu.add_argument("files", nargs="+")
    cpu.add_argument("--json", help="also write the rows here")
    argv = sys.argv[1:] if argv is None else list(argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    args = ap.parse_args(argv[:cut])
    if args.cmd == "cpu":
        return cpu_seconds(args.files, args.json, argv[cut + 1:])
    if cut < len(argv):
        rep.error("pytest options after -- go with cpu")
    if not (args.junit or args.log):
        rep.error("give --junit, --log or both")
    return report(args.junit, args.log)


if __name__ == "__main__":
    sys.exit(main())
