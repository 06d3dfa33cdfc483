#!/usr/bin/env python3
"""Per-file test seconds of a pytest run, also one that is cut.

As a pytest plugin it appends one JSON line per test report to the file
``$DURLOG`` as the report arrives (under pytest-xdist the controller
receives every worker's reports and logs them with the worker's id), so
a run cut by its time limit still leaves what it finished::

    DURLOG=/tmp/run.jsonl PYTHONPATH=scripts python -m pytest tests/ \\
        -p xdist -n 6 --dist loadfile -p test_file_times ...

As a script it sums the reports per test file, and with two logs compares
them: the summed test seconds, the port's files (``tests/test_torch_*``),
the seconds at which the last file ended, the ten longest files of each
run, and the files that ended last::

    python3 scripts/test_file_times.py before.jsonl [after.jsonl]
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time

_log = None


def pytest_runtest_logreport(report):
    """Plugin hook: one line per report (setup, call, teardown), with the
    xdist worker that ran it where there is one."""
    global _log
    worker = getattr(getattr(report, "node", None), "gateway", None)
    if _log is None:
        _log = open(os.environ["DURLOG"], "a", buffering=1)
    _log.write(json.dumps({"t": time.time(), "node": report.nodeid,
                           "when": report.when, "d": report.duration,
                           "o": report.outcome,
                           "w": worker.id if worker else None}) + "\n")


def per_file(path: str) -> dict:
    """file → [summed seconds, start s, end s, passes], times from the
    first report's start."""
    with open(path) as fh:
        rows = [json.loads(line) for line in fh if line.strip()]
    # under xdist each worker logs its own reports too: count the
    # controller's, which name the worker
    if any(r["w"] for r in rows):
        rows = [r for r in rows if r["w"]]
    t0 = min(r["t"] - r["d"] for r in rows)
    out = collections.defaultdict(lambda: [0.0, float("inf"), 0.0, 0])
    for r in rows:
        entry = out[r["node"].split("::")[0]]
        entry[0] += r["d"]
        entry[1] = min(entry[1], r["t"] - r["d"] - t0)
        entry[2] = max(entry[2], r["t"] - t0)
        entry[3] += r["when"] == "call" and r["o"] == "passed"
    return out


def report(name: str, files: dict) -> None:
    total = sum(v[0] for v in files.values())
    port = sum(v[0] for f, v in files.items() if "/test_torch_" in f)
    end = max(v[2] for v in files.values())
    print(f"{name}: {total:.0f} test seconds ({port:.0f} in the port's "
          f"files), the last file ended at {end:.0f} s")
    print("  ten longest files:")
    for f, (d, start, stop, n) in sorted(files.items(),
                                         key=lambda kv: -kv[1][0])[:10]:
        print(f"    {d:7.1f} s  {start:6.0f}–{stop:6.0f} s  {n:4d} passed  {f}")
    print("  ended last:")
    for f, (d, start, stop, n) in sorted(files.items(),
                                         key=lambda kv: -kv[1][2])[:5]:
        print(f"    {start:6.0f}–{stop:6.0f} s  {d:7.1f} s  {f}")


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    runs = [(path, per_file(path)) for path in argv]
    for path, files in runs:
        report(path, files)
    if len(runs) == 2:
        (_, a), (_, b) = runs
        print("  per file, first → second:")
        for f in sorted(set(a) | set(b), key=lambda f: -a.get(f, [0])[0])[:15]:
            print(f"    {a.get(f, [0.0])[0]:7.1f} → {b.get(f, [0.0])[0]:7.1f} s"
                  f"  {f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
