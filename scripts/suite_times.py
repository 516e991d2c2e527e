#!/usr/bin/env python3
"""Summarise a run of the CPU test suite from its junit file.

    python scripts/suite_times.py RUN.xml [RUN.xml ...] [--slowest N]

For each file, one JSON object: the session's seconds as pytest timed it,
the counts (tests, passed, failed, errors, skipped), the failing tests,
the test-seconds (setup, call and teardown of every test, summed over the
workers) of the port's files (`tests/test_torch_*.py`) and of the
reference's, the port's files by their test-seconds, and the port's N
slowest tests. Write the junit file with pytest's `--junitxml=RUN.xml`.
"""

import argparse
import collections
import json
import xml.etree.ElementTree as ET

PORT_PREFIX = "tests.test_torch_"


def summarise(path: str, slowest: int) -> dict:
    suite = ET.parse(path).getroot().find("testsuite")
    counts = {k: int(suite.get(k)) for k in
              ("tests", "failures", "errors", "skipped")}
    by_file = collections.Counter()
    port, failed = [], []
    for case in suite.iter("testcase"):
        cls, secs = case.get("classname"), float(case.get("time", 0.0))
        by_file[cls] += secs
        if cls.startswith(PORT_PREFIX):
            port.append((secs, f"{cls}::{case.get('name')}"))
        if case.find("failure") is not None or case.find("error") is not None:
            failed.append(f"{cls}::{case.get('name')}")
    port_files = {c: round(s, 3) for c, s in by_file.most_common()
                  if c.startswith(PORT_PREFIX)}
    return {
        "file": path,
        "session_s": float(suite.get("time")),
        **counts,
        "passed": counts["tests"] - counts["failures"] - counts["errors"]
        - counts["skipped"],
        "failed": failed,
        "port_test_s": round(sum(port_files.values()), 3),
        "reference_test_s": round(sum(
            s for c, s in by_file.items() if not c.startswith(PORT_PREFIX)),
            3),
        "port_files_s": port_files,
        "port_slowest": [[round(s, 3), n] for s, n in
                         sorted(port, reverse=True)[:slowest]],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit", nargs="+")
    ap.add_argument("--slowest", type=int, default=10)
    args = ap.parse_args(argv)
    for path in args.junit:
        print(json.dumps(summarise(path, args.slowest), indent=1))


if __name__ == "__main__":
    main()
