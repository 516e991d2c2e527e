#!/usr/bin/env python3
"""Summarise runs of `chip_smoke.py` from their standard output, side by
side.

    python3 scripts/smoke_times.py RUN.log [RUN.log ...]

Per run: the script's wall time and each phase's (the `{"timing": ...}`
line, or the phase lines' `elapsed_s` where a run has none), the card
chain's end and the dry run's, each sharded world's start, job and exit
seconds (its slowest rank) and whether the run waited on it, and the
phases' splits. Then, against the first run: whether each run printed the
same set of phase lines, the same `launches_by_path` in its kernels line
and the same dry-run records (FLOPs, peak GB, collective GB). Send the
script's stdout to a file: `python3 chip_smoke.py > RUN.log`.
"""

import json
import sys


def read(path: str) -> dict:
    phases, timing, kernels = [], None, None
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "phase" in obj:
                phases.append(obj)
            elif "timing" in obj:
                timing = obj["timing"]
            elif "kernels" in obj:
                kernels = obj["kernels"]
    return dict(phases=phases, timing=timing, kernels=kernels)


def walls(run: dict) -> dict:
    """Each phase's wall time: the timing line's, or the differences of
    `elapsed_s` (the stretch before the first line counted as `build`)."""
    if run["timing"] is not None:
        return dict(run["timing"]["phases"])
    out, last = {}, 0.0
    for p in run["phases"]:
        out[p["phase"]] = out.get(p["phase"], 0.0) + p["elapsed_s"] - last
        last = p["elapsed_s"]
    return out


def worlds(run: dict) -> dict:
    """{phase: [(job, start, job, exit s of its slowest rank, waited s)]}."""
    out = {}
    for p in run["phases"]:
        for rec in p.get("processes", []):
            ranks = rec["ranks"]
            job = max(r.get("job_start>job_end", 0.0) for r in ranks)
            exits = max(sum(v for k, v in r.items()
                            if k.startswith(("job_end>", "pg_down>")))
                        for r in ranks)
            out.setdefault(p["phase"], []).append(dict(
                job=rec["job"], ranks=len(ranks),
                start_s=max(r.get("start_s", 0.0) for r in ranks),
                job_s=job, exit_s=exits,
                waited_s=rec.get("waited_s")))
    return out


def dryrun_records(run: dict):
    for p in run["phases"]:
        if p["phase"] == "dryrun":
            return p["records"]
    return None


def by_path(run: dict):
    if run["kernels"] is None:
        return None
    return {row["name"]: row["launches_by_path"] for row in run["kernels"]}


def main(paths: list[str]) -> None:
    runs = [read(p) for p in paths]
    first = runs[0]
    for path, run in zip(paths, runs):
        t = run["timing"] or {}
        elapsed = run["phases"][-1]["elapsed_s"] if run["phases"] else None
        print(json.dumps(dict(
            file=path, wall_s=t.get("wall_s", elapsed),
            card_end_s=t.get("card_end_s"), dryrun_end_s=t.get(
                "dryrun_end_s"), process_start_s=t.get("process_start_s"),
            cpu_count=t.get("cpu_count"), phases=walls(run),
            worlds=worlds(run),
            splits={p["phase"]: p["split"] for p in run["phases"]
                    if "split" in p},
            same_phase_lines=({p["phase"] for p in run["phases"]}
                              == {p["phase"] for p in first["phases"]}),
            same_launches_by_path=by_path(run) == by_path(first),
            same_dryrun_records=dryrun_records(run) == dryrun_records(
                first))))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
