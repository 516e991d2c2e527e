"""The card-free logic of `chip_smoke.py`, on the CPU: the protocol of its
rank processes started ahead of their job (`World`, `drive`, `shard_rank`)
and the timing line's arithmetic."""

import os
import pathlib
import sys
import time

import pytest

from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
import chip_smoke_ranks  # noqa: E402


@pytest.fixture
def worlds(tmp_path, monkeypatch):
    """A World factory for gloo worlds of `chip_smoke_ranks.cpu_rank` on
    the CPU, forked from a forkserver that loaded torch, their directories
    under `tmp_path`; kills what a failed test left."""
    for k, v in one_thread_env({}).items():
        monkeypatch.setenv(k, v)
    ctx = chip_smoke.forkserver(preload=("torch",))
    monkeypatch.setattr(chip_smoke, "SHARD_DIR", tmp_path)
    monkeypatch.setattr(chip_smoke, "STARTED_WORLDS", [])
    monkeypatch.setattr(chip_smoke, "PROCESS_RECORDS", [])

    def make(name, job, n):
        where = str(tmp_path / name)
        return chip_smoke.World(name, n, chip_smoke_ranks.cpu_rank,
                                lambda r: (job, r, n, where), ctx)

    yield make
    # as at the script's exit: the ranks killed, the forkserver reaped
    from multiprocessing import forkserver as server
    pid = server._forkserver._forkserver_pid
    monkeypatch.setattr(chip_smoke, "CONTEXT", [ctx])
    chip_smoke.stop_processes()
    assert server._forkserver._forkserver_pid is None
    with pytest.raises(ChildProcessError):
        os.waitpid(pid, 0)


def test_a_world_of_two_runs_two_jobs_in_turn(worlds):
    """Both worlds start at once; the second waits, loaded, while the first
    runs its job, then runs its own in processes that ran nothing before:
    each rank's last line comes back, its start-up stamps taken out."""
    first, second = worlds("first", "allsum", 2), worlds("second",
                                                         "allsum", 2)
    chip_smoke.drive([first], 120)
    assert second.went is None
    chip_smoke.drive([second], 120)
    assert second.went > first.went
    for w in (first, second):
        lines = w.results()
        assert [(x["rank"], x["world"], x["sum"]) for x in lines] == [
            (0, 2, 3.0), (1, 2, 3.0)]
        assert all("boot" not in x for x in lines)
    pids = {p.pid for w in (first, second) for p in w.procs}
    assert len(pids) == 4
    recs = chip_smoke.PROCESS_RECORDS
    assert [r["job"] for r in recs] == ["first", "second"]
    for r in recs:
        for rank in r["ranks"]:
            assert rank["start_s"] > 0
            # spawn to exit, stage by stage, as the parent and rank saw it
            assert {"spawn>process", "go>job_start", "job_end>pg_down",
                    "pg_down>exit"} <= set(rank)


def test_a_failing_job_fails_its_world_and_kills_its_ranks(worlds):
    """Rank 1 raises while rank 0 goes on: `drive` raises with rank 1's
    error and kills rank 0."""
    world = worlds("failing", "fail", 2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failing rank 1 exited 1") as e:
        chip_smoke.drive([world], 120)
    assert "rank 1 fails its job" in str(e.value)
    assert time.monotonic() - t0 < 100
    codes = [p.exitcode for p in world.procs]
    assert codes[1] == 1 and codes[0] is not None and codes[0] < 0


def test_a_forked_rank_that_dies_idle_fails_its_world(worlds):
    """A loaded rank that dies before its job is sent fails its world at
    the next `drive`, which kills the other rank and sends no job."""
    world = worlds("orphan", "allsum", 2)
    chip_smoke.drive([world], 120, ready_only=True)
    world.procs[0].kill()
    world.procs[0].join(60)
    with pytest.raises(RuntimeError, match="orphan rank 0 exited -9"):
        chip_smoke.drive([world], 120)
    assert world.went is None
    assert world.procs[1].exitcode < 0


def test_the_timing_line_adds_up_to_the_wall_time(monkeypatch, capsys):
    """Phase lines emitted in turn (the kernel rows' many lines of one
    phase among them), then the timing line: its phases, `start` and
    `end` included, sum to its wall time, which is this process's age."""
    now = time.monotonic()
    monkeypatch.setattr(chip_smoke, "PHASE_WALLS", [])
    monkeypatch.setattr(chip_smoke, "LAST_LINE", [now])
    monkeypatch.setattr(chip_smoke, "STARTED", now)
    monkeypatch.setattr(chip_smoke, "LAPS", [])
    monkeypatch.setattr(chip_smoke, "BOOT", dict(chip_smoke.BOOT,
                                                 script=now))
    for phase in ("build", "kernels", "kernels", "main", "dryrun"):
        chip_smoke.lap("work")
        time.sleep(0.01)
        chip_smoke.emit({"phase": phase})
    line = chip_smoke.timing_summary(0.5, 0.25)
    age = time.monotonic() - chip_smoke.BOOT["process"]
    assert list(line["phases"]) == ["start", "build", "kernels", "main",
                                    "dryrun", "end"]
    assert sum(line["phases"].values()) == pytest.approx(line["wall_s"],
                                                         abs=1e-9)
    assert line["wall_s"] == pytest.approx(age, abs=0.05)
    assert line["phases"]["kernels"] >= 0.02
    assert (line["card_end_s"], line["dryrun_end_s"]) == (0.5, 0.25)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 5 and all('"split"' in x for x in out)
