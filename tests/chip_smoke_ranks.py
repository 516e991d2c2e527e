"""Rank bodies for `tests/test_torch_chip_smoke.py`: `chip_smoke.py`'s
protocol for a process forked ahead of its job (`await_go`, then
`shard_rank`: a gloo process group from the job directory's file store,
the job, the group stopped) on the CPU, with jobs of its own in place of
the card's."""

import pathlib
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def allsum(dev, rank, world, where) -> dict:
    """The ranks' numbers summed over the world: rank r gives r + 1."""
    t = torch.tensor([rank + 1.0], device=dev)
    dist.all_reduce(t)
    return {"sum": t.item()}


def fail(dev, rank, world, where) -> dict:
    """Rank 1 raises; the others go on for an hour."""
    if rank == 1:
        raise RuntimeError("rank 1 fails its job")
    time.sleep(3600)
    return {}


JOBS = {"allsum": allsum, "fail": fail}


def cpu_rank(job: str, rank: int, world: int, where: str, go) -> None:
    """`chip_smoke.card_process`'s shard branch on the CPU: loaded, wait
    for the job, run it in a gloo world on one torch thread."""
    chip_smoke.await_go(pathlib.Path(where), rank, go)
    chip_smoke.emit(dict(chip_smoke.shard_rank(
        torch.device("cpu"), JOBS, job, rank, world, "gloo", where,
        threads=1), boot=chip_smoke.BOOT))
