"""One torch intra-op thread for the port's tests, in this process and in
the port's child processes.

A parallel test run (`pytest -n 6`) puts several workers on the same cores.
With torch's default pool of one thread a core, each of the port's many
small eager CPU ops then waits for a whole pool to be scheduled, and a test
that takes 2 s alone takes minutes. On one thread it computes the same bits
alone, in one file or in the parallel run, as the gloo ranks
(`sharded_worlds.py`) already do.

Every `tests/test_torch_*.py` that holds a test imports `one_torch_thread`
(`tests/test_torch_hygiene.py` checks it). Importing this module sets the
pool, so the module's own fixtures and its import-time work run on one
thread too; the autouse fixture sets it again before each test, whatever
ran before in the worker. The setting stays in the tests: an entry point
of `repro_torch` leaves its caller's thread pool alone.

`torch.set_num_threads` does not reach a child process, so a child that
runs the port gets `one_thread_env`'s environment. The reference's
subprocesses (`sharded_reference.py` and the other JAX runs on forced host
devices) keep their environment: OMP_NUM_THREADS and XLA's own thread pool
stay as the reference's tests run them, so its numbers do not move.
"""

import os

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    torch.set_num_threads(1)


def one_thread_env(base=None, **extra):
    """`base` (default: this process's environment) and `extra`, with
    OMP_NUM_THREADS=1: the environment of a child process that runs the
    port."""
    return {**(os.environ if base is None else base), **extra,
            "OMP_NUM_THREADS": "1"}
