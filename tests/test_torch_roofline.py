"""The roofline (`roofline/analytic.py`, `roofline/analysis.py`,
`roofline/op_costs.py`) and the dry run's constants against the
reference's, with no world:

- `hbm_bytes_per_device` and `cache_bytes_per_device` equal the
  reference's on every cell of the grid, at 256 and 512 devices, with and
  without int8 moments, at several microbatch counts and TP degrees;
- `analyze_cell` (every field of its row), `format_table` and
  `pick_hillclimb_cells` equal the reference's on the same synthetic
  records (numpy-seeded costs for every cell on both meshes, some with
  `corrected`, one not ok), and `model_flops_per_chip` on every cell;
- `op_costs.analyze_ops` on the reference's two walker cases
  (`tests/test_dryrun.py`): ten chained 128 x 128 matmuls count
  10 x 2 x 128^3 FLOPs (the port has no loop to undercount), and
  sum(relu(x @ x) * 2) counts 2 x 64^3; a collective's wire bytes carry
  the reference's ring factor;
- the dry run's profile tables and `_profile_settings` equal the
  reference's on both production meshes.

The terms are the reference's simulated TPU v5e (`hwspec.V5E`), as in the
reference; every comparison is exact (the same float arithmetic).
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.roofline import analysis as janalysis
from repro.roofline import analytic as janalytic
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun as tdryrun
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import analytic as tanalytic
from repro_torch.roofline.op_costs import analyze_ops, ring_factor
from torch_threads import one_torch_thread  # noqa: F401

# the reference's dry-run module sets XLA_FLAGS (512 host devices) when it
# is imported, which its `analyze_cell` does; import it here and put the
# variable back, so no later subprocess of this worker inherits it
_saved = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402

if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

DEVICES = (256, 512)
MICROBATCHES = (1, 2, 4, 8)
CELLS = [(a, s) for a, s, ok in tbase.cells() if ok]
N_RECORD_SEED = 7


@pytest.mark.parametrize("arch,shape", CELLS)
def test_hbm_and_cache_bytes_equal_the_reference(arch, shape):
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    tsh, jsh = tbase.SHAPES[shape], jbase.SHAPES[shape]
    for n in DEVICES:
        assert tanalytic.cache_bytes_per_device(tcfg, tsh, n) == \
            janalytic.cache_bytes_per_device(jcfg, jsh, n)
        for mb in MICROBATCHES:
            for int8 in (False, True):
                for tp in (None, 1):
                    kw = dict(microbatches=mb, int8_opt=int8, tp=tp)
                    assert tanalytic.hbm_bytes_per_device(
                        tcfg, tsh, n, **kw) == \
                        janalytic.hbm_bytes_per_device(jcfg, jsh, n, **kw)


def _records():
    """Synthetic dry-run records of every cell on both meshes."""
    rng = np.random.default_rng(N_RECORD_SEED)
    out = []
    for mesh, devices in (("single", 256), ("multi", 512)):
        for i, (arch, shape) in enumerate(CELLS):
            kinds = {"all-gather": float(rng.uniform(1e6, 1e11)),
                     "all-reduce": float(rng.uniform(1e6, 1e11))}
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "devices": devices, "ok": True,
                   "flops": float(rng.uniform(1e9, 1e16)),
                   "collective_bytes": {**kinds,
                                        "total": sum(kinds.values())}}
            if i % 3 == 0:
                rec["corrected"] = {"flops": float(rng.uniform(1e9, 1e16)),
                                    "collective_bytes": float(
                                        rng.uniform(1e6, 1e11)),
                                    "by_kind": kinds}
            out.append(rec)
    out.append({"arch": "grok1_314b", "shape": "train_4k", "mesh": "single",
                "ok": False, "error": "synthetic"})
    return out


def test_analysis_equals_the_reference_on_synthetic_records():
    recs = _records()
    trows, jrows = [], []
    for rec in recs:
        t = tanalysis.analyze_cell(dict(rec))
        j = janalysis.analyze_cell(dict(rec))
        assert (t is None) == (j is None)
        if t is None:
            continue
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        trows.append(t)
        jrows.append(j)
    assert tanalysis.format_table(trows) == janalysis.format_table(jrows)
    tp, jp = (tanalysis.pick_hillclimb_cells(trows),
              janalysis.pick_hillclimb_cells(jrows))
    assert {k: dataclasses.asdict(v) for k, v in tp.items()} == \
        {k: dataclasses.asdict(v) for k, v in jp.items()}
    for arch, shape in CELLS:
        for n in DEVICES:
            assert tanalysis.model_flops_per_chip(arch, shape, n) == \
                janalysis.model_flops_per_chip(arch, shape, n)


def test_op_costs_count_the_walkers_cases():
    def chained(x):
        for _ in range(10):
            x = x @ x
        return x

    c = analyze_ops(chained, torch.ones((128, 128)))
    assert c.flops == 10 * 2 * 128 ** 3
    assert c.n_whiles == 0 and c.max_mult == 1.0
    # each product reads two 128 x 128 f32 operands and writes one
    assert c.hbm_bytes == 10 * 3 * 128 * 128 * 4
    c = analyze_ops(lambda x: torch.sum(torch.relu(x @ x) * 2.0),
                    torch.ones((64, 64)))
    assert c.flops == 2 * 64 ** 3


def test_ring_factors_are_the_references():
    for p in (2, 16, 256):
        assert ring_factor("all-gather", p) == (p - 1) / p
        assert ring_factor("all-reduce", p) == 2 * (p - 1) / p
        assert ring_factor("reduce-scatter", p) == float(p - 1)
        assert ring_factor("all-to-all", p) == (p - 1) / p


def test_the_dry_runs_profiles_equal_the_references():
    assert tdryrun.MICROBATCHES == jdryrun.MICROBATCHES
    assert tdryrun.INT8_OPT == jdryrun.INT8_OPT
    assert tdryrun.SHARDING_PROFILES == jdryrun.SHARDING_PROFILES
    for (shape, names) in tdryrun.MESHES.values():
        tmesh = types.SimpleNamespace(mesh_dim_names=names,
                                      shape=tuple(shape))
        jmesh = types.SimpleNamespace(
            axis_names=names, devices=types.SimpleNamespace(
                shape=tuple(shape), size=int(np.prod(shape))))
        for arch, sname in CELLS:
            t = tdryrun._profile_settings(arch, tmesh, tbase.SHAPES[sname])
            j = jdryrun._profile_settings(arch, jmesh, jbase.SHAPES[sname])
            assert t == j, (arch, sname)
        for arch, sname in CELLS:
            cfg_t, cfg_j = tbase.get_config(arch), jbase.get_config(arch)
            pt = tdryrun.analytic_profile(cfg_t, tbase.SHAPES[sname],
                                          int(np.prod(shape)))
            pj = jdryrun.analytic_profile(cfg_j, jbase.SHAPES[sname],
                                          int(np.prod(shape)))
            assert dataclasses.astuple(pt) == dataclasses.astuple(pj)
