"""Granite-20B (dense, MQA: one KV head) on the port against the reference:
the configurations field for field, their head plans (CONFIG: 48 q heads
over the one KV head duplicated to 16 by the tp=16 plan, group 3, head_dim
128; TINY: 4 q heads over one KV head, group 4, head_dim 32), the
parameter tree's shapes and dtypes read without allocating (29.39 B
parameters, ~58.8 GB in bf16), tiny Granite in f32 served through
`params_from_jax` on the reference's weights (tokens equal; plane
elementwise f32 PLANE; the learned estimate SOR, the uncentred EWLS solve
cancelling digits), and both launchers with `--arch granite_20b --tiny`."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import control_plane as jcp
from repro.core import policy as jpol
from repro.core import power_plane as jpp
from repro.core import sor as jsor
from repro.core import telemetry as jtel
from repro.core.hwspec import FleetSpec as JFleet
from repro.models import registry as jreg
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.core import control_plane as tcp
from repro_torch.core import policy as tpol
from repro_torch.core import power_plane as tpp
from repro_torch.core import sor as tsor
from repro_torch.core import telemetry as ttel
from repro_torch.core.hwspec import FleetSpec as TFleet
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.models import registry as treg
from repro_torch.serve.engine import ServeEngine as TEngine
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "granite_20b"
PLANE = dict(rtol=1e-6, atol=1e-7)
SOR = dict(rtol=1e-4, atol=1e-5)
B, TP, NEW, CHIPS = 2, 16, 12, 8
N_PARAMS = 29_394_327_552          # embed + lm_head + 52 x 553.6 M


@pytest.mark.parametrize("tiny", [False, True], ids=["CONFIG", "TINY"])
def test_config_and_head_plan_equal_the_reference(tiny):
    tcfg, jcfg = tget(ARCH, tiny=tiny), jget(ARCH, tiny=tiny)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tplan, jplan = tcfg.head_plan(), jcfg.head_plan()
    for f in ("n_q", "n_kv", "n_q_pad", "n_kv_pad", "group", "kv_src",
              "q_src"):
        assert tuple(np.atleast_1d(getattr(tplan, f))) == \
            tuple(np.atleast_1d(getattr(jplan, f))), f
    want = (4, 1, 4, 32) if tiny else (48, 16, 3, 128)
    assert (tplan.n_q_pad, tplan.n_kv_pad, tplan.group,
            tcfg.head_dim_) == want
    assert ARCH in ARCH_IDS


def test_parameter_tree_read_without_allocating():
    """The full configuration's shape tree against the reference's
    `abstract_params` (jax.eval_shape): the same leaves, shapes and
    dtypes, 29.39 B parameters, ~58.8 GB in bf16."""
    cfg = tget(ARCH)
    shapes, dtypes = lm.param_shapes(cfg), lm.param_dtypes(cfg)
    abstract = jreg.abstract_params(jget(ARCH))
    flat_t = list(lm.tree_leaves(shapes))
    flat_j = [tuple(a.shape) for a in jax.tree_util.tree_leaves(abstract)]
    assert sorted(map(tuple, flat_t)) == sorted(flat_j)
    assert {str(d).split(".")[-1] for d in lm.tree_leaves(dtypes)} == \
        {str(a.dtype) for a in jax.tree_util.tree_leaves(abstract)} \
        == {"bfloat16"}
    n = sum(math.prod(s) for s in flat_t)
    assert n == N_PARAMS == sum(math.prod(s) for s in flat_j)
    assert round(2 * n / 1e9, 1) == 58.8
    # k and v: the one KV head as 16 duplicated slots of 128
    assert tuple(shapes["blocks"]["attn"]["wk"]) == (52, 6144, 16, 128)


def _engine_kw(pol, cp, pp, sor, tel, fleet, n_params, mode):
    kw = dict(max_len=TP + NEW + 8, batch_size=B,
              prefill_profile=pp.StepProfile(2.0 * n_params * B * TP,
                                             2.0 * n_params, 0.0),
              decode_profile=pp.StepProfile(2.0 * n_params * B,
                                            2.0 * n_params, 0.0))
    if mode == "slice":
        kw.update(fleet=fleet.sample(CHIPS, seed=0),
                  controller=cp.InGraphRailController(
                      pol.MultiRailClosedLoop(),
                      sor=sor.SorConfig(ingest="frames",
                                        rails=tel.ALL_RAIL_OBSERVABLES,
                                        refresh_every=4)))
    else:
        kw.update(policy=pol.PhaseAware())
    return kw


@pytest.mark.parametrize("mode", ["slice", "scalar"])
def test_tiny_generate_matches_reference(mode):
    """The slice's serve path (8-chip fleet, learned three-rail round) and
    the scalar PhaseAware plane, on the reference's weights: the `[.., 1,
    32]` k and v leaves carry over as they are."""
    jcfg = dataclasses.replace(jget(ARCH, tiny=True), dtype="float32")
    tcfg = dataclasses.replace(tget(ARCH, tiny=True), dtype="float32")
    params = jreg.build(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  params)
    assert tree["blocks"]["attn"]["wk"].shape == (2, 128, 1, 32)
    n_params = sum(a.size for a in jax.tree_util.tree_leaves(params))
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, TP)).astype(np.int32)
    je = JEngine(jcfg, params, **_engine_kw(
        jpol, jcp, jpp, jsor, jtel, JFleet, n_params, mode))
    te = TEngine(tcfg, treg.params_from_jax(tcfg, tree, "cpu"),
                 device="cpu", **_engine_kw(tpol, tcp, tpp, tsor, ttel,
                                            TFleet, n_params, mode))
    jtok, ttok = je.generate(prompts, NEW), te.generate(prompts, NEW)
    np.testing.assert_array_equal(ttok, jtok)
    assert len(np.unique(ttok)) > 1
    for f in ("v_core", "v_hbm", "v_io", "energy_j"):
        np.testing.assert_allclose(getattr(te.plane, f).numpy(),
                                   np.asarray(getattr(je.plane, f)),
                                   err_msg=f, **PLANE)
    np.testing.assert_array_equal(te.plane.comp_level.numpy(),
                                  np.asarray(je.plane.comp_level))
    if mode == "slice":
        for f in ("intercept", "slope", "v_frontier", "confidence", "n_eff"):
            np.testing.assert_allclose(
                getattr(te._sor_state.estimate, f).numpy(),
                np.asarray(getattr(je._sor_state.estimate, f)), err_msg=f,
                **SOR)


def test_launchers_take_granite(capsys):
    launch_serve.main(["--arch", ARCH, "--tiny", "--device", "cpu",
                       "--max-new", "8"])
    out = capsys.readouterr().out
    assert "granite-tiny (1.0M): generated (4, 8) tokens" in out
    launch_train.main(["--arch", ARCH, "--tiny", "--steps", "2",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "granite-tiny: 1.0M params (tiny=True)" in out
    first, last = out.split("loss ")[1].split(";")[0].split(" -> ")
    assert math.isfinite(float(first)) and math.isfinite(float(last))
