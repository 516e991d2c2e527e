"""The whole slice on the CPU: `ServeEngine.generate` in the port against
the reference engine on the reference's weights (tiny Qwen2.5 in f32, plain
TINY and the padded-GQA variant; tiny RWKV6 in f32, the ssm family; tiny
Zamba2 in f32, the hybrid family, plain and with an 8-token window that the
shared block's KV cache wraps), an
8-chip fleet and the learned three-rail control round. Tokens must be equal; the plane and the SOR
estimate allclose; `summary()` carries the same keys and values."""

import dataclasses

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
from repro_torch.configs import get_config as tget
from repro_torch.core import control_plane as tcp
from repro_torch.core import policy as tpol
from repro_torch.core import power_plane as tpp
from repro_torch.core import sor as tsor
from repro_torch.core import telemetry as ttel
from repro_torch.core.hwspec import FleetSpec as TFleet
from repro_torch.models import registry as treg
from repro_torch.serve.engine import ServeEngine as TEngine

# the plane is elementwise f32 on equal inputs
PLANE = dict(rtol=1e-6, atol=1e-7)
# the SOR estimate inherits the uncentred EWLS solve's cancellation
SOR = dict(rtol=1e-4, atol=1e-5)
B, TP, NEW, CHIPS = 2, 16, 12, 8

CONFIGS = {
    "tiny": lambda get: get("qwen2p5_14b", tiny=True),
    "tiny_gqa_pad": lambda get: dataclasses.replace(
        get("qwen2p5_14b", tiny=True), n_heads=10, n_kv_heads=2,
        head_dim=32, tp=4),
    "rwkv_tiny": lambda get: get("rwkv6_7b", tiny=True),
    "zamba_tiny": lambda get: get("zamba2_1p2b", tiny=True),
    "zamba_tiny_window8": lambda get: dataclasses.replace(
        get("zamba2_1p2b", tiny=True), sliding_window=8),
}


def _engine_kw(pkg, n_params, mode):
    """Both packages' engine arguments: `slice` is the slice's controller
    (MultiRailClosedLoop with the learned three-rail round); `gate` a bare
    ClosedLoop on the fleet with admission control; `scalar` a bare
    PhaseAware on the single-chip plane."""
    pol, cp, pp, sor, tel, fleet = pkg
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
    elif mode == "gate":
        kw.update(fleet=fleet.sample(CHIPS, seed=1), policy=pol.ClosedLoop(),
                  admission_gate=True)
    else:
        kw.update(policy=pol.PhaseAware())
    return kw


JPKG = (jpol, jcp, jpp, jsor, jtel, JFleet)
TPKG = (tpol, tcp, tpp, tsor, ttel, TFleet)


@pytest.mark.parametrize("name,mode", [("tiny", "slice"),
                                       ("tiny_gqa_pad", "slice"),
                                       ("rwkv_tiny", "slice"),
                                       ("zamba_tiny", "slice"),
                                       ("zamba_tiny_window8", "slice"),
                                       ("tiny", "gate"),
                                       ("tiny", "scalar")])
def test_generate_matches_reference(name, mode):
    jcfg = dataclasses.replace(CONFIGS[name](jget), dtype="float32")
    tcfg = dataclasses.replace(CONFIGS[name](tget), dtype="float32")
    params = jreg.build(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  params)
    n_params = sum(a.size for a in jax.tree_util.tree_leaves(params))
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, TP)).astype(np.int32)

    je = JEngine(jcfg, params, **_engine_kw(JPKG, n_params, mode))
    te = TEngine(tcfg, treg.params_from_jax(tcfg, tree, "cpu"),
                 device="cpu", **_engine_kw(TPKG, n_params, mode))
    jtok, ttok = je.generate(prompts, NEW), te.generate(prompts, NEW)
    assert ttok.shape == (B, NEW) and ttok.dtype == np.int32
    np.testing.assert_array_equal(ttok, jtok)

    for f in ("v_core", "v_hbm", "v_io", "energy_j"):
        np.testing.assert_allclose(getattr(te.plane, f).numpy(),
                                   np.asarray(getattr(je.plane, f)),
                                   err_msg=f, **PLANE)
    for f in ("comp_level", "step"):
        np.testing.assert_array_equal(getattr(te.plane, f).numpy(),
                                      np.asarray(getattr(je.plane, f)))
    if mode == "slice":
        assert te._sor_state.tick == int(je._sor_state.tick) == NEW
        for f in ("intercept", "slope", "v_frontier", "confidence", "n_eff"):
            np.testing.assert_allclose(
                getattr(te._sor_state.estimate, f).numpy(),
                np.asarray(getattr(je._sor_state.estimate, f)), err_msg=f,
                **SOR)

    js, ts = je.summary(), te.summary()
    assert ts.keys() == js.keys()
    for k, v in js.items():
        if isinstance(v, float):
            np.testing.assert_allclose(ts[k], v, rtol=1e-5, err_msg=k)
        elif k != "sor":
            assert ts[k] == v, k


def test_engine_refuses_unported_options():
    """The sharded control round (`mesh=`, `shard_control=True`) needs a
    mesh and a fleet, as the reference's does (the sharded serve path is
    tested in tests/test_torch_sharding.py); routed serving (`router=`,
    `batch_cap=`) is tested in tests/test_torch_serve_trace.py."""
    cfg = tget("qwen2p5_14b", tiny=True)
    params = treg.build(cfg).init(torch.Generator().manual_seed(0))
    for kw, msg in ((dict(mesh=object(), shard_control=True), "fleet"),
                    (dict(shard_control=True), "needs a mesh")):
        with pytest.raises(ValueError, match=msg):
            TEngine(cfg, params, max_len=16, batch_size=1, device="cpu",
                    **kw)
    with pytest.raises(ValueError, match="params live on"):
        TEngine(cfg, params, max_len=16, batch_size=1, device="meta")
