"""The port's public surface against the reference's: `repro_torch.core`
re-exports the reference's `__all__` one for one (and importing it builds
no kernel), `sor.safe_envelope` and the fit's log10 clip, the
`RailController` protocol, the deprecated `Policy.update_{jax,host,fleet}`
shims (which warn `ControlAPIDeprecationWarning`, equal
`apply_request(decide(...))` on the same frame, and equal the reference's
shims; no module of the port calls them) and
`TelemetryLog.{per_chip_series, dump_jsonl}`.

Tolerances: the shims' rails against the reference F32 (elementwise f32
on the same inputs), against the port's own decide() bit for bit;
compression levels, masks and the telemetry log's series and JSON lines
exactly; a fitted estimate's envelope against the reference's fit SOR (the
EWLS solve cancels digits), the envelope of one estimate bit for bit."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import control_plane as jcp
from repro.core import policy as jpol
from repro.core import power_plane as jpp
from repro.core import sor as jsor
from repro.core import telemetry as jtel
from repro_torch.core import control_plane as tcp
from repro_torch.core import policy as tpol
from repro_torch.core import power_plane as tpp
from repro_torch.core import sor as tsor
from repro_torch.core import telemetry as ttel
from test_torch_inputs import ring_state
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

# the port's shims warn; an unexpected call anywhere in this file fails
pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.policy.ControlAPIDeprecationWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-6, atol=1e-7)
SOR = dict(rtol=1e-4, atol=1e-5)
FIELDS = ("intercept", "slope", "v_frontier", "confidence", "n_eff")
SHIMS = ("update_jax", "update_host", "update_fleet")


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- the package surface ------------------------------------------------------

def test_core_all_equals_the_reference():
    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        got = getattr(tcore, name)
        owner = got if isinstance(got, type) or callable(got) else type(got)
        if isinstance(got, tuple):        # ALL_RAIL_OBSERVABLES
            owner = type(got[0])
        assert owner.__module__.startswith("repro_torch."), name
        assert type(getattr(jcore, name)).__name__ == type(got).__name__


def test_core_import_builds_no_kernel():
    """Importing the package loads no kernel library and none of JAX or
    the reference (a fresh process)."""
    code = ("import sys, repro_torch.core; "
            "from repro_torch.kernels import _build; "
            "assert _build._lib is None, 'a kernel library was loaded'; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')); "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=one_thread_env()).stdout
    assert out.strip() == "ok"


def test_log10_clip_constants():
    assert (tsor.LOG10_ERR_FLOOR, tsor.LOG10_ERR_CEIL) == \
        (jsor.LOG10_ERR_FLOOR, jsor.LOG10_ERR_CEIL) == (-8.0, 2.0)


# -- safe_envelope ------------------------------------------------------------

def _fitted(case="mid", n=8):
    """Both packages' refit of one seeded three-rail ring (the same ring,
    each package's own fit) and their configs."""
    st = ring_state(case, n)
    kw = dict(rails=jtel.ALL_RAIL_OBSERVABLES, **st["cfg"])
    jcfg = jsor.SorConfig(**kw)
    tcfg = tsor.SorConfig(**{**kw, "rails": ttel.ALL_RAIL_OBSERVABLES})
    cap = st["v"].shape[0]
    bufs = {f: st[f] for f in ("v", "obs", "age_s", "polled", "valid")}
    jh = dataclasses.replace(
        jtel.FrameHistory.create(cap, n, rails=jtel.ALL_RAIL_OBSERVABLES),
        **{f: jnp.asarray(a) for f, a in bufs.items()},
        cursor=jnp.int32(st["cursor"]), count=jnp.int32(st["count"]))
    th = ttel.FrameHistory(**{f: torch.from_numpy(a.copy())
                              for f, a in bufs.items()},
                           cursor=st["cursor"], count=st["count"],
                           capacity=cap, rails=ttel.ALL_RAIL_OBSERVABLES)
    jest = jsor.update_estimate(jsor.SorEstimate.init(n, 3), jh, jcfg,
                                fused=True)
    test = tsor.update_estimate(tsor.SorEstimate.init(n, 3, device="cpu"),
                                th, tcfg, fused=True)
    return jest, test, jcfg, tcfg


def _same_envelope(te, je, tol=None):
    assert te.rail == je.rail and te.v_max is None and je.v_max is None
    assert te.max_extension_v == je.max_extension_v
    for got, want in ((te.v_min, je.v_min), (te.confidence, je.confidence),
                      (te.floor(0.8), je.floor(0.8)),
                      (te.ceil(1.05), je.ceil(1.05))):
        if tol is None:
            np.testing.assert_array_equal(npy(got), npy(want))
        else:
            np.testing.assert_allclose(npy(got), npy(want), **tol)


def test_safe_envelope_on_a_fitted_estimate():
    """The VDD_IO view of each package's own fit (SOR apart), and the
    port's view of the reference's fitted estimate bit for bit."""
    jest, test, jcfg, tcfg = _fitted()
    usable = npy(jest.confidence)[2] > 0
    assert usable.any()
    np.testing.assert_array_equal(npy(test.confidence)[2] > 0, usable)
    je = jsor.safe_envelope(jest, jcfg)
    assert je.rail == "VDD_IO"
    _same_envelope(tsor.safe_envelope(test, tcfg), je, SOR)
    carried = tsor.SorEstimate(*(torch.from_numpy(npy(getattr(jest, f)).copy())
                                 for f in FIELDS))
    _same_envelope(tsor.safe_envelope(carried, tcfg), je)


@pytest.mark.parametrize("rails", [("VDD_CORE",), ("VDD_CORE", "VDD_HBM")])
def test_safe_envelope_without_vdd_io(rails):
    """A one-rail config on another rail gives that rail's envelope; two
    rails without VDD_IO have no single view."""
    pick = lambda mod: tuple(s for s in mod.ALL_RAIL_OBSERVABLES
                             if s.rail in rails)
    jcfg = jsor.SorConfig(rails=pick(jtel), ingest="frames")
    tcfg = tsor.SorConfig(rails=pick(ttel), ingest="frames")
    jest = jsor.SorEstimate.init(2, len(rails))
    test = tsor.SorEstimate.init(2, len(rails), device="cpu")
    if len(rails) == 1:
        _same_envelope(tsor.safe_envelope(test, tcfg),
                       jsor.safe_envelope(jest, jcfg))
        return
    for mod, est, cfg in ((jsor, jest, jcfg), (tsor, test, tcfg)):
        with pytest.raises(KeyError, match="safe_envelope needs"):
            mod.safe_envelope(est, cfg)


# -- the RailController protocol ----------------------------------------------

@pytest.mark.parametrize("make", [
    lambda cp, pol: cp.InGraphRailController(pol.PhaseAware()),
    lambda cp, pol: cp.HostRailController(),
    lambda cp, pol: cp.HostDecisionController(pol.PhaseAware()),
    lambda cp, pol: cp.HostPowerController(),
    lambda cp, pol: cp.as_controller(pol.ClosedLoop(), host=True),
], ids=["in-graph", "host", "host-decide", "host-power", "as_controller"])
def test_controllers_are_rail_controllers(make):
    for cp, pol, rc in ((tcp, tpol, tcore.RailController),
                        (jcp, jpol, jcore.RailController)):
        c = make(cp, pol)
        assert isinstance(c, rc) and isinstance(c.name, str)
    assert not isinstance(tpol.PhaseAware(), tcore.RailController)
    assert tcp.Telemetry.__args__[0] is ttel.TelemetryFrame
    assert tcp.Telemetry.__args__[1].__origin__ is dict


# -- the deprecated Policy.update_* shims -------------------------------------

def _metrics(n=None, seed=0):
    """A metrics dict (numpy): per-chip error observables when `n`, the
    roofline times as scalars."""
    rng = np.random.default_rng(seed)
    shape = () if n is None else (n,)
    err = lambda lo, hi: rng.uniform(lo, hi, shape).astype(np.float32)
    return {"grad_error": err(0.0, 1e-2), "straggle_rate": err(0.0, 1e-2),
            "hbm_error_rate": err(0.0, 1e-2), "t_step_s": np.float32(0.012),
            "t_comp_s": np.float32(0.004), "t_mem_s": np.float32(0.010),
            "t_coll_s": np.float32(0.003), "power_w": np.float32(150.0)}


def _planes(n):
    if n is None:
        return jpp.PowerPlaneState.nominal(), \
            tpp.PowerPlaneState.nominal(device="cpu")
    comp = np.arange(n, dtype=np.int32) % 3
    jp = dataclasses.replace(jpp.PowerPlaneState.fleet(n),
                             comp_level=jnp.asarray(comp))
    tp = dataclasses.replace(tpp.PowerPlaneState.fleet(n, device="cpu"),
                             comp_level=torch.from_numpy(comp))
    return jp, tp


def _same_plane(got, want, tol=F32):
    for f in ("v_core", "v_hbm", "v_io"):
        np.testing.assert_allclose(npy(getattr(got, f)),
                                   np.broadcast_to(npy(getattr(want, f)),
                                                   npy(getattr(got, f)).shape),
                                   err_msg=f, **tol)
    np.testing.assert_array_equal(npy(got.comp_level), npy(want.comp_level))


def _as(arr, metrics):
    return {k: arr(np.asarray(v)) for k, v in metrics.items()}


@pytest.mark.parametrize("shim", SHIMS)
@pytest.mark.parametrize("name", list(tpol.POLICIES))
def test_shim_warns_and_equals_decide(name, shim):
    """Each shim warns, and its plane is `apply_request(decide(state,
    frame))` on the frame `from_dict` builds of the same dict (a fleet
    shim's scalar entries broadcast to the fleet); and it equals the
    reference's shim on the same inputs."""
    n = 8 if shim == "update_fleet" else None
    jp, tp = _planes(n)
    metrics = _metrics(n, seed=len(name))
    tpolicy, jpolicy = tpol.POLICIES[name], jpol.POLICIES[name]
    tdict = _as(torch.from_numpy, metrics)
    with pytest.warns(tpol.ControlAPIDeprecationWarning, match=shim):
        got = getattr(tpolicy, shim)(tp, tdict)
    with pytest.warns(jpol.ControlAPIDeprecationWarning, match=shim):
        want = getattr(jpolicy, shim)(jp, _as(jnp.asarray, metrics))
    _same_plane(got, want)

    if n is None:
        frame = ttel.TelemetryFrame.from_dict(tdict, state=tp)
    else:
        bcast = {k: v.expand(n) if v.dim() == 0 else v
                 for k, v in tdict.items()}
        if isinstance(tpolicy, tpol.WorstChipGate):
            for k in tpolicy.reduce_keys:
                bcast[k] = bcast[k].max().expand(n)
        frame = ttel.TelemetryFrame.from_dict(bcast, state=tp)
    direct = tpol.apply_request(tp, tpolicy.decide(tp, frame))
    _same_plane(got, direct, tol=dict(rtol=0.0, atol=0.0))


def test_fleet_shim_broadcasts_onto_the_plane_device():
    n = 4
    _, tp = _planes(n)
    seen = {}

    class Probe(tpol.Policy):
        def decide(self, state, frame):
            seen["grad_error"] = frame.grad_error
            seen["t_step_s"] = frame.t_step_s
            return tpol.RailRequest()

    with pytest.warns(tpol.ControlAPIDeprecationWarning):
        Probe().update_fleet(tp, {"grad_error": 1e-3,
                                  "t_step_s": torch.arange(n) * 1.0})
    assert seen["grad_error"].shape == (n,)
    assert seen["grad_error"].device == tp.device
    assert torch.equal(seen["t_step_s"], torch.arange(n) * 1.0)


def test_shims_are_called_by_no_module_of_the_port():
    """An AST scan of the package, `chip_smoke.py` and `scripts/`: a call to
    `.update_jax/.update_host/.update_fleet` may stand only inside a shim
    itself (the reducing wrapper delegates to its inner policy's)."""
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
             + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("*.py")))
    calls = []
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        inside = set()
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef) and fn.name in SHIMS:
                inside.update(id(n) for n in ast.walk(fn))
        calls += [f"{path.relative_to(ROOT)}:{node.lineno}"
                  for node in ast.walk(tree)
                  if isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in SHIMS and id(node) not in inside]
    assert len(files) > 50 and not calls, calls


# -- TelemetryLog.per_chip_series / dump_jsonl --------------------------------

def _logs(n=4, steps=5):
    """Both packages' TelemetryLog after the same records: fleet metrics
    (per-chip, scalar and `fleet/` keys) and a fleet plane."""
    rng = np.random.default_rng(2)
    jlog, tlog = jtel.TelemetryLog(), ttel.TelemetryLog()
    for step in range(steps):
        m = {"power_w": rng.uniform(100, 200, n).astype(np.float32),
             "t_step_s": np.float32(0.01 + 0.001 * step),
             "grad_error": rng.uniform(0, 1e-2, n).astype(np.float32),
             "energy_step_j": rng.uniform(1, 2, n).astype(np.float32),
             "t_chip_s": rng.uniform(0.01, 0.02, n).astype(np.float32),
             "fleet/power_w_worst": np.float32(199.0)}
        v = rng.uniform(0.6, 1.0, (3, n)).astype(np.float32)
        comp = rng.integers(0, 3, n).astype(np.int32)
        loss = np.float32(3.0 - 0.1 * step)
        jp = dataclasses.replace(jpp.PowerPlaneState.fleet(n),
                                 v_core=jnp.asarray(v[0]),
                                 v_hbm=jnp.asarray(v[1]),
                                 v_io=jnp.asarray(v[2]),
                                 comp_level=jnp.asarray(comp))
        tp = dataclasses.replace(tpp.PowerPlaneState.fleet(n, device="cpu"),
                                 v_core=torch.from_numpy(v[0].copy()),
                                 v_hbm=torch.from_numpy(v[1].copy()),
                                 v_io=torch.from_numpy(v[2].copy()),
                                 comp_level=torch.from_numpy(comp.copy()))
        jlog.append_from(step, jnp.asarray(loss), _as(jnp.asarray, m), jp)
        tlog.append_from(step, torch.tensor(loss), _as(torch.from_numpy, m),
                         tp)
    return jlog, tlog


def test_per_chip_series_and_dump_jsonl_equal_the_reference(tmp_path):
    jlog, tlog = _logs()
    for key in ("power_w", "t_chip_s", "v_io", "comp_level"):
        got, want = tlog.per_chip_series(key), jlog.per_chip_series(key)
        assert got.shape == want.shape == (5, 4) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for log in (jlog, tlog):
        with pytest.raises(KeyError, match="no per-chip telemetry"):
            log.per_chip_series("t_step_s")
    jlog.dump_jsonl(tmp_path / "ref.jsonl")
    tlog.dump_jsonl(tmp_path / "port.jsonl")
    want = (tmp_path / "ref.jsonl").read_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == want
    assert want.count(b"\n") == 5
