"""Training the ssm family (RWKV6) and the hybrid family (Zamba2) in the
port against the reference package, on the same numpy inputs and the
reference's weights (carried over by `params_from_jax`):

- each scan's differentiable call (`ops.mamba2_scan` ->
  `mamba2_ssd.Mamba2Scan`, `ops.rwkv6_scan` -> `rwkv6_scan.Rwkv6Scan`)
  against `jax.vjp` of the reference's oracle and of the reference's
  custom_vjp around the Pallas kernel in interpret mode, with and without
  an initial state, at T that tile the Pallas chunks;
- `forward_train` loss and every leaf's gradient of tiny Zamba2 (at a
  sequence past its 64-token window) and tiny RWKV6, remat "none" and
  "full", against `jax.value_and_grad` of the reference;
- the fleet SOR train step through `Trainer.run` for both against the
  reference, and the train launcher on the CPU;
- the serve calls: under `no_grad` the scans write `state_out` in place
  and build no graph; under grad they refuse it.

The CUDA side (K8 / K9 forward, the same plain backward, bit for bit) is
in tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hwspec import FleetSpec as JFleetSpec
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import SyntheticLM as JSynth
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.train import trainer as jtrainer
from repro_torch.data.pipeline import DataConfig as TData
from repro_torch.data.pipeline import SyntheticLM as TSynth
from repro_torch.kernels import ops as tops
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw
from repro_torch.train import trainer as ttrainer
from test_torch_inputs import mamba2_inputs, rwkv_inputs
from test_torch_train import (LOSS_TOL, N_CHIPS, TRAJ_METRIC_TOL,
                              TRAJ_PARAM_TOL, TRAJ_PLANE_TOL, _batches,
                              _close_plane, _close_trees,
                              _fleet_pair, _leaf, _pair)
from torch_threads import one_torch_thread  # noqa: F401

# a scan's gradients, f32: the same recurrence walked back in both
# packages, its einsums summed in another order; held relative to each
# gradient's largest magnitude
SCAN_GRAD_TOL = 1e-5
# y of the Pallas kernels' chunked forms against the plain version: the
# tolerance of tests/test_torch_zamba2.py CHUNKED_TOL (matmuls within a
# chunk, Mamba2's decays as exp of cumulative sums)
CHUNKED_Y_TOL = dict(rtol=1e-3, atol=2e-4)
# forward_train of the tiny models, f32: sums in another order through
# the layers and the scans (72 steps); gradients relative to each leaf's
# largest magnitude
MODEL_LOSS_TOL = dict(rtol=1e-5, atol=0.0)
MODEL_GRAD_TOL = 1e-4

FAMILIES = {
    "zamba2_tiny": lambda get: get("zamba2_1p2b", tiny=True),
    "rwkv6_tiny": lambda get: get("rwkv6_7b", tiny=True),
}
# tiny Zamba2's shared block attends within a 64-token window: the
# forward_train test runs one sequence past it
SEQ = 72


def _close_rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# The scans' differentiable calls
# ---------------------------------------------------------------------------

def _scan_vjps(name, T, with_state):
    """(torch grads, oracle vjp grads, Pallas custom_vjp grads, torch y,
    Pallas y) of one scan at seeded inputs and cotangents."""
    if name == "mamba2":
        *ins, s0 = mamba2_inputs(2, T, 4, 2, 16, seed=T, state=with_state)
        torch_fn, oracle = tops.mamba2_scan, jref.mamba2_scan_reference

        def pallas(*a, init_state):
            return jops._mamba2_kernel_vjp(*a, 128, True, init_state)
    else:
        *ins, s0 = rwkv_inputs(2, T, 2, 64, seed=T, state=with_state)
        torch_fn, oracle = tops.rwkv6_scan, jref.rwkv6_scan_reference

        def pallas(*a, init_state):
            return jops._rwkv6_kernel_vjp(*a, 64, True, init_state)
    state_shape = (2,) + (s0.shape[1:] if with_state else
                          ((4, 16, 64) if name == "mamba2" else (2, 64, 64)))
    rng = np.random.default_rng(T + 7)
    dy = rng.standard_normal(ins[0].shape).astype(np.float32)
    ds = rng.standard_normal(state_shape).astype(np.float32)
    args = ins + ([s0] if with_state else [])

    t_args = [torch.from_numpy(a).requires_grad_() for a in args]
    y, st = torch_fn(*t_args[:len(ins)],
                     init_state=t_args[-1] if with_state else None)
    assert y.grad_fn is not None and st.grad_fn is not None
    t_grads = torch.autograd.grad((y, st), t_args,
                                  (torch.from_numpy(dy), torch.from_numpy(ds)))

    def call(fn):
        def f(*a):
            return fn(*a[:len(ins)], init_state=a[-1] if with_state else None)
        out, vjp = jax.vjp(f, *map(jnp.asarray, args))
        return out, vjp((jnp.asarray(dy), jnp.asarray(ds)))

    _, o_grads = call(oracle)
    (py, _), p_grads = call(pallas)
    return t_grads, o_grads, p_grads, y.detach().numpy(), np.asarray(py)


@pytest.mark.parametrize("T,with_state", [(64, False), (128, True)])
@pytest.mark.parametrize("name", ["mamba2", "rwkv6"])
def test_scan_function_matches_reference_vjps(name, T, with_state):
    """Every input's gradient (the initial state's when one is given)
    against `jax.vjp` of the oracle and of the reference's custom_vjp with
    the Pallas kernel in interpret mode, whose backward is that oracle's
    vjp; y against the Pallas kernel's chunked form."""
    t_grads, o_grads, p_grads, y, py = _scan_vjps(name, T, with_state)
    assert len(t_grads) == len(o_grads) == len(p_grads)
    for i, (t, o, p) in enumerate(zip(t_grads, o_grads, p_grads)):
        _close_rel(t.numpy(), o, SCAN_GRAD_TOL, f"{name} grad {i} oracle")
        _close_rel(t.numpy(), p, SCAN_GRAD_TOL, f"{name} grad {i} pallas")
    np.testing.assert_allclose(y, py, **CHUNKED_Y_TOL)


@pytest.mark.parametrize("name", ["mamba2", "rwkv6"])
def test_scan_state_out_serves_in_place_and_refuses_grad(name):
    """The serve call (no_grad, inputs that require grad, as a model's
    weights do) writes the final state into `state_out` (here the initial
    state itself) and builds no graph; under grad `state_out` raises; a
    call without `state_out` under grad is differentiable. On the CPU no
    hand-written kernel is launched."""
    if name == "mamba2":
        *ins, s0 = mamba2_inputs(2, 8, 4, 1, 16, seed=1)
        fn = tops.mamba2_scan
    else:
        *ins, s0 = rwkv_inputs(2, 8, 2, 64, seed=1)
        fn = tops.rwkv6_scan
    ins = [torch.from_numpy(a).requires_grad_() for a in ins]
    want_y, want_s = fn(*ins, init_state=torch.from_numpy(s0))
    tops.reset_launch_counts()
    buf = torch.from_numpy(s0.copy())
    with torch.no_grad():
        y, st = fn(*ins, init_state=buf, state_out=buf)
    assert st is buf and y.grad_fn is None and not y.requires_grad
    assert torch.equal(buf, want_s.detach()) and torch.equal(y, want_y)
    with pytest.raises(ValueError, match="state_out"):
        fn(*ins, init_state=torch.from_numpy(s0),
           state_out=torch.empty_like(buf))
    assert want_y.grad_fn is not None
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}


# ---------------------------------------------------------------------------
# forward_train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_train_loss_and_grads_match_reference(name, remat):
    jcfg, tcfg, jparams, tparams = _pair(name, FAMILIES)
    (jb, tb), = _batches(jcfg, 1, seq=SEQ, batch=2)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jb, jcfg, remat=remat),
        has_aux=True)(jparams)
    paths = tadamw.leaf_paths(tparams)
    leaves = [tadamw.get_path(tparams, p) for p in paths]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, tmet = treg.build(tcfg, remat=remat).loss_fn(tparams, tb)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), **MODEL_LOSS_TOL)
    np.testing.assert_allclose(tmet["ce_loss"].item(), float(jmet["ce_loss"]),
                               **MODEL_LOSS_TOL)
    assert len(paths) == len(jax.tree_util.tree_leaves(jgrads))
    for path, g in zip(paths, grads):
        _close_rel(g.numpy(), np.asarray(_leaf(jgrads, path)),
                   MODEL_GRAD_TOL, str(path))


# ---------------------------------------------------------------------------
# The fleet SOR step and Trainer.run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FAMILIES))
def test_trainer_run_matches_reference(name, tmp_path):
    """Three fleet SOR steps (a refit at the second) through both
    Trainers: per-step losses, comp_level and fleet metrics, the plane,
    the summary's energy and time, and the params and AdamW moments at
    the end."""
    jfn, tfn, js, ts, jcfg, (jscfg, tscfg) = _fleet_pair(name,
                                                         variants=FAMILIES)
    jt = jtrainer.Trainer(
        jfn, JSynth(JData(jcfg.vocab_size, 32, 4)),
        jtrainer.TrainerConfig(total_steps=3, ckpt_every=100,
                               ckpt_dir=str(tmp_path), async_ckpt=False,
                               fleet=JFleetSpec.sample(N_CHIPS, seed=0),
                               sor=jscfg), js)
    tt = ttrainer.Trainer(
        tfn, TSynth(TData(jcfg.vocab_size, 32, 4)),
        ttrainer.TrainerConfig(total_steps=3, sor=tscfg, device="cpu"), ts)
    jt.run()
    tt.run()
    jrec, trec = list(jt.log.records), list(tt.log.records)
    assert [r.step for r in trec] == [r.step for r in jrec] == [0, 1, 2]
    np.testing.assert_allclose([r.loss for r in trec],
                               [r.loss for r in jrec], **LOSS_TOL)
    for a, b in zip(trec, jrec):
        assert a.comp_level == b.comp_level and set(a.fleet) == set(b.fleet)
        for k in a.fleet:
            np.testing.assert_allclose(a.fleet[k], b.fleet[k],
                                       **TRAJ_METRIC_TOL, err_msg=k)
    _close_plane(tt.state["plane"], jt.state["plane"], TRAJ_PLANE_TOL)
    assert tt.state["sor"].tick == int(jt.state["sor"].tick) == 3
    _close_trees(tt.state["params"], jt.state["params"], TRAJ_PARAM_TOL,
                 "params")
    for k in ("m", "v"):
        _close_trees(tt.state["opt"][k], jt.state["opt"][k], TRAJ_PARAM_TOL,
                     k)
    js_, ts_ = jt.summary(), tt.summary()
    for k in ("steps", "energy_j", "mean_power_w", "time_s",
              "fleet_energy_j", "n_chips"):
        np.testing.assert_allclose(ts_[k], js_[k], **TRAJ_METRIC_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch,name", [("zamba2_1p2b", "zamba2-tiny"),
                                       ("rwkv6_7b", "rwkv6-tiny")])
def test_launcher_tiny_cpu_trains(arch, name, capsys):
    from repro_torch.launch import train as launch_train
    tops.reset_launch_counts()
    launch_train.main(["--arch", arch, "--tiny", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert name in out and "'steps': 2" in out
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
