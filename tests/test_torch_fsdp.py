"""Placed (FSDP) training (`train.step.make_train_step(..., mesh=)`) in a
gloo world of 4 processes on the CPU (`sharded_worlds.fsdp_world`), every
family of `FSDP_ARCHS` in turn (tiny MiniCPM, tiny Qwen3-MoE under the
moe_ep profile, tiny Whisper, tiny Zamba2, tiny RWKV6; f32), over a
`(data, model)` mesh of 2 x 2 (where the step computes tensor-parallel
over 'model': each rank's heads, ff, vocab or experts) and a `(data,)`
mesh of 4, params and f32 moments placed by `named_shardings`, under
`mesh_context`. Held against:

- the one-process run of the same sequence (`sharded_worlds.fsdp_oracle`:
  each DP rank's rows in turn, split over the model ranks as the TP
  forward splits them, the gradients added in rank order, the norm block
  by block), which rank 0 runs: losses, grad norms and every rank's
  blocks of the params and first moment equal bit for bit;
- the reference's train step jitted with `in_shardings` from its
  `named_shardings`, the batch over `data`, under its `mesh_context`, on 4
  forced host devices (`sharded_reference.py fsdp`, REF_CASES in two
  subprocesses: every family on the 2 x 2 mesh, the dense one on both):
  the loss within LOSS_RTOL and the grad norm within NORM_RTOL
  (the reference's mean runs over the global batch in XLA's order, the
  port's is the mean of the ranks' means in rank order), each rank's
  blocks within PARAM_TOL / MOMENT_TOL of the reference's shards but for
  at most FLIP_FRAC of a leaf's elements, each within FLIP_GAP (AdamW
  divides each element's gradient by its own magnitude, so where a
  gradient is near zero the float-level gap between XLA's and torch's
  gradients moves the update by up to the learning rate: one element of
  65,536 of tiny RWKV6's embedding, 2.3e-4), and the reference's device
  index of every leaf equal to the port's block. The MoE's load-balance
  loss reads the top-1 expert shares of the whole batch on every rank
  (`sharding.batch_mean`), as the reference's global batch does.

Without an active mesh, and under one with plain tensors, the models'
`constrain` calls change nothing: losses and gradients equal bit for bit a
run with the constraints taken out.
"""

import os
import pickle
import shutil
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

import sharded_worlds as sw
from repro.configs import get_config as jget
from repro.models import registry as jreg
from repro_torch.configs import get_config as tget
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as tshd
from repro_torch.train import step as tstep
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 300
REF_TIMEOUT_S = 400
PARAMS_SEED = 3
LOSS_RTOL = 1e-5            # test_torch_train's LOSS_TOL
NORM_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)   # TRAJ_PARAM_TOL
MOMENT_TOL = dict(rtol=1e-3, atol=1e-6)
FLIP_FRAC = 1e-4
FLIP_GAP = 2e-3             # two AdamW steps at the schedule's peak lr
CASES = [(a, m) for a, _ in sw.FSDP_ARCHS for m in sw.FSDP_MESHES]
# the runs held against the reference: the dense family on both meshes,
# the others on the (data, model) mesh, which places over both axes (the
# oracle holds every run bit for bit); two subprocesses share them
REF_CASES = [("minicpm_2b", "data2_model2"), ("minicpm_2b", "data4"),
             ("qwen3_moe_30b_a3b", "data2_model2"),
             ("whisper_base", "data2_model2"),
             ("zamba2_1p2b", "data2_model2"), ("rwkv6_7b", "data2_model2")]
REF_SPLIT = 4


@pytest.fixture(scope="module")
def fsdp():
    """(the port's 4 ranks' results, the reference's results)."""
    out = tempfile.mkdtemp(prefix="fsdp_")
    params_path = os.path.join(out, "params.pkl")
    params = {arch: jax.tree_util.tree_map(np.asarray, jreg.build(
        sw.fsdp_config(jget, arch)).init(jax.random.PRNGKey(PARAMS_SEED)))
        for arch, _ in sw.FSDP_ARCHS}
    with open(params_path, "wb") as f:
        pickle.dump(params, f)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT,
                                           os.path.join(ROOT, "tests")]))
    refs = {}
    for i, cases in enumerate((REF_CASES[:REF_SPLIT],
                               REF_CASES[REF_SPLIT:])):
        path = os.path.join(out, f"reference_{i}.pkl")
        refs[i] = (path, subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "sharded_reference.py"),
             "fsdp", path, params_path,
             *(f"{a}:{m}" for a, m in cases)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        ranks = sw.spawn_world("fsdp_world", sw.FSDP_RANKS,
                               os.path.join(out, "world"), WORLD_TIMEOUT_S,
                               env={"FSDP_PARAMS": params_path})
        ref = {}
        for name, (path, proc) in refs.items():
            _, err = proc.communicate(timeout=REF_TIMEOUT_S)
            assert proc.returncode == 0, err[-3000:]
            with open(path, "rb") as f:
                ref.update(pickle.load(f))
    finally:
        for _, proc in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out, ignore_errors=True)
    return ranks, ref


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _shardings(arch, mesh_name, tree):
    shape, axes = sw.FSDP_MESHES[mesh_name]
    return tshd.named_shardings(tree, tshd.SpecMesh(axes, shape),
                                **dict(sw.FSDP_ARCHS)[arch])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_ranks_equal_the_one_process_run_bit_for_bit(fsdp, arch, mesh):
    ranks, _ = fsdp
    want = ranks[0][arch, mesh, "oracle"]
    for r in ranks:
        got = r[arch, mesh]
        assert got["loss"] == want["loss"]
        assert got["grad_norm"] == want["grad_norm"]
        for key in ("params", "m"):
            shard = _shardings(arch, mesh, want[key])
            for path, full in _leaves(want[key]):
                sh = _get(shard, path)
                block = full[tshd.block_index(full.shape, sh, got["coord"])]
                np.testing.assert_array_equal(_get(got[key], path), block,
                                              err_msg=f"{key} {path}")


@pytest.mark.parametrize("arch,mesh", REF_CASES)
def test_blocks_equal_the_references_sharded_run(fsdp, arch, mesh):
    ranks, ref = fsdp
    want = ref[arch, mesh]
    shape, axes = sw.FSDP_MESHES[mesh]
    for r in ranks:
        got = r[arch, mesh]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=NORM_RTOL)
        rank = int(np.ravel_multi_index(got["coord"], shape))
        shard = _shardings(arch, mesh, want["params"])
        for path, full in _leaves(want["params"]):
            sh = _get(shard, path)
            mine = tshd.block_index(full.shape, sh, got["coord"])
            index = _get(want["index"], path)[rank]
            # the reference's addressable shard on this rank's device is
            # this rank's block
            assert [(s.start, s.stop) for s in mine] == \
                [tuple(i) for i in index], path
            _close_but_flips(_get(got["params"], path), full[mine],
                             PARAM_TOL, f"params {path}")
            _close_but_flips(_get(got["m"], path),
                             _get(want["m"], path)[mine], MOMENT_TOL,
                             f"m {path}")


def _close_but_flips(got, want, tol, label):
    """Within `tol` but for at most FLIP_FRAC of the elements (at least
    one), each within FLIP_GAP (module docstring)."""
    gap = np.abs(got.astype(np.float64) - want)
    out = gap > tol["atol"] + tol["rtol"] * np.abs(want)
    assert out.sum() <= max(1, FLIP_FRAC * got.size), \
        f"{label}: {out.sum()} of {got.size} apart, max {gap.max()}"
    assert gap.max() <= max(FLIP_GAP, tol["atol"]), label


def test_the_worlds_cover_every_placement_kind(fsdp):
    """Every run shards some leaf, the 2-D mesh over both axes, and the
    moe_ep profile puts the experts over 'model'."""
    ranks, _ = fsdp
    for arch, mesh in CASES:
        shard = _shardings(arch, mesh, ranks[0][arch, mesh,
                                                "oracle"]["params"])
        dims = [sh.shard_dims for _, sh in _leaves(shard)]
        assert any(d[0] is not None for d in dims)
        if mesh == "data2_model2":
            assert any(d[1] is not None for d in dims)
    moe = _shardings("qwen3_moe_30b_a3b", "data2_model2",
                     ranks[0]["qwen3_moe_30b_a3b", "data2_model2",
                              "oracle"]["params"])
    assert moe["blocks"]["moe"]["w_gate"].shard_dims[1] == 1


def _loss_and_grads(arch, monkeypatch=None, mesh=None, rules=None):
    cfg = sw.fsdp_config(tget, arch)
    params = treg.build(cfg).init(torch.Generator().manual_seed(0))
    batch = sw.fsdp_batch(cfg, 0)
    loss_fn = treg.build(cfg, remat="full").loss_fn
    if mesh is None:
        loss, _, grads = tstep._accumulate_grads(loss_fn, params, batch, 1)
    else:
        with tshd.mesh_context(mesh, rules):
            loss, _, grads = tstep._accumulate_grads(loss_fn, params, batch,
                                                     1)
    return loss, [g for _, g in _leaves(grads)]


@pytest.mark.parametrize("arch", ["minicpm_2b", "qwen3_moe_30b_a3b",
                                  "whisper_base"])
def test_constraints_change_nothing_without_a_placed_activation(
        arch, monkeypatch):
    base_loss, base_grads = _loss_and_grads(arch)
    with tshd.mesh_context(tshd.SpecMesh(("data", "model"), (2, 2)),
                           sw.fsdp_rules("data2_model2", arch)):
        assert tshd.constrain(base_grads[0], "batch", "seq", "embed") is \
            base_grads[0]
    mesh_loss, mesh_grads = _loss_and_grads(
        arch, mesh=tshd.SpecMesh(("data", "model"), (2, 2)),
        rules=sw.fsdp_rules("data2_model2", arch))
    from repro_torch.models import encdec, lm, mlp
    calls = []

    def counted(x, *logical):
        calls.append(logical)
        return x

    for mod in (lm, mlp, encdec):
        monkeypatch.setattr(mod, "constrain", counted)
    bare_loss, bare_grads = _loss_and_grads(arch)
    assert calls       # the constraint sites ran
    for loss, grads in ((base_loss, base_grads), (mesh_loss, mesh_grads)):
        assert torch.equal(loss, bare_loss)
        for a, b in zip(grads, bare_grads):
            assert torch.equal(a, b)


def test_placed_step_refuses_the_int8_moments_and_the_ef_sync():
    """The ef sync stays refused on a placed step (the reference's pmean
    needs a bound data axis: its only binding, `shard_map_ef_step`, keeps
    the params replicated). The int8 moments are taken since the TP slice
    (`tests/test_torch_tp.py`): the factory builds a step with them."""
    from repro_torch.core.power_plane import StepProfile
    mesh = tshd.SpecMesh(("data",), (2,))
    prof = StepProfile(**sw.DP_PROFILE)
    assert callable(tstep.make_train_step(
        lambda p, b: None, tadamw.AdamWConfig(state_dtype="int8"),
        lambda s: 1e-3, prof, tstep.StepConfig(), mesh=mesh))
    with pytest.raises(NotImplementedError, match="ef sync"):
        tstep.make_train_step(lambda p, b: None, tadamw.AdamWConfig(),
                              lambda s: 1e-3, prof,
                              tstep.StepConfig(grad_sync="ef_int8"),
                              mesh=mesh)
