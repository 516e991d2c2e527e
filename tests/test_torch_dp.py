"""The data axis over `torch.distributed`: the error-feedback collectives
(`core/ecollectives.py`: `psum_lossless`, `psum_int8`, `psum_int8_topk`,
`pmean`, `reduce_gradients`, the fused `ef_sync_leaf_` with the wire
codes gathered) and `train.step.shard_map_ef_step`, in a gloo world of 2
processes on the CPU (`sharded_worlds.dp_world`), against the reference:
per slice in this process (`psum_int8` composed from the reference's
`quantize_int8` per rank and its `jnp.sum(axis=0)`), and its
`shard_map_ef_step` on 2 forced host devices in one subprocess
(`sharded_reference.py dp`).

Tolerances:
- The collectives: bit for bit against the reference's composition (the
  codes and scales are the reference codec's, the ranks are added in rank
  order as `jnp.sum(axis=0)` adds them), `psum_lossless` and `pmean`
  within 1e-6 (gloo's sum order is its own).
- The ef train step of tiny MiniCPM over 2 ranks: every rank's params
  equal bit for bit after every step (each applies the same reduced
  gradient), the loss is the ranks' mean; rank 0 against what the
  reference's `shard_map_ef_step` returns (its `out_specs=P()` hand back
  device 0's residual, plane and grad_error; the port keeps each rank's
  own, ROADMAP "Known disagreements") at the one-device ef step's parity
  tolerances (`tests/test_torch_ecollectives.py`, tiny MiniCPM in f32:
  loss LOSS_RTOL; params PARAM_TOL; grad_error GRAD_ERROR_RTOL; the
  residual within GRAD_ATOL except where a code flipped at a .5
  boundary, on at most FLIP_FRAC of its elements, by at most one
  quantization step).
"""

import os
import pickle
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharded_worlds as sw
from repro.configs import get_config as jget
from repro.core import ecollectives as jec
from repro.models import registry as jreg
from repro_torch.core import ecollectives as tec
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 240
REF_TIMEOUT_S = 300
LOSS_RTOL = 1e-5            # test_torch_train's LOSS_TOL
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)   # TRAJ_PARAM_TOL
GRAD_ERROR_RTOL = 5e-4      # test_torch_ecollectives' GERR_RTOL
FLIP_FRAC = 1e-3            # test_torch_ecollectives' FLIP_FRACTION
# the residual carries the raw gradient's float-level gaps (EF_GRAD_TOL's
# atol): an element apart by more holds a flipped code (measured 459 of
# 901,760 after 3 steps; 1,932 more apart by 1e-6-5e-6)
GRAD_ATOL = 5e-6


@pytest.fixture(scope="module")
def dp():
    """(the port's 2 ranks' results, the reference's 2-device results)."""
    out = tempfile.mkdtemp(prefix="dp_")
    params_path = os.path.join(out, "params.pkl")
    params = jax.tree_util.tree_map(np.asarray, jreg.build(
        sw.dp_config(jget)).init(jax.random.PRNGKey(1)))
    with open(params_path, "wb") as f:
        pickle.dump(params, f)
    ref_path = os.path.join(out, "reference.pkl")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT,
                                           os.path.join(ROOT, "tests")]))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "sharded_reference.py"),
         "dp", ref_path, params_path], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = sw.spawn_world("dp_world", sw.DP_RANKS,
                               os.path.join(out, "world"), WORLD_TIMEOUT_S,
                               env={"DP_PARAMS": params_path})
        _, err = ref.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    with open(ref_path, "rb") as f:
        return ranks, pickle.load(f)


def _ref_psum_int8(xs):
    """The reference's psum_int8 over the ranks' payloads, composed: each
    rank's `quantize_int8`, the stacked codes times scales summed over the
    rank axis, `dequantize_like`."""
    q, s = zip(*(jec.quantize_int8(jnp.asarray(x)) for x in xs))
    total = jnp.sum(jnp.stack(q).astype(jnp.float32) * jnp.stack(s), axis=0)
    return np.asarray(jec.dequantize_like(total, jnp.asarray(xs[0])))


def test_collectives_over_two_ranks_equal_the_reference_composed(dp):
    ranks, _ = dp
    xs = [sw.dp_inputs(r) for r in range(sw.DP_RANKS)]
    for r in ranks:
        assert r["axis_size"] == sw.DP_RANKS
        np.testing.assert_array_equal(r["psum_int8"], _ref_psum_int8(xs))
        np.testing.assert_array_equal(r["psum_int8_topk"], _ref_psum_int8(
            [np.asarray(jec.topk_mask(jnp.asarray(x), 0.25)) for x in xs]))
        np.testing.assert_allclose(r["psum_lossless"], xs[0] + xs[1],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["pmean"], (xs[0] + xs[1]) / 2,
                                   rtol=1e-6, atol=1e-7)
        c = [2 * x[:300] for x in xs]
        np.testing.assert_allclose(r["reduce_0"], (c[0] + c[1]) / 2,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(r["reduce_1"], _ref_psum_int8(c) / 2)
        np.testing.assert_array_equal(r["reduce_2"], _ref_psum_int8(
            [np.asarray(jec.topk_mask(jnp.asarray(x), 0.25)) for x in c])
            / 2)
    for key in ("psum_int8", "psum_lossless", "pmean"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


def test_an_unbound_axis_in_a_world_of_two_raises(monkeypatch):
    """Outside `shard_map_ef_step` (or `bound_axes`) a started world larger
    than one has no group for the axis."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(ValueError, match="not bound"):
        tec.psum_int8(torch.ones(256), "data")
    with pytest.raises(ValueError, match="not bound"):
        tec.pmean(torch.ones(2), "data")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree, np.float32)


def test_ef_step_ranks_stay_equal_and_keep_their_own_residuals(dp):
    ranks, _ = dp
    a, b = ranks[0]["ef"], ranks[1]["ef"]
    assert a["loss"] == b["loss"]          # the loss is the ranks' mean
    for (pa, la), (pb, lb) in zip(_leaves(a["params"]), _leaves(b["params"])):
        assert pa == pb
        np.testing.assert_array_equal(la, lb, err_msg=str(pa))
    # each rank's error feedback compresses its own gradient
    assert a["grad_error"] != b["grad_error"]
    assert any(not np.array_equal(la, lb) for (_, la), (_, lb) in
               zip(_leaves(a["ef"]), _leaves(b["ef"])))


def test_ef_step_over_two_ranks_against_the_reference(dp):
    ranks, ref = dp
    got, want = ranks[0]["ef"], ref["ef"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_error"], want["grad_error"],
                               rtol=GRAD_ERROR_RTOL)
    assert got["comp_level"] == want["comp_level"]
    np.testing.assert_allclose(got["v_io"], want["v_io"], rtol=1e-6)
    for (pa, la), (pb, lb) in zip(_leaves(got["params"]),
                                  _leaves(want["params"])):
        assert pa == pb
        np.testing.assert_allclose(la, lb, err_msg=str(pa), **PARAM_TOL)
    n = flips = 0
    for (pa, la), (pb, lb) in zip(_leaves(got["ef"]), _leaves(want["ef"])):
        assert pa == pb
        gap = np.abs(la - lb)
        # a flipped code moves the residual by one quantization step; a
        # residual is at most half a step, so a step is at most twice the
        # leaf's largest residual
        assert gap.max() <= 2 * max(np.abs(la).max(), np.abs(lb).max()) \
            + 1e-7, pa
        flips += int((gap > GRAD_ATOL).sum())
        n += la.size
    assert flips <= FLIP_FRAC * n, (flips, n)
