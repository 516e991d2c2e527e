"""The port's error-feedback gradient sync against the reference's: the
int8 codec (K10's plain version) against the eager reference codecs and
the Pallas kernel in interpret mode, the other `ecollectives` functions,
the train step with `grad_sync="ef_int8"` and `"ef_int8_topk"` against the
reference's jitted step under a one-device `data` mesh, and `Trainer.run`.

Inputs are made with numpy from a seed and handed to both packages; model
weights carry over through `registry.params_from_jax`.

What "exact" can mean for the codec (measured on the CPU, jax 0.9.0): the
reference's eager `ecollectives.quantize_int8` and
`ref.quantize_int8_reference` are IEEE (true division, round half to
even), and the port's codec equals them bit for bit. The Pallas kernel in
interpret mode and the jitted reference are not: XLA's CPU compiler misses
the IEEE quotient `absmax / 127` by an ulp on some scales (N(0, 1) from
seed 1, n = 65,536: 21 of 256 f32 scales and 13 of 256 bf16 scales; from
seed 300,000, n = 300,000: 50 and 52 of 1,172), and where x / scale then
lands next to a .5 boundary a code flips by one (bf16: 2 of 65,536 codes;
21 of 300,000; none in f32). At n <= 4096 none differ, which is all the
reference's own sweep (`tests/test_kernels.py::test_quant_codec_sweep`)
sees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ecollectives as jec
from repro.core.policy import BERBounded as JBER
from repro.core.policy import PhaseAware as JPhaseAware
from repro.core.power_plane import StepProfile as JProfile
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import SyntheticLM as JSynth
from repro.kernels import ref as jref
from repro.kernels.quant_codec import quantize_int8 as pallas_quantize_int8
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.optim.schedule import wsd as jwsd
from repro.train import step as jstep
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config as tget
from repro_torch.core import ecollectives as tec
from repro_torch.core.policy import BERBounded as TBER
from repro_torch.core.policy import PhaseAware as TPhaseAware
from repro_torch.core.power_plane import StepProfile as TProfile
from repro_torch.data.pipeline import DataConfig as TData
from repro_torch.data.pipeline import SyntheticLM as TSynth
from repro_torch.kernels import ops
from repro_torch.kernels import quant_codec as tqc
from repro_torch.models import registry as treg
from repro_torch.models.lm import tree_map
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import wsd as twsd
from repro_torch.train import step as tstep
from repro_torch.train import trainer as ttrainer
from test_torch_inputs import codec_input, codec_ties, ef_inputs
from test_torch_train import (GRAD_TOL, LOSS_TOL, PLANE_TOL, TRAJ_PARAM_TOL,
                              _batches, _close_plane, _leaf, _pair, _sched)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of `dtype` (bf16
    rounded once, by JAX, and carried over as f32)."""
    jd, td = DTYPES[dtype]
    jx = jnp.asarray(x).astype(jd)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)


def _eq(t, j, what):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=what)


# -- the codec ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,block", [(1000, 256), (4096, 256), (65, 64),
                                     (300_000, 256)])
def test_codec_equals_the_eager_reference(n, block, dtype):
    """Codes and scales equal (==) to both eager reference codecs."""
    jx, tx = _both(codec_input(n, seed=n, block=block), dtype)
    q, s = tec.quantize_int8(tx, block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (-(-n // block), block) and s.shape == (q.shape[0], 1)
    for name, (jq, js) in (
            ("ecollectives", jec.quantize_int8(jx, block)),
            ("ref", jref.quantize_int8_reference(jx, block=block))):
        _eq(q, jq, f"{name} codes")
        _eq(s, js, f"{name} scales")


def test_codec_special_blocks_equal_the_reference():
    """Exact .5 ties (half to even), an all-zero block (scale 1), a NaN
    block (absmax NaN, so the scale is 1; the NaN's code 0) and a padded
    tail."""
    x = np.concatenate([codec_ties(), np.zeros(256, np.float32),
                        codec_input(256, seed=3), np.full(17, 0.25,
                                                          np.float32)])
    x[600] = np.nan
    q, s = tqc.quantize_int8_plain(torch.from_numpy(x))
    jq, js = jec.quantize_int8(jnp.asarray(x))
    _eq(q, jq, "codes")
    _eq(s, js, "scales")
    assert s[0].item() == 1.0 and s[1].item() == 1.0 and s[2].item() == 1.0
    assert q[0, 1:4].tolist() == [-126, -124, -124]   # -125.5 -124.5 -123.5
    assert (q[1] == 0).all() and q[2, 600 - 512].item() == 0
    assert (q[3, :17] == 127).all() and (q[3, 17:] == 0).all()  # tail


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,block", [(1000, 256), (4096, 256), (65, 64)])
def test_codec_matches_pallas_interpret_within_one_grid_step(n, block,
                                                             dtype):
    """As the reference's own sweep holds the Pallas kernel: codes equal,
    scales within rtol 1e-6."""
    jx, tx = _both(codec_input(n, seed=n, block=block), dtype)
    jq, js = pallas_quantize_int8(jx, block=block, interpret=True)
    q, s = tec.quantize_int8(tx, block)
    _eq(q, jq, "codes")
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_codec_against_pallas_interpret_over_many_grid_steps(dtype):
    """At 65,536 elements (8 grid steps of 32 blocks) the interpret-mode
    kernel's scales are off by at most one ulp in some blocks (measured:
    21 of 256 in f32, 13 in bf16), and codes differ by at most one and
    only in those blocks (measured: none in f32, 2 in bf16)."""
    jx, tx = _both(np.random.default_rng(1).standard_normal(65_536)
                   .astype(np.float32), dtype)
    jq, js = pallas_quantize_int8(jx, block=256, interpret=True)
    q, s = tec.quantize_int8(tx)
    js, jq = np.asarray(js), np.asarray(jq).astype(np.int32)
    ulps = np.abs(s.numpy().view(np.int32) - js.view(np.int32))
    assert ulps.max() <= 1
    dq = np.abs(q.numpy().astype(np.int32) - jq)
    assert dq.max() <= 1
    assert not (dq.any(axis=1) & (ulps[:, 0] == 0)).any(), \
        "a code differs in a block whose scale agrees"


def test_codec_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(codec_input(1000, seed=0))
    ops.reset_launch_counts()
    got, want = ops.quantize_int8(x), tqc.quantize_int8_plain(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts()["quantize_int8"] == 0


# -- the other functions ------------------------------------------------------

def test_dequantize_matches_the_reference():
    x = codec_input(1000, seed=5)
    q, s = jec.quantize_int8(jnp.asarray(x))
    got = tec.dequantize_int8(torch.from_numpy(np.array(q)),
                              torch.from_numpy(np.array(s)), (10, 100))
    _eq(got, jec.dequantize_int8(q, s, (10, 100)), "dequantize")


@pytest.mark.parametrize("k_fraction", [0.25, 0.1, 0.004, 1.0])
@pytest.mark.parametrize("n,block", [(1000, 256), (130, 64)])
def test_topk_mask_matches_the_reference(n, block, k_fraction):
    """Ties at the threshold are all kept (each block holds repeated
    magnitudes) and the padded tail is cut off, as the reference does."""
    rng = np.random.default_rng(n)
    x = np.round(rng.standard_normal(n) * 4).astype(np.float32) / 4
    got = tec.topk_mask(torch.from_numpy(x), k_fraction, block)
    _eq(got, jec.topk_mask(jnp.asarray(x), k_fraction, block), "topk")


def _ef_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (1000,), "b": {"w": (40, 33), "z": (7,)}}
    return {k: (rng.standard_normal(v).astype(np.float32)
                if isinstance(v, tuple) else
                {kk: rng.standard_normal(vv).astype(np.float32)
                 for kk, vv in v.items()})
            for k, v in shapes.items()}


@pytest.mark.parametrize("level", [0, 1, 2])
def test_ef_compress_matches_the_reference(level):
    """g_hat and the new residual equal (==) the eager reference's on a
    small tree with a non-zero residual; the port updates the residual tree
    in place and returns it."""
    g, r = _ef_tree(0), tree_map(lambda a: a * 0.01, _ef_tree(1))
    jg, jr = jec.ef_compress(tree_map(jnp.asarray, g),
                             tree_map(jnp.asarray, r), level, 0.25)
    tr = tree_map(torch.from_numpy, r)
    tg, tr2 = tec.ef_compress(tree_map(torch.from_numpy, g), tr, level, 0.25)
    assert tr2 is tr
    for path in tadamw.leaf_paths(tg):
        _eq(tadamw.get_path(tg, path), _leaf(jg, path), f"g_hat{path}")
        _eq(tadamw.get_path(tr2, path), _leaf(jr, path), f"resid{path}")
    np.testing.assert_allclose(
        tec.compression_error_norm(tree_map(torch.from_numpy, g), tg).item(),
        float(jec.compression_error_norm(tree_map(jnp.asarray, g), jg)),
        rtol=1e-6)   # the same squares, summed in another order


def test_compression_error_norm_matches_the_reference():
    g, h = _ef_tree(2), _ef_tree(3)
    got = tec.compression_error_norm(tree_map(torch.from_numpy, g),
                                     tree_map(torch.from_numpy, h))
    want = jec.compression_error_norm(tree_map(jnp.asarray, g),
                                      tree_map(jnp.asarray, h))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    same = tree_map(torch.from_numpy, g)
    assert tec.compression_error_norm(same, same).item() == 0.0


def _one_device(fn, *args):
    mesh = jax.make_mesh((1,), ("data",))
    spec = jax.sharding.PartitionSpec()
    return jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                         check_vma=False)(*args)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_reduce_gradients_matches_the_reference_on_one_device(level):
    """`reduce_gradients` (psum_lossless / psum_int8 / psum_int8_topk) in
    the world of one against the reference under a one-device shard_map,
    as tests/test_ecollectives.py::test_psum_int8_single_device holds it:
    rtol 1e-6 (the traced reference's scales may be an ulp off)."""
    g = _ef_tree(4)
    want = _one_device(lambda t: jec.reduce_gradients(t, "data", level),
                       tree_map(jnp.asarray, g))
    got = tec.reduce_gradients(tree_map(torch.from_numpy, g), "data", level)
    for path in tadamw.leaf_paths(got):
        np.testing.assert_allclose(tadamw.get_path(got, path).numpy(),
                                   np.asarray(_leaf(want, path)), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))
    x = codec_input(512, seed=2)
    np.testing.assert_allclose(
        tec.psum_int8(torch.from_numpy(x), "data").numpy(),
        np.asarray(_one_device(lambda a: jec.psum_int8(a, "data"),
                               jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_a_world_larger_than_one_raises(monkeypatch):
    """In a started world larger than one an axis the step did not bind
    (`train.step.shard_map_ef_step`, `ecollectives.bound_axes`) raises; the
    bound world's collectives are tested in tests/test_torch_dp.py."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(ValueError, match="not bound"):
        tec.psum_int8(torch.ones(256), "data")
    with pytest.raises(ValueError, match="not bound"):
        tec.reduce_gradients({"w": torch.ones(4)}, "data", 0)


def test_step_refuses_an_unknown_grad_sync():
    cfg = tget("minicpm_2b", tiny=True)
    with pytest.raises(ValueError, match="grad_sync"):
        tstep.make_train_step(treg.build(cfg).loss_fn, tadamw.AdamWConfig(),
                              _sched(twsd), TProfile(1.0, 1.0, 1.0, 1.0),
                              tstep.StepConfig(grad_sync="ef_int4"))


# -- the fused pass: one leaf of the ef sync (ef_sync_leaf) --------------------

def _bits(t):
    """A tensor's bit pattern, so that NaNs compare equal to themselves."""
    t = t.detach().reshape(-1)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _bit_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def _fused_case(case, dtype, seed=0):
    """`ef_inputs(case)` as (g in `dtype`, r f32) tensors."""
    g, r = ef_inputs(case, seed)
    return torch.from_numpy(g).to(DTYPES[dtype][1]), torch.from_numpy(r)


@pytest.mark.parametrize("case", ["ragged", "zeros", "nan", "ties"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("level", [1, 2])
def test_fused_plain_equals_the_unfused_sequence(level, dtype, case):
    """The fused pass's plain version (and `ef_sync_leaf_`, the step's seam)
    against today's composed sequence: `ef_compress_leaf_`, `error_sums`,
    `reduce_leaf(..., LEVEL_INT8)` and the codes `psum_int8` gathers.
    r', out, q2, s2, num and den bit for bit (NaNs included)."""
    g, r = _fused_case(case, dtype)
    r_seq, r_seam, r_plain = r.clone(), r.clone(), r.clone()
    g_hat = tec.ef_compress_leaf_(g, r_seq, level, 0.25)
    num, den = tec.error_sums(g, g_hat)
    out = tec.reduce_leaf(g_hat, "data", tec.LEVEL_INT8)
    q2, s2 = tec.quantize_int8(g_hat)
    thr = (tec.topk_thresholds(r_plain + g, 0.25) if level == 2 else None)
    got = tqc.ef_sync_leaf_plain(g, r_plain, thr)
    for name, a, b in zip(("out", "q2", "s2", "num", "den"), got,
                          (out, q2, s2, num, den)):
        assert _bit_equal(a, b), name
    assert _bit_equal(r_plain, r_seq)
    ops.reset_launch_counts()
    seam = tec.ef_sync_leaf_(g, r_seam, level, "data", 0.25)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    for name, a, b in zip(("out", "num", "den"), seam, (out, num, den)):
        assert _bit_equal(a, b), name
    assert _bit_equal(r_seam, r_seq)
    if case == "ties" and level == 2:     # more than k kept in some block
        kept = (r_seq != g.float()).reshape(-1, 256).sum(1)
        assert (kept > 64).any()


def test_topk_thresholds_are_topk_masks():
    """`topk_mask` keeps exactly the elements at or above the shared
    helper's thresholds, on zero-padded blocks."""
    x = torch.from_numpy(np.round(np.random.default_rng(3).standard_normal(
        1000) * 4).astype(np.float32) / 4)
    thr = tec.topk_thresholds(x.clone(), 0.1)
    assert thr.shape == (4, 1)
    flat = torch.cat([x, x.new_zeros(24)]).reshape(-1, 256)
    want = torch.where(flat.abs() >= thr, flat, 0.0).reshape(-1)[:1000]
    assert torch.equal(tec.topk_mask(x, 0.1), want)


def test_fused_pass_refuses_mismatched_leaves():
    g = torch.ones(512)
    with pytest.raises(ValueError, match="one shape"):
        tqc.ef_sync_leaf(g, torch.zeros(256))
    with pytest.raises(ValueError, match="one shape"):
        tqc.ef_sync_leaf(g, torch.zeros(512, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="level 1 or 2"):
        tec.ef_sync_leaf_(g, torch.zeros(512), 0, "data")


def _np_codec(x):
    """The codec in numpy f32 on [nblocks, block] rows: IEEE quotients,
    round half to even, NaN propagating through the max, a NaN's code 0."""
    amax = np.abs(x).max(axis=1, keepdims=True)
    s = np.where(amax > 0, amax / np.float32(127), np.float32(1)).astype(
        np.float32)
    with np.errstate(invalid="ignore"):
        q = np.clip(np.rint(x / s), -127, 127)
    return np.nan_to_num(q, nan=0.0).astype(np.int8), s


def np_ef_sync(g, r, level, k_fraction=0.25, block=256):
    """A numpy model of the fused kernel's arithmetic on one leaf: zero-
    padded blocks; c = r + g; the level-2 mask; g_hat = q1 * s1 with the
    product rounded before c - g_hat (no FMA); the error terms a lane at a
    time (lane l's 4-element chunks l and 32 + l, ... summed in f32 in
    order, the lanes' sums then added in float64), g * g rounded to g's
    type; then the codec on g_hat and out = q2 * s2. g is f32 or
    ml_dtypes.bfloat16. Returns (r', out, q2, s2, num, den)."""
    import ml_dtypes
    n = g.size
    nb = -(-n // block)
    gf = np.zeros(nb * block, np.float32)
    gf[:n] = g.astype(np.float32)
    c = np.zeros(nb * block, np.float32)
    c[:n] = r
    c = (c + gf).reshape(nb, block)
    kept = c
    if level == 2:
        k = max(1, int(round(k_fraction * block)))
        thr = np.sort(np.abs(c), axis=1)[:, block - k][:, None]
        kept = np.where(np.abs(c) >= thr, c, np.float32(0))
    q1, s1 = _np_codec(kept)
    g_hat = q1.astype(np.float32) * s1
    r_new = (c - g_hat).reshape(-1)[:n]
    e = gf.reshape(nb, block) - g_hat
    g2 = gf * gf
    if g.dtype == ml_dtypes.bfloat16:
        g2 = g2.astype(ml_dtypes.bfloat16).astype(np.float32)
    num = den = 0.0
    for terms, acc in ((e * e, "num"), (g2.reshape(nb, block), "den")):
        lanes = terms.reshape(nb, block // 128, 32, 4).transpose(0, 2, 1, 3)
        lanes = lanes.reshape(nb * 32, -1)
        part = np.zeros(nb * 32, np.float32)
        for j in range(lanes.shape[1]):
            part = part + lanes[:, j]
        if acc == "num":
            num = part.astype(np.float64).sum()
        else:
            den = part.astype(np.float64).sum()
    q2, s2 = _np_codec(g_hat)
    out = (q2.astype(np.float32) * s2).reshape(-1)[:n]
    return r_new, out, q2, s2, num, den


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("level", [1, 2])
def test_fused_arithmetic_model_matches_the_reference(level, dtype):
    """The numpy model of the fused kernel against the reference's
    `ef_compress` + `compression_error_norm` + `reduce_gradients(level=
    INT8)` (under a one-device shard_map) on a tree of ragged leaves up to
    4096 elements, where the reference's codec is IEEE: r' and out at 0
    ulps; each leaf's sum (g - g_hat)^2 at rtol 1e-6 and sum g^2 at rtol
    1e-6 in f32, within one ulp in bf16 (the reference's bf16 sum, the
    model's rounded once: only the order differs); in f32 the error norm at
    rtol 1e-6. And against the port's plain version: r', out, q2, s2 bit
    for bit."""
    import ml_dtypes
    rng = np.random.default_rng(7)
    sizes = {"a": (1000,), "b": (40, 33), "c": (4096,)}
    g = {k: codec_input(int(np.prod(v)), seed=i).reshape(v)
         for i, (k, v) in enumerate(sizes.items())}
    r = {k: (rng.standard_normal(v) * 1e-3).astype(np.float32)
         for k, v in sizes.items()}
    jd, td = DTYPES[dtype]
    jg = {k: jnp.asarray(v).astype(jd) for k, v in g.items()}
    g_np = {k: np.asarray(v.astype(jnp.float32)).astype(
        np.float32 if dtype == "float32" else ml_dtypes.bfloat16)
        for k, v in jg.items()}
    jh, jr = jec.ef_compress(jg, {k: jnp.asarray(v) for k, v in r.items()},
                             level, 0.25)
    jout = _one_device(lambda t: jec.reduce_gradients(t, "data", 1), jh)
    jerr = float(jec.compression_error_norm(jg, jh))
    num = den = 0.0
    for k in sizes:
        r_new, out, q2, s2, n_, d_ = np_ef_sync(g_np[k].reshape(-1),
                                                r[k].reshape(-1), level)
        num, den = num + n_, den + d_
        np.testing.assert_allclose(
            n_, float(jnp.sum((jg[k] - jh[k]) ** 2)), rtol=1e-6)
        jden = jnp.sum(jg[k] ** 2)
        if dtype == "float32":
            np.testing.assert_allclose(d_, float(jden), rtol=1e-6)
        else:
            ulps = abs(int(np.float32(d_).astype(ml_dtypes.bfloat16).view(
                np.int16)) - int(np.asarray(jden).view(np.int16)))
            assert ulps <= 1, (d_, float(jden))
        np.testing.assert_array_equal(r_new, np.asarray(jr[k]).reshape(-1),
                                      err_msg=f"r' {k}")
        np.testing.assert_array_equal(out, np.asarray(jout[k]).reshape(-1),
                                      err_msg=f"out {k}")
        tg = torch.from_numpy(g_np[k].astype(np.float32)).to(td)
        thr = (tec.topk_thresholds(torch.from_numpy(r[k]) + tg, 0.25)
               if level == 2 else None)
        rt = torch.from_numpy(r[k].copy())
        got = tqc.ef_sync_leaf_plain(tg, rt, thr)
        np.testing.assert_array_equal(rt.numpy().reshape(-1), r_new)
        np.testing.assert_array_equal(got[0].numpy().reshape(-1), out)
        np.testing.assert_array_equal(got[1].numpy(), q2)
        np.testing.assert_array_equal(got[2].numpy(), s2)
    if dtype == "float32":
        np.testing.assert_allclose(np.sqrt(num / den), jerr, rtol=1e-6)


# -- the train step -----------------------------------------------------------

PROFILE = dict(flops_per_chip=6e9, hbm_bytes_per_chip=1.4e7,
               ici_bytes_per_chip=4e6, grad_bytes_per_chip=4e6)
POLICIES = {"phase": (JPhaseAware, TPhaseAware), "ber": (JBER, TBER)}
# grad_error: the relative L2 error of g_hat against g, whose float-level
# gradient gaps and flipped codes (below) move it. Measured over 3 steps:
# rel 1.1e-6, 5.5e-6, 8.2e-5 (ef_int8) and 1.3e-6, 1.3e-7, 9.1e-7
# (ef_int8_topk).
GERR_RTOL = 5e-4
# the raw gradient, recovered as g_hat + r' - r: equal params give it at
# GRAD_TOL in step 1; after that the params have moved apart (below
# TRAJ_PARAM_TOL) and it differs by up to 2.2e-6 (measured, step 3)
EF_GRAD_TOL = dict(rtol=1e-4, atol=5e-6)
# Flipped codes: elements whose g_hat differs by more than GRAD_TOL. A
# float-level gradient gap or an ulp of the jitted reference's scale moves
# x / scale across a .5 boundary; the flip then stays in the residual.
# Measured among 901,760 parameters: 10, 139, 316 (ef_int8) and 3, 8, 33
# (ef_int8_topk) in steps 1-3.
FLIP_FRACTION = 1e-3


def _ef_pair(sync, policy):
    """(jitted reference step under a one-device data mesh, port step, JAX
    state, port state, config) and the g_hat / residual trees each step
    compresses into, recorded per call."""
    jcfg, tcfg, jparams, tparams = _pair("minicpm_tiny")
    jpol, tpol = POLICIES[policy]
    jraw = jstep.make_train_step(
        jreg.build(jcfg, remat="full").loss_fn, jadamw.AdamWConfig(),
        _sched(jwsd), JProfile(**PROFILE),
        jstep.StepConfig(grad_sync=sync, policy=jpol()))
    tfn = tstep.make_train_step(
        treg.build(tcfg, remat="full").loss_fn, tadamw.AdamWConfig(),
        _sched(twsd), TProfile(**PROFILE),
        tstep.StepConfig(grad_sync=sync, policy=tpol()))
    jfn = jax.jit(jstep.shard_map_ef_step(jraw,
                                          jax.make_mesh((1,), ("data",))))
    jplane, jef = jtrainer.initial_plane_and_ef(jparams)
    tplane, tef = ttrainer.initial_plane_and_ef(tparams)
    js = {"params": jparams, "opt": jadamw.init_state(
        jparams, jadamw.AdamWConfig()), "plane": jplane, "ef": jef}
    ts = {"params": tparams, "opt": tadamw.init_state(
        tparams, tadamw.AdamWConfig()), "plane": tplane, "ef": tef}
    return jfn, tfn, js, ts, jcfg


@pytest.fixture
def recorded(monkeypatch):
    """Record each step's g_hat and new residual on both sides: the
    reference's through a debug callback on `ecollectives.ef_compress`
    (traced into the jitted step), the port's from `ef_sync_leaf_`, the
    step's one pass a leaf: r' as it leaves, and g_hat as (g + r) - r'.
    That recovers g_hat exactly: r' = c - g_hat is exact (g_hat is 0 or
    within half a scale of c, so Sterbenz's lemma holds), so c - r' is
    g_hat."""
    rec = {"jax": [], "torch": []}
    j_orig, t_orig = jec.ef_compress, tec.ef_sync_leaf_

    def j_ef(grads, resid, level, k_fraction=0.25, block=256):
        gs, rs = j_orig(grads, resid, level, k_fraction, block)
        jax.debug.callback(lambda g, r: rec["jax"].append(
            jax.tree_util.tree_map(np.array, (g, r))), gs, rs)
        return gs, rs

    def t_ef(g, r, *args, **kw):
        c = r + g
        got = t_orig(g, r, *args, **kw)
        rec["torch"].append((c.sub_(r), r.clone()))
        return got

    monkeypatch.setattr(jec, "ef_compress", j_ef)
    monkeypatch.setattr(tec, "ef_sync_leaf_", t_ef)
    return rec


def _quantum(c, block=256):
    """Each element's block scale absmax / 127 of the compressed values c
    (top-k keeps each block's largest, so its absmax is c's)."""
    flat = np.abs(c).reshape(-1)
    pad = (-flat.size) % block
    am = np.concatenate([flat, np.zeros(pad, flat.dtype)]).reshape(
        -1, block).max(1) / 127.0
    return np.repeat(am, block)[:flat.size].reshape(c.shape)


def _check_ef_step(rec, paths, prev, step, level):
    """g_hat + r' - r (the raw gradient) within tolerance; flipped codes
    few, each within what two quantizations of the corrected values allow.
    Returns (the new residuals per side, flips)."""
    jg, jr = rec["jax"][-1]
    tol = GRAD_TOL if step == 0 else EF_GRAD_TOL
    flips, n, new = 0, 0, ([], [])
    for i, path in enumerate(paths):
        tg, tr = (a.numpy() for a in rec["torch"][i])
        gj, rj = _leaf(jg, path), _leaf(jr, path)
        ct, cj = tg + tr, gj + rj                  # corrected = g_hat + r'
        rt0, rj0 = (prev[0][i], prev[1][i]) if prev else (0.0, 0.0)
        np.testing.assert_allclose(ct - rt0, cj - rj0, **tol,
                                   err_msg=f"g_hat + r' - r {path}")
        d = np.abs(tg - gj)
        flip = d > GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(gj)
        bound = np.abs(ct - cj) + (_quantum(ct) + _quantum(cj)) / 2
        if level == tec.LEVEL_INT8_TOPK:      # kept on one side only
            bound = bound + np.maximum(np.abs(ct), np.abs(cj))
        assert (d[flip] <= bound[flip] * (1 + 1e-5)).all(), path
        flips += int(flip.sum())
        n += flip.size
        new[0].append(tr)
        new[1].append(rj)
    assert flips <= FLIP_FRACTION * n, (flips, n)
    return new, flips


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("sync", ["ef_int8", "ef_int8_topk"])
def test_ef_step_matches_the_reference(recorded, sync, policy):
    """Tiny MiniCPM in f32, 3 steps against the reference's jitted
    `shard_map_ef_step` on a one-device mesh: loss, grad_error, plane
    (comp_level exact), the compressed gradient and the residual (through
    g_hat + r' - r and the flipped codes) and params at TRAJ_PARAM_TOL (no
    element of a flipped code needed more in the measured runs: max |dp|
    8.5e-5 at lr 1e-3). BERBounded's margins of grad_error to its two
    thresholds are far above GERR_RTOL (measured: grad_error 7e-3-1e-2
    (level 1) or 0.35-0.49 (level 2) against 0.5 * bound = 2.5e-3 and
    bound = 5e-3), so the level decisions match exactly."""
    jfn, tfn, js, ts, jcfg = _ef_pair(sync, policy)
    level = {"ef_int8": 1, "ef_int8_topk": 2}[sync]
    paths = tadamw.leaf_paths(ts["params"])
    ops.reset_launch_counts()
    prev, margins = None, []
    for step, (jb, tb) in enumerate(_batches(jcfg, 3)):
        recorded["torch"].clear()
        out_j = jfn(js["params"], js["opt"], js["plane"], js["ef"], jb)
        out_t = tfn(ts["params"], ts["opt"], ts["plane"], ts["ef"], tb)
        for s, out in ((js, out_j), (ts, out_t)):
            s.update(params=out[0], opt=out[1], plane=out[2], ef=out[3])
        jm, tm = out_j[4], out_t[4]
        jax.block_until_ready(out_j)
        jax.effects_barrier()          # the recording callback has run
        assert len(recorded["torch"]) == len(paths)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   **LOSS_TOL)
        gerr = tm["grad_error"].item()
        assert gerr > 0
        np.testing.assert_allclose(gerr, float(jm["grad_error"]),
                                   rtol=GERR_RTOL)
        margins.append(min(abs(gerr / b - 1) for b in (2.5e-3, 5e-3)))
        assert margins[-1] > 10 * GERR_RTOL
        _close_plane(ts["plane"], js["plane"], PLANE_TOL)
        prev, _ = _check_ef_step(recorded, paths, prev, step, level)
        for path in paths:      # the carried residual is the recorded one
            assert torch.equal(tadamw.get_path(ts["ef"], path),
                               torch.from_numpy(prev[0][paths.index(path)]))
    for path in paths:
        np.testing.assert_allclose(
            tadamw.get_path(ts["params"], path).detach().numpy(),
            np.asarray(_leaf(js["params"], path)), **TRAJ_PARAM_TOL,
            err_msg=str(path))
    assert ops.launch_counts()["quantize_int8"] == 0    # the CPU path


def test_fleet_step_runs_the_ef_sync():
    """The fleet step shares `_grads_and_update`, so it takes the ef sync
    too (the reference reaches it only under `shard_map_ef_step`): its
    grad_error equals the scalar step's on the same state."""
    from repro_torch.core.hwspec import FleetSpec
    _, tcfg, _, tparams = _pair("minicpm_tiny")
    api = treg.build(tcfg, remat="none")
    args = (api.loss_fn, tadamw.AdamWConfig(), _sched(twsd),
            TProfile(**PROFILE), tstep.StepConfig(grad_sync="ef_int8"))
    (_, tb), = _batches(tcfg, 1)
    errs = []
    for fleet in (None, FleetSpec.uniform(1)):
        params = tree_map(lambda a: a.detach().clone(), tparams)
        plane, ef = ttrainer.initial_plane_and_ef(params, fleet=fleet)
        opt = tadamw.init_state(params, tadamw.AdamWConfig())
        fn = (tstep.make_train_step(*args) if fleet is None else
              tstep.make_fleet_train_step(
                  *args, tstep.FleetStepConfig(spec=fleet, error_gain=0.0)))
        *_, ef, metrics = fn(params, opt, plane, ef, tb)
        errs.append(metrics["grad_error"].reshape(-1)[0].item())
        assert any(bool(a.abs().sum() > 0) for a in
                   (tadamw.get_path(ef, p) for p in tadamw.leaf_paths(ef)))
    assert errs[0] > 0 and errs[0] == errs[1]


# -- Trainer.run --------------------------------------------------------------

E2E_PROFILE = dict(flops_per_chip=5e9, hbm_bytes_per_chip=5e8,
                   ici_bytes_per_chip=2e8, grad_bytes_per_chip=1.8e8)


def _port_trainer(sync, steps, seed):
    """tests/test_train_e2e.py::_setup on the port: tiny MiniCPM, remat
    none, grad-clip 1.0, the port's own init from `seed`."""
    cfg = tget("minicpm_2b", tiny=True)
    api = treg.build(cfg, remat="none")
    params = api.init(torch.Generator(device="cpu").manual_seed(seed))
    opt_cfg = tadamw.AdamWConfig(grad_clip_norm=1.0)
    plane, ef = ttrainer.initial_plane_and_ef(params)
    step = tstep.make_train_step(api.loss_fn, opt_cfg, _sched(twsd),
                                 TProfile(**E2E_PROFILE),
                                 tstep.StepConfig(grad_sync=sync))
    return ttrainer.Trainer(
        step, TSynth(TData(cfg.vocab_size, 32, 4, seed=seed)),
        ttrainer.TrainerConfig(total_steps=steps, device="cpu"),
        {"params": params, "opt": tadamw.init_state(params, opt_cfg),
         "plane": plane, "ef": ef})


def test_ef_int8_training_converges_close_to_lossless():
    """As the reference's e2e test: 25 steps of `auto` and of `ef_int8`
    from one seed end within 5 % of each other's loss (mean of the last
    five), and the compression error is observed."""
    t_auto = _port_trainer("auto", 25, seed=5)
    t_auto.run()
    t_ef = _port_trainer("ef_int8", 25, seed=5)
    t_ef.run()
    la = np.mean([r.loss for r in list(t_auto.log.records)[-5:]])
    le = np.mean([r.loss for r in list(t_ef.log.records)[-5:]])
    assert abs(le - la) / la < 0.05, (la, le)
    assert max(r.grad_error for r in t_ef.log.records) > 0
    assert all(r.grad_error == 0 for r in t_auto.log.records)


def test_trainer_run_ef_matches_reference(tmp_path):
    """4 `ef_int8_topk` steps with BERBounded through both Trainers: the
    per-step losses, grad_error records, comp_level and summary()."""
    jfn, tfn, js, ts, jcfg = _ef_pair("ef_int8_topk", "ber")
    jt = jtrainer.Trainer(
        jfn, JSynth(JData(jcfg.vocab_size, 32, 4)),
        jtrainer.TrainerConfig(total_steps=4, ckpt_every=100,
                               ckpt_dir=str(tmp_path), async_ckpt=False), js)
    tt = ttrainer.Trainer(
        tfn, TSynth(TData(jcfg.vocab_size, 32, 4)),
        ttrainer.TrainerConfig(total_steps=4, device="cpu"), ts)
    jt.run()
    tt.run()
    jrec, trec = list(jt.log.records), list(tt.log.records)
    assert [r.step for r in trec] == [r.step for r in jrec] == [0, 1, 2, 3]
    np.testing.assert_allclose([r.loss for r in trec],
                               [r.loss for r in jrec], **LOSS_TOL)
    np.testing.assert_allclose([r.grad_error for r in trec],
                               [r.grad_error for r in jrec], rtol=GERR_RTOL)
    assert min(r.grad_error for r in trec) > 0
    assert [r.comp_level for r in trec] == [r.comp_level for r in jrec]
    js_, ts_ = jt.summary(), tt.summary()
    for k in ("steps", "energy_j", "mean_power_w", "time_s"):
        np.testing.assert_allclose(ts_[k], js_[k], rtol=1e-5, err_msg=k)
    assert tt.state["ef"] is ts["ef"]       # the residuals, updated in place
