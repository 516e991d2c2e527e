"""The port's dense LM against the reference on the reference's own
weights (carried over by `params_from_jax`): prefill logits and KV cache,
and a decode step's logits, for tiny Qwen2.5, tiny MiniCPM and a padded-GQA
Qwen variant (12 q / 4 kv heads, group 3, zero pad q slots — the pattern of
the full config's 48 / 16 / 3 that tp=1 TINY never exercises)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro_torch.configs import get_config as tget
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from torch_threads import one_torch_thread  # noqa: F401

# f32: the same math with sums in another order
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16: both packages round activations to bf16 after every op, at
# different places. The gap is absolute: ~2 ulps of the larger
# intermediates (a bf16 ulp is 0.0156 in [2, 4); measured max 0.031), which
# also lands on outputs near zero — so atol carries it, not rtol
BF16_TOL = dict(rtol=2e-2, atol=4e-2)

VARIANTS = {
    "qwen_tiny": lambda get: get("qwen2p5_14b", tiny=True),
    "minicpm_tiny": lambda get: get("minicpm_2b", tiny=True),
    "qwen_gqa_pad": lambda get: dataclasses.replace(
        get("qwen2p5_14b", tiny=True), n_heads=10, n_kv_heads=2,
        head_dim=32, tp=4),
}


def _pair(name, dtype):
    jcfg = dataclasses.replace(VARIANTS[name](jget), dtype=dtype)
    tcfg = dataclasses.replace(VARIANTS[name](tget), dtype=dtype)
    params = jreg.build(jcfg).init(jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  params)
    return jcfg, tcfg, params, treg.params_from_jax(tcfg, tree, "cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_and_decode_match_reference(name, dtype):
    jcfg, tcfg, jparams, tparams = _pair(name, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    B, T, max_len = 2, 24, 40
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)

    jlog, jcache, jT = jlm.prefill(jparams, jnp.asarray(toks), jcfg, max_len)
    tlog, tcache, tT = tlm.prefill(tparams, torch.from_numpy(toks), tcfg,
                                   max_len)
    assert jT == tT == T
    np.testing.assert_allclose(_np(tlog), _np(jlog), **tol)
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        assert tcache[key].dtype == tlm.common.default_dtype(dtype)
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **tol)

    nxt = np.array(jnp.argmax(jlog[:, -1, :jcfg.vocab_size], -1),
                   np.int32)[:, None]
    jlog2, jcache2 = jlm.decode_step(jparams, jcache, jnp.asarray(nxt),
                                     jnp.int32(T), jcfg)
    tlog2, tcache2 = tlm.decode_step(tparams, tcache, torch.from_numpy(nxt),
                                     T, tcfg)
    np.testing.assert_allclose(_np(tlog2), _np(jlog2), **tol)
    np.testing.assert_allclose(_np(tcache2["k"]), _np(jcache2["k"]), **tol)
    # padded vocab slots are masked in the logits dtype
    if tcfg.vocab_padded != tcfg.vocab_size:
        assert (tlog2[..., tcfg.vocab_size:] == -1e9).all()


def test_head_plan_matches_reference():
    for name in VARIANTS:
        assert dataclasses.astuple(VARIANTS[name](tget).head_plan()) == \
            dataclasses.astuple(VARIANTS[name](jget).head_plan())
    full_t, full_j = tget("qwen2p5_14b"), jget("qwen2p5_14b")
    assert dataclasses.astuple(full_t.head_plan()) == \
        dataclasses.astuple(full_j.head_plan())
    plan = full_t.head_plan()
    assert (plan.n_q_pad, plan.n_kv_pad, plan.group) == (48, 16, 3)
    assert full_t.vocab_padded == full_j.vocab_padded == 153600


def test_init_lm_layout_and_scale():
    """Port init: the reference's shapes, zero pad q slots, fan-in std."""
    cfg = dataclasses.replace(VARIANTS["qwen_gqa_pad"](tget), dtype="float32")
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    shapes = tlm.tree_map(lambda a: tuple(a.shape), params)
    assert shapes == tlm.param_shapes(cfg)
    pad = ~cfg.head_plan().q_pad_mask
    assert pad.sum() == 2
    assert (params["blocks"]["attn"]["wq"][:, :, pad] == 0).all()
    assert (params["blocks"]["attn"]["wo"][:, pad] == 0).all()
    w = params["blocks"]["mlp"]["w_in"]
    # truncated normal at +-2 sigma has std 0.8796 sigma
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 0.8796) < 0.02
    assert w.abs().max().item() <= 2.0 / cfg.d_model ** 0.5 + 1e-6


def test_params_from_jax_rejects_a_wrong_tree():
    cfg = tget("qwen2p5_14b", tiny=True)
    jcfg = jget("qwen2p5_14b", tiny=True)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)),
        jreg.build(jcfg).init(jax.random.PRNGKey(0)))
    del tree["blocks"]["attn"]["bq"]
    with pytest.raises(ValueError, match="keys"):
        treg.params_from_jax(cfg, tree, "cpu")
    with pytest.raises(ValueError, match="shape"):
        treg.params_from_jax(dataclasses.replace(cfg, d_ff=64),
                             jax.tree_util.tree_map(
                                 lambda a: np.asarray(a.astype(jnp.float32)),
                                 jreg.build(jcfg).init(
                                     jax.random.PRNGKey(0))), "cpu")


def test_non_dense_family_is_refused():
    """Every family of the reference builds (the moe, vlm and encdec ones
    in tests/test_torch_{moe,vlm,encdec}.py); a family the reference does
    not have is refused."""
    cfg = dataclasses.replace(tget("qwen2p5_14b", tiny=True),
                              family="diffusion")
    with pytest.raises(NotImplementedError, match="family"):
        treg.build(cfg)
    assert set(tlm.FAMILIES) | {"encdec"} == {
        "dense", "moe", "vlm", "ssm", "hybrid", "encdec"}
