"""The port's MoE layer and the moe family against the reference, on the
reference's own weights and inputs made from a numpy seed:
`moe_capacity` over a grid of T; `moe_apply` in f32 and bf16 (the routed
experts, the keep mask, y and the load-balance loss) with tokens dropped,
by a capacity factor under 1 and by a router skewed towards one expert,
and at T = 1; tiny Qwen3-30B-A3B and Grok-1: prefill and decode logits,
`ServeEngine.generate` tokens, `forward_train` loss and every gradient;
`params_from_jax` keeping the router in f32.

Top-k near-ties: `lax.top_k` and `torch.topk` pick the same experts only
where the k-th and (k+1)-th probabilities are apart, since each package
sums the f32 router product in its own order. Indices are held equal
wherever that gap exceeds NEAR_TIE; a token below it is reported and left
out, with the rest of its batch row (its ranks depend on every earlier
slot of the row)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import policy as jpol
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import registry as jreg
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.core import policy as tpol
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.engine import ServeEngine as TEngine
from torch_threads import one_torch_thread  # noqa: F401

# a gap between the k-th and (k+1)-th router probabilities below this is a
# near-tie. Measured on the tiny models' prefills (both packages, each
# layer's router from its own activations): the probabilities differ by at
# most 4.8e-7, so a gap over twice that picks the same experts in both
NEAR_TIE = 1e-6
# f32: the same math with sums in another order
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 y: both packages round the expert products to bf16 at different
# places (as tests/test_torch_models.py's BF16_TOL, the gap is ~2 ulps of
# the larger intermediates, absolute)
BF16_TOL = dict(rtol=2e-2, atol=4e-2)
# model logits and losses: f32
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ARCHS = ("qwen3_moe_30b_a3b", "grok1_314b")


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@functools.partial(jax.jit, static_argnums=2)
def _ref_routing(params, x, spec):
    """The reference's routing lines of `moe_apply`, on its arrays: (idx
    [B,T,K], keep [B,T*K], top-(k+1) gap [B,T])."""
    probs = jax.nn.softmax(jnp.einsum(
        "btd,de->bte", x.astype(jnp.float32), params["router"]), axis=-1)
    top, idx = jax.lax.top_k(probs, spec.k + 1)
    B, T = x.shape[:2]
    flat_e = idx[..., :spec.k].reshape(B, T * spec.k)
    onehot = jax.nn.one_hot(flat_e, spec.n_experts, dtype=jnp.int32)
    rank = jnp.sum((jnp.cumsum(onehot, axis=1) - onehot) * onehot, axis=-1)
    keep = rank < jmlp.moe_capacity(T, spec)
    gap = top[..., spec.k - 1] - top[..., spec.k]
    return idx[..., :spec.k], keep, gap


def _moe_inputs(spec, B, T, dtype, skew: float, seed: int):
    jparams = jmlp.init_moe(jax.random.PRNGKey(seed), spec, dtype)
    if skew:
        # every token prefers expert 0: it overflows its capacity
        jparams["router"] = jparams["router"].at[:, 0].add(skew)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, spec.d_model)).astype(np.float32)
    if skew:
        x = np.abs(x)
    jx = jnp.asarray(x, dtype)
    tparams = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if k == "router" else _tdtype(dtype))
        for k, v in jparams.items()}
    tx = torch.from_numpy(x).to(_tdtype(dtype))
    return jparams, jx, tparams, tx


def _tdtype(jdtype):
    return torch.bfloat16 if jdtype == jnp.bfloat16 else torch.float32


@pytest.mark.parametrize("n_experts,k,factor", [(8, 2, 2.0), (128, 8, 2.0),
                                                (4, 2, 0.5), (16, 1, 1.25)])
def test_moe_capacity_matches_reference(n_experts, k, factor):
    tspec = tmlp.MoESpec(64, 32, n_experts, k, factor)
    jspec = jmlp.MoESpec(64, 32, n_experts, k, factor)
    for T in (1, 2, 3, 7, 8, 15, 16, 31, 32, 100, 255, 256, 257, 1024, 4096):
        assert tmlp.moe_capacity(T, tspec) == jmlp.moe_capacity(T, jspec), T
    # the full config's decode and prefill caps
    q3 = tmlp.MoESpec(2048, 768, 128, 8)
    assert (tmlp.moe_capacity(1, q3), tmlp.moe_capacity(256, q3)) == (1, 32)


# (experts, k, capacity factor, batch, T, router skew): drops forced by a
# factor under 1 and by a skewed router; T = 1 (decode: cap 1)
MOE_CASES = {
    "drop_factor": (8, 2, 0.5, 2, 32, 0.0),
    "drop_skew": (8, 2, 2.0, 3, 24, 0.1),
    "no_drop": (8, 2, 2.0, 2, 16, 0.0),
    "decode_t1": (16, 4, 2.0, 4, 1, 0.0),
    "top1_ragged": (4, 1, 1.0, 2, 13, 0.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case, dtype):
    E, K, factor, B, T, skew = MOE_CASES[case]
    D, Fd = 32, 48
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jspec = jmlp.MoESpec(D, Fd, E, K, factor)
    tspec = tmlp.MoESpec(D, Fd, E, K, factor)
    jparams, jx, tparams, tx = _moe_inputs(jspec, B, T, jdt, skew, seed=3)
    jy, jaux = jax.jit(jmlp.moe_apply, static_argnums=2)(jparams, jx, jspec)
    ty, taux = tmlp.moe_apply(tparams, tx, tspec)

    idx, keep, gap = map(np.asarray, _ref_routing(jparams, jx, jspec))
    _, tidx, _ = tmlp.moe_route(tparams, tx, tspec)
    trank, tkeep = tmlp.moe_ranks(tidx, E, tmlp.moe_capacity(T, tspec))
    ties = np.argwhere(gap <= NEAR_TIE)
    rows = sorted(set(range(B)) - {int(b) for b, _ in ties})
    if len(ties):
        print(f"{case} {dtype}: near-ties at (row, token) {ties.tolist()}")
    assert len(rows) >= B - 1, "near-ties in most rows: the case is moot"
    np.testing.assert_array_equal(tidx.numpy()[rows], idx[rows])
    np.testing.assert_array_equal(tkeep.numpy()[rows], keep[rows])
    if case.startswith("drop"):
        assert not keep.all(), "the case must drop tokens"
    if case == "decode_t1":
        assert tmlp.moe_capacity(T, tspec) == 1 and keep.all()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(ty)[rows], _np(jy)[rows], **tol)
    assert ty.dtype == tx.dtype
    if not len(ties):
        np.testing.assert_allclose(taux["moe_aux"].item(),
                                   float(jaux["moe_aux"]), rtol=1e-5)


def test_moe_dropped_slots_carry_nothing():
    """A dropped slot adds nothing to y (the residual carries its token):
    with every slot of one token dropped, its y row is zero."""
    spec = tmlp.MoESpec(16, 8, 2, 1, capacity_factor=0.25)
    gen = torch.Generator().manual_seed(0)
    params = tmlp.init_moe(gen, spec)
    params["router"][:, 0] += 5.0
    x = torch.randn((1, 16, 16), generator=gen).abs()
    y, _ = tmlp.moe_apply(params, x, spec)
    _, idx, _ = tmlp.moe_route(params, x, spec)
    rank, keep = tmlp.moe_ranks(idx, 2, tmlp.moe_capacity(16, spec))
    assert (~keep).any()
    assert (y[0][~keep[0]] == 0).all()
    assert (y[0][keep[0]] != 0).any(dim=-1).all()


def _pair(arch, dtype="float32"):
    jcfg = dataclasses.replace(jget(arch, tiny=True), dtype=dtype)
    tcfg = dataclasses.replace(tget(arch, tiny=True), dtype=dtype)
    jparams = jreg.build(jcfg).init(jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  jparams)
    return jcfg, tcfg, jparams, treg.params_from_jax(tcfg, tree, "cpu")


def _model_gaps(jparams, jcfg, toks):
    """The top-(k+1) gap of every token at each layer's router during the
    reference's prefill of `toks`, the smallest one."""
    spec = jlm.moe_spec(jcfg)

    @jax.jit
    def gaps(params, toks):
        x = jlm.embed_tokens(params, toks, jcfg)
        B, T = toks.shape
        pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
        out = []
        for i in range(jcfg.n_layers):
            p = jax.tree_util.tree_map(lambda a: a[i], params["blocks"])
            h = jlm.common.rms_norm(x, p["ln1_w"], jcfg.norm_eps)
            a, _ = jlm.attn.attention_full(p["attn"], h, jlm.attn_spec(jcfg),
                                           pos)
            x = x + a
            h = jlm.common.rms_norm(x, p["ln2_w"], jcfg.norm_eps)
            top = jax.lax.top_k(jax.nn.softmax(jnp.einsum(
                "btd,de->bte", h, p["moe"]["router"]), axis=-1), spec.k + 1)[0]
            out.append(jnp.min(top[..., spec.k - 1] - top[..., spec.k]))
            x = x + jmlp.moe_apply(p["moe"], h, spec)[0]
        return jnp.min(jnp.stack(out))

    return float(gaps(jparams, jnp.asarray(toks)))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    B, T, max_len = 2, 24, 40
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    assert _model_gaps(jparams, jcfg, toks) > NEAR_TIE
    jlog, jcache, _ = jax.jit(lambda p, t: jlm.prefill(p, t, jcfg, max_len))(
        jparams, jnp.asarray(toks))
    tlog, tcache, _ = tlm.prefill(tparams, torch.from_numpy(toks), tcfg,
                                  max_len)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   **MODEL_TOL)
    nxt = np.array(jnp.argmax(jlog[:, -1, :jcfg.vocab_size], -1),
                   np.int32)[:, None]
    jdecode = jax.jit(lambda p, c, t, i: jlm.decode_step(p, c, t, i, jcfg))
    for step in range(3):
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(nxt),
                               jnp.int32(T + step))
        tlog, tcache = tlm.decode_step(tparams, tcache,
                                       torch.from_numpy(nxt), T + step, tcfg)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
        nxt = np.array(jnp.argmax(jlog[:, -1, :jcfg.vocab_size], -1),
                       np.int32)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    B, TP, NEW = 2, 16, 10
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, TP)).astype(np.int32)
    assert _model_gaps(jparams, jcfg, prompts) > NEAR_TIE
    je = JEngine(jcfg, jparams, max_len=TP + NEW + 8, batch_size=B,
                 policy=jpol.PhaseAware())
    te = TEngine(tcfg, tparams, max_len=TP + NEW + 8, batch_size=B,
                 policy=tpol.PhaseAware(), device="cpu")
    jtok, ttok = je.generate(prompts, NEW), te.generate(prompts, NEW)
    np.testing.assert_array_equal(ttok, jtok)
    assert len(np.unique(ttok)) > 1


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def check_loss_and_grads(jcfg, tcfg, jparams, tparams, jb, tb, remat,
                         tremat=None):
    """`forward_train` loss, ce and moe_aux, and every gradient leaf, the
    port (`tremat`, by default `remat`) against `jax.value_and_grad` of
    the reference (`remat`)."""
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.forward_train(p, jb, jcfg, remat=remat),
        has_aux=True))(jparams)
    paths = tadamw.leaf_paths(tparams)
    leaves = [tadamw.get_path(tparams, p) for p in paths]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, tmet = treg.build(tcfg, remat=tremat or remat).loss_fn(tparams,
                                                                  tb)
    grads = torch.autograd.grad(tloss, leaves)
    for leaf in leaves:
        leaf.requires_grad_(False)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    for key in ("ce_loss", "moe_aux"):
        np.testing.assert_allclose(tmet[key].item(), float(jmet[key]),
                                   **LOSS_TOL, err_msg=key)
    assert len(paths) == len(jax.tree_util.tree_leaves(jgrads))
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(_leaf(jgrads, path)),
                                   **GRAD_TOL, err_msg=str(path))
    return tmet


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_reference(arch, remat):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    rng = np.random.default_rng(2)
    B, T = 2, 32
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(-1, jcfg.vocab_size, (B, T)).astype(np.int32)
    assert _model_gaps(jparams, jcfg, toks) > NEAR_TIE
    tmet = check_loss_and_grads(
        jcfg, tcfg, jparams, tparams,
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        {"tokens": torch.from_numpy(toks),
         "labels": torch.from_numpy(labels)}, remat)
    assert tmet["moe_aux"].item() > 0


def test_params_from_jax_keeps_the_router_f32():
    cfg, jcfg = tget("qwen3_moe_30b_a3b", tiny=True), jget(
        "qwen3_moe_30b_a3b", tiny=True)
    assert cfg.dtype == "bfloat16"
    jparams = jreg.build(jcfg).init(jax.random.PRNGKey(0))
    assert jparams["blocks"]["moe"]["router"].dtype == jnp.float32
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  jparams)
    params = treg.params_from_jax(cfg, tree, "cpu")
    moe = params["blocks"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert {moe[k].dtype for k in ("w_gate", "w_in", "w_out")} == \
        {torch.bfloat16}
    np.testing.assert_array_equal(moe["router"].numpy(),
                                  tree["blocks"]["moe"]["router"])
    # the port's own init makes the same dtypes
    own = treg.build(cfg).init(torch.Generator().manual_seed(0))
    assert own["blocks"]["moe"]["router"].dtype == torch.float32
    assert tlm.tree_map(lambda a: a.dtype, own) == tlm.param_dtypes(cfg)
