"""The encoder-decoder family (Whisper) on the port against the reference,
on the reference's own weights and inputs made from a numpy seed: the
GELU MLP (the tanh approximation `jax.nn.gelu` defaults to), `encode_kv`
and both cross-attention paths (`attention_full(cross_kv=)` and
`attention_decode(cross_kv=)`, non-causal at T != S), tiny Whisper's
`encode`, `cross_kv`, `decode_train` logits, `forward_train` loss and every
gradient, and a run of `decode_step`s through `registry.build(cfg)
.decode_fn`; the parameter tree read without allocating; the serve
launcher's and `ServeEngine.generate`'s refusals; the train launcher."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import mlp as jmlp
from repro.models import registry as jreg
from repro_torch.configs import get_config as tget
from repro_torch.core import policy as tpol
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm
from repro_torch.models import mlp as tmlp
from repro_torch.models import registry as treg
from repro_torch.models.common import plan_head_padding
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.engine import ServeEngine as TEngine

ARCH = "whisper_base"
# f32: the same math with sums in another order
F32_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# bf16 (the GELU MLP): as tests/test_torch_models.py's BF16_TOL
BF16_TOL = dict(rtol=2e-2, atol=4e-2)
N_PARAMS = 185_436_160        # whisper_base's tree, 67.1 M of it dec_pos


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    p = jmlp.init_gelu_mlp(jax.random.PRNGKey(0), 32, 96, jdt)
    p = {k: v + (0.1 if k.startswith("b") else 0.0) for k, v in p.items()}
    x = np.random.default_rng(0).standard_normal((2, 9, 32)).astype(
        np.float32) * 3
    jy = jmlp.gelu_mlp(p, jnp.asarray(x, jdt))
    ty = tmlp.gelu_mlp({k: _t(v, tdt) for k, v in p.items()},
                       torch.from_numpy(x).to(tdt))
    np.testing.assert_allclose(_np(ty), _np(jy),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))
    if dtype == "float32":
        # the exact erf GELU parts from the reference by ~1e-3: tanh it is
        h = torch.from_numpy(x) @ _t(p["w_in"]) + _t(p["b_in"])
        exact = torch.nn.functional.gelu(h) @ _t(p["w_out"]) + _t(p["b_out"])
        assert np.abs(exact.numpy() - _np(jy)).max() > 1e-4


def _cross_spec(mod, n_heads, n_kv, tp, causal):
    plan = plan_head_padding(n_heads, n_kv, tp)
    return mod.AttnSpec(d_model=64, head_dim=16, plan=plan, qkv_bias=True,
                        causal=causal, use_rotary=False)


# (q heads, kv heads, tp): MHA, GQA, MHA zero-padded by the plan
HEADS = [(4, 4, 1), (4, 2, 1), (3, 3, 4)]


@pytest.mark.parametrize("heads", HEADS)
def test_encode_kv_and_cross_attention_match_reference(heads):
    """The non-causal cross attention at T != S (a 7-token decoder over 23
    encoder positions), training path and decode path, against the
    reference with the same weights; the decode path reads all S
    positions and writes no cache."""
    jspec = _cross_spec(jattn, *heads, causal=False)
    tspec = _cross_spec(tattn, *heads, causal=False)
    p = jattn.init_attention(jax.random.PRNGKey(3), jspec)
    rng = np.random.default_rng(4)
    p = {k: v + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                 if k.startswith("b") else 0.0) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    x_enc = rng.standard_normal((2, 23, 64)).astype(np.float32)
    x_dec = rng.standard_normal((2, 7, 64)).astype(np.float32)
    jk, jv = jattn.encode_kv(p, jnp.asarray(x_enc), jspec)
    tk, tv = tattn.encode_kv(tp, torch.from_numpy(x_enc), tspec)
    np.testing.assert_allclose(_np(tk), _np(jk), **F32_TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **F32_TOL)

    jy, _ = jattn.attention_full(p, jnp.asarray(x_dec), jspec,
                                 cross_kv=(jk, jv))
    ty, (k2, v2) = tattn.attention_full(tp, torch.from_numpy(x_dec), tspec,
                                        cross_kv=(tk, tv))
    np.testing.assert_allclose(_np(ty), _np(jy), **F32_TOL)
    assert k2 is tk and v2 is tv

    # a causal spec is not causal across: the cross path ignores the mask
    cspec = dataclasses.replace(tspec, causal=True)
    ty2, _ = tattn.attention_full(tp, torch.from_numpy(x_dec), cspec,
                                  cross_kv=(tk, tv))
    np.testing.assert_array_equal(ty2.numpy(), ty.numpy())

    jy1, _ = jattn.attention_decode(p, jnp.asarray(x_dec[:, :1]), None, 5,
                                    jspec, cross_kv=(jk, jv))
    cache = {"k": torch.zeros(2, 4, tspec.plan.n_kv_pad, 16)}
    ty1, c = tattn.attention_decode(tp, torch.from_numpy(x_dec[:, :1]), cache,
                                    5, tspec, cross_kv=(tk, tv))
    np.testing.assert_allclose(_np(ty1), _np(jy1), **F32_TOL)
    assert c is cache and not cache["k"].any()
    # the first decoder token's cross output is the training path's row 0
    np.testing.assert_allclose(ty1.numpy(), ty[:, :1].numpy(), **F32_TOL)


def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jget(ARCH, tiny=True), dtype=dtype)
    tcfg = dataclasses.replace(tget(ARCH, tiny=True), dtype=dtype)
    jparams = jreg.build(jcfg).init(jax.random.PRNGKey(1))
    # non-zero biases and layer-norm shifts, so their paths are checked
    rng = np.random.default_rng(9)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + rng.standard_normal(a.shape).astype(np.float32)
        * 0.05 if path[-1].key in ("b", "bq", "bk", "bv", "b_in", "b_out")
        else a, jparams)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  jparams)
    return jcfg, tcfg, jparams, treg.params_from_jax(tcfg, tree, "cpu")


def _inputs(cfg, B=2, T=12, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model)).astype(
        np.float32) * 0.5
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab_size, (B, T)).astype(np.int32)
    return frames, toks, labels


def test_encode_cross_kv_and_decode_train_match_reference():
    jcfg, tcfg, jparams, tparams = _pair()
    frames, toks, _ = _inputs(jcfg)
    jenc = jax.jit(lambda p, f: jencdec.encode(p, f, jcfg))(
        jparams, jnp.asarray(frames))
    tenc = tencdec.encode(tparams, torch.from_numpy(frames), tcfg)
    np.testing.assert_allclose(_np(tenc), _np(jenc), **MODEL_TOL)
    jkv = jencdec.cross_kv(jparams, jenc, jcfg)
    tkv = tencdec.cross_kv(tparams, tenc, tcfg)
    for key in ("k", "v"):
        assert tuple(tkv[key].shape) == jkv[key].shape
        np.testing.assert_allclose(_np(tkv[key]), _np(jkv[key]), **MODEL_TOL)
    jlog = jax.jit(lambda p, e, t: jencdec.decode_train(p, e, t, jcfg))(
        jparams, jenc, jnp.asarray(toks))
    tlog = tencdec.decode_train(tparams, tenc, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_forward_train_loss_and_grads_match_reference():
    jcfg, tcfg, jparams, tparams = _pair()
    frames, toks, labels = _inputs(jcfg, seed=1)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks),
          "labels": jnp.asarray(labels)}
    tb = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels)}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jencdec.forward_train(p, jb, jcfg), has_aux=True))(jparams)
    paths = tadamw.leaf_paths(tparams)
    leaves = [tadamw.get_path(tparams, p) for p in paths]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, tmet = treg.build(tcfg).loss_fn(tparams, tb)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    assert tmet["moe_aux"].item() == 0.0 == float(jmet["moe_aux"])
    assert len(paths) == len(jax.tree_util.tree_leaves(jgrads))
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(_leaf(jgrads, path)),
                                   **GRAD_TOL, err_msg=str(path))


def test_decode_steps_match_reference():
    """Eight greedy steps from the encoder's cross K/V through each
    package's `registry.build(cfg).decode_fn`: logits and the self-attention
    cache at each step; the port's cache is written in place."""
    jcfg, tcfg, jparams, tparams = _pair()
    frames, _, _ = _inputs(jcfg, seed=2)
    B, max_len = 2, 16
    japi, tapi = jreg.build(jcfg), treg.build(tcfg)
    assert tapi.prefill_fn is None
    jenc = jax.jit(lambda p, f: jencdec.encode(p, f, jcfg))(
        jparams, jnp.asarray(frames))
    jkv = jencdec.cross_kv(jparams, jenc, jcfg)
    tkv = tencdec.cross_kv(tparams, tencdec.encode(
        tparams, torch.from_numpy(frames), tcfg), tcfg)
    jcache = japi.init_decode_cache(B, max_len)
    tcache = tapi.init_decode_cache(B, max_len, "cpu")
    jdecode = jax.jit(japi.decode_fn)
    tok = np.zeros((B, 1), np.int32)
    for i in range(8):
        jlog, jcache = jdecode(jparams, jcache, {
            "tokens": jnp.asarray(tok), "cur_index": jnp.int32(i),
            "cross_kv": jkv})
        tlog, tc = tapi.decode_fn(tparams, tcache, {
            "tokens": torch.from_numpy(tok), "cur_index": i,
            "cross_kv": tkv})
        assert tc is tcache
        np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
        np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]),
                                   **MODEL_TOL)
        tok = np.array(jnp.argmax(jlog[:, -1, :jcfg.vocab_size], -1),
                       np.int32)[:, None]
        assert np.array_equal(
            tlog[:, -1, :tcfg.vocab_size].argmax(-1).numpy()[:, None], tok)


def test_parameter_tree_read_without_allocating():
    """The full configuration's shape tree against the reference's
    `abstract_params`: the same leaves under the same names, shapes and
    dtypes; 185.4 M parameters, 67.1 M of them the decoder positions. Its
    head plan zero-pads the 8 heads x 64 to 16 q and 16 kv slots."""
    cfg = tget(ARCH)
    shapes, dtypes = tencdec.param_shapes(cfg), tencdec.param_dtypes(cfg)
    abstract = jreg.abstract_params(jget(ARCH))
    flat_j = {jax.tree_util.keystr(path): (tuple(a.shape), str(a.dtype))
              for path, a in jax.tree_util.tree_leaves_with_path(abstract)}
    paths = tadamw.leaf_paths(shapes)
    flat_t = {"".join(f"['{k}']" for k in p): (
        tuple(tadamw.get_path(shapes, p)),
        str(tadamw.get_path(dtypes, p)).split(".")[-1]) for p in paths}
    assert flat_t == flat_j
    n = sum(math.prod(s) for s, _ in flat_t.values())
    assert n == N_PARAMS
    assert math.prod(shapes["dec_pos"]) == 67_108_864
    plan = cfg.head_plan()
    assert (plan.n_q_pad, plan.n_kv_pad, plan.group, cfg.head_dim_) == \
        (16, 16, 1, 64)


def test_serve_launcher_and_generate_refuse_encdec():
    with pytest.raises(SystemExit, match="cross"):
        launch_serve.main(["--arch", ARCH, "--tiny", "--device", "cpu"])
    cfg = tget(ARCH, tiny=True)
    params = treg.build(cfg).init(torch.Generator().manual_seed(0))
    eng = TEngine(cfg, params, max_len=16, batch_size=1,
                  policy=tpol.PhaseAware(), device="cpu")
    with pytest.raises(NotImplementedError, match="prefill"):
        eng.generate(np.zeros((1, 4), np.int32), 2)


def test_train_launcher_takes_whisper(capsys):
    launch_train.main(["--arch", ARCH, "--tiny", "--steps", "2", "--seq",
                       "16", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "whisper-tiny: 18.0M params (tiny=True)" in out
    first, last = out.split("loss ")[1].split(";")[0].split(" -> ")
    assert math.isfinite(float(first)) and math.isfinite(float(last))
    assert lm.FAMILIES == ("dense", "moe", "vlm", "ssm", "hybrid")
