"""The ssm family (RWKV6) in the port against the reference package, on the
same numpy inputs: the K9 plain version against `repro.kernels.ref` and
against the Pallas kernel in interpret mode, the state carry, the time-mix
and channel-mix, tiny RWKV6 prefill and decode on the reference's weights
(carried over by `params_from_jax`, which keeps the reference's f32
leaves) and the launcher on the CPU. The slice's `generate` parity is in
tests/test_torch_serve.py, training in tests/test_torch_train_families.py,
the CUDA kernel against its plain version in
tests/test_torch_kernels_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ref as jref
from repro.kernels import rwkv6_scan as jr6
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rwkv6_scan as tr6
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.models import rwkv6 as trwkv
from test_torch_inputs import (bf16_round, bf16_split, rwkv_adversarial_w,
                               rwkv_inputs)

# f32 recurrence: the same products summed in another order (the
# reference's einsum over keys against a sequential sum), relative to the
# output's magnitude (|y| reaches ~30 at T = 200)
SCAN_TOL = dict(rtol=1e-5, atol=1e-4)
# f32 blocks and model: sums in another order through a few matmuls
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 model: both packages round activations to bf16 after every op, at
# different places (XLA fuses elementwise bf16 chains and rounds once); the
# gap is a few bf16 ulps of O(1) values (an ulp is 2^-8 of the value;
# measured max 0.07 on the logits over three seeds)
BF16_TOL = dict(rtol=2e-2, atol=5e-2)
# the f32 recurrent state of a bf16 model sums T products of bf16 k and v,
# each of which may round to a neighbouring bf16 value in the other
# package, so its gap grows with its magnitude: held relative to the
# largest |state| (measured <= 1.1 % over three seeds, T = 24..26)
BF16_STATE_TOL = 2e-2


def _t(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(None if a is None else jnp.asarray(a) for a in arrays)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# K9: the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 16, 64, 200])
def test_rwkv6_plain_matches_reference(T, with_state):
    r, k, v, w, u, s0 = rwkv_inputs(2, T, 2, 64, seed=T, state=with_state)
    y, s = tr6.rwkv6_scan_plain(*_t(r, k, v, w, u), init_state=_t(s0)[0])
    y_j, s_j = jref.rwkv6_scan_reference(*_j(r, k, v, w, u),
                                         init_state=_j(s0)[0])
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **SCAN_TOL)


@pytest.mark.parametrize("T,chunk", [(16, 64), (64, 64), (128, 64)])
def test_rwkv6_plain_matches_pallas_interpret(T, chunk):
    """Against the Pallas kernel run in interpret mode, at T that tile by
    its chunk (the Pallas kernel refuses others; the port does not)."""
    r, k, v, w, u, s0 = rwkv_inputs(1, T, 2, 64, seed=T + 1)
    y, s = tr6.rwkv6_scan_plain(*_t(r, k, v, w, u), init_state=_t(s0)[0])
    y_j, s_j = jr6.rwkv6_scan(*_j(r, k, v, w, u), chunk=chunk,
                              init_state=jnp.asarray(s0), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **SCAN_TOL)


def test_rwkv6_plain_bf16_inputs():
    """bf16 r, k, v: y comes back in bf16, the state in f32, as the
    reference's."""
    r, k, v, w, u, _ = rwkv_inputs(1, 24, 2, 64, seed=7, state=False)
    rt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (r, k, v))
    y, s = tops.rwkv6_scan(rt, kt, vt, *_t(w, u))
    y_j, s_j = jref.rwkv6_scan_reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)), *_j(w, u))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert y_j.dtype == jnp.bfloat16 and s_j.dtype == jnp.float32
    np.testing.assert_allclose(_np(y), _np(y_j), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **SCAN_TOL)


def test_rwkv6_state_carry():
    """0..h, then h..T from the carried state, equals the whole run."""
    T, h = 200, 77
    r, k, v, w, u, s0 = _t(*rwkv_inputs(2, T, 2, 64, seed=3))
    y, s = tops.rwkv6_scan(r, k, v, w, u, init_state=s0)
    y1, s1 = tops.rwkv6_scan(*(a[:, :h] for a in (r, k, v, w)), u,
                             init_state=s0)
    y2, s2 = tops.rwkv6_scan(*(a[:, h:] for a in (r, k, v, w)), u,
                             init_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **SCAN_TOL)
    torch.testing.assert_close(s2, s, **SCAN_TOL)


def test_rwkv6_cpu_dispatch_runs_the_plain_version():
    r, k, v, w, u, s0 = _t(*rwkv_inputs(1, 5, 2, 64, seed=5))
    tops.reset_launch_counts()
    got = tops.rwkv6_scan(r, k, v, w, u, init_state=s0)
    want = tr6.rwkv6_scan_plain(r, k, v, w, u, init_state=s0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tops.launch_counts()["rwkv6_scan"] == 0


def test_rwkv6_state_out_gives_todays_results():
    """The plain version's `state_out`, a separate buffer or `init_state`
    itself, gives the same y and state as a call without it, and returns
    that buffer."""
    r, k, v, w, u, s0 = _t(*rwkv_inputs(2, 37, 2, 64, seed=9))
    y, s = tops.rwkv6_scan(r, k, v, w, u, init_state=s0)
    out = torch.full_like(s0, float("nan"))
    y1, s1 = tops.rwkv6_scan(r, k, v, w, u, init_state=s0, state_out=out)
    alias = s0.clone()
    y2, s2 = tops.rwkv6_scan(r, k, v, w, u, init_state=alias,
                             state_out=alias)
    assert s1 is out and s2 is alias
    for yy, ss in ((y1, s1), (y2, s2)):
        assert torch.equal(yy, y) and torch.equal(ss, s)
    y0, s0_out = tops.rwkv6_scan(r, k, v, w, u,
                                 state_out=torch.empty_like(s0))
    y0_want, s0_want = tops.rwkv6_scan(r, k, v, w, u)
    assert torch.equal(y0, y0_want) and torch.equal(s0_out, s0_want)


# ---------------------------------------------------------------------------
# K9's chunked arithmetic (csrc/rwkv6_scan.cu), modelled in numpy
# ---------------------------------------------------------------------------

def rwkv6_chunked_model(r, k, v, w, u, s0=None, tensor_cores=False):
    """K9's prefill as the kernel computes it, in numpy f32: chunks of
    `CHUNK` steps in the kernel's two passes (chunk 0 from the initial
    state, the others but the last from 0, each leaving its end state and
    per-key decay; then each later chunk from the fold of those before
    it), each walked in sub-chunks of `SUB` steps. e = exp(w) once
    an element; every decay is a running product of e taken in step order:
    rh_t = r_t prod_{m<t} e_m, kh_j = k_j prod_{m>j} e_m, and the scores
    A_tj (j < t) by walking k_j along t, multiplying by e_t after each
    step; A_tt is the bonus r_t . (u k_t). `tensor_cores` models the bf16
    path's operands: kh as three bf16 terms, S, rh and A as two, S rh as
    hi*hi + lo*hi + hi*lo (r, k, v are bf16 already). Returns (y f32,
    before the kernel's bf16 store, and the final state)."""
    f = np.float32
    B, T, H, Dh = r.shape
    SUB = tr6.SUB
    nc = -(-T // tr6.CHUNK)
    pad = nc * tr6.CHUNK - T

    def padded(a):
        return np.concatenate(
            [a.astype(f), np.zeros((B, pad) + a.shape[2:], f)], 1)

    rp, kp, vp = padded(r), padded(k), padded(v)
    e = np.exp(padded(w))                           # 1 past T (w 0)
    uk = u.astype(f)
    y = np.zeros((B, nc * tr6.CHUNK, H, Dh), f)
    ein = lambda spec, *a: np.einsum(spec, *a).astype(f)   # noqa: E731

    def walk(S, c, with_y):
        cdec = np.ones((B, H, Dh), f)
        for r0 in range(c * tr6.CHUNK, (c + 1) * tr6.CHUNK, SUB):
            if r0 >= T:
                break
            sl = slice(r0, r0 + SUB)
            es, rs, ks, vs = e[:, sl], rp[:, sl], kp[:, sl], vp[:, sl]
            pre = np.ones_like(es)                  # prod_{m<t}
            for t in range(1, SUB):
                pre[:, t] = pre[:, t - 1] * es[:, t - 1]
            db = pre[:, -1] * es[:, -1]
            suf = np.ones_like(es)                  # prod_{m>t}
            for t in range(SUB - 2, -1, -1):
                suf[:, t] = suf[:, t + 1] * es[:, t + 1]
            kh = ks * suf
            if with_y:
                rh = rs * pre
                A = np.zeros((B, H, SUB, SUB), f)
                for j in range(SUB):
                    A[:, :, j, j] = (rs[:, j] * (uk * ks[:, j])).sum(-1)
                    co = ks[:, j]
                    for t in range(j + 1, SUB):
                        A[:, :, t, j] = (rs[:, t] * co).sum(-1)
                        co = co * es[:, t]
                if tensor_cores:
                    (sh, sl_), (rhh, rhl) = bf16_split(S, 2), bf16_split(rh, 2)
                    yi = (ein("bthi,bhij->bthj", rhh, sh)
                          + ein("bthi,bhij->bthj", rhh, sl_)
                          + ein("bthi,bhij->bthj", rhl, sh))
                    ya = sum(ein("bhtu,buhj->bthj", aq, vs)
                             for aq in bf16_split(A, 2))
                else:
                    yi = ein("bthi,bhij->bthj", rh, S)
                    ya = ein("bhtu,buhj->bthj", A, vs)
                y[:, sl] = yi + ya
            S = S * db[..., None]
            for kq in (bf16_split(kh, 3) if tensor_cores else (kh,)):
                S = S + ein("bthi,bthj->bhij", kq, vs)
            cdec = cdec * db
        return S, cdec

    S = np.zeros((B, H, Dh, Dh), f) if s0 is None else s0.astype(f)
    if nc == 1:                 # one pass: chunk 0 from the initial state
        S, _ = walk(S, 0, True)
        return y[:, :T], S
    # pass 0: chunk 0 from the initial state (with y), the others but the
    # last from 0; each leaves its end state in a slot, with its decay
    slots = [walk(S, 0, True)] + [walk(np.zeros_like(S), c, False)
                                  for c in range(1, nc - 1)]
    # pass 1: chunk c from the fold of the slots before it
    for c in range(1, nc):
        S = slots[0][0]
        for cc in range(1, c):
            S = S * slots[cc][1][..., None] + slots[cc][0]
        S, _ = walk(S, c, True)
    return y[:, :T], S


def _rel(a, b):
    """max |a - b| relative to max(|b|, 1), as the card tests hold it."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


# the model against the reference: f32 sums in another order (1e-5,
# relative to the largest magnitude, as chip_smoke.py holds the kernel);
# the tensor-core path's two-term operands keep ~16 bits, so y within 1e-4
# (the kernel then rounds y to bf16, 2^-8)
MODEL_TOL = dict(y={False: 1e-5, True: 1e-4}, state=1e-5)
# the Pallas kernel walks each step as the reference does, so the model is
# held to it as to the reference
MODEL_TS = [1, 37, 63, 64, 65, 200, 256]


@pytest.mark.parametrize("tensor_cores", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", MODEL_TS)
def test_rwkv6_chunked_model_matches_reference_and_pallas(
        T, with_state, tensor_cores):
    """The numpy model of K9's chunked arithmetic against the reference's
    sequential scan and the Pallas kernel in interpret mode (MODEL_TOL), at
    T on and around the chunk and sub-chunk edges. The tensor-core path's
    inputs are bf16 values."""
    r, k, v, w, u, s0 = rwkv_inputs(1, T, 2, 64, seed=T + 5,
                                    state=with_state)
    if tensor_cores:
        r, k, v = (bf16_round(a) for a in (r, k, v))
    y, s = rwkv6_chunked_model(r, k, v, w, u, s0, tensor_cores)
    y_r, s_r = jref.rwkv6_scan_reference(*_j(r, k, v, w, u),
                                         init_state=_j(s0)[0])
    y_p, s_p = jr6.rwkv6_scan(*_j(r, k, v, w, u), chunk=T if T % 64 else 64,
                              init_state=None if s0 is None
                              else jnp.asarray(s0), interpret=True)
    for want_y, want_s in ((y_r, s_r), (y_p, s_p)):
        assert _rel(y, want_y) <= MODEL_TOL["y"][tensor_cores]
        assert _rel(s, want_s) <= MODEL_TOL["state"]


@pytest.mark.parametrize("tensor_cores", [False, True])
def test_rwkv6_chunked_model_at_an_adversarial_decay(tensor_cores):
    """sum |w| over a chunk far past 88 (w = -3 on one head, 192 a chunk;
    w down to -40 a step on another, mixed with decays near 1): the
    factorised form's e^{-W} overflows f32 on these inputs, while the
    running products stay finite and within MODEL_TOL of the reference."""
    T = 256
    r, k, v, w, u, s0 = rwkv_inputs(1, T, 2, 64, seed=13)
    w = rwkv_adversarial_w(w, seed=13)
    if tensor_cores:
        r, k, v = (bf16_round(a) for a in (r, k, v))
    cum = -np.cumsum(w[:, :tr6.CHUNK], axis=1, dtype=np.float32)
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.exp(cum)).all()     # the trap is set
    y, s = rwkv6_chunked_model(r, k, v, w, u, s0, tensor_cores)
    y_r, s_r = jref.rwkv6_scan_reference(*_j(r, k, v, w, u),
                                         init_state=_j(s0)[0])
    assert np.isfinite(y).all() and np.isfinite(s).all()
    assert _rel(y, y_r) <= MODEL_TOL["y"][tensor_cores]
    assert _rel(s, s_r) <= MODEL_TOL["state"]


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------

def _block_params(seed: int = 0):
    """Reference time-/channel-mix weights with every leaf perturbed (the
    reference init leaves the lerp bases and norms constant), as numpy."""
    spec = jrwkv.Rwkv6Spec(d_model=128, d_ff=256)
    params = jrwkv.init_rwkv6(jax.random.PRNGKey(seed), spec)
    rng = np.random.default_rng(seed)
    tree = {name: (np.asarray(a, np.float32)
                   + 0.1 * rng.standard_normal(a.shape).astype(np.float32))
            for name, a in params.items()}
    return spec, tree


@pytest.mark.parametrize("continued", [False, True])
def test_time_and_channel_mix_match_reference(continued):
    spec, tree = _block_params()
    tspec = trwkv.Rwkv6Spec(d_model=128, d_ff=256)
    assert tspec.n_heads == spec.n_heads == 2
    jp = {n: jnp.asarray(a) for n, a in tree.items()}
    tp = {n: torch.from_numpy(a) for n, a in tree.items()}
    rng = np.random.default_rng(11)
    B, T, D = 2, 9, spec.d_model
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    s0 = (rng.standard_normal((B, 2, 64, 64)).astype(np.float32)
          if continued else None)
    last = (rng.standard_normal((B, 1, D)).astype(np.float32)
            if continued else None)

    y_j, (s_j, l_j) = jrwkv.rwkv6_time_mix(
        jp, jnp.asarray(x), spec, init_state=_j(s0)[0], last_x=_j(last)[0])
    y_t, (s_t, l_t) = trwkv.rwkv6_time_mix(
        tp, torch.from_numpy(x), tspec, init_state=_t(s0)[0],
        last_x=_t(last)[0])
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32_TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **F32_TOL)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))

    c_j, cl_j = jrwkv.rwkv6_channel_mix(jp, jnp.asarray(x),
                                        last_x=_j(last)[0])
    c_t, cl_t = trwkv.rwkv6_channel_mix(tp, torch.from_numpy(x),
                                        last_x=_t(last)[0])
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **F32_TOL)
    np.testing.assert_array_equal(cl_t.numpy(), np.asarray(cl_j))


def test_layer_norm_matches_reference():
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    rng = np.random.default_rng(2)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 5, 64), (64,), (64,)))
    for dt in (torch.float32, torch.bfloat16):
        jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
        got = tcommon.layer_norm(torch.from_numpy(x).to(dt),
                                 torch.from_numpy(w).to(dt),
                                 torch.from_numpy(b).to(dt))
        want = jcommon.layer_norm(*(jnp.asarray(a, jdt) for a in (x, w, b)))
        assert got.dtype == dt
        tol = F32_TOL if dt == torch.float32 else dict(rtol=1e-2, atol=2e-2)
        np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------------------------
# Tiny RWKV6: prefill and decode on the reference's weights
# ---------------------------------------------------------------------------

def _pair(dtype, seed=1):
    jcfg = dataclasses.replace(jget("rwkv6_7b", tiny=True), dtype=dtype)
    tcfg = dataclasses.replace(tget("rwkv6_7b", tiny=True), dtype=dtype)
    params = jreg.build(jcfg).init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  params)
    return jcfg, tcfg, params, treg.params_from_jax(tcfg, tree, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    jcfg, tcfg, jparams, tparams = _pair(dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    B, T, max_len = 2, 24, 40
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)

    jlog, jcache, jT = jlm.prefill(jparams, jnp.asarray(toks), jcfg, max_len)
    tlog, tcache, tT = tlm.prefill(tparams, torch.from_numpy(toks), tcfg,
                                   max_len)
    assert jT == tT == T
    np.testing.assert_allclose(_np(tlog), _np(jlog), **tol)

    def check_cache(tc, jc):
        assert tc.keys() == jc.keys() == {"wkv", "tm_last", "cm_last"}
        for key in tc:
            assert tuple(tc[key].shape) == jc[key].shape, key
            a, b = _np(tc[key]), _np(jc[key])
            if key == "wkv" and dtype == "bfloat16":
                assert np.abs(a - b).max() <= BF16_STATE_TOL * np.abs(b).max()
            else:
                np.testing.assert_allclose(a, b, err_msg=key, **tol)
        assert tc["wkv"].dtype == torch.float32
        assert tc["tm_last"].dtype == tlm.common.default_dtype(dtype)

    check_cache(tcache, jcache)
    # two decode steps, each fed the reference's greedy token
    for step in range(2):
        nxt = np.array(jnp.argmax(jlog[:, -1, :jcfg.vocab_size], -1),
                       np.int32)[:, None]
        jlog, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(nxt),
                                       jnp.int32(T + step), jcfg)
        tlog, tcache = tlm.decode_step(tparams, tcache,
                                       torch.from_numpy(nxt), T + step, tcfg)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **tol)
        check_cache(tcache, jcache)
    # padded vocab slots are masked in the logits dtype
    assert tcfg.vocab_padded == 2048
    assert (tlog[..., tcfg.vocab_size:] == -1e9).all()


def test_params_from_jax_keeps_the_reference_f32_leaves():
    """In a bf16 model the decay base and the bonus stay f32, bit for bit:
    cast to bf16 they would move every decay (w = -exp(decay_base +
    dec))."""
    jcfg = jget("rwkv6_7b", tiny=True)
    tcfg = tget("rwkv6_7b", tiny=True)
    assert tcfg.dtype == "bfloat16"
    params = jreg.build(jcfg).init(jax.random.PRNGKey(0))
    ref_dtypes = jax.tree_util.tree_map(lambda a: str(a.dtype), params)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  params)
    tm = tree["blocks"]["rwkv_tm"]
    for name in ("decay_base", "bonus_u"):
        # values a bf16 cast would change
        tm[name] = tm[name] + rng.uniform(-1e-3, 1e-3, tm[name].shape).astype(
            np.float32)
    got = treg.params_from_jax(tcfg, tree, "cpu")
    got_dtypes = tlm.tree_map(lambda a: str(a.dtype).removeprefix("torch."),
                              got)
    assert got_dtypes == ref_dtypes
    assert ref_dtypes["blocks"]["rwkv_tm"]["decay_base"] == "float32"
    assert ref_dtypes["blocks"]["rwkv_tm"]["bonus_u"] == "float32"
    assert ref_dtypes["blocks"]["rwkv_tm"]["w_r"] == "bfloat16"
    for name in ("decay_base", "bonus_u"):
        np.testing.assert_array_equal(got["blocks"]["rwkv_tm"][name].numpy(),
                                      tm[name])
    # the port's own init makes the same dtypes
    init = treg.build(tcfg).init(torch.Generator().manual_seed(0))
    assert tlm.tree_map(lambda a: str(a.dtype).removeprefix("torch."),
                        init) == ref_dtypes


def test_params_from_jax_rejects_a_wrong_rwkv_tree():
    cfg = tget("rwkv6_7b", tiny=True)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)),
        jreg.build(jget("rwkv6_7b", tiny=True)).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="shape"):
        treg.params_from_jax(dataclasses.replace(cfg, d_ff=64), tree, "cpu")
    del tree["blocks"]["ln1_b"]
    with pytest.raises(ValueError, match="keys"):
        treg.params_from_jax(cfg, tree, "cpu")


def test_full_config_shapes_match_reference():
    """The full RWKV6-7B tree: the reference's shapes (from its init under
    `jax.eval_shape`) and its 7,568,494,592 parameters, no vocab padding."""
    jcfg, tcfg = jget("rwkv6_7b"), tget("rwkv6_7b")
    assert dataclasses.astuple(tcfg) == dataclasses.astuple(jcfg)
    shapes = jax.eval_shape(jreg.build(jcfg).init, jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), shapes)
    assert tlm.param_shapes(tcfg) == want
    n = sum(int(np.prod(s)) for s in tlm.tree_leaves(tlm.param_shapes(tcfg)))
    assert n == 7_568_494_592
    assert tcfg.vocab_padded == tcfg.vocab_size == 65536


def test_init_lm_layout_and_scale():
    cfg = dataclasses.replace(tget("rwkv6_7b", tiny=True), dtype="float32")
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    assert tlm.tree_map(lambda a: tuple(a.shape), params) == \
        tlm.param_shapes(cfg)
    tm = params["blocks"]["rwkv_tm"]
    assert (tm["decay_base"] == -2.0).all() and (tm["bonus_u"] == 0.5).all()
    assert (tm["mix_base"] == 0).all() and (tm["ln_x_w"] == 1).all()
    assert (params["blocks"]["ln1_b"] == 0).all()
    w = tm["cm_wk"]
    # truncated normal at +-2 sigma has std 0.8796 sigma
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 0.8796) < 0.02


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_cpu_rwkv_generate_launches_no_kernel(capsys):
    tops.reset_launch_counts()
    launch_serve.main(["--arch", "rwkv6_7b", "--tiny", "--batch", "2",
                       "--prompt-len", "8", "--max-new", "4",
                       "--fleet-chips", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "rwkv6-tiny" in out and "generated (2, 4) tokens" in out
    assert tops.launch_counts() == {name: 0 for name in tops.KERNELS}

