"""The hybrid family (Zamba2: Mamba2 layers and one shared attention + MLP
block) in the port against the reference package, on the same numpy
inputs: the K8 plain version against `repro.kernels.ref` and against the
Pallas kernel in interpret mode, the state carry, the Mamba2 block, tiny
Zamba2 prefill and decode on the reference's weights (carried over by
`params_from_jax`, which keeps the reference's f32 leaves), including the
shared block's rolling sliding-window KV cache, and the launcher on the
CPU. The slice's `generate` parity is in tests/test_torch_serve.py,
training in tests/test_torch_train_families.py, the CUDA kernel against
its plain version in tests/test_torch_kernels_cuda.py.

The port's hybrid decode cache is a dict (`{"mamba": {"conv_x", "conv_B",
"conv_C", "ssm"}, "shared_kv": {"k", "v"}}`) where the reference's Mamba
state is the tuple `((conv_x, conv_B, conv_C), ssm)`; `_ref_cache` maps
one onto the other."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import mamba2_ssd as jm2
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models import mamba2 as jmamba
from repro.models import registry as jreg
from repro_torch.configs import get_config as tget
from repro_torch.kernels import mamba2_ssd as tm2
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import registry as treg
from test_torch_inputs import (bf16_round, bf16_split,
                               mamba2_adversarial_decay, mamba2_inputs)

# f32 scan: the same products summed in another order (the reference's
# einsum over the state rows against torch's), relative to the output's
# magnitude (|y| reaches ~20 at T = 200)
SCAN_TOL = dict(rtol=1e-5, atol=1e-4)
# against the Pallas kernel's chunked form (matmuls within a chunk, decays
# as exp of cumulative sums): the tolerance of the reference package's own
# test of that kernel (tests/test_kernels.py::test_mamba2_ssd_sweep)
CHUNKED_TOL = dict(rtol=1e-3, atol=2e-4)
# bf16 x, B, C: y is the f32 result rounded to bf16 in both packages; sums
# in another order can round to a neighbouring bf16 value (an ulp is 2^-8
# of the value)
BF16_Y_TOL = dict(rtol=1e-2, atol=1e-2)
# f32 blocks and model: sums in another order through a few matmuls
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 model: both packages round activations to bf16 after every op, at
# different places (XLA fuses elementwise bf16 chains and rounds once); the
# gap is a few bf16 ulps of O(1) values (at rtol 2e-2, the logits and caches
# of tiny Zamba2 needed atol <= 0.054 over seeds 0-3, 6 decode steps)
BF16_TOL = dict(rtol=2e-2, atol=6e-2)
# the f32 ssm state of a bf16 model: x, B and the step-size projection are
# bf16 values that may round to a neighbour in the other package, and one
# ulp of dt (2^-8 of it) moves the decay exp(dt * A) by |dt * A| 2^-8 (A
# reaches -16); held relative to the largest |state| (measured <= 2.5 %
# over seeds 0-3)
BF16_STATE_TOL = 5e-2


def _t(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(None if a is None else jnp.asarray(a) for a in arrays)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# K8: the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 16, 64, 200])
def test_mamba2_plain_matches_reference(T, with_state, G, dtype):
    x, dt, A, B, C, D, s0 = mamba2_inputs(2, T, 4, G, 16, seed=T + G,
                                          state=with_state)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    xt, Bt, Ct = (torch.from_numpy(a).to(tdt) for a in (x, B, C))
    y, s = tm2.mamba2_ssd_plain(xt, *_t(dt, A), Bt, Ct, *_t(D),
                                init_state=_t(s0)[0])
    y_j, s_j = jref.mamba2_scan_reference(
        jnp.asarray(x, jdt), *_j(dt, A), jnp.asarray(B, jdt),
        jnp.asarray(C, jdt), *_j(D), init_state=_j(s0)[0])
    assert y.dtype == tdt and s.dtype == torch.float32
    assert y_j.dtype == jdt and s_j.dtype == jnp.float32
    np.testing.assert_allclose(
        _np(y), _np(y_j), **(SCAN_TOL if dtype == "float32" else BF16_Y_TOL))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **SCAN_TOL)


@pytest.mark.parametrize("T,H,P,G,N,chunk", [
    (128, 4, 32, 1, 16, 64),
    (256, 4, 64, 2, 32, 128),
    (64, 2, 16, 2, 16, 64),
])
def test_mamba2_plain_matches_pallas_interpret(T, H, P, G, N, chunk):
    """Against the Pallas kernel run in interpret mode at the reference
    package's own sweep shapes, where T tiles by its chunk (the Pallas
    kernel refuses others; the port does not)."""
    x, dt, A, B, C, D, s0 = mamba2_inputs(2, T, H, G, N, seed=T + 1, P=P)
    y, s = tm2.mamba2_ssd_plain(*_t(x, dt, A, B, C, D), init_state=_t(s0)[0])
    y_j, s_j = jm2.mamba2_ssd(*_j(x, dt, A, B, C, D), chunk=chunk,
                              init_state=jnp.asarray(s0), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **CHUNKED_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **CHUNKED_TOL)


def test_mamba2_state_carry():
    """0..h, then h..T from the carried state, equals the whole run."""
    T, h = 200, 77
    x, dt, A, B, C, D, s0 = _t(*mamba2_inputs(2, T, 4, 2, 16, seed=3))
    y, s = tops.mamba2_scan(x, dt, A, B, C, D, init_state=s0)
    y1, s1 = tops.mamba2_scan(x[:, :h], dt[:, :h], A, B[:, :h], C[:, :h], D,
                              init_state=s0)
    y2, s2 = tops.mamba2_scan(x[:, h:], dt[:, h:], A, B[:, h:], C[:, h:], D,
                              init_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **SCAN_TOL)
    torch.testing.assert_close(s2, s, **SCAN_TOL)


def test_mamba2_cpu_dispatch_runs_the_plain_version():
    args = _t(*mamba2_inputs(1, 5, 2, 1, 16, seed=5))
    tops.reset_launch_counts()
    got = tops.mamba2_scan(*args[:6], init_state=args[6])
    want = tm2.mamba2_ssd_plain(*args[:6], init_state=args[6])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tops.launch_counts()["mamba2_ssd"] == 0


def test_mamba2_state_out_gives_todays_results():
    """The plain version's `state_out`, a separate buffer or `init_state`
    itself, gives the same y and state as a call without it, and returns
    that buffer."""
    x, dt, A, B, C, D, s0 = _t(*mamba2_inputs(2, 37, 4, 2, 16, seed=9))
    y, s = tops.mamba2_scan(x, dt, A, B, C, D, init_state=s0)
    out = torch.full_like(s0, float("nan"))
    y1, s1 = tops.mamba2_scan(x, dt, A, B, C, D, init_state=s0,
                              state_out=out)
    alias = s0.clone()
    y2, s2 = tops.mamba2_scan(x, dt, A, B, C, D, init_state=alias,
                              state_out=alias)
    assert s1 is out and s2 is alias
    for yy, ss in ((y1, s1), (y2, s2)):
        assert torch.equal(yy, y) and torch.equal(ss, s)
    y0, s0_out = tops.mamba2_scan(x, dt, A, B, C, D,
                                  state_out=torch.empty_like(s0))
    y0_want, s0_want = tops.mamba2_scan(x, dt, A, B, C, D)
    assert torch.equal(y0, y0_want) and torch.equal(s0_out, s0_want)


# ---------------------------------------------------------------------------
# K8's chunked arithmetic (csrc/mamba2_ssd.cu), modelled in numpy
# ---------------------------------------------------------------------------

def mamba2_chunked_model(x, dt, A, B, C, D, s0=None, tensor_cores=False):
    """K8's prefill as the kernel computes it, in numpy f32: chunks of
    `CHUNK` steps in the kernel's two passes (chunk 0 from the initial
    state, the others but the last from 0, each leaving its end state and
    decay; then each later chunk from the fold of those before it), each
    walked in sub-chunks of `SUB` steps whose decays are
    running products of exp(dt * A) taken in step order. `tensor_cores`
    models the bf16 path's operands: Bh as three bf16 terms, S, Ch and W as
    two, S Ch as hi*hi + lo*hi + hi*lo (x, B, C are bf16 already). Returns
    (y f32, before the kernel's bf16 store, and the final state)."""
    f = np.float32
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = -(-T // tm2.CHUNK)
    pad = nc * tm2.CHUNK - T

    def padded(a):
        return np.concatenate(
            [a.astype(f), np.zeros((Bt, pad) + a.shape[2:], f)], 1)

    xp, dtp = padded(x), padded(dt)
    Bp = padded(np.repeat(B, H // G, 2))
    Cp = padded(np.repeat(C, H // G, 2))
    dec = np.exp(dtp * A.astype(f))                 # 1 past T (dt 0)
    y = np.zeros((Bt, nc * tm2.CHUNK, H, P), f)
    ein = lambda spec, *a: np.einsum(spec, *a).astype(f)   # noqa: E731

    def walk(S, c, with_y):
        cdec = np.ones((Bt, H), f)
        for r0 in range(c * tm2.CHUNK, (c + 1) * tm2.CHUNK, tm2.SUB):
            if r0 >= T:
                break
            sl = slice(r0, r0 + tm2.SUB)
            dc, dts, xs = dec[:, sl], dtp[:, sl], xp[:, sl]
            ep = np.cumprod(dc, axis=1, dtype=f)     # prod_{m<=t}
            su = np.ones_like(dc)                    # prod_{m>t}
            for t in range(tm2.SUB):
                for m in range(t + 1, tm2.SUB):
                    su[:, t] = su[:, t] * dc[:, m]
            dblk = ep[:, -1]
            Bh = Bp[:, sl] * (dts * su)[..., None]
            if with_y:
                Ch = Cp[:, sl] * ep[..., None]
                M = np.zeros((Bt, H, tm2.SUB, tm2.SUB), f)
                for j in range(tm2.SUB):
                    mm = dts[:, j]
                    M[:, :, j, j] = mm
                    for t in range(j + 1, tm2.SUB):
                        mm = mm * dc[:, t]
                        M[:, :, t, j] = mm
                W = ein("bthn,bjhn->bhtj", Cp[:, sl], Bp[:, sl]) * M
                if tensor_cores:
                    (sh, sl_), (chh, chl) = bf16_split(S, 2), bf16_split(Ch, 2)
                    yi = (ein("bthn,bhnp->bthp", chh, sh)
                          + ein("bthn,bhnp->bthp", chh, sl_)
                          + ein("bthn,bhnp->bthp", chl, sh))
                    ya = sum(ein("bhtj,bjhp->bthp", wq, xs)
                             for wq in bf16_split(W, 2))
                else:
                    yi = ein("bthn,bhnp->bthp", Ch, S)
                    ya = ein("bhtj,bjhp->bthp", W, xs)
                y[:, sl] = yi + ya + D.astype(f)[:, None] * xs
            S = S * dblk[..., None, None]
            for bq in (bf16_split(Bh, 3) if tensor_cores else (Bh,)):
                S = S + ein("bthn,bthp->bhnp", bq, xs)
            cdec = cdec * dblk
        return S, cdec

    S = np.zeros((Bt, H, N, P), f) if s0 is None else s0.astype(f)
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
            S = S * slots[cc][1][..., None, None] + slots[cc][0]
        S, _ = walk(S, c, True)
    return y[:, :T], S


def _rel(a, b):
    """max |a - b| relative to max(|b|, 1), as the card tests hold it."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


# the model against the reference: f32 sums in another order (SCAN_TOL's
# 1e-5, relative to the largest magnitude, as chip_smoke.py holds the
# kernel); the tensor-core path's two-term operands keep ~16 bits, so y
# within 1e-4 (the kernel then rounds y to bf16, 2^-8)
MODEL_TOL = dict(y={False: 1e-5, True: 1e-4}, state=1e-5)
MODEL_TS = [1, 37, 63, 64, 65, 200, 256]


@pytest.mark.parametrize("tensor_cores", [False, True])
@pytest.mark.parametrize("G,N", [(1, 64), (2, 16)])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", MODEL_TS)
def test_mamba2_chunked_model_matches_reference_and_pallas(
        T, with_state, G, N, tensor_cores):
    """The numpy model of K8's chunked arithmetic against the reference's
    sequential scan (MODEL_TOL) and the Pallas kernel in interpret mode
    (CHUNKED_TOL: its decays are exp of cumulative sums), at T on and
    around the chunk and sub-chunk edges. The tensor-core path's inputs are
    bf16 values."""
    x, dt, A, B, C, D, s0 = mamba2_inputs(1, T, 2, G, N, seed=T + 7 * G,
                                          state=with_state)
    if tensor_cores:
        x, B, C = (bf16_round(a) for a in (x, B, C))
    y, s = mamba2_chunked_model(x, dt, A, B, C, D, s0, tensor_cores)
    y_r, s_r = jref.mamba2_scan_reference(*_j(x, dt, A, B, C, D),
                                          init_state=_j(s0)[0])
    assert _rel(y, y_r) <= MODEL_TOL["y"][tensor_cores]
    assert _rel(s, s_r) <= MODEL_TOL["state"]
    y_p, s_p = jm2.mamba2_ssd(*_j(x, dt, A, B, C, D),
                              chunk=T if T % 128 else 128,
                              init_state=None if s0 is None
                              else jnp.asarray(s0), interpret=True)
    np.testing.assert_allclose(y, np.asarray(y_p), **CHUNKED_TOL)
    np.testing.assert_allclose(s, np.asarray(s_p), **CHUNKED_TOL)


@pytest.mark.parametrize("tensor_cores", [False, True])
def test_mamba2_chunked_model_at_an_adversarial_decay(tensor_cores):
    """dt * A = -64 a step on one head (each step's decay, e^-64, and every
    product of two underflow towards 0, as in the sequential form; a
    cumulative sum reaches -16384 over T) and ~-4e-3 on another (decays
    near 1): the running products stay finite and within MODEL_TOL."""
    T = 256
    x, dt, A, B, C, D, s0 = mamba2_inputs(1, T, 2, 1, 64, seed=11)
    dt, A = mamba2_adversarial_decay(dt, A)
    if tensor_cores:
        x, B, C = (bf16_round(a) for a in (x, B, C))
    assert (dt[..., 0] * A[0] == -64.0).all()
    y, s = mamba2_chunked_model(x, dt, A, B, C, D, s0, tensor_cores)
    y_r, s_r = jref.mamba2_scan_reference(*_j(x, dt, A, B, C, D),
                                          init_state=_j(s0)[0])
    assert np.isfinite(y).all() and np.isfinite(s).all()
    assert _rel(y, y_r) <= MODEL_TOL["y"][tensor_cores]
    assert _rel(s, s_r) <= MODEL_TOL["state"]


# ---------------------------------------------------------------------------
# Tiny Zamba2 on the reference's weights
# ---------------------------------------------------------------------------

def _pair(dtype, seed=1, perturb=False, **changes):
    """The reference's tiny Zamba2 params (as jnp arrays in the model dtype)
    and the port's, carried over by `params_from_jax`. With `perturb`
    every Mamba2 leaf gets N(0, 0.1) noise (the reference init leaves the
    conv biases, norm and the f32 leaves constant)."""
    jcfg = dataclasses.replace(jget("zamba2_1p2b", tiny=True), dtype=dtype,
                               **changes)
    tcfg = dataclasses.replace(tget("zamba2_1p2b", tiny=True), dtype=dtype,
                               **changes)
    params = jreg.build(jcfg).init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  params)
    if perturb:
        rng = np.random.default_rng(seed)
        tree["blocks"]["mamba"] = {
            k: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
            for k, a in tree["blocks"]["mamba"].items()}
        params = jax.tree_util.tree_map(
            lambda a, ref: jnp.asarray(a, ref.dtype), tree, params)
    return jcfg, tcfg, params, treg.params_from_jax(tcfg, tree, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_matches_reference(dtype):
    """`mamba2_forward` over a prompt from zero state, then two
    `mamba2_decode` steps from the carried state, on layer 1's perturbed
    weights."""
    jcfg, tcfg, jparams, tparams = _pair(dtype, perturb=True)
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"]["mamba"])
    tp = tlm.tree_map(lambda a: a[1], tparams["blocks"]["mamba"])
    jspec, tspec = jlm.mamba_spec(jcfg), tlm.mamba_spec(tcfg)
    assert (tspec.n_heads, tspec.d_state, tspec.head_dim) == \
        (jspec.n_heads, jspec.d_state, jspec.head_dim) == (4, 16, 64)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)

    def check(t, j):
        (tc, ts), (jc, js) = t, j
        for a, b in zip(tc, jc):
            assert a.dtype == tdt
            np.testing.assert_allclose(_np(a), _np(b), **tol)
        assert ts.dtype == torch.float32 and js.dtype == jnp.float32
        if dtype == "float32":
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), **tol)
        else:
            assert np.abs(_np(ts) - _np(js)).max() <= \
                BF16_STATE_TOL * np.abs(_np(js)).max()

    y_t, st_t = tmamba.mamba2_forward(tp, torch.from_numpy(x).to(tdt), tspec)
    y_j, st_j = jmamba.mamba2_forward(jp, jnp.asarray(x, jdt), jspec)
    assert y_t.dtype == tdt
    np.testing.assert_allclose(_np(y_t), _np(y_j), **tol)
    check(st_t, st_j)
    for step in range(2):
        x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        y_t, st_t = tmamba.mamba2_decode(tp, torch.from_numpy(x1).to(tdt),
                                         st_t, tspec)
        y_j, st_j = jmamba.mamba2_decode(jp, jnp.asarray(x1, jdt), st_j,
                                         jspec)
        np.testing.assert_allclose(_np(y_t), _np(y_j), **tol)
        check(st_t, st_j)


def _ref_cache(jc):
    """The reference's hybrid cache in the port's dict layout."""
    (conv_x, conv_B, conv_C), ssm = jc["mamba"]
    return {"mamba": {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
                      "ssm": ssm},
            "shared_kv": dict(jc["shared_kv"])}


# (sliding_window, prompt length): the TINY window (no wrap within the run);
# window 8 with a 16-token prompt (prefill keeps the last 8 positions, roll
# by 0; decode wraps at once); window 8 with 13 tokens (roll by 5)
WINDOWS = {"tiny": (None, 16), "window8_T16": (8, 16),
           "window8_T13": (8, 13)}


@pytest.mark.parametrize("variant", list(WINDOWS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype, variant):
    window, T = WINDOWS[variant]
    changes = {} if window is None else {"sliding_window": window}
    jcfg, tcfg, jparams, tparams = _pair(dtype, **changes)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    B, max_len = 2, T + 10
    n_occ = tcfg.n_layers // tcfg.attn_every
    S = min(max_len, tcfg.sliding_window)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)

    jlog, jcache, jT = jlm.prefill(jparams, jnp.asarray(toks), jcfg, max_len)
    tlog, tcache, tT = tlm.prefill(tparams, torch.from_numpy(toks), tcfg,
                                   max_len)
    assert jT == tT == T
    np.testing.assert_allclose(_np(tlog), _np(jlog), **tol)

    def check_cache(tc, jc):
        jc = _ref_cache(jc)
        assert tc.keys() == jc.keys()
        for part in tc:
            assert tc[part].keys() == jc[part].keys(), part
            for key in tc[part]:
                a, b = tc[part][key], jc[part][key]
                assert tuple(a.shape) == b.shape, (part, key)
                a, b = _np(a), _np(b)
                if key == "ssm" and dtype == "bfloat16":
                    assert np.abs(a - b).max() <= \
                        BF16_STATE_TOL * np.abs(b).max()
                else:
                    np.testing.assert_allclose(a, b, err_msg=key, **tol)
        assert tc["mamba"]["ssm"].dtype == torch.float32
        assert tc["shared_kv"]["k"].shape == (n_occ, B, S, 4, 32)
        assert tc["mamba"]["conv_x"].dtype == tlm.common.default_dtype(dtype)

    check_cache(tcache, jcache)
    # six decode steps, each fed the reference's greedy token; with window
    # 8 the shared KV slots wrap (slot = position % 8)
    for step in range(6):
        nxt = np.array(jnp.argmax(jlog[:, -1, :jcfg.vocab_size], -1),
                       np.int32)[:, None]
        jlog, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(nxt),
                                       jnp.int32(T + step), jcfg)
        tlog, tcache = tlm.decode_step(tparams, tcache,
                                       torch.from_numpy(nxt), T + step, tcfg)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **tol)
        check_cache(tcache, jcache)
    assert (tlog[..., tcfg.vocab_size:] == -1e9).all()


def test_params_from_jax_keeps_the_reference_f32_leaves():
    """In a bf16 model A_log, D and dt_bias stay f32, bit for bit: cast to
    bf16 they would move every step size and decay."""
    jcfg = jget("zamba2_1p2b", tiny=True)
    tcfg = tget("zamba2_1p2b", tiny=True)
    assert tcfg.dtype == "bfloat16"
    params = jreg.build(jcfg).init(jax.random.PRNGKey(0))
    ref_dtypes = jax.tree_util.tree_map(lambda a: str(a.dtype), params)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  params)
    m = tree["blocks"]["mamba"]
    for name in tmamba.F32_PARAMS:
        # values a bf16 cast would change
        m[name] = m[name] + rng.uniform(-1e-3, 1e-3, m[name].shape).astype(
            np.float32)
    got = treg.params_from_jax(tcfg, tree, "cpu")
    got_dtypes = tlm.tree_map(lambda a: str(a.dtype).removeprefix("torch."),
                              got)
    assert got_dtypes == ref_dtypes
    for name in tmamba.F32_PARAMS:
        assert ref_dtypes["blocks"]["mamba"][name] == "float32"
        np.testing.assert_array_equal(got["blocks"]["mamba"][name].numpy(),
                                      m[name])
    assert ref_dtypes["blocks"]["mamba"]["w_x"] == "bfloat16"
    assert ref_dtypes["shared"]["attn"]["wq"] == "bfloat16"
    # the unstacked shared block comes through as the reference has it
    np.testing.assert_array_equal(got["shared"]["mlp"]["w_in"].float().numpy(),
                                  np.asarray(params["shared"]["mlp"]["w_in"],
                                             np.float32))
    # the port's own init makes the same dtypes
    init = treg.build(tcfg).init(torch.Generator().manual_seed(0))
    assert tlm.tree_map(lambda a: str(a.dtype).removeprefix("torch."),
                        init) == ref_dtypes


def test_params_from_jax_rejects_a_wrong_hybrid_tree():
    cfg = tget("zamba2_1p2b", tiny=True)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)),
        jreg.build(jget("zamba2_1p2b", tiny=True)).init(
            jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="shape"):
        treg.params_from_jax(dataclasses.replace(cfg, ssm_state=8), tree,
                             "cpu")
    del tree["shared"]
    with pytest.raises(ValueError, match="keys"):
        treg.params_from_jax(cfg, tree, "cpu")


def test_full_config_shapes_and_dtypes_match_reference():
    """The full Zamba2-1.2B tree: the reference's shapes and dtypes (from
    its init under `jax.eval_shape`), 1,173,619,584 parameters, vocab 32000
    padded to 32768, 32/32 heads of 64 unpadded."""
    jcfg, tcfg = jget("zamba2_1p2b"), tget("zamba2_1p2b")
    assert dataclasses.astuple(tcfg) == dataclasses.astuple(jcfg)
    shapes = jax.eval_shape(jreg.build(jcfg).init, jax.random.PRNGKey(0))
    assert tlm.param_shapes(tcfg) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), shapes)
    assert tlm.tree_map(lambda d: str(d).removeprefix("torch."),
                        tlm.param_dtypes(tcfg)) == \
        jax.tree_util.tree_map(lambda a: str(a.dtype), shapes)
    n = sum(int(np.prod(s)) for s in tlm.tree_leaves(tlm.param_shapes(tcfg)))
    assert n == 1_173_619_584
    assert tcfg.vocab_padded == 32768
    plan = tcfg.head_plan()
    assert (plan.n_q_pad, plan.n_kv_pad, plan.group) == (32, 32, 1)
    spec = tlm.mamba_spec(tcfg)
    assert (spec.n_heads, spec.d_state, spec.head_dim) == (64, 64, 64)


def test_init_lm_layout_and_scale():
    cfg = dataclasses.replace(tget("zamba2_1p2b", tiny=True), dtype="float32")
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    assert tlm.tree_map(lambda a: tuple(a.shape), params) == \
        tlm.param_shapes(cfg)
    m = params["blocks"]["mamba"]
    H = tlm.mamba_spec(cfg).n_heads
    np.testing.assert_allclose(
        m["A_log"][0].numpy(), np.log(np.linspace(1.0, 16.0, H)), rtol=1e-6)
    assert (m["D"] == 1).all() and (m["norm_w"] == 1).all()
    np.testing.assert_allclose(m["dt_bias"].numpy(), np.log(np.expm1(0.01)),
                               rtol=1e-6)
    assert (m["conv_x_b"] == 0).all()
    assert (params["shared"]["ln1_w"] == 1).all()
    w = m["w_x"]
    # truncated normal at +-2 sigma has std 0.8796 sigma
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 0.8796) < 0.02


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_cpu_zamba_generate_launches_no_kernel(capsys):
    tops.reset_launch_counts()
    launch_serve.main(["--arch", "zamba2_1p2b", "--tiny", "--batch", "2",
                       "--prompt-len", "8", "--max-new", "4",
                       "--fleet-chips", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "zamba2-tiny" in out and "generated (2, 4) tokens" in out
    assert tops.launch_counts() == {name: 0 for name in tops.KERNELS}

