"""The port's kernels against the reference package's, on the same numpy
inputs: each plain PyTorch version against `repro.kernels.ref` (causal,
GQA, ragged T, lengths >= 1, usable and unusable SOR lanes) and, at one
small shape each, against the Pallas kernel run in interpret mode as
tests/test_kernels.py runs it: the flash forward and backward (against
`jax.grad` of `ref.mha_reference` and the Pallas `_bwd`), decode attention,
the SOR fit, the SOR accumulation (K7's plain version) and the fleet
reduction (NaN lane included). The bf16 K2's one deliberate numeric change
(p rounded to bf16 before P V) is bounded against `ref.mha_reference` at
the full-width paths' head shapes, and the bf16 K4/K5's (p and dS rounded
to bf16 before their products) against its `jax.vjp`. The CUDA kernels
against their plain versions are in tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jda
from repro.kernels import fleet_telemetry as jft
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import fleet_telemetry as tft
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_inputs import (SOR_KW, accumulate_inputs, check_sor,
                               check_sums, qkv, sor_inputs)

# f32 attention: the two packages sum the same products in another order
ATT_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("T,Hq,Hkv,Dh,causal", [
    (64, 4, 4, 32, True),      # MHA
    (50, 6, 2, 32, True),      # GQA group 3, ragged T
    (33, 8, 1, 64, False),     # MQA, non-causal
    (128, 12, 4, 32, True),    # the padded-GQA plan: 12 q / 4 kv heads
])
def test_flash_plain_matches_reference(T, Hq, Hkv, Dh, causal):
    q, k, v = qkv(2, T, T, Hq, Hkv, Dh, seed=T)
    group = Hq // Hkv
    o, lse = tfa.flash_attention(*_t(q, k, v), causal=causal, group=group)
    want = jref.mha_reference(*_j(q, k, v), causal=causal, group=group)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **ATT_TOL)
    assert lse.shape == (2, Hq, T)


def test_flash_plain_lse_matches_pallas_interpret():
    """o and the saved lse against the Pallas forward (interpret mode)."""
    B, T, Hq, Hkv, Dh = 1, 128, 4, 2, 32
    q, k, v = qkv(B, T, T, Hq, Hkv, Dh, seed=5)
    sw = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)
    o_j, lse_j = jfa._fwd(sw(q), sw(k), sw(v), causal=True, group=2,
                          window=0, bq=64, bk=64, interpret=True)
    o, lse = tfa.flash_attention(*_t(q, k, v), causal=True, group=2)
    np.testing.assert_allclose(o.numpy(), np.asarray(jnp.swapaxes(o_j, 1, 2)),
                               **ATT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **ATT_TOL)


def test_flash_plain_sliding_window_matches_reference():
    q, k, v = qkv(1, 96, 96, 2, 2, 32, seed=9)
    o, _ = tfa.flash_attention(*_t(q, k, v), causal=True, group=1,
                               sliding_window=24)
    want = jref.mha_reference(*_j(q, k, v), causal=True, group=1,
                              sliding_window=24)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **ATT_TOL)


def _bf16_p_attention(q, k, v, *, group: int, window: int, bk: int = 64):
    """The bf16 K2's arithmetic (`csrc/flash_attention_sm90.cu`) in plain
    torch: f32 scores, the online softmax over 64-key tiles, l summed from
    the f32 p, p rounded to bf16 before P V (the wgmma A operand), o
    divided by l and cast to q's dtype."""
    s = tref.masked_scores(q, k, causal=True, group=group,
                           sliding_window=window)            # [B,Hq,T,S]
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    m = torch.full(s.shape[:-1], -torch.inf)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros((*s.shape[:-1], v.shape[-1]))
    for k0 in range(0, s.shape[-1], bk):
        m_new = torch.maximum(m, s[..., k0:k0 + bk].amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s[..., k0:k0 + bk] - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = (acc * alpha[..., None]
               + p.bfloat16().float() @ vf[:, :, k0:k0 + bk])
        m = m_new
    return (acc / l[..., None]).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("T", [256, 512])
@pytest.mark.parametrize("Hq,Hkv,Dh,window", [
    (48, 16, 128, 0),      # Qwen2.5-14B's heads, group 3
    (32, 32, 64, 4096),    # Zamba2-1.2B's shared block, window 4096
    (48, 48, 64, 0),       # MiniCPM-2B's heads
])
def test_flash_bf16_p_within_card_tolerance(T, Hq, Hkv, Dh, window):
    """The bf16 K2 rounds p to bf16 before P V; the card holds its o to the
    f32 plain version within 2e-2 (`ATT_TOL[bf16]` of the card tests).
    That rounding, on bf16 inputs at the three paths' head shapes, stays
    within the same 2e-2 of the reference's `mha_reference`."""
    q, k, v = qkv(1, T, T, Hq, Hkv, Dh, seed=T + Dh)
    group = Hq // Hkv
    got = _bf16_p_attention(*(torch.from_numpy(a).bfloat16()
                              for a in (q, k, v)),
                            group=group, window=window)
    want = jref.mha_reference(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)),
                              causal=True, group=group, sliding_window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2e-2)


def _bf16_pds_backward(q, k, v, do, *, group: int, window: int):
    """The bf16 K4/K5's arithmetic (`csrc/flash_attention_bwd_sm90.cu`) in
    plain torch: o as the bf16 K2 gives it, delta = rowsum(o * do) in f32,
    f32 scores from the bf16 q and k, p from the f32 lse, dP from do and v
    in f32, and p and dS rounded to bf16 before dV = p^T do, dK = scale dS^T
    q and dQ = scale dS k (f32 sums, the wgmma accumulators), each cast to
    bf16."""
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(Dh)
    o = _bf16_p_attention(q, k, v, group=group, window=window)
    s = tref.masked_scores(q, k, causal=True, group=group,
                           sliding_window=window)            # [B,Hq,T,S]
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    kf, vf = (a.float().repeat_interleave(group, dim=2) for a in (k, v))
    dof = do.float()
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = (p * (dp - tfa.bwd_delta(o, do)[..., None])).bfloat16().float()
    p = p.bfloat16().float()
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float()) * scale
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    return (dq.bfloat16(),
            *(a.reshape(B, S, Hkv, group, Dh).sum(3).bfloat16()
              for a in (dk, dv)))


@pytest.mark.parametrize("T,Hq,Hkv,Dh,window", [
    (256, 48, 48, 64, 0),      # MiniCPM-2B's heads
    (512, 48, 48, 64, 0),
    (256, 12, 4, 64, 0),       # group 3
    (300, 8, 8, 64, 100),      # a window, T past it
    (200, 32, 32, 64, 0),      # ragged T
    (256, 48, 16, 128, 0),     # Qwen2.5-14B's heads, head_dim 128
])
def test_flash_bwd_bf16_pds_within_card_tolerance(T, Hq, Hkv, Dh, window):
    """The bf16 K4/K5 round p and dS to bf16 before their products; the
    card holds their grads to the f32 plain version within 1e-2 of the
    largest |grad| (`BWD_TOL[bf16]` of the card tests). That rounding, on
    bf16 inputs, stays within the same 1e-2 of `jax.vjp` of the
    reference's `mha_reference`."""
    q, k, v = qkv(1, T, T, Hq, Hkv, Dh, seed=T + Dh)
    do = np.random.default_rng(T).standard_normal(q.shape).astype(np.float32)
    group = Hq // Hkv
    got = _bf16_pds_backward(*(torch.from_numpy(a).bfloat16()
                               for a in (q, k, v, do)),
                             group=group, window=window)
    kw = dict(causal=True, group=group, sliding_window=window)
    _, vjp = jax.vjp(lambda a, b, c: jref.mha_reference(a, b, c, **kw),
                     *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b, np.float32)
        err = np.abs(a.float().numpy() - b).max()
        assert err <= 1e-2 * np.abs(b).max(), (name, err, np.abs(b).max())


@pytest.mark.parametrize("S,Hq,Hkv,lengths", [
    (40, 4, 2, [1, 40]),
    (296, 6, 2, [257, 3]),     # the serve path's cache length, group 3
    (17, 8, 1, [17, 9]),
])
def test_decode_plain_matches_reference(S, Hq, Hkv, lengths):
    q, k, v = qkv(2, 1, S, Hq, Hkv, 32, seed=S)
    lens = np.asarray(lengths, np.int32)
    o = tda.decode_attention(*_t(q, k, v), torch.from_numpy(lens),
                             group=Hq // Hkv)
    want = jref.mha_reference(*_j(q, k, v), causal=False, group=Hq // Hkv,
                              lengths=jnp.asarray(lens))
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **ATT_TOL)


def test_decode_plain_matches_pallas_interpret():
    q, k, v = qkv(2, 1, 256, 4, 2, 64, seed=3)
    lens = np.asarray([100, 256], np.int32)
    got = tda.decode_attention(*_t(q, k, v), torch.from_numpy(lens), group=2)
    want = jda.decode_attention(*_j(q, k, v), jnp.asarray(lens), group=2,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


def _split_merge_decode(q, k, v, lengths, *, group, split_keys, n_split):
    """K3's arithmetic in f32 numpy, as `csrc/decode_attention.cu` does it:
    per (row, kv head, split) and per warp (a quarter of each tile's rows)
    an online softmax in the log2 domain with one max and one rescale a
    tile; the four warps merged, then the splits in split order. A split
    or warp with no valid key stays at m = -inf, l = 0."""
    B, _, Hq, Dh = q.shape
    Hkv = k.shape[2]
    tile = min(64, max(16, 8192 // (4 * Dh)))   # the f32 kernel's tile
    neg = np.float32(-np.inf)

    def merge(parts):   # [(m, l, acc)] in order -> (M, L, A)
        M = max((m for m, _, _ in parts), default=neg)
        L, A = np.float32(0), np.zeros(Dh, np.float32)
        for m, l, acc in parts:
            c = np.float32(0) if m == neg else np.exp2(m - M)
            L, A = L + l * c, A + acc * c
        return M, L, A

    o = np.zeros_like(q)
    scale = np.float32(1 / np.sqrt(Dh) * np.log2(np.e))
    for b in range(B):
        n = int(np.clip(lengths[b], 0, k.shape[1]))
        for h in range(Hq):
            qs = q[b, 0, h] * scale
            kh, vh = k[b, :, h // group], v[b, :, h // group]
            splits = []
            for sp in range(n_split):
                start = sp * split_keys
                end = min(start + split_keys, n)
                warps = [[neg, np.float32(0), np.zeros(Dh, np.float32)]
                         for _ in range(4)]
                for key0 in range(start, end, tile):
                    for w, st in enumerate(warps):
                        rows = np.arange(key0 + w * tile // 4,
                                         key0 + (w + 1) * tile // 4)
                        rows = rows[rows < end]
                        if not rows.size:
                            continue
                        s = kh[rows] @ qs
                        m_new = max(st[0], s.max())
                        alpha = np.exp2(st[0] - m_new)
                        p = np.exp2(s - m_new)
                        st[1] = st[1] * alpha + p.sum()
                        st[2] = st[2] * alpha + p @ vh[rows]
                        st[0] = m_new
                splits.append(merge(warps))
            _, L, A = merge(splits)
            o[b, 0, h] = A / (L if L else np.float32(1))
    return o


def test_decode_split_plan_at_the_serve_shapes():
    """5 splits of 64 keys at both serve paths' S 296 (320 and 640 CTAs on
    132 SMs), 5 of 832 at Zamba2's 4096-key window."""
    assert tda.split_plan(4, 296, 16, 132) == (64, 5)
    assert tda.split_plan(4, 296, 32, 132) == (64, 5)
    assert tda.split_plan(4, 4096, 32, 132) == (832, 5)
    assert tda.split_plan(4, 0, 16, 132) == (64, 1)
    for B, S, Hkv in ((1, 1, 1), (2, 4097, 2), (4, 296, 16), (8, 65, 64)):
        keys, n = tda.split_plan(B, S, Hkv, 132)
        assert keys % 64 == 0 and 1 <= n <= tda.MAX_SPLITS
        assert (n - 1) * keys < S <= n * keys


@pytest.mark.parametrize("S,Hq,Hkv,Dh,lengths,plan", [
    # the Qwen2.5-14B serve plan: splits of 64; on, past and short of edges
    (296, 6, 2, 128, [64, 65, 257, 296], (4, 296, 16)),
    (296, 6, 2, 128, [0, 1, 63, 128], (4, 296, 16)),
    # Zamba2-1.2B's 4096-key window: 5 splits of 832; every split but the
    # first empty in row 1
    (4096, 2, 2, 64, [4096, 831], (4, 4096, 32)),
    (4096, 2, 2, 64, [833, 1664], (4, 4096, 32)),
    # the plan of few heads: the most splits (8 of 512)
    (4096, 2, 2, 64, [4095, 513], (2, 4096, 2)),
])
def test_decode_split_merge_matches_reference_and_pallas(S, Hq, Hkv, Dh,
                                                         lengths, plan):
    q, k, v = qkv(len(lengths), 1, S, Hq, Hkv, Dh, seed=S + lengths[1])
    lens = np.asarray(lengths, np.int32)
    split_keys, n_split = tda.split_plan(*plan, 132)
    got = _split_merge_decode(q, k, v, lens, group=Hq // Hkv,
                              split_keys=split_keys, n_split=n_split)
    pallas = jda.decode_attention(*_j(q, k, v), jnp.asarray(lens),
                                  group=Hq // Hkv, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **ATT_TOL)
    ref = np.asarray(jref.mha_reference(*_j(q, k, v), causal=False,
                                        group=Hq // Hkv,
                                        lengths=jnp.asarray(lens)))
    live = lens > 0     # the reference gives mean(v) at length 0
    np.testing.assert_allclose(got[live], ref[live], **ATT_TOL)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("window,n", [(32, 192), (32, 201), (7, 5)])
def test_sor_fit_plain_matches_reference(window, n):
    args = sor_inputs(window, n, seed=n)
    got = tft.sor_fit(*_t(*args), **SOR_KW)
    want = jref.sor_fit_reference(*_j(*args), **SOR_KW)
    usable = np.asarray(want[3]) > 0
    assert usable.any() and not usable.all()
    check_sor([g.numpy() for g in got], want)


def test_sor_fit_plain_matches_pallas_interpret():
    args = sor_inputs(16, 131, seed=1)
    got = tft.sor_fit(*_t(*args), **SOR_KW)
    want = jft.sor_fit(*_j(*args), **SOR_KW, interpret=True)
    check_sor([g.numpy() for g in got], want)


@pytest.mark.parametrize("window,n", [(32, 192), (29, 200), (32, 200),
                                      (29, 192)])
def test_sor_accumulate_plain_matches_reference_and_pallas(window, n):
    """K7's plain version against `ref.sor_accumulate_reference` and the
    Pallas kernel in interpret mode, at a window that is not a multiple of
    8 and a lane count that is not a multiple of 128, with zero-weight
    rows."""
    args = accumulate_inputs(window, n, seed=window + n)
    got = [g.numpy() for g in tft.sor_accumulate(*_t(*args))]
    check_sums(got, jref.sor_accumulate_reference(*_j(*args)))
    check_sums(got, jft.sor_accumulate(*_j(*args), interpret=True))
    for a, b in zip(tops.sor_accumulate(*_t(*args)), got):   # CPU: plain
        np.testing.assert_array_equal(a.numpy(), b)


# f32 attention gradients: sums over keys, rows and the group in another
# order (and the reference's autodiff through softmax), O(1) values
BWD_TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("T,Hq,Hkv,Dh,window", [
    (64, 4, 4, 64, 0),         # group 1
    (64, 6, 2, 64, 0),         # group 3
    (50, 6, 2, 64, 0),         # ragged T
    (96, 4, 4, 64, 24),        # causal + window
    (40, 6, 2, 32, 10),        # window, ragged, group 3
])
def test_flash_bwd_plain_matches_jax_grad(T, Hq, Hkv, Dh, window):
    q, k, v = qkv(2, T, T, Hq, Hkv, Dh, seed=T + Hq)
    do = np.random.default_rng(T).standard_normal(q.shape).astype(np.float32)
    group = Hq // Hkv
    kw = dict(causal=True, group=group, sliding_window=window)
    _, vjp = jax.vjp(lambda a, b, c: jref.mha_reference(a, b, c, **kw),
                     *_j(q, k, v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q, k, v)
    o, lse = tfa.flash_attention_plain(tq, tk, tv, **kw)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse,
                                        torch.from_numpy(do), **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("group,window", [(1, 0), (3, 0), (1, 40)])
def test_flash_bwd_plain_matches_pallas_interpret(group, window):
    """dq, dk, dv against the Pallas `_bwd` (dq and dk/dv kernels in
    interpret mode) on the same forward residuals."""
    B, T, Hkv, Dh = 1, 128, 2, 64
    Hq = group * Hkv
    q, k, v = qkv(B, T, T, Hq, Hkv, Dh, seed=11 + group)
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    sw = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)
    kw = dict(causal=True, group=group, window=window, bq=64, bk=64,
              interpret=True)
    o_j, lse_j = jfa._fwd(sw(q), sw(k), sw(v), **kw)
    want = jfa._bwd((sw(q), sw(k), sw(v), o_j, lse_j), sw(do), **kw)
    tkw = dict(causal=True, group=group, sliding_window=window)
    tq, tk, tv = _t(q, k, v)
    o, lse = tfa.flash_attention_plain(tq, tk, tv, **tkw)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse,
                                        torch.from_numpy(do), **tkw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(),
                                   np.asarray(jnp.swapaxes(b, 1, 2)),
                                   **BWD_TOL, err_msg=name)


def test_flash_function_on_cpu_is_the_plain_backward():
    """autograd through ops.flash_attention on CPU tensors runs the plain
    forward and the plain backward on the saved (q, k, v, o, lse), and
    launches no kernel; a strided incoming gradient is taken."""
    q, k, v = (a.requires_grad_() for a in _t(*qkv(2, 48, 48, 6, 2, 32,
                                                    seed=8)))
    tops.reset_launch_counts()
    o = tops.flash_attention(q, k, v, causal=True, group=3,
                             sliding_window=20)
    do = torch.randn((2, 6, 48, 32), generator=torch.Generator().manual_seed(
        0)).transpose(1, 2)
    got = torch.autograd.grad(o, (q, k, v), do)
    kw = dict(causal=True, group=3, sliding_window=20)
    o2, lse = tfa.flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                        **kw)
    want = tfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                         o2, lse, do.contiguous(), **kw)
    assert torch.equal(o.detach(), o2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tops.launch_counts() == {name: 0 for name in tops.KERNELS}


def _fleet_matrix(n_chips, seed):
    x = np.random.default_rng(seed).standard_normal((n_chips, 5)).astype(
        np.float32)
    x[n_chips // 3, 2] = np.nan                    # a NaN lane in field 2
    return x


# fleet reduction: max/min exact; the f32 sum in another order
RED_TOL = (dict(rtol=0, atol=0), dict(rtol=0, atol=0),
           dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("n_chips", [1, 64, 67, 300])
def test_fleet_reduce_plain_matches_reference(n_chips):
    x = _fleet_matrix(n_chips, n_chips)
    got = tft.fleet_reduce(torch.from_numpy(x))
    want = jref.fleet_reduce_reference(jnp.asarray(x))
    for a, b, tol in zip(got, want, RED_TOL):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    assert all(np.isnan(a[2].item()) for a in got)


def test_fleet_reduce_plain_matches_pallas_interpret():
    x = _fleet_matrix(67, 0)
    got = tft.fleet_reduce(torch.from_numpy(x))
    want = jft.fleet_reduce(jnp.asarray(x), interpret=True)
    for a, b, tol in zip(got, want, RED_TOL):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    assert all(np.isnan(np.asarray(b)[2]) for b in want)


@pytest.mark.parametrize("n", [1, 8, 64, 67])
def test_fleet_percentile_matches_reference(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    for q in (50.0, 95.0, 100.0):
        np.testing.assert_allclose(
            tops.fleet_percentile(torch.from_numpy(x), q).numpy(),
            np.asarray(jref.fleet_percentile_reference(jnp.asarray(x), q)),
            rtol=1e-6, atol=1e-7)


def test_wrappers_reject_other_devices():
    q = torch.zeros((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        tda.decode_attention(q[:, :1], q, q, torch.zeros(1, dtype=torch.int32,
                                                         device="meta"))
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        tft.sor_fit(x, x, x, x[0], x[0], **SOR_KW)
    with pytest.raises(ValueError):
        tft.sor_accumulate(x, x, x)
    with pytest.raises(ValueError):
        tft.fleet_reduce(x)
    lse = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dkv(q, q, q, q, lse, lse)
