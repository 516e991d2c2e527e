"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Every test here carries the `cuda` marker and skips without a card;
the file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -m cuda -o filterwarnings=default \
        tests/test_torch_kernels_cuda.py

(pytest.ini's warning filter names a class of the JAX package; the
override keeps pytest from importing it.)

The seeded input helpers are in tests/test_torch_inputs.py."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import fleet_telemetry as tft
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba2_ssd as tm2
from repro_torch.kernels import quant_codec as tqc
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as tr6
from test_torch_inputs import (SOR_KW, accumulate_inputs, check_sor,
                               check_sums, codec_input, codec_ties,
                               mamba2_inputs, qkv, rwkv_inputs, sor_inputs)

# attention on the card: f32 kernel vs f32 plain (FMA order); bf16 output
# vs the f32 plain version rounded to bf16 (an ulp or two of O(1) values)
ATT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Hq,Hkv,Dh,window", [
    (256, 48, 16, 128, 0),     # the serve path's prefill
    (256, 32, 32, 64, 4096),   # the hybrid serve path's (Zamba2-1.2B)
    (200, 12, 4, 32, 0),       # ragged T, the padded-GQA plan
    (77, 8, 8, 64, 0),         # MHA, head_dim 64
    (150, 4, 2, 32, 40),       # sliding window
    (512, 48, 48, 64, 0),      # the training path (MiniCPM-2B's heads)
    (200, 48, 16, 128, 0),     # ragged T at batch 2: a K/V tile past S must
    (200, 32, 32, 64, 0),      # not read the next batch row (Dh 128, 64)
    (300, 8, 8, 64, 100),      # T past the window: window-edge tiles
])
def test_flash_kernel_matches_plain(cuda, dtype, T, Hq, Hkv, Dh, window):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in qkv(2, T, T, Hq, Hkv, Dh, seed=T))
    kw = dict(causal=True, group=Hq // Hkv, sliding_window=window)
    o, lse = tfa.flash_attention(q, k, v, **kw)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, **kw)
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_counts_one_launch_per_call(cuda, dtype):
    """The FMA kernel (f32) and the tensor-core kernel (bf16) each count."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in qkv(1, 64, 64, 4, 2, 64, seed=2))
    before = tfa.flash_attention.launches
    tfa.flash_attention(q, k, v, causal=True, group=2)
    assert tfa.flash_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_without_keys(cuda, dtype):
    """S == 0 (no K/V tile to load): o is 0 and lse -inf, as the plain
    version."""
    q = torch.ones((1, 5, 2, 64), dtype=dtype, device=cuda)
    k = torch.ones((1, 0, 2, 64), dtype=dtype, device=cuda)
    o, lse = tfa.flash_attention(q, k, k, causal=False)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, k, causal=False)
    assert torch.equal(o, o_ref) and (o == 0).all()
    assert torch.equal(lse, lse_ref) and torch.isneginf(lse).all()


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_kernel_refuses_unaligned_inputs(cuda, which):
    """TMA needs 16-byte-aligned bases: a contiguous view 2 bytes into a
    buffer raises before any launch."""
    shape, n = (1, 64, 2, 64), 64 * 2 * 64
    qkv_ = [torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
            for _ in range(3)]
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device=cuda)
    qkv_[which] = buf.as_strided(shape, (n, 128, 64, 1), storage_offset=1)
    assert qkv_[which].is_contiguous() and qkv_[which].data_ptr() % 16 == 2
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(*qkv_, causal=True)
    assert tfa.flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hq,Hkv,Dh,lengths", [
    (296, 48, 16, 128, [1, 98, 257, 296]),   # the serve path's decode
    (296, 32, 32, 64, [1, 98, 257, 296]),    # the hybrid serve path's
    (50, 4, 4, 64, [50, 3, 1, 17]),
    (33, 8, 1, 32, [33, 33, 2, 9]),           # group 8, the kernel's most
])
def test_decode_kernel_matches_plain(cuda, dtype, S, Hq, Hkv, Dh, lengths):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in qkv(4, 1, S, Hq, Hkv, Dh, seed=S))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    o = tda.decode_attention(q, k, v, lens, group=Hq // Hkv)
    want = tda.decode_attention_plain(q, k, v, lens, group=Hq // Hkv)
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_decode_kernel_zero_length_rows_are_zero(cuda):
    """As the Pallas kernel: a row with no valid slot returns zeros."""
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in qkv(2, 1, 16, 4, 2, 32, seed=0))
    lens = torch.tensor([0, 16], dtype=torch.int32, device=cuda)
    o = tda.decode_attention(q, k, v, lens, group=2)
    assert (o[0] == 0).all()
    torch.testing.assert_close(
        o[1], tda.decode_attention_plain(q, k, v, lens, group=2)[1],
        rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("window,n", [(32, 192), (32, 201), (7, 5)])
def test_sor_fit_kernel_matches_plain(cuda, window, n):
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in sor_inputs(window, n, seed=n))
    got = tft.sor_fit(*args, **SOR_KW)
    want = tft.sor_fit_plain(*args, **SOR_KW)
    check_sor([g.cpu().numpy() for g in got],
              [w.cpu().numpy() for w in want])


@pytest.mark.cuda
@pytest.mark.parametrize("window,n", [(32, 192), (29, 200), (32, 3 * 1024),
                                      (7, 5)])
def test_sor_accumulate_kernel_matches_plain(cuda, window, n):
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in accumulate_inputs(window, n, seed=n))
    got = tft.sor_accumulate(*args)
    want = tft.sor_accumulate_plain(*args)
    check_sums([g.cpu().numpy() for g in got],
               [w.cpu().numpy() for w in want])


@pytest.mark.cuda
@pytest.mark.parametrize("window,n", [(32, 192), (32, 201), (29, 200)])
def test_split_fit_equals_the_fused_kernel(cuda, window, n):
    """K7, then the solve as tensor code, against K1 on the same inputs:
    both sum with the same device function, and the torch solve runs as
    separately rounded elementwise kernels in K1's op order."""
    x, y, w, bound, guard = (torch.from_numpy(a).to(cuda)
                             for a in sor_inputs(window, n, seed=n))
    fused = tft.sor_fit(x, y, w, bound, guard, **SOR_KW)
    split = tref.sor_solve_reference(tft.sor_accumulate(x, y, w), bound,
                                     guard, **SOR_KW)
    assert bool((fused[3] > 0).any())
    for name, a, b in zip(("intercept", "slope", "v_frontier",
                           "confidence", "n_eff", "floor"), split, fused):
        assert torch.equal(a, b), (name, (a - b).abs().max().item())


@pytest.mark.cuda
def test_sor_accumulate_refusals(cuda):
    x = torch.zeros((8, 4), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        tft.sor_accumulate(x.double(), x.double(), x.double())
    with pytest.raises(ValueError, match="must be"):
        tft.sor_accumulate(x, x[:7], x)
    with pytest.raises(ValueError, match="window, n"):
        tft.sor_accumulate(x[0], x[0], x[0])
    with pytest.raises(ValueError, match="one CUDA device"):
        tft.sor_accumulate(x, x.cpu(), x)
    with pytest.raises(ValueError, match="contiguous"):
        tft.sor_accumulate(x[:, ::2], x[:, :2].contiguous(),
                           x[:, :2].contiguous())


def bwd_close(got, want, tol):
    """max |got - want| within `tol` of the plain version's largest
    magnitude: the sums run in another order (f32), and a bf16 output is
    the f32 result rounded (an ulp is 2^-8 of the value)."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        assert err <= tol * max(scale, 1.0), (name, err, scale)


# flash backward: relative to the largest |grad|
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Hq,Hkv,Dh,window", [
    (4, 512, 48, 48, 64, 0),    # the training path: MiniCPM-2B's heads
    (2, 256, 48, 16, 128, 0),   # head_dim 128, group 3 (Qwen2.5-14B)
    (2, 200, 12, 4, 32, 0),     # ragged T, group 3
    (2, 150, 4, 2, 32, 40),     # sliding window
    (1, 77, 8, 8, 64, 0),       # ragged T smaller than one q tile pair
])
def test_flash_bwd_kernels_match_plain(cuda, dtype, B, T, Hq, Hkv, Dh,
                                       window):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in qkv(B, T, T, Hq, Hkv, Dh, seed=T))
    do = torch.from_numpy(qkv(B, T, T, Hq, Hkv, Dh, seed=T + 1)[0]).to(
        cuda, dtype)
    kw = dict(causal=True, group=Hq // Hkv, sliding_window=window)
    o, lse = tfa.flash_attention(q, k, v, **kw)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    bwd_close(got, want, BWD_TOL[dtype])


@pytest.mark.cuda
def test_flash_function_grads_match_plain_backward(cuda):
    """autograd through ops.flash_attention (K2, then K4 + K5) equals the
    plain backward on the same saved tensors."""
    from repro_torch.kernels import ops
    q, k, v = (torch.from_numpy(a).to(cuda).requires_grad_()
               for a in qkv(2, 96, 96, 6, 2, 64, seed=4))
    o = ops.flash_attention(q, k, v, causal=True, group=3)
    # a strided incoming gradient, as through the out-projection reshape
    do = torch.randn((2, 6, 96, 64), device=cuda).transpose(1, 2)
    got = torch.autograd.grad(o, (q, k, v), do)
    o2, lse = tfa.flash_attention(q.detach(), k.detach(), v.detach(),
                                  causal=True, group=3)
    want = tfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                         o2, lse, do, causal=True, group=3)
    bwd_close(got, want, BWD_TOL[torch.float32])


def bwd_inputs(cuda, B, T, Hq, Hkv, Dh, dtype=torch.bfloat16, window=0):
    """Seeded q, k, v, do and K2's o and lse for the backward kernels."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in qkv(B, T, T, Hq, Hkv, Dh, seed=T + Dh))
    do = torch.from_numpy(qkv(B, T, T, Hq, Hkv, Dh, seed=T + 1)[0]).to(
        cuda, dtype)
    kw = dict(causal=True, group=Hq // Hkv, sliding_window=window)
    o, lse = tfa.flash_attention(q, k, v, **kw)
    return (q, k, v, o, lse, do), kw


# the tensor-core K4/K5 (bf16, head_dim 64 and 128) at their edges
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Hq,Hkv,Dh,window", [
    (2, 200, 32, 32, 64, 0),    # ragged T at batch 2: a tile past T must
    (2, 200, 48, 16, 128, 0),   # not read the next batch row (Dh 64, 128)
    (2, 300, 8, 8, 64, 100),    # T past the window: window-edge tiles
    (2, 333, 4, 2, 128, 70),    # window, ragged, group 2, Dh 128
    (1, 160, 4, 4, 64, 7),      # a window inside one tile
    (2, 256, 12, 4, 64, 0),     # group 3 at head_dim 64
    (2, 190, 12, 4, 64, 50),    # group 3, window, ragged
    (1, 40, 6, 2, 64, 0),       # one q tile and one key tile, both ragged
])
def test_flash_bwd_sm90_edges_match_plain(cuda, B, T, Hq, Hkv, Dh, window):
    args, kw = bwd_inputs(cuda, B, T, Hq, Hkv, Dh, window=window)
    got = tfa.flash_attention_bwd(*args, **kw)
    want = tfa.flash_attention_bwd_plain(*args, **kw)
    assert all(torch.isfinite(g.float()).all() for g in got)
    bwd_close(got, want, BWD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_bwd_sm90_is_bit_identical_over_launches(cuda, Dh):
    """Each CTA owns its output tile (no atomics): two launches on the same
    inputs give the same bits."""
    args, kw = bwd_inputs(cuda, 2, 300, 12, 4, Dh, window=0)
    first = tfa.flash_attention_bwd(*args, **kw)
    second = tfa.flash_attention_bwd(*args, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Dh", [(torch.float32, 64),
                                      (torch.bfloat16, 32),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128)])
def test_flash_bwd_counts_one_launch_per_call(cuda, dtype, Dh):
    """The FMA kernels (f32, bf16 at head_dim 32) and the tensor-core
    kernels (bf16 at 64 and 128) each count one launch per call."""
    (q, k, v, o, lse, do), kw = bwd_inputs(cuda, 1, 70, 4, 2, Dh,
                                           dtype=dtype)
    delta = tfa.bwd_delta(o, do)
    dq0 = tfa.flash_attention_bwd_dq.launches
    dkv0 = tfa.flash_attention_bwd_dkv.launches
    tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    assert tfa.flash_attention_bwd_dq.launches == dq0 + 1
    assert tfa.flash_attention_bwd_dkv.launches == dkv0
    tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert tfa.flash_attention_bwd_dq.launches == dq0 + 1
    assert tfa.flash_attention_bwd_dkv.launches == dkv0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "do"])
def test_flash_bwd_refuses_unaligned_inputs(cuda, which):
    """TMA needs 16-byte-aligned bases: a q or do that is a contiguous view
    2 bytes into a buffer raises in K4 and K5 before any launch."""
    (q, k, v, o, lse, do), kw = bwd_inputs(cuda, 1, 64, 2, 2, 64)
    delta = tfa.bwd_delta(o, do)
    buf = torch.zeros(q.numel() + 8, dtype=q.dtype, device=cuda)
    bad = buf.as_strided(q.shape, q.stride(), storage_offset=1)
    bad.copy_(q if which == "q" else do)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 2
    args = dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    args[which] = bad
    for fn in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        before = fn.launches
        with pytest.raises(ValueError, match="16-byte"):
            fn(**args, **kw)
        assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Dh", [(torch.float32, 64),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128)])
def test_flash_bwd_without_queries(cuda, dtype, Dh):
    """T == 0: dq is empty and K5 writes dk = dv = 0 for every key (no q
    tile to load), as the plain version; T == S == 0 returns empty grads."""
    q = torch.ones((2, 0, 4, Dh), dtype=dtype, device=cuda)
    k = torch.ones((2, 5, 2, Dh), dtype=dtype, device=cuda)
    stat = torch.zeros((2, 4, 0), device=cuda)
    kw = dict(causal=False, group=2)
    dq = tfa.flash_attention_bwd_dq(q, k, k, q, stat, stat, **kw)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, k, q, stat, stat, **kw)
    dk_ref, dv_ref = tfa.flash_attention_bwd_dkv_plain(q, k, k, q, stat,
                                                        stat, **kw)
    assert dq.shape == q.shape
    assert torch.equal(dk, dk_ref) and (dk == 0).all()
    assert torch.equal(dv, dv_ref) and (dv == 0).all()
    empty = torch.ones((1, 0, 2, Dh), dtype=dtype, device=cuda)
    o, lse = tfa.flash_attention(empty, empty, empty, causal=True)
    got = tfa.flash_attention_bwd(empty, empty, empty, o, lse, empty,
                                  causal=True)
    assert all(g.shape == empty.shape for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chips", [64, 67, 1000])
def test_fleet_reduce_kernel_matches_plain(cuda, n_chips):
    x = torch.from_numpy(np.random.default_rng(n_chips).standard_normal(
        (n_chips, 5)).astype(np.float32)).to(cuda)
    x[n_chips // 2, 3] = float("nan")     # one NaN lane in field 3
    got = tft.fleet_reduce(x)
    want = tft.fleet_reduce_plain(x)
    for a, b, rtol in zip(got, want, (0.0, 0.0, 1e-5)):
        torch.testing.assert_close(a, b, rtol=rtol, atol=rtol,
                                   equal_nan=True)
    assert all(torch.isnan(a[3]) for a in got)
    assert not any(torch.isnan(a[:3]).any() or torch.isnan(a[4])
                   for a in got)


@pytest.mark.cuda
def test_kernels_count_their_launches(cuda):
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a).to(cuda).requires_grad_()
               for a in qkv(1, 8, 8, 2, 1, 32, seed=1))
    o = ops.flash_attention(q, k, v, causal=True, group=2)
    torch.autograd.grad(o.sum(), (q, k, v))
    ops.decode_attention(q[:, :1].detach().contiguous(), k.detach(),
                         v.detach(),
                         torch.tensor([8], dtype=torch.int32, device=cuda),
                         group=2)
    ops.sor_fit(*(torch.from_numpy(a).to(cuda)
                  for a in sor_inputs(4, 3, seed=0)), **SOR_KW)
    ops.sor_accumulate(*(torch.from_numpy(a).to(cuda)
                         for a in accumulate_inputs(4, 3, seed=0)))
    ops.fleet_reduce(torch.zeros((3, 2), device=cuda))
    r, k, v, w, u, _ = (None if a is None else torch.from_numpy(a).to(cuda)
                        for a in rwkv_inputs(1, 3, 1, 64, seed=0,
                                             state=False))
    ops.rwkv6_scan(r, k, v, w, u)
    x, dt, A, B, C, D, _ = (None if a is None else
                            torch.from_numpy(a).to(cuda)
                            for a in mamba2_inputs(1, 3, 2, 1, 16, seed=0,
                                                   state=False))
    ops.mamba2_scan(x, dt, A, B, C, D)
    ops.quantize_int8(torch.ones(300, device=cuda))
    ops.fleet_percentile(torch.zeros(3, device=cuda), 95.0)
    assert ops.launch_counts() == {name: 1 for name in ops.KERNELS}


# -- the int8 codec (K10): codes and scales equal the plain version -----------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,block", [(1000, 256), (65, 64), (300_000, 256),
                                     (4096, 256), (2304, 256), (4097, 1024),
                                     (100, 32)])
def test_quantize_int8_kernel_equals_plain(cuda, dtype, n, block):
    x = torch.from_numpy(codec_input(n, seed=n, block=block)).to(cuda, dtype)
    q, s = tqc.quantize_int8(x, block=block)
    q_ref, s_ref = tqc.quantize_int8_plain(x, block=block)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)


@pytest.mark.cuda
def test_quantize_int8_kernel_ties_zeros_nan(cuda):
    """Exact .5 ties round half to even, an all-zero block and a NaN block
    take scale 1, the NaN's code is 0."""
    x = np.concatenate([codec_ties(), np.zeros(256, np.float32),
                        codec_input(256, seed=3)])
    x[600] = np.nan
    x = torch.from_numpy(x).to(cuda)
    q, s = tqc.quantize_int8(x)
    q_ref, s_ref = tqc.quantize_int8_plain(x)
    assert torch.equal(s, s_ref) and s[:, 0].tolist()[:3] == [1.0] * 3
    assert torch.equal(q, q_ref) and q[2, 600 - 512].item() == 0


@pytest.mark.cuda
def test_quantize_int8_refusals(cuda):
    x = torch.ones(512, device=cuda)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tqc.quantize_int8(torch.ones(512, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        tqc.quantize_int8(x.reshape(2, 256).t())
    for block in (48, 1056, 16):
        with pytest.raises(ValueError, match="multiple of 32"):
            tqc.quantize_int8(x, block=block)
    for dtype in (torch.int32, torch.int8, torch.float16):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tqc.quantize_int8(x.to(dtype))
    with pytest.raises(ValueError, match="non-empty"):
        tqc.quantize_int8(x[:0])


# RWKV6 scan: y and the state against the plain version, relative to the
# largest magnitude of each. f32: sums in another order; bf16: r, k, v are
# the same bf16 values in both, the state is f32 in both, and y is the f32
# result rounded to bf16 (an ulp is 2^-8 of the value)
R6_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def scan_close(got, want, tol):
    for name, a, b in zip(("y", "state"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        assert err <= tol * max(scale, 1.0), (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,T,H", [
    (4, 256, 64),     # the serve path's prefill (RWKV6-7B: 64 heads x 64)
    (4, 1, 64),       # its decode step
    (2, 200, 8),      # ragged T, not a multiple of the staged tile
    (2, 64, 8),
])
def test_rwkv6_scan_kernel_matches_plain(cuda, dtype, with_state, B, T, H):
    r, k, v, w, u, s0 = rwkv_inputs(B, T, H, 64, seed=T, state=with_state)
    r, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (r, k, v))
    w, u = (torch.from_numpy(a).to(cuda) for a in (w, u))
    s0 = None if s0 is None else torch.from_numpy(s0).to(cuda)
    tr6.rwkv6_scan.launches = 0
    got = tr6.rwkv6_scan(r, k, v, w, u, init_state=s0)
    assert tr6.rwkv6_scan.launches == 1
    want = tr6.rwkv6_scan_plain(r, k, v, w, u, init_state=s0)
    assert tr6.rwkv6_scan.launches == 1
    scan_close(got, want, R6_TOL[dtype])


@pytest.mark.cuda
def test_rwkv6_scan_kernel_refuses_what_it_does_not_take(cuda):
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(cuda)
                         for a in rwkv_inputs(1, 8, 2, 64, seed=0))
    bad = {
        "cpu w": dict(w=w.cpu()),
        "bf16 w": dict(w=w.bfloat16()),
        "mixed r/k dtype": dict(k=k.bfloat16()),
        "non-contiguous r": dict(r=r.transpose(1, 2).contiguous()
                                 .transpose(1, 2)),
        "wrong u shape": dict(u=u[:1]),
        "bf16 state": dict(init_state=s0.bfloat16()),
    }
    for change in bad.values():
        a = {**dict(r=r, k=k, v=v, w=w, u=u, init_state=s0), **change}
        with pytest.raises(ValueError, match="rwkv6_scan"):
            tr6.rwkv6_scan(a["r"], a["k"], a["v"], a["w"], a["u"],
                           init_state=a["init_state"])
    r32, k32, v32, w32 = (a[..., :32].contiguous() for a in (r, k, v, w))
    with pytest.raises(ValueError, match="head_dim"):
        tr6.rwkv6_scan(r32, k32, v32, w32, u[:, :32].contiguous())


# Mamba2 SSD scan: y and the state against the plain version, relative to
# the largest magnitude of each, for the reasons given for R6_TOL: f32 sums
# in another order; bf16 x, B, C are the same values in both, the state is
# f32 in both, and y is the f32 result rounded to bf16
M2_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("Bt,T,H,G,N", [
    (4, 256, 64, 1, 64),   # the serve path's prefill (Zamba2-1.2B)
    (4, 1, 64, 1, 64),     # its decode step
    (2, 200, 8, 1, 64),    # ragged T, not a multiple of the staged tile
    (2, 64, 8, 2, 16),     # two groups, the tiny config's d_state
    (2, 37, 4, 2, 16),
])
def test_mamba2_ssd_kernel_matches_plain(cuda, dtype, with_state, Bt, T, H,
                                         G, N):
    x, dt, A, B, C, D, s0 = mamba2_inputs(Bt, T, H, G, N, seed=T,
                                          state=with_state)
    x, B, C = (torch.from_numpy(a).to(cuda, dtype) for a in (x, B, C))
    dt, A, D = (torch.from_numpy(a).to(cuda) for a in (dt, A, D))
    s0 = None if s0 is None else torch.from_numpy(s0).to(cuda)
    tm2.mamba2_ssd.launches = 0
    got = tm2.mamba2_ssd(x, dt, A, B, C, D, init_state=s0)
    assert tm2.mamba2_ssd.launches == 1
    want = tm2.mamba2_ssd_plain(x, dt, A, B, C, D, init_state=s0)
    assert tm2.mamba2_ssd.launches == 1
    scan_close(got, want, M2_TOL[dtype])


@pytest.mark.cuda
def test_mamba2_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, B, C, D, s0 = (torch.from_numpy(a).to(cuda)
                             for a in mamba2_inputs(1, 8, 4, 1, 16, seed=0))
    args = dict(x=x, dt=dt, A=A, B=B, C=C, D=D, init_state=s0)
    bad = {
        "cpu dt": dict(dt=dt.cpu()),
        "bf16 dt": dict(dt=dt.bfloat16()),
        "mixed x/B dtype": dict(B=B.bfloat16()),
        "non-contiguous x": dict(x=x.transpose(1, 2).contiguous()
                                 .transpose(1, 2)),
        "wrong A shape": dict(A=A[:1]),
        "bf16 state": dict(init_state=s0.bfloat16()),
        "head_dim 32": dict(x=x[..., :32].contiguous(),
                            init_state=s0[..., :32].contiguous()),
        "d_state 8": dict(B=B[..., :8].contiguous(), C=C[..., :8].contiguous(),
                          init_state=s0[:, :, :8].contiguous()),
        "d_state 32": dict(B=B.repeat(1, 1, 1, 2), C=C.repeat(1, 1, 1, 2),
                           init_state=s0.repeat(1, 1, 2, 1)),
        "3 groups of 4 heads": dict(B=B.expand(1, 8, 3, 16).contiguous(),
                                    C=C.expand(1, 8, 3, 16).contiguous()),
    }
    for change in bad.values():
        a = {**args, **change}
        with pytest.raises(ValueError, match="mamba2_ssd"):
            tm2.mamba2_ssd(a["x"], a["dt"], a["A"], a["B"], a["C"], a["D"],
                           init_state=a["init_state"])
