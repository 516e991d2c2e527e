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
from test_torch_inputs import (FLEET_CASES, FLEET_SIZES, FLEET_SUM_RTOL,
                               RING_BOUND, RING_CASES, SOR_KW, VIEW_OPS,
                               OpNames, accumulate_inputs, check_fleet_stats,
                               check_refit, check_sor, check_sums,
                               codec_input, codec_ties, ef_inputs,
                               fleet_inputs,
                               mamba2_adversarial_decay, mamba2_inputs, qkv,
                               ring_state, rwkv_adversarial_w, rwkv_inputs,
                               sor_inputs)

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


def _decode_case(cuda, dtype, S, Hq, Hkv, Dh, lengths, seed):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in qkv(len(lengths), 1, S, Hq, Hkv, Dh, seed=seed))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    return q, k, v, lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hq,Hkv,Dh,lengths", [
    # the Qwen2.5-14B heads, 5 splits of 64: on a split edge, one past it,
    # one short of it
    (296, 48, 16, 128, [64, 65, 63, 128]),
    # every split but the first empty (rows 0, 3), and the full row
    (296, 48, 16, 128, [1, 296, 64, 5]),
    # Zamba2-1.2B's heads at its 4096-key window: full, then S 4097 ragged
    (4096, 32, 32, 64, [4096, 4096, 4096, 4096]),
    (4097, 32, 32, 64, [4097, 833, 1, 4000]),
])
def test_decode_kernel_split_edges(cuda, dtype, S, Hq, Hkv, Dh, lengths):
    q, k, v, lens = _decode_case(cuda, dtype, S, Hq, Hkv, Dh, lengths, S)
    o = tda.decode_attention(q, k, v, lens, group=Hq // Hkv)
    want = tda.decode_attention_plain(q, k, v, lens, group=Hq // Hkv)
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 3, 8])
def test_decode_kernel_groups_and_head_dims(cuda, dtype, Dh, group):
    """Every tile geometry (16 to 64 keys) at the group registers 1, 4 and
    8; ragged lengths across several splits."""
    q, k, v, lens = _decode_case(cuda, dtype, 300, 2 * group, 2, Dh,
                                 [300, 129, 1, 250], Dh + group)
    o = tda.decode_attention(q, k, v, lens, group=group)
    want = tda.decode_attention_plain(q, k, v, lens, group=group)
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4, 8])
def test_decode_kernel_head_dim_16_in_f32(cuda, group):
    """Mistral-Large's tiny config (8 q / 2 kv heads x 16) on the f32
    kernel, ragged lengths across several splits; bf16 at head_dim 16 is
    refused (its row is two 16-byte chunks)."""
    q, k, v, lens = _decode_case(cuda, torch.float32, 300, 2 * group, 2, 16,
                                 [300, 129, 1, 250], 16 + group)
    o = tda.decode_attention(q, k, v, lens, group=group)
    want = tda.decode_attention_plain(q, k, v, lens, group=group)
    tol = ATT_TOL[torch.float32]
    torch.testing.assert_close(o, want, rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="head_dim"):
        tda.decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), lens,
                             group=group)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,causal", [
    (2, 40, 40, 8, 2, True),       # Mistral-Large's tiny heads x 16
    (2, 100, 100, 4, 4, True),     # ragged past a 64-row q tile
    (2, 33, 70, 4, 2, False),      # non-causal at T != S
])
def test_flash_kernels_head_dim_16_match_plain(cuda, dtype, B, T, S, Hq, Hkv,
                                               causal):
    """K2, K4 and K5 at head_dim 16 (the FMA kernels: lanes 16-31 own no
    column) against their plain versions."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in qkv(B, T, S, Hq, Hkv, 16, seed=T + S))
    do = torch.from_numpy(qkv(B, T, S, Hq, Hkv, 16, seed=T + 1)[0]).to(
        cuda, dtype)
    kw = dict(causal=causal, group=Hq // Hkv)
    o, lse = tfa.flash_attention(q, k, v, **kw)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, **kw)
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    bwd_close(got, want, BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Hq,Hkv,Dh,lengths", [
    (296, 48, 16, 128, [1, 98, 257, 296]),   # 5 splits, the merge's order
    (4096, 32, 32, 64, [4096, 833, 1, 4000]),
    (40, 4, 4, 64, [40, 3, 0, 17]),          # one split: no merge
])
def test_decode_kernel_two_launches_same_bits(cuda, dtype, S, Hq, Hkv, Dh,
                                              lengths):
    """No float atomics, and the merging CTA leaves its counter at 0."""
    q, k, v, lens = _decode_case(cuda, dtype, S, Hq, Hkv, Dh, lengths, 7)
    o1 = tda.decode_attention(q, k, v, lens, group=Hq // Hkv)
    o2 = tda.decode_attention(q, k, v, lens, group=Hq // Hkv)
    assert torch.equal(o1, o2)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2])
def test_decode_kernel_refuses_unaligned_inputs(cuda, which):
    """The 16-byte copies need 16-byte-aligned bases: a contiguous view 2
    bytes into a buffer raises before any launch."""
    shapes = [(2, 1, 4, 64), (2, 80, 2, 64), (2, 80, 2, 64)]
    qkv_ = [torch.zeros(s, dtype=torch.bfloat16, device=cuda)
            for s in shapes]
    n = qkv_[which].numel()
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device=cuda)
    qkv_[which] = buf[1:n + 1].view(shapes[which])
    assert qkv_[which].is_contiguous() and qkv_[which].data_ptr() % 16 == 2
    lens = torch.tensor([80, 5], dtype=torch.int32, device=cuda)
    before = tda.decode_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        tda.decode_attention(*qkv_, lens, group=2)
    assert tda.decode_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("S", [40, 296])
def test_decode_kernel_counts_one_launch_per_call(cuda, S):
    """One count a call, with one split (40 keys) or a merge of five."""
    q, k, v, lens = _decode_case(cuda, torch.bfloat16, S, 4, 2, 64,
                                 [S, 1], 3)
    before = tda.decode_attention.launches
    tda.decode_attention(q, k, v, lens, group=2)
    assert tda.decode_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("window,n", [(32, 192), (32, 201), (7, 5),
                                      (29, 200), (64, 67)])
def test_sor_fit_kernel_matches_plain(cuda, window, n):
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in sor_inputs(window, n, seed=n))
    got = tft.sor_fit(*args, **SOR_KW)
    want = tft.sor_fit_plain(*args, **SOR_KW)
    check_sor([g.cpu().numpy() for g in got],
              [w.cpu().numpy() for w in want])


@pytest.mark.cuda
@pytest.mark.parametrize("window,n", [(32, 192), (29, 200), (32, 3 * 1024),
                                      (7, 5), (64, 67)])
def test_sor_accumulate_kernel_matches_plain(cuda, window, n):
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in accumulate_inputs(window, n, seed=n))
    got = tft.sor_accumulate(*args)
    want = tft.sor_accumulate_plain(*args)
    check_sums([g.cpu().numpy() for g in got],
               [w.cpu().numpy() for w in want])


@pytest.mark.cuda
@pytest.mark.parametrize("window,n", [(32, 192), (32, 201), (29, 200),
                                      (64, 67), (7, 5)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("window,n", [(7, 5), (29, 200), (32, 192),
                                      (64, 67)])
def test_sor_kernels_sum_in_row_order(cuda, window, n):
    """K7's sums are the window's products added in row order, each
    product and add rounded on its own: a row-by-row torch sum equals
    them bit for bit, and K1's n_eff is K7's Σw."""
    x, y, w = (torch.from_numpy(a).to(cuda)
               for a in accumulate_inputs(window, n, seed=n))
    got = tft.sor_accumulate(x, y, w)
    want = [torch.zeros(n, device=cuda) for _ in range(5)]
    for r in range(window):
        wx = w[r] * x[r]
        for q, term in enumerate((w[r], wx, w[r] * y[r], wx * x[r],
                                  wx * y[r])):
            want[q] = want[q] + term
    for q, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (q, (a - b).abs().max().item())
    bound = torch.full((n,), -2.0, device=cuda)
    fit = tft.sor_fit(x, y, w, bound, bound, **SOR_KW)
    assert torch.equal(fit[4], got[0])


def ring_args(st, dev):
    """`ring_state`'s ring, old estimate and per-rail bounds on `dev`, and
    the refit's keywords."""
    ring = tuple(torch.from_numpy(np.ascontiguousarray(st[k])).to(dev)
                 for k in ("v", "obs", "valid", "age_s"))
    old = [torch.from_numpy(a).to(dev) for a in st["old"]]
    bound = torch.full((3,), float(np.float32(np.log10(RING_BOUND))),
                       device=dev)
    kw = dict(cursor=st["cursor"], decay=0.92,
              age_halflife_s=st["cfg"]["age_halflife_s"])
    return ring, old, bound, kw


@pytest.mark.cuda
@pytest.mark.parametrize("n_chips", [64, 1024])
@pytest.mark.parametrize("case", RING_CASES)
def test_sor_refit_kernel_matches_plain(cuda, case, n_chips):
    """K1's refit against its plain version (the composed sequence) on the
    card, at the serve paths' 3 x 64 lanes and at 3 x 1024."""
    st = ring_state(case, n_chips)
    ring, old, bound, kw = ring_args(st, cuda)
    kw.update(update_gain=st["cfg"]["update_gain"], **SOR_KW)
    got = tft.sor_refit(*ring, old, bound, **kw)
    want = tft.sor_refit_plain(*ring, old, bound, **kw)
    assert all(a.shape == (3, n_chips) for a in got)
    assert bool((want[3] > 0).any())
    check_refit([a.cpu().numpy() for a in got],
                [a.cpu().numpy() for a in want])


@pytest.mark.cuda
@pytest.mark.parametrize("n_chips", [64, 1024])
@pytest.mark.parametrize("case", ["cursor0", "partial", "nan_lanes",
                                  "aged"])
def test_sor_accumulate_ring_kernel_matches_plain(cuda, case, n_chips):
    st = ring_state(case, n_chips)
    ring, _, _, kw = ring_args(st, cuda)
    got = tft.sor_accumulate_ring(*ring, **kw)
    want = tft.sor_accumulate_ring_plain(*ring, **kw)
    check_sums([a.cpu().numpy() for a in got],
               [a.cpu().numpy() for a in want])


@pytest.mark.cuda
def test_sor_refit_refusals(cuda):
    st = ring_state("mid", 4)
    (v, obs, valid, age), old, bound, kw = ring_args(st, cuda)
    kw.update(update_gain=1.0, **SOR_KW)

    def refit(v=v, obs=obs, valid=valid, age=age, old=old, bound=bound,
              **over):
        return tft.sor_refit(v, obs, valid, age, old, bound, **{**kw,
                                                                **over})

    with pytest.raises(ValueError, match="torch.float32"):
        refit(v=v.double())
    with pytest.raises(ValueError, match="torch.bool"):
        refit(valid=valid.float())
    with pytest.raises(ValueError, match="one CUDA device"):
        refit(obs=obs.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        refit(v=v.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="capacity, n_rails"):
        refit(v=v[0])
    with pytest.raises(ValueError, match="age_s must be"):
        refit(age=age[:, :2].contiguous())
    with pytest.raises(ValueError, match="cursor"):
        refit(cursor=32)
    with pytest.raises(ValueError, match="cursor"):
        refit(cursor=-1)
    with pytest.raises(ValueError, match="five"):
        refit(old=old[:4])
    with pytest.raises(ValueError, match="old"):
        refit(old=[o[:, :2].contiguous() for o in old])
    with pytest.raises(ValueError, match="float32"):
        refit(bound=bound.double())
    with pytest.raises(ValueError, match="cursor"):
        tft.sor_accumulate_ring(v, obs, valid, age, cursor=40, decay=0.92,
                                age_halflife_s=None)


@pytest.mark.cuda
def test_sor_ring_kernels_count_their_launches(cuda):
    """One count a call: the refit on `sor_refit`, K7 on the ring on
    `sor_accumulate` (its kernel); K1 alone does not move."""
    st = ring_state("wrapped", 64)
    ring, old, bound, kw = ring_args(st, cuda)
    before = (tft.sor_refit.launches, tft.sor_accumulate.launches,
              tft.sor_fit.launches)
    tft.sor_refit(*ring, old, bound, update_gain=1.0, **kw, **SOR_KW)
    tft.sor_accumulate_ring(*ring, **kw)
    assert (tft.sor_refit.launches, tft.sor_accumulate.launches,
            tft.sor_fit.launches) == (before[0] + 1, before[1] + 1,
                                      before[2])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_refit_neither_copies_nor_syncs_on_the_card(cuda, fused):
    """A refit on cadence through `sor.update_estimate`: fused, one launch
    of K1's refit and nothing but an allocation and views; split, K7 on the
    ring and the solve's tensor code. Neither copies from the host nor
    synchronises the stream (`torch.cuda.set_sync_debug_mode("error")`
    raises on a synchronising op)."""
    from repro_torch.core import sor as tsor
    from repro_torch.core import telemetry as ttel
    from repro_torch.kernels import ops
    st = ring_state("old_conf", 64)
    hist = ttel.FrameHistory(
        **{f: torch.from_numpy(st[f]).to(cuda)
           for f in ("v", "obs", "age_s", "polled", "valid")},
        cursor=st["cursor"], count=st["count"], capacity=32,
        rails=ttel.ALL_RAIL_OBSERVABLES)
    cfg = tsor.SorConfig(rails=ttel.ALL_RAIL_OBSERVABLES, **st["cfg"])
    old = tsor.SorEstimate(*(torch.from_numpy(a).to(cuda)
                             for a in st["old"]))
    tsor.update_estimate(old, hist, cfg, fused=fused)   # builds the bounds
    torch.cuda.synchronize()
    before = ops.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with OpNames() as rec:
            tsor.update_estimate(old, hist, cfg, fused=fused)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in ops.launch_counts().items()
             if v != before[k]}
    assert moved == ({"sor_refit": 1} if fused else {"sor_accumulate": 1})
    assert not set(rec.names) & {"_to_copy", "copy_", "lift_fresh", "arange",
                                 "log10", "remainder"}, rec.names
    if fused:
        assert set(rec.names) <= VIEW_OPS | {"empty"}, rec.names


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
    (4, 256, 32, 32, 64, 4096),  # Zamba2-1.2B's shared block in training
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


# non-causal attention at T != S: the encoder-decoder's paths (Whisper-base's
# 8 heads x 64 zero-padded to 16 / 16 by the tp=16 plan; its encoder at
# T = S = 1500, whose last 64-key tile holds 28 keys, and its cross
# attention, 256 decoder tokens over 1500 frames), and ragged and reversed
# cases: T past S, a GQA group, head_dim 128, the FMA kernels (f32 and
# head_dim 32)
NONCAUSAL = [
    (1, 1500, 1500, 16, 16, 64),   # Whisper's encoder (one row of its 4)
    (2, 256, 1500, 16, 16, 64),    # Whisper's cross attention
    (2, 77, 200, 8, 4, 128),       # ragged T and S, group 2, head_dim 128
    (2, 300, 65, 6, 2, 64),        # T past S, S one key past a tile
    (2, 40, 130, 4, 4, 32),        # head_dim 32 (the FMA kernels)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,Dh", NONCAUSAL)
def test_flash_kernels_noncausal_at_t_not_s_match_plain(cuda, dtype, B, T,
                                                        S, Hq, Hkv, Dh):
    """K2 forward (o, lse) and K4 + K5 backward (dq, dk, dv) without the
    causal mask at T != S, each against its plain version."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in qkv(B, T, S, Hq, Hkv, Dh, seed=T + S))
    do = torch.from_numpy(qkv(B, T, S, Hq, Hkv, Dh, seed=T + 1)[0]).to(
        cuda, dtype)
    kw = dict(causal=False, group=Hq // Hkv)
    o, lse = tfa.flash_attention(q, k, v, **kw)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, **kw)
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert all(torch.isfinite(g.float()).all() for g in got)
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
@pytest.mark.parametrize("n_chips", [1, 2, 64, 65, 67, 1000])
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
@pytest.mark.parametrize("case", FLEET_CASES)
@pytest.mark.parametrize("n", FLEET_SIZES)
def test_fleet_stats_kernel_matches_plain(cuda, n, case):
    """The fleet step's tail in one launch against its plain version (the
    composed torch sequence) on the card: max, min, the p95s and the
    straggler fraction bit for bit, the means within FLEET_SUM_RTOL, NaN
    where the plain version has NaN; the same bits on a second launch."""
    args = [None if a is None else torch.from_numpy(a).to(cuda)
            for a in fleet_inputs(n, case)]
    got, again, want = ({k: v.cpu() for k, v in out.items()}
                        for out in (tft.fleet_stats(*args),
                                    tft.fleet_stats(*args),
                                    tft.fleet_stats_plain(*args)))
    check_fleet_stats(got, want, FLEET_SUM_RTOL)
    check_fleet_stats(again, got, 0.0)


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
    ring, old, bound, kw = ring_args(ring_state("partial", 2), cuda)
    ops.sor_refit(*ring, old, bound, update_gain=1.0, **kw, **SOR_KW)
    ops.fleet_reduce(torch.zeros((3, 2), device=cuda))
    ops.fleet_stats(*(None if a is None else torch.from_numpy(a).to(cuda)
                      for a in fleet_inputs(5)))
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
    ops.ef_sync_leaf(torch.ones(300, device=cuda),
                     torch.zeros(300, device=cuda))
    ops.fleet_percentile(torch.zeros(3, device=cuda), 95.0)
    assert ops.launch_counts() == {name: 1 for name in ops.KERNELS}


# -- the int8 codec (K10): codes and scales equal the plain version -----------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,block", [(1000, 256), (65, 64), (300_000, 256),
                                     (4096, 256), (2304, 256), (4097, 1024),
                                     (100, 32), (128 * 33, 128),
                                     (10_001, 512), (5000, 384), (487, 96),
                                     (256 * 33 + 4, 256), (70_000, 1024)])
def test_quantize_int8_kernel_equals_plain(cuda, dtype, n, block):
    """Block 256 (the vector kernel) and the scalar kernel's (every other
    block), whole and ragged tails."""
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_refuses_unaligned_inputs(cuda, dtype):
    """The 16-byte loads need a 16-byte-aligned base: a contiguous view one
    element into a buffer raises before any launch; the aligned view of the
    same buffer runs."""
    buf = torch.ones(1024 + 16, dtype=dtype, device=cuda)
    x = buf[1:1025]
    assert x.is_contiguous() and x.data_ptr() % 16
    before = tqc.quantize_int8.launches
    with pytest.raises(ValueError, match="16-byte"):
        tqc.quantize_int8(x)
    assert tqc.quantize_int8.launches == before
    aligned = buf[16 // buf.element_size():][:1024]
    q, s = tqc.quantize_int8(aligned)
    assert torch.equal(q, tqc.quantize_int8_plain(aligned)[0])


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


# -- the fused ef pass (K10 in ef_sync_leaf): bits against the plain version --

# num = sum (g - g_hat)^2 and den = sum g^2: per-lane f32 block sums then
# doubles on the card, torch's f32 sums in the plain version; only the
# order differs (measured on the H100: up to 1e-7 relative in f32). den of
# a bf16 g is rounded to bf16 on both sides: at most one bf16 ulp apart.
EF_SUM_RTOL = 1e-6


def _ef_pair(cuda, g, r, dtype, level):
    """The kernel and the plain version on the same (g, r) and level-2
    thresholds; returns (kernel outputs, its r', plain outputs, its r')."""
    from repro_torch.core import ecollectives as tec
    g = torch.from_numpy(g).to(cuda, dtype)
    r = torch.from_numpy(r).to(cuda)
    thr = tec.topk_thresholds(r + g, 0.25) if level == 2 else None
    r_k, r_p = r.clone(), r.clone()
    got = tqc.ef_sync_leaf(g, r_k, thr)
    want = tqc.ef_sync_leaf_plain(g, r_p, thr)
    return got, r_k, want, r_p


def _bits(t):
    t = t.reshape(-1)
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32) \
        if t.is_floating_point() else t


def _check_ef(got, r_k, want, r_p):
    assert torch.equal(_bits(r_k), _bits(r_p)), "r'"
    for name, a, b in zip(("out", "q2", "s2"), got[:3], want[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name
    for name, a, b in zip(("num", "den"), got[3:], want[3:]):
        assert a.dtype == b.dtype and a.shape == (), name
        if torch.isnan(b):
            assert torch.isnan(a), name
        elif a.dtype == torch.bfloat16:
            assert abs(int(a.view(torch.int16)) - int(b.view(torch.int16))) \
                <= 1, (name, a, b)
        else:
            torch.testing.assert_close(a, b, rtol=EF_SUM_RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1000, 4096, 2304, 300_000, 70_001, 10_000,
                               5000, 92_160])
def test_ef_sync_leaf_kernel_equals_plain(cuda, dtype, level, n):
    """r', out, q2 and s2 bit for bit; num and den within EF_SUM_RTOL (den
    of a bf16 g within one bf16 ulp); whole and ragged last blocks."""
    _check_ef(*_ef_pair(cuda, *ef_inputs("ragged", seed=n, n=n), dtype,
                        level))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zeros", "nan", "ties"])
@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ef_sync_leaf_kernel_special_blocks(cuda, dtype, level, case):
    """An all-zero block, a NaN in g (its block's scale 1, its code 0, num
    and den NaN) and ties at the top-k threshold (all kept)."""
    got, r_k, want, r_p = _ef_pair(cuda, *ef_inputs(case), dtype, level)
    _check_ef(got, r_k, want, r_p)
    if case == "zeros":
        assert (got[2][1] == 1.0).all() and (got[1][1] == 0).all()
    if case == "nan":
        assert torch.isnan(got[3]) and torch.isnan(got[4])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ef_sync_leaf_two_launches_same_bits(cuda, dtype):
    """The partial sums are per CTA in a fixed order and the grid depends
    on n only: two launches on the same inputs give the same bits."""
    g, r = ef_inputs("ragged", seed=5, n=1_000_003)
    g = torch.from_numpy(g).to(cuda, dtype)
    r1 = torch.from_numpy(r).to(cuda)
    r2 = r1.clone()
    a = tqc.ef_sync_leaf(g, r1)
    b = tqc.ef_sync_leaf(g, r2)
    assert torch.equal(r1, r2)
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.cuda
def test_ef_sync_leaf_counts_one_launch_per_call(cuda):
    """One fused launch a leaf; the standalone codec is not launched."""
    from repro_torch.core import ecollectives as tec
    from repro_torch.kernels import ops
    g = torch.randn(3000, device=cuda, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    for level in (1, 2, 1):
        tec.ef_sync_leaf_(g, torch.zeros(3000, device=cuda), level, "data")
    assert ops.launch_counts() == dict(
        {name: 0 for name in ops.KERNELS}, ef_sync_leaf=3)


@pytest.mark.cuda
def test_ef_sync_leaf_refusals(cuda):
    g = torch.ones(512, device=cuda)
    r = torch.zeros(512, device=cuda)
    before = tqc.ef_sync_leaf.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        tqc.ef_sync_leaf(g.to("meta"), r.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        tqc.ef_sync_leaf(g.cpu(), r)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tqc.ef_sync_leaf(g.half(), r)
    with pytest.raises(ValueError, match="f32 r"):
        tqc.ef_sync_leaf(g, r.double())
    with pytest.raises(ValueError, match="contiguous"):
        tqc.ef_sync_leaf(g.reshape(2, 256).t(), r.reshape(2, 256).t())
    buf = torch.ones(512 + 4, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        tqc.ef_sync_leaf(buf[1:513], r)
    with pytest.raises(ValueError, match="16-byte"):
        tqc.ef_sync_leaf(g, buf[1:513])
    with pytest.raises(ValueError, match="thresholds"):
        tqc.ef_sync_leaf(g, r, torch.zeros((3, 1), device=cuda))
    with pytest.raises(ValueError, match="thresholds"):
        tqc.ef_sync_leaf(g, r, torch.zeros((2, 1), device=cuda,
                                           dtype=torch.float64))
    with pytest.raises(ValueError, match="non-empty"):
        tqc.ef_sync_leaf(g[:0], r[:0])
    assert tqc.ef_sync_leaf.launches == before


# RWKV6 scan: y and the state against the plain version, relative to the
# largest magnitude of each. f32: sums in another order; bf16: r, k, v are
# the same bf16 values in both, the state is f32 in both, and y is the f32
# result rounded to bf16 (an ulp is 2^-8 of the value)
R6_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def scan_close(got, want, tol):
    for name, a, b in zip(("y", "state"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        assert err <= tol * max(scale, 1.0), (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,T,H,decay", [
    (4, 256, 64, "drawn"),  # the serve path's prefill (RWKV6-7B: 64 x 64)
    (4, 1, 64, "drawn"),    # its decode step
    (2, 200, 8, "drawn"),   # ragged T, not a multiple of the 64-step chunk
    (2, 64, 8, "drawn"),    # one chunk; then around the chunk's edges
    (2, 63, 8, "drawn"),
    (2, 65, 8, "drawn"),
    (2, 129, 4, "drawn"),
    (2, 17, 4, "drawn"),    # one sub-chunk and a step
    (2, 2, 4, "drawn"),
    (2, 256, 8, "adversarial"),  # sum |w| far past 88 a chunk
    (2, 1, 8, "adversarial"),
])
def test_rwkv6_scan_kernel_matches_plain(cuda, dtype, with_state, B, T, H,
                                         decay):
    r, k, v, w, u, s0 = rwkv_inputs(B, T, H, 64, seed=T, state=with_state)
    if decay == "adversarial":
        w = rwkv_adversarial_w(w, seed=T)
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
        "bf16 state_out": dict(state_out=s0.bfloat16()),
        "wrong state_out shape": dict(state_out=s0[:, :1].contiguous()),
        "unaligned r": dict(r=torch.empty(r.numel() + 1, dtype=r.dtype,
                                          device=cuda)[1:].view(r.shape)),
        "unaligned state_out": dict(
            state_out=torch.empty(s0.numel() + 1, device=cuda)[1:]
            .view(s0.shape)),
    }
    for change in bad.values():
        a = {**dict(r=r, k=k, v=v, w=w, u=u, init_state=s0,
                    state_out=None), **change}
        with pytest.raises(ValueError, match="rwkv6_scan"):
            tr6.rwkv6_scan(a["r"], a["k"], a["v"], a["w"], a["u"],
                           init_state=a["init_state"],
                           state_out=a["state_out"])
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
@pytest.mark.parametrize("Bt,T,H,G,N,decay", [
    (4, 256, 64, 1, 64, "drawn"),   # the serve path's prefill (Zamba2-1.2B)
    (4, 1, 64, 1, 64, "drawn"),     # its decode step
    (2, 200, 8, 1, 64, "drawn"),    # ragged T, not a multiple of the chunk
    (2, 64, 8, 2, 16, "drawn"),     # two groups, the tiny config's d_state
    (2, 37, 4, 2, 16, "drawn"),
    (2, 63, 8, 1, 64, "drawn"),     # around the chunk's edges
    (2, 65, 8, 1, 64, "drawn"),
    (2, 129, 4, 2, 16, "drawn"),
    (2, 17, 4, 1, 64, "drawn"),     # one sub-chunk and a step
    (2, 1, 8, 2, 16, "drawn"),      # the decode step at d_state 16
    (2, 256, 8, 1, 64, "adversarial"),  # dt * A = -64 a step on a head
    (2, 1, 8, 1, 64, "adversarial"),
])
def test_mamba2_ssd_kernel_matches_plain(cuda, dtype, with_state, Bt, T, H,
                                         G, N, decay):
    x, dt, A, B, C, D, s0 = mamba2_inputs(Bt, T, H, G, N, seed=T,
                                          state=with_state)
    if decay == "adversarial":
        dt, A = mamba2_adversarial_decay(dt, A)
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
        "bf16 state_out": dict(state_out=s0.bfloat16()),
        "wrong state_out shape": dict(state_out=s0[:, :1].contiguous()),
        "unaligned x": dict(x=torch.empty(x.numel() + 1, device=cuda)[1:]
                            .view(x.shape)),
        "unaligned state_out": dict(
            state_out=torch.empty(s0.numel() + 1, device=cuda)[1:]
            .view(s0.shape)),
    }
    for change in bad.values():
        a = {**args, "state_out": None, **change}
        with pytest.raises(ValueError, match="mamba2_ssd"):
            tm2.mamba2_ssd(a["x"], a["dt"], a["A"], a["B"], a["C"], a["D"],
                           init_state=a["init_state"],
                           state_out=a["state_out"])


# K8 and K9 in place, and bit for bit over launches

def _scan_case(name, cuda, dtype, T, seed):
    """(kernel, plain, args, s0) at the serve heads, batch 2."""
    if name == "rwkv6_scan":
        r, k, v, w, u, s0 = rwkv_inputs(2, T, 64, 64, seed=seed)
        args = tuple(torch.from_numpy(a).to(cuda, dtype) for a in (r, k, v)) \
            + tuple(torch.from_numpy(a).to(cuda) for a in (w, u))
        return tr6.rwkv6_scan, tr6.rwkv6_scan_plain, args, \
            torch.from_numpy(s0).to(cuda)
    x, dt, A, B, C, D, s0 = mamba2_inputs(2, T, 64, 1, 64, seed=seed)
    args = (torch.from_numpy(x).to(cuda, dtype),
            *(torch.from_numpy(a).to(cuda) for a in (dt, A)),
            *(torch.from_numpy(a).to(cuda, dtype) for a in (B, C)),
            torch.from_numpy(D).to(cuda))
    return tm2.mamba2_ssd, tm2.mamba2_ssd_plain, args, \
        torch.from_numpy(s0).to(cuda)


SCAN_TOL = {"rwkv6_scan": R6_TOL, "mamba2_ssd": M2_TOL}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 256])
@pytest.mark.parametrize("name", ["rwkv6_scan", "mamba2_ssd"])
def test_scan_kernel_state_out_in_place(cuda, name, T, dtype):
    """`state_out` the initial state itself (the model's cache slice) and
    a separate buffer: the same y and state as the plain version, written
    into the buffer and returned; one launch a call."""
    kernel, plain, args, s0 = _scan_case(name, cuda, dtype, T, seed=T + 3)
    want = plain(*args, init_state=s0)
    buf = s0.clone()
    kernel.launches = 0
    got = kernel(*args, init_state=buf, state_out=buf)
    assert kernel.launches == 1 and got[1] is buf
    scan_close(got, want, SCAN_TOL[name][dtype])
    out = torch.full_like(s0, float("nan"))
    got = kernel(*args, init_state=s0, state_out=out)
    assert got[1] is out
    scan_close(got, want, SCAN_TOL[name][dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 65, 256])
@pytest.mark.parametrize("name", ["rwkv6_scan", "mamba2_ssd"])
def test_scan_kernel_two_launches_same_bits(cuda, name, T, dtype):
    """Sums in a fixed order, no atomics: two launches, the same bits."""
    kernel, _, args, s0 = _scan_case(name, cuda, dtype, T, seed=T + 4)
    y1, st1 = kernel(*args, init_state=s0)
    y2, st2 = kernel(*args, init_state=s0)
    assert torch.equal(y1, y2) and torch.equal(st1, st2)


# K8 and K9 as the training path's differentiable calls

def _grad_case(name, cuda, dtype, with_state, seed):
    """(ops entry point, kernel, plain version, leaves, initial state or
    None) at batch 2 x 130 steps (three chunks), 8 heads."""
    from repro_torch.kernels import ops
    if name == "rwkv6_scan":
        r, k, v, w, u, s0 = rwkv_inputs(2, 130, 8, 64, seed=seed)
        args = [torch.from_numpy(a).to(cuda, dtype) for a in (r, k, v)] + \
            [torch.from_numpy(a).to(cuda) for a in (w, u)]
        fn, kernel, plain = ops.rwkv6_scan, tr6.rwkv6_scan, \
            tr6.rwkv6_scan_plain
    else:
        x, dt, A, B, C, D, s0 = mamba2_inputs(2, 130, 8, 2, 64, seed=seed)
        args = [torch.from_numpy(x).to(cuda, dtype),
                *(torch.from_numpy(a).to(cuda) for a in (dt, A)),
                *(torch.from_numpy(a).to(cuda, dtype) for a in (B, C)),
                torch.from_numpy(D).to(cuda)]
        fn, kernel, plain = ops.mamba2_scan, tm2.mamba2_ssd, \
            tm2.mamba2_ssd_plain
    s0 = torch.from_numpy(s0).to(cuda) if with_state else None
    return fn, kernel, plain, args, s0


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["rwkv6_scan", "mamba2_ssd"])
def test_scan_function_grads_equal_plain_autograd(cuda, name, dtype,
                                                  with_state):
    """The differentiable call's forward launches the kernel once and its
    backward none; its gradients (y's cotangent, and the final state's
    from a given initial state) equal autograd through the plain version
    on the card bit for bit: the backward is that plain version re-run on
    the saved inputs. Its y is the kernel's."""
    fn, kernel, plain, args, s0 = _grad_case(name, cuda, dtype, with_state,
                                             seed=21)

    def leaves():
        return [a.clone().requires_grad_() for a in args] + \
            ([] if s0 is None else [s0.clone().requires_grad_()])

    n = len(args)
    ins, ref_ins = leaves(), leaves()
    kernel.launches = 0
    y, st = fn(*ins[:n], init_state=ins[n] if with_state else None)
    assert kernel.launches == 1 and y.grad_fn is not None
    gen = torch.Generator(device=cuda).manual_seed(22)
    cots = [torch.randn(y.shape, generator=gen, device=cuda).to(dtype)]
    outs = [y]
    if with_state:
        cots.append(torch.randn(st.shape, generator=gen, device=cuda))
        outs.append(st)
    got = torch.autograd.grad(outs, ins, cots)
    assert kernel.launches == 1
    ref_outs = plain(*ref_ins[:n], init_state=ref_ins[n] if with_state
                     else None)
    want = torch.autograd.grad(ref_outs[:len(outs)], ref_ins, cots)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    kernel_y, _ = kernel(*args, init_state=s0)
    assert torch.equal(y.detach(), kernel_y)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rwkv6_scan", "mamba2_ssd"])
def test_scan_function_refuses_state_out_and_serves_in_place(cuda, name):
    """Under grad, with an input that requires one, `state_out` raises;
    under no_grad the same call writes the state in place, launches the
    kernel once and builds no graph."""
    fn, kernel, _, args, s0 = _grad_case(name, cuda, torch.bfloat16, True,
                                         seed=23)
    ins = [a.clone().requires_grad_() for a in args]
    buf = s0.clone()
    with pytest.raises(ValueError, match="state_out"):
        fn(*ins, init_state=buf, state_out=buf)
    kernel.launches = 0
    with torch.no_grad():
        y, st = fn(*ins, init_state=buf, state_out=buf)
    assert kernel.launches == 1 and st is buf and y.grad_fn is None
    want = kernel(*args, init_state=s0)
    assert torch.equal(y, want[0]) and torch.equal(buf, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [False, True], ids=["scalar", "fleet"])
def test_plane_accounting_on_the_card_equals_the_cpu(cuda, fleet):
    """The power plane's step time and power on the card, bit for bit the
    CPU's: the spec's nominals divide as device scalars (a Python-number
    divisor runs as a multiply by its reciprocal on the card), so the
    routed trace's default tick and every rate built on it agree."""
    from repro_torch.core import power_plane as pp
    from repro_torch.core.hwspec import FleetSpec
    prof = pp.StepProfile(2e12, 8e9, 4e9, 3e9)
    spec = FleetSpec.sample(16, seed=23)
    out = {}
    for dev in ("cpu", cuda):
        plane = (pp.PowerPlaneState.from_fleet(spec, dev) if fleet
                 else pp.PowerPlaneState.fleet(16, device=dev))
        var = pp.fleet_variation(spec, dev) if fleet else None
        t = pp.step_time_s(prof, plane, variation=var)
        p = pp.chip_power_w(plane, 0.3, 0.5, 0.2, spec.base, variation=var)
        out[str(dev)] = (t.cpu(), p.cpu())
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(a, b)
