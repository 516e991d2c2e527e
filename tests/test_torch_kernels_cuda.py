"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Every test here carries the `cuda` marker and skips without a card;
the file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -m cuda -o filterwarnings=default \
        tests/test_torch_kernels_cuda.py

(pytest.ini's warning filter names a class of the JAX package; the
override keeps pytest from importing it.)

The input helpers are shared with tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import fleet_telemetry as tft
from repro_torch.kernels import flash_attention as tfa

SOR_KW = dict(min_slope=0.5, min_spread_v=2e-3, conf_samples=8.0)
# SOR fit: the uncentred EWLS solve cancels digits (denom = sw*sxx - sx^2),
# so analog outputs agree to ~1e-5 relative, not bitwise; masks exactly
SOR_TOL = dict(rtol=1e-4, atol=1e-6)
# attention on the card: f32 kernel vs f32 plain (FMA order); bf16 output
# vs the f32 plain version rounded to bf16 (an ulp or two of O(1) values)
ATT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def qkv(B, T, S, Hq, Hkv, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, Hq, Dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32))


def sor_inputs(window: int, n: int, seed: int):
    """A window with a real log-linear frontier (slope -30 dex/V) on two
    lanes in three and a flat observable on the rest; recency weights with
    some invalid (zero-weight) samples."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.6, 0.95, (window, n)).astype(np.float32)
    steep = (np.arange(n) % 3 != 2).astype(np.float32)
    y = (-3.0 - 30.0 * steep * (x - 0.7)
         + 0.05 * rng.standard_normal((window, n))).astype(np.float32)
    rank = np.arange(window)[::-1, None].astype(np.float32)
    w = (0.92 ** rank * (rng.uniform(size=(window, n)) > 0.1)).astype(
        np.float32)
    bound = np.full((n,), np.log10(5e-3), np.float32)
    guard = np.full((n,), 0.01, np.float32)
    return x, y, w, bound, guard


def check_sor(got, want):
    """Usable masks exactly, the six analog outputs at SOR_TOL."""
    names = ("intercept", "slope", "v_frontier", "confidence", "n_eff",
             "floor")
    np.testing.assert_array_equal(np.asarray(got[3]) > 0,
                                  np.asarray(want[3]) > 0)
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=name, **SOR_TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Hq,Hkv,Dh,window", [
    (256, 48, 16, 128, 0),     # the serve path's prefill
    (200, 12, 4, 32, 0),       # ragged T, the padded-GQA plan
    (77, 8, 8, 64, 0),         # MHA, head_dim 64
    (150, 4, 2, 32, 40),       # sliding window
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
@pytest.mark.parametrize("S,Hq,Hkv,Dh,lengths", [
    (296, 48, 16, 128, [1, 98, 257, 296]),   # the serve path's decode
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
def test_kernels_count_their_launches(cuda):
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in qkv(1, 8, 8, 2, 1, 32, seed=1))
    ops.flash_attention(q, k, v, causal=True, group=2)
    ops.decode_attention(q[:, :1].contiguous(), k, v,
                         torch.tensor([8], dtype=torch.int32, device=cuda),
                         group=2)
    ops.sor_fit(*(torch.from_numpy(a).to(cuda)
                  for a in sor_inputs(4, 3, seed=0)), **SOR_KW)
    assert ops.launch_counts() == {name: 1 for name in ops.KERNELS}
