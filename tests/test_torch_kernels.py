"""The port's kernels against the reference package's, on the same numpy
inputs: each plain PyTorch version against `repro.kernels.ref` (causal,
GQA, ragged T, lengths >= 1, usable and unusable SOR lanes) and, at one
small shape each, against the Pallas kernel run in interpret mode as
tests/test_kernels.py runs it. The CUDA kernels against their plain
versions are in tests/test_torch_kernels_cuda.py."""

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
from test_torch_kernels_cuda import SOR_KW, check_sor, qkv, sor_inputs

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
