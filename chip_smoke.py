#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold every CUDA kernel
against its plain PyTorch version.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line; any failure raises and the
script exits nonzero:

1. build      - compile every kernel from `src/repro_torch/kernels/csrc/`
                for sm_90a (seconds taken, the ptxas report in the build
                dir) and count the HGMMA (wgmma) instructions of the bf16
                tensor-core kernels (K2, K4, K5 at head_dim 64 and 128) in
                the library's SASS (fails on one with none);
2. kernels    - each kernel's wrapper at its paths' shapes (the Qwen serve
                path for K1, the host path for K7, the Qwen and the Zamba2
                serve paths for K2 and K3, the training path for K2 and
                K4-K6 (K2 also in f32 at the Qwen prefill), the
                RWKV6 serve path for K9, the Zamba2 serve path for K8, the
                ef training path's parameter leaves for K10) against its
                plain version (stated tolerances; K10 bit for bit), timed
                beside its bound, the plain version and one PyTorch call as
                a yardstick where one exists; K7 followed by the plain
                solve also against K1; K2 also at Zamba2's heads with a
                4608-token prompt past its 4096 window;
3. tiny       - tiny Qwen2.5 in f32 from one seed on cuda and on cpu through
                `ServeEngine.generate` with the slice's controller: equal
                tokens, plane and SOR estimate allclose;
4. tiny_host  - the same with the host controller (READ_VOUT polls, the
                polled three-rail learner) on an 8-chip fleet: equal tokens,
                achieved rails bit for bit, equal `stats()`; then the
                frontier world of the reference's multi-rail host test on an
                8-chip plane, cuda against cpu: the same lanes learn, floors
                within SOR_RTOL and inside the reference test's bands;
5. main       - full-width, full-depth Qwen2.5-14B in bf16 (random weights
                from a seed), batch 4, prompt 256, 32 new tokens, 64-chip
                fleet and the learned rail-control round; launch counts of
                every kernel must be exactly what the path implies; then the
                breakdown of a decode step, read through `generate` (with
                and without the control round, device busy share and top
                kernels from torch.profiler);
6. main_host  - the same weights served through the host control path: a
                64-chip `HostRailController` deciding from its own polls,
                learning with the split fit (K7) every 4 rounds, actuating
                the simulated PMBus fleet at 400 kHz; exact launch counts,
                the host round's time (bus simulation, SOR observe), its
                plane reads, the bus's `stats()` and the decode breakdown;
7. tiny_rwkv  - tiny RWKV6 (the ssm family) as phase 3;
8. main_rwkv  - full-width, full-depth RWKV6-7B (32 layers, d_model 4096,
                64 heads x 64, d_ff 14336, vocab 65536) as phase 5, with its
                own exact launch counts (K9 32 per prefill and per decoded
                token) and decode-step breakdown;
9. tiny_zamba - tiny Zamba2 (the hybrid family) as phase 3, plain and with
                an 8-token sliding window that the shared block's KV cache
                wraps;
10. main_zamba - full-width, full-depth Zamba2-1.2B (38 Mamba2 layers,
                d_model 2048, 64 SSD heads x 64, state 64; the shared
                attention + MLP block after every 6th layer, 32/32 heads
                x 64, window 4096) as phase 5, with its own exact launch
                counts (K8 38 per prefill and per decoded token, K2 6 per
                prefill, K3 6 per decoded token after the first) and
                decode-step breakdown;
11. tiny_train - tiny MiniCPM in f32 from one seed on cuda and on cpu, three
                fleet SOR train steps through `Trainer.run`: losses, params,
                plane and SOR estimate allclose;
12. tiny_train_host - tiny MiniCPM in f32, four scalar steps through
                `Trainer.run` with a `HostRailController(PhaseAware())`
                between steps, cuda against cpu: losses allclose, host
                actuations and their bus seconds equal;
13. main_train - full-width, full-depth MiniCPM-2B in bf16 (random weights
                from a seed), batch 4 x seq 512, per-layer remat, AdamW,
                the launcher's WSD schedule, a 64-chip fleet with in-graph
                SOR learning, through `Trainer.run`: one warm-up step, then
                8 steps whose launch counts must be exact; step time, data
                time, tokens/s, MFU, peak memory, losses, the learned-region
                summary, and a torch.profiler window of 2 steps (the
                device ms per step of K2, K4 and K5 beside the top
                kernels);
14. tiny_train_ef - tiny MiniCPM in f32 from one seed on cuda and on cpu,
                four scalar steps of each error-feedback level (`ef_int8`,
                `ef_int8_topk`) with BERBounded through `Trainer.run`:
                losses, grad_error, comp_level, the compressed gradient
                and residual (g_hat + r', flipped codes) and params; K10
                exactly twice per leaf per step;
15. main_train_ef - full-width, full-depth MiniCPM-2B in bf16 as phase 13,
                the scalar step with the ef gradient sync and BERBounded:
                one warm-up step, then 8 steps each of `ef_int8`,
                `ef_int8_topk` and `auto` on the same state, launch counts
                exact (K10 24 per ef step), step times, tokens/s, MFU, peak
                memory, losses, grad_error, comp_level and v_io; a
                torch.profiler window of 2 `ef_int8` steps with K10's
                device ms beside its bound, and K2's, K4's and K5's.

Each model's weights are freed before the next model loads its own.
Then the `{"kernels": [...]}` line (launches summed over the main paths'
checked runs, and by path), the card's name and power limit, and the
final `{"ok": true, ...}` line. Exits nonzero without printing a result when no
CUDA device is present.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12           # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core rate
              "float32": 67e12}       # non-tensor-core f32 rate

# the serve paths driven on the card: full width and depth
MAIN = dict(arch="qwen2p5_14b", batch=4, prompt=256, new=32, chips=64)
RWKV = dict(arch="rwkv6_7b", batch=4, prompt=256, new=32, chips=64)
ZAMBA = dict(arch="zamba2_1p2b", batch=4, prompt=256, new=32, chips=64)
# the training path driven on the card: full width and depth
TRAIN = dict(arch="minicpm_2b", batch=4, seq=512, chips=64, steps=8,
             profiled_steps=2)
# the bf16 attention kernels of the training path (K2, K4, K5), by name
TRAIN_ATTENTION = ("flash_fwd_sm90", "flash_bwd_dq_sm90",
                   "flash_bwd_dkv_sm90")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush=None) -> float:
    """Mean device time of one call: CUDA events around each call, the
    stream held by a device-side sleep while the host enqueues them all, so
    the events time the device work and not Python's launch overhead.
    `flush` (a >50 MB buffer) is overwritten before each call so the L2
    starts cold, as it does on the serve path between layers."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(int(2e6) * iters)      # ~1 ms of device time per call
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound_ms(n_bytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def attn_paths() -> dict:
    """The attention shapes of each serve path that runs K2 and K3, from
    its configuration: (batch, padded q heads, padded kv heads, head_dim,
    sliding window, prompt, KV-cache length)."""
    from repro_torch.configs import get_config
    out = {}
    for path, spec in (("serve-qwen", MAIN), ("serve-zamba", ZAMBA)):
        cfg = get_config(spec["arch"])
        plan = cfg.head_plan()
        max_len = spec["prompt"] + spec["new"] + 8     # as `slice_engine`
        out[path] = (spec["batch"], plan.n_q_pad, plan.n_kv_pad,
                     cfg.head_dim_, cfg.sliding_window, spec["prompt"],
                     min(max_len, cfg.sliding_window or max_len))
    return out


def flash_paths() -> dict:
    """K2's shapes: each serve path's prefill (`attn_paths`) and the
    training path's forward, (batch, q heads, kv heads, head_dim, window,
    T)."""
    from repro_torch.configs import get_config
    out = {path: spec[:6] for path, spec in attn_paths().items()}
    cfg = get_config(TRAIN["arch"])
    plan = cfg.head_plan()
    out["train-minicpm"] = (TRAIN["batch"], plan.n_q_pad, plan.n_kv_pad,
                            cfg.head_dim_, cfg.sliding_window, TRAIN["seq"])
    return out


def check_flash(dev, flush) -> dict:
    """K2 in bf16 at each serve path's prefill and the training path's
    forward (its T, and a ragged T of 200) against its plain version, timed
    at the path's T beside its bound, the plain version and one SDPA call;
    then the f32 path at the Qwen2.5 prefill, checked and timed (`f32_ms`).
    The row's top-level times are the Qwen2.5 path's; `paths` holds each
    path's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(11)
    err, checked, paths = 0.0, [], {}
    for path, (B, Hq, Hkv, Dh, window, Tp) in flash_paths().items():
        group = Hq // Hkv
        kw = dict(causal=True, group=group, sliding_window=window)
        for T in (Tp, 200):     # the path's prompt, and a ragged T
            q, k, v = (torch.randn((B, T, h, Dh), generator=gen, device=dev,
                                   dtype=torch.bfloat16)
                       for h in (Hq, Hkv, Hkv))
            o, lse = fa.flash_attention(q, k, v, **kw)
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            d = (o.float() - o_ref.float()).abs().max().item()
            d_lse = (lse - lse_ref).abs().max().item()
            # bf16 output against the f32 plain version rounded to bf16
            if not (math.isfinite(d) and d <= 2e-2 and d_lse <= 1e-3):
                raise AssertionError(f"flash_attention {path} T={T}: "
                                     f"max|o-o_ref|={d}, "
                                     f"max|lse-lse_ref|={d_lse}")
            err = max(err, d)
            checked.append(dict(path=path, B=B, T=T, Hq=Hq, Hkv=Hkv, Dh=Dh,
                                window=window, dtype="bf16"))
        T = Tp
        q, k, v = (torch.randn((B, T, h, Dh), generator=gen, device=dev,
                               dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv))
        ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20, flush)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                           5, flush)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
        rows = torch.arange(T, device=dev)
        keep = rows[None, :] <= rows[:, None]          # causal: keys <= row
        if window:
            keep &= rows[None, :] > rows[:, None] - window
        windowed = 0 < window < T
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep if windowed else None,
            is_causal=not windowed), 20, flush)
        n_bytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * B * Hq * T
        pairs = B * Hq * int(keep.sum().item())
        b_ms, b_by = bound_ms(n_bytes, 4 * Dh * pairs, "bfloat16")
        paths[path] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms,
                           shape=dict(B=B, T=T, Hq=Hq, Hkv=Hkv, Dh=Dh,
                                      window=window, dtype="bf16"))
    # the sliding window past its length at Zamba2's full head shapes:
    # causal, window 4096, a prompt of 4096 + 512 tokens, one batch row
    B, Hq, Hkv, Dh, window, _ = flash_paths()["serve-zamba"]
    B, T = 1, window + 512
    kw = dict(causal=True, group=Hq // Hkv, sliding_window=window)
    q, k, v = (torch.randn((B, T, h, Dh), generator=gen, device=dev,
                           dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv))
    o, lse = fa.flash_attention(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    d = (o.float() - o_ref.float()).abs().max().item()
    d_lse = (lse - lse_ref).abs().max().item()
    if not (math.isfinite(d) and d <= 2e-2 and d_lse <= 1e-3):
        raise AssertionError(f"flash_attention window {window} T={T}: "
                             f"max|o-o_ref|={d}, max|lse-lse_ref|={d_lse}")
    err = max(err, d)
    checked.append(dict(path="serve-zamba-past-window", B=B, T=T, Hq=Hq,
                        Hkv=Hkv, Dh=Dh, window=window, dtype="bf16",
                        max_abs_err=d, max_lse_err=d_lse))
    # the f32 path (the FMA kernel) at the Qwen2.5 prefill: f32 FMA sums
    # in another order than the plain version's
    B, Hq, Hkv, Dh, window, T = flash_paths()["serve-qwen"]
    kw = dict(causal=True, group=Hq // Hkv, sliding_window=window)
    q, k, v = (torch.randn((B, T, h, Dh), generator=gen, device=dev)
               for h in (Hq, Hkv, Hkv))
    o, lse = fa.flash_attention(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    d = (o - o_ref).abs().max().item()
    d_lse = (lse - lse_ref).abs().max().item()
    if not (math.isfinite(d) and d <= 1e-4 and d_lse <= 1e-3):
        raise AssertionError(f"flash_attention f32 T={T}: max|o-o_ref|={d}, "
                             f"max|lse-lse_ref|={d_lse}")
    checked.append(dict(path="serve-qwen", B=B, T=T, Hq=Hq, Hkv=Hkv, Dh=Dh,
                        window=window, dtype="f32", max_abs_err=d,
                        max_lse_err=d_lse))
    f32_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20, flush)
    paths["serve-qwen"]["f32_ms"] = f32_ms
    del q, k, v, o, lse, o_ref, lse_ref
    top = dict(paths["serve-qwen"])
    return dict(name="flash_attention_fwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                f32_source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:92",
                max_abs_err=err, **top, checked=checked, paths=paths)


def check_decode(dev, flush) -> dict:
    """K3 at each serve path's decode step (its KV-cache length, lengths 1
    to full) against its plain version, timed beside its bound, the plain
    version and one masked SDPA call. The row's top-level times are the
    Qwen2.5 path's; `paths` holds each path's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(12)
    err, checked, paths = 0.0, [], {}
    for path, (B, Hq, Hkv, Dh, _, Tp, S) in attn_paths().items():
        group = Hq // Hkv
        q = torch.randn((B, 1, Hq, Dh), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, Hkv, Dh), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        lengths = torch.tensor([1, S // 3, Tp + 1, S], dtype=torch.int32,
                               device=dev)
        o = da.decode_attention(q, k, v, lengths, group=group)
        o_ref = da.decode_attention_plain(q, k, v, lengths, group=group)
        torch.cuda.synchronize()
        d = (o.float() - o_ref.float()).abs().max().item()
        if not (math.isfinite(d) and d <= 2e-2):
            raise AssertionError(f"decode_attention {path}: "
                                 f"max|o-o_ref|={d}")
        err = max(err, d)
        shape = dict(B=B, S=S, Hq=Hq, Hkv=Hkv, Dh=Dh, dtype="bf16",
                     lengths=lengths.tolist())
        checked.append(dict(path=path, **shape))
        ms = time_ms(lambda: da.decode_attention(q, k, v, lengths,
                                                 group=group), 100, flush)
        plain_ms = time_ms(lambda: da.decode_attention_plain(
            q, k, v, lengths, group=group), 20, flush)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), 100, flush)
        n_valid = int(lengths.sum().item())
        n_bytes = 2 * (2 * q.numel() + 2 * n_valid * Hkv * Dh) + 4 * B
        b_ms, b_by = bound_ms(n_bytes, 4 * Dh * Hq * n_valid, "bfloat16")
        paths[path] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms, shape=shape)
    top = dict(paths["serve-qwen"])
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:60",
                max_abs_err=err, **top, checked=checked, paths=paths)


def sor_inputs(window: int, n: int, seed: int, dev):
    """Synthetic EWLS window with a real log-linear frontier on 2/3 of the
    lanes (slope -30 dex/V) and a flat observable on the rest, recency
    weights and some invalid (zero-weight) samples."""
    import numpy as np
    import torch
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
    return tuple(torch.from_numpy(a).to(dev) for a in (x, y, w, bound, guard))


SOR_KW = dict(min_slope=0.5, min_spread_v=2e-3, conf_samples=8.0)


def check_sor_fit(dev, flush) -> dict:
    import torch

    from repro_torch.kernels import fleet_telemetry as ft
    err = 0.0
    window = 32
    for n in (3 * MAIN["chips"], 3 * 67):    # the path's lanes, and ragged
        args = sor_inputs(window, n, seed=n, dev=dev)
        got = ft.sor_fit(*args, **SOR_KW)
        want = ft.sor_fit_plain(*args, **SOR_KW)
        torch.cuda.synchronize()
        usable_k, usable_p = got[3] > 0, want[3] > 0
        if not torch.equal(usable_k, usable_p) or not usable_p.any() or \
                usable_p.all():
            raise AssertionError(f"sor_fit n={n}: usable masks differ or "
                                 f"are degenerate")
        for name, a, b in zip(("intercept", "slope", "v_frontier",
                               "confidence", "n_eff", "floor"), got, want):
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-6):
                raise AssertionError(f"sor_fit n={n} {name}: max diff "
                                     f"{(a - b).abs().max().item()}")
            err = max(err, (a - b).abs().max().item())
    n = 3 * MAIN["chips"]
    args = sor_inputs(window, n, seed=n, dev=dev)
    ms = time_ms(lambda: ft.sor_fit(*args, **SOR_KW), 100, flush)
    plain_ms = time_ms(lambda: ft.sor_fit_plain(*args, **SOR_KW), 50, flush)
    n_bytes = 4 * (3 * window * n + 2 * n + 6 * n)
    b_ms, b_by = bound_ms(n_bytes, 9 * window * n + 30 * n, "float32")
    return dict(name="sor_fit", route="cuda",
                source="src/repro_torch/kernels/csrc/sor_fit.cu",
                replaces="src/repro/kernels/fleet_telemetry.py:113",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=dict(window=window, n=n, ragged_n=3 * 67))


# K7's five sums in another order than the plain version's: within 1e-6
# of the largest |sum| of each output (f32 sums of O(1) terms)
SUM_TOL = 1e-6
SUMS = ("sw", "sx", "sy", "sxx", "sxy")
SOR_OUTS = ("intercept", "slope", "v_frontier", "confidence", "n_eff",
            "floor")


def check_sor_accumulate(dev, flush) -> dict:
    """K7 at the host path's window (32 rows, 3 rails x 64 chips), a ragged
    (29, 200) and a 1024-chip fleet (32, 3 x 1024), two whole rows at zero
    weight in each, against its plain version (SUM_TOL); then K7 followed
    by the plain solve (`ref.sor_solve_reference`) against K1 on the same
    inputs. Expected bit-equal: K7 and K1 sum with one device function, and
    the solve runs as separately rounded elementwise kernels in K1's op
    order. Where they differ, the largest gap of each output is reported
    and held to K1's own tolerance against its plain version."""
    import torch

    from repro_torch.kernels import fleet_telemetry as ft
    from repro_torch.kernels import ref
    err, gaps, checked = 0.0, {}, []
    for window, n in ((32, 3 * MAIN["chips"]), (29, 200), (32, 3 * 1024)):
        x, y, w, bound, guard = sor_inputs(window, n, seed=window + n,
                                           dev=dev)
        w[[0, window // 2]] = 0.0
        got = ft.sor_accumulate(x, y, w)
        want = ft.sor_accumulate_plain(x, y, w)
        fused = ft.sor_fit(x, y, w, bound, guard, **SOR_KW)
        split = ref.sor_solve_reference(got, bound, guard, **SOR_KW)
        torch.cuda.synchronize()
        for name, a, b in zip(SUMS, got, want):
            d = (a - b).abs().max().item()
            scale = max(b.abs().max().item(), 1.0)
            if not (math.isfinite(d) and d <= SUM_TOL * scale):
                raise AssertionError(f"sor_accumulate ({window}, {n}) "
                                     f"{name}: max diff {d}, max |ref| "
                                     f"{scale}")
            err = max(err, d)
        if not torch.equal(fused[3] > 0, split[3] > 0):
            raise AssertionError(f"split fit ({window}, {n}): usable lanes "
                                 f"differ from K1's")
        gap = {name: (a - b).abs().max().item()
               for name, a, b in zip(SOR_OUTS, split, fused)}
        for name, a, b in zip(SOR_OUTS, split, fused):
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-6):
                raise AssertionError(f"split fit ({window}, {n}) {name}: "
                                     f"max diff {gap[name]} from K1")
        gaps[f"{window}x{n}"] = gap
        checked.append([window, n])
    window, n = 32, 3 * MAIN["chips"]
    x, y, w, _, _ = sor_inputs(window, n, seed=n, dev=dev)
    ms = time_ms(lambda: ft.sor_accumulate(x, y, w), 100, flush)
    plain_ms = time_ms(lambda: ft.sor_accumulate_plain(x, y, w), 100, flush)
    # reads x, y, w once, writes five sums; 4 multiplies and 5 adds per
    # element
    b_ms, b_by = bound_ms(4 * (3 * window * n + 5 * n), 9 * window * n,
                          "float32")
    split_equal = all(g == 0.0 for gap in gaps.values()
                      for g in gap.values())
    return dict(name="sor_accumulate", route="cuda",
                source="src/repro_torch/kernels/csrc/sor_fit.cu",
                replaces="src/repro/kernels/fleet_telemetry.py:157",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, sum_tolerance=SUM_TOL,
                split_fit_equals_k1=split_equal,
                split_fit_gap_to_k1=gaps,
                split_fit_gap_reason=None if split_equal else (
                    "torch.exp on the card and K1's expf round differently; "
                    "held to K1's tolerance (rtol 1e-4, atol 1e-6)"),
                checked=checked, shape=dict(window=window, n=n))


def check_flash_bwd(dev, flush) -> list[dict]:
    """K4 and K5 at the training path's shapes (MiniCPM-2B: 48/48 heads,
    head_dim 64, bf16, causal), with K2's o and lse, each against its
    plain version; plus a ragged T, a window and a ragged T at batch 2 (a
    tile past T must not read the next batch row). The yardstick is the
    backward of one SDPA call (dq, dk, dv together)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, Dh = TRAIN["batch"], 48, 48, 64
    gen = torch.Generator(device=dev).manual_seed(13)

    def inputs(nb, T, hq, hkv):
        return tuple(torch.randn(shape, generator=gen, device=dev,
                                 dtype=torch.bfloat16)
                     for shape in ((nb, T, hq, Dh), (nb, T, hkv, Dh),
                                   (nb, T, hkv, Dh), (nb, T, hq, Dh)))

    err = {"dq": 0.0, "dkv": 0.0}
    for nb, T, hq, hkv, window in ((B, TRAIN["seq"], Hq, Hkv, 0),
                                   (B, 500, 12, 4, 0), (B, 300, 8, 8, 96),
                                   (2, 200, Hq, Hkv, 0)):
        q, k, v, do = inputs(nb, T, hq, hkv)
        kw = dict(causal=True, group=hq // hkv, sliding_window=window)
        o, lse = fa.flash_attention(q, k, v, **kw)
        o_ref, _ = fa.flash_attention_plain(q, k, v, **kw)
        delta = fa.bwd_delta(o, do)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        dq_ref = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                 **kw)
        dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse,
                                                          delta, **kw)
        torch.cuda.synchronize()
        d_o = (o.float() - o_ref.float()).abs().max().item()
        if not (math.isfinite(d_o) and d_o <= 2e-2):
            raise AssertionError(f"flash_attention B={nb} T={T} Dh={Dh}: "
                                 f"max|o-o_ref|={d_o}")
        # bf16 outputs against the f32 plain version rounded to bf16: an
        # ulp is 2^-8 of a value, so 1e-2 of the largest magnitude
        for name, key, a, b in (("dq", "dq", dq, dq_ref),
                                ("dk", "dkv", dk, dk_ref),
                                ("dv", "dkv", dv, dv_ref)):
            d = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            if not (math.isfinite(d) and d <= 1e-2 * max(scale, 1.0)):
                raise AssertionError(f"flash backward {name} B={nb} T={T} "
                                     f"window={window}: max diff {d}, "
                                     f"max |ref| {scale}")
            err[key] = max(err[key], d)
    T = TRAIN["seq"]
    q, k, v, do = inputs(B, T, Hq, Hkv)
    kw = dict(causal=True, group=Hq // Hkv)
    o, lse = fa.flash_attention(q, k, v, **kw)
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta)
    dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(*args, **kw), 20,
                    flush)
    dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(*args, **kw), 20,
                     flush)
    dq_plain_ms = time_ms(lambda: fa.flash_attention_bwd_dq_plain(
        *args, **kw), 5, flush)
    dkv_plain_ms = time_ms(lambda: fa.flash_attention_bwd_dkv_plain(
        *args, **kw), 5, flush)
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_()
                  for a in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), 20, flush)
    pairs = B * Hq * T * (T + 1) // 2            # causal: keys <= row
    qb, kb = 2 * q.numel(), 2 * k.numel()        # bf16 q-shaped, k-shaped
    stats = 2 * 4 * B * Hq * T                   # lse and delta, f32
    # K4 reads q, k, v, do, lse, delta, writes dq; s, dp, dq products
    dq_bound = bound_ms(3 * qb + 2 * kb + stats, 6 * Dh * pairs, "bfloat16")
    # K5 reads q, k, v, do, lse, delta, writes dk, dv; s, dp, dv, dk
    dkv_bound = bound_ms(2 * qb + 4 * kb + stats, 8 * Dh * pairs,
                         "bfloat16")
    shape = dict(B=B, T=T, Hq=Hq, Hkv=Hkv, Dh=Dh, dtype="bf16",
                 also_B_T_Hq_Hkv_window=[[B, 500, 12, 4, 0],
                                         [B, 300, 8, 8, 96],
                                         [2, 200, Hq, Hkv, 0]])
    src = "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu"
    return [dict(name="flash_attention_bwd_dq", route="cuda", source=src,
                 replaces="src/repro/kernels/flash_attention.py:234",
                 max_abs_err=err["dq"], ms=dq_ms, plain_ms=dq_plain_ms,
                 bound_ms=dq_bound[0], bound_by=dq_bound[1],
                 library_ms=lib_ms, shape=shape),
            dict(name="flash_attention_bwd_dkv", route="cuda", source=src,
                 replaces="src/repro/kernels/flash_attention.py:262",
                 max_abs_err=err["dkv"], ms=dkv_ms, plain_ms=dkv_plain_ms,
                 bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
                 library_ms=lib_ms, shape=shape)]


def check_fleet_reduce(dev, flush) -> dict:
    """K6 at the fleet train step's [64, 5] and at 1000 chips, a NaN lane
    in one field of each; max and min exact, the sum to f32 order."""
    import numpy as np
    import torch

    from repro_torch.kernels import fleet_telemetry as ft
    err = 0.0
    for n in (TRAIN["chips"], 1000):
        x = torch.from_numpy(np.random.default_rng(n).standard_normal(
            (n, 5)).astype(np.float32)).to(dev)
        x[n // 2, 3] = float("nan")
        got, want = ft.fleet_reduce(x), ft.fleet_reduce_plain(x)
        torch.cuda.synchronize()
        for name, a, b, tol in zip(("max", "min", "sum"), got, want,
                                   (0.0, 0.0, 1e-5)):
            if not torch.equal(torch.isnan(a), torch.isnan(b)) or \
                    not bool(torch.isnan(a[3])):
                raise AssertionError(f"fleet_reduce n={n} {name}: NaN lanes "
                                     f"differ")
            ok = ~torch.isnan(b)
            d = (a[ok] - b[ok]).abs().max().item()
            if d > tol * max(1.0, b[ok].abs().max().item()):
                raise AssertionError(f"fleet_reduce n={n} {name}: max diff "
                                     f"{d}")
            err = max(err, d)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (TRAIN["chips"], 5)).astype(np.float32)).to(dev)
    ms = time_ms(lambda: ft.fleet_reduce(x), 100, flush)
    plain_ms = time_ms(lambda: ft.fleet_reduce_plain(x), 100, flush)
    b_ms, b_by = bound_ms(4 * (x.numel() + 3 * 5), 3 * x.numel(), "float32")
    return dict(name="fleet_reduce", route="cuda",
                source="src/repro_torch/kernels/csrc/fleet_reduce.cu",
                replaces="src/repro/kernels/fleet_telemetry.py:192",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=dict(n_chips=TRAIN["chips"], n_fields=5,
                           nan_lane_checked_at=[TRAIN["chips"], 1000]))


def rwkv6_args(B, T, H, dtype, state, gen, dev):
    """r, k, v ~ N(0, 1) in `dtype`; w = -exp(N(-1, 1)) f32 (decays spread
    over (0, 1)); u ~ N(0, 0.5); an N(0, 1) f32 initial state or None."""
    import torch
    Dh = 64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = (randn(B, T, H, Dh).to(dtype) for _ in range(3))
    w = -torch.exp(randn(B, T, H, Dh) - 1.0)
    u = 0.5 * randn(H, Dh)
    s0 = randn(B, H, Dh, Dh) if state else None
    return (r, k, v, w, u), s0


def mamba2_args(B, T, H, G, N, dtype, state, gen, dev):
    """x, B, C ~ N(0, 1) in `dtype`; dt = softplus(N(0, 1)) f32 (step sizes
    in (0, ~4)); A = -exp(N(0, 1)) and D ~ N(0, 1) f32; an N(0, 1) f32
    initial state or None."""
    import torch
    import torch.nn.functional as F
    P = 64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(B, T, H, P).to(dtype)
    dt = F.softplus(randn(B, T, H))
    A = -torch.exp(randn(H))
    Bm, Cm = (randn(B, T, G, N).to(dtype) for _ in range(2))
    D = randn(H)
    s0 = randn(B, H, N, P) if state else None
    return (x, dt, A, Bm, Cm, D), s0


# K8 and K9 against their plain versions, relative to the largest
# magnitude: y in f32 carries sums in another order; y in bf16 is the f32
# result rounded (an ulp is 2^-8 of the value); the state is f32 from the
# same inputs in both, so it carries only the order of the sums
SCAN_TOL = dict(y={"float32": 1e-5, "bfloat16": 1e-2},
                state={"float32": 1e-5, "bfloat16": 1e-5})


def scan_bound(args, s0, y, state, flops) -> tuple[float, str]:
    """Bytes: each input read once (the initial state only where given),
    y and the final state written once; `flops` f32 operations."""
    n_bytes = sum(a.numel() * a.element_size() for a in args) + \
        y.numel() * y.element_size() + state.numel() * 4 + \
        (0 if s0 is None else s0.numel() * 4)
    return bound_ms(n_bytes, flops, "float32")


def check_scan(name, kernel, plain, cases, flops, flush) -> dict:
    """`kernel` against `plain` on y and on the final state at each of
    `cases` ({label: (args, s0)}; the first is the path's prefill, the
    second its decode step) at SCAN_TOL; then both timed at the prefill
    and the decode case, beside the bound (`flops(args)` f32 operations)."""
    import torch
    err = {"y": 0.0, "state": 0.0}
    for label, (args, s0) in cases.items():
        got = kernel(*args, init_state=s0)
        want = plain(*args, init_state=s0)
        torch.cuda.synchronize()
        dt = str(args[0].dtype).removeprefix("torch.")
        for part, a, b in zip(("y", "state"), got, want):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{name} {label} {part}: {a.dtype} "
                                     f"{tuple(a.shape)} != {b.dtype} "
                                     f"{tuple(b.shape)}")
            d = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            if not (math.isfinite(d) and
                    d <= SCAN_TOL[part][dt] * max(scale, 1.0)):
                raise AssertionError(f"{name} {label} {part}: max diff {d}, "
                                     f"max |ref| {scale}")
            err[part] = max(err[part], d)
    out = {}
    for prefix, (args, s0) in zip(("", "decode_"), cases.values()):
        y, st = kernel(*args, init_state=s0)
        b_ms, b_by = scan_bound(args, s0, y, st, flops(args))
        decode = prefix == "decode_"
        out.update({
            f"{prefix}ms": time_ms(lambda: kernel(*args, init_state=s0),
                                   100 if decode else 20, flush),
            f"{prefix}plain_ms": time_ms(lambda: plain(*args, init_state=s0),
                                         20 if decode else 3, flush),
            f"{prefix}bound_ms": b_ms, f"{prefix}bound_by": b_by})
    return dict(max_abs_err=max(err.values()), max_abs_err_y=err["y"],
                max_abs_err_state=err["state"], library_ms=None,
                tolerance=SCAN_TOL, checked=list(cases), **out)


def check_rwkv6_scan(dev, flush) -> dict:
    """K9 at the RWKV6-7B serve path's prefill (B 4, T 256, 64 heads x 64,
    bf16, zero initial state) and decode step (T 1, the carried state),
    plus a ragged T and f32; 5 f32 operations per state element and step
    (r . S and the state update)."""
    import torch

    from repro_torch.kernels import rwkv6_scan as r6
    B, T, H = RWKV["batch"], RWKV["prompt"], 64
    gen = torch.Generator(device=dev).manual_seed(14)
    cases = {f"T={t} {dt} state={state}": rwkv6_args(
                 B, t, H, getattr(torch, dt), state, gen, dev)
             for t, dt, state in ((T, "bfloat16", False), (1, "bfloat16", True),
                                  (200, "bfloat16", True),
                                  (T, "float32", True), (1, "float32", True),
                                  (37, "float32", False))}

    def flops(args):
        b, t, h, dh = args[0].shape
        return 5 * dh * dh * b * t * h

    return dict(name="rwkv6_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                replaces="src/repro/kernels/rwkv6_scan.py:67",
                **check_scan("rwkv6_scan", r6.rwkv6_scan, r6.rwkv6_scan_plain,
                             cases, flops, flush),
                shape=dict(B=B, T=T, H=H, Dh=64, dtype="bf16",
                           decode=dict(T=1, init_state=True)))


def check_mamba2_ssd(dev, flush) -> dict:
    """K8 at the Zamba2-1.2B serve path's prefill (B 4, T 256, 64 heads x
    64, one group, state 64, bf16, zero initial state) and decode step (T 1,
    the carried state), plus a ragged T, f32, and two groups at state 16; 5
    f32 operations per state element and step (decay, rank-one update,
    C . S)."""
    import torch

    from repro_torch.kernels import mamba2_ssd as m2
    B, T, H = ZAMBA["batch"], ZAMBA["prompt"], 64
    gen = torch.Generator(device=dev).manual_seed(15)
    cases = {f"T={t} {dt} state={state} G={G} N={N}": mamba2_args(
                 B, t, H, G, N, getattr(torch, dt), state, gen, dev)
             for t, dt, state, G, N in (
                 (T, "bfloat16", False, 1, 64), (1, "bfloat16", True, 1, 64),
                 (200, "bfloat16", True, 1, 64), (T, "float32", True, 1, 64),
                 (1, "float32", True, 1, 64), (37, "float32", False, 2, 16))}

    def flops(args):
        b, t, h, p = args[0].shape
        return 5 * args[3].shape[3] * p * b * t * h

    return dict(name="mamba2_ssd", route="cuda",
                source="src/repro_torch/kernels/csrc/mamba2_ssd.cu",
                replaces="src/repro/kernels/mamba2_ssd.py:82",
                **check_scan("mamba2_ssd", m2.mamba2_ssd, m2.mamba2_ssd_plain,
                             cases, flops, flush),
                shape=dict(B=B, T=T, H=H, P=64, G=1, N=64, dtype="bf16",
                           decode=dict(T=1, init_state=True)))


def ef_leaf_sizes() -> list[int]:
    """The element counts of MiniCPM-2B's parameter leaves, the shapes K10
    quantizes on the ef train path (twice each per step)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    shapes = lm.param_shapes(get_config(TRAIN["arch"]))
    return [math.prod(adamw.get_path(shapes, p))
            for p in adamw.leaf_paths(shapes)]


def codec_bytes(n: int, elem_bytes: int, block: int = 256) -> int:
    """K10's bytes: each input element read once, the padded codes and the
    scales written once."""
    nb = -(-n // block)
    return n * elem_bytes + nb * block + 4 * nb


def check_quantize_int8(dev, flush) -> dict:
    """K10 at the train path's leaf sizes (the two MLP and attention sizes
    in f32, as the ef step quantizes them; the norms; the attention size in
    bf16) and two small ragged cases, codes and scales equal
    (`torch.equal`) to the plain version; timed at the three large shapes
    beside its bound and the plain version. No single PyTorch call computes
    this codec. The row's top-level times are the 283.1 M f32 leaf's."""
    import torch

    from repro_torch.kernels import quant_codec as qc
    sizes = sorted(set(ef_leaf_sizes()), reverse=True)
    gen = torch.Generator(device=dev).manual_seed(14)
    cases = [(n, 256, torch.float32) for n in sizes]
    cases += [(sizes[1], 256, torch.bfloat16), (1000, 256, torch.float32),
              (65, 64, torch.float32)]
    timed, checked = {}, []
    for n, block, dtype in cases:
        x = torch.randn(n, generator=gen, device=dev, dtype=dtype).mul_(1e-3)
        q, s = qc.quantize_int8(x, block=block)
        q_ref, s_ref = qc.quantize_int8_plain(x, block=block)
        torch.cuda.synchronize()
        if not (torch.equal(q, q_ref) and torch.equal(s, s_ref)):
            raise AssertionError(
                f"quantize_int8 n={n} block={block} {dtype}: "
                f"{int((q != q_ref).sum())} codes and "
                f"{int((s != s_ref).sum())} scales differ")
        del q, s, q_ref, s_ref
        dt = str(dtype).removeprefix("torch.")
        checked.append(dict(n=n, block=block, dtype=dt))
        if n >= sizes[1]:
            ms = time_ms(lambda: qc.quantize_int8(x, block=block), 20, flush)
            plain_ms = time_ms(lambda: qc.quantize_int8_plain(x, block=block),
                               3, flush)
            b_ms, b_by = bound_ms(codec_bytes(n, x.element_size(), block),
                                  4 * n, "float32")
            timed[f"{n}/{dt}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by, library_ms=None)
        del x
        torch.cuda.empty_cache()
    top = dict(timed[f"{sizes[1]}/float32"])
    return dict(name="quantize_int8", route="cuda",
                source="src/repro_torch/kernels/csrc/quant_codec.cu",
                replaces="src/repro/kernels/quant_codec.py:30",
                max_abs_err=0.0, **top, checked=checked, timed=timed,
                shape=dict(n=sizes[1], block=256, dtype="float32"))


# ---------------------------------------------------------------------------
# phases 3-10: the serve paths through ServeEngine.generate
# ---------------------------------------------------------------------------

def slice_engine(cfg, params, *, batch: int, prompt: int, new: int,
                 chips: int, device, control: bool = True,
                 host: bool = False):
    """The slice's serve configuration: a `chips`-chip fleet, the learned
    three-rail control round (refit every 4 rounds; left out with
    `control=False`, accounting only), and the launcher's roofline
    profiles. `host=True` takes the host control path instead: a
    `HostRailController` deciding from its own READ_VOUT polls (Table VI
    default interval, software path at 400 kHz), learning from them with
    the split fit every 4 rounds and actuating the simulated PMBus fleet."""
    from repro_torch.core.control_plane import (HostRailController,
                                                InGraphRailController)
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.core.policy import MultiRailClosedLoop
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.core.sor import SorConfig
    from repro_torch.core.telemetry import ALL_RAIL_OBSERVABLES
    from repro_torch.models.lm import tree_leaves
    from repro_torch.serve.engine import ServeEngine
    n = sum(a.numel() for a in tree_leaves(params))
    controller = None
    if control and host:
        controller = HostRailController(
            MultiRailClosedLoop(), n_chips=chips, decide_from="poll",
            sor=SorConfig(ingest="polled", rails=ALL_RAIL_OBSERVABLES,
                          refresh_every=4))
        controller.enable_polling()
    elif control:
        controller = InGraphRailController(
            MultiRailClosedLoop(),
            sor=SorConfig(ingest="frames", rails=ALL_RAIL_OBSERVABLES,
                          refresh_every=4))
    return ServeEngine(
        cfg, params, max_len=prompt + new + 8, batch_size=batch,
        fleet=FleetSpec.sample(chips, seed=0), controller=controller,
        prefill_profile=StepProfile(2.0 * n * batch * prompt, 2.0 * n, 0.0),
        decode_profile=StepProfile(2.0 * n * batch, 2.0 * n, 0.0),
        device=device)


def tiny_variants(arch: str) -> dict:
    """The tiny configurations of `arch` in f32 held cuda against cpu: for
    Qwen2.5 plain TINY and the padded-GQA variant (12 q / 4 kv heads,
    group 3, zero pad slots); for Zamba2 plain TINY and an 8-token sliding
    window, which the shared block's KV cache wraps (`run_tiny` prompts 16
    tokens); for RWKV6 its TINY."""
    import dataclasses

    from repro_torch.configs import get_config
    tiny = dataclasses.replace(get_config(arch, tiny=True), dtype="float32")
    if arch == "qwen2p5_14b":
        return {"tiny": tiny,
                "tiny_gqa_pad": dataclasses.replace(
                    tiny, n_heads=10, n_kv_heads=2, head_dim=32, tp=4)}
    if arch == "zamba2_1p2b":
        return {"tiny": tiny,
                "tiny_window": dataclasses.replace(tiny, sliding_window=8)}
    return {"tiny": tiny}


def run_tiny(arch: str) -> dict:
    """Tiny `arch` in f32 (`tiny_variants`), the same weights on cuda and
    cpu through the slice's engine: tokens equal, plane and SOR estimate
    allclose."""
    import numpy as np
    import torch

    from repro_torch.models import registry
    from repro_torch.models.lm import tree_map
    B, Tp, new, chips = 2, 16, 12, 8
    out = {}
    for name, cfg in tiny_variants(arch).items():
        params = registry.build(cfg).init(
            torch.Generator(device="cpu").manual_seed(0))
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, Tp)).astype(np.int32)
        runs = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda a: a.to(dev), params)
            eng = slice_engine(cfg, p, batch=B, prompt=Tp, new=new,
                               chips=chips, device=dev)
            runs[dev] = (eng.generate(prompts, new), eng)
        (t_cpu, e_cpu), (t_gpu, e_gpu) = runs["cpu"], runs["cuda"]
        if not np.array_equal(t_cpu, t_gpu):
            raise AssertionError(f"{name}: cuda tokens {t_gpu.tolist()} != "
                                 f"cpu tokens {t_cpu.tolist()}")
        worst = 0.0
        for f in ("v_core", "v_hbm", "v_io", "energy_j"):
            a = getattr(e_cpu.plane, f)
            b = getattr(e_gpu.plane, f).cpu()
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-7):
                raise AssertionError(f"{name}: plane.{f} differs")
            worst = max(worst, (a - b).abs().max().item())
        if not torch.equal(e_cpu.plane.comp_level,
                           e_gpu.plane.comp_level.cpu()):
            raise AssertionError(f"{name}: comp_level differs")
        for f in ("intercept", "slope", "v_frontier", "confidence", "n_eff"):
            a = getattr(e_cpu._sor_state.estimate, f)
            b = getattr(e_gpu._sor_state.estimate, f).cpu()
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"{name}: SOR estimate {f} differs")
        out[name] = dict(tokens_equal=True, shape=list(t_gpu.shape),
                         plane_max_abs_diff=worst, family=cfg.family)
        if cfg.family == "dense":
            plan = cfg.head_plan()
            out[name]["heads"] = [plan.n_q_pad, plan.n_kv_pad, plan.group]
        if cfg.family == "hybrid":
            out[name]["sliding_window"] = cfg.sliding_window
    return out


# The host path's frontier world, cuda against cpu. The split fit on the
# same window: frontier, confidence and weight at the port's stated SOR
# tolerance; intercept and slope at the window's conditioning bound
# (`solve_rtol`): the uncentred solve cancels all but ~1e-4 of `sw*sxx` on a
# window that spans ~40 mV, and the two devices differ in the last bit of
# the sums (torch's CPU `sum` blocks the rows, K7 adds them in order) and of
# the inputs (log10 and the recency powers round differently on the card).
# The closed loop: each device's envelope feeds its own next setpoint, so
# those last bits move setpoints across LINEAR16 steps (0.244 mV) and the
# learned floors part by up to 0.5 mV, the bound tests/test_torch_host.py
# holds the port to against the reference (FLOOR_ATOL). No summation order
# closes it: the inputs themselves differ (`same_window_inputs_equal`).
SOR_TOL = dict(rtol=1e-4, atol=1e-5)
FLOOR_ATOL = 5e-4


def solve_rtol(x, y, w):
    """Per-lane first-order bound on the relative change of the uncentred
    EWLS solve's slope and intercept when every window term moves by one
    rounding and each of the five sums by one rounding per row, in f64
    from the window [window, n] (the bound of tests/test_torch_host.py::
    _solve_rtol): (n + 2) u times the cancellation factors (sw*sxx +
    sx^2)/|denom| and (sw sum|wxy| + sx sum|wy|)/|num|, and for the
    intercept `(sy - slope*sx)/sw` the factor (sum|wy| + |slope*sx|)/|sy -
    slope*sx|. Returns (rel_slope, rel_intercept), each [n] f64."""
    import numpy as np
    x, y, w = (np.asarray(a, np.float64) for a in (x, y, w))
    u = (x.shape[0] + 2) * 2.0 ** -24
    sw, sx, sy = w.sum(0), (w * x).sum(0), (w * y).sum(0)
    sxx, sxy = (w * x * x).sum(0), (w * x * y).sum(0)
    a_y, a_xy = np.abs(w * y).sum(0), np.abs(w * x * y).sum(0)
    with np.errstate(divide="ignore", invalid="ignore"):
        denom, num = sw * sxx - sx * sx, sw * sxy - sx * sy
        slope = num / denom
        rel_slope = 2 * u * ((sw * sxx + sx * sx) / np.abs(denom)
                             + (sw * a_xy + sx * a_y) / np.abs(num))
        rel_icpt = (u * a_y + np.abs(slope * sx) * (rel_slope + u)) \
            / np.abs(sy - slope * sx) + u
    return rel_slope, rel_icpt


def host_learning_world(dev, chips: int = 8, rounds: int = 40):
    """The frontier world of the reference's
    tests/test_sor_multirail.py::test_host_polled_ingest_multirail on a
    `chips`-chip plane: MultiRailClosedLoop with floors 0.70/1.00/0.70,
    the VDD_IO observable at the bound at 0.78 V and VDD_CORE's at 0.72 V
    (30 dex/V), polls every 1 ms, `rounds` rounds of 5 ms idle. The
    observables are computed on the host from the plane, in f32, so both
    devices see the same numbers for the same plane."""
    import numpy as np
    import torch

    from repro_torch.core.control_plane import HostRailController
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.core.policy import MultiRailClosedLoop
    from repro_torch.core.power_plane import PowerPlaneState
    from repro_torch.core.sor import SorConfig
    from repro_torch.core.telemetry import ALL_RAIL_OBSERVABLES
    cfg = SorConfig(capacity=24, refresh_every=2, decay=0.96, guard_v=0.004,
                    max_extension_v=0.12, rails=ALL_RAIL_OBSERVABLES)
    hc = HostRailController(
        MultiRailClosedLoop(floors={"VDD_CORE": 0.70, "VDD_HBM": 1.00,
                                    "VDD_IO": 0.70}),
        n_chips=chips, settle_band_frac=0.001, decide_from="poll", sor=cfg)
    hc.enable_polling(interval_s=1e-3)
    plane = PowerPlaneState.from_fleet(FleetSpec.sample(chips, seed=0), dev)

    def observable(v, onset):
        v = v.cpu().numpy().astype(np.float32)
        return torch.from_numpy((5e-3 * 10.0 ** np.clip(
            30.0 * (onset - v), -6.0, 3.0)).astype(np.float32)).to(dev)

    for _ in range(rounds):
        hc.fleet.idle(5e-3)
        plane = hc.control_step(plane, {
            "grad_error": observable(plane.v_io, 0.78),
            "straggle_rate": observable(plane.v_core, 0.72)})
    return hc, plane


def run_tiny_host() -> dict:
    """Tiny Qwen2.5 in f32 served on an 8-chip fleet through the host
    control path on cuda and on cpu (tokens, the achieved rails of every
    chip and `stats()` equal); then `host_learning_world` on both devices:
    the same lanes learn, inside the reference test's bands, with the
    closed-loop floors within FLOOR_ATOL (VDD_HBM, never reported, stays
    cold); and the cpu run's final window refitted by the split fit on
    both devices (K7 on the card): the same usable lanes, frontier,
    confidence and weight within SOR_TOL, intercept and slope within the
    window's conditioning bound (`solve_rtol`)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import registry
    from repro_torch.models.lm import tree_map
    B, Tp, new, chips = 2, 16, 12, 8
    cfg = tiny_variants("qwen2p5_14b")["tiny"]
    params = registry.build(cfg).init(
        torch.Generator(device="cpu").manual_seed(0))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, Tp)).astype(np.int32)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev), params)
        eng = slice_engine(cfg, p, batch=B, prompt=Tp, new=new, chips=chips,
                           device=dev, host=True)
        runs[dev] = (eng.generate(prompts, new), eng)
    (t_cpu, e_cpu), (t_gpu, e_gpu) = runs["cpu"], runs["cuda"]
    if not np.array_equal(t_cpu, t_gpu):
        raise AssertionError(f"tiny_host: cuda tokens {t_gpu.tolist()} != "
                             f"cpu tokens {t_cpu.tolist()}")
    for f in ("v_core", "v_hbm", "v_io"):
        if not torch.equal(getattr(e_cpu.plane, f),
                           getattr(e_gpu.plane, f).cpu()):
            raise AssertionError(f"tiny_host: achieved {f} differs")
    st_cpu = dataclasses.asdict(e_cpu.controller.stats())
    st_gpu = dataclasses.asdict(e_gpu.controller.stats())
    if st_cpu != st_gpu:
        raise AssertionError(f"tiny_host: stats {st_gpu} != {st_cpu}")
    s_cpu, s_gpu = e_cpu.summary()["sor"], e_gpu.summary()["sor"]
    if s_cpu["chips_learned"] != s_gpu["chips_learned"]:
        raise AssertionError("tiny_host: serve path lanes learned differ")
    out = dict(tokens_equal=True, rails_equal=True, stats=st_gpu,
               serve_chips_learned=s_gpu["chips_learned"],
               v_io_mean=float(e_gpu.plane.v_io.mean()))

    worlds = {dev: host_learning_world(dev) for dev in ("cpu", "cuda")}
    sums = {dev: hc.sor_summary() for dev, (hc, _) in worlds.items()}
    learn = {}
    for i, (rail, band) in enumerate((("VDD_CORE", (0.715, 0.74)),
                                      ("VDD_HBM", None),
                                      ("VDD_IO", (0.775, 0.80)))):
        n_cpu = sums["cpu"][f"{rail}/chips_learned"]
        n_gpu = sums["cuda"][f"{rail}/chips_learned"]
        if n_cpu != n_gpu:
            raise AssertionError(f"learning world {rail}: {n_gpu} chips "
                                 f"learned on cuda, {n_cpu} on cpu")
        if band is None:
            if n_gpu != 0:
                raise AssertionError(f"{rail} was never reported but "
                                     f"{n_gpu} chips learned")
            learn[rail] = dict(chips_learned=0)
            continue
        if n_gpu != 8:
            raise AssertionError(f"learning world {rail}: {n_gpu} of 8 "
                                 f"chips learned")
        floors = {}
        for dev, (hc, _) in worlds.items():
            est = hc.sor_state.estimate
            floors[dev] = (est.v_frontier[i] + 0.004).cpu()
            mean = sums[dev][f"{rail}/floor_mean_v"]
            if not band[0] < mean < band[1]:
                raise AssertionError(f"learning world {rail} on {dev}: "
                                     f"floor {mean} outside {band}")
        gap = (floors["cuda"] - floors["cpu"]).abs().max().item()
        learn[rail] = dict(chips_learned=n_gpu,
                           floor_mean_v=sums["cuda"][f"{rail}/floor_mean_v"],
                           floor_max_abs_diff=gap)
        if not gap <= FLOOR_ATOL:
            raise AssertionError(f"learning world {rail}: floors differ by "
                                 f"{gap} V (atol {FLOOR_ATOL})")
    rails_gap = max((getattr(worlds["cuda"][1], f).cpu()
                     - getattr(worlds["cpu"][1], f)).abs().max().item()
                    for f in ("v_core", "v_hbm", "v_io"))

    from repro_torch.core import sor
    hc = worlds["cpu"][0]
    hist = hc.sor_state.history
    on_card = dataclasses.replace(hist, **{
        f: getattr(hist, f).to("cuda")
        for f in ("v", "obs", "age_s", "polled", "valid")})
    fits = {"cpu": sor.fit_history(hist, hc.sor, fused=False),
            "cuda": sor.fit_history(on_card, hc.sor, fused=False)}
    if not torch.equal(fits["cpu"].confidence > 0,
                       fits["cuda"].confidence.cpu() > 0):
        raise AssertionError("same-window split fit: usable lanes differ")
    x, y, w = (a.reshape(hist.capacity, -1).numpy()
               for a in sor._fit_inputs(hist, hc.sor))
    card_inputs = [a.reshape(hist.capacity, -1).cpu().numpy()
                   for a in sor._fit_inputs(on_card, hc.sor)]
    rel = dict(zip(("slope", "intercept"), solve_rtol(x, y, w)))
    usable = (fits["cpu"].confidence > 0).reshape(-1).numpy()
    fit_gap, fit_rel = {}, {}
    for f in ("intercept", "slope", "v_frontier", "confidence", "n_eff"):
        a, b = getattr(fits["cuda"], f).cpu(), getattr(fits["cpu"], f)
        fit_gap[f] = (a - b).abs().max().item()
        if f in rel:
            a, b = a.reshape(-1).numpy(), b.reshape(-1).numpy()
            r = np.abs(a - b)[usable] / np.abs(b)[usable]
            fit_rel[f] = dict(max_rel=float(r.max()),
                              bound_min=float(rel[f][usable].min()))
            if not np.all(r <= rel[f][usable]):
                raise AssertionError(
                    f"same-window split fit {f}: relative gaps "
                    f"{r.tolist()} beyond the bound "
                    f"{rel[f][usable].tolist()}")
        elif not torch.allclose(a, b, **SOR_TOL):
            raise AssertionError(f"same-window split fit {f}: max diff "
                                 f"{fit_gap[f]}")
    inputs_equal = {k: bool(np.array_equal(a, b)) for k, a, b in
                    zip("xyw", (x, y, w), card_inputs)}
    out["learning_world"] = dict(
        rails_max_abs_diff=rails_gap, floor_atol=FLOOR_ATOL,
        same_window_fit_max_abs_diff=fit_gap, same_window_fit_rel=fit_rel,
        same_window_inputs_equal=inputs_equal, sor_tol=SOR_TOL, **learn)
    return out


def serve_launches(cfg, new: int) -> dict:
    """The launches one `generate` of `new` tokens must make: the control
    round refits on every 4th of its `new` rounds (K1); dense: K2 once per
    layer in the prefill, K3 once per layer per decoded token; ssm: K9 once
    per layer in the prefill and per decoded token; hybrid: K8 once per
    layer in the prefill and per decoded token, K2 and K3 as dense but once
    per occurrence of the shared block (n_layers // attn_every)."""
    from repro_torch.kernels import ops
    want = {name: 0 for name in ops.KERNELS}
    want["sor_fit"] = new // 4
    if cfg.family == "ssm":
        want["rwkv6_scan"] = cfg.n_layers * new
    elif cfg.family == "hybrid":
        n_occ = cfg.n_layers // cfg.attn_every
        want.update({"mamba2_ssd": cfg.n_layers * new,
                     "flash_attention_fwd": n_occ,
                     "decode_attention": n_occ * (new - 1)})
    else:
        want.update({"flash_attention_fwd": cfg.n_layers,
                     "decode_attention": cfg.n_layers * (new - 1)})
    return want


def init_main(dev, spec: dict):
    """`spec["arch"]` at full width and depth, random weights from seed 0
    on the card: (cfg, params, seconds taken)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = get_config(spec["arch"])
    t0 = time.perf_counter()
    params = registry.build(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def main_prompts(cfg, spec: dict):
    import numpy as np
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (spec["batch"], spec["prompt"])).astype(np.int32)


def run_main(dev, spec: dict, cfg, params, init_s: float) -> dict:
    """Full-width, full-depth `spec["arch"]` through ServeEngine.generate
    with the 64-chip fleet and the learned control round; the launch counts
    of this run alone are checked exactly. The breakdown of a decode step
    (`decode_breakdown`) follows the checked run."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.lm import tree_leaves
    B, Tp, new, chips = spec["batch"], spec["prompt"], spec["new"], \
        spec["chips"]
    n_params = sum(a.numel() for a in tree_leaves(params))
    prompts = main_prompts(cfg, spec)

    def engine(control=True):
        return slice_engine(cfg, params, batch=B, prompt=Tp, new=new,
                            chips=chips, device=dev, control=control)

    engine().generate(prompts, 2)        # warm-up (cuBLAS, first launches)
    torch.cuda.synchronize()

    eng = engine()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, new)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = eng.summary()

    want = serve_launches(cfg, new)
    if launches != want:
        raise AssertionError(f"{cfg.name} launch counts {launches} != "
                             f"{want}")
    if tokens.shape != (B, new) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tokens.shape} "
                             f"[{tokens.min()}, {tokens.max()}]")
    for k in ("energy_j", "model_time_s", "v_core", "v_io",
              "fleet_energy_j"):
        if not math.isfinite(summary[k]):
            raise AssertionError(f"summary[{k!r}] = {summary[k]}")

    eng = engine()                     # prefill + first token alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_s = (total_s - prefill_s) / (new - 1)
    profile = decode_breakdown(engine, prompts)
    return dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
                d_model=cfg.d_model, params=n_params,
                batch=B, prompt=Tp, new_tokens=new, n_chips=chips,
                dtype=cfg.dtype, init_s=init_s, generate_s=total_s,
                prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_s * 1e3,
                tokens_per_s=B * new / total_s,
                decode_tokens_per_s=B / decode_s,
                peak_mem_gb=peak_gb, launches=launches,
                expected_launches=want, summary=summary,
                first_tokens=tokens[:, :8].tolist(), profile=profile)


def host_serve_launches(cfg, new: int) -> dict:
    """`serve_launches` with the host control path: the split fit refits
    on every 4th round through K7, and K1 never runs."""
    want = serve_launches(cfg, new)
    want["sor_accumulate"], want["sor_fit"] = want["sor_fit"], 0
    return want


def run_main_host(dev, spec: dict, cfg, params) -> dict:
    """The main path's weights served through the host control path
    (`slice_engine(host=True)`): a warm-up, then one checked `generate`
    whose launch counts must be exact; the prefill alone; the host round's
    time split into the bus simulation and the SOR observe
    (`host_round_breakdown`); and the decode-step breakdown."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    B, Tp, new, chips = spec["batch"], spec["prompt"], spec["new"], \
        spec["chips"]
    prompts = main_prompts(cfg, spec)

    def engine(control=True):
        return slice_engine(cfg, params, batch=B, prompt=Tp, new=new,
                            chips=chips, device=dev, control=control,
                            host=True)

    engine().generate(prompts, 2)        # warm-up
    torch.cuda.synchronize()
    eng = engine()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, new)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = eng.summary()
    hc = eng.controller
    stats = dataclasses.asdict(hc.stats())

    want = host_serve_launches(cfg, new)
    if launches != want:
        raise AssertionError(f"{cfg.name} host path launch counts "
                             f"{launches} != {want}")
    if tokens.shape != (B, new) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tokens.shape} "
                             f"[{tokens.min()}, {tokens.max()}]")
    if stats["decisions"] != new or stats["poll_decisions"] != new or \
            stats["actuations"] < 1 or not stats["actuation_seconds"] > 0:
        raise AssertionError(f"host path stats {stats}")
    for k in ("energy_j", "model_time_s", "v_core", "v_io",
              "fleet_energy_j"):
        if not math.isfinite(summary[k]):
            raise AssertionError(f"summary[{k!r}] = {summary[k]}")

    eng = engine()                     # prefill + first token alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_s = (total_s - prefill_s) / (new - 1)
    rounds = host_round_breakdown(engine, prompts)
    profile = decode_breakdown(engine, prompts)
    return dict(arch=cfg.name, control_path="host", batch=B, prompt=Tp,
                new_tokens=new, n_chips=chips, dtype=cfg.dtype,
                generate_s=total_s, prefill_ms=prefill_s * 1e3,
                decode_ms_per_token=decode_s * 1e3,
                tokens_per_s=B * new / total_s,
                peak_mem_gb=peak_gb, launches=launches,
                expected_launches=want, stats=stats,
                plane_reads_per_round=hc.plane_reads / stats["decisions"],
                host_round=rounds, summary=summary,
                first_tokens=tokens[:, :8].tolist(), profile=profile)


def host_round_breakdown(engine, prompts, steps: int = 8) -> dict:
    """The host controller's round on the host clock, through a `generate`
    of 1 + `steps` tokens with the rounds instrumented: each
    `control_step` between two device syncs (so it does not wait for the
    model's queued work, and its own device work is inside), split into the
    bus simulation (`apply_setpoints` and `poll_frame` of the fleet, pure
    Python) and the SOR observe (push, split fit, envelopes; synced at its
    end). Per round, the prefill's round left out."""
    import torch
    eng = engine(True)
    hc = eng.controller
    cur = {}
    rounds = []

    def timed(fn, key, sync=False):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            cur[key] = cur.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    hc.fleet.apply_setpoints = timed(hc.fleet.apply_setpoints, "bus")
    hc.fleet.poll_frame = timed(hc.fleet.poll_frame, "bus")
    hc._sor_observe = timed(hc._sor_observe, "sor", sync=True)
    step = hc.control_step

    def control_step(plane, telemetry):
        cur.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(plane, telemetry)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0, cur.get("bus", 0.0),
                       cur.get("sor", 0.0)))
        return out

    hc.control_step = control_step
    eng.generate(prompts, 1 + steps)
    decode = rounds[1:]
    n = len(decode)
    total, bus, sor = (sum(r[i] for r in decode) / n * 1e3 for i in range(3))
    return dict(rounds=n, round_ms=total, bus_simulation_ms=bus,
                sor_observe_ms=sor, other_ms=total - bus - sor,
                round_ms_each=[r[0] * 1e3 for r in decode])


def decode_breakdown(engine, prompts, steps: int = 8) -> dict:
    """Where a decode step's time goes, read through `generate` alone: a
    run of 1 + `steps` tokens less a run of 1 token (the prefill and first
    token), per decode step. On the host clock (synchronized, best of two)
    with the control round and without it, so their difference is the
    control round's cost; then under torch.profiler for the device's busy
    share and the kernels that fill it. `engine(control)` makes a fresh
    engine of the main path, with or without its controller."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def wall_ms(control, n):
        eng = engine(control)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def step_ms(control):
        return min(wall_ms(control, 1 + steps) - wall_ms(control, 1)
                   for _ in range(2)) / steps

    step_with, step_without = step_ms(True), step_ms(False)

    def dev_us(evt):
        return getattr(evt, "device_time_total",
                       getattr(evt, "cuda_time_total", 0.0))

    def profiled(n):
        eng = engine(True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate(prompts, n)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, copies, fills): the CPU ops
        # that launched them report the same time again
        return wall, {e.key: (e.count, dev_us(e)) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA}

    wall_1, kern_1 = profiled(1)
    wall_n, kern_n = profiled(1 + steps)
    per_kernel = {name: (calls - kern_1.get(name, (0, 0.0))[0],
                         us - kern_1.get(name, (0, 0.0))[1])
                  for name, (calls, us) in kern_n.items()}
    busy_ms = sum(us for _, us in per_kernel.values()) / 1e3 / steps
    profiled_step_ms = (wall_n - wall_1) / steps
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][1],
                 reverse=True)[:12]
    return dict(
        steps=steps, decode_step_ms=step_with,
        decode_step_without_control_ms=step_without,
        control_round_ms=step_with - step_without,
        profiled_step_ms=profiled_step_ms, device_busy_ms_per_step=busy_ms,
        device_busy_share=busy_ms / profiled_step_ms,
        top_kernels=[dict(name=name[:90], calls_per_step=calls / steps,
                          ms_per_step=us / 1e3 / steps)
                     for name, (calls, us) in top])


# ---------------------------------------------------------------------------
# phases 11-13: the training path through Trainer.run
# ---------------------------------------------------------------------------

def train_slice(cfg, params, dev, *, chips: int, batch: int, seq: int,
                steps: int, refresh_every: int, remat: str = "full"):
    """The slice's training configuration: the fleet train step with
    in-graph SOR learning on a `chips`-chip fleet (margin-coupled error,
    straggler and HBM-error observables, learned three-rail control round,
    refit every `refresh_every` steps), AdamW with f32 moments, the
    launcher's WSD schedule and roofline profile. Returns (make_trainer,
    initial state, data, sor config); make_trainer(state, total_steps)
    builds a `Trainer` that continues from `state`."""
    from repro_torch.core import sor
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.core.policy import MultiRailClosedLoop
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.core.telemetry import ALL_RAIL_OBSERVABLES
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.step import (FleetStepConfig, StepConfig,
                                        make_fleet_train_step)
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           initial_plane_and_ef)
    n = sum(a.numel() for a in tree_leaves(params))
    opt_cfg = adamw.AdamWConfig()
    fleet = FleetSpec.sample(chips, seed=0)
    scfg = sor.SorConfig(ingest="frames", rails=ALL_RAIL_OBSERVABLES,
                         refresh_every=refresh_every)
    tokens = batch * seq

    def sched(s):
        return wsd(s, peak_lr=3e-4, warmup_steps=10,
                   stable_steps=int(steps * 0.7),
                   decay_steps=int(steps * 0.2))

    step = make_fleet_train_step(
        registry.build(cfg, remat=remat).loss_fn, opt_cfg, sched,
        StepProfile(6.0 * n * tokens, 14.0 * n, 4.0 * n, 4.0 * n),
        StepConfig(policy=MultiRailClosedLoop()),
        FleetStepConfig(spec=fleet, hbm_error_base=1e-4,
                        straggler_prob=0.05, link_ber_floor=1e-3, sor=scfg))
    plane, ef = initial_plane_and_ef(params, fleet)
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg),
             "plane": plane, "ef": ef,
             "sor": sor.init_state(scfg, chips, device=dev)}
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch))

    def make_trainer(state, total_steps):
        return Trainer(step, data,
                       TrainerConfig(total_steps=total_steps, sor=scfg,
                                     device=dev), state)

    return make_trainer, state, data, scfg


# tiny cuda vs cpu, f32. Losses and params: sums in another order, then
# AdamW's normalized step (m / sqrt(v)) amplifies a last-bit gradient
# difference where |g| is tiny (params held to lr-scaled error). The first
# SOR refit solves from two samples: the reference's uncentred f32 solve
# cancels ~3 of 7 digits, so its slope carries ~2 % of f32 rounding
# (measured between the two packages on the CPU: slope 0.15 of ~9 dex/V,
# v_frontier 2.8e-3 V), which the envelope floor passes to the rails at
# confidence 0.21 (measured 2.3e-4 V).
TINY_TRAIN_TOL = dict(loss=dict(rtol=1e-4, atol=0.0),
                      params=dict(rtol=1e-4, atol=1e-4),
                      rails=dict(rtol=0.0, atol=5e-4),
                      sor=dict(rtol=5e-2, atol=1e-2))


def run_tiny_train() -> dict:
    """Tiny MiniCPM in f32, the same weights on cuda and cpu, three fleet
    SOR steps (refit every second step) through Trainer.run: losses,
    params, plane (comp_level exact) and SOR estimate (usable lanes exact)
    allclose at TINY_TRAIN_TOL; the largest differences are reported."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("minicpm_2b", tiny=True),
                              dtype="float32")
    params = registry.build(cfg).init(
        torch.Generator(device="cpu").manual_seed(0))
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev, copy=True), params)
        make, state, _, scfg = train_slice(cfg, p, dev, chips=8, batch=2,
                                           seq=32, steps=3, refresh_every=2)
        trainer = make(state, 3)
        trainer.run()
        runs[dev] = trainer
    cpu, gpu = runs["cpu"], runs["cuda"]
    tol = TINY_TRAIN_TOL

    def worst(a, b, t, what):
        b = b.detach().cpu()
        a = a.detach()
        if not torch.allclose(a, b, **t):
            raise AssertionError(f"tiny_train {what}: max diff "
                                 f"{(a - b).abs().max().item()}")
        return (a - b).abs().max().item()

    losses = {d: torch.tensor([r.loss for r in t.log.records])
              for d, t in runs.items()}
    out = {"loss_max_abs_diff": worst(losses["cpu"], losses["cuda"],
                                      tol["loss"], "loss"),
           "losses_cuda": losses["cuda"].tolist()}
    out["params_max_abs_diff"] = max(
        worst(a, b, tol["params"], "params")
        for a, b in zip(tree_leaves(cpu.state["params"]),
                        tree_leaves(gpu.state["params"])))
    pc, pg = cpu.state["plane"], gpu.state["plane"]
    out["rails_max_abs_diff"] = max(
        worst(getattr(pc, f), getattr(pg, f), tol["rails"], f)
        for f in ("v_core", "v_hbm", "v_io"))
    if not torch.equal(pc.comp_level, pg.comp_level.cpu()):
        raise AssertionError("tiny_train: comp_level differs")
    ec, eg = cpu.state["sor"].estimate, gpu.state["sor"].estimate
    if not torch.equal(ec.confidence > 0, eg.confidence.cpu() > 0):
        raise AssertionError("tiny_train: SOR usable lanes differ")
    out["sor_max_abs_diff"] = {
        f: worst(getattr(ec, f), getattr(eg, f), tol["sor"], f"sor {f}")
        for f in ("intercept", "slope", "v_frontier", "confidence",
                  "n_eff")}
    out["sor_lanes_learned"] = int((eg.confidence > 0).sum())
    out["tolerances"] = tol
    return out


def run_tiny_train_host() -> dict:
    """Tiny MiniCPM in f32, the same weights on cuda and cpu, four scalar
    train steps through Trainer.run with a `HostRailController(PhaseAware())`
    between steps (the train launcher's `--control-path host`): losses
    within TINY_TRAIN_TOL, host actuations and their simulated bus seconds
    equal, the achieved rails equal."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.control_plane import HostRailController
    from repro_torch.core.policy import PhaseAware
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.step import StepConfig, make_train_step
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           initial_plane_and_ef)
    cfg = dataclasses.replace(get_config("minicpm_2b", tiny=True),
                              dtype="float32")
    api = registry.build(cfg)
    params = api.init(torch.Generator(device="cpu").manual_seed(0))
    n = sum(a.numel() for a in tree_leaves(params))
    B, T, steps = 2, 32, 4

    def sched(s):
        return wsd(s, peak_lr=3e-4, warmup_steps=10,
                   stable_steps=int(steps * 0.7),
                   decay_steps=int(steps * 0.2))

    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev, copy=True), params)
        opt_cfg = adamw.AdamWConfig()
        step = make_train_step(
            api.loss_fn, opt_cfg, sched,
            StepProfile(6.0 * n * B * T, 14.0 * n, 4.0 * n, 4.0 * n),
            StepConfig(policy=None))
        plane, ef = initial_plane_and_ef(p)
        trainer = Trainer(
            step, SyntheticLM(DataConfig(cfg.vocab_size, T, B)),
            TrainerConfig(total_steps=steps,
                          controller=HostRailController(PhaseAware()),
                          device=dev),
            {"params": p, "opt": adamw.init_state(p, opt_cfg),
             "plane": plane, "ef": ef})
        trainer.run()
        runs[dev] = trainer
    losses = {d: torch.tensor([r.loss for r in t.log.records])
              for d, t in runs.items()}
    if not torch.allclose(losses["cpu"], losses["cuda"],
                          **TINY_TRAIN_TOL["loss"]):
        raise AssertionError(f"tiny_train_host losses {losses}")
    sums = {d: t.summary() for d, t in runs.items()}
    for k in ("host_actuations", "host_actuation_s",
              "host_skipped_actuations"):
        if sums["cpu"][k] != sums["cuda"][k]:
            raise AssertionError(f"tiny_train_host {k}: cuda "
                                 f"{sums['cuda'][k]} != cpu "
                                 f"{sums['cpu'][k]}")
    if sums["cuda"]["host_actuations"] < 1:
        raise AssertionError("tiny_train_host: no actuation")
    for f in ("v_core", "v_hbm", "v_io"):
        if not torch.equal(getattr(runs["cpu"].state["plane"], f),
                           getattr(runs["cuda"].state["plane"], f).cpu()):
            raise AssertionError(f"tiny_train_host: achieved {f} differs")
    stats = dataclasses.asdict(runs["cuda"].cfg.controller.stats())
    return dict(steps=steps, losses_cuda=losses["cuda"].tolist(),
                loss_max_abs_diff=(losses["cpu"] - losses["cuda"]).abs()
                .max().item(),
                host_actuations=sums["cuda"]["host_actuations"],
                host_actuation_s=sums["cuda"]["host_actuation_s"],
                stats=stats, tolerances=dict(loss=TINY_TRAIN_TOL["loss"]))


def run_main_train(dev) -> dict:
    """Full-width, full-depth MiniCPM-2B in bf16 through Trainer.run: one
    warm-up step, then TRAIN["steps"] steps whose launch counts are checked
    exactly, then a torch.profiler window of TRAIN["profiled_steps"]."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves
    cfg = get_config(TRAIN["arch"])
    B, T, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    t0 = time.perf_counter()
    params = registry.build(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    n_params = sum(a.numel() for a in tree_leaves(params))
    make, state, data, scfg = train_slice(
        cfg, params, dev, chips=TRAIN["chips"], batch=B, seq=T, steps=steps,
        refresh_every=4)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for s in range(3):
        data.batch(s)
    data_ms = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    for s in range(3):
        data.torch_batch(s, dev)
    torch.cuda.synchronize()
    data_to_device_ms = (time.perf_counter() - t0) / 3 * 1e3

    warm = make(state, 1)          # warm-up: cuBLAS, allocator, first launch
    warm.run()
    torch.cuda.synchronize()
    tick0 = warm.state["sor"].tick

    trainer = make(warm.state, steps)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    L = cfg.n_layers
    refits = sum(1 for t in range(tick0 + 1, tick0 + steps + 1)
                 if t % scfg.refresh_every == 0)
    want = {name: 0 for name in ops.KERNELS}
    want.update({"flash_attention_fwd": 2 * L * steps,   # forward + remat
                 "flash_attention_bwd_dq": L * steps,
                 "flash_attention_bwd_dkv": L * steps,
                 "fleet_reduce": steps, "sor_fit": refits})
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    losses = [r.loss for r in trainer.log.records]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    summary = trainer.summary()
    sor = summary["sor"]
    step_s = statistics.median(trainer.step_times)
    tokens = B * T
    # the device time per step of K2, K4 and K5 (their bf16 kernels)
    profile = train_breakdown(make, trainer.state, TRAIN["profiled_steps"],
                              watch=TRAIN_ATTENTION)
    return dict(
        arch=cfg.name, n_layers=L, params=n_params, batch=B, seq=T,
        n_chips=TRAIN["chips"], dtype=cfg.dtype, remat="full",
        adamw_state="float32", init_s=init_s, steps=steps,
        step_ms_median=step_s * 1e3,
        step_ms=[x * 1e3 for x in trainer.step_times],
        run_s=run_s, data_batch_ms=data_ms,
        data_to_device_ms=data_to_device_ms,
        tokens_per_s=tokens / step_s,
        mfu=6.0 * n_params * tokens / step_s / PEAK_FLOPS["bfloat16"],
        peak_mem_gb=peak_gb, losses=losses, launches=launches,
        expected_launches=want, sor_tick_before=tick0,
        sor_conf_mean=sor["confidence_mean"],
        sor_conf_min=min(sor[f"{r.rail}/confidence_min"]
                         for r in scfg.rails),
        sor_summary=sor, fleet_last=summary.get("fleet_last"),
        profile=profile)


def train_breakdown(make, state, steps: int, watch: tuple[str, ...] = ()
                    ) -> dict:
    """`steps` more train steps under torch.profiler: the device's busy
    time per step (sum of device-side events), its share of the host wall
    time of the same steps, the kernels that fill it and, for each name in
    `watch`, the device ms and calls per step of the kernels whose name
    holds it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(evt):
        return getattr(evt, "device_time_total",
                       getattr(evt, "cuda_time_total", 0.0))

    trainer = make(state, steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kern = {e.key: (e.count, dev_us(e)) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}
    busy_ms = sum(us for _, us in kern.values()) / 1e3 / steps
    top = sorted(kern.items(), key=lambda kv: kv[1][1], reverse=True)[:12]
    out = dict(steps=steps, profiled_step_ms=wall_ms,
               device_busy_ms_per_step=busy_ms,
               device_busy_share=busy_ms / wall_ms,
               top_kernels=[dict(name=name[:90], calls_per_step=c / steps,
                                 ms_per_step=us / 1e3 / steps)
                            for name, (c, us) in top])
    for w in watch:
        out[f"{w}_ms_per_step"] = sum(
            us for name, (_, us) in kern.items() if w in name) / 1e3 / steps
        out[f"{w}_calls_per_step"] = sum(
            c for name, (c, _) in kern.items() if w in name) / steps
    return out


# ---------------------------------------------------------------------------
# phases 14-15: the error-feedback gradient sync (K10) through Trainer.run
# ---------------------------------------------------------------------------

EF_SYNCS = ("ef_int8", "ef_int8_topk", "auto")


def ef_slice(cfg, params, dev, *, batch: int, seq: int, steps: int,
             remat: str = "full"):
    """The ef slice's training configuration: the scalar train step with
    `StepConfig(grad_sync=..., policy=BERBounded())` (the paper's
    case-study policy reading the compression error), AdamW with f32
    moments, the launcher's WSD schedule and roofline profile. Returns
    (make_trainer, initial state); make_trainer(sync, state, total_steps)
    builds a `Trainer` whose step syncs gradients by `sync` and continues
    from `state`."""
    from repro_torch.core.policy import BERBounded
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.step import StepConfig, make_train_step
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           initial_plane_and_ef)
    n = sum(a.numel() for a in tree_leaves(params))
    opt_cfg = adamw.AdamWConfig()

    def sched(s):
        return wsd(s, peak_lr=3e-4, warmup_steps=10,
                   stable_steps=int(steps * 0.7),
                   decay_steps=int(steps * 0.2))

    loss_fn = registry.build(cfg, remat=remat).loss_fn
    profile = StepProfile(6.0 * n * batch * seq, 14.0 * n, 4.0 * n, 4.0 * n)
    step_fns = {sync: make_train_step(
        loss_fn, opt_cfg, sched, profile,
        StepConfig(grad_sync=sync, policy=BERBounded()))
        for sync in EF_SYNCS}
    plane, ef = initial_plane_and_ef(params)
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg),
             "plane": plane, "ef": ef}
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch))

    def make_trainer(sync, state, total_steps):
        return Trainer(step_fns[sync], data,
                       TrainerConfig(total_steps=total_steps, device=dev),
                       state)

    return make_trainer, state


# tiny ef cuda vs cpu. K10 equals its plain version bit for bit, but the
# gradients differ at the float level (cuBLAS and the CPU sum in other
# orders), so where x / scale sits at a .5 boundary a code flips and the
# flip stays in the residual; held as tests/test_torch_ecollectives.py
# holds the port against the reference (measured there: raw gradients
# 2.2e-6 apart by step 3, grad_error 8.2e-5 relative, flips 3.5e-4 of the
# elements).
TINY_EF_TOL = dict(grad=dict(rtol=1e-4, atol=5e-6), grad_error_rtol=5e-4,
                   flip_fraction=1e-3, flip=dict(rtol=1e-4, atol=1e-6))


def recording_ef():
    """Patch `ecollectives.ef_compress_leaf_` to record each leaf's
    (g_hat, new residual) on the host; returns (records, restore)."""
    from repro_torch.core import ecollectives
    orig, records = ecollectives.ef_compress_leaf_, []

    def rec(g, r, *args, **kw):
        g_hat = orig(g, r, *args, **kw)
        records.append((g_hat.to("cpu", copy=True), r.to("cpu", copy=True)))
        return g_hat

    ecollectives.ef_compress_leaf_ = rec
    return records, lambda: setattr(ecollectives, "ef_compress_leaf_", orig)


def block_quantum(c, block: int = 256):
    """Each element's block scale (absmax / 127) of the values c that were
    compressed (top-k keeps a block's largest, so its absmax is c's)."""
    import torch
    flat = c.abs().reshape(-1)
    pad = (-flat.numel()) % block
    am = torch.cat([flat, flat.new_zeros(pad)]).reshape(-1, block).amax(1)
    return (am / 127.0).repeat_interleave(block)[:flat.numel()].reshape(
        c.shape)


def check_ef_records(cpu, gpu, n_leaves: int, level: int) -> dict:
    """Per step and leaf, cuda against cpu: the raw gradient recovered as
    g_hat + r' - r within TINY_EF_TOL["grad"]; g_hat elements apart by more
    than TINY_EF_TOL["flip"] (flipped codes) few, each within what two
    quantizations of the corrected values allow. Returns the worst
    gradient gap and the flips per step."""
    import torch
    tol = TINY_EF_TOL
    worst, flips = 0.0, []
    prev = [(0.0, 0.0)] * n_leaves
    for s in range(len(cpu) // n_leaves):
        nflip = total = 0
        for i in range(n_leaves):
            (hc, rc), (hg, rg) = cpu[s * n_leaves + i], gpu[s * n_leaves + i]
            cc, cg = hc + rc, hg + rg                  # corrected
            gc, gg = cc - prev[i][0], cg - prev[i][1]
            if not torch.allclose(gg, gc, **tol["grad"]):
                raise AssertionError(f"tiny_train_ef step {s} leaf {i}: raw "
                                     f"gradients {(gg - gc).abs().max()} "
                                     f"apart")
            worst = max(worst, (gg - gc).abs().max().item())
            d = (hg - hc).abs()
            flip = d > tol["flip"]["atol"] + tol["flip"]["rtol"] * hc.abs()
            bound = (cg - cc).abs() + (block_quantum(cg)
                                       + block_quantum(cc)) / 2
            if level == 2:                       # kept on one side only
                bound = bound + torch.maximum(cg.abs(), cc.abs())
            if bool((d[flip] > bound[flip] * (1 + 1e-5)).any()):
                raise AssertionError(f"tiny_train_ef step {s} leaf {i}: a "
                                     f"flipped code exceeds its quantum")
            nflip += int(flip.sum())
            total += flip.numel()
            prev[i] = (rc, rg)
        if nflip > tol["flip_fraction"] * total:
            raise AssertionError(f"tiny_train_ef step {s}: {nflip} of "
                                 f"{total} codes flipped")
        flips.append(nflip)
    return dict(raw_grad_max_abs_diff=worst, flipped_codes=flips)


def run_tiny_train_ef() -> dict:
    """Tiny MiniCPM in f32, the same weights on cuda and cpu, 4 scalar
    steps of each ef level with BERBounded through Trainer.run: losses
    (TINY_TRAIN_TOL), grad_error (rtol), comp_level exact, g_hat + r' and
    the flipped codes (`check_ef_records`), params (TINY_TRAIN_TOL); K10
    launched exactly twice per leaf per step on cuda."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("minicpm_2b", tiny=True),
                              dtype="float32")
    params = registry.build(cfg).init(
        torch.Generator(device="cpu").manual_seed(0))
    n_leaves, steps = len(list(tree_leaves(params))), 4
    out = {}
    for level, sync in ((1, "ef_int8"), (2, "ef_int8_topk")):
        runs, records = {}, {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda a: a.to(dev, copy=True), params)
            make, state = ef_slice(cfg, p, dev, batch=2, seq=32, steps=steps)
            records[dev], restore = recording_ef()
            ops.reset_launch_counts()
            trainer = make(sync, state, steps)
            trainer.run()
            restore()
            runs[dev] = (trainer, ops.launch_counts())
        (cpu, _), (gpu, launches) = runs["cpu"], runs["cuda"]
        if launches["quantize_int8"] != 2 * n_leaves * steps:
            raise AssertionError(f"tiny_train_ef {sync}: K10 launched "
                                 f"{launches['quantize_int8']} times")
        rc, rg = cpu.log.records, gpu.log.records
        loss_c = torch.tensor([r.loss for r in rc])
        loss_g = torch.tensor([r.loss for r in rg])
        err_c = torch.tensor([r.grad_error for r in rc])
        err_g = torch.tensor([r.grad_error for r in rg])
        if not torch.allclose(loss_g, loss_c, **TINY_TRAIN_TOL["loss"]):
            raise AssertionError(f"tiny_train_ef {sync} losses {loss_g} "
                                 f"{loss_c}")
        if not (bool((err_g > 0).all()) and torch.allclose(
                err_g, err_c, rtol=TINY_EF_TOL["grad_error_rtol"], atol=0)):
            raise AssertionError(f"tiny_train_ef {sync} grad_error {err_g} "
                                 f"{err_c}")
        if [r.comp_level for r in rg] != [r.comp_level for r in rc]:
            raise AssertionError(f"tiny_train_ef {sync}: comp_level differs")
        params_diff = 0.0
        for a, b in zip(tree_leaves(cpu.state["params"]),
                        tree_leaves(gpu.state["params"])):
            b = b.detach().cpu()
            if not torch.allclose(b, a.detach(), **TINY_TRAIN_TOL["params"]):
                raise AssertionError(f"tiny_train_ef {sync}: params "
                                     f"{(b - a).abs().max().item()} apart")
            params_diff = max(params_diff, (b - a).abs().max().item())
        out[sync] = dict(
            losses_cuda=loss_g.tolist(), grad_error_cuda=err_g.tolist(),
            grad_error_max_rel_diff=((err_g - err_c).abs() / err_c).max()
            .item(), comp_level=[r.comp_level for r in rg],
            params_max_abs_diff=params_diff, k10_launches=
            launches["quantize_int8"],
            **check_ef_records(records["cpu"], records["cuda"], n_leaves,
                               level))
    out["tolerances"] = dict(TINY_EF_TOL, loss=TINY_TRAIN_TOL["loss"],
                             params=TINY_TRAIN_TOL["params"])
    return out


def run_main_train_ef(dev) -> dict:
    """Full-width, full-depth MiniCPM-2B in bf16 through Trainer.run with
    the error-feedback gradient sync and BERBounded: one warm-up step, then
    TRAIN["steps"] checked steps of each of `ef_int8`, `ef_int8_topk` and
    `auto` on the same state (the last measures the compression's cost in
    the same run), exact launch counts (K10 twice per leaf per step), then
    a torch.profiler window of TRAIN["profiled_steps"] `ef_int8` steps
    with K10's device time beside its bound."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves
    cfg = get_config(TRAIN["arch"])
    B, T, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    t0 = time.perf_counter()
    params = registry.build(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    sizes = [a.numel() for a in tree_leaves(params)]
    n_params, n_leaves = sum(sizes), len(sizes)
    make, state = ef_slice(cfg, params, dev, batch=B, seq=T,
                           steps=len(EF_SYNCS) * steps)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    warm = make("ef_int8", state, 1)
    warm.run()
    state = warm.state
    del warm
    L, tokens = cfg.n_layers, B * T
    runs, by_sync = {}, {}
    for sync in EF_SYNCS:
        trainer = make(sync, state, steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        trainer.run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        want = {name: 0 for name in ops.KERNELS}
        want.update({"flash_attention_fwd": 2 * L * steps,
                     "flash_attention_bwd_dq": L * steps,
                     "flash_attention_bwd_dkv": L * steps,
                     "quantize_int8": 0 if sync == "auto"
                     else 2 * n_leaves * steps})
        if launches != want:
            raise AssertionError(f"train-ef {sync} launch counts {launches} "
                                 f"!= {want}")
        recs = trainer.log.records
        losses = [r.loss for r in recs]
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train-ef {sync} losses {losses}")
        errs = [r.grad_error for r in recs]
        if sync != "auto" and not all(e > 0 for e in errs):
            raise AssertionError(f"train-ef {sync} grad_error {errs}")
        step_s = statistics.median(trainer.step_times)
        state = trainer.state
        by_sync[sync] = launches
        runs[sync] = dict(
            step_ms_median=step_s * 1e3,
            step_ms=[x * 1e3 for x in trainer.step_times],
            tokens_per_s=tokens / step_s,
            mfu=6.0 * n_params * tokens / step_s / PEAK_FLOPS["bfloat16"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            losses=losses, grad_error=errs, comp_level=recs[-1].comp_level,
            v_io=state["plane"].v_io.item(), launches=launches)
        del trainer
    k10_bytes = sum(2 * codec_bytes(n, 4) for n in sizes)
    k10_bound = bound_ms(k10_bytes, sum(2 * 4 * n for n in sizes),
                         "float32")
    profile = train_breakdown(lambda st, n: make("ef_int8", st, n), state,
                              TRAIN["profiled_steps"],
                              watch=("quantize_int8", *TRAIN_ATTENTION))
    launches = {name: sum(c[name] for c in by_sync.values())
                for name in ops.KERNELS}
    return dict(
        arch=cfg.name, n_layers=L, params=n_params, leaves=n_leaves,
        batch=B, seq=T, dtype=cfg.dtype, remat="full",
        adamw_state="float32", policy="ber-bounded", init_s=init_s,
        steps=steps, runs=runs,
        ef_int8_over_auto_ms=runs["ef_int8"]["step_ms_median"]
        - runs["auto"]["step_ms_median"],
        ef_int8_topk_over_auto_ms=runs["ef_int8_topk"]["step_ms_median"]
        - runs["auto"]["step_ms_median"],
        k10_bound_ms_per_step=k10_bound[0], k10_bound_by=k10_bound[1],
        launches=launches, profile=profile)


def sm90_hgmma(lib: Path) -> dict:
    """The tensor-core instructions (`HGMMA`, Hopper's wgmma) in each
    instantiation of the sm90 attention kernels (K2's forward, K4's dq,
    K5's dk/dv, at head_dim 64 and 128), read from the built library's
    SASS; raises if an instantiation is missing or has none."""
    import re
    import shutil
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        hit = re.search(rf"({'|'.join(TRAIN_ATTENTION)})ILi(\d+)E", name)
        if hit:
            counts[f"{hit.group(1)}<{hit.group(2)}>"] = fn.count("HGMMA")
    want = {f"{kernel}<{dh}>" for kernel in TRAIN_ATTENTION
            for dh in (64, 128)}
    if set(counts) != want or not all(counts.values()):
        raise AssertionError(f"the sm90 kernels lack HGMMA: {counts}")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's card checks need one",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch next to this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()

    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    lib = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)), "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "sm90_hgmma": sm90_hgmma(lib)})
    _build.load()
    print(lib.with_name(lib.name + ".ptxas.txt").read_text(),
          file=sys.stderr)

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    kernels = {}
    checks = (check_sor_fit, check_sor_accumulate, check_flash, check_decode,
              check_flash_bwd, check_fleet_reduce, check_rwkv6_scan,
              check_mamba2_ssd, check_quantize_int8)
    for check in checks:
        rows = check(dev, flush)
        for row in rows if isinstance(rows, list) else [rows]:
            kernels[row["name"]] = row
            emit({"phase": "kernels", **row})
    del flush

    by_path = {}
    emit({"phase": "tiny", **run_tiny(MAIN["arch"])})
    emit({"phase": "tiny_host", **run_tiny_host()})
    cfg, params, init_s = init_main(dev, MAIN)
    result = run_main(dev, MAIN, cfg, params, init_s)
    by_path["serve-qwen"] = result["launches"]
    emit({"phase": "main", **result})
    result = run_main_host(dev, MAIN, cfg, params)
    by_path["serve-qwen-host"] = result["launches"]
    emit({"phase": "main_host", **result})
    del result, params
    torch.cuda.empty_cache()       # the Qwen2.5 weights are gone

    for tiny, phase, path, spec in (
            ("tiny_rwkv", "main_rwkv", "serve-rwkv", RWKV),
            ("tiny_zamba", "main_zamba", "serve-zamba", ZAMBA)):
        emit({"phase": tiny, **run_tiny(spec["arch"])})
        cfg, params, init_s = init_main(dev, spec)
        result = run_main(dev, spec, cfg, params, init_s)
        by_path[path] = result["launches"]
        emit({"phase": phase, **result})
        del result, params
        torch.cuda.empty_cache()   # the model's weights are gone

    emit({"phase": "tiny_train", **run_tiny_train()})
    emit({"phase": "tiny_train_host", **run_tiny_train_host()})
    result = run_main_train(dev)
    by_path["train"] = result["launches"]
    emit({"phase": "main_train", **result})
    del result
    gc.collect()
    torch.cuda.empty_cache()       # main_train's MiniCPM state is gone

    emit({"phase": "tiny_train_ef", **run_tiny_train_ef()})
    result = run_main_train_ef(dev)
    by_path["train-ef"] = result["launches"]
    emit({"phase": "main_train_ef", **result})
    del result

    rows = []
    for name in ops.KERNELS:
        row = dict(kernels[name])
        row.pop("shape")
        row["launches"] = sum(counts[name] for counts in by_path.values())
        row["launches_by_path"] = {path: counts[name]
                                   for path, counts in by_path.items()}
        rows.append(row)
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
