#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold every CUDA kernel
against its plain PyTorch version.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line; any failure raises and the
script exits nonzero:

1. build    - compile every kernel from `src/repro_torch/kernels/csrc/` for
              sm_90a (seconds taken, the ptxas report in the build dir);
2. kernels  - each kernel's wrapper at the serve path's shapes against its
              plain version (stated tolerances), timed beside its bound, the
              plain version and one PyTorch call as a yardstick;
3. tiny     - tiny Qwen2.5 in f32 from one seed on cuda and on cpu through
              `ServeEngine.generate` with the slice's controller: equal
              tokens, plane and SOR estimate allclose;
4. main     - full-width, full-depth Qwen2.5-14B in bf16 (random weights
              from a seed), batch 4, prompt 256, 32 new tokens, 64-chip
              fleet and the learned rail-control round; launch counts of
              every kernel must be exactly what the path implies; then the
              breakdown of a decode step, read through `generate` (with
              and without the control round, device busy share and top
              kernels from torch.profiler).

Then the `{"kernels": [...]}` line, the card's name and power limit, and the
final `{"ok": true, ...}` line. Exits nonzero without printing a result when
no CUDA device is present.
"""

from __future__ import annotations

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

# the serve path driven on the card: full width and depth
MAIN = dict(arch="qwen2p5_14b", batch=4, prompt=256, new=32, chips=64)


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

def check_flash(dev, flush) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, Dh = 4, 48, 16, 128
    group = Hq // Hkv
    gen = torch.Generator(device=dev).manual_seed(11)
    err = 0.0
    for T in (256, 200):    # the main path's prompt, and a ragged T
        q, k, v = (torch.randn((B, T, h, Dh), generator=gen, device=dev,
                               dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv))
        o, lse = fa.flash_attention(q, k, v, causal=True, group=group)
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=True,
                                                  group=group)
        torch.cuda.synchronize()
        d = (o.float() - o_ref.float()).abs().max().item()
        d_lse = (lse - lse_ref).abs().max().item()
        # bf16 output against the f32 plain version rounded to bf16
        if not (math.isfinite(d) and d <= 2e-2 and d_lse <= 1e-3):
            raise AssertionError(f"flash_attention T={T}: max|o-o_ref|={d}, "
                                 f"max|lse-lse_ref|={d_lse}")
        err = max(err, d)
    T = 256
    q, k, v = (torch.randn((B, T, h, Dh), generator=gen, device=dev,
                           dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv))
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                            group=group), 20, flush)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=True, group=group), 5, flush)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20, flush)
    n_bytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * B * Hq * T
    pairs = B * Hq * T * (T + 1) // 2            # causal: keys <= row
    b_ms, b_by = bound_ms(n_bytes, 4 * Dh * pairs, "bfloat16")
    return dict(name="flash_attention_fwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:92",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=dict(B=B, T=T, Hq=Hq, Hkv=Hkv, Dh=Dh, dtype="bf16",
                           ragged_T=200))


def check_decode(dev, flush) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    B, S, Hq, Hkv, Dh = 4, MAIN["prompt"] + MAIN["new"] + 8, 48, 16, 128
    group = Hq // Hkv
    gen = torch.Generator(device=dev).manual_seed(12)
    q = torch.randn((B, 1, Hq, Dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, Dh), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([1, S // 3, 257, S], dtype=torch.int32,
                           device=dev)
    o = da.decode_attention(q, k, v, lengths, group=group)
    o_ref = da.decode_attention_plain(q, k, v, lengths, group=group)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    if not (math.isfinite(err) and err <= 2e-2):
        raise AssertionError(f"decode_attention: max|o-o_ref|={err}")
    ms = time_ms(lambda: da.decode_attention(q, k, v, lengths, group=group),
                 100, flush)
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
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:60",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=dict(B=B, S=S, Hq=Hq, Hkv=Hkv, Dh=Dh, dtype="bf16",
                           lengths=lengths.tolist()))


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


# ---------------------------------------------------------------------------
# phases 3-4: the serve path through ServeEngine.generate
# ---------------------------------------------------------------------------

def slice_engine(cfg, params, *, batch: int, prompt: int, new: int,
                 chips: int, device, control: bool = True):
    """The slice's serve configuration: a `chips`-chip fleet, the learned
    three-rail control round (refit every 4 rounds; left out with
    `control=False`, accounting only), and the launcher's roofline
    profiles."""
    from repro_torch.core.control_plane import InGraphRailController
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.core.policy import MultiRailClosedLoop
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.core.sor import SorConfig
    from repro_torch.core.telemetry import ALL_RAIL_OBSERVABLES
    from repro_torch.models.lm import tree_leaves
    from repro_torch.serve.engine import ServeEngine
    n = sum(a.numel() for a in tree_leaves(params))
    return ServeEngine(
        cfg, params, max_len=prompt + new + 8, batch_size=batch,
        fleet=FleetSpec.sample(chips, seed=0),
        controller=InGraphRailController(
            MultiRailClosedLoop(),
            sor=SorConfig(ingest="frames", rails=ALL_RAIL_OBSERVABLES,
                          refresh_every=4)) if control else None,
        prefill_profile=StepProfile(2.0 * n * batch * prompt, 2.0 * n, 0.0),
        decode_profile=StepProfile(2.0 * n * batch, 2.0 * n, 0.0),
        device=device)


def run_tiny() -> dict:
    """Tiny Qwen2.5 (plain TINY and the padded-GQA variant: 12 q / 4 kv
    heads, group 3, zero pad slots) in f32, the same weights on cuda and
    cpu: tokens equal, plane and SOR estimate allclose."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_map
    tiny = dataclasses.replace(get_config("qwen2p5_14b", tiny=True),
                               dtype="float32")
    variants = {"tiny": tiny,
                "tiny_gqa_pad": dataclasses.replace(
                    tiny, n_heads=10, n_kv_heads=2, head_dim=32, tp=4)}
    B, Tp, new, chips = 2, 16, 12, 8
    out = {}
    for name, cfg in variants.items():
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
                         plane_max_abs_diff=worst,
                         heads=[cfg.head_plan().n_q_pad,
                                cfg.head_plan().n_kv_pad,
                                cfg.head_plan().group])
    return out


def run_main(dev) -> dict:
    """Full-width, full-depth Qwen2.5-14B through ServeEngine.generate with
    the 64-chip fleet and the learned control round; the launch counts of
    this run alone are checked exactly. The breakdown of a decode step
    (`decode_breakdown`) follows the checked run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves
    cfg = get_config(MAIN["arch"])
    B, Tp, new, chips = MAIN["batch"], MAIN["prompt"], MAIN["new"], \
        MAIN["chips"]
    t0 = time.perf_counter()
    params = registry.build(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(a.numel() for a in tree_leaves(params))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, Tp)).astype(np.int32)

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

    want = {"flash_attention_fwd": cfg.n_layers,
            "decode_attention": cfg.n_layers * (new - 1),
            "sor_fit": new // 4}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
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
    return dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
                batch=B, prompt=Tp, new_tokens=new, n_chips=chips,
                dtype=cfg.dtype, init_s=init_s, generate_s=total_s,
                prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_s * 1e3,
                tokens_per_s=B * new / total_s,
                decode_tokens_per_s=B / decode_s,
                peak_mem_gb=peak_gb, launches=launches,
                expected_launches=want, summary=summary,
                first_tokens=tokens[:, :8].tolist(), profile=profile)


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
          "torch": torch.__version__, "cuda": torch.version.cuda})
    _build.load()
    print(lib.with_name(lib.name + ".ptxas.txt").read_text(),
          file=sys.stderr)

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    kernels = {}
    for check in (check_sor_fit, check_flash, check_decode):
        row = check(dev, flush)
        kernels[row["name"]] = row
        emit({"phase": "kernels", **row})
    del flush

    emit({"phase": "tiny", **run_tiny()})

    result = run_main(dev)
    launches = result["launches"]
    emit({"phase": "main", **result})

    rows = []
    for name in ops.KERNELS:
        row = dict(kernels[name])
        row.pop("shape")
        row["launches"] = launches[name]
        rows.append(row)
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
