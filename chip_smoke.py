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
                path for K1 alone and for its fused refit on the history
                ring at every ring state of the CPU tests, 3 x 64 and
                3 x 1024 and 3 x 4096 lanes (the routed fleets), beside the
                composed sequence it replaced
                and the harness's floor; the host path for K7, also at
                windows 7 to 64; the Qwen2.5, Granite, Zamba2 and serve
                example's paths for K2 and K3, the training paths
                (MiniCPM-2B's, the train example's) for K2 and K4-K6 (K2
                also in f32 at the Qwen prefill; K6 also as
                `fleet_stats`, the fleet step's reduction tail in one
                launch, at 1 to 20000 chips with ties at the p95's ranks
                and NaN lanes, beside the composed sequence it replaced
                and the harness's floor), the
                RWKV6 serve path for K9, the Zamba2 serve path for K8 (each
                also at T around its 64-step chunk, and its decode step in
                place, beside its bytes and operations bounds), the
                ef training path's parameter leaves for K10 alone and for
                its fused ef pass at both levels, the fused pass also at
                the train example's leaves) against its plain version
                (stated tolerances; K10 and the fused pass bit for bit, the
                fused pass's two sums to EF_SUM_RTOL), timed
                beside its bound, the plain version and one PyTorch call as
                a yardstick where one exists; K7 followed by the plain
                solve also against K1; K2 also at Zamba2's heads with a
                4608-token prompt past its 4096 window; K3 also at the
                serve paths' uniform lengths of the first and the last
                decode step and at Zamba2's full 4096-key window, with its
                wrapper's host us a call; K8 and K9 also as the training
                paths' differentiable calls at batch 4 x 256 (their
                gradients bit for bit those of autograd through the plain
                version on the card, one launch a forward and none a
                backward, the backward's span and device time); K2, K4
                and K5 also at Zamba2's shared-block training shape and
                InternVL2-2B's (16/16 x 128, T 512), and without the
                causal mask at Whisper-base's encoder (T = S = 1500) and
                cross attention (T 256 over S 1500); K2 and K3 also at
                Qwen3-30B-A3B's serve path; K3 also at Whisper-base's
                cross attention at decode (S 1500, every slot valid);
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
7. tiny_routed - routed serving (`ServeEngine.serve_trace`) cuda against
                cpu on the routed world of tests/test_torch_serve_trace.py
                (16 chips; 8 for the half-pinned migration world and the
                host controller): the ledger equal on every discrete field
                where the CPU tests hold the port to the reference exactly,
                energies and rails within ROUTED_RTOL, exact launches (K1's
                refit, K7 on the host path); the headroom router in the
                learned world: both finish, the SLO summary within
                ROUTED_SUMMARY_REL, the first split reported, one tick from
                the same state through both devices' tick functions, and the
                fused ledger equal to the loop ledger on each device;
7a. tiny_sharded - rank processes of this script (`--shard-rank`,
                started together and joined by a deadline; a rank that
                fails fails the phase): an NCCL world of one, where the
                forced sharded paths (shard_control=True on a one-rank
                chips mesh) equal the unsharded fleet step, routed run and
                K6 reduce bit for bit; and a gloo world of 2 sharing the
                card, each rank's block cuda against its cpu run
                (TINY_SHARD_RTOL, ROUTED_RTOL), against the unsharded cuda
                run's slice bit for bit, and the ef collectives over the
                bound data axis cuda against cpu bit for bit;
8. main_routed - the routed world at 1024 chips (serve_scale's weak-scaled
                trace, unbatched; serve_batching's forced-pin trace weak-
                scaled, batch_cap 4 with the decode profile, draining and
                with migrate_after_ticks 6) and at 4096 chips (unbatched),
                fused: ticks, ticks/s, us a tick and chip, the SLO summary,
                peak memory, K1's refit launches exactly (48 + ticks) // 4,
                one tick's kernels, copies and syncs with and without a
                refit; the host controller's loop path at 64 chips (K7
                exactly); `launch/serve.py --arch qwen2p5_14b --fleet-chips
                1024 --router headroom --batch-cap 4` at full width;
8a. main_sharded_routed - main_routed's 4096-chip world (its trace,
                seed and headroom router) over 4 gloo ranks of 1024 chips
                sharing the card: every ledger field and energy, and each
                rank's plane and SOR state against the unsharded run's
                slice, bit for bit; K1's refit (48 + ticks) // 4 a rank;
                ticks/s and one tick's kernels, copies and syncs a rank
                (`lockstep_activity`);
9. tiny_granite - tiny Granite (dense, one KV head: 4 q heads, group 4,
                head_dim 32) as phase 3;
10. main_granite - full-width, full-depth Granite-20B (52 layers, d_model
                6144, 48 q heads over the one KV head duplicated to 16 by
                the tp=16 plan, head_dim 128, vocab 49152; 29.39 B
                parameters, 58.8 GB in bf16) as phase 5, once the Qwen2.5
                weights are freed (at most RESIDENT_GB_MAX still allocated
                before its weights are made; peak under CARD_GB), with its
                exact launch counts (K2 52, K3 52 x 31, K1's refit 8) and
                decode-step breakdown beside the weights' byte floor;
10a. tiny_qwen3moe - tiny Qwen3-MoE (`run_tiny_family`): phase 3's
                generate, the experts of every token's slots layer by
                layer equal cuda against cpu where the top-(k+1) gap
                passes NEAR_TIE, and one fleet SOR train step as phase 16;
10b. main_qwen3moe - full-width, full-depth Qwen3-30B-A3B (48 layers,
                d_model 2048, 128 experts top-8 of ff 768, 32 q over the
                4 KV heads duplicated to 16, head_dim 128; 30.83 B
                parameters, 61.7 GB in bf16) as phase 10, once Granite's
                weights are freed: K2 48, K3 48 x 31, K1's refit 8; its
                decode reads every expert (cap 1 a decode slot);
11. tiny_rwkv  - tiny RWKV6 (the ssm family) as phase 3;
12. main_rwkv  - full-width, full-depth RWKV6-7B (32 layers, d_model 4096,
                64 heads x 64, d_ff 14336, vocab 65536) as phase 5, with its
                own exact launch counts (K9 32 per prefill and per decoded
                token) and decode-step breakdown (K9's device ms and the
                copy kernels a step: the wkv state is written in place);
13. tiny_zamba - tiny Zamba2 (the hybrid family) as phase 3, plain and with
                an 8-token sliding window that the shared block's KV cache
                wraps;
14. main_zamba - full-width, full-depth Zamba2-1.2B (38 Mamba2 layers,
                d_model 2048, 64 SSD heads x 64, state 64; the shared
                attention + MLP block after every 6th layer, 32/32 heads
                x 64, window 4096) as phase 5, with its own exact launch
                counts (K8 38 per prefill and per decoded token, K2 6 per
                prefill, K3 6 per decoded token after the first) and
                decode-step breakdown (K8's device ms and the copy kernels
                a step: the ssm state is written in place);
15. examples   - the reference's examples (`repro_torch.examples.*`, each
                `main(argv)` in this process) on the card at their own
                defaults: `case_study_transceiver` and `quickstart` print
                what their cpu runs print (the model's Fig 16 reductions
                within PAPER_SAVINGS_ABS of the paper's 28.4 % and 29.3 %;
                quickstart's achieved VDD_IO and transaction count);
                `serve_decode` deterministic with exact launches (K2, K3);
                `train_voltune_lm` (300 steps, ef_int8, injected failures
                and stragglers, checkpoints under `build/`) with a finite,
                falling loss, its printed restarts and checkpoints its
                trainer's, and exact launches (K2, K4, K5, K10's fused ef
                pass);
16. tiny_train - tiny MiniCPM in f32 from one seed on cuda and on cpu, three
                fleet SOR train steps through `Trainer.run`: losses, params,
                plane and SOR estimate allclose;
17. tiny_train_host - tiny MiniCPM in f32, four scalar steps through
                `Trainer.run` with a `HostRailController(PhaseAware())`
                between steps, cuda against cpu: losses allclose, host
                actuations and their bus seconds equal;
18. tiny_train_ckpt - tiny MiniCPM in bf16, three fleet SOR steps on cuda
                through `Trainer.run` with a checkpoint after the last:
                restored by the port on the cpu and by a fresh cuda
                `Trainer` (`maybe_restore`, its state from seed 1), every
                leaf bit for bit the cuda state's;
19. main_train - full-width, full-depth MiniCPM-2B in bf16 (random weights
                from a seed), batch 4 x seq 512, per-layer remat, AdamW,
                the launcher's WSD schedule, a 64-chip fleet with in-graph
                SOR learning, through `Trainer.run`: one warm-up step, then
                8 steps whose launch counts must be exact; step time, data
                time, tokens/s, MFU, peak memory, losses, the learned-region
                summary, and a torch.profiler window of 2 steps (the
                device ms per step of K2, K4 and K5 beside the top
                kernels);
20. tiny_train_ef - tiny MiniCPM in f32 from one seed on cuda and on cpu,
                four scalar steps of each error-feedback level (`ef_int8`,
                `ef_int8_topk`) with BERBounded through `Trainer.run`:
                losses, grad_error, comp_level, the compressed gradient
                and residual (g_hat + r', flipped codes) and params; the
                fused ef pass exactly once per leaf per step, K10 alone
                never;
21. main_train_ef - full-width, full-depth MiniCPM-2B in bf16 as phase 19,
                the scalar step with the ef gradient sync and BERBounded:
                one warm-up step, then 4 steps each of `ef_int8`,
                `ef_int8_topk` and `auto` on the same state, launch counts
                exact (the fused ef pass 12 per ef step, K10 alone 0), step
                times, tokens/s, MFU, peak
                memory, losses, grad_error, comp_level and v_io; a
                torch.profiler window of 2 `ef_int8` steps with the fused
                ef pass's device ms beside its bound, and K2's, K4's and
                K5's;
21a. main_train_dp - MiniCPM-2B at full width, 4 of its 40 layers (bf16,
                random weights from seed 0), over 4 data-parallel gloo
                ranks sharing the card (TRAIN_DP: one 512-token row a rank,
                the 64-chip fleet 16 chips a rank, shard_control, the ef
                int8 sync with BERBounded): params equal across the ranks
                after every step, exact launches a rank, then a
                one-process oracle of the same four-rank sequence on the
                card (rank 0's params bit for bit, the loss within
                DP_LOSS_RTOL); step ms, gathered bytes and seconds, peak
                GB a rank;
22. tiny_train_zamba - tiny Zamba2 in f32 from one seed, cuda against cpu:
                one `forward_train` gradient (on the card K8's and K2's
                forward, the plain scan's and K4/K5's backward; every
                leaf within TINY_GRAD_TOL, launches exact), then three
                fleet SOR steps through `Trainer.run` as phase 16, at a
                sequence of 80 tokens (past the shared block's 64-token
                window and K8's 64-step chunk);
23. main_train_zamba - full-width, full-depth Zamba2-1.2B in bf16, batch 4
                x seq 256, per-layer remat (a Mamba2 layer and the shared
                block after it under one checkpoint), f32 AdamW moments,
                the 64-chip fleet with in-graph SOR: one warm-up step,
                then 2 steps whose launch counts must be exact (K8 2 x
                38 a step: the forward and the remat recompute; K2 2 x
                6; K4, K5 6; `fleet_stats` 1; `sor_refit` on cadence),
                step time, tokens/s, MFU, peak memory (under 80 GB),
                losses; then one step split by CUDA events into K8's
                forward, the scan's backward (the plain version re-run
                and walked back, as the reference's custom_vjp does), K2,
                the flash backward and the rest;
24. tiny_train_rwkv - tiny RWKV6 as phase 22 (K9);
25. main_train_rwkv - full-width, full-depth RWKV6-7B as phase 23 (K9 2 x
                32 a step), with the reference's int8 AdamW moments: f32
                ones need ~91 GB beside the bf16 weights;
25a. tiny_grok1, tiny_mistral - tiny Grok-1 (moe) and tiny Mistral-Large
                (dense, head_dim 16, its train step under
                remat="group") as phase 10a;
25b. main_train_moe - Qwen3-30B-A3B at full width, its depth cut to 4
                layers (3.15 B parameters, f32 AdamW moments), under the
                two-level group remat (one group of 4), as phase 23: K2
                2 x 4 a step (forward and the group's recompute), K4, K5
                4; a positive load-balance loss each step; one step in a
                guarded profile window;
25c. tiny_internvl, main_train_internvl - tiny InternVL2 as phase 10a
                (its train batches carry the stub image embeddings), then
                full-width, full-depth InternVL2-2B (2.00 B) as phase
                25b: 256 stub image tokens ahead of 256 text tokens a
                row, per-layer remat, f32 moments;
25d. tiny_whisper, main_whisper - tiny Whisper cuda against cpu (encoder
                states and cross K/V allclose, 8 greedy decode steps with
                equal tokens, exact launches; one train step), then
                full-width, full-depth Whisper-base (185.4 M) trained as
                phase 25b (batch 4, 1500 stub frames, 256 tokens; K2, K4,
                K5 18 a step: 6 encoder layers non-causal, 6 decoder
                self, 6 cross at T != S) and served from the trained
                weights: encode, the cross K/V and 32 greedy decode steps
                through `registry.build(cfg).decode_fn`, twice, with
                equal tokens (K2 6 and K3 12 a step exactly);
26. main_train_ckpt - Zamba2-1.2B as phase 23 trains it, its depth cut to
                6 of 38 layers (for the script's time), from a fresh
                state through `Trainer.run` with async checkpoints every 2
                steps and after step 4 and one injected node failure
                before step 3 (steps 0, 1, the save, 2, the failure, the
                restore of step_2, 2 and 3 again, the save): the restored
                state equal to the saved one (a digest of every leaf taken
                on the card at the save and after the restore), the re-run
                of step 2 equal to its first run (loss, plane and whole
                state bits), restarts 1, writes 2, launches exact for 5
                steps, peak memory within 1 GB of its own before the first
                save; the
                checkpoint's bytes, the save's host-blocking snapshot and
                background write, the restore, free disk and host memory
                (MiniCPM-2B's 46 GB checkpoints, two at once, do not fit
                the card machine's 80 GB of disk).

Each model's weights are freed before the next model loads its own. Each
phase line carries `elapsed_s`, the seconds since the script started.
Then the `{"kernels": [...]}` line (launches summed over the main paths'
checked runs, and by path), the card's name and power limit, and the
final `{"ok": true, ...}` line. Exits nonzero without printing a result when no
CUDA device is present.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12           # HBM3, H100 SXM data sheet
CARD_GB = 80.0                       # the H100's device memory
# what a main serve path may find still allocated before it makes its
# weights: the previous model's are freed (Granite-20B's 58.8 GB do not
# fit beside Qwen2.5-14B's 31.6)
RESIDENT_GB_MAX = 1.0
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core rate
              "float32": 67e12}       # non-tensor-core f32 rate

# the serve paths driven on the card: full width; Qwen2.5-14B at full
# depth, the others cut to half their depth for the script's time
# (Granite-20B 26 of 52 layers, RWKV6-7B 16 of 32, Zamba2-1.2B 18 of 38:
# three shared-block occurrences, attn_every 6)
MAIN = dict(arch="qwen2p5_14b", batch=4, prompt=256, new=32, chips=64)
GRANITE = dict(arch="granite_20b", n_layers=26, batch=4, prompt=256, new=32,
               chips=64)
RWKV = dict(arch="rwkv6_7b", n_layers=16, batch=4, prompt=256, new=32,
            chips=64)
ZAMBA = dict(arch="zamba2_1p2b", n_layers=18, batch=4, prompt=256, new=32,
             chips=64)
# the training path driven on the card: full width, cut to 20 of its 40
# layers for the script's time
TRAIN = dict(arch="minicpm_2b", n_layers=20, batch=4, seq=512, chips=64,
             steps=8, profiled_steps=2, ef_steps=4, ef_layers=8)
# (`main_train_ef` runs ef_steps of each sync, cut from 8, at ef_layers of
# the 40 layers, for the script's time: the ef sync's leaves keep their
# full width, the stacked ones hold 8 layers)
# the hybrid and ssm families' training paths: full width, the serve
# paths' traffic (4 x 256 tokens), one warm-up step and `steps` steps with
# exact launch counts, then one step split by CUDA events. Their depth is
# cut for the script's time (a step is nearly all the plain scans'
# backward, a layer at a time): Zamba2-1.2B to 12 of its 38 layers (two
# shared-block occurrences, attn_every 6), RWKV6-7B to 8 of 32. RWKV6-7B's
# f32 AdamW moments would need ~91 GB at full depth with the bf16 weights
# (12 B a parameter): its moments are the reference's int8 ones
TRAIN_ZAMBA = dict(arch="zamba2_1p2b", n_layers=12, batch=4, seq=256,
                   chips=64, steps=2, adamw_state="float32")
TRAIN_RWKV = dict(arch="rwkv6_7b", n_layers=8, batch=4, seq=256, chips=64,
                  steps=2, adamw_state="int8")
# the moe family served at full width: Qwen3-30B-A3B (30.83 B parameters,
# ~61.7 GB in bf16 at its 48 layers), cut to 24 layers for the script's
# time, made after Granite-20B's weights are freed
QWEN3MOE = dict(arch="qwen3_moe_30b_a3b", n_layers=24, batch=4, prompt=256,
                new=32, chips=64)
# the moe family trained: Qwen3-30B-A3B at full width, its depth cut to 4
# layers (3.15 B parameters: ~38 GB with f32 AdamW moments; the 48 layers'
# ~61.7 GB of bf16 weights leave no room for gradients and moments), under
# the two-level group remat (one group of 4)
TRAIN_MOE = dict(arch="qwen3_moe_30b_a3b", n_layers=4, batch=4, seq=256,
                 chips=64, steps=2, adamw_state="float32", remat="group")
# the vlm family trained at full width and depth: InternVL2-2B, 256 stub
# image tokens ahead of 256 text tokens a row
TRAIN_INTERNVL = dict(arch="internvl2_2b", batch=4, seq=256, chips=64,
                      steps=2, adamw_state="float32", remat="full")
# the encdec family at full width and depth: Whisper-base trained (1500
# stub frames a row, 256 decoder tokens; the family keeps its activations,
# as the reference's does), then served: encode, the cross K/V, `new`
# greedy decode steps
WHISPER = dict(arch="whisper_base", batch=4, seq=256, chips=64, steps=2,
               adamw_state="float32", remat="none", new=32)
# the tiny configurations of the families this slice added, each cuda
# against cpu (`run_tiny_family`), by phase
TINY_FAMILIES = {"tiny_qwen3moe": "qwen3_moe_30b_a3b",
                 "tiny_grok1": "grok1_314b",
                 "tiny_mistral": "mistral_large_123b",
                 "tiny_internvl": "internvl2_2b",
                 "tiny_whisper": "whisper_base"}
# the bf16 attention kernels of the training path (K2, K4, K5), by name
TRAIN_ATTENTION = ("flash_fwd_sm90", "flash_bwd_dq_sm90",
                   "flash_bwd_dkv_sm90")
# K3's kernel, by name, in the decode-step profiles
DECODE_ATTENTION = "decode_split_kernel"
# K8's and K9's kernels (chunked prefill, decode step), and the copy
# kernels, by name, in the decode-step profiles
SCAN_KERNELS = ("ssd_chunk", "ssd_decode", "wkv_chunk", "wkv_decode")
COPY_KERNELS = ("copy", "Memcpy")


# the script's start on the host clock: each phase line carries the
# seconds since (`elapsed_s`), so where the time limit goes reads off them
STARTED = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - STARTED)
    print(json.dumps(obj, default=lambda o: o.tolist()
                     if hasattr(o, "tolist") else str(o)), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush=None, *, setup=None) -> float:
    """Mean device time of one call: CUDA events around each call, the
    stream held by a device-side sleep while the host enqueues them all, so
    the events time the device work and not Python's launch overhead.
    `flush` (a >50 MB buffer) is overwritten before each call so the L2
    starts cold, as it does on the serve path between layers. `setup`, if
    given, runs before each call (and before the flush), outside the timed
    region: it restores the inputs of a call that updates them in place."""
    import torch
    for _ in range(3):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(int(2e6) * iters)      # ~1 ms of device time per call
    for s, e in zip(starts, ends):
        if setup is not None:
            setup()
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

def attention_serve_paths() -> dict:
    """{path: (configuration, spec)} of each serve path that runs K2 and
    K3: the dense, moe and hybrid main paths and the serve example (its
    `batch`, `prompt` and `new`)."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_decode
    out = {path: (get_config(spec["arch"]), spec) for path, spec in (
        ("serve-qwen", MAIN), ("serve-granite", GRANITE),
        ("serve-qwen3moe", QWEN3MOE), ("serve-zamba", ZAMBA))}
    out["example-serve"] = (serve_decode.CONFIG, dict(
        batch=serve_decode.BATCH, prompt=serve_decode.PROMPT,
        new=serve_decode.NEW))
    return out


def example_train_config():
    """The train example's configuration and arguments at its defaults."""
    from repro_torch.examples import train_voltune_lm
    args = train_voltune_lm.parser().parse_args([])
    return train_voltune_lm.model_config(args), args


def attn_paths() -> dict:
    """The attention shapes of each serve path that runs K2 and K3, from
    its configuration: (batch, padded q heads, padded kv heads, head_dim,
    sliding window, prompt, KV-cache length)."""
    out = {}
    for path, (cfg, spec) in attention_serve_paths().items():
        plan = cfg.head_plan()
        max_len = spec["prompt"] + spec["new"] + 8     # as `slice_engine`
        out[path] = (spec["batch"], plan.n_q_pad, plan.n_kv_pad,
                     cfg.head_dim_, cfg.sliding_window, spec["prompt"],
                     min(max_len, cfg.sliding_window or max_len))
    return out


def flash_paths() -> dict:
    """K2's shapes: each serve path's prefill (`attn_paths`) and the
    training paths' forward (MiniCPM-2B's; Zamba2-1.2B's shared block,
    the same shape as its serve prefill), (batch, q heads, kv heads,
    head_dim, window, T)."""
    from repro_torch.configs import get_config
    out = {path: spec[:6] for path, spec in attn_paths().items()}
    cfg = get_config(TRAIN["arch"])
    plan = cfg.head_plan()
    out["train-minicpm"] = (TRAIN["batch"], plan.n_q_pad, plan.n_kv_pad,
                            cfg.head_dim_, cfg.sliding_window, TRAIN["seq"])
    out["train-zamba"] = train_zamba_heads()
    out["train-internvl"] = train_internvl_heads()
    cfg, args = example_train_config()
    plan = cfg.head_plan()
    out["example-train"] = (args.batch, plan.n_q_pad, plan.n_kv_pad,
                            cfg.head_dim_, cfg.sliding_window, args.seq)
    return out


def train_internvl_heads() -> tuple:
    """InternVL2-2B's attention in training: (batch, q heads, kv heads,
    head_dim, window, T = image tokens + text tokens)."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_INTERNVL["arch"])
    plan = cfg.head_plan()
    return (TRAIN_INTERNVL["batch"], plan.n_q_pad, plan.n_kv_pad,
            cfg.head_dim_, 0, cfg.n_img_tokens + TRAIN_INTERNVL["seq"])


def noncausal_paths() -> dict:
    """Whisper-base's non-causal attention, K2 in serving and training,
    K4 and K5 in training: its encoder (T = S = the 1500 frames) and its
    decoder's cross attention (the 256 training tokens over the frames),
    (batch, T, S, q heads, kv heads, head_dim)."""
    from repro_torch.configs import get_config
    cfg = get_config(WHISPER["arch"])
    plan = cfg.head_plan()
    B, S, T = WHISPER["batch"], cfg.enc_seq_len, WHISPER["seq"]
    heads = (plan.n_q_pad, plan.n_kv_pad, cfg.head_dim_)
    return {"whisper-encoder": (B, S, S) + heads,
            "whisper-cross": (B, T, S) + heads}


def flash_noncausal_case(fa, gen, dev, flush, B, T, S, Hq, Hkv, Dh) -> dict:
    """K2 without the causal mask at T x S: checked against its plain
    version (o within 2e-2, lse within 1e-3), timed beside its bound, the
    plain version and one SDPA call."""
    import torch
    import torch.nn.functional as F
    group = Hq // Hkv
    kw = dict(causal=False, group=group)
    q = torch.randn((B, T, Hq, Dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, Dh), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    d = (o.float() - o_ref.float()).abs().max().item()
    d_lse = (lse - lse_ref).abs().max().item()
    shape = dict(B=B, T=T, S=S, Hq=Hq, Hkv=Hkv, Dh=Dh, causal=False,
                 dtype="bf16")
    if not (math.isfinite(d) and d <= 2e-2 and d_lse <= 1e-3):
        raise AssertionError(f"flash_attention {shape}: max|o-o_ref|={d}, "
                             f"max|lse-lse_ref|={d_lse}")
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), 20, flush)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 5,
                       flush)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20,
                     flush)
    n_bytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * B * Hq * T
    b_ms, b_by = bound_ms(n_bytes, 4 * Dh * B * Hq * T * S, "bfloat16")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, max_abs_err=d, max_lse_err=d_lse,
                shape=shape)


def train_zamba_heads() -> tuple:
    """The shared block's attention on the hybrid training path: (batch,
    q heads, kv heads, head_dim, window, T)."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ZAMBA["arch"])
    plan = cfg.head_plan()
    return (TRAIN_ZAMBA["batch"], plan.n_q_pad, plan.n_kv_pad,
            cfg.head_dim_, cfg.sliding_window, TRAIN_ZAMBA["seq"])


def check_flash(dev, flush) -> dict:
    """K2 in bf16 at each serve path's prefill and the training path's
    forward (its T, and a ragged T of 200) against its plain version, timed
    at the path's T beside its bound, the plain version and one SDPA call;
    Whisper-base's non-causal encoder and cross attention at T != S
    (`noncausal_paths`, `flash_noncausal_case`); then the f32 path at the
    Qwen2.5 prefill, checked and timed (`f32_ms`).
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
    # Whisper's non-causal encoder and cross attention (T != S)
    for path, shape in noncausal_paths().items():
        paths[path] = flash_noncausal_case(fa, gen, dev, flush, *shape)
        err = max(err, paths[path]["max_abs_err"])
        checked.append(dict(path=path, **paths[path]["shape"]))
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


def decode_case(da, q, k, v, lengths, group: int, flush) -> dict:
    """One K3 case: checked against the plain version (bf16 within 2e-2),
    timed beside its bound, the plain version and one masked SDPA call."""
    import torch
    import torch.nn.functional as F
    o = da.decode_attention(q, k, v, lengths, group=group)
    o_ref = da.decode_attention_plain(q, k, v, lengths, group=group)
    torch.cuda.synchronize()
    d = (o.float() - o_ref.float()).abs().max().item()
    B, _, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    shape = dict(B=B, S=S, Hq=Hq, Hkv=Hkv, Dh=Dh, dtype="bf16",
                 lengths=lengths.tolist())
    if not (math.isfinite(d) and d <= 2e-2):
        raise AssertionError(f"decode_attention {shape}: max|o-o_ref|={d}")
    ms = time_ms(lambda: da.decode_attention(q, k, v, lengths, group=group),
                 100, flush)
    plain_ms = time_ms(lambda: da.decode_attention_plain(
        q, k, v, lengths, group=group), 20, flush)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), 100, flush)
    n_valid = int(lengths.sum().item())
    n_bytes = 2 * (2 * q.numel() + 2 * n_valid * Hkv * Dh) + 4 * B
    b_ms, b_by = bound_ms(n_bytes, 4 * Dh * Hq * n_valid, "bfloat16")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, max_abs_err=d, shape=shape)


def host_us(fn, calls: int = 100, reps: int = 5) -> float:
    """Host microseconds a call: `perf_counter` around `calls` enqueued
    calls, no sync between them (the device keeps up); the least of `reps`
    such runs, since the host is shared and its noise only adds time."""
    import torch
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(runs)


def check_decode(dev, flush) -> dict:
    """K3 at each serve path's decode step, its KV-cache length S: lengths
    1 to full (`ragged`), then the uniform lengths the path runs, every row
    at prompt + 1 (`first`, the first decode step) and at prompt + new - 1
    (`last`); then Zamba2's heads at its 4096-key window, full. Each case
    against the plain version, timed beside its bound, the plain version and
    one masked SDPA call (`decode_case`); each path's wrapper host us a call
    at its ragged case (`host_us`). The row's top-level times are the
    Qwen2.5 path's ragged case; `paths` holds each path's cases, and
    Whisper-base's cross attention at decode (`whisper-cross`: S 1500,
    every slot valid)."""
    import torch

    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(12)
    err, checked, paths = 0.0, [], {}
    specs = {path: spec
             for path, (_, spec) in attention_serve_paths().items()}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for path, (B, Hq, Hkv, Dh, window, Tp, S) in attn_paths().items():
        group = Hq // Hkv
        q = torch.randn((B, 1, Hq, Dh), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, Hkv, Dh), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        new = specs[path]["new"]
        cases = {}
        for case, lens in (("ragged", [1, S // 3, Tp + 1, S]),
                           ("first", [Tp + 1] * B),
                           ("last", [Tp + new - 1] * B)):
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            cases[case] = decode_case(da, q, k, v, lengths, group, flush)
            err = max(err, cases[case]["max_abs_err"])
            checked.append(dict(path=path, case=case,
                                **cases[case]["shape"]))
        lengths = torch.tensor([1, S // 3, Tp + 1, S], dtype=torch.int32,
                               device=dev)
        cases["host_us"] = host_us(
            lambda: da.decode_attention(q, k, v, lengths, group=group))
        cases["split_keys"], cases["n_split"] = da.split_plan(B, S, Hkv,
                                                               n_sm)
        paths[path] = dict(cases.pop("ragged"), **cases)
        if window:      # the rolling cache at its full window
            kw = dict(generator=gen, device=dev, dtype=torch.bfloat16)
            k, v = (torch.randn((B, window, Hkv, Dh), **kw)
                    for _ in range(2))
            lengths = torch.full((B,), window, dtype=torch.int32, device=dev)
            row = decode_case(da, q, k, v, lengths, group, flush)
            err = max(err, row["max_abs_err"])
            checked.append(dict(path=path, case="window", **row["shape"]))
            paths[path]["window"] = row
        del q, k, v
    # Whisper-base's cross attention at decode: the encoder's 1500 frames,
    # every slot valid, no cache write
    B, _, S, Hq, Hkv, Dh = noncausal_paths()["whisper-cross"]
    q = torch.randn((B, 1, Hq, Dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, Dh), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    row = decode_case(da, q, k, v, lengths, Hq // Hkv, flush)
    err = max(err, row["max_abs_err"])
    checked.append(dict(path="whisper-cross", case="full", **row["shape"]))
    paths["whisper-cross"] = row
    del q, k, v
    top = {key: paths["serve-qwen"][key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_us",
        "shape")}
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
    checked = []
    for window, n in ((32, 3 * MAIN["chips"]), (32, 3 * 67), (29, 200),
                      (64, 67), (7, 5)):       # the path's lanes, ragged
        args = sor_inputs(window, n, seed=n, dev=dev)
        got = ft.sor_fit(*args, **SOR_KW)
        want = ft.sor_fit_plain(*args, **SOR_KW)
        torch.cuda.synchronize()
        usable_k, usable_p = got[3] > 0, want[3] > 0
        if not torch.equal(usable_k, usable_p) or not usable_p.any() or \
                usable_p.all():
            raise AssertionError(f"sor_fit ({window}, {n}): usable masks "
                                 f"differ or are degenerate")
        for name, a, b in zip(("intercept", "slope", "v_frontier",
                               "confidence", "n_eff", "floor"), got, want):
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-6):
                raise AssertionError(f"sor_fit ({window}, {n}) {name}: max "
                                     f"diff {(a - b).abs().max().item()}")
            err = max(err, (a - b).abs().max().item())
        checked.append([window, n])
    window, n = 32, 3 * MAIN["chips"]
    args = sor_inputs(window, n, seed=n, dev=dev)
    ms = time_ms(lambda: ft.sor_fit(*args, **SOR_KW), 100, flush)
    plain_ms = time_ms(lambda: ft.sor_fit_plain(*args, **SOR_KW), 50, flush)
    n_bytes = 4 * (3 * window * n + 2 * n + 6 * n)
    b_ms, b_by = bound_ms(n_bytes, 9 * window * n + 30 * n, "float32")
    return dict(name="sor_fit", route="cuda",
                source="src/repro_torch/kernels/csrc/sor_fit.cu",
                replaces="src/repro/kernels/fleet_telemetry.py:113",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, floor_ms=floor_ms(flush),
                checked=checked, shape=dict(window=window, n=n))


# K7's five sums in another order than the plain version's: within 1e-6
# of the largest |sum| of each output (f32 sums of O(1) terms)
SUM_TOL = 1e-6
SUMS = ("sw", "sx", "sy", "sxx", "sxy")
SOR_OUTS = ("intercept", "slope", "v_frontier", "confidence", "n_eff",
            "floor")


def check_sor_accumulate(dev, flush) -> dict:
    """K7 at the host path's window (32 rows, 3 rails x 64 chips), a ragged
    (29, 200), a 1024-chip fleet (32, 3 x 1024), two passes of 32 rows
    (64, 201) and (7, 5), two whole rows at zero weight in each, against
    its plain version (SUM_TOL); then K7 followed
    by the plain solve (`ref.sor_solve_reference`) against K1 on the same
    inputs. Expected bit-equal: K7 and K1 sum with one device function, and
    the solve runs as separately rounded elementwise kernels in K1's op
    order. Where they differ, the largest gap of each output is reported
    and held to K1's own tolerance against its plain version."""
    import torch

    from repro_torch.kernels import fleet_telemetry as ft
    from repro_torch.kernels import ref
    err, gaps, checked = 0.0, {}, []
    for window, n in ((32, 3 * MAIN["chips"]), (29, 200), (32, 3 * 1024),
                      (64, 201), (7, 5)):
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
                bound_by=b_by, library_ms=None, floor_ms=floor_ms(flush),
                sum_tolerance=SUM_TOL,
                split_fit_equals_k1=split_equal,
                split_fit_gap_to_k1=gaps,
                split_fit_gap_reason=None if split_equal else (
                    "torch.exp on the card and K1's expf round differently; "
                    "held to K1's tolerance (rtol 1e-4, atol 1e-6)"),
                checked=checked, shape=dict(window=window, n=n))


def floor_ms(flush) -> float:
    """The harness's floor: a one-element fill timed as `time_ms` times a
    kernel (launch, events and the L2 flush, no work)."""
    import torch
    tiny = torch.zeros(1, device=flush.device)
    return time_ms(lambda: tiny.zero_(), 100, flush)


# torch.profiler drops device events at the start of a window: now and
# then the first kernel of a window (on the H100 its start lags its launch
# by ~1-2 ms on the profiler's clock), in a process that ran the kernel
# checks before K6's that first kernel in almost every window
# (`scripts/profile_windows.py --after-checks`), and in a process that
# had profiled a full-width decode (thousands of events) every kernel
# before the window's first synchronize (all four leads and the first
# witness, in every window). `GuardedProfile` therefore opens each window
# with a warm-up step (the profiler traces and drops what it records:
# PROFILE_LEADS lead kernels, a synchronize and PROFILE_PAD_S of host
# time), then in the recorded step runs PROFILE_LEADS more lead kernels
# and a synchronize, and counts only what starts between two witness
# kernels around the call; a window that lost a witness is taken again,
# at most PROFILE_TRIES times, each with four times the leads.
# `device_activity` (one call's kernels, copies and syncs) and the serve
# and train breakdowns (`decode_breakdown`, `train_breakdown`: busy ms and
# kernels by name) read their windows through it, so a lost window is
# taken again rather than read as an idle device
PROFILE_PAD_S = 0.005
PROFILE_TRIES = 5
PROFILE_LEADS = 4
# the copies `device_activity` splits out by direction (a Memset last)
COPY_KINDS = ("HtoD", "DtoH", "DtoD", "Memset")


class GuardedProfile:
    """torch.profiler windows whose device events can be trusted: a
    warm-up step whose events are dropped (lead kernels, a synchronize,
    PROFILE_PAD_S of host time), then the recorded step: lead kernels, a
    synchronize, a witness kernel, the call (and a synchronize), the
    witness again and PROFILE_PAD_S of host time. The device events that
    start between the two witnesses are the call's. A window that did not
    record both witnesses is taken again with four times the leads
    (PROFILE_TRIES; `retaken` counts them), after `setup` runs anew."""

    def __init__(self, host: bool = True):
        import torch
        self.host = host            # record host events too (the syncs)
        self.lead = torch.zeros(1, dtype=torch.int32, device="cuda")
        self.witness = torch.zeros(1, dtype=torch.int16, device="cuda")
        self.retaken = 0
        seen = []
        for attempt in range(PROFILE_TRIES):
            _, device, _ = self._window(lambda: None, attempt)
            names = [e.name for e in device]
            # around a call that does nothing the last kernel is the witness
            if names and names.count(names[-1]) == 2:
                self.witness_kernel = names[-1]
                return
            self.retaken += 1
            seen.append(names[-3:])
        raise RuntimeError("GuardedProfile: torch.profiler recorded no two "
                           f"witness kernels in {PROFILE_TRIES} windows: "
                           f"{seen}")

    def _window(self, fn, attempt: int):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, schedule
        leads = PROFILE_LEADS * 4 ** attempt
        torch.cuda.synchronize()
        with profile(activities=([ProfilerActivity.CPU] if self.host
                                 else []) + [ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(leads):          # warm-up: traced, dropped
                self.lead.neg_()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            prof.step()
            for _ in range(leads):
                self.lead.neg_()
            torch.cuda.synchronize()
            self.witness.neg_()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            self.witness.neg_()
            # a kernel still running when the profiler stops goes
            # unrecorded: the window ends after the call's last kernel
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            prof.step()
        events = prof.events()
        device = sorted((e for e in events
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        return events, device, wall_s

    def take(self, fn, setup=None):
        """(host events of the window, the call's device events, the call's
        host seconds up to its synchronize)."""
        from torch.autograd import DeviceType
        lost = []
        for attempt in range(PROFILE_TRIES):
            if setup is not None:
                setup()
            events, device, wall_s = self._window(fn, attempt)
            marks = [i for i, e in enumerate(device)
                     if e.name == self.witness_kernel]
            if len(marks) >= 2:
                host = [e for e in events if e.device_type != DeviceType.CUDA]
                return host, device[marks[0] + 1:marks[-1]], wall_s
            self.retaken += 1
            lost.append([e.name[:40] for e in device[:8]])
        raise RuntimeError("GuardedProfile: torch.profiler lost a witness "
                           f"in {PROFILE_TRIES} windows (the first kernels "
                           f"recorded: {lost})")


def device_us(event) -> float:
    return getattr(event, "device_time", 0.0)


def by_name(device_events) -> dict:
    """{kernel name: (calls, device us)} of a window's device events."""
    out = {}
    for e in device_events:
        calls, us = out.get(e.name, (0, 0.0))
        out[e.name] = (calls + 1, us + device_us(e))
    return out


def device_activity(call) -> dict:
    """What one `call` (after a warm-up call) puts on the card and asks of
    the host's CUDA runtime (a `GuardedProfile` window): device kernels,
    device memory copies (also by direction: COPY_KINDS), their summed
    device time (us), and the stream or device synchronisations the host
    waited on, less those of profiling a call that does nothing (the
    profiler's and the window's own); `retaken` counts the windows taken
    again for a lost witness."""
    guard = GuardedProfile()

    def profiled(fn):
        fn()
        host, device, _ = guard.take(fn)
        out = {"kernels": 0, "copies": 0, "device_us": 0.0, "syncs": 0}
        out.update(dict.fromkeys(COPY_KINDS, 0))
        for e in device:
            if e.name.startswith(("Memcpy", "Memset")):
                out["copies"] += 1
                out[next(k for k in COPY_KINDS if k in e.name or
                         k == "Memset")] += 1
            else:
                out["kernels"] += 1
            out["device_us"] += device_us(e)
        out["syncs"] = sum("Synchronize" in e.name for e in host)
        return out

    base = profiled(lambda: None)
    out = {k: v - base[k] for k, v in profiled(call).items()}
    return dict(out, retaken=guard.retaken)


def row_order_sums(x, y, w):
    """The five EWLS sums of x, y, w [window, ...] added row by row, each
    product and add its own tensor op: the kernels' order."""
    import torch
    s = [torch.zeros(x.shape[1:], device=x.device) for _ in range(5)]
    for r in range(x.shape[0]):
        wx = w[r] * x[r]
        for q, term in enumerate((w[r], wx, w[r] * y[r], wx * x[r],
                                  wx * y[r])):
            s[q] = s[q] + term
    return s


REFIT_FIELDS = ("intercept", "slope", "v_frontier", "confidence", "n_eff")


def check_sor_refit(dev, flush) -> dict:
    """K1's refit on cadence (`sor_refit`, one launch: the ring's window
    inputs, the sums, the solve, the blend) at each ring state of
    `tests/test_torch_inputs.RING_CASES` on the serve paths' 3 x 64 lanes
    and on 3 x 1024 and 3 x 4096 (the routed fleets): against its plain
    version, the composed tensor
    sequence, on the card (confidence > 0 masks exactly, every field within
    K1's tolerance, rtol 1e-4 and atol 1e-6; torch's sums block the rows),
    and against the same sequence with its sums added in row order
    (`row_order_sums`, the kernel's order), where a gap can come only from
    a library function: the ring's K7 sums against the row-order sums
    name it (Σw: powf, the weights; Σwy with Σw equal: log10f; confidence
    with n_eff equal: expf). Then the main path's ring (capacity 32, 3 x
    64, no staleness weighting, gain 1): device ms of the refit, of its
    plain version and of the composed sequence it replaced on the main
    path (torch's input preparation, K1 alone, torch's blend); host us a
    refit both ways (`sor.update_estimate` and the composed sequence); the
    device work and host syncs of one refit fused, composed and split
    (`device_activity`); the harness's floor; the refit's device ms at the
    routed fleets' 3 x 1024 and 3 x 4096 lanes beside their bounds."""
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_inputs import RING_CASES, ring_state

    from repro_torch.core import sor
    from repro_torch.core.telemetry import (ALL_RAIL_OBSERVABLES,
                                            FrameHistory)
    from repro_torch.kernels import fleet_telemetry as ft
    from repro_torch.kernels import ref

    def on_card(st):
        hist = FrameHistory(
            **{f: torch.from_numpy(st[f]).to(dev)
               for f in ("v", "obs", "age_s", "polled", "valid")},
            cursor=st["cursor"], count=st["count"],
            capacity=st["cfg"]["capacity"], rails=ALL_RAIL_OBSERVABLES)
        cfg = sor.SorConfig(rails=ALL_RAIL_OBSERVABLES, **st["cfg"])
        old = sor.SorEstimate(*(torch.from_numpy(a).to(dev)
                                for a in st["old"]))
        args = (*sor._ring(hist), [a.reshape(3, -1) for a in
                                   (getattr(old, f) for f in REFIT_FIELDS)],
                sor._rail_consts(cfg, dev)[0])
        kw = dict(update_gain=cfg.update_gain, **sor._weighting(hist, cfg),
                  **sor._gates(cfg))
        return hist, cfg, old, args, kw

    def composed(hist, cfg, old):
        """The refit as the main path ran it before K1's refit."""
        x, y, w = (a.reshape(hist.capacity, -1)
                   for a in sor._fit_inputs(hist, cfg))
        bound, guard = sor._rail_consts(cfg, dev)
        n_chips = x.shape[1] // 3

        def lanes(a):
            return a[:, None].expand(3, n_chips).reshape(-1)

        fit = ft.sor_fit(x, y, w, lanes(bound), lanes(guard),
                         **sor._gates(cfg))[:5]
        return ref.sor_blend_reference(
            [getattr(old, f).reshape(-1) for f in REFIT_FIELDS], fit,
            cfg.update_gain)

    err, checked = 0.0, []
    gap_plain = dict.fromkeys(REFIT_FIELDS, 0.0)
    gap_row = dict.fromkeys(REFIT_FIELDS, 0.0)
    gap_sums = dict.fromkeys(SUMS, 0.0)
    for n_chips in (MAIN["chips"], 1024, 4096):
        for case in RING_CASES:
            st = ring_state(case, n_chips)
            hist, cfg, old, args, kw = on_card(st)
            got = ft.sor_refit(*args, **kw)
            plain = ft.sor_refit_plain(*args, **kw)
            window = ref.sor_fit_inputs(*args[:4], **sor._weighting(hist,
                                                                    cfg))
            row_sums = row_order_sums(*window)
            fit = ref.sor_estimate_reference(row_sums, args[5][:, None],
                                             **sor._gates(cfg))
            row = ref.sor_blend_reference(args[4], fit, cfg.update_gain)
            k7 = ft.sor_accumulate_ring(*args[:4], **sor._weighting(hist,
                                                                    cfg))
            torch.cuda.synchronize()
            for other, what in ((plain, "plain"), (row, "row-order")):
                if not torch.equal(got[3] > 0, other[3] > 0):
                    raise AssertionError(f"sor_refit {case} x {n_chips}: "
                                         f"usable lanes differ from the "
                                         f"{what} sequence")
            if not (plain[3] > 0).any():
                raise AssertionError(f"sor_refit {case}: no lane learned")
            for name, a, b, c in zip(REFIT_FIELDS, got, plain, row):
                if not torch.allclose(a, b, rtol=1e-4, atol=1e-6):
                    raise AssertionError(
                        f"sor_refit {case} x {n_chips} {name}: max diff "
                        f"{(a - b).abs().max().item()} from the plain "
                        f"version")
                if not torch.allclose(a, c, rtol=1e-4, atol=1e-6):
                    raise AssertionError(
                        f"sor_refit {case} x {n_chips} {name}: max diff "
                        f"{(a - c).abs().max().item()} from the row-order "
                        f"sequence")
                gap_plain[name] = max(gap_plain[name],
                                      (a - b).abs().max().item())
                gap_row[name] = max(gap_row[name],
                                    (a - c).abs().max().item())
            for name, a, b in zip(SUMS, k7, row_sums):
                gap_sums[name] = max(gap_sums[name],
                                     (a - b).abs().max().item())
            checked.append([case, n_chips])
    err = max(gap_plain.values())
    sources = []
    if gap_sums["sw"]:
        sources.append("powf (the weights) against torch.pow")
    elif gap_sums["sy"] or gap_sums["sxy"]:
        sources.append("log10f against torch.log10")
    if gap_row["confidence"] and not gap_row["n_eff"]:
        sources.append("expf against torch.exp")

    # the routed fleets' refit (3 x 1024 and 3 x 4096 lanes), timed alone
    routed = {}
    for n_chips in (1024, 4096):
        hist_r, cfg_r, _, args_r, kw_r = on_card(ring_state("mid", n_chips))
        lanes = 3 * n_chips
        routed[n_chips] = dict(
            ms=time_ms(lambda: ft.sor_refit(*args_r, **kw_r), 100, flush),
            bound_ms=bound_ms(4 * 2 * cfg_r.capacity * lanes
                              + cfg_r.capacity * lanes + 4 * 10 * lanes
                              + 4 * 3, 13 * cfg_r.capacity * lanes
                              + 40 * lanes, "float32")[0])

    st = ring_state("mid", MAIN["chips"])      # the main path's SorConfig
    hist, cfg, old, args, kw = on_card(st)
    cap, n = cfg.capacity, 3 * MAIN["chips"]
    ms = time_ms(lambda: ft.sor_refit(*args, **kw), 100, flush)
    # 10 calls of the multi-launch sequences: their 500-750 launches stay
    # inside the launch queue while the device sleeps, so the events time
    # the device and not the host's enqueueing
    plain_ms = time_ms(lambda: ft.sor_refit_plain(*args, **kw), 10, flush)
    composed_ms = time_ms(lambda: composed(hist, cfg, old), 10, flush)
    # reads v, obs (f32), valid (bool), the old estimate and the bounds
    # once, writes the new estimate; 4 products and 5 adds a window element
    # beside its preparation, ~40 operations a lane to solve and blend
    b_ms, b_by = bound_ms(4 * 2 * cap * n + cap * n + 4 * 10 * n + 4 * 3,
                          13 * cap * n + 40 * n, "float32")
    return dict(
        name="sor_refit", route="cuda",
        source="src/repro_torch/kernels/csrc/sor_fit.cu",
        replaces="src/repro/kernels/fleet_telemetry.py:113",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, floor_ms=floor_ms(flush),
        composed_ms=composed_ms,
        host_us=host_us(lambda: sor.update_estimate(old, hist, cfg)),
        composed_host_us=host_us(lambda: composed(hist, cfg, old)),
        per_refit=dict(
            fused=device_activity(lambda: sor.update_estimate(old, hist,
                                                              cfg)),
            composed=device_activity(lambda: composed(hist, cfg, old)),
            split=device_activity(lambda: sor.update_estimate(
                old, hist, cfg, fused=False))),
        gap_to_plain=gap_plain, gap_to_row_order=gap_row,
        bit_equal_to_row_order=not any(gap_row.values()),
        k7_sums_gap_to_row_order=gap_sums, library_gap_sources=sources,
        routed_fleets=routed, checked=checked, shape=dict(capacity=cap, n=n))


def check_flash_bwd(dev, flush) -> list[dict]:
    """K4 and K5 at the training paths' shapes (MiniCPM-2B: 48/48 heads,
    head_dim 64, bf16, causal; Zamba2-1.2B's shared block: 32/32 heads x
    64, window 4096, T 256; InternVL2-2B: 16/16 x 128, T 512; Whisper-base's
    non-causal encoder, T = S = 1500, and cross attention, T 256 over S
    1500, 16/16 x 64), with K2's o and lse, each against its plain
    version; plus a ragged T, a window and a ragged T at batch 2 (a tile
    past T must not read the next batch row). Each path is timed
    (`flash_bwd_path`); the row's top-level times are MiniCPM-2B's. The
    yardstick is the backward of one SDPA call (dq, dk, dv together)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, Dh = TRAIN["batch"], 48, 48, 64
    gen = torch.Generator(device=dev).manual_seed(13)

    def inputs(nb, T, hq, hkv):
        return bwd_inputs(gen, dev, nb, T, T, hq, hkv, Dh)

    err = {"dq": 0.0, "dkv": 0.0}
    for nb, T, hq, hkv, window in ((B, 500, 12, 4, 0), (B, 300, 8, 8, 96),
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
    paths = {}
    for path, (nb, hq, hkv, dh, window, T) in (
            ("train-minicpm", (B, Hq, Hkv, Dh, 0, TRAIN["seq"])),
            ("train-zamba", train_zamba_heads()),
            ("train-internvl", train_internvl_heads()),
            ("example-train", flash_paths()["example-train"])):
        paths[path] = flash_bwd_path(
            fa, bwd_inputs(gen, dev, nb, T, T, hq, hkv, dh), hq // hkv,
            window, flush)
    for path, (nb, T, S, hq, hkv, dh) in noncausal_paths().items():
        paths[path] = flash_bwd_path(
            fa, bwd_inputs(gen, dev, nb, T, S, hq, hkv, dh), hq // hkv, 0,
            flush, causal=False)
    for row in paths.values():
        for name in ("dq", "dkv"):
            err[name] = max(err[name], row[f"{name}_max_abs_err"])
    shape = dict(B=B, T=TRAIN["seq"], Hq=Hq, Hkv=Hkv, Dh=Dh, dtype="bf16",
                 also_B_T_Hq_Hkv_window=[[B, 500, 12, 4, 0],
                                         [B, 300, 8, 8, 96],
                                         [2, 200, Hq, Hkv, 0]])
    src = "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu"
    top = paths["train-minicpm"]
    return [dict(name="flash_attention_bwd_dq", route="cuda", source=src,
                 replaces="src/repro/kernels/flash_attention.py:234",
                 max_abs_err=err["dq"], ms=top["dq_ms"],
                 plain_ms=top["dq_plain_ms"], bound_ms=top["dq_bound_ms"],
                 bound_by=top["dq_bound_by"], library_ms=top["library_ms"],
                 shape=shape, paths=paths),
            dict(name="flash_attention_bwd_dkv", route="cuda", source=src,
                 replaces="src/repro/kernels/flash_attention.py:262",
                 max_abs_err=err["dkv"], ms=top["dkv_ms"],
                 plain_ms=top["dkv_plain_ms"], bound_ms=top["dkv_bound_ms"],
                 bound_by=top["dkv_bound_by"], library_ms=top["library_ms"],
                 shape=shape, paths=paths)]


def bwd_inputs(gen, dev, B, T, S, Hq, Hkv, Dh):
    """Random bf16 q, k, v, do ([B,T,Hq,Dh], [B,S,Hkv,Dh] twice,
    [B,T,Hq,Dh]) on the card."""
    import torch
    return tuple(torch.randn(shape, generator=gen, device=dev,
                             dtype=torch.bfloat16)
                 for shape in ((B, T, Hq, Dh), (B, S, Hkv, Dh),
                               (B, S, Hkv, Dh), (B, T, Hq, Dh)))


def flash_bwd_path(fa, qkvdo, group: int, window: int, flush, *,
                   causal: bool = True) -> dict:
    """K4 and K5 at one training path's shape (bf16, `causal`, `window`):
    checked against their plain versions (1e-2 of the largest |grad|),
    timed beside their bounds, their plain versions and the backward of
    one SDPA call (dq, dk, dv together; masked where the window is inside
    T)."""
    import torch
    import torch.nn.functional as F
    q, k, v, do = qkvdo
    B, T, Hq, Dh = q.shape
    S = k.shape[1]
    kw = dict(causal=causal, group=group, sliding_window=window)
    o, lse = fa.flash_attention(q, k, v, **kw)
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta)
    out = {}
    dq = fa.flash_attention_bwd_dq(*args, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(*args, **kw)
    dq_ref = fa.flash_attention_bwd_dq_plain(*args, **kw)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, pairs in (("dq", ((dq, dq_ref),)),
                        ("dkv", ((dk, dk_ref), (dv, dv_ref)))):
        worst = 0.0
        for a, b in pairs:
            d = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            if not (math.isfinite(d) and d <= 1e-2 * max(scale, 1.0)):
                raise AssertionError(f"flash backward {name} B={B} T={T} "
                                     f"Hq={Hq} window={window}: max diff "
                                     f"{d}, max |ref| {scale}")
            worst = max(worst, d)
        out[f"{name}_max_abs_err"] = worst
    out["dq_ms"] = time_ms(lambda: fa.flash_attention_bwd_dq(*args, **kw),
                           20, flush)
    out["dkv_ms"] = time_ms(lambda: fa.flash_attention_bwd_dkv(*args, **kw),
                            20, flush)
    out["dq_plain_ms"] = time_ms(lambda: fa.flash_attention_bwd_dq_plain(
        *args, **kw), 5, flush)
    out["dkv_plain_ms"] = time_ms(lambda: fa.flash_attention_bwd_dkv_plain(
        *args, **kw), 5, flush)
    Hkv = k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (a.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
              .requires_grad_() for a in (k, v))
    rows = torch.arange(T, device=q.device)
    keys = torch.arange(S, device=q.device)
    keep = keys[None, :] <= rows[:, None]          # causal: keys <= row
    if not causal:
        keep = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if window:
        keep &= keys[None, :] > rows[:, None] - window
    windowed = 0 < window < T
    ot = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep if windowed else None,
        is_causal=causal and not windowed)
    dot = do.transpose(1, 2).contiguous()
    out["library_ms"] = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), 20, flush)
    pairs = B * Hq * int(keep.sum().item())
    qb, kb = 2 * q.numel(), 2 * k.numel()        # bf16 q-shaped, k-shaped
    stats = 2 * 4 * B * Hq * T                   # lse and delta, f32
    # K4 reads q, k, v, do, lse, delta, writes dq; s, dp, dq products
    out["dq_bound_ms"], out["dq_bound_by"] = bound_ms(
        3 * qb + 2 * kb + stats, 6 * Dh * pairs, "bfloat16")
    # K5 reads q, k, v, do, lse, delta, writes dk, dv; s, dp, dv, dk
    out["dkv_bound_ms"], out["dkv_bound_by"] = bound_ms(
        2 * qb + 4 * kb + stats, 8 * Dh * pairs, "bfloat16")
    out["shape"] = dict(B=B, T=T, S=S, Hq=Hq, Hkv=Hkv, Dh=Dh,
                        window=window, causal=causal, dtype="bf16")
    return out


def check_fleet_reduce(dev, flush) -> dict:
    """K6 at the fleet train step's [64, 5], at 1, 2, 65 and 1000 chips, a
    NaN lane in one field of each; max and min exact, the sum to f32
    order; the harness's floor beside it."""
    import numpy as np
    import torch

    from repro_torch.kernels import fleet_telemetry as ft
    err = 0.0
    sizes = (1, 2, TRAIN["chips"], 65, 1000)
    for n in sizes:
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
                bound_by=b_by, library_ms=None, floor_ms=floor_ms(flush),
                host_us=host_us(lambda: ft.fleet_reduce(x)),
                per_call=device_activity(lambda: ft.fleet_reduce(x)),
                shape=dict(n_chips=TRAIN["chips"], n_fields=5,
                           nan_lane_checked_at=list(sizes)))


def fleet_tail_composed(ops, power_w, t_chip_s, grad_error, energy_step_j,
                        v_io, straggle, conf=None):
    """The fleet train step's reduction tail as it ran before
    `fleet_stats`: the five fields stacked, K6 (`ops.fleet_reduce`), five
    divides, two `ops.fleet_percentile` (torch.quantile), the straggler
    mean, the confidence's mean and min. `ops` is the kernels module of the
    checkout that runs it."""
    import torch
    n = power_w.shape[0]
    stacked = torch.stack([power_w, t_chip_s, grad_error, energy_step_j,
                           v_io], dim=1).contiguous()
    mx, mn, sm = ops.fleet_reduce(stacked)
    out = {}
    for i, name in enumerate(("power_w", "t_chip_s", "grad_error",
                              "energy_step_j")):
        out[f"fleet/{name}_worst"] = mx[i]
        out[f"fleet/{name}_mean"] = sm[i] / n
    out["fleet/v_io_min"] = mn[4]
    out["fleet/v_io_mean"] = sm[4] / n
    out["fleet/t_fleet_s"] = mx[1]
    out["fleet/t_chip_p95_s"] = ops.fleet_percentile(t_chip_s, 95.0)
    out["fleet/grad_error_p95"] = ops.fleet_percentile(grad_error, 95.0)
    out["fleet/straggler_frac"] = straggle.float().mean()
    if conf is not None:
        out["fleet/sor_conf_mean"] = conf.mean()
        out["fleet/sor_conf_min"] = conf.min()
    return out


def fleet_tail_args(n: int, case: str, dev) -> list:
    """`tests/test_torch_inputs.fleet_inputs` on the card."""
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_inputs import fleet_inputs
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in fleet_inputs(n, case)]


def check_fleet_stats(dev, flush) -> dict:
    """`fleet_stats`, the fleet train step's reduction tail in one launch,
    at each chip count and case of `tests/test_torch_inputs` (`FLEET_SIZES`
    x `FLEET_CASES`: ties at the p95's ranks, a NaN in t_chip_s, grad_error
    or v_io, with and without the confidence) against its plain version on
    the card (`check_fleet_stats`: max, min, the p95s and the straggler
    fraction bit for bit, the means within FLEET_SUM_RTOL, NaN where the
    plain version has NaN), against itself on a second launch (the same
    bits) and against the composed sequence it replaced (K6 in it). Then at
    the main path's 64 chips (the confidence [3, 64]): device ms of the
    kernel, of its plain version and of the composed sequence (10 calls of
    the multi-launch ones, inside the launch queue), host us a call and
    what one call puts on the card (`device_activity`) of each and of the
    harness's floor (the kernel's must read one kernel, no copy, no sync);
    and the kernel's device ms at 128 to 20000 chips."""
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_inputs import (FLEET_CASES, FLEET_SIZES, FLEET_SUM_RTOL,
                                   check_fleet_stats as check)

    from repro_torch.kernels import fleet_telemetry as ft
    from repro_torch.kernels import ops

    def host(d):
        return {k: v.cpu() for k, v in d.items()}

    gap, checked = 0.0, []
    for n in FLEET_SIZES:
        for case in FLEET_CASES:
            args = fleet_tail_args(n, case, dev)
            got = host(ft.fleet_stats(*args))
            check(host(ft.fleet_stats(*args)), got, 0.0)
            gap = max(gap, check(got, host(ft.fleet_stats_plain(*args)),
                                 FLEET_SUM_RTOL))
            check(got, host(fleet_tail_composed(ops, *args)), FLEET_SUM_RTOL)
            checked.append([n, case])

    # the kernel past the step's n: its p95s count ranks up to 128 chips
    # and run a radix select past that
    ms_by_n = {}
    for n in (128, 129, 1000, 4096, 20000):
        args = fleet_tail_args(n, "plain", dev)
        ms_by_n[n] = time_ms(lambda: ops.fleet_stats(*args), 100, flush)

    n = TRAIN["chips"]
    args = fleet_tail_args(n, "plain", dev)
    m = args[-1].numel()
    tiny = torch.zeros(1, device=dev)
    calls = {"fused": lambda: ops.fleet_stats(*args),
             "plain": lambda: ft.fleet_stats_plain(*args),
             "composed": lambda: fleet_tail_composed(ops, *args),
             "floor": lambda: tiny.zero_()}
    # reads the five fields, the mask and the confidence once, writes 16
    # values; a max, a min and an add a value of each fold, at least a
    # compare a value for each p95
    b_ms, b_by = bound_ms(4 * 5 * n + n + 4 * m + 4 * 16,
                          3 * 5 * n + 3 * n + 3 * m + 2 * n, "float32")
    per_call = {k: device_activity(fn) for k, fn in calls.items()}
    fused = per_call["fused"]
    if (fused["kernels"], fused["copies"], fused["syncs"]) != (1, 0, 0):
        raise AssertionError(f"fleet_stats: one call put {fused} on the "
                             f"card, not one kernel")
    return dict(
        name="fleet_stats", route="cuda",
        source="src/repro_torch/kernels/csrc/fleet_reduce.cu",
        replaces="src/repro/kernels/fleet_telemetry.py:192",
        max_abs_err=gap, ms=time_ms(calls["fused"], 100, flush),
        plain_ms=time_ms(calls["plain"], 10, flush), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        composed_ms=time_ms(calls["composed"], 10, flush),
        floor_ms=floor_ms(flush),
        host_us={k: host_us(fn) for k, fn in calls.items()},
        per_call=per_call, ms_by_n=ms_by_n, checked=checked,
        shape=dict(n=n, conf=list(args[-1].shape)))


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


# The bf16 scans (K8, K9) take their f32 products on the bf16 tensor cores
# with an f32 operand split into bf16 terms, three at most (the state
# update's): an f32 operation there costs at least three bf16 ones.
SCAN_BF16_TERMS = 3


def scan_bound(args, s0, y, state, flops) -> dict:
    """Bytes: each input read once (the initial state only where given),
    y and the final state written once. Operations: `flops` f32 operations
    at the rate of the form the kernel runs them in (bf16 inputs: the
    tensor cores' bf16 rate over SCAN_BF16_TERMS; f32 inputs: the f32
    rate). Returns both times and the bound, the larger of them, and the
    f32-rate time of the same count (`bound_f32_ops_ms`, information
    only)."""
    n_bytes = sum(a.numel() * a.element_size() for a in args) + \
        y.numel() * y.element_size() + state.numel() * 4 + \
        (0 if s0 is None else s0.numel() * 4)
    if str(y.dtype) == "torch.bfloat16":
        b_ms, b_by = bound_ms(n_bytes, flops * SCAN_BF16_TERMS, "bfloat16")
        ops_ms = flops * SCAN_BF16_TERMS / PEAK_FLOPS["bfloat16"] * 1e3
    else:
        b_ms, b_by = bound_ms(n_bytes, flops, "float32")
        ops_ms = flops / PEAK_FLOPS["float32"] * 1e3
    return dict(bound_ms=b_ms, bound_by=b_by,
                bound_bytes_ms=n_bytes / H100_BYTES_PER_S * 1e3,
                bound_ops_ms=ops_ms,
                bound_f32_ops_ms=flops / PEAK_FLOPS["float32"] * 1e3)


def scan_close(name, label, got, want) -> dict:
    """y and the final state of `got` against `want` at SCAN_TOL, relative
    to the largest magnitude; returns the max abs difference of each."""
    err = {}
    dt = str(want[0].dtype).removeprefix("torch.")
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
        err[part] = d
    return err


def check_scan(name, kernel, plain, cases, flops, flush) -> dict:
    """`kernel` against `plain` on y and on the final state at each of
    `cases` ({label: (args, s0)}; the first is the path's prefill, the
    second its decode step) at SCAN_TOL, then the decode step again in
    place (`state_out` the initial state itself, as the model hands it its
    cache slice); then the prefill and the decode step timed (the decode
    step in place too, its state restored outside the timed region),
    beside both bounds (`flops(args)` f32 operations)."""
    import torch
    err = {"y": 0.0, "state": 0.0}
    for label, (args, s0) in cases.items():
        got = kernel(*args, init_state=s0)
        want = plain(*args, init_state=s0)
        torch.cuda.synchronize()
        for part, d in scan_close(name, label, got, want).items():
            err[part] = max(err[part], d)
    dec_args, dec_s0 = list(cases.values())[1]
    buf = dec_s0.clone()
    got = kernel(*dec_args, init_state=buf, state_out=buf)
    want = plain(*dec_args, init_state=dec_s0)
    torch.cuda.synchronize()
    if got[1].data_ptr() != buf.data_ptr():
        raise AssertionError(f"{name}: the in-place step returned another "
                             f"state than its state_out")
    for part, d in scan_close(name, "decode in place", got, want).items():
        err[part] = max(err[part], d)
    out = {}
    for prefix, (args, s0) in zip(("", "decode_"), cases.values()):
        y, st = kernel(*args, init_state=s0)
        decode = prefix == "decode_"
        out.update({
            f"{prefix}ms": time_ms(lambda: kernel(*args, init_state=s0),
                                   100 if decode else 20, flush),
            f"{prefix}plain_ms": time_ms(lambda: plain(*args, init_state=s0),
                                         20 if decode else 3, flush),
            **{f"{prefix}{k}": v for k, v in
               scan_bound(args, s0, y, st, flops(args)).items()}})
    out["decode_in_place_ms"] = time_ms(
        lambda: kernel(*dec_args, init_state=buf, state_out=buf), 100, flush,
        setup=lambda: buf.copy_(dec_s0))
    return dict(max_abs_err=max(err.values()), max_abs_err_y=err["y"],
                max_abs_err_state=err["state"], library_ms=None,
                tolerance=SCAN_TOL,
                checked=list(cases) + ["decode in place"], **out)


def check_rwkv6_scan(dev, flush) -> dict:
    """K9 at the RWKV6-7B serve path's prefill (B 4, T 256, 64 heads x 64,
    bf16, zero initial state) and decode step (T 1, the carried state),
    plus a ragged T and f32; 5 f32 operations per state element and step
    (r . S and the state update), bounded as `scan_bound` says."""
    import torch

    from repro_torch.kernels import rwkv6_scan as r6
    B, T, H = RWKV["batch"], RWKV["prompt"], 64
    gen = torch.Generator(device=dev).manual_seed(14)
    cases = {f"T={t} {dt} state={state}": rwkv6_args(
                 B, t, H, getattr(torch, dt), state, gen, dev)
             for t, dt, state in ((T, "bfloat16", False), (1, "bfloat16", True),
                                  (200, "bfloat16", True),
                                  (63, "bfloat16", True),
                                  (65, "bfloat16", False),
                                  (T, "float32", True), (1, "float32", True),
                                  (37, "float32", False))}

    def flops(args):
        b, t, h, dh = args[0].shape
        return 5 * dh * dh * b * t * h

    row = dict(name="rwkv6_scan", route="cuda",
               source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
               replaces="src/repro/kernels/rwkv6_scan.py:67",
               **check_scan("rwkv6_scan", r6.rwkv6_scan, r6.rwkv6_scan_plain,
                            cases, flops, flush))
    args, _ = rwkv6_args(TRAIN_RWKV["batch"], TRAIN_RWKV["seq"], H,
                         torch.bfloat16, False, gen, dev)
    row["train_backward"] = check_scan_backward(
        "rwkv6_scan", r6.rwkv6_scan, r6.rwkv6_scan_plain, args,
        rwkv6_args(TRAIN_RWKV["batch"], 1, H, torch.bfloat16, True, gen,
                   dev)[1], flush)
    return dict(row,
                shape=dict(B=B, T=T, H=H, Dh=64, dtype="bf16",
                           decode=dict(T=1, init_state=True)))


def check_mamba2_ssd(dev, flush) -> dict:
    """K8 at the Zamba2-1.2B serve path's prefill (B 4, T 256, 64 heads x
    64, one group, state 64, bf16, zero initial state) and decode step (T 1,
    the carried state), plus a ragged T, f32, and two groups at state 16; 5
    f32 operations per state element and step (decay, rank-one update,
    C . S), bounded as `scan_bound` says."""
    import torch

    from repro_torch.kernels import mamba2_ssd as m2
    B, T, H = ZAMBA["batch"], ZAMBA["prompt"], 64
    gen = torch.Generator(device=dev).manual_seed(15)
    cases = {f"T={t} {dt} state={state} G={G} N={N}": mamba2_args(
                 B, t, H, G, N, getattr(torch, dt), state, gen, dev)
             for t, dt, state, G, N in (
                 (T, "bfloat16", False, 1, 64), (1, "bfloat16", True, 1, 64),
                 (200, "bfloat16", True, 1, 64), (63, "bfloat16", True, 1, 64),
                 (65, "bfloat16", False, 2, 16), (T, "float32", True, 1, 64),
                 (1, "float32", True, 1, 64), (37, "float32", False, 2, 16))}

    def flops(args):
        b, t, h, p = args[0].shape
        return 5 * args[3].shape[3] * p * b * t * h

    row = dict(name="mamba2_ssd", route="cuda",
               source="src/repro_torch/kernels/csrc/mamba2_ssd.cu",
               replaces="src/repro/kernels/mamba2_ssd.py:82",
               **check_scan("mamba2_ssd", m2.mamba2_ssd, m2.mamba2_ssd_plain,
                            cases, flops, flush))
    args, _ = mamba2_args(TRAIN_ZAMBA["batch"], TRAIN_ZAMBA["seq"], H, 1, 64,
                          torch.bfloat16, False, gen, dev)
    row["train_backward"] = check_scan_backward(
        "mamba2_scan", m2.mamba2_ssd, m2.mamba2_ssd_plain, args,
        mamba2_args(TRAIN_ZAMBA["batch"], 1, H, 1, 64, torch.bfloat16, True,
                    gen, dev)[1], flush)
    return dict(row,
                shape=dict(B=B, T=T, H=H, P=64, G=1, N=64, dtype="bf16",
                           decode=dict(T=1, init_state=True)))


def check_scan_backward(name, kernel, plain, args, s0, flush) -> dict:
    """The scan's differentiable call (`ops.<name>`: the kernel forward,
    the plain version's gradient) at the training paths' shape (bf16,
    batch 4 x 256 steps, 64 heads x 64): its gradients equal autograd
    through the plain version on the card bit for bit (y's cotangent
    alone, as on the training path; then y's and the final state's from
    an initial state), the forward launches the kernel once and the
    backward none; then one backward (the plain version re-run and walked
    back) timed by CUDA events (`ms`: its span on the device's timeline,
    host-bound), its device kernels and their summed time (`busy_ms`)."""
    import torch

    from repro_torch.kernels import ops
    fn = getattr(ops, name)
    gen = torch.Generator(device=args[0].device).manual_seed(16)
    n = len(args)

    def leaves(st):
        return [a.detach().clone().requires_grad_() for a in args] + \
            ([] if st is None else [st.detach().clone().requires_grad_()])

    def forward(f, ins, st):
        return f(*ins[:n], init_state=ins[n] if st is not None else None)

    for st in (None, s0):
        ins, ref_ins = leaves(st), leaves(st)
        before = kernel.launches
        y, state = forward(fn, ins, st)
        if kernel.launches != before + 1:
            raise AssertionError(f"{name}: the forward launched "
                                 f"{kernel.launches - before} kernels")
        cots = [torch.randn(y.shape, generator=gen, device=y.device,
                            dtype=torch.float32).to(y.dtype)]
        outs = [y]
        if st is not None:
            cots.append(torch.randn(state.shape, generator=gen,
                                    device=y.device))
            outs.append(state)
        got = torch.autograd.grad(outs, ins, cots)
        if kernel.launches != before + 1:
            raise AssertionError(f"{name}: the backward launched the kernel")
        ref_outs = forward(plain, ref_ins, st)
        want = torch.autograd.grad(ref_outs[:len(outs)], ref_ins, cots)
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} backward: input {i}'s gradient "
                                     f"differs from autograd through the "
                                     f"plain version, max "
                                     f"{(a - b).abs().max().item()}")
    ins = leaves(None)
    y, _ = forward(fn, ins, None)
    dy = torch.randn(y.shape, generator=gen, device=y.device).to(y.dtype)

    def backward():
        return torch.autograd.grad(y, ins, dy, retain_graph=True)

    return dict(ms=time_ms(backward, 3, flush), **device_busy(backward),
                grads_bit_equal=True, launches_forward=1,
                launches_backward=0)


def device_busy(call) -> dict:
    """The device kernels and memory copies of one `call` (after a warm-up
    call) and their summed device time, read in a `GuardedProfile` window
    (the events between its two witnesses; `retaken` counts the windows
    taken again for a lost witness); device activity only, as the call
    holds thousands of kernels and no host event is read."""
    guard = GuardedProfile(host=False)
    call()
    _, device, _ = guard.take(call)
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in device)
    return dict(kernels=len(device) - copies, copies=copies,
                busy_ms=sum(device_us(e) for e in device) / 1e3,
                retaken=guard.retaken)


def ef_leaf_sizes(cfg=None) -> list[int]:
    """The element counts of the parameter leaves of `cfg` (MiniCPM-2B's
    by default), the shapes K10 quantizes on an ef train path (twice each
    per step)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    shapes = lm.param_shapes(cfg or get_config(TRAIN["arch"]))
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


# the fused ef pass's two sums against the plain version's: per-lane f32
# block sums then doubles on the card, torch's f32 sums in the plain
# version (only the order differs; den of a bf16 g within one bf16 ulp)
EF_SUM_RTOL = 1e-6
EF_OPS_PER_ELEMENT = 22    # r + g, two codecs (|.|, max, /, rint, clamp,
                           # * s), c - g_hat, (g - g_hat)^2 and g^2 summed


def ef_sync_bytes(n: int, g_bytes: int, level: int, block: int = 256) -> int:
    """The fused ef pass's bytes: g and r read, r', out, the padded codes
    and the scales written (and the thresholds read at level 2)."""
    nb = -(-n // block)
    return n * (g_bytes + 12) + nb * block + 4 * nb * (2 if level == 2
                                                         else 1)


def unfused_ef_sync(ec, g, r, level: int):
    """The composed per-leaf sequence, the yardstick: `ef_compress_leaf_`,
    `error_sums`, `reduce_leaf(..., LEVEL_INT8)` (torch ops around two
    launches of K10 alone)."""
    g_hat = ec.ef_compress_leaf_(g, r, level)
    sums = ec.error_sums(g, g_hat)
    return ec.reduce_leaf(g_hat, "data", ec.LEVEL_INT8), sums


def check_ef_sync_leaf(dev, flush) -> dict:
    """K10's fused ef pass at each distinct leaf size of the ef train path,
    g bf16 (the train step's gradients) and r f32, at levels 1 and 2 (the
    thresholds from `ecollectives.topk_thresholds`): r', out, q2 and s2
    equal (bits) to the plain version, num and den within EF_SUM_RTOL (den
    one bf16 ulp). Timed beside its bound, the plain version and the
    unfused sequence (the composed torch ops with K10 alone) as the
    yardstick, and summed over the 12 leaves an ef step. The pass updates r
    in place, so each timed call of it (and of its plain version) starts
    from the same r, restored outside the timed region: the level-2
    thresholds are those of that r + g, the mask a real step applies. No
    single PyTorch call computes the pass. The row's top-level times are
    the 283.1 M leaf's at level 1. The train example's leaves (its ef
    path at level 1) are checked and timed alike (`example_leaves`)."""
    import torch

    from repro_torch.core import ecollectives as ec
    from repro_torch.kernels import quant_codec as qc
    leaves = ef_leaf_sizes()
    example_leaves = ef_leaf_sizes(example_train_config()[0])
    sizes = sorted(set(leaves) | set(example_leaves), reverse=True)
    gen = torch.Generator(device=dev).manual_seed(21)
    timed, worst = {}, dict(num=0.0, den_ulps=0)
    for n in sizes:
        for level in (1, 2):
            g = torch.randn(n, generator=gen, device=dev,
                            dtype=torch.bfloat16).mul_(1e-3)
            r = torch.randn(n, generator=gen, device=dev).mul_(1e-5)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            thr = ec.topk_thresholds(r + g, 0.25) if level == 2 else None
            thr_temp_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
            r_plain = r.clone()
            got = qc.ef_sync_leaf(g, r, thr)
            want = qc.ef_sync_leaf_plain(g, r_plain, thr)
            torch.cuda.synchronize()
            same = [torch.equal(r, r_plain)] + [
                torch.equal(a, b) for a, b in zip(got[:3], want[:3])]
            num_rel = abs(got[3].item() - want[3].item()) / want[3].item()
            den_ulps = abs(int(got[4].view(torch.int16))
                           - int(want[4].view(torch.int16)))
            if not all(same) or num_rel > EF_SUM_RTOL or den_ulps > 1:
                raise AssertionError(
                    f"ef_sync_leaf n={n} level={level}: r', out, q2, s2 "
                    f"equal {same}, num {num_rel} apart, den {den_ulps} "
                    f"ulps")
            worst["num"] = max(worst["num"], num_rel)
            worst["den_ulps"] = max(worst["den_ulps"], den_ulps)
            del got, want
            r0 = r_plain.copy_(r)
            ms = time_ms(lambda: qc.ef_sync_leaf(g, r, thr), 10, flush,
                         setup=lambda: r.copy_(r0))
            seam_ms = time_ms(lambda: ec.ef_sync_leaf_(g, r, level, "data"),
                              10, flush)
            plain_ms = time_ms(lambda: qc.ef_sync_leaf_plain(g, r, thr), 3,
                               flush, setup=lambda: r.copy_(r0))
            unfused_ms = time_ms(lambda: unfused_ef_sync(ec, g, r, level), 3,
                                 flush)
            b_ms, b_by = bound_ms(ef_sync_bytes(n, 2, level),
                                  EF_OPS_PER_ELEMENT * n, "float32")
            timed[f"{n}/L{level}"] = dict(
                ms=ms, seam_ms=seam_ms, plain_ms=plain_ms,
                unfused_ms=unfused_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, thresholds_temp_gb=thr_temp_gb)
            del g, r, r0, r_plain, thr
            torch.cuda.empty_cache()
    per_step = {f"L{level}": {k: sum(timed[f"{n}/L{level}"][k]
                                     for n in leaves)
                              for k in ("ms", "seam_ms", "unfused_ms",
                                        "bound_ms")}
                for level in (1, 2)}
    top = dict(timed[f"{sizes[1]}/L1"])
    return dict(name="ef_sync_leaf", route="cuda",
                source="src/repro_torch/kernels/csrc/quant_codec.cu",
                replaces="src/repro/kernels/quant_codec.py:30",
                max_abs_err=0.0, sums=dict(worst, rtol=EF_SUM_RTOL),
                **top, timed=timed, per_ef_step=per_step,
                shape=dict(n=sizes[1], block=256, g="bfloat16", r="float32",
                           level=1, leaves=leaves,
                           example_leaves=example_leaves))


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
    round refits on every 4th of its `new` rounds (K1's fused refit, one
    launch a refit; K1 alone never); dense: K2 once per
    layer in the prefill, K3 once per layer per decoded token; ssm: K9 once
    per layer in the prefill and per decoded token; hybrid: K8 once per
    layer in the prefill and per decoded token, K2 and K3 as dense but once
    per occurrence of the shared block (n_layers // attn_every)."""
    from repro_torch.kernels import ops
    want = {name: 0 for name in ops.KERNELS}
    want["sor_refit"] = new // 4
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
    """`spec["arch"]` at full width, at its full depth or
    `spec["n_layers"]`, random weights from seed 0 on the card: (cfg,
    params, seconds taken)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = get_config(spec["arch"])
    if "n_layers" in spec:            # a depth cut, listed in PERF.md
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
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

    if not peak_gb < CARD_GB:
        raise AssertionError(f"{cfg.name}: peak {peak_gb} GB")

    eng = engine()                     # prefill + first token alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_s = (total_s - prefill_s) / (new - 1)
    profile = decode_breakdown(engine, prompts)
    weight_bytes = sum(a.numel() * a.element_size()
                       for a in tree_leaves(params))
    return dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
                d_model=cfg.d_model, params=n_params,
                batch=B, prompt=Tp, new_tokens=new, n_chips=chips,
                dtype=cfg.dtype, init_s=init_s, generate_s=total_s,
                prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_s * 1e3,
                weights_gb=weight_bytes / 1e9,
                weights_read_floor_ms=weight_bytes / H100_BYTES_PER_S * 1e3,
                tokens_per_s=B * new / total_s,
                decode_tokens_per_s=B / decode_s,
                peak_mem_gb=peak_gb, launches=launches,
                expected_launches=want, summary=summary,
                first_tokens=tokens[:, :8].tolist(), profile=profile)


def host_serve_launches(cfg, new: int) -> dict:
    """`serve_launches` with the host control path: the split fit refits
    on every 4th round through K7 (reading the ring), and K1 never runs."""
    want = serve_launches(cfg, new)
    want["sor_accumulate"], want["sor_refit"] = want["sor_refit"], 0
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


def decode_breakdown(engine, prompts, steps: int = 4) -> dict:
    """Where a decode step's time goes, read through `generate` alone: a
    run of 1 + `steps` tokens less a run of 1 token (the prefill and first
    token), per decode step. On the host clock (synchronized, best of two)
    with the control round and without it, so their difference is the
    control round's cost; then in `GuardedProfile` windows (a window that
    lost a witness is taken again, `retaken`) for the device's busy
    share, the kernels that fill it, K3's part (its device ms and calls a
    step), K8's and K9's (`scan_*`) and the copy kernels' (`copy_*`: the
    cache writes of the conv and token-shift states; K8 and K9 write the
    recurrent state in place). `engine(control)` makes a fresh engine of
    the main path, with or without its controller."""
    import torch

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
    guard = GuardedProfile()

    def profiled(n):
        made = {}

        def setup():
            made["engine"] = engine(True)
            torch.cuda.synchronize()

        _, device, wall_s = guard.take(
            lambda: made["engine"].generate(prompts, n), setup=setup)
        return wall_s * 1e3, by_name(device)

    wall_1, kern_1 = profiled(1)
    wall_n, kern_n = profiled(1 + steps)
    per_kernel = {name: (calls - kern_1.get(name, (0, 0.0))[0],
                         us - kern_1.get(name, (0, 0.0))[1])
                  for name, (calls, us) in kern_n.items()}
    busy_ms = sum(us for _, us in per_kernel.values()) / 1e3 / steps
    if busy_ms <= 0.0:
        raise AssertionError(f"decode_breakdown: {busy_ms} busy ms a step")
    profiled_step_ms = (wall_n - wall_1) / steps
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][1],
                 reverse=True)[:12]
    return dict(
        steps=steps, retaken=guard.retaken, decode_step_ms=step_with,
        decode_step_without_control_ms=step_without,
        control_round_ms=step_with - step_without,
        profiled_step_ms=profiled_step_ms, device_busy_ms_per_step=busy_ms,
        device_busy_share=busy_ms / profiled_step_ms,
        top_kernels=[dict(name=name[:90], calls_per_step=calls / steps,
                          ms_per_step=us / 1e3 / steps)
                     for name, (calls, us) in top],
        decode_attention_ms_per_step=sum(
            us for name, (_, us) in per_kernel.items()
            if DECODE_ATTENTION in name) / 1e3 / steps,
        decode_attention_calls_per_step=sum(
            calls for name, (calls, _) in per_kernel.items()
            if DECODE_ATTENTION in name) / steps,
        **{f"{what}_{unit}_per_step": sum(
            (us / 1e3 if unit == "ms" else calls)
            for name, (calls, us) in per_kernel.items()
            if any(k in name for k in names)) / steps
           for what, names in (("scan", SCAN_KERNELS), ("copy", COPY_KERNELS))
           for unit in ("ms", "calls")})


# ---------------------------------------------------------------------------
# phase examples: the reference's examples on the port
# ---------------------------------------------------------------------------

# the paper's Fig 16 reductions of the 10 Gbps TX rail's power at the
# near-zero-BER and the BER <= 1e-6 boundaries (%), and the bound
# tests/test_transceiver.py holds the model to (percentage points)
PAPER_SAVINGS_PCT = {0.869: 28.4, 0.864: 29.3}
PAPER_SAVINGS_ABS = 0.2


def run_example(name: str, argv: list[str]):
    """`repro_torch.examples.<name>.main(argv)` in this process: (its
    printed text, what it returned, the kernel launches it made, its
    seconds to the last synchronize)."""
    import contextlib
    import importlib
    import io

    import torch

    from repro_torch.kernels import ops
    module = importlib.import_module(f"repro_torch.examples.{name}")
    text = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        result = module.main(argv)
    torch.cuda.synchronize()
    return (text.getvalue(), result, ops.launch_counts(),
            time.perf_counter() - t0)


def run_elastic_example(none: dict) -> dict:
    """The elastic example at its defaults on the card (gloo worlds of 4
    and then 8 ranks sharing it; its checkpoint under `build/`, removed
    after): the continuity line OK, the restored step the 10th, and rank
    0's launches exact in each world: K2, K4 and K5 once a layer a step
    (no remat), 30 steps on 4 ranks (phase 1 and the uninterrupted 20)
    and 10 on 8. Its text goes to a buffer of its own (not stdout), so it
    can run in a thread beside other phases (`Beside`)."""
    import io
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.examples import elastic_restart as ex
    ckpt_dir = ROOT / "build" / "elastic_ckpt"
    buf = io.StringIO()
    t0 = time.perf_counter()
    result = ex.main(["--ckpt-dir", str(ckpt_dir)], out=buf)
    secs = time.perf_counter() - t0
    text = buf.getvalue()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if "elastic restore onto a larger mesh: OK" not in text or \
            result["step"] != ex.STEPS:
        raise AssertionError(f"elastic_restart:\n{text}")
    L = get_config("minicpm_2b", tiny=True).n_layers
    launches = {}
    for world, steps in (("small", 3 * ex.STEPS), ("large", ex.STEPS)):
        want = dict(none, **{k: L * steps for k in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")})
        if result["launches"][world] != want:
            raise AssertionError(f"elastic_restart {world} world rank 0: "
                                 f"launches {result['launches'][world]} != "
                                 f"{want}")
        for k, v in want.items():
            launches[k] = launches.get(k, 0) + v
    return dict(seconds=secs, drift=result["drift"], l1=result["l1"],
                l2=result["l2"], save_s=result["save_s"],
                restore_s=result["restore_s"],
                ckpt_bytes=result["ckpt_bytes"], launches=launches,
                text=text.strip().splitlines())


class Beside:
    """`fn(*args)` in a thread, started beside the tiny sharded worlds
    (their rank processes and this work share the card and the host; none
    of it is timed for a claim) and joined before the next main phase:
    `tiny_routed` (the only one of them that launches kernels in this
    process, so its launch counts stay its own) and the elastic example,
    whose result joins the `examples` phase."""

    def __init__(self, fn, *args):
        import threading
        self.result, self.error = None, None
        self.thread = threading.Thread(target=self._run, args=(fn, args))
        self.thread.start()

    def _run(self, fn, args):
        try:
            self.result = fn(*args)
        except BaseException as e:      # raised again by `join`
            self.error = e

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.result


def printed_line(text: str, start: str) -> str:
    return next(line for line in text.splitlines() if line.startswith(start))


def run_examples(elastic: dict) -> dict:
    """The four examples in this process on the card, at their own
    defaults (the train example's checkpoints under `build/`, removed
    after): the case study's text equal to a cpu run's and the model's
    Fig 16 reductions within PAPER_SAVINGS_ABS of the paper's 28.4 % and
    29.3 %; quickstart's text (the achieved VDD_IO and the PMBus
    transaction count among it) equal to a cpu run's; serve_decode's
    `deterministic generation: True`, K2 once a layer a generate and K3
    once a layer a decoded token after the first (two generates); the
    train example's losses finite and falling (`improved`), its printed
    restarts, stragglers and checkpoints those of its trainer, K2, K4 and
    K5 once a layer a step run and K10's fused ef pass once a leaf a step
    run (steps re-run after a restart included), no other kernel; and
    `elastic`, the elastic example's checked run (`run_elastic_example`,
    made earlier beside the tiny sharded worlds)."""
    import shutil
    import statistics

    from repro_torch.core.transceiver import GtxLinkModel
    from repro_torch.examples import serve_decode
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    out, by_path, printed = {}, {}, {}
    none = {name: 0 for name in ops.KERNELS}

    for name in ("case_study_transceiver", "quickstart"):
        text, _, launches, secs = run_example(name, ["--device", "cuda"])
        cpu_text = run_example(name, ["--device", "cpu"])[0]
        if text != cpu_text or launches != none:
            raise AssertionError(f"{name}: the card's run printed\n{text}\n"
                                 f"the cpu's\n{cpu_text}; launches "
                                 f"{launches}")
        out[name] = dict(seconds=secs, text_equals_cpu=True)
        printed[name] = text
    model = GtxLinkModel()
    p_nom = model.rail_power_w("tx", 1.0, 10.0)
    savings = {v: 100.0 * (1.0 - model.rail_power_w("tx", v, 10.0) / p_nom)
               for v in PAPER_SAVINGS_PCT}
    for v, paper in PAPER_SAVINGS_PCT.items():
        if not abs(savings[v] - paper) <= PAPER_SAVINGS_ABS:
            raise AssertionError(f"case study: {savings[v]} % at {v} V, "
                                 f"the paper {paper} %")
    out["case_study_transceiver"].update(
        savings_pct_at={str(v): x for v, x in savings.items()},
        fig16=[line.strip() for line in
               printed["case_study_transceiver"].splitlines()
               if "saving" in line])
    line = printed_line(printed["quickstart"], "TPU VDD_IO")
    out["quickstart"].update(
        v_io_achieved=float(line.split("achieved ")[1].split(" V")[0]),
        transactions=int(line.split("(")[-1].split()[0]))

    text, _, launches, secs = run_example("serve_decode", ["--device",
                                                           "cuda"])
    L, new = serve_decode.CONFIG.n_layers, serve_decode.NEW
    want = dict(none, flash_attention_fwd=2 * L,
                decode_attention=2 * L * (new - 1))
    if "deterministic generation: True" not in text or launches != want:
        raise AssertionError(f"serve_decode: launches {launches} != {want}"
                             f"\n{text}")
    by_path["example-serve"] = launches
    out["serve_decode"] = dict(
        seconds=secs, deterministic=True, launches=launches,
        energy=printed_line(text, "energy:"),
        rails=printed_line(text, "rails after decode phase:"))

    cfg, args = example_train_config()
    ckpt_dir = ROOT / "build" / "example_ckpt"
    text, trainer, launches, secs = run_example(
        "train_voltune_lm", ["--device", "cuda", "--ckpt-dir",
                             str(ckpt_dir)])
    shutil.rmtree(ckpt_dir)
    head, tail = (float(x) for x in
                  printed_line(text, "loss:").split()[1:4:2])
    losses = [r.loss for r in trainer.log.records]
    s = trainer.summary()
    faults = (f"fault tolerance: {s['restarts']} restarts, "
              f"{s['straggler_events']} stragglers mitigated, "
              f"{s['ckpt_writes']} checkpoints")
    if not (all(math.isfinite(x) for x in losses) and tail < head
            and "(improved)" in text and faults in text
            and len(losses) == args.steps
            and s["ckpt_writes"] >= args.steps // 50):
        raise AssertionError(f"train_voltune_lm: {s}\n{text}")
    runs = len(trainer.step_times)         # re-runs after a restart too
    n_leaves = len(ef_leaf_sizes(cfg))
    want = dict(none, flash_attention_fwd=cfg.n_layers * runs,
                flash_attention_bwd_dq=cfg.n_layers * runs,
                flash_attention_bwd_dkv=cfg.n_layers * runs,
                ef_sync_leaf=n_leaves * runs)
    if launches != want:
        raise AssertionError(f"train_voltune_lm: launches {launches} != "
                             f"{want}")
    by_path["example-train"] = launches
    out["elastic_restart"] = elastic
    by_path["example-elastic"] = dict(none, **elastic["launches"])
    out["train_voltune_lm"] = dict(
        seconds=secs, steps=args.steps, steps_run=runs,
        params=sum(a.numel() for a in lm.tree_leaves(
            trainer.state["params"])),
        loss_head=head, loss_tail=tail, restarts=s["restarts"],
        straggler_events=s["straggler_events"],
        ckpt_writes=s["ckpt_writes"],
        step_ms_median=statistics.median(trainer.step_times) * 1e3,
        launches=launches, energy=printed_line(text, "energy:"),
        saving=printed_line(text, "VolTune saving"))
    return dict(out, by_path=by_path)


# ---------------------------------------------------------------------------
# phases 11, 12 and 14: the training path through Trainer.run
# ---------------------------------------------------------------------------

def train_slice(cfg, params, dev, *, chips: int, batch: int, seq: int,
                steps: int, refresh_every: int, remat: str = "full",
                opt_cfg=None):
    """The slice's training configuration: the fleet train step with
    in-graph SOR learning on a `chips`-chip fleet (margin-coupled error,
    straggler and HBM-error observables, learned three-rail control round,
    refit every `refresh_every` steps), AdamW (`opt_cfg`, by default f32
    moments), the launcher's WSD schedule, roofline profile and data
    (`FrontendData`: the vlm and encdec families' batches carry their stub
    frontend inputs). Returns
    (make_trainer, initial state, data, sor config); make_trainer(state,
    total_steps, **trainer_config) builds a `Trainer` (of the fleet's
    provenance and the given `TrainerConfig` fields) that continues from
    `state`."""
    from repro_torch.core import sor
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.core.policy import MultiRailClosedLoop
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.core.telemetry import ALL_RAIL_OBSERVABLES
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import FrontendData
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.step import (FleetStepConfig, StepConfig,
                                        make_fleet_train_step)
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           initial_plane_and_ef)
    n = sum(a.numel() for a in tree_leaves(params))
    opt_cfg = opt_cfg or adamw.AdamWConfig()
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
    # the vlm and encdec families' batches carry their stub frontends
    data = FrontendData(DataConfig(cfg.vocab_size, seq, batch), cfg)

    def make_trainer(state, total_steps, **trainer_config):
        return Trainer(step, data,
                       TrainerConfig(total_steps=total_steps, sor=scfg,
                                     fleet=fleet, device=dev,
                                     **trainer_config), state)

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


def run_tiny_train(arch: str = "minicpm_2b", seq: int = 32, steps: int = 3,
                   remat: str = "full") -> dict:
    """Tiny `arch` in f32, the same weights on cuda and cpu, `steps` fleet
    SOR steps (refit every second step) of batch 2 x `seq` through
    Trainer.run under `remat`: losses, params, plane (comp_level exact) and
    SOR estimate (usable lanes exact) allclose at TINY_TRAIN_TOL; the
    largest differences are reported."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float32")
    params = registry.build(cfg).init(
        torch.Generator(device="cpu").manual_seed(0))
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev, copy=True), params)
        make, state, _, scfg = train_slice(cfg, p, dev, chips=8, batch=2,
                                           seq=seq, steps=steps,
                                           refresh_every=2, remat=remat)
        trainer = make(state, steps)
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
    """Full-width MiniCPM-2B (cut to TRAIN["n_layers"] layers) in bf16
    through Trainer.run: one warm-up step, then TRAIN["steps"] steps whose
    launch counts are checked exactly, then a torch.profiler window of
    TRAIN["profiled_steps"]."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=TRAIN["n_layers"])
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
    want = model_launches(cfg, steps)
    want.update(fleet_stats=steps, sor_refit=refits)
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


def model_launches(cfg, passes: int, remat: str = "full") -> dict:
    """The exact launch counts of `passes` forward and backward passes of
    `cfg`: K2 and the scan (K8, K9) once a layer that runs them in the
    forward and, under remat ("full" or "group"), once more in its
    recompute; K4 and K5 once. The encdec family (which keeps every
    activation) runs attention once an encoder layer and twice a decoder
    layer (self and cross). Every other kernel never."""
    from repro_torch.kernels import ops
    L = cfg.n_layers
    if cfg.family == "encdec":
        attention, remat = (cfg.n_enc_layers or L) + 2 * L, "none"
    else:
        attention = {"ssm": 0, "hybrid": L // max(cfg.attn_every, 1)}.get(
            cfg.family, L)
    forward = 1 if remat == "none" else 2
    want = {name: 0 for name in ops.KERNELS}
    want.update(flash_attention_fwd=forward * attention * passes,
                flash_attention_bwd_dq=attention * passes,
                flash_attention_bwd_dkv=attention * passes)
    scan = {"hybrid": "mamba2_ssd", "ssm": "rwkv6_scan"}.get(cfg.family)
    if scan:
        want[scan] = forward * L * passes
    return want


def train_breakdown(make, state, steps: int, watch: tuple[str, ...] = ()
                    ) -> dict:
    """`steps` more train steps in a `GuardedProfile` window (a window
    that lost a witness is taken again, with a fresh trainer on the state
    as it then stands: `retaken`): the device's busy time per step (sum of
    device-side events), its share of the host wall time of the same
    steps, the kernels that fill it and, for each name in `watch`, the
    device ms and calls per step of the kernels whose name holds it."""
    import torch

    made = {}

    def setup():
        made["trainer"] = make(state, steps)
        torch.cuda.synchronize()

    guard = GuardedProfile()
    _, device, wall_s = guard.take(lambda: made["trainer"].run(),
                                   setup=setup)
    wall_ms = wall_s * 1e3 / steps
    kern = by_name(device)
    busy_ms = sum(us for _, us in kern.values()) / 1e3 / steps
    if busy_ms <= 0.0:
        raise AssertionError(f"train_breakdown: {busy_ms} busy ms a step")
    top = sorted(kern.items(), key=lambda kv: kv[1][1], reverse=True)[:12]
    out = dict(steps=steps, retaken=guard.retaken, profiled_step_ms=wall_ms,
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
# phases 13 and 21: checkpoints, restore and node-failure recovery
# ---------------------------------------------------------------------------

DIGEST_CHUNK = 1 << 24     # elements a digest pass takes at once


def leaf_digest(x) -> tuple:
    """A leaf's bits folded on its device: two int64 sums over its words
    (as int32, int16 or uint8 by element size), one of them weighted by
    each word's position, taken in slices of the leading axis of at most
    DIGEST_CHUNK elements (a broadcast view is read as the values it
    shows); with its shape and dtype. A host integer is itself."""
    import torch
    if not isinstance(x, torch.Tensor):
        return ("int", int(x))
    x = x.detach()
    word = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[x.element_size()]
    flat = x.reshape(1) if x.dim() == 0 else x
    rows = max(1, DIGEST_CHUNK // max(1, flat[0].numel()))
    total = weighted = torch.zeros((), dtype=torch.int64, device=x.device)
    at = 0
    for i in range(0, flat.shape[0], rows):
        w = flat[i:i + rows].reshape(-1)
        w = (w.view(torch.uint8) if w.dtype == torch.bool else w.view(word)
             ).to(torch.int64)
        pos = torch.arange(at, at + w.numel(), dtype=torch.int64,
                           device=x.device)
        total = total + w.sum()
        weighted = weighted + (w * (pos * 2654435761 % 2147483647 + 1)).sum()
        at += w.numel()
    return (str(x.dtype), tuple(x.shape), total.item(), weighted.item())


def state_digest(state) -> dict:
    """`leaf_digest` of every leaf of a trainer state, keyed as the
    checkpoint keys it (`<group>::<path>`)."""
    from repro_torch.checkpoint import ckpt
    out = {}
    for name, tree in state.items():
        ckpt._map_with_path(
            lambda path, x, name=name: out.__setitem__(
                f"{name}::{ckpt._path_key(path)}", leaf_digest(x)), tree)
    return out


def host_bits(state) -> dict:
    """Every leaf of a trainer state as bytes on the host, keyed as the
    checkpoint keys it."""
    import torch

    from repro_torch.checkpoint import ckpt
    out = {}

    def take(name, path, x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().contiguous().reshape(-1)
            x = x.view(torch.uint8) if x.numel() else x
            x = bytes(x.numpy())
        out[f"{name}::{ckpt._path_key(path)}"] = x

    for name, tree in state.items():
        ckpt._map_with_path(lambda p, x, name=name: take(name, p, x), tree)
    return out


def run_tiny_train_ckpt() -> dict:
    """Tiny MiniCPM (bf16) on cuda: three fleet SOR steps through
    Trainer.run with a checkpoint after the last. The port on the cpu
    restores it into a cpu state: every leaf bit for bit the cuda state's.
    A fresh cuda Trainer whose state starts from seed 1 `maybe_restore`s it:
    `start_step` 3 and the same bits."""
    import shutil

    import torch

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_map
    cfg = get_config("minicpm_2b", tiny=True)
    where = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(where, ignore_errors=True)

    def slice_on(dev, seed):
        params = registry.build(cfg).init(
            torch.Generator(device="cpu").manual_seed(seed))
        params = tree_map(lambda a: a.to(dev, copy=True), params)
        return train_slice(cfg, params, dev, chips=8, batch=2, seq=32,
                           steps=3, refresh_every=2)

    try:
        make, state, _, _ = slice_on("cuda", 0)
        trainer = make(state, 3, ckpt_every=3, ckpt_dir=str(where))
        trainer.run()
        if trainer.ckpt.list_steps() != [3] or trainer.ckpt_writes != 1:
            raise AssertionError(f"tiny_train_ckpt wrote "
                                 f"{trainer.ckpt.list_steps()}")
        want = host_bits(trainer.state)
        _, cpu_state, _, _ = slice_on("cpu", 1)
        step, restored = CheckpointManager(str(where)).restore(cpu_state)
        if step != 3 or host_bits(restored) != want:
            raise AssertionError("tiny_train_ckpt: the cpu restore differs "
                                 "from the cuda state")
        make1, state1, _, _ = slice_on("cuda", 1)
        fresh = make1(state1, 6, ckpt_dir=str(where))
        if not fresh.maybe_restore() or fresh.start_step != 3:
            raise AssertionError("tiny_train_ckpt: no restore on cuda")
        if host_bits(fresh.state) != want:
            raise AssertionError("tiny_train_ckpt: the cuda restore differs")
        return dict(steps=3, leaves=len(want), bytes=sum(
            len(v) for v in want.values() if isinstance(v, bytes)),
            ckpt_bytes=trainer.ckpt.timings["bytes"],
            cpu_restore="bit for bit", cuda_restore="bit for bit",
            start_step=fresh.start_step)
    finally:
        shutil.rmtree(where, ignore_errors=True)


# the main_train_ckpt run: one node failure, drawn before step 3 (the fail
# draws of steps 0-2, then 3, then 2-3 again: 0.2616, 0.2985, 0.8142,
# 0.0919, 0.6001, 0.7286 from np.random.default_rng(2))
CKPT_FAULTS = dict(fail_prob=0.15, seed=2)
CKPT_STEPS, CKPT_EVERY = 4, 2
# Zamba2-1.2B as `main_train_zamba` trains it, its depth cut from 38 to 6
# layers (one occurrence of the shared block) to keep the script inside
# its time: a checkpoint is then ~5.5 GB (bf16 params, f32 moments, the ef
# zeros; ~16.4 GB at full depth). MiniCPM-2B's is ~46 GB, and two of them
# do not fit the card machine's 80 GB of disk.
TRAIN_CKPT = dict(TRAIN_ZAMBA, n_layers=6)
CKPT_MIN_FREE_GB = 40.0       # two checkpoints beside each other
CKPT_PEAK_GB = 1.0            # peak's distance from the config's own peak
                              # before its first checkpoint


def mem_available_gb() -> float:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def run_main_train_ckpt(dev) -> dict:
    """Full-width TRAIN_CKPT (Zamba2-1.2B at 6 of its 38 layers, f32
    AdamW moments) as its `main_train_*` phase trains it, through
    Trainer.run with checkpoints (every 2 steps and after step 4, async)
    and one injected node failure before step 3: steps 0 and 1, the save
    of the state after step 1 (step_2), step 2, the failure, the restore
    of step_2, steps 2 and 3 again, the save of step_4. Holds: the state
    after the restore is the state at the step_2 save bit for bit (a digest
    of every leaf taken on the card at the save and after the restore);
    the re-run of step 2 gives the loss bits and the plane of its first
    run; restarts 1, checkpoint writes 2; launches exact for 5 steps; peak
    memory within CKPT_PEAK_GB of the peak of steps 0 and 1, before the
    first save. Reports the checkpoint's
    bytes (the ef zeros among them), the save's host-blocking snapshot and
    its background write, the restore, and the free disk and host memory
    before the phase."""
    import dataclasses
    import hashlib
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import FaultConfig
    draws = np.random.default_rng(CKPT_FAULTS["seed"]).random(6)
    fails = (draws < CKPT_FAULTS["fail_prob"]).tolist()
    if fails != [False, False, False, True, False, False]:
        raise AssertionError(f"the fault draws {draws} do not fail once, "
                             f"before step 3")
    where = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    free_gb = shutil.disk_usage(where).free / 1e9
    host_gb = mem_available_gb()
    if free_gb < CKPT_MIN_FREE_GB:
        raise RuntimeError(f"{free_gb:.1f} GB free under {where}; "
                           f"main_train_ckpt needs {CKPT_MIN_FREE_GB}")
    spec = TRAIN_CKPT
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              n_layers=spec["n_layers"])
    B, T = spec["batch"], spec["seq"]
    try:
        params = registry.build(cfg).init(
            torch.Generator(device=dev).manual_seed(0))
        n_params = sum(a.numel() for a in tree_leaves(params))
        make, state, _, scfg = train_slice(
            cfg, params, dev, chips=spec["chips"], batch=B, seq=T,
            steps=CKPT_STEPS, refresh_every=2,
            opt_cfg=adamw.AdamWConfig(state_dtype=spec["adamw_state"]))
        del params
        ef_bytes = sum(a.numel() * 4 for a in tree_leaves(state["ef"]))
        trainer = make(state, CKPT_STEPS, ckpt_every=CKPT_EVERY,
                       ckpt_dir=str(where), async_ckpt=True,
                       faults=FaultConfig(**CKPT_FAULTS))
        mgr, step_fn = trainer.ckpt, trainer.train_step
        calls, saves, restores, pre_save_peaks = [], [], [], []

        def plane_bits(plane):
            return hashlib.sha256(bytes(torch.cat([
                getattr(plane, f).view(torch.int32) for f in
                ("v_core", "v_hbm", "v_io", "comp_level", "energy_j",
                 "step")]).cpu().numpy())).hexdigest()

        def recorded_step(*args):
            out = step_fn(*args)
            i = len(calls)
            calls.append(dict(
                loss_bits=out[-1]["loss"].detach().view(torch.int32).item(),
                plane=plane_bits(out[2]), tick=out[4].tick,
                state=state_digest(dict(zip(
                    ("params", "opt", "plane", "ef", "sor"), out[:5])))
                if i in (2, 3) else None))
            return out

        save, restore = mgr.save, mgr.restore

        def recorded_save(step, state, fleet=None, **kw):
            torch.cuda.synchronize()
            pre_save_peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            digest = state_digest(state)
            t0 = time.perf_counter()
            path = save(step, state, fleet=fleet, **kw)
            saves.append(dict(step=step, digest=digest,
                              host_blocking_s=time.perf_counter() - t0,
                              snapshot_s=mgr.timings["snapshot_s"]))
            return path

        def recorded_restore(state_like, *a, **kw):
            written = dict(mgr.timings)   # the step_2 writer has finished
            step, out = restore(state_like, *a, **kw)
            restores.append(dict(step=step, digest=state_digest(out),
                                 restore_s=mgr.timings["restore_s"],
                                 restore_bytes=mgr.timings["restore_bytes"],
                                 write_s=written["write_s"],
                                 ckpt_bytes=written["bytes"]))
            return step, out

        trainer.train_step = recorded_step
        mgr.save, mgr.restore = recorded_save, recorded_restore
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        last_write_s, last_bytes = mgr.timings["write_s"], \
            mgr.timings["bytes"]
        steps_logged = [r.step for r in trainer.log.records]
        losses = [r.loss for r in trainer.log.records]

        if steps_logged != [0, 1, 2, 2, 3] or len(calls) != 5:
            raise AssertionError(f"main_train_ckpt ran steps {steps_logged}")
        if (trainer.restarts, trainer.ckpt_writes) != (1, 2) \
                or mgr.list_steps() != [2, 4]:
            raise AssertionError(
                f"main_train_ckpt: restarts {trainer.restarts}, writes "
                f"{trainer.ckpt_writes}, checkpoints {mgr.list_steps()}")
        if [s["step"] for s in saves] != [2, 4] or len(restores) != 1 \
                or restores[0]["step"] != 2:
            raise AssertionError("main_train_ckpt: saves or restore out of "
                                 "order")
        # check 1: the restored state is the saved one, bit for bit
        if restores[0]["digest"] != saves[0]["digest"]:
            bad = [k for k in saves[0]["digest"]
                   if restores[0]["digest"].get(k) != saves[0]["digest"][k]]
            raise AssertionError(f"main_train_ckpt: the restore differs from "
                                 f"the save at {bad[:8]}")
        # check 2: the re-run of step 2 repeats its first run
        first, again = calls[2], calls[3]
        if (first["loss_bits"], first["plane"]) != (again["loss_bits"],
                                                    again["plane"]):
            raise AssertionError(f"main_train_ckpt: step 2 re-ran to "
                                 f"{again} after {first}")
        rerun_state_equal = first["state"] == again["state"]
        # check 4: launches for the five steps that ran
        refits = sum(1 for c in calls if c["tick"] % scfg.refresh_every == 0)
        want = model_launches(cfg, len(calls))
        want.update(fleet_stats=len(calls), sor_refit=refits)
        if launches != want:
            raise AssertionError(f"main_train_ckpt launch counts {launches} "
                                 f"!= {want}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"main_train_ckpt losses {losses}")
        # check 5: no second state on the device
        main_peak_gb = pre_save_peaks[0]
        if abs(peak_gb - main_peak_gb) > CKPT_PEAK_GB:
            raise AssertionError(f"main_train_ckpt peak {peak_gb:.3f} GB, "
                                 f"the config's {main_peak_gb:.3f} GB "
                                 f"before its first save")
        r = restores[0]
        gb = 1e9
        return dict(
            arch=cfg.name, n_layers=cfg.n_layers, params=n_params, batch=B,
            seq=T, n_chips=spec["chips"], dtype=cfg.dtype,
            adamw_state=spec["adamw_state"], faults=CKPT_FAULTS,
            steps_logged=steps_logged, losses=losses,
            restarts=trainer.restarts, ckpt_writes=trainer.ckpt_writes,
            restore_bit_exact=True, leaves=len(saves[0]["digest"]),
            rerun_loss_bits_equal=True, rerun_plane_equal=True,
            rerun_state_equal=rerun_state_equal,
            launches=launches, expected_launches=want,
            sor_ticks=[c["tick"] for c in calls],
            peak_mem_gb=peak_gb, pre_save_peak_mem_gb=main_peak_gb,
            free_disk_gb_before=free_gb, mem_available_gb_before=host_gb,
            ckpt_bytes=r["ckpt_bytes"], ckpt_bytes_step4=last_bytes,
            ef_zero_bytes=ef_bytes,
            save_host_blocking_s=[s["host_blocking_s"] for s in saves],
            save_snapshot_s=[s["snapshot_s"] for s in saves],
            save_write_s=[r["write_s"], last_write_s],
            save_write_gb_per_s=[r["ckpt_bytes"] / gb / r["write_s"],
                                 last_bytes / gb / last_write_s],
            restore_s=r["restore_s"], restore_bytes=r["restore_bytes"],
            restore_gb_per_s=r["restore_bytes"] / gb / r["restore_s"],
            run_s=run_s, step_ms=[x * 1e3 for x in trainer.step_times])
    finally:
        shutil.rmtree(where, ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 17-20: the hybrid and ssm families' training paths
# ---------------------------------------------------------------------------

# tiny Zamba2 / RWKV6 `forward_train` gradients, cuda against cpu, f32: on
# the card the forward is K8 / K9's chunked sum (its sums in another order
# than the cpu's step-by-step plain version, ~1e-5 relative at T 80) and
# the backward the plain version's at those inputs, so the gap grows
# through the layers, the loss and the backward. Each leaf's largest gap,
# relative to its largest |grad| (measured: 3.8e-6 Zamba2, 3.0e-6 RWKV6):
TINY_GRAD_TOL = 1e-4
# the tiny families' sequence: past tiny Zamba2's 64-token window and the
# scans' 64-step chunk
TINY_FAMILY_SEQ = 80


def tiny_grad_check(arch: str) -> dict:
    """One `forward_train` gradient of tiny `arch` in f32 with per-layer
    remat (batch 2 x TINY_FAMILY_SEQ), cuda against cpu from the same
    weights: the loss within TINY_TRAIN_TOL, every leaf's gradient within
    TINY_GRAD_TOL; the cuda pass's launches exact (`model_launches`), the
    cpu pass's none."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_map
    from repro_torch.optim.adamw import get_path, leaf_paths
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float32")
    api = registry.build(cfg, remat="full")
    params = api.init(torch.Generator(device="cpu").manual_seed(0))
    batch = SyntheticLM(DataConfig(cfg.vocab_size, TINY_FAMILY_SEQ, 2)) \
        .torch_batch(0, "cpu")
    paths = leaf_paths(params)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev, copy=True).requires_grad_(), params)
        ops.reset_launch_counts()
        loss, _ = api.loss_fn(p, {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, [get_path(p, q) for q in paths])
        runs[dev] = (loss.item(), grads, ops.launch_counts())
    want = model_launches(cfg, 1)
    if runs["cuda"][2] != want or any(runs["cpu"][2].values()):
        raise AssertionError(f"tiny_train {arch} gradient launches: cuda "
                             f"{runs['cuda'][2]} (want {want}), cpu "
                             f"{runs['cpu'][2]}")
    (l_cpu, g_cpu, _), (l_gpu, g_gpu, _) = runs["cpu"], runs["cuda"]
    if not math.isclose(l_gpu, l_cpu,
                        rel_tol=TINY_TRAIN_TOL["loss"]["rtol"]):
        raise AssertionError(f"tiny_train {arch} loss {l_gpu} != {l_cpu}")
    gaps = {}
    for path, a, b in zip(paths, g_cpu, g_gpu):
        d = (a - b.cpu()).abs().max().item()
        scale = a.abs().max().item()
        if not (math.isfinite(d) and d <= TINY_GRAD_TOL * scale):
            raise AssertionError(f"tiny_train {arch} gradient {path}: max "
                                 f"gap {d}, max |grad| {scale}")
        gaps["/".join(path)] = dict(max_abs_gap=d, max_abs=scale)
    return dict(loss_cpu=l_cpu, loss_cuda=l_gpu, seq=TINY_FAMILY_SEQ,
                grad_max_rel_gap=max(g["max_abs_gap"] / g["max_abs"]
                                     for g in gaps.values()),
                grad_gaps=gaps, launches=runs["cuda"][2],
                tolerance=TINY_GRAD_TOL)


def run_tiny_train_family(arch: str) -> dict:
    """Tiny `arch` (Zamba2 or RWKV6) in f32, cuda against cpu: one
    `forward_train` gradient (`tiny_grad_check`), then three fleet SOR
    steps through Trainer.run (`run_tiny_train`) at TINY_FAMILY_SEQ."""
    return dict(grad=tiny_grad_check(arch),
                **run_tiny_train(arch, seq=TINY_FAMILY_SEQ))


def run_main_train_family(dev, spec: dict, then=None) -> dict:
    """Full-width `spec["arch"]` in bf16 through Trainer.run as
    `run_main_train`, at its full depth or `spec["n_layers"]`, under
    `spec["remat"]` (by default per layer), with `spec`'s AdamW moments
    and a refit every second step: one warm-up step, then spec["steps"]
    steps whose launch counts are checked exactly, finite losses (and a
    positive load-balance loss for the moe family) and a peak under the
    card's 80 GB; then, for the scan families (Zamba2-1.2B, RWKV6-7B), one
    step split by CUDA events (`train_step_split`), for the others one
    step in a guarded profile window (`train_breakdown`). `then(cfg,
    params)`, if given, runs on the trained weights and its dict joins the
    result."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim import adamw
    cfg = get_config(spec["arch"])
    if "n_layers" in spec:            # a depth cut, listed in PERF.md
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    remat = spec.get("remat", "full")
    B, T, steps = spec["batch"], spec["seq"], spec["steps"]
    t0 = time.perf_counter()
    params = registry.build(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    n_params = sum(a.numel() for a in tree_leaves(params))
    make, state, _, scfg = train_slice(
        cfg, params, dev, chips=spec["chips"], batch=B, seq=T, steps=steps,
        refresh_every=2, remat=remat,
        opt_cfg=adamw.AdamWConfig(state_dtype=spec["adamw_state"]))
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    warm = make(state, 1)
    warm.run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    tick0 = warm.state["sor"].tick
    trainer = make(warm.state, steps)
    del warm, state
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    refits = sum(1 for t in range(tick0 + 1, tick0 + steps + 1)
                 if t % scfg.refresh_every == 0)
    want = model_launches(cfg, steps, remat)
    want.update(fleet_stats=steps, sor_refit=refits)
    if launches != want:
        raise AssertionError(f"train {cfg.name} launch counts {launches} "
                             f"!= {want}")
    losses = [r.loss for r in trainer.log.records]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {cfg.name} losses {losses}")
    moe_aux = [r.extras.get("moe_aux") for r in trainer.log.records]
    if cfg.family == "moe" and not all(a is not None and math.isfinite(a)
                                       and a > 0 for a in moe_aux):
        raise AssertionError(f"train {cfg.name} moe_aux {moe_aux}")
    if peak_gb >= CARD_GB:
        raise AssertionError(f"train {cfg.name} peak {peak_gb} GB")
    step_s = statistics.median(trainer.step_times)
    # tokens a step through the decoder stack: the vlm's image prefix too
    tokens = B * (T + (cfg.n_img_tokens if cfg.family == "vlm" else 0))
    if cfg.family in ("hybrid", "ssm"):
        extra = dict(split=train_step_split(make, trainer.state,
                                            cfg.family))
    else:
        extra = dict(profile=train_breakdown(make, trainer.state, 1,
                                             watch=TRAIN_ATTENTION))
    if then is not None:
        extra.update(then(cfg, trainer.state["params"]))
    return dict(
        arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
        params=n_params, batch=B, seq=T, n_chips=spec["chips"],
        dtype=cfg.dtype, remat=remat, adamw_state=spec["adamw_state"],
        init_s=init_s, warmup_step_s=warm_s, steps=steps,
        step_ms_median=step_s * 1e3,
        step_ms=[x * 1e3 for x in trainer.step_times], run_s=run_s,
        tokens_per_s=tokens / step_s,
        mfu=6.0 * n_params * tokens / step_s / PEAK_FLOPS["bfloat16"],
        peak_mem_gb=peak_gb, losses=losses, moe_aux=moe_aux,
        launches=launches, expected_launches=want, sor_tick_before=tick0,
        **extra)


def train_step_split(make, state, family: str) -> dict:
    """One more train step with CUDA events around the step and around
    each call of the scan's autograd Function (its forward: K8 or K9; its
    backward: the plain version re-run and walked back) and, on the
    hybrid path, the attention's (K2; the flash backward: delta, K4, K5):
    each one's calls and summed span on the device's timeline (its
    kernels and the device's idle time between them, the host's dispatch
    where the host is behind), and the rest of the step's span."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as m2
    from repro_torch.kernels import rwkv6_scan as r6
    scan = {"hybrid": m2.Mamba2Scan, "ssm": r6.Rwkv6Scan}[family]
    hooks = {"scan_forward": (scan, "forward"),
             "scan_backward": (scan, "backward")}
    if family == "hybrid":
        hooks.update(attention_forward=(fa.FlashAttention, "forward"),
                     attention_backward=(fa.FlashAttention, "backward"))
    marks = {label: [] for label in hooks}

    def timed(fn, label):
        def call(*args):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args)
            end.record()
            marks[label].append((start, end))
            return out
        return staticmethod(call)

    saved = {label: cls.__dict__[meth] for label, (cls, meth) in hooks.items()}
    trainer = make(state, 1)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    try:
        for label, (cls, meth) in hooks.items():
            setattr(cls, meth, timed(getattr(cls, meth), label))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        trainer.run()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for label, (cls, meth) in hooks.items():
            setattr(cls, meth, saved[label])
    spans = {label: dict(calls=len(m),
                         ms=sum(s.elapsed_time(e) for s, e in m))
             for label, m in marks.items()}
    step_ms = start.elapsed_time(end)
    return dict(step_span_ms=step_ms, step_wall_ms=wall_ms, spans=spans,
                rest_ms=step_ms - sum(v["ms"] for v in spans.values()))


# ---------------------------------------------------------------------------
# phases 15-16: the error-feedback gradient sync (K10) through Trainer.run
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
    """Patch `ecollectives.ef_sync_leaf_`, the train step's one pass a
    leaf, to record each leaf's (g_hat, new residual r') on the host,
    g_hat recovered as (g + r) - r': r' = c - g_hat is exact (g_hat is 0
    or within half a scale of c: Sterbenz's lemma), so c - r' is g_hat
    bit for bit. Returns (records, restore)."""
    from repro_torch.core import ecollectives
    orig, records = ecollectives.ef_sync_leaf_, []

    def rec(g, r, *args, **kw):
        c = r + g
        got = orig(g, r, *args, **kw)
        records.append((c.sub_(r).cpu(), r.to("cpu", copy=True)))
        return got

    ecollectives.ef_sync_leaf_ = rec
    return records, lambda: setattr(ecollectives, "ef_sync_leaf_", orig)


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
    the flipped codes (`check_ef_records`), params (TINY_TRAIN_TOL); the
    fused ef pass launched exactly once per leaf per step on cuda, K10
    alone never."""
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
        if (launches["ef_sync_leaf"], launches["quantize_int8"]) != (
                n_leaves * steps, 0):
            raise AssertionError(f"tiny_train_ef {sync}: fused pass and K10 "
                                 f"launched {launches['ef_sync_leaf']} and "
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
            params_max_abs_diff=params_diff, ef_sync_leaf_launches=
            launches["ef_sync_leaf"],
            **check_ef_records(records["cpu"], records["cuda"], n_leaves,
                               level))
    out["tolerances"] = dict(TINY_EF_TOL, loss=TINY_TRAIN_TOL["loss"],
                             params=TINY_TRAIN_TOL["params"])
    return out


def run_main_train_ef(dev) -> dict:
    """Full-width MiniCPM-2B (cut to TRAIN["ef_layers"] layers) in bf16
    through Trainer.run with the error-feedback gradient sync and
    BERBounded: one warm-up step, then
    TRAIN["ef_steps"] checked steps of each of `ef_int8`, `ef_int8_topk` and
    `auto` on the same state (the last measures the compression's cost in
    the same run), exact launch counts (the fused ef pass once per leaf
    per step, K10 alone never), then a torch.profiler window of
    TRAIN["profiled_steps"] `ef_int8` steps with the fused pass's device
    time beside its bound."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=TRAIN["ef_layers"])
    B, T, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["ef_steps"]
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
                     "ef_sync_leaf": 0 if sync == "auto"
                     else n_leaves * steps})
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
    ef_bound = bound_ms(sum(ef_sync_bytes(n, 2, 1) for n in sizes),
                        EF_OPS_PER_ELEMENT * n_params, "float32")
    profile = train_breakdown(lambda st, n: make("ef_int8", st, n), state,
                              TRAIN["profiled_steps"],
                              watch=("ef_sync_leaf", "quantize_int8",
                                     *TRAIN_ATTENTION))
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
        ef_sync_bound_ms_per_step=ef_bound[0], ef_sync_bound_by=ef_bound[1],
        launches=launches, profile=profile)


# ---------------------------------------------------------------------------
# phases tiny_routed and main_routed: routed serving (serve_trace)
# ---------------------------------------------------------------------------

# cuda against cpu on the routed world: energies and the plane's rails (f32
# elementwise on equal inputs, summed in float64 on the host) within
# ROUTED_RTOL; a tick's floors and headroom within FLOOR_ATOL (K1's refit
# against its plain version on equal windows); discrete fields exactly
ROUTED_RTOL = 1e-5
ROUTED_SUMMARY_REL = 0.02      # the SLO summary where placements part
ROUTED_CHIPS = (1024, 4096)    # serve_scale's largest fleet; weak scaling
ROUTED_HOST_CHIPS = 64
ROUTED_MIGRATE_AFTER = 6
ROUTED_TICK_S = 0.0138         # a tick near the world's fleet-mean step
ROUTED_MAX_TICKS = 1500        # past the weak-scaled trace's drain


def routed_params(dev):
    """Tiny MiniCPM weights on `dev`: `serve_trace` runs no forward, the
    engine only needs them to exist."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = get_config("minicpm_2b", tiny=True)
    return cfg, registry.build(cfg).init(torch.Generator(device=dev)
                                         .manual_seed(0))


def routed_run(dev, n_chips: int, *, router="headroom", control="learned",
               batch_cap=None, decode=False, trace=None, max_ticks=900,
               warm=True, **serve_kw):
    """One routed run in the serve_router world on `dev` (fresh engine,
    warm-up, `trace` or the weak-scaled one): (engine, ledger, seconds of
    serve_trace, the world's observe)."""
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_inputs as ti

    from repro_torch.core.power_plane import StepProfile
    from repro_torch.serve.router import HeadroomRouter, RoundRobinRouter
    from repro_torch.serve.traffic import bursty_trace
    cfg, params = routed_params(dev)
    cap = ti.ROUTED_CAPACITY
    eng = ti.routed_engine(
        n_chips, dev, params=params, cfg=cfg,
        router=(HeadroomRouter(capacity=cap) if router == "headroom"
                else RoundRobinRouter(capacity=cap)),
        decode_profile=(StepProfile(**ti.ROUTED_DECODE_PROFILE)
                        if decode else None),
        control=control, batch_cap=batch_cap)
    observe = ti.routed_observe(eng.fleet_spec,
                                ti.routed_noise(n_chips, max_ticks), dev)
    if warm:
        ti.routed_warm_up(eng, observe)
    if trace is None:
        kn = ti.routed_trace_knobs(n_chips)
        trace = bursty_trace(kn.pop("n_requests"), **kn)
    if dev != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ledger = eng.serve_trace(trace, observe=observe, max_ticks=max_ticks,
                             error_bound=ti.ROUTED_BOUND, **serve_kw)
    if dev != "cpu":
        torch.cuda.synchronize()
    return eng, ledger, time.perf_counter() - t0, observe


def first_split(a, b):
    """The first request placed at another time or on another chip in
    ledger `b` than in `a`: (rid, placement tick of `a`), or None."""
    for ra, rb in zip(a.records(), b.records()):
        if (ra.t_placed_s, ra.chip) != (rb.t_placed_s, rb.chip):
            return ra.rid, ra.t_placed_s
    return None


def routed_analog_gap(ea, la, eb, lb) -> float:
    """The largest relative gap of the energies and the rails between two
    routed runs; raises past ROUTED_RTOL."""
    import numpy as np
    pairs = [(la.fleet_energy_j, lb.fleet_energy_j),
             (ea.stats.fleet_energy_j, eb.stats.fleet_energy_j)]
    pairs += [(ra.energy_j, rb.energy_j)
              for ra, rb in zip(la.records(), lb.records())]
    worst = 0.0
    for x, y in pairs:
        worst = max(worst, abs(x - y) / max(abs(y), 1e-9))
    for f in ("v_core", "v_hbm", "v_io", "energy_j"):
        x = getattr(ea.plane, f).cpu().numpy().astype(np.float64)
        y = getattr(eb.plane, f).cpu().numpy().astype(np.float64)
        worst = max(worst, float((np.abs(x - y)
                                  / np.maximum(np.abs(y), 1e-9)).max()))
    if worst > ROUTED_RTOL:
        raise AssertionError(f"routed analog gap {worst} > {ROUTED_RTOL}")
    return worst


def routed_tick_pair(cpu_eng, observe_cpu, observe_gpu, gpu_eng,
                     refit: bool) -> dict:
    """The cpu engine's plane and SOR state after its run, through the cpu
    and the cuda tick functions with the same busy fraction and tick (a
    control round that refits, or one that does not): the bundle's energy
    and step-time rows within ROUTED_RTOL, floors and headroom within
    FLOOR_ATOL, the over row exactly, the pinned rows exactly on every
    lane whose held voltage is not within FLOOR_ATOL of either floor."""
    import dataclasses

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_inputs as ti

    from repro_torch.core.power_plane import PowerPlaneState
    from repro_torch.core.sor import SorEstimate, SorState
    from repro_torch.core.telemetry import FrameHistory
    n = cpu_eng.n_chips
    st = cpu_eng._sor_state
    every = cpu_eng.controller.sor.refresh_every
    st = dataclasses.replace(st, tick=(st.tick // every) * every
                             + (every - 1 if refit else 0))

    def moved(dev):
        plane = PowerPlaneState(**{
            f.name: getattr(cpu_eng.plane, f.name).to(dev)
            for f in dataclasses.fields(PowerPlaneState)})
        h = st.history
        hist = dataclasses.replace(h, **{
            f: getattr(h, f).to(dev)
            for f in ("v", "obs", "age_s", "polled", "valid")})
        est = SorEstimate(*(getattr(st.estimate, f.name).to(dev)
                            for f in dataclasses.fields(SorEstimate)))
        return plane, SorState(history=hist, estimate=est, tick=st.tick)

    busy = (np.random.default_rng(3).integers(0, 5, n) / 4).astype(
        np.float32)
    out = {}
    for dev, eng, obs in (("cpu", cpu_eng, observe_cpu),
                          ("cuda", gpu_eng, observe_gpu)):
        fn = eng._build_serve_tick(obs, ROUTED_TICK_S, ti.ROUTED_BOUND)
        plane, state = moved(dev)
        _, s2, bundle, _, _ = fn(plane, state, torch.from_numpy(
            busy).to(dev), 7)
        out[dev] = bundle.cpu().numpy().astype(np.float64)
        assert (s2.tick % every == 0) == refit
    a, b = out["cpu"], out["cuda"]
    rel = np.abs(a[:3] - b[:3]) / np.maximum(np.abs(a[:3]), 1e-12)
    if rel.max() > ROUTED_RTOL:
        raise AssertionError(f"tick rows 0-2 differ by {rel.max()}")
    floor_gap = float(np.abs(a[4:10] - b[4:10]).max())
    if floor_gap > FLOOR_ATOL:
        raise AssertionError(f"tick floors/headroom differ by {floor_gap}")
    if not np.array_equal(a[3], b[3]):
        raise AssertionError("tick over rows differ")
    near = (np.abs(a[7:10]) < FLOOR_ATOL) | (np.abs(b[7:10]) < FLOOR_ATOL)
    if not np.array_equal(a[10:13][~near], b[10:13][~near]):
        raise AssertionError("tick pinned rows differ off the floors")
    return dict(refit=refit, rows_rel_gap=float(rel.max()),
                floor_gap=floor_gap, pinned_equal=bool(np.array_equal(
                    a[10:13], b[10:13])), lanes_at_floor=int(near.sum()))


def run_tiny_routed() -> dict:
    """Routed serving cuda against cpu on the 16-chip routed world (the
    tests' worlds, tests/test_torch_serve_trace.py): where the CPU tests
    hold the port to the reference exactly (the round-robin router in the
    learned world, fused and loop, batch_cap 4; the headroom router in the
    static world; the half-pinned migration world; the host controller
    on the loop path at 8 chips), cuda's ledger equals cpu's on every
    discrete field and the analog values within ROUTED_RTOL. The headroom
    router in the learned world: both finish every request, the first
    split (if any) is reported, the SLO summary within ROUTED_SUMMARY_REL,
    and one tick from the same state through both devices' tick
    functions (`routed_tick_pair`). The port's fused ledger equals its
    loop ledger on cuda. No kernel but K1's refit (in-graph) and K7 (the
    host controller's split fit) launches."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_inputs as ti

    from repro_torch.core.policy import Policy, RailRequest
    from repro_torch.kernels import ops
    from repro_torch.serve.traffic import bursty_trace

    def learned_trace(n_requests=24):
        return bursty_trace(n_requests, seed=ti.ROUTED_SEED,
                            quiet_rate_hz=8.0, burst_rate_hz=40.0,
                            decode_mean=48.0)

    class HalfPinned(Policy):
        """Even chips pinned at the VDD_HBM floor, odd ones at nominal."""
        name = "half-pinned"

        def decide(self, state, frame):
            import torch
            even = torch.arange(state.v_hbm.shape[0],
                                device=state.device) % 2 == 0
            return RailRequest(v_hbm=torch.where(even, 0.0,
                                                 frame.v_nom_hbm),
                               reason="pinned-at-floor")

    def half_pinned(dev):
        from repro_torch.core.hwspec import FleetSpec
        from repro_torch.core.power_plane import StepProfile
        from repro_torch.serve.engine import ServeEngine
        from repro_torch.serve.router import HeadroomRouter
        cfg, params = routed_params(dev)
        eng = ServeEngine(
            cfg, params, max_len=24,
            batch_size=2, prefill_profile=StepProfile(**ti.ROUTED_PROFILE),
            decode_profile=StepProfile(**ti.ROUTED_DECODE_PROFILE),
            fleet=FleetSpec.sample(8, seed=ti.ROUTED_SEED),
            policy=HalfPinned(), batch_cap=4, device=dev,
            router=HeadroomRouter(capacity=4, drain_pinned=False))
        t0 = time.perf_counter()
        led = eng.serve_trace(bursty_trace(
            96, seed=ti.ROUTED_SEED, quiet_rate_hz=16.0, burst_rate_hz=80.0,
            decode_mean=96.0), max_ticks=4000, migrate_after_ticks=6)
        return eng, led, time.perf_counter() - t0, None

    worlds = {
        "learned-roundrobin-fused": lambda d: routed_run(
            d, 16, router="roundrobin", trace=learned_trace()),
        "learned-roundrobin-loop": lambda d: routed_run(
            d, 16, router="roundrobin", trace=learned_trace(), fused=False),
        "learned-roundrobin-batch4": lambda d: routed_run(
            d, 16, router="roundrobin", trace=learned_trace(), batch_cap=4,
            decode=True),
        "static-headroom-fused": lambda d: routed_run(
            d, 16, control="static", trace=learned_trace()),
        "static-headroom-batch4": lambda d: routed_run(
            d, 16, control="static", trace=learned_trace(), batch_cap=4,
            decode=True),
        "half-pinned-migrate": half_pinned,
        "host-roundrobin-loop": lambda d: routed_run(
            d, 8, router="roundrobin", control="host",
            trace=learned_trace()),
    }
    out, failures = {}, []
    for name, run in worlds.items():
        ops.reset_launch_counts()
        gpu, lg, s_gpu, _ = run("cuda")
        launches = ops.launch_counts()
        cpu, lc, s_cpu, _ = run("cpu")
        a, b = ti.ledger_discrete(cpu, lc), ti.ledger_discrete(gpu, lg)
        ticks = gpu.last_trace["ticks"]
        if a != b:
            split = first_split(lc, lg)
            failures.append(f"{name}: cuda ledger differs from cpu in "
                            f"{[k for k in a if a[k] != b[k]]}; first "
                            f"split {split}; ticks {ticks} / "
                            f"{cpu.last_trace['ticks']}")
            continue
        try:
            gap = routed_analog_gap(gpu, lg, cpu, lc)
        except AssertionError as e:
            failures.append(f"{name}: {e}")
            continue
        want = {k: 0 for k in ops.KERNELS}
        if name.startswith("host"):
            want["sor_accumulate"] = (ti.ROUTED_WARMUP + ticks) // 4
        elif name.startswith("learned"):
            want["sor_refit"] = (ti.ROUTED_WARMUP + ticks) // 4
        if launches != want:
            failures.append(f"{name}: launches {launches} != {want}")
            continue
        s = lg.summary()
        out[name] = dict(equal=True, analog_rel_gap=gap, ticks=ticks,
                         completed=s["completed"],
                         migrations=s["migrations"],
                         degraded_chip_ticks=gpu.last_trace[
                             "degraded_chip_ticks"],
                         launches={k: v for k, v in launches.items() if v},
                         cuda_s=s_gpu, cpu_s=s_cpu)
    if not out.get("half-pinned-migrate", {}).get("migrations", 1):
        failures.append("the half-pinned world migrated nothing")

    # the headroom router in the learned world: placements may part at a
    # near-tie of the learned floors (K1's refit against its plain version)
    runs = {}
    for dev in ("cpu", "cuda"):
        for fused in (True, False):
            eng, led, _, obs = routed_run(dev, 16, trace=learned_trace(),
                                          fused=fused)
            runs[dev, fused] = (eng, led, obs)
    for dev in ("cpu", "cuda"):
        (ef, lf, _), (el, ll, _) = runs[dev, True], runs[dev, False]
        if ti.ledger_discrete(ef, lf) != ti.ledger_discrete(el, ll):
            raise AssertionError(f"tiny_routed {dev}: fused ledger differs "
                                 f"from the loop ledger")
    (ec, lc, oc), (eg, lg, og) = runs["cpu", True], runs["cuda", True]
    sc, sg = lc.summary(), lg.summary()
    if not sc["completed"] == sg["completed"] == len(lc):
        raise AssertionError("tiny_routed learned headroom: unfinished")
    rel = {k: abs(sg[k] - sc[k]) / abs(sc[k])
           for k in ("tokens_per_joule", "p50_latency_s", "p95_latency_s",
                     "p99_latency_s", "fleet_energy_j")}
    if max(rel.values()) > ROUTED_SUMMARY_REL:
        raise AssertionError(f"tiny_routed learned headroom: summary "
                             f"{rel}")
    split = first_split(lc, lg)
    ticks = [routed_tick_pair(ec, oc, og, eg, refit)
             for refit in (False, True)]
    out["learned-headroom"] = dict(
        fused_equals_loop=True, summary_rel_gap=rel,
        first_split=(None if split is None else dict(
            rid=split[0], t_s=split[1],
            tick=round(split[1] / ec.last_trace["tick_s"]))),
        completed=sg["completed"], tick_pairs=ticks)
    if failures:
        raise AssertionError("tiny_routed: " + "; ".join(failures)
                             + f" (passed: {json.dumps(out)})")
    return out


def routed_tick_activity(eng, observe, refit: bool) -> dict:
    """What one fused tick puts on the card and asks of the host, as the
    trace loop runs it: the busy fraction's host-to-device copy, the tick
    function, the bundle's device-to-host copy (`device_activity`), on a
    control round that refits (K1) or one that does not; and its host
    microseconds (`host_us`)."""
    import dataclasses

    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_inputs as ti
    fn = eng._serve_tick_jit(observe, ROUTED_TICK_S, ti.ROUTED_BOUND)
    st = eng._sor_state
    every = eng.controller.sor.refresh_every
    st = dataclasses.replace(st, tick=(st.tick // every) * every
                             + (every - 1 if refit else 0))
    # as the trace loop sends it: from pinned memory, without a sync
    busy = torch.from_numpy((np.arange(eng.n_chips) % 5 / 4).astype(
        np.float32)).pin_memory()

    def call():
        _, _, bundle, _, _ = fn(eng.plane, st, busy.to(
            eng.device, non_blocking=True), 0)
        return bundle.cpu().numpy()

    return dict(device_activity(call), host_us=host_us(call, 20, 3))


# the process `routed_tick_activity` reads one tick in: torch.profiler, in a
# process that has run the earlier phases and the routed traces, dropped
# more than a window's PROFILE_LEADS first kernels (every window, on the
# H100), so the tick is read in a fresh process
ROUTED_TICK_FLAG = "--routed-tick"


def run_routed_tick(dev, n_chips: int) -> dict:
    """One fused tick of the routed world at `n_chips`, after the warm-up
    and a few routed ticks: `routed_tick_activity` without and with K1's
    refit. Runs as `python3 chip_smoke.py --routed-tick N`."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_inputs as ti

    from repro_torch.serve.traffic import bursty_trace
    eng, _, _, obs = routed_run(dev, n_chips, max_ticks=20,
                                trace=bursty_trace(
                                    n_chips, seed=ti.ROUTED_SEED))
    return {"hold": routed_tick_activity(eng, obs, False),
            "refit": routed_tick_activity(eng, obs, True)}


def routed_tick_in_fresh_process(n_chips: int) -> dict:
    """`run_routed_tick` in a process of its own (ROUTED_TICK_FLAG)."""
    done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           ROUTED_TICK_FLAG, str(n_chips)],
                          capture_output=True, text=True, timeout=600)
    if done.returncode:
        raise RuntimeError(f"routed tick process failed: "
                           f"{done.stderr[-2000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def run_main_routed(dev) -> dict:
    """Routed serving at fleet size on the card: the serve_router world
    (learned, the headroom router, capacity 4, 48 warm-up rounds) at 1024
    chips with serve_scale's weak-scaled trace, unbatched; then
    `batch_cap=4` with serve_batching's decode profile on its forced-pin
    (saturating) trace weak-scaled to 1024 chips, draining only and with
    `migrate_after_ticks=6` (migration must move lanes); at 4096 chips
    unbatched (fused); per run the
    ticks, ticks/s, us a tick and a tick and chip, the SLO ledger's
    summary, peak device memory, K1's refit launches exactly (48 + ticks)
    // 4 and no other kernel, and (1024, 4096 unbatched) one tick's
    kernels, copies and syncs with and without a refit, read in a fresh
    process (`routed_tick_in_fresh_process`). Then the host
    controller's routed loop path at 64 chips (K7 exactly (48 + ticks) //
    4 launches, K1 none), and `launch/serve.py --arch qwen2p5_14b
    --fleet-chips 1024 --router headroom --batch-cap 4` in-process at full
    width and depth (its profiles from the full model's parameter count;
    no learning, so no kernel)."""
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_inputs as ti

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.traffic import bursty_trace

    def one(label, n, expect_kernel, **kw):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        eng, led, secs, _ = routed_run(dev, n, max_ticks=ROUTED_MAX_TICKS,
                                       **kw)
        launches = ops.launch_counts()
        ticks = eng.last_trace["ticks"]
        want = {k: 0 for k in ops.KERNELS}
        want[expect_kernel] = (ti.ROUTED_WARMUP + ticks) // 4
        if launches != want:
            raise AssertionError(f"main_routed {label}: launches "
                                 f"{launches} != {want}")
        s = led.summary()
        if not 0 < s["completed"] <= len(led):
            raise AssertionError(f"main_routed {label}: completed "
                                 f"{s['completed']}")
        for k in ("fleet_energy_j", "tokens_per_joule", "p99_latency_s"):
            if not math.isfinite(s[k]):
                raise AssertionError(f"main_routed {label}: {k} = {s[k]}")
        row = dict(n_chips=n, requests=len(led), ticks=ticks,
                   serve_trace_s=secs, ticks_per_s=ticks / secs,
                   us_per_tick=secs / ticks * 1e6,
                   us_per_tick_per_chip=secs / ticks / n * 1e6,
                   launches={k: v for k, v in launches.items() if v},
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   trace=eng.last_trace,
                   slo={k: s[k] for k in (
                       "completed", "placed", "defers", "defers_by_reason",
                       "tokens_out", "fleet_energy_j", "tokens_per_joule",
                       "p50_latency_s", "p95_latency_s", "p99_latency_s",
                       "mean_queue_s", "migrations", "migration_stall_s")})
        by_path[f"serve-routed-{label}"] = launches
        if label == f"{SHARD_ROUTED_CHIPS}":
            UNSHARDED_ROUTED.update(
                state=routed_state(eng), ticks=ticks,
                ticks_per_s=ticks / secs, fleet_energy_j=led.fleet_energy_j,
                energies=[r.energy_j for r in led.records()],
                discrete=json.loads(json.dumps(
                    ti.ledger_discrete(eng, led),
                    default=lambda o: o.tolist())))
        return row

    out, by_path = {}, {}
    for n in ROUTED_CHIPS:
        out[f"{n}"] = one(f"{n}", n, "sor_refit")
        out[f"{n}"]["per_tick"] = routed_tick_in_fresh_process(n)
    UNSHARDED_ROUTED["per_tick"] = out[f"{SHARD_ROUTED_CHIPS}"]["per_tick"]
    n = ROUTED_CHIPS[0]
    kn = ti.routed_migration_knobs(n)
    saturating = bursty_trace(kn.pop("n_requests"), **kn)
    for label, kw in (("batch4", dict(batch_cap=4, decode=True)),
                      ("batch4_migrate", dict(
                          batch_cap=4, decode=True,
                          migrate_after_ticks=ROUTED_MIGRATE_AFTER))):
        out[f"{n}_{label}"] = one(f"{n}-{label}", n, "sor_refit",
                                  trace=saturating, **kw)
    if not out[f"{n}_batch4_migrate"]["trace"]["migrations"]:
        raise AssertionError("main_routed: migration moved no lane")
    out[f"host_{ROUTED_HOST_CHIPS}"] = one(
        f"host-{ROUTED_HOST_CHIPS}", ROUTED_HOST_CHIPS, "sor_accumulate",
        control="host", router="roundrobin")

    # the launcher at full width and depth
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng, led = launch_serve.main(["--arch", "qwen2p5_14b", "--fleet-chips",
                                  "1024", "--router", "headroom",
                                  "--batch-cap", "4"])
    torch.cuda.synchronize()
    launcher_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"launcher: launches {launches}")
    s = led.summary()
    if s["completed"] != len(led) or not math.isfinite(
            s["tokens_per_joule"]):
        raise AssertionError(f"launcher: {s}")
    from repro_torch.models.lm import tree_leaves
    out["launcher_qwen2p5_14b_1024"] = dict(
        params=sum(a.numel() for a in tree_leaves(eng.params)),
        seconds=launcher_s, ticks=eng.last_trace["ticks"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        slo={k: s[k] for k in ("completed", "tokens_per_joule",
                               "p50_latency_s", "p99_latency_s")})
    by_path["serve-routed-launcher"] = launches
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, by_path=by_path)


# ---------------------------------------------------------------------------
# the moe, vlm and encdec families: tiny cuda-vs-cpu phases, Whisper's
# encode-then-decode serve path
# ---------------------------------------------------------------------------

# a gap between a token's k-th and (k+1)-th router probabilities below this
# is a near-tie, where the card's and the host's f32 router products may
# pick different experts (tests/test_torch_moe.py's NEAR_TIE)
NEAR_TIE = 1e-6


def moe_routes(params, tokens, cfg) -> list:
    """Each moe layer's routing of a prefill of `tokens`: (expert indices
    [B,T,K], top-(k+1) gap [B,T]) a layer, on the device of `params`."""
    import torch

    from repro_torch.models import attention, common, lm, mlp
    x = lm.embed_tokens(params, tokens, cfg)
    spec = lm.moe_spec(cfg)
    out = []
    for i in range(cfg.n_layers):
        p = lm._layer(params, i)
        h = common.rms_norm(x, p["ln1_w"], cfg.norm_eps)
        a, _ = attention.attention_full(p["attn"], h, lm.attn_spec(cfg))
        x = x + a
        h = common.rms_norm(x, p["ln2_w"], cfg.norm_eps)
        probs = torch.softmax(h.float() @ p["moe"]["router"], dim=-1)
        top = torch.topk(probs, spec.k + 1, dim=-1).values
        out.append((mlp.moe_route(p["moe"], h, spec)[1].cpu(),
                    (top[..., spec.k - 1] - top[..., spec.k]).cpu()))
        x = x + mlp.moe_apply(p["moe"], h, spec)[0]
    return out


def moe_routing_check(cfg, params, prompts) -> dict:
    """The experts each token's slots go to, layer by layer in a prefill of
    `prompts`, cuda against cpu from the same weights: equal wherever the
    host's top-(k+1) gap exceeds NEAR_TIE; the near-ties are counted."""
    import torch

    from repro_torch.models.lm import tree_map
    runs = {}
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            runs[dev] = moe_routes(tree_map(lambda a: a.to(dev), params),
                                   torch.from_numpy(prompts).to(dev), cfg)
    ties = 0
    for i, ((idx_c, gap), (idx_g, _)) in enumerate(zip(runs["cpu"],
                                                       runs["cuda"])):
        clear = gap > NEAR_TIE
        ties += int((~clear).sum())
        if not torch.equal(idx_c[clear], idx_g[clear]):
            raise AssertionError(f"{cfg.name} layer {i}: cuda routes "
                                 f"tokens to other experts than cpu")
    return dict(routing_equal=True, near_ties=ties,
                min_gap=min(float(g.min()) for _, g in runs["cpu"]),
                near_tie=NEAR_TIE)


def whisper_decode(params, frames, cfg, new: int):
    """Whisper's serve path through `registry.build(cfg).decode_fn`: encode
    the frames, the stacked cross K/V, then `new` greedy steps from token 0
    -> (tokens [B, new] numpy, seconds for encode + cross K/V, seconds for
    the steps). Times are host clock after a synchronize on the card."""
    import numpy as np
    import torch

    from repro_torch.models import encdec, registry
    api = registry.build(cfg)
    B = frames.shape[0]
    dev = frames.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        xkv = encdec.cross_kv(params, encdec.encode(params, frames, cfg),
                              cfg)
        sync()
        t1 = time.perf_counter()
        cache = api.init_decode_cache(B, new + 8, dev)
        tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        out = []
        for i in range(new):
            logits, cache = api.decode_fn(params, cache, {
                "tokens": tok, "cur_index": i, "cross_kv": xkv})
            tok = logits[:, -1, :cfg.vocab_size].argmax(-1).to(
                torch.int32)[:, None]
            out.append(tok)
        tokens = torch.cat(out, dim=1).cpu().numpy()
        t2 = time.perf_counter()
    return np.asarray(tokens), t1 - t0, t2 - t1


# tiny Whisper's encoder states and cross K/V, cuda against cpu in f32:
# sums in another order through 2 layers
WHISPER_TINY_TOL = dict(rtol=1e-4, atol=1e-5)


def run_tiny_encdec(arch: str = "whisper_base") -> dict:
    """Tiny Whisper in f32, the same weights on cuda and cpu: the encoder's
    states and the cross K/V allclose (WHISPER_TINY_TOL), 8 greedy decode
    steps with equal tokens; the cuda run's launches exact (K2 once an
    encoder layer, K3 twice a decoder layer a step)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import stub_frontend_inputs
    from repro_torch.kernels import ops
    from repro_torch.models import encdec, registry
    from repro_torch.models.lm import tree_map
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float32")
    params = registry.build(cfg).init(
        torch.Generator(device="cpu").manual_seed(0))
    frames = stub_frontend_inputs(cfg, cfg.family, 2, device="cpu")["frames"]
    new = 8
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev), params)
        f = frames.to(dev)
        with torch.no_grad():
            enc = encdec.encode(p, f, cfg)
            xkv = encdec.cross_kv(p, enc, cfg)
        ops.reset_launch_counts()
        tokens, _, _ = whisper_decode(p, f, cfg, new)
        runs[dev] = (tokens, enc.cpu(), {k: v.cpu() for k, v in xkv.items()},
                     ops.launch_counts())
    (t_cpu, e_cpu, x_cpu, _), (t_gpu, e_gpu, x_gpu, launches) = \
        runs["cpu"], runs["cuda"]
    if not np.array_equal(t_cpu, t_gpu):
        raise AssertionError(f"tiny whisper: cuda tokens {t_gpu.tolist()} "
                             f"!= cpu tokens {t_cpu.tolist()}")
    gaps = {}
    for name, a, b in (("encode", e_cpu, e_gpu), ("cross_k", x_cpu["k"],
                                                  x_gpu["k"]),
                       ("cross_v", x_cpu["v"], x_gpu["v"])):
        if not torch.allclose(a, b, **WHISPER_TINY_TOL):
            raise AssertionError(f"tiny whisper {name}: max diff "
                                 f"{(a - b).abs().max().item()}")
        gaps[name] = (a - b).abs().max().item()
    want = {name: 0 for name in ops.KERNELS}
    want.update(flash_attention_fwd=cfg.n_enc_layers,
                decode_attention=2 * cfg.n_layers * new)
    if launches != want:
        raise AssertionError(f"tiny whisper launches {launches} != {want}")
    return dict(tokens_equal=True, shape=list(t_gpu.shape),
                max_abs_diff=gaps, launches=launches,
                tolerance=WHISPER_TINY_TOL)


def run_tiny_family(arch: str) -> dict:
    """Tiny `arch` of the families this slice added (and Mistral-Large) in
    f32, cuda against cpu: serving (`run_tiny`: `ServeEngine.generate`,
    tokens equal, plane and SOR estimate allclose; Whisper:
    `run_tiny_encdec`), the MoE's routing layer by layer
    (`moe_routing_check`), and one fleet SOR train step (`run_tiny_train`,
    Mistral-Large under remat="group")."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = get_config(arch, tiny=True)
    out = dict(family=cfg.family)
    if cfg.family == "encdec":
        out["serve"] = run_tiny_encdec(arch)
    else:
        out["serve"] = run_tiny(arch)
    if cfg.family == "moe":
        f32 = dataclasses.replace(cfg, dtype="float32")
        params = registry.build(f32).init(
            torch.Generator(device="cpu").manual_seed(0))
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32)
        out["routing"] = moe_routing_check(f32, params, prompts)
    remat = "group" if arch == "mistral_large_123b" else "full"
    out["train"] = dict(remat=remat,
                        **run_tiny_train(arch, steps=1, remat=remat))
    return out


def run_main_whisper(dev) -> dict:
    """Whisper-base at full width and depth: trained as
    `run_main_train_family` (WHISPER), then served from the trained
    weights: encode the stub frames, the cross K/V, WHISPER["new"] greedy
    decode steps through `registry.build(cfg).decode_fn`, twice: equal
    tokens, exact launches (K2 once an encoder layer, K3 twice a decoder
    layer a step), the encode and per-token times, and the decode's busy
    share in a guarded profile window."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import stub_frontend_inputs
    from repro_torch.kernels import ops

    def serve(cfg, params):
        B, new = WHISPER["batch"], WHISPER["new"]
        frames = stub_frontend_inputs(cfg, cfg.family, B, device=dev)[
            "frames"]
        whisper_decode(params, frames, cfg, 2)           # warm-up
        runs = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            tokens, enc_s, dec_s = whisper_decode(params, frames, cfg, new)
            runs.append((tokens, enc_s, dec_s, ops.launch_counts(),
                         torch.cuda.max_memory_allocated() / 1e9))
        want = {name: 0 for name in ops.KERNELS}
        want.update(flash_attention_fwd=cfg.n_enc_layers,
                    decode_attention=2 * cfg.n_layers * new)
        for tokens, _, _, launches, _ in runs:
            if launches != want:
                raise AssertionError(f"whisper serve launches {launches} "
                                     f"!= {want}")
            if tokens.shape != (B, new) or tokens.min() < 0 or \
                    tokens.max() >= cfg.vocab_size:
                raise AssertionError(f"whisper tokens {tokens.shape}")
        if not np.array_equal(runs[0][0], runs[1][0]):
            raise AssertionError("whisper: two decodes of the same frames "
                                 "gave other tokens")
        guard = GuardedProfile()
        _, device, wall_s = guard.take(
            lambda: whisper_decode(params, frames, cfg, new))
        busy_ms = sum(us for _, us in by_name(device).values()) / 1e3
        return dict(serve=dict(
            batch=B, frames=cfg.enc_seq_len, new_tokens=new,
            tokens_equal=True, first_tokens=runs[0][0][:, :8].tolist(),
            encode_ms=[r[1] * 1e3 for r in runs],
            decode_ms_per_token=[r[2] * 1e3 / new for r in runs],
            peak_mem_gb=max(r[4] for r in runs), launches=runs[0][3],
            expected_launches=want, profiled_ms=wall_s * 1e3,
            device_busy_ms=busy_ms,
            device_busy_share=busy_ms / (wall_s * 1e3),
            retaken=guard.retaken))

    return run_main_train_family(dev, WHISPER, then=serve)


# ---------------------------------------------------------------------------
# sharding over torch.distributed: rank processes that share the card
# ---------------------------------------------------------------------------

# `python3 chip_smoke.py SHARD_FLAG job rank world backend dir` is one rank
# of a sharded phase (`SHARD_JOBS[job]`) in a world its parent started
# (`run_worlds`); the process group comes from a file store in `dir`
SHARD_FLAG = "--shard-rank"
SHARD_DIR = ROOT / "build" / "shard"
SHARD_RANKS = 4
SHARD_ROUTED_CHIPS = 4096
# a sharded step's state and metrics, each rank's cuda against its cpu:
# elementwise f32 on the two devices (transcendentals to an ulp) and the
# loss's sums in another order, before any refit (3 steps, refit every 4)
TINY_SHARD_RTOL = 1e-5
# main_routed's unsharded run at SHARD_ROUTED_CHIPS, as main_sharded_routed
# compares its ranks with it: the final plane and SOR state, the ledger,
# ticks/s
UNSHARDED_ROUTED: dict = {}
# the routed state the ranks' blocks are held to bit for bit
ROUTED_STATE = ("v_core", "v_hbm", "v_io", "energy_j", "comp_level",
                "step", "history_v", "history_obs", "history_age_s",
                "history_valid", "intercept", "slope", "v_frontier",
                "confidence", "n_eff")
# main_train_dp: MiniCPM-2B at full width cut to 4 of its 40 layers, one
# row of 512 tokens a rank, the 64-chip fleet 16 chips a rank, the ef int8
# sync, a warm-up step and one measured one (cut from two for the
# script's time); the SOR refits every 2 steps, so the measured step holds
# one refit
TRAIN_DP = dict(arch="minicpm_2b", n_layers=4, batch=4, seq=512, chips=64,
                steps=2, warm=1, refresh_every=2)
# the one-process oracle against the ranks: the same kernels on the same
# inputs in the same order, so params are expected equal bit for bit; the
# loss is the ranks' mean, summed by gloo in its own order
DP_LOSS_RTOL = 1e-6


def run_worlds(jobs, timeout_s: float) -> dict:
    """Start every `(job, world, backend)` of `jobs` at once, each world a
    process of this script per rank, and join them all by a deadline. A
    rank that exits non-zero, or a world past the deadline, kills every
    other rank and fails the phase with the ranks' error tails. Returns
    {job: [each rank's last JSON line]}."""
    procs = {}
    for job, world, backend in jobs:
        where = SHARD_DIR / job
        shutil.rmtree(where, ignore_errors=True)
        where.mkdir(parents=True)
        procs[job] = []
        for r in range(world):
            with open(where / f"rank{r}.out", "w") as out, \
                    open(where / f"rank{r}.err", "w") as err:
                procs[job].append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), SHARD_FLAG,
                     job, str(r), str(world), backend, str(where)],
                    stdout=out, stderr=err))
    every = [(job, r, p) for job, ps in procs.items()
             for r, p in enumerate(ps)]
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while failed is None:
            bad = [(job, r, p.returncode) for job, r, p in every
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"{bad[0][0]} rank {bad[0][1]} exited {bad[0][2]}"
            elif all(p.poll() == 0 for _, _, p in every):
                break
            elif time.monotonic() > deadline:
                failed = f"ranks still running after {timeout_s} s"
            else:
                time.sleep(0.2)
    finally:
        for _, _, p in every:
            if p.poll() is None:
                p.kill()
        for _, _, p in every:
            p.wait()
    if failed:
        tails = "\n".join(
            f"{job} rank {r}: "
            + (SHARD_DIR / job / f"rank{r}.err").read_text()[-2000:]
            for job, r, _ in every)
        raise RuntimeError(f"sharded phase: {failed}\n{tails}")
    return {job: [json.loads((SHARD_DIR / job / f"rank{r}.out").read_text()
                             .strip().splitlines()[-1])
                  for r in range(len(ps))]
            for job, ps in procs.items()}


def shard_rank(dev) -> dict:
    """One rank (SHARD_FLAG's arguments): start the process group from the
    parent's file store on the named backend, run the job, stop it."""
    import torch
    import torch.distributed as dist
    job, rank, world = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    backend, where = sys.argv[5], Path(sys.argv[6])
    sys.path.insert(0, str(ROOT / "tests"))
    torch.cuda.set_device(dev)
    # the ranks share the host's cores: two intra-op threads each
    torch.set_num_threads(2)
    dist.init_process_group(backend, init_method=f"file://{where}/store",
                            rank=rank, world_size=world)
    try:
        return dict(SHARD_JOBS[job](dev, rank, world, where), job=job,
                    rank=rank, world=world, backend=backend)
    finally:
        dist.destroy_process_group()


def equal_arrays(a: dict, b: dict, label: str) -> None:
    """Raise unless every array of `a` equals `b`'s bit for bit."""
    import numpy as np
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if not np.array_equal(x, y):
            gap = np.abs(x.astype(np.float64) - y.astype(np.float64)).max()
            raise AssertionError(f"{label}: {k} differs (max gap {gap})")


def shard_tiny_nccl(dev, rank, world, where) -> dict:
    """An NCCL world of one, the production backend's code path: the
    forced sharded paths (shard_control=True on a one-rank chips mesh)
    against the unsharded ones on the card, bit for bit: the tiny fleet
    step (3 steps of the reference test's linear model, 16 chips, the
    gathered tail), the 16-chip routed world (learned, headroom) and
    `sharded_fleet_reduce` forced through its collectives."""
    import numpy as np
    import torch
    import sharded_worlds as sw

    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_chips_mesh
    mesh = make_chips_mesh(device_type=dev.type)
    fs = FleetSpec.sample(sw.N, seed=sw.STEP_FLEET_SEED)
    runs = {}
    for label, kw in (("unsharded", {}),
                      ("sharded", dict(mesh=mesh, shard_control=True))):
        ops.reset_launch_counts()
        state, metrics = sw.run_fleet_step(*sw.fleet_step(fs, device=dev,
                                                          **kw))
        runs[label] = (sw.state_arrays(state["plane"], state["sor"]),
                       metrics, ops.launch_counts())
    (a, ma, la), (b, mb, lb) = runs["unsharded"], runs["sharded"]
    equal_arrays(a, b, "tiny_nccl fleet step")
    equal_arrays(ma, mb, "tiny_nccl fleet step metrics")
    if la != lb or lb["fleet_stats"] != sw.STEPS:
        raise AssertionError(f"tiny_nccl fleet step launches {lb} / {la}")
    serve = {}
    for label, kw in (("unsharded", {}),
                      ("sharded", dict(mesh=mesh, shard_control=True))):
        ops.reset_launch_counts()
        eng, led = sw.routed_run("headroom", device=dev, **kw)
        arrays = sw.serve_arrays(eng, led)
        arrays.pop("summary")
        serve[label] = (arrays, ops.launch_counts(), eng.last_trace["ticks"])
    (sa, sla, ta), (sb, slb, tb) = serve["unsharded"], serve["sharded"]
    if sa["discrete"] != sb["discrete"]:
        raise AssertionError("tiny_nccl routed: the ledger differs")
    for k in sa:
        if k != "discrete" and not np.array_equal(sa[k], sb[k]):
            raise AssertionError(f"tiny_nccl routed: {k} differs")
    want = {k: 0 for k in ops.KERNELS}
    want["sor_refit"] = (48 + tb) // 4
    if slb != want or sla != want:
        raise AssertionError(f"tiny_nccl routed launches {slb} / {sla} != "
                             f"{want}")
    x = torch.from_numpy(sw.reduce_input()).to(dev)
    ops.reset_launch_counts()
    got = ops.sharded_fleet_reduce(x, mesh=mesh, use_shard_map=True)
    for g, w in zip(got, ops.fleet_reduce(x)):
        if not torch.equal(g, w):
            raise AssertionError("tiny_nccl sharded_fleet_reduce differs")
    return dict(fleet_step_equal=True, routed_equal=True, ticks=tb,
                fleet_reduce_equal=True, fleet_step_launches=sw.STEPS,
                routed_refits=want["sor_refit"])


def shard_tiny_gloo(dev, rank, world, where) -> dict:
    """A gloo world of 2 sharing the card: the sharded fleet step and the
    routed world (learned, round-robin) over the two ranks on cuda and on
    cpu, each rank's cuda against its cpu (metrics and state within
    TINY_SHARD_RTOL, the ledger exact, the routed analog values within
    ROUTED_RTOL), the cuda blocks against the unsharded cuda runs' slices
    bit for bit, and the ef collectives over the bound data axis (the
    int8 sum and K10's fused pass with its codes gathered) cuda against
    cpu bit for bit."""
    import numpy as np
    import torch
    import sharded_worlds as sw

    from repro_torch.core import ecollectives as ec
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_chips_mesh, make_mesh
    import test_torch_inputs as ti
    mesh = make_chips_mesh(device_type=dev.type)
    fs = FleetSpec.sample(sw.N, seed=sw.STEP_FLEET_SEED)
    lo, hi = ops.chip_block(mesh, sw.N)
    out = {}
    step, serve, engines = {}, {}, {}
    for label, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        ops.reset_launch_counts()
        state, metrics = sw.run_fleet_step(*sw.fleet_step(fs, mesh=mesh,
                                                          device=d))
        eng, led = sw.routed_run("roundrobin", mesh=mesh, device=d)
        step[label] = (sw.state_arrays(state["plane"], state["sor"]),
                       metrics)
        engines[label] = (eng, led)
        serve[label] = ops.launch_counts()
    (ga, gm), (ca, cm) = step["cuda"], step["cpu"]
    worst = 0.0
    for k in ga:
        x = np.asarray(ga[k], np.float64)
        y = np.asarray(ca[k], np.float64)
        worst = max(worst, float((np.abs(x - y) / np.maximum(np.abs(y),
                                                            1e-9)).max()))
    for k in gm:
        x, y = np.asarray(gm[k], np.float64), np.asarray(cm[k], np.float64)
        worst = max(worst, float((np.abs(x - y) / np.maximum(np.abs(y),
                                                            1e-9)).max()))
    if worst > TINY_SHARD_RTOL:
        raise AssertionError(f"tiny_gloo fleet step cuda vs cpu {worst}")
    (eg, lg), (ec_, lc) = engines["cuda"], engines["cpu"]
    if ti.ledger_discrete(eg, lg) != ti.ledger_discrete(ec_, lc):
        raise AssertionError("tiny_gloo routed: cuda ledger differs")
    gap = routed_analog_gap(eg, lg, ec_, lc)
    want = {k: 0 for k in ops.KERNELS}
    want.update(fleet_stats=sw.STEPS,
                sor_refit=(48 + eg.last_trace["ticks"]) // 4)
    if serve["cuda"] != want:
        raise AssertionError(f"tiny_gloo launches {serve['cuda']} != "
                             f"{want}")
    # the cuda blocks against the unsharded cuda runs' slices
    state, metrics = sw.run_fleet_step(*sw.fleet_step(fs, device=dev))
    whole = sw.state_arrays(state["plane"], state["sor"])
    equal_arrays(ga, {k: (np.asarray(v)[..., lo:hi] if np.ndim(v) else v)
                      for k, v in whole.items()}, "tiny_gloo block")
    equal_arrays({k: v for k, v in gm.items() if k.startswith("fleet/")},
                 {k: v for k, v in metrics.items() if k.startswith("fleet/")},
                 "tiny_gloo tail")
    e1, l1 = sw.routed_run("roundrobin", device=dev)
    if ti.ledger_discrete(e1, l1) != ti.ledger_discrete(eg, lg):
        raise AssertionError("tiny_gloo routed: sharded ledger differs "
                             "from the unsharded one")
    for f in ("v_core", "v_hbm", "v_io", "energy_j"):
        if not torch.equal(getattr(e1.plane, f)[lo:hi],
                           getattr(eg.plane, f)):
            raise AssertionError(f"tiny_gloo routed: block {f} differs")
    # the ef collectives over the bound data axis, cuda against cpu
    dmesh = make_mesh((world,), ("data",), dev.type)
    group = ops.axis_group(dmesh, "data")[0]
    got = {}
    g = torch.from_numpy(sw.dp_inputs(rank, 100_000))
    r0 = torch.from_numpy(sw.dp_inputs(rank + 10, 100_000)) * 0.01
    with ec.bound_axes({"data": group}):
        for label, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            r = r0.to(d).clone()
            red, num, den = ec.ef_sync_leaf_(g.to(d), r, ec.LEVEL_INT8,
                                             "data")
            got[label] = dict(psum=ec.psum_int8(g.to(d), "data").cpu(),
                               red=red.cpu(), r=r.cpu(), num=num.cpu(),
                               den=den.cpu())
    for k in ("psum", "red", "r"):
        if not torch.equal(got["cuda"][k], got["cpu"][k]):
            raise AssertionError(f"tiny_gloo ef collective {k} differs")
    for k in ("num", "den"):
        if not torch.allclose(got["cuda"][k], got["cpu"][k], rtol=1e-6):
            raise AssertionError(f"tiny_gloo ef sums {k} differ")
    out.update(fleet_step_rel_gap=worst, routed_analog_rel_gap=gap,
               routed_ticks=eg.last_trace["ticks"], block=[lo, hi],
               launches={k: v for k, v in serve["cuda"].items() if v},
               ef_collectives_equal=True)
    return out


def routed_state(eng) -> dict:
    """A routed engine's plane and SOR state as host arrays."""
    st, p = eng._sor_state, eng.plane
    out = {f: getattr(p, f).cpu().numpy() for f in (
        "v_core", "v_hbm", "v_io", "energy_j", "comp_level", "step")}
    for f in ("v", "obs", "age_s", "valid"):
        out["history_" + f] = getattr(st.history, f).cpu().numpy()
    for f in ("intercept", "slope", "v_frontier", "confidence", "n_eff"):
        out[f] = getattr(st.estimate, f).cpu().numpy()
    return out


def lockstep_activity(call, group) -> dict:
    """`device_activity` for a call that holds collectives: every rank of
    `group` takes the same windows (a window one rank lost is taken again
    on all), so the collectives pair up."""
    import torch
    import torch.distributed as dist
    guard = GuardedProfile()

    def window(fn):
        fn()
        for attempt in range(PROFILE_TRIES):
            events, device, _ = guard._window(fn, attempt)
            marks = [i for i, e in enumerate(device)
                     if e.name == guard.witness_kernel]
            ok = torch.tensor([int(len(marks) >= 2)])
            dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
            if ok.item():
                from torch.autograd import DeviceType
                host = [e for e in events if e.device_type != DeviceType.CUDA]
                return host, device[marks[0] + 1:marks[-1]]
            guard.retaken += 1
        raise RuntimeError("lockstep_activity: a witness lost in every "
                           "window")

    def count(fn):
        host, device = window(fn)
        out = {"kernels": 0, "copies": 0, "device_us": 0.0, "syncs": 0}
        out.update(dict.fromkeys(COPY_KINDS, 0))
        for e in device:
            if e.name.startswith(("Memcpy", "Memset")):
                out["copies"] += 1
                out[next(k for k in COPY_KINDS if k in e.name or
                         k == "Memset")] += 1
            else:
                out["kernels"] += 1
            out["device_us"] += device_us(e)
        out["syncs"] = sum("Synchronize" in e.name for e in host)
        return out

    base = count(lambda: None)
    out = {k: v - base[k] for k, v in count(call).items()}
    return dict(out, retaken=guard.retaken)


def shard_routed(dev, rank, world, where) -> dict:
    """One rank of the 4096-chip routed world over SHARD_RANKS ranks
    sharing the card (main_routed's world, trace, seed and router: learned,
    headroom, capacity 4): the warm-up on the whole plane, the fused trace
    on the rank's 1024 chips with the bundles exchanged on the host. Saves
    the rank's plane and SOR state; reports the ledger, ticks/s, K1's
    refits and one tick's device activity (the tick function, the
    bundle's copy, the host all_gather and the busy fraction's copy, in
    windows every rank takes alike)."""
    import numpy as np
    import torch
    import test_torch_inputs as ti

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_chips_mesh
    from repro_torch.serve.router import HeadroomRouter
    from repro_torch.serve.traffic import bursty_trace
    mesh = make_chips_mesh(device_type=dev.type)
    n = SHARD_ROUTED_CHIPS
    cfg, params = routed_params(dev)
    ops.reset_launch_counts()
    eng = ti.routed_engine(n, dev, params=params, cfg=cfg,
                           router=HeadroomRouter(
                               capacity=ti.ROUTED_CAPACITY), mesh=mesh)
    noise = ti.routed_noise(n, ROUTED_MAX_TICKS)
    ti.routed_warm_up(eng, ti.routed_observe(eng.fleet_spec, noise, dev))
    lo, hi = eng.chip_block
    observe = ti.routed_observe(ops.shard_chip_tree(eng.fleet_spec, mesh, n),
                                noise[..., lo:hi], dev)
    kn = ti.routed_trace_knobs(n)
    trace = bursty_trace(kn.pop("n_requests"), **kn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    led = eng.serve_trace(trace, observe=observe, max_ticks=ROUTED_MAX_TICKS,
                          error_bound=ti.ROUTED_BOUND)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    ticks = eng.last_trace["ticks"]
    np.savez(where / f"state{rank}.npz", **routed_state(eng))
    # one tick on the rank, as the trace loop runs it
    fn = eng._serve_tick_jit(observe, eng.last_trace["tick_s"],
                             ti.ROUTED_BOUND)
    group = ops.host_group(mesh)
    busy = torch.from_numpy((np.arange(lo, hi) % 5 / 4).astype(
        np.float32)).pin_memory()

    def tick(refit):
        st = eng._sor_state
        every = eng.controller.sor.refresh_every
        st = type(st)(history=st.history, estimate=st.estimate,
                      tick=(st.tick // every) * every
                      + (every - 1 if refit else 0))

        def call():
            _, _, bundle, _, _ = fn(eng.plane, st, busy.to(
                dev, non_blocking=True), 0)
            return ops.gather_stack(bundle.cpu(), group).numpy()

        return call

    per_tick = {"hold": lockstep_activity(tick(False), group),
                "refit": lockstep_activity(tick(True), group)}
    s = led.summary()
    return dict(block=[lo, hi], ticks=ticks, serve_trace_s=secs,
                ticks_per_s=ticks / secs, us_per_tick=secs / ticks * 1e6,
                launches={k: v for k, v in launches.items() if v},
                discrete=ti.ledger_discrete(eng, led),
                fleet_energy_j=led.fleet_energy_j,
                energies=[r.energy_j for r in led.records()],
                slo={k: s[k] for k in ("completed", "placed", "defers",
                                       "tokens_out", "fleet_energy_j",
                                       "p99_latency_s")},
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                per_tick=per_tick)


def dp_model(dev):
    """MiniCPM-2B cut to TRAIN_DP's layers, random bf16 weights from seed
    0 on the card (the same on every rank)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = dataclasses.replace(get_config(TRAIN_DP["arch"]),
                              n_layers=TRAIN_DP["n_layers"])
    params = registry.build(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    return cfg, params


def dp_setup(cfg, params, dev, *, chips_mesh=None, data_mesh=None):
    """The main_train_dp step (the fleet train step with the ef int8 sync
    and BERBounded, the SOR on a TRAIN_DP['chips']-chip fleet, the
    launcher's schedule and profile) and its state; over the meshes when
    given (the fleet's chips over `chips_mesh`, the batch and the ef sync
    over `data_mesh`). Returns (step, state, data, loss_fn, opt_cfg,
    schedule)."""
    from repro_torch.core import sor
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.core.policy import BERBounded
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.core.telemetry import ALL_RAIL_OBSERVABLES
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.step import (FleetStepConfig, StepConfig,
                                        make_fleet_train_step,
                                        shard_fleet_state, shard_map_ef_step)
    from repro_torch.train.trainer import initial_plane_and_ef
    n = sum(a.numel() for a in tree_leaves(params))
    tokens = TRAIN_DP["batch"] * TRAIN_DP["seq"]
    fleet = FleetSpec.sample(TRAIN_DP["chips"], seed=0)
    scfg = sor.SorConfig(ingest="frames", rails=ALL_RAIL_OBSERVABLES,
                         refresh_every=TRAIN_DP["refresh_every"])
    opt_cfg = adamw.AdamWConfig()

    def sched(s):
        return wsd(s, peak_lr=3e-4, warmup_steps=10, stable_steps=7,
                   decay_steps=2)

    loss_fn = registry.build(cfg, remat="full").loss_fn
    step = make_fleet_train_step(
        loss_fn, opt_cfg, sched,
        StepProfile(6.0 * n * tokens, 14.0 * n, 4.0 * n, 4.0 * n),
        StepConfig(grad_sync="ef_int8", policy=BERBounded()),
        FleetStepConfig(spec=fleet, hbm_error_base=1e-4,
                        link_ber_floor=1e-3, sor=scfg, mesh=chips_mesh,
                        shard_control=True if chips_mesh is not None
                        else None))
    plane, ef = initial_plane_and_ef(params, fleet)
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg),
             "plane": plane, "ef": ef,
             "sor": sor.init_state(scfg, TRAIN_DP["chips"], device=dev)}
    if chips_mesh is not None:
        state = shard_fleet_state(state, chips_mesh)
    if data_mesh is not None:
        step = shard_map_ef_step(step, data_mesh)
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_DP["seq"],
                                  TRAIN_DP["batch"]))
    return step, state, data, loss_fn, opt_cfg, sched


def params_digest(params) -> list:
    from repro_torch.models.lm import tree_leaves
    return [list(leaf_digest(a)) for a in tree_leaves(params)]


def shard_train_dp(dev, rank, world, where) -> dict:
    """One rank of main_train_dp: full-width MiniCPM-2B at TRAIN_DP's
    depth, its row of the batch, its 16 of the 64 chips, the ef int8 sync
    over the data axis (K10's fused pass a leaf, its codes and scales
    all-gathered over gloo from the card, the dequantize-and-sum in rank
    order). After every step the ranks' params must be equal bit for bit
    (digests exchanged); the measured steps' launches exact. Rank 0 saves
    its final params for the parent's one-process oracle."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import ecollectives as ec
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import tree_leaves
    cfg, params = dp_model(dev)
    chips = make_mesh((world,), ("chips",), dev.type)
    data_mesh = make_mesh((world,), ("data",), dev.type)
    host = ops.host_group(chips)
    step, state, data, *_ = dp_setup(cfg, params, dev, chips_mesh=chips,
                                     data_mesh=data_mesh)
    gathered = {"bytes": 0, "seconds": 0.0}
    plain_gather = ec.gather_codes

    def timed_gather(q, s, axis_name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qg, sg = plain_gather(q, s, axis_name)
        torch.cuda.synchronize()
        gathered["seconds"] += time.perf_counter() - t0
        gathered["bytes"] += qg.numel() + sg.numel() * 4
        return qg, sg

    ec.gather_codes = timed_gather

    def same_on_every_rank(label):
        digests = [None] * world
        dist.all_gather_object(digests, params_digest(state["params"]),
                               group=host)
        if any(d != digests[0] for d in digests):
            raise AssertionError(f"main_train_dp: params differ across "
                                 f"ranks {label}")

    same_on_every_rank("at init")
    losses, step_ms, launches = [], [], None
    for i in range(TRAIN_DP["steps"]):
        if i == TRAIN_DP["warm"]:
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            gathered.update(bytes=0, seconds=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state["params"], state["opt"], state["plane"], state["ef"],
         state["sor"], metrics) = step(
            state["params"], state["opt"], state["plane"], state["ef"],
            state["sor"], data.torch_batch(i, dev))
        loss = metrics["loss"].item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        same_on_every_rank(f"after step {i}")
    launches = ops.launch_counts()
    measured = TRAIN_DP["steps"] - TRAIN_DP["warm"]
    n_leaves = sum(1 for _ in tree_leaves(state["params"]))
    want = model_launches(cfg, measured)
    want.update(ef_sync_leaf=n_leaves * measured, fleet_stats=measured,
                sor_refit=sum(1 for t in range(TRAIN_DP["warm"] + 1,
                                               TRAIN_DP["steps"] + 1)
                              if t % TRAIN_DP["refresh_every"] == 0))
    if launches != want:
        raise AssertionError(f"main_train_dp rank {rank}: launches "
                             f"{launches} != {want}")
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in
                    _flat_params(state["params"]).items()},
                   where / "params_rank0.pt")
    ec.gather_codes = plain_gather
    return dict(losses=losses, step_ms=step_ms,
                grad_error=float(metrics["grad_error"].float().mean()),
                fleet={k: float(v) for k, v in metrics.items()
                       if k.startswith("fleet/")},
                gathered_bytes_per_step=gathered["bytes"] / measured,
                gather_s_per_step=gathered["seconds"] / measured,
                launches={k: v for k, v in launches.items() if v},
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                params=sum(a.numel() for a in tree_leaves(state["params"])),
                comp_level=state["plane"].comp_level.tolist())


def _flat_params(params) -> dict:
    from repro_torch.optim.adamw import get_path, leaf_paths
    return {"/".join(p): get_path(params, p) for p in leaf_paths(params)}


def dp_oracle(dev, ranks: int) -> dict:
    """main_train_dp's sequence in one process on the card: each step,
    each rank's row through the same loss and gradient in turn, K10's fused
    pass a leaf on that rank's own residual, then the codes of every rank
    combined as `psum_int8` defines it (the dequantize-and-sum in rank
    order, over the ranks) and the same AdamW update. Returns (params,
    per-step mean losses)."""
    import torch

    from repro_torch.core import ecollectives as ec
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import get_path, leaf_paths
    from repro_torch.train.step import _accumulate_grads
    cfg, params = dp_model(dev)
    _, state, data, loss_fn, opt_cfg, sched = dp_setup(cfg, params, dev)
    paths = leaf_paths(params)
    resid = [ec.own_residuals(ec.zeros_like_residuals(params))
             for _ in range(ranks)]
    losses = []
    for i in range(TRAIN_DP["steps"]):
        batch = data.torch_batch(i, dev)
        k = batch["tokens"].shape[0] // ranks
        codes, loss_sum = [], []
        for p in range(ranks):
            rows = {key: v[p * k:(p + 1) * k] for key, v in batch.items()}
            loss, _, grads = _accumulate_grads(loss_fn, params, rows, 1)
            loss_sum.append(loss)
            mine = []
            for path in paths:
                _, q, s, _, _ = ec.ops.ef_sync_leaf(
                    get_path(grads, path).contiguous(),
                    get_path(resid[p], path))
                mine.append((q, s))
            codes.append(mine)
            del grads
        reduced: dict = {}
        for j, path in enumerate(paths):
            qg = torch.stack([codes[p][j][0] for p in range(ranks)])
            sg = torch.stack([codes[p][j][1] for p in range(ranks)])
            leaf = get_path(params, path)
            total = ec.dequantize_sum(qg, sg).reshape(-1)[:leaf.numel()]
            node = reduced
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = ec._divide(total.reshape(leaf.shape), ranks)
            for p in range(ranks):
                codes[p][j] = None
        losses.append(sum(float(x) for x in loss_sum) / ranks)
        lr = sched(state["opt"]["step"])
        adamw.apply_updates(params, reduced, state["opt"], lr, opt_cfg)
        del reduced
    return params, losses


def run_tiny_sharded() -> tuple[dict, dict, dict]:
    """tiny_sharded, tiny_fsdp and tiny_tp, run at once: an NCCL world of
    one (the forced sharded paths against the unsharded ones, bit for
    bit), a gloo world of 2 sharing the card (cuda against cpu, blocks
    against the unsharded slices), tiny_fsdp's gloo world of 4
    (`shard_tiny_fsdp`) and tiny_tp's (`shard_tiny_tp`). Returns the
    three phases' results."""
    t0 = time.perf_counter()
    res = run_worlds([("tiny_nccl", 1, "nccl"), ("tiny_gloo", 2, "gloo"),
                      ("tiny_fsdp", 4, "gloo"), ("tiny_tp", 4, "gloo")],
                     timeout_s=400)
    secs = time.perf_counter() - t0

    def summed(job):
        launches = {}
        for r in res[job]:
            for run in r["runs"].values():
                for k, v in run["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        return launches

    return (dict(nccl_world_of_one=res["tiny_nccl"][0],
                 gloo_world_of_two=res["tiny_gloo"], seconds=secs),
            dict(rank0=res["tiny_fsdp"][0]["runs"],
                 launches=summed("tiny_fsdp"),
                 ranks=len(res["tiny_fsdp"]), blocks_equal_oracle=True,
                 seconds=secs),
            dict(rank0=res["tiny_tp"][0]["runs"], launches=summed("tiny_tp"),
                 ranks=len(res["tiny_tp"]), equal_oracle=True,
                 seconds=secs))


def run_main_sharded_routed() -> dict:
    """main_sharded_routed: main_routed's 4096-chip world over SHARD_RANKS
    ranks of 1024 chips sharing the card (gloo): every rank's ledger equal
    to the unsharded run's on every discrete field, the energies equal,
    each rank's plane and SOR state equal to the unsharded run's slice bit
    for bit, K1's refits exactly (48 + ticks) // 4 a rank; ticks/s and one
    tick's device activity a rank beside the unsharded run's."""
    import numpy as np
    t0 = time.perf_counter()
    ranks = run_worlds([("routed", SHARD_RANKS, "gloo")],
                       timeout_s=420)["routed"]
    want = UNSHARDED_ROUTED
    if not want:
        raise AssertionError("main_sharded_routed: no unsharded run to hold "
                             "the ranks to (main_routed)")
    for r in ranks:
        lo, hi = r["block"]
        if json.loads(json.dumps(r["discrete"])) != want["discrete"]:
            raise AssertionError(f"main_sharded_routed rank {r['rank']}: "
                                 "the ledger differs from the unsharded "
                                 "run's")
        if r["energies"] != want["energies"] or \
                r["fleet_energy_j"] != want["fleet_energy_j"]:
            raise AssertionError(f"main_sharded_routed rank {r['rank']}: "
                                 "energies differ")
        with np.load(SHARD_DIR / "routed" / f"state{r['rank']}.npz") as z:
            for k in ROUTED_STATE:
                if not np.array_equal(z[k], want["state"][k][..., lo:hi]):
                    raise AssertionError(
                        f"main_sharded_routed rank {r['rank']}: {k} is not "
                        f"the unsharded run's slice")
        refits = (48 + r["ticks"]) // 4
        if r["launches"] != {"sor_refit": refits}:
            raise AssertionError(f"main_sharded_routed rank {r['rank']}: "
                                 f"launches {r['launches']}")
        del r["discrete"], r["energies"]
    shutil.rmtree(SHARD_DIR / "routed", ignore_errors=True)
    return dict(ranks=ranks, unsharded=dict(
        ticks=want["ticks"], ticks_per_s=want["ticks_per_s"],
        per_tick=want.get("per_tick")), state_equal=True,
        ledger_equal=True, seconds=time.perf_counter() - t0,
        launches={"sor_refit": sum(r["launches"]["sor_refit"]
                                   for r in ranks)})


def run_main_train_dp(dev) -> dict:
    """main_train_dp: TRAIN_DP over SHARD_RANKS data-parallel ranks sharing
    the card (gloo), then the one-process oracle of the same four-rank
    sequence on the card: rank 0's params after the last step against the
    oracle's bit for bit, the ranks' losses against the oracle's means
    within DP_LOSS_RTOL."""
    import torch

    from repro_torch.models.lm import tree_leaves
    t0 = time.perf_counter()
    ranks = run_worlds([("train_dp", SHARD_RANKS, "gloo")],
                       timeout_s=600)["train_dp"]
    ranks_s = time.perf_counter() - t0
    for r in ranks:
        if r["losses"] != ranks[0]["losses"]:
            raise AssertionError("main_train_dp: the ranks' losses differ")
    got = torch.load(SHARD_DIR / "train_dp" / "params_rank0.pt")
    t1 = time.perf_counter()
    params, losses = dp_oracle(dev, SHARD_RANKS)
    oracle_s = time.perf_counter() - t1
    worst = 0.0
    equal = True
    for name, leaf in _flat_params(params).items():
        a = leaf.detach().cpu()
        equal = equal and torch.equal(a, got[name])
        worst = max(worst, float((a.float() - got[name].float()).abs()
                                 .max()))
    del params, got
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(SHARD_DIR / "train_dp", ignore_errors=True)
    if not equal:
        raise AssertionError(f"main_train_dp: rank 0's params differ from "
                             f"the oracle's (max |d| {worst})")
    rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                  losses))
    if rel > DP_LOSS_RTOL:
        raise AssertionError(f"main_train_dp: loss {ranks[0]['losses']} "
                             f"against the oracle's {losses}")
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return dict(ranks=ranks, config=TRAIN_DP, oracle_losses=losses,
                oracle_loss_rel_gap=rel, params_equal_oracle=True,
                ranks_s=ranks_s, oracle_s=oracle_s, launches=launches,
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# placed (FSDP) training: tiny_fsdp and main_train_fsdp
# ---------------------------------------------------------------------------

# tiny_fsdp: each rank's blocks against the one-process run on the card bit
# for bit; that run against the same run on the cpu (elementwise f32 on
# both devices, sums in other orders; AdamW moves an element whose
# gradient is near zero by up to the learning rate: at most
# TINY_FSDP_FLIP_FRAC of a leaf, each within TINY_FSDP_FLIP_GAP)
TINY_FSDP_TOL = dict(rtol=1e-4, atol=1e-5)
TINY_FSDP_LOSS_RTOL = 1e-5
TINY_FSDP_FLIP_FRAC = 1e-3
TINY_FSDP_FLIP_GAP = 2e-3
# the MoE's router parts the devices where a token's k-th and (k+1)-th
# expert probabilities are a near-tie (ROADMAP "MoE top-k near-ties"): a
# token routed to another expert changes the gradients of many elements
# (285 of 16,384 of tiny Qwen3-MoE's wv moved, by up to 8.3e-4), so the
# MoE's params are held to the cpu run only by TINY_FSDP_FLIP_GAP per
# element, the most two AdamW steps can part them
TINY_FSDP_MOE_FLIP_FRAC = 1.0
TINY_FSDP_CPU_MESH = "data4"
TINY_FSDP_CPU_THREADS = 4
# main_train_fsdp: MiniCPM-2B at full width cut to 4 of its 40 layers (the
# ranks' memory on one card and the script's time), 4 rows of 512 tokens,
# f32 AdamW moments, StepConfig(); placed over a `(data,)` mesh of 2 gloo
# ranks for 2 steps, saved, restored onto 4 ranks for 2 more
TRAIN_FSDP = dict(arch="minicpm_2b", n_layers=4, batch=4, seq=512,
                  steps=2, save_ranks=2, restore_ranks=4)
FSDP_CKPT = ROOT / "build" / "ckpt_fsdp"
# the elastic example's bound, against the one-process oracle of the 4
# steps (which adds the ranks' gradients in the same order, so the losses
# and params are expected equal bit for bit)
FSDP_LOSS_RTOL = 1e-3


def blocks_close(got: dict, want: dict, label: str,
                 flip_frac: float = TINY_FSDP_FLIP_FRAC,
                 flip_gap: float = TINY_FSDP_FLIP_GAP) -> dict:
    """Every leaf of `got` within TINY_FSDP_TOL of `want` but for flips:
    at most `flip_frac` of the tree's elements (at least one), each within
    `flip_gap`. Returns the largest gap and the flips' count."""
    import numpy as np
    apart = size = 0
    worst = 0.0
    for path, a in _leaf_items(got):
        a, b = np.asarray(a, np.float64), np.asarray(_at(want, path))
        gap = np.abs(a - b)
        out = gap > TINY_FSDP_TOL["atol"] + TINY_FSDP_TOL["rtol"] * np.abs(b)
        if gap.max(initial=0.0) > flip_gap:
            raise AssertionError(f"{label} {path}: max gap {gap.max()}")
        apart, size = apart + int(out.sum()), size + a.size
        worst = max(worst, float(gap.max(initial=0.0)))
    if apart > max(1, flip_frac * size):
        raise AssertionError(f"{label}: {apart} of {size} elements apart")
    return dict(max_gap=worst, apart=apart, elements=size)


def shard_tiny_fsdp(dev, rank, world, where) -> dict:
    """One rank of tiny_fsdp: every family of `sharded_worlds.FSDP_ARCHS`
    (f32 tiny configs, the port's init from seed 0) through FSDP_STEPS
    placed steps on the card over each mesh of FSDP_MESHES, under
    `mesh_context`: the rank's launches exact (`model_launches`). Rank 0
    runs the one-process run on the card and holds every rank's blocks
    (gathered to it as host arrays) to that run's slices bit for bit, and
    that run to the same run on the cpu on one mesh (TINY_FSDP_CPU_MESH: a
    family's placements change only which blocks the ranks hold, and both
    meshes' blocks are held to the card's one-process run)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import sharded_worlds as sw
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as shd
    out = {}
    for arch, kw in sw.FSDP_ARCHS:
        cfg = sw.fsdp_config(get_config, arch)
        for name, (shape, axes) in sw.FSDP_MESHES.items():
            mesh = make_mesh(shape, axes, "cuda")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            got = sw.fsdp_run(arch, name, mesh, device=dev)
            secs = time.perf_counter() - t0
            launches = ops.launch_counts()
            want = model_launches(cfg, sw.FSDP_STEPS)
            if launches != want:
                raise AssertionError(f"tiny_fsdp {arch} {name} rank {rank}: "
                                     f"launches {launches} != {want}")
            every = [None] * world
            dist.all_gather_object(every, got)
            row = dict(seconds=secs, loss=got["loss"],
                       launches={k: v for k, v in launches.items() if v})
            out[f"{arch}/{name}"] = row
            if rank != 0:
                continue
            oracle = sw.fsdp_oracle(arch, name, dev)
            n_blocks = 0
            for r, theirs in enumerate(every):
                if theirs["loss"] != oracle["loss"] or \
                        theirs["grad_norm"] != oracle["grad_norm"]:
                    raise AssertionError(
                        f"tiny_fsdp {arch} {name} rank {r}: losses "
                        f"{theirs['loss']} != {oracle['loss']}")
                for key in ("params", "m"):
                    sh = shd.named_shardings(oracle[key], mesh, **kw)
                    for path, full in _leaf_items(oracle[key]):
                        block = full[shd.block_index(
                            full.shape, _at(sh, path), theirs["coord"])]
                        if not np.array_equal(_at(theirs[key], path), block):
                            raise AssertionError(
                                f"tiny_fsdp {arch} {name} rank {r}: {key} "
                                f"{path} is not the one-process run's block")
                        n_blocks += 1
            row["blocks_equal_oracle"] = n_blocks
            if name == TINY_FSDP_CPU_MESH:
                torch.set_num_threads(TINY_FSDP_CPU_THREADS)
                cpu = sw.fsdp_oracle(arch, name, "cpu")
                torch.set_num_threads(2)
                rel = max(abs(a - b) / abs(b) for a, b in
                          zip(oracle["loss"], cpu["loss"]))
                if rel > TINY_FSDP_LOSS_RTOL:
                    raise AssertionError(f"tiny_fsdp {arch} {name}: cuda "
                                         f"{oracle['loss']} cpu "
                                         f"{cpu['loss']}")
                row.update(cpu_loss_rel_gap=rel,
                           cpu=blocks_close(
                               {"params": oracle["params"],
                                "m": oracle["m"]},
                               {"params": cpu["params"], "m": cpu["m"]},
                               f"tiny_fsdp {arch} {name}",
                               TINY_FSDP_MOE_FLIP_FRAC if cfg.family == "moe"
                               else TINY_FSDP_FLIP_FRAC))
    return dict(runs=out)


def _leaf_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def fsdp_model(dev):
    """MiniCPM-2B cut to TRAIN_FSDP's layers, random bf16 weights from seed
    0 on the card (the same on every rank), its loss and step i's
    batch."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry
    cfg = dataclasses.replace(get_config(TRAIN_FSDP["arch"]),
                              n_layers=TRAIN_FSDP["n_layers"])
    params = registry.build(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_FSDP["seq"],
                                  TRAIN_FSDP["batch"]))
    return (cfg, params, registry.build(cfg, remat="full").loss_fn,
            lambda i: data.torch_batch(i, dev))


class CommMeter:
    """Seconds and bytes of the placed step's collectives on this rank:
    the gathers of its leaves' blocks along the mesh dims the forward
    takes whole (`sharding.gather_dims`: the FSDP dims; a TP block stays
    the rank's) and the gradient reduction to blocks
    (`train.step._grad_block`), each timed between two synchronizes (the
    wrappers are installed on the modules and removed by `close`)."""

    def __init__(self):
        from repro_torch.parallel import sharding as shd
        from repro_torch.train import step as step_mod
        self.mods = (shd, step_mod)
        self.plain = (shd.gather_dims, step_mod._grad_block)
        self.reset()
        shd.gather_dims = self._wrap(self.plain[0], "gather",
                                     lambda out, a: out.numel()
                                     * out.element_size())
        step_mod._grad_block = self._wrap(
            self.plain[1], "reduce",
            lambda out, a: a[0].numel() * a[0].element_size())

    def reset(self):
        self.seconds = {"gather": 0.0, "reduce": 0.0}
        self.bytes = {"gather": 0, "reduce": 0}

    def _wrap(self, fn, kind, size):
        import torch

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds[kind] += time.perf_counter() - t0
            self.bytes[kind] += size(out, a)
            return out
        return timed

    def close(self):
        self.mods[0].gather_dims, self.mods[1]._grad_block = self.plain


def fsdp_train(dev, step_fn, state, batch, first: int, steps: int,
               meter) -> dict:
    """`steps` placed steps from step `first`: losses, step ms, and the
    collectives' seconds and GB a step."""
    import torch
    losses, norms, step_ms = [], [], []
    meter.reset()
    for i in range(first, first + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state["params"], state["opt"], state["plane"], state["ef"],
         metrics) = step_fn(state["params"], state["opt"], state["plane"],
                            state["ef"], batch(i))
        losses.append(metrics["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(metrics["grad_norm"].item())
    return dict(losses=losses, grad_norms=norms, step_ms=step_ms,
                gather_s_per_step=meter.seconds["gather"] / steps,
                gather_gb_per_step=meter.bytes["gather"] / steps / 1e9,
                reduce_s_per_step=meter.seconds["reduce"] / steps,
                reduce_gb_per_step=meter.bytes["reduce"] / steps / 1e9)


def fsdp_step_fn(cfg, loss_fn, mesh):
    import sharded_worlds as sw
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import wsd
    from repro_torch.train.step import StepConfig, make_train_step
    return make_train_step(loss_fn, adamw.AdamWConfig(),
                           sw.fsdp_schedule(wsd),
                           StepProfile(**sw.DP_PROFILE), StepConfig(),
                           mesh=mesh)


def block_digests(params, coord=None, mesh_shape=None) -> dict:
    """`leaf_digest` of this rank's block of every params leaf (a placed
    tree), or of the block at `coord` of a `(data,)` mesh of `mesh_shape`
    (a whole tree)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import sharding as shd
    out = {}
    if coord is not None:
        sh = shd.named_shardings(params, shd.SpecMesh(("data",),
                                                      mesh_shape))
    for path, leaf in _leaf_items(params):
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        else:
            leaf = leaf[shd.block_index(tuple(leaf.shape), _at(sh, path),
                                        coord)]
        out["/".join(path)] = list(leaf_digest(leaf))
    return out


def shard_train_fsdp_save(dev, rank, world, where) -> dict:
    """One rank of main_train_fsdp's first world: TRAIN_FSDP's model, its
    params and f32 moments placed over a `(data,)` mesh of the world, two
    placed steps with exact launches, then the placed checkpoint (every
    rank gathers, rank 0 writes FSDP_CKPT)."""
    import torch

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.trainer import initial_plane_and_ef
    cfg, params, loss_fn, batch = fsdp_model(dev)
    mesh = make_mesh((world,), ("data",), "cuda")
    opt = adamw.init_state(params, adamw.AdamWConfig())
    plane, ef = initial_plane_and_ef(params)
    state = {"params": shd.place(params, shd.named_shardings(params, mesh)),
             "opt": shd.place(opt, shd.named_shardings(opt, mesh)),
             "plane": plane, "ef": ef}
    del params, opt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    meter = CommMeter()
    ops.reset_launch_counts()
    out = fsdp_train(dev, fsdp_step_fn(cfg, loss_fn, mesh), state, batch, 0,
                     TRAIN_FSDP["steps"], meter)
    meter.close()
    launches = ops.launch_counts()
    if launches != model_launches(cfg, TRAIN_FSDP["steps"]):
        raise AssertionError(f"main_train_fsdp rank {rank}: launches "
                             f"{launches}")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    cm = CheckpointManager(str(FSDP_CKPT))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cm.save(TRAIN_FSDP["steps"], {"params": state["params"],
                                  "opt": state["opt"]})
    out["save_s"] = time.perf_counter() - t0
    out.update(ckpt_timings=dict(cm.timings),
               launches={k: v for k, v in launches.items() if v})
    return out


def shard_train_fsdp_restore(dev, rank, world, where) -> dict:
    """One rank of main_train_fsdp's second world: FSDP_CKPT restored with
    `shardings=` onto a `(data,)` mesh of the world (each rank its block),
    two more placed steps with exact launches; the digests of the rank's
    params blocks for the parent's oracle."""
    import torch

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.trainer import initial_plane_and_ef
    cfg, _, loss_fn, batch = fsdp_model_config(dev)
    mesh = make_mesh((world,), ("data",), "cuda")
    like = {"params": registry.abstract_params(cfg)}
    like["opt"] = adamw.init_state(like["params"], adamw.AdamWConfig())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cm = CheckpointManager(str(FSDP_CKPT))
    first, state = cm.restore(like, shardings={
        k: shd.named_shardings(v, mesh) for k, v in like.items()})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state["plane"], state["ef"] = initial_plane_and_ef(state["params"])
    torch.cuda.reset_peak_memory_stats()
    meter = CommMeter()
    ops.reset_launch_counts()
    out = fsdp_train(dev, fsdp_step_fn(cfg, loss_fn, mesh), state, batch,
                     first, TRAIN_FSDP["steps"], meter)
    meter.close()
    launches = ops.launch_counts()
    if launches != model_launches(cfg, TRAIN_FSDP["steps"]):
        raise AssertionError(f"main_train_fsdp rank {rank}: launches "
                             f"{launches}")
    out.update(first_step=first, restore_s=restore_s,
               restore_timings=dict(cm.timings),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               coord=list(mesh.get_coordinate()),
               digests=block_digests(state["params"]),
               launches={k: v for k, v in launches.items() if v})
    return out


def fsdp_model_config(dev):
    """`fsdp_model` without the weights (the restored world's)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry
    cfg = dataclasses.replace(get_config(TRAIN_FSDP["arch"]),
                              n_layers=TRAIN_FSDP["n_layers"])
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_FSDP["seq"],
                                  TRAIN_FSDP["batch"]))
    return (cfg, None, registry.build(cfg, remat="full").loss_fn,
            lambda i: data.torch_batch(i, dev))


def fsdp_oracle(dev) -> dict:
    """main_train_fsdp's one-process oracle of its 4 steps on the card
    (`sharded_worlds.placed_oracle`: each step's DP ranks' rows in turn,
    their gradients added in rank order, the norm block by block, 2 ranks'
    split then 4's): its losses, norms and the digests of the params
    blocks each of the 4 restored ranks holds after the last step."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    import sharded_worlds as sw
    t0 = time.perf_counter()
    cfg, params, loss_fn, batch = fsdp_model(dev)
    n_params = sum(a.numel() for a in _leaf_values(params))
    steps = ([((TRAIN_FSDP["save_ranks"],), ("data",))] * TRAIN_FSDP["steps"]
             + [((TRAIN_FSDP["restore_ranks"],), ("data",))]
             * TRAIN_FSDP["steps"])
    out = sw.placed_oracle(cfg, params, loss_fn, batch, steps,
                           shares=False, host=False)
    # digests as the ranks' come through their JSON lines
    n = TRAIN_FSDP["restore_ranks"]
    out["digests"] = [json.loads(json.dumps(block_digests(params, (r,),
                                                          (n,))))
                      for r in range(n)]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, params=n_params, seconds=time.perf_counter() - t0)


def run_main_train_fsdp(dev) -> dict:
    """main_train_fsdp: the one-process oracle (`fsdp_oracle`), then
    TRAIN_FSDP placed over 2 gloo ranks sharing the card for 2 steps and
    saved, restored with `shardings=` onto 4 ranks for 2 more: the losses
    within FSDP_LOSS_RTOL of the oracle's and every rank's params blocks
    equal to the oracle's bit for bit (digests)."""
    t0 = time.perf_counter()
    oracle = fsdp_oracle(dev)
    shutil.rmtree(FSDP_CKPT, ignore_errors=True)
    save = run_worlds([("fsdp_save", TRAIN_FSDP["save_ranks"], "gloo")],
                      timeout_s=600)["fsdp_save"]
    ckpt_gb = sum(f.stat().st_size for f in FSDP_CKPT.rglob("*")
                  if f.is_file()) / 1e9
    t1 = time.perf_counter()
    restore = run_worlds([("fsdp_restore", TRAIN_FSDP["restore_ranks"],
                           "gloo")], timeout_s=600)["fsdp_restore"]
    ranks_s = (t1 - t0, time.perf_counter() - t1)
    shutil.rmtree(FSDP_CKPT, ignore_errors=True)
    for world in (save, restore):
        if any(r["losses"] != world[0]["losses"] for r in world):
            raise AssertionError("main_train_fsdp: the ranks' losses differ")
    differ = []
    for r in restore:
        want = oracle["digests"][r["coord"][0]]
        got = r.pop("digests")
        differ += [f"{r['rank']}:{k}" for k in want if got[k] != want[k]]
    if differ:
        raise AssertionError(
            f"main_train_fsdp: params blocks differ from the oracle's: "
            f"{differ}; losses {save[0]['losses'] + restore[0]['losses']} "
            f"norms {save[0]['grad_norms'] + restore[0]['grad_norms']}; "
            f"oracle {oracle['loss']} {oracle['grad_norm']}; worlds "
            f"{ranks_s} s; save {save[0]['save_s']} s, "
            f"restore {restore[0]['restore_s']} s, steps "
            f"{save[0]['step_ms']} {restore[0]['step_ms']} ms")
    losses = save[0]["losses"] + restore[0]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, oracle["loss"]))
    if rel > FSDP_LOSS_RTOL:
        raise AssertionError(f"main_train_fsdp: losses {losses} against the "
                             f"oracle's {oracle['loss']}")
    launches = {}
    for r in save + restore:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return dict(save_ranks=save, restore_ranks=restore, config=TRAIN_FSDP,
                params=oracle["params"], checkpoint_gb=ckpt_gb,
                oracle_losses=oracle["loss"], losses=losses,
                oracle_loss_rel_gap=rel, losses_equal_oracle=losses ==
                oracle["loss"], params_equal_oracle=True,
                worlds_s=ranks_s, oracle_s=oracle["seconds"],
                launches=launches, seconds=time.perf_counter() - t0)


def _leaf_values(tree):
    return [leaf for _, leaf in _leaf_items(tree)]


# -- tensor parallelism over 'model' (slice 21) -------------------------------------

# tiny_tp: the card's one-process split run against the cpu's, f32 tiny
# models (the same bound as tiny_fsdp's cuda against cpu). With int8
# moments a float-level gradient gap flips a moment code now and then, and
# a flipped element's update is bounded only by 1/eps
# (`tests/test_torch_tp.py` INT8_FLIP_FRAC): the flips are counted, not
# bounded
TINY_TP_LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
TINY_TP_INT8_FLIP_FRAC = 1e-3
# main_serve_tp: Qwen2.5-14B at full width and depth over 2 model ranks
# (24 of the 48 padded q heads and 8 of the 16 kv heads a rank), the main
# phase's traffic (4 prompts of 256 tokens, 32 greedy tokens), weights
# from seed 0 as `init_main` draws them. The split adds the two ranks' bf16
# partial sums where the unsharded run sums one product: the logits part
# by up to TP_LOGIT_ATOL (0.0850 measured at the first step, run 1 of PR
# 32), and a token may part from the unsharded run's only where its top-2
# gap is within twice that (the random weights' logits are flat: gaps of
# 0–0.11)
SERVE_TP = dict(arch="qwen2p5_14b", batch=4, prompt=256, new=32, ranks=2)
TP_LOGIT_ATOL = 0.25
# main_train_tp: RWKV6-7B at full width (d_model 4096, 64 heads x 64) cut
# to 4 of its 32 layers (the 4 ranks' memory on one card and the script's
# time), 4 rows of 256 tokens, f32 AdamW, StepConfig(), over (data 2,
# model 2): 32 heads a rank
TRAIN_TP = dict(arch="rwkv6_7b", n_layers=4, batch=4, seq=256, steps=2,
                shape=(2, 2))
TP_LOSS_RTOL = 1e-6


def tp_serve_launches(cfg, steps: int) -> dict:
    """The launches of `sharded_worlds.tp_serve`'s placed prefill (TP_PROMPT
    tokens: one launch a scan) and `steps` decode steps a rank (the encdec
    family has no prefill: its encoder runs once, whole, for the cross
    K/V, and the decoder attends twice a layer)."""
    from repro_torch.kernels import ops
    L = cfg.n_layers
    want = {name: 0 for name in ops.KERNELS}
    if cfg.family == "ssm":
        want["rwkv6_scan"] = L * (1 + steps)
    elif cfg.family == "hybrid":
        n_occ = L // cfg.attn_every
        want.update(mamba2_ssd=L * (1 + steps), flash_attention_fwd=n_occ,
                    decode_attention=n_occ * steps)
    elif cfg.family == "encdec":
        want.update(flash_attention_fwd=cfg.n_enc_layers or L,
                    decode_attention=2 * L * steps)
    else:
        want.update(flash_attention_fwd=L, decode_attention=L * steps)
    return want


def shard_tiny_tp(dev, rank, world, where) -> dict:
    """One rank of tiny_tp: every family of `sharded_worlds.TP_ARCHS`
    served placed (prefill, TP_NEW greedy decode steps) and the TP_TRAIN
    placed train steps (tiny Grok-1 and Mistral-Large with int8 moments)
    on the card over (data 2, model 2), the port's init from seed 0, each
    rank's launches exact. Rank 0 runs the one-process split on the card
    (`tp_serve_oracle`, `tp_train_oracle`) and holds every rank's logits,
    tokens, caches, losses and blocks to it bit for bit, and that run to
    the same run on the cpu (TINY_TP_LOGIT_TOL; train: `blocks_close`)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import sharded_worlds as sw
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as shd
    mesh = make_mesh(*sw.TP_MESH, dev.type)
    out = {}
    for arch, kw in sw.TP_ARCHS:
        cfg = sw.fsdp_config(get_config, arch)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = sw.tp_serve(arch, mesh, dev)
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()
        want = tp_serve_launches(cfg, sw.TP_NEW)
        if launches != want:
            raise AssertionError(f"tiny_tp serve {arch} rank {rank}: "
                                 f"launches {launches} != {want}")
        every = [None] * world
        dist.all_gather_object(every, got)
        row = dict(seconds=secs,
                   launches={k: v for k, v in launches.items() if v})
        out[f"serve/{arch}"] = row
        if rank != 0:
            continue
        oracle = sw.tp_serve_oracle(arch, dev)
        k = sw.TP_BATCH // sw.TP_MESH[0][0]
        for r, theirs in enumerate(every):
            want_r = oracle[theirs["coord"]]
            d = theirs["coord"][0]
            same = all(np.array_equal(a, b) for a, b in
                       zip(theirs["logits"], want_r["logits"])) and all(
                np.array_equal(a[d * k:(d + 1) * k], b) for a, b in
                zip(theirs["tokens"], want_r["tokens"])) and all(
                np.array_equal(a, _at(want_r["cache"], path))
                for path, a in _leaf_items(theirs["cache"]))
            if not same:
                raise AssertionError(f"tiny_tp serve {arch} rank {r}: not "
                                     f"the one-process split's bits")
        torch.set_num_threads(TINY_FSDP_CPU_THREADS)
        cpu = sw.tp_serve_oracle(arch, "cpu")
        torch.set_num_threads(2)
        gap = 0.0
        for coord, o in oracle.items():
            for a, b in zip(o["logits"], cpu[coord]["logits"]):
                np.testing.assert_allclose(a, b, **TINY_TP_LOGIT_TOL,
                                           err_msg=f"tiny_tp {arch}")
                gap = max(gap, float(np.abs(a - b).max()))
        row.update(ranks_equal_oracle=True, cpu_logit_gap=gap)
    for arch, dtype in sw.TP_TRAIN:
        cfg = sw.fsdp_config(get_config, arch)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = sw.tp_train_run(arch, dtype, mesh, dev)
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()
        want = model_launches(cfg, sw.FSDP_STEPS)
        if launches != want:
            raise AssertionError(f"tiny_tp train {arch} rank {rank}: "
                                 f"launches {launches} != {want}")
        if dtype == "int8" and not got["restored"]:
            raise AssertionError(f"tiny_tp {arch}: the placed int8 state "
                                 f"did not restore bit for bit")
        every = [None] * world
        dist.all_gather_object(every, got)
        row = dict(seconds=secs, loss=got["loss"], moments=dtype,
                   launches={k: v for k, v in launches.items() if v})
        out[f"train/{arch}"] = row
        if rank != 0:
            continue
        oracle = sw.tp_train_oracle(arch, dtype, dev)
        sh = shd.named_shardings(oracle["params"], mesh,
                                 **dict(sw.TP_ARCHS)[arch])
        for r, theirs in enumerate(every):
            if theirs["loss"] != oracle["loss"] or \
                    theirs["grad_norm"] != oracle["grad_norm"]:
                raise AssertionError(f"tiny_tp train {arch} rank {r}: "
                                     f"{theirs['loss']} != {oracle['loss']}")
            for path, full in _leaf_items(oracle["params"]):
                block = full[shd.block_index(full.shape, _at(sh, path),
                                             theirs["coord"])]
                if not np.array_equal(_at(theirs["params"], path), block):
                    raise AssertionError(f"tiny_tp train {arch} rank {r}: "
                                         f"params {path}")
        torch.set_num_threads(TINY_FSDP_CPU_THREADS)
        cpu = sw.tp_train_oracle(arch, dtype, "cpu")
        torch.set_num_threads(2)
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(oracle["loss"], cpu["loss"]))
        if rel > TINY_FSDP_LOSS_RTOL:
            raise AssertionError(f"tiny_tp {arch}: cuda {oracle['loss']} "
                                 f"cpu {cpu['loss']}")
        flips = ((TINY_TP_INT8_FLIP_FRAC, math.inf) if dtype == "int8"
                 else (TINY_FSDP_FLIP_FRAC, TINY_FSDP_FLIP_GAP))
        row.update(ranks_equal_oracle=True, cpu_loss_rel_gap=rel,
                   cpu=blocks_close({"params": oracle["params"]},
                                    {"params": cpu["params"]},
                                    f"tiny_tp {arch}", *flips))
    return dict(runs=out)


def tp_blocks_of(cfg, params, rank: int, size: int) -> dict:
    """This model rank's blocks of a whole parameter tree over a ('model',)
    mesh of `size` (`sharding.tp_plan`), contiguous; each whole leaf is
    dropped from `params` as its blocks are made."""
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    mesh = shd.SpecMesh(("model",), (size,))
    dims = shd._tree_map(lambda s: s.shard_dims, shd.named_shardings(
        registry.abstract_params(cfg), mesh))
    plan = shd.tp_plan(dims, ("model",), ())

    def one(leaf, d, keep):
        if not keep:
            return leaf.clone()
        n = leaf.shape[d[keep[0]]] // size
        return leaf.narrow(d[keep[0]], rank * n, n).contiguous()
    return shd._tree_map(one, params, dims, plan)


def tp_draw(cfg, dev, rank: int, size: int) -> dict:
    """`init_main`'s weights (`lm.init_lm` from seed 0 on the card: the
    embedding, the head, then each layer's draws) drawn in its order, a
    layer at a time, keeping this model rank's blocks (`tp_plan` on a
    ('model',) mesh of `size`): the rank never holds the whole model."""
    import torch

    from repro_torch.models import common, lm, registry
    from repro_torch.parallel import sharding as shd
    abstract = registry.abstract_params(cfg)
    dims = shd._tree_map(lambda s: s.shard_dims, shd.named_shardings(
        abstract, shd.SpecMesh(("model",), (size,))))
    plan = shd.tp_plan(dims, ("model",), ())

    def cut_dim(path):
        keep = shd._get_path(plan, path)
        return shd._get_path(dims, path)[keep[0]] if keep else None

    def cut(path, leaf, lead: int = 0):
        d = cut_dim(path)
        if d is None:
            return leaf
        d -= lead
        n = leaf.shape[d] // size
        return leaf.narrow(d, rank * n, n).contiguous()

    gen = torch.Generator(device=dev).manual_seed(0)
    dtype = common.default_dtype(cfg.dtype)
    Vp, D = cfg.vocab_padded, cfg.d_model
    out = {"embed": cut(("embed",), common.embed_init(gen, (Vp, D), dtype)),
           "final_norm_w": torch.ones(D, dtype=dtype, device=dev),
           "lm_head": cut(("lm_head",),
                          common.dense_init(gen, (D, Vp), D, dtype))}

    def local(path, a):
        shape = list(a.shape)
        d = cut_dim(("blocks",) + path)
        if d is not None:
            shape[d] //= size
        return torch.empty(shape, dtype=a.dtype, device=dev)

    blocks = shd._map_with_path(local, abstract["blocks"])
    for i in range(cfg.n_layers):
        layer = lm._init_block(gen, cfg, dtype)
        shd._map_with_path(lambda path, a: shd._get_path(blocks, path)[i]
                           .copy_(cut(("blocks",) + path, a, lead=1)),
                           layer)
        del layer
    out["blocks"] = blocks
    if set(abstract) != set(out):
        raise ValueError(f"tp_draw draws {sorted(out)}, not "
                         f"{sorted(abstract)}")
    return out


def tp_placed(cfg, blocks: dict, mesh) -> dict:
    """DTensors on `mesh` (a ('model',) mesh) from this rank's blocks."""
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    abstract = registry.abstract_params(cfg)
    return shd._tree_map(lambda b, sh, a: shd.from_block(b, sh,
                                                         tuple(a.shape)),
                         blocks, shd.named_shardings(abstract, mesh),
                         abstract)


def greedy_run(prefill, decode, vocab_size: int, n_vocab: int, prompts,
               new: int, *, tp=False):
    """Greedy decoding through `prefill(tokens) -> logits` and
    `decode(tokens, i) -> logits` (each the last logits, [B, 1, V] or its
    vocab block): the tokens fed, the last logits of every step (f32 on
    the host) and, on whole logits, each step's smallest top-2 gap."""
    import torch

    from repro_torch.models import common
    from repro_torch.parallel import sharding as shd
    toks, logits_out, gaps = [], [], []
    logits = prefill(prompts)
    for i in range(new):
        last = common.mask_padded_vocab(logits[:, -1].float().clone(),
                                        vocab_size, n_vocab)
        logits_out.append(last.cpu())
        if not tp:
            top2 = last.topk(2, -1).values
            gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        tok = shd.vocab_argmax(last, n_vocab)[:, None].to(torch.int32)
        toks.append(tok.cpu())
        if i + 1 < new:
            logits = decode(tok, i)
    return torch.cat(toks, 1), logits_out, gaps


def shard_serve_tp(dev, rank, world, where) -> dict:
    """One rank of main_serve_tp: SERVE_TP's model drawn a layer at a time
    keeping this rank's blocks (`tp_draw`), placed over a ('model',) mesh
    of the world, then the placed prefill and greedy decode
    (`prefill_fn` / `decode_fn`, the cache placed by `serve_cache_pspecs`)
    with the rank's launches exact, its decode timed; one more decode step
    under `roofline.op_costs` (the collectives a token); the tokens and
    the rank's logits blocks written to `where`."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    from repro_torch.roofline.op_costs import analyze_ops
    cfg = get_config(SERVE_TP["arch"])
    B, Tp, new = SERVE_TP["batch"], SERVE_TP["prompt"], SERVE_TP["new"]
    mesh = make_mesh((world,), ("model",), dev.type)
    t0 = time.perf_counter()
    params = tp_placed(cfg, tp_draw(cfg, dev, rank, world), mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_local = sum(a.to_local().numel() for a in _leaf_values(params))
    api = registry.build(cfg)
    prompts = torch.from_numpy(main_prompts(cfg, SERVE_TP)).to(dev)
    max_len = Tp + new
    state = {}

    def prefill(tok):
        logits, state["cache"], state["T"] = api.prefill_fn(params, tok,
                                                            max_len)
        return logits.to_local()

    def decode(tok, i):
        logits, state["cache"] = api.decode_fn(
            params, state["cache"], {"tokens": tok,
                                     "cur_index": state["T"] + i})
        return logits.to_local()

    # the mesh has no data axis: the batch is replicated
    with torch.no_grad(), shd.mesh_context(mesh, {"batch": None}):
        greedy_run(prefill, decode, cfg.vocab_size, cfg.vocab_padded,
                   prompts[:, :16], 2, tp=True)        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        prefill(prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tokens, logits, _ = greedy_run(prefill, decode, cfg.vocab_size,
                                       cfg.vocab_padded, prompts, new,
                                       tp=True)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        last = tokens[:, -1:].to(dev)
        costs = analyze_ops(lambda: shd.vocab_argmax(
            decode(last, new - 1)[:, -1].float(), cfg.vocab_padded))
    want = {name: 0 for name in ops.KERNELS}
    want.update(flash_attention_fwd=cfg.n_layers,
                decode_attention=cfg.n_layers * (new - 1))
    if launches != want:
        raise AssertionError(f"main_serve_tp rank {rank}: launches "
                             f"{launches} != {want}")
    np.savez(where / f"rank{rank}.npz", tokens=tokens.numpy(),
             logits=torch.stack(logits).numpy())
    return dict(coord=tuple(mesh.get_coordinate()), params_local=n_local,
                init_s=init_s, prefill_ms=prefill_s * 1e3,
                decode_ms_per_token=(total_s - prefill_s) / (new - 1) * 1e3,
                generate_s=total_s, peak_gb=peak_gb,
                collectives_per_token=dict(costs.op_counts),
                collective_bytes_per_token=dict(costs.collective_bytes),
                launches={k: v for k, v in launches.items() if v})


def run_main_serve_tp(dev, cfg, params) -> dict:
    """main_serve_tp: the unsharded path's greedy run on `params` (the main
    phase's weights: `lm.prefill` and `decode_step`, each step's logits
    and smallest top-2 gap), then SERVE_TP over gloo model ranks sharing
    the card (`shard_serve_tp`), then, after the ranks exit, the
    one-process split of the same weights (`sharding.run_model_ranks`,
    the ranks' blocks cut from `params`, which is emptied once they are
    made: the card holds the weights twice at most): every rank's tokens
    and logits equal the split's bit for bit, and the unsharded path's
    within TP_LOGIT_ATOL, its tokens equal up to the first near-tie."""
    import numpy as np
    import torch

    from repro_torch.models import lm
    from repro_torch.parallel import sharding as shd
    t0 = time.perf_counter()
    B, Tp, new = SERVE_TP["batch"], SERVE_TP["prompt"], SERVE_TP["new"]
    prompts = torch.from_numpy(main_prompts(cfg, SERVE_TP)).to(dev)
    state = {}

    def prefill(tok):
        logits, state["cache"], state["T"] = lm.prefill(params, tok, cfg,
                                                        Tp + new)
        return logits

    def decode(tok, i):
        return lm.decode_step(params, state["cache"], tok, state["T"] + i,
                              cfg)[0]

    with torch.no_grad():
        whole_tokens, whole_logits, gaps = greedy_run(
            prefill, decode, cfg.vocab_size, cfg.vocab_padded, prompts, new)
    state.clear()
    ranks = run_worlds([("serve_tp", SERVE_TP["ranks"], "gloo")],
                       timeout_s=600)["serve_tp"]
    files = [np.load(SHARD_DIR / "serve_tp" / f"rank{r}.npz")
             for r in range(SERVE_TP["ranks"])]
    m = SERVE_TP["ranks"]
    split = [tp_blocks_of(cfg, params, r, m) for r in range(m)]
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()

    def oracle(r):
        st = {}

        def pre(tok):
            logits, st["cache"], st["T"] = lm.prefill(split[r], tok, cfg,
                                                      Tp + new)
            return logits

        def dec(tok, i):
            return lm.decode_step(split[r], st["cache"], tok, st["T"] + i,
                                  cfg)[0]
        return greedy_run(pre, dec, cfg.vocab_size, cfg.vocab_padded,
                          prompts, new, tp=True)

    with torch.no_grad():
        ref = shd.run_model_ranks(m, oracle)
    del split
    gc.collect()
    torch.cuda.empty_cache()
    for r, f in enumerate(files):
        if not (np.array_equal(f["tokens"], ref[r][0].numpy())
                and np.array_equal(f["logits"],
                                   torch.stack(ref[r][1]).numpy())):
            raise AssertionError(f"main_serve_tp rank {r}: not the "
                                 f"one-process split's tokens and logits")
    joined = np.concatenate([f["logits"] for f in files], -1)
    tp_tokens, want = files[0]["tokens"], whole_tokens.numpy()
    # the inputs agree up to the first step whose token parts, so the
    # logits are held there too; a token may part only where the unsharded
    # top-2 gap is within twice the logits' tolerance
    parted = [i for i in range(new)
              if not np.array_equal(tp_tokens[:, i], want[:, i])]
    first = parted[0] if parted else new
    gap = max(float(np.abs(joined[i] - whole_logits[i].numpy()).max())
              for i in range(min(first + 1, new)))
    if gap > TP_LOGIT_ATOL:
        raise AssertionError(f"main_serve_tp: logits {gap} from the "
                             f"unsharded path's by step {first}")
    if first < new and gaps[first] > 2 * TP_LOGIT_ATOL:
        raise AssertionError(f"main_serve_tp: step {first}'s token parts "
                             f"from the unsharded path's at a top-2 gap "
                             f"of {gaps[first]}")
    return dict(config=SERVE_TP, ranks=ranks, tokens_equal_unsharded_steps=
                first, unsharded_top2_gaps=gaps, max_logit_gap=gap,
                ranks_equal_oracle=True,
                launches={k: sum(r["launches"].get(k, 0) for r in ranks)
                          for k in ranks[0]["launches"]},
                seconds=time.perf_counter() - t0)


def tp_train_model(dev):
    """TRAIN_TP's model: RWKV6-7B cut to its layers, random bf16 weights
    from seed 0 on the card (the same on every rank), its loss (remat
    "full"; the oracle's "none", the same bits) and step i's batch."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry
    cfg = dataclasses.replace(get_config(TRAIN_TP["arch"]),
                              n_layers=TRAIN_TP["n_layers"])
    params = registry.build(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_TP["seq"],
                                  TRAIN_TP["batch"]))
    return cfg, params, lambda i: data.torch_batch(i, dev)


def shard_train_tp(dev, rank, world, where) -> dict:
    """One rank of main_train_tp: TRAIN_TP's params and f32 moments placed
    over (data 2, model 2), TRAIN_TP["steps"] placed steps (the TP
    forward: K9 on the rank's 32 heads) with exact launches; the losses,
    the step times, the gathers' and reductions' seconds and bytes
    (`CommMeter`), the digests of the rank's params blocks after them;
    then one more step, not compared, under `roofline.op_costs` (the
    collectives a step by kind); the peak."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    from repro_torch.roofline.op_costs import analyze_ops
    from repro_torch.train.trainer import initial_plane_and_ef
    cfg, params, batch = tp_train_model(dev)
    mesh = make_mesh(TRAIN_TP["shape"], ("data", "model"), dev.type)
    plane, ef = initial_plane_and_ef(params)
    placed = shd.place(params, shd.named_shardings(params, mesh))
    del params
    torch.cuda.empty_cache()
    # the f32 moments made on the rank's blocks (the whole model's would
    # be 11.3 GB a rank while the four ranks share the card)
    state = {"params": placed, "opt": placed_adamw_state(placed),
             "plane": plane, "ef": ef}
    step = fsdp_step_fn(cfg, registry.build(cfg, remat="full").loss_fn, mesh)
    meter = CommMeter()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with shd.mesh_context(mesh):
        out = fsdp_train(dev, step, state, batch, 0, TRAIN_TP["steps"],
                         meter)
        launches = ops.launch_counts()
        digests = block_digests(state["params"])
        # one more step, not compared, for its collectives by kind
        costs = analyze_ops(lambda: fsdp_train(
            dev, step, state, batch, TRAIN_TP["steps"], 1, meter))
    meter.close()
    want = model_launches(cfg, TRAIN_TP["steps"])
    if launches != want:
        raise AssertionError(f"main_train_tp rank {rank}: launches "
                             f"{launches} != {want}")
    return dict(out, coord=tuple(mesh.get_coordinate()),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                collectives_a_step=dict(costs.op_counts),
                collective_bytes_a_step=dict(costs.collective_bytes),
                launches={k: v for k, v in launches.items() if v},
                digests=digests)


def placed_adamw_state(placed) -> dict:
    """`adamw.init_state` (f32 moments) of a placed params tree, made as
    each rank's blocks: zero moments with the params' placements (their
    `named_shardings` are the params'), the step replicated."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.parallel import sharding as shd

    def zeros(a):
        return DTensor.from_local(
            torch.zeros(a.to_local().shape, dtype=torch.float32,
                        device=a.to_local().device), a.device_mesh,
            a.placements, run_check=False, shape=a.shape, stride=a.stride())

    first = shd._leaves_of(placed)[0]
    step = DTensor.from_local(
        torch.zeros((), dtype=torch.int32, device=first.to_local().device),
        first.device_mesh, [Replicate()] * first.device_mesh.ndim,
        run_check=False)
    return {"step": step, "m": shd._tree_map(zeros, placed),
            "v": shd._tree_map(zeros, placed)}


def run_main_train_tp(dev) -> dict:
    """main_train_tp: TRAIN_TP over 4 gloo ranks sharing the card
    (`shard_train_tp`), then the one-process oracle of the split on the
    card (`sharded_worlds.placed_oracle`: each DP rank's rows in turn, its
    two model ranks a thread each, the gradients added in rank order):
    every rank's losses and params blocks equal the oracle's bit for
    bit."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    import sharded_worlds as sw
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    t0 = time.perf_counter()
    ranks = run_worlds([("train_tp", 4, "gloo")],
                       timeout_s=600)["train_tp"]
    t1 = time.perf_counter()
    cfg, params, batch = tp_train_model(dev)
    n_params = sum(a.numel() for a in _leaf_values(params))
    shape, names = TRAIN_TP["shape"], ("data", "model")
    oracle = sw.placed_oracle(cfg, params,
                              registry.build(cfg, remat="none").loss_fn,
                              batch, [(shape, names)] * TRAIN_TP["steps"],
                              shares=False, host=False)
    spec = shd.SpecMesh(names, shape)
    sh = shd.named_shardings(params, spec)
    differ = []
    for r in ranks:
        if r["losses"] != oracle["loss"] or \
                r["grad_norms"] != oracle["grad_norm"]:
            raise AssertionError(
                f"main_train_tp rank {r['rank']}: losses {r['losses']}, "
                f"norms {r['grad_norms']} != {oracle['loss']}, "
                f"{oracle['grad_norm']}")
        for path, leaf in _leaf_items(params):
            block = leaf[shd.block_index(tuple(leaf.shape), _at(sh, path),
                                         tuple(r["coord"]))]
            want = json.loads(json.dumps(list(leaf_digest(block))))
            if r["digests"]["/".join(path)] != want:
                differ.append(f"{r['rank']}:{'/'.join(path)}")
    if differ:
        raise AssertionError(f"main_train_tp: blocks differ from the "
                             f"oracle's: {differ}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for r in ranks:
        r.pop("digests")
    return dict(config=TRAIN_TP, params=n_params, ranks=ranks,
                losses=oracle["loss"], params_equal_oracle=True,
                step_ms=ranks[0]["step_ms"], world_s=t1 - t0,
                oracle_s=time.perf_counter() - t1,
                launches={k: sum(r["launches"].get(k, 0) for r in ranks)
                          for k in ranks[0]["launches"]},
                seconds=time.perf_counter() - t0)


# the dry run's cells `chip_smoke.py` runs (the whole grid's 64 take ~380 s
# of one core, `PERF.md` §6, and slow the host-bound card phases beside
# them): every family (dense, moe under moe_ep and the default rules, vlm,
# encdec, hybrid, ssm), both meshes, both int8 train cells
DRYRUN_CELLS = (("whisper_base", "decode_32k", "single"),
                ("zamba2_1p2b", "long_500k", "single"),
                ("rwkv6_7b", "long_500k", "single"),
                ("qwen3_moe_30b_a3b", "prefill_32k", "single"),
                ("minicpm_2b", "train_4k", "single"),
                ("internvl2_2b", "decode_32k", "single"),
                ("qwen2p5_14b", "decode_32k", "multi"),
                ("grok1_314b", "train_4k", "multi"),
                ("mistral_large_123b", "train_4k", "multi"))


class DryRun:
    """DRYRUN_CELLS through `python -m repro_torch.launch.dryrun --arch A
    --shape S --mesh M` (CPU only), one process a cell in turn, in a thread
    started beside the card's phases and joined at the end: each must
    print `1/1 cells passed`."""

    def __init__(self):
        import threading
        self.out = ROOT / "build" / "dryrun"
        shutil.rmtree(self.out, ignore_errors=True)
        self.out.mkdir(parents=True)
        self.proc = None
        self.stopped = False
        self.done: list = []
        self.t0 = time.perf_counter()
        # a phase that fails before `join` leaves no process behind
        import atexit
        atexit.register(self.stop)
        self.thread = threading.Thread(target=self._run)
        self.thread.start()

    def _run(self) -> None:
        for arch, shape, mesh in DRYRUN_CELLS:
            if self.stopped:
                return
            where = self.out / f"{arch}.{shape}.{mesh}"
            with open(self.out / "log.txt", "a") as log:
                self.proc = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--out", str(where)],
                    stdout=log, stderr=subprocess.STDOUT,
                    env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
                self.done.append((arch, shape, mesh, self.proc.wait()))

    def stop(self) -> None:
        self.stopped = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def join(self, timeout_s: float) -> dict:
        self.thread.join(timeout_s)
        alive = self.thread.is_alive()
        self.stop()
        self.thread.join()
        secs = time.perf_counter() - self.t0
        text = (self.out / "log.txt").read_text()
        bad = [c for c in self.done if c[3] != 0]
        if alive or bad or len(self.done) != len(DRYRUN_CELLS) or \
                text.count("1/1 cells passed") != len(DRYRUN_CELLS):
            raise AssertionError(f"dryrun: {len(self.done)} of "
                                 f"{len(DRYRUN_CELLS)} cells ran, failed "
                                 f"{bad}:\n" + text[-3000:])
        recs = [json.loads((self.out / f"{a}.{s}.{m}" / f"dryrun_{m}.json")
                           .read_text())[0] for a, s, m, _ in self.done]
        return dict(cells=len(recs), ok=sum(r["ok"] for r in recs),
                    seconds=secs, line=f"{len(recs)}/{len(recs)} cells",
                    cell_s=sum(r["lower_s"] + r["compile_s"] for r in recs),
                    records={f"{r['arch']}/{r['shape']}/{r['mesh']}":
                             dict(flops=r["flops"],
                                  peak_gb=r["memory"]["peak_bytes"] / 1e9,
                                  collective_gb=r["collective_bytes"]
                                  ["total"] / 1e9)
                             for r in recs})


SHARD_JOBS = {"tiny_nccl": shard_tiny_nccl, "tiny_gloo": shard_tiny_gloo,
              "routed": shard_routed, "train_dp": shard_train_dp,
              "tiny_fsdp": shard_tiny_fsdp,
              "fsdp_save": shard_train_fsdp_save,
              "fsdp_restore": shard_train_fsdp_restore,
              "tiny_tp": shard_tiny_tp, "serve_tp": shard_serve_tp,
              "train_tp": shard_train_tp}


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

    if sys.argv[1:2] == [ROUTED_TICK_FLAG]:     # run_routed_tick's process
        _build.build()
        _build.load()
        emit(run_routed_tick(dev, int(sys.argv[2])))
        return 0
    if sys.argv[1:2] == [SHARD_FLAG]:           # a rank of a sharded phase
        _build.build()
        _build.load()
        emit(shard_rank(dev))
        return 0

    t0 = time.perf_counter()
    lib = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)), "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "sm90_hgmma": sm90_hgmma(lib)})
    _build.load()
    print(lib.with_name(lib.name + ".ptxas.txt").read_text(),
          file=sys.stderr)
    dryrun = DryRun()              # CPU only: beside every card phase

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    kernels = {}
    checks = (check_sor_fit, check_sor_accumulate, check_sor_refit,
              check_flash, check_decode, check_flash_bwd, check_fleet_reduce,
              check_fleet_stats,
              check_rwkv6_scan, check_mamba2_ssd, check_quantize_int8,
              check_ef_sync_leaf)
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
    result = run_main_serve_tp(dev, cfg, params)     # empties params
    by_path["serve-qwen-tp"] = {k: result["launches"].get(k, 0)
                                for k in ops.KERNELS}
    emit({"phase": "main_serve_tp", **result})
    del result, params
    gc.collect()
    torch.cuda.empty_cache()       # the Qwen2.5 weights are gone

    routed = Beside(run_tiny_routed)
    elastic = Beside(run_elastic_example, {name: 0 for name in ops.KERNELS})
    tiny_sharded, tiny_fsdp, tiny_tp = run_tiny_sharded()
    emit({"phase": "tiny_routed", **routed.join()})
    emit({"phase": "tiny_sharded", **tiny_sharded})
    emit({"phase": "tiny_fsdp", **tiny_fsdp})
    emit({"phase": "tiny_tp", **tiny_tp})
    elastic = elastic.join()
    gc.collect()
    torch.cuda.empty_cache()
    result = run_main_routed(dev)
    by_path.update(result.pop("by_path"))
    emit({"phase": "main_routed", **result})
    result = run_main_sharded_routed()
    by_path["serve-routed-sharded"] = {
        k: result["launches"].get(k, 0) for k in ops.KERNELS}
    emit({"phase": "main_sharded_routed", **result})
    UNSHARDED_ROUTED.clear()
    del result

    for tiny, phase, path, spec in (
            ("tiny_granite", "main_granite", "serve-granite", GRANITE),
            ("tiny_qwen3moe", "main_qwen3moe", "serve-qwen3moe", QWEN3MOE),
            ("tiny_rwkv", "main_rwkv", "serve-rwkv", RWKV),
            ("tiny_zamba", "main_zamba", "serve-zamba", ZAMBA)):
        run = run_tiny_family if tiny in TINY_FAMILIES else run_tiny
        emit({"phase": tiny, **run(spec["arch"])})
        resident_gb = torch.cuda.memory_allocated() / 1e9
        if resident_gb > RESIDENT_GB_MAX:
            raise AssertionError(f"{phase}: {resident_gb} GB still "
                                 f"allocated before its weights")
        cfg, params, init_s = init_main(dev, spec)
        result = run_main(dev, spec, cfg, params, init_s)
        result["resident_before_init_gb"] = resident_gb
        by_path[path] = result["launches"]
        emit({"phase": phase, **result})
        del result, params
        torch.cuda.empty_cache()   # the model's weights are gone

    result = run_examples(elastic)
    by_path.update(result.pop("by_path"))
    emit({"phase": "examples", **result})
    del result
    gc.collect()
    torch.cuda.empty_cache()       # the examples' models are gone

    emit({"phase": "tiny_train", **run_tiny_train()})
    emit({"phase": "tiny_train_host", **run_tiny_train_host()})
    emit({"phase": "tiny_train_ckpt", **run_tiny_train_ckpt()})
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
    gc.collect()
    torch.cuda.empty_cache()       # main_train_ef's MiniCPM state is gone
    result = run_main_train_dp(dev)
    by_path["train-dp"] = {k: result["launches"].get(k, 0)
                           for k in ops.KERNELS}
    emit({"phase": "main_train_dp", **result})
    del result
    result = run_main_train_fsdp(dev)
    by_path["train-fsdp"] = {k: result["launches"].get(k, 0)
                             for k in ops.KERNELS}
    emit({"phase": "main_train_fsdp", **result})
    del result
    result = run_main_train_tp(dev)
    by_path["train-tp"] = {k: result["launches"].get(k, 0)
                           for k in ops.KERNELS}
    emit({"phase": "main_train_tp", **result})
    del result
    gc.collect()
    torch.cuda.empty_cache()       # main_train_tp's oracle state is gone

    for tiny, phase, path, spec in (
            ("tiny_train_zamba", "main_train_zamba", "train-zamba",
             TRAIN_ZAMBA),
            ("tiny_train_rwkv", "main_train_rwkv", "train-rwkv",
             TRAIN_RWKV)):
        emit({"phase": tiny, **run_tiny_train_family(spec["arch"])})
        result = run_main_train_family(dev, spec)
        by_path[path] = result["launches"]
        emit({"phase": phase, **result})
        del result
        gc.collect()
        torch.cuda.empty_cache()   # the model's training state is gone

    for tiny in ("tiny_grok1", "tiny_mistral"):
        emit({"phase": tiny, **run_tiny_family(TINY_FAMILIES[tiny])})
    for tiny, phase, path, run in (
            (None, "main_train_moe", "train-moe",
             lambda: run_main_train_family(dev, TRAIN_MOE)),
            ("tiny_internvl", "main_train_internvl", "train-internvl",
             lambda: run_main_train_family(dev, TRAIN_INTERNVL)),
            ("tiny_whisper", "main_whisper", "whisper",
             lambda: run_main_whisper(dev))):
        if tiny is not None:
            emit({"phase": tiny, **run_tiny_family(TINY_FAMILIES[tiny])})
        result = run()
        by_path[path] = result["launches"]
        if "serve" in result:
            by_path[path + "-serve"] = result["serve"]["launches"]
        emit({"phase": phase, **result})
        del result
        gc.collect()
        torch.cuda.empty_cache()   # the model's training state is gone

    result = run_main_train_ckpt(dev)
    by_path["train-ckpt"] = result["launches"]
    emit({"phase": "main_train_ckpt", **result})
    del result
    gc.collect()
    torch.cuda.empty_cache()       # main_train_ckpt's training state is gone

    emit({"phase": "dryrun", **dryrun.join(timeout_s=600)})

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
