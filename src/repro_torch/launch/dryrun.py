"""Multi-pod dry run (port of `repro/launch/dryrun.py`): build and run
every runnable (architecture x input shape) cell once on the production
meshes, (data 16, model 16) = 256 ranks or (pod 2, data 16, model 16) =
512, and record its per-device costs, memory and collectives for the
roofline (`roofline/analysis.py`).

The reference lowers and compiles each cell through XLA on 512 forced
host devices. The port has no compiler: it runs the cell's step once as
rank 0 of a world of 256 or 512 ranks on the `fake` process-group backend
(`torch.testing._internal.distributed.fake_pg`: collectives that move
nothing), in a process of its own, on meta tensors (shapes, no memory):
- the params (and for train cells the AdamW state, int8 moments for
  `INT8_OPT`) from `registry.abstract_params` placed by `named_shardings`
  under the cell's profile, the batch from `input_specs` (the global
  batch; each rank takes its rows), the decode cache from
  `abstract_decode_cache` placed by `serve_cache_pspecs`;
- the train step (`make_train_step(..., mesh=)`), the prefill or the decode
  step run under `mesh_context(mesh, overrides)` on the TP forward, the
  hand-written kernels through their meta branch (`kernels/ops.py`);
- FLOPs from `FlopCounterMode` plus the kernels' counts, HBM bytes and the
  collectives' wire bytes by kind from `roofline/op_costs.py`, the peak of
  the live storages' bytes over the run (`LiveBytes`).

A record has the reference's keys. `lower_s` is the build (placing the
meta trees and making the step), `compile_s` the traced run; `corrected`
repeats the counts, which are exact over loops already: the port runs its
layers and microbatches in Python. A decode cell runs at `cur_index`
seq_len - 1, every cache slot valid.

Usage:
    python -m repro_torch.launch.dryrun --arch grok1_314b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out reports/
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
import traceback

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      ShapeConfig, cells, get_config)
from repro_torch.core.power_plane import PowerPlaneState, StepProfile
from repro_torch.parallel import sharding as shd

# Per-arch microbatch counts for train_4k (activation-memory control; the
# constraint is microbatches <= global_batch / dp_size). §Perf iteration:
# FSDP all-gathers scale with the microbatch count, so these sit at the
# smallest value whose activations still fit 16 GB/chip.
MICROBATCHES = {
    "mistral_large_123b": 8, "grok1_314b": 2, "granite_20b": 4,
    "qwen2p5_14b": 4, "qwen3_moe_30b_a3b": 2, "rwkv6_7b": 4,
    "zamba2_1p2b": 2, "minicpm_2b": 2, "internvl2_2b": 2, "whisper_base": 1,
}
# >=100B-param models use int8 optimizer moments (DESIGN.md §5)
INT8_OPT = {"mistral_large_123b", "grok1_314b"}

# §Perf iteration (sharding recipe per arch): sub-3B models pay more in TP
# activation all-reduces than they save, so they run wide-FSDP (params
# sharded over data x model, no TP; batch over data x model when divisible).
SHARDING_PROFILES = {
    "zamba2_1p2b": "fsdp_wide", "minicpm_2b": "fsdp_wide",
    "internvl2_2b": "fsdp_wide", "whisper_base": "fsdp_wide",
    # E=128 divides model=16 -> true expert parallelism (EP): experts over
    # 'model', full-width F per expert (F/16=48 was MXU-hostile)
    "qwen3_moe_30b_a3b": "moe_ep",
}

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh_size(mesh, axes) -> int:
    sizes = shd.mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return max(n, 1)


def _profile_settings(arch: str, mesh, shape: ShapeConfig):
    """Returns (rule_overrides, fsdp_axes, batch_axis_candidates, microbatches).

    fsdp_wide applies ONLY to training: inference batches (32/128/1) don't
    divide data x model, which would idle the model axis and turn FSDP
    gathers into per-token traffic (§Perf iteration 3: measured regression).
    Wide-FSDP training also forces microbatches=1 so each microbatch still
    divides the 256-way batch split (a 128-row microbatch on 256 devices
    compiles to 2x padded work — §Perf iteration 3a)."""
    from repro_torch.launch.mesh import dp_axes
    names = tuple(shd.mesh_axes(mesh))
    base_dp = dp_axes(mesh)
    mb = MICROBATCHES.get(arch, 2) if shape.name == "train_4k" else 1
    if (SHARDING_PROFILES.get(arch) == "fsdp_wide"
            and shape.kind == "train"
            and shape.global_batch % _mesh_size(mesh, ("data", "model")) == 0):
        overrides = {"heads": None, "kv_heads": None, "ff": None,
                     "vocab": None, "ssm_heads": None, "experts": None}
        wide = names
        cands = [c for c in (wide, ("data", "model"))
                 if shape.global_batch % _mesh_size(mesh, c) == 0]
        return overrides, ("data", "model"), cands + [base_dp, None], 1
    if SHARDING_PROFILES.get(arch) == "moe_ep":
        return {"experts": "model", "ff": None}, "data", [base_dp, None], mb
    return {}, "data", [base_dp, None], mb


def analytic_profile(cfg: ModelConfig, shape: ShapeConfig, n_chips: int
                     ) -> StepProfile:
    """Coarse 6ND-based profile for the in-graph power plane (the precise
    numbers come back out of this dry-run; the plane only needs scale)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        flops = 6.0 * n_active * shape.tokens / n_chips
        grad_bytes = 2.0 * 2 * cfg.param_count() / n_chips
    elif shape.kind == "prefill":
        flops = 2.0 * n_active * shape.tokens / n_chips
        grad_bytes = 0.0
    else:
        flops = 2.0 * n_active * shape.global_batch / n_chips
        grad_bytes = 0.0
    hbm = 2.0 * cfg.param_count() / n_chips + 0.05 * flops / 100.0
    ici = grad_bytes
    return StepProfile(flops, hbm, ici, grad_bytes)


# the batch's specs (rows over the batch axes; the encdec decode's cross
# K/V also its heads over 'model'), the reference's `batch_pspecs`
batch_pspecs = shd.batch_pspecs


# ---------------------------------------------------------------------------
# The world and the cells
# ---------------------------------------------------------------------------

def init_world(n_ranks: int) -> None:
    """This process as rank 0 of a `fake` world of `n_ranks` (its
    collectives move nothing), replacing any world it was in."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def production_mesh(kind: str):
    """The production mesh of `kind` over the world's ranks (`init_world`
    of its size first)."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = MESHES[kind]
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def build_cell(arch: str, shape_name: str, mesh):
    """Returns (run, arguments): `run()` runs the cell's step once on its
    placed meta inputs under `mesh_context`; `arguments` is the tree of
    what the step takes, as the rank holds it (its local blocks)."""
    from repro_torch.models import encdec, registry
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import cosine
    from repro_torch.train.step import StepConfig, make_train_step
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    api = registry.build(cfg)
    rule_overrides, fsdp_axes, batch_candidates, mb = _profile_settings(
        arch, mesh, shape)
    batch_axes = next(
        (c for c in batch_candidates
         if c is None or shape.global_batch % _mesh_size(mesh, c) == 0), None)
    moe_ep = SHARDING_PROFILES.get(arch) == "moe_ep"
    abstract = registry.abstract_params(cfg)
    params = shd.place(abstract, shd.named_shardings(
        abstract, mesh, fsdp=fsdp_axes, moe_ep=moe_ep))
    overrides = {"batch": batch_axes, **rule_overrides}
    batch = registry.input_specs(cfg, shape)
    local_batch = shd.local_inputs(batch, batch_pspecs(batch, batch_axes),
                                   mesh)

    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(
            state_dtype="int8" if arch in INT8_OPT else "float32")
        abstract_opt = adamw.init_state(abstract, opt_cfg)
        opt = shd.place(abstract_opt, shd.named_shardings(
            abstract_opt, mesh, fsdp=fsdp_axes, moe_ep=moe_ep))
        profile = analytic_profile(cfg, shape, mesh.size())
        sched = lambda s: cosine(s, peak_lr=3e-4, warmup_steps=2000,
                                 total_steps=100_000)
        step = make_train_step(api.loss_fn, opt_cfg, sched, profile,
                               StepConfig(microbatches=mb), mesh=mesh)
        plane = PowerPlaneState.nominal(device="meta")

        def run():
            with shd.mesh_context(mesh, overrides):
                return step(params, opt, plane, {}, batch)

        return run, {"params": params, "opt": opt, "batch": local_batch}

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            def run():
                with shd.mesh_context(mesh, overrides):
                    _, axes, p = registry.serve_setup(params,
                                                      shape.global_batch)
                    loc = shd.local_inputs(
                        batch, shd.batch_pspecs(batch, axes), mesh)
                    with shd.model_group_context(
                            shd.mesh_model_group(mesh)):
                        enc = encdec.encode(p, loc["frames"], cfg)
                        logits = encdec.decode_train(p, enc, loc["tokens"],
                                                     cfg)
                        return logits[:, -1:], encdec.cross_kv(p, enc, cfg)
        else:
            def run():
                with shd.mesh_context(mesh, overrides):
                    return api.prefill_fn(params, batch["tokens"],
                                          shape.seq_len)
        return run, {"params": params, "batch": local_batch}

    # decode: the whole cache placed, the step at its last slot
    whole = registry.abstract_decode_cache(cfg, shape)
    with shd.mesh_context(mesh, overrides):
        cache = shd.place(whole, shd._tree_map(
            lambda s: shd.NamedSharding(mesh, s), shd.serve_cache_pspecs(
                whole, mesh, batch_axes=batch_axes)))
    step_batch = dict(batch, cur_index=shape.seq_len - 1)

    def run():
        with shd.mesh_context(mesh, overrides):
            return api.decode_fn(params, cache, step_batch)

    return run, {"params": params, "cache": cache, "batch": local_batch}


# ---------------------------------------------------------------------------
# Collective bytes from post-SPMD HLO text (the reference's parser, copied:
# the port makes no HLO, `roofline/op_costs.py` counts its collectives)
# ---------------------------------------------------------------------------

_COLL_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"[^\n]*",
    re.M)

_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s64|s32|s16|s8|u64|u32|u16|u8|pred)"
                       r"\[([\d,]*)\]")
_GROUP_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUP_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

_BYTES = {"f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
          "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1}


def _group_size(line: str) -> int:
    m = _GROUP_IOTA_RE.search(line)       # iota format: [ngroups,group_size]
    if m:
        return max(1, int(m.group(2)))
    m = _GROUP_RE.search(line)            # explicit: {{0,1,...},{...}}
    if m:
        return max(1, m.group(1).count(",") + 1)
    return 2


def collective_bytes(hlo_text: str) -> dict[str, float]:
    """Per-device wire bytes of every collective in post-optimization HLO.

    Output-shape bytes are converted to ring-algorithm wire traffic per
    participant (P = replica-group size):
      all-gather         out*(P-1)/P     (out = full gathered buffer)
      all-reduce         2*out*(P-1)/P   (reduce-scatter + all-gather phases)
      reduce-scatter     out*(P-1)       (out = the local shard)
      all-to-all         out*(P-1)/P
      collective-permute out
    """
    out: dict[str, float] = {}
    counts: dict[str, int] = {}
    for m in _COLL_RE.finditer(hlo_text):
        shapes_blob, kind, line = m.group(1), m.group(2), m.group(0)
        total = 0
        for sm in _SHAPE_RE.finditer(shapes_blob):
            dt, dims = sm.group(1), sm.group(2)
            n = 1
            if dims:
                for d in dims.split(","):
                    n *= int(d)
            total += n * _BYTES[dt]
        p = _group_size(line)
        factor = {"all-gather": (p - 1) / p,
                  "all-reduce": 2 * (p - 1) / p,
                  "reduce-scatter": float(p - 1),
                  "all-to-all": (p - 1) / p,
                  "collective-permute": 1.0}[kind]
        out[kind] = out.get(kind, 0) + total * factor
        counts[kind] = counts.get(kind, 0) + 1
    out["total"] = sum(v for k, v in out.items() if k != "total")
    out["op_counts"] = counts
    return out


# ---------------------------------------------------------------------------
# Memory: the live storages' bytes
# ---------------------------------------------------------------------------

def _local_tensors(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _local_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _local_tensors(v)
    elif isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif hasattr(tree, "__dataclass_fields__"):
        for f in tree.__dataclass_fields__:
            yield from _local_tensors(getattr(tree, f))


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors as this rank holds them, each storage
    once."""
    seen, total = set(), 0
    for t in _local_tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


class LiveBytes:
    """A dispatch mode's peak of the bytes of the storages alive: each op's
    new outputs are registered (views and the collectives' in-place
    outputs add nothing) and their storages held weakly. A registration
    that would raise the peak first drops the expired storages, so the
    peak is exact; a sweep every `SWEEP` registrations keeps the running
    sum from drifting far between."""

    SWEEP = 256

    def __init__(self, resident=()):
        from torch.multiprocessing.reductions import StorageWeakRef
        self._ref = StorageWeakRef
        self.live: dict = {}
        self.now = self.peak = 0
        self._n = 0
        for t in resident:
            self.add(t)

    def add(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = (self._ref(st), n)
        self.now += n
        self._n += 1
        if self.now > self.peak or self._n % self.SWEEP == 0:
            self.sweep()
            self.peak = max(self.peak, self.now)

    def sweep(self) -> None:
        for key, (ref, n) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.now -= n

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        tracker = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if shd.is_shapes_only() or func.namespace == "c10d" or any(
                        r.alias_info is not None
                        for r in func._schema.returns):
                    return out
                for t in _local_tensors(out):
                    tracker.add(t)
                return out

        return Mode()


def run_cell(arch: str, shape_name: str, mesh_kind: str) -> dict:
    """One cell on the production mesh of `mesh_kind` (the world of its
    size must be up: `init_world`)."""
    from repro_torch.roofline.op_costs import analyze_ops
    mesh = production_mesh(mesh_kind)
    t0 = time.time()
    run, arguments = build_cell(arch, shape_name, mesh)
    t_lower = time.time() - t0
    resident = list(_local_tensors(arguments))
    live = LiveBytes(resident)
    out: list = []
    t0 = time.time()
    with live.mode():
        costs = analyze_ops(lambda: out.append(run()))
    t_compile = time.time() - t0
    live.sweep()
    arg_bytes = tree_bytes(arguments)
    res_keys = {t.untyped_storage()._cdata for t in resident}
    out_bytes = sum(
        t.untyped_storage().nbytes() for t in _local_tensors(out)
        if t.untyped_storage()._cdata not in res_keys)
    coll = dict(costs.collective_bytes)
    coll["total"] = costs.collective_total
    coll["op_counts"] = dict(costs.op_counts)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "devices": int(mesh.size()),
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "flops": costs.flops,
        "bytes_accessed": costs.hbm_bytes,
        "utilization_ops": {},
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": max(live.peak - arg_bytes - out_bytes, 0),
                   "peak_bytes": live.peak},
        "collective_bytes": coll,
        "corrected": {"flops": costs.flops,
                      "collective_bytes": costs.collective_total,
                      "by_kind": dict(costs.collective_bytes)},
        "ok": True,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="reports")
    ap.add_argument("--save-hlo", action="store_true")
    args = ap.parse_args()
    if args.save_hlo:
        ap.error("--save-hlo: the port compiles nothing, so it has no HLO "
                 "text to save (roofline/op_costs.py walks the run's aten "
                 "ops instead)")

    if args.all:
        todo = [(a, s) for a, s, runnable in cells() if runnable]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        todo = [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    results = []
    path = os.path.join(args.out, f"dryrun_{'_'.join(meshes)}.json")
    for mesh_kind in meshes:
        shape, _ = MESHES[mesh_kind]
        init_world(int(torch.tensor(shape).prod()))
        for arch, shape_name in todo:
            tag = f"{arch} x {shape_name} x {mesh_kind}"
            try:
                r = run_cell(arch, shape_name, mesh_kind)
                print(f"[OK] {tag}: flops={r['flops']:.3e} "
                      f"coll={r['collective_bytes']['total']:.3e}B "
                      f"compile={r['compile_s']}s", flush=True)
            except Exception as e:
                # a failed cell is recorded and the run goes on, as the
                # reference's does; the exit code below reports it
                traceback.print_exc()
                r = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                     "ok": False, "error": f"{type(e).__name__}: {e}"}
                print(f"[FAIL] {tag}: {r['error']}", flush=True)
            results.append(r)
            with open(path, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells passed -> {path}")
    if n_ok != len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
