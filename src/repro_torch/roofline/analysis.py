"""Roofline analysis: three terms per (arch x shape x mesh) from the dry
run's records (copied from `repro/roofline/analysis.py`). The terms are the
reference's simulated TPU v5e production mesh (`hwspec.V5E`: its peak,
HBM and ICI rates), not the H100's: no number here is a card number.

The port's records carry `corrected` (the counts of a run that executes
every layer and microbatch, `launch/dryrun.py`), so the reference's
fallback to an HLO walk over saved HLO text has no counterpart: nothing in
the port produces HLO.

    compute term    = HLO_FLOPs / (peak_FLOP/s per chip)
    memory term     = HLO_bytes / (HBM bytes/s per chip)
    collective term = collective wire bytes / (ICI bytes/s per chip)

`compiled.cost_analysis()` on a partitioned module reports per-device FLOPs
and bytes; collective bytes come from the post-SPMD HLO parse in
launch/dryrun.py (already per-device wire traffic). MODEL_FLOPS uses
6*N*D (dense) / 6*N_active*D (MoE) for training, 2*N*D for inference, per
the assignment; the ratio MODEL_FLOPS / HLO_FLOPs exposes remat/padding
waste (values < 1 mean the compiled step does extra work — e.g. remat
recompute; values > 1 would mean XLA found algebraic savings).
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core.hwspec import V5E, ChipSpec


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    devices: int
    t_compute_s: float
    t_memory_s: float
    t_collective_s: float
    dominant: str
    model_flops_per_chip: float
    hlo_flops_per_chip: float
    useful_ratio: float          # MODEL_FLOPS / HLO_FLOPs
    roofline_fraction: float     # t_compute / max(all terms) — MFU-like bound
    note: str = ""

    @property
    def t_step_bound_s(self) -> float:
        return max(self.t_compute_s, self.t_memory_s, self.t_collective_s)


def model_flops_per_chip(arch: str, shape_name: str, devices: int) -> float:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        total = 6.0 * n_active * shape.tokens
    elif shape.kind == "prefill":
        total = 2.0 * n_active * shape.tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / devices


def analyze_cell(rec: dict, spec: ChipSpec = V5E) -> RooflineRow | None:
    if not rec.get("ok"):
        return None
    corrected = rec.get("corrected")
    if corrected:
        flops = float(corrected["flops"])
        coll = float(corrected["collective_bytes"])
    else:
        flops = float(rec["flops"] or 0.0)
        coll = float(rec["collective_bytes"]["total"])
    # memory term: analytic TPU HBM-traffic model (see roofline/analytic.py)
    from repro_torch.launch.dryrun import (INT8_OPT, MICROBATCHES,
                                          SHARDING_PROFILES)
    from repro_torch.roofline.analytic import hbm_bytes_per_device
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    wide = (SHARDING_PROFILES.get(rec["arch"]) == "fsdp_wide"
            and rec["shape"] == "train_4k")
    mb = 1 if wide else (
        MICROBATCHES.get(rec["arch"], 2) if rec["shape"] == "train_4k" else 1)
    tp_eff = 1 if wide else cfg.tp
    hbm_bytes = hbm_bytes_per_device(cfg, shape, rec["devices"],
                                     microbatches=mb, tp=tp_eff,
                                     int8_opt=rec["arch"] in INT8_OPT)
    t_comp = flops / spec.peak_bf16_flops
    t_mem = hbm_bytes / spec.hbm_bandwidth
    t_coll = coll / (spec.ici_link_bandwidth * spec.ici_links_per_chip)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_chip(rec["arch"], rec["shape"], rec["devices"])
    t_bound = max(terms.values()) or 1e-30
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        devices=rec["devices"],
        t_compute_s=t_comp, t_memory_s=t_mem, t_collective_s=t_coll,
        dominant=dominant,
        model_flops_per_chip=mf, hlo_flops_per_chip=flops,
        useful_ratio=mf / flops if flops else 0.0,
        roofline_fraction=(mf / spec.peak_bf16_flops) / t_bound,
    )


def load_report(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)


def analyze_report(path: str, mesh: str | None = "single"
                   ) -> list[RooflineRow]:
    rows = []
    for rec in load_report(path):
        if mesh and rec.get("mesh") != mesh:
            continue
        row = analyze_cell(rec)
        if row:
            rows.append(row)
    return rows


def format_table(rows: list[RooflineRow]) -> str:
    hdr = (f"{'arch':<20} {'shape':<12} {'mesh':<6} "
           f"{'t_comp(ms)':>10} {'t_mem(ms)':>10} {'t_coll(ms)':>10} "
           f"{'dominant':>10} {'useful':>7} {'roofl%':>7}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:<20} {r.shape:<12} {r.mesh:<6} "
            f"{r.t_compute_s*1e3:>10.3f} {r.t_memory_s*1e3:>10.3f} "
            f"{r.t_collective_s*1e3:>10.3f} {r.dominant:>10} "
            f"{r.useful_ratio:>7.2f} {100*r.roofline_fraction:>6.1f}%")
    return "\n".join(lines)


def pick_hillclimb_cells(rows: list[RooflineRow]) -> dict[str, RooflineRow]:
    """The three §Perf targets: worst roofline fraction, most collective-
    bound, most representative of the paper's technique (largest
    gradient-sync collective share in training = the 'transceiver link')."""
    train = [r for r in rows if r.shape == "train_4k"]
    worst = min(rows, key=lambda r: r.roofline_fraction)
    coll = max(rows, key=lambda r: r.t_collective_s / (r.t_step_bound_s or 1))
    paper = max(train, key=lambda r: r.t_collective_s) if train else coll
    return {"worst_roofline": worst, "most_collective_bound": coll,
            "paper_representative": paper}


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--report", default="reports/dryrun_single_multi.json")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    rows = analyze_report(args.report, args.mesh)
    print(format_table(rows))
    picks = pick_hillclimb_cells(rows)
    print("\nHillclimb candidates:")
    for k, r in picks.items():
        print(f"  {k}: {r.arch} x {r.shape} (dominant={r.dominant}, "
              f"roofline={100*r.roofline_fraction:.1f}%)")


if __name__ == "__main__":
    main()
