"""Trip-count-aware static cost analysis of post-optimization HLO text
(port of `repro/roofline/hlo_costs.py`, a copy: plain text parsing, no
JAX). The port compiles nothing, so nothing in it produces HLO; the
dry run walks its aten ops instead (`roofline/op_costs.py`, whose `Costs`
has these fields). This parser reads HLO text made elsewhere, such as the
reference's `launch/dryrun.py --save-hlo` files.

Why: XLA's `compiled.cost_analysis()` counts a `while` body ONCE regardless
of trip count (a scan of 10 matmuls reports 1 matmul of FLOPs), so every
scan-over-layers model is undercounted by ~L x M. This walker parses the
text and propagates loop multipliers:

  * computations are split on header lines (`%name (...) -> ... {`),
  * `while(...)` ops link to condition/body computations; the trip count is
    the s32 constant in the condition computation (scan-generated loops
    compare the induction variable against exactly one such constant),
  * `fusion ... calls=%f`, `call ... to_apply=%f` and conditional branches
    propagate the parent multiplier (x1),
  * FLOPs: every `dot(...)` contributes 2 * prod(output_dims) *
    prod(lhs_contracting_dims) * multiplier,
  * HBM bytes: for ops in non-fused computations (fusion interiors never
    touch HBM), output bytes + operand bytes (name -> shape symbol table),
    skipping bookkeeping ops (GTE/tuple/parameter/constant/bitcast/copy),
  * collective wire bytes: the same ring-factor model as
    `launch/dryrun.collective_bytes`, with loop multipliers applied.

Caveats: `conditional` branches count once each (zamba2's every-6th-layer
shared-attention block therefore overcounts its attention FLOPs ~6x — a
conservative upper bound); elementwise FLOPs are ignored (<2% for these
models); bytes is a producer/consumer-boundary model, an upper bound on
HBM traffic.
"""

from __future__ import annotations

import dataclasses
import re

_BYTES = {"f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
          "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
          "pred": 1, "c64": 8, "c128": 16}

_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->", re.M)
_OPLINE = re.compile(r"^\s+(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.+)$")
_SHAPE = re.compile(r"(f64|f32|bf16|f16|s64|s32|s16|s8|u64|u32|u16|u8|pred|c64|c128)\[([\d,]*)\]")
_WHILE = re.compile(r"while\(.*condition=%([\w.\-]+),\s*body=%([\w.\-]+)")
_CALLS = re.compile(r"(?:calls|to_apply)=%([\w.\-]+)")
_BRANCHES = re.compile(r"branch_computations=\{([^}]*)\}")
_TRUE_FALSE = re.compile(r"(?:true_computation|false_computation)=%([\w.\-]+)")
_CONST_S32 = re.compile(r"s32\[\]\s+constant\((\d+)\)")
_OPERANDS = re.compile(r"%([\w.\-]+)")
_COLL_KIND = re.compile(r"\b(all-gather|all-reduce|reduce-scatter|all-to-all|"
                        r"collective-permute)\(")
_GROUP_IOTA = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUP_LIST = re.compile(r"replica_groups=\{\{([\d,]+)\}")

_SKIP_OPS = ("get-tuple-element", "tuple(", "parameter(", "constant(",
             "bitcast(", "after-all(", "partition-id(", "iota(")


def _shape_bytes(text: str) -> int:
    total = 0
    for m in _SHAPE.finditer(text):
        n = 1
        if m.group(2):
            for d in m.group(2).split(","):
                n *= int(d)
        total += n * _BYTES[m.group(1)]
    return total


def _first_shape_elems_bytes(text: str) -> tuple[list[int], int]:
    m = _SHAPE.search(text)
    if not m:
        return [], 0
    dims = [int(d) for d in m.group(2).split(",")] if m.group(2) else []
    n = 1
    for d in dims:
        n *= d
    return dims, n * _BYTES[m.group(1)]


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict[str, float] = dataclasses.field(default_factory=dict)
    n_whiles: int = 0
    max_mult: float = 1.0

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())


class HloModule:
    def __init__(self, text: str):
        self.comps: dict[str, list[str]] = {}
        self.entry: str | None = None
        self._split(text)
        self.shapes: dict[str, str] = {}     # op name -> defining line
        for name, lines in self.comps.items():
            for ln in lines:
                m = _OPLINE.match(ln)
                if m:
                    self.shapes[m.group(1)] = m.group(2)

    def _split(self, text: str) -> None:
        cur = None
        for line in text.splitlines():
            if line.startswith(("ENTRY", "%")) and "->" in line and line.rstrip().endswith("{"):
                m = _COMP_HDR.match(line)
                if m:
                    cur = m.group(1)
                    self.comps[cur] = []
                    if line.startswith("ENTRY"):
                        self.entry = cur
                    continue
            if line.startswith("}"):
                cur = None
                continue
            if cur is not None:
                self.comps[cur].append(line)
        if self.entry is None:
            # fall back: the computation named like the module entry
            self.entry = next(iter(self.comps)) if self.comps else None

    # -- trip counts ---------------------------------------------------------
    def trip_count(self, cond_name: str) -> int:
        consts = [int(c) for ln in self.comps.get(cond_name, ())
                  for c in _CONST_S32.findall(ln)]
        consts = [c for c in consts if c > 0]
        return max(consts) if consts else 1

    # -- multiplier propagation -------------------------------------------------
    def multipliers(self) -> dict[str, float]:
        mult: dict[str, float] = {}

        def visit(name: str, m: float):
            if name not in self.comps:
                return
            mult[name] = mult.get(name, 0.0) + m
            for ln in self.comps[name]:
                w = _WHILE.search(ln)
                if w:
                    cond, body = w.group(1), w.group(2)
                    t = self.trip_count(cond)
                    visit(cond, m * (t + 1))
                    visit(body, m * t)
                    continue
                if "conditional(" in ln:
                    for b in _TRUE_FALSE.findall(ln):
                        visit(b, m)
                    bm = _BRANCHES.search(ln)
                    if bm:
                        for b in _OPERANDS.findall(bm.group(1)):
                            visit(b, m)
                    continue
                for c in _CALLS.findall(ln):
                    visit(c, m)

        if self.entry:
            visit(self.entry, 1.0)
        return mult

    # -- cost walk ------------------------------------------------------------------
    def costs(self) -> Costs:
        mult = self.multipliers()
        out = Costs()
        fused = {n for n in self.comps if n.startswith(("fused_computation",
                                                        "wrapped_"))}
        for name, lines in self.comps.items():
            m = mult.get(name, 0.0)
            if m == 0.0:
                continue
            out.max_mult = max(out.max_mult, m)
            in_fusion = name in fused
            for ln in lines:
                opm = _OPLINE.match(ln)
                if not opm:
                    continue
                rhs = opm.group(2)
                # FLOPs from dots (count inside fusions too)
                if " dot(" in rhs or rhs.startswith("dot("):
                    dims, _ = _first_shape_elems_bytes(rhs)
                    n_out = 1
                    for d in dims:
                        n_out *= d
                    lhs_c = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rhs)
                    k = 1
                    if lhs_c:
                        ops = _OPERANDS.findall(rhs.split("dot(")[1])
                        lhs_name = ops[0] if ops else None
                        lhs_def = self.shapes.get(lhs_name, "")
                        ldims, _ = _first_shape_elems_bytes(lhs_def)
                        for idx in (lhs_c.group(1).split(",")
                                    if lhs_c.group(1) else []):
                            i = int(idx)
                            if i < len(ldims):
                                k *= ldims[i]
                    out.flops += 2.0 * n_out * k * m
                if "while(" in rhs:
                    out.n_whiles += 1
                # collectives (appear in non-fused comps)
                cm = _COLL_KIND.search(rhs)
                if cm and not in_fusion:
                    kind = cm.group(1)
                    _, obytes = _first_shape_elems_bytes(rhs)
                    # output may be a tuple: sum all shapes before the opcode
                    obytes = _shape_bytes(rhs.split(cm.group(1) + "(")[0])
                    p = self._group_size(rhs)
                    factor = {"all-gather": (p - 1) / p,
                              "all-reduce": 2 * (p - 1) / p,
                              "reduce-scatter": float(p - 1),
                              "all-to-all": (p - 1) / p,
                              "collective-permute": 1.0}[kind]
                    out.collective_bytes[kind] = (
                        out.collective_bytes.get(kind, 0.0)
                        + obytes * factor * m)
                # HBM traffic: non-fused boundaries only
                if not in_fusion and not any(s in rhs for s in _SKIP_OPS):
                    _, obytes = _first_shape_elems_bytes(rhs)
                    opnd_bytes = 0
                    paren = rhs.find("(")
                    if paren > 0:
                        args_blob = rhs[paren + 1:rhs.find(")", paren)]
                        for op_name in _OPERANDS.findall(args_blob):
                            opnd_bytes += _shape_bytes(
                                self.shapes.get(op_name, "").split(" ")[0])
                    out.hbm_bytes += (obytes + opnd_bytes) * m
        return out

    @staticmethod
    def _group_size(rhs: str) -> int:
        m = _GROUP_IOTA.search(rhs)
        if m:
            return max(1, int(m.group(2)))
        m = _GROUP_LIST.search(rhs)
        if m:
            return max(1, m.group(1).count(",") + 1)
        return 2


def analyze_hlo_text(text: str) -> Costs:
    return HloModule(text).costs()


def analyze_hlo_file(path: str) -> Costs:
    with open(path) as f:
        return analyze_hlo_text(f.read())
