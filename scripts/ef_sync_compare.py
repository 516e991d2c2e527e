#!/usr/bin/env python3
"""Time one checkout's int8 codec (K10, `repro_torch.kernels.quant_codec.
quantize_int8`) and its error-feedback gradient sync (`train.step._ef_sync`)
on the card: device ms a call (CUDA events, queue held, L2 flushed, as
`chip_smoke.py`'s `kernels` phase).

    python3 scripts/ef_sync_compare.py [--root CHECKOUT]

The codec runs at MiniCPM-2B's 283.1 M and 530.8 M leaves in f32 and its
283.1 M leaf in bf16; the sync takes one MiniCPM-2B leaf set (its 12
parameter leaves: bf16 gradients, f32 residuals) at levels 1 (`ef_int8`)
and 2 (`ef_int8_topk`). `--root` (default: this repository) is the
checkout whose `src/` is imported and whose kernels are built into its own
`build/kernels/`. To set two versions side by side, unpack one with `git
archive` into a directory that `.gitignore` lists and run both in one
command, in turns (A, B, B, A). Prints one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402  (this repository's timing helpers)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ef_sync_compare: needs a CUDA card", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import quant_codec as qc
    from repro_torch.models import lm
    from repro_torch.models.lm import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import step
    assert Path(qc.__file__).resolve().is_relative_to(root), qc.__file__

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    out = {"root": str(root), "gpu": chip_smoke.nvidia_smi(), "k10": {}}
    for n, dtype in ((283_115_520, torch.float32),
                     (530_841_600, torch.float32),
                     (283_115_520, torch.bfloat16)):
        x = torch.randn(n, generator=gen, device=dev, dtype=dtype).mul_(1e-3)
        key = f"{n}/{str(dtype).removeprefix('torch.')}"
        out["k10"][key] = chip_smoke.time_ms(lambda: qc.quantize_int8(x), 20,
                                             flush)
        del x

    shapes = lm.param_shapes(get_config("minicpm_2b"))
    grads = tree_map(lambda s: torch.randn(
        s, generator=gen, device=dev, dtype=torch.bfloat16).mul_(1e-3),
        shapes)
    resid = tree_map(lambda s: torch.randn(
        s, generator=gen, device=dev).mul_(1e-5), shapes)
    out["leaves"] = [math.prod(adamw.get_path(shapes, p))
                     for p in adamw.leaf_paths(shapes)]
    out["sync_ms"] = {}
    for level, sync in ((1, "ef_int8"), (2, "ef_int8_topk")):
        cfg = step.StepConfig(grad_sync=sync)

        def call():
            # a fresh tree of the same gradients: the sync replaces leaves
            return step._ef_sync(tree_map(lambda g: g, grads), resid, cfg)

        out["sync_ms"][f"L{level}"] = chip_smoke.time_ms(call, 3, flush)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
