#!/usr/bin/env python3
"""Time K3's wrapper (`repro_torch.kernels.decode_attention`) of one
checkout at the serve paths' decode shapes: device ms a call (CUDA events,
queue held, L2 flushed, as `chip_smoke.py`'s `kernels` phase) and host us a
call (the least of five runs of 100 calls enqueued, no sync between),
beside the harness's floor (`floor_ms`: a one-element fill timed alike).

    python3 scripts/decode_compare.py [--root CHECKOUT]

`--root` (default: this repository) is the checkout whose `src/` is
imported and whose kernels are built into its own `build/kernels/`. To set
two versions side by side, unpack one with `git archive` into a directory
that `.gitignore` lists and run both in one command, in turns (A, B, B, A).
Prints one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
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
        print("decode_compare: needs a CUDA card", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import decode_attention as da
    assert Path(da.__file__).resolve().is_relative_to(root), da.__file__

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    # bf16 matrix products first, ~0.3 s of them: without them the first
    # case timed in a fresh process read several times slower on the H100
    a = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    for _ in range(200):
        a @ a
    torch.cuda.synchronize()
    del a
    gen = torch.Generator(device=dev).manual_seed(12)
    # the harness's floor: one launch of a one-element fill, timed alike
    tiny = torch.zeros(1, device=dev)
    out = {"root": str(root), "gpu": chip_smoke.nvidia_smi(),
           "floor_ms": chip_smoke.time_ms(lambda: tiny.zero_(), 100, flush)}
    for path, (B, Hq, Hkv, Dh, _, Tp, S) in chip_smoke.attn_paths().items():
        group = Hq // Hkv
        q = torch.randn((B, 1, Hq, Dh), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, Hkv, Dh), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        lengths = torch.tensor([1, S // 3, Tp + 1, S], dtype=torch.int32,
                               device=dev)

        def call():
            return da.decode_attention(q, k, v, lengths, group=group)

        out[path] = dict(
            ms=chip_smoke.time_ms(call, 100, flush),
            host_us=chip_smoke.host_us(call),
            lengths=lengths.tolist())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
