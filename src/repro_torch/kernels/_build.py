"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every `csrc/*.cu` is compiled by its own `nvcc` process (all started
together) for `sm_90a` into an object file, and the objects are linked into
one shared library with a plain C interface. The library is named by a hash
of the sources, the headers they include (`csrc/*.cuh`) and the flags, so an
edited source rebuilds and an unchanged tree reuses what is already in
`build/kernels/` at the repository root.

Nothing here runs at import time: the CPU tests import every module of the
port, and this machine-independent module only touches `nvcc` when a kernel
is first launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_int64
# C entry point -> argtypes; every entry point returns cudaGetLastError()
SIGNATURES = {
    "sor_fit_launch": [_P] * 11 + [_I, _I, _F, _F, _F, _P],
    "sor_accumulate_launch": [_P] * 8 + [_I, _I, _P],
    "flash_attention_fwd": [_P] * 5 + [_I] * 10 + [_F, _P],
    "decode_attention_fwd": [_P] * 5 + [_I] * 7 + [_F, _P],
    "flash_attention_bwd_dq": [_P] * 7 + [_I] * 10 + [_F, _P],
    "flash_attention_bwd_dkv": [_P] * 8 + [_I] * 10 + [_F, _P],
    "fleet_reduce_launch": [_P] * 4 + [_I, _I, _P],
    "rwkv6_scan_fwd": [_P] * 8 + [_I] * 5 + [_P],
    "mamba2_ssd_fwd": [_P] * 9 + [_I] * 7 + [_P],
    "quantize_int8_launch": [_P] * 3 + [_L, _I, _I, _P],
}

_lib: "ctypes.CDLL | None" = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _tag() -> str:
    """A hash of the flags and of every source and header in `csrc/`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def build() -> Path:
    """Compile and link the kernels unless the current sources are built;
    returns the library path. The ptxas report (registers, shared memory,
    spills per kernel) is kept beside it as `<library>.ptxas.txt`."""
    srcs = sources()
    lib = BUILD_DIR / f"libkernels_{_tag()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{p.stem}_{os.getpid()}.o" for p in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(srcs, objs)]
    reports = []
    failed = []
    for src, proc in zip(srcs, procs):
        out, err = proc.communicate()
        reports.append(f"== {src.name}\n{out}{err}")
        if proc.returncode:
            failed.append(f"nvcc failed on {src.name}:\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", *ARCH_FLAGS, *map(str, objs),
                           "-o", str(tmp)], capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernel library failed:\n"
                           f"{link.stderr}")
    for obj in objs:
        obj.unlink()
    lib.with_name(lib.name + ".ptxas.txt").write_text("\n".join(reports))
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry point's
    argtypes and restype declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if rc:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
