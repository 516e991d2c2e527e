"""Boundaries of the port: it imports neither jax nor the reference
package, its entry points refuse to run on a missing card unless asked for
the CPU, and the CPU path launches no kernel."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import registry
from repro_torch.serve.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "ops.py", "sor.py", "chip_smoke.py"} <= names


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_engine_default_device_needs_a_card(no_card):
    cfg = get_config("qwen2p5_14b", tiny=True)
    params = registry.build(cfg).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_len=16, batch_size=1)


def _default_device_builders():
    from repro_torch.models import attention, lm
    cfg = get_config("qwen2p5_14b", tiny=True)
    api = registry.build(cfg)
    tree = lm.tree_map(lambda s: np.zeros(s, np.float32),
                       lm.param_shapes(cfg))
    return {
        "params_from_jax": lambda: registry.params_from_jax(cfg, tree),
        "api.init_decode_cache": lambda: api.init_decode_cache(1, 8),
        "lm.init_decode_cache": lambda: lm.init_decode_cache(cfg, 1, 8),
        "attention.init_kv_cache": lambda: attention.init_kv_cache(
            1, 8, lm.attn_spec(cfg)),
    }


@pytest.mark.parametrize("builder", ["params_from_jax",
                                     "api.init_decode_cache",
                                     "lm.init_decode_cache",
                                     "attention.init_kv_cache"])
def test_builders_default_device_needs_a_card(no_card, builder):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_device_builders()[builder]()


def test_launcher_default_device_needs_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen2p5_14b", "--tiny"])


def test_launcher_refuses_unported_paths():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        launch_serve.main(["--arch", "qwen2p5_14b", "--tiny",
                           "--control-path", "host", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        launch_serve.main(["--arch", "qwen2p5_14b", "--tiny",
                           "--router", "headroom", "--device", "cpu"])


def test_cpu_generate_launches_no_kernel(capsys):
    ops.reset_launch_counts()
    launch_serve.main(["--arch", "qwen2p5_14b", "--tiny", "--batch", "2",
                       "--prompt-len", "8", "--max-new", "4",
                       "--fleet-chips", "4", "--device", "cpu"])
    assert "generated (2, 4) tokens" in capsys.readouterr().out
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_kernel_build_is_lazy():
    """Importing every module of the port builds nothing: the kernel
    library is only made when a kernel first launches on a CUDA tensor."""
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  for p in PORT_FILES if p.name != "chip_smoke.py")
    code = "; ".join([f"import {m.removesuffix('.__init__')}" for m in mods]
                     + ["from repro_torch.kernels import _build",
                        "assert _build._lib is None"])
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
