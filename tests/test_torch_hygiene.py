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
from repro_torch.launch import train as launch_train
from repro_torch.models import registry
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import trainer as ttrainer
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# the scripts: the card-side ones that set a checkout beside the parent
# (`*_compare.py`) and the profiler's window count, and the CPU suite's
# timing summary (`suite_times.py`)
CARD_SCRIPTS = sorted((ROOT / "scripts").glob("*.py"))


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES + CARD_SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    # nor msgpack, which the card's machine lacks: the checkpoint manifest
    # goes through the port's own codec
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")]
    assert not bad, f"{path} imports {bad}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES + CARD_SCRIPTS}
    assert {"engine.py", "ops.py", "sor.py", "chip_smoke.py", "step.py",
            "trainer.py", "adamw.py", "schedule.py", "pipeline.py",
            "train.py", "rwkv6.py", "rwkv6_scan.py", "rwkv6_7b.py",
            "mamba2.py", "mamba2_ssd.py", "zamba2_1p2b.py", "codecs.py",
            "regulator.py", "pmbus.py", "settling.py", "power_manager.py",
            "fleet.py", "control_plane.py", "fleet_telemetry.py",
            "fleet_compare.py", "sor_compare.py", "profile_windows.py",
            "ckpt.py", "_msgpack.py", "router.py", "traffic.py",
            "transceiver.py", "overhead.py", "granite_20b.py",
            "quickstart.py", "case_study_transceiver.py", "serve_decode.py",
            "train_voltune_lm.py", "mesh.py", "sharding.py",
            "elastic_restart.py", "dryrun.py", "analysis.py", "analytic.py",
            "op_costs.py"} <= names


def test_port_tests_run_on_one_torch_thread(request):
    """A port test runs on one torch thread, and so does every other: each
    `tests/test_torch_*.py` that holds a test imports the autouse fixture
    `one_torch_thread` of `tests/torch_threads.py` and defines none of its
    own, so a new file cannot bring back a pool of a thread a core beside
    the other workers of a parallel run."""
    assert torch.get_num_threads() == 1
    assert "one_torch_thread" in request.fixturenames
    paths = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(paths) > 30
    bad = []
    for path in paths:
        body = ast.parse(path.read_text(), str(path)).body
        names = {n.name for n in body
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        takes = any(isinstance(n, ast.ImportFrom)
                    and n.module == "torch_threads"
                    and "one_torch_thread" in (a.name for a in n.names)
                    for n in body)
        if any(n.lower().startswith("test") for n in names) and (
                not takes or "one_torch_thread" in names):
            bad.append(path.name)
    assert not bad, bad


def test_only_the_dry_run_imports_the_fake_world():
    """`torch.testing._internal` (the `fake` process-group backend of the
    dry run's 256- and 512-rank worlds) is imported by
    `launch/dryrun.py` alone, inside the function that starts its world:
    importing the module (as `roofline/analysis.py` does for its tables)
    leaves it out of the process."""
    users = [p for p in PORT_FILES
             if any(m.startswith("torch.testing._internal")
                    for m in _imported_modules(p))]
    assert [p.relative_to(ROOT).as_posix() for p in users] == [
        "src/repro_torch/launch/dryrun.py"]
    tree = ast.parse(users[0].read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any(getattr(n, "module", "") and n.module.startswith(
        "torch.testing") for n in top)
    import repro_torch.launch.dryrun  # noqa: F401
    import repro_torch.roofline.analysis  # noqa: F401
    assert "torch.testing._internal.distributed.fake_pg" not in sys.modules


MESH = ROOT / "src" / "repro_torch" / "launch" / "mesh.py"


@pytest.mark.parametrize("check", ["no_try", "no_environ", "no_init"])
def test_mesh_module_switches_no_backend(check):
    """`launch/mesh.py` (imports already scanned above) picks no backend:
    no try/except to fall from one to another, no environment knob, and
    no process group of its own (the caller starts it). Across the port,
    only the examples and the dry run start one: the train example on the
    backend its flag names, the elastic example its gloo worlds of 4 and
    8, the dry run its `fake` worlds of 256 and 512 ranks."""
    tree = ast.parse(MESH.read_text())
    if check == "no_try":
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    elif check == "no_environ":
        assert "environ" not in MESH.read_text()
    else:
        def starts(path):
            return any(isinstance(n, ast.Call) and getattr(
                n.func, "attr", getattr(n.func, "id", None))
                == "init_process_group"
                for n in ast.walk(ast.parse(path.read_text())))

        starters = sorted(str(p.relative_to(ROOT)) for p in PORT_FILES
                          if p.name != "chip_smoke.py" and starts(p))
        assert starters == [
            "src/repro_torch/examples/elastic_restart.py",
            "src/repro_torch/examples/train_voltune_lm.py",
            "src/repro_torch/launch/dryrun.py"], starters


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_elastic_example_default_device_needs_a_card(no_card, tmp_path):
    from repro_torch.examples import elastic_restart
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic_restart.main(["--ckpt-dir", str(tmp_path / "ckpt")])
    assert not (tmp_path / "ckpt").exists()


def test_engine_default_device_needs_a_card(no_card):
    cfg = get_config("qwen2p5_14b", tiny=True)
    params = registry.build(cfg).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_len=16, batch_size=1)


def _default_device_builders():
    from repro_torch.data.pipeline import DataConfig, stub_frontend_inputs
    from repro_torch.launch.train import FrontendData
    from repro_torch.models import attention, encdec, lm, mamba2, rwkv6
    cfg = get_config("qwen2p5_14b", tiny=True)
    whisper = get_config("whisper_base", tiny=True)
    vlm = get_config("internvl2_2b", tiny=True)
    ssm = get_config("rwkv6_7b", tiny=True)
    hybrid = get_config("zamba2_1p2b", tiny=True)
    api = registry.build(cfg)
    tree = lm.tree_map(lambda s: np.zeros(s, np.float32),
                       lm.param_shapes(cfg))
    return {
        "params_from_jax": lambda: registry.params_from_jax(cfg, tree),
        "SyntheticLM.torch_batch": lambda: _synthetic().torch_batch(0),
        "api.init_decode_cache": lambda: api.init_decode_cache(1, 8),
        "lm.init_decode_cache": lambda: lm.init_decode_cache(cfg, 1, 8),
        "attention.init_kv_cache": lambda: attention.init_kv_cache(
            1, 8, lm.attn_spec(cfg)),
        "lm.init_decode_cache[ssm]": lambda: lm.init_decode_cache(ssm, 1, 8),
        "rwkv6.init_rwkv6_state": lambda: rwkv6.init_rwkv6_state(
            1, lm.rwkv_spec(ssm)),
        "lm.init_decode_cache[hybrid]": lambda: lm.init_decode_cache(
            hybrid, 1, 8),
        "mamba2.init_mamba2_state": lambda: mamba2.init_mamba2_state(
            1, lm.mamba_spec(hybrid)),
        "encdec.init_decode_cache": lambda: encdec.init_decode_cache(
            whisper, 1, 8),
        "api.init_decode_cache[encdec]": lambda: registry.build(
            whisper).init_decode_cache(1, 8),
        "stub_frontend_inputs": lambda: stub_frontend_inputs(vlm, "vlm", 1),
        "FrontendData.torch_batch": lambda: FrontendData(
            DataConfig(64, 8, 1), whisper).torch_batch(0),
    }


def _synthetic():
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(64, 8, 1))


@pytest.mark.parametrize("builder", ["params_from_jax",
                                     "SyntheticLM.torch_batch",
                                     "api.init_decode_cache",
                                     "lm.init_decode_cache",
                                     "attention.init_kv_cache",
                                     "lm.init_decode_cache[ssm]",
                                     "rwkv6.init_rwkv6_state",
                                     "lm.init_decode_cache[hybrid]",
                                     "mamba2.init_mamba2_state",
                                     "encdec.init_decode_cache",
                                     "api.init_decode_cache[encdec]",
                                     "stub_frontend_inputs",
                                     "FrontendData.torch_batch"])
def test_builders_default_device_needs_a_card(no_card, builder):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_device_builders()[builder]()


def test_launcher_default_device_needs_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen2p5_14b", "--tiny"])


def test_routed_launcher_default_device_needs_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen2p5_14b", "--tiny",
                           "--fleet-chips", "4", "--router", "headroom",
                           "--batch-cap", "4"])


def test_routed_engine_default_device_needs_a_card(no_card):
    """A routed engine (router, batch_cap) on the default device raises
    without a card, before any trace is served."""
    from repro_torch.core.hwspec import FleetSpec
    from repro_torch.serve.router import HeadroomRouter
    cfg = get_config("qwen2p5_14b", tiny=True)
    params = registry.build(cfg).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_len=16, batch_size=1,
                    fleet=FleetSpec.sample(4, seed=0),
                    router=HeadroomRouter(capacity=4), batch_cap=4)


def test_train_launcher_default_device_needs_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "minicpm_2b", "--tiny", "--steps", "1"])


def test_trainer_default_device_needs_a_card(no_card):
    cfg = ttrainer.TrainerConfig(total_steps=1)
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(lambda *a: None, None, cfg, {"plane": None})


@pytest.mark.parametrize("entry", ["ServeEngine", "Trainer"])
def test_host_controller_default_device_needs_a_card(no_card, entry):
    """The library entry points with a HostRailController and the default
    device raise without a card: the controller does not move the plane to
    the CPU on its own."""
    from repro_torch.core.control_plane import HostRailController
    from repro_torch.core.policy import PhaseAware
    hc = HostRailController(PhaseAware(), n_chips=4, decide_from="poll")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "ServeEngine":
            cfg = get_config("qwen2p5_14b", tiny=True)
            params = registry.build(cfg).init(
                torch.Generator().manual_seed(0))
            ServeEngine(cfg, params, max_len=16, batch_size=1, controller=hc)
        else:
            cfg = ttrainer.TrainerConfig(total_steps=1, controller=hc)
            assert cfg.device == "cuda" and cfg.controller is hc
            ttrainer.Trainer(lambda *a: None, None, cfg, {"plane": None})


def test_host_path_launchers_default_device_needs_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen2p5_14b", "--tiny",
                           "--fleet-chips", "4", "--control-path", "host"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "minicpm_2b", "--tiny", "--steps", "1",
                           "--control-path", "host"])


@pytest.mark.parametrize("flags", [["--dry-run"]])
def test_train_launcher_refuses_unported_paths(flags, monkeypatch):
    """The launcher refuses no path any longer: `--dry-run` (refused until
    the dry run was ported) runs `launch/dryrun.py` on the architecture's
    train_4k cell on both meshes in a process of its own and exits with
    its code, as the reference's launcher does (the run itself:
    `tests/test_torch_dryrun.py`)."""
    import subprocess
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda argv: calls.append(argv) or 3)
    with pytest.raises(SystemExit) as exc:
        launch_train.main(["--arch", "minicpm_2b", "--tiny", "--device",
                           "cpu", *flags])
    assert exc.value.code == 3
    assert calls == [[sys.executable, "-m", "repro_torch.launch.dryrun",
                      "--arch", "minicpm_2b", "--shape", "train_4k",
                      "--mesh", "both"]]


def test_train_launcher_refuses_resume_without_ckpt_dir(capsys):
    with pytest.raises(SystemExit) as exc:
        launch_train.main(["--arch", "minicpm_2b", "--tiny", "--device",
                           "cpu", "--resume"])
    assert exc.value.code == 2
    assert "--resume needs --ckpt-dir" in capsys.readouterr().err


def test_train_launcher_writes_and_resumes(tmp_path, capsys):
    """`--ckpt-dir` writes the reference's layout on its cadence
    (max(10, steps // 5)) and after the last step; `--resume` continues
    from the latest; without `--resume` the directory is emptied first."""
    ckpt = tmp_path / "ckpt"
    base = ["--arch", "minicpm_2b", "--tiny", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(ckpt)]
    ops.reset_launch_counts()
    launch_train.main(base + ["--steps", "12"])
    out = capsys.readouterr().out
    assert "'ckpt_writes': 2" in out and "resumed" not in out
    assert sorted(os.listdir(ckpt)) == ["step_00000010", "step_00000012"]
    assert sorted(os.listdir(ckpt / "step_00000012")) == [
        ".complete", "arrays.npz", "manifest.msgpack"]
    launch_train.main(base + ["--steps", "14", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 12" in out and "'steps': 2" in out
    launch_train.main(base + ["--steps", "3"])
    assert os.listdir(ckpt) == ["step_00000003"]
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_cpu_train_step_launches_no_kernel(capsys):
    ops.reset_launch_counts()
    launch_train.main(["--arch", "minicpm_2b", "--tiny", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert "'steps': 2" in capsys.readouterr().out
    # an error-feedback step (the codec, K10's plain version on the CPU)
    from repro_torch.core.power_plane import StepProfile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train.step import StepConfig, make_train_step
    from repro_torch.train.trainer import initial_plane_and_ef
    cfg = get_config("minicpm_2b", tiny=True)
    api = registry.build(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    step = make_train_step(api.loss_fn, adamw.AdamWConfig(), lambda s: 1e-3,
                           StepProfile(1.0, 1.0, 1.0, 1.0),
                           StepConfig(grad_sync="ef_int8"))
    plane, ef = initial_plane_and_ef(params)
    *_, metrics = step(params, adamw.init_state(params, adamw.AdamWConfig()),
                       plane, ef,
                       SyntheticLM(DataConfig(cfg.vocab_size, 16, 2))
                       .torch_batch(0, "cpu"))
    assert metrics["grad_error"].item() > 0
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_launcher_refuses_unported_paths():
    """What the serve launcher still refuses: routing without a fleet (as
    the reference's launcher does). `--router` itself is ported
    (`test_routed_launcher_runs_on_cpu`)."""
    with pytest.raises(SystemExit, match="--fleet-chips"):
        launch_serve.main(["--arch", "qwen2p5_14b", "--tiny",
                           "--router", "headroom", "--device", "cpu"])


@pytest.mark.parametrize("router", ["headroom", "roundrobin"])
def test_routed_launcher_runs_on_cpu(capsys, router):
    """`--router` routes a bursty trace over the fleet on the CPU and
    launches no kernel."""
    ops.reset_launch_counts()
    launch_serve.main(["--arch", "qwen2p5_14b", "--tiny", "--fleet-chips",
                       "4", "--router", router, "--trace-requests", "6",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"routed 6 requests over 4 chips ({router})" in out
    assert "'completed': 6" in out
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_cpu_generate_launches_no_kernel(capsys):
    for path in ("in-graph", "host"):
        ops.reset_launch_counts()
        launch_serve.main(["--arch", "qwen2p5_14b", "--tiny", "--batch", "2",
                           "--prompt-len", "8", "--max-new", "4",
                           "--fleet-chips", "4", "--control-path", path,
                           "--device", "cpu"])
        assert "generated (2, 4) tokens" in capsys.readouterr().out
        assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


@pytest.mark.parametrize("fleet_chips", ["0", "4"])
def test_serve_launcher_host_path_runs_on_cpu(capsys, fleet_chips):
    """`--control-path host` serves through a HostRailController on a
    scalar plane and on a fleet plane."""
    launch_serve.main(["--arch", "qwen2p5_14b", "--tiny", "--batch", "2",
                       "--prompt-len", "8", "--max-new", "4",
                       "--fleet-chips", fleet_chips, "--control-path",
                       "host", "--device", "cpu"])
    assert "generated (2, 4) tokens" in capsys.readouterr().out


def test_train_launcher_host_path_runs_on_cpu(capsys):
    ops.reset_launch_counts()
    launch_train.main(["--arch", "minicpm_2b", "--tiny", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--control-path",
                       "host", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'steps': 2" in out
    actuations = int(out.split("'host_actuations': ")[1].split(",")[0])
    assert actuations >= 1
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
                   env=one_thread_env(PYTHONPATH=str(ROOT / "src")))
