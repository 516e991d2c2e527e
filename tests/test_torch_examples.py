"""The reference's examples on the port (`repro_torch.examples.*`) on the
CPU, each against the reference's example (`examples/*.py`, run in the same
process): `case_study_transceiver` and `quickstart` print exactly the
reference's text; `serve_decode` and `train_voltune_lm` (at 8 steps, d_model
64, 2 layers) print the reference's lines but those of the weights (the
sampled tokens, the losses: torch cannot draw `jax.random`'s numbers, so
each package draws its own from seed 0), and their energy, rails,
determinism, restarts and checkpoints exactly. Without `--device cpu` each
raises on a machine with no card. No tolerance: the printed text."""

import importlib
import math
import pathlib
import runpy
import subprocess
import sys

import pytest
import torch

from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "case_study_transceiver", "serve_decode",
         "train_voltune_lm")
TRAIN_ARGS = ["--steps", "8", "--d-model", "64", "--layers", "2"]


def _reference(name, argv, monkeypatch, capsys):
    path = str(ROOT / "examples" / f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path, *argv])
    runpy.run_path(path, run_name="__main__")
    return capsys.readouterr().out


def _port(name, argv, capsys):
    result = importlib.import_module(f"repro_torch.examples.{name}").main(
        [*argv, "--device", "cpu"])
    return capsys.readouterr().out, result


@pytest.mark.parametrize("name", ["case_study_transceiver", "quickstart"])
def test_prints_the_reference_text(name, monkeypatch, capsys):
    want = _reference(name, [], monkeypatch, capsys)
    got, _ = _port(name, [], capsys)
    assert got == want
    if name == "case_study_transceiver":
        assert "-> 28.6% saving  (paper: 28.4%)" in got
        assert "-> 29.4% saving  (paper: 29.3%)" in got
    else:
        assert "achieved 0.801 V" in got and "(6 transactions)" in got


def _split(text, start, end):
    """`text` less the lines from the one holding `start` up to the one
    holding `end` (numpy may wrap a printed array); returns (rest, cut)."""
    lines = text.splitlines()
    i = next(k for k, s in enumerate(lines) if start in s)
    j = next(k for k in range(i, len(lines)) if end in lines[k])
    return lines[:i] + lines[j + 1:], "\n".join(lines[i:j + 1])


def test_serve_decode_matches_the_reference(monkeypatch, capsys):
    want, _ = _split(_reference("serve_decode", [], monkeypatch, capsys),
                     "first sequence:", "...")
    got, first = _split(_port("serve_decode", [], capsys)[0],
                        "first sequence:", "...")
    assert got == want
    assert "serving 6.8M-param model, batch=4" in got
    assert "deterministic generation: True" in got
    tokens = first.split("[")[1].split("]")[0].split()
    assert len(tokens) == 16 and all(0 <= int(t) < 4096 for t in tokens)


def test_train_voltune_lm_matches_the_reference(tmp_path, monkeypatch,
                                                capsys):
    want, _ = _split(_reference(
        "train_voltune_lm", [*TRAIN_ARGS, "--ckpt-dir", str(tmp_path / "j")],
        monkeypatch, capsys), "loss:", "loss:")
    out, trainer = _port("train_voltune_lm",
                         [*TRAIN_ARGS, "--ckpt-dir", str(tmp_path / "t")],
                         capsys)
    got, loss = _split(out, "loss:", "loss:")
    assert got == want
    assert "fault tolerance: 0 restarts, 0 stragglers mitigated, " \
        "1 checkpoints" in got
    head, tail = (float(w) for w in loss.split()[1:4:2])
    assert math.isfinite(head) and math.isfinite(tail)
    assert len(trainer.step_times) == 8 and trainer.ckpt.latest_step() == 8
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        ["step_00000008"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.mark.parametrize("name", NAMES)
def test_needs_a_card_without_device_cpu(no_card, name, tmp_path):
    argv = ["--ckpt-dir", str(tmp_path)] if name == "train_voltune_lm" \
        else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"repro_torch.examples.{name}").main(argv)


def test_runs_as_a_module(no_card):
    """`python -m repro_torch.examples.<name>`: with `--device cpu` the case
    study prints its text; without it the process fails, no card."""
    cmd = [sys.executable, "-m", "repro_torch.examples.case_study_transceiver"]
    env = one_thread_env(PYTHONPATH=str(ROOT / "src"))
    ok = subprocess.run(cmd + ["--device", "cpu"], env=env,
                        capture_output=True, text=True, check=True)
    assert "=== Fig 16: BER-aware power savings at 10 Gbps ===" in ok.stdout
    bad = subprocess.run(cmd, env=env, capture_output=True, text=True)
    assert bad.returncode != 0 and "no CUDA device" in bad.stderr
