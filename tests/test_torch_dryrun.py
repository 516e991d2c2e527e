"""The dry run (`launch/dryrun.py`) and `launch/train.py --dry-run`, each in
a process of its own (the `fake` world of 256 or 512 ranks never reaches
this test process), all started together:

- the reference's own slow test's cell (`whisper_base` x `decode_32k` on
  the single-pod mesh): ok, 256 devices, FLOPs and collective bytes;
- `qwen2p5_14b` x `decode_32k`: the per-device FLOPs equal the closed form
  of the TP decode (each rank's 8 rows, 3 of the 48 padded q heads and 1
  of the 16 kv heads, 864 of the ff and 9,600 of the padded vocab; K3 over
  all 32,768 cache slots), and the all-reduces are the TP design's: the
  vocab-parallel embedding's and two a layer (attention, MLP), each's wire
  bytes at the reference's ring factor over the 16 model ranks;
- `grok1_314b` x `train_4k` on the two-pod mesh: 512 devices, int8 AdamW
  moments, ok;
- `launch/train.py --arch whisper_base --dry-run`: exits 0 and writes the
  two meshes' records.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
RUNS = {
    "whisper": ["repro_torch.launch.dryrun", "--arch", "whisper_base",
                "--shape", "decode_32k", "--mesh", "single"],
    "qwen": ["repro_torch.launch.dryrun", "--arch", "qwen2p5_14b",
             "--shape", "decode_32k", "--mesh", "single"],
    "grok": ["repro_torch.launch.dryrun", "--arch", "grok1_314b",
             "--shape", "train_4k", "--mesh", "multi"],
    "train": ["repro_torch.launch.train", "--arch", "whisper_base",
              "--dry-run"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for name, argv in RUNS.items():
        out = tmp_path_factory.mktemp(name)
        extra = [] if name == "train" else ["--out", str(out)]
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", *argv, *extra], cwd=out, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    done = {}
    try:
        for name, (out, proc) in procs.items():
            so, se = proc.communicate(timeout=TIMEOUT_S)
            done[name] = (out, proc.returncode, so, se)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return done


def _record(runs, name, mesh="single"):
    out, rc, so, se = runs[name]
    assert rc == 0, so[-2000:] + se[-2000:]
    with open(out / f"dryrun_{mesh}.json") as f:
        recs = json.load(f)
    assert len(recs) == 1
    return recs[0]


def test_the_references_cell_runs(runs):
    rec = _record(runs, "whisper")
    assert rec["ok"] and rec["devices"] == 256
    assert rec["flops"] > 0
    assert rec["collective_bytes"]["total"] > 0
    for key in ("arch", "shape", "mesh", "lower_s", "compile_s",
                "bytes_accessed", "utilization_ops", "memory", "corrected"):
        assert key in rec
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]


def test_qwen_decode_counts_equal_the_tp_design(runs):
    rec = _record(runs, "qwen")
    cfg = get_config("qwen2p5_14b")
    plan = cfg.head_plan()
    tp, dp = 16, 16
    B = 128 // dp
    D, Dh, S = cfg.d_model, cfg.head_dim_, 32768
    hq, hkv = plan.n_q_pad // tp, plan.n_kv_pad // tp
    ff, vocab = cfg.d_ff // tp, cfg.vocab_padded // tp
    layer = (2 * B * D * hq * Dh + 2 * 2 * B * D * hkv * Dh
             + 2 * B * hq * Dh * D + 3 * 2 * B * D * ff
             + 4 * Dh * hq * B * S)
    assert rec["flops"] == cfg.n_layers * layer + 2 * B * D * vocab
    assert rec["collective_bytes"]["op_counts"]["all-reduce"] == \
        1 + 2 * cfg.n_layers
    # each a [8, 1, 5120] bf16 activation, at the reference's ring factor
    # 2 (P - 1) / P over the 16 model ranks
    assert rec["collective_bytes"]["all-reduce"] == \
        (1 + 2 * cfg.n_layers) * B * D * 2 * 2 * (tp - 1) / tp


def test_grok_trains_with_int8_moments_on_two_pods(runs):
    rec = _record(runs, "grok", "multi")
    assert rec["ok"] and rec["devices"] == 512
    assert rec["flops"] > 0 and rec["collective_bytes"]["total"] > 0


def test_the_train_launchers_dry_run_runs(runs):
    out, rc, so, se = runs["train"]
    assert rc == 0, so[-2000:] + se[-2000:]
    assert "2/2 cells passed" in so
    with open(out / "reports" / "dryrun_single_multi.json") as f:
        recs = json.load(f)
    assert [(r["mesh"], r["ok"]) for r in recs] == [("single", True),
                                                    ("multi", True)]
