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
  moments; the per-device FLOPs within GROK_FLOPS_RTOL of the closed form
  of each rank's share (the MoE's 1/16 on every model rank, the rank's
  heads and vocab), the peak under GROK_PEAK_BYTES;
- Mistral-Large at full width cut to 2 of its 88 layers on the
  single-pod mesh, trained once with int8 and once with f32 moments (a
  driver in a process of its own, `INT8_DRIVER`): the int8 update gathers
  nothing more, and the bytes its all-to-alls add are at most twice the
  f32 bytes of the rank's blocks (its moments' rows and its params'
  blocks);
- `launch/train.py --arch whisper_base --dry-run`: exits 0 and writes the
  two meshes' records.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config
from repro_torch.models.mlp import MoESpec, moe_capacity
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

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
    "int8": ["-c"],
}
# the dry run counts every matmul exactly; the closed form leaves out the
# attention scores and the elementwise work (under 2 % of the cell)
GROK_FLOPS_RTOL = 0.15
# an eighth of the peak the cell had while every model rank computed the
# whole MoE layer (4.000e12 B)
GROK_PEAK_BYTES = 5.0e11
# Mistral-Large's placed step at reduced depth and one microbatch (the
# update runs once a step either way), with each kind of AdamW moments:
# the step's collective bytes and the rank's blocks' elements
INT8_DRIVER = """
import dataclasses, json
import repro_torch.launch.dryrun as d
from repro_torch.configs.base import get_config
arch = "mistral_large_123b"
cfg = dataclasses.replace(get_config(arch), n_layers=2)
d.get_config = lambda a, tiny=False: cfg
d.MICROBATCHES[arch] = 1
d.init_world(256)

def codes(t):
    if isinstance(t, dict) and "q" in t and not isinstance(t["q"], dict):
        return [t["q"]]
    return [x for v in t.values() for x in codes(v)] if isinstance(
        t, dict) else []

out = {}
for kind in ("int8", "float32"):
    d.INT8_OPT = {arch} if kind == "int8" else set()
    rec = d.run_cell(arch, "train_4k", "single")
    _, args = d.build_cell(arch, "train_4k", d.production_mesh("single"))
    out[kind] = dict(
        coll=rec["collective_bytes"], peak=rec["memory"]["peak_bytes"],
        params=sum(t.numel() for t in d._local_tensors(args["params"])),
        rows=sum(q.to_local().numel() for q in codes(args["opt"]["m"])))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = one_thread_env(PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for name, argv in RUNS.items():
        out = tmp_path_factory.mktemp(name)
        extra = ([INT8_DRIVER] if name == "int8" else [] if name == "train"
                 else ["--out", str(out)])
        flag = [] if argv[0] == "-c" else ["-m"]
        procs[name] = (out, subprocess.Popen(
            [sys.executable, *flag, *argv, *extra], cwd=out, env=env,
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


def test_grok_train_counts_each_model_ranks_share(runs):
    """The closed form of a device's FLOPs on the two-pod mesh: its 8 rows
    of 4096 tokens (256 over pod x data); a layer's forward runs the MoE
    buffer's E x cap rows a batch row at 6 D F a row split over the 16
    model ranks, and its 3 of the 48 padded q heads and 1 of the 16 kv
    heads at 2 FLOPs a weight a token, four times over (the forward, the
    backward's two, the remat recompute); the head's 1/16 of the vocab at
    6 a weight a token."""
    rec = _record(runs, "grok", "multi")
    cfg = get_config("grok1_314b")
    plan = cfg.head_plan()
    tp, rows, T = 16, 256 // 32, 4096
    D, F, E, Dh = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.head_dim_
    cap = moe_capacity(T, MoESpec(D, F, E, cfg.experts_per_token))
    moe = 6 * D * F * E * cap * rows / tp
    attn = 2 * D * Dh * (2 * plan.n_q_pad + 2 * plan.n_kv_pad) / tp \
        * rows * T
    head = 6 * D * cfg.vocab_padded / tp * rows * T
    closed = 4 * cfg.n_layers * (moe + attn) + head
    assert rec["flops"] == pytest.approx(closed, rel=GROK_FLOPS_RTOL)
    assert rec["memory"]["peak_bytes"] <= GROK_PEAK_BYTES


def test_int8_update_moves_only_the_ranks_blocks(runs):
    out, rc, so, se = runs["int8"]
    assert rc == 0, so[-2000:] + se[-2000:]
    got = json.loads(so.strip().splitlines()[-1])
    int8, f32 = got["int8"]["coll"], got["float32"]["coll"]
    # the int8 update gathers nothing
    assert int8["all-gather"] == f32["all-gather"]
    assert int8["op_counts"]["all-gather"] == f32["op_counts"]["all-gather"]
    # its all-to-alls: the gradient's elements to the moments' rows and
    # the direction's back to the params' blocks, in f32
    blocks = 4 * (got["int8"]["rows"] + got["int8"]["params"])
    extra = int8["all-to-all"] - f32["all-to-all"]
    assert 0 < extra <= 2 * blocks


def test_the_train_launchers_dry_run_runs(runs):
    out, rc, so, se = runs["train"]
    assert rc == 0, so[-2000:] + se[-2000:]
    assert "2/2 cells passed" in so
    with open(out / "reports" / "dryrun_single_multi.json") as f:
        recs = json.load(f)
    assert [(r["mesh"], r["ok"]) for r in recs] == [("single", True),
                                                    ("multi", True)]
