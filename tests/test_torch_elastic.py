"""Elastic restore: `CheckpointManager.restore(shardings=)` and the ported
`examples/elastic_restart.py`, on the CPU.

- A placed checkpoint of tiny MiniCPM (bf16 params, f32 moments, one placed
  step) written by a gloo world of 4 on a (data, model) mesh of 2 x 2
  (`sharded_worlds.elastic_save_world`) restores onto `(data,)` meshes of
  8 and of 1 (`elastic_restore_world`): every rank's blocks equal the
  slices of the saved state bit for bit, and a placed step runs from there
  (the two worlds' losses within ACROSS_WORLDS_RTOL: 8 ranks' means of one
  row against one mean of 8 rows, in bf16).
- The placed checkpoint restores in the reference (its `restore`), and the
  reference's checkpoint restores placed on the 2 x 2 mesh: bit for bit.
- The ported example (`python -m repro_torch.examples.elastic_restart
  --device cpu`, the reference's init through `--params`) against the
  reference's example (a subprocess on 8 forced host devices): the same
  lines, the printed losses within EXAMPLE_RTOL (bf16; 2.0e-4 measured),
  and both continuity checks OK. The reference's example fails as written
  under jax 0.9.0: `jax.make_mesh` makes Explicit axes, and the embedding
  gather of a batch placed on them raises `ShardingTypeError`. The test
  runs its text with `axis_types=(AxisType.Auto,)` on both meshes and its
  checkpoint path under the test's temporary directory (its source is read
  and patched in memory; the file is untouched) — ROADMAP "Known
  disagreements".
"""

import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sharded_worlds as sw
from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro_torch.parallel import sharding as tshd
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 300
EXAMPLE_TIMEOUT_S = 400
REF_CKPT_STEP = 5
ACROSS_WORLDS_RTOL = 1e-2
EXAMPLE_RTOL = 1e-3
REF_EXAMPLE = os.path.join(ROOT, "examples", "elastic_restart.py")
AUTO = "axis_types=(jax.sharding.AxisType.Auto,)"
# the reference example's text, run with Auto mesh axes and a checkpoint
# path of the test's own (module docstring)
REF_RUNNER = f"""
import sys
src = open({REF_EXAMPLE!r}).read()
for old, new in (
        ('"/tmp/voltune_elastic_ckpt"', repr(sys.argv[1])),
        ('devices=jax.devices()[:4])', 'devices=jax.devices()[:4], {AUTO})'),
        ('jax.make_mesh((8,), ("data",))',
         'jax.make_mesh((8,), ("data",), {AUTO})')):
    assert src.count(old) == 1, old
    src = src.replace(old, new)
exec(compile(src, {REF_EXAMPLE!r}, "exec"), {{"__name__": "__main__"}})
"""


def _env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu", **extra,
                PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT,
                                            os.path.join(ROOT, "tests")]))


def _ref_state():
    """The reference's tiny MiniCPM (bf16) and AdamW state after one update
    (nonzero moments), as its checkpoint holds them."""
    cfg = jget("minicpm_2b", tiny=True)
    params = jreg.build(cfg, remat="none").init(jax.random.PRNGKey(0))
    opt_cfg = jadamw.AdamWConfig()
    grads = jax.tree_util.tree_map(lambda a: a * 0.01, params)
    params, opt, _ = jadamw.apply_updates(
        params, grads, jadamw.init_state(params, opt_cfg), 1e-3, opt_cfg)
    return {"params": params, "opt": opt}


@pytest.fixture(scope="module")
def elastic():
    out = tempfile.mkdtemp(prefix="elastic_")
    try:
        yield _elastic_runs(out)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _elastic_runs(out: str) -> dict:
    """The fixture's runs, their files under `out`."""
    init = jreg.build(jget("minicpm_2b", tiny=True), remat="none").init(
        jax.random.PRNGKey(0))
    params_path = os.path.join(out, "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), init), f)
    ref_state = _ref_state()
    JCheckpointManager(os.path.join(out, "ref_ckpt"), async_save=False).save(
        REF_CKPT_STEP, ref_state)
    ref_ex = subprocess.Popen(
        [sys.executable, "-c", REF_RUNNER, os.path.join(out, "ref_example")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    port_ex = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.elastic_restart",
         "--device", "cpu", "--ckpt-dir", os.path.join(out, "port_example"),
         "--params", params_path], env=one_thread_env(_env()),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        env = {"ELASTIC_PARAMS": params_path, "ELASTIC_DIR": out}
        saved = sw.spawn_world("elastic_save_world", 4,
                               os.path.join(out, "w4"), WORLD_TIMEOUT_S, env)
        restored = {n: sw.spawn_world("elastic_restore_world", n,
                                      os.path.join(out, f"w{n}_restore"),
                                      WORLD_TIMEOUT_S, env)
                    for n in (8, 1)}
        texts = {}
        for name, proc in (("reference", ref_ex), ("port", port_ex)):
            text, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            assert proc.returncode == 0, err[-3000:]
            texts[name] = text
    finally:
        for proc in (ref_ex, port_ex):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"dir": out, "saved": saved, "restored": restored,
            "ref_state": ref_state, "texts": texts}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _check_blocks(blocks: dict, whole: dict, mesh, coord) -> int:
    """Every leaf of `blocks` (a rank's) equals the slice of `whole` under
    `named_shardings` on `mesh` at `coord`, bit for bit; returns the leaves
    compared."""
    n = 0
    for group in ("params", "opt"):
        shard = tshd.named_shardings(whole[group], mesh)
        for path, full in _leaves(whole[group]):
            full = np.asarray(full, np.float32)
            want = full[tshd.block_index(full.shape, _get(shard, path),
                                         coord)]
            np.testing.assert_array_equal(_get(blocks[group], path), want,
                                          err_msg=f"{group} {path}")
            n += 1
    return n


@pytest.mark.parametrize("world", [8, 1])
def test_a_placed_checkpoint_restores_onto_another_world(elastic, world):
    whole = elastic["saved"][0]["whole"]
    mesh = tshd.SpecMesh(("data",), (world,))
    ranks = elastic["restored"][world]
    for r in ranks:
        assert r["step"] == sw.ELASTIC_STEP
        assert _check_blocks(r["blocks"], whole, mesh, r["coord"]) > 20
        assert np.isfinite(r["loss"])
    # a placed leaf is cut 8 ways over data (embed's D of 128)
    assert ranks[0]["blocks"]["params"]["embed"].shape[1] == 128 // world
    assert len({r["loss"] for r in ranks}) == 1


def test_the_restored_worlds_train_on(elastic):
    l8 = elastic["restored"][8][0]["loss"]
    l1 = elastic["restored"][1][0]["loss"]
    np.testing.assert_allclose(l8, l1, rtol=ACROSS_WORLDS_RTOL)


def test_a_placed_checkpoint_restores_in_the_reference(elastic):
    whole = elastic["saved"][0]["whole"]
    like = elastic["ref_state"]
    step, got = JCheckpointManager(
        os.path.join(elastic["dir"], "port_ckpt")).restore(like)
    assert step == sw.ELASTIC_STEP
    for group in ("params", "opt"):
        flat = dict(_leaves(whole[group]))
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                got[group])[0]:
            keys = tuple(getattr(k, "key", None) for k in path)
            assert leaf.dtype == _get(like[group], keys).dtype
            np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                          flat[keys], err_msg=str(keys))


def test_the_references_checkpoint_restores_placed(elastic):
    ref = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                 elastic["ref_state"])
    mesh = tshd.SpecMesh(*reversed(sw.ELASTIC_SAVE_MESH))
    for r in elastic["saved"]:
        assert _check_blocks(r["from_ref"], ref, mesh, r["coord"]) > 20


LINES = [r"phase 1 \(4 devices\): steps 0-9, loss (\S+) -> (\S+)",
         r"checkpoint written at step 10",
         r"phase 2 \(8 devices\): steps 10-19, loss (\S+) -> (\S+)",
         r"",
         r"continuity check: restored-step loss (\S+) vs uninterrupted "
         r"(\S+) \(rel drift (\S+)\)",
         r"elastic restore onto a larger mesh: OK"]


def _numbers(text: str) -> list[float]:
    lines = text.strip().splitlines()
    assert len(lines) == len(LINES), text
    out = []
    for line, pat in zip(lines, LINES):
        m = re.fullmatch(pat, line)
        assert m, (line, pat)
        out.extend(float(g) for g in m.groups())
    return out


def test_the_example_prints_the_references_lines(elastic):
    port = _numbers(elastic["texts"]["port"])
    ref = _numbers(elastic["texts"]["reference"])
    # the losses (the last number is each package's own drift)
    np.testing.assert_allclose(port[:-1], ref[:-1], rtol=EXAMPLE_RTOL)
    assert port[-1] < 1e-3 and ref[-1] < 1e-3
