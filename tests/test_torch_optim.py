"""The port's optimizer, schedules and data pipeline against the
reference's on the same numpy inputs: three AdamW steps with f32 and int8
moments (int8 codes exactly equal), `wsd` and `cosine` at a sweep of steps,
and `SyntheticLM` batches bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tsched
from torch_threads import one_torch_thread  # noqa: F401

# f32 AdamW: the same elementwise ops in the same order; the global norm
# sums in another order, so the clip factor (and through it every update)
# may differ in the last bits
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)
# schedules: the same f32 ops; pow and cos may differ by an ulp
SCHED_TOL = dict(rtol=1e-6, atol=0.0)


def _tree(seed):
    """A parameter-like tree: nested dicts, 1-D leaves (no weight decay),
    a leaf whose size is not a multiple of the 256-element int8 block."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (40, 24), "final_norm_w": (24,),
              "blocks": {"attn": {"wq": (2, 24, 3, 8)}, "ln1_w": (2, 24),
                         "mlp": {"w_in": (2, 24, 13)}}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    return make(shapes)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_three_steps_match_reference(state_dtype):
    cfg_j = jadamw.AdamWConfig(state_dtype=state_dtype)
    cfg_t = tadamw.AdamWConfig(state_dtype=state_dtype)
    params_np = _tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    tp = _to_torch(params_np)
    js = jadamw.init_state(jp, cfg_j)
    ts = tadamw.init_state(tp, cfg_t)
    for step in range(3):
        grads_np = jax.tree_util.tree_map(lambda a: a * (0.5 + step),
                                          _tree(10 + step))
        lr = np.float32(1e-2 / (step + 1))
        jp, js, jm = jadamw.apply_updates(
            jp, jax.tree_util.tree_map(jnp.asarray, grads_np), js,
            jnp.asarray(lr), cfg_j)
        tp2, ts2, tm = tadamw.apply_updates(
            tp, _to_torch(grads_np), ts, torch.tensor(lr), cfg_t)
        assert tp2 is tp and ts2 is ts       # updated in place
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for path in tadamw.leaf_paths(tp):
        jleaf = jp
        for k in path:
            jleaf = jleaf[k]
        np.testing.assert_allclose(tadamw.get_path(tp, path).numpy(),
                                   np.asarray(jleaf), **ADAM_TOL,
                                   err_msg=str(path))
    for moment in ("m", "v"):
        jflat = jax.tree_util.tree_leaves(js[moment])
        tflat = [tadamw.get_path(ts[moment], p)
                 for p in tadamw.leaf_paths(ts[moment])]
        assert len(jflat) == len(tflat)
        for j, t in zip(jflat, tflat):
            if t.dtype == torch.int8:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           **ADAM_TOL)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_chunked_update_equals_one_pass(state_dtype, monkeypatch):
    """Large leaves are updated in slices of their leading axis (at 512
    elements a slice here: 4 slices of a [8, 32, 8] leaf, 2 of a [12, 64]
    leaf whose slices are 8 and 4 rows); params and moments, the int8
    codes and scales included, equal one pass over each leaf bit for
    bit."""
    cfg = tadamw.AdamWConfig(state_dtype=state_dtype)
    rng = np.random.default_rng(3)
    shapes = {"a": (8, 32, 8), "b": (12, 64), "c": (300,), "d": (5, 7, 3)}

    def tree():
        return {k: torch.from_numpy(rng.standard_normal(v).astype(
            np.float32)) for k, v in shapes.items()}

    params = tree()
    grads = [tree() for _ in range(3)]
    runs = []
    for chunk in (512, 1 << 26):
        monkeypatch.setattr(tadamw, "CHUNK_ELEMENTS", chunk)
        p = {k: v.clone() for k, v in params.items()}
        st = tadamw.init_state(p, cfg)
        for g in grads:
            tadamw.apply_updates(p, g, st, torch.tensor(1e-2), cfg)
        runs.append((p, st))
    assert [len(tadamw._row_chunks(params[k])) for k in "abcd"] == [1] * 4
    monkeypatch.setattr(tadamw, "CHUNK_ELEMENTS", 512)
    assert [len(tadamw._row_chunks(params[k])) for k in "abcd"] == \
        [4, 2, 1, 1]
    one, two = ({"p": p, "m": st["m"], "v": st["v"]} for p, st in runs)
    for path in tadamw.leaf_paths(one):
        assert torch.equal(tadamw.get_path(one, path),
                           tadamw.get_path(two, path)), path


def test_int8_init_state_is_the_codes_of_zeros():
    p = {"a": torch.ones((3, 100)), "b": torch.ones(256)}
    st = tadamw.init_state(p, tadamw.AdamWConfig(state_dtype="int8"))
    for k, leaf in p.items():
        want = tadamw._q_encode(torch.zeros(leaf.shape))
        for moment in ("m", "v"):
            got = st[moment][k]
            assert got["q"].dtype == want["q"].dtype
            assert torch.equal(got["q"], want["q"])
            assert torch.equal(got["scale"], want["scale"])


def test_q_codec_round_half_to_even_matches_reference():
    x = np.concatenate([np.arange(-6, 7, dtype=np.float32) * 0.5 * 127 / 3,
                        np.random.default_rng(1).standard_normal(300).astype(
                            np.float32)])
    tj = jadamw._q_encode(jnp.asarray(x))
    tt = tadamw._q_encode(torch.from_numpy(x))
    np.testing.assert_array_equal(tt["q"].numpy(), np.asarray(tj["q"]))
    np.testing.assert_array_equal(tt["scale"].numpy(),
                                  np.asarray(tj["scale"]))
    np.testing.assert_array_equal(
        tadamw._q_decode(tt, x.shape).numpy(),
        np.asarray(jadamw._q_decode(tj, x.shape)))


def test_global_norm_matches_reference():
    tree = _tree(3)
    np.testing.assert_allclose(
        tadamw.global_norm(_to_torch(tree)).numpy(),
        np.asarray(jadamw.global_norm(
            jax.tree_util.tree_map(jnp.asarray, tree))), rtol=1e-6)


STEPS = [0, 1, 5, 9, 10, 11, 50, 79, 80, 81, 95, 99, 100, 140]


@pytest.mark.parametrize("name,kw", [
    ("wsd", dict(peak_lr=3e-4, warmup_steps=10, stable_steps=70,
                 decay_steps=20)),
    ("wsd", dict(peak_lr=1e-3, warmup_steps=0, stable_steps=0,
                 decay_steps=0, final_frac=0.3)),
    ("cosine", dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)),
])
def test_schedules_match_reference(name, kw):
    for s in STEPS:
        want = np.asarray(jsched.SCHEDULES[name](s, **kw))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = tsched.SCHEDULES[name](step, **kw)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(got.numpy(), want, **SCHED_TOL,
                                       err_msg=f"{name} step {s}")


@pytest.mark.parametrize("vocab,seq,batch", [(512, 64, 4), (122753, 40, 2)])
def test_synthetic_batches_identical(vocab, seq, batch):
    jd = jpipe.SyntheticLM(jpipe.DataConfig(vocab, seq, batch))
    td = tpipe.SyntheticLM(tpipe.DataConfig(vocab, seq, batch))
    for step in (0, 3):
        jb, tb = jd.batch(step), td.torch_batch(step, "cpu")
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), jb[k])
