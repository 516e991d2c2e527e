"""The vlm family (InternVL2) and the stub modality frontends on the port
against the reference: `stub_frontend_inputs` equal to the reference's
arrays bit for bit; `SyntheticLM.torch_batch(extra=)` merging them as
`jax_batch(step, extra)` does; tiny InternVL2's `forward_train` loss and
every gradient with the image prefix (labels -1 over it), and without
images (img_proj's gradient zero, as the train step materializes it);
`ServeEngine.generate` tokens (prefill and decode read tokens only, as the
reference's do); the configuration and parameter tree; the train
launcher's batches."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import policy as jpol
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.core import policy as tpol
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.engine import ServeEngine as TEngine
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "internvl2_2b"
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
N_PARAMS = 2_000_783_360      # internvl2_2b's tree (img_proj 4.2 M of it)


@pytest.mark.parametrize("arch", ["internvl2_2b", "whisper_base",
                                  "qwen2p5_14b"])
@pytest.mark.parametrize("tiny", [True, False], ids=["TINY", "CONFIG"])
def test_stub_frontend_inputs_equal_the_reference(arch, tiny):
    tcfg, jcfg = tget(arch, tiny=tiny), jget(arch, tiny=tiny)
    B = 2 if tiny else 1
    for seed in (0, 3):
        want = jpipe.stub_frontend_inputs(jcfg, jcfg.family, B, seed)
        got = tpipe.stub_frontend_inputs(tcfg, tcfg.family, B, seed,
                                         device="cpu")
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert bool(got) == (tcfg.family in ("vlm", "encdec"))


def test_torch_batch_merges_extra_as_jax_batch_does():
    cfg = tget(ARCH, tiny=True)
    dcfg = (cfg.vocab_size, 8, 2)
    extra = tpipe.stub_frontend_inputs(cfg, cfg.family, 2, device="cpu")
    tb = tpipe.SyntheticLM(tpipe.DataConfig(*dcfg)).torch_batch(1, "cpu",
                                                                extra)
    jb = jpipe.SyntheticLM(jpipe.DataConfig(*dcfg)).jax_batch(
        1, jpipe.stub_frontend_inputs(jget(ARCH, tiny=True), "vlm", 2))
    assert set(tb) == set(jb) == {"tokens", "labels", "img_embeds"}
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    launcher = launch_train.FrontendData(tpipe.DataConfig(*dcfg), cfg)
    lb = launcher.torch_batch(1, "cpu")
    for k in jb:
        np.testing.assert_array_equal(lb[k].numpy(), np.asarray(jb[k]))


def _pair():
    jcfg = dataclasses.replace(jget(ARCH, tiny=True), dtype="float32")
    tcfg = dataclasses.replace(tget(ARCH, tiny=True), dtype="float32")
    jparams = jreg.build(jcfg).init(jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  jparams)
    return jcfg, tcfg, jparams, treg.params_from_jax(tcfg, tree, "cpu")


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("images", [True, False],
                         ids=["with_images", "tokens_only"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_train_loss_and_grads_match_reference(remat, images):
    jcfg, tcfg, jparams, tparams = _pair()
    rng = np.random.default_rng(6)
    B, T = 2, 24
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(-1, jcfg.vocab_size, (B, T)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if images:
        jb.update(jpipe.stub_frontend_inputs(jcfg, "vlm", B, seed=4))
        tb.update(tpipe.stub_frontend_inputs(tcfg, "vlm", B, seed=4,
                                             device="cpu"))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.forward_train(p, jb, jcfg, remat=remat),
        has_aux=True))(jparams)
    paths = tadamw.leaf_paths(tparams)
    leaves = [tadamw.get_path(tparams, p) for p in paths]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, tmet = treg.build(tcfg, remat=remat).loss_fn(tparams, tb)
    grads = torch.autograd.grad(tloss, leaves, materialize_grads=True)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(tmet["ce_loss"].item(), float(jmet["ce_loss"]),
                               **LOSS_TOL)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(_leaf(jgrads, path)),
                                   **GRAD_TOL, err_msg=str(path))
    g_img = grads[paths.index(("img_proj",))]
    assert (g_img.abs().max().item() > 0) == images


def test_generate_tokens_match_reference():
    jcfg, tcfg, jparams, tparams = _pair()
    B, TP, NEW = 2, 16, 10
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, TP)).astype(np.int32)
    je = JEngine(jcfg, jparams, max_len=TP + NEW + 8, batch_size=B,
                 policy=jpol.PhaseAware())
    te = TEngine(tcfg, tparams, max_len=TP + NEW + 8, batch_size=B,
                 policy=tpol.PhaseAware(), device="cpu")
    jtok, ttok = je.generate(prompts, NEW), te.generate(prompts, NEW)
    np.testing.assert_array_equal(ttok, jtok)
    assert len(np.unique(ttok)) > 1


def test_parameter_tree_read_without_allocating():
    """The full configuration's shape tree against the reference's
    `abstract_params`: the same leaves, shapes and dtypes, 2.00 B
    parameters (it trains at full width and depth on one card)."""
    cfg = tget(ARCH)
    shapes = tlm.param_shapes(cfg)
    abstract = jreg.abstract_params(jget(ARCH))
    flat_t = sorted(tuple(s) for s in tlm.tree_leaves(shapes))
    flat_j = sorted(tuple(a.shape)
                    for a in jax.tree_util.tree_leaves(abstract))
    assert flat_t == flat_j
    assert shapes["img_proj"] == (2048, 2048)
    assert sum(math.prod(s) for s in flat_t) == N_PARAMS
    plan = cfg.head_plan()
    assert (plan.n_q_pad, plan.n_kv_pad, plan.group, cfg.head_dim_) == \
        (16, 16, 1, 128)


def test_train_launcher_takes_internvl(capsys):
    launch_train.main(["--arch", ARCH, "--tiny", "--steps", "2", "--seq",
                       "16", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "internvl2-tiny: 0.8M params (tiny=True)" in out
    first, last = out.split("loss ")[1].split(";")[0].split(" -> ")
    assert math.isfinite(float(first)) and math.isfinite(float(last))
