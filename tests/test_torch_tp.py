"""Tensor-parallel compute over 'model' (`parallel/sharding.py` TP regions,
the models' TP sites, the placed train step's int8 moments, the placed
prefill and decode of `registry.build(cfg)`), in a gloo world of 4
processes on the CPU on a (data 2, model 2) mesh (`sharded_worlds.tp_world`,
spawned once for every family):

- every family's tiny f32 config (`TP_ARCHS`: dense MHA and MQA, the MoE
  under moe_ep and under the default rules, the latter with 4 experts
  (`w_out` by its experts over 'model') and with 3 (`w_out`'s ff over
  'data', each rank's ff rows moved to it), vlm, encdec, hybrid, ssm)
  served placed: the prefill (the encdec family: its decode on the whole
  cross K/V) and TP_NEW greedy decode steps on params placed by
  `named_shardings` and the cache by `serve_cache_pspecs`. Each rank's
  logits blocks, the tokens and its cache blocks equal bit for bit the
  one-process run of the same split (`tp_serve_oracle`: each model rank a
  thread of `sharding.run_model_ranks`, the reductions' sums in rank
  order), and the whole logits equal the reference's prefill and decode
  jitted on the same placements on 4 forced host devices
  (`sharded_reference.py tp_serve`) within LOGIT_TOL, the tokens equal up
  to the first step whose top-2 gap lies under NEAR_TIE;
- the placed train steps `fsdp_world` does not take (TP_TRAIN: the vlm,
  and tiny Grok-1 (4 and 3 experts) and Mistral-Large with int8 AdamW
  moments): losses, norms and every rank's blocks equal the one-process
  run bit for bit (`placed_oracle`, the norm over the params' blocks),
  and the
  reference's sharded jit (with `AdamWConfig(state_dtype="int8")`) at
  `test_torch_fsdp.py`'s tolerances. `test_torch_fsdp.py`'s 2 x 2 runs
  hold the dense, moe_ep, encdec, hybrid and ssm train steps on TP;
- one placed step of tiny MiniCPM under `CommDebugMode`: its all-gathers
  are exactly those of the data axis (each leaf's FSDP gather, the
  gradients of the leaves replicated over data, the means of the loss and
  metrics) and the norm's two, so no leaf is gathered along 'model'; its
  all-reduces are the TP regions' (a reduce each attention, MLP and
  embedding, three in the vocab-parallel loss, a copy's backward each
  region input); and one of tiny Grok-1 in each MoE layout, whose
  all-gathers and all-to-alls are the placement's and the MoE layer's
  activations' (`test_no_moe_leaf_is_gathered_along_model`).

Beside the world, in this process: the region functions' gradients in a
one-process emulation, the MoE's splits (the rank's experts, the experts'
ff, the default rules' d_model with `w_out` by experts or by ff) against
the whole layer with their gradients, the TP plan of the production
meshes, and a one-rank model group's bit-for-bit identity.
"""

import os
import pickle
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import sharded_worlds as sw
from repro_torch.configs import get_config as tget
from repro_torch.models import mlp as tmlp
from repro_torch.models import registry as treg
from repro_torch.models.lm import tree_map as tmap
from repro_torch.parallel import sharding as tshd
from test_torch_fsdp import (FLIP_FRAC, FLIP_GAP, LOSS_RTOL, MOMENT_TOL,
                             NORM_RTOL, PARAM_TOL, _get, _leaves)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 300
REF_TIMEOUT_S = 400
PARAMS_SEED = 3
# the placed serve paths against the reference's sharded jit: f32 tiny
# models, the reductions over 'model' in another order
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)
NEAR_TIE = 1e-4
# int8 moments: the float-level gradient gaps (XLA against torch) move a
# moment's code across a .5 boundary now and then (`ROADMAP.md`, the ef
# codes' flips); a flipped second-moment code on an element whose v is
# small against its block's absmax moves that element's update m/sqrt(v)
# far past 1. The unplaced port against the unplaced reference shows the
# same after the same two steps (tiny Mistral-Large's w_gate: 8 of 98,304
# elements apart, the largest by 0.0150; tiny Grok-1's: 47 of 262,144, by
# 0.0067, where f32 moments stay within 8e-8). A flipped element's update
# is bounded only by 1/eps, so the int8 cases bound how many elements
# flip (INT8_FLIP_FRAC of a leaf), not by how much
INT8_FLIP_FRAC = 5e-4
INT8_FLIP_GAP = np.inf
INT8_MOMENT_TOL = dict(rtol=1e-2, atol=1e-6)
SERVE_ARCHS = [a for a, _ in sw.TP_ARCHS]
TRAIN_CASES = list(sw.TP_TRAIN)
REF_SERVE_SPLIT = 5
# the moe layer of the emulated splits
MOE_SPEC = tmlp.MoESpec(d_model=32, d_ff=16, n_experts=4, k=2)


def _serve_shardings(arch, tree):
    shape, axes = sw.TP_MESH
    return tshd.named_shardings(tree, tshd.SpecMesh(axes, shape),
                                **dict(sw.TP_ARCHS)[arch])


@pytest.fixture(scope="module")
def tp():
    """(the port's 4 ranks' results, the reference's serve runs, its train
    runs)."""
    out = tempfile.mkdtemp(prefix="tp_")
    params_path = os.path.join(out, "params.pkl")
    # the port's init from a seed, as numpy arrays in the reference's tree
    # layout, read by both packages (the reference's jax init of the nine
    # models would take ~35 s of this worker's time)
    params = {arch: tmap(lambda a: a.detach().numpy().copy(), treg.build(
        sw.fsdp_config(tget, arch)).init(
            torch.Generator().manual_seed(PARAMS_SEED)))
        for arch in SERVE_ARCHS}
    with open(params_path, "wb") as f:
        pickle.dump(params, f)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT,
                                           os.path.join(ROOT, "tests")]))
    script = os.path.join(ROOT, "tests", "sharded_reference.py")
    jobs = {"serve0": ["tp_serve", *SERVE_ARCHS[:REF_SERVE_SPLIT]],
            "serve1": ["tp_serve", *SERVE_ARCHS[REF_SERVE_SPLIT:]],
            "train": ["fsdp", *(f"{a}:data2_model2:{d}"
                                for a, d in TRAIN_CASES)]}
    refs = {}
    for name, (which, *cases) in jobs.items():
        path = os.path.join(out, f"reference_{name}.pkl")
        refs[name] = (path, subprocess.Popen(
            [sys.executable, script, which, path, params_path, *cases],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        ranks = sw.spawn_world("tp_world", sw.TP_RANKS,
                               os.path.join(out, "world"), WORLD_TIMEOUT_S,
                               env={"FSDP_PARAMS": params_path})
        ref = {}
        for name, (path, proc) in refs.items():
            _, err = proc.communicate(timeout=REF_TIMEOUT_S)
            assert proc.returncode == 0, err[-3000:]
            with open(path, "rb") as f:
                ref.update(pickle.load(f))
    finally:
        for _, proc in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out, ignore_errors=True)
    return ranks, ref


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_ranks_equal_the_one_process_split_bit_for_bit(tp, arch):
    ranks, _ = tp
    oracle = ranks[0]["serve", arch, "oracle"]
    k = sw.TP_BATCH // sw.TP_MESH[0][0]
    for r in ranks:
        got = r["serve", arch]
        want = oracle[got["coord"]]
        d = got["coord"][0]
        assert len(got["logits"]) == len(want["logits"])
        for a, b in zip(got["logits"], want["logits"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(a[d * k:(d + 1) * k], b)
        for path, block in _leaves(got["cache"]):
            np.testing.assert_array_equal(block, _get(want["cache"], path),
                                          err_msg=str(path))


def _whole_logits(ranks, arch, step):
    """The step's logits joined from the ranks' blocks ([B, 1, Vp]: rows
    over data, the vocab over model)."""
    rows = {}
    for r in ranks:
        d, m = r["serve", arch]["coord"]
        rows.setdefault(d, {})[m] = r["serve", arch]["logits"][step]
    return np.concatenate([np.concatenate([rows[d][m] for m in sorted(
        rows[d])], -1) for d in sorted(rows)])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_equals_the_references_sharded_jit(tp, arch):
    ranks, ref = tp
    want = ref[arch]
    cfg = sw.fsdp_config(tget, arch)
    got_tokens = ranks[0]["serve", arch]["tokens"]
    assert len(want["logits"]) == len(ranks[0]["serve", arch]["logits"])
    # the first step whose greedy pick is a near-tie: its logits are still
    # held, the tokens made from it and the steps after it are not
    tie = len(want["logits"])
    for step, w in enumerate(want["logits"]):
        top2 = np.sort(w[:, -1, :cfg.vocab_size], -1)[:, -2:]
        if (top2[:, 1] - top2[:, 0]).min() < NEAR_TIE:
            tie = step
            break
    for step in range(min(tie + 1, len(want["logits"]))):
        np.testing.assert_allclose(
            _whole_logits(ranks, arch, step)[..., :cfg.vocab_size],
            want["logits"][step][..., :cfg.vocab_size], **LOGIT_TOL,
            err_msg=f"step {step}")
    # token i is made from logits i (the encdec family: i - 1; its first
    # is the prompt's)
    lag = 1 if cfg.family == "encdec" else 0
    for i, tok in enumerate(want["tokens"]):
        if i - lag < tie:
            np.testing.assert_array_equal(got_tokens[i], tok)


@pytest.mark.parametrize("arch,dtype", TRAIN_CASES)
def test_train_ranks_equal_the_one_process_run_bit_for_bit(tp, arch, dtype):
    ranks, _ = tp
    want = ranks[0]["train", arch, "oracle"]
    for r in ranks:
        got = r["train", arch]
        assert got["loss"] == want["loss"]
        assert got["grad_norm"] == want["grad_norm"]
        shard = _serve_shardings(arch, want["params"])
        for path, full in _leaves(want["params"]):
            block = full[tshd.block_index(full.shape, _get(shard, path),
                                          got["coord"])]
            np.testing.assert_array_equal(_get(got["params"], path), block,
                                          err_msg=f"params {path}")
        if dtype == "float32":
            for path, full in _leaves(want["m"]):
                block = full[tshd.block_index(full.shape, _get(shard, path),
                                              got["coord"])]
                np.testing.assert_array_equal(_get(got["m"], path), block)


def _close_but_flips(got, want, tol, label, frac=FLIP_FRAC, gap=FLIP_GAP):
    """Within `tol` but for at most `frac` of the elements (at least one),
    each within `gap` (`test_torch_fsdp.py`'s, with the int8 bounds)."""
    d = np.abs(got.astype(np.float64) - want)
    out = d > tol["atol"] + tol["rtol"] * np.abs(want)
    assert out.sum() <= max(1, frac * got.size), \
        f"{label}: {out.sum()} of {got.size} apart, max {d.max()}"
    assert d.max() <= max(gap, tol["atol"]), label


@pytest.mark.parametrize("arch", [a for a, d in TRAIN_CASES if d == "int8"])
def test_a_placed_int8_state_saves_and_restores_bit_for_bit(tp, arch):
    """The placed state with int8 moments (their flat codes and scales
    placed over data) through `CheckpointManager.save` and
    `restore(shardings=)` onto the same mesh: every rank's blocks back
    bit for bit."""
    ranks, _ = tp
    assert all(r["train", arch]["restored"] for r in ranks)


@pytest.mark.parametrize("arch,dtype", TRAIN_CASES)
def test_train_blocks_equal_the_references_sharded_run(tp, arch, dtype):
    ranks, ref = tp
    want = ref[arch, "data2_model2", dtype]
    oracle = ranks[0]["train", arch, "oracle"]
    flips = ((INT8_FLIP_FRAC, INT8_FLIP_GAP) if dtype == "int8"
             else (FLIP_FRAC, FLIP_GAP))
    for r in ranks:
        got = r["train", arch]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=NORM_RTOL)
        shard = _serve_shardings(arch, want["params"])
        for path, full in _leaves(want["params"]):
            mine = tshd.block_index(full.shape, _get(shard, path),
                                    got["coord"])
            _close_but_flips(_get(got["params"], path), full[mine],
                             PARAM_TOL, f"params {path}", *flips)
    # the first moment, whole (int8: its decoded values), from the oracle
    # the ranks equal bit for bit
    tol = INT8_MOMENT_TOL if dtype == "int8" else MOMENT_TOL
    for path, full in _leaves(want["m"]):
        _close_but_flips(_get(oracle["m"], path), full, tol, f"m {path}",
                         *flips)


def test_no_leaf_is_gathered_along_model(tp):
    ranks, _ = tp
    for r in ranks:
        comm = r["comm", "minicpm_2b"]
        dims = list(comm["dims"].values())  # per leaf: (data, model) dims
        fsdp = sum(d[0] is not None for d in dims)
        replicated = sum(d[0] is None for d in dims)
        # the means of the loss, ce_loss and moe_aux; the norm's gathers
        # over the two mesh dims
        want = fsdp + replicated + 3 + 2
        assert comm["counts"]["c10d.allgather_"] == want
        assert comm["counts"]["c10d.alltoall_base_"] == fsdp
        # tiny MiniCPM (2 layers): forward reduces (embedding, 2 a layer,
        # 3 in the loss) and backward copies (2 a layer, the logits')
        assert comm["counts"]["c10d.allreduce_"] == (1 + 4 + 3) + (4 + 1)


@pytest.mark.parametrize("arch", ["grok1_314b", "grok1_314b@e3"])
def test_no_moe_leaf_is_gathered_along_model(tp, arch):
    """One placed step of tiny Grok-1 (2 layers) on (data 2, model 2):
    every all-gather is one the placement implies (a leaf's FSDP gather
    along data, the gradient sum of a leaf replicated over data, the
    means, the MoE's batch statistic, the norm) or the backward of the
    MoE's reduce-scatter: no leaf, the MoE's among them, is gathered
    along 'model'. With 4 experts `w_out` keeps its experts (an all-to-all
    of the activation a layer each way); with 3 its ff lies over 'data'
    and its rows are moved to the rank (one all-to-all) and its gradient
    back (a reduce-scatter over data, then one all-to-all)."""
    ranks, _ = tp
    L = sw.fsdp_config(tget, arch).n_layers
    for r in ranks:
        comm = r["comm", arch]
        dims = comm["dims"]
        fetched = [p for p in dims if p[-1] == "w_out" and
                   dims[p][1] is None]
        assert len(fetched) == (arch.endswith("@e3"))
        fsdp = sum(d[0] is not None for d in dims.values()) - len(fetched)
        replicated = sum(d[0] is None for d in dims.values())
        # FSDP gathers, replicated gradients' sums, the 3 metric means,
        # the top-1 shares' mean a layer, the norm's 2, and the two
        # reduce-scatters' backward all-gathers a layer
        assert comm["counts"]["c10d.allgather_"] == \
            fsdp + replicated + 3 + L + 2 + 2 * L
        # each FSDP leaf's gradient exchange; a layer's two reduce-scatters
        # and, where w_out keeps its experts, the activation's swap each
        # way; the fetched w_out's rows, its gradient's exchange and move
        moe = 2 * L + (0 if fetched else 2 * L)
        assert comm["counts"]["c10d.alltoall_base_"] == \
            fsdp + moe + 3 * len(fetched)
        # forward reduces (embedding, attention and MoE a layer, 3 in the
        # loss) and backward copies (attention, the MoE's input and gates
        # a layer, the logits')
        assert comm["counts"]["c10d.allreduce_"] == \
            (1 + 2 * L + 3) + (3 * L + 1)


# -- in this process ----------------------------------------------------------------

def _emulate(m, fn):
    return tshd.run_model_ranks(m, fn)


def test_regions_gradients_in_the_one_process_emulation():
    """copy: identity forward, the ranks' gradients summed backward;
    reduce: the ranks' values summed forward, each rank's gradient
    backward; gather: the blocks joined forward, each rank's block of the
    gradient backward."""
    torch.manual_seed(0)
    xs = [torch.randn(3, 4, requires_grad=True) for _ in range(2)]
    ws = [torch.randn(4, 2) for _ in range(2)]

    def fn(r):
        tp = tshd.model_group()
        y = tp.reduce(tp.copy(xs[r]) @ ws[r])
        g = tp.gather(xs[r][:, :2], -1)
        return y, g

    outs = _emulate(2, fn)
    want = xs[0].detach() @ ws[0] + xs[1].detach() @ ws[1]
    torch.testing.assert_close(outs[0][0], want, rtol=0, atol=0)
    torch.testing.assert_close(outs[1][0], want, rtol=0, atol=0)
    assert torch.equal(outs[0][1], torch.cat([xs[0][:, :2], xs[1][:, :2]],
                                             -1))
    gy = [torch.randn(3, 2) for _ in range(2)]
    gx = torch.autograd.grad([o[0] for o in outs], xs, gy)
    # copy's backward: sum over ranks of each rank's partial
    want_g = gy[0] @ ws[0].T + gy[1] @ ws[1].T
    torch.testing.assert_close(gx[0], want_g, rtol=0, atol=0)
    torch.testing.assert_close(gx[1], want_g, rtol=0, atol=0)


# each MoE layout's tensor dim (unstacked) of w_gate, w_in, w_out split over
# 'model': the rank's experts (moe_ep); the experts' ff; the default rules'
# d_model blocks of w_gate and w_in beside w_out's experts (a mesh whose
# model size divides the experts: the card's ('model',) of 2) or beside
# w_out's ff (the production meshes, where 8 experts do not divide 16 and
# w_out's ff lies over 'data': `fetch_block` moves its rows to the rank)
MOE_LAYOUTS = {"experts": (0, 0, 0), "ff": (2, 2, 1),
               "d_model_experts": (1, 1, 0), "d_model_ff": (1, 1, 1)}
# the split against the whole layer: f32 sums in another order
MOE_SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", list(MOE_LAYOUTS))
def test_moe_split_equals_the_whole_layer(layout):
    """`moe_apply` on each rank's blocks (MOE_LAYOUTS), emulated over 2
    model ranks (`run_model_ranks`: the reduce-scatter, the all-to-all
    and the reduce as joint autograd nodes), against the whole layer: the
    routing is the same, the output and the gradients of x and of every
    weight (the ranks' blocks joined) within MOE_SPLIT_TOL, the load
    balance loss equal."""
    gen = torch.Generator().manual_seed(1)
    params = tmlp.init_moe(gen, MOE_SPEC)
    x = torch.randn((2, 6, MOE_SPEC.d_model), generator=gen)
    names = ("router", "w_gate", "w_in", "w_out")
    leaves = [params[k].clone().requires_grad_(True) for k in names]
    xw = x.clone().requires_grad_(True)
    want, aux = tmlp.moe_apply(dict(zip(names, leaves)), xw, MOE_SPEC)
    gy = torch.randn(want.shape, generator=gen)
    want_g = torch.autograd.grad(want, [xw] + leaves, gy)
    dims = dict(zip(names[1:], MOE_LAYOUTS[layout]))

    def block(k, r):
        a = params[k]
        if k not in dims:
            return a.clone().requires_grad_(True)
        n = a.shape[dims[k]] // 2
        return a.narrow(dims[k], r * n, n).contiguous().requires_grad_(True)

    ranks = [[block(k, r) for k in names] for r in range(2)]
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    outs = _emulate(2, lambda r: tmlp.moe_apply(dict(zip(names, ranks[r])),
                                                xs[r], MOE_SPEC))
    for y, a in outs:
        torch.testing.assert_close(y, want.detach(), **MOE_SPLIT_TOL)
        assert torch.equal(a["moe_aux"], aux["moe_aux"].detach())
    got = torch.autograd.grad([o[0] for o in outs],
                              [xs[0]] + ranks[0] + ranks[1], [gy, gy])
    torch.testing.assert_close(got[0], want_g[0], **MOE_SPLIT_TOL)
    torch.testing.assert_close(got[1], want_g[1], **MOE_SPLIT_TOL)
    for j, k in enumerate(names[1:], start=2):
        joined = torch.cat([got[j], got[j + 4]], dims[k])
        torch.testing.assert_close(joined, want_g[j], **MOE_SPLIT_TOL,
                                   msg=f"{layout} {k}")


def test_tp_plan_keeps_what_the_layers_split():
    """The production meshes: attention, MLP, vocab, ssm and moe_ep blocks
    stay blocks; the MoE under the default rules (the dense patterns place
    its d_model and experts over 'model') keeps `w_gate`'s and `w_in`'s
    d_model blocks, and `w_out`, whose 8 experts do not divide over 16
    ranks (its ff lies over 'data'), takes its rank's ff block
    (`tp_cuts`), so no MoE leaf is gathered whole along 'model'; on a
    ('model',) mesh of 2 `w_out` keeps its experts. The wide-FSDP profile
    is gathered whole along 'model'."""
    mesh = tshd.SpecMesh(("data", "model"), (16, 16))
    names = mesh.axis_names

    def plan(arch, mesh=mesh, dp=(0,), cuts=False, **kw):
        ab = treg.abstract_params(tget(arch))
        shard = tshd.named_shardings(ab, mesh, **kw)
        fn = tshd.tp_cuts if cuts else tshd.tp_plan
        return fn(tshd._tree_map(lambda s: s.shard_dims, shard),
                  mesh.axis_names, dp,
                  shapes=tshd._tree_map(lambda a: tuple(a.shape), ab),
                  sizes=mesh.shape)

    qwen = plan("qwen2p5_14b")
    for key in ("wq", "wk", "wv", "wo"):
        assert qwen["blocks"]["attn"][key] == (1,)
    assert qwen["embed"] == (1,) and qwen["lm_head"] == (1,)
    assert qwen["blocks"]["mlp"]["w_out"] == (1,)
    assert qwen["blocks"]["ln1_w"] == ()
    grok = plan("grok1_314b")
    moe = grok["blocks"]["moe"]
    assert (moe["w_gate"], moe["w_in"], moe["w_out"]) == ((1,), (1,), ())
    cuts = plan("grok1_314b", cuts=True)["blocks"]["moe"]
    # [L, E, D, F] by d_model, [L, E, F, D] by the ff the placement lacks
    assert (cuts["w_gate"], cuts["w_out"]) == (((1, 2),), ((1, 2),))
    assert cuts["router"] == ()
    card = plan("grok1_314b", tshd.SpecMesh(("model",), (2,)), ())
    assert all(card["blocks"]["moe"][k] == (0,) for k in ("w_gate", "w_in",
                                                         "w_out"))
    assert grok["blocks"]["attn"]["wq"] == (1,)
    ep = plan("qwen3_moe_30b_a3b", moe_ep=True)
    assert all(ep["blocks"]["moe"][k] == (1,) for k in ("w_gate", "w_in",
                                                       "w_out"))
    rwkv = plan("rwkv6_7b")
    assert rwkv["blocks"]["rwkv_tm"]["w_r"] == (1,)
    assert rwkv["blocks"]["rwkv_tm"]["ln_x_w"] == ()
    wide = plan("minicpm_2b", fsdp=("data", "model"))
    assert all(k == () for k in tshd._leaves_of(wide))


def test_a_one_rank_model_group_changes_nothing():
    """Where a leaf holds its whole dim no region runs: the forward and
    gradients under a model group of one rank equal the plain run bit for
    bit (`tp_local` returns None before it reads the group)."""
    cfg = sw.fsdp_config(tget, "minicpm_2b")
    params = treg.build(cfg).init(torch.Generator().manual_seed(0))
    batch = sw.fsdp_batch(cfg, 0)
    loss_fn = treg.build(cfg, remat="none").loss_fn
    from repro_torch.train.step import _accumulate_grads
    base, _, g0 = _accumulate_grads(loss_fn, params, batch, 1)
    one = _emulate(1, lambda r: _accumulate_grads(loss_fn, params, batch,
                                                  1))[0]
    assert torch.equal(base, one[0])
    for a, b in zip(tshd._leaves_of(g0), tshd._leaves_of(one[2])):
        assert torch.equal(a, b)


class _HalfSplit:
    """A model group of 2 whose collectives return their input: rank 0's
    half of a split, enough to need the group (not a real reduction)."""
    rank, size = 0, 2

    def copy(self, x):
        return x

    reduce = allsum = copy

    def gather(self, x, dim):
        return torch.cat([x, x], dim)

    def max(self, x):
        return x.detach()

    def gather_list(self, x):
        return [x.detach(), x.detach()]


def test_a_checkpointed_recompute_runs_in_the_forwards_context():
    """A checkpointed layer recomputes in the backward, which on the card
    runs in the autograd engine's device thread, where this thread's
    context variables (the model group, the batch statistic) are unset:
    `forward_train` runs the recompute in a copy of the forward's context.
    Here rank 0's blocks of tiny MiniCPM run under a stand-in model group
    and the backward runs in another thread: its gradients equal this
    thread's bit for bit (without the copy the recompute finds no group
    and raises)."""
    import threading

    cfg = sw.fsdp_config(tget, "minicpm_2b")
    whole = treg.build(cfg).init(torch.Generator().manual_seed(0))
    mesh = tshd.SpecMesh(("model",), (2,))
    tdims = sw.tp_dims(tshd.named_shardings(whole, mesh), ("model",))
    from repro_torch.train.step import _tree
    paths = list(tdims)
    leaves = []
    for path in paths:
        a, d = whole, tdims[path]
        for k in path:
            a = a[k]
        leaves.append((a if d is None else a.narrow(d, 0, a.shape[d] // 2))
                      .detach().clone().requires_grad_(True))
    params = _tree(paths, leaves)
    batch = sw.fsdp_batch(cfg, 0)
    loss_fn = treg.build(cfg, remat="full").loss_fn

    def grads(other_thread: bool):
        with tshd.model_group_context(_HalfSplit()):
            loss, _ = loss_fn(params, batch)
        out = {}

        def backward():
            out["g"] = torch.autograd.grad(loss, leaves)
        if other_thread:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            backward()
        return out["g"]

    same, other = grads(False), grads(True)
    for a, b in zip(same, other):
        assert torch.equal(a, b)
