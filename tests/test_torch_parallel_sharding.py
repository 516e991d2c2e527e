"""`parallel/sharding.py`'s pure mappings against the reference's, with no
world: the spec trees of every config at full size (the port's built on
meta tensors by `registry.abstract_params`, the reference's on
`jax.eval_shape`), the decode caches' of every decode cell, the rules and
`resolve`, and the spec-to-placements mapping.

The reference's spec functions read only a mesh's `axis_names` and
`devices.shape` (`_axis_size`), so a duck-typed mesh gives them the
production meshes without forced devices; the port's take a `SpecMesh`.
Every comparison is exact: the specs are discrete.
"""

import time
import types

import jax
import numpy as np
import pytest

import sharded_worlds as sw
from repro.configs import base as jbase
from repro.launch.mesh import dp_axes as jdp_axes
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jshd
from repro_torch.configs import base as tbase
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as tshd
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2": (("data", "model"), (2, 2))}
# fsdp profiles: the default, and wide-FSDP (params over data x model, the
# 'model' TP assignment dropped)
PROFILES = {"fsdp_data": dict(fsdp="data"),
            "fsdp_wide": dict(fsdp=("data", "model"))}
# the reference's moe_ep profile (`launch/dryrun.py` SHARDING_PROFILES)
MOE_EP_ARCH = "qwen3_moe_30b_a3b"
# Grok-1's and Mistral-Large's full-size meta trees build in well under a
# second each
META_BUILD_S = 0.5


def _jmesh(name):
    axes, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=types.SimpleNamespace(shape=shape))


def _tmesh(name):
    axes, shape = MESHES[name]
    return tshd.SpecMesh(axes, shape)


def _jflat(tree) -> dict:
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", None)))
                for k in path]
        out[".".join(keys)] = tuple(spec)
    return out


def _tflat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, prefix + (str(k),)))
        return out
    return {".".join(prefix): tuple(tree)}


_ABSTRACT: dict = {}


def _trees(arch):
    """(reference abstract trees, port meta trees) for params, the f32
    AdamW state and the int8 AdamW state of `arch` at full size."""
    if arch not in _ABSTRACT:
        jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
        jp = jreg.abstract_params(jcfg)
        tp = treg.abstract_params(tcfg)
        trees = {"params": (jp, tp)}
        for dt in ("float32", "int8"):
            jo = jax.eval_shape(lambda p, dt=dt: jadamw.init_state(
                p, jadamw.AdamWConfig(state_dtype=dt)), jp)
            to = tadamw.init_state(tp, tadamw.AdamWConfig(state_dtype=dt))
            trees[f"opt_{dt}"] = (jo, to)
        _ABSTRACT[arch] = trees
    return _ABSTRACT[arch]


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_abstract_params_are_the_references_shapes(arch):
    jp, tp = _trees(arch)["params"]
    jshapes = {k: v for k, v in _jflat(jax.tree_util.tree_map(
        lambda a: jax.sharding.PartitionSpec(*a.shape), jp)).items()}
    tshapes = _tflat(treg.lm.tree_map(lambda a: tshd.P(*a.shape), tp))
    assert tshapes == jshapes
    jd = {k: str(v.dtype) for k, v in zip(
        _jflat(jax.tree_util.tree_map(lambda a: jax.sharding.PartitionSpec(),
                                      jp)), jax.tree_util.tree_leaves(jp))}
    td = {k: str(v.dtype).replace("torch.", "")
          for k, v in zip(_tflat(treg.lm.tree_map(lambda a: tshd.P(), tp)),
                          treg.lm.tree_leaves(tp))}
    assert td == jd
    assert all(a.device.type == "meta" for a in treg.lm.tree_leaves(tp))


@pytest.mark.parametrize("arch", ["grok1_314b", "mistral_large_123b"])
def test_full_size_meta_trees_build_fast(arch):
    t0 = time.perf_counter()
    tree = treg.abstract_params(tbase.get_config(arch))
    specs = tshd.param_pspecs(tree, _tmesh("2x16x16"))
    assert time.perf_counter() - t0 < META_BUILD_S
    n = sum(a.numel() for a in treg.lm.tree_leaves(tree))
    assert n > (300e9 if arch == "grok1_314b" else 120e9)
    assert _tflat(specs)


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_param_pspecs_equal_the_reference(arch, mesh, profile):
    kw = PROFILES[profile]
    for tree, (jt, tt) in _trees(arch).items():
        want = _jflat(jshd.param_pspecs(jt, _jmesh(mesh), **kw))
        got = _tflat(tshd.param_pspecs(tt, _tmesh(mesh), **kw))
        assert got == want, tree


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_ep_pspecs_equal_the_reference(mesh):
    for tree, (jt, tt) in _trees(MOE_EP_ARCH).items():
        want = _jflat(jshd.param_pspecs(jt, _jmesh(mesh), moe_ep=True))
        got = _tflat(tshd.param_pspecs(tt, _tmesh(mesh), moe_ep=True))
        assert got == want, tree
        if tree != "opt_int8":
            # the profile moves the experts' dim onto 'model'
            assert got[("m." if tree != "params" else "")
                       + "blocks.moe.w_gate"][:2] == (None, "model")


# the port keeps the hybrid family's Mamba state as a dict; the reference
# as the tuple ((conv_x, conv_B, conv_C), ssm)
_HYBRID_KEYS = {"mamba.conv_x": "mamba.0.0", "mamba.conv_B": "mamba.0.1",
                "mamba.conv_C": "mamba.0.2", "mamba.ssm": "mamba.1"}


def _decode_cells():
    return [(a, s) for a, s, _ in tbase.cells()
            if tbase.SHAPES[s].kind == "decode"]


def _batch_axes(mesh_name, shape):
    """The reference's batch-axis choice for a decode cell: the DP axes
    when the global batch divides them, else None."""
    axes, sizes = MESHES[mesh_name]
    dp = jdp_axes(types.SimpleNamespace(axis_names=axes))
    size = int(np.prod([dict(zip(axes, sizes))[a] for a in dp]))
    return dp if shape.global_batch % size == 0 else None


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,sname", _decode_cells())
def test_cache_pspecs_equal_the_reference(arch, sname, mesh):
    shape = tbase.SHAPES[sname]
    ba = _batch_axes(mesh, shape)
    jc = jreg.abstract_decode_cache(jbase.get_config(arch),
                                    jbase.SHAPES[sname])
    tc = treg.abstract_decode_cache(tbase.get_config(arch), shape)
    want = _jflat(jshd.cache_pspecs(jc, _jmesh(mesh), batch_axes=ba))
    got = {_HYBRID_KEYS.get(k, k): v for k, v in _tflat(
        tshd.cache_pspecs(tc, _tmesh(mesh), batch_axes=ba)).items()}
    assert got == want
    jshape = _jflat(jax.tree_util.tree_map(
        lambda a: jax.sharding.PartitionSpec(*a.shape), jc))
    tshape = {_HYBRID_KEYS.get(k, k): v for k, v in _tflat(
        treg.lm.tree_map(lambda a: tshd.P(*a.shape), tc)).items()}
    assert tshape == jshape


def test_cells_walk_the_references_sequence():
    assert list(tbase.cells()) == list(jbase.cells())
    assert list(tbase.cells(True)) == list(jbase.cells(True))
    assert tbase.SHAPES == {k: tbase.ShapeConfig(*(getattr(v, f) for f in (
        "name", "seq_len", "global_batch", "kind")))
        for k, v in jbase.SHAPES.items()}
    assert tbase.LONG_CONTEXT_ARCHS == jbase.LONG_CONTEXT_ARCHS
    assert sorted(tbase.ARCH_IDS) == sorted(jbase.ARCH_IDS)
    assert tbase.CELL_ORDER == jbase.ARCH_IDS


@pytest.mark.parametrize("arch,sname", [(a, s) for a, s, _ in tbase.cells()])
def test_input_specs_equal_the_reference(arch, sname):
    j = jreg.input_specs(jbase.get_config(arch), jbase.SHAPES[sname])
    t = treg.input_specs(tbase.get_config(arch), tbase.SHAPES[sname])
    jf = {k: (tuple(v.shape), str(v.dtype)) for k, v in zip(
        _jflat(jax.tree_util.tree_map(lambda a: jax.sharding.PartitionSpec(),
                                      j)), jax.tree_util.tree_leaves(j))}
    tf = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
          for k, v in zip(_tflat(treg.lm.tree_map(lambda a: tshd.P(), t)),
                          treg.lm.tree_leaves(t))}
    assert tf == jf


def test_rules_and_resolve_equal_the_reference():
    assert tshd.DEFAULT_RULES == jshd.DEFAULT_RULES
    for name in MESHES:
        for over in (None, {"experts": "model", "ff": None},
                     sw.NO_TP):
            assert tshd.rules_for_mesh(_tmesh(name), over) == \
                jshd.rules_for_mesh(_jmesh(name), over)
    logical = [("batch", "seq", "embed"), ("batch", "seq", "vocab"),
               ("batch", "experts", None, "ff"), ()]
    for lg in logical:
        assert tuple(tshd.resolve(*lg)) == tuple(jshd.resolve(*lg)) == ()
    for name in MESHES:
        for over in (None, sw.NO_TP):
            with tshd.mesh_context(_tmesh(name), over), \
                    jshd.mesh_context(_jmesh(name), over):
                assert tshd.active_mesh() == _tmesh(name)
                for lg in logical:
                    assert tuple(tshd.resolve(*lg)) == \
                        tuple(jshd.resolve(*lg))
        assert tshd.active_mesh() is None


def test_spec_for_path_equals_the_reference():
    cases = [("blocks.attn.wq", (64, 4, 16)), ("embed", (128, 64)),
             ("blocks.moe.w_gate", (8, 64, 32)), ("m.blocks.attn.wo.q",
                                                  (40, 256)),
             ("shared.ln1_w", (64,)), ("unknown", (3, 4)),
             ("blocks.rwkv_tm.mix_w2", (5, 32, 64)), ("step", ())]
    for path, shape in cases:
        for ep in (False, True):
            assert tuple(tshd.spec_for_path(path, shape, moe_ep=ep)) == \
                tuple(jshd.spec_for_path(path, shape, moe_ep=ep))


def test_spec_is_a_plain_tuple_equal_to_partition_spec():
    P = jax.sharding.PartitionSpec
    for axes in [(), (None,), ("data", None), (("pod", "data"), "model"),
                 (None, ("data", "model"), None), (("data",), None),
                 ((), "model"), (["pod", "data"],)]:
        assert tuple(tshd.P(*axes)) == tuple(P(*axes))
        assert isinstance(tshd.P(*axes), tuple)


def _placements(spec, mesh="2x2"):
    sh = tshd.NamedSharding(_tmesh(mesh), tshd.P(*spec))
    return [type(p).__name__ + (f"({p.dim})" if hasattr(p, "dim") else "")
            for p in sh.placements]


def test_placements_of_specs():
    assert _placements(("data", "model", None)) == ["Shard(0)", "Shard(1)"]
    assert _placements(("model", None, "data")) == ["Shard(2)", "Shard(0)"]
    assert _placements((None, None)) == ["Replicate", "Replicate"]
    assert _placements((None, "model")) == ["Replicate", "Shard(1)"]
    # a tuple of axes on one dim shards that dim over each of them,
    # nested in mesh order (pod outermost)
    assert _placements((("data", "model"), None)) == ["Shard(0)",
                                                      "Shard(0)"]
    assert _placements((("pod", "data"), "model"), "2x16x16") == [
        "Shard(0)", "Shard(0)", "Shard(1)"]
    assert _placements((None, ("pod", "data")), "2x16x16") == [
        "Shard(1)", "Shard(1)", "Replicate"]


@pytest.mark.parametrize("spec", [(("model", "data"), None),
                                  (None, ("data", "pod"))])
def test_axes_against_the_mesh_order_raise(spec):
    mesh = "2x16x16" if "pod" in str(spec) else "2x2"
    with pytest.raises(ValueError, match="against"):
        tshd.NamedSharding(_tmesh(mesh), tshd.P(*spec))


def test_an_axis_absent_from_the_mesh_raises_and_is_dropped_by_the_rules():
    with pytest.raises(ValueError, match="not in the mesh"):
        tshd.NamedSharding(tshd.SpecMesh(("data",), (4,)),
                           tshd.P("data", "model"))
    with pytest.raises(ValueError, match="twice"):
        tshd.NamedSharding(_tmesh("2x2"), tshd.P("data", "data"))
    # param_pspecs drops an axis the mesh lacks, as the reference does
    tree = {"blocks": {"attn": {"wq": np.zeros((3, 8, 4, 2))}}}
    mesh = tshd.SpecMesh(("data",), (4,))
    got = tshd.param_pspecs(tree, mesh)["blocks"]["attn"]["wq"]
    assert tuple(got) == (None, "data", None, None)


def test_a_non_dividing_dim_is_left_replicated_and_refused_by_place():
    mesh = _tmesh("2x2")
    tree = {"embed": np.zeros((6, 3))}     # 3 % 2 != 0 on the fsdp dim
    assert tuple(tshd.param_pspecs(tree, mesh)["embed"]) == ("model", None)
    sh = tshd.NamedSharding(mesh, tshd.P("model", "data"))
    with pytest.raises(ValueError, match="does not divide"):
        tshd.block_index((6, 3), sh, (0, 0))


def test_block_index_nests_in_mesh_order_and_distinct_coords():
    mesh = tshd.SpecMesh(("pod", "data", "model"), (2, 2, 2))
    sh = tshd.NamedSharding(mesh, tshd.P(("pod", "data"), "model"))
    a = np.arange(8 * 4).reshape(8, 4)
    blocks = {}
    for coord in np.ndindex(2, 2, 2):
        blocks[coord] = a[tshd.block_index(a.shape, sh, coord)]
    # pod is the major part of dim 0, data the minor, as JAX lays it out
    assert np.array_equal(blocks[(1, 0, 0)], a[4:6, 0:2])
    assert np.array_equal(blocks[(0, 1, 1)], a[2:4, 2:4])
    rep = tshd.NamedSharding(mesh, tshd.P(None, "model"))
    assert tshd.distinct_coords(rep) == [(0, 0, 0), (0, 0, 1)]
    assert len(tshd.distinct_coords(sh)) == 8


def test_constrain_is_the_identity_without_a_mesh_and_on_plain_tensors():
    import torch
    x = torch.ones(4, 3, 2)
    assert tshd.constrain(x, "batch", "seq", "embed") is x
    assert tshd.active_mesh() is None
    with tshd.mesh_context(_tmesh("2x2")):
        assert tshd.constrain(x, "batch", "seq", "vocab") is x
    with tshd.mesh_context(tshd.SpecMesh(("data",), (4,))):
        # the default rules name 'model', which this mesh lacks
        with pytest.raises(ValueError, match="not in the mesh"):
            tshd.constrain(x, "batch", "seq", "vocab")
    with tshd.mesh_context(tshd.SpecMesh(("data",), (4,)),
                           sw.NO_TP):
        assert tshd.constrain(x, "batch", "seq", "vocab") is x
