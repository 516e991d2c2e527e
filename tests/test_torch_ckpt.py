"""The port's checkpoints (`repro_torch.checkpoint`) against the
reference's (`repro.checkpoint.ckpt`): the manifest codec byte for byte
against `msgpack`, a checkpoint of a tiny MiniCPM fleet state written by
either package restored by the other bit for bit (bf16 params, f32 and
int8 moments, the 4-chip plane, the ef tree with a broadcast-view leaf and
an owned one, a wrapped SorState, the FleetSpec), the reference's own
checkpoint tests run on the port, the in-place restore, the snapshot's
isolation from in-place updates, and `remap_plane` / `remap_sor` against
the reference's.

Every comparison here is exact (bit for bit): a checkpoint moves bytes."""

import dataclasses
import os
import struct

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget
from repro.core import sor as jsor
from repro.core.hwspec import V5E as JV5E
from repro.core.hwspec import FleetSpec as JFleetSpec
from repro.core.power_plane import PowerPlaneState as JPlane
from repro.core.telemetry import ALL_RAIL_OBSERVABLES as JRAILS
from repro.core.telemetry import FrameHistory as JHistory
from repro.models import registry as jreg
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import get_config as tget
from repro_torch.core import ecollectives as tec
from repro_torch.core import sor as tsor
from repro_torch.core.hwspec import V5E as TV5E
from repro_torch.core.hwspec import FleetSpec as TFleetSpec
from repro_torch.core.power_plane import PowerPlaneState as TPlane
from repro_torch.core.telemetry import ALL_RAIL_OBSERVABLES as TRAILS
from repro_torch.core.telemetry import FrameHistory as THistory
from repro_torch.models import registry as treg
from repro_torch.optim import adamw as tadamw

N_CHIPS = 4
CAPACITY = 4
PUSHES = 6           # more samples than the ring holds: it has wrapped


# -- the manifest codec -------------------------------------------------------------

_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300))
_keys = st.text(max_size=40)
_manifests = st.recursive(
    _scalars, lambda inner: (st.lists(inner, max_size=20)
                             | st.dictionaries(_keys, inner, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_manifests)
def test_msgpack_codec_matches_msgpack(obj):
    data = msgpack.packb(obj)
    assert _msgpack.packb(obj) == data
    assert _msgpack.unpackb(data) == msgpack.unpackb(data)


# each length and integer form at its edges
EDGES = ([0, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
          (1 << 64) - 1, -1, -32, -33, -128, -129, -32768, -32769,
          -(1 << 31), -(1 << 31) - 1, -(1 << 63)]
         + ["a" * n for n in (0, 31, 32, 255, 256, 65535, 65536)]
         + [list(range(n)) for n in (15, 16, 65535, 65536)]
         + [{str(i): i for i in range(n)} for n in (15, 16, 65536)]
         + [0.1, -0.0, float("inf"), 1e300, True, False, None, "é∂",
            (1, "two", 3.0)])


@pytest.mark.parametrize("obj", EDGES, ids=range(len(EDGES)))
def test_msgpack_codec_length_and_int_forms(obj):
    data = msgpack.packb(obj)
    assert _msgpack.packb(obj) == data
    assert _msgpack.unpackb(data) == msgpack.unpackb(data)


def test_msgpack_codec_reads_what_it_does_not_write():
    """float32, bin and the 16-bit array form, as another writer may use
    them; and refuses extension types and truncated data."""
    data = msgpack.packb({"f": 1.5, "b": b"\x00\x01"}, use_single_float=True)
    assert _msgpack.unpackb(data) == {"f": 1.5, "b": b"\x00\x01"}
    assert _msgpack.unpackb(b"\xdc\x00\x01\x07") == [7]
    with pytest.raises(ValueError, match="type byte"):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(msgpack.packb("abc")[:-1])
    with pytest.raises(TypeError, match="serialize"):
        _msgpack.packb({"x": np.float32(1.0)})


# -- a tiny MiniCPM fleet state in both packages ---------------------------------

def _np_states(state_dtype: str):
    """(reference state, port state, FleetSpecs) holding the same numbers:
    the tiny MiniCPM's bf16 parameters, AdamW moments (f32 or int8) and a
    step, a 4-chip plane off its nominal point, the ef tree zero but for
    one leaf, and a SorState whose 4-slot ring has taken 6 pushes."""
    rng = np.random.default_rng(0)
    jcfg, tcfg = jget("minicpm_2b", tiny=True), tget("minicpm_2b", tiny=True)
    jparams = jreg.build(jcfg).init(jax.random.PRNGKey(1))
    tparams = treg.params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    paths = tadamw.leaf_paths(tparams)

    def tree(make):
        out = {}
        for p in paths:
            node = out
            for k in p[:-1]:
                node = node.setdefault(k, {})
            node[p[-1]] = make(p)
        return out

    def moment(p):
        n = tadamw.get_path(tparams, p).numel()
        if state_dtype == "float32":
            return rng.standard_normal(
                tuple(tadamw.get_path(tparams, p).shape)).astype(np.float32)
        blocks = -(-n // tadamw.Q_BLOCK)
        return {"q": rng.integers(-127, 128, (blocks, tadamw.Q_BLOCK),
                                  dtype=np.int8),
                "scale": rng.uniform(0.1, 2.0, (blocks, 1)).astype(
                    np.float32)}

    m, v = tree(moment), tree(moment)
    owned = paths[1]          # the ef leaf the sync has written
    ef_vals = rng.standard_normal(
        tuple(tadamw.get_path(tparams, owned).shape)).astype(np.float32)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    plane = dict(v_core=0.9 + 0.01 * f32(N_CHIPS),
                 v_hbm=1.1 + 0.01 * f32(N_CHIPS),
                 v_io=0.95 + 0.01 * f32(N_CHIPS),
                 comp_level=rng.integers(0, 3, N_CHIPS).astype(np.int32),
                 energy_j=np.abs(f32(N_CHIPS)) * 100,
                 step=np.full(N_CHIPS, 7, np.int32))
    n_rails = len(TRAILS)
    hist = dict(v=f32(CAPACITY, n_rails, N_CHIPS),
                obs=f32(CAPACITY, n_rails, N_CHIPS),
                age_s=np.abs(f32(CAPACITY, N_CHIPS)),
                polled=(rng.random((CAPACITY, N_CHIPS)) < 0.5).astype(
                    np.float32),
                valid=rng.random((CAPACITY, n_rails, N_CHIPS)) < 0.8)
    est = {f: f32(n_rails, N_CHIPS) for f in tsor._FIELDS}
    cursor, tick = PUSHES % CAPACITY, PUSHES

    j = jax.tree_util.tree_map
    jstate = {
        "params": jparams,
        "opt": {"step": jnp.int32(5), "m": j(jnp.asarray, m),
                "v": j(jnp.asarray, v)},
        "plane": JPlane(**{k: jnp.asarray(a) for k, a in plane.items()}),
        "ef": jax.tree_util.tree_map_with_path(
            lambda kp, p: (jnp.asarray(ef_vals) if tuple(
                k.key for k in kp) == owned else jnp.zeros(p.shape,
                                                            jnp.float32)),
            jparams),
        "sor": jsor.SorState(
            history=JHistory(**{k: jnp.asarray(a) for k, a in hist.items()},
                             cursor=jnp.int32(cursor),
                             count=jnp.int32(PUSHES), capacity=CAPACITY,
                             rails=JRAILS),
            estimate=jsor.SorEstimate(**{k: jnp.asarray(a)
                                         for k, a in est.items()}),
            tick=jnp.int32(tick))}
    t = lambda a: torch.from_numpy(np.array(a))
    ef = tec.zeros_like_residuals(tparams)
    tadamw.get_path(ef, owned[:-1])[owned[-1]] = t(ef_vals)
    tstate = {
        "params": tparams,
        "opt": {"step": torch.tensor(5, dtype=torch.int32),
                "m": tree(lambda p: j(t, tadamw.get_path(m, p))),
                "v": tree(lambda p: j(t, tadamw.get_path(v, p)))},
        "plane": TPlane(**{k: t(a) for k, a in plane.items()}),
        "ef": ef,
        "sor": tsor.SorState(
            history=THistory(**{k: t(a) for k, a in hist.items()},
                             cursor=cursor, count=PUSHES, capacity=CAPACITY,
                             rails=TRAILS),
            estimate=tsor.SorEstimate(**{k: t(a) for k, a in est.items()}),
            tick=tick)}
    return jstate, tstate, (JFleetSpec.sample(N_CHIPS, seed=5),
                            TFleetSpec.sample(N_CHIPS, seed=5)), owned


def _fresh_port(tstate):
    """A port template of the same structure: zeros, the ef tree all
    broadcast views, an empty ring."""
    zero = lambda a: torch.zeros_like(a)
    params = tadamw._map(zero, tstate["params"])
    scfg = tsor.SorConfig(capacity=CAPACITY, rails=TRAILS, ingest="frames")
    return {"params": params,
            "opt": {"step": torch.tensor(0, dtype=torch.int32),
                    "m": tadamw._map(zero, tstate["opt"]["m"]),
                    "v": tadamw._map(zero, tstate["opt"]["v"])},
            "plane": TPlane.from_fleet(TFleetSpec.sample(N_CHIPS, seed=9),
                                       "cpu"),
            "ef": tec.zeros_like_residuals(params),
            "sor": tsor.init_state(scfg, N_CHIPS, device="cpu")}


def _fresh_reference(jstate):
    scfg = jsor.SorConfig(capacity=CAPACITY, rails=JRAILS, ingest="frames")
    z = lambda a: jnp.zeros_like(a)
    return {"params": jax.tree_util.tree_map(z, jstate["params"]),
            "opt": jax.tree_util.tree_map(z, jstate["opt"]),
            "plane": JPlane.from_fleet(JFleetSpec.sample(N_CHIPS, seed=9)),
            "ef": jax.tree_util.tree_map(z, jstate["ef"]),
            "sor": jsor.init_state(scfg, N_CHIPS)}


def _bits(x) -> np.ndarray:
    """A leaf's bytes as unsigned integers (bf16 and -0.0 included)."""
    if isinstance(x, int):
        return np.asarray(x, np.int32).view(np.uint32)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        a = x.numpy().copy()
    else:
        a = np.array(x)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype != bool else a


def _port_leaves(state):
    out = {}
    tckpt._map_with_path(lambda p, x: out.__setitem__(tckpt._path_key(p), x)
                         , state)
    return out


def _reference_leaves(state):
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda kp, x: out.__setitem__(
            "/".join(jckpt._path_key(k) for k in kp), x), state)
    return out


def _same_bits(a: dict, b: dict, what: str):
    assert list(a) == list(b), what
    for k in a:
        x, y = _bits(a[k]), _bits(b[k])
        assert x.shape == y.shape and np.array_equal(x, y), f"{what}: {k}"


def _manifest_bytes(path):
    """The manifest's bytes with the write time's float64 zeroed."""
    data = bytearray(open(os.path.join(path, "manifest.msgpack"),
                          "rb").read())
    at = data.index(b"\xa4time\xcb") + 6
    data[at:at + 8] = struct.pack(">d", 0.0)
    return bytes(data)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_both_packages_write_the_same_checkpoint(tmp_path, state_dtype):
    """The same state saved by each package: the same npz entries in the
    same order with the same bytes, and manifests byte-equal but for the
    write time."""
    jstate, tstate, (jfs, tfs), _ = _np_states(state_dtype)
    pj = jckpt.CheckpointManager(str(tmp_path / "j")).save(3, jstate, jfs)
    pt = tckpt.CheckpointManager(str(tmp_path / "t")).save(3, tstate, tfs)
    assert _manifest_bytes(pt) == _manifest_bytes(pj)
    with np.load(os.path.join(pj, "arrays.npz")) as zj, \
            np.load(os.path.join(pt, "arrays.npz")) as zt:
        assert zt.files == zj.files
        for k in zj.files:
            a, b = zj[k], zt[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(_bits(a), _bits(b)), k
    assert sorted(os.listdir(pt)) == sorted(os.listdir(pj))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_port_restores_a_reference_checkpoint(tmp_path, state_dtype):
    jstate, tstate, (jfs, tfs), owned = _np_states(state_dtype)
    jckpt.CheckpointManager(str(tmp_path)).save(3, jstate, jfs)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    template = _fresh_port(tstate)
    step, out = mgr.restore(template)
    assert step == 3
    _same_bits(_port_leaves(out), _port_leaves(tstate), "restored")
    sor = out["sor"]
    assert (sor.history.cursor, sor.history.count, sor.tick) == \
        (PUSHES % CAPACITY, PUSHES, PUSHES)
    assert all(isinstance(x, int) for x in (sor.history.cursor,
                                            sor.history.count, sor.tick))
    assert sor.history.rails == TRAILS and sor.history.capacity == CAPACITY
    # written into the template's tensors, none made anew
    for k, x in _port_leaves(template["params"]).items():
        assert _port_leaves(out["params"])[k] is x
    # the zero ef leaves stay broadcast views; the written one owns memory
    for path in tadamw.leaf_paths(out["ef"]):
        leaf = tadamw.get_path(out["ef"], path)
        assert tckpt._is_broadcast(leaf) == (path != owned), path
    fs = mgr.restore_fleet()
    assert fs.seed == tfs.seed and fs.base == tfs.base == TV5E
    for f in tckpt._FLEET_FIELDS:
        np.testing.assert_array_equal(getattr(fs, f), getattr(tfs, f))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_reference_restores_a_port_checkpoint(tmp_path, state_dtype):
    jstate, tstate, (jfs, tfs), _ = _np_states(state_dtype)
    tckpt.CheckpointManager(str(tmp_path)).save(3, tstate, tfs)
    mgr = jckpt.CheckpointManager(str(tmp_path))
    step, out = mgr.restore(_fresh_reference(jstate))
    assert step == 3
    _same_bits(_reference_leaves(out), _reference_leaves(jstate),
               "restored")
    assert out["sor"].history.rails == JRAILS
    fs = mgr.restore_fleet()
    assert fs.seed == jfs.seed and fs.base == jfs.base == JV5E
    for f in jckpt._FLEET_FIELDS:
        np.testing.assert_array_equal(getattr(fs, f), getattr(jfs, f))


# -- the reference's checkpoint tests, on the port --------------------------------

def test_checkpoint_manager_atomicity(tmp_path):
    cm = tckpt.CheckpointManager(str(tmp_path), async_save=False)
    cm.save(3, {"params": {"w": torch.ones(4)}})
    # a partial dir without .complete must be invisible
    os.makedirs(tmp_path / "step_00000009")
    assert cm.list_steps() == [3]
    step, out = cm.restore({"params": {"w": torch.zeros(4)}})
    assert step == 3 and bool((out["params"]["w"] == 1).all())


def test_checkpoint_bf16_roundtrip(tmp_path):
    cm = tckpt.CheckpointManager(str(tmp_path), async_save=False)
    x = torch.tensor([1.5, -2.25, 0.001, -0.0], dtype=torch.bfloat16)
    cm.save(1, {"params": {"w": x}})
    _, out = cm.restore({"params": {"w": torch.zeros(4,
                                                     dtype=torch.bfloat16)}})
    assert out["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["w"].view(torch.int16),
                       x.view(torch.int16))


def test_checkpoint_keeps_the_newest_and_lists_steps(tmp_path):
    cm = tckpt.CheckpointManager(str(tmp_path), keep=2)
    assert cm.latest_step() is None and cm.restore_fleet() is None
    with pytest.raises(FileNotFoundError):
        cm.restore({"params": {}})
    for s in (1, 5, 3, 8):
        cm.save(s, {"params": {"w": torch.full((2,), float(s))}})
    assert cm.list_steps() == [5, 8] and cm.latest_step() == 8
    assert sorted(os.listdir(tmp_path)) == ["step_00000005",
                                            "step_00000008"]
    step, out = cm.restore({"params": {"w": torch.zeros(2)}}, step=5)
    assert step == 5 and out["params"]["w"].tolist() == [5.0, 5.0]


def test_restore_skips_groups_missing_from_checkpoint(tmp_path):
    cfg = tsor.SorConfig(rails=TRAILS, ingest="frames")
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=False)
    fs = TFleetSpec.sample(2, seed=0)
    mgr.save(1, {"plane": TPlane.from_fleet(fs, "cpu")})
    template = {"plane": TPlane.from_fleet(fs, "cpu"),
                "sor": tsor.init_state(cfg, 2, device="cpu")}
    step, restored = mgr.restore(template, optional=("sor",))
    assert step == 1 and "sor" not in restored and "plane" in restored
    with pytest.raises(KeyError, match="sor"):
        mgr.restore(template)   # not marked optional -> loud


def test_restore_rejects_mismatched_rail_layout(tmp_path):
    cfg3 = tsor.SorConfig(refresh_every=1, rails=TRAILS, ingest="frames")
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"sor": tsor.init_state(cfg3, 2, device="cpu")})
    with pytest.raises(ValueError, match="rails"):
        mgr.restore({"sor": tsor.init_state(tsor.SorConfig(), 2,
                                            device="cpu")})
    respec = tuple(dataclasses.replace(s, error_bound=1e-6) for s in TRAILS)
    with pytest.raises(ValueError, match="rails"):
        mgr.restore({"sor": tsor.init_state(
            dataclasses.replace(cfg3, rails=respec), 2, device="cpu")})
    with pytest.raises(ValueError, match="capacity"):
        mgr.restore({"sor": tsor.init_state(
            dataclasses.replace(cfg3, capacity=16), 2, device="cpu")})
    step, restored = mgr.restore({"sor": tsor.init_state(cfg3, 2,
                                                         device="cpu")})
    assert step == 1 and restored["sor"].history.rails == TRAILS


def test_checkpoint_fleet_preserves_custom_chip_spec(tmp_path):
    custom = dataclasses.replace(TV5E, name="tpu-custom", p_hbm_w=45.0,
                                 nominal_v_io=0.93)
    fs = TFleetSpec.sample(3, seed=4, spec=custom)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(2, {"plane": TPlane.from_fleet(fs, "cpu")}, fleet=fs)
    restored = mgr.restore_fleet()
    assert restored.base == custom and restored.base.p_hbm_w == 45.0
    # and the reference reads the same
    assert jckpt.CheckpointManager(str(tmp_path)).restore_fleet().base == \
        dataclasses.replace(JV5E, name="tpu-custom", p_hbm_w=45.0,
                            nominal_v_io=0.93)


def test_restore_onto_a_mesh_waits_for_sharding(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": {"w": torch.ones(2)}})
    with pytest.raises(NotImplementedError, match="Sharding"):
        mgr.restore({"params": {"w": torch.zeros(2)}},
                    shardings={"params": object()})


# -- the in-place restore and the snapshot --------------------------------------------

def test_async_snapshot_is_isolated_from_in_place_updates(tmp_path):
    """`save` returns with every leaf on the host: the state overwritten in
    place right after it (as the next train step does) does not reach the
    checkpoint."""
    _, tstate, (_, tfs), owned = _np_states("float32")
    before = {k: _bits(x).copy() for k, x in _port_leaves(tstate).items()}
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(4, tstate, fleet=tfs)
    with torch.no_grad():
        for path in tadamw.leaf_paths(tstate["params"]):
            tadamw.get_path(tstate["params"], path).add_(1.0)
            tadamw.get_path(tstate["opt"]["m"], path).mul_(-3.0)
        tadamw.get_path(tstate["ef"], owned).fill_(7.0)
        tstate["plane"].v_io.fill_(0.5)
        tstate["sor"].history.v.zero_()
    mgr.wait()
    step, out = mgr.restore(_fresh_port(tstate))
    assert step == 4
    after = {k: _bits(x) for k, x in _port_leaves(out).items()}
    assert list(after) == list(before)
    for k in before:
        assert np.array_equal(after[k], before[k]), k


def test_async_writer_failure_is_raised_by_wait(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=True)
    (tmp_path / "step_00000002").write_text("not a directory")
    mgr.save(2, {"params": {"w": torch.ones(2)}})
    with pytest.raises(FileExistsError):
        mgr.wait()
    mgr.wait()                       # raised once
    assert mgr.list_steps() == []


@pytest.mark.parametrize("live", ["view", "owned"])
@pytest.mark.parametrize("saved", ["zeros", "values"])
def test_ef_leaves_restore_as_views_or_into_memory(tmp_path, live, saved):
    """An all-zero leaf restored into a broadcast view stays the view (no
    memory); saved values give a view memory of its own; an owned leaf is
    written in place. The saved file holds the full leaf either way."""
    shape = (3, 5)
    src = (tec.zeros_like_residuals({"w": torch.empty(shape)})["w"]
           if saved == "zeros" else torch.arange(15.0).reshape(shape))
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"ef": {"w": src}})
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        np.testing.assert_array_equal(z["ef::w"], src.numpy())
    target = (tec.zeros_like_residuals({"w": torch.empty(shape)})["w"]
              if live == "view" else torch.full(shape, 9.0))
    _, out = mgr.restore({"ef": {"w": target}})
    got = out["ef"]["w"]
    assert torch.equal(got, src)
    assert tckpt._is_broadcast(got) == (live == "view" and saved == "zeros")
    if live == "owned":
        assert got is target
    tec.own_residuals(out["ef"])     # the ef sync accepts either form
    assert out["ef"]["w"].is_contiguous()


def test_negative_zero_ef_leaf_is_not_restored_as_a_view(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"ef": {"w": torch.full((4,), -0.0)}})
    view = tec.zeros_like_residuals({"w": torch.empty(4)})["w"]
    _, out = mgr.restore({"ef": {"w": view}})
    assert not tckpt._is_broadcast(out["ef"]["w"])
    assert torch.equal(out["ef"]["w"].view(torch.int32),
                       torch.full((4,), -0.0).view(torch.int32))


def test_restore_into_a_fleet_plane_leaves_the_fleet_spec_alone(tmp_path):
    fs = TFleetSpec.sample(4, seed=2)
    nominal = fs.v_io_nominal.copy()
    plane = dataclasses.replace(TPlane.from_fleet(fs, "cpu"),
                                v_io=torch.full((4,), 0.7))
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"plane": plane})
    live = TPlane.from_fleet(fs, "cpu")
    _, out = mgr.restore({"plane": live})
    assert out["plane"].v_io is live.v_io
    assert torch.equal(out["plane"].v_io, torch.full((4,), 0.7))
    np.testing.assert_array_equal(fs.v_io_nominal, nominal)


# -- remaps against the reference's -------------------------------------------------

@pytest.mark.parametrize("n_new", [2, 4, 6])
@pytest.mark.parametrize("scalar", [False, True])
def test_remap_plane_matches_reference(n_new, scalar):
    rng = np.random.default_rng(n_new)
    n = () if scalar else (4,)
    vals = dict(v_core=rng.uniform(0.8, 0.9, n).astype(np.float32),
                v_hbm=rng.uniform(1.0, 1.1, n).astype(np.float32),
                v_io=rng.uniform(0.8, 0.95, n).astype(np.float32),
                comp_level=rng.integers(0, 3, n).astype(np.int32),
                energy_j=rng.uniform(0, 9, n).astype(np.float32),
                step=rng.integers(3, 9, n).astype(np.int32))
    jp = JPlane(**{k: jnp.asarray(v) for k, v in vals.items()})
    tp = TPlane(**{k: torch.from_numpy(v.copy()) for k, v in vals.items()})
    jout = jckpt.remap_plane(jp, JFleetSpec.sample(n_new, seed=33))
    tout = tckpt.remap_plane(tp, TFleetSpec.sample(n_new, seed=33))
    if n_new == 4 and not scalar:
        assert tout is tp
    for f in vals:
        np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                      np.asarray(getattr(jout, f)), f)


def _learned_sor(pkg, n_chips):
    rng = np.random.default_rng(n_chips)
    n_rails = len(TRAILS)
    hist = dict(v=rng.uniform(0.8, 0.95, (CAPACITY, n_rails, n_chips)),
                obs=rng.uniform(-4, -2, (CAPACITY, n_rails, n_chips)),
                age_s=rng.uniform(0, 1, (CAPACITY, n_chips)),
                polled=np.ones((CAPACITY, n_chips)))
    hist = {k: v.astype(np.float32) for k, v in hist.items()}
    hist["valid"] = rng.random((CAPACITY, n_rails, n_chips)) < 0.9
    est = {f: rng.uniform(0.1, 1.0, (n_rails, n_chips)).astype(np.float32)
           for f in tsor._FIELDS}
    if pkg == "jax":
        return jsor.SorState(
            JHistory(**{k: jnp.asarray(v) for k, v in hist.items()},
                     cursor=jnp.int32(1), count=jnp.int32(5),
                     capacity=CAPACITY, rails=JRAILS),
            jsor.SorEstimate(**{k: jnp.asarray(v) for k, v in est.items()}),
            jnp.int32(5))
    t = lambda a: torch.from_numpy(a.copy())
    return tsor.SorState(
        THistory(**{k: t(v) for k, v in hist.items()}, cursor=1, count=5,
                 capacity=CAPACITY, rails=TRAILS),
        tsor.SorEstimate(**{k: t(v) for k, v in est.items()}), 5)


@pytest.mark.parametrize("n_new", [2, 6])
def test_remap_sor_matches_reference(n_new):
    jout = jckpt.remap_sor(_learned_sor("jax", 4), n_new)
    tout = tckpt.remap_sor(_learned_sor("torch", 4),
                           TFleetSpec.sample(n_new, seed=1))
    _same_bits(_port_leaves(tout), _reference_leaves(jout), "remap_sor")
    assert tout.history.chip_shape == (n_new,)
    if n_new > 4:
        assert (tout.estimate.confidence[:, 4:] == 0).all()
        assert not tout.history.valid[:, :, 4:].any()


def test_remap_sor_same_size_and_scalar():
    st4 = _learned_sor("torch", 4)
    assert tckpt.remap_sor(st4, 4) is st4
    with pytest.raises(ValueError, match="fleet-shaped"):
        tckpt.remap_sor(tsor.init_state(tsor.SorConfig(), device="cpu"), 4)
