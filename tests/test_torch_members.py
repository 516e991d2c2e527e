"""Public members of the reference kept as copies in the port, each
against the reference on the same inputs:

- `FrameHistory.{n_rails, rail_index, v_io, error, partition_specs}` and
  `TelemetryFrame.to_dict` (`core/telemetry.py`);
- `SorConfig.rail_index`, `SorEstimate.{rail, log10_error_at}` and the
  module's `__all__` (`core/sor.py`) and `RailRequest.is_empty` (`core/policy.py`);
- `ModelConfig.has_attention` (`configs/base.py`) and
  `models/common.{pad_heads_q, pad_heads_kv}`;
- the HLO text parsers, `roofline/hlo_costs.py` and
  `launch/dryrun.collective_bytes`, copied: on the HLO text the
  reference's `tests/test_dryrun.py` feeds its walker (a scan of 10
  matmuls, a fused matmul) and on hand-written collectives in both
  replica-group forms.

Tolerances: the ring's views and the frame's dict exactly (the same pushes
of the same f32 values); the estimate's `log10_error_at` at F32 (one f32
multiply-add, XLA's against torch's); the padded heads exactly; the
parsers' counts exactly (the same text through the same code)."""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget
from repro.core import policy as jpol
from repro.core import sor as jsor
from repro.core import telemetry as jtel
from repro.models import common as jcommon
from repro.roofline import hlo_costs as jhlo
from repro_torch.configs.base import get_config as tget
from repro_torch.core import policy as tpol
from repro_torch.core import sor as tsor
from repro_torch.core import telemetry as ttel
from repro_torch.launch import dryrun as tdry
from repro_torch.models import common as tcommon
from repro_torch.roofline import hlo_costs as thlo
from test_torch_control import _frame, _observables
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-6, atol=1e-7)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_collective_bytes():
    """The reference's `launch/dryrun.collective_bytes`, run from its
    source: importing that module sets XLA_FLAGS to 512 host devices for
    the rest of the process, so the parser's section (its regexes,
    `_group_size` and the function) is executed alone."""
    text = (ROOT / "src/repro/launch/dryrun.py").read_text()
    a = text.index("_COLL_RE = re.compile(")
    b = text.index("# Runner")
    scope = {"re": re}
    exec(compile(text[a:b], "repro/launch/dryrun.py", "exec"), scope)
    return scope["collective_bytes"]


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _histories(n, rails_j, rails_t, pushes=9, seed=2):
    rng = np.random.default_rng(seed)
    jh = jtel.FrameHistory.create(6, n, rails=rails_j)
    th = ttel.FrameHistory.create(6, n, rails=rails_t, device="cpu")
    for _ in range(pushes):
        v = rng.uniform(0.6, 1.0, (3, n)).astype(np.float32)
        jf, tf = _frame(v, _observables(v, 0.7, rng))
        jh, th = jh.push(jf), th.push(tf)
    return jh, th


@pytest.mark.parametrize("rails", ["io", "all"])
def test_frame_history_views_equal_the_reference(rails):
    jr, tr = ((jtel.DEFAULT_RAIL_OBSERVABLES, ttel.DEFAULT_RAIL_OBSERVABLES)
              if rails == "io" else
              (jtel.ALL_RAIL_OBSERVABLES, ttel.ALL_RAIL_OBSERVABLES))
    jh, th = _histories(8, jr, tr)
    assert th.n_rails == jh.n_rails
    for s in tr:
        assert th.rail_index(s.rail) == jh.rail_index(s.rail)
    with pytest.raises(KeyError):
        th.rail_index("VDD_NONE")
    np.testing.assert_array_equal(npy(th.v_io), npy(jh.v_io))
    np.testing.assert_array_equal(npy(th.error), npy(jh.error))


@pytest.mark.parametrize("n_chips", [8, None])
def test_frame_history_partition_specs_equal_the_references(n_chips):
    """A fleet ring shards its trailing chip axis (the port's `Shard(-1)`
    where the reference's spec ends in the axis name) and replicates its
    scalars; a scalar ring replicates every leaf."""
    from torch.distributed.tensor import Replicate, Shard
    jh = jtel.FrameHistory.create(4, n_chips)
    th = ttel.FrameHistory.create(4, n_chips, device="cpu")
    jspec, tspec = jh.partition_specs("chips"), th.partition_specs("chips")
    for f in ("v", "obs", "age_s", "polled", "valid", "cursor", "count"):
        want = getattr(jspec, f)
        sharded = len(want) > 0 and want[-1] == "chips"
        assert getattr(tspec, f) == (Shard(-1) if sharded else Replicate()), f
    assert tspec.rails == th.rails


def test_frame_to_dict_equals_the_reference():
    rng = np.random.default_rng(5)
    v = rng.uniform(0.6, 1.0, (3, 4)).astype(np.float32)
    jf, tf = _frame(v, _observables(v, 0.7, rng, nan_frac=0.0))
    jd, td = jf.to_dict(), tf.to_dict()
    assert sorted(td) == sorted(jd)
    for k in jd:
        np.testing.assert_array_equal(npy(td[k]), npy(jd[k]), err_msg=k)


def test_sor_members_equal_the_reference():
    assert tsor.__all__ == jsor.__all__
    assert tsor.ALL_RAIL_OBSERVABLES == ttel.ALL_RAIL_OBSERVABLES
    jc = jsor.SorConfig(rails=jsor.ALL_RAIL_OBSERVABLES)
    tc = tsor.SorConfig(rails=tsor.ALL_RAIL_OBSERVABLES)
    for s in tc.rails:
        assert tc.rail_index(s.rail) == jc.rail_index(s.rail)
    rng = np.random.default_rng(7)
    arrays = {f: rng.standard_normal((3, 5)).astype(np.float32)
              for f in ("intercept", "slope", "v_frontier", "confidence",
                        "n_eff")}
    je = jsor.SorEstimate(**{k: jnp.asarray(a) for k, a in arrays.items()})
    te = tsor.SorEstimate(**{k: torch.from_numpy(a)
                             for k, a in arrays.items()})
    for i in range(3):
        for f in arrays:
            np.testing.assert_array_equal(npy(getattr(te.rail(i), f)),
                                          npy(getattr(je.rail(i), f)))
    v = rng.uniform(0.6, 1.0, (3, 5)).astype(np.float32)
    for arg in (v, 0.75):
        np.testing.assert_allclose(
            npy(te.log10_error_at(torch.from_numpy(v) if arg is v else arg)),
            npy(je.log10_error_at(arg)), **F32)


@pytest.mark.parametrize("fields", [{}, {"v_io": 0.7}, {"comp_level": 1},
                                    {"v_core": None, "reason": "hold"}])
def test_rail_request_is_empty_equals_the_reference(fields):
    assert tpol.RailRequest(**fields).is_empty() == \
        jpol.RailRequest(**fields).is_empty()


def test_has_attention_equals_the_reference():
    for arch in ARCH_IDS:
        for tiny in (False, True):
            assert tget(arch, tiny).has_attention == \
                jget(arch, tiny).has_attention, arch


@pytest.mark.parametrize("n_q,n_kv,tp", [(48, 8, 16), (40, 40, 16),
                                         (48, 1, 16), (4, 2, 1), (6, 6, 4)])
def test_pad_heads_equal_the_reference(n_q, n_kv, tp):
    plan_j = jcommon.plan_head_padding(n_q, n_kv, tp)
    plan_t = tcommon.plan_head_padding(n_q, n_kv, tp)
    rng = np.random.default_rng(n_q + n_kv + tp)
    for n, fn in ((n_q, "pad_heads_q"), (n_kv, "pad_heads_kv")):
        w = rng.standard_normal((3, n, 8)).astype(np.float32)
        got = getattr(tcommon, fn)(torch.from_numpy(w), plan_t)
        want = getattr(jcommon, fn)(jnp.asarray(w), plan_j)
        np.testing.assert_array_equal(npy(got), npy(want), err_msg=fn)


# -- the HLO text parsers -------------------------------------------------------------

def _scan_text():
    def f(x):
        y, _ = jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=10)
        return y
    return jax.jit(f).lower(jnp.ones((128, 128))).compile().as_text()


def _fusion_text():
    def f(x):
        return jnp.sum(jax.nn.relu(x @ x) * 2.0)
    return jax.jit(f).lower(jnp.ones((64, 64))).compile().as_text()


# one op of each collective kind, in both replica-group forms, inside a
# computation a while loop runs 4 times and in the entry
COLLECTIVES = """HloModule m

%cond (p: (s32[], f32[8,16])) -> pred[] {
  %p = (s32[], f32[8,16]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(4)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

%body (p: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {
  %p = (s32[], f32[8,16]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[8,16] get-tuple-element(%p), index=1
  %ag = f32[32,16] all-gather(%x), replica_groups=[4,4]<=[16], dimensions={0}
  %ar = bf16[8,16] all-reduce(%x), replica_groups={{0,1},{2,3}}, to_apply=%add
  %rs = f32[2,16] reduce-scatter(%x), replica_groups=[2,8]<=[16], dimensions={0}
  ROOT %t = (s32[], f32[8,16]) tuple(%i, %x)
}

ENTRY %main (a: f32[8,16]) -> f32[8,16] {
  %a = f32[8,16] parameter(0)
  %z = s32[] constant(0)
  %init = (s32[], f32[8,16]) tuple(%z, %a)
  %w = (s32[], f32[8,16]) while(%init), condition=%cond, body=%body
  %a2a = (f32[8,16], f32[8,16]) all-to-all(%a, %a), replica_groups={{0,1,2,3}}
  %cp = f32[8,16] collective-permute(%a), source_target_pairs={{0,1},{1,0}}
  %d = f32[8,8] dot(%a, %a), lhs_contracting_dims={1}, rhs_contracting_dims={1}
  ROOT %r = f32[8,16] get-tuple-element(%w), index=1
}
"""


@pytest.mark.parametrize("text", ["scan", "fusion", "collectives"])
def test_hlo_parsers_equal_the_references(text):
    hlo = {"scan": _scan_text, "fusion": _fusion_text,
           "collectives": lambda: COLLECTIVES}[text]()
    got, want = thlo.analyze_hlo_text(hlo), jhlo.analyze_hlo_text(hlo)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tdry.collective_bytes(hlo) == _reference_collective_bytes()(hlo)
    if text == "scan":
        assert got.flops == 10 * 2 * 128 ** 3 and got.n_whiles == 1
    if text == "collectives":
        assert set(got.collective_bytes) == {
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"}
        assert got.max_mult == 5.0        # the condition runs 4 + 1 times
        assert tdry.collective_bytes(hlo)["op_counts"]["all-gather"] == 1
