"""The paper's §VI case-study model and the §V-F overhead tables on the port
(`repro_torch/core/transceiver.py`, `repro_torch/core/overhead.py`, copies
of the reference's host models) against the reference: every case of
tests/test_transceiver.py and the overhead cases of tests/test_controller.py
run on both modules, and every sweep of the case study (4 speeds x
both/tx/rx) equals the reference's field for field, bit for bit (no
tolerance: the same numpy arithmetic on the same inputs)."""

import ast
import dataclasses
import math
import subprocess
import sys

import pytest

from repro.core import overhead as j_overhead
from repro.core import transceiver as j_tx
from repro_torch.core import overhead as t_overhead
from repro_torch.core import transceiver as t_tx
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

MODULES = {"reference": j_tx, "port": t_tx}
OVERHEAD = {"reference": j_overhead, "port": t_overhead}
SPEEDS = j_tx.SPEEDS_GBPS


@pytest.fixture(params=list(MODULES), scope="module")
def tx(request):
    return MODULES[request.param]


@pytest.fixture(scope="module")
def m(tx):
    return tx.GtxLinkModel(seed=0)


# -- the reference's case-study cases, on both modules ------------------------

def test_ber_zero_above_onset(tx, m):
    for s in tx.SPEEDS_GBPS:
        r = m.run_link_test(1.0, 1.0, s)
        assert r.ber == 0.0 and r.bytes_received == r.bytes_sent


@pytest.mark.parametrize("speed", SPEEDS)
def test_ber_onset_voltages(tx, m, speed):
    """Fig 14: onsets 0.869 / 0.787 / 0.745 / 0.744 V."""
    onset = tx.RX_BER_ONSET_V[speed]
    above = m.run_link_test(onset + 0.003, onset + 0.003, speed)
    below = m.run_link_test(onset - 0.002, onset - 0.002, speed)
    assert above.ber == 0.0
    assert below.ber > 0.0


def test_ber_ramp_at_10g(m):
    """Fig 12c: ~1e-7 near 0.866 V, ~1e-6 near 0.864 V."""
    b866 = m.run_link_test(0.866, 0.866, 10.0).ber_true
    b864 = m.run_link_test(0.864, 0.864, 10.0).ber_true
    assert math.log10(b866) == pytest.approx(-7.0, abs=0.3)
    assert math.log10(b864) == pytest.approx(-6.0, abs=0.3)


def test_throughput_collapse_near_0p80(m):
    """Fig 12a: first major collapse near 0.80 V at 10 Gbps."""
    ok = m.run_link_test(0.805, 0.805, 10.0)
    dead = m.run_link_test(0.79, 0.79, 10.0)
    assert ok.bytes_received == ok.bytes_sent
    assert dead.bytes_received < 0.5 * dead.bytes_sent and not dead.link_up


def test_rx_dominant_sensitivity(m):
    """Fig 13: TX-only sweep keeps full payload to 0.7 V; RX-swept degrades;
    TX BER onset ~0.82 V vs RX ~0.869 V."""
    tx_only = m.run_link_test(0.70, 1.0, 10.0)
    rx_only = m.run_link_test(1.0, 0.79, 10.0)
    assert tx_only.bytes_received == tx_only.bytes_sent
    assert rx_only.bytes_received < rx_only.bytes_sent
    assert m.run_link_test(0.825, 1.0, 10.0).ber == 0.0
    assert m.run_link_test(0.815, 1.0, 10.0).ber_true > 1e-10


@pytest.mark.parametrize("speed", SPEEDS)
def test_latency_baselines(tx, m, speed):
    """Fig 15b: ~100/130/200/410 ns in the stable region."""
    assert m.latency_ns(1.0, 1.0, speed) == pytest.approx(
        tx.LATENCY_BASE_NS[speed])


def test_latency_excursions_below_onset(tx, m):
    """Fig 15a: sustained excursions appear below ~0.86 V at 10 Gbps."""
    spikes = [m.latency_ns(v, v, 10.0) for v in
              [0.84 - i * 0.002 for i in range(30)]]
    assert max(spikes) > 10 * tx.LATENCY_BASE_NS[10.0]


def test_power_reduction_headline(m):
    """Fig 16: 28.4% at the near-zero-BER boundary; 29.3% at BER<=1e-6."""
    p_nom = m.rail_power_w("tx", 1.0, 10.0)
    assert p_nom == pytest.approx(0.200, abs=1e-3)
    p_nb = m.rail_power_w("tx", 0.869, 10.0)
    assert 1 - p_nb / p_nom == pytest.approx(0.284, abs=0.002)
    p_b6 = m.rail_power_w("tx", 0.864, 10.0)
    assert 1 - p_b6 / p_nom == pytest.approx(0.293, abs=0.002)
    assert p_nb == pytest.approx(0.1432, abs=5e-4)
    assert p_b6 == pytest.approx(0.1415, abs=5e-4)


def test_power_table_xii_anchors(m):
    """Table XII: representative rail power at 1.0/0.8 V across speeds."""
    expect = {
        (10.0, "tx"): (0.20, 0.13), (10.0, "rx"): (0.17, 0.11),
        (7.5, "tx"): (0.18, 0.12), (7.5, "rx"): (0.155, 0.10),
        (5.0, "tx"): (0.14, 0.09), (5.0, "rx"): (0.12, 0.08),
        (2.5, "tx"): (0.12, 0.08), (2.5, "rx"): (0.095, 0.07),
    }
    for (speed, side), (p10, p08) in expect.items():
        assert m.rail_power_w(side, 1.0, speed) == pytest.approx(p10, rel=0.06)
        assert m.rail_power_w(side, 0.8, speed) == pytest.approx(p08, rel=0.10)


def test_power_monotone_in_voltage(tx, m):
    for side in ("tx", "rx"):
        for s in tx.SPEEDS_GBPS:
            ps = [m.rail_power_w(side, v, s)
                  for v in [0.7 + 0.01 * i for i in range(31)]]
            assert all(b >= a - 1e-12 for a, b in zip(ps, ps[1:]))


def test_power_locality(m):
    """Table XI: savings localize to the swept side."""
    r = m.run_link_test(0.75, 1.0, 10.0)   # TX swept, RX fixed
    assert r.tx_power_w < 0.12 and r.rx_power_w == pytest.approx(0.17, rel=0.02)


def test_sweep_procedure_shape(m):
    sw = m.sweep(10.0, mode="both", v_stop=0.9)
    assert len(sw) == 101  # 1 mV steps over 0.1 V
    assert sw[0].v_tx == 1.0 and sw[-1].v_tx == pytest.approx(0.9)


# -- the reference's §V-F overhead cases, on both modules -----------------------

@pytest.fixture(params=list(OVERHEAD))
def overhead(request):
    return OVERHEAD[request.param]


def test_static_power_ratio_5p6x(overhead):
    assert overhead.static_power_ratio() == pytest.approx(5.60, abs=0.01)
    assert overhead.HW_STATIC_TOTAL_W == pytest.approx(0.015)
    assert overhead.SW_STATIC_TOTAL_W == pytest.approx(0.084)


def test_bram_ratio_31p96x(overhead):
    assert overhead.bram_ratio() == pytest.approx(31.96, abs=0.01)


def test_controller_budget_check(overhead):
    rep = overhead.ControllerOverheadReport(
        path="in_graph", controller_flops_per_step=1e6,
        model_flops_per_step=1e12, controller_bytes_per_step=1e3,
        model_bytes_per_step=1e9, host_seconds_per_step=1e-5,
        step_seconds=0.1)
    assert rep.within_budget(0.02)
    assert not dataclasses.replace(rep, host_seconds_per_step=0.01
                                   ).within_budget(0.02)


# -- the port against the reference ---------------------------------------------

@pytest.mark.parametrize("mode", ["both", "tx", "rx"])
@pytest.mark.parametrize("speed", SPEEDS)
def test_sweep_equals_the_reference_bit_for_bit(speed, mode):
    """The §VI-B sweep, 1.0 -> 0.7 V at 1 mV: 301 LinkTestResults each,
    every field equal (floats compared with ==, the jittered fields
    included)."""
    want = j_tx.GtxLinkModel(seed=0).sweep(speed, mode=mode)
    got = t_tx.GtxLinkModel(seed=0).sweep(speed, mode=mode)
    assert len(got) == len(want) == 301
    fields = [f.name for f in dataclasses.fields(t_tx.LinkTestResult)]
    assert fields == [f.name for f in dataclasses.fields(j_tx.LinkTestResult)]
    for g, w in zip(got, want):
        assert dataclasses.astuple(g) == dataclasses.astuple(w), g.v_rx
    if (speed, mode) == (10.0, "both"):
        # the jitter draws are in play: a collapsed link, latency spikes
        assert any(not r.link_up for r in got)
        assert len({r.latency_ns for r in got}) > 1


def test_model_tables_equal_the_reference():
    for name in ("SPEEDS_GBPS", "PAYLOAD_BYTES_DEFAULT", "NOMINAL_V",
                 "REFCLK_MHZ", "RX_BER_ONSET_V", "TX_BER_ONSET_V",
                 "RX_COLLAPSE_V", "LATENCY_BASE_NS",
                 "LATENCY_EXCURSION_ONSET_V", "TX_POWER_1V0_W",
                 "RX_POWER_1V0_W", "_POWER_SHAPE_ANCHORS",
                 "_POWER_SHAPE_ANCHORS_25RX", "BER_FLOOR_LOG10"):
        assert getattr(t_tx, name) == getattr(j_tx, name), name
    for shape in ("_POWER_SHAPE", "_POWER_SHAPE_25RX"):
        for f in ("x", "y", "m", "h"):
            assert (getattr(getattr(t_tx, shape), f)
                    == getattr(getattr(j_tx, shape), f)).all(), (shape, f)
    for name in ("KC705_TOTALS", "HW_UTILIZATION_PCT", "SW_UTILIZATION_PCT",
                 "HW_STATIC_POWER_W", "SW_STATIC_POWER_W",
                 "HW_STATIC_TOTAL_W", "SW_STATIC_TOTAL_W", "HW_STATIC_SHARE",
                 "SW_STATIC_SHARE"):
        assert getattr(t_overhead, name) == getattr(j_overhead, name), name
    assert t_overhead.static_power_ratio() == j_overhead.static_power_ratio()
    assert t_overhead.bram_ratio() == j_overhead.bram_ratio()


KEYS = [(0, 0.869, 10.0), (0, 0.75, 0.744, 2.5, 2.0), (1, 0.801, 7.5),
        (3, 1.0, 1.0, 5.0), (7, 0.7, 0.7, 10.0, 1.0)]


def test_det_uniform_is_the_same_in_another_process():
    """`_det_uniform` hashes a tuple of ints, which does not depend on the
    process's string-hash seed: a process with another PYTHONHASHSEED
    draws the reference's numbers."""
    want = [j_tx._det_uniform(*k) for k in KEYS]
    assert [t_tx._det_uniform(*k) for k in KEYS] == want
    code = ("from repro_torch.core.transceiver import _det_uniform; "
            f"print(repr([_det_uniform(*k) for k in {KEYS!r}]))")
    env = one_thread_env(PYTHONHASHSEED="12345")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert ast.literal_eval(out) == want
