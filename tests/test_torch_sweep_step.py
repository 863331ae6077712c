"""The .DC sweep, .STEP and .MEASURE DC in the PyTorch port on the CPU,
f64, against the JAX package: ``sweep_values`` and ``find_source``; the
nested sweep of examples/mos_family.sp (grid order included) against JAX's
``dc_sweep``, and examples/diode_temp.sp's sweep against the JAX CLI's
CSV; ``.MEASURE DC``; a three-card .STEP grid (a source list, .STEP PARAM
and .STEP TEMP over a .TEMP card) against JAX's ``run_step``; the
transient .STEP with and without saved waveforms; .STEP with .hb.  Each
JAX computation is made once and shared (module fixtures)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.analysis import measure as jmeasure
from circuitsimulator_tpu.analysis import sweep as jsweep
from circuitsimulator_tpu.netlist.parser import \
    parse_netlist_text as jax_parse
from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.analysis import step as tstep
from circuitsimulator_tpu_torch.analysis import sweep as tsweep
from circuitsimulator_tpu_torch.netlist import parse_netlist_text

# one intra-op thread, as in every port test file (pytest-xdist shares
# the cores between workers)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
GOLDENS = os.path.join(REPO, "tests", "goldens")
J64 = JAX_OPTIONS.replace(dtype=jnp.float64)
TOL = 1e-9

# a source list, a .PARAM and the temperature over a .TEMP card, with a
# diode that scales IS(T) (EG, XTI): 3 x 2 x 2 operating points
GRID = """* .STEP grid
.PARAM rr=1k
.TEMP 50
V1 in 0 DC 1
R1 in a {rr}
D1 a 0 IS=1e-14 EG=1.11 XTI=3
R2 a 0 10k
.STEP V1 LIST 0.5 1 2
.STEP PARAM rr LIST 1k 2k
.STEP TEMP LIST 27 85
.op
"""

# the RC deck of tests/test_param_step.py's transient .STEP
RC_STEP = """* step RC tau
.PARAM rr=1k
V1 in 0 PULSE(0 1 0 1n 1n 1 2)
R1 in out {rr}
C1 out 0 1n
.TRAN 20n 8u
.STEP PARAM rr LIST 1k 2k
.MEASURE TRAN t63 WHEN V(out)=0.632 RISE=1
.MEASURE TRAN t90 WHEN V(out)=0.9 RISE=1
"""


def golden_csv(name):
    with open(os.path.join(GOLDENS, name)) as f:
        header = f.readline()
    return header, np.loadtxt(os.path.join(GOLDENS, name), delimiter=",",
                              skiprows=1, ndmin=2)


@pytest.fixture(scope="module")
def jax_mos_family():
    js = JaxSimulator.from_file(os.path.join(EXAMPLES, "mos_family.sp"),
                                opts=J64)
    res = js.dc_sweep()
    return (np.asarray(res.values), np.asarray(res.values2),
            np.asarray(res.xs), res.source, res.source2)


@pytest.fixture(scope="module")
def jax_grid():
    res = JaxSimulator.from_text(GRID, opts=J64).step()
    return res.name, res.kind, list(res.values), res.analysis, \
        np.asarray(res.result)


# ------------------------------------------------------------ the sweep
@pytest.mark.parametrize("args", [(0.0, 2.0, 0.02), (0.0, 5.0, 0.1),
                                  (1.0, 3.0, 0.5), (3.0, -1.0, -0.25),
                                  (0.0, 1.0, 0.3), (1.0, 1.0, 1.0),
                                  (0.0, 1.0, 0.0), (0.0, 1.0, -0.1)])
def test_sweep_values_matches_jax(args):
    try:
        want = jsweep.sweep_values(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tsweep.sweep_values(*args)
        return
    np.testing.assert_array_equal(tsweep.sweep_values(*args), want)


@pytest.mark.parametrize("name", ["V1", "v1", "Vb", "I1", "i1", "Rx"])
def test_find_source_matches_jax(name):
    text = "V1 a 0 DC 1\nR1 a b 1k\nI1 0 b DC 1m\nVb b 0 DC 0\n.op\n"
    jc, _ = jax_parse(text)
    tc, _ = parse_netlist_text(text)
    try:
        want = jsweep.find_source(jc, name)
    except KeyError:
        with pytest.raises(KeyError, match=name):
            tsweep.find_source(tc, name)
        return
    assert tsweep.find_source(tc, name) == want


def test_nested_sweep_matches_jax(jax_mos_family):
    """mos_family.sp's .DC Vds 0 5 0.1 Vgs 1 3 0.5: 51 x 5 points in one
    batched DC, outer-major (Vgs slowest), within 1e-9 V of JAX's vmapped
    sweep."""
    values, values2, xs, source, source2 = jax_mos_family
    sim = Simulator.from_file(os.path.join(EXAMPLES, "mos_family.sp"),
                              device="cpu")
    res = sim.dc_sweep()
    assert (res.source, res.source2) == (source, source2) == ("Vds", "Vgs")
    np.testing.assert_array_equal(res.values, values)
    np.testing.assert_array_equal(res.values2, values2)
    assert res.values2[0] == res.values2[50] == 1.0 and res.values[1] == 0.1
    np.testing.assert_allclose(res.xs.numpy(), xs, rtol=0, atol=TOL)


def test_sweep_and_measure_dc_match_jax(tmp_path):
    """diode_temp.sp's .DC V1 0 2 0.02 against the JAX CLI's CSV, and its
    .MEASURE DC von (the WHEN crossing over the swept value) against JAX's
    evaluator on the same waveforms and the JAX CLI's printed value."""
    sim = Simulator.from_file(os.path.join(EXAMPLES, "diode_temp.sp"),
                              device="cpu")
    res = sim.dc_sweep()
    path = tmp_path / "sweep.csv"
    tsweep.write_sweep_csv(str(path), sim.topo, res)
    header, want = golden_csv("diode_temp_dcsweep_jax.csv")
    assert path.read_text().splitlines(True)[0] == header
    got = np.loadtxt(path, delimiter=",", skiprows=1)
    assert got.shape == want.shape == (101, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    (name, von), = sim.measure(res, "dc")
    jax_von = jmeasure.run_measures(sim.config.measures, sim.topo,
                                    res.values, res.xs.numpy(),
                                    analysis="dc")
    assert (name, von) == tuple(jax_von[0])
    assert name == "von" and von == pytest.approx(7.203214153e-01,
                                                  abs=1e-9)


def test_dc_sweep_source_override_and_errors():
    sim = Simulator.from_text("V1 a 0 DC 1\nR1 a b 1k\nR2 b 0 1k\n.op\n",
                              device="cpu")
    res = sim.dc_sweep(source="V1", values=[1.0, 2.0, 4.0])
    b = sim.circuit.nodes[sim.circuit.node_name_to_id["b"]].eq_index
    np.testing.assert_allclose(res.xs[:, b].numpy(), [0.5, 1.0, 2.0],
                               rtol=1e-15)
    assert res.source2 == "" and res.values2 is None
    with pytest.raises(ValueError, match="requires `values`"):
        sim.dc_sweep(source="V1")
    with pytest.raises(ValueError, match=".DC card missing"):
        sim.dc_sweep()
    with pytest.raises(KeyError, match="Vzz"):
        sim.dc_sweep(source="Vzz", values=[1.0])


# ------------------------------------------------------------ .STEP
def test_step_grid_matches_jax(jax_grid, tmp_path):
    """Three cards as one cartesian batch of 12 operating points: the
    source list, the re-parsed .PARAM and .STEP TEMP's IS(T) from the
    nominal saturation current under a .TEMP card, within 1e-9 V of JAX's
    run_step; the CSV writer's header and rows."""
    name, kind, values, analysis, xs = jax_grid
    sim = Simulator.from_text(GRID, device="cpu")
    res = sim.step()
    assert (res.name, res.kind, res.analysis) == (name, kind, analysis) == \
        ("V1,rr,temp", "source,param,temp", "op")
    assert [tuple(v) for v in res.values] == [tuple(v) for v in values]
    np.testing.assert_allclose(res.result.numpy(), xs, rtol=0, atol=TOL)
    # one card of the three: the source list alone
    one = sim.step(step_index=0)
    assert one.kind == "source" and one.values == [0.5, 1.0, 2.0]
    path = tmp_path / "step.csv"
    tstep.write_step_csv(str(path), sim.topo, res)
    lines = path.read_text().splitlines()
    assert lines[0] == "V1,rr,temp,V(in),V(a),I(V1)" and len(lines) == 13


@pytest.mark.parametrize("save_xs", [True, False])
def test_step_transient_measures(save_xs):
    """The transient .STEP: with saved waveforms the host measures per
    step, without them the streaming accumulators; both give tau = RC."""
    sim = Simulator.from_text(RC_STEP, device="cpu")
    res = sim.step(save_xs=save_xs)
    assert res.analysis == "tran" and res.kind == "param"
    names = [nm for nm, _ in res.measures]
    assert names == ["t63", "t90"]
    t63 = res.measures[0][1]
    np.testing.assert_allclose(t63, [1.02e-6, 2.04e-6], rtol=5e-2)
    assert (res.result.xs is None) != save_xs
    if not save_xs:
        ref = sim.step(save_xs=True)
        for (_, a), (_, b) in zip(res.measures, ref.measures):
            np.testing.assert_allclose(np.asarray(a, np.float64), b,
                                       rtol=1e-12)


def test_step_with_hb_raises_naming_hb():
    """.STEP with a .hb card: it raised (naming HB) until the harmonic
    stack was ported; now the step points solve as one batched HB
    (JAX's step.py), each lane equal to its own single-lane solve."""
    from circuitsimulator_tpu_torch.analysis.hb import harmonic_balance
    sim = Simulator.from_text("V1 1 0 SIN 0 1 1e6\nR1 1 2 1k\nC1 2 0 1n\n"
                              ".STEP V1 LIST 1 2\n.hb 1e6 4\n", device="cpu")
    sres = sim.step()
    assert sres.analysis == "hb" and bool(sres.result.converged.all())
    p = dict(sim.params)
    p["vs_dc"] = torch.full_like(p["vs_dc"], 2.0)
    one = harmonic_balance(sim.engine, p, 1e6, n_harm=4)
    np.testing.assert_allclose(sres.result.xs[1].numpy(), one.xs.numpy(),
                               rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match=".STEP card missing"):
        Simulator.from_text("V1 1 0 1\nR1 1 0 1k\n.op\n",
                            device="cpu").step()
