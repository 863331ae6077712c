"""Initial conditions (.IC cards, .TRAN UIC and element IC= on C and L) in
the PyTorch port on the CPU, f64: the decks of tests/test_ic.py (all but
the adaptive one) against JAX's ``Simulator.transient`` within 1e-9 V, and
tests/test_ic.py's assertions on the port.  The decks are merged into two
(one under UIC, one without) so that each takes one shared JAX
computation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu_torch import Simulator

# one intra-op thread, as in every port test file (pytest-xdist shares
# the cores between workers)
torch.set_num_threads(1)

J64 = JAX_OPTIONS.replace(dtype=jnp.float64)
TOL = 1e-9

# test_uic_rc_discharge (a), test_cap_ic_uic_discharge (b),
# test_ind_ic_uic_decay (c), test_floating_cap_ic_and_dotic_override
# (d, e, f), test_ic_unknown_node_warns (zzz), under one UIC card
UIC_DECK = """* UIC starts
R1 a 0 1k
C1 a 0 1u
C2 b 0 1u IC=2
R2 b 0 1k
L1 c 0 1m IC=3m
R3 c 0 1
C3 d e 1u IC=1.5
R4 d 0 1k
R5 e 0 1k
C4 f 0 1u IC=0.7
R6 f 0 1k
.IC V(a)=2 V(f)=0.9
.IC V(zzz)=5
.TRAN 10u 2m UIC
"""

# test_ic_without_uic_overrides_dc_start (a), test_cap_ic_ignored_without
# _uic (b), test_uic_flag_overridable_at_callsite (c, with uic=True)
IC_DECK = """* .IC over the DC point
V1 in 0 1
R1 in a 1k
C1 a 0 1u
R2 in b 1k
C2 b 0 1u IC=0.25
R3 in c 1k
C3 c 0 1u
.IC V(a)=3
.TRAN 1e-4 4e-3
"""


def veq(sim, name):
    return sim.circuit.nodes[sim.circuit.node_name_to_id[name]].eq_index


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's transients: the UIC deck, the .IC deck, and the .IC deck with
    uic=True at the call site."""
    uic = JaxSimulator.from_text(UIC_DECK, opts=J64)
    ic = JaxSimulator.from_text(IC_DECK, opts=J64)
    out = {}
    for name, js, kw in (("uic", uic, {}), ("ic", ic, {}),
                         ("ic_uic_override", ic, {"uic": True})):
        res = js.transient(**kw)
        out[name] = (np.asarray(res.times), np.asarray(res.xs))
    return out


@pytest.fixture(scope="module")
def port_runs():
    uic = Simulator.from_text(UIC_DECK, device="cpu")
    ic = Simulator.from_text(IC_DECK, device="cpu")
    out = {}
    for name, sim, kw in (("uic", uic, {}), ("ic", ic, {}),
                          ("ic_uic_override", ic, {"uic": True})):
        res = sim.transient(**kw)
        assert not bool(res.failed)
        out[name] = (sim, res.times.numpy(), res.xs.numpy())
    return out


@pytest.mark.parametrize("run", ["uic", "ic", "ic_uic_override"])
def test_transient_matches_jax(run, jax_runs, port_runs):
    _, ts, xs = port_runs[run]
    jts, jxs = jax_runs[run]
    assert xs.shape == jxs.shape
    np.testing.assert_allclose(ts, jts, rtol=1e-15, atol=0)
    np.testing.assert_allclose(xs, jxs, rtol=0, atol=TOL)


@pytest.mark.parametrize("case", ["uic_rc_discharge", "cap_ic_uic",
                                  "ind_ic_uic", "floating_cap_and_override",
                                  "ic_without_uic", "cap_ic_ignored",
                                  "uic_override"])
def test_ic_cases(case, port_runs):
    """tests/test_ic.py's assertions, on the port's runs."""
    run = ("uic" if case in ("uic_rc_discharge", "cap_ic_uic", "ind_ic_uic",
                             "floating_cap_and_override")
           else "ic_uic_override" if case == "uic_override" else "ic")
    sim, ts, xs = port_runs[run]

    def v(n):
        return xs[:, veq(sim, n)]

    if case == "uic_rc_discharge":      # no DC solve: RC decay from 2 V
        assert v("a")[0] == 2.0
        assert np.abs(v("a") - 2.0 * np.exp(-ts / 1e-3)).max() < 0.12
    elif case == "cap_ic_uic":          # BE decay (1 + dt/tau)^-n
        assert v("b")[0] == pytest.approx(2.0)
        assert v("b")[100] == pytest.approx(2.0 * 1.01 ** -100, rel=1e-3)
    elif case == "ind_ic_uic":
        (l1,) = [e for e in sim.circuit.elements if e.name == "L1"]
        assert xs[0, l1.branch_eq] == pytest.approx(3e-3)
        assert xs[99, l1.branch_eq] == pytest.approx(3e-3 * np.exp(-1),
                                                     rel=0.06)
    elif case == "floating_cap_and_override":
        x0 = sim._initial_conditions_x0(True).numpy()
        assert x0[veq(sim, "d")] - x0[veq(sim, "e")] == pytest.approx(1.5)
        assert x0[veq(sim, "f")] == pytest.approx(0.9)   # .IC wins
        np.testing.assert_array_equal(xs[0], x0)
    elif case == "ic_without_uic":      # starts at the IC, decays to 1 V
        assert v("a")[0] == 3.0 and abs(v("a")[-1] - 1.0) < 0.1
    elif case == "cap_ic_ignored":      # IC= is a UIC value only
        assert v("b")[0] == pytest.approx(1.0, abs=1e-6)
    else:                               # uic=True: from zeros, charging
        assert v("c")[0] == 0.0 and v("c")[-1] > 0.2
        assert v("b")[0] == pytest.approx(0.25) and v("a")[0] == 3.0


def test_ic_unknown_node_warns(capsys):
    sim = Simulator.from_text(UIC_DECK, device="cpu")
    sim._initial_conditions_x0(True)
    assert (".IC: unknown or ground node 'zzz'; ignored"
            in capsys.readouterr().err)


def test_x_op_wins_and_no_ic_keeps_the_dc_start():
    """An explicit x_op is the start even on a .IC deck; a deck without
    .IC or UIC starts from its DC point (no initial-condition vector)."""
    sim = Simulator.from_text(IC_DECK, device="cpu")
    x = sim.dc()
    res = sim.transient(x_op=x, tstop=2e-4)
    np.testing.assert_array_equal(res.xs[0].numpy(), x.numpy())
    plain = Simulator.from_text(IC_DECK.replace(".IC V(a)=3\n", ""),
                                device="cpu")
    assert plain._initial_conditions_x0(False) is None
    assert plain._initial_conditions_x0(True) is not None
