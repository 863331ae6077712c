"""METHOD=TRAP and the dense ``lu`` transient solver in the PyTorch port on
the CPU, against the JAX package (f64): tests/test_trap.py's decks (the RC
recurrence, the MOS + L + C deck on ``woodbury`` and ``lu``, the same deck
under MOSCAP=CHARGE), xfmr.sp (K) and a batch of eight numpy-drawn lanes.
One JAX computation per deck: the batch's lane 0 is the nominal deck."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.analysis.transient import run_transient
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

# one intra-op thread, as in every port test file (pytest-xdist shares
# the cores between workers)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
GMIN = 1e-6

RC_TEXT = ("V1 1 0 PULSE(0 1 0 0 0 1 0)\nR1 1 2 1k\nC1 2 0 1n\n"
           ".TRAN 2e-8 4e-7\n")
# tests/test_trap.py's MOS + L + C deck, cut to 30 steps
MOS_TEXT = (".MODEL 2 VT 0.4 MU 1e-2 COX 1e-3 LAMBDA 0.05 CJ0 1e-13\n"
            "VDD 1 0 3\nVin 2 0 SIN 1 0.5 1e8\nRD 1 3 1k\n"
            "M1 3 2 0 n 10e-6 1e-6 2\nC1 3 0 2e-13\nL1 3 4 1e-9\n"
            "C2 4 0 1e-13\n.TRAN 1e-11 3e-10\n")
SIGMAS = {"res_r": 0.05, "mos_vth": 0.05, "cap_c": 0.1, "ind_l": 0.1}


def jopts(**kw):
    return JAX_OPTIONS.replace(dtype=jnp.float64, tran_method="trap", **kw)


def topts(**kw):
    return DEFAULT_OPTIONS.replace(tran_method="trap", **kw)


def port(text, **kw):
    return Simulator.from_text(text, opts=topts(**kw), device="cpu")


def draw_lanes(params, B, seed):
    """B lanes of the JAX params, lane 0 nominal, the others lognormal on
    SIGMAS' leaves, drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
           for k, v in params.items()}
    for key, sigma in SIGMAS.items():
        z = rng.standard_normal(out[key].shape)
        z[0] = 0.0
        out[key] = out[key] * np.exp(sigma * z)
    return out


@pytest.fixture(scope="module")
def mos_batch():
    """The MOS + L + C deck's eight lanes: the port's batched DC (held to
    JAX's by tests/test_torch_dc_tran.py), then JAX's trap transient of
    each lane from it (save_xs, the non-fused loop, vmapped): the lanes,
    the DC points and JAX's xs (B, n + 1, N)."""
    js = JaxSimulator.from_text(MOS_TEXT, opts=jopts())
    lanes = draw_lanes(js.params, 8, seed=14)
    x0 = tmc.batched_dc_fast(port(MOS_TEXT).engine, params_from_numpy(lanes))
    res = jax.jit(jax.vmap(lambda p, x: run_transient(
        js.engine, p, 1e-11, 3e-10, x0=x)))(
            {k: jnp.asarray(v) for k, v in lanes.items()},
            jnp.asarray(x0.numpy()))
    assert not np.asarray(res.failed).any()
    return lanes, x0, np.asarray(res.xs)


def test_trap_rc_recurrence():
    """tests/test_trap.py's exact recurrence (the trapezoidal companion of
    the RC low-pass with gmin and the damped early stop, solved with numpy)
    on the lu solver, 20 steps, at JAX's bar for it (1e-12 V: the JAX run
    is held there by tests/test_trap.py, so the two agree within 2e-12)."""
    res = port(RC_TEXT, tran_solver="lu").transient()
    v2 = res.xs[:, 1].numpy()
    R, C, dt = 1e3, 1e-9, 2e-8
    g, gc2 = 1.0 / R, 2 * C / dt
    G = np.array([[g + GMIN, -g, 1.0], [-g, g + gc2 + GMIN, 0.0],
                  [1.0, 0.0, 0.0]])
    x = np.zeros(3)
    v_prev = i_prev = 0.0
    for k in range(1, len(v2)):
        x_raw = np.linalg.solve(G, np.array([0.0, gc2 * v_prev + i_prev,
                                             1.0]))
        for _ in range(50):
            x_new = x + 0.45 * (x_raw - x)
            err = np.linalg.norm(x_new - x)
            x = x_new
            if err < 1e-6:
                break
        i_prev = gc2 * (x[1] - v_prev) - i_prev
        v_prev = x[1]
        assert v2[k] == pytest.approx(v_prev, abs=1e-12), k


def test_trap_mos_deck_woodbury_and_lu(mos_batch):
    """The MOS + L + C deck on both solvers against JAX (lane 0 of its
    batch is the nominal deck), lu against woodbury within JAX's own bar
    (tests/test_trap.py:84-85)."""
    _, x0, jxs = mos_batch
    wb = port(MOS_TEXT).transient(x_op=x0[0])
    lu = port(MOS_TEXT, tran_solver="lu").transient(x_op=x0[0])
    assert not (bool(wb.failed) or bool(lu.failed))
    for res in (wb, lu):
        np.testing.assert_allclose(res.xs.numpy(), jxs[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(lu.xs.numpy(), wb.xs.numpy(), rtol=0,
                               atol=1e-10)


def test_trap_batched_lanes_match_jax(mos_batch):
    """Eight numpy-drawn lanes (R, VT, C, L perturbed) through the port's
    batched_transient: the non-fused trap loop against JAX's vmapped
    one."""
    lanes, x0, jxs = mos_batch
    ts = port(MOS_TEXT)
    res = tmc.batched_transient(ts.engine, params_from_numpy(lanes), 1e-11,
                                3e-10, save_xs=True, x0=x0)
    assert not bool(res.failed.any())
    np.testing.assert_allclose(res.xs.numpy().swapaxes(0, 1), jxs, rtol=0,
                               atol=TOL)


@pytest.fixture(scope="module")
def charge_jax():
    """The deck under MOSCAP=CHARGE: the port's DC point and JAX's 10 trap
    steps from it."""
    x0 = port(MOS_TEXT, mos_cap_model="charge").dc()
    js = JaxSimulator.from_text(MOS_TEXT, opts=jopts(mos_cap_model="charge"))
    res = jax.jit(lambda p, x: run_transient(js.engine, p, 1e-11, 1e-10,
                                             x0=x))(js.params,
                                                    jnp.asarray(x0.numpy()))
    return x0, np.asarray(res.xs)


@pytest.mark.parametrize("solver", ["woodbury", "lu"])
def test_trap_charge_model_matches_jax(solver, charge_jax):
    """The same deck under MOSCAP=CHARGE (the trapezoidal charge currents
    qi in the state), 10 steps, each solver against JAX's woodbury run."""
    x0, want = charge_jax
    sim = port(MOS_TEXT, mos_cap_model="charge", tran_solver=solver)
    res = sim.transient(tstop=1e-10, x_op=x0)
    assert not bool(res.failed)
    np.testing.assert_allclose(res.xs.numpy(), want, rtol=0, atol=TOL)


def test_trap_mutual_inductance_matches_jax():
    """xfmr.sp (K) over 100 trapezoidal steps: the doubled -2M/dt cross
    terms and history currents."""
    path = os.path.join(REPO, "examples", "xfmr.sp")
    js = JaxSimulator.from_file(path, opts=jopts())
    n = 100
    tstop = n * js.config.tran.tstep
    want = np.asarray(js.transient(tstop=tstop).xs)
    got = Simulator.from_file(path, opts=topts(), device="cpu").transient(
        tstop=tstop)
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got.xs.numpy(), want, rtol=0, atol=TOL)


def test_trap_state_update_and_fused_refusal():
    """The trapezoidal state carries i_C, v_L and, under MOSCAP=CHARGE,
    qi (zero under BE, whose numbers stay those of the BE update); the
    fused chunk (K1) stays Backward Euler only and refuses a trap deck by
    name."""
    sim = port(MOS_TEXT, mos_cap_model="charge")
    eng = sim.engine
    x0 = sim.dc()
    st = eng.init_state(x0, sim.params)
    assert set(st) == {"vc", "ic", "il", "vl", "qm", "qi"}
    assert bool((st["qi"] == 0).all())
    x1 = x0 * 1.01
    trap = eng.make_update_state(1e-11, "trap")(sim.params, x1, st)
    be = eng.make_update_state(1e-11)(sim.params, x1, st)
    assert bool((trap["ic"] != 0).any()) and bool((trap["qi"] != 0).any())
    assert bool((be["ic"] == 0).all()) and bool((be["qi"] == 0).all())
    assert torch.equal(be["qm"], trap["qm"])
    bp = tmc.broadcast_params(sim.params, 2)
    with pytest.raises(NotImplementedError,
                       match=r"METHOD=TRAP \(Backward Euler only\)"):
        tmc.batched_transient(eng, bp, 1e-11, 1e-10, fused=True)


STEP_TEXT = """* RC step response under TRAP, .STEP over R
.PARAM rr=1k
V1 in 0 PULSE(0 1 0 1n 1n 1 2)
R1 in out {rr}
C1 out 0 1n
.STEP PARAM rr LIST 500 2k
.MEASURE TRAN t63 WHEN V(out)=0.632 RISE=1
.OPTIONS METHOD=TRAP
.TRAN 50n 2u
"""
MC_TEXT = """* RC filter with tolerances under TRAP
V1 in 0 PULSE(0 1 0 1u 1u 1 2)
R1 in out 1k DEV=5%
C1 out 0 100n DEV=10%
.MEASURE TRAN t50 WHEN V(out)=0.5 RISE=1
.MEASURE TRAN vfinal FIND V(out) AT=0.4m
.OPTIONS METHOD=TRAP
.TRAN 10u 0.5m
"""


def test_trap_step_and_monte_carlo_inherit_trap():
    """.STEP and Simulator.monte_carlo run TRAP decks through the same
    batched loop: each .STEP lane equals the single-lane trapezoidal run
    of its value (1e-12 V; the single lane is held to JAX above), and the
    Monte-Carlo lanes' streamed measures equal the host measures of the
    batched trapezoidal waveforms of the same lanes."""
    from circuitsimulator_tpu_torch.analysis.measure import run_measures
    res = Simulator.from_text(STEP_TEXT, device="cpu").step()
    for lane, rr in enumerate(("500", "2k")):
        one = Simulator.from_text(
            STEP_TEXT.replace(".STEP PARAM rr LIST 500 2k\n", "").replace(
                ".PARAM rr=1k", f".PARAM rr={rr}"), device="cpu")
        assert one.opts.tran_method == "trap"
        np.testing.assert_allclose(res.result.xs[:, lane].numpy(),
                                   one.transient().xs.numpy(), rtol=0,
                                   atol=1e-12)
    mc = Simulator.from_text(MC_TEXT, device="cpu")
    cfg = mc.config
    bp, vals = mc.monte_carlo(3, warm_start=False)
    ref = tmc.batched_transient(mc.engine, bp, cfg.tran.tstep, cfg.tran.tstop,
                                save_xs=True)
    xs = ref.xs.numpy()
    for lane in range(3):
        want = dict(run_measures(cfg.measures, mc.topo, ref.times.numpy(),
                                 xs[:, lane], analysis="tran",
                                 bindings=cfg.param_values))
        for name in ("t50", "vfinal"):
            np.testing.assert_allclose(float(vals[name][lane]), want[name],
                                       rtol=1e-9)
