"""The junction and switch devices of the PyTorch port (diode, BJT, JFET,
S/W switch) against the JAX package on the same numpy inputs, f64 on the
CPU: the model functions on bias grids that cross every branch, the
engine's assembly and Woodbury solve on four decks, DC, a 100-step
transient, AC of a BJT amplifier, IS(T) scaling, the batched DC."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.models import bjt as jbjt
from circuitsimulator_tpu.models import diode as jdiode
from circuitsimulator_tpu.models import mosfet as jmos
from circuitsimulator_tpu.models import switch as jswitch
from circuitsimulator_tpu.ops.woodbury import WoodburySolver as JaxWoodbury
from circuitsimulator_tpu.utils import temp as jtemp
from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.convert import (params_from_numpy,
                                                state_from_numpy)
from circuitsimulator_tpu_torch.models import bjt, diode, mosfet, switch
from circuitsimulator_tpu_torch.ops.woodbury import WoodburySolver
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc
from circuitsimulator_tpu_torch.utils import temp

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
# the JAX package's whole-deck results (DC, transients, bjt_amp's AC):
# each compiles for 2-10 s on the CPU; ``PYTHONPATH=. JAX_PLATFORMS=cpu
# python tests/test_torch_devices.py`` remakes the file
GOLDEN = os.path.join(REPO, "tests", "goldens", "devices_jax.json")
RTOL = 1e-12

# the decks of tests/test_pallas_step.py with a .TRAN card each: a rectifier
# with a forward diode and a zener in breakdown; an NPN stage with Early
# voltage and a PNP follower; MOS, JFET, BJT and diode in one plan; a switch
# (width-4 Woodbury row) with a MOS and a diode
DIODE_DECK = """* diode rectifier + zener
V1 in 0 SIN 0 4 5e6
R1 in a 100
D1 a out
C1 out 0 1n
R2 out 0 10k
RBD in bd 500
D2 0 bd BV=3 IBV=1e-3
.TRAN 1n 100n
"""

BJT_DECK = """* npn + pnp stages
.MODEL qn NPN IS=1e-15 BF=120 BR=2 VAF=50 CJE=2p CJC=1p
.MODEL qp PNP IS=1e-15 BF=80 BR=1
VCC 1 0 5
Vin 2 0 SIN 0.65 0.01 1e6
RB 2 3 10k
RC 1 4 2k
Q1 4 3 0 qn
VB2 5 0 DC 4.3
RB2 5 6 10k
RC2 7 0 2k
Q2 7 6 1 qp
CL 4 0 1p
.TRAN 1n 100n
"""

MIXED_DECK = """* mixed nonlinear classes
.MODEL 2 VT 0.386 MU 3.0238e-2 COX 6.058e-3 LAMBDA 0.05 CJ0 4.0e-14
.MODEL j1 NJF VTO=-2 BETA=1e-3 LAMBDA=0.01
.MODEL qn NPN IS=1e-15 BF=120 BR=2
VDD 1 0 DC 3
Vin 2 0 SIN 0.8 0.2 5e6
M1 3 2 0 n 10e-6 0.35e-6 2
RL1 1 3 2k
J1 4 2 0 j1
RL2 1 4 2k
RB 2 7 20k
Q1 5 7 0 qn
RL3 1 5 2k
D1 6 0 CJO=1p
RD 1 6 1k
C1 3 0 1p
.TRAN 1n 100n
"""

SWITCH_DECK = """* switch chopper + mixed classes
.MODEL swm SW RON=10 ROFF=1e8 VT=0.5 VH=0.1
.MODEL cswm CSW RON=10 ROFF=1e9 IT=1m IH=0
.MODEL mn VT 0.6 MU 2e-2 COX 1e-3
VCTL c 0 PULSE 0 1 0 1u 1u 8u 20u
VIN in 0 SIN 0 2 5e4
S1 in mid c 0 swm
Vsen mid m2 0
RL m2 0 1k
W1 m2 0 Vsen cswm
C1 mid 0 100n
M1 mid g 0 b mn W=5u L=1u
VG g 0 0.8
D1 mid 0
.TRAN 100n 4u
"""

DECKS = {"diode": DIODE_DECK, "bjt": BJT_DECK, "mixed": MIXED_DECK,
         "switch": SWITCH_DECK}


def close(got, want, rtol=RTOL):
    """Elementwise within rtol, plus rtol of the largest entry."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    if want.size:
        np.testing.assert_allclose(
            got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def within(got, want, rtol=RTOL):
    """Rows of (n, m): each within rtol of its row's largest entry."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got.numpy() - want) <= rtol * scale).all()


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("breakdown", [False, True])
def test_diode_linearize_matches_jax(breakdown):
    """u from far below 0 to far above 40 (both sides of the continuation);
    with breakdown, devices with bv = 0 (gated off) beside zeners biased on
    both sides of -BV."""
    rng = np.random.default_rng(0)
    n = 400
    isat = 10.0 ** rng.uniform(-15, -9, n)
    nid = rng.uniform(1.0, 2.0, n)
    vp = rng.uniform(-6.0, 2.5, n)
    vm = rng.uniform(-0.5, 0.5, n)
    kw_j, kw_t = {}, {}
    if breakdown:
        bv = np.where(rng.random(n) < 0.5, 0.0, rng.uniform(2.0, 5.0, n))
        ibv = np.full(n, 1e-3)
        kw_j = dict(bv=jnp.asarray(bv), ibv=jnp.asarray(ibv))
        kw_t = dict(bv=t64(bv), ibv=t64(ibv))
    u = (vp - vm) / (nid * 0.025852)
    assert (u > 45).any() and (u < 40).any() and (u < -100).any()
    want = jdiode.diode_linearize(*map(jnp.asarray, (isat, nid, vp, vm)),
                                  **kw_j)
    got = diode.diode_linearize(*map(t64, (isat, nid, vp, vm)), **kw_t)
    for g, w in zip(got, want):
        assert np.isfinite(np.asarray(w)).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=0)
    sg = diode.diode_stamp_vals(*map(t64, (isat, nid, vp, vm)), **kw_t)
    sw_ = jdiode.diode_stamp_vals(*map(jnp.asarray, (isat, nid, vp, vm)),
                                  **kw_j)
    for g, w in zip(sg, sw_):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=0)


@pytest.mark.parametrize("early", [False, True])
def test_bjt_linearize_matches_jax(early):
    """NPN and PNP, junctions forward past the exponential limit and
    reverse; with the Early voltage, devices with vaf = 0 (off) and biases
    on both sides of the 0.05 clamp."""
    rng = np.random.default_rng(1)
    n = 600
    isat = 10.0 ** rng.uniform(-16, -12, n)
    bf = rng.uniform(50, 200, n)
    br = rng.uniform(0.5, 4, n)
    p = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    vc, vb, ve = (rng.uniform(-3.0, 3.0, n) for _ in range(3))
    kw_j, kw_t = {}, {}
    if early:
        vaf = np.where(rng.random(n) < 0.3, 0.0, rng.uniform(1.0, 80.0, n))
        raw = 1.0 - p * (vb - vc) / np.where(vaf > 0, vaf, 1.0)
        assert ((raw < 0.05) & (vaf > 0)).any() and (raw > 0.05).any()
        kw_j, kw_t = dict(vaf=jnp.asarray(vaf)), dict(vaf=t64(vaf))
    assert (p * (vb - ve) / 0.025852 > 41).any()
    args = (isat, bf, br, p, vc, vb, ve)
    want = jbjt.bjt_linearize(*map(jnp.asarray, args), **kw_j)
    got = bjt.bjt_linearize(*map(t64, args), **kw_t)
    # per device, against the largest of its row's entries: the constants
    # and the emitter row are differences of large terms
    for grow, wrow in zip(got, want):
        within(torch.stack(grow, -1), np.stack(wrow, -1))
    sg = bjt.bjt_stamp_vals(*map(t64, args), **kw_t)
    sj = jbjt.bjt_stamp_vals(*map(jnp.asarray, args), **kw_j)
    within(sg[0].reshape(n, 9), np.asarray(sj[0]).reshape(n, 9))
    within(sg[1].reshape(n, 3), np.asarray(sj[1]).reshape(n, 3))


def test_switch_matches_jax():
    """Control voltages below, inside and above the window, and the hard
    step of vh = 0."""
    rng = np.random.default_rng(2)
    n = 300
    ron = 10.0 ** rng.uniform(-1, 2, n)
    roff = 10.0 ** rng.uniform(6, 9, n)
    vt = rng.uniform(0.2, 0.8, n)
    vh = np.where(rng.random(n) < 0.3, 0.0, rng.uniform(0.05, 0.3, n))
    vc = rng.uniform(-0.5, 1.5, n)
    inside = (vh > 0) & (np.abs(vc - vt) < vh)
    assert inside.any() and (vh == 0).any() and (vc > vt + vh).any()
    args = (ron, roff, vt, vh, vc)
    want = jswitch.switch_conductance(*map(jnp.asarray, args))
    got = switch.switch_conductance(*map(t64, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=0)
    assert (np.asarray(want[1])[vh == 0] == 0).all()
    vp, vm, vcm = (rng.uniform(-2, 2, n) for _ in range(3))
    args = (ron, roff, vt, vh, vp, vm, vc + vcm, vcm)
    for g, w in zip(switch.switch_stamp_vals(*map(t64, args)),
                    jswitch.switch_stamp_vals(*map(jnp.asarray, args))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=RTOL * np.abs(w).max() * 1e-6)


def test_jfet_call_matches_jax():
    """The JFET stamp is the Level-1 stamp with K = 2 BETA and the signed
    VTO, N and P channel, cut off, triode and saturated."""
    rng = np.random.default_rng(3)
    n = 300
    p = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    vto = -p * rng.uniform(0.5, 3.0, n)
    beta = 10.0 ** rng.uniform(-4, -2, n)
    lam = rng.uniform(0, 0.05, n)
    vd, vg, vs = (rng.uniform(-4, 4, n) for _ in range(3))
    want = jmos.mos_stamp_vals(*map(jnp.asarray, (vto, 2.0 * beta, lam, p,
                                                  vd, vg, vs)))
    got = mosfet.mos_stamp_vals(t64(vto), 2.0 * t64(beta),
                                *map(t64, (lam, p, vd, vg, vs)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=RTOL * np.abs(w).max() * 1e-6)


def test_apply_is_temp_matches_jax():
    js = JaxSimulator.from_text(BJT_DECK)
    jp = dict(js.params)
    rng = np.random.default_rng(4)
    for key, lo, hi in (("dio_eg", 0.6, 1.2), ("dio_xti", 2, 4),
                        ("bjt_eg", 0.6, 1.2), ("bjt_xti", 2, 4)):
        jp[key] = jnp.asarray(rng.uniform(lo, hi, jp[key].shape))
    jp["dio_is"] = jnp.asarray([1e-14, 3e-12])
    jp["dio_n"] = jnp.asarray([1.0, 1.7])
    jp["dio_eg"] = jnp.asarray([1.11, 0.69])
    jp["dio_xti"] = jnp.asarray([3.0, 2.0])
    jp["vt_thermal"] = jnp.asarray(1.380649e-23 * (273.15 + 85.0)
                                   / 1.602176634e-19)
    assert jtemp.has_is_temp(jp)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    assert temp.has_is_temp(tp)
    want, got = jtemp.apply_is_temp(jp), temp.apply_is_temp(tp)
    for key in ("dio_is", "bjt_is"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=0)
        assert (np.asarray(want[key]) > 10.0 * np.asarray(jp[key])).all()
    assert not temp.has_is_temp(params_from_numpy(
        {k: np.asarray(v) for k, v in js.params.items()}))
    # lanes of temperatures against (B, n) leaves
    lanes = {k: v[None].expand((2,) + v.shape) for k, v in tp.items()}
    lanes["vt_thermal"] = torch.stack([tp["vt_thermal"],
                                       torch.tensor(0.025852,
                                                    dtype=torch.float64)])
    out = temp.apply_is_temp(lanes)
    close(out["bjt_is"][0], want["bjt_is"])
    close(out["bjt_is"][1], jp["bjt_is"])


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module", params=list(DECKS))
def pair(request):
    """(deck name, JAX simulator, port simulator, the port's params carried
    from JAX's)."""
    text = DECKS[request.param]
    js = JaxSimulator.from_text(text)
    ts = Simulator.from_text(text, device="cpu")
    tp = params_from_numpy({k: np.asarray(v) for k, v in js.params.items()})
    return request.param, js, ts, tp


def test_assembly_matches_jax(pair):
    """G and I of a DC iteration, the nonlinear stamp values, the BE matrix,
    the t = 0 state (the longer vc), the step RHS and the state update, at
    a bias where junctions sit on both sides of the exponential limit."""
    _, js, ts, tp = pair
    je, te = js.engine, ts.engine
    jp = js.params
    rng = np.random.default_rng(17)
    x = rng.uniform(-1.0, 1.2, (te.N,))
    x2 = x[::-1].copy()
    dt, t = 1e-9, 3.7e-8

    @jax.jit
    def ref(p, x, x2):
        d = jnp.asarray(dt)
        G, I = je.dc_static(p, jnp.asarray(0.3))
        s = je.init_state(x)
        return (je.assemble_dc_iter(G, I, p, x, 2.5e-6), je._nl_vals(p, x),
                je.tran_static_G(p, d, 1e-6), s,
                je.make_tran_static_I(d)(p, s, jnp.asarray(t)),
                je.make_update_state(d)(p, x2, s))

    (jG, jI), jnl, jGt, jst, jIt, jup = ref(jp, jnp.asarray(x),
                                            jnp.asarray(x2))
    d, xt = t64(dt), t64(x)
    tG, tI = te.dc_static(tp, t64(0.3))
    tG, tI = te.assemble_dc_iter(tG, tI, tp, xt, 2.5e-6)
    close(tG, jG)
    # up to the RHS's ground slot I[N], which no solve reads (the port's 0)
    close(tI[..., :te.N], jI[..., :te.N])
    for g, w in zip(te._nl_vals(tp, xt), jnl):
        close(g, w)
    close(te.tran_static_G(tp, d, 1e-6), jGt)
    st = te.init_state(xt)
    assert st["vc"].shape[-1] == te.n_caplike == je.n_caplike
    close(te.make_tran_static_I(d)(tp, st, t64(t)), jIt)
    up = te.make_update_state(d)(tp, t64(x2), st)
    for key in ("vc", "ic", "il", "vl"):
        close(st[key], jst[key])
        close(up[key], jup[key])
    carried = state_from_numpy({k: np.asarray(v) for k, v in jst.items()})
    close(te.make_tran_static_I(d)(tp, carried, t64(t)), jIt)


def test_woodbury_solve_matches_jax(pair):
    name, js, ts, tp = pair
    je, te = js.engine, ts.engine
    N, dt = je.N, 1e-9
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.5, 0.7, (N,))
    b0 = rng.standard_normal((N,))

    @jax.jit
    def ref(p, x, b0):
        # G0^-1 through LAPACK: the pivoted-LU inverse of the JAX solver is
        # held to the port's in tests/test_torch_engine.py and costs seconds
        # to compile for every deck
        G0 = je.tran_static_G(p, jnp.asarray(dt), 1e-6)[:N, :N]
        w = JaxWoodbury(je, p, solve_op=lambda B: jnp.linalg.solve(G0, B))
        z0 = w.z0(b0)
        return w.Y, z0, w.nl_coeffs(p, x), w.solve(p, x, z0)

    jY, jz0, (jv, jc), jx = ref(js.params, jnp.asarray(x), jnp.asarray(b0))
    tw = WoodburySolver(te, tp, te.tran_static_G(tp, t64(dt),
                                                 1e-6)[..., :N, :N])
    plan = tw.plan
    assert plan.W == (4 if name == "switch" else 3)
    assert plan.k == jv.shape[0] and plan.W == jv.shape[1]
    tz0 = tw.z0(t64(b0))
    tv, tc = tw.nl_coeffs(tp, t64(x))
    close(tw.Y, jY, rtol=1e-10)
    close(tz0, jz0, rtol=1e-10)
    close(tv, jv)
    close(tc, jc)
    close(tw.solve(tp, t64(x), tz0), jx, rtol=1e-10)


TEMP_DECK = """* hot junctions
.MODEL qn NPN IS=1e-15 BF=100 EG=1.11 XTI=3
V1 1 0 DC 5
R1 1 2 10k
D1 2 0 IS=1e-14 EG=1.11 XTI=3
RB 1 3 470k
RC 1 4 1k
Q1 4 3 0 qn
.TEMP 85
.op
"""


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("deck", ["diode", "mixed"])
def test_dc_matches_jax(golden, deck):
    ts = Simulator.from_text(DECKS[deck], device="cpu")
    np.testing.assert_allclose(ts.dc().numpy(), golden[f"dc_{deck}"],
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("deck,steps", [("bjt", 100), ("switch", 40)])
def test_transient_matches_jax(golden, deck, steps):
    """DC (row 0) and the deck's Backward-Euler steps: 100 on two BJTs of
    opposite polarity with junction caps; 40 (the control pulse's rise and
    plateau) on S and W switches with a MOS and a diode on the width-4
    plan."""
    want = golden[f"tran_{deck}"]
    res = Simulator.from_text(DECKS[deck], device="cpu").transient()
    assert res.n_steps == steps and not bool(res.failed)
    assert not want["failed"]
    np.testing.assert_allclose(res.xs.numpy(), want["xs"], rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(res.newton_iters.numpy(),
                                  want["newton_iters"])


# ------------------------------------------------------------- whole decks
@pytest.mark.parametrize("deck", ["bjt_amp", "chopper", "mixer_rf",
                                  "diode_temp"])
def test_example_deck_loads(golden, deck):
    """The four example decks the port refused before load and reach a
    finite operating point; chopper's (an S and a current-controlled W
    switch) is held to the JAX package's."""
    path = os.path.join(EXAMPLES, f"{deck}.sp")
    ts = Simulator.from_file(path, device="cpu")
    x = ts.dc()
    assert bool(torch.isfinite(x).all())
    if deck == "chopper":
        assert ts.topo.counts["S"] == 2
        np.testing.assert_allclose(x.numpy(), golden["dc_chopper"], rtol=0,
                                   atol=1e-9)


def test_ac_bjt_amp_matches_jax(golden):
    """The DC point, its linearisation (the BJT's Early conductance and
    junction caps) and the K3 sweep over the deck's .AC card."""
    path = os.path.join(EXAMPLES, "bjt_amp.sp")
    want = golden["ac_bjt_amp"]
    got = Simulator.from_file(path, device="cpu").ac()
    np.testing.assert_allclose(got.freqs, want["freqs"], rtol=1e-15)
    w = np.asarray(want["re"]) + 1j * np.asarray(want["im"])
    assert got.xs.shape == w.shape == (71, 7)
    assert np.abs(got.xs - w).max() <= 1e-9 * np.abs(w).max()


def test_temp_card_scales_saturation_currents(golden):
    """.TEMP with EG/XTI on the models: the port applies IS(T) as the JAX
    package does, so the operating points agree."""
    want = golden["temp"]
    ts = Simulator.from_text(TEMP_DECK, device="cpu")
    close(ts.params["dio_is"], np.asarray(want["dio_is"]))
    close(ts.params["bjt_is"], np.asarray(want["bjt_is"]))
    assert float(ts.params["dio_is"][0]) > 1e-12      # 1e-14 at 27 C
    np.testing.assert_allclose(ts.dc().numpy(), want["dc"], rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("deck", ["diode", "bjt"])
def test_batched_dc_converges_every_lane(deck):
    """The natively batched DC on perturbed junction lanes against the
    single-lane DC of each lane."""
    ts = Simulator.from_text(DECKS[deck], device="cpu")
    sig = {"res_r": 0.02, "bjt_is": 0.1, "bjt_bf": 0.1, "dio_is": 0.1,
           "sw_ron": 0.05, "jf_beta": 0.05}
    bp = tmc.perturb_params(ts.params, torch.Generator().manual_seed(9), 4,
                            sig)
    if deck == "bjt":
        assert not torch.equal(bp["bjt_is"][0], bp["bjt_is"][1])
    xb = tmc.batched_dc_fast(ts.engine, bp)
    assert bool(torch.isfinite(xb).all())
    for lane in (0, 3):
        one = ts.dc({k: v[lane] for k, v in bp.items()})
        np.testing.assert_allclose(xb[lane].numpy(), one.numpy(), rtol=0,
                                   atol=1e-9)


def make_golden():
    """Write the JAX package's whole-deck results (float64 on the CPU)
    into tests/goldens/devices_jax.json."""
    def lst(a):
        return np.asarray(a).tolist()

    out = {f"dc_{d}": lst(JaxSimulator.from_text(DECKS[d]).dc())
           for d in ("diode", "mixed")}
    for d in ("bjt", "switch"):
        r = JaxSimulator.from_text(DECKS[d]).transient()
        out[f"tran_{d}"] = {"xs": lst(r.xs),
                            "newton_iters": lst(r.newton_iters),
                            "failed": bool(np.asarray(r.failed))}
    out["dc_chopper"] = lst(JaxSimulator.from_file(
        os.path.join(EXAMPLES, "chopper.sp")).dc())
    ac = JaxSimulator.from_file(os.path.join(EXAMPLES, "bjt_amp.sp")).ac()
    xs = np.asarray(ac.xs)
    out["ac_bjt_amp"] = {"freqs": lst(ac.freqs), "re": lst(xs.real),
                         "im": lst(xs.imag)}
    js = JaxSimulator.from_text(TEMP_DECK)
    out["temp"] = {"dio_is": lst(js.params["dio_is"]),
                   "bjt_is": lst(js.params["bjt_is"]), "dc": lst(js.dc())}
    with open(GOLDEN, "w") as fh:
        json.dump(out, fh)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    make_golden()
