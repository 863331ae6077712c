"""The fused transient chunk (K1, scopes K1a, K1b and K1d-i) of the PyTorch
port on the CPU: its plain version against the JAX Pallas kernel
(interpret mode) and against the port's own non-fused loop, on MOS decks,
on the junction and switch decks, on the charge-model decks and on the
rank-22 inamp (the Gauss-Jordan branch); the gate against the JAX gate; the
``batched_transient`` dispatch."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.ops import pallas_step
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.ops import cuda_step, fused_step
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETLISTS = os.path.join(REPO, "tests", "netlists")
SIGMAS = {"res_r": 0.01, "mos_vth": 0.02, "cap_c": 0.02}

# the decks of tests/test_pallas_step.py: every waveform kind with a MOS
# load, and a fully linear RLC deck (k = 0)
WAVEFORM_DECK = """* all source kinds
.MODEL 2 VT 0.386 MU 3.0238e-2 COX 6.058e-3 LAMBDA 0.05 CJ0 4.0e-14
VDD 1 0 DC 3
Vp 2 0 PULSE(0 1.5 10n 5n 5n 40n 100n)
Vw 3 0 PWL(0 0 20n 1 50n 0.4 80n 1.2)
Ve 4 0 EXP(0 2 5n 10n 60n 15n)
Rp 2 5 1k
Rw 3 5 2k
Re 4 5 2k
Is 0 5 SFFM(1m 0.5m 2e7 2 3e6)
Ip 0 6 PULSE(0 1m 0 0 0 50n 120n)
R6 6 0 1k
M1 7 5 0 n 10e-6 0.35e-6 2
RL 1 7 2k
C1 7 0 1p
.op
"""

LINEAR_DECK = """* linear RLC filter
V1 in 0 SIN 0 1 2e6
I1 0 mid PULSE(0 1m 0 0 0 100n 250n)
R1 in a 1k
L1 a mid 10u
C1 mid 0 100p
R2 mid out 2k
C2 out 0 50p
RL out 0 10k
.op
"""


# the junction and switch decks of tests/test_pallas_step.py, with the
# timestep, step count and f32 tolerance of its cases
DIODE_DECK = """* diode rectifier + zener
V1 in 0 SIN 0 4 5e6
R1 in a 100
D1 a out
C1 out 0 1n
R2 out 0 10k
RBD in bd 500
D2 0 bd BV=3 IBV=1e-3
.op
"""

BJT_DECK = """* npn + pnp stages
.MODEL qn NPN IS=1e-15 BF=120 BR=2 VAF=50
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
.op
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
D1 6 0
RD 1 6 1k
C1 3 0 1p
.op
"""

SWITCH_DECK = """* switch chopper + mixed classes
.MODEL swm SW RON=10 ROFF=1e8 VT=0.5 VH=0.1
.MODEL mn VT 0.6 MU 2e-2 COX 1e-3
VCTL c 0 PULSE 0 1 0 1u 1u 8u 20u
VIN in 0 SIN 0 2 5e4
S1 in mid c 0 swm
RL mid 0 1k
C1 mid 0 100n
M1 mid g 0 b mn W=5u L=1u
VG g 0 0.8
D1 mid 0
.op
"""

# the 2-MOS stage under the charge model (tests/test_pallas_step.py): rank
# 2 + 10 charge rows = 12, the elimination branch with charge rows
CHARGE_DECK = """* charge-model CMOS stage
.OPTIONS MOSCAP=CHARGE
.MODEL 1 VT -0.75 MU 5e-2 COX 0.3e-4 LAMBDA 0.05 CJ0 4.0e-14
.MODEL 2 VT 0.83 MU 1.5e-1 COX 0.3e-4 LAMBDA 0.05 CJ0 4.0e-14
VDD 1 0 3
Vin 2 0 SIN 1.5 0.5 5e6
M1 3 2 1 p 30e-6 0.35e-6 1
M2 3 2 0 n 10e-6 0.35e-6 2
C1 3 0 0.5p
RL 3 0 10k
.op
"""

# the start point that two runs under test share needs no reference-grade
# DC: three source-ramp steps to 1e-7 V land within 2e-7 V of the
# reference's ten to 1e-9 V, at a third of the Newton iterations
START_DC = {"ramp_steps": 3, "dc_tol": 1e-7}

K1B = {"diode": (DIODE_DECK, 1e-9, 6, 5e-6),
       "bjt": (BJT_DECK, 1e-9, 6, 1e-4),
       "mixed": (MIXED_DECK, 1e-9, 6, 1e-4),
       "switch": (SWITCH_DECK, 1e-7, 12, 1e-4)}
K1B_SIGMAS = {**SIGMAS, "bjt_is": 0.05, "bjt_bf": 0.05, "dio_is": 0.05,
              "sw_ron": 0.02}


def fast(opts, dtype):
    """bench.py's Monte-Carlo fast configuration."""
    return opts.replace(dtype=dtype, tran_tol=1e-5, dc_tol=1e-5,
                        tran_alpha=1.0, tran_predictor=True,
                        tran_max_newton_iters=6, tran_unrolled_iters=2)


def damped(opts, dtype):
    """The damped while-loop reference configuration at f32 tolerances."""
    return opts.replace(dtype=dtype, tran_tol=1e-5, dc_tol=1e-5)


def draw_lanes(params, B, seed=0, sigmas=(("res_r", 0.01), ("mos_vth", 0.02))):
    """B lanes of the JAX params with lognormal factors on the named leaves,
    drawn with numpy (``jmc.perturb_params`` run eagerly costs a second and
    a half of small compiles per deck)."""
    rng = np.random.default_rng(seed)
    out = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
           for k, v in params.items()}
    for key, sigma in sigmas:
        out[key] = out[key] * np.exp(sigma * rng.standard_normal(
            out[key].shape)).astype(out[key].dtype)
    return {k: jnp.asarray(v) for k, v in out.items()}


def jax_runner(engine, bparams, dt, **kw):
    """``PallasStepRunner(engine, bparams, dt, **kw)`` with its constructor
    run under one ``jax.jit`` trace.  Run eagerly, the constructor dispatches a
    few hundred small operations (the unrolled G0 inverse among them), each
    compiled on its own: 10-15 s per deck on the CPU against 1-2 s for the
    one traced computation.  The arrays it builds are the same to f32
    rounding; the static plan (k, W, index operators) is untouched."""
    made = []

    def build(p):
        made.append(pallas_step.PallasStepRunner(engine, p, dt, **kw))
        return {k: v for k, v in vars(made[-1]).items()
                if isinstance(v, jax.Array)}

    arrays = jax.jit(build)(bparams)
    vars(made[-1]).update(arrays)
    return made[-1]


@pytest.mark.parametrize("config", ["fast", "damped"])
def test_plain_matches_jax_pallas_kernel(config):
    """dbmixer, B = 128, 4 steps from x = 0 (tests/test_pallas_step.py
    _run_both without its XLA scan): the plain version against the JAX
    kernel in interpret mode on the same lanes."""
    make = fast if config == "fast" else damped
    B, steps, dt = 128, 4, 1e-13
    path = os.path.join(NETLISTS, "dbmixer.sp")
    js = JaxSimulator.from_file(path, opts=make(JAX_OPTIONS, jnp.float32))
    jp = draw_lanes(js.params, B)
    je = js.engine
    x0 = jnp.zeros((B, je.N), jnp.float32)
    st0 = jax.jit(jax.vmap(je.init_state))(x0)
    runner = jax_runner(je, jp, dt)
    want = runner.run_chunk(x0, x0, st0["vc"], st0["il"],
                            jnp.zeros((B,), bool), 0, steps, interpret=True)
    want = [np.asarray(a) for a in want]

    ts = Simulator.from_file(path, device="cpu",
                             opts=make(DEFAULT_OPTIONS, torch.float32))
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()},
                           dtype=torch.float32)
    tr = fused_step.FusedStepRunner(ts.engine, tp, dt)
    x = torch.zeros((B, ts.engine.N), dtype=torch.float32)
    st = ts.engine.init_state(x)
    got = tr.run_chunk_plain(x, x, st["vc"], st["il"],
                             torch.zeros((B,), dtype=torch.bool), 0, steps)
    xo, _, vco, ilo, fo, iters = (a.numpy() for a in got)
    np.testing.assert_allclose(xo, want[0], rtol=0, atol=5e-6)
    np.testing.assert_allclose(vco, want[2], rtol=0, atol=5e-6)
    np.testing.assert_allclose(ilo, want[3], rtol=0, atol=5e-6)
    np.testing.assert_array_equal(fo, want[4])
    if config == "fast":
        np.testing.assert_array_equal(iters, np.full(B, 2 * steps))
    else:
        assert iters.min() > 0


def dc_points(text, jp, opts=DEFAULT_OPTIONS):
    """The lanes' operating points from the port's float64 batched DC, as
    float32 numpy: both kernels start there (the float32 DC leaves about 1%
    of a BJT deck's lanes unconverged, in both packages), computed with
    START_DC: the points are only shared starting values."""
    sim = Simulator.from_text(text, opts=opts.replace(**START_DC),
                              device="cpu")
    x0 = tmc.batched_dc_fast(sim.engine, params_from_numpy(
        {k: np.array(v) for k, v in jp.items()}))
    return x0.numpy().astype(np.float32)


@pytest.mark.parametrize("deck", list(K1B))
def test_plain_matches_jax_pallas_kernel_k1b(deck):
    """The junction and switch decks from the DC operating point (a
    junction at 1e5 S amplifies an f32 ULP to volts from x = 0), B = 128,
    f32 damped: the plain version against the JAX kernel in interpret mode
    on the same lanes from the same DC points (the port's f64 batched DC),
    at the tolerances the JAX tests hold their kernel to."""
    text, dt, steps, tol = K1B[deck]
    B = 128
    js = JaxSimulator.from_text(text, opts=damped(JAX_OPTIONS, jnp.float32))
    jp = draw_lanes(js.params, B)
    je = js.engine
    x0 = jnp.asarray(dc_points(text, jp))
    st0 = jax.jit(jax.vmap(je.init_state))(x0)
    runner = jax_runner(je, jp, dt)
    want = runner.run_chunk(x0, x0, st0["vc"], st0["il"],
                            jnp.zeros((B,), bool), 0, steps, interpret=True)
    want = [np.asarray(a) for a in want]

    ts = Simulator.from_text(text, device="cpu",
                             opts=damped(DEFAULT_OPTIONS, torch.float32))
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()},
                           dtype=torch.float32)
    tr = fused_step.FusedStepRunner(ts.engine, tp, dt)
    assert (tr.k, tr.W) == (runner.k, runner.W)
    x = torch.as_tensor(np.array(x0))
    st = ts.engine.init_state(x)
    np.testing.assert_allclose(st["vc"].numpy(), np.asarray(st0["vc"]),
                               rtol=0, atol=1e-6)
    got = tr.run_chunk_plain(x, x, st["vc"], st["il"],
                             torch.zeros((B,), dtype=torch.bool), 0, steps)
    xo, _, vco, ilo, fo, iters = (a.numpy() for a in got)
    np.testing.assert_allclose(xo, want[0], rtol=0, atol=tol)
    np.testing.assert_allclose(vco, want[2], rtol=0, atol=tol)
    np.testing.assert_allclose(ilo, want[3], rtol=0, atol=tol)
    np.testing.assert_array_equal(fo, want[4])
    assert not fo.any() and iters.min() > 0


@pytest.mark.parametrize("deck", ["charge", "buffer-charge"])
def test_plain_matches_jax_pallas_kernel_k1d(deck):
    """K1d-i on the charge-model decks, B = 128, 4 steps, f32 damped: the
    plain version against the JAX kernel in interpret mode on the same lanes
    within 1e-4 V (the bar of tests/test_pallas_step.py: 1/dt = 1e9 scales
    the charge rows' rounding).  The 2-MOS stage (k = 12, elimination with
    charge rows) starts from the port's f64 DC point; buffer.sp under the
    charge model (k = 24, Gauss-Jordan with charge rows) starts from x = 0:
    from its DC point the output sits at ~1e-16 V, where the Ward-Dutton
    triode-charge Jacobian loses every digit (ROADMAP queue 3) and both
    kernels fail every lane at the first iteration in f32."""
    B, steps, dt = 128, 4, 1e-9
    jo = damped(JAX_OPTIONS, jnp.float32).replace(mos_cap_model="charge")
    to = damped(DEFAULT_OPTIONS, torch.float32).replace(mos_cap_model="charge")
    if deck == "charge":
        js = JaxSimulator.from_text(CHARGE_DECK, opts=jo)
        ts = Simulator.from_text(CHARGE_DECK, opts=to, device="cpu")
    else:
        path = os.path.join(NETLISTS, "buffer.sp")
        js = JaxSimulator.from_file(path, opts=jo)
        ts = Simulator.from_file(path, opts=to, device="cpu")
    je = js.engine
    jp = draw_lanes(js.params, B)
    if deck == "charge":
        x0 = jnp.asarray(dc_points(CHARGE_DECK, jp))
    else:
        x0 = jnp.zeros((B, je.N), jnp.float32)
    # both kernels take vc and il of the port's init_state (the JAX one
    # would trace the charge model's jvp for qm, which K1 does not read)
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()},
                           dtype=torch.float32)
    x = torch.as_tensor(np.array(x0))
    st = ts.engine.init_state(x, tp)
    runner = jax_runner(je, jp, dt)
    want = runner.run_chunk(x0, x0, jnp.asarray(st["vc"].numpy()),
                            jnp.asarray(st["il"].numpy()),
                            jnp.zeros((B,), bool), 0, steps, interpret=True)
    want = [np.asarray(a) for a in want]

    tr = fused_step.FusedStepRunner(ts.engine, tp, dt)
    assert (tr.k, tr.W, tr.nCq) == (runner.k, runner.W, runner.nCq)
    assert tr.k == (12 if deck == "charge" else 24)
    got = tr.run_chunk_plain(x, x, st["vc"], st["il"],
                             torch.zeros((B,), dtype=torch.bool), 0, steps)
    xo, _, vco, ilo, fo, iters = (a.numpy() for a in got)
    np.testing.assert_allclose(xo, want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(vco, want[2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ilo, want[3], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(fo, want[4])
    assert not fo.any() and iters.min() > 0


def _deck(name, opts):
    if name.endswith("-charge"):
        opts = opts.replace(mos_cap_model="charge")
        name = name[:-len("-charge")]
    if name == "charge":
        return Simulator.from_text(CHARGE_DECK, opts=opts, device="cpu")
    if name in ("dbmixer", "buffer", "inamp"):
        return Simulator.from_file(os.path.join(NETLISTS, f"{name}.sp"),
                                   opts=opts, device="cpu")
    if name in K1B:
        return Simulator.from_text(K1B[name][0], opts=opts, device="cpu")
    text = WAVEFORM_DECK if name == "waveform" else LINEAR_DECK
    return Simulator.from_text(text, opts=opts, device="cpu")


@pytest.mark.parametrize("deck,config,B,steps,dt", [
    ("dbmixer", "fast", 8, 20, 1e-13),
    ("dbmixer", "damped", 8, 20, 1e-13),
    ("buffer", "damped", 4, 20, 1e-9),
    ("waveform", "damped", 4, 25, 2e-9),
    ("linear", "damped", 4, 25, 2e-9),
    ("diode", "damped", 8, 6, 1e-9),
    ("bjt", "damped", 8, 6, 1e-9),
    ("mixed", "damped", 8, 6, 1e-9),
    ("switch", "damped", 8, 12, 1e-7),
    ("charge", "damped", 4, 4, 1e-9),
    ("inamp", "damped", 4, 3, 1e-9),
    ("buffer-charge", "tight", 4, 3, 1e-9),
])
def test_plain_matches_nonfused_f64(deck, config, B, steps, dt):
    """f64 from the batched DC point (START_DC): the plain
    version of the fused chunk against the port's non-fused loop on the
    same lanes, within 1e-9 V, with the same failed masks and per-lane
    Newton iteration counts.  inamp (k = 22) takes the Gauss-Jordan branch
    against the non-fused LU.  The
    "tight" configuration (tran_tol 1e-13, 100 iterations) holds buffer.sp
    under the charge model (k = 24) to the same 1e-9 V: at the default
    1e-6 its damped Newton stops on a path that depends on rounding (the
    triode-charge Jacobian has no correct digit at its output's ~1e-16 V
    drain, ROADMAP queue 3), so there the iteration counts are not
    compared."""
    opts = (fast(DEFAULT_OPTIONS, torch.float64) if config == "fast"
            else DEFAULT_OPTIONS)
    if config == "tight":
        opts = opts.replace(tran_tol=1e-13, tran_max_newton_iters=100)
    # both runs start from the same point (START_DC)
    sim = _deck(deck, opts.replace(
        ramp_steps=START_DC["ramp_steps"],
        dc_tol=max(opts.dc_tol, START_DC["dc_tol"])))
    assert fused_step.supported(sim.engine, dt)
    bp = tmc.perturb_params(sim.params, torch.Generator().manual_seed(3), B,
                            K1B_SIGMAS)
    carry, advance, _ = tmc.make_fused_transient_fn(sim.engine, bp, dt,
                                                    chunk=steps)
    (x, xp, vc, il, failed), iters = advance(carry, 0, steps)
    ref = tmc.init_carry(sim.engine, carry[0], bp)
    ts = torch.arange(1, steps + 1, dtype=torch.float64) * dt
    ref, ref_iters = tmc.batched_transient_chunk(sim.engine, bp, ref, ts, dt)
    np.testing.assert_allclose(x.numpy(), ref[0].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(vc.numpy(), ref[-2]["vc"].numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(il.numpy(), ref[-2]["il"].numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(failed.numpy(), ref[-1].numpy())
    assert not failed.any()
    if config != "tight":
        np.testing.assert_array_equal(iters.numpy(), ref_iters.numpy())


@pytest.mark.parametrize("deck,expect", [
    ("buffer", True), ("dbmixer", True), ("inamp", True),
    ("waveform", True), ("linear", True), ("diode", True), ("bjt", True),
    ("mixed", True), ("switch", True), ("bjt_amp", True), ("chopper", True),
    ("mixer_rf", True), ("charge", True), ("buffer-charge", True),
    ("dbmixer-charge", False),
])
def test_gate_implies_jax_gate(deck, expect):
    name = deck.split("-")[0]
    opts = {}
    if deck.endswith("-charge"):
        opts = {"mos_cap_model": "charge"}
    if name in ("buffer", "dbmixer", "inamp", "bjt_amp", "chopper",
                "mixer_rf"):
        folder = NETLISTS if name in ("buffer", "dbmixer", "inamp") \
            else os.path.join(REPO, "examples")
        path = os.path.join(folder, f"{name}.sp")
        js = JaxSimulator.from_file(path, opts=JAX_OPTIONS.replace(**opts))
        ts = Simulator.from_file(path, opts=DEFAULT_OPTIONS.replace(**opts),
                                 device="cpu")
    else:
        text = {"waveform": WAVEFORM_DECK, "linear": LINEAR_DECK,
                "charge": CHARGE_DECK}.get(name) or K1B[name][0]
        js = JaxSimulator.from_text(text)
        ts = Simulator.from_text(text, device="cpu")
    ours = fused_step.supported(ts.engine, 1e-9)
    assert ours == expect
    assert not ours or pallas_step.supported(js.engine, 1e-9)
    assert ts.engine.mos_charge == js.engine.mos_charge
    if deck == "dbmixer-charge":
        assert "k = 36 > 32" in fused_step.unsupported_reason(ts.engine,
                                                              1e-9)


@pytest.fixture
def no_cuda_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA kernel was reached on the CPU")

    monkeypatch.setattr(cuda_step, "run_chunk_cuda", refuse)
    monkeypatch.setattr(cuda_step, "_fn", refuse)


def test_dispatch_on_cpu(no_cuda_kernel):
    """fused="auto" on CPU tensors takes the non-fused loop, fused=True the
    kernel's plain version; both agree and neither reaches the kernel."""
    sim = _deck("dbmixer", DEFAULT_OPTIONS.replace(**START_DC))
    bp = tmc.perturb_params(sim.params, torch.Generator().manual_seed(5), 4,
                            SIGMAS)
    dt, n = 1e-13, 4
    # the three runs start from the same operating points (one batched DC,
    # not three)
    x0 = tmc.batched_dc_fast(sim.engine, bp)
    auto = tmc.batched_transient(sim.engine, bp, dt, n * dt, x0=x0)
    assert auto.xs is None and tuple(auto.newton_iters.shape) == (n, 4)
    forced = tmc.batched_transient(sim.engine, bp, dt, n * dt, fused=True,
                                   x0=x0)
    assert forced.xs is None and tuple(forced.newton_iters.shape) == (4,)
    np.testing.assert_allclose(forced.x_final.numpy(), auto.x_final.numpy(),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(forced.newton_iters.numpy(),
                                  auto.newton_iters.sum(0).numpy())
    saved = tmc.batched_transient(sim.engine, bp, dt, n * dt, save_xs=True,
                                  x0=x0)
    assert tuple(saved.xs.shape) == (n + 1, 4, sim.engine.N)


@pytest.mark.parametrize("deck,what", [
    ("dbmixer-charge", "k = 36 > 32"),
    ("* pwl\nV1 1 0 PWL(0 0 1n 1 2n 0 3n 1 4n 0 5n 1 6n 0 7n 1 8n 0)\n"
     "R1 1 0 1k\n.op\n", "PWL"),
])
def test_out_of_scope_fused_raises_by_name(no_cuda_kernel, deck, what):
    if deck == "dbmixer-charge":
        sim = _deck(deck, DEFAULT_OPTIONS)
    else:
        sim = Simulator.from_text(deck, device="cpu")
    bp = tmc.broadcast_params(sim.params, 2)
    with pytest.raises(NotImplementedError, match=what):
        tmc.batched_transient(sim.engine, bp, 1e-9, 1e-8, fused=True)


def test_k1a_plain_output_is_unchanged_by_the_row_plan():
    """dbmixer keeps the width-3 layout: W = 3, the (W, k) column plan is
    the MOS (d, g, s) plan, the junction packs are empty, and the plain
    chunk is bitwise the one-class computation (the MOS linearisation, the
    width-3 S and vz sums) written out here."""
    from circuitsimulator_tpu_torch.models.mosfet import mos_linearize
    from circuitsimulator_tpu_torch.ops.lu import lu_solve_plain
    sim = _deck("dbmixer", fast(DEFAULT_OPTIONS, torch.float32))
    t = sim.topo
    bp = tmc.perturb_params(sim.params, torch.Generator().manual_seed(3), 4,
                            SIGMAS)
    r = fused_step.FusedStepRunner(sim.engine, bp, 1e-13)
    assert (r.W, r.k, r.nMJ, r.nD, r.nQ, r.nSw) == (3, 6, 6, 0, 0, 0)
    np.testing.assert_array_equal(
        r.row_cols.numpy(), np.stack([t.mos_ed, t.mos_eg, t.mos_es]))
    assert tuple(r.Yc3.shape) == (3, 6, 6, 4)
    assert r.diop.numel() == r.bjtp.numel() == r.swp.numel() == 0
    x = torch.zeros((4, r.N), dtype=torch.float32)
    st = sim.engine.init_state(x)
    nofail = torch.zeros((4,), dtype=torch.bool)
    got = r.run_chunk_plain(x, x, st["vc"], st["il"], nofail, 0, 1)
    # one step of two undamped iterations from x = 0, sources at t = dt
    zcol = torch.zeros((4, 1))
    cols = r.row_cols.long()
    vth, kk, lam, pp = (p.T for p in r.mosp)
    b = torch.zeros((4, r.N + 1))
    sv = fused_step.srcmod.eval_tran_masked(
        r.src_masks, r.src[0].T, *(a.permute(2, 1, 0) for a in r.src[1:5]),
        r.src[5].T, torch.tensor(1.0) * r.dt_t)
    h = r.gc.T * st["vc"]
    b.index_add_(1, r._rhs_rows,
                 torch.cat([sv, -sv, -(r.gl.T * st["il"]), h, -h], 1))
    z0 = torch.einsum("mnb,bm->bn", r.G0invT, b[:, :r.N])
    xx = x
    for _ in range(2):
        xe = torch.cat([xx, zcol], 1)
        gd, gg, gs, cst = mos_linearize(vth, kk, lam, pp, xe[:, cols[0]],
                                        xe[:, cols[1]], xe[:, cols[2]],
                                        r.off_gds)
        z = z0 - torch.einsum("jnb,bj->bn", r.YT, cst)
        v = torch.stack([gd, gg, gs])
        S = torch.eye(6) + torch.einsum("sbj,sjlb->bjl", v, r.Yc3)
        ze = torch.cat([z, zcol], 1)
        vz = (v * torch.stack([ze[:, c] for c in cols])).sum(0)
        xx = z - torch.einsum("jnb,bj->bn", r.YT, lu_solve_plain(S, vz, 0.0))
    assert torch.equal(got[0], xx)
