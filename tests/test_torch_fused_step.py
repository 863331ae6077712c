"""The fused transient chunk (K1a) of the PyTorch port on the CPU: its plain
version against the JAX Pallas kernel (interpret mode) and against the
port's own non-fused loop, the K1a gate against the JAX gate, and the
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
from circuitsimulator_tpu.parallel import montecarlo as jmc
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


def fast(opts, dtype):
    """bench.py's Monte-Carlo fast configuration."""
    return opts.replace(dtype=dtype, tran_tol=1e-5, dc_tol=1e-5,
                        tran_alpha=1.0, tran_predictor=True,
                        tran_max_newton_iters=6, tran_unrolled_iters=2)


def damped(opts, dtype):
    """The damped while-loop reference configuration at f32 tolerances."""
    return opts.replace(dtype=dtype, tran_tol=1e-5, dc_tol=1e-5)


@pytest.mark.parametrize("config", ["fast", "damped"])
def test_plain_matches_jax_pallas_kernel(config):
    """dbmixer, B = 128, 10 steps from x = 0 (tests/test_pallas_step.py
    _run_both without its XLA scan): the plain version against the JAX
    kernel in interpret mode on the same JAX-drawn lanes."""
    make = fast if config == "fast" else damped
    B, steps, dt = 128, 10, 1e-13
    path = os.path.join(NETLISTS, "dbmixer.sp")
    js = JaxSimulator.from_file(path, opts=make(JAX_OPTIONS, jnp.float32))
    jp = jmc.perturb_params(js.params, jax.random.key(0), B,
                            {"res_r": 0.01, "mos_vth": 0.02})
    je = js.engine
    x0 = jnp.zeros((B, je.N), jnp.float32)
    st0 = jax.vmap(je.init_state)(x0)
    runner = pallas_step.PallasStepRunner(je, jp, dt)
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


def _deck(name, opts):
    if name in ("dbmixer", "buffer"):
        return Simulator.from_file(os.path.join(NETLISTS, f"{name}.sp"),
                                   opts=opts, device="cpu")
    text = WAVEFORM_DECK if name == "waveform" else LINEAR_DECK
    return Simulator.from_text(text, opts=opts, device="cpu")


@pytest.mark.parametrize("deck,config,B,steps,dt", [
    ("dbmixer", "fast", 16, 100, 1e-13),
    ("dbmixer", "damped", 16, 100, 1e-13),
    ("buffer", "damped", 8, 100, 1e-9),
    ("waveform", "damped", 8, 50, 2e-9),
    ("linear", "damped", 8, 50, 2e-9),
])
def test_plain_matches_nonfused_f64(deck, config, B, steps, dt):
    """f64 from the batched DC point: the plain version of the fused chunk
    against the port's non-fused loop on the same lanes, within 1e-9 V,
    with the same failed masks and per-lane Newton iteration counts."""
    opts = (fast(DEFAULT_OPTIONS, torch.float64) if config == "fast"
            else DEFAULT_OPTIONS)
    sim = _deck(deck, opts)
    assert fused_step.supported(sim.engine, dt)
    bp = tmc.perturb_params(sim.params, torch.Generator().manual_seed(3), B,
                            SIGMAS)
    carry, advance, _ = tmc.make_fused_transient_fn(sim.engine, bp, dt,
                                                    chunk=steps)
    (x, xp, vc, il, failed), iters = advance(carry, 0, steps)
    ref = tmc.init_carry(sim.engine, carry[0])
    ts = torch.arange(1, steps + 1, dtype=torch.float64) * dt
    ref, ref_iters = tmc.batched_transient_chunk(sim.engine, bp, ref, ts, dt)
    np.testing.assert_allclose(x.numpy(), ref[0].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(vc.numpy(), ref[-2]["vc"].numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(il.numpy(), ref[-2]["il"].numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(failed.numpy(), ref[-1].numpy())
    np.testing.assert_array_equal(iters.numpy(), ref_iters.numpy())


@pytest.mark.parametrize("deck,expect", [
    ("buffer", True), ("dbmixer", True), ("inamp", False),
    ("waveform", True), ("linear", True),
])
def test_gate_implies_jax_gate(deck, expect):
    if deck in ("buffer", "dbmixer", "inamp"):
        path = os.path.join(NETLISTS, f"{deck}.sp")
        js = JaxSimulator.from_file(path)
        ts = Simulator.from_file(path, device="cpu")
    else:
        text = WAVEFORM_DECK if deck == "waveform" else LINEAR_DECK
        js = JaxSimulator.from_text(text)
        ts = Simulator.from_text(text, device="cpu")
    ours = fused_step.supported(ts.engine, 1e-9)
    assert ours == expect
    assert not ours or pallas_step.supported(js.engine, 1e-9)
    if deck == "inamp":
        assert "k = 22" in fused_step.unsupported_reason(ts.engine, 1e-9)


@pytest.fixture
def no_cuda_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA kernel was reached on the CPU")

    monkeypatch.setattr(cuda_step, "run_chunk_cuda", refuse)
    monkeypatch.setattr(cuda_step, "_fn", refuse)


def test_dispatch_on_cpu(no_cuda_kernel):
    """fused="auto" on CPU tensors takes the non-fused loop, fused=True the
    kernel's plain version; both agree and neither reaches the kernel."""
    sim = _deck("dbmixer", DEFAULT_OPTIONS)
    bp = tmc.perturb_params(sim.params, torch.Generator().manual_seed(5), 4,
                            SIGMAS)
    dt, n = 1e-13, 20
    auto = tmc.batched_transient(sim.engine, bp, dt, n * dt)
    assert auto.xs is None and tuple(auto.newton_iters.shape) == (n, 4)
    forced = tmc.batched_transient(sim.engine, bp, dt, n * dt, fused=True)
    assert forced.xs is None and tuple(forced.newton_iters.shape) == (4,)
    np.testing.assert_allclose(forced.x_final.numpy(), auto.x_final.numpy(),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(forced.newton_iters.numpy(),
                                  auto.newton_iters.sum(0).numpy())
    saved = tmc.batched_transient(sim.engine, bp, dt, n * dt, save_xs=True)
    assert tuple(saved.xs.shape) == (n + 1, 4, sim.engine.N)


@pytest.mark.parametrize("deck,what", [
    ("inamp", "k = 22"),
    ("* pwl\nV1 1 0 PWL(0 0 1n 1 2n 0 3n 1 4n 0 5n 1 6n 0 7n 1 8n 0)\n"
     "R1 1 0 1k\n.op\n", "PWL"),
])
def test_out_of_scope_fused_raises_by_name(no_cuda_kernel, deck, what):
    if deck == "inamp":
        sim = Simulator.from_file(os.path.join(NETLISTS, "inamp.sp"),
                                  device="cpu")
    else:
        sim = Simulator.from_text(deck, device="cpu")
    bp = tmc.broadcast_params(sim.params, 2)
    with pytest.raises(NotImplementedError, match=what):
        tmc.batched_transient(sim.engine, bp, 1e-9, 1e-8, fused=True)
