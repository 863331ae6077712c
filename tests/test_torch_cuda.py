"""Tests of the PyTorch port that need an NVIDIA GPU (marked ``cuda``; they
skip without one).  This file imports no JAX, so it also runs where JAX is
not installed; run it there without the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import copy
import os

import numpy as np
import pytest
import torch

from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.ops import cuda_lu
from circuitsimulator_tpu_torch.ops import lu as tlu

FLOOR = 1e-15
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def lane_masks(x):
    """(all-zero lanes, lanes holding a NaN): the fail and NaN contracts."""
    flat = x.reshape(x.shape[0], -1)
    return np.all(flat == 0.0, axis=1), np.any(np.isnan(flat), axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 7, 300])
@pytest.mark.parametrize("R", ["1", "3", "N"])
@pytest.mark.parametrize("n", [1, 8, 9, 16, 17, 31, 32, 33, 64])
def test_lu_kernel_matches_plain(cuda_device, dtype, B, n, R):
    # every team capacity (8, 16, 32, 64) and its edges
    R = n if R == "N" else int(R)
    rng = np.random.default_rng(n + R)
    A = rng.standard_normal((B, n, n)) + 2.0 * np.sqrt(n) * np.eye(n)
    A = A[:, ::-1].copy()                   # every lane pivots
    b = rng.standard_normal((B, n, R))
    if B > 4:
        A[1] = 0.0                          # singular -> zeros
        A[2] *= 1e-17                       # below the pivot floor -> zeros
        A[3, 0, 0] = np.nan                 # NaN propagates
    At = torch.as_tensor(A, dtype=dtype, device=cuda_device)
    bt = torch.as_tensor(b, dtype=dtype, device=cuda_device)
    A0, b0 = At.cpu().numpy(), bt.cpu().numpy()
    before = cuda_lu.LAUNCHES
    x = tlu.lu_solve(At, bt, FLOOR)
    torch.cuda.synchronize()
    assert cuda_lu.LAUNCHES == before + 1
    # the kernel reads A and b in place and writes neither
    np.testing.assert_array_equal(At.cpu().numpy(), A0)
    np.testing.assert_array_equal(bt.cpu().numpy(), b0)
    ref = tlu.lu_solve_plain(At, bt, FLOOR)
    x, ref = x.cpu().numpy(), ref.cpu().numpy()
    for got, want in zip(lane_masks(x), lane_masks(ref)):
        np.testing.assert_array_equal(got, want)
    if B > 4:
        assert lane_masks(x)[0][[1, 2]].all() and lane_masks(x)[1][3]
    good = ~(lane_masks(ref)[0] | lane_masks(ref)[1])
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(x[good], ref[good], rtol=tol, atol=tol)
    if R > 1:
        # one factorisation, R columns: each bitwise a single-RHS solve
        one = tlu.lu_solve(At, bt[..., -1:].contiguous(), FLOOR)
        np.testing.assert_array_equal(x[..., -1:], one.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lu_kernel_strided_and_broadcast_inputs(cuda_device, dtype):
    # ops/lu.py makes a strided or broadcast input contiguous before the
    # kernel reads it: the answers are the plain version's
    rng = np.random.default_rng(5)
    n = 13
    A = rng.standard_normal((40, n, n)) + 2.0 * np.sqrt(n) * np.eye(n)
    b = rng.standard_normal((40, n, 3))
    At = torch.as_tensor(A, dtype=dtype, device=cuda_device)
    bt = torch.as_tensor(b, dtype=dtype, device=cuda_device)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    cases = [(At.transpose(-1, -2), bt[:, :, 1]),           # strided
             (At[:1].expand(40, n, n), bt),                 # broadcast A
             (At[::2], bt[::2, :, ::2]),                     # every other lane
             (At[0], bt),                                   # one A, many b
             (At, bt[:1].expand(40, n, 3))]                  # broadcast b
    for Ac, bc in cases:
        before = cuda_lu.LAUNCHES
        x = tlu.lu_solve(Ac, bc, FLOOR)
        torch.cuda.synchronize()
        assert cuda_lu.LAUNCHES == before + 1
        ref = tlu.lu_solve_plain(Ac, bc, FLOOR)
        assert x.shape == ref.shape
        np.testing.assert_allclose(x.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
def test_batched_dbmixer_cuda_matches_cpu(cuda_device):
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    deck = os.path.join(REPO, "tests", "netlists", "dbmixer.sp")
    cpu = Simulator.from_file(deck, device="cpu")
    gpu = Simulator.from_file(deck, device=cuda_device)
    g = torch.Generator().manual_seed(1)
    bp = mc.perturb_params(cpu.params, g, 4,
                           {"res_r": 0.01, "mos_vth": 0.02, "cap_c": 0.02})
    bpg = {k: v.to(cuda_device) for k, v in bp.items()}
    x0c = mc.batched_dc_fast(cpu.engine, bp)
    x0g = mc.batched_dc_fast(gpu.engine, bpg)
    np.testing.assert_allclose(x0g.cpu().numpy(), x0c.numpy(), rtol=0,
                               atol=1e-9)
    ts = torch.arange(1, 51, dtype=torch.float64) * 1e-13
    cc, _ = mc.batched_transient_chunk(cpu.engine, bp,
                                       mc.init_carry(cpu.engine, x0c), ts,
                                       1e-13)
    cg, _ = mc.batched_transient_chunk(gpu.engine, bpg,
                                       mc.init_carry(gpu.engine, x0g),
                                       ts.to(cuda_device), 1e-13)
    np.testing.assert_allclose(cg[0].cpu().numpy(), cc[0].numpy(), rtol=0,
                               atol=1e-9)


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


@pytest.mark.cuda
@pytest.mark.parametrize("deck,dtype", [
    ("dbmixer", torch.float32), ("dbmixer", torch.float64),
    ("linear", torch.float64)])
def test_fused_step_kernel_matches_plain(cuda_device, deck, dtype):
    """K1 against its plain version on the same card and inputs: 64 lanes,
    30 steps from the batched DC point (f32: bench.py's fast
    configuration; f64: the damped reference configuration)."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)
    if dtype == torch.float32:
        opts = opts.replace(tran_tol=1e-5, dc_tol=1e-5, tran_alpha=1.0,
                            tran_predictor=True, tran_max_newton_iters=6,
                            tran_unrolled_iters=2)
    if deck == "dbmixer":
        sim = Simulator.from_file(
            os.path.join(REPO, "tests", "netlists", "dbmixer.sp"), opts=opts,
            device=cuda_device)
        dt = 1e-13
    else:
        sim = Simulator.from_text(LINEAR_DECK, opts=opts, device=cuda_device)
        dt = 2e-9
    g = torch.Generator(device=cuda_device).manual_seed(2)
    bp = mc.perturb_params(sim.params, g, 64,
                           {"res_r": 0.01, "mos_vth": 0.02, "cap_c": 0.02})
    carry, advance, meta = mc.make_fused_transient_fn(sim.engine, bp, dt)
    before = cuda_step.LAUNCHES
    got, it = advance(carry, 0, 30)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES == before + 1
    ref = meta["runner"].run_chunk_plain(*carry, 0, 30)
    tol = 1e-4 if dtype == torch.float32 else 1e-9
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)
    np.testing.assert_array_equal(got[4].cpu().numpy(), ref[4].cpu().numpy())
    if dtype == torch.float32:
        np.testing.assert_array_equal(it.cpu().numpy(),
                                      ref[5].cpu().numpy())


# the junction and switch decks of tests/test_pallas_step.py
K1B_DECKS = {
    "diode": ("""* diode rectifier + zener
V1 in 0 SIN 0 4 5e6
R1 in a 100
D1 a out
C1 out 0 1n
R2 out 0 10k
RBD in bd 500
D2 0 bd BV=3 IBV=1e-3
.op
""", 1e-9, 6),
    "bjt": ("""* npn + pnp stages
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
""", 1e-9, 6),
    "mixed": ("""* mixed nonlinear classes
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
""", 1e-9, 6),
    "switch": ("""* switch chopper + mixed classes
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
""", 1e-7, 12),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("deck", list(K1B_DECKS))
def test_fused_step_kernel_matches_plain_k1b(cuda_device, deck, dtype):
    """K1's junction and switch rows against the plain version on the same
    card and inputs: 64 lanes from the float64 batched DC point (the
    float32 DC Newton leaves about 1% of a BJT deck's lanes unconverged),
    damped configuration (f32 within 1e-4 V, f64 within 1e-9 V with equal
    per-lane iteration counts), failed masks identical and empty."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    text, dt, steps = K1B_DECKS[deck]
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)
    if dtype == torch.float32:
        opts = opts.replace(tran_tol=1e-5, dc_tol=1e-5)
    sim = Simulator.from_text(text, opts=opts, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    bp = mc.perturb_params(sim.params, g, 64,
                           {"res_r": 0.01, "mos_vth": 0.02, "cap_c": 0.02,
                            "bjt_is": 0.05, "bjt_bf": 0.05, "dio_is": 0.05,
                            "sw_ron": 0.02})
    sim64 = Simulator.from_text(text, device=cuda_device)
    x0 = mc.batched_dc_fast(sim64.engine,
                            {k: v.double() if v.is_floating_point() else v
                             for k, v in bp.items()})
    carry, advance, meta = mc.make_fused_transient_fn(sim.engine, bp, dt,
                                                      x0=x0)
    assert meta["runner"].W == (4 if deck == "switch" else 3)
    before = cuda_step.LAUNCHES
    got, it = advance(carry, 0, steps)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES == before + 1
    ref = meta["runner"].run_chunk_plain(*carry, 0, steps)
    tol = 1e-4 if dtype == torch.float32 else 1e-9
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)
    np.testing.assert_array_equal(got[4].cpu().numpy(), ref[4].cpu().numpy())
    assert not bool(got[4].any())
    if dtype == torch.float64:
        np.testing.assert_array_equal(it.cpu().numpy(),
                                      ref[5].cpu().numpy())


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("deck", ["charge", "inamp", "buffer-charge"])
def test_fused_step_kernel_matches_plain_k1d(cuda_device, deck, dtype):
    """K1d-i against the plain version on the same card and inputs, 64
    lanes x 8 steps, damped configuration: the charge stage (k = 12,
    elimination with charge rows) and inamp (k = 22, Gauss-Jordan) from the
    batched f64 DC point, f32 within 1e-4 V, f64 within 1e-10 V with equal
    per-lane iteration counts; buffer.sp under the charge model (k = 24,
    Gauss-Jordan with charge rows) from x = 0 in f32 and, in f64, at
    tran_tol 1e-13 within 1e-10 V (its Newton path depends on rounding at
    the default tolerance, ROADMAP queue 3), iteration counts not held."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)
    if dtype == torch.float32:
        opts = opts.replace(tran_tol=1e-5, dc_tol=1e-5)
    if deck == "charge":
        sim = Simulator.from_text(CHARGE_DECK, opts=opts, device=cuda_device)
        sim64 = Simulator.from_text(CHARGE_DECK, device=cuda_device)
    else:
        name = deck.split("-")[0]
        if deck == "buffer-charge":
            opts = opts.replace(mos_cap_model="charge")
            if dtype == torch.float64:
                opts = opts.replace(tran_tol=1e-13, tran_max_newton_iters=100)
        path = os.path.join(REPO, "tests", "netlists", f"{name}.sp")
        sim = Simulator.from_file(path, opts=opts, device=cuda_device)
        sim64 = Simulator.from_file(
            path, opts=DEFAULT_OPTIONS.replace(
                mos_cap_model=opts.mos_cap_model), device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    bp = mc.perturb_params(sim.params, g, 64,
                           {"res_r": 0.01, "mos_vth": 0.02, "cap_c": 0.02})
    x0 = mc.batched_dc_fast(sim64.engine,
                            {k: v.double() if v.is_floating_point() else v
                             for k, v in bp.items()})
    carry, advance, meta = mc.make_fused_transient_fn(sim.engine, bp, 1e-9,
                                                      x0=x0)
    if deck == "buffer-charge":
        x = torch.zeros_like(carry[0])
        st = sim.engine.init_state(x, bp)
        carry = (x, x, st["vc"], st["il"], carry[4])
    assert meta["runner"].k == {"charge": 12, "inamp": 22,
                                "buffer-charge": 24}[deck]
    before = cuda_step.LAUNCHES
    got, it = advance(carry, 0, 8)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES == before + 1
    ref = meta["runner"].run_chunk_plain(*carry, 0, 8)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)
    np.testing.assert_array_equal(got[4].cpu().numpy(), ref[4].cpu().numpy())
    assert not bool(got[4].any())
    if dtype == torch.float64 and deck != "buffer-charge":
        np.testing.assert_array_equal(it.cpu().numpy(),
                                      ref[5].cpu().numpy())


# the B-source deck of tests/test_pallas_step.py: an I-form source with a
# .PARAM, a V-form source with a time term, and a diode
B_DECK = """* behavioral multiplier + limiter + diode
.PARAM gain=1m
V1 a 0 SIN 0 1 1e4
V2 b 0 SIN 0 1 1.3e4
R1 a 0 1k
R2 b 0 1k
B1 p 0 I=v(a)*v(b)*gain
RP p 0 1k
B2 q 0 V=tanh(v(p)*2)+0.1*sin(6.28e4*time)
RQ q 0 2k
C1 q 0 10n
D1 q 0 IS=1e-14
.op
"""


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("deck", ["bdeck", "sdomain_filter"])
def test_fused_step_kernel_matches_plain_k1d_ii(cuda_device, deck, dtype):
    """K1d-ii (the B-source rows) against the plain version on the same
    card and inputs, 64 lanes x 10 steps from the f64 batched DC point,
    damped configuration, resistors and b_consts perturbed: B_DECK (W = 4)
    and sdomain_filter.sp (POLY(3) sources, W = 6); f32 within 1e-4 V,
    f64 within 1e-9 V with equal per-lane iteration counts."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)
    if dtype == torch.float32:
        opts = opts.replace(tran_tol=1e-5, dc_tol=1e-5)
    if deck == "bdeck":
        sim = Simulator.from_text(B_DECK, opts=opts, device=cuda_device)
        sim64 = Simulator.from_text(B_DECK, device=cuda_device)
        dt, W = 1e-6, 4
    else:
        path = os.path.join(REPO, "examples", f"{deck}.sp")
        sim = Simulator.from_file(path, opts=opts, device=cuda_device)
        sim64 = Simulator.from_file(path, device=cuda_device)
        dt, W = 2e-5, 6
    g = torch.Generator(device=cuda_device).manual_seed(2)
    bp = mc.perturb_params(sim.params, g, 64,
                           {"res_r": 0.01, "b_consts": 0.05})
    x0 = mc.batched_dc_fast(sim64.engine,
                            {k: v.double() if v.is_floating_point() else v
                             for k, v in bp.items()})
    carry, advance, meta = mc.make_fused_transient_fn(sim.engine, bp, dt,
                                                      x0=x0)
    assert meta["runner"].W == W and meta["runner"].nB == 2
    before = cuda_step.LAUNCHES
    got, it = advance(carry, 0, 10)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES == before + 1
    ref = meta["runner"].run_chunk_plain(*carry, 0, 10)
    tol = 1e-4 if dtype == torch.float32 else 1e-9
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)
    np.testing.assert_array_equal(got[4].cpu().numpy(), ref[4].cpu().numpy())
    assert not bool(got[4].any())
    if dtype == torch.float64:
        np.testing.assert_array_equal(it.cpu().numpy(),
                                      ref[5].cpu().numpy())


@pytest.mark.cuda
def test_fused_step_refuses_a_deep_b_expression(cuda_device):
    """An expression whose stack would overflow the kernel's (16 entries)
    is refused by name by the gate and by the wrapper; nothing launches."""
    from circuitsimulator_tpu_torch.ops import cuda_step, fused_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    deep = "v(a)*(" * 17 + "v(a)" + ")" * 17
    sim = Simulator.from_text(f"* deep\nV1 a 0 SIN 0 1 1e6\nR1 a 0 1k\n"
                              f"B1 q 0 V={deep}\nRQ q 0 1k\n.op\n",
                              device=cuda_device)
    assert "stack depth 18 > 16" in fused_step.unsupported_reason(
        sim.engine, 1e-9)
    bp = mc.broadcast_params(sim.params, 4)
    before = cuda_step.LAUNCHES
    with pytest.raises(NotImplementedError, match="stack depth 18 > 16"):
        mc.batched_transient(sim.engine, bp, 1e-9, 4e-9, fused=True)
    assert cuda_step.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("deck", ["dbmixer", "bjt", "linear"])
def test_fused_step_probe_stream_matches_plain(cuda_device, deck, dtype):
    """K1c-i, the probe stream, against the plain version on the same card
    and inputs: a (3, N) matrix of +1/-1 pairs, 64 lanes x 10 steps from
    the f64 batched DC point, damped configuration: carry and probe block
    within 1e-4 V in f32 and 1e-9 V in f64, the last probe tile equal to
    probe_mat @ x_out bit for bit, and the carry equal to the kernel's
    without probes."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step, fused_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)
    if dtype == torch.float32:
        opts = opts.replace(tran_tol=1e-5, dc_tol=1e-5)
    if deck == "dbmixer":
        path = os.path.join(REPO, "tests", "netlists", "dbmixer.sp")
        sim = Simulator.from_file(path, opts=opts, device=cuda_device)
        sim64 = Simulator.from_file(path, device=cuda_device)
        dt = 1e-13
    else:
        text = K1B_DECKS["bjt"][0] if deck == "bjt" else LINEAR_DECK
        sim = Simulator.from_text(text, opts=opts, device=cuda_device)
        sim64 = Simulator.from_text(text, device=cuda_device)
        dt = 1e-9
    g = torch.Generator(device=cuda_device).manual_seed(3)
    bp = mc.perturb_params(sim.params, g, 64, {"res_r": 0.02})
    x0 = mc.batched_dc_fast(sim64.engine,
                            {k: v.double() if v.is_floating_point() else v
                             for k, v in bp.items()}).to(dtype)
    N = sim.engine.N
    pm = torch.zeros((3, N), dtype=dtype, device=cuda_device)
    pm[0, 0] = 1.0
    pm[1, 1] = 1.0
    pm[1, N - 1] -= 1.0
    pm[2, N // 2] = 1.0
    runner = fused_step.FusedStepRunner(sim.engine, bp, dt, probe_mat=pm)
    bare = copy.copy(runner)                # the same constants, no probes
    bare.probe_mat = None
    st = sim.engine.init_state(x0, bp)
    carry = (x0, x0, st["vc"], st["il"],
             torch.zeros((64,), dtype=torch.bool, device=cuda_device))
    before = cuda_step.LAUNCHES
    got = runner.run_chunk(*carry, 0, 10)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES == before + 1
    assert len(got) == 7 and got[6].shape == (10, 3, 64)
    ref = runner.run_chunk_plain(*carry, 0, 10)
    tol = 1e-4 if dtype == torch.float32 else 1e-9
    for a, b in zip(got[:4] + got[6:], ref[:4] + ref[6:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)
    assert torch.equal(got[6][-1], pm @ got[0].T)
    nop = bare.run_chunk(*carry, 0, 10)
    for a, b in zip(got[:6], nop):
        assert torch.equal(a, b)
    assert not bool(got[4].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_transient_measures_on_the_card(cuda_device, dtype):
    """examples/mc_filter.sp, 256 lanes of its DEV=/LOT= tolerances:
    fused="auto" takes K1 with its probe stream in f32; the fused run
    against the non-fused loop within rtol 2e-4, atol 2e-6 in f32 and rtol
    1e-9 in f64."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)
    if dtype == torch.float32:
        opts = opts.replace(tran_tol=1e-5, dc_tol=1e-5)
    sim = Simulator.from_file(os.path.join(REPO, "examples", "mc_filter.sp"),
                              opts=opts, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    bp = mc.perturb_params_netlist(sim.params, g, 256, sim.lowered.mc_tols)
    tran, ms = sim.config.tran, sim.config.measures
    before = cuda_step.LAUNCHES
    res, got = mc.batched_transient_measures(
        sim.engine, bp, tran.tstep, tran.tstop, ms, sim.topo,
        fused="auto" if dtype == torch.float32 else True)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES == before + 1 and not bool(res.failed.any())
    _, want = mc.batched_transient_measures(
        sim.engine, bp, tran.tstep, tran.tstop, ms, sim.topo, fused=False)
    rtol, atol = (2e-4, 2e-6) if dtype == torch.float32 else (1e-9, 0.0)
    for name in ("settle", "vfinal"):
        np.testing.assert_allclose(got[name].cpu().numpy(),
                                   want[name].cpu().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def ac_lanes(B, n, seed):
    """Diagonally dominant lanes; lane 1 exactly singular, lane 2 NaN."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n)) + n * np.eye(n)
    B1 = rng.standard_normal((B, n, n))
    br = rng.standard_normal((B, n))
    bi = rng.standard_normal((B, n))
    G[1] = 0.0
    B1[1] = 0.0
    G[2, n // 2, min(1, n - 1)] = np.nan
    return G, B1, br, bi


def lane_rel_err(x, ref, good):
    """Worst lane of max|x - ref| / max|ref| over frequencies and unknowns."""
    d = np.abs(x - ref)[good].reshape(int(good.sum()), -1).max(1)
    s = np.abs(ref)[good].reshape(int(good.sum()), -1).max(1)
    return float((d / np.maximum(s, 1e-300)).max())


def mna_lanes(B, n, seed):
    """MNA-style lanes of small integers: node rows of integer conductances
    (a grounded chain and random branches) and capacitances, and
    voltage-source rows of +-1 with a zero diagonal, the equations in a
    random order per lane, so that exact ties in |a|^2 decide pivots; with
    B > 2 lane 1 is singular and lane 2 holds a NaN."""
    rng = np.random.default_rng(seed)
    m = n // 4                                  # voltage sources
    nv = n - m
    G = np.zeros((B, n, n))
    C = np.zeros((B, n, n))

    def branch(M, b, a, c, v):
        M[b, a, a] += v
        if c is not None:
            M[b, c, c] += v
            M[b, a, c] -= v
            M[b, c, a] -= v

    for b in range(B):
        branch(G, b, 0, None, 1.0)              # node 0 to ground
        for a in range(nv - 1):
            branch(G, b, a, a + 1, float(rng.integers(1, 4)))
        for _ in range(nv // 2):
            a, c = rng.choice(nv, 2, replace=False)
            branch(G, b, a, c, float(rng.integers(1, 3)))
            branch(C, b, a, c, float(rng.integers(0, 3)))
        for k in range(m):                      # disjoint node pairs
            r, a, c = nv + k, 2 * k, 2 * k + 1
            G[b, a, r] = G[b, r, a] = 1.0
            if c < nv:
                G[b, c, r] = G[b, r, c] = -1.0
        perm = rng.permutation(n)
        G[b], C[b] = G[b, perm], C[b, perm]
    br = rng.integers(-2, 3, (B, n)).astype(float)
    bi = rng.integers(-2, 3, (B, n)).astype(float)
    if B > 2:
        G[1] = 0.0
        C[1] = 0.0
        G[2, n // 2, min(1, n - 1)] = np.nan
    return G, C, br, bi


def check_ac_sweep(device, arrays, om, dtype, **override):
    """K3 (plan, or ``override`` of the team capacity) against its plain
    version: one launch, identical fail masks, the singular and NaN lanes
    zeroed, lane-relative error <= 1e-12 (f64) and <= 1e-4 (f32)."""
    from circuitsimulator_tpu_torch.ops import ac_sweep, cuda_ac
    G, B1, br, bi = (torch.as_tensor(a, dtype=dtype, device=device)
                     for a in arrays)
    om = torch.as_tensor(om, dtype=dtype, device=device)
    B = G.shape[0]
    before = cuda_ac.LAUNCHES
    if override:
        xr, xi = cuda_ac.ac_sweep_cuda(G, B1, br, bi, om, FLOOR, **override)
    else:
        xr, xi = ac_sweep.ac_sweep(G, B1, br, bi, om, FLOOR)
    torch.cuda.synchronize()
    assert cuda_ac.LAUNCHES == before + 1
    pr, pi = ac_sweep.ac_sweep_plain(G, B1, br, bi, om, FLOOR)
    x = xr.cpu().numpy() + 1j * xi.cpu().numpy()
    ref = pr.cpu().numpy() + 1j * pi.cpu().numpy()
    zero_k = np.all(x.reshape(B, -1) == 0.0, axis=1)
    zero_p = np.all(ref.reshape(B, -1) == 0.0, axis=1)
    np.testing.assert_array_equal(zero_k, zero_p)
    if B > 2:
        assert zero_k[1] and zero_k[2]
    good = ~zero_p
    assert good.any()
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert lane_rel_err(x, ref, good) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("F", [1, 3, 8])
@pytest.mark.parametrize("B", [1, 7, 300])
@pytest.mark.parametrize("n", [1, 8, 9, 16, 17, 31, 32, 33, 64])
def test_ac_sweep_kernel_matches_plain(cuda_device, dtype, B, n, F):
    """K3 against its plain version on the card at every team capacity's
    edges (8, 16, 32 threads, the wide route), one lane to 300, one to
    eight frequencies."""
    arrays = ac_lanes(max(B, 3), n, seed=n + F)
    # omega <= 1 keeps the lanes diagonally dominant for the f32 bar
    check_ac_sweep(cuda_device, [a[:B] for a in arrays],
                   np.logspace(-1, 0, F), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [4, 7, 10, 17, 31, 40])
def test_ac_sweep_kernel_ties_on_mna_lanes(cuda_device, dtype, n):
    """Small-integer MNA lanes with +-1 source rows (omegas powers of two,
    so w B1 is exact): ties in |a|^2 decide the pivots, the first position
    wins in both versions."""
    check_ac_sweep(cuda_device, mna_lanes(300, n, seed=n),
                   2.0 ** np.arange(-3, 5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 5, 8, 9, 16, 17, 31, 32])
def test_ac_sweep_every_team(cuda_device, dtype, n):
    """Every team capacity that holds N (two rows a thread at 8 and 16, one
    at 32, and the wide route at 64), forced through the wrapper: the same
    fail masks and values within the bars, on random and on MNA lanes."""
    from circuitsimulator_tpu_torch.ops import cuda_ac
    for cap in (c for c in cuda_ac.CAPACITIES if c >= n):
        check_ac_sweep(cuda_device, ac_lanes(40, n, seed=n),
                       np.logspace(-1, 0, 5), dtype, team=cap)
        check_ac_sweep(cuda_device, mna_lanes(40, n, seed=n),
                       2.0 ** np.arange(-2, 3), dtype, team=cap)


@pytest.mark.cuda
def test_ac_analysis_batched_on_the_card(cuda_device):
    """dbmixer, 64 lanes x 8 frequencies, f64: the card's route (batched DC
    on K2, K3) against the CPU route (plain versions) within 1e-9
    lane-relative, with one K3 launch."""
    from circuitsimulator_tpu_torch.analysis.ac import ac_analysis_batched
    from circuitsimulator_tpu_torch.ops import cuda_ac
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    deck = os.path.join(REPO, "tests", "netlists", "dbmixer.sp")
    cpu = Simulator.from_file(deck, device="cpu")
    gpu = Simulator.from_file(deck, device=cuda_device)
    bp = mc.perturb_params(cpu.params, torch.Generator().manual_seed(4), 64,
                           {"res_r": 0.01, "mos_vth": 0.02, "cap_c": 0.02})
    bp["vs_ac_mag"] = bp["vs_ac_mag"].clone()
    bp["vs_ac_mag"][:, 0] = 1.0
    freqs = np.logspace(6, 10, 8)
    want = ac_analysis_batched(cpu.engine, bp, freqs)
    before = cuda_ac.LAUNCHES
    got = ac_analysis_batched(gpu.engine,
                              {k: v.to(cuda_device) for k, v in bp.items()},
                              freqs)
    assert cuda_ac.LAUNCHES == before + 1
    assert got.xs.shape == (64, 8, gpu.engine.N)
    assert np.isfinite(got.xs).all()
    assert lane_rel_err(got.xs, want.xs, np.ones(64, bool)) <= 1e-9


@pytest.mark.cuda
def test_cli_run_ac_on_the_card(cuda_device, tmp_path, monkeypatch):
    """--run-ac on the card: cs_amp.sp's CSV against the committed JAX
    golden, phasors within 1e-9 of each probe's largest magnitude."""
    import shutil
    from circuitsimulator_tpu_torch import cli
    shutil.copy(os.path.join(REPO, "examples", "cs_amp.sp"), tmp_path)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["cs_amp.sp", "--device", "cuda", "--no-tran",
                     "--run-ac", "ac.csv"]) == 0
    gold = os.path.join(REPO, "tests", "goldens", "cs_amp_ac_jax.csv")
    with open("ac.csv") as f, open(gold) as g:
        assert f.readline() == g.readline()
    a = np.loadtxt("ac.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(gold, delimiter=",", skiprows=1)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    xa = a[:, 1::2] * np.exp(1j * np.radians(a[:, 2::2]))
    xb = b[:, 1::2] * np.exp(1j * np.radians(b[:, 2::2]))
    scale = np.maximum(np.abs(xb).max(axis=0), 1e-300)
    assert (np.abs(xa - xb) / scale).max() <= 1e-9


# transmission lines (K1c-ii): the diode-clamp deck of
# tests/test_pallas_step.py with a second line of another delay (ticks 8
# and 5 at dt = 0.25 ns)
TL2_DECK = """* two lines + diode clamp
V1 in 0 PULSE(0 1 1n 0.2n 0.2n 6n 0)
RS in a 50
T1 a 0 b 0 Z0=50 TD=2n
RL b 0 200
D1 b 0
T2 b 0 c 0 Z0=75 TD=1.25n
RC c 0 100
.op
"""


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("deck", ["two_lines", "tline_reflect"])
def test_fused_step_delay_ring_matches_plain(cuda_device, deck, dtype):
    """K1c-ii against the plain version on the same card and inputs: 64
    lanes (Rs and Z0 perturbed) from the f64 batched DC, damped
    configuration, three launches in a row (the head wraps around the
    8-slot ring; tline_reflect's 100-slot ring is crossed once): x and the
    ring within 1e-4 V in f32 and 1e-9 V in f64 with equal per-lane
    iteration counts, one launch per chunk, and the ring at exit in the
    Engine's layout (slot 0 the wave of the returned x, bit for bit)."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step, fused_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)
    if dtype == torch.float32:
        opts = opts.replace(tran_tol=1e-5, dc_tol=1e-5)
    if deck == "two_lines":
        sim = Simulator.from_text(TL2_DECK, opts=opts, device=cuda_device)
        sim64 = Simulator.from_text(TL2_DECK, device=cuda_device)
        dt, chunks = 0.25e-9, (7, 9, 5)
    else:
        path = os.path.join(REPO, "examples", "tline_reflect.sp")
        sim = Simulator.from_file(path, opts=opts, device=cuda_device)
        sim64 = Simulator.from_file(path, device=cuda_device)
        dt, chunks = 1e-10, (40, 40, 30)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    bp = mc.perturb_params(sim.params, g, 64, {"res_r": 0.02,
                                               "tl_z0": 0.02})
    x0 = mc.batched_dc_fast(sim64.engine,
                            {k: v.double() if v.is_floating_point() else v
                             for k, v in bp.items()}).to(dtype)
    runner = fused_step.FusedStepRunner(sim.engine, bp, dt)
    st = sim.engine.init_state(x0, bp, dt)
    kc = pc = (x0, x0, st["vc"], st["il"],
               torch.zeros((64,), dtype=torch.bool, device=cuda_device),
               st["tlw"])
    tol = 1e-4 if dtype == torch.float32 else 1e-9
    step0 = 0
    for n in chunks:
        before = cuda_step.LAUNCHES
        got = runner.run_chunk(*kc[:5], step0, n, tlw=kc[5])
        torch.cuda.synchronize()
        assert cuda_step.LAUNCHES == before + 1
        ref = runner.run_chunk_plain(*pc[:5], step0, n, tlw=pc[5])
        if dtype == torch.float64:
            assert torch.equal(got[5], ref[5])
        kc, pc = got[:5] + got[-1:], ref[:5] + ref[-1:]
        step0 += n
    for a, b in zip(kc[:4] + kc[5:], pc[:4] + pc[5:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)
    assert kc[5].shape == (64, runner.Dmax, 2 * runner.nT)
    assert torch.equal(kc[5][:, 0], sim.engine._tl_wave_now(bp, kc[0]))
    assert not bool(kc[4].any())


@pytest.mark.cuda
def test_tline_monte_carlo_on_the_card(cuda_device):
    """tline_reflect.sp, 256 lanes in f32: batched_transient_measures takes
    K1 with its probe stream and its ring (fused="auto") and agrees with the
    non-fused loop within rtol 2e-4, atol 2e-6; the matched line's AC over
    8 frequencies through K2, never K3, equal to the CPU route within
    1e-5 lane-relative."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.analysis.ac import ac_analysis_batched
    from circuitsimulator_tpu_torch.ops import cuda_ac, cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    opts = DEFAULT_OPTIONS.replace(dtype=torch.float32)
    sim = Simulator.from_file(os.path.join(REPO, "examples",
                                           "tline_reflect.sp"),
                              opts=opts, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    bp = mc.perturb_params(sim.params, g, 256, {"res_r": 0.02})
    tran, ms = sim.config.tran, sim.config.measures
    before = cuda_step.LAUNCHES
    res, got = mc.batched_transient_measures(sim.engine, bp, tran.tstep,
                                             tran.tstop, ms, sim.topo)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES == before + 2 and not bool(res.failed.any())
    _, want = mc.batched_transient_measures(sim.engine, bp, tran.tstep,
                                            tran.tstop, ms, sim.topo,
                                            fused=False)
    for name in ("arrival", "vpeak"):
        np.testing.assert_allclose(got[name].cpu().numpy(),
                                   want[name].cpu().numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=name)
    text = """* ac matched line
V1 src 0 DC 0 AC 1
Rs src in 50
T1 in 0 out 0 Z0=50 TD=10n
Rl out 0 50
"""
    cpu = Simulator.from_text(text, device="cpu")
    gpu = Simulator.from_text(text, opts=opts, device=cuda_device)
    bp = mc.perturb_params(cpu.params, torch.Generator().manual_seed(7), 32,
                           {"res_r": 0.02, "tl_z0": 0.02})
    freqs = np.logspace(6, 9, 8)
    want = ac_analysis_batched(cpu.engine, bp, freqs)
    before = cuda_ac.LAUNCHES
    got = ac_analysis_batched(gpu.engine, {
        k: (v.float() if v.is_floating_point() else v).to(cuda_device)
        for k, v in bp.items()}, freqs)
    assert cuda_ac.LAUNCHES == before
    assert lane_rel_err(got.xs, want.xs, np.ones(32, bool)) <= 1e-5


@pytest.mark.cuda
def test_cli_tline_reflect_on_the_card(cuda_device, tmp_path, monkeypatch,
                                       capsys):
    """examples/tline_reflect.sp through the CLI on the card (f64): stdout
    byte-identical to the JAX CLI's golden, CSV within 1e-9 V."""
    import shutil
    from circuitsimulator_tpu_torch import cli
    (tmp_path / "examples").mkdir()
    shutil.copy(os.path.join(REPO, "examples", "tline_reflect.sp"),
                tmp_path / "examples")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["examples/tline_reflect.sp", "tline_reflect_tran.csv",
                     "--device", "cuda"]) == 0
    gold = os.path.join(REPO, "tests", "goldens")
    with open(os.path.join(gold, "tline_reflect_stdout_jax.txt")) as f:
        assert capsys.readouterr().out == f.read()
    a = np.loadtxt("tline_reflect_tran.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(os.path.join(gold, "tline_reflect_tran_jax.csv"),
                   delimiter=",", skiprows=1)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


WHITE_NOISE_DECK = """* white noise, V and I sources, diode load
V1 in 0 DC 1 TRNOISE(5m 0)
I1 0 out 1m TRNOISE(2u 2.5e-7)
R1 in out 1k
R2 out 0 1k
C1 out 0 1n
D1 out 0
.TRAN 1e-7 4e-6
"""


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_step_noise_block_matches_plain(cuda_device, dtype):
    """K1c-iii against the plain version on the same card and inputs: the
    white V + I noise deck of tests/test_trnoise_fused.py, 256 lanes
    (resistors 1%) from the f64 batched DC, damped configuration, three
    chunks in a row, each with its noise block from Engine.trnoise_stream
    (per-lane keys split from key(3)): x within 1e-5 V in f32 and 1e-12 V
    in f64 with equal per-lane iteration counts, one launch per chunk; a
    runner with noise refuses a missing block."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    from circuitsimulator_tpu_torch.utils import prng
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)
    if dtype == torch.float32:
        opts = opts.replace(tran_tol=1e-5, dc_tol=1e-5)
    sim = Simulator.from_text(WHITE_NOISE_DECK, opts=opts, device=cuda_device)
    sim64 = Simulator.from_text(WHITE_NOISE_DECK, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    bp = mc.perturb_params(sim.params, g, 256, {"res_r": 0.01})
    x0 = mc.batched_dc_fast(sim64.engine,
                            {k: v.double() if v.is_floating_point() else v
                             for k, v in bp.items()}).to(dtype)
    carry, _, meta = mc.make_fused_transient_fn(sim.engine, bp, 1e-7, x0=x0,
                                                noise_key=prng.key(3))
    runner, feed = meta["runner"], meta["feed"]
    assert runner.nN == 2
    kc = pc = carry
    step0 = 0
    for n in (7, 12, 5):
        nz, banks = feed.block(kc[-1], step0, n)
        before = cuda_step.LAUNCHES
        got = runner.run_chunk(*kc[:5], step0, n, noise=nz)
        torch.cuda.synchronize()
        assert cuda_step.LAUNCHES == before + 1
        ref = runner.run_chunk_plain(*pc[:5], step0, n, noise=nz)
        if dtype == torch.float64:
            assert torch.equal(got[5], ref[5])
        kc, pc = got[:5] + (banks,), ref[:5] + (banks,)
        step0 += n
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for a, b in zip(kc[:4], pc[:4]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)
    assert not bool(kc[4].any())
    with pytest.raises(ValueError, match="noise"):
        runner.run_chunk(*kc[:5], step0, 3)


@pytest.mark.cuda
def test_threefry_on_the_card_matches_the_cpu(cuda_device):
    """utils/prng on CUDA gives the CPU's draws bit for bit (the uint32
    arithmetic in int64, the normals from arithmetic alone): keys, bits and
    f32 and f64 normals of 4 x 5,000 draws under split keys."""
    from circuitsimulator_tpu_torch.utils import prng
    out = {}
    for dev in ("cpu", cuda_device):
        keys = prng.split(prng.key(123, dev), 4)
        out[str(dev)[:4]] = (keys, prng.bits(keys, (5000,)),
                             prng.normal(keys, (5000,), torch.float32),
                             prng.normal(keys, (5000,), torch.float64))
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b.cpu())


def edge_deck(N, k):
    """A deck of N unknowns at Woodbury rank k: a current source into an RC
    ladder (one unknown a node; with a voltage source, one more for its
    branch) and k weak MOS, device j from ladder node j to ground (even j,
    on) or to node j + 1 (odd j), gated by node j + 2 (wrapping), each its
    own Woodbury row."""
    nodes = N - 1 if N > 1 else 1
    lines = ["* K1 launch-plan edge deck",
             ".MODEL 2 VT 0.4 MU 3e-2 COX 6e-3 LAMBDA 0.05"]
    if N > 1:
        lines.append("V1 n1 0 SIN 0.9 0.3 5e6")
    else:
        lines.append("I1 0 n1 SIN 0.5m 0.2m 5e6")
    for i in range(1, nodes + 1):
        lines.append(f"RG{i} n{i} 0 {10e3 + 100 * i:g}")
        lines.append(f"CG{i} n{i} 0 {1e-12 + 1e-14 * i:g}")
        if i > 1:
            lines.append(f"RS{i} n{i - 1} n{i} 1k")
    for j in range(k):
        d, g = (j % nodes) + 1, ((j + 2) % nodes) + 1
        src = "0" if j % 2 == 0 else f"n{((j + 1) % nodes) + 1}"
        lines.append(f"M{j} n{d} n{g} {src} n 1e-6 4e-6 2")
    return "\n".join(lines + [".op", ""])


def _edge_case(cuda_device, N, k, dtype, B, route=None, team=None,
               steps=30):
    """K1 on the edge deck against its plain version from the batched DC
    point: f64 within 1e-9 V with equal per-lane iteration counts, f32
    within 1e-4 V, failed masks equal (damped configuration)."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)
    if dtype == torch.float32:
        opts = opts.replace(tran_tol=1e-5, dc_tol=1e-5)
    sim = Simulator.from_text(edge_deck(N, k), opts=opts, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(N * 64 + k)
    bp = mc.perturb_params(sim.params, g, B,
                           {"res_r": 0.02, "cap_c": 0.02, "mos_vth": 0.02})
    carry, _, meta = mc.make_fused_transient_fn(sim.engine, bp, 2e-9)
    runner = meta["runner"]
    assert (runner.N, runner.k) == (N, k)
    p = cuda_step.runner_plan(runner, route, team=team)
    before = cuda_step.LAUNCHES
    got = cuda_step.run_chunk_cuda(runner, *carry, 0, steps, route=route,
                                   team=team)
    torch.cuda.synchronize()
    assert cuda_step.LAUNCHES == before + 1
    ref = runner.run_chunk_plain(*carry, 0, steps)
    tol = 1e-4 if dtype == torch.float32 else 1e-9
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)
    np.testing.assert_array_equal(got[4].cpu().numpy(), ref[4].cpu().numpy())
    if dtype == torch.float64:
        np.testing.assert_array_equal(got[5].cpu().numpy(),
                                      ref[5].cpu().numpy())
    assert int(got[5].min()) > 0
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 7, 300])
@pytest.mark.parametrize("N,k", [(8, 2), (9, 2), (16, 2), (17, 2), (32, 2),
                                 (33, 2), (64, 2), (20, 0), (20, 16),
                                 (20, 17), (20, 32), (64, 32)])
def test_fused_step_kernel_at_the_plan_edges(cuda_device, N, k, dtype, B):
    """K1 at every edge of its launch plan (team 4/8/16/32 from max(k,
    ceil(N / 3)), rows of x a thread, elimination for k <= 16 and
    Gauss-Jordan above) against the plain version, at lane counts that are
    not multiples of the lanes per block."""
    p = _edge_case(cuda_device, N, k, dtype, B)
    assert p.team >= k and p.team * p.rows >= N


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("team,route", [(4, "shared"), (8, "shared"),
                                        (16, "shared"), (32, "shared"),
                                        (32, "registers")])
def test_fused_step_kernel_by_team_and_route(cuda_device, team, route,
                                             dtype):
    """One deck (N = 16, k = 4) on every team the plan can take, four rows
    a thread down to one, and on both routes (G0^-1 rows in shared memory
    or in registers), against the plain version."""
    if route == "registers" and dtype == torch.float64:
        with pytest.raises(ValueError, match="registers route"):
            _edge_case(cuda_device, 16, 4, dtype, 300, route, team)
        return
    p = _edge_case(cuda_device, 16, 4, dtype, 300, route, team)
    assert (p.team, p.route) == (team, route)
    assert p.rows == -(-16 // team)


# K1e, the mutual-inductance history: examples/xfmr.sp (k = 0), its
# secondary with a diode and an RC load (k = 1), and three windings under
# two K cards (one inductor in both)
RECTIFIER_DECK = """* transformer-coupled half-wave rectifier
V1 src 0 SIN 0 1 1e5
Rs src p 10
L1 p 0 1m
L2 s 0 4m
K1 L1 L2 0.98
D1 s out
Rl out 0 1k
Cl out 0 100n
.TRAN 1e-8 5e-5
"""
THREE_WINDINGS_DECK = """* three coupled windings
V1 src 0 SIN 0 1 1e5
Rs src p 10
L1 p 0 1m
L2 s 0 4m
L3 t 0 2m
K1 L1 L2 0.8
K2 L2 L3 0.5
Rl s 0 1k
R3 t 0 500
.TRAN 1e-8 5e-5
"""


def k_deck(deck, opts, device):
    if deck == "xfmr":
        return Simulator.from_file(os.path.join(REPO, "examples", "xfmr.sp"),
                                   opts=opts, device=device)
    return Simulator.from_text(RECTIFIER_DECK if deck == "rectifier"
                               else THREE_WINDINGS_DECK, opts=opts,
                               device=device)


def k_lanes(sim, B, seed):
    """B lanes with ind_l (5%), mut_k (1%, at most 0.999) and res_r (2%)
    perturbed, drawn with numpy."""
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    rng = np.random.default_rng(seed)
    bp = dict(mc.broadcast_params(sim.params, B))
    for key, sigma in (("ind_l", 0.05), ("mut_k", 0.01), ("res_r", 0.02)):
        p = sim.params[key]
        f = np.exp(sigma * rng.standard_normal((B,) + tuple(p.shape)))
        bp[key] = p[None] * torch.as_tensor(f, dtype=p.dtype,
                                            device=p.device)
    bp["mut_k"] = bp["mut_k"].clamp(max=0.999)
    return bp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("deck", ["xfmr", "rectifier", "three_windings"])
def test_fused_step_mutual_history_matches_plain(cuda_device, deck, dtype):
    """K1e against the plain version on the same card and inputs: 300 lanes
    from the f64 batched DC, damped configuration, two launches in a row
    (f32 within 2e-4 V over 100 steps, f64 within 1e-9 V with equal
    per-lane iteration counts over 250), one launch per chunk; in f64 the
    fused run within 1e-9 V of the non-fused loop.  In f32 the branch rows
    of these decks cancel terms of L/dt i (about 1e3 V at dt = 10 ns) down
    to volts, so two correct orders of summation drift apart as the
    rectifier's diode conducts: about 3e-5 V after 100 steps, 3e-4 V after
    250 (the plain version against the non-fused loop on the CPU)."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step, fused_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)
    if dtype == torch.float32:
        opts = opts.replace(tran_tol=1e-5, dc_tol=1e-5)
    sim = k_deck(deck, opts, cuda_device)
    bp = k_lanes(sim, 300, 6)
    bp64 = {k: v.double() if v.is_floating_point() else v
            for k, v in bp.items()}
    x0 = mc.batched_dc_fast(k_deck(deck, DEFAULT_OPTIONS,
                                   cuda_device).engine, bp64).to(dtype)
    dt = 1e-8
    runner = fused_step.FusedStepRunner(sim.engine, bp, dt)
    assert runner.nK == (2 if deck == "three_windings" else 1)
    st = sim.engine.init_state(x0, bp, dt)
    kc = pc = (x0, x0, st["vc"], st["il"],
               torch.zeros((300,), dtype=torch.bool, device=cuda_device))
    step0, iters, ref_iters = 0, 0, 0
    for n in ((150, 100) if dtype == torch.float64 else (60, 40)):
        before = cuda_step.LAUNCHES
        got = runner.run_chunk(*kc, step0, n)
        torch.cuda.synchronize()
        assert cuda_step.LAUNCHES == before + 1
        ref = runner.run_chunk_plain(*pc, step0, n)
        kc, pc = got[:5], ref[:5]
        iters, ref_iters = iters + got[5], ref_iters + ref[5]
        step0 += n
    tol = 2e-4 if dtype == torch.float32 else 1e-9
    for a, b in zip(kc[:4], pc[:4]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)
    assert not bool(kc[4].any()) and not bool(pc[4].any())
    if dtype == torch.float64:
        np.testing.assert_array_equal(iters.cpu().numpy(),
                                      ref_iters.cpu().numpy())
        loop = mc.batched_transient(sim.engine, bp, dt, step0 * dt, x0=x0,
                                    fused=False)
        np.testing.assert_allclose(kc[0].cpu().numpy(),
                                   loop.x_final.cpu().numpy(), rtol=0,
                                   atol=1e-9)


@pytest.mark.cuda
def test_dc_sweep_on_the_card_matches_cpu(cuda_device):
    """mos_family.sp's nested .DC sweep (255 points, one batched DC on K2)
    on the card within 1e-9 V of the CPU, with the same points failing
    (none)."""
    from circuitsimulator_tpu_torch.ops import cuda_lu
    path = os.path.join(REPO, "examples", "mos_family.sp")
    before = cuda_lu.LAUNCHES
    got = Simulator.from_file(path, device=cuda_device).dc_sweep()
    torch.cuda.synchronize()
    assert cuda_lu.LAUNCHES > before
    ref = Simulator.from_file(path, device="cpu").dc_sweep()
    np.testing.assert_array_equal(got.values, ref.values)
    np.testing.assert_array_equal(got.values2, ref.values2)
    x, xr = got.xs.cpu().numpy(), ref.xs.numpy()
    assert np.isfinite(x).all() and np.isfinite(xr).all()
    np.testing.assert_allclose(x, xr, rtol=0, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adaptive_stacked_level_inverse_matches_plain(cuda_device, dtype):
    """The adaptive ladder's G0 inverses, dbmixer at L + 1 = 9 levels x 64
    lanes: one K2 launch with the levels folded into the lanes, against the
    plain version of the same (576, 31, 31) solve on the card."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops.woodbury import WoodburySolver
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)
    sim = Simulator.from_file(os.path.join(REPO, "tests", "netlists",
                                           "dbmixer.sp"), opts=opts,
                              device=cuda_device)
    eng, N = sim.engine, sim.engine.N
    bp = k_lanes_res(sim, 64, 3)
    L = opts.tran_max_refine_levels
    Gs = torch.stack([eng.tran_static_G(bp, 1e-13 / (1 << lv),
                                        opts.tran_gmin)
                      for lv in range(L + 1)])[..., :N, :N]
    before = cuda_lu.LAUNCHES
    wb = WoodburySolver(eng, bp, Gs)
    torch.cuda.synchronize()
    assert cuda_lu.LAUNCHES == before + 1
    assert wb.G0inv.shape == (L + 1, 64, N, N)
    eye = torch.eye(N, dtype=dtype, device=cuda_device)
    ref = tlu.lu_solve_plain(Gs, eye.expand(Gs.shape), FLOOR)
    rel = ((wb.G0inv - ref).abs().amax(dim=(-2, -1))
           / ref.abs().amax(dim=(-2, -1)))
    assert float(rel.max()) <= (1e-4 if dtype == torch.float32 else 1e-12)


def k_lanes_res(sim, B, seed):
    """B lanes with res_r (2%) perturbed, drawn with numpy."""
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    rng = np.random.default_rng(seed)
    bp = dict(mc.broadcast_params(sim.params, B))
    p = sim.params["res_r"]
    f = np.exp(0.02 * rng.standard_normal((B,) + tuple(p.shape)))
    bp["res_r"] = p[None] * torch.as_tensor(f, dtype=p.dtype,
                                            device=p.device)
    return bp


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["be", "trap"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lu_solver_step_matches_plain(cuda_device, method, dtype):
    """The dense ``lu`` transient solver on the card, dbmixer at 256 lanes,
    20 steps: K2 at (256, 31, 1) on every Newton iteration, against the
    same loop on the CPU (the plain version), f64 within 1e-9 V, f32 within
    1e-4 V; in f64 also the mixed refinement (f32 K2 around an f64
    residual) within 1e-6 V of the f64 run."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    opts = DEFAULT_OPTIONS.replace(dtype=dtype, tran_solver="lu",
                                   tran_method=method)
    if dtype == torch.float32:
        opts = opts.replace(tran_tol=1e-5, dc_tol=1e-5)
    path = os.path.join(REPO, "tests", "netlists", "dbmixer.sp")
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        sim = Simulator.from_file(path, opts=opts, device=dev)
        bp = k_lanes_res(sim, 256, 4)
        x0 = mc.batched_dc_fast(sim.engine, bp)
        before = cuda_lu.LAUNCHES
        res = mc.batched_transient(sim.engine, bp, 1e-13, 20e-13, x0=x0,
                                   fused=False)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            # one launch per Newton iteration of the shared loop
            assert cuda_lu.LAUNCHES - before >= 20
        out[dev.type] = res.x_final.cpu()
        assert not bool(res.failed.any())
    tol = 1e-4 if dtype == torch.float32 else 1e-9
    np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(),
                               rtol=0, atol=tol)
    if dtype == torch.float64:
        sim = Simulator.from_file(path, opts=opts.replace(
            tran_mixed_refine=True), device=cuda_device)
        bp = k_lanes_res(sim, 256, 4)
        res = mc.batched_transient(sim.engine, bp, 1e-13, 20e-13,
                                   fused=False)
        np.testing.assert_allclose(res.x_final.cpu().numpy(),
                                   out["cpu"].numpy(), rtol=0, atol=1e-6)


def _small_signal_systems(sim, x):
    """The noise adjoint's (1, N, N) transposed unit-omega system of
    ``sim`` at its .AC card's frequencies, and a 2-port excitation of the
    same G and B1 as two lanes: [(G, B1, br, bi), omegas] twice."""
    from circuitsimulator_tpu_torch.analysis.ac import (_omegas,
                                                        ac_system_real)
    G, B1, _, _ = ac_system_real(sim.engine, sim.params, x, 1.0)
    N = sim.engine.N
    om = _omegas(sim.engine, sim._ac_freqs())[1]
    e = torch.zeros((1, N), dtype=G.dtype, device=G.device)
    e[0, N // 2] = 1.0
    adj = [G.mT[None].contiguous(), B1.mT[None].contiguous(), e,
           torch.zeros_like(e)]
    rhs = torch.zeros((2, N), dtype=G.dtype, device=G.device)
    rhs[0, 0] = rhs[1, N - 1] = 1.0
    nport = [G.expand(2, N, N).contiguous(), B1.expand(2, N, N).contiguous(),
             rhs, torch.zeros_like(rhs)]
    return (adj, om), (nport, om)


@pytest.mark.cuda
@pytest.mark.parametrize("deck", ["bjt_amp", "cs_amp", "feedback_loop"])
def test_k3_adjoint_and_nport_shapes_match_plain(cuda_device, deck):
    """K3 at the small-signal shapes: the adjoint sweep (1, F, N) on the
    transposed G and B1 and the n-port sweep (2, F, N), each one launch,
    against the plain version: fail masks identical, f64 lane-relative
    error <= 1e-12."""
    from circuitsimulator_tpu_torch.ops import ac_sweep, cuda_ac
    sim = Simulator.from_file(os.path.join(REPO, "examples", f"{deck}.sp"),
                              device=cuda_device)
    for arrays, om in _small_signal_systems(sim, sim.dc()):
        before = cuda_ac.LAUNCHES
        xr, xi = ac_sweep.ac_sweep(*arrays, om, FLOOR)
        torch.cuda.synchronize()
        assert cuda_ac.LAUNCHES == before + 1
        pr, pi = ac_sweep.ac_sweep_plain(*arrays, om, FLOOR)
        x = torch.complex(xr, xi).cpu().numpy()
        p = torch.complex(pr, pi).cpu().numpy()
        assert np.array_equal(lane_masks(x)[0], lane_masks(p)[0])
        scale = np.abs(p).reshape(len(p), -1).max(axis=1)
        err = np.abs(x - p).reshape(len(p), -1).max(axis=1) / scale
        assert err.max() <= 1e-12, err


@pytest.mark.cuda
@pytest.mark.parametrize("deck", ["bjt_amp", "feedback_loop"])
def test_group_delay_two_sweeps_match_cpu(cuda_device, deck):
    """Simulator.group_delay on the card: the forward and the adjoint
    sweep are two K3 launches, and tau is within 1e-8 relative of the
    port's run on the CPU."""
    from circuitsimulator_tpu_torch.ops import cuda_ac
    path = os.path.join(REPO, "examples", f"{deck}.sp")
    node = {"bjt_amp": "c", "feedback_loop": "out"}[deck]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        sim = Simulator.from_file(path, device=dev)
        x = sim.dc()
        before = cuda_ac.LAUNCHES
        f, tau = sim.group_delay(node, x_op=x)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert cuda_ac.LAUNCHES == before + 2
        out[dev.type] = tau
    assert np.all(np.isfinite(out["cuda"]))
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-8, atol=0)


@pytest.mark.cuda
def test_lu_solve_diff_backward_matches_cpu(cuda_device):
    """lu_solve_diff on the card (K2 forward and K2 on the transposed
    systems backward) against its plain path on the CPU, f64: values and
    both cotangents within 1e-12 of their largest entry, a lane zeroed by
    the fail contract with zero cotangents on both."""
    g = torch.Generator().manual_seed(3)
    F, N = 71, 14
    A = torch.randn(F, N, N, generator=g, dtype=torch.float64)
    A += 3.0 * torch.eye(N, dtype=torch.float64)
    A[5] = 0.0
    b = torch.randn(F, N, generator=g, dtype=torch.float64)
    w = torch.randn(F, N, generator=g, dtype=torch.float64)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        At = A.to(dev).requires_grad_()
        bt = b.to(dev).requires_grad_()
        before = cuda_lu.LAUNCHES
        x = tlu.lu_solve_diff(At, bt)
        (x * w.to(dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert cuda_lu.LAUNCHES == before + 2
        out[dev.type] = [v.detach().cpu().numpy()
                         for v in (x, At.grad, bt.grad)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert not out["cuda"][1][5].any() and not out["cuda"][2][5].any()


@pytest.mark.cuda
def test_adjoint_gradient_matches_cpu(cuda_device):
    """The reverse-mode transient adjoint of the diode + sine +
    time-dependent B-source deck on the card (every forward Newton solve
    and every transposed solve on K2) against the port on the CPU: the
    waveform and every parameter gradient within 1e-8 of its largest
    entry."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.analysis.adjoint import (
        transient_adjoint_gradient)
    deck = """* diode, sine and a time-dependent B source
V1 in 0 SIN 0.4 0.3 2e6
R1 in a 1k
C1 a 0 100p
D1 a 0 IS=1e-13 N=1
RL a 0 5k
B1 a 0 I=0.1m*v(a)*sin(6.283e6*time)
.TRAN 5e-9 1e-7
"""
    opts = DEFAULT_OPTIONS.replace(dtype=torch.float64, tran_solver="lu")
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        sim = Simulator.from_text(deck, opts=opts, device=dev)
        eq = sim._node_eq("a")
        before = cuda_lu.LAUNCHES
        val, grads = transient_adjoint_gradient(
            sim.engine, sim.params, 5e-9, 1e-7,
            lambda t, x: (x[:, eq] ** 2).sum() * 1e3)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert cuda_lu.LAUNCHES > before + 20
        out[dev.type] = (float(val), {k: v.cpu().numpy()
                                      for k, v in grads.items()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-12)
    for k, want in out["cpu"][1].items():
        if want.size and np.abs(want).max() > 0:
            got = out["cuda"][1][k]
            assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max(), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,R", [(64, 130, 1), (1, 500, 1), (8, 65, 3)])
def test_large_route_matches_plain(cuda_device, dtype, B, n, R):
    """Above K2's 64 unknowns ``lu_solve`` takes ``lu_solve_large`` (chosen
    by N, never on a failure; K2 does not launch): against the plain
    version, a singular lane zeroed in both, lane-relative 1e-10 in f64
    and 1e-3 in f32."""
    rng = np.random.default_rng(n + B)
    A = rng.standard_normal((B, n, n)) + 2.0 * np.sqrt(n) * np.eye(n)
    b = rng.standard_normal((B, n, R))
    if B > 1:
        A[1] = 0.0
    At = torch.as_tensor(A, dtype=dtype, device=cuda_device)
    bt = torch.as_tensor(b, dtype=dtype, device=cuda_device)
    before, calls = cuda_lu.LAUNCHES, tlu.LARGE_CALLS
    x = tlu.lu_solve(At, bt, FLOOR)
    torch.cuda.synchronize()
    assert (cuda_lu.LAUNCHES, tlu.LARGE_CALLS) == (before, calls + 1)
    ref = tlu.lu_solve_plain(At, bt, FLOOR)
    zx, _ = lane_masks(x.cpu().numpy())
    zr, _ = lane_masks(ref.cpu().numpy())
    assert np.array_equal(zx, zr) and (B == 1 or zx[1])
    d = (x - ref).abs().flatten(1).amax(1)
    s = ref.abs().flatten(1).amax(1).clamp_min(1e-30)
    tol = 1e-10 if dtype == torch.float64 else 1e-3
    assert float((d / s)[torch.as_tensor(~zr)].max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("deck", ["ladder", "grid_blockband", "grid_blockwb"])
def test_large_circuit_backends_match_cpu(cuda_device, deck):
    """The large-circuit backends on the card against the port's CPU run
    of the same deck, f64: the DC point and 10 transient steps within
    1e-9 V; K2 solves the Schur corner (it launches)."""
    from circuitsimulator_tpu_torch.synthetic import (rc_grid_netlist,
                                                      rc_ladder_netlist)
    text = {"ladder": rc_ladder_netlist(600, tstop=1e-10),
            "grid_blockband": rc_grid_netlist(20, 20, tstop=1e-10),
            "grid_blockwb": rc_grid_netlist(20, 20, diode_every=30,
                                            tstop=1e-10)}[deck]
    out = {}
    for dev in ("cpu", cuda_device):
        sim = Simulator.from_text(text, device=dev)
        before = cuda_lu.LAUNCHES
        x = sim.dc()
        res = sim.transient(x_op=x)
        out[str(dev)[:4]] = (sim.opts.tran_solver, x.cpu(), res.xs.cpu(),
                             cuda_lu.LAUNCHES - before)
    assert out["cpu"][0] == out["cuda"][0] == {
        "ladder": "tridiag", "grid_blockband": "blockband",
        "grid_blockwb": "blockwb"}[deck]
    assert out["cuda"][3] > 0
    for i in (1, 2):
        assert float((out["cuda"][i] - out["cpu"][i]).abs().max()) <= 1e-9


HB_INV = (".MODEL 2 VT 0.4 MU 1e-2 COX 1e-3 LAMBDA 0.05 CJ0 1e-13\n"
          "VDD 1 0 3\nVin 2 0 SIN 1 0.5 1e8\nRD 1 3 1k\n"
          "M1 3 2 0 n 10e-6 1e-6 2\nC1 3 0 2e-13\nL1 3 4 1e-8\nR4 4 0 1k\n"
          ".hb 1e8 6\n")
HB_TL = ("V1 1 0 SIN 0 1 1e8\nR1 1 2 50\nT1 2 0 3 0 Z0=50 TD=2.5e-9\n"
         "D1 3 0 1\n.MODEL 1 IS 1e-12\nRL 3 0 120\n.hb 1e8 5\n")


@pytest.mark.cuda
@pytest.mark.parametrize("deck", ["inv", "inv_charge", "tline", "dbmixer"])
def test_harmonic_balance_matches_cpu(cuda_device, deck):
    """Dense and GMRES HB on the card against the port's CPU run of the
    same deck, f64, within 1e-9 V with equal Newton counts; the warm-up
    transient's Woodbury solves launch K2; then 3 batched lanes (dense)
    against the CPU's."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.analysis.hb import (
        harmonic_balance, harmonic_balance_batched)
    text, f0, H = {"inv": (HB_INV, 1e8, 6), "inv_charge": (HB_INV, 1e8, 6),
                   "tline": (HB_TL, 1e8, 5),
                   "dbmixer": (open(os.path.join(
                       REPO, "tests/netlists/dbmixer.sp")).read(), 1e8, 5)
                   }[deck]
    opts = DEFAULT_OPTIONS.replace(mos_cap_model="charge") \
        if deck == "inv_charge" else DEFAULT_OPTIONS
    out = {}
    for dev in ("cpu", cuda_device):
        sim = Simulator.from_text(text, opts=opts, device=dev)
        before = cuda_lu.LAUNCHES
        runs = [harmonic_balance(sim.engine, sim.params, f0, n_harm=H,
                                 warmup_periods=2, solver=s)
                for s in ("dense", "gmres")]
        bp = {k: v.expand((3,) + v.shape).clone()
              for k, v in sim.params.items()}
        bp["res_r"] = bp["res_r"] * torch.linspace(
            0.95, 1.05, 3, dtype=torch.float64, device=dev)[:, None]
        rb = harmonic_balance_batched(sim.engine, bp, f0, n_harm=H,
                                      warmup_periods=2)
        out[str(dev)[:4]] = ([(r.xs.cpu(), r.newton_iters) for r in runs],
                             rb.xs.cpu(), cuda_lu.LAUNCHES - before)
    cpu, card = out["cpu"], out["cuda"]
    assert card[2] > 0
    for (xg, ig), (xc, ic) in zip(card[0], cpu[0]):
        assert ig == ic
        assert float((xg - xc).abs().max()) <= 1e-9
    assert float((card[0][1][0] - card[0][0][0]).abs().max()) <= 1e-9
    assert float((card[1] - cpu[1]).abs().max()) <= 1e-9


@pytest.mark.cuda
def test_shooting_and_envelope_match_cpu(cuda_device):
    """Shooting on mixer_rf.sp (64 steps a period; K2 launches for every
    Newton iteration of the lu transient) and the order-2 envelope of
    am_envelope.sp on the card against the CPU, f64, within 1e-9 V."""
    out = {}
    for dev in ("cpu", cuda_device):
        sim = Simulator.from_file(os.path.join(REPO, "examples/mixer_rf.sp"),
                                  device=dev)
        before = cuda_lu.LAUNCHES
        ss = sim.steady_state(steps_per_period=64, warmup_periods=2)
        env = Simulator.from_file(
            os.path.join(REPO, "examples/am_envelope.sp"), device=dev
        ).envelope(5e-7, 1e-7, n_harm=5, order=2, warmup_periods=1)
        out[str(dev)[:4]] = (ss.xs.cpu(), ss.newton_iters, env.xs,
                             cuda_lu.LAUNCHES - before)
    cpu, card = out["cpu"], out["cuda"]
    assert card[3] > 0 and card[1] == cpu[1]
    assert float((card[0] - cpu[0]).abs().max()) <= 1e-9
    assert float(np.abs(card[2] - cpu[2]).max()) <= 1e-9


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.mark.cuda
def test_pac_family_matches_cpu(cuda_device):
    """The periodic small-signal analyses of mixer_rf.sp around the port's
    own HB steady state (the PSS path launches K2): PAC, PXF, PNOISE, the
    mixer noise figure, the hot S-parameters and pnoise_batched over three
    lanes; the envelope noise of am_envelope.sp and pnoise on the T-line
    deck.  Card against CPU, f64, within 1e-9 of each result's largest
    magnitude."""
    from circuitsimulator_tpu_torch.analysis.pac import pnoise_batched
    d = [1e5, 1e6]
    out = {}
    for dev in ("cpu", cuda_device):
        sim = Simulator.from_file(os.path.join(REPO, "examples/mixer_rf.sp"),
                                  device=dev)
        before = cuda_lu.LAUNCHES
        pss = sim._pss_samples(sim.params, 1e7, None, warmup_periods=2)
        k2 = cuda_lu.LAUNCHES - before
        r = {"pss": pss.cpu().numpy(),
             "pac": sim.pac(d, pss_xs=pss).spectrum,
             "pxf": sim.pxf(d, "if", pss_xs=pss).xf_v,
             "pnoise": sim.pnoise(d, "if", pss_xs=pss).onoise,
             "nf": sim.mixer_noise_figure("Rrf", 1e5, "if", pss_xs=pss),
             "psp": sim.hot_sparams([("if", None, 50.0)], d,
                                    pss_xs=pss).s}
        bp = {k: v.expand((3,) + v.shape).clone()
              for k, v in sim.params.items()}
        bp["res_r"] = bp["res_r"] * torch.linspace(
            0.95, 1.05, 3, dtype=torch.float64, device=dev)[:, None]
        eq = sim.circuit.nodes[sim.circuit.node_name_to_id["if"]].eq_index
        r["pnoise_b"] = pnoise_batched(sim.engine, bp, 1e7,
                                       pss.expand((3,) + pss.shape), d,
                                       eq).onoise
        am = Simulator.from_file(os.path.join(REPO, "examples/am_envelope.sp"),
                                 device=dev)
        env = am.envelope(3e-7, 1e-7, n_harm=5, warmup_periods=1)
        r["envnoise"] = am.envelope_noise(d, "out", env=env).onoise
        tl = Simulator.from_text(HB_TL, device=dev)
        r["tline"] = tl.pnoise(d, "3", f0=1e8, n_harm=5,
                               warmup_periods=2).onoise
        out[str(dev)[:4]] = (r, k2)
    (cpu, _), (card, k2) = out["cpu"], out["cuda"]
    assert k2 > 0
    assert float(np.abs(card["pss"] - cpu["pss"]).max()) <= 1e-9
    for k in cpu:
        assert _rel_err(card[k], cpu[k]) <= 1e-9, k
