"""Tests of the PyTorch port that need an NVIDIA GPU (marked ``cuda``; they
skip without one).  This file imports no JAX, so it also runs where JAX is
not installed; run it there without the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

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
@pytest.mark.parametrize("B,n,R", [(1, 4, 1), (300, 6, 1), (300, 31, 1),
                                   (64, 31, 31)])
def test_lu_kernel_matches_plain(cuda_device, dtype, B, n, R):
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
    before = cuda_lu.LAUNCHES
    x = tlu.lu_solve(At, bt, FLOOR)
    torch.cuda.synchronize()
    assert cuda_lu.LAUNCHES == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,F", [(1, 1, 3), (7, 5, 4), (300, 31, 8),
                                   (40, 64, 3)])
def test_ac_sweep_kernel_matches_plain(cuda_device, dtype, B, n, F):
    """K3 against its plain version on the card: identical fail masks,
    lane-relative error <= 1e-12 (f64) and <= 1e-4 (f32)."""
    from circuitsimulator_tpu_torch.ops import ac_sweep, cuda_ac
    arrays = ac_lanes(max(B, 3), n, seed=n + F)
    arrays = [a[:B] for a in arrays]
    G, B1, br, bi = (torch.as_tensor(a, dtype=dtype, device=cuda_device)
                     for a in arrays)
    # omega <= 1 keeps the lanes diagonally dominant for the f32 bar
    om = torch.as_tensor(np.logspace(-1, 0, F), dtype=dtype,
                         device=cuda_device)
    before = cuda_ac.LAUNCHES
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
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert lane_rel_err(x, ref, good) <= tol


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
