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
