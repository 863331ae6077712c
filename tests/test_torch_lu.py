"""K2 (batched pivoted LU) in the PyTorch port: the plain version against the
JAX solvers on the CPU, and the CPU dispatch.  The CUDA kernel against the
plain version is in test_torch_cuda.py, which imports no JAX."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from circuitsimulator_tpu.ops.lu import lu_solve_batched
from circuitsimulator_tpu.ops.pallas_lu import lu_solve_pallas_batched
from circuitsimulator_tpu_torch.ops import cuda_lu
from circuitsimulator_tpu_torch.ops import lu as tlu

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

FLOOR = 1e-15
_jax_lu = jax.jit(lu_solve_batched, static_argnums=2)


def jax_lu(A, b):
    return np.asarray(_jax_lu(jnp.asarray(A), jnp.asarray(b), FLOOR))


def systems(B, n, seed=0, R=None):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    b = rng.standard_normal((B, n) if R is None else (B, n, R))
    return A, b


def plain(A, b):
    return tlu.lu_solve_plain(torch.as_tensor(A), torch.as_tensor(b),
                              FLOOR).numpy()


def lane_masks(x):
    """(all-zero lanes, lanes holding a NaN): the fail and NaN contracts."""
    flat = x.reshape(x.shape[0], -1)
    return np.all(flat == 0.0, axis=1), np.any(np.isnan(flat), axis=1)


@pytest.mark.parametrize("B,n", [(1, 4), (7, 13), (130, 31), (64, 8)])
def test_plain_lu_matches_jax_reference(B, n):
    # f64, rtol 1e-12 (same elimination arithmetic; the back-substitution
    # dot sums in another order), and the zero-lane masks must agree
    A, b = systems(B, n, seed=n)
    A[0] = A[0][::-1]                      # a lane that must pivot
    if B > 2:
        A[1][:, 2] = 0.0                   # singular lane -> zeros
    x = plain(A, b)
    ref = jax_lu(A, b)
    np.testing.assert_allclose(x, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(lane_masks(x)[0], lane_masks(ref)[0])


@pytest.mark.parametrize("B,n", [(1, 4), (7, 13), (64, 8)])
def test_plain_lu_matches_pallas_interpret(B, n):
    A, b = systems(B, n, seed=n)
    x = plain(A, b)
    ref = np.asarray(lu_solve_pallas_batched(jnp.asarray(A), jnp.asarray(b),
                                             interpret=True, lane_block=256))
    np.testing.assert_allclose(x, ref, rtol=1e-9, atol=1e-10)


def test_plain_lu_pivoting_singular_and_floor_lanes():
    A = np.array([[[0.0, 1.0], [1.0, 1.0]]] * 4)
    b = np.tile([2.0, 3.0], (4, 1))
    A[1] = 0.0                              # singular
    A[2] *= 1e-16                           # every pivot below the floor
    x = plain(A, b)
    np.testing.assert_allclose(x[[0, 3]], np.tile([1.0, 2.0], (2, 1)),
                               rtol=1e-12)
    np.testing.assert_array_equal(x[1:3], np.zeros((2, 2)))
    ref = np.asarray(lu_solve_pallas_batched(jnp.asarray(A), jnp.asarray(b),
                                             interpret=True))
    np.testing.assert_array_equal(lane_masks(x)[0], lane_masks(ref)[0])


@pytest.mark.parametrize("n", [4, 31])
def test_plain_lu_nan_lane_propagates_like_ops_lu(n):
    # ops/lu.py keeps a NaN column maximum (NaN < floor is False) so NaN
    # reaches x and drives the DC non-finite branch; the Pallas kernel
    # zeroes such a lane instead (a recorded reference-side deviation)
    A, b = systems(5, n, seed=3)
    A[2, n // 2, 1] = np.nan
    x = plain(A, b)
    ref = jax_lu(A, b)
    zx, nx = lane_masks(x)
    zr, nr = lane_masks(ref)
    np.testing.assert_array_equal(nx, nr)
    np.testing.assert_array_equal(zx, zr)
    assert nx[2] and not nx[[0, 1, 3, 4]].any()
    good = ~nr
    np.testing.assert_allclose(x[good], ref[good], rtol=1e-12, atol=1e-12)


def test_plain_lu_multi_rhs_and_inverse():
    A, b = systems(6, 7, seed=11, R=3)
    x = plain(A, b)
    for r in range(3):
        np.testing.assert_allclose(x[..., r], plain(A, b[..., r]),
                                   rtol=1e-14, atol=1e-15)
    inv = tlu.lu_inverse(torch.as_tensor(A), FLOOR).numpy()
    np.testing.assert_allclose(inv, np.linalg.inv(A), rtol=1e-10, atol=1e-12)


def test_cpu_dispatch_never_touches_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CPU tensor reached the CUDA wrapper")
    monkeypatch.setattr(cuda_lu, "lu_solve_cuda", boom)
    before = cuda_lu.LAUNCHES
    A, b = systems(3, 5, seed=2)
    x = tlu.lu_solve(torch.as_tensor(A), torch.as_tensor(b), FLOOR).numpy()
    np.testing.assert_array_equal(x, plain(A, b))
    assert cuda_lu.LAUNCHES == before


def test_cuda_wrapper_rejects_cpu_tensors():
    A, b = systems(2, 3, seed=4, R=1)
    with pytest.raises(ValueError):
        cuda_lu.lu_solve_cuda(torch.as_tensor(A), torch.as_tensor(b))


@pytest.mark.parametrize("itemsize", [4, 8])
def test_cuda_plan_fits_a_block(itemsize):
    # the launcher's plan for every N the kernel takes, with one, N and 2N
    # right-hand sides: the smallest capacity that holds N, a team of that
    # many threads, the shared memory of the kernel's layout (factors in
    # rows of cap + 1, the RHS tile, perm; at cap 64 the arg-max slots)
    # within one H100 block
    for N in range(1, cuda_lu.MAX_N + 1):
        for R in (1, N, 2 * N):
            p = cuda_lu.plan(N, R, itemsize)
            assert p.cap == min(c for c in (8, 16, 32, 64) if c >= N)
            assert p.team == p.cap
            assert p.spb >= 1 and (p.cap < 64 or p.spb == 1)
            assert p.threads <= (64 if p.cap == 64 else 256) <= 1024
            assert p.threads % 32 == 0
            assert p.rt == R
            big = p.cap == 64
            need = (itemsize * (N * (p.cap + 1) + N * R
                                + (4 if big else 0))
                    + 4 * (p.cap + (4 if big else 0)))
            assert need <= p.team_bytes < need + 16
            assert p.team_bytes % 16 == 0
            assert p.smem <= 232448
    wide = cuda_lu.plan(64, 1000, itemsize)      # tiles of 2 x cap columns
    assert wide.rt == 128 and wide.smem <= 232448


def test_cuda_plan_refuses_n_above_64():
    for N in (0, cuda_lu.MAX_N + 1):
        with pytest.raises(ValueError):
            cuda_lu.plan(N, 1, 4)
