"""Dense LU solve with partial pivoting and the reference's fail contract.

Behavioral contract (reference include/solver.hpp:30-131, JAX twin
``circuitsimulator_tpu/ops/lu.py:_lu_solve_unrolled``):

- Doolittle elimination with partial (row) pivoting on the first index of
  the largest |A[i, k]|, i >= k (a NaN counts as largest, as in argmax);
- if the smallest column maximum is below ``pivot_floor`` the lane returns
  the zero vector (a NaN column maximum is not below it, so NaN propagates
  and drives the DC non-finite branch);
- back substitution maps a diagonal with |d| < pivot_floor to x_j = 0.

``lu_solve_plain`` is the plain PyTorch version (any device);
``lu_solve`` dispatches a CPU tensor to it and a CUDA tensor to the
hand-written kernel (``ops/cuda_lu.py``) for N <= ``cuda_lu.MAX_N``, or
raises.  Above that size a CUDA tensor takes ``lu_solve_large``, chosen
by N alone and never on a failure of the kernel.
"""

from __future__ import annotations

import torch

from . import cuda_lu
from ..utils.shapes import broadcast_shapes


def _as_columns(A, b):
    """Broadcast (..., N, N) x (..., N) | (..., N, R) to a common lead shape;
    returns (A, B (..., N, R), was_vector)."""
    vec = b.dim() == A.dim() - 1
    bm = b.unsqueeze(-1) if vec else b
    N = A.shape[-1]
    lead = A.shape[:-2]
    if bm.shape[:-2] != lead:
        lead = broadcast_shapes(lead, bm.shape[:-2])
    return (A.expand(lead + (N, N)), bm.expand(lead + bm.shape[-2:]), vec)


@torch.inference_mode()
def lu_solve_plain(A, b, pivot_floor: float = 1e-15):
    """Plain batched solve: A (..., N, N), b (..., N) or (..., N, R)."""
    N = A.shape[-1]
    if N == 0:
        return b
    A, B, vec = _as_columns(A, b)
    # augmented [A | B]: one row swap and one update per column serve both
    M = torch.cat([A, B], dim=-1)
    lead = M.shape[:-2]
    W = M.shape[-1]
    on_cpu = M.device.type == "cpu"
    rows, cols = M.unbind(-2), M.unbind(-1)     # views, one call each
    bests = []
    for k in range(N):
        m = N - k - 1
        # max with indices: the first largest |A[i, k]| (a NaN counts as
        # largest); the smallest of these decides the fail-to-zero below
        best, p = cols[k].narrow(-1, k, N - k).abs().max(-1, keepdim=True)
        bests.append(best)
        rowk = rows[k]
        # swap rows k <-> k + p (row k is written last, so p == 0 is a
        # no-op); on the CPU a batch where no lane swaps skips it (the check
        # would be a device sync on a GPU)
        if not on_cpu or bool(p.any()):
            ip = p.add_(k).unsqueeze_(-1).expand(lead + (1, W))
            rowp = M.gather(-2, ip)
            M.scatter_(-2, ip, rowk.unsqueeze(-2).clone())
            rowk.copy_(rowp.squeeze(-2))
        pivot = rowk.narrow(-1, k, 1)                           # (..., 1)
        safe = pivot.masked_fill(pivot == 0.0, 1.0)
        f = (cols[k].narrow(-1, k + 1, m) / safe).unsqueeze(-1)  # (..., m, 1)
        M.narrow(-2, k + 1, m).narrow(-1, k + 1, W - k - 1).sub_(
            f * rowk.narrow(-1, k + 1, W - k - 1).unsqueeze(-2))
    d = M.diagonal(dim1=-2, dim2=-1).unsqueeze(-1)              # (..., N, 1)
    dsafe = d.masked_fill(d == 0.0, 1.0).unbind(-2)
    dzero = (d.abs() < pivot_floor).unbind(-2)
    x = torch.zeros(lead + (N, W - N), dtype=M.dtype, device=M.device)
    xrows = x.unbind(-2)
    for j in range(N - 1, -1, -1):
        m = N - j - 1
        acc = (rows[j].narrow(-1, j + 1, m).unsqueeze(-1)
               * x.narrow(-2, j + 1, m)).sum(-2)
        xj = (rows[j].narrow(-1, N, W - N) - acc) / dsafe[j]
        xrows[j].copy_(xj.masked_fill_(dzero[j], 0.0))
    minpiv = torch.cat(bests, -1).amin(-1)
    x.masked_fill_((minpiv < pivot_floor)[..., None, None], 0.0)
    return x[..., 0] if vec else x


LARGE_CALLS = 0     # lu_solve_large calls made by lu_solve on CUDA tensors


@torch.inference_mode()
def lu_solve_large(A, b, pivot_floor: float = 1e-15):
    """The solve of systems above K2's size: A (..., N, N), b (..., N) or
    (..., N, R), any device.  ``torch.linalg.lu_factor_ex`` (partial
    pivoting) and ``torch.linalg.lu_solve``, with the fail contract applied
    from U's diagonal: a lane whose smallest |U_jj| (its smallest pivot) is
    below ``pivot_floor`` returns the zero vector; a NaN pivot is not below
    it, so a NaN in A goes through as in ``lu_solve_plain``.

    A library call in place of a library call: what this replaces in the
    JAX package, ``circuitsimulator_tpu/ops/lu.py:_lu_solve_looped``, is
    XLA code, not a Pallas kernel (the Pallas LU takes N <= 64)."""
    N = A.shape[-1]
    if N == 0:
        return b
    A, B, vec = _as_columns(A, b)
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    x = torch.linalg.lu_solve(LU, piv, B)
    minpiv = LU.diagonal(dim1=-2, dim2=-1).abs().amin(-1)
    x = x.masked_fill((minpiv < pivot_floor)[..., None, None], 0.0)
    return x[..., 0] if vec else x


def lu_solve(A, b, pivot_floor: float = 1e-15):
    """Batched solve; CPU tensors take the plain version, CUDA tensors the
    K2 kernel (every leading axis is flattened into the kernel's lanes; a
    strided or broadcast input is made contiguous here, and the kernel
    reads it in place without writing it), or ``lu_solve_large`` when N is
    above the kernel's ``cuda_lu.MAX_N``."""
    global LARGE_CALLS
    if A.device.type == "cpu" and b.device.type == "cpu":
        return lu_solve_plain(A, b, pivot_floor)
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"lu_solve: unsupported devices {A.device}, {b.device}")
    N = A.shape[-1]
    if N == 0:
        return b
    if N > cuda_lu.MAX_N:
        LARGE_CALLS += 1
        return lu_solve_large(A, b, pivot_floor)
    if A.dim() == 3 and b.dim() in (2, 3) and b.shape[:2] == A.shape[:2]:
        # the batched callers' shapes: no broadcast, one lead axis
        vec = b.dim() == 2
        x = cuda_lu.lu_solve_cuda(
            A.contiguous(), (b.unsqueeze(-1) if vec else b).contiguous(),
            pivot_floor)
        return x[..., 0] if vec else x
    A, B, vec = _as_columns(A, b)
    lead = A.shape[:-2]
    R = B.shape[-1]
    x = cuda_lu.lu_solve_cuda(A.reshape(-1, N, N).contiguous(),
                              B.reshape(-1, N, R).contiguous(), pivot_floor)
    x = x.reshape(lead + (N, R))
    return x[..., 0] if vec else x


def lu_inverse(A, pivot_floor: float = 1e-15):
    """Dense inverse (..., N, N): one factorisation per matrix with the N
    identity columns as right-hand sides (same fail contract)."""
    N = A.shape[-1]
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    return lu_solve(A, eye.expand(A.shape[:-2] + (N, N)), pivot_floor)


class _LUSolveDiff(torch.autograd.Function):
    """x = A^-1 b with the implicit reverse rule: lambda = A^-T xbar (a
    second ``lu_solve``: K2 on CUDA tensors), bbar = lambda, Abar =
    -lambda x^T.  A lane that the forward zeroed by the fail contract (a
    zero x from a non-zero b) gets zero cotangents, as JAX's ``jnp.where``
    gives them when it differentiates ``_lu_solve_unrolled``."""

    @staticmethod
    def forward(ctx, A, b, pivot_floor):
        x = lu_solve(A, b, pivot_floor).clone()    # not an inference tensor
        ctx.pivot_floor = pivot_floor
        ctx.save_for_backward(A, b, x)
        return x

    @staticmethod
    def backward(ctx, xbar):
        A, b, x = ctx.saved_tensors
        vec = b.dim() == A.dim() - 1
        lam = lu_solve(A.mT, xbar, ctx.pivot_floor).clone()
        xm, bm, lm = ((v.unsqueeze(-1) if vec else v) for v in (x, b, lam))
        zeroed = (xm == 0).all(-1).all(-1) & (bm != 0).any(-1).any(-1)
        lm = lm.masked_fill(zeroed[..., None, None], 0.0)
        Abar = -(lm @ xm.mT)
        bbar = lm[..., 0] if vec else lm
        # summed over any axis that an input was broadcast along
        return Abar.sum_to_size(A.shape), bbar.sum_to_size(b.shape), None


def lu_solve_diff(A, b, pivot_floor: float = 1e-15):
    """``lu_solve`` that autograd differentiates (the differentiable AC
    solve's route): forward and backward each one ``lu_solve`` (so above
    ``cuda_lu.MAX_N`` on CUDA, each one ``lu_solve_large``)."""
    return _LUSolveDiff.apply(A, b, pivot_floor)
