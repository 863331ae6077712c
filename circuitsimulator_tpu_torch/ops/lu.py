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
hand-written kernel (``ops/cuda_lu.py``), or raises.
"""

from __future__ import annotations

import torch

from . import cuda_lu


def _as_columns(A, b):
    """Broadcast (..., N, N) x (..., N) | (..., N, R) to a common lead shape;
    returns (A, B (..., N, R), was_vector)."""
    vec = b.dim() == A.dim() - 1
    bm = b.unsqueeze(-1) if vec else b
    N = A.shape[-1]
    lead = A.shape[:-2]
    if bm.shape[:-2] != lead:
        lead = torch.broadcast_shapes(lead, bm.shape[:-2])
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


def lu_solve(A, b, pivot_floor: float = 1e-15):
    """Batched solve; CPU tensors take the plain version, CUDA tensors the
    K2 kernel (every leading axis is flattened into the kernel's lanes; a
    strided or broadcast input is made contiguous here, and the kernel
    reads it in place without writing it)."""
    if A.device.type == "cpu" and b.device.type == "cpu":
        return lu_solve_plain(A, b, pivot_floor)
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"lu_solve: unsupported devices {A.device}, {b.device}")
    N = A.shape[-1]
    if N == 0:
        return b
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
