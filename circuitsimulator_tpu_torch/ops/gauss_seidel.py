"""Gauss-Seidel iterative solve (port of
``circuitsimulator_tpu/ops/gauss_seidel.py``).

Behavioral contract (reference include/solver.hpp:139-204):
- warm-startable (x0); a diagonal with |d| < 1e-12 is replaced by a
  sign-preserving 1e-12 (a non-negative zero counts as positive);
- one sweep updates x in place (j < i uses new values, j > i old ones);
- stops when the sweep-to-sweep 2-norm delta is below tol or after
  max_iters sweeps.

A sweep is the forward substitution (D + L) x' = b - U x_old: the same
recurrence as the row loop, one triangular solve per sweep.  Leading lane
axes run together; a lane stops where its own loop would (its x is frozen
once its delta is below tol), the sweeps run while any lane goes on.
"""

from __future__ import annotations

import torch

from ..utils.shapes import broadcast_shapes


@torch.inference_mode()
def gauss_seidel_solve(A, b, x0=None, max_iters=1000, tol=1e-10,
                       diag_eps=1e-12):
    N = A.shape[-1]
    if N == 0:
        return b
    lead = broadcast_shapes(A.shape[:-2], b.shape[:-1])
    A = A.expand(lead + (N, N))
    x = (torch.zeros_like(b) if x0 is None else x0).expand(lead + (N,))
    diag = A.diagonal(dim1=-2, dim2=-1)
    sign = torch.where(diag >= 0.0, 1.0, -1.0).to(A.dtype)
    diag_reg = torch.where(diag.abs() < diag_eps, sign * diag_eps, diag)
    lower = A.tril(-1) + torch.diag_embed(diag_reg)
    upper = A.triu(1)
    bb = b.expand(lead + (N,))[..., None]
    done = torch.zeros(lead, dtype=torch.bool, device=A.device)
    for _ in range(int(max_iters)):
        x_new = torch.linalg.solve_triangular(
            lower, bb - upper @ x[..., None], upper=False)[..., 0]
        err = torch.linalg.vector_norm(x_new - x, dim=-1)
        x = torch.where(done[..., None], x, x_new)
        done = done | ~(err >= tol)     # a NaN delta stops, as in JAX
        if bool(done.all()):
            break
    return x
