"""Restarted GMRES with the least-squares solve at the end of each restart
(the counterpart of ``jax.scipy.sparse.linalg.gmres(...,
solve_method="batched")``, which the JAX harmonic-balance solvers call).

The algorithm is JAX's, step for step (``jax/_src/scipy/sparse/linalg.py``,
``_gmres_solve``, ``_gmres_batched``, ``_kth_arnoldi_iteration``):

- the preconditioned residual M(b - A x0) starts the Krylov basis; a
  restart runs while its norm is above atol = max(tol ||b||, atol) and
  fewer than ``maxiter`` restarts have run (``maxiter`` defaults to 10 n,
  ``restart`` is capped at n);
- Arnoldi step k: v = M(A(V[:, k])), one classical Gram-Schmidt pass
  against every column of V (JAX's ``_iterative_classical_gram_schmidt``
  with ``max_iterations=2`` stops after its first pass: its loop
  condition is ``k < max_iterations - 1`` after the first body), then v is
  normalised with the threshold eps ||v|| (below it the vector is zero and
  the restart breaks down; its Hessenberg row stays the identity row);
- the Hessenberg system H^T y = ||r|| e_1 is solved in least squares by
  the normal equations and a Cholesky solve (JAX's ``_lstsq``);
- the preconditioner is applied on the left, as in JAX.

Every vector is (..., n): the leading axes are independent lanes (JAX's
``vmap`` of the solver), each lane with its own breakdown and stopping
rules; a lane that has stopped keeps its values while the others go on.
``sync=False`` runs every restart of every lane with masks and no host
sync (the batched factories); the default stops the restart loop on the
host once no lane is active, which gives the same result."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _safe_normalize(x, thresh=None):
    """(x / ||x||, ||x||), or (0, 0) where ||x|| <= thresh (default eps)."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    unit = torch.where(use[..., None], x / torch.where(use, norm, 1.0)[..., None],
                       0.0)
    return unit, torch.where(use, norm, 0.0)


def _gmres_restart(A, b, x0, unit_residual, residual_norm, restart: int, M):
    """One restart: the ``restart``-dimensional Krylov basis, then the
    least-squares projection (JAX's ``_gmres_batched``)."""
    lead, n = b.shape[:-1], b.shape[-1]
    dtype, dev = b.dtype, b.device
    eps = torch.finfo(dtype).eps
    V = torch.zeros(lead + (n, restart + 1), dtype=dtype, device=dev)
    V[..., 0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=dtype,
                  device=dev).expand(lead + (restart, restart + 1)).clone()
    breakdown = torch.zeros(lead, dtype=torch.bool, device=dev)
    for k in range(restart):
        live = ~breakdown
        v = M(A(V[..., k]))
        _, v_norm_0 = _safe_normalize(v)
        h = torch.einsum("...nr,...n->...r", V, v)
        v = v - torch.einsum("...nr,...r->...n", V, h)
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        h = h.clone()
        h[..., k + 1] = v_norm_1
        liv = live[..., None]
        V[..., k + 1] = torch.where(liv, unit_v, V[..., k + 1])
        H[..., k, :] = torch.where(liv, h, H[..., k, :])
        breakdown = breakdown | (live & (v_norm_1 == 0.0))
    beta = torch.zeros(lead + (restart + 1,), dtype=dtype, device=dev)
    beta[..., 0] = residual_norm
    # JAX's _lstsq: (a^T a) y = a^T beta with a = H^T, by Cholesky
    a2 = H @ H.transpose(-1, -2)
    b2 = (H @ beta[..., None])
    L, info = torch.linalg.cholesky_ex(a2)
    y = torch.cholesky_solve(b2, L)[..., 0]
    y = torch.where((info == 0)[..., None], y, float("nan"))
    x = x0 + torch.einsum("...nr,...r->...n", V[..., :-1], y)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm


def gmres(A: Callable, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
          restart: int = 20, maxiter: Optional[int] = None,
          M: Optional[Callable] = None, sync: bool = True):
    """Solve A x = b for x (..., n); A and M map (..., n) to (..., n)."""
    n = b.shape[-1]
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        def M(v):
            return v
    if maxiter is None:
        maxiter = 10 * n
    restart = min(int(restart), n)
    atol_ = torch.clamp_min(tol * _norm(b), atol)
    unit, rnorm = _safe_normalize(M(b - A(x0)))
    x = x0
    active = rnorm > atol_
    for _ in range(int(maxiter)):
        if sync and not bool(active.any()):
            break
        xn, un, rn = _gmres_restart(A, b, x, unit, rnorm, restart, M)
        act = active[..., None]
        x = torch.where(act, xn, x)
        unit = torch.where(act, un, unit)
        rnorm = torch.where(active, rn, rnorm)
        active = active & (rnorm > atol_)
    return x
