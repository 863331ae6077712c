"""Block cyclic reduction for bordered block-tridiagonal systems (port of
``circuitsimulator_tpu/ops/blockcr.py``).

The block form of ``ops/tridiag.py``: the system

    L[i] X[i-1] + D[i] X[i] + U[i] X[i+1] = F[i]     (L[0] = U[nb-1] = 0)

with dense k x k blocks is reduced level by level: each level eliminates
the odd blocks with batched k x k solves and k x k matmuls, halving the
block count, so nb blocks take O(log2 nb) stages of O(nb k^3) work in all.
Within a block ``torch.linalg.solve_ex`` pivots (the JAX package calls
``jnp.linalg.solve`` there: a library call in place of a library call);
across blocks there is no pivoting, exact for the diagonally dominant
systems MNA gives.  The border

    [ T   Ub ] [x]   [f]       T block-tridiagonal, mb small
    [ Wb  Db ] [y] = [g]

is eliminated by a Schur complement whose mb x mb solve goes through
``ops/lu.lu_solve`` (the K2 kernel on CUDA for mb <= 64), with its fail
contract.
"""

from __future__ import annotations

import math

import torch
from torch.nn.functional import pad as _pad

from .lu import lu_inverse, lu_solve
from ..utils.shapes import broadcast_shapes


def _solve(A, B):
    """A^-1 B, batched, without the host sync of an error check (a
    singular block gives non-finite values, as ``jnp.linalg.solve`` does)."""
    shape = broadcast_shapes(A.shape[:-2], B.shape[:-2])
    return torch.linalg.solve_ex(A.expand(shape + A.shape[-2:]),
                                 B.expand(shape + B.shape[-2:]))[0]


def _inv(A):
    return torch.linalg.inv_ex(A)[0]


def _shift_dn(X, fill_eye: bool = False):
    """Value of block neighbour i - 1 at position i (block axis -3)."""
    Y = _pad(X[..., :-1, :, :], (0, 0, 0, 0, 1, 0))
    if fill_eye:
        Y[..., 0, :, :].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    return Y


def _shift_up(X):
    """Value of block neighbour i + 1 at position i (block axis -3)."""
    return _pad(X[..., 1:, :, :], (0, 0, 0, 0, 0, 1))


def _rsolve(B, A):
    """A @ B^-1 through a batched (partially pivoted) solve."""
    return _solve(B.transpose(-1, -2), A.transpose(-1, -2)).transpose(-1, -2)


def _pad_pow2_blocks(L, D, U, F):
    nb = D.shape[-3]
    M = 1 << max(int(math.ceil(math.log2(max(nb, 1)))), 0)
    if M == nb:
        return L, D, U, F, nb
    pad = M - nb
    k = D.shape[-1]

    def zpad(X):
        return _pad(X, (0, 0, 0, 0, 0, pad))

    eye = torch.eye(k, dtype=D.dtype, device=D.device).expand(
        D.shape[:-3] + (pad, k, k))
    return zpad(L), torch.cat([D, eye], dim=-3), zpad(U), zpad(F), nb


def _interleave(X, Xo):
    """Even blocks X and odd blocks Xo back into block order."""
    shape = broadcast_shapes(X.shape, Xo.shape)
    return torch.stack([X.expand(shape), Xo.expand(shape)], dim=-3).reshape(
        shape[:-3] + (2 * shape[-3],) + shape[-2:])


def block_cr_solve(L, D, U, F):
    """Solve the block-tridiagonal system.  L/D/U (..., nb, k, k); F (...,
    nb, k, q): q right-hand sides solved together."""
    L, D, U, F, nb = _pad_pow2_blocks(L, D, U, F)
    levels = []
    while D.shape[-3] > 1:
        Le, De, Ue, Fe = (L[..., ::2, :, :], D[..., ::2, :, :],
                          U[..., ::2, :, :], F[..., ::2, :, :])
        Lo, Do, Uo, Fo = (L[..., 1::2, :, :], D[..., 1::2, :, :],
                          U[..., 1::2, :, :], F[..., 1::2, :, :])
        levels.append((Lo, Do, Uo, Fo))
        # the left odd neighbour of even block e is odd block e - 1
        Ll, Dl = _shift_dn(Lo), _shift_dn(Do, fill_eye=True)
        Ul, Fl = _shift_dn(Uo), _shift_dn(Fo)
        alpha = _rsolve(Dl, Le)          # couples to X_{e-1, odd}
        gamma = _rsolve(Do, Ue)          # couples to X_{e, odd} (right)
        L = -alpha @ Ll
        D = De - alpha @ Ul - gamma @ Lo
        U = -gamma @ Uo
        F = Fe - alpha @ Fl - gamma @ Fo
    X = _solve(D, F)
    for Lo, Do, Uo, Fo in reversed(levels):
        # X_odd[e] = D_o[e]^-1 (F_o[e] - L_o[e] X_even[e] - U_o[e] X_even[e+1])
        X = _interleave(X, _solve(Do, Fo - Lo @ X - Uo @ _shift_up(X)))
    return X[..., :nb, :, :]


def bordered_block_solve(L, D, U, Ub, Wb, Db, f, g,
                         pivot_floor: float = 1e-15):
    """Solve [[T, Ub], [Wb, Db]] [x; y] = [f; g] with T block-tridiagonal.

    L/D/U (..., nb, k, k); Ub (..., n_pad, mb); Wb (..., mb, n_pad); Db
    (..., mb, mb); f (..., n_pad); g (..., mb).  Returns (x, y) with x
    (..., n_pad) in interior-slot order and y (..., mb)."""
    nb, k = D.shape[-3], D.shape[-1]
    mb = Db.shape[-1]
    batch = broadcast_shapes(D.shape[:-3], f.shape[:-1], Ub.shape[:-2])
    fb = f.expand(batch + f.shape[-1:])
    if mb == 0:
        x = block_cr_solve(L, D, U, fb.reshape(batch + (nb, k, 1)))
        return x.reshape(batch + (nb * k,)), g[..., :0]
    rhs = torch.cat([fb[..., None], Ub.expand(batch + Ub.shape[-2:])], -1)
    sols = block_cr_solve(L, D, U, rhs.reshape(batch + (nb, k, mb + 1)))
    sols = sols.reshape(batch + (nb * k, mb + 1))
    z0, Z = sols[..., 0], sols[..., 1:]     # (..., n_pad), (..., n_pad, mb)
    S = Db - Wb @ Z                         # (..., mb, mb)
    y = lu_solve(S, g - (Wb @ z0[..., None])[..., 0], pivot_floor)
    x = z0 - (Z @ y[..., None])[..., 0]
    return x, y


# ---------------------------------------------------------------------
# Pre-factored form: T is factored once per transient (the companion
# matrix is constant while dt is fixed); each Newton iteration's solve is
# then O(nb k^2) matmul work instead of block_cr_solve's O(nb k^3)
# re-elimination.  The nonlinear devices ride rank-one Woodbury rows over
# this base (ops/woodbury.py, solve_op=).
# ---------------------------------------------------------------------

def block_cr_factor(L, D, U):
    """Factor the block-tridiagonal T for ``block_cr_apply``: per CR level
    (alpha, gamma, Lo, Uo, inv(Do)); the explicit odd-block inverses make
    the back substitution pure batched matmuls (safe for the reason that
    cross-block non-pivoting is: diagonal dominance)."""
    k = D.shape[-1]
    F0 = D.new_zeros(D.shape[:-2] + (k, 0))
    L, D, U, _, nb = _pad_pow2_blocks(L, D, U, F0)
    levels = []
    while D.shape[-3] > 1:
        Le, De, Ue = L[..., ::2, :, :], D[..., ::2, :, :], U[..., ::2, :, :]
        Lo, Do, Uo = L[..., 1::2, :, :], D[..., 1::2, :, :], U[..., 1::2, :, :]
        Ll, Dl = _shift_dn(Lo), _shift_dn(Do, fill_eye=True)
        Ul = _shift_dn(Uo)
        alpha = _rsolve(Dl, Le)
        gamma = _rsolve(Do, Ue)
        levels.append((alpha, gamma, Lo, Uo, _inv(Do)))
        L = -alpha @ Ll
        D = De - alpha @ Ul - gamma @ Lo
        U = -gamma @ Uo
    return {"levels": levels, "invD_root": _inv(D), "nb": nb}


def block_cr_apply(fac, F):
    """Solve T X = F with ``block_cr_factor``'s output; F (..., nb, k, q).
    Matmuls only (the factorisation's inverses are applied, not redone)."""
    nb = fac["nb"]
    M = fac["invD_root"].shape[-3] * (2 ** len(fac["levels"]))
    pad = M - F.shape[-3]
    if pad:
        F = _pad(F, (0, 0, 0, 0, 0, pad))
    saved = []
    for alpha, gamma, _, _, _ in fac["levels"]:
        Fe, Fo = F[..., ::2, :, :], F[..., 1::2, :, :]
        saved.append(Fo)
        F = Fe - alpha @ _shift_dn(Fo) - gamma @ Fo
    X = fac["invD_root"] @ F
    for (_, _, Lo, Uo, invDo), Fo in zip(reversed(fac["levels"]),
                                         reversed(saved)):
        X = _interleave(X, invDo @ (Fo - Lo @ X - Uo @ _shift_up(X)))
    return X[..., :nb, :, :]


def bordered_block_factor(L, D, U, Ub, Wb, Db, pivot_floor: float = 1e-15):
    """Factor [[T, Ub], [Wb, Db]]: block-CR factors of T and the border's
    Schur pieces Z = T^-1 Ub and S = Db - Wb Z, S kept as an explicit
    inverse (``ops/lu.lu_inverse``: K2 on CUDA for mb <= 64; mb is small)."""
    nb, k = D.shape[-3], D.shape[-1]
    mb = Db.shape[-1]
    fac = block_cr_factor(L, D, U)
    out = {"cr": fac, "nb": nb, "k": k, "mb": mb, "Wb": Wb}
    if mb:
        Z = block_cr_apply(fac, Ub.reshape(Ub.shape[:-2] + (nb, k, mb)))
        Z = Z.reshape(Z.shape[:-3] + (nb * k, mb))
        out["Z"] = Z
        out["Sinv"] = lu_inverse(Db - Wb @ Z, pivot_floor)
    return out


def bordered_block_apply_cols(bfac, F, G):
    """Solve with ``bordered_block_factor``'s output for q right-hand sides
    at once: F (..., n_pad, q), G (..., mb, q).  Returns (X (..., n_pad,
    q) in interior-slot order, Y (..., mb, q)); the columns ride the last
    axis, so lane axes of the factors broadcast against F's."""
    nb, k, mb = bfac["nb"], bfac["k"], bfac["mb"]
    q = F.shape[-1]
    Z0 = block_cr_apply(bfac["cr"], F.reshape(F.shape[:-2] + (nb, k, q)))
    Z0 = Z0.reshape(Z0.shape[:-3] + (nb * k, q))
    if mb == 0:
        return Z0, G[..., :0, :]
    Y = bfac["Sinv"] @ (G - bfac["Wb"] @ Z0)
    return Z0 - bfac["Z"] @ Y, Y


def bordered_block_apply(bfac, f, g):
    """Solve with ``bordered_block_factor``'s output; f (..., n_pad), g
    (..., mb).  Returns (x in interior-slot order, y)."""
    x, y = bordered_block_apply_cols(bfac, f[..., None], g[..., None])
    return x[..., 0], y[..., 0]
