"""Tridiagonal and bordered-tridiagonal solvers by cyclic reduction (port
of ``circuitsimulator_tpu/ops/tridiag.py``).

For a ladder (the 10k-node RC ladder with its diode chain of
``synthetic.rc_ladder_netlist``) the MNA node block is tridiagonal: node i
couples only to nodes i - 1, i + 1 and ground.  Dense LU is O(N^3) and
unusable at N = 10^4; cyclic reduction is O(N) work in O(log N) depth,
built from strided slices and elementwise ops, so it runs over batch lanes
as whole-tensor operations.

V-source and inductor branch equations attach as a thin border:

    [ T   U ] [x]   [f]        T: (N, N) tridiagonal, m = #branches
    [ W   D ] [y] = [g]

solved by the Schur complement on the m x m corner: m + 1 CR solves with
T and one small dense solve through ``ops/lu.lu_solve`` (the K2 kernel on
CUDA for m <= 64).

Stability: plain CR without pivoting, exact for the diagonally dominant
systems a ladder gives (C/dt + 1/R + gmin + diode conductance on the
diagonal); callers choose it only for detected ladders (``ops/banded``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .lu import lu_solve
from ..utils.shapes import broadcast_shapes


def _pad_pow2(a, b, c, d):
    """Pad the system to a power-of-two size with decoupled identity rows."""
    N = a.shape[-1]
    M = 1 << max(int(math.ceil(math.log2(max(N, 1)))), 0)
    if M == N:
        return a, b, c, d, N
    pad = M - N

    def padded(x, fill):
        return F.pad(x, (0, pad), value=fill)

    return padded(a, 0.0), padded(b, 1.0), padded(c, 0.0), padded(d, 0.0), N


def _shift_r(x, s, fill):
    """Value of neighbour i - s at position i (one launch)."""
    return F.pad(x[..., :-s], (s, 0), value=fill)


def _shift_l(x, s, fill):
    """Value of neighbour i + s at position i (one launch)."""
    return F.pad(x[..., s:], (0, s), value=fill)


def cr_solve(a, b, c, d):
    """Solve the tridiagonal system
        a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i]   (a[0] = c[N-1] = 0)
    by cyclic reduction.  All tensors (..., N); batch dims broadcast."""
    a, b, c, d, N = _pad_pow2(a, b, c, d)
    levels = []
    while a.shape[-1] > 1:
        # split into even (kept) and odd (eliminated) equations
        ae, be, ce, de = a[..., ::2], b[..., ::2], c[..., ::2], d[..., ::2]
        ao, bo, co, do = a[..., 1::2], b[..., 1::2], c[..., 1::2], d[..., 1::2]
        levels.append((ao, bo, co, do))
        # even equation k couples to odd k - 1 (left) and odd k (right)
        a_l, b_l = _shift_r(ao, 1, 0.0), _shift_r(bo, 1, 1.0)
        c_l, d_l = _shift_r(co, 1, 0.0), _shift_r(do, 1, 0.0)
        alpha = ae * (1.0 / b_l)
        gamma = ce * (1.0 / bo)
        a, b, c, d = (-alpha * a_l, be - alpha * c_l - gamma * ao,
                      -gamma * co, de - alpha * d_l - gamma * do)
    x = d / b                   # one unknown left
    for ao, bo, co, do in reversed(levels):
        # x_odd[k] = (d_o[k] - a_o[k] x_even[k] - c_o[k] x_even[k+1]) / b_o[k]
        x_right = _shift_l(x, 1, 0.0)
        x_odd = (do - ao * x - co * x_right) / bo
        # equal halves at every level (power-of-two padding): interleave
        shape = broadcast_shapes(x.shape, x_odd.shape)
        x = torch.stack([x.expand(shape), x_odd.expand(shape)],
                        -1).reshape(shape[:-1] + (2 * shape[-1],))
    return x[..., :N]


def pcr_solve(a, b, c, d):
    """Parallel cyclic reduction: the system of ``cr_solve``, with both
    neighbours eliminated from every equation at every level, so there is
    no back-substitution sweep: about log2(N) stages instead of CR's
    2 log2(N), each a fixed-size elementwise pass (O(N log N) work).  Same
    diagonal-dominance caveat as ``cr_solve``."""
    a, b, c, d, N = _pad_pow2(a, b, c, d)
    M = a.shape[-1]
    s = 1
    while s < M:
        am, bm, cm, dm = (_shift_r(a, s, 0.0), _shift_r(b, s, 1.0),
                          _shift_r(c, s, 0.0), _shift_r(d, s, 0.0))
        ap, bp, cp, dp = (_shift_l(a, s, 0.0), _shift_l(b, s, 1.0),
                          _shift_l(c, s, 0.0), _shift_l(d, s, 0.0))
        alpha = -a / bm
        gamma = -c / bp
        b = b + alpha * cm + gamma * ap
        d = d + alpha * dm + gamma * dp
        a = alpha * am
        c = gamma * cp
        s *= 2
    return (d / b)[..., :N]


def bordered_solve(a, b, c, U, W, D, f, g, algo: str = "cr"):
    """Solve the bordered system [[T, U], [W, D]] [x; y] = [f; g].

    T tridiagonal as (a, b, c) (..., N); U (..., N, m), W (..., m, N),
    D (..., m, m), f (..., N), g (..., m).  Returns (x, y)."""
    solve = pcr_solve if algo == "pcr" else cr_solve
    m = D.shape[-1]
    if m == 0:
        return solve(a, b, c, f), g[..., :0]
    # solve T [z0 | Z] = [f | U] with m + 1 stacked CR solves
    lead = broadcast_shapes(f.shape[:-1], U.shape[:-2])
    rhs = torch.cat([f.expand(lead + f.shape[-1:])[..., None],
                     U.expand(lead + U.shape[-2:])], -1)       # (..., N, m+1)
    sols = solve(a[..., None, :], b[..., None, :], c[..., None, :],
                 rhs.transpose(-1, -2))                        # (..., m+1, N)
    z0 = sols[..., 0, :]
    Z = sols[..., 1:, :].transpose(-1, -2)                     # (..., N, m)
    S = D - W @ Z                                              # (..., m, m)
    y = lu_solve(S, g - (W @ z0[..., None])[..., 0])
    x = z0 - (Z @ y[..., None])[..., 0]
    return x, y
