"""Harmonic-balance sensitivities by implicit differentiation (port of
``circuitsimulator_tpu/analysis/hb_diff.py``).

The converged HB system F(X*; p) = 0 defines X*(p), so for a scalar
metric m(X, p)

    dm/dp = dm/dp|_X - lambda^T dF/dp,      J^T lambda = (dm/dX)^T,

one transposed HB-Jacobian solve (the analytic blockdiag(A_t) + kron(D, C)
form) and one reverse pass of the residual through the parameters
(``torch.autograd.grad``): the cost does not grow with the number of
parameters.  The residual and Jacobian are the Newton solvers' own
(``hb.make_hb_system``, ``hbmulti.make_hbmulti_system``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..ops.assemble import Engine
from .hb import make_hb_system


def _implicit_grads(engine: Engine, params, X, m_of, residual, jacobian):
    """(value, grads) of m_of(X, float leaves) at the converged X of
    residual(X, params) = 0: a gradient for every float leaf, zeros (in
    the engine's dtype) for the integer leaves."""
    fkeys = [k for k, v in params.items() if v.is_floating_point()]
    rest = {k: v for k, v in params.items() if k not in fkeys}
    with torch.inference_mode(False), torch.enable_grad():
        pf = {k: params[k].detach().clone().requires_grad_(True)
              for k in fkeys}
        Xv = X.detach().clone().requires_grad_(True)
        val = m_of(Xv, pf)
        leaves = [Xv] + [pf[k] for k in fkeys]
        g = torch.autograd.grad(val, leaves, allow_unused=True)
        mX = g[0] if g[0] is not None else torch.zeros_like(Xv)
        mp = dict(zip(fkeys, g[1:]))
        with torch.no_grad():
            pd = {**{k: pf[k].detach() for k in fkeys}, **rest}
            _, A_t = residual(Xv.detach(), pd, with_At=True)
            J = jacobian(A_t, pd)
            lam = torch.linalg.solve(J.transpose(-1, -2), mX.reshape(-1))
        res = residual(Xv.detach(), {**pf, **rest})
        pbar = torch.autograd.grad(res, [pf[k] for k in fkeys],
                                   grad_outputs=-lam.reshape(res.shape),
                                   allow_unused=True)
    grads = {}
    for k, a, b in zip(fkeys, (mp[k] for k in fkeys), pbar):
        parts = [t for t in (a, b) if t is not None]
        grads[k] = (sum(parts).detach() if parts
                    else torch.zeros_like(params[k]))
    for k, v in rest.items():
        grads[k] = torch.zeros(v.shape, dtype=engine.dtype, device=v.device)
    return float(val.detach()), grads


def hb_gradient(engine: Engine, params, f0: float, n_harm: int,
                m_fn: Callable, x_star=None, gmin: float = 0.0, **hb_kw):
    """(value, grads) of m_fn(X, ts) over the converged HB solution: m_fn
    takes the (K, N) grid samples and the (K,) sample times.  x_star may
    pass a solved HBResult.xs to skip the forward solve."""
    from .hb import harmonic_balance
    if x_star is None:
        x_star = harmonic_balance(engine, params, f0, n_harm=n_harm,
                                  **hb_kw).xs
    ts, residual, jacobian = make_hb_system(engine, f0, n_harm, gmin=gmin)
    X = torch.as_tensor(x_star, dtype=engine.dtype, device=engine.device)

    def m_of(Xv, pv):
        return m_fn(Xv, ts)

    return _implicit_grads(engine, params, X, m_of, residual, jacobian)


def hbmulti_gradient(engine: Engine, params, tones, m_fn: Callable,
                     x_star=None, **hb_kw):
    """(value, grads) of m_fn(X, Ks) over the converged multi-tone HB
    solution (the tone assignment pinned to the nominal SIN
    frequencies)."""
    from .hbmulti import harmonic_balance_multi, make_hbmulti_system
    if x_star is None:
        x_star = harmonic_balance_multi(engine, params, tones, **hb_kw).xs
    Ks, _, residual, jacobian = make_hbmulti_system(engine, tones, params)
    X = torch.as_tensor(x_star, dtype=engine.dtype,
                        device=engine.device).reshape(int(np.prod(Ks)),
                                                      engine.N)

    def m_of(Xv, pv):
        return m_fn(Xv, Ks)

    return _implicit_grads(engine, params, X, m_of, residual, jacobian)


def mixed_harmonic_metric(eq_index: int, harmonics):
    """m_fn: the one-sided amplitude 2 |c| of the mixed harmonic (k_1, ...,
    k_D) of x[eq_index] on the multi-tone grid, by cos/sin projections."""

    def m_fn(X, Ks):
        Xg = X.reshape(tuple(Ks) + (X.shape[-1],))
        y = Xg[..., eq_index]
        ph = 0.0
        for d, (K, k) in enumerate(zip(Ks, harmonics)):
            idx = torch.arange(K, dtype=X.dtype, device=X.device)
            shape = [1] * len(Ks)
            shape[d] = K
            ph = ph + (2.0 * math.pi * k * idx / K).reshape(shape)
        re = (y * torch.cos(ph)).sum() / y.numel()
        im = -(y * torch.sin(ph)).sum() / y.numel()
        return 2.0 * torch.sqrt(re * re + im * im)

    return m_fn


def fundamental_metric(eq_index: int, harmonic: int = 1):
    """m_fn: the one-sided amplitude of the given harmonic of x[eq_index]
    by explicit cos/sin projections of the grid samples (hb.py's
    spectrum convention)."""

    def m_fn(X, ts):
        K = X.shape[0]
        k = torch.arange(K, dtype=X.dtype, device=X.device)
        c = torch.cos(2.0 * math.pi * harmonic * k / K)
        s = torch.sin(2.0 * math.pi * harmonic * k / K)
        y = X[:, eq_index]
        re = (y * c).sum() * (2.0 / K)
        im = (y * s).sum() * (2.0 / K)
        return torch.sqrt(re * re + im * im)

    return m_fn
