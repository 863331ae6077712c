"""FORM worst-case analysis: the most-probable-failure-point search (port
of ``circuitsimulator_tpu/analysis/form.py``), on the reverse-
differentiable transient (``analysis/adjoint.diff_transient``), DC
(``adjoint.diff_dc``) and small-signal solve.

The lognormal Monte-Carlo model maps a standard-normal z to the parameters
p_j = nominal_j exp(sigma_j z_j) (``parallel/montecarlo._z_layout``
order).  With a limit state g (g < 0 = failure; the nominal must pass) the
most probable failure point is z* = argmin ||z||^2 s.t. g(z) = 0, found by
the Hasofer-Lind / Rackwitz-Fiessler iteration

    z_{k+1} = (grad g . z_k - g(z_k)) grad g / ||grad g||^2,

each step one differentiable run (forward, then the adjoint sweep).  The
reliability index beta = ||z*|| gives the FORM estimate Phi(-beta), and
alpha = z* / beta is the importance-sampling shift and design-centering
direction.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch

from ..ops.assemble import Engine
from ..ops.lu import lu_solve_diff
from .adjoint import diff_dc, diff_transient
from .measure_diff import diff_measure, diff_measure_ac, interp


def _phi_tail(beta: float) -> float:
    return 0.5 * math.erfc(beta / math.sqrt(2.0))


def _ac_solution(engine: Engine, params, x_op, freqs):
    """(xr, xi), each (F, N): every frequency assembled on its own
    (``ac_system_real``) and the F real 2N systems [[G, -B], [B, G]]
    solved by one ``lu_solve_diff`` (K2 on CUDA tensors, forward and
    backward), differentiable in params and x_op."""
    from .ac import ac_system_real
    N = engine.N
    systems = [ac_system_real(engine, params, x_op, 2.0 * math.pi * f)
               for f in freqs]
    G, B, br, bi = (torch.stack([s[q] for s in systems]) for q in range(4))
    M = torch.cat([torch.cat([G, -B], -1), torch.cat([B, G], -1)], -2)
    x = lu_solve_diff(M, torch.cat([br, bi], -1), engine.opts.lu_pivot_floor)
    return x[..., :N], x[..., N:]


def _limit_fn(engine: Engine, params, rel_sigma, tstep, tstop, fn,
              analysis: str, freqs):
    """(names, sizes, dims, f(base, z) -> scalar): ``fn`` of the
    differentiable run at the parameters base * exp(sigma z)."""
    from ..parallel.montecarlo import _z_layout
    names, sizes, dims = _z_layout(params, rel_sigma)
    if not names:
        raise ValueError("rel_sigma names no perturbable parameter")
    dtype, dev = engine.dtype, engine.device

    def params_of_z(base, z):
        out = dict(base)
        off = 0
        for n, sz in zip(names, sizes):
            col = z[off:off + sz].reshape(base[n].shape)
            out[n] = base[n] * torch.exp(rel_sigma[n] * col.to(base[n].dtype))
            off += sz
        return out

    if analysis == "ac":
        if freqs is None:
            raise ValueError("analysis='ac' needs freqs")
        fr = torch.as_tensor(np.asarray(freqs, np.float64), dtype=dtype,
                             device=dev)

        def f(base, z):
            p = params_of_z(base, z)
            xr, xi = _ac_solution(engine, p, diff_dc(engine, p), fr)
            return torch.as_tensor(fn(fr, xr, xi), dtype=dtype, device=dev)
    elif analysis == "dc":
        def f(base, z):
            return torch.as_tensor(fn(diff_dc(engine, params_of_z(base, z))),
                                   dtype=dtype, device=dev)
    else:
        def f(base, z):
            times, xs = diff_transient(engine, params_of_z(base, z), tstep,
                                       tstop)
            return torch.as_tensor(fn(times, xs), dtype=dtype, device=dev)
    return names, sizes, dims, f, params_of_z


def _value_and_grad(f, z):
    """(f(z), df/dz), both detached; a z-independent f has gradient 0."""
    z = z.detach().requires_grad_()
    val = f(z)
    g = (torch.autograd.grad(val, z, allow_unused=True)[0]
         if val.requires_grad else None)
    return val.detach(), (torch.zeros_like(z) if g is None else g)


def mpp_search(engine: Engine, params, rel_sigma: Mapping[str, float],
               tstep, tstop, g_fn: Callable, max_iter: int = 25,
               tol: float = 1e-6, damping: float = 1.0, design_grads=None,
               analysis: str = "tran", freqs=None, sorm: bool = False,
               sorm_step: float = 1e-3):
    """Most-probable-failure-point search (HL-RF) in the z-space of
    ``rel_sigma``.  g_fn takes the differentiable transient's (times, xs)
    (analysis="tran"), the polished DC point x_op ("dc"), or (freqs, xr,
    xi) of the differentiable small-signal solve at ``freqs`` linearised
    at the differentiable DC point ("ac"); g < 0 is failure.

    Returns a dict: beta, p_fail = Phi(-beta), z_star, alpha, params_star
    (the worst-case parameters, on the failure boundary), dims, names,
    g_nominal, n_iter, converged.  design_grads (a list of leaf names):
    also dbeta = (dg/dp) / ||grad_z g|| at the MPP, the design-centering
    gradient, and grad_z_norm.  sorm=True adds Breitung's second-order
    estimate p_fail_sorm (and sorm_det) from the boundary's curvatures,
    the Hessian of g by central differences of the adjoint gradient
    (2 dims extra runs)."""
    names, _, dims, g_of, params_of_z = _limit_fn(
        engine, params, rel_sigma, tstep, tstop, g_fn, analysis, freqs)
    dtype, dev = engine.dtype, engine.device

    def g_grad(z):
        return _value_and_grad(lambda z_: g_of(params, z_), z)

    z = torch.zeros((dims,), dtype=dtype, device=dev)
    g0 = None
    converged = False
    it = 0
    for it in range(1, max_iter + 1):
        val, grad = g_grad(z)
        if g0 is None:
            g0 = float(val)
            if g0 < 0:
                raise ValueError(
                    f"nominal design already fails (g(0) = {g0:.3g}); "
                    "FORM needs a passing nominal")
        gg = float(torch.dot(grad, grad))
        if not math.isfinite(gg) or gg == 0.0:
            break
        z_new = (torch.dot(grad, z) - val) * grad / gg
        if damping != 1.0:
            z_new = z + damping * (z_new - z)
        step = float(torch.linalg.vector_norm(z_new - z))
        z = z_new
        if step < tol * max(1.0, float(torch.linalg.vector_norm(z))):
            converged = True
            break
    beta = float(torch.linalg.vector_norm(z))
    alpha = z / beta if beta > 0 else z
    extras = {}
    if sorm and beta > 0 and dims >= 1:
        _, grad_star = g_grad(z)
        gnorm = float(torch.linalg.vector_norm(grad_star))
        # the Hessian of g at the MPP by central differences of the exact
        # adjoint gradient
        h = sorm_step * max(beta, 1.0)
        H = np.zeros((dims, dims))
        for i in range(dims):
            e = torch.zeros((dims,), dtype=dtype, device=dev)
            e[i] = h
            _, gp = g_grad(z + e)
            _, gm = g_grad(z - e)
            H[i] = ((gp - gm) / (2.0 * h)).cpu().numpy()
        H = 0.5 * (H + H.T)
        if dims > 1:
            # tangent basis orthogonal to alpha (QR of [alpha | I]); for
            # Breitung's form g = beta + sum k_i z_i^2 / 2 - z_n the tangent
            # Hessian over |grad g| is diag(k), p = Phi(-beta) prod (1 +
            # beta k_i)^(-1/2)
            a = alpha.cpu().numpy().reshape(dims, 1)
            Q, _ = np.linalg.qr(np.concatenate([a, np.eye(dims)], axis=1))
            Tt = Q[:, 1:dims]
            A = (Tt.T @ H @ Tt) / gnorm
            det = float(np.linalg.det(np.eye(dims - 1) + beta * A))
        else:
            det = 1.0
        extras["p_fail_sorm"] = (_phi_tail(beta) / math.sqrt(det) if det > 0
                                 else None)            # extreme curvature
        extras["sorm_det"] = det
    if design_grads:
        # FORM design sensitivity at the MPP: dbeta/dp = (dg/dp) / |grad g|
        _, grad_z = g_grad(z)
        gnorm = float(torch.linalg.vector_norm(grad_z))
        leaves = {k: params[k].detach().clone().requires_grad_()
                  for k in design_grads}
        val = g_of({**params, **leaves}, z)
        got = torch.autograd.grad(val, list(leaves.values()),
                                  allow_unused=True)
        extras["dbeta"] = {k: (torch.zeros_like(leaves[k]) if g is None
                               else g) / gnorm
                           for k, g in zip(leaves, got)}
        extras["grad_z_norm"] = gnorm
    with torch.no_grad():
        params_star = params_of_z(params, z)
    return {
        **extras,
        "beta": beta,
        "p_fail": _phi_tail(beta),
        "z_star": z,
        "alpha": alpha,
        "params_star": params_star,
        "dims": dims,
        "names": names,
        "g_nominal": g0,
        "n_iter": it,
        "converged": converged,
    }


def mismatch_budget(engine: Engine, params, rel_sigma: Mapping[str, float],
                    tstep, tstop, m_fn: Callable, analysis: str = "tran",
                    freqs=None):
    """Linearised variance decomposition of a scalar metric over the
    mismatch space: one adjoint pass gives dM/dz_j of every dimension at
    the nominal point, Var[M] ~ sum_j (dM/dz_j)^2, and each dimension's
    share is its squared gradient over the sum.  m_fn as ``mpp_search``'s
    g_fn for the same analysis.  Returns a dict: m_nominal, sigma_m,
    grad_z and contributions, a list of (param_name, index_within_leaf,
    variance_share) sorted by share, largest first."""
    names, sizes, dims, m_of, _ = _limit_fn(
        engine, params, rel_sigma, tstep, tstop, m_fn, analysis, freqs)
    m0, grad = _value_and_grad(
        lambda z: m_of(params, z),
        torch.zeros((dims,), dtype=engine.dtype, device=engine.device))
    g2 = grad ** 2
    var = float(g2.sum())
    shares = (g2 / var if var > 0 else g2).cpu().numpy()
    contributions = []
    off = 0
    for n, sz in zip(names, sizes):
        for i in range(sz):
            contributions.append((n, i, float(shares[off + i])))
        off += sz
    contributions.sort(key=lambda c: -c[2])
    return {
        "m_nominal": float(m0),
        "sigma_m": math.sqrt(var),
        "grad_z": grad,
        "contributions": contributions,
    }


def _window(v, low, high):
    """min(v - low, high - v) over the bounds given (g < 0: outside)."""
    gs = []
    if low is not None:
        gs.append(v - low)
    if high is not None:
        gs.append(high - v)
    return gs[0] if len(gs) == 1 else torch.minimum(*gs)


def _need_bound(low, high):
    if low is None and high is None:
        raise ValueError("need at least one bound")


def limit_state_measure(m, topo, low=None, high=None):
    """Limit state on a deck's ``.MEASURE TRAN`` card (the differentiable
    measure layer): g < 0 when the value leaves (low, high)."""
    _need_bound(low, high)
    f = diff_measure(m, topo)
    return lambda times, xs: _window(f(times, xs), low, high)


def limit_state_measure_ac(m, topo, low=None, high=None):
    """Limit state on a deck's ``.MEASURE AC`` card: g < 0 when the value
    leaves (low, high)."""
    _need_bound(low, high)
    f = diff_measure_ac(m, topo)
    return lambda freqs, xr, xi: _window(f(freqs, xr, xi), low, high)


def limit_state_dc(eq_index: int, low=None, high=None):
    """Limit state on a DC node voltage x_op[eq_index] against (low,
    high)."""
    _need_bound(low, high)
    return lambda x_op: _window(x_op[eq_index], low, high)


def limit_state_ac_mag(eq_index: int, low=None, high=None,
                       f_index: int = 0):
    """Limit state on |V(node)| at freqs[f_index] against (low, high)."""
    _need_bound(low, high)
    return lambda freqs, xr, xi: _window(
        torch.sqrt(xr[f_index, eq_index] ** 2 + xi[f_index, eq_index] ** 2),
        low, high)


def limit_state_find_at(eq_index: int, t_at: float, low=None, high=None):
    """Limit state for a ``FIND V(node) AT=t`` spec: xs[:, eq_index]
    interpolated at t_at, against (low, high)."""
    _need_bound(low, high)
    return lambda times, xs: _window(interp(t_at, times, xs[:, eq_index]),
                                     low, high)
