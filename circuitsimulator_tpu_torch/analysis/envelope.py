"""Envelope-following transient: modulated-carrier simulation on two time
scales (port of ``circuitsimulator_tpu/analysis/envelope.py``).

The bivariate MPDE form f(x(t1, t2)) + C [d/dt1 + d/dt2] x = b(t1, t2),
with t2 the fast carrier axis (K = 2H+1 spectral samples of T = 1/f0, the
HB grid) and t1 the slow envelope axis stepped by backward Euler (order 1)
or the trapezoidal rule (order 2) with step dt_env.  Each envelope step is
one HB-sized Newton solve:

    r_env(X_n) = r_hb(X_n) - b_env(t1_n) + C (X_n - X_{n-1}) / dt = 0,
    J_env      = J_hb + kron(I_K, C) / dt,

r_hb/J_hb being the HB system with every source zeroed (the residual is
linear in the source RHS) and b_env the two-timescale source RHS: a SIN at
>= f0/2 rides the fast axis (evaluated at t2), every other waveform and
every DC term the slow one (at t1).  The t1 = 0 state is the periodic
steady state with the slow sources frozen at t = 0, from a warm-up
transient as in ``harmonic_balance``; x0_xs starts from a given (K, N)
state instead.  The dense (K N)^2 step solves are ``torch.linalg.solve_ex``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Optional

import numpy as np
import torch

from ..netlist import WAVE_SIN
from ..ops.assemble import Engine
from .dc import dc_operating_point
from .hb import (_mos_charge_pieces, _reactive_structure, hb_system,
                 one_sided, source_values, warmup_samples)


_V_SRC_ZERO = ("vs_dc", "vs_pulse", "vs_sin", "vs_pwl_v")
_I_SRC_ZERO = ("is_dc", "is_pulse", "is_sin", "is_pwl_v")


@dataclasses.dataclass
class EnvelopeResult:
    f0: float
    t1: np.ndarray            # (T1,) envelope time grid (0 = initial PSS)
    xs: Any                   # (T1, K, N) envelope sample trajectories
    freqs: np.ndarray         # (H+1,) harmonic frequencies
    coeffs: np.ndarray        # (T1, H+1, N) one-sided complex envelopes
    converged: np.ndarray     # (T1,) per-step Newton convergence
    residuals: np.ndarray     # (T1,) final Newton residual norms


@dataclasses.dataclass
class EnvelopeBatchResult:
    f0: float
    t1: np.ndarray            # (T1+1,) envelope time points
    xs: Any                   # (B, T1+1, K, N) waveform samples per lane
    freqs: np.ndarray         # (H+1,)
    coeffs: np.ndarray        # (B, T1+1, H+1, N) complex envelopes
    converged: np.ndarray     # (B,) every step of the lane converged
    residuals: np.ndarray     # (B, T1+1) final Newton residual per step


def _fast_masks(engine: Engine, params, f0: float):
    """Per-source fast-axis masks: SIN waveforms at >= f0/2 (a fast source
    is evaluated on the period grid, so a frequency that is not a harmonic
    of f0 warns: it would alias)."""
    vs = params["vs_sin"].detach().cpu().numpy()
    is_ = params["is_sin"].detach().cpu().numpy()
    fv = (engine.vs_kinds == WAVE_SIN) & (vs[:, 2] >= 0.5 * f0)
    fi = (engine.is_kinds == WAVE_SIN) & (is_[:, 2] >= 0.5 * f0)
    for mask, sin, tag in ((fv, vs, "V"), (fi, is_, "I")):
        freqs = sin[:, 2][mask]
        ratio = freqs / f0
        bad = np.abs(ratio - np.round(ratio)) > 1e-6 * np.maximum(ratio, 1.0)
        if np.any(bad):
            warnings.warn(
                f"envelope: fast-axis {tag}-source SIN frequencies "
                f"{freqs[bad].tolist()} are not harmonics of f0={f0:g}; "
                "they will be phase-wrapped onto the period grid "
                "(aliased). Use a slow (baseband) source or adjust f0.",
                stacklevel=3)
    dev = engine.device
    return (torch.as_tensor(fv, device=dev), torch.as_tensor(fi, device=dev))


def _b_env_fn(engine: Engine, params, ts, fv, fi):
    """b_env(t1) -> (..., K, N): fast waveforms at the K period samples,
    slow waveforms (and every DC term) at t1; params may carry a lane
    axis."""
    zp = dict(params)
    zp["vs_dc"] = torch.zeros_like(params["vs_dc"])
    zp["is_dc"] = torch.zeros_like(params["is_dc"])
    fast = [source_values(engine, zp, t) for t in ts]
    vf = torch.stack([v for v, _ in fast], -2)           # (..., K, nV)
    if_ = torch.stack([i for _, i in fast], -2)
    vdc = params["vs_dc"][..., None, :]
    idc = params["is_dc"][..., None, :]

    def b_env(t1):
        vw, iw = source_values(engine, zp, t1)
        vval = torch.where(fv, vf + vdc, (params["vs_dc"] + vw)[..., None, :])
        ival = torch.where(fi, if_ + idc, (params["is_dc"] + iw)[..., None, :])
        return engine.source_rhs(vval, ival)[..., :engine.N]

    return b_env


def _zero_sources(params):
    p = dict(params)
    for k in _V_SRC_ZERO + _I_SRC_ZERO:
        p[k] = torch.zeros_like(params[k])
    return p


@torch.inference_mode()
def envelope_transient(engine: Engine, params, f0: float, t_stop: float,
                       dt_env: float, n_harm: int = 7,
                       x0_xs: Optional[Any] = None,
                       tol: float = 1e-9, max_newton: int = 25,
                       warmup_periods: int = 6,
                       order: int = 1) -> EnvelopeResult:
    """Envelope transient to t_stop in steps of dt_env: order=1 backward
    Euler, order=2 the trapezoidal rule (theta = 1/2 averaging of the
    algebraic residual)."""
    if order not in (1, 2):
        raise ValueError("order must be 1 (BE) or 2 (trapezoidal)")
    theta = 1.0 if order == 1 else 0.5
    dtype, dev = engine.dtype, engine.device
    N = engine.N
    H = int(n_harm)
    K = 2 * H + 1
    T = 1.0 / f0
    system = hb_system(engine, f0, n_harm)
    ctx0 = system.prepare(_zero_sources(params))
    fv, fi = _fast_masks(engine, params, f0)
    mos_q = engine.mos_charge
    C_struct = _reactive_structure(engine, params, base_only=mos_q)
    b_env = _b_env_fn(engine, params, system.ts, fv, fi)

    def t1_reactive(X, Xprev, inv_dt):
        r1 = inv_dt * ((X - Xprev) @ C_struct.T)
        if not mos_q:
            return r1, None
        qn, Cq = _mos_charge_pieces(engine, params, X)
        qp, _ = _mos_charge_pieces(engine, params, Xprev)
        return r1 + inv_dt * (qn - qp), inv_dt * Cq

    def r_alg(X, t1):
        return system.residual_ctx(X, ctx0) - b_env(t1)

    def newton(X, Xprev, r_prev, t1, inv_dt):
        r, A_t = system.residual_ctx(X, ctx0, True)
        r1, Cq1 = t1_reactive(X, Xprev, inv_dt)
        r = theta * (r - b_env(t1)) + (1.0 - theta) * r_prev + r1
        J = (theta * system.jacobian_ctx(A_t, ctx0)).reshape(K, N, K, N)
        blk = J.diagonal(0, 0, 2)                        # (N, N, K)
        blk += (inv_dt * C_struct)[..., None]
        if Cq1 is not None:
            blk += Cq1.movedim(0, -1)
        dX = torch.linalg.solve_ex(J.reshape(K * N, K * N),
                                   -r.reshape(-1))[0].reshape(K, N)
        return X + dX, torch.linalg.vector_norm(r)

    def solve_at(X, Xprev, r_prev, t1, inv_dt):
        t1 = torch.as_tensor(t1, dtype=dtype, device=dev)
        inv_dt = torch.as_tensor(inv_dt, dtype=dtype, device=dev)
        res = math.inf
        for _ in range(max_newton):
            X_new, rn = newton(X, Xprev, r_prev, t1, inv_dt)
            res = float(rn)
            if not math.isfinite(res):
                break
            X = X_new
            if res < tol:
                break
        return X, res

    if x0_xs is not None:
        X = torch.as_tensor(x0_xs, dtype=dtype, device=dev)
        if tuple(X.shape) != (K, N):
            raise ValueError(f"x0_xs must be (K={K}, N={N})")
        res0 = 0.0
    else:
        x0 = dc_operating_point(engine, params)
        Xw = warmup_samples(engine, params, x0, T, K, warmup_periods)
        zero = torch.zeros((K, N), dtype=dtype, device=dev)
        X, res0 = solve_at(Xw, zero, zero, 0.0, 0.0)

    n_steps = int(round(t_stop / dt_env))
    t1s = np.arange(n_steps + 1) * dt_env
    xs = [X]
    resids = [res0]
    inv_dt = 1.0 / dt_env
    r_prev = (r_alg(X, torch.zeros((), dtype=dtype, device=dev))
              if theta < 1.0 else torch.zeros((K, N), dtype=dtype,
                                               device=dev))
    for n in range(1, n_steps + 1):
        X, res = solve_at(X, X, r_prev, t1s[n], inv_dt)
        if theta < 1.0:
            r_prev = r_alg(X, torch.as_tensor(t1s[n], dtype=dtype,
                                              device=dev))
        xs.append(X)
        resids.append(res)
    xs = torch.stack(xs).cpu().numpy()                  # (T1, K, N)
    resids = np.asarray(resids)
    return EnvelopeResult(
        f0=f0, t1=t1s, xs=xs, freqs=np.arange(H + 1) * f0,
        coeffs=one_sided(torch.as_tensor(xs), 1).numpy(),
        converged=resids < max(tol * 100, 1e-6), residuals=resids)


def make_envelope_batched_fn(engine: Engine, f0: float, t_stop: float,
                             dt_env: float, n_harm: int = 7,
                             n_newton: int = 10, tol: float = 1e-9,
                             warmup_periods: int = 6, fast_masks=None):
    """(t1s, fn) with fn(bparams, x0s) -> (Xs (B, T1+1, K, N), resid (B,
    T1+1)): the whole envelope run (warm-up transient, the t1 = 0 PSS,
    the backward-Euler envelope steps) over the lanes at once, a fixed
    n_newton per step with per-lane freeze and no host sync.  fast_masks
    (fv, fi): the fast/slow split, from the nominal lane (it cannot vary
    per lane); by default from lane 0."""
    dtype, dev = engine.dtype, engine.device
    N = engine.N
    H = int(n_harm)
    K = 2 * H + 1
    T = 1.0 / f0
    system = hb_system(engine, f0, n_harm)
    n_steps = int(round(t_stop / dt_env))
    t1s = np.arange(n_steps + 1) * dt_env
    mos_q = engine.mos_charge

    @torch.inference_mode()
    def fn(bp, x0s):
        B = x0s.shape[0]
        ctx = system.prepare(_zero_sources(bp))
        ps = ctx["ps"]
        fv, fi = (fast_masks if fast_masks is not None
                  else _fast_masks(engine, {k: v[0] for k, v in bp.items()},
                                   f0))
        C_struct = _reactive_structure(engine, bp, base_only=mos_q)
        b_env = _b_env_fn(engine, bp, system.ts, fv, fi)

        def newton_iters(X, Xprev, t1, inv_dt):
            if mos_q:
                qp, _ = _mos_charge_pieces(engine, ps, Xprev)
            res = torch.full((B,), math.inf, dtype=dtype, device=dev)
            done = torch.zeros(B, dtype=torch.bool, device=dev)
            for _ in range(n_newton):
                r, A_t = system.residual_ctx(X, ctx, True)
                r = (r - b_env(t1)
                     + inv_dt * ((X - Xprev) @ C_struct.transpose(-1, -2)))
                J = system.jacobian_ctx(A_t, ctx).reshape(B, K, N, K, N)
                blk = J.diagonal(0, 1, 3)                # (B, N, N, K)
                blk += (inv_dt * C_struct)[..., None]
                if mos_q:
                    qn, Cq = _mos_charge_pieces(engine, ps, X)
                    r = r + inv_dt * (qn - qp)
                    blk += (inv_dt * Cq).movedim(1, -1)
                dX = torch.linalg.solve_ex(J.reshape(B, K * N, K * N),
                                           -r.reshape(B, -1))[0]
                dX = dX.reshape(B, K, N)
                rn = torch.linalg.vector_norm(r, dim=(-2, -1))
                ok = torch.isfinite(rn) & torch.isfinite(dX).all(-1).all(-1)
                take = ~done & ok
                X = torch.where(take[:, None, None], X + dX, X)
                res = torch.where(done, res, rn)
                done = done | (rn < tol) | ~ok
            return X, res

        Xw = warmup_samples(engine, bp, x0s, T, K, warmup_periods)
        zero = torch.zeros((B, K, N), dtype=dtype, device=dev)
        X, r0 = newton_iters(Xw, zero, torch.zeros((), dtype=dtype,
                                                   device=dev), 0.0)
        Xs, rs = [X], [r0]
        inv_dt = 1.0 / dt_env
        for t1 in t1s[1:]:
            X, res = newton_iters(X, X, torch.as_tensor(
                t1, dtype=dtype, device=dev), inv_dt)
            Xs.append(X)
            rs.append(res)
        return torch.stack(Xs, 1), torch.stack(rs, 1)

    return t1s, fn


def envelope_transient_batched(engine: Engine, bparams, f0: float,
                               t_stop: float, dt_env: float,
                               n_harm: int = 7, n_newton: int = 10,
                               tol: float = 1e-9,
                               warmup_periods: int = 6,
                               x0s=None) -> EnvelopeBatchResult:
    """Monte-Carlo envelope transient: B perturbed lanes (a leading lane
    axis) of the whole two-timescale run; backward Euler only; the
    fast/slow split from lane 0."""
    nominal = {k: v[0] for k, v in bparams.items()}
    masks = _fast_masks(engine, nominal, f0)
    if x0s is None:
        from ..parallel.montecarlo import batched_dc_fast
        x0s = batched_dc_fast(engine, bparams)
    t1s, fn = make_envelope_batched_fn(
        engine, f0, t_stop, dt_env, n_harm=n_harm, n_newton=n_newton,
        tol=tol, warmup_periods=warmup_periods, fast_masks=masks)
    Xs, rs = fn(bparams, x0s)
    H = int(n_harm)
    rs = rs.cpu().numpy()
    return EnvelopeBatchResult(
        f0=f0, t1=t1s, xs=Xs, freqs=np.arange(H + 1) * f0,
        coeffs=one_sided(Xs, 2).cpu().numpy(),
        converged=np.all(rs < max(tol * 100, 1e-6), axis=1), residuals=rs)
