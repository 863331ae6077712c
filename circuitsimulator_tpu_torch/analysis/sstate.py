"""Periodic steady state by shooting: the driven `.hb f0 nHarm` card and
the autonomous oscillator, the period a Newton unknown (port of
``circuitsimulator_tpu/analysis/sstate.py``).

The circuit's dynamical state is s = [x, vc, ic, il, vl] (the node
solution, every capacitor-like voltage and trapezoidal current, the
inductor currents and voltages; under MOSCAP=CHARGE the charge currents
qi, with a transmission line the delay ring).  One period T = 1/f0 of the
transient defines the map Phi(s); the steady state solves Phi(s) = s by
Newton, the shooting Jacobian formed column by column by finite
differences: the n_s perturbed states and the unperturbed one propagate
as n_s + 1 lanes of one batched transient (the ``lu`` solver: K2 on the
card).  Warm-up periods from the DC point precede the Newton loop.

The drive must be T-periodic over the window; a SIN whose delay exceeds
it is constant (dbmixer.sp's 180 s delays) and fine.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops.assemble import Engine
from ..models.moscap import charges_of_x
from .dc import dc_operating_point
from .hb import one_sided
from .transient import transient_step_fn


@dataclasses.dataclass
class SteadyStateResult:
    times: Any       # (K+1,) one period, t in [0, T]
    xs: Any          # (K+1, N) periodic waveform (xs[0] == state at t=0)
    residual: Any    # ||Phi(s*) - s*||
    newton_iters: int
    freqs: Any       # (nHarm+1,) harmonic frequencies 0..nHarm*f0
    spectrum: Any    # (nHarm+1, N) complex Fourier coefficients of xs
    converged: Any
    s: Any = None    # the converged shooting vector at t = 0
    f0: Any = None   # the drive frequency the period was solved at


_STATE_KEYS = ("vc", "ic", "il", "vl")


def _split(engine: Engine, s, dmax: int = 0, params=None):
    """Flat shooting vector (..., n) -> (x, state dict).  Under the charge
    model the vector carries the 5 nM trapezoidal charge currents qi; the
    accepted charges qm = q(x) are derived (hence ``params``).  With
    transmission lines the delay ring (dmax, 2 nT) is part of it."""
    N = engine.N
    nc = engine.n_caplike
    nL = len(engine.topo.ind_k)
    sizes = {"vc": nc, "ic": nc, "il": nL, "vl": nL}
    x = s[..., :N]
    state = {}
    off = N
    for k in _STATE_KEYS:
        state[k] = s[..., off:off + sizes[k]]
        off += sizes[k]
    if engine.mos_charge:
        if params is None:
            raise ValueError("charge cap model: _split needs params "
                             "(qm = q(x) is recomputed)")
        nM = len(engine.topo.mos_ed)
        state["qi"] = s[..., off:off + 5 * nM].reshape(s.shape[:-1] + (nM, 5))
        off += 5 * nM
        state["qm"] = charges_of_x(engine.mos_vdgs(x), params)
    if engine.n_tl:
        n2 = 2 * engine.n_tl
        state["tlw"] = s[..., off:off + dmax * n2].reshape(
            s.shape[:-1] + (dmax, n2))
    return x, state


def _join(x, state):
    parts = [x] + [state[k] for k in _STATE_KEYS]
    if "qi" in state:
        parts.append(state["qi"].flatten(-2))
    if "tlw" in state:
        parts.append(state["tlw"].flatten(-2))
    return torch.cat(parts, dim=-1)


def _minnorm_solve(A, b, rcond: float = 1e-8):
    """Minimum-norm least-squares solve by SVD, directions with a singular
    value below rcond sigma_max zeroed: the period map's J - I carries
    exactly neutral directions (a cap on a source-pinned node, the
    trapezoidal (-1)^k mode), along which the right Newton update is 0."""
    u_, s_, vt = torch.linalg.svd(A, full_matrices=False)
    keep = s_ > rcond * s_[0]
    inv = torch.where(keep, 1.0 / torch.where(keep, s_, 1.0), 0.0)
    return vt.transpose(-1, -2) @ (inv * (u_.transpose(-1, -2) @ b))


def _dyn_mask(engine: Engine, params, dmax: int = 0) -> np.ndarray:
    """Which shooting-vector entries are genuine unknowns: a cap-like slot
    with C = 0, or with both terminals on one equation, is a pass-through
    whose trapezoidal current flips sign every step (J - I would have zero
    rows); under the charge model likewise the q slots without oxide
    charge, CJ0 or a non-degenerate junction."""
    cvals = engine._caplike_C(params).cpu().numpy()
    cap_on = (cvals > 0.0) & (engine.cap_a != engine.cap_b)
    nL = len(engine.topo.ind_k)
    parts = [np.ones(engine.N, bool), cap_on, cap_on,
             np.ones(nL, bool), np.ones(nL, bool)]
    if engine.mos_charge:
        t = engine.topo
        coxwl = params["mos_coxwl"].cpu().numpy() > 0.0
        cj0 = params["mos_cj0"].cpu().numpy() > 0.0
        sb_ok = np.asarray(t.mos_es) != np.asarray(t.mos_eb)
        db_ok = np.asarray(t.mos_ed) != np.asarray(t.mos_eb)
        qm = np.stack([coxwl, coxwl, coxwl, cj0 & sb_ok, cj0 & db_ok], -1)
        parts.append(qm.reshape(-1))
    if engine.n_tl:
        parts.append(np.ones(dmax * 2 * engine.n_tl, bool))
    return np.concatenate(parts)


def osc_engine(engine: Engine) -> Engine:
    """The engine clone that shooting steps with: the dense ``lu``
    transient solver, trapezoidal integration (BE's numerical damping
    shrinks every tank at practical steps a period) and, in float64, a
    per-step Newton tolerance of at most 1e-9 (the default 1e-6 early stop
    biases the period map)."""
    opts = engine.opts
    tol = (min(float(opts.tran_tol), 1e-9)
           if engine.dtype == torch.float64 else float(opts.tran_tol))
    if (opts.tran_solver == "lu" and opts.tran_method == "trap"
            and float(opts.tran_tol) <= tol):
        return engine
    eng = copy.copy(engine)              # shared scatter patterns
    eng.opts = opts.replace(tran_solver="lu", tran_method="trap",
                            tran_tol=tol)
    return eng


@torch.inference_mode()
def steady_state(engine: Engine, params, f0: float,
                 n_harm: int = 8,
                 steps_per_period: int = 512,
                 warmup_periods: int = 8,
                 max_newton: int = 15,
                 tol: float = 1e-9,
                 fd_eps: float = 1e-6) -> SteadyStateResult:
    """The periodic steady state by Newton shooting on the trapezoidal
    period map (``osc_engine``)."""
    engine = osc_engine(engine)
    dtype, dev = engine.dtype, engine.device
    T = 1.0 / f0
    K = int(steps_per_period)
    dt = T / K
    step = transient_step_fn(engine, params, dt)
    ts = torch.arange(1, K + 1, dtype=dtype, device=dev) \
        * torch.as_tensor(dt, dtype=dtype, device=dev)
    dmax = int(engine.tl_ticks(dt).max()) if engine.n_tl else 0

    def propagate(s, save: bool = False):
        x, state = _split(engine, s, dmax, params)
        carry = (x, state, torch.zeros(x.shape[:-1], dtype=torch.bool,
                                       device=dev))
        xs = (torch.empty((K,) + tuple(x.shape), dtype=dtype, device=dev)
              if save else None)
        for i in range(K):
            carry, (xo, _) = step(carry, ts[i])
            if save:
                xs[i] = xo
        return _join(carry[0], carry[1]), xs

    x0 = dc_operating_point(engine, params)
    s = _join(x0, engine.init_state(x0, params, dt))
    for _ in range(warmup_periods):
        s = propagate(s)[0]

    dyn = torch.as_tensor(np.nonzero(_dyn_mask(engine, params, dmax))[0],
                          device=dev)
    n_s = len(dyn)
    eye = torch.eye(n_s, dtype=dtype, device=dev)
    rc = 1e-10 if dtype == torch.float64 else 1e-8
    iters = 0
    for i in range(max_newton):
        s_red = s[dyn]
        # lane 0 unperturbed, lane j + 1 with dynamic entry j moved by eps
        lanes = s.expand(n_s + 1, s.shape[-1]).clone()
        lanes[1:, dyn] = s_red + fd_eps * eye
        phis = propagate(lanes)[0]
        phi0 = phis[0]
        r = phi0[dyn] - s_red
        J = (phis[1:][:, dyn] - phi0[None, dyn]).T / fd_eps   # dPhi/ds
        ds = _minnorm_solve(J - eye, -r, rcond=rc)
        res = torch.linalg.vector_norm(r)
        s_new = phi0.clone()
        s_new[dyn] = s_red + ds
        iters = i + 1
        res_f = float(res)
        if np.isfinite(res_f):
            s = s_new
        if res_f < tol:
            break

    s_out, xs = propagate(s, save=True)
    final_res = torch.linalg.vector_norm(s_out - s)
    x_first, _ = _split(engine, s, dmax, params)
    xs_all = torch.cat([x_first[None], xs], dim=0)
    times = torch.cat([torch.zeros((1,), dtype=dtype, device=dev), ts])
    nh = min(int(n_harm), K // 2)
    coeffs = one_sided(xs_all[:K], 0)[:nh + 1]
    return SteadyStateResult(
        times=times, xs=xs_all, residual=final_res, newton_iters=iters,
        freqs=torch.arange(nh + 1, dtype=dtype, device=dev) * f0,
        spectrum=coeffs, converged=bool(final_res < tol * 10), s=s, f0=f0)


@dataclasses.dataclass
class OscillatorResult:
    f0: Any          # solved oscillation frequency
    times: Any       # (K+1,) one period
    xs: Any          # (K+1, N)
    residual: Any
    newton_iters: int
    converged: Any
    s: Any = None    # the converged shooting vector at t = 0 (the start of
                     # ``xs``): analysis/oscnoise.py re-propagates from it


@torch.inference_mode()
def kicked_warmup(engine: Engine, params, f0_guess: float, anchor_eq: int,
                  K: int, periods: int, kick: float, extra: int = 0,
                  x0=None):
    """The oscillators' start: the DC point (or ``x0``, (..., N)) with
    ``kick`` volts added at the anchor (an asymmetric start leaves the
    unstable equilibrium within the warm-up), then ``periods`` x K
    trapezoidal steps of the guessed period and ``extra`` more.  Returns
    (dt (the working dtype's value as a float), the (periods K, ..., N)
    warm-up samples, the (extra, ...) samples and states after it, as
    lists)."""
    dtype, dev = engine.dtype, engine.device
    dt = float(torch.tensor(1.0 / (f0_guess * K), dtype=dtype))
    step = transient_step_fn(engine, params, dt)
    x0 = (dc_operating_point(engine, params) if x0 is None else x0).clone()
    x0[..., anchor_eq] += kick
    state = engine.init_state(x0, params, dt)
    carry = (x0, state, torch.zeros(x0.shape[:-1], dtype=torch.bool,
                                    device=dev))
    n_w = periods * K
    dt_t = torch.as_tensor(dt, dtype=dtype, device=dev)
    ts = torch.arange(1, n_w + 1, dtype=dtype, device=dev) * dt_t
    xs = torch.empty((n_w,) + tuple(x0.shape), dtype=dtype, device=dev)
    for i in range(n_w):
        carry, (xs[i], _) = step(carry, ts[i])
    # the times after the warm-up count on from its last one
    te = ts[-1] + torch.arange(1, extra + 1, dtype=dtype, device=dev) * dt_t
    xe, se = [], []
    for i in range(extra):
        carry, _ = step(carry, te[i])
        xe.append(carry[0])
        se.append(carry[1])
    return dt, xs, xe, se


@torch.inference_mode()
def oscillator_steady_state(engine: Engine, params, f0_guess: float,
                            anchor_eq: int,
                            steps_per_period: int = 256,
                            warmup_periods: int = 30,
                            max_newton: int = 25,
                            tol: float = 1e-9,
                            fd_eps: float = 1e-7,
                            damping: float = 1.0,
                            kick: float = 0.5) -> OscillatorResult:
    """Periodic steady state of an autonomous circuit: the period T is a
    Newton unknown beside the state, u = [s_dyn, T], with the equations
    Phi_T(s) - s = 0 and a phase anchor pinning the anchor's value at the
    start (the time-shift null direction).

    The start is a kicked warm-up of ``warmup_periods`` guessed periods
    (``kicked_warmup``), the period re-estimated from the anchor's last
    two upward mean-crossings, and the shooting state restarted at the
    next upward crossing (anchoring at an extremum would make the system
    singular in the phase direction).  The Jacobian is formed by finite
    differences, n_s + 1 columns: the n_s state columns and the
    unperturbed lane propagate as n_s + 1 lanes of one batched transient
    (the ``lu`` solver: K2 on the card) at dt = T/K, and the period column
    as a propagation of its own at its own dt (the step takes one dt for
    all its lanes).  Charge decks solve the Newton system by the min-norm
    SVD (their exactly neutral q slots), the others by ``lu_solve`` (K2 on
    the card, (1, n_s + 1, 1)); T stays within [0.2, 5] T0.
    Transmission lines are refused: the period unknown changes dt and with
    it the delay ring's length."""
    if engine.n_tl:
        raise NotImplementedError(
            "oscillator shooting does not support transmission lines: "
            "the unknown period makes dt — and with it the delay-ring "
            "length — change every Newton iteration (a dynamic state "
            "shape). Use the harmonic-balance oscillator instead "
            "(Simulator.oscillator_hb / analysis/hbosc.py), which "
            "treats T-line delays EXACTLY via band-limited shift "
            "operators traced through f0.")
    from ..ops.lu import lu_solve
    engine = osc_engine(engine)
    dtype, dev = engine.dtype, engine.device
    K = int(steps_per_period)
    dt_w, xs_w, xs_c, st_c = kicked_warmup(engine, params, f0_guess,
                                           anchor_eq, K, warmup_periods,
                                           kick, extra=2 * K)
    # the period from the anchor's last two upward mean-crossings
    ya = xs_w[:, anchor_eq].cpu().numpy()
    mean = ya[-4 * K:].mean()
    up = np.nonzero((ya[:-1] < mean) & (ya[1:] >= mean))[0]
    T0 = float((up[-1] - up[-2]) * dt_w) if len(up) >= 2 else 1.0 / f0_guess
    # restart at an upward mean-crossing: a transversal phase anchor
    yc = torch.stack(xs_c)[:, anchor_eq].cpu().numpy()
    upc = np.nonzero((yc[:-1] < mean) & (yc[1:] >= mean))[0]
    idx = int(upc[0] + 1) if len(upc) else 0
    anchor_val = xs_c[idx][anchor_eq]
    s0_full = _join(xs_c[idx], st_c[idx])
    n_full = s0_full.shape[-1]
    dyn_np = np.nonzero(_dyn_mask(engine, params))[0]
    dyn = torch.as_tensor(dyn_np, device=dev)
    n_s = len(dyn_np)
    red_anchor = int(np.searchsorted(dyn_np, anchor_eq))

    def propagate(s_red, T, save: bool = False):
        """s_red (..., n_s) over one period T (a 0-dim tensor) -> the
        dynamic state at its end (and the saved (K, ..., N) samples)."""
        dt_t = T / K
        step = transient_step_fn(engine, params, float(dt_t))
        s = torch.zeros(s_red.shape[:-1] + (n_full,), dtype=dtype,
                        device=dev)
        s[..., dyn] = s_red
        x, state = _split(engine, s, params=params)
        carry = (x, state, torch.zeros(x.shape[:-1], dtype=torch.bool,
                                       device=dev))
        ts = torch.arange(1, K + 1, dtype=dtype, device=dev) * dt_t
        xs = []
        for i in range(K):
            carry, (xo, _) = step(carry, ts[i])
            if save:
                xs.append(xo)
        out = _join(carry[0], carry[1])[..., dyn]
        return (out, torch.stack(xs)) if save else out

    def residual(s_red, phi):
        return torch.cat([phi - s_red, (s_red[..., red_anchor:red_anchor + 1]
                                        - anchor_val)], -1)

    charge = engine.mos_charge
    floor = engine.opts.lu_pivot_floor

    def newton_step(u):
        s_red, T = u[:-1], u[-1]
        # per-column steps: O(1) on the states, relative on the period
        scale = torch.cat([torch.clamp_min(u[:-1].abs(), 1.0), u[-1:].abs()])
        h = fd_eps * scale
        lanes = s_red.expand(n_s + 1, n_s).clone()
        lanes[1:] += torch.diag(h[:-1])
        rs = residual(lanes, propagate(lanes, T))
        r0 = rs[0]
        r_T = residual(s_red, propagate(s_red, T + h[-1]))
        J = torch.cat([rs[1:] - r0, r_T[None] - r0], 0).T / h
        if charge:
            du = _minnorm_solve(J, -r0)
        else:
            du = lu_solve(J, -r0, floor)
        return u + damping * du, torch.linalg.vector_norm(r0)

    u = torch.cat([s0_full[dyn], torch.tensor([T0], dtype=dtype,
                                              device=dev)])
    iters = 0
    for i in range(max_newton):
        u_new, res = newton_step(u)
        iters = i + 1
        res_f = float(res)
        if not np.isfinite(res_f):
            break
        # keep T positive and sane
        u_new[-1] = torch.clamp(u_new[-1], 0.2 * T0, 5.0 * T0)
        u = u_new
        if res_f < tol:
            break

    T_fin = u[-1]
    phi, xs = propagate(u[:-1], T_fin, save=True)
    final = torch.linalg.vector_norm(residual(u[:-1], phi))
    s_fin = torch.zeros((n_full,), dtype=dtype, device=dev)
    s_fin[dyn] = u[:-1]
    x_first, _ = _split(engine, s_fin, params=params)
    ts = torch.arange(1, K + 1, dtype=dtype, device=dev) * (T_fin / K)
    return OscillatorResult(
        f0=1.0 / float(T_fin), times=torch.cat([ts.new_zeros(1), ts]),
        xs=torch.cat([x_first[None], xs]), residual=final,
        newton_iters=iters, converged=float(final) < tol * 100, s=s_fin)


def harmonic_table(topo, result, node_names=None) -> str:
    """Text table of harmonic magnitudes per node voltage column."""
    names = list(topo.volt_col_names)
    sel = [n for n in node_names if n in names] if node_names else names
    spec = result.spectrum
    spec = spec.cpu().numpy() if isinstance(spec, torch.Tensor) \
        else np.asarray(spec)
    freqs = result.freqs
    freqs = freqs.cpu().numpy() if isinstance(freqs, torch.Tensor) \
        else np.asarray(freqs)
    lines = ["==== Steady-state harmonics (|V| per node) ===="]
    lines.append("freq(Hz)      " + "  ".join(f"V({n})".ljust(12)
                                             for n in sel))
    for k, f in enumerate(freqs):
        row = [f"{f:.4e}"] + [
            f"{abs(spec[k, topo.volt_col_eqs[names.index(n)]]):.6e}"
            for n in sel]
        lines.append("  ".join(c.ljust(12) for c in row))
    return "\n".join(lines)
