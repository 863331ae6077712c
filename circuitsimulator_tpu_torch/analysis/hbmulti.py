"""Multi-tone harmonic balance: the quasi-periodic steady state on the
multirate (MPDE) grid (port of ``circuitsimulator_tpu/analysis/
hbmulti.py``).

    circuit ODE:        d/dt q(x) + f(x) = b(t)
    MPDE lift:          (sum_d d/dt_d) q(x^) + f(x^) = b^(t_1..t_D)
    physical solution:  x(t) = x^(t mod T_1, ..., t mod T_D)

Each independent SIN source rides the time axis of the tone it belongs to
(matched by its frequency, ``assign_tones``); x^ is sampled on a
K_1 x ... x K_D grid (K_d = 2 H_d + 1), each axis differentiated by its
exact spectral operator, and the grid is solved by Newton as single-tone
HB is (``hb.HarmonicSystem`` with the grid's d/dt T = sum_d I (x) D_d (x)
I).  The initial guess is single-tone HB of the dominant tone with the
others muted, broadcast along the remaining axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from ..netlist import WAVE_NONE, WAVE_SIN
from ..ops.assemble import Engine
from .hb import (HarmonicSystem, _hb_freq_precond, _tl_hb_terms,
                 batched_newton, harmonic_balance, make_hb_batched_fn,
                 newton_loop, newton_step, source_values,
                 spectral_diff_matrix)


@dataclasses.dataclass
class HBMultiResult:
    tones: Any        # ((f, H) per axis)
    times: Any        # list of per-axis sample-time arrays
    xs: Any           # (K_1, ..., K_D, N) grid samples of x^
    spectrum: Any     # (K_1, ..., K_D, N) complex; axis index k maps to
                      # harmonic k for k <= H_d else k - K_d (negative)
    residual: Any
    newton_iters: int
    converged: Any


@dataclasses.dataclass
class HBMultiBatchResult:
    tones: Any        # ((f, H) per axis)
    times: Any
    xs: Any           # (B, K_1, ..., K_D, N)
    spectrum: Any     # (B, K_1, ..., K_D, N) complex
    residual: Any     # (B,)
    converged: Any    # (B,)


def _mute(params, key, assign, keep):
    """params[key] with va (SIN column 1) zeroed for the sources whose
    assignment is not ``keep`` (keep=None zeroes every va)."""
    sin = params[key]
    if sin.shape[-2] == 0:
        return sin
    live = (np.zeros(sin.shape[-2], bool) if keep is None
            else np.asarray(assign) == keep)
    keep_cols = torch.as_tensor(live, dtype=sin.dtype,
                                device=sin.device)[:, None]
    va_zero = sin * torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0], dtype=sin.dtype,
                                 device=sin.device)
    return sin * keep_cols + va_zero * (1.0 - keep_cols)


def assign_tones(kinds: np.ndarray, sin: np.ndarray,
                 tone_freqs: Sequence[float]) -> np.ndarray:
    """Match each SIN source to the tone axis whose harmonic grid best
    contains its frequency (relative distance of f to the nearest positive
    multiple of f_tone).  Non-SIN (DC) sources get -1."""
    n = len(kinds)
    out = np.full(n, -1, np.int32)
    for i in range(n):
        if kinds[i] != WAVE_SIN:
            if kinds[i] != WAVE_NONE:
                raise ValueError(
                    "multi-tone HB supports DC and SIN sources only "
                    f"(source {i} has waveform kind {kinds[i]})")
            continue
        f = float(sin[i, 2])
        if f <= 0.0:
            continue
        best, bestpen = 0, math.inf
        for d, ft in enumerate(tone_freqs):
            k = max(round(f / ft), 1)
            pen = abs(f - k * ft) / ft
            if pen < bestpen:
                best, bestpen = d, pen
        if bestpen > 1e-6:
            raise ValueError(
                f"source frequency {f} is not a harmonic of any tone "
                f"{list(tone_freqs)} (closest relative error {bestpen:.3g})")
        out[i] = best
    return out


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy()


def _assignments(engine: Engine, params, freqs):
    """(assign_v, assign_i) from the nominal (or lane 0) SIN columns."""
    def nominal(key):
        a = params[key]
        return _host(a if a.dim() == 2 else a[0])
    return (assign_tones(np.asarray(engine.vs_kinds), nominal("vs_sin"),
                         freqs),
            assign_tones(np.asarray(engine.is_kinds), nominal("is_sin"),
                         freqs))


def _tone_params(params, assign, keep):
    p = dict(params)
    p["vs_sin"] = _mute(params, "vs_sin", assign[0], keep)
    p["is_sin"] = _mute(params, "is_sin", assign[1], keep)
    return p


def hbmulti_system(engine: Engine, tones, nominal_params,
                   b_time_axis: int = 0) -> HarmonicSystem:
    """The params-parametric MPDE grid system (``make_hbmulti_system``);
    its ``Ks`` and ``ts_axes`` attributes are the grid's axes."""
    dtype, dev = engine.dtype, engine.device
    freqs = [float(f) for f, _ in tones]
    Hs = [int(h) for _, h in tones]
    Ks = [2 * h + 1 for h in Hs]
    Kt = int(np.prod(Ks))
    D_axes = len(tones)
    Ds_np = [spectral_diff_matrix(K, 1.0 / f) for K, f in zip(Ks, freqs)]
    ts = [torch.arange(K, dtype=dtype, device=dev) * (1.0 / f / K)
          for K, f in zip(Ks, freqs)]
    Tm = np.zeros((Kt, Kt))
    for d in range(D_axes):
        M = np.ones((1, 1))
        for e in range(D_axes):
            M = np.kron(M, Ds_np[e] if e == d else np.eye(Ks[e]))
        Tm += M
    Tm = torch.as_tensor(Tm, dtype=dtype, device=dev)
    axis = int(b_time_axis)
    if not (0 <= axis < D_axes):
        raise ValueError(f"b_time_axis {axis} outside the {D_axes} tones")
    bshape = [1] * D_axes
    bshape[axis] = Ks[axis]
    t_bflat = ts[axis].reshape(bshape).expand(tuple(Ks)).reshape(Kt)
    assign = _assignments(engine, nominal_params, freqs)

    def b_src(params):
        def rhs(p, t):
            return engine.source_rhs(
                *source_values(engine, p, t))[..., :engine.N]
        b_dc = rhs(_tone_params(params, assign, None),
                   torch.zeros((), dtype=dtype, device=dev))
        lead = b_dc.shape[:-1]
        b_hat = b_dc.reshape(lead + (1,) * D_axes + b_dc.shape[-1:])
        for d in range(D_axes):
            p_d = _tone_params(params, assign, d)
            bd = torch.stack([rhs(p_d, t) for t in ts[d]], -2) \
                - b_dc[..., None, :]
            shape = [1] * D_axes
            shape[d] = Ks[d]
            b_hat = b_hat + bd.reshape(lead + tuple(shape) + bd.shape[-1:])
        return b_hat.expand(lead + tuple(Ks) + b_dc.shape[-1:]).reshape(
            lead + (Kt, engine.N))

    def tl_parts(params):
        """The static-stamp patch and the grid delay operator: a physical
        delay shifts every artificial time scale, so the grid's shift is
        the kron of the per-axis band-limited shifts."""
        S_tot, corr = None, None
        for d in range(D_axes):
            cr, cc, cv, S_d = _tl_hb_terms(engine, params, ts[d], Hs[d],
                                           freqs[d])
            if corr is None:
                corr = (cr, cc, cv)
            if S_tot is None:
                S_tot = S_d
            else:
                n = S_tot.shape[-1] * S_d.shape[-1]
                S_tot = torch.einsum("...iab,...icd->...iacbd", S_tot,
                                     S_d).reshape(S_d.shape[:-2] + (n, n))
        return corr + (S_tot,)

    s = HarmonicSystem(engine, Tm, t_bflat, b_src, tl_parts)
    s.Ks, s.ts_axes = Ks, ts
    return s


def make_hbmulti_system(engine: Engine, tones, nominal_params,
                        b_time_axis: int = 0):
    """(Ks, ts_axes, residual, jacobian) of the multi-tone grid, shared by
    the Newton solvers and ``analysis/hb_diff.hbmulti_gradient``.  The
    tone assignment is static, matched on the nominal SIN frequencies;
    behavioral ``time`` rides tone axis ``b_time_axis``."""
    s = hbmulti_system(engine, tones, nominal_params, b_time_axis)
    return s.Ks, s.ts_axes, s.residual, s.jacobian


def _mt_basis(Ks, freqs):
    """Real half-space DFT basis on the flattened multi-tone grid:
    (omegas (P,), Fc (P+1, Kt), Fs (P+1, Kt), Ic (Kt, P+1), Is), row 0 the
    DC index, each signed multi-index k paired with -k and represented by
    the one whose first nonzero component is positive; omegas are the
    signed mixing frequencies sum_d k_d w_d of the half rows."""
    D = len(Ks)
    Hs = [(K - 1) // 2 for K in Ks]
    Kt = int(np.prod(Ks))
    ks = [np.concatenate([np.arange(0, h + 1), np.arange(-h, 0)])
          for h in Hs]
    kg = np.meshgrid(*ks, indexing="ij")
    kflat = np.stack([g.reshape(-1) for g in kg], axis=0)      # (D, Kt)
    tg = np.meshgrid(*[np.arange(K) * (1.0 / f / K)
                       for K, f in zip(Ks, freqs)], indexing="ij")
    tflat = np.stack([g.reshape(-1) for g in tg], axis=0)      # (D, Kt)
    phase = np.zeros((Kt, Kt))
    omega = np.zeros(Kt)
    for d in range(D):
        wk = 2.0 * np.pi * freqs[d] * kflat[d]
        phase += wk[:, None] * tflat[d][None, :]
        omega += wk
    nz = kflat != 0
    first_nz = np.where(nz.any(axis=0), nz.argmax(axis=0), 0)
    lead = kflat[first_nz, np.arange(Kt)]
    half = np.flatnonzero(lead > 0)
    zero = int(np.flatnonzero((kflat == 0).all(axis=0))[0])
    order = np.concatenate([[zero], half])
    C, S = np.cos(phase[order]), np.sin(phase[order])
    scale = np.full((len(order), 1), 2.0 / Kt)
    scale[0, 0] = 1.0 / Kt
    return omega[half], C * scale, S * scale, C.T, S.T


def _grid_spectrum(Xg, axes):
    """Two-sided grid coefficients fftn / Kt over the grid axes."""
    Kt = int(np.prod([Xg.shape[a] for a in axes]))
    return torch.fft.fftn(Xg, dim=axes) / Kt


@torch.inference_mode()
def harmonic_balance_multi(engine: Engine, params,
                           tones: Sequence[Tuple[float, int]],
                           max_newton: int = 30,
                           tol: float = 1e-9,
                           damping: float = 1.0,
                           solver: str = "dense",
                           gmres_tol: float = 1e-4,
                           gmres_restart: int = 40,
                           gmres_maxiter: int = 4,
                           b_time_axis: int = 0,
                           **warmup_kw) -> HBMultiResult:
    """The quasi-periodic steady state on the multi-tone grid.  tones:
    [(freq, n_harm), ...], the first the dominant one (the warm-up's);
    unbatched params.  solver="gmres": matrix-free Newton-Krylov, the
    preconditioner's rows at the half-space mixing frequencies."""
    if solver not in ("dense", "gmres"):
        raise ValueError(f"unknown HB solver {solver!r} "
                         "(expected 'dense' or 'gmres')")
    N = engine.N
    D_axes = len(tones)
    if D_axes < 1:
        raise ValueError("need at least one tone")
    freqs = [float(f) for f, _ in tones]
    Hs = [int(h) for _, h in tones]
    system = hbmulti_system(engine, tones, params, b_time_axis)
    Ks = system.Ks
    Kt = int(np.prod(Ks))
    assign = _assignments(engine, params, freqs)
    res1 = harmonic_balance(engine, _tone_params(params, assign, 0),
                            freqs[0], n_harm=Hs[0], tol=tol, **warmup_kw)
    X = res1.xs.reshape((Ks[0],) + (1,) * (D_axes - 1) + (N,)).expand(
        tuple(Ks) + (N,)).reshape(Kt, N)
    ctx = system.prepare(params)
    omegas, *trig = _mt_basis(Ks, freqs)

    def precond(c, aux):
        return _hb_freq_precond(engine, params, omegas, aux, trig, c["C"])

    def step(X):
        Xn, rn, _ = newton_step(system, ctx, X, solver, damping, precond,
                                {"tol": gmres_tol, "restart": gmres_restart,
                                 "maxiter": gmres_maxiter})
        return Xn, rn

    X, iters = newton_loop(step, X, max_newton, tol)
    final = torch.linalg.vector_norm(system.residual_ctx(X, ctx))
    Xg = X.reshape(tuple(Ks) + (N,))
    return HBMultiResult(tones=tuple((f, h) for f, h in zip(freqs, Hs)),
                         times=system.ts_axes, xs=Xg,
                         spectrum=_grid_spectrum(Xg, tuple(range(D_axes))),
                         residual=final, newton_iters=iters,
                         converged=bool(final < max(tol * 100, 1e-6)))


def make_hbmulti_batched_fn(engine: Engine, tones, nominal_params,
                            n_newton: int = 12,
                            tol: float = 1e-9,
                            damping: float = 1.0,
                            solver: str = "dense",
                            gmres_tol: float = 1e-4,
                            gmres_restart: int = 40,
                            gmres_maxiter: int = 4,
                            b_time_axis: int = 0):
    """(Ks, ts, fn) with fn(bparams, X0s (B, Kt, N)) -> (Xs, finals): the
    batched Newton of ``hb.batched_newton`` on the grid (fixed n_newton,
    per-lane freeze, lane chunks that fit the card)."""
    if solver not in ("dense", "gmres"):
        raise ValueError(f"unknown HB solver {solver!r} "
                         "(expected 'dense' or 'gmres')")
    freqs = [float(f) for f, _ in tones]
    system = hbmulti_system(engine, tones, nominal_params, b_time_axis)
    omegas, *trig = _mt_basis(system.Ks, freqs)

    def precond(c, aux):
        return _hb_freq_precond(engine, c["p"], omegas, aux, trig, c["C"])

    @torch.inference_mode()
    def fn(bparams, x0s):
        return batched_newton(system, bparams, x0s, n_newton, tol, damping,
                              solver, precond,
                              {"tol": gmres_tol, "restart": gmres_restart,
                               "maxiter": gmres_maxiter})

    return system.Ks, system.ts_axes, fn


def harmonic_balance_multi_batched(engine: Engine, bparams,
                                   tones: Sequence[Tuple[float, int]],
                                   n_newton: int = 12,
                                   tol: float = 1e-9,
                                   damping: float = 1.0,
                                   solver: str = "dense",
                                   x0s=None,
                                   warmup_n_newton: int = 15,
                                   **solver_kw) -> HBMultiBatchResult:
    """Monte-Carlo multi-tone HB: the batched single-tone HB of the
    dominant tone (tone-muted lanes) as the warm-up, broadcast onto each
    lane's grid, then the batched grid Newton."""
    N = engine.N
    freqs = [float(f) for f, _ in tones]
    Hs = [int(h) for _, h in tones]
    D_axes = len(tones)
    assign = _assignments(engine, bparams, freqs)
    bp0 = _tone_params(bparams, assign, 0)
    if x0s is None:
        from ..parallel.montecarlo import batched_dc_fast
        x0s = batched_dc_fast(engine, bp0)
    _, fn1 = make_hb_batched_fn(engine, freqs[0], n_harm=Hs[0], tol=tol,
                                n_newton=warmup_n_newton)
    Xs1, _ = fn1(bp0, x0s)                              # (B, K0, N)
    B = int(Xs1.shape[0])
    Ks = [2 * h + 1 for h in Hs]
    Kt = int(np.prod(Ks))
    X0 = Xs1.reshape((B, Ks[0]) + (1,) * (D_axes - 1) + (N,)).expand(
        (B,) + tuple(Ks) + (N,)).reshape(B, Kt, N)
    probe = {k: v[0] for k, v in bparams.items()}
    Ks, ts, fn = make_hbmulti_batched_fn(engine, tones, probe,
                                         n_newton=n_newton, tol=tol,
                                         damping=damping, solver=solver,
                                         **solver_kw)
    Xs, finals = fn(bparams, X0)
    Xg = Xs.reshape((B,) + tuple(Ks) + (N,))
    floor = 1e-6 if engine.dtype == torch.float64 else 1e-5
    return HBMultiBatchResult(
        tones=tuple((f, h) for f, h in zip(freqs, Hs)), times=ts, xs=Xg,
        spectrum=_grid_spectrum(Xg, tuple(range(1, D_axes + 1))),
        residual=finals, converged=finals < max(tol * 100, floor))


def _index(tones, harmonics):
    idx = []
    for (f, H), k in zip(tones, harmonics):
        if abs(k) > H:
            raise ValueError(f"harmonic {k} outside the box (H={H})")
        idx.append(k % (2 * H + 1))
    return tuple(idx)


def coeff_batched(result: HBMultiBatchResult, harmonics: Sequence[int]):
    """Per-lane complex coefficient (B, N) of
    exp(j 2 pi (sum_d k_d f_d) t), the lane-axis twin of ``coeff``."""
    return result.spectrum[(slice(None),) + _index(result.tones, harmonics)]


def coeff(result: HBMultiResult, harmonics: Sequence[int]):
    """Complex coefficient (N,) of exp(j 2 pi (sum_d k_d f_d) t); negative
    k_d allowed (c[-k] = conj(c[k]) on the real grid)."""
    return result.spectrum[_index(result.tones, harmonics)]


def evaluate(result: HBMultiResult, t) -> np.ndarray:
    """The physical waveform x(t) = x^(t, ..., t) on the host: t may be an
    array, the result is (*t.shape, N) real samples."""
    t = np.asarray(t, np.float64)
    Ks = [2 * h + 1 for _, h in result.tones]
    spec = result.spectrum
    spec = _host(spec) if isinstance(spec, torch.Tensor) else np.asarray(spec)
    N = spec.shape[-1]
    c = spec.reshape(-1, N)                               # (Kt, N)
    freq = np.zeros(tuple(Ks))
    for d, (f, H) in enumerate(result.tones):
        k = np.concatenate([np.arange(0, H + 1), np.arange(-H, 0)])
        shape = [1] * len(Ks)
        shape[d] = Ks[d]
        freq = freq + (k * f).reshape(shape)
    ph = np.exp(2j * np.pi * np.tensordot(t, freq.reshape(-1), axes=0))
    return np.real(np.tensordot(ph, c, axes=[[-1], [0]]))
