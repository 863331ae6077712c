"""Autonomous harmonic balance: the oscillator steady state in the
frequency domain with the fundamental f0 a Newton unknown, its PPV phase
noise, the Monte-Carlo forms, and injection and subharmonic locking (port
of ``circuitsimulator_tpu/analysis/hbosc.py``).

The frequency-domain twin of the shooting oscillator
(``sstate.oscillator_steady_state``) and the only oscillator path on a
transmission-line deck: the harmonic space takes the delay exactly, as the
phase factor e^{-j k w0 tau} (``hb._tl_hb_terms``), smooth in w0.

Formulation: unknowns u = [X (K N samples), f0].
- The HB residual with every f0 dependence a tensor: d/dt = f0 D(1), the
  sample times t_i = i / (K f0), the T-line shifts through 2 pi f0 tau
  (``auto_system``: a ``hb.HarmonicSystem`` built at a tensor f0).
- A phase anchor removes the time-shift null direction: the cosine part
  of the anchor node's fundamental is pinned to zero, which the initial
  guess (sampled from an upward mean-crossing) satisfies.
- The bordered (K N + 1)^2 Jacobian: the HB Jacobian, the dr/df0 column
  (``torch.func.jvp`` over f0) and the anchor's cosine row, solved by
  ``ops/lu.lu_solve`` (K2 on the card up to 64 unknowns, above it
  ``lu_solve_large``), or matrix-free by ``ops/gmres.py`` on the flat
  (K N + 1) vector, the block-circulant preconditioner on the X block and
  the identity on the f0 border.

The initial guess is a kicked trapezoidal warm-up at the guessed period
(``sstate.kicked_warmup``), the period re-estimated from the anchor's last
upward mean-crossings and the last period resampled onto the K-point grid.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops.assemble import Engine
from ..ops.gmres import gmres
from ..ops.lu import lu_solve
from .hb import (HarmonicSystem, _hb_freq_precond, _hb_lane_chunk,
                 _hb_trig_mats, _per_sample, _reactive_structure,
                 _mos_charge_pieces, _tl_hb_terms, one_sided, source_values,
                 spectral_diff_matrix)
from .oscnoise import (InjectionLockResult, _pair_matrix, by_class,
                       check_lock_args, lock_from_ppv, lorentzian,
                       noise_generators)
from .sstate import kicked_warmup, osc_engine


@dataclasses.dataclass
class HBOscResult:
    f0: Any          # solved fundamental (Hz)
    times: Any       # (K,) sample times in [0, T)
    xs: Any          # (K, N) periodic waveform samples
    freqs: Any       # (H+1,)
    spectrum: Any    # (H+1, N) complex one-sided Fourier coefficients
    residual: Any
    newton_iters: int
    converged: Any


def auto_system(engine: Engine, n_harm: int, f0, gmin: float = 0.0
                ) -> HarmonicSystem:
    """The single-tone HB system at the fundamental ``f0``, a tensor: ()
    or one per lane (B,), which every f0 dependence follows (d/dt =
    f0 D(1), the sample times i / (K f0) of the sources and B sources, the
    T-line shifts), so that the residual's derivative in f0 is a jvp."""
    dtype, dev = engine.dtype, engine.device
    K = 2 * int(n_harm) + 1
    D1 = torch.as_tensor(spectral_diff_matrix(K, 1.0), dtype=dtype,
                         device=dev)
    D = f0[..., None, None] * D1
    ts = torch.arange(K, dtype=dtype, device=dev) / (K * f0[..., None])

    def b_src(params):
        ps = _per_sample(params, ts.dim() > 1)
        return engine.source_rhs(*source_values(engine, ps, ts[..., None])
                                 )[..., :engine.N]

    def tl_parts(params):
        return _tl_hb_terms(engine, params, ts, n_harm, f0)

    return HarmonicSystem(engine, D, ts, b_src, tl_parts, gmin)


def _residual(engine, n_harm, gmin, X, f0, params, with_aux=False):
    s = auto_system(engine, n_harm, f0, gmin)
    ctx = s.prepare(params)
    r, aux = s.residual_ctx(X, ctx, True)
    return (r, (s, ctx, aux)) if with_aux else r


def residual_and_df0(engine: Engine, n_harm: int, X, f0, params,
                     gmin: float = 0.0):
    """(r (..., K, N), dr/df0 (..., K, N), (system, ctx, aux)) at X, f0:
    the residual's f0 derivative by ``torch.func.jvp`` (each lane's
    derivative in its own f0)."""
    r, aux = _residual(engine, n_harm, gmin, X, f0, params, True)
    _, dr = torch.func.jvp(
        lambda f: _residual(engine, n_harm, gmin, X, f, params),
        (f0,), (torch.ones_like(f0),))
    return r, dr, aux


def _anchor_row(engine: Engine, K: int, anchor_eq: int):
    """(K N,) the cosine part of the anchor's fundamental."""
    a = torch.zeros((K, engine.N), dtype=engine.dtype, device=engine.device)
    a[:, anchor_eq] = torch.as_tensor(np.cos(2 * np.pi * np.arange(K) / K)
                                      * (2.0 / K), dtype=engine.dtype)
    return a.reshape(-1)


def _initial_samples(xs_w, anchor_eq: int, dt_w: float, Kw: int, K: int,
                     f0_guess: float):
    """(f0, X (K, N)): the period from the anchor's last upward
    mean-crossings (the mean of the last two spacings when there are
    three), the last period resampled onto the K grid from the final
    crossing back."""
    ya = xs_w[:, anchor_eq].cpu().numpy()
    mean = ya[-4 * Kw:].mean()
    up = np.nonzero((ya[:-1] < mean) & (ya[1:] >= mean))[0]
    if len(up) >= 3:
        T0 = float(np.mean(np.diff(up[-3:])) * dt_w)
    elif len(up) == 2:
        T0 = float((up[-1] - up[-2]) * dt_w)
    else:
        T0 = 1.0 / f0_guess
    if len(up) >= 1:
        start = max(int(up[-1]) - int(round(T0 / dt_w)), 0)
    else:
        start = max(len(ya) - int(round(T0 / dt_w)) - 1, 0)
    span = T0 / dt_w
    idx = np.minimum(start + np.round(np.arange(K) * span / K).astype(int),
                     len(ya) - 1)
    return 1.0 / T0, xs_w[torch.as_tensor(idx, device=xs_w.device)]


def oscillator_hb(engine: Engine, params, f0_guess: float, anchor_eq: int,
                  n_harm: int = 9,
                  warmup_periods: int = 30,
                  steps_per_period: int = 256,
                  max_newton: int = 40,
                  tol: float = 1e-9,
                  damping: float = 1.0,
                  kick: float = 0.5,
                  gmin: float = 0.0,
                  solver: str = "dense",
                  gmres_tol: float = 1e-4,
                  gmres_restart: int = 40,
                  gmres_maxiter: int = 4) -> HBOscResult:
    """The frequency-domain periodic steady state of a free-running
    oscillator (see the module docstring).  solver="gmres" solves the
    bordered Newton system matrix-free: J u = [J_XX u_X + (dr/df0) u_f,
    a . u_X] with J_XX u_X from ``HarmonicSystem.jv`` and dr/df0 one jvp
    per Newton iteration, preconditioned by the block-circulant M (row
    frequencies k 2 pi f0 from the current f0) and the identity on the
    border; the phase grid keeps the trigonometric basis f0-free."""
    if solver not in ("dense", "gmres"):
        raise ValueError(f"unknown HB solver {solver!r} "
                         "(expected 'dense' or 'gmres')")
    dtype, dev = engine.dtype, engine.device
    N = engine.N
    H = int(n_harm)
    K = 2 * H + 1
    n = K * N
    Kw = int(steps_per_period)
    dt_w, xs_w, _, _ = kicked_warmup(osc_engine(engine), params, f0_guess,
                                     anchor_eq, Kw, warmup_periods, kick)
    f0, X = _initial_samples(xs_w, anchor_eq, dt_w, Kw, K, f0_guess)
    X = X.clone()
    f0 = torch.tensor(f0, dtype=dtype, device=dev)
    a_row = _anchor_row(engine, K, anchor_eq)
    floor = engine.opts.lu_pivot_floor
    trig = _hb_trig_mats(K, H, 1.0)        # the phase grid: f0-free

    def newton(X, f0):
        r, dr, (s, ctx, aux) = residual_and_df0(engine, H, X, f0, params,
                                                gmin)
        anchor = a_row @ X.reshape(-1)
        rhs = -torch.cat([r.reshape(-1), anchor[None]])
        if solver == "dense":
            J = torch.zeros((n + 1, n + 1), dtype=dtype, device=dev)
            J[:n, :n] = s.jacobian_ctx(aux, ctx)
            J[:n, n] = dr.reshape(-1)
            J[n, :n] = a_row
            du = lu_solve(J, rhs, floor)
        else:
            omegas = np.arange(1, H + 1) * (2.0 * np.pi) * float(f0)
            apply_M = _hb_freq_precond(engine, params, omegas, aux, trig,
                                       ctx["C"])
            drf = dr.reshape(-1)

            def jv(u):
                vX = u[:n].reshape(K, N)
                return torch.cat([(s.jv(aux, ctx, vX)).reshape(-1)
                                  + drf * u[n], (a_row @ u[:n])[None]])

            def M(u):
                return torch.cat([apply_M(u[:n].reshape(K, N)).reshape(-1),
                                  u[n:]])
            du = gmres(jv, rhs, M=M, tol=gmres_tol, atol=0.0,
                       restart=gmres_restart, maxiter=gmres_maxiter)
        res = torch.sqrt((r * r).sum() + anchor * anchor)
        return (X + damping * du[:n].reshape(K, N), f0 + damping * du[n],
                res)

    iters = 0
    with torch.no_grad():
        for i in range(max_newton):
            X_new, f0_new, res = newton(X, f0)
            iters = i + 1
            if not bool(torch.isfinite(res)) or float(f0_new) <= 0:
                break
            X, f0 = X_new, f0_new
            if float(res) < tol:
                break
        final = float(torch.linalg.vector_norm(
            _residual(engine, H, gmin, X, f0, params)))
    f0_f = float(f0)
    # f32's bordered residual floor sits near 2e-6 on converged lanes
    floor_c = 1e-6 if dtype == torch.float64 else 1e-5
    return HBOscResult(
        f0=f0_f, times=torch.arange(K, dtype=dtype, device=dev) / (K * f0_f),
        xs=X, freqs=torch.arange(H + 1, dtype=dtype, device=dev) * f0_f,
        spectrum=one_sided(X, 0), residual=final, newton_iters=iters,
        converged=final < max(tol * 100, floor_c))


@dataclasses.dataclass
class HBOscPhaseNoiseResult:
    f0: Any
    c: Any             # white phase-diffusion constant (var(t) = c t)
    c_flicker: Any     # flicker coefficient (x 1/df)
    offsets: Any
    L_dbc: Any         # Lorentzian L(df), dBc/Hz, with the 1/f^3 skirt
    period_jitter: Any  # sqrt(c T): per-period rms jitter (s)
    by_class: Any      # dict kind -> share of c
    per_source: Any    # (nS,) per-generator contribution to c
    kinds: Any
    ppv: Any           # (K, N) normalised PPV samples
    invariance: Any    # rms of v_t . C x'_t - 1 (delay-free: ~0)
    sv_gap: Any        # sigma_min / sigma_next of the HB Jacobian


def oscillator_phase_noise_hb(engine: Engine, params, osc: HBOscResult,
                              offsets, extra_pairs=None,
                              extra_psd=None) -> HBOscPhaseNoiseResult:
    """Phase noise of a converged autonomous-HB limit cycle by the PPV:
    the left null vector V of the (singular) HB Jacobian (host numpy SVD
    in float64), scaled by the Fredholm normalisation K / (f0 V . dr/df0)
    (Demir's v . C x' = 1 in the delay-free limit; with T-lines dr/df0
    carries the delay-shift terms), then c_j = <(v . u_j)^2 s_j> / 2 per
    white generator, averaged over the cycle (the .NOISE catalog, as
    ``oscnoise``)."""
    dtype = engine.dtype
    N = engine.N
    X = torch.as_tensor(osc.xs, dtype=dtype, device=engine.device)
    K = X.shape[0]
    H = (K - 1) // 2
    f0 = float(osc.f0)
    T = 1.0 / f0
    f0t = torch.tensor(f0, dtype=dtype, device=engine.device)
    with torch.no_grad():
        _, dr, (s, ctx, aux) = residual_and_df0(engine, H, X, f0t, params)
        J = s.jacobian_ctx(aux, ctx).cpu().numpy().astype(np.float64)
    U, sv, _ = np.linalg.svd(J)
    sv_gap = float(sv[-1] / max(sv[-2], 1e-300))
    V = U[:, -1].reshape(K, N)
    dr = dr.cpu().numpy().astype(np.float64).ravel()
    V = V * (K / (f0 * float(V.ravel() @ dr)))

    # delay-free diagnostic: the DAE biorthogonality v . C x' = 1
    D1 = spectral_diff_matrix(K, 1.0)
    xdot = f0 * (D1 @ X.cpu().numpy().astype(np.float64))
    C_s = _reactive_structure(engine, params, base_only=engine.mos_charge
                              ).cpu().numpy().astype(np.float64)
    if engine.mos_charge:
        _, Cq_t = _mos_charge_pieces(engine, params, X)
        C_k = C_s[None] + Cq_t.cpu().numpy().astype(np.float64)
        norms = np.einsum("kn,knm,km->k", V, C_k, xdot)
    else:
        norms = np.einsum("kn,kn->k", V, xdot @ C_s.T)
    invariance = float(np.sqrt(np.mean((norms - 1.0) ** 2)))

    E, S_w, S_f, kinds = noise_generators(engine, params, X, extra_pairs,
                                          extra_psd)
    S_w = S_w.cpu().numpy().astype(np.float64)
    S_f = S_f.cpu().numpy().astype(np.float64)
    g = V @ E.T                                           # (K, nS)
    per_src_w = (g * g * S_w).mean(axis=0) / 2.0
    per_src_f = (g * g * S_f).mean(axis=0) / 2.0
    c = float(per_src_w.sum())
    c_fl = float(per_src_f.sum())
    offsets = np.asarray(offsets, np.float64)
    return HBOscPhaseNoiseResult(
        f0=f0, c=c, c_flicker=c_fl, offsets=offsets,
        L_dbc=lorentzian(f0, c, c_fl, offsets),
        period_jitter=float(np.sqrt(max(c, 0.0) * T)),
        by_class=by_class(kinds, per_src_w), per_source=per_src_w,
        kinds=np.asarray(kinds), ppv=V, invariance=invariance,
        sv_gap=sv_gap)


# ---------------------------------------------------------------------
# Monte-Carlo oscillators: batched autonomous HB + batched phase noise
# ---------------------------------------------------------------------

@dataclasses.dataclass
class HBOscBatchResult:
    f0: Any            # (B,) solved fundamentals
    xs: Any            # (B, K, N) periodic waveform samples
    residual: Any      # (B,)
    converged: Any     # (B,) bool
    # the phase-noise block (None until oscillator_phase_noise_hb_batched)
    c: Any = None            # (B,) white phase-diffusion constants
    c_flicker: Any = None    # (B,)
    offsets: Any = None      # (F,)
    L_dbc: Any = None        # (B, F) Lorentzian L(df), dBc/Hz
    period_jitter: Any = None  # (B,)
    per_source: Any = None   # (B, nS)
    kinds: Any = None        # (nS,)


def _batched_initial_samples(xs_w, anchor_eq: int, dt_w: float, Kw: int,
                             K: int, f0_guess: float):
    """The period re-estimate and resampling of ``_initial_samples`` for
    every lane at once on the device (xs_w (L, B, N)): the upward
    crossings' step indices masked, sorted, the last three read."""
    L, B, _ = xs_w.shape
    dtype, dev = xs_w.dtype, xs_w.device
    ya = xs_w[:, :, anchor_eq].T                               # (B, L)
    mean = ya[:, -min(4 * Kw, L):].mean(-1, keepdim=True)
    upm = (ya[:, :-1] < mean) & (ya[:, 1:] >= mean)            # (B, L-1)
    steps = torch.arange(L - 1, device=dev).expand(B, L - 1)
    srt = torch.where(upm, steps, -1).sort(-1).values
    u1, u2, u3 = srt[:, -1], srt[:, -2], srt[:, -3]
    cnt = upm.sum(-1)
    dtw = torch.tensor(dt_w, dtype=dtype, device=dev)
    T0 = torch.where(
        cnt >= 3, (u1 - u3).to(dtype) / 2.0 * dtw,
        torch.where(cnt == 2, (u1 - u2).to(dtype) * dtw,
                    torch.tensor(1.0 / f0_guess, dtype=dtype, device=dev)))
    span = T0 / dtw
    rs = torch.round(span).to(torch.int32)
    start = torch.where(cnt >= 1, u1 - rs, L - rs - 1).clamp_min(0)
    k = torch.arange(K, dtype=dtype, device=dev)
    gidx = torch.clamp_max(start[:, None] + torch.round(
        k * span[:, None] / K).to(torch.int32), L - 1).to(torch.int64)
    X = xs_w.permute(1, 0, 2).gather(
        1, gidx[..., None].expand(B, K, xs_w.shape[-1]))      # (B, K, N)
    return 1.0 / T0, X


def make_hbosc_batched_fn(engine: Engine, f0_guess: float, anchor_eq: int,
                          n_harm: int = 9,
                          warmup_periods: int = 30,
                          steps_per_period: int = 256,
                          n_newton: int = 25,
                          tol: float = 1e-9,
                          damping: float = 1.0,
                          kick: float = 0.5,
                          gmin: float = 0.0):
    """fn(bparams, x0s) -> (Xs (B, K, N), f0s (B,), finals (B,)): every
    lane's kicked trapezoidal warm-up as one batched ``lu`` transient (K2
    at (B, N, 1) each Newton iteration on the card), the period
    re-estimate on the device (``_batched_initial_samples``), then a fixed
    ``n_newton`` bordered Newton iterations per lane (``torch.linalg.
    solve_ex``, batched), a converged or non-finite lane frozen, no host
    sync; lanes in chunks of ``hb._hb_lane_chunk``.  Every lane starts
    from f0_guess and the anchor and converges to its own f0."""
    eng_w = osc_engine(engine)
    H = int(n_harm)
    K = 2 * H + 1
    N = engine.N
    n = K * N
    Kw = int(steps_per_period)
    a_row = _anchor_row(engine, K, anchor_eq)

    @torch.no_grad()
    def fn(bparams, x0s):
        dtype, dev = engine.dtype, engine.device
        B = x0s.shape[0]
        dt_w, xs_w, _, _ = kicked_warmup(eng_w, bparams, f0_guess, anchor_eq,
                                         Kw, warmup_periods, kick, x0=x0s)
        f0s, Xs = _batched_initial_samples(xs_w, anchor_eq, dt_w, Kw, K,
                                           f0_guess)
        del xs_w
        itemsize = torch.finfo(dtype).bits // 8
        c = _hb_lane_chunk(n + 1, B, "dense", itemsize, dev)
        outs, fs, fins = [], [], []
        for lo in range(0, B, c):
            p = {k: v[lo:lo + c] for k, v in bparams.items()}
            X, f0 = Xs[lo:lo + c], f0s[lo:lo + c]
            done = torch.zeros(X.shape[0], dtype=torch.bool, device=dev)
            for _ in range(n_newton):
                r, dr, (s, ctx, aux) = residual_and_df0(engine, H, X, f0, p,
                                                        gmin)
                b = X.shape[0]
                anchor = X.reshape(b, n) @ a_row
                J = torch.zeros((b, n + 1, n + 1), dtype=dtype, device=dev)
                J[:, :n, :n] = s.jacobian_ctx(aux, ctx)
                J[:, :n, n] = dr.reshape(b, n)
                J[:, n, :n] = a_row
                rhs = -torch.cat([r.reshape(b, n), anchor[:, None]], -1)
                du = torch.linalg.solve_ex(J, rhs)[0]
                resn = torch.sqrt((r * r).sum((-2, -1)) + anchor * anchor)
                f0n = f0 + damping * du[:, n]
                finite = (torch.isfinite(resn) & torch.isfinite(du).all(-1)
                          & (f0n > 0))
                upd = ~done & finite
                X = torch.where(upd[:, None, None],
                                X + damping * du[:, :n].reshape(b, K, N), X)
                f0 = torch.where(upd, f0n, f0)
                done = done | (resn < tol) | ~finite
            rf = _residual(engine, H, gmin, X, f0, p)
            anchor_f = X.reshape(X.shape[0], n) @ a_row
            outs.append(X)
            fs.append(f0)
            fins.append(torch.sqrt((rf * rf).sum((-2, -1))
                                   + anchor_f * anchor_f))
        return torch.cat(outs), torch.cat(fs), torch.cat(fins)

    return fn


def oscillator_hb_batched(engine: Engine, bparams, f0_guess: float,
                          anchor_eq: int, n_harm: int = 9,
                          x0s=None, tol: float = 1e-9,
                          **kw) -> HBOscBatchResult:
    """Monte-Carlo autonomous HB: B perturbed lanes (a leading lane axis)
    each solve for their own limit cycle and fundamental as one batch
    (``make_hbosc_batched_fn``); x0s (B, N) defaults to the batched DC."""
    if x0s is None:
        from ..parallel.montecarlo import batched_dc_fast
        x0s = batched_dc_fast(engine, bparams)
    fn = make_hbosc_batched_fn(engine, f0_guess, anchor_eq, n_harm=n_harm,
                               tol=tol, **kw)
    Xs, f0s, finals = fn(bparams, x0s.to(engine.dtype))
    finals = finals.cpu().numpy()
    floor = 1e-6 if engine.dtype == torch.float64 else 1e-5
    return HBOscBatchResult(f0=f0s.cpu().numpy(), xs=Xs, residual=finals,
                            converged=finals < max(tol * 100, floor))


def _lane_params(bparams):
    """Per-sample params of B lanes against (B, K, ...) samples, the
    thermal voltage (B,) to (B, 1, 1) (the noise catalog multiplies it
    into (B, K, n) terms)."""
    ps = _per_sample(bparams, True)
    ps["vt_thermal"] = bparams["vt_thermal"].reshape(-1, 1, 1)
    return ps


def make_hbosc_pnoise_batched_fn(engine: Engine, n_harm: int, pairs,
                                 inv_iters: int = 4, gmin: float = 0.0):
    """fn(bparams, Xs (B, K, N), f0s (B,)) -> (per_w, per_f) (B, nS): every
    lane's PPV and per-source phase-diffusion terms, batched.  The left
    null vector comes from inverse iteration on the regularised transpose
    J^T + eps I (one batched ``torch.linalg.lu_factor_ex``, ``inv_iters``
    batched ``lu_solve``s) started from dr/df0, which cannot be orthogonal
    to it (V . dr/df0 is the Fredholm denominator); eps = 1e-9 ||J||_F / n
    in float64 and 1e-5 in float32 (below float32's resolution the
    factorisation of the near-singular J^T is noise).  The Fredholm scale
    K / (f0 V . dr/df0) gives the single-lane path's normalisation."""
    dtype = engine.dtype
    N = engine.N
    H = int(n_harm)
    K = 2 * H + 1
    n = K * N
    E = torch.as_tensor(_pair_matrix(np.asarray(pairs), N, np.float64),
                        dtype=dtype, device=engine.device)

    @torch.no_grad()
    def fn(bparams, Xs, f0s):
        from .noise import _device_noise_currents
        B = Xs.shape[0]
        _, dr, (s, ctx, aux) = residual_and_df0(engine, H, Xs, f0s, bparams,
                                                gmin)
        J = s.jacobian_ctx(aux, ctx)                           # (B, n, n)
        dr = dr.reshape(B, n)
        eps_rel = 1e-9 if torch.finfo(dtype).eps < 1e-10 else 1e-5
        eps = eps_rel * torch.linalg.matrix_norm(J) / n
        JT = J.transpose(-1, -2) + eps[:, None, None] * torch.eye(
            n, dtype=dtype, device=J.device)
        LU, piv, _ = torch.linalg.lu_factor_ex(JT)
        v = dr / torch.linalg.vector_norm(dr, dim=-1, keepdim=True)
        for _ in range(int(inv_iters)):
            v = torch.linalg.lu_solve(LU, piv, v[..., None])[..., 0]
            v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        V = v.reshape(B, K, N) * (K / (f0s * (v * dr).sum(-1)))[:, None,
                                                                 None]
        _, S_w, S_f, _ = _device_noise_currents(engine, _lane_params(bparams),
                                                Xs)
        S_w = S_w.expand(B, K, S_w.shape[-1])
        S_f = S_f.expand(B, K, S_f.shape[-1])
        g = V @ E.T                                            # (B, K, nS)
        return (g * g * S_w).mean(1) / 2.0, (g * g * S_f).mean(1) / 2.0

    return fn


def oscillator_phase_noise_hb_batched(engine: Engine, bparams,
                                      osc: HBOscBatchResult, offsets,
                                      inv_iters: int = 4
                                      ) -> HBOscBatchResult:
    """Monte-Carlo oscillator phase noise: every lane's PPV, Demir
    phase-diffusion constants and Lorentzian L(df) of a converged
    ``oscillator_hb_batched`` result, in chunks of lanes that fit the
    card.  Fills and returns the result's phase-noise block (c,
    c_flicker, offsets, L_dbc, period_jitter, per_source, kinds)."""
    from .noise import _device_noise_currents
    Xs = torch.as_tensor(osc.xs)
    B, K, N = Xs.shape
    H = (K - 1) // 2
    probe = {k: v[0] for k, v in bparams.items()}
    pairs, _, _, kinds = _device_noise_currents(
        engine, probe, torch.zeros((N,), dtype=engine.dtype,
                                   device=engine.device))
    if not len(pairs):
        raise ValueError("no noise generators: the deck has no noisy "
                         "devices")
    lane = make_hbosc_pnoise_batched_fn(engine, H, pairs,
                                        inv_iters=inv_iters)
    f0s = torch.as_tensor(np.asarray(osc.f0), dtype=engine.dtype,
                          device=engine.device)
    itemsize = torch.finfo(engine.dtype).bits // 8
    c = _hb_lane_chunk(K * N, B, "dense", itemsize, engine.device)
    per_w, per_f = [], []
    for lo in range(0, B, c):
        w, f = lane({k: v[lo:lo + c] for k, v in bparams.items()},
                    Xs[lo:lo + c], f0s[lo:lo + c])
        per_w.append(w)
        per_f.append(f)
    per_w = torch.cat(per_w).cpu().numpy().astype(np.float64)   # (B, nS)
    per_f = torch.cat(per_f).cpu().numpy().astype(np.float64)
    c = per_w.sum(axis=1)
    c_fl = per_f.sum(axis=1)
    f0 = np.asarray(osc.f0, np.float64)
    offsets = np.asarray(offsets, np.float64)
    osc.c = c
    osc.c_flicker = c_fl
    osc.offsets = offsets
    osc.L_dbc = lorentzian(f0[:, None], c[:, None], c_fl[:, None],
                           offsets[None])
    osc.period_jitter = np.sqrt(np.maximum(c, 0.0) / f0)
    osc.per_source = per_w
    osc.kinds = np.asarray(list(kinds))
    return osc


def injection_lock_hb(engine: Engine, params, osc: HBOscResult,
                      pair, amp: float,
                      harmonic: int = 1) -> InjectionLockResult:
    """The Adler lock range from the autonomous-HB PPV (the frequency-
    domain twin of ``oscnoise.injection_lock`` and the locking path of
    T-line oscillators): the Fredholm-normalised PPV samples V(t_k) share
    Demir's convention, so |f_inj - m f0| <= m f0 amp |p_m| with p_m the
    m-th Fourier coefficient of p(t) = V(t)^T u."""
    m = check_lock_args(amp, harmonic)
    H = (osc.xs.shape[0] - 1) // 2
    if m > H:
        raise ValueError(
            f"harmonic={m} exceeds the HB truncation H={H} (K=2H+1 "
            f"samples): p_m would alias onto a lower harmonic. Re-run "
            "oscillator_hb with n_harm >= harmonic.")
    pn = oscillator_phase_noise_hb(engine, params, osc,
                                   offsets=[float(osc.f0) * 1e-3],
                                   extra_pairs=[tuple(pair)],
                                   extra_psd=[0.0])
    u = _pair_matrix(np.asarray([tuple(pair)]), engine.N, np.float64)[0]
    return lock_from_ppv(float(osc.f0), amp, m, np.asarray(pn.ppv) @ u, pn)


# ---------------------------------------------------------------------
# Subharmonic injection locking: the driven-HB fold search
# ---------------------------------------------------------------------

@dataclasses.dataclass
class SubharmonicLockResult:
    f0: float                # free-running oscillation frequency
    m: int                   # lock order: f_osc = m f_inj
    amp: float               # injected current amplitude (A)
    f_lo: float              # lowest locked injection frequency
    f_hi: float              # highest locked injection frequency
    lock_range_hz: float     # (f_hi - f_lo) / 2, the one-sided range
    locked_center: Any       # HB samples of the locked solution at f0/m


def make_driven_hb_fn(engine: Engine, params, n_harm: int, b_dir, amp,
                      n_newton: int = 60, tol: float = 1e-9,
                      damping: float = 1.0):
    """fn(X0, f) -> (X, ||residual||): the HB system at the fixed
    fundamental f with an extra injected current amp cos(2 pi f t) along
    b_dir, by at most ``n_newton`` Newton iterations (dense
    ``torch.linalg.solve_ex``), stopping once the residual is below tol or
    a step is non-finite."""
    H = int(n_harm)
    K = 2 * H + 1
    dtype, dev = engine.dtype, engine.device
    bv = torch.as_tensor(b_dir, dtype=dtype, device=dev)

    @torch.no_grad()
    def fn(X0, f):
        f = torch.as_tensor(f, dtype=dtype, device=dev)
        s = auto_system(engine, H, f)
        ctx = s.prepare(params)
        binj = float(amp) * torch.cos(2.0 * np.pi * f * s.t_nl)[:, None] \
            * bv[None, :]
        X = X0
        for _ in range(n_newton):
            r, aux = s.residual_ctx(X, ctx, True)
            r = r - binj
            rn = torch.linalg.vector_norm(r)
            J = s.jacobian_ctx(aux, ctx)
            dX = torch.linalg.solve_ex(J, -r.reshape(-1))[0].reshape(K, -1)
            ok = bool(torch.isfinite(rn)) and bool(torch.isfinite(dX).all())
            if not ok or float(rn) < tol:
                break
            X = X + damping * dX
        return X, torch.linalg.vector_norm(s.residual_ctx(X, ctx) - binj)

    return fn


def subharmonic_lock_hb(engine: Engine, params, osc: HBOscResult,
                        pair, amp: float, m: int = 2,
                        probe_node: int = 0,
                        rel_span: float = 0.02,
                        rel_tol: float = 1e-4,
                        tol: float = 1e-9) -> SubharmonicLockResult:
    """Subharmonic injection-locking range by driven-HB fold search:
    amp cos(2 pi f_inj t) into the node pair with f_inj near f0/m, and the
    f_inj interval over which the oscillator stays locked at exactly
    m f_inj.  The first-order PPV average is zero here, so this solves the
    full driven HB at the fundamental f_inj (K grown m-fold for the
    oscillator's own harmonics), warm-started from the free-running
    solution, and walks each edge by continuation: a probe is locked when
    its Newton converges and the probe node's m-th harmonic keeps more
    than 0.3 of the free-running amplitude; the step grows 1.8x on
    success and shrinks 3x on failure down to rel_tol f0/m.

    pair: (eq_a, eq_b), b may be -1 (ground); probe_node: the equation
    whose harmonic-m amplitude arbitrates; rel_span: the search half-width
    as a fraction of f0/m."""
    m = int(m)
    if m < 2:
        raise ValueError("subharmonic order m must be >= 2 "
                         "(m=1 is injection_lock_hb)")
    if amp <= 0:
        raise ValueError("injection amplitude must be > 0")
    f0 = float(osc.f0)
    xs = np.asarray(torch.as_tensor(osc.xs).cpu().numpy())
    K0 = xs.shape[0]
    H0 = (K0 - 1) // 2
    H = m * H0 + 1            # room for the oscillation's own harmonics
    K = 2 * H + 1
    u = _pair_matrix(np.asarray([tuple(pair)]), engine.N, np.float64)[0]
    spec0 = torch.as_tensor(osc.spectrum).cpu().numpy()
    a_free = abs(spec0[1, probe_node])
    if a_free <= 0:
        raise ValueError("probe_node carries no fundamental amplitude "
                         "in the free-running solution")
    # the warm start on the K-point grid of period m/f0: the oscillator's
    # waveform repeated m times (phase-coherent resampling)
    tk = np.arange(K) / (K * (f0 / m))
    phase = (tk * f0) % 1.0
    idx = phase * K0
    i0 = np.floor(idx).astype(int) % K0
    i1 = (i0 + 1) % K0
    w = (idx - np.floor(idx))[:, None]
    X_warm = (1.0 - w) * xs[i0] + w * xs[i1]

    def probe_amp(X):
        c = np.fft.fft(X.cpu().numpy()[:, probe_node]) / K
        return 2.0 * abs(c[m % K])

    solve = make_driven_hb_fn(engine, params, H, u, float(amp), tol=tol)

    def locked(f_inj, X_init):
        X, res = solve(torch.as_tensor(X_init, dtype=engine.dtype,
                                       device=engine.device), float(f_inj))
        res = float(res)
        ok = np.isfinite(res) and res < max(tol * 100, 1e-6) \
            and probe_amp(X) > 0.3 * a_free
        return ok, X

    fc = f0 / m
    ok, Xc = locked(fc, X_warm)
    if not ok:
        raise RuntimeError(
            f"driven HB did not lock at the center frequency f0/{m} — "
            "raise amp (the subharmonic range shrinks ~amp^2) or check "
            "the injection pair")

    def edge(direction):
        f, X = fc, Xc
        df = rel_tol * fc
        while abs(f - fc) < rel_span * fc:
            f_try = f + direction * df
            ok_t, X_t = locked(f_try, X)
            if ok_t:
                f, X = f_try, X_t
                df *= 1.8
            else:
                if df <= rel_tol * fc * 1.0001:
                    break
                df = max(df / 3.0, rel_tol * fc)
        return f

    f_hi = edge(+1.0)
    f_lo = edge(-1.0)
    return SubharmonicLockResult(
        f0=f0, m=m, amp=float(amp), f_lo=float(f_lo), f_hi=float(f_hi),
        lock_range_hz=0.5 * (float(f_hi) - float(f_lo)), locked_center=Xc)
