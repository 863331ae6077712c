"""Harmonic balance: the frequency-domain periodic steady state (port of
``circuitsimulator_tpu/analysis/hb.py``).

- The unknowns are the K = 2H+1 uniform time samples X (K, N) of one
  period; reactive currents are spectral, d/dt being the dense K x K
  operator D = F^-1 diag(j k w) F (``spectral_diff_matrix``).
- Resistive and nonlinear currents come per time sample from the Engine's
  Newton stamps, the K samples as lanes of one assembly: A(x) x - b(x) is
  the exact KCL residual, so the HB residual is one batched assembly and
  one batched matvec.
- Newton runs on the whole (K N) system, whose Jacobian is
  blockdiag_t(A(x_t)) + kron(D, C_struct) (the charge model adds the
  per-sample trans-capacitance blocks D[t, s] Cq(x_s)).
- Transmission lines are exact: each line's delayed wave is the
  band-limited shift S_i (a Dirichlet kernel) of the other port's wave.

``solver="dense"`` forms the (K N)^2 Jacobian and solves it with
``torch.linalg.solve_ex`` (a library solve, as JAX's ``jnp.linalg.solve``;
a singular Jacobian gives a non-finite step, which the Newton loop
detects, never a silent zero).  ``solver="gmres"`` never forms it: J v
comes from A_t, the reactive structure and the T-line and charge blocks
(``HarmonicSystem.jv``, equal to the dense J v), inside the restarted
GMRES of ``ops/gmres.py`` with the block-circulant frequency-domain
preconditioner (``_hb_freq_precond``).

The initial guess is a warm-up transient (``transient_step_fn``: its
Woodbury k x k solves run on K2 on the card) from the DC point, resampled
onto the HB grid.  The batched factories (``make_hb_batched_fn``) run a
fixed number of Newton iterations with per-lane done masks and no host
sync; their lanes are cut into chunks that fit the card's free memory
(``_hb_lane_chunk``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models import sources as srcmod
from ..models.moscap import charge_jacobian
from ..ops.assemble import Engine, ScatterPlan
from ..ops.gmres import gmres
from ..utils.shapes import broadcast_shapes
from .dc import dc_operating_point
from .transient import transient_step_fn


@dataclasses.dataclass
class HBResult:
    times: Any       # (K,) sample times in [0, T)
    xs: Any          # (K, N) periodic waveform samples
    freqs: Any       # (H+1,)
    spectrum: Any    # (H+1, N) complex one-sided Fourier coefficients
    residual: Any    # final ||KCL residual||
    newton_iters: int
    converged: Any


@dataclasses.dataclass
class HBBatchResult:
    times: Any       # (K,)
    xs: Any          # (B, K, N) per-lane periodic samples
    freqs: Any       # (H+1,)
    spectrum: Any    # (B, H+1, N) complex one-sided coefficients
    residual: Any    # (B,) final ||KCL residual|| per lane
    converged: Any   # (B,) bool


def spectral_diff_matrix(K: int, T: float) -> np.ndarray:
    """Dense d/dt operator for K uniform samples of a T-periodic signal."""
    F = np.fft.rfft(np.eye(K), axis=0)            # (H+1, K)
    w = 2.0 * np.pi / T
    kvec = np.arange(F.shape[0]) * w
    return np.fft.irfft(1j * kvec[:, None] * F, n=K, axis=0)  # (K, K)


def one_sided(X, dim: int):
    """One-sided complex Fourier coefficients of real samples along
    ``dim``: rfft / K, doubled, the DC term halved (JAX's host rfft
    scaling)."""
    K = X.shape[dim]
    c = torch.fft.rfft(X, dim=dim) / K * 2.0
    c.select(dim, 0).div_(2.0)
    return c


def _lead(params):
    """The lane shape of a params dict: () or (B,)."""
    return tuple(params["res_r"].shape[:-1])


def _per_sample(params, batched: bool):
    """Params whose leaves broadcast against (..., K, n) sample arrays: a
    lane axis gains a singleton sample axis after it."""
    if not batched:
        return params
    return {k: v.unsqueeze(1) for k, v in params.items()}


def _reactive_structure(engine: Engine, params, x_op=None,
                        base_only: bool = False):
    """C_struct (..., N, N): the capacitor patterns on node rows (+C at
    (a, a), -C at (a, b), ...), -L on the inductor branch diagonals and
    -M at the mutual pairs, so that r += C_struct dx/dt completes the KCL
    and branch equations.  Under MOSCAP=CHARGE the structure depends on
    the state: pass x_op for the trans-capacitances dq/dv there
    (small-signal consumers), or base_only=True for everything but the
    MOS charges (the large-signal consumers add them per sample,
    ``_mos_charge_pieces``)."""
    if engine.mos_charge and x_op is None and not base_only:
        raise NotImplementedError(
            "state-dependent C structure: pass x_op (small-signal) or "
            "base_only=True + per-sample charge terms (large-signal)")
    N = engine.N
    t = engine.topo
    C = engine._caplike_C(params)
    parts = [torch.stack([C, C, -C, -C], -1).flatten(-2)]
    rows, cols = [engine.cap_rows], [engine.cap_cols]
    if len(t.ind_k):
        parts.append(-params["ind_l"])
        rows.append(t.ind_k)
        cols.append(t.ind_k)
    if len(t.mut_a):
        mm = engine._mutual_M(params)
        parts.append(-torch.cat([mm, mm], -1))
        rows.append(engine.mut_rows)
        cols.append(engine.mut_cols)
    if engine.mos_charge and x_op is not None:
        _, Jq = charge_jacobian(engine.mos_vdgs(x_op), params)
        parts.append(Jq.flatten(-3))
        rows.append(engine.mq_rows)
        cols.append(engine.mq_cols)
    lead = broadcast_shapes(*(p.shape[:-1] for p in parts))
    vals = torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], -1)
    N1 = N + 1
    flat = torch.as_tensor(
        np.concatenate(rows).astype(np.int64) * N1
        + np.concatenate(cols).astype(np.int64), device=engine.device)
    M = torch.zeros(lead + (N1 * N1,), dtype=engine.dtype,
                    device=engine.device)
    M = M.index_add(-1, flat, vals)
    return M.reshape(lead + (N1, N1))[..., :N, :N]


def _mos_charge_pieces(engine: Engine, params, X):
    """Per-sample MOS charges under MOSCAP=CHARGE: X (..., K, N) ->
    (qvec (..., K, N), the node-scattered terminal charges q(x_k);
    Cq (..., K, N, N), their exact Jacobians dq/dv), so the reactive
    residual is D @ qvec and the Jacobian gains D[t, s] Cq[s] blocks.
    ``params`` broadcast against the samples (``_per_sample``)."""
    N, N1 = engine.N, engine.N + 1
    q, Jq = charge_jacobian(engine.mos_vdgs(X), params)
    lead = X.shape[:-1]
    dev = engine.device
    qv = torch.zeros(lead + (N1,), dtype=engine.dtype, device=dev)
    qv = qv.index_add(-1, torch.as_tensor(engine.mq_rhs_rows, device=dev),
                      q.flatten(-2))
    Cq = torch.zeros(lead + (N1 * N1,), dtype=engine.dtype, device=dev)
    Cq = Cq.index_add(-1, torch.as_tensor(
        engine.mq_rows * N1 + engine.mq_cols, device=dev), Jq.flatten(-3))
    return qv[..., :N], Cq.reshape(lead + (N1, N1))[..., :N, :N]


def _tl_hb_terms(engine: Engine, params, ts, n_harm: int, f0: float):
    """Transmission-line pieces of the HB system: (corr_rows, corr_cols,
    corr_vals, S).  corr_* patch the static conductance matrix (cancel the
    DC-degenerate stamps V1 = V2, i1 = -i2 that ``dc_static_entries``
    bakes in and stamp the own-port Branin rows V(p) - V(n) - Z0 i
    instead); S (..., n_tl, K, K) are the per-line band-limited delay
    operators S_i[t, s] = D_H(t_t - t_s - tau_i), D_H the order-H
    Dirichlet kernel, so (S_i @ w)(t) = w(t - tau_i) for any signal in the
    HB harmonic space (differentiable in tl_td and tl_z0).  f0 may be a
    tensor, () or one per lane with ts (..., K) (the autonomous systems of
    ``hbosc.py``)."""
    z0 = params["tl_z0"]
    td = params["tl_td"]
    one = torch.ones_like(z0)
    corr_rows = np.concatenate([engine.tl_dc_rows, engine.tl_tran_rows])
    corr_cols = np.concatenate([engine.tl_dc_cols, engine.tl_tran_cols])
    own = torch.stack([one, -one, -z0, one, -one, -z0], -1).flatten(-2)
    dc = -engine.tl_dc_vals
    corr_vals = torch.cat([dc.expand(own.shape[:-1] + dc.shape), own], -1)
    K = ts.shape[-1]
    w0 = 2.0 * np.pi * f0
    if isinstance(w0, torch.Tensor):
        w0 = w0[..., None, None, None]     # a fundamental per lane
    dts = ts[..., :, None] - ts[..., None, :]                  # (..., K, K)
    arg = w0 * (dts[..., None, :, :] - td[..., :, None, None])  # (..., nT, K, K)
    k = torch.arange(1, int(n_harm) + 1, dtype=ts.dtype, device=ts.device)
    S = (1.0 + 2.0 * torch.cos(
        k.reshape((-1,) + (1,) * arg.dim()) * arg).sum(0)) / K
    return corr_rows, corr_cols, corr_vals, S


def _tl_residual_delay(engine: Engine, params, S, X, res):
    """Subtract the delayed other-port waves from the branch rows: k1
    loses w2(t - tau) = V(p2) - V(n2) + Z0 I2 delayed, and k2 w1.  S is
    (..., n_tl, Kt, Kt) (single tone, or the kron of per-axis shifts on the
    multi-tone grid); X, res (..., Kt, N); params broadcast against the
    samples."""
    ep1, em1, k1, ep2, em2, k2 = engine._tl_idx
    z0 = params["tl_z0"]
    Xe = engine.x_ext(X)
    w1 = Xe[..., ep1] - Xe[..., em1] + z0 * X[..., k1]
    w2 = Xe[..., ep2] - Xe[..., em2] + z0 * X[..., k2]
    u1 = torch.einsum("...its,...si->...ti", S, w1)
    u2 = torch.einsum("...its,...si->...ti", S, w2)
    return res.index_add(-1, k1, -u2).index_add(-1, k2, -u1)


def _tl_add_jacobian_blocks(engine: Engine, params, S, J):
    """Add the delayed-coupling blocks coef S_i to the (..., Kt, N, Kt, N)
    HB Jacobian (the derivative of ``_tl_residual_delay``), in place."""
    t = engine.topo
    z0 = params["tl_z0"]
    N = J.shape[-1]
    for i in range(engine.n_tl):
        Si = S[..., i, :, :]
        for row, cols in (
                (int(t.tl_k1[i]), (int(t.tl_ep2[i]), int(t.tl_em2[i]),
                                   int(t.tl_k2[i]))),
                (int(t.tl_k2[i]), (int(t.tl_ep1[i]), int(t.tl_em1[i]),
                                   int(t.tl_k1[i])))):
            for c, coef in zip(cols, (-1.0, 1.0, -z0[..., i, None, None])):
                if c < N:    # the ground column drops out
                    J[..., :, row, :, c] += coef * Si
    return J


def source_values(engine: Engine, params, t):
    """(vval (..., nV), ival (..., nI)) of every source at the time t."""
    p = params
    vval = srcmod.eval_tran_masked(
        engine._vs_masks, p["vs_dc"], p["vs_pulse"], p["vs_sin"],
        p["vs_pwl_t"], p["vs_pwl_v"], p["vs_pwl_n"], t)
    ival = srcmod.eval_tran_masked(
        engine._is_masks, p["is_dc"], p["is_pulse"], p["is_sin"],
        p["is_pwl_t"], p["is_pwl_v"], p["is_pwl_n"], t)
    return vval, ival


def sources_rhs_at(engine: Engine, params, ts):
    """(..., K, N) source RHS at every sample time of ``ts`` (K,): no
    history terms, the harmonic solvers take d/dt spectrally."""
    return torch.stack([engine.source_rhs(
        *source_values(engine, params, t))[..., :engine.N] for t in ts], -2)


class HarmonicSystem:
    """The params-parametric residual and Jacobian of the collocation grid
    shared by the single-tone HB, the multi-tone MPDE grid, the envelope
    and the sensitivities.

    ``Dop`` (..., Kt, Kt) is the grid's d/dt (a leading lane axis when
    every lane has its own fundamental); ``t_nl`` (..., Kt) the times at which
    B sources read ``time``; ``b_src(params)`` the (..., Kt, N) source
    RHS; ``tl_parts(params)`` the T-line (corr_rows, corr_cols, corr_vals,
    S).  ``prepare(params)`` evaluates everything that does not depend on
    X once (a Newton loop prepares once and iterates); params may carry a
    leading lane axis, X then (B, Kt, N)."""

    def __init__(self, engine: Engine, Dop, t_nl, b_src: Callable,
                 tl_parts: Optional[Callable] = None, gmin: float = 0.0):
        self.engine = engine
        self.D = Dop
        self.t_nl = t_nl
        self.Kt = Dop.shape[-1]
        self.b_src = b_src
        self.tl_parts = tl_parts
        self.gmin = float(gmin)
        self.mos_q = bool(engine.mos_charge)
        self._tl_plan = None
        if engine.n_tl:
            rows = np.concatenate([engine.tl_dc_rows, engine.tl_tran_rows])
            cols = np.concatenate([engine.tl_dc_cols, engine.tl_tran_cols])
            self._tl_plan = ScatterPlan(rows.astype(np.int64) * (engine.N + 1)
                                        + cols.astype(np.int64),
                                        engine.device)

    def prepare(self, params):
        eng = self.engine
        lead = _lead(params)
        ctx = {"p": params, "ps": _per_sample(params, bool(lead)),
               "lead": lead,
               "C": _reactive_structure(eng, params, base_only=self.mos_q),
               "b_src": self.b_src(params)}
        _, _, svals = eng.dc_static_entries(params)
        Gf = eng._zeros_G(svals.shape[:-1])
        eng._dc_flat.add_(Gf, svals)
        if eng.n_tl:
            _, _, cv, S = self.tl_parts(params)
            self._tl_plan.add_(Gf, cv.expand(Gf.shape[:-1] + cv.shape[-1:]))
            ctx["S"] = S
        if self.gmin:
            gm = eng._scalar(self.gmin).expand(
                Gf.shape[:-1] + (len(eng.topo.node_eqs),))
            eng._gmin_flat.add_(Gf, gm)
        ctx["A_flat"] = Gf
        return ctx

    def residual_ctx(self, X, ctx, with_At: bool = False):
        """(..., Kt, N) KCL residual at X, or (res, aux) with aux = A_t
        (..., Kt, N, N), or (A_t, Cq_t) under the charge model."""
        eng = self.engine
        N, N1 = eng.N, eng.N + 1
        ps = ctx["ps"]
        gvals, rvals = eng._nl_vals(ps, X, self.t_nl)
        lead = X.shape[:-1]
        Gf = ctx["A_flat"][..., None, :].expand(lead + (N1 * N1,)).clone()
        eng._nl_flat.add_(Gf, gvals.expand(lead + gvals.shape[-1:]))
        A_t = Gf.reshape(lead + (N1, N1))[..., :N, :N]
        b = eng.add_rhs(eng._zeros_I(lead), eng._nl_rhs,
                        rvals.expand(lead + rvals.shape[-1:]))
        res = (A_t @ X[..., None])[..., 0] - b[..., :N] - ctx["b_src"]
        res = res + (self.D @ X) @ ctx["C"].transpose(-1, -2)
        if eng.n_tl:
            res = _tl_residual_delay(eng, ps, ctx["S"], X, res)
        aux = A_t
        if self.mos_q:
            qvec, Cq_t = _mos_charge_pieces(eng, ps, X)
            res = res + self.D @ qvec
            aux = (A_t, Cq_t)
        return (res, aux) if with_At else res

    def jacobian_ctx(self, aux, ctx):
        """(..., Kt N, Kt N) = blockdiag(A_t) + kron(D, C) (+ the charge
        and T-line blocks)."""
        D, C = self.D, ctx["C"]
        if self.mos_q:
            A_t, Cq_t = aux
            J = (torch.einsum("...ts,...ij->...tisj", D, C)
                 + torch.einsum("...ts,...sij->...tisj", D, Cq_t))
        else:
            A_t = aux
            J = torch.einsum("...ts,...ij->...tisj", D, C)
        J = J.contiguous()
        J.diagonal(0, -4, -2).add_(A_t.movedim(-3, -1))
        if self.engine.n_tl:
            J = _tl_add_jacobian_blocks(self.engine, ctx["p"], ctx["S"], J)
        Kt, N = self.Kt, self.engine.N
        return J.reshape(J.shape[:-4] + (Kt * N, Kt * N))

    def jv(self, aux, ctx, V):
        """J V for V (..., Kt, N) without forming J: the per-sample A_t,
        the spectral reactive term, the charge blocks and the T-line
        delays (the residual's derivative, term by term)."""
        if self.mos_q:
            A_t, Cq_t = aux
        else:
            A_t = aux
        out = (A_t @ V[..., None])[..., 0] \
            + (self.D @ V) @ ctx["C"].transpose(-1, -2)
        if self.mos_q:
            out = out + self.D @ (Cq_t @ V[..., None])[..., 0]
        if self.engine.n_tl:
            out = _tl_residual_delay(self.engine, ctx["ps"], ctx["S"], V, out)
        return out

    def residual(self, X, params, with_At: bool = False):
        return self.residual_ctx(X, self.prepare(params), with_At)

    def jacobian(self, aux, params):
        return self.jacobian_ctx(aux, self.prepare(params))


def hb_system(engine: Engine, f0: float, n_harm: int,
              gmin: float = 0.0) -> HarmonicSystem:
    """The single-tone system on the K = 2H+1 grid (``make_hb_system``)."""
    dtype, dev = engine.dtype, engine.device
    T = 1.0 / f0
    K = 2 * int(n_harm) + 1
    D = torch.as_tensor(spectral_diff_matrix(K, T), dtype=dtype, device=dev)
    ts = torch.arange(K, dtype=dtype, device=dev) * (T / K)

    def b_src(params):
        return sources_rhs_at(engine, params, ts)

    def tl_parts(params):
        return _tl_hb_terms(engine, params, ts, n_harm, f0)

    sys_ = HarmonicSystem(engine, D, ts, b_src, tl_parts, gmin)
    sys_.ts = ts
    return sys_


def make_hb_system(engine: Engine, f0: float, n_harm: int,
                   gmin: float = 0.0):
    """(ts, residual, jacobian) of the single-tone HB system:
    residual(X, params, with_At=False) -> (K, N) KCL residual [or (res,
    A_t)], jacobian(A_t, params) -> (K N, K N).  Shared by the Newton
    solvers and the implicit-differentiation sensitivities
    (``analysis/hb_diff.py``, which differentiates through params)."""
    s = hb_system(engine, f0, n_harm, gmin)
    return s.ts, s.residual, s.jacobian


def _hb_trig_mats(K: int, H: int, T: float):
    """Real one-sided DFT analysis/synthesis matrices on the K = 2H+1 grid:
    Fc/Fs (H+1, K) give cosine/sine coefficients, Ic/Is (K, H+1)
    synthesize samples."""
    tsn = np.arange(K) * (T / K)
    th = (2.0 * np.pi / T) * np.outer(np.arange(H + 1), tsn)  # (H+1, K)
    c, s = np.cos(th), np.sin(th)
    scale = np.full((H + 1, 1), 2.0 / K)
    scale[0, 0] = 1.0 / K
    return c * scale, s * scale, c.T, s.T


def _hb_freq_precond(engine: Engine, params, omegas, aux, trig, C=None):
    """Block-circulant preconditioner for matrix-free HB
    (Telichevesky/Kundert): the time-varying conductance is replaced by its
    period average A_bar = mean_t A(x_t), which diagonalises per harmonic;
    in the real one-sided basis the k-th block is the 2N x 2N real
    embedding of A_bar + j Omega_k C_bar,

        M_k = [[A_bar, Omega_k C_bar], [-Omega_k C_bar, A_bar]],  M_0 = A_bar,

    each LU-factored once per Newton iteration.  ``omegas`` (P,) are the
    angular frequencies of the P non-DC basis rows; ``aux`` is A_t, or
    (A_t, Cq_t) under the charge model (C_bar then averages the per-sample
    trans-capacitances); ``C`` the base reactive structure when the caller
    has it.  T-line delays are left to GMRES.  A tiny norm-scaled diagonal
    shift keeps M_0 finite on a node with no DC path.  Returns apply_M(v):
    (..., K, N) -> (..., K, N), the action of M^-1."""
    dtype, dev = engine.dtype, engine.device
    N = engine.N
    if C is None:
        C = _reactive_structure(engine, params, base_only=engine.mos_charge)
    if isinstance(aux, tuple):
        A_t, Cq_t = aux
        Cbar = C + Cq_t.mean(-3)
    else:
        A_t = aux
        Cbar = C
    Abar = A_t.mean(-3)
    eye = torch.eye(N, dtype=dtype, device=dev)
    shift = 1e-9 * (1.0 + Abar.abs().amax((-2, -1)))
    Abar = Abar + shift[..., None, None] * eye
    lu0 = torch.linalg.lu_factor_ex(Abar)[:2]
    kw = torch.as_tensor(omegas, dtype=dtype, device=dev)[:, None, None]
    Ab = Abar[..., None, :, :].expand(Abar.shape[:-2] + (kw.shape[0], N, N))
    Cb = kw * Cbar[..., None, :, :]
    Cb = Cb.expand(Ab.shape)
    Mk = torch.cat([torch.cat([Ab, Cb], -1), torch.cat([-Cb, Ab], -1)], -2)
    luk = torch.linalg.lu_factor_ex(Mk)[:2]
    Fc, Fs, Ic, Is = (torch.as_tensor(m, dtype=dtype, device=dev)
                      for m in trig)

    def apply_M(v):
        a = Fc @ v                                    # (..., P+1, N)
        b = Fs @ v
        y0 = torch.linalg.lu_solve(*lu0, a[..., 0, :, None])[..., 0]
        y = torch.linalg.lu_solve(
            *luk, torch.cat([a[..., 1:, :], b[..., 1:, :]], -1)[..., None])
        y = y[..., 0]
        ca = torch.cat([y0[..., None, :], y[..., :N]], -2)
        cb = torch.cat([torch.zeros_like(y0[..., None, :]), y[..., N:]], -2)
        return Ic @ ca + Is @ cb

    return apply_M


def newton_step(system: HarmonicSystem, ctx, X, solver: str, damping: float,
                precond=None, gmres_kw=None, sync: bool = True):
    """One Newton iteration on the grid: (X + damping dX, ||r||, dX).
    precond(ctx, aux) -> apply_M for the GMRES solver."""
    lead, (Kt, N) = X.shape[:-2], X.shape[-2:]
    r, aux = system.residual_ctx(X, ctx, True)
    if solver == "dense":
        J = system.jacobian_ctx(aux, ctx)
        dX = torch.linalg.solve_ex(J, -r.reshape(lead + (Kt * N,)))[0]
    elif solver == "gmres":
        apply_M = precond(ctx, aux)

        def flat(f):
            return lambda v: f(v.reshape(lead + (Kt, N))).reshape(
                lead + (Kt * N,))

        dX = gmres(flat(lambda v: system.jv(aux, ctx, v)),
                   -r.reshape(lead + (Kt * N,)), M=flat(apply_M), atol=0.0,
                   sync=sync, **gmres_kw)
    else:
        raise ValueError(f"unknown HB solver {solver!r} "
                         "(expected 'dense' or 'gmres')")
    dX = dX.reshape(lead + (Kt, N))
    return X + damping * dX, torch.linalg.vector_norm(r, dim=(-2, -1)), dX


def newton_loop(step: Callable, X, max_newton: int, tol: float):
    """The host Newton loop of the single-lane solvers: stop on a
    non-finite residual (keeping the last finite X), on tol, or once an
    already small residual (below 1e-3) fails for two consecutive
    iterations to improve on the best seen, from the third iteration on.
    Returns (X, iterations)."""
    best = math.inf
    stall = 0
    iters = 0
    for i in range(max_newton):
        X_new, res_norm = step(X)
        iters = i + 1
        res = float(res_norm)
        if not math.isfinite(res):
            break
        X = X_new
        if res < tol:
            break
        if i >= 2 and res >= best and best < 1e-3:
            stall += 1
            if stall >= 2:
                break
        else:
            stall = 0
        best = min(best, res)
    return X, iters


def warmup_samples(engine: Engine, params, x0, T: float, K: int,
                   warmup_periods: int):
    """The warm-up transient from x0 over ``warmup_periods`` periods of
    max(4K, 64) steps; returns its last period resampled onto the K-point
    grid, (..., K, N)."""
    dtype, dev = engine.dtype, engine.device
    spp = max(4 * K, 64)
    dt = T / spp
    step = transient_step_fn(engine, params, dt)
    state = engine.init_state(x0, params, dt)
    carry = (x0, state, torch.zeros(x0.shape[:-1], dtype=torch.bool,
                                    device=dev))
    n = warmup_periods * spp
    tw = torch.arange(1, n + 1, dtype=dtype, device=dev) \
        * torch.as_tensor(dt, dtype=dtype, device=dev)
    keep = {(warmup_periods - 1) * spp + int(i): j
            for j, i in enumerate((np.arange(K) * spp) // K)}
    X = torch.empty(x0.shape[:-1] + (K, x0.shape[-1]), dtype=dtype,
                    device=dev)
    for i in range(n):
        carry, (x, _) = step(carry, tw[i])
        j = keep.get(i)
        if j is not None:
            X[..., j, :] = x
    return X


@torch.inference_mode()
def harmonic_balance(engine: Engine, params, f0: float,
                     n_harm: int = 8,
                     warmup_periods: int = 6,
                     max_newton: int = 30,
                     tol: float = 1e-9,
                     gmin: float = 0.0,
                     damping: float = 1.0,
                     solver: str = "dense",
                     gmres_tol: float = 1e-4,
                     gmres_restart: int = 40,
                     gmres_maxiter: int = 4) -> HBResult:
    """Solve the periodic steady state in the frequency domain.
    solver="dense" forms the (K N)^2 Jacobian and solves it directly;
    solver="gmres" solves J dX = -r matrix-free with restarted GMRES and
    the frequency-domain preconditioner (gmres_tol is the inexact-Newton
    relative tolerance of the inner solve)."""
    if solver not in ("dense", "gmres"):
        raise ValueError(f"unknown HB solver {solver!r} "
                         "(expected 'dense' or 'gmres')")
    dtype, dev = engine.dtype, engine.device
    T = 1.0 / f0
    H = int(n_harm)
    K = 2 * H + 1
    system = hb_system(engine, f0, n_harm, gmin)
    ctx = system.prepare(params)

    x0 = dc_operating_point(engine, params)
    X = warmup_samples(engine, params, x0, T, K, warmup_periods)

    trig = _hb_trig_mats(K, H, T)
    omegas = np.arange(1, H + 1) * (2.0 * np.pi * f0)

    def precond(c, aux):
        return _hb_freq_precond(engine, params, omegas, aux, trig, c["C"])

    def step(X):
        Xn, rn, _ = newton_step(system, ctx, X, solver, damping, precond,
                                {"tol": gmres_tol, "restart": gmres_restart,
                                 "maxiter": gmres_maxiter})
        return Xn, rn

    X, iters = newton_loop(step, X, max_newton, tol)
    final = torch.linalg.vector_norm(system.residual_ctx(X, ctx))
    return HBResult(times=system.ts, xs=X,
                    freqs=torch.arange(H + 1, dtype=dtype, device=dev) * f0,
                    spectrum=one_sided(X, 0), residual=final,
                    newton_iters=iters,
                    converged=bool(final < max(tol * 100, 1e-6)))


def _hb_lane_chunk(KN: int, B: int, solver: str, itemsize: int, device,
                   restart: int = 40) -> int:
    """Lanes per chunk of the batched Newton: all of them on the CPU; on
    CUDA as many as fit in half the free memory, from the per-lane working
    set (the dense path: the (KN)^2 Jacobian, the solver's LU copy and the
    assembly's intermediates, 4 (KN)^2; GMRES: its restart + 1 Krylov
    vectors and a few more).  Raises when one lane does not fit."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return B
    per_lane = (4 * KN * KN if solver == "dense"
                else (restart + 16) * KN) * itemsize
    free, _ = torch.cuda.mem_get_info(dev)
    c = int(free // 2 // per_lane)
    if c < 1:
        raise MemoryError(
            f"one harmonic-balance lane needs ~{per_lane / 2**20:.0f} MiB "
            f"(KN = {KN}, {solver}); {free / 2**20:.0f} MiB free")
    return min(B, c)


def batched_newton(system: HarmonicSystem, bparams, X, n_newton: int,
                   tol: float, damping: float, solver: str, precond=None,
                   gmres_kw=None):
    """The batched factories' Newton: a fixed ``n_newton`` iterations per
    lane, a lane frozen once done (||r|| < tol) or non-finite, no host
    sync; lanes in chunks of ``_hb_lane_chunk``.  Returns (X, finals)."""
    eng = system.engine
    B, Kt, N = X.shape
    itemsize = torch.finfo(eng.dtype).bits // 8
    c = _hb_lane_chunk(Kt * N, B, solver, itemsize, eng.device,
                       (gmres_kw or {}).get("restart", 40))
    outs, fins = [], []
    for lo in range(0, B, c):
        p = {k: v[lo:lo + c] for k, v in bparams.items()}
        ctx = system.prepare(p)
        Xc = X[lo:lo + c]
        done = torch.zeros(Xc.shape[0], dtype=torch.bool, device=eng.device)
        for _ in range(n_newton):
            Xn, resn, dX = newton_step(system, ctx, Xc, solver, damping,
                                       precond, gmres_kw, sync=False)
            finite = torch.isfinite(resn) & torch.isfinite(dX).all(-1).all(-1)
            upd = ~done & finite
            Xc = torch.where(upd[:, None, None], Xn, Xc)
            done = done | (resn < tol) | ~finite
        outs.append(Xc)
        fins.append(torch.linalg.vector_norm(system.residual_ctx(Xc, ctx),
                                             dim=(-2, -1)))
    return torch.cat(outs), torch.cat(fins)


def make_hb_batched_fn(engine: Engine, f0: float,
                       n_harm: int = 8,
                       warmup_periods: int = 6,
                       n_newton: int = 15,
                       tol: float = 1e-9,
                       gmin: float = 0.0,
                       damping: float = 1.0,
                       solver: str = "dense",
                       gmres_tol: float = 1e-4,
                       gmres_restart: int = 40,
                       gmres_maxiter: int = 4):
    """(ts, fn) with fn(bparams, x0s (B, N)) -> (Xs (B, K, N), finals (B,)):
    every lane's warm-up transient (one batched run), then the batched
    Newton of ``batched_newton``.  solver="gmres" never forms the per-lane
    (K N)^2 Jacobian."""
    if solver not in ("dense", "gmres"):
        raise ValueError(f"unknown HB solver {solver!r} "
                         "(expected 'dense' or 'gmres')")
    T = 1.0 / f0
    H = int(n_harm)
    K = 2 * H + 1
    system = hb_system(engine, f0, n_harm, gmin)
    trig = _hb_trig_mats(K, H, T)
    omegas = np.arange(1, H + 1) * (2.0 * np.pi * f0)

    def precond(c, aux):
        return _hb_freq_precond(engine, c["p"], omegas, aux, trig, c["C"])

    @torch.inference_mode()
    def fn(bparams, x0s):
        X = warmup_samples(engine, bparams, x0s, T, K, warmup_periods)
        return batched_newton(system, bparams, X, n_newton, tol, damping,
                              solver, precond,
                              {"tol": gmres_tol, "restart": gmres_restart,
                               "maxiter": gmres_maxiter})

    return system.ts, fn


def harmonic_balance_batched(engine: Engine, bparams, f0: float,
                             n_harm: int = 8,
                             warmup_periods: int = 6,
                             n_newton: int = 15,
                             tol: float = 1e-9,
                             gmin: float = 0.0,
                             damping: float = 1.0,
                             x0s=None,
                             solver: str = "dense",
                             **solver_kw) -> HBBatchResult:
    """Monte-Carlo harmonic balance: B perturbed lanes (params with a
    leading lane axis) as one batched program with per-lane freeze; x0s
    (B, N) defaults to the batched DC."""
    dtype, dev = engine.dtype, engine.device
    H = int(n_harm)
    if x0s is None:
        from ..parallel.montecarlo import batched_dc_fast
        x0s = batched_dc_fast(engine, bparams)
    ts, fn = make_hb_batched_fn(engine, f0, n_harm=n_harm,
                                warmup_periods=warmup_periods,
                                n_newton=n_newton, tol=tol, gmin=gmin,
                                damping=damping, solver=solver, **solver_kw)
    Xs, finals = fn(bparams, x0s)
    return HBBatchResult(times=ts, xs=Xs,
                         freqs=torch.arange(H + 1, dtype=dtype,
                                            device=dev) * f0,
                         spectrum=one_sided(Xs, 1), residual=finals,
                         converged=finals < max(tol * 100, 1e-6))
