"""Fixed-step transient, Backward Euler or trapezoidal, on the Woodbury
or the dense LU backend (port of ``circuitsimulator_tpu/analysis/
transient.py``).

Reproduces src/tanalisis.cpp:83-424 (and, under ``MOSCAP=CHARGE``, the
JAX package's charge rows with the previous step's charges in the state;
with transmission lines, the delay ring of past waves, ``state["tlw"]``;
on a noisy TRNOISE run, the source noise of the coming step, ``tn_v`` and
``tn_i``):
t = 0 state from the DC operating point; nSteps = floor(tstop/dt + 1e-12),
t_k = (k+1) dt; per step a damped Newton (alpha 0.45, gmin 1e-6, tol 1e-6
on the damped step, max 50 iterations, non-convergence is not an error);
element history updates from the accepted x.  A non-finite solve freezes the lane and raises its
``failed`` flag instead of aborting the batch.

``SolverOptions.tran_method`` picks the companions ("be", the reference's,
or "trap", the JAX package's trapezoidal extension: twice the companion
conductances, the element currents and voltages in the state) and
``tran_solver`` the linear solve: "woodbury" (G_static inverted once, a
rank-k update per Newton iteration) or "lu" (the whole system assembled
and solved every iteration, the reference's algorithm; with
``tran_mixed_refine`` in float64, the residual in float64 and the
correction solved in float32); for large circuits, on the stamp entries
and never a dense matrix, "tridiag" (bordered cyclic reduction of a
ladder, ``tridiag_algo`` PCR or CR), "blockband" (the RCM block-banded
block CR, re-eliminated every iteration) or "blockwb" (that block CR
factored once, the nonlinear devices as Woodbury rows over it).  Under
MOSCAP=CHARGE the sparse solves scatter the charge rows' entries too.
Every dense and Schur solve goes through ``ops/lu.lu_solve``: the K2
kernel on CUDA (above its 64 unknowns, ``lu_solve_large``).

The JAX ``lax.scan`` over steps is a Python loop; the per-step Newton is
either ``tran_unrolled_iters`` fixed iterations (no host sync: the
Monte-Carlo fast configuration) or a loop that stops when every lane is
done, checking ``any(~done)`` on the host each iteration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..ops.assemble import Engine
from ..ops.lu import lu_solve
from ..ops.sparse_system import SparseSystem, cat_lanes
from ..ops.woodbury import WoodburySolver
from .dc import dc_operating_point


@dataclasses.dataclass
class TransientResult:
    times: Any        # (n_saved,) — includes the t = 0 row when xs is saved
    xs: Any           # (n_saved, ..., N) or None
    x_final: Any      # (..., N)
    newton_iters: Any # (n_steps, ...) per-step Newton iterations
    failed: Any       # (...,) bool: non-finite solve encountered
    n_steps: int


def n_steps_for(tstep: float, tstop: float) -> int:
    """nSteps = floor(tstop/dt + 1e-12) (tanalisis.cpp:238)."""
    return int(math.floor(tstop / tstep + 1e-12))


def transient_step_fn(engine: Engine, params, dt, predictor: bool = False):
    """Build step(carry, t) -> (carry, (x, iters)).

    carry = (x, state, failed), or (x, x_prev, state, failed) with the
    predictor, where each step's Newton starts from 2x - x_prev.  ``dt``
    is best the Python float of the timestep: the T-line delays are
    counted in steps from ``float(dt)`` (``Engine.tl_ticks``)."""
    opts = engine.opts
    N = engine.N
    method = opts.tran_method
    dt_host = float(dt)
    dt = torch.as_tensor(dt, dtype=engine.dtype, device=engine.device)
    static_I = engine.make_tran_static_I(dt_host, method)
    update_state = engine.make_update_state(dt, method)
    floor = opts.lu_pivot_floor
    woodbury = opts.tran_solver in ("woodbury", "blockwb")
    if opts.tran_solver in ("tridiag", "blockband"):
        (static,), sparse = sparse_tran_backend(engine, params, [dt], method)

        def solve(params, x, I_s, qex, t):
            return sparse(params, x, I_s, qex, t, static)
    elif opts.tran_solver == "blockwb":
        wb = WoodburySolver(engine, params,
                            solve_op=_blockwb_solve_op(engine, params, dt,
                                                       method))
        solve = wb.solve
    elif opts.tran_solver == "woodbury":
        G_static = engine.tran_static_G(params, dt, opts.tran_gmin, method)
        wb = WoodburySolver(engine, params, G_static[..., :N, :N])
        solve = wb.solve
    else:
        G_static = engine.tran_static_G(params, dt, opts.tran_gmin, method)
        mixed = (bool(opts.tran_mixed_refine)
                 and engine.dtype == torch.float64)

        def solve(params, x, z0, qex, t):
            """x_raw of one iteration of the dense LU solver."""
            G, I = engine.assemble_tran_iter(G_static, z0, params, x, t, qex)
            Gn = G[..., :N, :N]
            if not mixed:
                return lu_solve(Gn, I[..., :N], floor)
            # f64 residual around the iterate, f32 solve of the correction:
            # Newton is the refinement loop, so the damped fixpoint is the
            # f64 one while every factorisation runs in f32
            r = I[..., :N] - (Gn @ x[..., None])[..., 0]
            d = lu_solve(Gn.to(torch.float32), r.to(torch.float32), floor)
            return x + d.to(engine.dtype)
    unrolled = int(opts.tran_unrolled_iters)
    alpha, tol, clamp = opts.tran_alpha, opts.tran_tol, opts.tran_newton_clamp
    # the charge rows' companion reads the previous step's charges (and,
    # under trap, their currents)
    inv_dt = 1.0 / dt if engine.mos_charge else None

    def body(c, z0, qex, t, masked: bool):
        """One damped Newton iteration.  masked=True freezes lanes that were
        done before it (the while-loop form: a vmapped while_loop does not
        touch the carry of a lane whose condition is false)."""
        x, done, failed, it = c
        x_raw = solve(params, x, z0, qex, t)
        finite = torch.isfinite(x_raw).all(-1)
        upd_vec = x_raw - x
        if clamp > 0.0:
            upd_vec = torch.clamp(upd_vec, -clamp, clamp)
        x_new = x + alpha * upd_vec
        err = torch.linalg.vector_norm(x_new - x, dim=-1)
        upd = finite & ~done
        x_out = torch.where(upd[..., None], x_new, x)
        done_out = done | (upd & (err < tol)) | ~finite
        failed_out = failed | ~finite
        if masked:
            active = ~done
            done_out = torch.where(active, done_out, done)
            failed_out = torch.where(active, failed_out, failed)
            return x_out, done_out, failed_out, it + active.to(it.dtype)
        return x_out, done_out, failed_out, it + 1

    def step(carry, t):
        if predictor:
            x, x_prev, state, failed = carry
            x_init = 2.0 * x - x_prev
        else:
            x, state, failed = carry
            x_init = x
        I_s = static_I(params, state, t)
        # the Woodbury solves take G0^-1 I_s, the others I_s itself
        z0 = wb.z0(I_s[..., :N]) if woodbury else I_s
        qex = None
        if engine.mos_charge:
            qex = ((state["qm"], inv_dt, state["qi"]) if method == "trap"
                   else (state["qm"], inv_dt))
        c = (x_init, failed, failed, torch.zeros_like(failed, dtype=torch.int32))
        if unrolled > 0:
            for _ in range(unrolled):
                c = body(c, z0, qex, t, masked=False)
        else:
            for _ in range(opts.tran_max_newton_iters):
                if not bool((~c[1]).any()):
                    break
                c = body(c, z0, qex, t, masked=True)
        x_new, _, failed_new, iters = c
        state = update_state(params, x_new, state)
        if predictor:
            return (x_new, x, state, failed_new), (x_new, iters)
        return (x_new, state, failed_new), (x_new, iters)

    return step


def sparse_tran_backend(engine: Engine, params, dts, method: str):
    """The ``tridiag`` or ``blockband`` backend: (statics, solve) with
    statics the static companion matrices scattered once for each timestep
    of ``dts``, and solve(params, x, I_s, qex, t, static) -> x_raw: the
    device linearisation (and the charge rows) scattered onto ``static``,
    then the bordered (block) cyclic reduction."""
    opts = engine.opts
    entries = [engine.tran_static_entries(params, d, opts.tran_gmin, method)
               for d in dts]
    pats = [(engine.nl_rows, engine.nl_cols)]
    if engine.mos_charge:
        pats.append((engine.mq_rows, engine.mq_cols))
    system = SparseSystem(engine, opts.tran_solver, *entries[0][:2], pats,
                          algo=opts.tridiag_algo)
    statics = [system.scatter(e[2]) for e in entries]

    def solve(params, x, I_s, qex, t, static):
        gvals, rvals = engine._nl_vals(params, x, t)
        I = engine.add_rhs(I_s, engine._nl_rhs, rvals)
        if qex is not None:
            # the charge rows: 15 Jacobian and 5 RHS entries per MOS
            gq, cq = engine.mosq_linearize(params, engine.mos_vdgs(x), *qex)
            gvals = cat_lanes(gvals, gq.flatten(-3))
            I = engine.add_rhs(I, engine._mq_rhs, -cq.flatten(-2))
        return system.solve(static, I, gvals)

    return statics, solve


def _blockwb_solve_op(engine: Engine, params, dt, method: str):
    """The ``blockwb`` base: the static companion matrix in the RCM block
    band, factored once (``bordered_block_factor``); returns solve_op(B)
    applying its inverse to (..., N, q) original-order right-hand sides."""
    from ..ops.blockcr import (bordered_block_apply_cols,
                               bordered_block_factor)
    opts = engine.opts
    srows, scols, svals = engine.tran_static_entries(params, dt,
                                                     opts.tran_gmin, method)
    system = SparseSystem(engine, "blockband", srows, scols)
    layout = system.layout
    m = system.scatter(svals)
    bfac = bordered_block_factor(m["L"], m["D"], m["U"], m["Ub"], m["Wb"],
                                 m["Db"], opts.lu_pivot_floor)

    def solve_op(B):
        f, g = layout.gather_rhs(B.transpose(-1, -2))     # (..., q, n_pad)
        X, Y = bordered_block_apply_cols(bfac, f.transpose(-1, -2),
                                         g.transpose(-1, -2))
        return layout.gather_solution(X.transpose(-1, -2),
                                      Y.transpose(-1, -2)).transpose(-1, -2)

    return solve_op


@torch.inference_mode()
def run_transient(engine: Engine, params, tstep, tstop,
                  x0: Optional[Any] = None, save_xs: bool = True,
                  noise_key=None):
    """Full transient; x0 defaults to the DC operating point.  The time
    grid is arange(1, n+1) * dt in the working dtype (never t += dt).
    noise_key (``utils/prng`` key data: (2,), or (B, 2) for one
    realisation per lane) turns on a TRNOISE deck's source noise, drawn
    step by step as the JAX package draws it; without one the run is
    noise-free."""
    dtype, dev = engine.dtype, engine.device
    dt = torch.tensor(tstep, dtype=dtype, device=dev)
    n_steps = n_steps_for(float(tstep), float(tstop))
    if x0 is None:
        x0 = dc_operating_point(engine, params)
    state = engine.init_state(x0, params, float(tstep), noise_key=noise_key)
    failed = torch.zeros(x0.shape[:-1], dtype=torch.bool, device=dev)
    predictor = engine.opts.tran_predictor
    carry = (x0, x0, state, failed) if predictor else (x0, state, failed)
    ts = torch.arange(1, n_steps + 1, dtype=dtype, device=dev) * dt
    step = transient_step_fn(engine, params, float(tstep),
                             predictor=predictor)
    xs = (torch.empty((n_steps + 1,) + tuple(x0.shape), dtype=dtype,
                      device=dev) if save_xs else None)
    if save_xs:
        xs[0] = x0
    iters = torch.empty((n_steps,) + tuple(failed.shape), dtype=torch.int32,
                        device=dev)
    for i in range(n_steps):
        carry, (x, it) = step(carry, ts[i])
        if save_xs:
            xs[i + 1] = x
        iters[i] = it
    times = (torch.cat([torch.zeros((1,), dtype=dtype, device=dev), ts])
             if save_xs else ts)
    return TransientResult(times=times, xs=xs, x_final=carry[0],
                           newton_iters=iters, failed=carry[-1],
                           n_steps=n_steps)
