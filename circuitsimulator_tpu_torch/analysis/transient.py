"""Backward-Euler transient on the Woodbury backend (port of
``circuitsimulator_tpu/analysis/transient.py``).

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
    dt_host = float(dt)
    dt = torch.as_tensor(dt, dtype=engine.dtype, device=engine.device)
    static_I = engine.make_tran_static_I(dt_host)
    update_state = engine.make_update_state(dt)
    G_static = engine.tran_static_G(params, dt, opts.tran_gmin)
    wb = WoodburySolver(engine, params, G_static[..., :N, :N])
    unrolled = int(opts.tran_unrolled_iters)
    alpha, tol, clamp = opts.tran_alpha, opts.tran_tol, opts.tran_newton_clamp
    # the charge rows' BE companion reads the previous step's charges
    inv_dt = 1.0 / dt if engine.mos_charge else None

    def body(c, z0, qex, t, masked: bool):
        """One damped Newton iteration.  masked=True freezes lanes that were
        done before it (the while-loop form: a vmapped while_loop does not
        touch the carry of a lane whose condition is false)."""
        x, done, failed, it = c
        x_raw = wb.solve(params, x, z0, qex, t)
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
        z0 = wb.z0(I_s[..., :N])
        qex = (state["qm"], inv_dt) if engine.mos_charge else None
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
