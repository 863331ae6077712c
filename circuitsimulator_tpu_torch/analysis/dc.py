"""DC operating point (port of ``circuitsimulator_tpu/analysis/dc.py``,
LU solver only).

Reproduces the reference's solver structure (src/dcanalysis.cpp):

- linear circuits: one stamp pass at sourceScale = 1 and one LU solve, no
  gmin (dcSolveDirectLU);
- nonlinear circuits: 10-step source ramp, each step a damped Newton loop
  (max 50 iterations) with the ConvController schedule.  Strict mode keeps
  the reference quirks: the update is always x + 0.35 (x_raw - x), the
  convergence test is the damped step size, gmin starts each ramp step at
  base(scale), doubles on slow convergence and is multiplied by 10 on a
  non-finite solve with x and prev_err kept; non-convergence is not an
  error.

``batch = B`` runs the loop natively batched over a leading lane axis: the
iteration counter is shared, the loop runs until every lane is done or the
cap is reached, and done lanes are frozen by masks so extra iterations
cannot change their trajectory.  The JAX ``lax.while_loop`` becomes a
Python loop whose condition reads ``any(~done)`` on the host.
"""

from __future__ import annotations

import math

import torch

from ..ops.assemble import Engine
from ..ops.lu import lu_solve


@torch.inference_mode()
def dc_linear(engine: Engine, params):
    """dcSolveDirectLU: one stamp pass, sourceScale = 1, no gmin."""
    N = engine.N
    G, I = engine.dc_static(params, engine._scalar(1.0))
    return lu_solve(G[..., :N, :N], I[..., :N], engine.opts.lu_pivot_floor)


@torch.inference_mode()
def dc_newton(engine: Engine, params, batch: int = 0, x_init=None,
              final_only: bool = False):
    """dcSolveNewtonLU: source ramp + damped Newton.  x_init warm-starts
    Newton; final_only skips the ramp and runs only the scale = 1 step."""
    opts = engine.opts
    N, dtype, dev = engine.N, engine.dtype, engine.device
    ramp = opts.ramp_steps
    floor = opts.lu_pivot_floor
    lane_shape = (batch,) if batch else ()

    if x_init is not None:
        x = torch.as_tensor(x_init, dtype=dtype, device=dev).expand(
            lane_shape + (N,)).clone()
    else:
        x = torch.zeros(lane_shape + (N,), dtype=dtype, device=dev)
    for step in range(ramp - 1 if final_only else 0, ramp):
        scale = torch.tensor(float(step + 1), dtype=dtype, device=dev) / ramp
        G_s, I_s = engine.dc_static(params, scale)
        s = torch.clamp(scale, 0.0, 1.0)
        gmin_base = opts.gmin_high_base * (1.0 - s) + opts.gmin_low_base * s
        gmin = gmin_base.expand(lane_shape).clone()
        prev_err = torch.full(lane_shape, math.inf, dtype=dtype, device=dev)
        alpha_c = torch.full(lane_shape, 0.5, dtype=dtype, device=dev)
        done = torch.zeros(lane_shape, dtype=torch.bool, device=dev)
        it = 0
        while it < opts.dc_max_newton_iters and bool((~done).any()):
            G, I = engine.assemble_dc_iter(G_s, I_s, params, x, gmin)
            x_raw = lu_solve(G[..., :N, :N], I[..., :N], floor)
            finite = torch.isfinite(x_raw).all(-1)
            if opts.strict_reference_mode:
                # dcanalysis.cpp:274 re-clamps the constant 0.35 every call
                alpha = min(max(opts.alpha_const, opts.alpha_min),
                            opts.alpha_max)
                x_new = x + alpha * (x_raw - x)
            else:
                alpha = torch.clamp(alpha_c, opts.alpha_min, opts.alpha_max)
                x_new = x + alpha[..., None] * (x_raw - x)
            err = torch.linalg.vector_norm(x_new - x, dim=-1)
            first = (it == 0) | ~torch.isfinite(prev_err)
            slow = err > prev_err * opts.slow_conv_ratio
            fast = err < prev_err * opts.fast_conv_ratio
            if opts.strict_reference_mode:
                alpha_next = alpha_c
            else:
                alpha_next = torch.where(
                    first, alpha,
                    torch.where(slow,
                                torch.clamp_min(alpha * 0.7, opts.alpha_min),
                                torch.where(fast,
                                            torch.clamp_max(alpha * 1.1,
                                                            opts.alpha_max),
                                            alpha)))
            gmin_upd = torch.where(
                first, gmin_base,
                torch.where(slow,
                            torch.clamp_max(gmin * 2.0, opts.gmin_abs_max),
                            torch.where(fast, 0.5 * gmin + 0.5 * gmin_base,
                                        0.7 * gmin + 0.3 * gmin_base)))
            converged = err < opts.dc_tol
            # non-finite path: bump gmin, keep x and prev_err
            gmin_nf = torch.clamp_max(gmin * opts.gmin_nonfinite_factor,
                                      opts.gmin_nonfinite_max)
            upd = finite & ~done
            x = torch.where(upd[..., None], x_new, x)
            prev_err = torch.where(upd, err, prev_err)
            gmin = torch.where(done, gmin,
                               torch.where(finite, gmin_upd, gmin_nf))
            alpha_c = torch.where(upd, alpha_next, alpha_c)
            done = done | (upd & converged)
            it += 1
    return x


def dc_operating_point(engine: Engine, params):
    """computeDcOperatingPoint: Newton for nonlinear circuits, else one
    direct LU solve."""
    if engine.topo.has_nonlinear:
        return dc_newton(engine, params)
    return dc_linear(engine, params)
