"""DC operating point (port of ``circuitsimulator_tpu/analysis/dc.py``).

Reproduces the reference's solver structure (src/dcanalysis.cpp):

- linear circuits: one stamp pass at sourceScale = 1 and one LU solve, no
  gmin (dcSolveDirectLU), or Gauss-Seidel (dcSolveDirectGS);
- nonlinear circuits: 10-step source ramp, each step a damped Newton loop
  (max 50 iterations; Gauss-Seidel: 60, 120 on the last step) with the
  ConvController schedule.  Strict mode keeps the reference quirks: the
  update is always x + 0.35 (x_raw - x), the convergence test is the
  damped step size, gmin starts each ramp step at base(scale), doubles on
  slow convergence and is multiplied by 10 on a non-finite solve with x
  and prev_err kept; non-convergence is not an error.

The linear solve of a Newton iteration is ``linear_solver``: "lu" (dense,
``ops/lu.lu_solve``: K2 on CUDA), "gs" (``ops/gauss_seidel``, warm-started
from x), or one of the large-circuit solves on the sparse stamp entries,
never a dense matrix: "tridiag" (bordered cyclic reduction, always CR: the
DC can be near-singular) or "blockband" (RCM block-banded block CR).

``batch = B`` runs the loop natively batched over a leading lane axis: the
iteration counter is shared, the loop runs until every lane is done or the
cap is reached, and done lanes are frozen by masks so extra iterations
cannot change their trajectory (as a vmapped ``while_loop`` leaves them).
Every linear solver takes the lanes.  The JAX ``lax.while_loop`` becomes a
Python loop whose condition reads ``any(~done)`` on the host.
"""

from __future__ import annotations

import math

import torch

from ..ops.assemble import Engine
from ..ops.gauss_seidel import gauss_seidel_solve
from ..ops.lu import lu_solve
from ..ops.sparse_system import SparseSystem, cat_lanes


@torch.inference_mode()
def dc_linear(engine: Engine, params):
    """dcSolveDirectLU: one stamp pass, sourceScale = 1, no gmin."""
    N = engine.N
    G, I = engine.dc_static(params, engine._scalar(1.0))
    return lu_solve(G[..., :N, :N], I[..., :N], engine.opts.lu_pivot_floor)


@torch.inference_mode()
def dc_linear_gs(engine: Engine, params):
    """dcSolveDirectGS (dcanalysis.cpp:71-92): one stamp pass, Gauss-Seidel
    with the gs_* options from a zero initial guess."""
    N, opts = engine.N, engine.opts
    G, I = engine.dc_static(params, engine._scalar(1.0))
    return gauss_seidel_solve(G[..., :N, :N], I[..., :N], None,
                              opts.gs_max_iters, opts.gs_tol, opts.gs_diag_eps)


def _sparse_dc(engine: Engine, params, kind: str, nl: bool = True,
               ns_eqs=None):
    """(system, static) of the DC's large-circuit solve (``tridiag``,
    always CR: the DC can be near-singular, or ``blockband``): the static
    DC entries scattered once, and per Newton iteration the device
    linearisation, gmin on every node diagonal and the .NODESET hold at
    ``ns_eqs``, in that order."""
    rows, cols, vals = engine.dc_static_entries(params)
    pats = []
    if nl:
        node = engine.topo.node_eqs
        pats = [(engine.nl_rows, engine.nl_cols), (node, node)]
        if ns_eqs is not None:
            pats.append((ns_eqs, ns_eqs))
    system = SparseSystem(engine, kind, rows, cols, pats, algo="cr")
    return system, system.scatter(vals)


@torch.inference_mode()
def dc_linear_tridiag(engine: Engine, params):
    """Linear DC by the bordered-tridiagonal solve (ladder circuits; CR)."""
    system, static = _sparse_dc(engine, params, "tridiag", nl=False)
    return system.solve(static, engine.dc_rhs(params, engine._scalar(1.0)))


@torch.inference_mode()
def dc_linear_blockband(engine: Engine, params):
    """Linear DC by the bordered block-tridiagonal solve (general large
    circuits; ``ops/blockband.py``)."""
    system, static = _sparse_dc(engine, params, "blockband", nl=False)
    return system.solve(static, engine.dc_rhs(params, engine._scalar(1.0)))


@torch.inference_mode()
def dc_newton(engine: Engine, params, batch: int = 0, x_init=None,
              final_only: bool = False, nodeset=None,
              return_gmin: bool = False, linear_solver=None):
    """dcSolveNewtonLU / dcSolveNewtonGS: source ramp + damped Newton.
    x_init warm-starts Newton; final_only skips the ramp and runs only the
    scale = 1 step.  return_gmin: also return the gmin of each lane's last
    accepted solve (the shunt of the fixed point that x approximates).
    linear_solver: "lu", "gs", "tridiag" or "blockband"; None takes the
    engine's ``dc_solver`` (the JAX function defaults to "lu"; the port's
    batched callers reach a large circuit's solver this way).

    nodeset = (eqs, vals) (``Simulator._nodeset``, the .NODESET card):
    Newton starts from x[eqs] = vals, and every ramp step but the last
    holds those unknowns there with a unit conductance to vals (G[e, e] +=
    1, I[e] += vals); the last step releases the hold."""
    opts = engine.opts
    N, dtype, dev = engine.N, engine.dtype, engine.device
    ramp = opts.ramp_steps
    floor = opts.lu_pivot_floor
    lane_shape = (batch,) if batch else ()
    solver = linear_solver or opts.dc_solver
    use_gs = solver == "gs"
    max_iters_base = 60 if use_gs else opts.dc_max_newton_iters
    sparse = solver in ("tridiag", "blockband")
    if sparse:
        system, static = _sparse_dc(
            engine, params, solver,
            ns_eqs=None if nodeset is None else nodeset[0])

    if x_init is not None:
        x = torch.as_tensor(x_init, dtype=dtype, device=dev).expand(
            lane_shape + (N,)).clone()
    else:
        x = torch.zeros(lane_shape + (N,), dtype=dtype, device=dev)
    if nodeset is not None:
        ns_eqs = torch.as_tensor(nodeset[0], dtype=torch.long, device=dev)
        ns_vals = torch.as_tensor(nodeset[1], dtype=dtype, device=dev)
        ns_diag = ns_eqs * (N + 2)        # flat (e, e) of the (N+1)^2 matrix
        ns_ones = torch.ones_like(ns_vals)
        x[..., ns_eqs] = ns_vals
    for step in range(ramp - 1 if final_only else 0, ramp):
        scale = torch.tensor(float(step + 1), dtype=dtype, device=dev) / ramp
        held = nodeset is not None and step < ramp - 1
        if sparse:
            I_s = engine.dc_rhs(params, scale)
        else:
            G_s, I_s = engine.dc_static(params, scale)
        if held:
            # hold: a unit conductance from each set unknown to its value
            # (the sparse solves add the conductance every iteration)
            if not sparse:
                Gf = G_s.flatten(-2)
                Gf.index_add_(-1, ns_diag, ns_ones.expand(
                    Gf.shape[:-1] + ns_vals.shape))
                G_s = Gf.unflatten(-1, G_s.shape[-2:])
            I_s.index_add_(-1, ns_eqs, ns_vals.expand(I_s.shape[:-1]
                                                      + ns_vals.shape))
        s = torch.clamp(scale, 0.0, 1.0)
        gmin_base = opts.gmin_high_base * (1.0 - s) + opts.gmin_low_base * s
        gmin = gmin_base.expand(lane_shape).clone()
        prev_err = torch.full(lane_shape, math.inf, dtype=dtype, device=dev)
        # initialAlphaGS / initialAlphaLU (dcanalysis.hpp)
        alpha_c = torch.full(lane_shape, 0.7 if use_gs else 0.5, dtype=dtype,
                             device=dev)
        done = torch.zeros(lane_shape, dtype=torch.bool, device=dev)
        gmin_used = gmin
        max_iters = (2 * max_iters_base if use_gs and step == ramp - 1
                     else max_iters_base)
        it = 0
        while it < max_iters and bool((~done).any()):
            if sparse:
                gvals, rvals = engine._nl_vals(params, x)
                vals = [gvals, gmin[..., None].expand(
                    gmin.shape + engine.topo.node_eqs.shape)]
                if nodeset is not None:
                    vals.append(ns_ones if held else torch.zeros_like(ns_ones))
                x_raw = system.solve(
                    static, engine.add_rhs(I_s, engine._nl_rhs, rvals),
                    cat_lanes(*vals))
            else:
                G, I = engine.assemble_dc_iter(G_s, I_s, params, x, gmin)
                if use_gs:
                    x_raw = gauss_seidel_solve(
                        G[..., :N, :N], I[..., :N], x, opts.gs_max_iters,
                        opts.gs_tol, opts.gs_diag_eps)
                else:
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
            gmin_used = torch.where(upd, gmin, gmin_used)
            x = torch.where(upd[..., None], x_new, x)
            prev_err = torch.where(upd, err, prev_err)
            gmin = torch.where(done, gmin,
                               torch.where(finite, gmin_upd, gmin_nf))
            alpha_c = torch.where(upd, alpha_next, alpha_c)
            done = done | (upd & converged)
            it += 1
    return (x, gmin_used) if return_gmin else x


@torch.inference_mode()
def dc_refine(engine: Engine, params, x, n_iter: int = 2, gmin=0.0,
              batch: int = 0):
    """Mixed-precision iterative refinement of a DC operating point: the
    residual in the engine's precision (float64), the Jacobian factored and
    solved in float32, ``n_iter`` undamped sweeps x += J32^-1 r64 towards
    the gmin-free operating point (it removes the ramped solve's gmin
    leak).  Lanes (``batch``) ride the leading axis; every solve goes
    through ``lu_solve``, so on CUDA the batched float32 solve runs on K2,
    as the JAX package's runs on its Pallas LU."""
    N = engine.N
    floor = engine.opts.lu_pivot_floor
    gmin = engine._scalar(gmin)
    G_s, I_s = engine.dc_static(params, engine._scalar(1.0))
    for _ in range(int(n_iter)):
        G, I = engine.assemble_dc_iter(G_s, I_s, params, x, gmin)
        Gn = G[..., :N, :N]
        r = I[..., :N] - (Gn @ x[..., None])[..., 0]
        d = lu_solve(Gn.to(torch.float32), r.to(torch.float32), floor)
        x = x + d.to(engine.dtype)
    return x


@torch.inference_mode()
def dc_residual(engine: Engine, params, x, gmin=0.0):
    """Infinity-norm residual ||I(x) - G(x) x||_inf of the nonlinear DC
    system (gmin-free by default), in the engine's precision."""
    N = engine.N
    G_s, I_s = engine.dc_static(params, engine._scalar(1.0))
    G, I = engine.assemble_dc_iter(G_s, I_s, params, x, engine._scalar(gmin))
    r = I[..., :N] - (G[..., :N, :N] @ x[..., None])[..., 0]
    return r.abs().amax(-1)


_LINEAR = {"lu": dc_linear, "gs": dc_linear_gs,
           "tridiag": dc_linear_tridiag, "blockband": dc_linear_blockband}


def dc_operating_point(engine: Engine, params, nodeset=None,
                       linear_solver=None, batch: int = 0):
    """computeDcOperatingPoint: Newton for nonlinear circuits (with the
    .NODESET hold of ``dc_newton``), else one direct solve.  linear_solver:
    "lu" (the reference default), "gs" (dcSolveGaussSeidel), "tridiag"
    (ladders) or "blockband" (grids, trees, meshes); None takes the
    engine's ``dc_solver``.  batch: params carry a leading lane axis of
    that size (the linear solves take the lanes as they come)."""
    solver = linear_solver or engine.opts.dc_solver
    if engine.topo.has_nonlinear:
        return dc_newton(engine, params, batch=batch, nodeset=nodeset,
                         linear_solver=solver)
    return _LINEAR[solver](engine, params)
