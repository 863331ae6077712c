"""Adaptive-timestep transient on the dyadic refinement ladder (port of
``circuitsimulator_tpu/analysis/adaptive.py``: the ``woodbury`` and ``lu``
backends, and the ``tridiag`` and ``blockband`` ones with their scattered
statics stacked per level; ``blockwb`` takes the dense statics, as in the
JAX package).

The internal step is ``tstep / 2**lvl`` for an integer level ``lvl`` in
[0, L], L = ``tran_max_refine_levels``.  Every candidate dt is known up
front, so the static matrix of each level (and, for the Woodbury backend,
its G0^-1, Y and Y_cols) is built once and stacked on a leading level
axis; the L + 1 G0 inverses are one K2 launch with the levels folded into
the lanes.  An integer tick clock (2**L ticks per output interval, a
level-l step advances 2**(L-l)) keeps every step on the dyadic grid, so
the integrator lands exactly on each ``.TRAN`` point and the result has
the fixed-step path's rows.

Local truncation error comes from the linear predictor x_pred = x + (x -
x_prev) dt / dt_prev: LTE ~ |x - x_pred| dt / (dt + dt_prev) (a third of
that under trap) in the weighted norm rtol max(|x'|, |x|) + atol.  A step
is rejected and refined when the LTE exceeds 1 or Newton does not converge
or its solve is not finite; it grows a level when the LTE is below 0.25
(0.1 under trap) and the dyadic alignment allows.  At the deepest level a
step is always accepted; a non-finite one freezes the lane (``failed``),
one with LTE above 1 sets ``lte_exceeded``.

JAX batches this function with ``vmap``; the port takes lanes directly
(params with a leading lane axis, or a (B, N) ``x0``): the level, tick
position and predictor history are per-lane tensors, each lane's level
view of the stacked matrices is gathered per substep, and every carry
update is masked by the lane's own activity, as a vmapped ``while_loop``
leaves a finished lane's carry alone.  The ``while`` loops become host
loops: a substep runs while any lane is still inside its interval, a
Newton iteration while any lane is not done.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import torch

from ..ops.assemble import Engine
from ..ops.lu import lu_solve
from ..ops.woodbury import WoodburySolver
from .dc import dc_operating_point
from .transient import n_steps_for, sparse_tran_backend


@dataclasses.dataclass
class AdaptiveTransientResult:
    times: Any        # (n_out + 1,): the .TRAN output grid with t = 0
    xs: Any           # (n_out + 1, ..., N) or None
    x_final: Any      # (..., N)
    n_substeps: Any   # (...,) accepted internal steps
    n_rejected: Any   # (...,) rejected (refined) attempts
    newton_iters: Any # (...,) Newton iterations
    failed: Any       # (...,) non-finite solve at the deepest level
    lte_exceeded: Any # (...,) accepted a step with LTE > 1 at the deepest
    n_steps: int


TLINE_MESSAGE = (
    "adaptive timestepping with transmission lines is not "
    "supported: the delay ring length is dt-dependent and the "
    "dyadic refinement levels use different dts, so a single "
    "ring cannot serve all levels (a fixed-rate ring at dt_min "
    "would need a dynamic number of pushes per accepted step). "
    "Use the fixed-step transient — T-line decks run on every "
    "fixed-step backend including the fused Pallas kernel "
    "(ops/pallas_step.py carries the ring in VMEM).")


def _lanes(params):
    """(B,) of batched params (a leading lane axis on every leaf; the
    per-lane scalar ``vt_thermal`` tells), () of a single circuit."""
    return tuple(params["vt_thermal"].shape)


@torch.inference_mode()
def run_transient_adaptive(engine: Engine, params, tstep, tstop,
                           x0: Optional[Any] = None, save_xs: bool = True):
    """LTE-controlled transient on the dyadic ladder.  Output rows are the
    fixed-step ``.TRAN`` grid (t = 0 from the DC point or ``x0``, then k
    tstep).  params and x0 may carry one leading lane axis (B,): each lane
    runs as JAX's vmapped run does, with its own levels and counters."""
    opts = engine.opts
    N, dtype, dev = engine.N, engine.dtype, engine.device
    method = opts.tran_method
    L = int(opts.tran_max_refine_levels)
    if L < 0 or L > 20:
        raise ValueError("tran_max_refine_levels must be in [0, 20]")
    END = 1 << L                      # ticks per output interval
    tstep_f = float(tstep)
    dt_min = torch.tensor(tstep_f / END, dtype=dtype, device=dev)
    alpha = opts.tran_adaptive_alpha
    rtol, atol = opts.tran_lte_rtol, opts.tran_lte_atol
    grow_thr = 0.25 if method == "be" else 0.1
    n_out = n_steps_for(tstep_f, float(tstop))
    if engine.n_tl:
        raise NotImplementedError(TLINE_MESSAGE)
    woodbury = opts.tran_solver == "woodbury"
    # blockwb has no ladder form: like the JAX package's, it takes the
    # dense per-level statics below
    sparse = opts.tran_solver in ("tridiag", "blockband")

    # the lanes: a single circuit runs as a batch of one
    single = not _lanes(params) and (x0 is None or x0.dim() == 1)
    if single:
        params = {k: v[None] for k, v in params.items()}
    B = _lanes(params)[0] if _lanes(params) else x0.shape[0]
    if not _lanes(params):
        params = {k: v.expand((B,) + v.shape) for k, v in params.items()}
    lanes = torch.arange(B, device=dev)

    # per-level statics, (L + 1, B, N + 1, N + 1), or the sparse backends'
    # scattered statics stacked the same way
    dts = [tstep_f / (1 << lv) for lv in range(L + 1)]
    if sparse:
        statics, sparse_solve = sparse_tran_backend(engine, params, dts,
                                                    method)
        stack = {k: torch.stack([st[k] for st in statics])
                 for k in statics[0]}
    else:
        Gs = torch.stack([engine.tran_static_G(params, d, opts.tran_gmin,
                                               method) for d in dts])
    if woodbury:
        # the L + 1 G0 inverses in one solve: levels x lanes systems
        wb = WoodburySolver(engine, params, Gs[..., :N, :N])

    if x0 is None:
        x0 = dc_operating_point(engine, params, batch=B)
    else:
        x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
        if single:
            x0 = x0[None]
        x0 = x0.expand(B, N)
    state = engine.init_state(x0)

    def newton(x_init, I_s, lvl, t_new, active):
        """Damped Newton at one substep of each active lane: (x, conv,
        finite, iters), each lane's loop as JAX's (no clamp, the
        adaptive alpha, stop on convergence or a non-finite solve)."""
        if woodbury:
            wv = copy.copy(wb)
            wv.G0inv = wb.G0inv[lvl, lanes]
            wv.Y = wb.Y[lvl, lanes]
            wv.Y_cols = wb.Y_cols[lvl, lanes]
            z0 = wv.z0(I_s[..., :N])
        elif sparse:
            static = {k: v[lvl, lanes] for k, v in stack.items()}
        else:
            G_static = Gs[lvl, lanes]
        x = x_init
        done = ~active
        conv = torch.zeros_like(active)
        finite = torch.ones_like(active)
        it = torch.zeros((B,), dtype=torch.int32, device=dev)
        for _ in range(opts.tran_max_newton_iters):
            if not bool((~done).any()):
                break
            act = ~done
            if woodbury:
                x_raw = wv.solve(params, x, z0, None, t_new)
            elif sparse:
                x_raw = sparse_solve(params, x, I_s, None, t_new, static)
            else:
                G, I = engine.assemble_tran_iter(G_static, I_s, params, x,
                                                 t_new)
                x_raw = lu_solve(G[..., :N, :N], I[..., :N],
                                 opts.lu_pivot_floor)
            fin = torch.isfinite(x_raw).all(-1)
            x_new = x + alpha * (x_raw - x)
            err = torch.linalg.vector_norm(x_new - x, dim=-1)
            cv = fin & (err < opts.tran_tol)
            x = torch.where((act & fin)[:, None], x_new, x)
            done = done | (act & (cv | ~fin))
            conv = conv | (act & cv)
            finite = finite & (~act | fin)
            it = it + act.to(torch.int32)
        return x, conv, finite, it

    def where_lane(m, new, old):
        return torch.where(m.reshape(m.shape + (1,) * (new.dim() - 1)),
                           new, old)

    x, x_prev = x0, x0
    lvl = torch.zeros((B,), dtype=torch.int64, device=dev)
    dt_prev = torch.full((B,), tstep_f, dtype=dtype, device=dev)
    have_prev = torch.zeros((B,), dtype=torch.bool, device=dev)
    failed = torch.zeros_like(have_prev)
    lte_exceeded = torch.zeros_like(have_prev)
    n_sub = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_rej = torch.zeros_like(n_sub)
    n_newton = torch.zeros_like(n_sub)
    t0s = (torch.arange(n_out, dtype=dtype, device=dev)
           * torch.tensor(tstep_f, dtype=dtype, device=dev))
    xs = (torch.empty((n_out + 1, B, N), dtype=dtype, device=dev)
          if save_xs else None)
    if save_xs:
        xs[0] = x0
    for i in range(n_out):
        t0 = t0s[i]
        pos = torch.zeros((B,), dtype=torch.int64, device=dev)
        while bool((pos < END).any()):
            active = pos < END
            ticks = END >> lvl
            dt = tstep_f * torch.exp2(-lvl.to(dtype))
            t_new = t0 + (pos + ticks).to(dtype) * dt_min
            I_s = engine.make_tran_static_I(dt[:, None], method)(
                params, state, t_new[:, None])
            # the linear predictor: Newton's start and the LTE probe
            slope = torch.where(have_prev[:, None],
                                (x - x_prev)
                                / torch.maximum(dt_prev, dt_min)[:, None],
                                0.0)
            x_pred = x + slope * dt[:, None]
            x_new, conv, finite, iters = newton(x_pred, I_s, lvl, t_new,
                                                active)
            fac = dt / (dt + dt_prev)
            if method == "trap":
                fac = fac / 3.0
            wt = rtol * torch.maximum(x_new.abs(), x.abs()) + atol
            lte = ((x_new - x_pred).abs() / wt).amax(-1) * fac
            lte_ok = lte <= 1.0

            at_max = lvl >= L
            good = finite & conv & lte_ok
            accept = good | at_max
            # at the deepest level a non-finite solve freezes the lane
            freeze = at_max & ~finite
            x_acc = torch.where(freeze[:, None], x, x_new)
            new_pos = pos + ticks
            state_new = engine.make_update_state(dt[:, None], method)(
                params, x_acc, state)
            lvl_ref = torch.clamp(lvl + 1, max=L)             # on reject
            stride2 = 2 * ticks
            can_grow = ((lvl > 0) & (new_pos % stride2 == 0)
                        & (new_pos + stride2 <= END) & (lte <= grow_thr))
            lvl_acc = torch.where(can_grow & finite & conv, lvl - 1, lvl)

            upd = active & accept
            rej = active & ~accept
            pos = torch.where(upd, new_pos, pos)
            lvl = torch.where(upd, lvl_acc, torch.where(rej, lvl_ref, lvl))
            x_prev = torch.where(upd[:, None], x, x_prev)
            x = torch.where(upd[:, None], x_acc, x)
            dt_prev = torch.where(upd, dt, dt_prev)
            have_prev = have_prev | upd
            state = {k: where_lane(upd, state_new[k], state[k])
                     for k in state}
            failed = failed | (upd & freeze)
            lte_exceeded = lte_exceeded | (upd & ~good & finite)
            n_sub = n_sub + upd.to(torch.int32)
            n_rej = n_rej + rej.to(torch.int32)
            n_newton = n_newton + torch.where(active, iters, 0)
        if save_xs:
            xs[i + 1] = x

    times = torch.cat([torch.zeros((1,), dtype=dtype, device=dev),
                       torch.arange(1, n_out + 1, dtype=dtype, device=dev)
                       * tstep_f])
    out = (x, n_sub, n_rej, n_newton, failed, lte_exceeded)
    if single:
        out = tuple(a[0] for a in out)
        xs = xs[:, 0] if save_xs else None
    x, n_sub, n_rej, n_newton, failed, lte_exceeded = out
    return AdaptiveTransientResult(
        times=times, xs=xs, x_final=x, n_substeps=n_sub, n_rejected=n_rej,
        newton_iters=n_newton, failed=failed, lte_exceeded=lte_exceeded,
        n_steps=n_out)
