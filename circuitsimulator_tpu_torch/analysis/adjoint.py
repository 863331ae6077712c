"""Reverse-mode transient adjoint: d loss(waveform) / d every parameter in
one backward pass (port of ``circuitsimulator_tpu/analysis/adjoint.py``).

The converged Backward-Euler or trapezoidal step and the DC operating
point are each a ``torch.autograd.Function`` whose backward uses the
implicit function theorem at the converged solution,

    r(x_k; p, state_{k-1}, t_k) = 0,     dr/dx = A(x_k)  (Newton identity)
    xbar -> lambda = A^T \\ xbar,  (pbar, statebar) = -lambda^T dr/d(p, state)

so autograd never differentiates through a Newton loop.  The Python loop
over the steps records the state updates (the T-line ring push included),
and its reverse pass is the adjoint-in-time sweep.  Every solve, forward
and transposed, is ``ops/lu.lu_solve``: the K2 kernel at (1, N, 1) on a
CUDA tensor.  Memory: the stored trajectory, O(n_steps (N + state)).

Cost: the forward transient plus, per step, the assembly of the sources
and the devices, one transposed solve and one ``torch.autograd.grad``
through the residual, independent of the number of parameters.  The
static matrix (R, the companions, gmin, the couplings) depends on the
parameters alone: as in ``analysis/transient.py`` it is assembled once
per run, and its cotangent, summed over the steps, goes through that one
assembly.

The Function inputs are the float tensors that require a gradient (the
parameter leaves, then the state leaves); every other leaf rides along
unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..ops.assemble import Engine
from ..ops.lu import lu_solve
from .dc import dc_operating_point
from .sensitivity import _polish
from .transient import n_steps_for


def _split(d: Dict[str, Any]):
    """(keys, tensors) of the float tensors of ``d`` that require a
    gradient, and the rest of ``d``."""
    keys = [k for k, v in d.items() if isinstance(v, torch.Tensor)
            and v.is_floating_point() and v.requires_grad]
    return keys, [d[k] for k in keys], {k: v for k, v in d.items()
                                        if k not in keys}


def _implicit_vjp(assemble, x, leaves, needs, xbar, floor):
    """(cotangents of ``leaves``, None where not ``needs``; lambda) at a
    converged x of the residual r = G x - I, (G, I) = assemble(leaves):
    lambda = G^T \\ xbar (``lu_solve``, cloned: an inference tensor cannot
    enter autograd), then -lambda^T dr/d leaf by one
    ``torch.autograd.grad``."""
    with torch.enable_grad():
        live = [v.detach().requires_grad_(n) for v, n in zip(leaves, needs)]
        G, I = assemble(live)
        r = (G @ x[..., None])[..., 0] - I
    lam = lu_solve(G.detach().mT, xbar, floor).clone()
    want = [v for v, n in zip(live, needs) if n]
    got = iter(torch.autograd.grad(r, want, grad_outputs=-lam,
                                   allow_unused=True) if want else ())
    out = []
    for v, n in zip(live, needs):
        g = next(got) if n else None
        out.append(torch.zeros_like(v) if n and g is None else g)
    return out, lam


class _DiffDC(torch.autograd.Function):
    """x = _polish(dc_operating_point(p)) (the ramped solver, then three
    undamped Newton steps at gmin = 0); backward through the gmin = 0 DC
    residual."""

    @staticmethod
    def forward(ctx, engine, keys, rest, *leaves):
        params = {**rest, **dict(zip(keys, leaves))}
        x = _polish(engine, params,
                    dc_operating_point(engine, params)).clone()
        ctx.engine, ctx.keys, ctx.rest = engine, keys, rest
        ctx.save_for_backward(x, *leaves)
        return x

    @staticmethod
    def backward(ctx, xbar):
        x, *leaves = ctx.saved_tensors
        engine, N = ctx.engine, ctx.engine.N

        def assemble(live):
            p = {**ctx.rest, **dict(zip(ctx.keys, live))}
            G_s, I_s = engine.dc_static(p, engine._scalar(1.0))
            G, I = engine.assemble_dc_iter(G_s, I_s, p, x, 0.0)
            return G[..., :N, :N], I[..., :N]

        grads, _ = _implicit_vjp(assemble, x, leaves,
                                 ctx.needs_input_grad[3:], xbar,
                                 engine.opts.lu_pivot_floor)
        return (None, None, None, *grads)


def diff_dc(engine: Engine, params):
    """The differentiable DC operating point (N,) of ``params``."""
    keys, leaves, rest = _split(params)
    return _DiffDC.apply(engine, keys, rest, *leaves)


class _StepRule:
    """The static parts of one converged step at a fixed dt and method."""

    def __init__(self, engine: Engine, dt: float, method: str):
        self.engine, self.method = engine, method
        self.dt = torch.tensor(dt, dtype=engine.dtype, device=engine.device)
        self.static_I = engine.make_tran_static_I(dt, method)

    def static_G(self, params):
        """The whole transient matrix but the devices' entries: one per
        run (it depends on the parameters alone)."""
        return self.engine.tran_static_G(params, self.dt,
                                         self.engine.opts.tran_gmin,
                                         self.method)

    def system(self, params, state, x, t, G_s):
        """(G, I) of the step's residual G x - I at x: the whole dense
        system (no Woodbury), no charge rows (as the JAX adjoint builds
        it)."""
        N = self.engine.N
        I_s = self.static_I(params, state, t)
        G, I = self.engine.assemble_tran_iter(G_s, I_s, params, x, t)
        return G[..., :N, :N], I[..., :N]

    def newton(self, params, state, t, x, G_s):
        """JAX's adjoint Newton: undamped, the dense system solved by
        ``lu_solve``, done |= (finite & err < tran_tol) | ~finite, the old
        x kept on a non-finite solve, at most tran_max_newton_iters."""
        e, N, opts = self.engine, self.engine.N, self.engine.opts
        I_s = self.static_I(params, state, t)
        done = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
        for _ in range(opts.tran_max_newton_iters):
            if bool(done.all()):
                break
            G, I = e.assemble_tran_iter(G_s, I_s, params, x, t)
            x_raw = lu_solve(G[..., :N, :N], I[..., :N], opts.lu_pivot_floor)
            finite = torch.isfinite(x_raw).all(-1)
            err = torch.linalg.vector_norm(x_raw - x, dim=-1)
            x = torch.where((finite & ~done)[..., None], x_raw, x)
            done = done | (finite & (err < opts.tran_tol)) | ~finite
        return x


class _DiffStep(torch.autograd.Function):
    """x_k(params, state_{k-1}, t_k) of one converged step, with the run's
    static matrix G_s an input of its own: its cotangent -lambda x^T
    (the residual is G x - I) accumulates over the steps, and autograd
    takes it through the static assembly once per backward sweep.
    x_init gets a zero cotangent, t none."""

    @staticmethod
    def forward(ctx, rule, keys, n_param, rest, t, x_init, G_s, *leaves):
        params = {**rest[0], **dict(zip(keys[:n_param], leaves[:n_param]))}
        state = {**rest[1], **dict(zip(keys[n_param:], leaves[n_param:]))}
        x = rule.newton(params, state, t, x_init, G_s).clone()
        ctx.rule, ctx.keys, ctx.n_param, ctx.rest = rule, keys, n_param, rest
        ctx.save_for_backward(x, t, G_s, *leaves)
        return x

    @staticmethod
    def backward(ctx, xbar):
        x, t, G_s, *leaves = ctx.saved_tensors
        n, N = ctx.n_param, ctx.rule.engine.N
        G_s = G_s.detach()

        def assemble(live):
            p = {**ctx.rest[0], **dict(zip(ctx.keys[:n], live[:n]))}
            s = {**ctx.rest[1], **dict(zip(ctx.keys[n:], live[n:]))}
            return ctx.rule.system(p, s, x, t, G_s)

        grads, lam = _implicit_vjp(assemble, x, leaves,
                                   ctx.needs_input_grad[7:], xbar,
                                   ctx.rule.engine.opts.lu_pivot_floor)
        Gbar = None
        if ctx.needs_input_grad[6]:
            Gbar = torch.zeros_like(G_s)
            Gbar[..., :N, :N] = -(lam[..., :, None] * x[..., None, :])
        return (None,) * 6 + (Gbar,) + tuple(grads)


def diff_step(rule: _StepRule, params, state, t, x_init, G_s):
    """The differentiable converged step x_k."""
    pk, pl, prest = _split(params)
    sk, sl, srest = _split(state)
    return _DiffStep.apply(rule, pk + sk, len(pk), (prest, srest), t,
                           x_init.detach(), G_s, *pl, *sl)


def diff_transient(engine: Engine, params, tstep, tstop):
    """Reverse-differentiable transient: (times (n_steps + 1,), xs
    (n_steps + 1, N)); ``torch.autograd`` of any function of xs reaches
    every parameter that requires a gradient through the rules above."""
    dtype, dev = engine.dtype, engine.device
    method = engine.opts.tran_method
    n_steps = n_steps_for(float(tstep), float(tstop))
    rule = _StepRule(engine, float(tstep), method)
    ts = torch.arange(1, n_steps + 1, dtype=dtype, device=dev) * rule.dt
    update_state = engine.make_update_state(rule.dt, method)
    x = diff_dc(engine, params)
    # T-line decks carry the delay ring in the state: its push is a
    # torch.cat, which autograd differentiates
    state = (engine.init_state(x, params, float(tstep)) if engine.n_tl
             else engine.init_state(x))
    G_s = rule.static_G(params)
    xs = [x]
    for i in range(n_steps):
        x = diff_step(rule, params, state, ts[i], x, G_s)
        state = update_state(params, x, state)
        xs.append(x)
    times = torch.cat([torch.zeros((1,), dtype=dtype, device=dev), ts])
    return times, torch.stack(xs)


def transient_adjoint_gradient(engine: Engine, params, tstep, tstop,
                               loss_fn: Callable[[Any, Any], Any]):
    """(loss value, d loss / d params) for loss_fn(times, xs) -> scalar.
    Integer leaves (waveform kinds, PWL counts) are structural: they get
    zero gradients in the engine's dtype."""
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items() if v.is_floating_point()}
    times, xs = diff_transient(engine, {**params, **leaves}, tstep, tstop)
    val = loss_fn(times, xs)
    got = torch.autograd.grad(val, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v, dtype=engine.dtype)
             for k, v in params.items()}
    for k, g in zip(leaves, got):
        if g is not None:
            grads[k] = g
    return val.detach(), grads
