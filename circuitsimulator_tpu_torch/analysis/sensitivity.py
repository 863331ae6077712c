"""DC sensitivity analysis (``.SENS``); port of the DC part of
``circuitsimulator_tpu/analysis/sensitivity.py``.

The gradient of a DC output V(out[, ref]) with respect to every circuit
parameter at once, by implicit differentiation at the converged operating
point:

    KCL residual  r(x, p) = A(x, p) x - b(x, p) = 0  at the solution
    MNA Newton is Newton on r, so  dr/dx = A(x, p)  (the stamped Jacobian)
    y = c^T x  =>  dy/dp = -lambda^T dr/dp   with   A^T lambda = c

One adjoint solve (``lu_solve``: K2 at (1, N, 1) on the card) and one
reverse pass of ``torch.autograd`` through the assembly give the whole
gradient, the thermal voltage (temperature) included.  The operating point
is first polished with a few undamped Newton steps at gmin = 0 so the
residual is zero to machine precision where it is linearised.

The Engine's solver paths run under ``torch.inference_mode``, whose tensors
can never join autograd; the float leaves of ``params`` and the operating
point are therefore cloned into ordinary tensors outside it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.assemble import Engine
from ..ops.lu import lu_solve
from .dc import dc_operating_point


def dc_residual(engine: Engine, params, x):
    """Exact KCL residual r(x, p) (N,) with gmin = 0: differentiable in
    params (pure assembly, no iteration)."""
    N = engine.N
    G_s, I_s = engine.dc_static(params, engine._scalar(1.0))
    G, I = engine.assemble_dc_iter(G_s, I_s, params, x, 0.0)
    return torch.einsum("...ij,...j->...i", G[..., :N, :N], x) - I[..., :N]


def dc_jacobian(engine: Engine, params, x):
    """The stamped Jacobian dr/dx = G[:N, :N] at x, gmin = 0."""
    N = engine.N
    G_s, I_s = engine.dc_static(params, engine._scalar(1.0))
    G, _ = engine.assemble_dc_iter(G_s, I_s, params, x, 0.0)
    return G[..., :N, :N]


@torch.inference_mode()
def _polish(engine: Engine, params, x, iters: int = 3):
    """Undamped Newton refinements at gmin = 0 (fixed count; K2 solves)."""
    N = engine.N
    G_s, I_s = engine.dc_static(params, engine._scalar(1.0))
    for _ in range(iters):
        G, I = engine.assemble_dc_iter(G_s, I_s, params, x, 0.0)
        x_new = lu_solve(G[..., :N, :N], I[..., :N],
                         engine.opts.lu_pivot_floor)
        x = torch.where(torch.isfinite(x_new).all(-1, keepdim=True),
                        x_new, x)
    return x


def _unit(engine: Engine, eq: int, ref: int = -1):
    """e_eq - e_ref as an (N,) tensor; a ground index (< 0 or >= N) adds
    nothing."""
    c = torch.zeros((engine.N,), dtype=engine.dtype, device=engine.device)
    if 0 <= eq < engine.N:
        c[eq] += 1.0
    if 0 <= ref < engine.N:
        c[ref] -= 1.0
    return c


def dc_sensitivity(engine: Engine, params, out_eq: int, ref_eq: int = -1,
                   x: Optional[Any] = None, polish_iters: int = 3):
    """d V(out, ref) / d p for every leaf of ``params``.

    Returns (grads, x, residual_norm): a dict matching params (integer
    leaves get zeros, as JAX's float0 cotangents), the polished operating
    point, and the final |r| as a quality check."""
    if x is None:
        x = dc_operating_point(engine, params)
    x = _polish(engine, params, x, polish_iters)
    with torch.inference_mode():
        J = dc_jacobian(engine, params, x)
        lam = lu_solve(J.transpose(-1, -2), _unit(engine, out_eq, ref_eq),
                       engine.opts.lu_pivot_floor)
    # ordinary tensors: inference tensors cannot be saved for backward
    x = x.clone()
    lam = lam.clone()
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items() if torch.is_floating_point(v)}
    r = dc_residual(engine, {**params, **leaves}, x)
    got = torch.autograd.grad(r, list(leaves.values()), grad_outputs=-lam,
                              allow_unused=True)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    for k, g in zip(leaves, got):
        if g is not None:
            grads[k] = g.detach()
    with torch.inference_mode():
        rnorm = torch.linalg.vector_norm(dc_residual(engine, params, x))
    return grads, x, rnorm


# params-key -> (circuit element kind, parameter label)
_PARAM_LABELS = {
    "res_r": ("R", "R"), "cap_c": ("C", "C"), "ind_l": ("L", "L"),
    "mut_k": ("K", "K"),
    "jf_vto": ("J", "VTO"), "jf_beta": ("J", "BETA"), "jf_lam": ("J", "LAMBDA"),
    "sw_ron": ("S", "RON"), "sw_roff": ("S", "ROFF"), "sw_vt": ("S", "VT"),
    "vs_dc": ("V", "DC"), "is_dc": ("I", "DC"),
    "mos_vth": ("M", "VT"), "mos_k": ("M", "K"), "mos_lam": ("M", "LAMBDA"),
    "mos_cj0": ("M", "CJ0"), "mos_gamma": ("M", "GAMMA"),
    "dio_is": ("D", "IS"), "dio_n": ("D", "N"),
    "bjt_is": ("Q", "IS"), "bjt_bf": ("Q", "BF"), "bjt_br": ("Q", "BR"),
    "bjt_vaf": ("Q", "VAF"), "bjt_cje": ("Q", "CJE"),
    "bjt_cjc": ("Q", "CJC"),
    "res_tc1": ("R", "TC1"), "res_tc2": ("R", "TC2"),
    "vcvs_gain": ("E", "GAIN"), "vccs_g": ("G", "GM"),
    "cccs_gain": ("F", "GAIN"), "ccvs_r": ("H", "R"),
}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def sensitivity_report(circuit, grads: Dict[str, Any],
                       normalize_params: Optional[Dict[str, Any]] = None):
    """[(label, dV/dp [, p*dV/dp])] rows for every per-element parameter,
    labeled ``d/d<PARAM>(<element>)``, sorted by |sensitivity| descending.
    With normalize_params the per-decade sensitivity p*dy/dp is added."""
    names = {}
    for e in circuit.elements:
        names.setdefault(e.kind, []).append(e.name)
    rows = []
    for key, (kind, label) in _PARAM_LABELS.items():
        g = grads.get(key)
        if g is None or not hasattr(g, "shape") or _np(g).size == 0:
            continue
        g = _np(g)
        for i, name in enumerate(names.get(kind, [])):
            if i >= g.shape[-1]:
                break
            row = [f"d/d{label}({name})", float(g[..., i])]
            if normalize_params is not None:
                p = float(_np(normalize_params[key])[..., i])
                row.append(p * float(g[..., i]))
            rows.append(tuple(row))
    if "vt_thermal" in grads and hasattr(grads["vt_thermal"], "shape"):
        g = float(_np(grads["vt_thermal"]))
        row = ["d/dVt(thermal)", g]
        if normalize_params is not None:
            row.append(float(_np(normalize_params["vt_thermal"])) * g)
        rows.append(tuple(row))
    rows.sort(key=lambda r: -abs(r[1]))
    return rows


def unit_tangent(params, key: str, idx=None):
    """A params-shaped tangent: 1.0 at params[key][idx] (every entry of the
    leaf when idx is None), zeros elsewhere (integer leaves too: they are
    structural and take no tangent)."""
    t = {k: torch.zeros_like(v) for k, v in params.items()}
    t[key][... if idx is None else idx] = 1.0
    return t


def _jvp(fn, primals, tangents):
    """(fn(*primals), its tangent along ``tangents``) for pytrees of
    tensors in and out, by two reverse passes: u(v) = (dfn)^T v with the
    graph kept, then d<u(v), tangent>/dv = dfn . tangent.  (Eager forward
    mode of this PyTorch takes a Python path for every broadcasting
    operator and costs twice as much on the assembly.)  An output that
    does not depend on the primals gets a zero tangent."""
    from torch.utils import _pytree as pytree
    p_leaves, spec = pytree.tree_flatten(primals)
    t_leaves = pytree.tree_leaves(tangents)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in p_leaves]
        out = fn(*pytree.tree_unflatten(live, spec))
        o_leaves, o_spec = pytree.tree_flatten(out)
        idx = [i for i, o in enumerate(o_leaves) if o.requires_grad]
        vs = [torch.zeros_like(o_leaves[i], requires_grad=True)
              for i in idx]
        tan = [torch.zeros_like(o) for o in o_leaves]
        if idx:
            us = torch.autograd.grad([o_leaves[i] for i in idx], live, vs,
                                     create_graph=True, allow_unused=True)
            tot = sum((u * t).sum() for u, t in zip(us, t_leaves)
                      if u is not None)
            if isinstance(tot, torch.Tensor) and tot.requires_grad:
                got = torch.autograd.grad(tot, vs, allow_unused=True)
                for i, g in zip(idx, got):
                    if g is not None:
                        tan[i] = g
    prim = [o.detach() for o in o_leaves]
    return (pytree.tree_unflatten(prim, o_spec),
            pytree.tree_unflatten(tan, o_spec))


def transient_sensitivity(engine: Engine, params, tangent, tstep, tstop,
                          **tran_kw):
    """Waveform sensitivity d x(t) / d p in the direction ``tangent`` (a
    params-shaped dict, e.g. from ``unit_tangent``): returns (xs, dxs),
    the transient and its tangent, each (n_steps + 1, N).

    The JAX package pushes ``jax.jvp`` through the DC and every Newton
    iteration of ``run_transient``; so does this, iteration by iteration:
    each iteration's tangent is dx_raw = A^-1 (dI - dA x_raw) (a second
    ``lu_solve``: K2 on CUDA) with (dA, dI) the assembly's own tangent
    (``torch.func.jvp``), carried through the damping, the clamp, the
    predictor and the stopping rule of ``analysis/transient.py``.  The
    iterate solves the whole dense system (the fixed point of every
    transient solver).  The DC point's tangent is the implicit one at the
    gmin of its last Newton solve (the reference's shunt, which the JAX
    tangent carries), J dx0 = -(dr_dc/dp) p'.  ``tran_kw`` is accepted and
    ignored, as in the JAX package."""
    from .dc import dc_linear, dc_newton
    from .transient import n_steps_for
    opts, N = engine.opts, engine.N
    floor, method = opts.lu_pivot_floor, opts.tran_method
    jvp = _jvp
    # the leaves that the tangent moves carry it; the others are constants
    fkeys = [k for k, v in params.items() if v.is_floating_point()
             and bool((tangent[k] != 0).any())]
    rest = {k: v for k, v in params.items() if k not in fkeys}
    pf = {k: params[k].detach() for k in fkeys}
    tp = {k: tangent[k].to(params[k].dtype) for k in fkeys}

    def solve(A, b):
        return lu_solve(A, b, floor).clone()

    if engine.topo.has_nonlinear:
        x, g0 = dc_newton(engine, params, return_gmin=True)
        x, g0 = x.clone(), g0.clone()
    else:
        x, g0 = dc_linear(engine, params).clone(), 0.0

    def dc_system(p):
        G_s, I_s = engine.dc_static({**rest, **p}, engine._scalar(1.0))
        G, I = engine.assemble_dc_iter(G_s, I_s, {**rest, **p}, x, g0)
        J = G[..., :N, :N]
        return (J @ x[..., None])[..., 0] - I[..., :N], J
    (_, J), (dr, _) = jvp(dc_system, (pf,), (tp,))
    xd = -solve(J, dr)
    xs, dxs = [x], [xd]

    dt = float(tstep)
    dt_t = torch.tensor(dt, dtype=engine.dtype, device=engine.device)
    static_I = engine.make_tran_static_I(dt, method)
    update = engine.make_update_state(dt_t, method)
    inv_dt = 1.0 / dt_t if engine.mos_charge else None

    G_s, G_sd = jvp(lambda p: engine.tran_static_G(
        {**rest, **p}, dt_t, opts.tran_gmin, method), (pf,), (tp,))

    def system(p, s, x_, G_s, I_s, t):
        qex = None
        if engine.mos_charge:
            qex = ((s["qm"], inv_dt, s["qi"]) if method == "trap"
                   else (s["qm"], inv_dt))
        G, I = engine.assemble_tran_iter(G_s, I_s, {**rest, **p}, x_, t, qex)
        return G[..., :N, :N], I[..., :N]

    state, sd = jvp(lambda p, x_: engine.init_state(x_, {**rest, **p}, dt),
                    (pf, x), (tp, xd))
    x_prev, xd_prev = x, xd
    n_steps = n_steps_for(dt, float(tstop))
    ts = torch.arange(1, n_steps + 1, dtype=engine.dtype,
                      device=engine.device) * dt_t
    alpha, tol, clamp = opts.tran_alpha, opts.tran_tol, opts.tran_newton_clamp
    unrolled = int(opts.tran_unrolled_iters)
    for k in range(n_steps):
        t = ts[k]
        I_s, I_sd = jvp(lambda p, s: static_I({**rest, **p}, s, t),
                        (pf, state), (tp, sd))
        if opts.tran_predictor:
            x_new, xd_new = 2.0 * x - x_prev, 2.0 * xd - xd_prev
            x_prev, xd_prev = x, xd
            x, xd = x_new, xd_new
        done = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
        for _ in range(unrolled or opts.tran_max_newton_iters):
            if not unrolled and bool(done.all()):
                break
            (G, I), (Gd, Id) = jvp(
                lambda p, s, x_, a, b: system(p, s, x_, a, b, t),
                (pf, state, x, G_s, I_s), (tp, sd, xd, G_sd, I_sd))
            x_raw = solve(G, I)
            xd_raw = solve(G, Id - (Gd @ x_raw[..., None])[..., 0])
            finite = torch.isfinite(x_raw).all(-1)
            u, ud = x_raw - x, xd_raw - xd
            if clamp > 0.0:
                ud = torch.where(u.abs() < clamp, ud, 0.0)
                u = torch.clamp(u, -clamp, clamp)
            x_new, xd_new = x + alpha * u, xd + alpha * ud
            err = torch.linalg.vector_norm(x_new - x, dim=-1)
            upd = (finite & ~done)[..., None]
            x, xd = torch.where(upd, x_new, x), torch.where(upd, xd_new, xd)
            done = done | (upd[..., 0] & (err < tol)) | ~finite
        xs.append(x)
        dxs.append(xd)
        state, sd = jvp(lambda p, x_, s: update({**rest, **p}, x_, s),
                        (pf, x, state), (tp, xd, sd))
    return torch.stack(xs), torch.stack(dxs)
