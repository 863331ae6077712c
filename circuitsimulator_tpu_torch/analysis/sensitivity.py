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
