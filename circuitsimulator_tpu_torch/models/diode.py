"""Junction diode Newton linearization, vectorized.

Port of ``circuitsimulator_tpu/models/diode.py``: the Shockley equation with
a linearized continuation above a critical argument, which keeps I and
dI/dV continuous and the Newton iterates finite:

    I(V) = Is * (e(V / (n*Vt)) - 1),   e(u) = exp(u)                u <= U
                                       e(u) = exp(U) * (1 + u - U)  u >  U

and the optional reverse breakdown branch: below -BV the reverse current
grows as -IBV * e(-(BV + V) / Vt) (ideality 1, the same continuation),
gated per device on bv > 0.
"""

from __future__ import annotations

import math

import torch

VT_THERMAL = 0.025852  # kT/q at 300 K, volts
EXP_LIMIT = 40.0


def exp_lim(u, u_max=EXP_LIMIT):
    """(e(u), de/du) of the limited exponential.  u = -inf gives (0, 0);
    no inf reaches a selected value for any finite u."""
    e = torch.exp(torch.clamp_max(u, u_max))
    top = math.exp(u_max)
    below = u <= u_max
    return (torch.where(below, e, top * (1.0 + (u - u_max))),
            torch.where(below, e, top))


def diode_linearize(i_sat, n_ideal, vp, vm, vt=VT_THERMAL, u_max=EXP_LIMIT,
                    bv=None, ibv=None, nvt=None):
    """Per-device linearization I ~= g*(Vp-Vm) + cst; returns (g, cst),
    each (..., nD).  bv/ibv = None keeps the breakdown terms structurally
    absent; nvt, when given, is n_ideal * vt already multiplied."""
    v = vp - vm
    if nvt is None:
        nvt = n_ideal * vt
    exp_u, dexp_u = exp_lim(v / nvt, u_max)
    i = i_sat * (exp_u - 1.0)
    g = i_sat * dexp_u / nvt
    if bv is not None:
        on = bv > 0.0
        # an off device sits at ub = -inf: e = de = 0 are the selected
        # values, the continuation's -inf is never selected
        ub = torch.where(on, -(v + bv) / vt, -math.inf)
        exp_b, dexp_b = exp_lim(ub, u_max)
        i = i - torch.where(on, ibv * exp_b, 0.0)
        g = g + torch.where(on, ibv * dexp_b / vt, 0.0)
    cst = i - g * v
    return g, cst


def diode_stamp_vals(i_sat, n_ideal, vp, vm, vt=VT_THERMAL, bv=None,
                     ibv=None):
    """(G-entry values (..., 4*nD), RHS values (..., 2*nD)): rows [P,P,M,M]
    x cols [P,M,P,M] with vals [g,-g,-g,g]; RHS rows [P,M] get
    [-cst,+cst]."""
    g, cst = diode_linearize(i_sat, n_ideal, vp, vm, vt, bv=bv, ibv=ibv)
    gvals = torch.stack([g, -g, -g, g], dim=-1).flatten(-2)
    rhs = torch.stack([-cst, cst], dim=-1).flatten(-2)
    return gvals, rhs
