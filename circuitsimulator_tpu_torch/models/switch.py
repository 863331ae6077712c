"""Voltage/current-controlled switches (S / W elements), vectorized.

Port of ``circuitsimulator_tpu/models/switch.py``.  Smooth-transition
switch: the conductance interpolates log-linearly (cubic smoothstep)
between 1/ROFF and 1/RON over the control window [VT-VH, VT+VH]; VH == 0
is an ideal step (zero derivative).  No hysteresis state is kept.  The W
element is the same device controlled by a V source's branch current: the
lowering maps its control pair to (branch_eq, dump).

Stamp (control vc = V(cp) - V(cm), vd = V(p) - V(m)):
    i = G(vc) vd,  gd = G(vc),  gc = G'(vc) vd,  cst = i0 - gd vd0 - gc vc0
    rows [p,p,m,m,p,p,m,m] x cols [p,m,p,m,cp,cm,cp,cm]
    vals [gd,-gd,-gd,gd, gc,-gc,-gc,gc];  RHS rows [p,m] get [-cst,+cst]
"""

from __future__ import annotations

import torch


def switch_conductance(ron, roff, vt, vh, vc):
    """G(vc) and dG/dvc (log-smoothstep between 1/roff and 1/ron)."""
    l_on = torch.log(1.0 / ron)
    l_off = torch.log(1.0 / roff)
    has_win = vh > 0.0
    width = torch.where(has_win, 2.0 * vh, 1.0)
    u = torch.clamp((vc - (vt - vh)) / width, 0.0, 1.0)
    u = torch.where(has_win, u, (vc > vt).to(vc.dtype))
    s = u * u * (3.0 - 2.0 * u)
    G = torch.exp(l_off + (l_on - l_off) * s)
    dsdu = 6.0 * u * (1.0 - u)
    dG = torch.where(has_win, G * (l_on - l_off) * dsdu / width, 0.0)
    return G, dG


def switch_linearize(ron, roff, vt, vh, vp, vm, vcp, vcm):
    """(gd, gc, cst): i ~= gd*(Vp-Vm) + gc*(Vcp-Vcm) + cst."""
    vd = vp - vm
    vc = vcp - vcm
    G, dG = switch_conductance(ron, roff, vt, vh, vc)
    gc = dG * vd
    cst = G * vd - G * vd - gc * vc     # == -gc*vc: i is exactly G*vd
    return G, gc, cst


def switch_stamp_vals(ron, roff, vt, vh, vp, vm, vcp, vcm):
    """(G-entry values (..., 8*nS), RHS values (..., 2*nS)) in the pattern
    order of the module docstring."""
    gd, gc, cst = switch_linearize(ron, roff, vt, vh, vp, vm, vcp, vcm)
    gvals = torch.stack([gd, -gd, -gd, gd, gc, -gc, -gc, gc],
                        dim=-1).flatten(-2)
    rhs = torch.stack([-cst, cst], dim=-1).flatten(-2)
    return gvals, rhs
