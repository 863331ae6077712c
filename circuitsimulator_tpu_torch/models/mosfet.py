"""Level-1 (square-law) MOSFET Newton linearization, vectorized.

Port of ``circuitsimulator_tpu/models/mosfet.py`` with the reference's
quirks kept bug-for-bug (src/element.cpp:181-307): PMOS as an effective
NMOS with p = -1; "on" iff Vgs_eff > Vth and Vds_eff >= 0 (no reverse
region unless ``reverse_region``); off-state leak ``off_gds``; CLM factor
max(1 + lambda*Vds_eff, 0) with dIds/dVgs omitting the lambda term.
``gamma``/``phi`` add the body effect with the bulk at ground.
"""

from __future__ import annotations

import torch


def mos_linearize(vth, k, lam, p, vd, vg, vs, off_gds=1e-12,
                  reverse_region=False, gamma=None, phi=None):
    """Linearize Ids(Vd, Vg, Vs): returns (gd, gg, gs, cst) with
    Ids ~= gd*Vd + gg*Vg + gs*Vs + cst; every argument is (..., nM)."""
    if reverse_region:
        swap = p * (vd - vs) < 0.0
        vd2 = torch.where(swap, vs, vd)
        vs2 = torch.where(swap, vd, vs)
        gd2, gg2, gs2, cst2 = mos_linearize(vth, k, lam, p, vd2, vg, vs2,
                                            off_gds, gamma=gamma, phi=phi)
        gd = torch.where(swap, -gs2, gd2)
        gg = torch.where(swap, -gg2, gg2)
        gs = torch.where(swap, -gd2, gs2)
        cst = torch.where(swap, -cst2, cst2)
        return gd, gg, gs, cst
    vgs_eff = p * (vg - vs)
    vds_eff = p * (vd - vs)

    if gamma is not None:
        vsb_eff = torch.clamp_min(p * vs, 0.0)
        phi_s = torch.clamp_min(phi, 1e-12)
        root = torch.sqrt(phi_s + vsb_eff)
        vth_eff = vth + gamma * (root - torch.sqrt(phi_s))
        dvth_dvsb = torch.where((gamma != 0.0) & (p * vs > 0.0),
                                gamma / (2.0 * root), 0.0)
    else:
        vth_eff = vth
        dvth_dvsb = 0.0

    on = (vgs_eff > vth_eff) & (vds_eff >= 0.0)
    vov = vgs_eff - vth_eff
    triode = vds_eff < vov

    ids0 = torch.where(
        on,
        torch.where(triode,
                    k * (vov * vds_eff - 0.5 * vds_eff * vds_eff),
                    0.5 * k * vov * vov),
        0.0)
    gds0 = torch.where(on, torch.where(triode, k * (vov - vds_eff), 0.0),
                       off_gds)
    gm0 = torch.where(on, torch.where(triode, k * vds_eff, k * vov), 0.0)

    factor = torch.clamp_min(1.0 + lam * vds_eff, 0.0)
    ids_eff = ids0 * factor
    d_vds = gds0 * factor + ids0 * lam
    d_vgs = gm0 * factor
    d_vsb = -gm0 * dvth_dvsb * factor

    ids = p * ids_eff
    gd = d_vds
    gg = d_vgs
    gs = -(d_vds + d_vgs) + d_vsb
    cst = ids - gd * vd - gg * vg - gs * vs
    return gd, gg, gs, cst


def mos_stamp_vals(vth, k, lam, p, vd, vg, vs, off_gds=1e-12,
                   reverse_region=False, gamma=None, phi=None):
    """(G-entry values (..., 6*nM), RHS values (..., 2*nM)): rows
    [D,D,D,S,S,S] x cols [D,G,S,D,G,S]; RHS rows [D,S]."""
    gd, gg, gs, cst = mos_linearize(vth, k, lam, p, vd, vg, vs, off_gds,
                                    reverse_region, gamma=gamma, phi=phi)
    gvals = torch.stack([gd, gg, gs, -gd, -gg, -gs], dim=-1).flatten(-2)
    rhs = torch.stack([-cst, cst], dim=-1).flatten(-2)
    return gvals, rhs
