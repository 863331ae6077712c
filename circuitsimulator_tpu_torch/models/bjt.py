"""Ebers-Moll BJT Newton linearization, vectorized.

Port of ``circuitsimulator_tpu/models/bjt.py``.  Injection form, NPN (PNP
by the polarity p = -1 applied to all terminal voltages and currents):

    If  = Is (e(Vbe/Vt) - 1)        Ir = Is (e(Vbc/Vt) - 1)
    Ic  = If - Ir - Ir/br           Ib = If/bf + Ir/br
    Ie  = -(Ic + Ib)

with the diode model's limited exponential.  Each device contributes two
KCL row patterns, (e_C - e_E) Ic + (e_B - e_E) Ib: a rank-2 update of the
MNA matrix, two Woodbury columns per device.
"""

from __future__ import annotations

import torch

from .diode import VT_THERMAL, exp_lim


def bjt_linearize(i_sat, bf, br, p, vc, vb, ve, vt=VT_THERMAL, vaf=None):
    """Linearize (Ic, Ib) around the physical terminal voltages: returns
    ((g_c, g_b, g_e, cst) for Ic, the same for Ib) with
    I ~= g_c*Vc + g_b*Vb + g_e*Ve + cst; p = +1 NPN, -1 PNP.

    vaf (Early voltage; None = structurally absent, 0 = off per device):
    the transport current If - Ir is scaled by kq = 1 - Vbc/VAF, clamped
    at 0.05 for a large forward Vbc; base currents are unscaled."""
    vbe = p * (vb - ve)
    vbc = p * (vb - vc)
    ef, def_ = exp_lim(vbe / vt)
    er, der_ = exp_lim(vbc / vt)
    i_f = i_sat * (ef - 1.0)
    i_r = i_sat * (er - 1.0)
    gf = i_sat * def_ / vt          # dIf/dVbe
    gr = i_sat * der_ / vt          # dIr/dVbc

    if vaf is not None:
        on = vaf > 0.0
        safe_vaf = torch.where(on, vaf, 1.0)
        raw = 1.0 - vbc / safe_vaf
        kq = torch.where(on, torch.clamp_min(raw, 0.05), 1.0)
        dkq = torch.where(on & (raw > 0.05), -1.0 / safe_vaf, 0.0)
    else:
        kq = 1.0
        dkq = 0.0

    ict = (i_f - i_r) * kq
    ic_eff = ict - i_r / br
    ib_eff = i_f / bf + i_r / br

    dic_dvbe = gf * kq
    dic_dvbc = -gr * kq + (i_f - i_r) * dkq - gr / br
    dib_dvbe = gf / bf
    dib_dvbc = gr / br

    # chain rule to the physical nodes; p^2 == 1 cancels as with the MOSFET
    def phys(di_dvbe, di_dvbc):
        return -di_dvbc, di_dvbe + di_dvbc, -di_dvbe     # g_c, g_b, g_e

    ic = p * ic_eff
    ib = p * ib_eff
    gc_c, gc_b, gc_e = phys(dic_dvbe, dic_dvbc)
    gb_c, gb_b, gb_e = phys(dib_dvbe, dib_dvbc)
    cst_c = ic - gc_c * vc - gc_b * vb - gc_e * ve
    cst_b = ib - gb_c * vc - gb_b * vb - gb_e * ve
    return (gc_c, gc_b, gc_e, cst_c), (gb_c, gb_b, gb_e, cst_b)


def bjt_stamp_vals(i_sat, bf, br, p, vc, vb, ve, vt=VT_THERMAL, vaf=None):
    """(G-entry values (..., 9*nQ), RHS values (..., 3*nQ)): rows
    [C,C,C, B,B,B, E,E,E] x cols [C,B,E] x 3, the E row carrying the
    -(Ic + Ib) gradients; RHS rows [C, B, E] get
    [-cst_c, -cst_b, cst_c + cst_b]."""
    (gcc, gcb, gce, cc), (gbc, gbb, gbe, cb) = bjt_linearize(
        i_sat, bf, br, p, vc, vb, ve, vt, vaf=vaf)
    gvals = torch.stack([gcc, gcb, gce, gbc, gbb, gbe,
                         -(gcc + gbc), -(gcb + gbb), -(gce + gbe)],
                        dim=-1).flatten(-2)
    rhs = torch.stack([-cc, -cb, cc + cb], dim=-1).flatten(-2)
    return gvals, rhs
