"""Charge-conserving MOS capacitance model (``.OPTIONS MOSCAP=CHARGE``).

Port of ``circuitsimulator_tpu/models/moscap.py``.  Under this model the
fixed lumped MOS caps are replaced by terminal charges: the transient
integrates i_t = dq_t/dt, so charge is conserved over any closed bias loop.

Gate: strong-inversion sheet charge with the Ward-Dutton partition (with
vgt = vgs_eff - vth, d = vds_eff, D = vgt d - d^2/2, Cox = COXWL):

  triode (0 <= d < vgt):  q_G = Cox (vgt^3 - (vgt - d)^3) / (3 D)
                          q_D = -Cox (vgt^3 d^2/2 - 5 vgt^2 d^3/6
                                      + vgt d^4/2 - d^5/10) / D^2
  saturation (d >= vgt > 0): q_G = 2/3 Cox vgt, q_D = -4/15 Cox vgt
  cutoff (vgt <= 0): zero;  q_S = -(q_G + q_D) always.

PMOS mirrors through p = -1 (q_phys = p q_eff); vds_eff < 0 swaps the drain
and source roles.  Junctions: the SPICE depletion charge of the S-B and D-B
junctions (bulk grounded), PB = 0.8, MJ = 0.5, FC = 0.5, linearised beyond
FC PB.

Every consumer differentiates the same charge functions.  The JAX file takes
three ``jax.jvp`` passes; here ``charge_jacobian`` runs the same functions
once on ``Dual`` numbers (a value and its three tangents d/d(vd, vg, vs)),
which is those three forward-mode passes side by side.  ``torch.func.jvp``
gives the same derivatives (a test holds the two together), but on this
function it costs about 200 times the function itself: forward AD sends
every operation with a tangent-less operand (a Python constant, a
parameter) through PyTorch's Python decompositions.  The rules follow JAX's
``jvp``: ``where`` selects tangents, and ``maximum``/``minimum`` split the
tangent evenly between the two arguments at an exact tie (so do
``torch.maximum``/``torch.minimum`` under ``torch.func.jvp``).  The CUDA
kernel (``csrc/fused_step.cu``) evaluates the same functions on its own dual
type.
"""

from __future__ import annotations

import torch

# fixed junction-grading constants (the reference card carries CJ0 only)
PB = 0.8
MJ = 0.5
FC = 0.5


class Dual:
    """A value v (...) and its tangents t (..., 3): forward-mode AD over the
    operations the charge functions use."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v, self.t = v, t

    @staticmethod
    def _vt(o):
        """(value, tangent or None) of a Dual, tensor or Python number."""
        return (o.v, o.t) if isinstance(o, Dual) else (o, None)

    @staticmethod
    def _col(a):
        """A value as a column against the tangent axis."""
        return a[..., None] if isinstance(a, torch.Tensor) else a

    def __neg__(self):
        return Dual(-self.v, -self.t)

    def __add__(self, o):
        ov, ot = self._vt(o)
        return Dual(self.v + ov, self.t if ot is None else self.t + ot)

    __radd__ = __add__

    def __sub__(self, o):
        ov, ot = self._vt(o)
        return Dual(self.v - ov, self.t if ot is None else self.t - ot)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.t)

    def __mul__(self, o):
        ov, ot = self._vt(o)
        t = self.t * self._col(ov)
        if ot is not None:
            t = t + self._col(self.v) * ot
        return Dual(self.v * ov, t)

    __rmul__ = __mul__

    def __truediv__(self, o):
        """JAX's rule: d(a/b) = da/b + (-db a) b^-2."""
        ov, ot = self._vt(o)
        t = self.t / self._col(ov)
        if ot is not None:
            t = t + (-ot * self._col(self.v)) * self._col(1.0 / (ov * ov))
        return Dual(self.v / ov, t)

    def __pow__(self, n):
        """Integer powers and the square root (``** 0.5`` is sqrt in
        PyTorch): d(x^n) = n x^(n-1) dx."""
        return Dual(self.v ** n, self.t * self._col(n * self.v ** (n - 1)))


def _val(x):
    return x.v if isinstance(x, Dual) else x


def _where(c, a, b):
    """torch.where on values; tangents selected the same way."""
    av, at = Dual._vt(a)
    bv, bt = Dual._vt(b)
    v = torch.where(c, av, bv)
    if at is None and bt is None:
        return v
    z = torch.zeros_like(at if at is not None else bt)
    return Dual(v, torch.where(c[..., None], z if at is None else at,
                               z if bt is None else bt))


def _pick(a, b, a_wins, plain):
    """maximum/minimum with JAX's tie rule: the winner's tangent, half of
    each at an exact tie.  A NaN in a wins (NaN propagates, as in
    torch.maximum and jnp.maximum).  Plain tensors take ``plain``
    (torch.maximum or torch.minimum), whose forward-mode rule is the same."""
    av, at = Dual._vt(a)
    bv, bt = Dual._vt(b)
    if at is None and bt is None:
        return plain(av, bv if isinstance(bv, torch.Tensor)
                     else torch.full_like(av, bv))
    a_wins = a_wins | torch.isnan(av)
    v = torch.where(a_wins, av, bv)
    z = torch.zeros_like(at if at is not None else bt)
    at = z if at is None else at
    bt = z if bt is None else bt
    tie = (av == bv)[..., None]
    t = torch.where(tie, 0.5 * at + 0.5 * bt,
                    torch.where(a_wins[..., None], at, bt))
    return Dual(v, t)


def _maximum(a, b):
    return _pick(a, b, _val(a) > _val(b), torch.maximum)


def _minimum(a, b):
    return _pick(a, b, _val(a) < _val(b), torch.minimum)


def mos_gate_charges(vd, vg, vs, vth, coxwl, p):
    """Ward-Dutton terminal charges (q_d, q_g, q_s) at the physical (d, g, s)
    terminals; q_d + q_g + q_s = 0.  Arguments broadcast (tensors, or
    ``Dual`` voltages); p = +1 NMOS, -1 PMOS."""
    vgs = p * (vg - vs)
    vds = p * (vd - vs)
    swap = _val(vds) < 0.0
    d_ = _where(swap, -vds, vds)
    vgt = _where(swap, vgs - vds, vgs) - vth        # vgd when swapped
    on = _val(vgt) > 0.0
    vgt = _maximum(vgt, 0.0)
    sat = _val(d_) >= _val(vgt)
    d_t = _minimum(d_, vgt)                         # triode-clamped vds
    # safe denominators (double where: finite values and tangents)
    D = vgt * d_t - 0.5 * d_t * d_t
    D_ok = _val(D) > 0.0
    Ds = _where(D_ok, D, 1.0)
    qg_tri = coxwl * (vgt ** 3 - (vgt - d_t) ** 3) / (3.0 * Ds)
    qd_tri = -coxwl * (0.5 * vgt ** 3 * d_t ** 2
                       - (5.0 / 6.0) * vgt ** 2 * d_t ** 3
                       + 0.5 * vgt * d_t ** 4
                       - 0.1 * d_t ** 5) / (Ds * Ds)
    qg_sat = (2.0 / 3.0) * coxwl * vgt
    qd_sat = -(4.0 / 15.0) * coxwl * vgt
    # D == 0 means d_t == 0 (deep triode limit): qg = Cox vgt, 50/50 split
    qg = _where(D_ok, qg_tri, coxwl * vgt)
    qd = _where(D_ok, qd_tri, -0.5 * coxwl * vgt)
    qg = _where(sat, qg_sat, qg)
    qd = _where(sat, qd_sat, qd)
    qg = _where(on, qg, 0.0)
    qd = _where(on, qd, 0.0)
    qs = -(qg + qd)
    # undo the role swap, then mirror PMOS back to physical charges
    qd_phys = p * _where(swap, qs, qd)
    qs_phys = p * _where(swap, qd, qs)
    return qd_phys, p * qg, qs_phys


def depletion_charge(v, cj0):
    """SPICE depletion charge against the forward junction bias v:
    q'(v) = CJ0 / (1 - v/PB)^MJ up to FC PB, then the linearised capacitance
    CJ0 (F3 + MJ v/PB) / F2 integrated from the breakpoint (C^1)."""
    f1 = PB / (1.0 - MJ) * (1.0 - (1.0 - FC) ** (1.0 - MJ))
    f2 = (1.0 - FC) ** (1.0 + MJ)
    f3 = 1.0 - FC * (1.0 + MJ)
    vb = FC * PB
    v_lo = _minimum(v, vb)
    arg = _maximum(1.0 - v_lo / PB, 1e-6)
    # arg ** 0.5: PyTorch computes it as sqrt (the kernel does the same)
    q_lo = cj0 * PB / (1.0 - MJ) * (1.0 - arg ** (1.0 - MJ))
    dv = _maximum(v - vb, 0.0)
    q_hi = cj0 / f2 * (f3 * dv
                       + 0.5 * (MJ / PB) * ((vb + dv) ** 2 - vb * vb))
    return _where(_val(v) <= vb, q_lo, cj0 * f1 + q_hi)


def mos_junction_charges(vs, vd, cj0, p):
    """Depletion charges of the (S, B) and (D, B) junctions as element
    charges q_el(v_node - v_bulk), bulk grounded: dq_el/dv = +C_dep > 0 for
    both polarities."""
    qsb = -p * depletion_charge(-p * vs, cj0)
    qdb = -p * depletion_charge(-p * vd, cj0)
    return qsb, qdb


def mos_all_charges(vd, vg, vs, vth, coxwl, cj0, p):
    """(q_d, q_g, q_s, q_sb, q_db) per device: gate charges inject at
    (d, g, s), junction charges are node-to-ground elements at s and d."""
    qd, qg, qs = mos_gate_charges(vd, vg, vs, vth, coxwl, p)
    qsb, qdb = mos_junction_charges(vs, vd, cj0, p)
    return qd, qg, qs, qsb, qdb


def charges_of_x(vdgs, params):
    """Charges (..., nM, 5) in the order (q_d, q_g, q_s, q_sb, q_db) from the
    terminal voltages vdgs (..., nM, 3) ordered (vd, vg, vs)."""
    q = mos_all_charges(vdgs[..., 0], vdgs[..., 1], vdgs[..., 2],
                        params["mos_vth"], params["mos_coxwl"],
                        params["mos_cj0"], params["mos_p"])
    return torch.stack(q, dim=-1)


def charge_jacobian(vdgs, params):
    """(q, dq/dv): charges (..., nM, 5) and their exact Jacobian
    (..., nM, 5, 3) with respect to (vd, vg, vs), forward mode."""
    eye = torch.eye(3, dtype=vdgs.dtype, device=vdgs.device)
    v = [Dual(vdgs[..., j], eye[j].expand(vdgs.shape)) for j in range(3)]
    q = mos_all_charges(*v, params["mos_vth"], params["mos_coxwl"],
                        params["mos_cj0"], params["mos_p"])
    return (torch.stack([a.v for a in q], dim=-1),
            torch.stack([a.t for a in q], dim=-2))
