"""Circuit description produced by the netlist frontend.

This is the host-side IR: plain-data element records in netlist order, a node
table in creation order, and the MOS model registry.  Equation-index
assignment follows the reference rule exactly (src/circuit.cpp:42-61):
non-ground nodes get node equations in creation order, then voltage sources
and inductors get branch-current equations in element order.  Ground nodes
(name "0"/"gnd", case-insensitive) get eq_index -1.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, List, Optional

from ..utils.numbers import is_ground_name

# Waveform kinds
WAVE_NONE = 0
WAVE_PULSE = 1
WAVE_SIN = 2
WAVE_PWL = 3
# extensions (the reference parses SIN only; PULSE/PWL above are already
# extensions).  EXP reuses the PULSE field block as
# [v1, v2, td1, tau1, td2, tau2] -> (v1, v2, ptd, tr, tf, ton); SFFM reuses
# the SIN block as [vo, va, fc, mdi, fs] -> (v0, va, freq, std, phi).
WAVE_EXP = 4
WAVE_SFFM = 5


@dataclasses.dataclass
class Waveform:
    kind: int = WAVE_NONE
    # PULSE (sim.hpp:46-54)
    v1: float = 0.0
    v2: float = 0.0
    ptd: float = 0.0
    tr: float = 0.0
    tf: float = 0.0
    ton: float = 0.0
    per: float = 0.0
    # SIN (sim.hpp:56-62)
    v0: float = 0.0
    va: float = 0.0
    freq: float = 0.0
    std: float = 0.0
    phi: float = 0.0
    # PWL (sim.hpp:64-67)
    pwl_t: List[float] = dataclasses.field(default_factory=list)
    pwl_v: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SourceSpec:
    dc: float = 0.0
    ac_mag: float = 0.0
    ac_phase_deg: float = 0.0
    wave: Waveform = dataclasses.field(default_factory=Waveform)
    # TRNOISE(na nt [alpha namp]) extension: white Gaussian transient
    # noise with RMS amplitude na, sample-and-hold interval nt (0 =
    # redraw every step), plus an optional 1/f^alpha flicker component
    # of total RMS namp (octave-spaced AR(1) bank) — all ADDED to the
    # deterministic waveform (superset of the ngspice form)
    tn_na: float = 0.0
    tn_nt: float = 0.0
    tn_alpha: float = 1.0
    tn_namp: float = 0.0

    def eval_dc(self, scale: float) -> float:
        """Reference sim.hpp:152-158: SIN sources fold the sine's v0 offset
        into the DC value."""
        base = self.dc
        if self.wave.kind == WAVE_SIN:
            base += self.wave.v0
        elif self.wave.kind == WAVE_EXP:
            base += self.wave.v1          # EXP starts at v1 (t <= td1)
        elif self.wave.kind == WAVE_SFFM:
            base += self.wave.v0          # SFFM carrier offset vo
        return base * scale

    def eval_tran(self, t: float) -> float:
        return self.dc + eval_waveform(self.wave, t)


def _clamp01(x: float) -> float:
    if x < 0.0:
        return 0.0
    if x > 1.0:
        return 1.0
    return x


def eval_waveform(w: Waveform, t: float) -> float:
    """Scalar waveform evaluator (sim.hpp:75-143); the vectorized twin
    lives in models/sources.py."""
    if w.kind == WAVE_PULSE:
        if w.per <= 0.0:
            tau = t - w.ptd
            if tau <= 0.0:
                return w.v1
            if tau < w.tr:
                return w.v1 + _clamp01(tau / w.tr) * (w.v2 - w.v1)
            if tau < w.tr + w.ton:
                return w.v2
            tfall = tau - (w.tr + w.ton)
            return w.v2 + _clamp01(tfall / w.tf if w.tf != 0.0 else math.inf) * (w.v1 - w.v2)
        else:
            if t < w.ptd:
                return w.v1
            tau = math.fmod(t - w.ptd, w.per)
            if tau < 0.0:
                tau += w.per
            if tau < w.tr:
                return w.v1 + (w.v2 - w.v1) * _clamp01(tau / w.tr)
            if tau < w.tr + w.ton:
                return w.v2
            if tau < w.tr + w.ton + w.tf:
                tfall = tau - (w.tr + w.ton)
                return w.v2 + (w.v1 - w.v2) * _clamp01(tfall / w.tf if w.tf != 0.0 else math.inf)
            return w.v1
    if w.kind == WAVE_SIN:
        if t < w.std:
            return w.v0
        tau = t - w.std
        return w.v0 + w.va * math.sin(2.0 * math.pi * w.freq * tau + w.phi)
    if w.kind == WAVE_PWL:
        tt, vv = w.pwl_t, w.pwl_v
        if not tt:
            return 0.0
        if t <= tt[0]:
            return vv[0]
        if t >= tt[-1]:
            return vv[-1]
        for i in range(len(tt) - 1):
            if tt[i] < t <= tt[i + 1]:
                k = (t - tt[i]) / (tt[i + 1] - tt[i])
                return vv[i] + (vv[i + 1] - vv[i]) * k
        return vv[-1]
    if w.kind == WAVE_EXP:
        # EXP(v1 v2 td1 tau1 td2 tau2), standard SPICE semantics: rise
        # exponential from td1, decay exponential superposed from td2
        v1, v2, td1, tau1, td2, tau2 = w.v1, w.v2, w.ptd, w.tr, w.tf, w.ton
        out = v1
        if t > td1 and tau1 > 0.0:
            out += (v2 - v1) * (1.0 - math.exp(-(t - td1) / tau1))
        elif t > td1:
            out += v2 - v1
        if t > td2 and tau2 > 0.0:
            out += (v1 - v2) * (1.0 - math.exp(-(t - td2) / tau2))
        elif t > td2:
            out += v1 - v2
        return out
    if w.kind == WAVE_SFFM:
        # SFFM(vo va fc mdi fs): single-frequency FM
        vo, va, fc, mdi, fs = w.v0, w.va, w.freq, w.std, w.phi
        return vo + va * math.sin(2.0 * math.pi * fc * t
                                  + mdi * math.sin(2.0 * math.pi * fs * t))
    return 0.0


@dataclasses.dataclass
class MosModel:
    name: str
    is_p: bool = False
    vt: float = 0.7
    mu: float = 1e-3
    cox: float = 1e-3
    lam: float = 0.0
    cj0: float = 0.0
    # flicker-noise coefficients (extension; used by analysis/noise.py only)
    kf: float = 0.0
    af: float = 1.0
    # body effect (extension, default off): GAMMA/PHI with bulk at the
    # reference-forced ground
    gamma: float = 0.0
    phi: float = 0.6


@dataclasses.dataclass
class JfetModel:
    """JFET model card (extension): `.MODEL id NJF|PJF VTO= BETA= LAMBDA=`.
    Shichman-Hodges: the square law is the MOSFET level-1 equation with
    K = 2*BETA and a (typically negative) signed VTO — the engine reuses
    the vectorized MOS linearization (models/mosfet.py) directly."""
    name: str
    is_p: bool = False
    vto: float = -2.0
    beta: float = 1e-4
    lam: float = 0.0


@dataclasses.dataclass
class SwModel:
    """Switch model card (extension): `.MODEL id SW|CSW RON= ROFF= VT=|IT=
    VH=|IH=`; the reference has no switch devices."""
    name: str
    ron: float = 1.0
    roff: float = 1e12
    vt: float = 0.0       # threshold (volts for SW, amps for CSW)
    vh: float = 0.0       # transition half-width (no hysteresis state)


@dataclasses.dataclass
class BjtModel:
    """Ebers-Moll BJT model card (extension: `.MODEL id NPN|PNP IS=.. BF=..
    BR=..`); the reference has no BJT."""
    name: str
    is_pnp: bool = False
    i_sat: float = 1e-16
    bf: float = 100.0
    br: float = 1.0
    vaf: float = 0.0      # Early voltage (extension); 0 = off
    cje: float = 0.0      # B-E junction capacitance (extension); 0 = off
    cjc: float = 0.0      # B-C junction capacitance (extension); 0 = off
    eg: float = 0.0       # IS(T) activation energy, eV (extension); 0 = off
    xti: float = 0.0      # IS(T) temperature exponent (extension)


# Element kinds
KIND_R = "R"
KIND_C = "C"
KIND_L = "L"
KIND_V = "V"
KIND_I = "I"
KIND_M = "M"
KIND_D = "D"  # diode: extension beyond the reference's device set
KIND_Q = "Q"  # BJT: extension beyond the reference's device set
# linear controlled sources (extensions; absent from the reference):
KIND_E = "E"  # VCVS: E np nm ncp ncm gain     (branch-current unknown)
KIND_G = "G"  # VCCS: G np nm ncp ncm gm
KIND_F = "F"  # CCCS: F np nm Vctrl gain
KIND_H = "H"  # CCVS: H np nm Vctrl r          (branch-current unknown)
KIND_K = "K"  # mutual inductance: K L1 L2 k   (no nodes, no unknowns)
KIND_S = "S"  # V-controlled switch: S np nm ncp ncm model [ON|OFF]
KIND_W = "W"  # I-controlled switch: W np nm Vctrl model [ON|OFF]
KIND_J = "J"  # JFET: J nd ng ns model (Shichman-Hodges square law)
KIND_T = "T"  # lossless transmission line: T p1 n1 p2 n2 Z0= TD=|F= NL=
KIND_B = "B"  # behavioral source: B np nm V=expr | I=expr


@dataclasses.dataclass
class ElementRec:
    kind: str
    name: str
    node_ids: List[int]
    value: float = 0.0                  # R / C / L value
    spec: Optional[SourceSpec] = None   # V / I sources
    # MOSFET parameters, resolved at netlist-build time (circuit.cpp:144)
    is_p: bool = False
    vth: float = 0.0
    k: float = 0.0
    lam: float = 0.0
    cj0: float = 0.0
    kf: float = 0.0
    af: float = 1.0
    gamma: float = 0.0
    phi: float = 0.6
    # total gate-oxide capacitance COX*W*L (extension; the charge-based
    # cap model needs it — K alone only fixes COX*W/L)
    coxwl: float = 0.0
    # Diode parameters
    i_sat: float = 0.0
    n_ideal: float = 1.0
    # reverse breakdown (extension): BV=0 means off; IBV = |I| at -BV
    d_bv: float = 0.0
    d_ibv: float = 1e-3
    # IS(T) scaling (extension, diode + BJT; 0 = off): IS(T) = IS *
    # (T/Tnom)^(xti/n) * exp(eg/(n) * (1/vt_nom - 1/vt))
    eg: float = 0.0
    xti: float = 0.0
    # BJT parameters (kind Q; node_ids = [C, B, E])
    bf: float = 0.0
    br: float = 0.0
    vaf: float = 0.0
    cje: float = 0.0
    cjc: float = 0.0
    # controlled sources: gain/gm/r in `value`; F/H controlling V source
    ctrl_name: str = ""
    # mutual inductance (kind K): the two coupled inductors by name,
    # ctrl_name = L1 and ctrl2_name = L2; coupling coefficient in `value`
    ctrl2_name: str = ""
    # switches (kinds S/W): resolved model parameters
    ron: float = 1.0
    roff: float = 1e12
    s_vt: float = 0.0
    s_vh: float = 0.0
    # transmission line (kind T): impedance/delay + second branch unknown
    z0: float = 50.0
    td: float = 0.0
    branch_eq2: int = -1
    # behavioral source (kind B): the raw expression text; b_is_v selects
    # the V=expr (branch unknown) vs I=expr form
    b_expr: str = ""
    b_is_v: bool = True
    branch_eq: int = -1                 # V / L / E / H branch-current eq
    # resistor temperature coefficients (extension):
    # R(T) = value * (1 + tc1*(T-27) + tc2*(T-27)^2)
    tc1: float = 0.0
    tc2: float = 0.0
    # Monte-Carlo tolerances (extension, R/C/L): relative sigmas applied
    # as value * exp(dev*N_device + lot*N_lane) by parallel/montecarlo.py
    dev_tol: float = 0.0
    lot_tol: float = 0.0
    # C/L `IC=` initial conditions (extension, honored under .TRAN UIC:
    # cap voltage / inductor current at t=0 — api._initial_conditions_x0)
    ic: float = 0.0
    has_ic: bool = False


@dataclasses.dataclass
class Node:
    id: int
    name: str
    eq_index: int = -1


class Circuit:
    def __init__(self):
        self.nodes: List[Node] = []
        self.node_name_to_id: Dict[str, int] = {}
        self.elements: List[ElementRec] = []
        self.mos_models: Dict[str, MosModel] = {}
        self.bjt_models: Dict[str, BjtModel] = {}
        self.sw_models: Dict[str, SwModel] = {}
        self.jfet_models: Dict[str, JfetModel] = {}
        # resolved .PARAM bindings (filled by the parser); behavioral B
        # expressions resolve bare names against this at lowering
        self.param_values: Dict[str, float] = {}

    # --- node table -------------------------------------------------------
    def get_or_create_node(self, name: str) -> int:
        nid = self.node_name_to_id.get(name)
        if nid is not None:
            return nid
        nid = len(self.nodes)
        self.nodes.append(Node(id=nid, name=name))
        self.node_name_to_id[name] = nid
        return nid

    def num_node_equations(self) -> int:
        return sum(1 for n in self.nodes if not is_ground_name(n.name))

    def num_voltage_branches(self) -> int:
        return sum(1 for e in self.elements
                   if e.kind in (KIND_V, KIND_L, KIND_E, KIND_H)
                   or (e.kind == KIND_B and e.b_is_v)) \
            + 2 * sum(1 for e in self.elements if e.kind == KIND_T)

    def num_unknowns(self) -> int:
        return self.num_node_equations() + self.num_voltage_branches()

    def assign_equation_indices(self) -> None:
        eq = 0
        for n in self.nodes:
            if is_ground_name(n.name):
                n.eq_index = -1
            else:
                n.eq_index = eq
                eq += 1
        for e in self.elements:
            if (e.kind in (KIND_V, KIND_L, KIND_E, KIND_H)
                    or (e.kind == KIND_B and e.b_is_v)):
                e.branch_eq = eq
                eq += 1
            elif e.kind == KIND_T:
                e.branch_eq = eq       # port-1 current
                e.branch_eq2 = eq + 1  # port-2 current
                eq += 2

    # --- element factories ------------------------------------------------
    def add_resistor(self, name, n1, n2, value, tc1=0.0, tc2=0.0,
                     dev_tol=0.0, lot_tol=0.0):
        ids = [self.get_or_create_node(n1), self.get_or_create_node(n2)]
        self.elements.append(ElementRec(KIND_R, name, ids, value=value,
                                        tc1=tc1, tc2=tc2,
                                        dev_tol=dev_tol, lot_tol=lot_tol))

    def add_capacitor(self, name, n1, n2, value, dev_tol=0.0, lot_tol=0.0,
                      ic=None):
        ids = [self.get_or_create_node(n1), self.get_or_create_node(n2)]
        self.elements.append(ElementRec(KIND_C, name, ids, value=value,
                                        dev_tol=dev_tol, lot_tol=lot_tol,
                                        ic=ic or 0.0, has_ic=ic is not None))

    def add_inductor(self, name, n1, n2, value, dev_tol=0.0, lot_tol=0.0,
                     ic=None):
        ids = [self.get_or_create_node(n1), self.get_or_create_node(n2)]
        self.elements.append(ElementRec(KIND_L, name, ids, value=value,
                                        dev_tol=dev_tol, lot_tol=lot_tol,
                                        ic=ic or 0.0, has_ic=ic is not None))

    def add_current_source(self, name, np_, nm, spec):
        ids = [self.get_or_create_node(np_), self.get_or_create_node(nm)]
        self.elements.append(ElementRec(KIND_I, name, ids, spec=spec))

    def add_voltage_source(self, name, np_, nm, spec):
        ids = [self.get_or_create_node(np_), self.get_or_create_node(nm)]
        self.elements.append(ElementRec(KIND_V, name, ids, spec=spec))

    def add_mosfet(self, name, nd, ng, ns, model_id, w, l,
                   dev_tol=0.0, lot_tol=0.0, m_mult=1.0):
        """Mirrors src/circuit.cpp:128-168: the model must exist *before* any
        node is created, bulk is forced to node "0", and K = MU*COX*(W/L) is
        resolved immediately.  DEV/LOT (extension): per-instance VT
        mismatch tolerances for netlist Monte-Carlo."""
        m = self.mos_models.get(model_id)
        if m is None:
            print(f"Unknown MOS model: {model_id}", file=sys.stderr)
            return
        ids = [
            self.get_or_create_node(nd),
            self.get_or_create_node(ng),
            self.get_or_create_node(ns),
            self.get_or_create_node("0"),
        ]
        # M= parallel multiplicity (extension): K and the junction cap
        # scale with the number of parallel devices
        self.elements.append(ElementRec(
            KIND_M, name, ids,
            is_p=m.is_p, vth=abs(m.vt), k=m.mu * m.cox * (w / l) * m_mult,
            lam=m.lam, cj0=m.cj0 * m_mult, kf=m.kf, af=m.af,
            gamma=m.gamma, phi=m.phi,
            coxwl=m.cox * w * l * m_mult,
            dev_tol=dev_tol, lot_tol=lot_tol,
        ))

    def add_vcvs(self, name, np_, nm, ncp, ncm, gain):
        ids = [self.get_or_create_node(n) for n in (np_, nm, ncp, ncm)]
        self.elements.append(ElementRec(KIND_E, name, ids, value=gain))

    def add_vccs(self, name, np_, nm, ncp, ncm, gm):
        ids = [self.get_or_create_node(n) for n in (np_, nm, ncp, ncm)]
        self.elements.append(ElementRec(KIND_G, name, ids, value=gm))

    def add_cccs(self, name, np_, nm, ctrl, gain):
        ids = [self.get_or_create_node(np_), self.get_or_create_node(nm)]
        self.elements.append(ElementRec(KIND_F, name, ids, value=gain,
                                        ctrl_name=ctrl))

    def add_ccvs(self, name, np_, nm, ctrl, r):
        ids = [self.get_or_create_node(np_), self.get_or_create_node(nm)]
        self.elements.append(ElementRec(KIND_H, name, ids, value=r,
                                        ctrl_name=ctrl))

    def add_jfet_model(self, m: JfetModel) -> None:
        self.jfet_models[m.name] = m

    def add_jfet(self, name, nd, ng, ns, model_id,
                 dev_tol=0.0, lot_tol=0.0, m_mult=1.0):
        """J nd ng ns model (extension): signed VTO kept in `vth`,
        BETA in `k`, LAMBDA in `lam` (MOS field reuse).  DEV/LOT: VTO
        mismatch tolerances for netlist Monte-Carlo.  M: parallel
        multiplicity (BETA scales)."""
        m = self.jfet_models.get(model_id)
        if m is None:
            print(f"Unknown JFET model: {model_id}", file=sys.stderr)
            return
        ids = [self.get_or_create_node(n) for n in (nd, ng, ns)]
        self.elements.append(ElementRec(
            KIND_J, name, ids, is_p=m.is_p, vth=m.vto,
            k=m.beta * m_mult, lam=m.lam,
            dev_tol=dev_tol, lot_tol=lot_tol))

    def add_bsource(self, name, np_, nm, is_v, expr):
        """B np nm V=expr | I=expr (extension): behavioral source (parsed
        here; lowering refuses it, B sources are not simulated yet)."""
        ids = [self.get_or_create_node(np_), self.get_or_create_node(nm)]
        self.elements.append(ElementRec(KIND_B, name, ids,
                                        b_expr=expr, b_is_v=is_v))

    def add_tline(self, name, p1, n1, p2, n2, z0, td):
        """T p1 n1 p2 n2 Z0= TD= (extension): ideal lossless line, two
        branch-current unknowns (one per port)."""
        ids = [self.get_or_create_node(n) for n in (p1, n1, p2, n2)]
        self.elements.append(ElementRec(KIND_T, name, ids, z0=z0, td=td))

    def add_sw_model(self, m: SwModel) -> None:
        self.sw_models[m.name] = m

    def add_switch(self, name, np_, nm, ncp, ncm, model_id):
        """S np nm ncp ncm model (extension): V-controlled switch; model
        resolved at build time like the MOSFET's (circuit.cpp:128-168)."""
        m = self.sw_models.get(model_id)
        if m is None:
            print(f"Unknown switch model: {model_id}", file=sys.stderr)
            return
        ids = [self.get_or_create_node(n) for n in (np_, nm, ncp, ncm)]
        self.elements.append(ElementRec(
            KIND_S, name, ids, ron=m.ron, roff=m.roff,
            s_vt=m.vt, s_vh=m.vh))

    def add_wswitch(self, name, np_, nm, ctrl, model_id):
        """W np nm Vctrl model (extension): switch controlled by the branch
        current of a V source."""
        m = self.sw_models.get(model_id)
        if m is None:
            print(f"Unknown switch model: {model_id}", file=sys.stderr)
            return
        ids = [self.get_or_create_node(np_), self.get_or_create_node(nm)]
        self.elements.append(ElementRec(
            KIND_W, name, ids, ctrl_name=ctrl, ron=m.ron, roff=m.roff,
            s_vt=m.vt, s_vh=m.vh))

    def add_mutual(self, name, l1, l2, k):
        """K L1 L2 k (extension): mutual inductance M = k*sqrt(L1*L2)
        between two inductors; contributes no nodes and no unknowns."""
        self.elements.append(ElementRec(KIND_K, name, [], value=k,
                                        ctrl_name=l1, ctrl2_name=l2))

    def add_diode(self, name, np_, nm, i_sat, n_ideal, cj0=0.0,
                  bv=0.0, ibv=1e-3, eg=0.0, xti=0.0,
                  dev_tol=0.0, lot_tol=0.0):
        """CJO (extension): a constant junction capacitance across the
        diode, lumped into the cap-like class like the MOS junction caps.
        BV/IBV (extension): reverse breakdown; BV=0 disables it.
        DEV/LOT: IS mismatch tolerances for netlist Monte-Carlo."""
        ids = [self.get_or_create_node(np_), self.get_or_create_node(nm)]
        self.elements.append(ElementRec(KIND_D, name, ids, i_sat=i_sat,
                                        n_ideal=n_ideal, cj0=cj0,
                                        d_bv=bv, d_ibv=ibv,
                                        eg=eg, xti=xti,
                                        dev_tol=dev_tol, lot_tol=lot_tol))

    def add_bjt(self, name, nc, nb, ne, model_id,
                dev_tol=0.0, lot_tol=0.0, m_mult=1.0):
        """DEV/LOT (extension): BF mismatch tolerances for Monte-Carlo.
        M: parallel multiplicity (IS and junction caps scale)."""
        m = self.bjt_models.get(model_id)
        if m is None:
            print(f"Unknown BJT model: {model_id}", file=sys.stderr)
            return
        ids = [self.get_or_create_node(nc), self.get_or_create_node(nb),
               self.get_or_create_node(ne)]
        self.elements.append(ElementRec(
            KIND_Q, name, ids, is_p=m.is_pnp, i_sat=m.i_sat * m_mult,
            bf=m.bf, br=m.br, vaf=m.vaf,
            cje=m.cje * m_mult, cjc=m.cjc * m_mult, eg=m.eg, xti=m.xti,
            dev_tol=dev_tol, lot_tol=lot_tol))

    def add_mos_model(self, m: MosModel):
        self.mos_models[m.name] = m

    def add_bjt_model(self, m: BjtModel):
        self.bjt_models[m.name] = m

    def has_nonlinear(self) -> bool:
        return any(e.kind in (KIND_M, KIND_D, KIND_Q) for e in self.elements)

    def connectivity_report(self) -> str:
        """Node -> attached elements table (counterpart of the reference's
        Circuit::printConnectivity, circuit.cpp:174-186)."""
        attached = {n.id: [] for n in self.nodes}
        for e in self.elements:
            for nid in e.node_ids:
                if e.name not in attached[nid]:
                    attached[nid].append(e.name)
        lines = ["========== node connectivity =========="]
        for n in self.nodes:
            els = " ".join(attached[n.id])
            lines.append(f"Node {n.name} (id={n.id}, eqIndex={n.eq_index}): {els}")
        return "\n".join(lines)
