"""Lowering: parsed Circuit -> numpy index topology + torch parameter dict.

Port of ``circuitsimulator_tpu/ir/lower.py``.  Equation indices follow the
reference ordering (non-ground nodes in creation order, then V-source and
inductor branch currents in element order) and ground maps to the dump slot
N of an (N+1)-sized system, so no stamp needs a branch.  The topology is
numpy (static structure); every parameter leaf is a torch tensor on
``device`` — the part that Monte-Carlo lanes perturb.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..netlist import (
    Circuit, KIND_R, KIND_C, KIND_L, KIND_V, KIND_I, KIND_M, KIND_D, KIND_Q,
    KIND_E, KIND_G, KIND_F, KIND_H, KIND_K, KIND_S, KIND_W, KIND_J, KIND_T,
    KIND_B, is_ground_name,
)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static circuit structure; numpy arrays only."""
    n_unknowns: int
    n_node_eq: int
    n_nodes: int
    n_elements: int
    has_nonlinear: bool
    # eq-index arrays per device class; ground mapped to dump slot N
    node_eqs: np.ndarray
    res_e1: np.ndarray
    res_e2: np.ndarray
    cap_e1: np.ndarray
    cap_e2: np.ndarray
    ind_ep: np.ndarray
    ind_em: np.ndarray
    ind_k: np.ndarray
    vs_ep: np.ndarray
    vs_em: np.ndarray
    vs_k: np.ndarray
    is_ep: np.ndarray
    is_em: np.ndarray
    mos_ed: np.ndarray
    mos_eg: np.ndarray
    mos_es: np.ndarray
    mos_eb: np.ndarray
    dio_ep: np.ndarray
    dio_em: np.ndarray
    bjt_ec: np.ndarray
    bjt_eb: np.ndarray
    bjt_ee: np.ndarray
    vcvs_ep: np.ndarray
    vcvs_em: np.ndarray
    vcvs_ecp: np.ndarray
    vcvs_ecm: np.ndarray
    vcvs_k: np.ndarray
    vccs_ep: np.ndarray
    vccs_em: np.ndarray
    vccs_ecp: np.ndarray
    vccs_ecm: np.ndarray
    cccs_ep: np.ndarray
    cccs_em: np.ndarray
    cccs_kc: np.ndarray
    ccvs_ep: np.ndarray
    ccvs_em: np.ndarray
    ccvs_kc: np.ndarray
    ccvs_k: np.ndarray
    mut_a: np.ndarray
    mut_b: np.ndarray
    sw_ep: np.ndarray
    sw_em: np.ndarray
    sw_ecp: np.ndarray
    sw_ecm: np.ndarray
    jf_ed: np.ndarray
    jf_eg: np.ndarray
    jf_es: np.ndarray
    tl_ep1: np.ndarray
    tl_em1: np.ndarray
    tl_ep2: np.ndarray
    tl_em2: np.ndarray
    tl_k1: np.ndarray
    tl_k2: np.ndarray
    tl_td_s: Tuple[float, ...]
    # output metadata
    volt_col_eqs: np.ndarray
    volt_col_names: Tuple[str, ...]
    branch_col_eqs: np.ndarray
    branch_col_names: Tuple[str, ...]
    node_table: Tuple[Tuple[str, int], ...]
    branch_table: Tuple[Tuple[str, str, str, str, int], ...]

    @property
    def counts(self):
        return dict(
            R=len(self.res_e1), C=len(self.cap_e1), L=len(self.ind_ep),
            V=len(self.vs_ep), I=len(self.is_ep), M=len(self.mos_ed),
            D=len(self.dio_ep), Q=len(self.bjt_ec),
            E=len(self.vcvs_ep), G=len(self.vccs_ep),
            F=len(self.cccs_ep), H=len(self.ccvs_ep),
            K=len(self.mut_a), S=len(self.sw_ep), J=len(self.jf_ed),
            T=len(self.tl_k1),
        )


@dataclasses.dataclass
class BSourceInfo:
    """One lowered behavioral source.  ``tape`` is its compiled expression
    (``utils/expr.compile_tape``) over the probe values
    vals[j] = x_ext[pairs[j, 0]] - x_ext[pairs[j, 1]]; is_v selects the
    V=expr form (branch row ``k``) over the I=expr form (KCL rows ep/em)."""
    name: str
    tape: Any
    pairs: np.ndarray             # (m, 2) eq-index pairs per probe
    is_v: bool
    ep: int
    em: int
    k: int                        # branch eq (V form), -1 otherwise
    uses_time: bool
    # slice of params["b_consts"] holding the .PARAM values the expression
    # reads (Monte-Carlo lanes may perturb them)
    const_off: int = 0
    n_consts: int = 0


@dataclasses.dataclass
class LoweredCircuit:
    topo: Topology
    params: Dict[str, torch.Tensor]
    circuit: Circuit
    device: torch.device
    b_sources: List[BSourceInfo] = dataclasses.field(default_factory=list)


def _np_i32(xs) -> np.ndarray:
    return np.asarray(xs, dtype=np.int32)


def _eq_of(ckt: Circuit, node_id: int, dump: int) -> int:
    eq = ckt.nodes[node_id].eq_index
    return eq if eq >= 0 else dump


def _pack_sources(specs, dtype, device):
    n = len(specs)
    dc = np.zeros(n)
    kind = np.zeros(n, dtype=np.int32)
    pulse = np.zeros((n, 7))
    sin = np.zeros((n, 5))
    pmax = max([len(s.wave.pwl_t) for s in specs], default=0)
    pmax = max(pmax, 1) if n else 0
    pwl_t = np.zeros((n, pmax))
    pwl_v = np.zeros((n, pmax))
    pwl_n = np.zeros(n, dtype=np.int32)
    ac_mag = np.zeros(n)
    ac_phase = np.zeros(n)
    tn = np.zeros((n, 4))
    for i, s in enumerate(specs):
        w = s.wave
        dc[i] = s.dc
        kind[i] = w.kind
        pulse[i] = [w.v1, w.v2, w.ptd, w.tr, w.tf, w.ton, w.per]
        sin[i] = [w.v0, w.va, w.freq, w.std, w.phi]
        ac_mag[i] = s.ac_mag
        ac_phase[i] = s.ac_phase_deg
        tn[i] = [s.tn_na, s.tn_nt, s.tn_alpha, s.tn_namp]
        m = len(w.pwl_t)
        pwl_n[i] = m
        if m:
            pwl_t[i, :m] = w.pwl_t
            pwl_v[i, :m] = w.pwl_v

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    return {
        "dc": f(dc), "kind": i(kind), "pulse": f(pulse), "sin": f(sin),
        "pwl_t": f(pwl_t), "pwl_v": f(pwl_v), "pwl_n": i(pwl_n),
        "ac_mag": f(ac_mag), "ac_phase": f(ac_phase), "tn": f(tn),
    }


def lower(ckt: Circuit, dtype=torch.float64, device="cpu") -> LoweredCircuit:
    """Lower a parsed Circuit (equation indices assigned on demand)."""
    device = torch.device(device)
    if any(n.eq_index == -1 and not is_ground_name(n.name) for n in ckt.nodes):
        ckt.assign_equation_indices()
    N = ckt.num_unknowns()
    dump = N

    def of(kind):
        return [e for e in ckt.elements if e.kind == kind]

    res, cap, ind = of(KIND_R), of(KIND_C), of(KIND_L)
    vs, isrc, mos = of(KIND_V), of(KIND_I), of(KIND_M)
    dio, bjt, mut = of(KIND_D), of(KIND_Q), of(KIND_K)
    sw = [e for e in ckt.elements if e.kind in (KIND_S, KIND_W)]
    jf, tl, bsrc = of(KIND_J), of(KIND_T), of(KIND_B)
    vcvs, vccs, cccs, ccvs = of(KIND_E), of(KIND_G), of(KIND_F), of(KIND_H)

    def ctrl_branch(e):
        """Branch eq of an F/H/W element's controlling V source."""
        for exact in (True, False):
            for el in ckt.elements:
                if el.kind != KIND_V:
                    continue
                if (el.name == e.ctrl_name) if exact \
                        else (el.name.lower() == e.ctrl_name.lower()):
                    return el.branch_eq
        raise ValueError(f"{e.name}: controlling source {e.ctrl_name!r} "
                         "is not a voltage source in this circuit")

    def eq(nid):
        return _eq_of(ckt, nid, dump)

    def ind_index(kel, lname):
        for exact in (True, False):
            for j, el in enumerate(ind):
                if (el.name == lname) if exact \
                        else (el.name.lower() == lname.lower()):
                    return j
        raise ValueError(f"{kel.name}: coupled inductor {lname!r} "
                         "is not an inductor in this circuit")

    mut_ok = []
    for e in mut:
        try:
            mut_ok.append((ind_index(e, e.ctrl_name),
                           ind_index(e, e.ctrl2_name), e.value))
        except ValueError as err:
            print(f"warning: {err}; K element skipped", file=sys.stderr)

    node_eqs = _np_i32([n.eq_index for n in ckt.nodes if n.eq_index >= 0])
    volt_cols = [(n.name, n.eq_index) for n in ckt.nodes if n.eq_index >= 0]
    branch_cols = []
    branch_table = []
    for e in ckt.elements:
        if (e.kind in (KIND_V, KIND_L, KIND_E, KIND_H)
                or (e.kind == KIND_B and e.b_is_v)):
            branch_cols.append((e.name, e.branch_eq))
            branch_table.append(
                (e.kind, e.name, ckt.nodes[e.node_ids[0]].name,
                 ckt.nodes[e.node_ids[1]].name, e.branch_eq))
        elif e.kind == KIND_T:
            branch_cols.append((f"{e.name}.1", e.branch_eq))
            branch_cols.append((f"{e.name}.2", e.branch_eq2))
            branch_table.append(
                (e.kind, f"{e.name}.1", ckt.nodes[e.node_ids[0]].name,
                 ckt.nodes[e.node_ids[1]].name, e.branch_eq))
            branch_table.append(
                (e.kind, f"{e.name}.2", ckt.nodes[e.node_ids[2]].name,
                 ckt.nodes[e.node_ids[3]].name, e.branch_eq2))

    def eqs(els, i):
        return _np_i32([eq(e.node_ids[i]) for e in els])

    topo = Topology(
        n_unknowns=N,
        n_node_eq=ckt.num_node_equations(),
        n_nodes=len(ckt.nodes),
        n_elements=len(ckt.elements),
        has_nonlinear=bool(mos or dio or bjt or sw or jf or bsrc),
        node_eqs=node_eqs,
        res_e1=eqs(res, 0), res_e2=eqs(res, 1),
        cap_e1=eqs(cap, 0), cap_e2=eqs(cap, 1),
        ind_ep=eqs(ind, 0), ind_em=eqs(ind, 1),
        ind_k=_np_i32([e.branch_eq for e in ind]),
        vs_ep=eqs(vs, 0), vs_em=eqs(vs, 1),
        vs_k=_np_i32([e.branch_eq for e in vs]),
        is_ep=eqs(isrc, 0), is_em=eqs(isrc, 1),
        mos_ed=eqs(mos, 0), mos_eg=eqs(mos, 1),
        mos_es=eqs(mos, 2), mos_eb=eqs(mos, 3),
        dio_ep=eqs(dio, 0), dio_em=eqs(dio, 1),
        bjt_ec=eqs(bjt, 0), bjt_eb=eqs(bjt, 1), bjt_ee=eqs(bjt, 2),
        vcvs_ep=eqs(vcvs, 0), vcvs_em=eqs(vcvs, 1),
        vcvs_ecp=eqs(vcvs, 2), vcvs_ecm=eqs(vcvs, 3),
        vcvs_k=_np_i32([e.branch_eq for e in vcvs]),
        vccs_ep=eqs(vccs, 0), vccs_em=eqs(vccs, 1),
        vccs_ecp=eqs(vccs, 2), vccs_ecm=eqs(vccs, 3),
        cccs_ep=eqs(cccs, 0), cccs_em=eqs(cccs, 1),
        cccs_kc=_np_i32([ctrl_branch(e) for e in cccs]),
        ccvs_ep=eqs(ccvs, 0), ccvs_em=eqs(ccvs, 1),
        ccvs_kc=_np_i32([ctrl_branch(e) for e in ccvs]),
        ccvs_k=_np_i32([e.branch_eq for e in ccvs]),
        mut_a=_np_i32([m[0] for m in mut_ok]),
        mut_b=_np_i32([m[1] for m in mut_ok]),
        sw_ep=eqs(sw, 0), sw_em=eqs(sw, 1),
        sw_ecp=_np_i32([eq(e.node_ids[2]) if e.kind == KIND_S
                        else ctrl_branch(e) for e in sw]),
        sw_ecm=_np_i32([eq(e.node_ids[3]) if e.kind == KIND_S
                        else dump for e in sw]),
        jf_ed=eqs(jf, 0), jf_eg=eqs(jf, 1), jf_es=eqs(jf, 2),
        tl_ep1=eqs(tl, 0), tl_em1=eqs(tl, 1),
        tl_ep2=eqs(tl, 2), tl_em2=eqs(tl, 3),
        tl_k1=_np_i32([e.branch_eq for e in tl]),
        tl_k2=_np_i32([e.branch_eq2 for e in tl]),
        tl_td_s=tuple(float(e.td) for e in tl),
        volt_col_eqs=_np_i32([c[1] for c in volt_cols]),
        volt_col_names=tuple(c[0] for c in volt_cols),
        branch_col_eqs=_np_i32([c[1] for c in branch_cols]),
        branch_col_names=tuple(c[0] for c in branch_cols),
        node_table=tuple((n.name, n.eq_index) for n in ckt.nodes),
        branch_table=tuple(branch_table),
    )

    b_infos, b_consts = _lower_bsources(ckt, bsrc, eq, dump)

    def f(vals):
        return torch.as_tensor(np.asarray(vals, dtype=np.float64),
                               dtype=dtype, device=device)

    def sign(els):
        return f([-1.0 if e.is_p else 1.0 for e in els])

    params = {
        "res_r": f([e.value for e in res]),
        "res_tc1": f([e.tc1 for e in res]),
        "res_tc2": f([e.tc2 for e in res]),
        "temp_delta_c": f(0.0),
        "cap_c": f([e.value for e in cap]),
        "ind_l": f([e.value for e in ind]),
        "mos_vth": f([e.vth for e in mos]),
        "mos_k": f([e.k for e in mos]),
        "mos_lam": f([e.lam for e in mos]),
        "mos_cj0": f([e.cj0 for e in mos]),
        "mos_coxwl": f([e.coxwl for e in mos]),
        "mos_kf": f([e.kf for e in mos]),
        "mos_gamma": f([e.gamma for e in mos]),
        "mos_phi": f([e.phi for e in mos]),
        "mos_af": f([e.af for e in mos]),
        "mos_p": sign(mos),
        "dio_is": f([e.i_sat for e in dio]),
        "dio_cjo": f([e.cj0 for e in dio]),
        "dio_bv": f([e.d_bv for e in dio]),
        "dio_ibv": f([e.d_ibv for e in dio]),
        "dio_eg": f([e.eg for e in dio]),
        "dio_xti": f([e.xti for e in dio]),
        "bjt_eg": f([e.eg for e in bjt]),
        "bjt_xti": f([e.xti for e in bjt]),
        "bjt_cje": f([e.cje for e in bjt]),
        "bjt_cjc": f([e.cjc for e in bjt]),
        "dio_n": f([e.n_ideal for e in dio]),
        "bjt_is": f([e.i_sat for e in bjt]),
        "bjt_bf": f([e.bf for e in bjt]),
        "bjt_br": f([e.br for e in bjt]),
        "bjt_vaf": f([e.vaf for e in bjt]),
        "mut_k": f([m[2] for m in mut_ok]),
        "b_consts": f(b_consts),
        "tl_z0": f([e.z0 for e in tl]),
        "tl_td": f([e.td for e in tl]),
        "jf_vto": f([e.vth for e in jf]),
        "jf_beta": f([e.k for e in jf]),
        "jf_lam": f([e.lam for e in jf]),
        "jf_p": sign(jf),
        "sw_ron": f([e.ron for e in sw]),
        "sw_roff": f([e.roff for e in sw]),
        "sw_vt": f([e.s_vt for e in sw]),
        "sw_vh": f([e.s_vh for e in sw]),
        "vcvs_gain": f([e.value for e in vcvs]),
        "vccs_g": f([e.value for e in vccs]),
        "cccs_gain": f([e.value for e in cccs]),
        "ccvs_r": f([e.value for e in ccvs]),
        # thermal voltage kT/q; matches the diode model's VT_THERMAL
        "vt_thermal": f(0.025852),
        "bjt_p": sign(bjt),
    }
    for key, specs in (("vs", [e.spec for e in vs]),
                       ("is", [e.spec for e in isrc])):
        for name, arr in _pack_sources(specs, dtype, device).items():
            params[f"{key}_{name}"] = arr

    return LoweredCircuit(topo=topo, params=params, circuit=ckt,
                          device=device, b_sources=b_infos)


def _lower_bsources(ckt: Circuit, bsrc, eq, dump):
    """Compile the behavioral sources and resolve their probes: (infos,
    b_consts), b_consts the referenced .PARAM values in (device,
    first-appearance) order."""
    from ..utils.expr import (ExprError, compile_tape, free_names,
                              parse_expr, probe_refs)
    infos, b_consts = [], []
    for e in bsrc:
        try:
            ast = parse_expr(e.b_expr, probes=True)
            refs = probe_refs(ast)
            prefs = [r for r in refs if r[0] != "time"]
            pairs = []
            for r in prefs:
                if r[0] == "v":
                    nid = ckt.node_name_to_id.get(r[1])
                    if nid is None:
                        raise ExprError(f"unknown node {r[1]!r} in v()")
                    bq = dump
                    if r[2] is not None:
                        nid2 = ckt.node_name_to_id.get(r[2])
                        if nid2 is None:
                            raise ExprError(f"unknown node {r[2]!r} in v()")
                        bq = eq(nid2)
                    pairs.append((eq(nid), bq))
                else:
                    keq = -1
                    for exact in (True, False):
                        for el in ckt.elements:
                            if getattr(el, "branch_eq", -1) < 0:
                                continue
                            if (el.name == r[1]) if exact \
                                    else (el.name.lower() == r[1].lower()):
                                keq = el.branch_eq
                                break
                        if keq >= 0:
                            break
                    if keq < 0:
                        raise ExprError(
                            f"i({r[1]}): no branch-current unknown (only "
                            "V/L/E/H/B-V elements carry one)")
                    pairs.append((keq, dump))
            names = free_names(ast)
            pv = {k.lower(): v for k, v in ckt.param_values.items()}
            const_off = len(b_consts)
            for nm in names:
                if nm not in pv:
                    raise ExprError(f"undefined parameter {nm!r}")
                b_consts.append(float(pv[nm]))
            tape = compile_tape(ast, {r: j for j, r in enumerate(prefs)},
                                {nm: j for j, nm in enumerate(names)})
            infos.append(BSourceInfo(
                name=e.name, tape=tape,
                pairs=np.asarray(pairs, np.int64).reshape(-1, 2),
                is_v=e.b_is_v, ep=eq(e.node_ids[0]), em=eq(e.node_ids[1]),
                k=e.branch_eq, uses_time=("time",) in refs,
                const_off=const_off, n_consts=len(names)))
        except ExprError as err:
            # a V-form B owns a branch equation: skipping it would leave a
            # singular row, so an unresolved reference is loud
            raise ValueError(f"behavioral source {e.name}: {err}")
    return infos, b_consts
