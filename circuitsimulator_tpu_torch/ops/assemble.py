"""MNA assembly: precomputed stamp patterns, per-call values.

Port of the part of ``circuitsimulator_tpu/ops/assemble.Engine`` that the
DC, Backward-Euler and AC paths run, for R, C, L, V, I, Level-1 MOS, JFET,
diode, BJT, the S/W switches, the linear controlled sources E/G/F/H and the
behavioral B sources (``utils/expr.eval_tape``: value and gradient of the
compiled expression), with
the fixed MOS caps or the charge-conserving model (``MOSCAP=CHARGE``: five
injection rows per MOS, ``models/moscap.py``).
The stamp *pattern* (row/col index lists) is built once per circuit in
numpy; only the *values* are recomputed, split by how often they change:

- per analysis:  R, V/L couplings, E/G/F/H, C and MOS/diode/BJT junction-cap
                 companions, gmin                                 -> G_static
- per timestep:  source values at t, C/L history currents         -> I_static
- per Newton iteration: MOS/JFET/diode/BJT/switch/B linearization -> scatter
                 (and under MOSCAP=CHARGE the charge rows: ``mosq_linearize``)

Ground is the dump slot N of an (N+1)-sized system.  Parameters, x and the
transient state may carry leading lane axes; the index patterns are shared.
Scatter-adds are ``index_add_`` on the flattened (N+1)^2 matrix; the
per-timestep RHS and the state read are one-hot matmuls (exact: keep TF32
off).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.lower import LoweredCircuit
from ..models import sources as srcmod
from ..models.bjt import bjt_stamp_vals
from ..models.diode import diode_stamp_vals
from ..models.moscap import charge_jacobian, charges_of_x
from ..models.mosfet import mos_stamp_vals
from ..models.switch import switch_stamp_vals
from ..utils.expr import eval_tape
from ..utils.options import SolverOptions

# device classes of the JAX engine that the port does not stamp yet
_UNPORTED = {"K": "mutual inductance (K)", "T": "transmission line (T)"}


def _two_terminal_pattern(a: np.ndarray, b: np.ndarray):
    """rows [a,b,a,b], cols [a,b,b,a], value pattern [+g,+g,-g,-g]."""
    rows = np.stack([a, b, a, b], axis=1).ravel()
    cols = np.stack([a, b, b, a], axis=1).ravel()
    return rows.astype(np.int64), cols.astype(np.int64)


def _two_terminal_vals(g):
    return torch.stack([g, g, -g, -g], dim=-1).flatten(-2)


def _branch_pattern(ep: np.ndarray, em: np.ndarray, k: np.ndarray):
    """V-source/inductor coupling: rows [ep,em,k,k], cols [k,k,ep,em]."""
    rows = np.stack([ep, em, k, k], axis=1).ravel()
    cols = np.stack([k, k, ep, em], axis=1).ravel()
    return rows.astype(np.int64), cols.astype(np.int64)


def check_supported(low: LoweredCircuit, opts: SolverOptions) -> None:
    """Raise NotImplementedError naming what this port does not run yet."""
    counts = low.topo.counts
    for cls, name in _UNPORTED.items():
        if counts[cls]:
            raise NotImplementedError(f"{name}: not yet ported")
    tn = np.concatenate([np.asarray(low.params["vs_tn"].cpu()).reshape(-1, 4),
                         np.asarray(low.params["is_tn"].cpu()).reshape(-1, 4)])
    if np.any(tn[:, 0] > 0) or np.any(tn[:, 3] > 0):
        raise NotImplementedError("TRNOISE sources: not yet ported")
    if opts.mos_cap_model not in ("fixed", "charge"):
        raise ValueError(f"unknown mos_cap_model {opts.mos_cap_model!r} "
                         "(fixed|charge)")
    if opts.dc_solver != "lu" or opts.tran_solver != "woodbury":
        raise NotImplementedError(
            f"dc_solver={opts.dc_solver!r}, tran_solver={opts.tran_solver!r}: "
            "only the 'lu' DC and 'woodbury' transient solvers are ported")
    if opts.tran_method != "be":
        raise NotImplementedError(f"METHOD={opts.tran_method.upper()}: "
                                  "not yet ported (BE only)")


class Engine:
    """Per-circuit assembly engine: the static stamp patterns on ``device``."""

    def __init__(self, low: LoweredCircuit, opts: SolverOptions, device=None):
        check_supported(low, opts)
        t = self.topo = low.topo
        self.opts = opts
        self.dtype = opts.dtype
        self.device = torch.device(device) if device is not None else low.device
        N = self.N = t.n_unknowns
        dev, dt_ = self.device, self.dtype

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        def flat(rows, cols):
            return idx(np.asarray(rows, np.int64) * (N + 1)
                       + np.asarray(cols, np.int64))

        # ---- DC G pattern: R conductances + V/L +-1 couplings ----
        self.res_rows, self.res_cols = _two_terminal_pattern(t.res_e1, t.res_e2)
        vs_rows, vs_cols = _branch_pattern(t.vs_ep, t.vs_em, t.vs_k)
        ind_rows, ind_cols = _branch_pattern(t.ind_ep, t.ind_em, t.ind_k)
        self.dc_const_rows = np.concatenate([vs_rows, ind_rows])
        self.dc_const_cols = np.concatenate([vs_cols, ind_cols])
        nV, nI, nL = len(t.vs_ep), len(t.is_ep), len(t.ind_ep)
        self.dc_const_vals = torch.as_tensor(
            np.tile(np.array([1.0, -1.0, 1.0, -1.0]), nV + nL),
            dtype=dt_, device=dev)

        # ---- linear controlled sources (static stamps) ----
        # VCCS: rows [p,p,m,m] x cols [cp,cm,cp,cm], vals [+g,-g,-g,+g]
        # CCCS: rows [p,m] x cols [kc,kc], vals [+gain,-gain]
        # VCVS: rows [p,m,k,k,k,k] x cols [k,k,p,m,cp,cm],
        #       vals [1,-1, 1,-1,-gain,+gain]
        # CCVS: rows [p,m,k,k,k] x cols [k,k,p,m,kc], vals [1,-1,1,-1,-r]
        self.ctrl_rows = np.concatenate([
            np.stack([t.vccs_ep, t.vccs_ep, t.vccs_em, t.vccs_em], 1).ravel(),
            np.stack([t.cccs_ep, t.cccs_em], 1).ravel(),
            np.stack([t.vcvs_ep, t.vcvs_em, t.vcvs_k, t.vcvs_k,
                      t.vcvs_k, t.vcvs_k], 1).ravel(),
            np.stack([t.ccvs_ep, t.ccvs_em, t.ccvs_k, t.ccvs_k,
                      t.ccvs_k], 1).ravel(),
        ]).astype(np.int64)
        self.ctrl_cols = np.concatenate([
            np.stack([t.vccs_ecp, t.vccs_ecm, t.vccs_ecp,
                      t.vccs_ecm], 1).ravel(),
            np.stack([t.cccs_kc, t.cccs_kc], 1).ravel(),
            np.stack([t.vcvs_k, t.vcvs_k, t.vcvs_ep, t.vcvs_em,
                      t.vcvs_ecp, t.vcvs_ecm], 1).ravel(),
            np.stack([t.ccvs_k, t.ccvs_k, t.ccvs_ep, t.ccvs_em,
                      t.ccvs_kc], 1).ravel(),
        ]).astype(np.int64)
        # ---- behavioral B sources: the V form's branch coupling is static
        # (like a V source); the expression's linearisation is per
        # iteration (nl tier, after the switches)
        self.b_sources = list(low.b_sources)
        b_static_rows, b_static_cols = [], []
        b_nl_rows, b_nl_cols, b_rhs_rows = [], [], []
        for bs in self.b_sources:
            if bs.is_v:
                b_static_rows += [bs.ep, bs.em, bs.k, bs.k]
                b_static_cols += [bs.k, bs.k, bs.ep, bs.em]
                for a, b in bs.pairs:
                    b_nl_rows += [bs.k, bs.k]
                    b_nl_cols += [int(a), int(b)]
                b_rhs_rows.append(bs.k)
            else:
                for a, b in bs.pairs:
                    b_nl_rows += [bs.ep, bs.ep, bs.em, bs.em]
                    b_nl_cols += [int(a), int(b), int(a), int(b)]
                b_rhs_rows += [bs.ep, bs.em]
        self._b_pairs = [(idx(bs.pairs[:, 0]), idx(bs.pairs[:, 1]))
                         for bs in self.b_sources]
        self.b_static_rows = np.asarray(b_static_rows, np.int64)
        self.b_static_cols = np.asarray(b_static_cols, np.int64)
        self.b_static_vals = torch.as_tensor(
            np.tile(np.array([1.0, -1.0, 1.0, -1.0]),
                    len(b_static_rows) // 4), dtype=dt_, device=dev)
        self._dc_flat = flat(
            np.concatenate([self.res_rows, self.dc_const_rows,
                            self.b_static_rows, self.ctrl_rows]),
            np.concatenate([self.res_cols, self.dc_const_cols,
                            self.b_static_cols, self.ctrl_cols]))

        # ---- transient patterns: inductor BE companion (4 couplings + the
        # -L/dt branch diagonal), cap-like class = explicit C, then the 4
        # lumped MOS caps per device, pairs (G,S),(G,D),(S,B),(D,B), then
        # the diode junction caps, then the BJT caps CJE (B-E) and CJC
        # (B-C) interleaved per device; the state vector shares the layout
        self.ind_rows = np.concatenate(
            [np.stack([t.ind_ep, t.ind_em, t.ind_k, t.ind_k], 1).ravel(),
             t.ind_k]).astype(np.int64)
        self.ind_cols = np.concatenate(
            [np.stack([t.ind_k, t.ind_k, t.ind_ep, t.ind_em], 1).ravel(),
             t.ind_k]).astype(np.int64)
        mc_a = np.stack([t.mos_eg, t.mos_eg, t.mos_es, t.mos_ed], 1).ravel()
        mc_b = np.stack([t.mos_es, t.mos_ed, t.mos_eb, t.mos_eb], 1).ravel()
        qc_a = np.stack([t.bjt_eb, t.bjt_eb], 1).ravel()
        qc_b = np.stack([t.bjt_ee, t.bjt_ec], 1).ravel()
        self.cap_a = np.concatenate([t.cap_e1, mc_a, t.dio_ep,
                                     qc_a]).astype(np.int64)
        self.cap_b = np.concatenate([t.cap_e2, mc_b, t.dio_em,
                                     qc_b]).astype(np.int64)
        self.cap_rows, self.cap_cols = _two_terminal_pattern(self.cap_a,
                                                             self.cap_b)
        self.n_caplike = len(self.cap_a)

        # ---- charge-conserving MOS caps (MOSCAP=CHARGE): the fixed lumps
        # stay in the cap-like layout with C = 0 (_caplike_C), the charges
        # ride 5 injection rows per device (i_d, i_g, i_s at d, g, s; i_sb at
        # s; i_db at d), each with Jacobian entries at the (d, g, s) columns
        nM = len(t.mos_ed)
        self.mos_charge = opts.mos_cap_model == "charge" and nM > 0
        if self.mos_charge:
            term = np.stack([t.mos_ed, t.mos_eg, t.mos_es], 1)     # (nM, 3)
            inj = np.stack([t.mos_ed, t.mos_eg, t.mos_es, t.mos_es,
                            t.mos_ed], 1)                         # (nM, 5)
            self.mq_rows = np.repeat(inj, 3, axis=1).ravel().astype(np.int64)
            self.mq_cols = np.tile(term, (1, 5)).ravel().astype(np.int64)
            self.mq_rhs_rows = inj.ravel().astype(np.int64)       # (5 nM,)
            self._mq_flat = flat(self.mq_rows, self.mq_cols)
            self._mq_rhs = idx(self.mq_rhs_rows)
        self._tran_flat = flat(
            np.concatenate([self.res_rows, self.dc_const_rows[:4 * nV],
                            self.ind_rows, self.cap_rows, t.node_eqs,
                            self.ctrl_rows, self.b_static_rows]),
            np.concatenate([self.res_cols, self.dc_const_cols[:4 * nV],
                            self.ind_cols, self.cap_cols, t.node_eqs,
                            self.ctrl_cols, self.b_static_cols]))

        def any_nz(key):
            return bool(np.any(np.asarray(low.params[key].cpu())))

        # static flags: an optional term no device uses stays structurally
        # absent from the stamp math
        self.mos_body = any_nz("mos_gamma")
        self.res_tc = any_nz("res_tc1") or any_nz("res_tc2")
        self.bjt_early = any_nz("bjt_vaf")
        self.dio_bv = any_nz("dio_bv")

        # ---- nonlinear (per-Newton-iteration) patterns, concatenated in
        # the order mos, jfet, diode, bjt, switch, B ----
        def fet(d, g, s):
            """rows [D,D,D,S,S,S] x cols [D,G,S,D,G,S]; RHS rows [D,S]."""
            return (np.stack([d, d, d, s, s, s], 1).ravel(),
                    np.stack([d, g, s, d, g, s], 1).ravel(),
                    np.stack([d, s], 1).ravel())

        mos = fet(t.mos_ed, t.mos_eg, t.mos_es)
        jf = fet(t.jf_ed, t.jf_eg, t.jf_es)
        dio = (np.stack([t.dio_ep, t.dio_ep, t.dio_em, t.dio_em], 1).ravel(),
               np.stack([t.dio_ep, t.dio_em, t.dio_ep, t.dio_em], 1).ravel(),
               np.stack([t.dio_ep, t.dio_em], 1).ravel())
        # BJT: rows [C,C,C, B,B,B, E,E,E] x cols [C,B,E] x 3 (models/bjt.py)
        bjt = (np.stack([t.bjt_ec] * 3 + [t.bjt_eb] * 3 + [t.bjt_ee] * 3,
                        1).ravel(),
               np.stack([t.bjt_ec, t.bjt_eb, t.bjt_ee] * 3, 1).ravel(),
               np.stack([t.bjt_ec, t.bjt_eb, t.bjt_ee], 1).ravel())
        # switch: 2x2 conductance block + 2x2 control coupling
        sw = (np.stack([t.sw_ep, t.sw_ep, t.sw_em, t.sw_em,
                        t.sw_ep, t.sw_ep, t.sw_em, t.sw_em], 1).ravel(),
              np.stack([t.sw_ep, t.sw_em, t.sw_ep, t.sw_em,
                        t.sw_ecp, t.sw_ecm, t.sw_ecp, t.sw_ecm], 1).ravel(),
              np.stack([t.sw_ep, t.sw_em], 1).ravel())
        classes = (mos, jf, dio, bjt, sw,
                   (np.asarray(b_nl_rows, np.int64),
                    np.asarray(b_nl_cols, np.int64),
                    np.asarray(b_rhs_rows, np.int64)))
        self.nl_rows, self.nl_cols, self.nl_rhs_rows = (
            np.concatenate([c[i] for c in classes]).astype(np.int64)
            for i in range(3))
        self._nl_flat = flat(self.nl_rows, self.nl_cols)
        self._nl_rhs = idx(self.nl_rhs_rows)
        self._gmin_flat = flat(t.node_eqs, t.node_eqs)
        self._vs_k = idx(t.vs_k)
        self.is_rhs_rows = np.stack([t.is_ep, t.is_em], 1).ravel()
        self._is_rhs = idx(self.is_rhs_rows)
        self._mos_term = (idx(t.mos_ed), idx(t.mos_eg), idx(t.mos_es))
        self._jf_term = (idx(t.jf_ed), idx(t.jf_eg), idx(t.jf_es))
        self._dio_term = (idx(t.dio_ep), idx(t.dio_em))
        self._bjt_term = (idx(t.bjt_ec), idx(t.bjt_eb), idx(t.bjt_ee))
        self._sw_term = (idx(t.sw_ep), idx(t.sw_em), idx(t.sw_ecp),
                         idx(t.sw_ecm))

        # ---- one-hot hot-path operators ----
        #   RHS assembly:  I = [vval | ival | vhist | cap_hist] @ rhs_mat
        #   state read:    [vc | il | vl] = x @ state_mat
        ncap = self.n_caplike
        nterms = nV + nI + nL + ncap
        M = np.zeros((N, nterms))
        for j in range(nV):
            M[t.vs_k[j], j] += 1.0
        for j in range(nI):
            if t.is_ep[j] < N:
                M[t.is_ep[j], nV + j] -= 1.0
            if t.is_em[j] < N:
                M[t.is_em[j], nV + j] += 1.0
        for j in range(nL):
            M[t.ind_k[j], nV + nI + j] += 1.0
        for j in range(ncap):
            if self.cap_a[j] < N:
                M[self.cap_a[j], nV + nI + nL + j] += 1.0
            if self.cap_b[j] < N:
                M[self.cap_b[j], nV + nI + nL + j] -= 1.0
        self.rhs_mat = torch.as_tensor(M.T.copy(), dtype=dt_, device=dev)
        S = np.zeros((N, ncap + 2 * nL))
        for j in range(ncap):
            if self.cap_a[j] < N:
                S[self.cap_a[j], j] += 1.0
            if self.cap_b[j] < N:
                S[self.cap_b[j], j] -= 1.0
        for j in range(nL):
            S[t.ind_k[j], ncap + j] += 1.0
            if t.ind_ep[j] < N:
                S[t.ind_ep[j], ncap + nL + j] += 1.0
            if t.ind_em[j] < N:
                S[t.ind_em[j], ncap + nL + j] -= 1.0
        self.state_mat = torch.as_tensor(S, dtype=dt_, device=dev)
        # waveform kinds are structural: only present formulas are evaluated
        self.vs_kinds = np.asarray(low.params["vs_kind"].cpu())
        self.is_kinds = np.asarray(low.params["is_kind"].cpu())
        self.pwl_width = max(low.params["vs_pwl_t"].shape[-1],
                             low.params["is_pwl_t"].shape[-1])
        self._vs_masks = srcmod.kind_masks(self.vs_kinds, dev)
        self._is_masks = srcmod.kind_masks(self.is_kinds, dev)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def x_ext(self, x):
        """Append the ground slot (always 0 V): getV(-1) -> 0.0."""
        return torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)

    def _scalar(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _caplike_C(self, params):
        """Explicit C values, the MOS junction caps Cgs = Cgd = Cj0/2,
        Csb = Cdb = Cj0 (tanalisis.cpp:337-341), the diode CJO, then the
        BJT (CJE, CJC) pairs.  Under the charge model the MOS slots stay in
        the layout with C = 0: the charges are injection rows instead."""
        cj0 = params["mos_cj0"]
        if self.mos_charge:
            cj0 = torch.zeros_like(cj0)
        mc = torch.stack([0.5 * cj0, 0.5 * cj0, cj0, cj0], dim=-1).flatten(-2)
        qc = torch.stack([params["bjt_cje"], params["bjt_cjc"]],
                         dim=-1).flatten(-2)
        parts = [params["cap_c"], mc, params["dio_cjo"], qc]
        lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
        return torch.cat([p.expand(lead + p.shape[-1:]) for p in parts],
                         dim=-1)

    def _res_vals(self, params):
        r = params["res_r"]
        if self.res_tc:
            dt_ = params["temp_delta_c"]
            if dt_.dim():
                dt_ = dt_[..., None]
            r = r * (1.0 + params["res_tc1"] * dt_
                     + params["res_tc2"] * dt_ * dt_)
        nz = r != 0.0
        g = torch.where(nz, 1.0 / torch.where(nz, r, 1.0), 0.0)
        return _two_terminal_vals(g)

    def _ctrl_vals(self, params):
        """Values for the controlled-source pattern (ctrl_rows/cols order);
        all linear, so they belong to the static tier."""
        g, a = params["vccs_g"], params["cccs_gain"]
        e, r = params["vcvs_gain"], params["ccvs_r"]
        oe, orr = torch.ones_like(e), torch.ones_like(r)
        parts = [torch.stack([g, -g, -g, g], dim=-1).flatten(-2),
                 torch.stack([a, -a], dim=-1).flatten(-2),
                 torch.stack([oe, -oe, oe, -oe, -e, e], dim=-1).flatten(-2),
                 torch.stack([orr, -orr, orr, -orr, -r], dim=-1).flatten(-2)]
        lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
        return torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], -1)

    def _zeros_G(self, lead):
        return torch.zeros(lead + ((self.N + 1) ** 2,), dtype=self.dtype,
                           device=self.device)

    def _zeros_I(self, lead):
        return torch.zeros(lead + (self.N + 1,), dtype=self.dtype,
                           device=self.device)

    def _as_matrix(self, Gf):
        return Gf.reshape(Gf.shape[:-1] + (self.N + 1, self.N + 1))

    def _nl_vals(self, params, x, t=0.0):
        """Per-Newton-iteration nonlinear stamp values (G entries, RHS
        entries) in the order mos, jfet, diode, bjt, switch, B; ``t``
        reaches B expressions that read ``time`` (DC and AC linearise at
        t = 0)."""
        topo, opts = self.topo, self.opts
        xe = self.x_ext(x)
        gv, rv = [], []

        def add(pair):
            gv.append(pair[0])
            rv.append(pair[1])

        def lane_vt():
            # vt_thermal is per lane (scalar or (B,)) while the device
            # leaves are (..., n): expand it on the last axis
            return params["vt_thermal"][..., None]

        if len(topo.mos_ed):
            ed, eg, es = self._mos_term
            add(mos_stamp_vals(
                params["mos_vth"], params["mos_k"], params["mos_lam"],
                params["mos_p"], xe[..., ed], xe[..., eg], xe[..., es],
                opts.mos_off_gds, opts.mos_reverse_region,
                gamma=params["mos_gamma"] if self.mos_body else None,
                phi=params["mos_phi"] if self.mos_body else None))
        if len(topo.jf_ed):
            # Shichman-Hodges == square law with K = 2*BETA, signed VTO
            ed, eg, es = self._jf_term
            add(mos_stamp_vals(
                params["jf_vto"], 2.0 * params["jf_beta"], params["jf_lam"],
                params["jf_p"], xe[..., ed], xe[..., eg], xe[..., es],
                opts.mos_off_gds, opts.mos_reverse_region))
        if len(topo.dio_ep):
            ep, em = self._dio_term
            add(diode_stamp_vals(
                params["dio_is"], params["dio_n"], xe[..., ep], xe[..., em],
                vt=lane_vt(),
                bv=params["dio_bv"] if self.dio_bv else None,
                ibv=params["dio_ibv"] if self.dio_bv else None))
        if len(topo.bjt_ec):
            ec, eb, ee = self._bjt_term
            add(bjt_stamp_vals(
                params["bjt_is"], params["bjt_bf"], params["bjt_br"],
                params["bjt_p"], xe[..., ec], xe[..., eb], xe[..., ee],
                vt=lane_vt(),
                vaf=params["bjt_vaf"] if self.bjt_early else None))
        if len(topo.sw_ep):
            ep, em, ecp, ecm = self._sw_term
            add(switch_stamp_vals(
                params["sw_ron"], params["sw_roff"], params["sw_vt"],
                params["sw_vh"], xe[..., ep], xe[..., em], xe[..., ecp],
                xe[..., ecm]))
        for bs, (pa, pb) in zip(self.b_sources, self._b_pairs):
            # the expression's value and gradient at the probe values give
            # the linearisation; consts are its .PARAM values (per lane)
            vals = xe[..., pa] - xe[..., pb]
            consts = params["b_consts"][
                ..., bs.const_off:bs.const_off + bs.n_consts]
            e0, grads = eval_tape(bs.tape, vals, t, consts)
            cst = e0 - (grads * vals).sum(-1)
            if bs.is_v:
                # branch row: Vp - Vm - sum g_j val_j = cst
                add((torch.stack([-grads, grads], -1).flatten(-2),
                     cst[..., None]))
            else:
                add((torch.stack([grads, -grads, -grads, grads],
                                 -1).flatten(-2),
                     torch.stack([-cst, cst], -1)))
        if not gv:
            z = x.new_zeros(x.shape[:-1] + (0,))
            return z, z
        lead = torch.broadcast_shapes(*(g.shape[:-1] for g in gv))
        return (torch.cat([g.expand(lead + g.shape[-1:]) for g in gv], -1),
                torch.cat([r.expand(lead + r.shape[-1:]) for r in rv], -1))

    # ------------------------------------------------------------------
    # DC assembly
    # ------------------------------------------------------------------
    def dc_static_entries(self, params):
        """Static COO entries of the DC matrix: (rows, cols, vals)."""
        rvals = self._res_vals(params)
        cvals = self._ctrl_vals(params)
        lead = torch.broadcast_shapes(rvals.shape[:-1], cvals.shape[:-1])
        const = self.dc_const_vals.expand(lead + self.dc_const_vals.shape)
        bvals = self.b_static_vals.expand(lead + self.b_static_vals.shape)
        rows = np.concatenate([self.res_rows, self.dc_const_rows,
                               self.b_static_rows, self.ctrl_rows])
        cols = np.concatenate([self.res_cols, self.dc_const_cols,
                               self.b_static_cols, self.ctrl_cols])
        return rows, cols, torch.cat([rvals.expand(lead + rvals.shape[-1:]),
                                      const, bvals,
                                      cvals.expand(lead + cvals.shape[-1:])],
                                     dim=-1)

    def dc_rhs(self, params, scale):
        """DC RHS: V/I source values at the ramp scale."""
        vval = srcmod.eval_dc(params["vs_dc"], params["vs_kind"],
                              params["vs_sin"], scale, pulse=params["vs_pulse"])
        ival = srcmod.eval_dc(params["is_dc"], params["is_kind"],
                              params["is_sin"], scale, pulse=params["is_pulse"])
        lead = torch.broadcast_shapes(vval.shape[:-1], ival.shape[:-1])
        I = self._zeros_I(lead)
        I.index_add_(-1, self._vs_k, vval.expand(lead + vval.shape[-1:]))
        irhs = torch.stack([-ival, ival], dim=-1).flatten(-2)
        I.index_add_(-1, self._is_rhs, irhs.expand(lead + irhs.shape[-1:]))
        return I

    def dc_static(self, params, scale):
        """G/I parts constant across the Newton iterations of a ramp step."""
        _, _, vals = self.dc_static_entries(params)
        Gf = self._zeros_G(vals.shape[:-1])
        Gf.index_add_(-1, self._dc_flat, vals)
        return self._as_matrix(Gf), self.dc_rhs(params, scale)

    def assemble_dc_iter(self, G_static, I_static, params, x, gmin):
        """Add the device linearization and the adaptive gmin diagonal."""
        gvals, rvals = self._nl_vals(params, x)
        lead = torch.broadcast_shapes(G_static.shape[:-2], gvals.shape[:-1])
        Gf = G_static.reshape(G_static.shape[:-2] + (-1,))
        Gf = Gf.expand(lead + Gf.shape[-1:]).clone()
        Gf.index_add_(-1, self._nl_flat, gvals.expand(lead + gvals.shape[-1:]))
        gm = self._scalar(gmin)[..., None].expand(
            lead + (len(self.topo.node_eqs),))
        Gf.index_add_(-1, self._gmin_flat, gm)
        I = I_static.expand(lead + I_static.shape[-1:]).clone()
        I.index_add_(-1, self._nl_rhs, rvals.expand(lead + rvals.shape[-1:]))
        return self._as_matrix(Gf), I

    # ------------------------------------------------------------------
    # Transient assembly (Backward Euler companions, tanalisis.cpp:255-356)
    # ------------------------------------------------------------------
    def tran_static_entries(self, params, dt, gmin):
        """Static COO entries of the BE transient matrix: R, V couplings,
        L and C/MOS-cap companions (G_C = C/dt, R_L = L/dt), gmin, E/G/F/H,
        the B V-form couplings."""
        rvals = self._res_vals(params)
        cvals = self._ctrl_vals(params)
        lead = torch.broadcast_shapes(rvals.shape[:-1], cvals.shape[:-1])
        nV = len(self.topo.vs_ep)
        vs_vals = self.dc_const_vals[:4 * nV]
        L = params["ind_l"]
        lmask = L > 0.0
        ones = torch.ones_like(L)
        pat = torch.stack([ones, -ones, ones, -ones], dim=-1)
        pat = (pat * lmask[..., None]).flatten(-2)
        diag = torch.where(lmask, -L / dt, 0.0)
        ind_vals = torch.cat([pat, diag], dim=-1)
        C = self._caplike_C(params)
        gc = torch.where(C > 0.0, C / dt, 0.0)
        cap_vals = _two_terminal_vals(gc)
        gm = self._scalar(gmin)[..., None].expand(
            lead + (len(self.topo.node_eqs),))
        rows = np.concatenate([self.res_rows, self.dc_const_rows[:4 * nV],
                               self.ind_rows, self.cap_rows,
                               self.topo.node_eqs, self.ctrl_rows,
                               self.b_static_rows])
        cols = np.concatenate([self.res_cols, self.dc_const_cols[:4 * nV],
                               self.ind_cols, self.cap_cols,
                               self.topo.node_eqs, self.ctrl_cols,
                               self.b_static_cols])
        parts = [rvals, vs_vals, ind_vals, cap_vals, gm, cvals,
                 self.b_static_vals]
        vals = torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], -1)
        return rows, cols, vals

    def tran_static_G(self, params, dt, gmin):
        """The whole BE matrix except the nonlinear devices' entries: constant
        for the entire transient (fixed dt, fixed gmin)."""
        _, _, vals = self.tran_static_entries(params, dt, gmin)
        Gf = self._zeros_G(vals.shape[:-1])
        Gf.index_add_(-1, self._tran_flat, vals)
        return self._as_matrix(Gf)

    def make_tran_static_I(self, dt):
        """f(params, state, t) -> (..., N+1) RHS of one BE timestep: sources
        at t plus history currents, as one one-hot matmul.

            cap:  I(a) += (C/dt) v_prev,    L: I(k) += -(L/dt) i_prev
        """
        def f(params, state, t):
            vval = srcmod.eval_tran_masked(
                self._vs_masks, params["vs_dc"], params["vs_pulse"],
                params["vs_sin"], params["vs_pwl_t"], params["vs_pwl_v"],
                params["vs_pwl_n"], t)
            ival = srcmod.eval_tran_masked(
                self._is_masks, params["is_dc"], params["is_pulse"],
                params["is_sin"], params["is_pwl_t"], params["is_pwl_v"],
                params["is_pwl_n"], t)
            L = params["ind_l"]
            C = self._caplike_C(params)
            vhist = torch.where(L > 0.0, -(L / dt) * state["il"], 0.0)
            gc = torch.where(C > 0.0, C / dt, 0.0)
            h = gc * state["vc"]
            parts = [vval, ival, vhist, h]
            lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
            terms = torch.cat([p.expand(lead + p.shape[-1:]) for p in parts],
                              dim=-1)
            I = terms @ self.rhs_mat
            return torch.cat([I, torch.zeros_like(I[..., :1])], dim=-1)

        return f

    def mos_vdgs(self, x):
        """Per-MOS terminal voltages (..., nM, 3) ordered (vd, vg, vs)."""
        xe = self.x_ext(x)
        return torch.stack([xe[..., i] for i in self._mos_term], dim=-1)

    def mosq_linearize(self, params, vdgs, qprev, inv_dt):
        """Backward-Euler companion of the charge currents i = dq/dt:
        (g (..., nM, 5, 3), cst (..., nM, 5)) with i ~= g (vd, vg, vs) + cst,
        g = (dq/dv)/dt, cst = (q(v) - q_prev)/dt - g v; qprev (..., nM, 5)
        are the accepted charges of the previous step."""
        q, J = charge_jacobian(vdgs, params)
        g = J * inv_dt
        cst = (q - qprev) * inv_dt - (g * vdgs[..., None, :]).sum(-1)
        return g, cst

    def assemble_tran_iter(self, G_static, I_static, params, x, t=0.0,
                           qex=None):
        """Dense BE system of one Newton iteration: the static G and RHS
        (both (..., N+1, ...)) plus the device linearisation at x; qex =
        (qprev, inv_dt) adds the 15 Jacobian and 5 RHS entries per MOS of
        the charge model."""
        gvals, rvals = self._nl_vals(params, x, t)
        lead = torch.broadcast_shapes(G_static.shape[:-2], gvals.shape[:-1])
        Gf = G_static.reshape(G_static.shape[:-2] + (-1,))
        Gf = Gf.expand(lead + Gf.shape[-1:]).clone()
        Gf.index_add_(-1, self._nl_flat, gvals.expand(lead + gvals.shape[-1:]))
        I = I_static.expand(lead + I_static.shape[-1:]).clone()
        I.index_add_(-1, self._nl_rhs, rvals.expand(lead + rvals.shape[-1:]))
        if qex is not None:
            gq, cq = self.mosq_linearize(params, self.mos_vdgs(x), *qex)
            gq, cq = gq.flatten(-3), -cq.flatten(-2)
            Gf.index_add_(-1, self._mq_flat, gq.expand(lead + gq.shape[-1:]))
            I.index_add_(-1, self._mq_rhs, cq.expand(lead + cq.shape[-1:]))
        return self._as_matrix(Gf), I

    # ------------------------------------------------------------------
    # Transient state
    # ------------------------------------------------------------------
    def _state_parts(self, x):
        """(cap-like voltage diffs, inductor currents, inductor voltages)."""
        ncap = self.n_caplike
        nL = len(self.topo.ind_k)
        s = x @ self.state_mat
        return s[..., :ncap], s[..., ncap:ncap + nL], s[..., ncap + nL:]

    def init_state(self, x, params=None):
        """TranState from a DC solution (tanalisis.cpp:139-180); x may carry
        leading lane axes.  ic/vl are the trapezoidal extras (zero at DC).
        The charge model adds the MOS charges qm (..., nM, 5) at x, which
        needs ``params``."""
        vc, il, _ = self._state_parts(x)
        state = {"vc": vc, "ic": torch.zeros_like(vc),
                 "il": il, "vl": torch.zeros_like(il)}
        if self.mos_charge:
            if params is None:
                raise ValueError("the charge cap model needs "
                                 "init_state(x, params)")
            state["qm"] = charges_of_x(self.mos_vdgs(x), params)
        return state

    def make_update_state(self, dt):
        """Post-step BE state update: voltages and currents of the accepted x
        (tanalisis.cpp:379-417), and the charges under the charge model."""
        def f(params, x, state):
            vc, il, _ = self._state_parts(x)
            new = {"vc": vc, "ic": torch.zeros_like(vc),
                   "il": il, "vl": torch.zeros_like(il)}
            if self.mos_charge:
                new["qm"] = charges_of_x(self.mos_vdgs(x), params)
            return new

        return f
