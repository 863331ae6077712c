"""MNA assembly: precomputed stamp patterns, per-call values.

Port of the part of ``circuitsimulator_tpu/ops/assemble.Engine`` that the
DC, Backward-Euler and AC paths run, for R, C, L, V, I, Level-1 MOS and the
linear controlled sources E/G/F/H.
The stamp *pattern* (row/col index lists) is built once per circuit in
numpy; only the *values* are recomputed, split by how often they change:

- per analysis:  R, V/L couplings, E/G/F/H, C and MOS-cap companions,
                 gmin                                             -> G_static
- per timestep:  source values at t, C/L history currents         -> I_static
- per Newton iteration: MOS conduction linearization              -> scatter

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
from ..models.mosfet import mos_stamp_vals
from ..utils.options import SolverOptions

# device classes of the JAX engine that the port does not stamp yet
_UNPORTED = {"D": "diode", "Q": "BJT", "J": "JFET", "S": "switch (S/W)",
             "K": "mutual inductance (K)", "T": "transmission line (T)"}


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
    if opts.mos_cap_model != "fixed":
        raise NotImplementedError("MOSCAP=CHARGE: not yet ported")
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
        self._dc_flat = flat(
            np.concatenate([self.res_rows, self.dc_const_rows,
                            self.ctrl_rows]),
            np.concatenate([self.res_cols, self.dc_const_cols,
                            self.ctrl_cols]))

        # ---- transient patterns: inductor BE companion (4 couplings + the
        # -L/dt branch diagonal), cap-like class = explicit C then the 4
        # lumped MOS caps per device, pairs (G,S),(G,D),(S,B),(D,B) ----
        self.ind_rows = np.concatenate(
            [np.stack([t.ind_ep, t.ind_em, t.ind_k, t.ind_k], 1).ravel(),
             t.ind_k]).astype(np.int64)
        self.ind_cols = np.concatenate(
            [np.stack([t.ind_k, t.ind_k, t.ind_ep, t.ind_em], 1).ravel(),
             t.ind_k]).astype(np.int64)
        mc_a = np.stack([t.mos_eg, t.mos_eg, t.mos_es, t.mos_ed], 1).ravel()
        mc_b = np.stack([t.mos_es, t.mos_ed, t.mos_eb, t.mos_eb], 1).ravel()
        self.cap_a = np.concatenate([t.cap_e1, mc_a]).astype(np.int64)
        self.cap_b = np.concatenate([t.cap_e2, mc_b]).astype(np.int64)
        self.cap_rows, self.cap_cols = _two_terminal_pattern(self.cap_a,
                                                             self.cap_b)
        self.n_caplike = len(self.cap_a)
        self._tran_flat = flat(
            np.concatenate([self.res_rows, self.dc_const_rows[:4 * nV],
                            self.ind_rows, self.cap_rows, t.node_eqs,
                            self.ctrl_rows]),
            np.concatenate([self.res_cols, self.dc_const_cols[:4 * nV],
                            self.ind_cols, self.cap_cols, t.node_eqs,
                            self.ctrl_cols]))

        self.mos_body = bool(np.any(np.asarray(low.params["mos_gamma"].cpu())))
        self.res_tc = bool(np.any(np.asarray(low.params["res_tc1"].cpu()))
                           or np.any(np.asarray(low.params["res_tc2"].cpu())))

        # ---- nonlinear (per-Newton-iteration) MOS pattern ----
        self.nl_rows = np.stack(
            [t.mos_ed, t.mos_ed, t.mos_ed, t.mos_es, t.mos_es, t.mos_es],
            1).ravel().astype(np.int64)
        self.nl_cols = np.stack(
            [t.mos_ed, t.mos_eg, t.mos_es, t.mos_ed, t.mos_eg, t.mos_es],
            1).ravel().astype(np.int64)
        self.nl_rhs_rows = np.stack([t.mos_ed, t.mos_es],
                                    1).ravel().astype(np.int64)
        self._nl_flat = flat(self.nl_rows, self.nl_cols)
        self._nl_rhs = idx(self.nl_rhs_rows)
        self._gmin_flat = flat(t.node_eqs, t.node_eqs)
        self._vs_k = idx(t.vs_k)
        self.is_rhs_rows = np.stack([t.is_ep, t.is_em], 1).ravel()
        self._is_rhs = idx(self.is_rhs_rows)
        self._mos_term = (idx(t.mos_ed), idx(t.mos_eg), idx(t.mos_es))

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
        """Explicit C values then the MOS junction caps Cgs = Cgd = Cj0/2,
        Csb = Cdb = Cj0 (tanalisis.cpp:337-341)."""
        cj0 = params["mos_cj0"]
        mc = torch.stack([0.5 * cj0, 0.5 * cj0, cj0, cj0], dim=-1).flatten(-2)
        cap = params["cap_c"]
        lead = torch.broadcast_shapes(cap.shape[:-1], mc.shape[:-1])
        return torch.cat([cap.expand(lead + cap.shape[-1:]),
                          mc.expand(lead + mc.shape[-1:])], dim=-1)

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
        """Per-Newton-iteration MOS stamp values (G entries, RHS entries)."""
        if not len(self.topo.mos_ed):
            z = x.new_zeros(x.shape[:-1] + (0,))
            return z, z
        xe = self.x_ext(x)
        ed, eg, es = self._mos_term
        opts = self.opts
        return mos_stamp_vals(
            params["mos_vth"], params["mos_k"], params["mos_lam"],
            params["mos_p"], xe[..., ed], xe[..., eg], xe[..., es],
            opts.mos_off_gds, opts.mos_reverse_region,
            gamma=params["mos_gamma"] if self.mos_body else None,
            phi=params["mos_phi"] if self.mos_body else None)

    # ------------------------------------------------------------------
    # DC assembly
    # ------------------------------------------------------------------
    def dc_static_entries(self, params):
        """Static COO entries of the DC matrix: (rows, cols, vals)."""
        rvals = self._res_vals(params)
        cvals = self._ctrl_vals(params)
        lead = torch.broadcast_shapes(rvals.shape[:-1], cvals.shape[:-1])
        const = self.dc_const_vals.expand(lead + self.dc_const_vals.shape)
        rows = np.concatenate([self.res_rows, self.dc_const_rows,
                               self.ctrl_rows])
        cols = np.concatenate([self.res_cols, self.dc_const_cols,
                               self.ctrl_cols])
        return rows, cols, torch.cat([rvals.expand(lead + rvals.shape[-1:]),
                                      const,
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
        """Add the MOS linearization and the adaptive gmin diagonal."""
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
        L and C/MOS-cap companions (G_C = C/dt, R_L = L/dt), gmin, E/G/F/H."""
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
                               self.topo.node_eqs, self.ctrl_rows])
        cols = np.concatenate([self.res_cols, self.dc_const_cols[:4 * nV],
                               self.ind_cols, self.cap_cols,
                               self.topo.node_eqs, self.ctrl_cols])
        parts = [rvals, vs_vals, ind_vals, cap_vals, gm, cvals]
        vals = torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], -1)
        return rows, cols, vals

    def tran_static_G(self, params, dt, gmin):
        """The whole BE matrix except the MOS conduction entries: constant
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

    # ------------------------------------------------------------------
    # Transient state
    # ------------------------------------------------------------------
    def _state_parts(self, x):
        """(cap-like voltage diffs, inductor currents, inductor voltages)."""
        ncap = self.n_caplike
        nL = len(self.topo.ind_k)
        s = x @ self.state_mat
        return s[..., :ncap], s[..., ncap:ncap + nL], s[..., ncap + nL:]

    def init_state(self, x):
        """TranState from a DC solution (tanalisis.cpp:139-180); x may carry
        leading lane axes.  ic/vl are the trapezoidal extras (zero at DC)."""
        vc, il, _ = self._state_parts(x)
        return {"vc": vc, "ic": torch.zeros_like(vc),
                "il": il, "vl": torch.zeros_like(il)}

    def make_update_state(self, dt):
        """Post-step BE state update: voltages and currents of the accepted x
        (tanalisis.cpp:379-417)."""
        def f(params, x, state):
            vc, il, _ = self._state_parts(x)
            return {"vc": vc, "ic": torch.zeros_like(vc),
                    "il": il, "vl": torch.zeros_like(il)}

        return f
