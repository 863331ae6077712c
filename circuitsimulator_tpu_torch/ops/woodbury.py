"""Low-rank (Woodbury) Newton solve for the transient hot loop.

Port of ``circuitsimulator_tpu/ops/woodbury.py`` for Level-1 MOS, JFET,
diode, BJT, switch and behavioral B-source rows and the charge rows of
``MOSCAP=CHARGE``.  Each MOSFET's conduction stamp is a rank-one update
(e_D - e_S) v^T of the otherwise constant BE or trapezoidal matrix G0
(fixed dt); JFETs, diodes and switches are rank one too, a BJT is rank
two ((e_C - e_E) for Ic, (e_B - e_E) for Ib), a B source is one row over
its probe pairs
(applied at e_p - e_m for I=expr, at the branch row e_k for V=expr), and
the charge model adds five node-to-ground rows per MOS (i_d, i_g, i_s,
i_sb, i_db at d, g, s, s, d, each over (vd, vg, vs)).  With G0 inverted
once:

    A = G0 + U V^T,  b = b0 - U c,  Y = G0^{-1} U,  z = G0^{-1} b0 - Y c
    x = z - Y (I_k + V^T Y)^{-1} V^T z

Per Newton iteration: matvecs plus one k x k pivoted solve, which goes
through ``ops/lu.lu_solve`` (the K2 kernel on CUDA).  Terminal-voltage
reads are one-hot matmuls; rows of grounded terminals (dump index) are all
zero, which reproduces the x_ext ground convention.  With ``solve_op=``
(the ``blockwb`` backend) G0^-1 is applied by the pre-factored block CR
instead of a dense inverse, and the k x k solve goes through
``lu_solve`` all the same (K2 for k <= 64, ``lu_solve_large`` above).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.bjt import bjt_linearize
from ..models.diode import diode_linearize
from ..models.mosfet import mos_linearize
from ..models.switch import switch_linearize
from ..utils.expr import eval_tape
from .lu import lu_inverse, lu_solve
from ..utils.shapes import broadcast_shapes


class WoodburyPlan:
    """Static index plan of the rank-k update, rows in the order mos, jfet,
    diode, bjt (Ic row then Ib row per device), switch, B, then the charge
    rows (five per MOS, device-major) when the engine runs the charge model.

    The V^T row width W is 3 (MOS/JFET d, g, s; diode p, m, dump; BJT c, b,
    e) unless a switch is present: its row couples the node pair to the
    control pair (p, m, cp, cm), so every class pads to W = 4 with the dump
    column (zero coefficient).  A B source's row reads its m probe pairs
    (a_0, b_0, a_1, b_1, ...), so B sources widen W to 2 max(m).  Decks
    without a switch or a B source keep the exact width-3 layout."""

    def __init__(self, engine):
        t = engine.topo
        N = self.N = engine.N
        self.nM, self.nJ = len(t.mos_ed), len(t.jf_ed)
        self.nD, self.nQ, self.nS = len(t.dio_ep), len(t.bjt_ec), len(t.sw_ep)
        self.nCq = 5 * self.nM if engine.mos_charge else 0
        self.b_sources = list(engine.b_sources)
        self.nB = nB = len(self.b_sources)
        self.k = (self.nM + self.nJ + self.nD + 2 * self.nQ + self.nS + nB
                  + self.nCq)
        W = 4 if self.nS else 3
        if nB:
            W = max(W, max(2 * len(bs.pairs) for bs in self.b_sources))
        self.W = W
        # charge rows inject at (d, g, s, s, d) against ground
        mcq_pos = (np.stack([t.mos_ed, t.mos_eg, t.mos_es, t.mos_es,
                             t.mos_ed], 1).ravel() if self.nCq
                   else np.zeros((0,), np.int64))
        # U column j = e_pos[j] - e_neg[j] (dump-mapped entries vanish)
        # a B row applies at e_k (V form: its branch row) or e_p - e_m
        b_pos = [bs.k if bs.is_v else bs.ep for bs in self.b_sources]
        b_neg = [N if bs.is_v else bs.em for bs in self.b_sources]
        self.u_pos = np.concatenate([
            t.mos_ed, t.jf_ed, t.dio_ep,
            np.stack([t.bjt_ec, t.bjt_eb], 1).ravel(), t.sw_ep, b_pos,
            mcq_pos
        ]).astype(np.int64)
        self.u_neg = np.concatenate([
            t.mos_es, t.jf_es, t.dio_em,
            np.stack([t.bjt_ee, t.bjt_ee], 1).ravel(), t.sw_em, b_neg,
            np.full(self.nCq, N)
        ]).astype(np.int64)

        def cols(*terms):
            """(n, W) column block, padded with the dump index."""
            n = len(terms[0])
            pad = [np.full(n, N)] * (W - len(terms))
            return np.stack(list(terms) + pad, 1).reshape(n, W)

        # terminal reads of each class, (n, W) in the row layout
        self.mos_cols = cols(t.mos_ed, t.mos_eg, t.mos_es)
        self.jf_cols = cols(t.jf_ed, t.jf_eg, t.jf_es)
        self.dio_cols = cols(t.dio_ep, t.dio_em)
        self.bjt_cols = cols(t.bjt_ec, t.bjt_eb, t.bjt_ee)
        self.sw_cols = (cols(t.sw_ep, t.sw_em, t.sw_ecp, t.sw_ecm)
                        if self.nS else np.zeros((0, W)))
        # each B row reads its probe pairs (a_0, b_0, a_1, b_1, ...)
        self.b_cols = np.asarray(
            [list(bs.pairs.ravel()) + [N] * (W - 2 * len(bs.pairs))
             for bs in self.b_sources], np.int64).reshape(nB, W)
        # the charge rows read (vd, vg, vs): all five rows of a device
        self.mcq_cols = (np.repeat(self.mos_cols, 5, axis=0) if self.nCq
                         else np.zeros((0, W)))
        self._cols = np.concatenate([
            self.mos_cols, self.jf_cols, self.dio_cols,
            np.repeat(self.bjt_cols, 2, axis=0), self.sw_cols, self.b_cols,
            self.mcq_cols
        ]).astype(np.int64)

    def build_U(self, dtype, device):
        """(N, k) dense U (dump entries vanish)."""
        U = np.zeros((self.N + 1, self.k))
        np.add.at(U, (self.u_pos, np.arange(self.k)), 1.0)
        np.add.at(U, (self.u_neg, np.arange(self.k)), -1.0)
        return torch.as_tensor(U[: self.N], dtype=dtype, device=device)

    def col_idx(self) -> np.ndarray:
        """(k, W) column indices of the V^T coefficient rows."""
        return self._cols


class WoodburySolver:
    """Per-transient factorisation state and the per-iteration solve."""

    def __init__(self, engine, params, G0=None, solve_op=None):
        """G0: (..., N, N) static BE matrix (tran_static_G without the dump
        row/column), inverted once with the pivoted LU.  Or ``solve_op(B)``,
        which applies G0^-1 to (..., N, q) right-hand sides without a dense
        inverse (the pre-factored block CR of ``ops/blockcr``, where an N x
        N inverse would take N^2 memory)."""
        self.engine = engine
        self.plan = plan = WoodburyPlan(engine)
        opts = engine.opts
        N, dev, dt_ = engine.N, engine.device, engine.dtype
        self.pivot_floor = opts.lu_pivot_floor
        U = plan.build_U(dt_, dev)
        self._solve_op = solve_op
        if solve_op is None:
            self.G0inv = lu_inverse(G0, opts.lu_pivot_floor)
            self.Y = self.G0inv @ U                             # (..., N, k)
        else:
            self.G0inv = None
            self.Y = solve_op(U)
        cols = torch.as_tensor(plan.col_idx(), device=dev)      # (k, W)
        Y_ext = torch.cat([self.Y, torch.zeros_like(self.Y[..., :1, :])],
                          dim=-2)                               # dump row = 0
        self.Y_cols = Y_ext[..., cols, :]                       # (..., k, W, k)
        self.eye_k = torch.eye(plan.k, dtype=dt_, device=dev)

        def onehot(idx):
            idx = np.asarray(idx, np.int64).ravel()
            M = np.zeros((N + 1, len(idx)))
            M[idx, np.arange(len(idx))] = 1.0
            return torch.as_tensor(M[:N], dtype=dt_, device=dev)

        self.M_mos = onehot(plan.mos_cols)                      # (N, W nM)
        self.M_jf = onehot(plan.jf_cols)
        self.M_dio = onehot(plan.dio_cols)
        self.M_bjt = onehot(plan.bjt_cols)
        self.M_sw = onehot(plan.sw_cols)
        self.M_b = onehot(plan.b_cols)                          # (N, W nB)
        self.M_cols = onehot(plan.col_idx())                    # (N, W k)

    def z0(self, b0):
        """G0^{-1} b0, once per timestep (b0 = sources + history)."""
        if self._solve_op is not None:
            return self._solve_op(b0[..., None])[..., 0]
        return (self.G0inv @ b0[..., None])[..., 0]

    def nl_coeffs(self, params, x, qex=None, t=0.0):
        """Per-row V^T values (..., k, W) and Newton constants (..., k);
        qex = (qprev, inv_dt) for the charge rows, (qprev, inv_dt, iprev)
        under trap, t the time that B expressions read."""
        plan, eng = self.plan, self.engine
        opts = eng.opts
        W = plan.W
        parts_v, parts_c = [], []

        def read(M, n):
            """Terminal voltages of a class: W tensors of (..., n)."""
            return (x @ M).unflatten(-1, (n, W)).unbind(-1)

        def rows(*coef):
            """Coefficient rows (..., n, W), short rows zero-padded."""
            coef = list(coef) + [torch.zeros_like(coef[0])] * (W - len(coef))
            return torch.stack(coef, dim=-1)

        def lane_vt():
            return params["vt_thermal"][..., None]

        if plan.nM:
            vd, vg, vs = read(self.M_mos, plan.nM)[:3]
            body = eng.mos_body
            gd, gg, gs, cst = mos_linearize(
                params["mos_vth"], params["mos_k"], params["mos_lam"],
                params["mos_p"], vd, vg, vs,
                opts.mos_off_gds, opts.mos_reverse_region,
                gamma=params["mos_gamma"] if body else None,
                phi=params["mos_phi"] if body else None)
            parts_v.append(rows(gd, gg, gs))
            parts_c.append(cst)
        if plan.nJ:
            vd, vg, vs = read(self.M_jf, plan.nJ)[:3]
            gd, gg, gs, cst = mos_linearize(
                params["jf_vto"], 2.0 * params["jf_beta"], params["jf_lam"],
                params["jf_p"], vd, vg, vs,
                opts.mos_off_gds, opts.mos_reverse_region)
            parts_v.append(rows(gd, gg, gs))
            parts_c.append(cst)
        if plan.nD:
            vp, vm = read(self.M_dio, plan.nD)[:2]
            g, cst = diode_linearize(
                params["dio_is"], params["dio_n"], vp, vm, vt=lane_vt(),
                bv=params["dio_bv"] if eng.dio_bv else None,
                ibv=params["dio_ibv"] if eng.dio_bv else None)
            parts_v.append(rows(g, -g))
            parts_c.append(cst)
        if plan.nQ:
            vc, vb, ve = read(self.M_bjt, plan.nQ)[:3]
            rc, rb = bjt_linearize(
                params["bjt_is"], params["bjt_bf"], params["bjt_br"],
                params["bjt_p"], vc, vb, ve, vt=lane_vt(),
                vaf=params["bjt_vaf"] if eng.bjt_early else None)
            # interleave (Ic row, Ib row) per device
            parts_v.append(torch.stack([rows(*rc[:3]), rows(*rb[:3])],
                                       dim=-2).flatten(-3, -2))
            parts_c.append(torch.stack([rc[3], rb[3]], dim=-1).flatten(-2))
        if plan.nS:
            vp, vm, vcp, vcm = read(self.M_sw, plan.nS)
            gd, gc, cst = switch_linearize(
                params["sw_ron"], params["sw_roff"], params["sw_vt"],
                params["sw_vh"], vp, vm, vcp, vcm)
            parts_v.append(rows(gd, -gd, gc, -gc))
            parts_c.append(cst)
        if plan.nB:
            # B rows: I form [g, -g, ...] at the probe pairs with c = cst;
            # V form (-f on the branch row, U column = +e_k) [-g, g, ...]
            # with c = -cst (Engine._nl_vals sign convention)
            xb = read(self.M_b, plan.nB)
            for i, bs in enumerate(plan.b_sources):
                m = len(bs.pairs)
                vals = torch.stack([xb[2 * j][..., i] - xb[2 * j + 1][..., i]
                                    for j in range(m)], -1) if m else \
                    x[..., :0]
                consts = params["b_consts"][
                    ..., bs.const_off:bs.const_off + bs.n_consts]
                e0, grads = eval_tape(bs.tape, vals, t, consts)
                cst = e0 - (grads * vals).sum(-1)
                sig = -1.0 if bs.is_v else 1.0
                coef = [c for j in range(m)
                        for c in (sig * grads[..., j], -sig * grads[..., j])]
                if not coef:
                    coef = [torch.zeros_like(e0)]
                parts_v.append(rows(*coef)[..., None, :])
                parts_c.append((sig * cst)[..., None])
        if plan.nCq:
            if qex is None:
                raise ValueError("the charge rows need qex=(qprev, inv_dt)")
            vdgs = torch.stack(read(self.M_mos, plan.nM)[:3], dim=-1)
            gq, cq = eng.mosq_linearize(params, vdgs, *qex)
            parts_v.append(rows(*gq.flatten(-3, -2).unbind(-1)))
            parts_c.append(cq.flatten(-2))
        if len(parts_v) == 1:
            return parts_v[0], parts_c[0]
        lead = broadcast_shapes(*(c.shape[:-1] for c in parts_c))
        return (torch.cat([v.expand(lead + v.shape[-2:]) for v in parts_v],
                          dim=-2),
                torch.cat([c.expand(lead + c.shape[-1:]) for c in parts_c],
                          dim=-1))

    def solve(self, params, x, z0, qex=None, t=0.0):
        """One Newton linear solve: x_raw with A(x) x_raw = b(x); qex =
        (qprev, inv_dt), or (qprev, inv_dt, iprev) under trap, for the
        charge model, t the step time (B expressions that read ``time``)."""
        plan = self.plan
        if plan.k == 0:
            return z0
        vcoef, c = self.nl_coeffs(params, x, qex, t)
        z = z0 - (self.Y @ c[..., None])[..., 0]
        # S = I + V^T Y: S[j, l] = sum_s vcoef[j, s] * Y[cols[j, s], l]
        S = self.eye_k + (vcoef[..., None] * self.Y_cols).sum(-2)
        zc = (z @ self.M_cols).unflatten(-1, (plan.k, plan.W))
        vz = (vcoef * zc).sum(-1)
        w = lu_solve(S, vz, self.pivot_floor)
        return z - (self.Y @ w[..., None])[..., 0]
