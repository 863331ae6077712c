"""MNA assembly: precomputed stamp patterns, per-call values.

Port of the part of ``circuitsimulator_tpu/ops/assemble.Engine`` that the
DC, transient (Backward Euler and trapezoidal) and AC paths run, for R, C,
L, V, I, Level-1 MOS, JFET, diode, BJT, the S/W switches, the linear
controlled sources E/G/F/H, the behavioral B sources
(``utils/expr.eval_tape``: value and gradient of the compiled expression),
the lossless transmission lines (T: the Branin method of characteristics,
a delay ring of past waves in the state) and mutual inductance (K: the
-M/dt branch-row cross terms, -2M/dt under trap, and their history
currents), with
the fixed MOS caps or the charge-conserving model (``MOSCAP=CHARGE``: five
injection rows per MOS, ``models/moscap.py``).
The stamp *pattern* (row/col index lists) is built once per circuit in
numpy; only the *values* are recomputed, split by how often they change:

- per analysis:  R, V/L couplings, E/G/F/H, C and MOS/diode/BJT junction-cap
                 companions, gmin                                 -> G_static
- per timestep:  source values at t (plus, on a noisy run, the TRNOISE
                 values of the state), C/L history currents, the T-line
                 delayed-wave EMFs                                -> I_static
- per Newton iteration: MOS/JFET/diode/BJT/switch/B linearization -> scatter
                 (and under MOSCAP=CHARGE the charge rows: ``mosq_linearize``)

Ground is the dump slot N of an (N+1)-sized system.  Parameters, x and the
transient state may carry leading lane axes; the index patterns are shared.
Scatter-adds are ``index_add_`` on the flattened (N+1)^2 matrix, one launch
per occurrence rank of a position (``ScatterPlan``), so a CUDA run sums
every element's stamps in the same order as the CPU and is bit for bit
repeatable; the per-timestep RHS and the state read are one-hot matmuls
(exact: keep TF32 off).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ir.lower import LoweredCircuit
from ..models import sources as srcmod
from ..models.bjt import bjt_stamp_vals
from ..models.diode import diode_stamp_vals
from ..models.moscap import charge_jacobian, charges_of_x
from ..models.mosfet import mos_stamp_vals
from ..models.switch import switch_stamp_vals
from ..utils import prng
from ..utils.expr import eval_tape
from ..utils.options import SolverOptions
from ..utils.shapes import broadcast_shapes

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


class ScatterPlan:
    """``index_add_`` of values at fixed positions, the k-th occurrence of
    every position in the k-th launch.  CUDA's ``index_add_`` adds with
    atomics in no fixed order, so a position stamped more than once can
    take other bits from run to run; with one add per element a launch is
    exact, and every element sums its values in their given order, as the
    CPU's sequential ``index_add_`` does (the CPU's bits are unchanged).
    Positions that occur once take one launch, as before.  Entries at
    ``size`` or past it (an RHS's ground slot) are left out."""

    def __init__(self, flat, device, size=None):
        flat = np.asarray(flat, np.int64).ravel()
        self.sel = None
        if size is not None and np.any(flat >= size):
            kept = np.flatnonzero(flat < size)
            self.sel = torch.as_tensor(kept, device=device)
            flat = flat[kept]
        n = len(flat)
        order = np.argsort(flat, kind="stable")
        srt = flat[order]
        start = np.r_[0, np.flatnonzero(srt[1:] != srt[:-1]) + 1] \
            if n else np.zeros(0, np.int64)
        group = np.cumsum(np.r_[0, srt[1:] != srt[:-1]]) if n else start
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n) - start[group]
        self.idx = torch.as_tensor(flat, device=device)
        self.layers = None
        if n and rank.max() > 0:
            perm = np.lexsort((np.arange(n), rank))     # by rank, in order
            counts = np.bincount(rank)
            offs = np.r_[0, np.cumsum(counts)[:-1]]
            self.layers = [(torch.as_tensor(flat[perm[o:o + c]],
                                            device=device), int(o), int(c))
                           for o, c in zip(offs, counts)]
            if self.sel is not None:
                perm = kept[perm]
                self.sel = None
            self.perm = torch.as_tensor(perm, device=device)

    def add_(self, target, vals):
        """target (..., M) += vals (..., n) at the positions; in place."""
        if self.layers is None:
            if self.sel is not None:
                vals = vals.index_select(-1, self.sel)
            return target.index_add_(-1, self.idx, vals)
        v = vals.index_select(-1, self.perm)
        for idx, off, cnt in self.layers:
            target.index_add_(-1, idx, v.narrow(-1, off, cnt))
        return target


DC_SOLVERS = ("lu", "gs", "tridiag", "blockband")
# the largest N x (RHS terms) assembled by one-hot matmuls (the JAX
# Engine's bar); above it the Engine scatters and gathers
MATMUL_HOTPATH_BAR = 2_000_000
TRAN_SOLVERS = ("woodbury", "lu", "tridiag", "blockband", "blockwb")


def check_supported(low: LoweredCircuit, opts: SolverOptions) -> None:
    """Raise ValueError on an option value the engine does not know (the
    JAX package's words and choices, ``utils/options.py``)."""
    if opts.mos_cap_model not in ("fixed", "charge"):
        raise ValueError(f"unknown mos_cap_model {opts.mos_cap_model!r} "
                         "(fixed|charge)")
    if opts.dc_solver not in DC_SOLVERS:
        raise ValueError(f"unknown dc_solver {opts.dc_solver!r} "
                         f"({'|'.join(DC_SOLVERS)})")
    if opts.tran_solver not in TRAN_SOLVERS:
        raise ValueError(f"unknown tran_solver {opts.tran_solver!r} "
                         f"({'|'.join(TRAN_SOLVERS)})")
    if opts.tran_method not in ("be", "trap"):
        raise ValueError(f"unknown tran_method {opts.tran_method!r} "
                         "(be|trap)")


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
            return ScatterPlan(np.asarray(rows, np.int64) * (N + 1)
                               + np.asarray(cols, np.int64), dev)

        def rhs(rows):
            """An RHS plan: no solve reads the ground's slot I[N], which
            every grounded device would stamp at a launch per device."""
            return ScatterPlan(rows, dev, size=N)

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

        # ---- transmission lines (Branin / method of characteristics): each
        # port is a Thevenin branch V(p) - V(n) - Z0 i = E, E the delayed
        # wave of the OTHER port; two branch unknowns per line.  At DC the
        # line is a short: V1 = V2 and i1 = -i2
        nT = self.n_tl = len(t.tl_k1)
        # KCL couplings (DC and transient): the port current leaves p
        self.tl_kcl_rows = np.stack(
            [t.tl_ep1, t.tl_em1, t.tl_ep2, t.tl_em2], 1).ravel().astype(np.int64)
        self.tl_kcl_cols = np.stack(
            [t.tl_k1, t.tl_k1, t.tl_k2, t.tl_k2], 1).ravel().astype(np.int64)
        self.tl_kcl_vals = torch.as_tensor(
            np.tile(np.array([1.0, -1.0, 1.0, -1.0]), nT), dtype=dt_,
            device=dev)
        # transient branch rows (k1: p1, n1, k1) (k2: p2, n2, k2)
        self.tl_tran_rows = np.stack(
            [t.tl_k1, t.tl_k1, t.tl_k1, t.tl_k2, t.tl_k2, t.tl_k2],
            1).ravel().astype(np.int64)
        self.tl_tran_cols = np.stack(
            [t.tl_ep1, t.tl_em1, t.tl_k1, t.tl_ep2, t.tl_em2, t.tl_k2],
            1).ravel().astype(np.int64)
        # DC branch rows: k1: V(p1) - V(n1) - V(p2) + V(n2) = 0; k2: i1 + i2 = 0
        self.tl_dc_rows = np.stack(
            [t.tl_k1, t.tl_k1, t.tl_k1, t.tl_k1, t.tl_k2, t.tl_k2],
            1).ravel().astype(np.int64)
        self.tl_dc_cols = np.stack(
            [t.tl_ep1, t.tl_em1, t.tl_ep2, t.tl_em2, t.tl_k1, t.tl_k2],
            1).ravel().astype(np.int64)
        self.tl_dc_vals = torch.as_tensor(
            np.tile(np.array([1.0, -1.0, -1.0, 1.0, 1.0, 1.0]), nT),
            dtype=dt_, device=dev)
        # AC: the delayed other-port columns of the branch rows
        self._tl_other_cols = np.stack(
            [t.tl_ep2, t.tl_em2, t.tl_k2, t.tl_ep1, t.tl_em1, t.tl_k1],
            1).ravel().astype(np.int64)
        self._tl_idx = tuple(idx(a) for a in (t.tl_ep1, t.tl_em1, t.tl_k1,
                                              t.tl_ep2, t.tl_em2, t.tl_k2))
        self._dc_flat = flat(
            np.concatenate([self.res_rows, self.dc_const_rows,
                            self.tl_kcl_rows, self.tl_dc_rows,
                            self.b_static_rows, self.ctrl_rows]),
            np.concatenate([self.res_cols, self.dc_const_cols,
                            self.tl_kcl_cols, self.tl_dc_cols,
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
            self._mq_rhs = rhs(self.mq_rhs_rows)

        # ---- mutual inductance (K): branch-row cross terms, row k_a gets
        # -M/dt at column k_b and vice versa (the BE companion of
        # v_a = L_a di_a/dt + M di_b/dt); the history currents gather il at
        # the coupled inductors and scatter through one-hot selectors
        nK = len(t.mut_a)
        ka, kb = t.ind_k[t.mut_a], t.ind_k[t.mut_b]
        self.mut_rows = np.concatenate([ka, kb]).astype(np.int64)
        self.mut_cols = np.concatenate([kb, ka]).astype(np.int64)
        self._mut_a, self._mut_b = idx(t.mut_a), idx(t.mut_b)
        nL = len(t.ind_k)
        sel_a, sel_b = np.zeros((nK, nL)), np.zeros((nK, nL))
        sel_a[np.arange(nK), t.mut_a] = 1.0
        sel_b[np.arange(nK), t.mut_b] = 1.0
        self.mut_sel_a = torch.as_tensor(sel_a, dtype=dt_, device=dev)
        self.mut_sel_b = torch.as_tensor(sel_b, dtype=dt_, device=dev)
        self._tran_flat = flat(*self._tran_pattern())

        def any_nz(key):
            return bool(np.any(np.asarray(low.params[key].cpu())))

        # static flags: an optional term no device uses stays structurally
        # absent from the stamp math
        self.mos_body = any_nz("mos_gamma")
        self.res_tc = any_nz("res_tc1") or any_nz("res_tc2")
        self.bjt_early = any_nz("bjt_vaf")
        self.dio_bv = any_nz("dio_bv")
        # TRNOISE(na nt [alpha namp]) on V and I sources: static flags (the
        # noise amplitudes are no Monte-Carlo knobs) and the sources that
        # carry noise, white (na > 0) or flicker (namp > 0)
        tnv = np.asarray(low.params["vs_tn"].cpu()).reshape(-1, 4)
        tni = np.asarray(low.params["is_tn"].cpu()).reshape(-1, 4)
        self.vs_flicker = bool(np.any(tnv[:, 3] > 0))
        self.is_flicker = bool(np.any(tni[:, 3] > 0))
        self.vs_noisy = np.where((tnv[:, 0] > 0) | (tnv[:, 3] > 0))[0]
        self.is_noisy = np.where((tni[:, 0] > 0) | (tni[:, 3] > 0))[0]
        self.has_trnoise = bool(len(self.vs_noisy) or len(self.is_noisy))
        self._vs_noisy, self._is_noisy = idx(self.vs_noisy), idx(self.is_noisy)

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
        self._nl_rhs = rhs(self.nl_rhs_rows)
        self._gmin_flat = flat(t.node_eqs, t.node_eqs)
        self._vs_k = rhs(t.vs_k)
        self.is_rhs_rows = np.stack([t.is_ep, t.is_em], 1).ravel()
        self._is_rhs = rhs(self.is_rhs_rows)
        self._mos_term = (idx(t.mos_ed), idx(t.mos_eg), idx(t.mos_es))
        self._jf_term = (idx(t.jf_ed), idx(t.jf_eg), idx(t.jf_es))
        self._dio_term = (idx(t.dio_ep), idx(t.dio_em))
        self._bjt_term = (idx(t.bjt_ec), idx(t.bjt_eb), idx(t.bjt_ee))
        self._sw_term = (idx(t.sw_ep), idx(t.sw_em), idx(t.sw_ecp),
                         idx(t.sw_ecm))

        # ---- one-hot hot-path operators ----
        #   RHS assembly:  I = [vval | ival | vhist | cap_hist | E1 | E2] @ rhs_mat
        #   state read:    [vc | il | vl] = x @ state_mat
        # The matmuls are O(N nterms) a step: a large circuit (N nterms above
        # MATMUL_HOTPATH_BAR) scatters the terms and gathers the state at
        # static indices instead.
        ncap = self.n_caplike
        nterms = nV + nI + nL + ncap + 2 * nT
        self.use_matmul_hotpath = N * max(nterms, 1) <= MATMUL_HOTPATH_BAR
        # (row, term, sign) of every RHS term, ground rows dropped
        off_c, off_t = nV + nI + nL, nV + nI + nL + ncap
        rhs_row = np.concatenate([t.vs_k, t.is_ep, t.is_em, t.ind_k,
                                  self.cap_a, self.cap_b, t.tl_k1, t.tl_k2])
        rhs_term = np.concatenate([
            np.arange(nV), nV + np.arange(nI), nV + np.arange(nI),
            nV + nI + np.arange(nL), off_c + np.arange(ncap),
            off_c + np.arange(ncap), off_t + np.arange(nT),
            off_t + nT + np.arange(nT)]).astype(np.int64)
        rhs_sign = np.concatenate([
            np.ones(nV), -np.ones(nI), np.ones(nI), np.ones(nL),
            np.ones(ncap), -np.ones(ncap), np.ones(2 * nT)])
        real = rhs_row < N
        rhs_row, rhs_term, rhs_sign = (rhs_row[real].astype(np.int64),
                                       rhs_term[real], rhs_sign[real])
        if self.use_matmul_hotpath:
            M = np.zeros((N, nterms))
            np.add.at(M, (rhs_row, rhs_term), rhs_sign)
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
        else:
            self.rhs_mat = self.state_mat = None
            self._rhs_term = idx(rhs_term)
            self._rhs_sign = torch.as_tensor(rhs_sign, dtype=dt_, device=dev)
            self._rhs_plan = rhs(rhs_row)
            self._state_idx = tuple(idx(a) for a in (
                self.cap_a, self.cap_b, t.ind_k, t.ind_ep, t.ind_em))
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

    def tl_ticks(self, dt) -> np.ndarray:
        """Per-line delay in timesteps, max(1, rint(TD / dt)), on the host in
        float64 from ``float(dt)``: pass the Python float of the timestep
        (an f32 tensor would shift a delay that sits near a half step)."""
        td = np.asarray(self.topo.tl_td_s, dtype=float)
        return np.maximum(1, np.rint(td / float(dt)).astype(int))

    def _tl_wave_now(self, params, x):
        """w = V(p) - V(n) + Z0 i of both ports: (..., 2 nT) as
        [w1 of every line, w2 of every line]."""
        ep1, em1, k1, ep2, em2, k2 = self._tl_idx
        xe = self.x_ext(x)
        z0 = params["tl_z0"]
        w1 = xe[..., ep1] - xe[..., em1] + z0 * x[..., k1]
        w2 = xe[..., ep2] - xe[..., em2] + z0 * x[..., k2]
        return torch.cat([w1, w2], dim=-1)

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
        lead = broadcast_shapes(*(p.shape[:-1] for p in parts))
        return torch.cat([p.expand(lead + p.shape[-1:]) for p in parts],
                         dim=-1)

    def _mutual_M(self, params):
        """M = k sqrt(L_a L_b) per K element, from the live ``ind_l``: a
        Monte-Carlo or .STEP lane that perturbs an inductor keeps its
        coupling consistent."""
        L = params["ind_l"]
        return params["mut_k"] * torch.sqrt(L[..., self._mut_a]
                                             * L[..., self._mut_b])

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
        lead = broadcast_shapes(*(p.shape[:-1] for p in parts))
        return torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], -1)

    def _zeros_G(self, lead):
        return torch.zeros(lead + ((self.N + 1) ** 2,), dtype=self.dtype,
                           device=self.device)

    def _zeros_I(self, lead):
        return torch.zeros(lead + (self.N + 1,), dtype=self.dtype,
                           device=self.device)

    @staticmethod
    def add_rhs(I_s, plan, vals):
        """A copy of I_s (..., N+1) plus ``vals`` at ``plan``'s rows,
        broadcast over the lanes of both."""
        lead = broadcast_shapes(I_s.shape[:-1], vals.shape[:-1])
        I = I_s.expand(lead + I_s.shape[-1:]).clone()
        plan.add_(I, vals.expand(lead + vals.shape[-1:]))
        return I

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
        lead = broadcast_shapes(*(g.shape[:-1] for g in gv))
        return (torch.cat([g.expand(lead + g.shape[-1:]) for g in gv], -1),
                torch.cat([r.expand(lead + r.shape[-1:]) for r in rv], -1))

    # ------------------------------------------------------------------
    # DC assembly
    # ------------------------------------------------------------------
    def dc_static_entries(self, params):
        """Static COO entries of the DC matrix: (rows, cols, vals)."""
        rvals = self._res_vals(params)
        cvals = self._ctrl_vals(params)
        lead = broadcast_shapes(rvals.shape[:-1], cvals.shape[:-1])
        const = torch.cat([self.dc_const_vals, self.tl_kcl_vals,
                           self.tl_dc_vals, self.b_static_vals])
        rows = np.concatenate([self.res_rows, self.dc_const_rows,
                               self.tl_kcl_rows, self.tl_dc_rows,
                               self.b_static_rows, self.ctrl_rows])
        cols = np.concatenate([self.res_cols, self.dc_const_cols,
                               self.tl_kcl_cols, self.tl_dc_cols,
                               self.b_static_cols, self.ctrl_cols])
        return rows, cols, torch.cat([rvals.expand(lead + rvals.shape[-1:]),
                                      const.expand(lead + const.shape),
                                      cvals.expand(lead + cvals.shape[-1:])],
                                     dim=-1)

    def dc_rhs(self, params, scale):
        """DC RHS: V/I source values at the ramp scale."""
        vval = srcmod.eval_dc(params["vs_dc"], params["vs_kind"],
                              params["vs_sin"], scale, pulse=params["vs_pulse"])
        ival = srcmod.eval_dc(params["is_dc"], params["is_kind"],
                              params["is_sin"], scale, pulse=params["is_pulse"])
        lead = broadcast_shapes(vval.shape[:-1], ival.shape[:-1])
        I = self._zeros_I(lead)
        self._vs_k.add_(I, vval.expand(lead + vval.shape[-1:]))
        irhs = torch.stack([-ival, ival], dim=-1).flatten(-2)
        self._is_rhs.add_(I, irhs.expand(lead + irhs.shape[-1:]))
        return I

    def dc_static(self, params, scale):
        """G/I parts constant across the Newton iterations of a ramp step."""
        _, _, vals = self.dc_static_entries(params)
        Gf = self._zeros_G(vals.shape[:-1])
        self._dc_flat.add_(Gf, vals)
        return self._as_matrix(Gf), self.dc_rhs(params, scale)

    def assemble_dc_iter(self, G_static, I_static, params, x, gmin):
        """Add the device linearization and the adaptive gmin diagonal."""
        gvals, rvals = self._nl_vals(params, x)
        lead = broadcast_shapes(G_static.shape[:-2], gvals.shape[:-1])
        Gf = G_static.reshape(G_static.shape[:-2] + (-1,))
        Gf = Gf.expand(lead + Gf.shape[-1:]).clone()
        self._nl_flat.add_(Gf, gvals.expand(lead + gvals.shape[-1:]))
        gm = self._scalar(gmin)[..., None].expand(
            lead + (len(self.topo.node_eqs),))
        self._gmin_flat.add_(Gf, gm)
        I = self.add_rhs(I_static, self._nl_rhs,
                         rvals.expand(lead + rvals.shape[-1:]))
        return self._as_matrix(Gf), I

    # ------------------------------------------------------------------
    # Transient assembly (Backward Euler companions, tanalisis.cpp:255-356;
    # method "trap": the trapezoidal companions, twice the conductances)
    # ------------------------------------------------------------------
    def _tran_pattern(self):
        """(rows, cols) of ``tran_static_entries``."""
        t, nV = self.topo, len(self.topo.vs_ep)
        rows = np.concatenate([self.res_rows, self.dc_const_rows[:4 * nV],
                               self.ind_rows, self.mut_rows, self.cap_rows,
                               t.node_eqs, self.ctrl_rows, self.tl_kcl_rows,
                               self.tl_tran_rows, self.b_static_rows])
        cols = np.concatenate([self.res_cols, self.dc_const_cols[:4 * nV],
                               self.ind_cols, self.mut_cols, self.cap_cols,
                               t.node_eqs,
                               self.ctrl_cols, self.tl_kcl_cols,
                               self.tl_tran_cols, self.b_static_cols])
        return rows, cols

    def tran_static_entries(self, params, dt, gmin, method: str = "be"):
        """Static COO entries of the transient matrix: R, V couplings, L and
        C/MOS-cap companions (BE: G_C = C/dt, R_L = L/dt; trap: G_C =
        2C/dt, R_L = 2L/dt), the K cross terms (-M/dt, trap -2M/dt), gmin,
        E/G/F/H, the T-line KCL couplings and Thevenin branch rows (+1, -1,
        -Z0 per port), the B V-form couplings."""
        fac = 2.0 if method == "trap" else 1.0
        rvals = self._res_vals(params)
        cvals = self._ctrl_vals(params)
        lead = broadcast_shapes(rvals.shape[:-1], cvals.shape[:-1])
        nV = len(self.topo.vs_ep)
        vs_vals = self.dc_const_vals[:4 * nV]
        L = params["ind_l"]
        lmask = L > 0.0
        ones = torch.ones_like(L)
        pat = torch.stack([ones, -ones, ones, -ones], dim=-1)
        pat = (pat * lmask[..., None]).flatten(-2)
        diag = torch.where(lmask, -fac * L / dt, 0.0)
        ind_vals = torch.cat([pat, diag], dim=-1)
        mv = -fac * self._mutual_M(params) / dt
        mut_vals = torch.cat([mv, mv], dim=-1)
        C = self._caplike_C(params)
        gc = torch.where(C > 0.0, fac * C / dt, 0.0)
        cap_vals = _two_terminal_vals(gc)
        gm = self._scalar(gmin)[..., None].expand(
            lead + (len(self.topo.node_eqs),))
        z0 = params["tl_z0"]
        o = torch.ones_like(z0)
        tl_branch = torch.stack([o, -o, -z0, o, -o, -z0], dim=-1).flatten(-2)
        rows, cols = self._tran_pattern()
        parts = [rvals, vs_vals, ind_vals, mut_vals, cap_vals, gm, cvals,
                 self.tl_kcl_vals, tl_branch, self.b_static_vals]
        lead = broadcast_shapes(lead, *(p.shape[:-1] for p in parts))
        vals = torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], -1)
        return rows, cols, vals

    def tran_static_G(self, params, dt, gmin, method: str = "be"):
        """The whole transient matrix except the nonlinear devices' entries:
        constant for the entire transient (fixed dt, fixed gmin)."""
        _, _, vals = self.tran_static_entries(params, dt, gmin, method)
        Gf = self._zeros_G(vals.shape[:-1])
        self._tran_flat.add_(Gf, vals)
        return self._as_matrix(Gf)

    def make_tran_static_I(self, dt, method: str = "be"):
        """f(params, state, t) -> (..., N+1) RHS of one timestep: sources
        at t plus history currents, as one one-hot matmul.

            BE    cap:  I(a) += (C/dt) v_prev,    L: I(k) += -(L/dt) i_prev
            trap  cap:  I(a) += (2C/dt) v_prev + i_prev
                  L:    I(k) += -(2L/dt) i_prev - v_prev
            K:    I(k_a) += -(M/dt) i_b_prev, I(k_b) += -(M/dt) i_a_prev
                  (2M/dt under trap)
            T:    I(k1) += E1 = w2 of ticks steps ago, I(k2) += E2 = w1

        ``dt`` is the timestep as a Python float (the T-line delays are
        counted in steps from it, ``tl_ticks``) or a tensor (one per lane,
        (B, 1), on the adaptive ladder)."""
        trap = method == "trap"
        fac = 2.0 if trap else 1.0
        nT, nK = self.n_tl, len(self.topo.mut_a)
        if nT:
            dev = self.device
            tl_read = torch.as_tensor(self.tl_ticks(dt) - 1, device=dev)
            tl_cols1 = torch.arange(nT, 2 * nT, device=dev)   # E1 <- w2
            tl_cols2 = torch.arange(0, nT, device=dev)        # E2 <- w1
        dt = self._scalar(dt)

        def f(params, state, t):
            vval = srcmod.eval_tran_masked(
                self._vs_masks, params["vs_dc"], params["vs_pulse"],
                params["vs_sin"], params["vs_pwl_t"], params["vs_pwl_v"],
                params["vs_pwl_n"], t)
            ival = srcmod.eval_tran_masked(
                self._is_masks, params["is_dc"], params["is_pulse"],
                params["is_sin"], params["is_pwl_t"], params["is_pwl_v"],
                params["is_pwl_n"], t)
            if "tn_v" in state:     # this step's TRNOISE values
                vval = vval + state["tn_v"]
                ival = ival + state["tn_i"]
            L = params["ind_l"]
            C = self._caplike_C(params)
            if trap:
                vhist = torch.where(
                    L > 0.0, -(2.0 * L / dt) * state["il"] - state["vl"],
                    0.0)
                gc = torch.where(C > 0.0, 2.0 * C / dt, 0.0)
                h = gc * state["vc"] + torch.where(C > 0.0, state["ic"], 0.0)
            else:
                vhist = torch.where(L > 0.0, -(L / dt) * state["il"], 0.0)
                gc = torch.where(C > 0.0, C / dt, 0.0)
                h = gc * state["vc"]
            if nK:
                il = state["il"]
                coef = -(fac / dt) * self._mutual_M(params)
                vhist = (vhist
                         + (coef * il[..., self._mut_b]) @ self.mut_sel_a
                         + (coef * il[..., self._mut_a]) @ self.mut_sel_b)
            parts = [vval, ival, vhist, h]
            if nT:
                # the ring (..., Dmax, 2 nT): slot d is the wave d + 1 steps
                # before the step being computed
                ring = state["tlw"]
                parts += [ring[..., tl_read, tl_cols1],
                          ring[..., tl_read, tl_cols2]]
            lead = broadcast_shapes(*(p.shape[:-1] for p in parts))
            terms = torch.cat([p.expand(lead + p.shape[-1:]) for p in parts],
                              dim=-1)
            if self.rhs_mat is None:
                I = terms.new_zeros(lead + (self.N + 1,))
                return self._rhs_plan.add_(
                    I, terms.index_select(-1, self._rhs_term)
                    * self._rhs_sign)
            I = terms @ self.rhs_mat
            return torch.cat([I, torch.zeros_like(I[..., :1])], dim=-1)

        return f

    def mos_vdgs(self, x):
        """Per-MOS terminal voltages (..., nM, 3) ordered (vd, vg, vs)."""
        xe = self.x_ext(x)
        return torch.stack([xe[..., i] for i in self._mos_term], dim=-1)

    def mosq_linearize(self, params, vdgs, qprev, inv_dt, iprev=None):
        """Companion of the charge currents i = dq/dt: (g (..., nM, 5, 3),
        cst (..., nM, 5)) with i ~= g (vd, vg, vs) + cst; qprev (..., nM,
        5) are the accepted charges of the previous step.
        BE (iprev None): g = (dq/dv)/dt, cst = (q(v) - q_prev)/dt - g v.
        Trapezoidal (iprev: the accepted charge currents of the previous
        step, i' = 2(q' - q)/dt - i): g = 2(dq/dv)/dt,
        cst = 2(q(v) - q_prev)/dt - g v - i_prev."""
        q, J = charge_jacobian(vdgs, params)
        if iprev is None:
            g = J * inv_dt
            return g, (q - qprev) * inv_dt - (g * vdgs[..., None, :]).sum(-1)
        g = 2.0 * J * inv_dt
        cst = 2.0 * (q - qprev) * inv_dt - (g * vdgs[..., None, :]).sum(-1)
        return g, cst - iprev

    def assemble_tran_iter(self, G_static, I_static, params, x, t=0.0,
                           qex=None):
        """Dense system of one Newton iteration: the static G and RHS
        (both (..., N+1, ...)) plus the device linearisation at x; qex =
        (qprev, inv_dt), or (qprev, inv_dt, iprev) under trap, adds the 15
        Jacobian and 5 RHS entries per MOS of the charge model."""
        gvals, rvals = self._nl_vals(params, x, t)
        lead = broadcast_shapes(G_static.shape[:-2], gvals.shape[:-1])
        Gf = G_static.reshape(G_static.shape[:-2] + (-1,))
        Gf = Gf.expand(lead + Gf.shape[-1:]).clone()
        self._nl_flat.add_(Gf, gvals.expand(lead + gvals.shape[-1:]))
        I = self.add_rhs(I_static, self._nl_rhs,
                         rvals.expand(lead + rvals.shape[-1:]))
        if qex is not None:
            gq, cq = self.mosq_linearize(params, self.mos_vdgs(x), *qex)
            gq, cq = gq.flatten(-3), -cq.flatten(-2)
            self._mq_flat.add_(Gf, gq.expand(lead + gq.shape[-1:]))
            self._mq_rhs.add_(I, cq.expand(lead + cq.shape[-1:]))
        return self._as_matrix(Gf), I

    # ------------------------------------------------------------------
    # Transient state
    # ------------------------------------------------------------------
    def _state_parts(self, x):
        """(cap-like voltage diffs, inductor currents, inductor voltages)."""
        ncap = self.n_caplike
        nL = len(self.topo.ind_k)
        if self.state_mat is None:
            ca, cb, k, ep, em = self._state_idx
            xe = self.x_ext(x)
            return (xe[..., ca] - xe[..., cb], x[..., k],
                    xe[..., ep] - xe[..., em])
        s = x @ self.state_mat
        return s[..., :ncap], s[..., ncap:ncap + nL], s[..., ncap + nL:]

    # ------------------------------------------------------------------
    # TRNOISE: transient source noise, the realisation of the JAX Engine
    # ------------------------------------------------------------------
    FLICKER_M = 16     # octave-spaced AR(1) bank depth (covers 2^16 steps)

    def _key(self, key):
        """Key data on the engine's device (a key made on the host works)."""
        return torch.as_tensor(key, device=self.device)

    def _source_keys(self, key, salt: int, src):
        """fold_in(fold_in(key, salt), s) of each source index s in src:
        (..., len(src), 2), the key of every white draw of the source."""
        src = torch.as_tensor(src, dtype=torch.int64, device=self.device)
        return prng.fold_in(prng.fold_in(self._key(key), salt)[..., None, :],
                            src)

    def _draw(self, tn, ks, step, dt):
        """na N(0, 1) at the hold index of ``step`` under source keys ks
        (..., ns, 2); tn (..., ns, 4) the rows of those sources."""
        na, nt = tn[..., 0], tn[..., 1]
        s = torch.as_tensor(step, device=self.device)
        step_f = s.to(self.dtype).reshape(
            s.shape + (1,) * max(na.dim(), ks.dim() - 1))
        j = torch.where(nt > 0, torch.floor(step_f * self._scalar(dt)
                                            / torch.clamp_min(nt, 1e-30)),
                        step_f).to(torch.int64)
        return na * prng.normal(prng.fold_in(ks, j), (), self.dtype)

    def trnoise_draw(self, tn, key, salt: int, step, dt):
        """White-noise values of the sources for solver step ``step``
        (1-based, t = step dt): na_s N(0, 1) drawn at the hold index
        j_s = floor(step dt / nt_s) (nt = 0: a new draw every step), keyed
        by (key, salt, source index s, j), so a realisation is reproducible
        and constant within a hold window.  The draws are JAX's
        ``Engine.trnoise_draw``'s (``utils/prng.py``); j is computed in the
        engine's dtype as JAX computes it, step dt first, then divided by
        max(nt, 1e-30).

        tn (..., nS, 4); key (..., 2): one key (2,) gives every lane of a
        batched tn the same realisation, keys (B, 2) one each.  ``step`` is
        an int or a 1-D tensor of n steps (a leading axis n in the
        result)."""
        src = torch.arange(tn.shape[-2], device=self.device)
        return self._draw(tn, self._source_keys(key, salt, src), step, dt)

    def _white(self, tn, ks, noisy, step, dt):
        """The white draws of every source under the noisy sources' keys ks
        (elsewhere na = 0 and the value is 0)."""
        vals = self._draw(tn[..., noisy, :], ks, step, dt)
        out = vals.new_zeros(vals.shape[:-1] + (tn.shape[-2],))
        out[..., noisy] = vals
        return out

    def _flicker_coefs(self, tn, dt):
        """Sum-of-Lorentzians 1/f^alpha synthesis: M octave-spaced AR(1)
        processes with corner rates f_m = f_Nyq / 2^(m+1) and per-octave
        variances w_m^2 ~ f_m^(1 - alpha), normalised so the summed process
        has RMS namp.  Returns (b (M,), g (..., nS, M)): the per-step pole
        and the stationary standard deviation of each state."""
        alpha, namp = tn[..., 2], tn[..., 3]
        dt = self._scalar(dt)
        m = torch.arange(self.FLICKER_M, dtype=self.dtype, device=self.device)
        f = torch.reciprocal(2.0 * dt) / torch.exp2(m + 1.0)
        b = torch.exp(-2.0 * math.pi * f * dt)
        w2 = f ** (1.0 - alpha[..., None])
        w2 = w2 / w2.sum(-1, keepdim=True)
        return b, namp[..., None] * torch.sqrt(w2)

    @staticmethod
    def _bank_shape(g, key):
        """The shape one key draws for an AR(1) bank g (..., nS, M): what
        follows the key's lane axes (JAX draws g.shape under each key)."""
        return g.shape[min(key.dim() - 1, g.dim() - 2):]

    def _flicker_start(self, tn, base, dt):
        _, g = self._flicker_coefs(tn, dt)
        return g * prng.normal(base, self._bank_shape(g, base), self.dtype)

    def _flicker_next(self, tn, base, step, dt, x):
        b, g = self._flicker_coefs(tn, dt)
        xi = prng.normal(prng.fold_in(base, step), self._bank_shape(x, base),
                         self.dtype)
        return b * x + g * torch.sqrt(1.0 - b * b) * xi

    def flicker_init(self, tn, key, salt: int, dt):
        """Stationary start of the AR(1) bank: x_m ~ N(0, g_m^2)."""
        return self._flicker_start(tn, prng.fold_in(self._key(key), salt), dt)

    def flicker_step(self, tn, key, salt: int, step, dt, x):
        """Advance the AR(1) bank one step: x' = b x + g sqrt(1 - b^2) xi,
        xi keyed by (key, salt, step)."""
        return self._flicker_next(tn, prng.fold_in(self._key(key), salt), step,
                                  dt, x)

    def _flicker_run(self, tn, base, step0, n_steps, dt, x):
        """The bank through steps step0 + 1 .. step0 + n: (its state after
        the last, (n, ..., nS) sums of the states entering each step).
        Step 1 takes the stationary draw; every other step is
        ``flicker_step``'s arithmetic, its normals drawn for a block of
        steps at a time (about 2^22 per block)."""
        b, g = self._flicker_coefs(tn, dt)
        c = g * torch.sqrt(1.0 - b * b)
        if x is None:
            x = torch.zeros_like(g)
        shape = self._bank_shape(x, base)
        per = max(1, (1 << 22) // max(1, x.numel()))
        sums = []
        for s0 in range(0, n_steps, per):
            ss = step0 + 1 + torch.arange(s0, min(n_steps, s0 + per),
                                          device=self.device)
            xi = prng.normal(prng.fold_in(
                base, ss.reshape(ss.shape + (1,) * (base.dim() - 1))),
                shape, self.dtype)
            for r, s in enumerate(ss.tolist()):
                x = (self._flicker_start(tn, base, dt) if s == 1
                     else b * x + c * xi[r])
                sums.append(x.sum(-1))
        return x, torch.stack(sums)

    def _noise_keys(self, key):
        """The keys every step of a noisy run folds its step into: the
        noisy V and I sources' white keys, the V and I flicker bases."""
        key = self._key(key)
        return {"tn_key": key,
                "tn_kv": self._source_keys(key, 0, self._vs_noisy),
                "tn_ki": self._source_keys(key, 1, self._is_noisy),
                "tn_bv": prng.fold_in(key, 4), "tn_bi": prng.fold_in(key, 5)}

    def trnoise_stream(self, params, key, step0: int, n_steps: int, dt,
                       fv=None, fi=None):
        """TRNOISE values of the sources for solver steps step0 + 1 ..
        step0 + n_steps in one batched draw, element [i] equal to the
        tn_v / tn_i the per-step state carries into step step0 + 1 + i
        (``init_state`` / ``make_update_state``), bit for bit: the fused
        chunk's input (JAX ``Engine.trnoise_stream``).

        fv / fi: the flicker banks (..., nS, M) as of step step0; None (or
        zeros) at step0 = 0, where step 1 takes the stationary draw.
        Returns (tnv (n, ..., nSv), tni (n, ..., nSi), fv', fi'), the banks
        after the last step (None without flicker) for the next chunk."""
        k = self._noise_keys(key)
        steps = step0 + 1 + torch.arange(n_steps, device=self.device)
        tnv = self._white(params["vs_tn"], k["tn_kv"], self._vs_noisy, steps,
                          dt)
        tni = self._white(params["is_tn"], k["tn_ki"], self._is_noisy, steps,
                          dt)
        if self.vs_flicker:
            fv, sums = self._flicker_run(params["vs_tn"], k["tn_bv"], step0,
                                         n_steps, dt, fv)
            tnv = tnv + sums
        if self.is_flicker:
            fi, sums = self._flicker_run(params["is_tn"], k["tn_bi"], step0,
                                         n_steps, dt, fi)
            tni = tni + sums
        return (tnv, tni, fv if self.vs_flicker else None,
                fi if self.is_flicker else None)

    def _noise_state(self, params, keys, step, dt, prev=None):
        """The state's noise entries for step ``step``: the keys, tn_v and
        tn_i (with flicker, plus the bank's sum) and the flicker banks tn_fv
        / tn_fi, from the stationary draw at step 1, else advanced from
        ``prev``."""
        st = dict(keys, tn_step=step)
        st["tn_v"] = self._white(params["vs_tn"], keys["tn_kv"],
                                 self._vs_noisy, step, dt)
        st["tn_i"] = self._white(params["is_tn"], keys["tn_ki"],
                                 self._is_noisy, step, dt)
        for flick, tv, tn, base, bank in (
                (self.vs_flicker, "tn_v", "vs_tn", "tn_bv", "tn_fv"),
                (self.is_flicker, "tn_i", "is_tn", "tn_bi", "tn_fi")):
            if flick:
                st[bank] = (self._flicker_start(params[tn], keys[base], dt)
                            if prev is None else
                            self._flicker_next(params[tn], keys[base], step,
                                               dt, prev[bank]))
                st[tv] = st[tv] + st[bank].sum(-1)
        return st

    def init_state(self, x, params=None, dt=None, noise_key=None):
        """TranState from a DC solution (tanalisis.cpp:139-180); x may carry
        leading lane axes.  ic/vl are the trapezoidal extras (zero at DC).
        The charge model adds the MOS charges qm (..., nM, 5) at x, which
        needs ``params``, and their trapezoidal currents qi (zero at DC);
        transmission lines add the delay ring tlw
        (..., Dmax, 2 nT) filled with the DC wave, which needs ``params``
        and the timestep ``dt`` (a Python float: Dmax = max ticks).

        noise_key (a TRNOISE deck; ``utils/prng`` key data (2,), or (B, 2)
        for one realisation per lane) turns the transient noise on: the
        state then carries the key (and the keys each step folds into, tn_kv
        / tn_ki / tn_bv / tn_bi), the step counter (a Python int) and the
        source noise values tn_v / tn_i of the coming step (with flicker,
        the AR(1) banks tn_fv / tn_fi), which needs ``params`` and ``dt``.
        Without a key the run is noise-free."""
        vc, il, _ = self._state_parts(x)
        state = {"vc": vc, "ic": torch.zeros_like(vc),
                 "il": il, "vl": torch.zeros_like(il)}
        if self.mos_charge:
            if params is None:
                raise ValueError("the charge cap model needs "
                                 "init_state(x, params)")
            state["qm"] = charges_of_x(self.mos_vdgs(x), params)
            state["qi"] = torch.zeros_like(state["qm"])
        if self.n_tl:
            if params is None or dt is None:
                raise ValueError("transmission lines need init_state(x, "
                                 "params, dt): the delay ring length "
                                 "depends on dt")
            dmax = int(self.tl_ticks(dt).max())
            w = self._tl_wave_now(params, x)                  # (..., 2 nT)
            state["tlw"] = w[..., None, :].expand(
                w.shape[:-1] + (dmax, 2 * self.n_tl)).contiguous()
        if noise_key is not None and self.has_trnoise:
            if params is None or dt is None:
                raise ValueError("TRNOISE needs init_state(x, params, dt, "
                                 "noise_key)")
            state.update(self._noise_state(
                params, self._noise_keys(noise_key), 1, dt))
        return state

    def make_update_state(self, dt, method: str = "be"):
        """Post-step state update: voltages and currents of the accepted x
        (tanalisis.cpp:379-417), the charges under the charge model, the
        T-line ring (this step's waves into slot 0, the others shifted one
        slot older) and, on a noisy run, the next step's noise values.
        Trapezoidal also carries the element currents and voltages:
        i_C' = (2C/dt)(v' - v) - i_C, v_L' = V(p) - V(m), and the charge
        currents qi' = (2/dt)(q' - q) - qi; under BE they stay zero."""
        trap = method == "trap"

        def f(params, x, state):
            vc, il, vl = self._state_parts(x)
            if trap:
                C = self._caplike_C(params)
                gc2 = torch.where(C > 0.0, 2.0 * C / dt, 0.0)
                new = {"vc": vc, "ic": gc2 * (vc - state["vc"]) - state["ic"],
                       "il": il, "vl": vl}
            else:
                new = {"vc": vc, "ic": torch.zeros_like(vc),
                       "il": il, "vl": torch.zeros_like(il)}
            if self.mos_charge:
                new["qm"] = charges_of_x(self.mos_vdgs(x), params)
                new["qi"] = ((2.0 / dt) * (new["qm"] - state["qm"])
                             - state["qi"] if trap
                             else torch.zeros_like(new["qm"]))
            if self.n_tl:
                w = self._tl_wave_now(params, x)
                ring = state["tlw"]
                new["tlw"] = torch.cat([w[..., None, :], ring[..., :-1, :]],
                                       dim=-2)
            if "tn_key" in state:
                keys = {k: state[k] for k in ("tn_key", "tn_kv", "tn_ki",
                                              "tn_bv", "tn_bi")}
                new.update(self._noise_state(params, keys,
                                             state["tn_step"] + 1, dt, state))
            return new

        return f
