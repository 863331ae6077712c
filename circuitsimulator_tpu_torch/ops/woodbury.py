"""Low-rank (Woodbury) Newton solve for the transient hot loop.

Port of ``circuitsimulator_tpu/ops/woodbury.py`` for Level-1 MOS rows.
Each MOSFET's conduction stamp is a rank-one update (e_D - e_S) v^T of the
otherwise constant BE matrix G0 (fixed dt), so with G0 inverted once:

    A = G0 + U V^T,  b = b0 - U c,  Y = G0^{-1} U,  z = G0^{-1} b0 - Y c
    x = z - Y (I_k + V^T Y)^{-1} V^T z

Per Newton iteration: matvecs plus one k x k pivoted solve, which goes
through ``ops/lu.lu_solve`` (the K2 kernel on CUDA).  Terminal-voltage
reads are one-hot matmuls; rows of grounded terminals (dump index) are all
zero, which reproduces the x_ext ground convention.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.mosfet import mos_linearize
from .lu import lu_inverse, lu_solve


class WoodburyPlan:
    """Static index plan of the rank-k MOS update (W = 3: d, g, s)."""

    def __init__(self, engine):
        t = engine.topo
        self.N = engine.N
        self.nM = len(t.mos_ed)
        self.k = self.nM
        self.W = 3
        self.u_pos = t.mos_ed.astype(np.int64)
        self.u_neg = t.mos_es.astype(np.int64)
        self.mos_cols = (np.stack([t.mos_ed, t.mos_eg, t.mos_es], 1)
                         if self.nM else np.zeros((0, 3), np.int32))

    def build_U(self, dtype, device):
        """(N, k) dense U: column j = e_D - e_S (dump entries vanish)."""
        U = np.zeros((self.N + 1, self.k))
        np.add.at(U, (self.u_pos, np.arange(self.k)), 1.0)
        np.add.at(U, (self.u_neg, np.arange(self.k)), -1.0)
        return torch.as_tensor(U[: self.N], dtype=dtype, device=device)

    def col_idx(self) -> np.ndarray:
        """(k, W) column indices of the V^T coefficient rows."""
        return self.mos_cols.astype(np.int64)


class WoodburySolver:
    """Per-transient factorisation state and the per-iteration solve."""

    def __init__(self, engine, params, G0):
        """G0: (..., N, N) static BE matrix (tran_static_G without the dump
        row/column), inverted once with the pivoted LU."""
        self.engine = engine
        self.plan = plan = WoodburyPlan(engine)
        opts = engine.opts
        N, dev, dt_ = engine.N, engine.device, engine.dtype
        self.pivot_floor = opts.lu_pivot_floor
        U = plan.build_U(dt_, dev)
        self.G0inv = lu_inverse(G0, opts.lu_pivot_floor)
        self.Y = self.G0inv @ U                                 # (..., N, k)
        cols = torch.as_tensor(plan.col_idx(), device=dev)      # (k, 3)
        Y_ext = torch.cat([self.Y, torch.zeros_like(self.Y[..., :1, :])],
                          dim=-2)                               # dump row = 0
        self.Y_cols = Y_ext[..., cols, :]                       # (..., k, 3, k)
        self.eye_k = torch.eye(plan.k, dtype=dt_, device=dev)

        def onehot(idx_list):
            M = np.zeros((N, len(idx_list)))
            for j, r in enumerate(idx_list):
                if r < N:
                    M[r, j] = 1.0
            return torch.as_tensor(M, dtype=dt_, device=dev)

        self.M_mos = onehot(plan.mos_cols.ravel())               # (N, 3nM)
        self.M_cols = onehot(plan.col_idx().ravel())             # (N, 3k)

    def z0(self, b0):
        """G0^{-1} b0, once per timestep (b0 = sources + history)."""
        return (self.G0inv @ b0[..., None])[..., 0]

    def nl_coeffs(self, params, x):
        """Per-device V^T rows (..., k, 3) and Newton constants (..., k)."""
        plan = self.plan
        opts = self.engine.opts
        vm = (x @ self.M_mos).unflatten(-1, (plan.nM, 3))
        body = self.engine.mos_body
        gd, gg, gs, cst = mos_linearize(
            params["mos_vth"], params["mos_k"], params["mos_lam"],
            params["mos_p"], vm[..., 0], vm[..., 1], vm[..., 2],
            opts.mos_off_gds, opts.mos_reverse_region,
            gamma=params["mos_gamma"] if body else None,
            phi=params["mos_phi"] if body else None)
        return torch.stack([gd, gg, gs], dim=-1), cst

    def solve(self, params, x, z0):
        """One Newton linear solve: x_raw with A(x) x_raw = b(x)."""
        plan = self.plan
        if plan.k == 0:
            return z0
        vcoef, c = self.nl_coeffs(params, x)
        z = z0 - (self.Y @ c[..., None])[..., 0]
        # S = I + V^T Y: S[j, l] = sum_s vcoef[j, s] * Y[cols[j, s], l]
        S = self.eye_k + (vcoef[..., None] * self.Y_cols).sum(-2)
        zc = (z @ self.M_cols).unflatten(-1, (plan.k, plan.W))
        vz = (vcoef * zc).sum(-1)
        w = lu_solve(S, vz, self.pivot_floor)
        return z - (self.Y @ w[..., None])[..., 0]
