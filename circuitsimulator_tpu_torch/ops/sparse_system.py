"""The large-circuit linear system on the stamp entries, never a dense
matrix: one object behind the ``tridiag`` layout (``ops/banded`` +
``ops/tridiag``) and the ``blockband`` layout (``ops/blockband`` +
``ops/blockcr``), shared by the DC Newton and the transient step.

A system has a static pattern, scattered once per timestep or ramp step
(``scatter``), and the per-iteration patterns (the nonlinear devices, the
MOSCAP=CHARGE rows, the DC's gmin and .NODESET diagonals), concatenated in
their given order into one pattern whose values ``solve`` scatters onto a
static before it solves.  Each position sums its static value, then its
per-iteration values in order (``ScatterPlan``)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.shapes import broadcast_shapes


class SparseSystem:
    """kind "tridiag" or "blockband"; (rows, cols) the static pattern;
    ``patterns`` the per-iteration (rows, cols) pairs; ``algo`` the
    tridiagonal algorithm ("cr" or "pcr")."""

    def __init__(self, engine, kind: str, rows, cols, patterns=(),
                 algo: str = "cr"):
        self.engine, self.kind, self.algo = engine, kind, algo
        N, n = engine.N, engine.topo.n_node_eq
        self.n = n
        prows = np.concatenate([np.asarray(p[0], np.int64) for p in patterns]
                               + [np.zeros(0, np.int64)])
        pcols = np.concatenate([np.asarray(p[1], np.int64) for p in patterns]
                               + [np.zeros(0, np.int64)])
        if kind == "tridiag":
            from .banded import BandedPlan
            self._static = BandedPlan(n, N - n, rows, cols)
            self._iter = BandedPlan(n, N - n, prows, pcols)
            if not (self._static.ok and self._iter.ok):
                raise ValueError("circuit is not ladder-structured; "
                                 "tridiag solver not applicable")
        elif kind == "blockband":
            from .blockband import BlockScatter, get_layout
            self.layout = get_layout(engine)
            self._static = BlockScatter(self.layout, rows, cols)
            self._iter = BlockScatter(self.layout, prows, pcols)
        else:
            raise ValueError(f"unknown sparse system {kind!r}")

    def scatter(self, vals):
        """The static matrices from the static pattern's values."""
        return self._static.scatter(vals)

    def solve(self, static, I, vals=None):
        """x (..., N) of the system ``static`` plus the per-iteration
        pattern's ``vals`` (None: the static system alone) against the
        RHS I (..., >= N)."""
        from .blockcr import bordered_block_solve
        from .tridiag import bordered_solve
        eng = self.engine
        mats = static if vals is None else self._iter.scatter(vals,
                                                              base=static)
        if self.kind == "tridiag":
            n, N = self.n, eng.N
            xn, y = bordered_solve(mats["sub"], mats["diag"], mats["sup"],
                                   mats["U"], mats["W"], mats["D"],
                                   I[..., :n], I[..., n:N], algo=self.algo)
            return torch.cat([xn, y], dim=-1)
        f, g = self.layout.gather_rhs(I)
        xi, y = bordered_block_solve(mats["L"], mats["D"], mats["U"],
                                     mats["Ub"], mats["Wb"], mats["Db"], f,
                                     g, eng.opts.lu_pivot_floor)
        return self.layout.gather_solution(xi, y)


def cat_lanes(*parts):
    """Concatenate (..., k_i) values along the last axis, their lanes
    broadcast."""
    lead = broadcast_shapes(*(p.shape[:-1] for p in parts))
    return torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], -1)
