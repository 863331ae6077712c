"""Bordered-tridiagonal assembly for ladder-structured circuits (port of
``circuitsimulator_tpu/ops/banded.py``).

Classifies the engine's COO stamp entries into the layout that
``ops/tridiag.py`` solves:

    [ T   U ]   T: (n, n) tridiagonal over the node equations
    [ W   D ]   border: m = #branch equations (V sources / inductors)

A circuit qualifies ("is a ladder") iff every node-node coupling lands on
the band |r - c| <= 1: RC ladders and line meshes whose nodes were created
in chain order, with any number of to-ground elements (C, diodes) and a
few branch elements.  The classification is static (numpy, once); the
per-iteration work is scatter-adds into length-n vectors, O(n) memory
instead of the dense engine's O(n^2).
"""

from __future__ import annotations

import numpy as np
import torch

from .assemble import ScatterPlan
from ..utils.shapes import broadcast_shapes

# entry targets
_DIAG, _SUB, _SUP, _U, _W, _D, _DROP = range(7)


class BandedPlan:
    """Static classification of COO (rows, cols) into bordered-tridiagonal
    targets for a circuit with n node equations and m branch equations."""

    def __init__(self, n: int, m: int, rows: np.ndarray, cols: np.ndarray):
        self.n, self.m = n, m
        N = n + m
        r = np.asarray(rows).astype(np.int64)
        c = np.asarray(cols).astype(np.int64)
        tgt = np.full(r.shape, _DROP)
        node_node = (r < n) & (c < n)
        tgt[node_node & (r == c)] = _DIAG
        tgt[node_node & (r == c + 1)] = _SUB
        tgt[node_node & (c == r + 1)] = _SUP
        self.off_band = node_node & (np.abs(r - c) > 1)
        tgt[(r < n) & (c >= n) & (c < N)] = _U
        tgt[(r >= n) & (r < N) & (c < n)] = _W
        tgt[(r >= n) & (r < N) & (c >= n) & (c < N)] = _D
        self.ok = not bool(self.off_band.any())

        def sel(t):
            return np.nonzero(tgt == t)[0]

        self.i_diag, self.i_sub, self.i_sup = sel(_DIAG), sel(_SUB), sel(_SUP)
        self.i_u, self.i_w, self.i_d = sel(_U), sel(_W), sel(_D)
        self.diag_idx = r[self.i_diag]
        self.sub_idx = r[self.i_sub]
        self.sup_idx = r[self.i_sup]
        self.u_idx = (r[self.i_u], c[self.i_u] - n)
        self.w_idx = (r[self.i_w] - n, c[self.i_w])
        self.d_idx = (r[self.i_d] - n, c[self.i_d] - n)
        self._dev = None

    def _plans(self, device):
        """(selection, ScatterPlan) per target on ``device``, built once."""
        if self._dev != device:
            n, m = self.n, self.m
            flat = {"diag": self.diag_idx, "sub": self.sub_idx,
                    "sup": self.sup_idx,
                    "U": self.u_idx[0] * m + self.u_idx[1],
                    "W": self.w_idx[0] * n + self.w_idx[1],
                    "D": self.d_idx[0] * m + self.d_idx[1]}

            sels = {"diag": self.i_diag, "sub": self.i_sub,
                    "sup": self.i_sup, "U": self.i_u, "W": self.i_w,
                    "D": self.i_d}
            self._sc = {k: (torch.as_tensor(sels[k], device=device),
                            ScatterPlan(flat[k], device))
                        for k in flat if len(sels[k])}
            self._dev = device
        return self._sc

    def scatter(self, vals, base=None):
        """vals: (..., nnz) entry values aligned with the plan's rows/cols.
        Returns dict(sub, diag, sup, U, W, D); adds onto ``base`` if given
        (a copy: ``base`` is not written)."""
        n, m = self.n, self.m
        batch = vals.shape[:-1]
        shapes = {"diag": (n,), "sub": (n,), "sup": (n,), "U": (n, m),
                  "W": (m, n), "D": (m, m)}
        if base is None:
            flat = {k: vals.new_zeros(batch + (int(np.prod(s)),))
                    for k, s in shapes.items()}
        else:
            flat = {}
            for k, s in shapes.items():
                v = base[k].reshape(base[k].shape[:base[k].dim() - len(s)]
                                    + (-1,))
                lead = broadcast_shapes(batch, v.shape[:-1])
                flat[k] = v.expand(lead + v.shape[-1:]).clone()
        for k, (sel, plan) in self._plans(vals.device).items():
            v = vals.index_select(-1, sel)
            plan.add_(flat[k], v.expand(flat[k].shape[:-1] + v.shape[-1:]))
        return {k: flat[k].reshape(flat[k].shape[:-1] + s)
                for k, s in shapes.items()}


def is_ladder(engine) -> bool:
    """Does the circuit's full stamp pattern fit the bordered band?  Checks
    the union of static DC, static transient and nonlinear patterns."""
    t = engine.topo
    n = t.n_node_eq
    m = t.n_unknowns - n
    from .blockband import union_pattern
    rows, cols = union_pattern(engine)
    return BandedPlan(n, m, rows, cols).ok
