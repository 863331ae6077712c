"""Pole-zero analysis (``.PZ``); port of ``circuitsimulator_tpu/analysis/
pz.py``.

Linearises the circuit at the DC operating point into the MNA pencil

    (A + s C) x = b        A: conductance Jacobian (gmin = 0)
                           C: reactance structure (caps, -L, -M)

and computes

- **poles**: the finite generalized eigenvalues of (A, -C) by shift-invert
  (eig((A + sigma C)^{-1} C) = mu maps to s = sigma - 1/mu), so the
  infinite eigenvalues of the singular pencil land harmlessly at mu = 0;
- **zeros** of H(s) = c^T (A + s C)^{-1} b from an input source to the
  output: the finite eigenvalues of the bordered pencil
  ([[A, b], [c^T, 0]], [[-C, 0], [0, 0]]), found the same way.

A and C are assembled on the engine's device (the polish is K2's); the
small dense eigenproblem runs on the host in float64 numpy, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..ops.assemble import Engine
from .dc import dc_operating_point
from .hb import _reactive_structure
from .sensitivity import _polish, dc_jacobian


@dataclasses.dataclass
class PZResult:
    poles: np.ndarray     # complex, rad/s
    zeros: np.ndarray     # complex, rad/s (empty without an input)
    sigma: float          # shift actually used


def _finite_pencil_eigs(A: np.ndarray, C: np.ndarray,
                        mu_tol: float = 1e-9) -> Tuple[np.ndarray, float]:
    """Finite s with det(A + s C) = 0 via shift-invert + numpy eig."""
    scale = max(np.abs(A).max(), 1e-30) / max(np.abs(C).max(), 1e-30)
    for sig in [0.0, -0.1 * scale, -1.7 * scale, 0.31 * scale,
                -13.0 * scale]:
        M = A + sig * C
        try:
            Minv_C = np.linalg.solve(M, C)
        except np.linalg.LinAlgError:
            continue
        if not np.isfinite(Minv_C).all():
            continue
        mu = np.linalg.eigvals(Minv_C)
        keep = np.abs(mu) > mu_tol * max(np.abs(mu).max(), 1e-300)
        s = sig - 1.0 / mu[keep]
        return s, sig
    raise np.linalg.LinAlgError(
        "pole-zero: every shift produced a singular pencil")


def pole_zero(engine: Engine, params, out_eq: int, ref_eq: int = -1,
              input_ref: Optional[Tuple] = None,
              x_op: Optional[Any] = None) -> PZResult:
    """Poles of the linearized circuit and (with input_ref, as in
    analysis/noise.py: ("v", branch_eq) or ("i", ep, em)) the zeros of the
    transfer to V(out_eq, ref_eq)."""
    if x_op is None:
        x_op = dc_operating_point(engine, params)
    x_op = _polish(engine, params, x_op)
    N = engine.N
    with torch.inference_mode():
        A = dc_jacobian(engine, params, x_op).cpu().numpy().astype(
            np.float64)
    C = _reactive_structure(engine, params, x_op=x_op).cpu().numpy().astype(
        np.float64)

    poles, sigma = _finite_pencil_eigs(A, C)

    zeros = np.zeros((0,), complex)
    if input_ref is not None:
        b = np.zeros((N, 1))
        if input_ref[0] == "v":
            b[input_ref[1], 0] = 1.0
        else:
            if input_ref[1] < N:
                b[input_ref[1], 0] -= 1.0
            if input_ref[2] < N:
                b[input_ref[2], 0] += 1.0
        c = np.zeros((1, N))
        c[0, out_eq] = 1.0
        if ref_eq >= 0:
            c[0, ref_eq] -= 1.0
        Ab = np.block([[A, b], [c, np.zeros((1, 1))]])
        Cb = np.zeros((N + 1, N + 1))
        Cb[:N, :N] = C
        zeros, _ = _finite_pencil_eigs(Ab, Cb)
    return PZResult(poles=np.sort_complex(poles),
                    zeros=np.sort_complex(zeros), sigma=sigma)


def pz_table(result: PZResult) -> str:
    out = ["==== Poles (rad/s) ===="]
    for p in result.poles:
        out.append(f"  {p.real: .6e} {p.imag:+.6e}j   "
                   f"(f = {abs(p) / (2 * np.pi):.6e} Hz)")
    if len(result.zeros):
        out.append("==== Zeros (rad/s) ====")
        for z in result.zeros:
            out.append(f"  {z.real: .6e} {z.imag:+.6e}j   "
                       f"(f = {abs(z) / (2 * np.pi):.6e} Hz)")
    return "\n".join(out)
