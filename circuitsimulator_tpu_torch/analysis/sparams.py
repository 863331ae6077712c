"""N-port S-parameter extraction; port of
``circuitsimulator_tpu/analysis/sparams.py``.

The open-circuit impedance matrix Z(f) comes from n AC solves per frequency
(a unit AC current into each port pair, all port voltages read); then

    S = F (Z - Z0) (Z + Z0)^{-1} F^{-1},   Z0 = diag(Z0_i),
    F  = diag(1 / (2 sqrt(Re Z0_i))).

The n port excitations are n lanes of one K3 launch over the whole sweep
(``ac.rhs_sweep``; a T-line deck solves its 2N systems on K2); the n x n Z
to S algebra runs on the host in numpy, as in the JAX package.  A port with
no AC path to the rest of the circuit makes Z singular; the circuit should
not contain the port terminations (matched loading is implicit).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.assemble import Engine
from .ac import _omegas, rhs_sweep


@dataclasses.dataclass
class SParamResult:
    freqs: np.ndarray        # (F,)
    s: np.ndarray            # (F, n, n) complex
    z: np.ndarray            # (F, n, n) complex open-circuit impedances
    z0: np.ndarray           # (n,) reference impedances


@torch.inference_mode()
def s_parameters(engine: Engine, params, port_eqs: Sequence[Tuple[int, int]],
                 z0s: Sequence[float], freqs, x_op) -> SParamResult:
    """port_eqs: (eq_p, eq_m) per port with the dump-slot convention
    (ground = engine.N); z0s: reference impedance per port."""
    N = engine.N
    n = len(port_eqs)
    freqs = np.asarray(freqs, float)
    z0 = np.asarray(z0s, float)
    Z0 = np.diag(z0.astype(complex))
    F = np.diag(1.0 / (2.0 * np.sqrt(z0)))
    Finv = np.diag(2.0 * np.sqrt(z0))

    rhs = torch.zeros((n, N), dtype=engine.dtype, device=engine.device)
    for j, (p, m) in enumerate(port_eqs):
        if p < N:
            rhs[j, p] += 1.0
        if m < N:
            rhs[j, m] -= 1.0
    _, om = _omegas(engine, freqs)
    vr, vi = rhs_sweep(engine, params, x_op, om, rhs)      # (n, F, N)
    V = vr.cpu().numpy() + 1j * vi.cpu().numpy()
    Ve = np.concatenate([V, np.zeros(V.shape[:-1] + (1,), complex)], -1)
    # Z[k, i, j]: port i's voltage under port j's unit current
    Z = np.stack([Ve[..., p] - Ve[..., m] for (p, m) in port_eqs], -1)
    Z = Z.transpose(1, 2, 0)
    S = np.stack([F @ (Zk - Z0) @ np.linalg.inv(Zk + Z0) @ Finv
                  for Zk in Z]) if len(Z) else np.zeros((0, n, n), complex)
    return SParamResult(freqs=freqs, s=S, z=Z, z0=z0)


@dataclasses.dataclass
class TwoPortMetrics:
    freqs: np.ndarray        # (F,)
    k: np.ndarray            # (F,) Rollett stability factor
    delta: np.ndarray        # (F,) complex determinant S11*S22 - S12*S21
    mu_load: np.ndarray      # (F,) Edwards-Sinsky mu (output/load side)
    mu_src: np.ndarray       # (F,) mu' (input/source side)
    msg: np.ndarray          # (F,) maximum stable gain |S21/S12|
    mag: np.ndarray          # (F,) maximum available gain (NaN where K < 1)
    mason_u: np.ndarray      # (F,) Mason's unilateral gain U
    stable: np.ndarray       # (F,) bool: unconditionally stable (mu > 1)


def two_port_metrics(res, freqs=None) -> TwoPortMetrics:
    """Stability and gain figures of a 2-port from its S-parameters (an
    SParamResult, or a raw (F, 2, 2) complex array + freqs):

        delta = S11 S22 - S12 S21
        K     = (1 - |S11|^2 - |S22|^2 + |delta|^2) / (2 |S12 S21|)
        mu    = (1 - |S11|^2) / (|S22 - delta conj(S11)| + |S12 S21|)
        mu'   = (1 - |S22|^2) / (|S11 - delta conj(S22)| + |S12 S21|)
        MSG   = |S21| / |S12|
        MAG   = MSG (K - sqrt(K^2 - 1))        for K >= 1, NaN otherwise
        U     = |S21/S12 - 1|^2 / (2 (K |S21/S12| - Re(S21/S12)))

    Unconditionally stable iff mu > 1 (Edwards & Sinsky)."""
    if isinstance(res, SParamResult):
        s, freqs = res.s, res.freqs
    else:
        s = np.asarray(res, complex)
        freqs = np.asarray(
            freqs if freqs is not None else np.arange(s.shape[0]), float)
    if s.ndim != 3 or s.shape[-2:] != (2, 2):
        raise ValueError(f"two_port_metrics needs (F, 2, 2) S-parameters, "
                         f"got {s.shape}")
    s11, s12 = s[:, 0, 0], s[:, 0, 1]
    s21, s22 = s[:, 1, 0], s[:, 1, 1]
    delta = s11 * s22 - s12 * s21
    p = np.abs(s12 * s21)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = (1.0 - np.abs(s11) ** 2 - np.abs(s22) ** 2
             + np.abs(delta) ** 2) / (2.0 * p)
        mu_load = (1.0 - np.abs(s11) ** 2) / (
            np.abs(s22 - delta * np.conj(s11)) + p)
        mu_src = (1.0 - np.abs(s22) ** 2) / (
            np.abs(s11 - delta * np.conj(s22)) + p)
        r = s21 / s12
        msg = np.abs(r)
        mag = np.where(k >= 1.0, msg * (k - np.sqrt(np.maximum(
            k ** 2 - 1.0, 0.0))), np.nan)
        mason_u = np.abs(r - 1.0) ** 2 / (
            2.0 * (k * np.abs(r) - np.real(r)))
    return TwoPortMetrics(freqs=np.asarray(freqs, float), k=k, delta=delta,
                          mu_load=mu_load, mu_src=mu_src, msg=msg, mag=mag,
                          mason_u=mason_u, stable=mu_load > 1.0)


def write_touchstone(path: str, res: SParamResult) -> None:
    """Touchstone v1 .sNp writer (``# Hz S MA R <z0>``): magnitude/angle
    pairs, the 2-port S11 S21 S12 S22 column order, row-major with 4 pairs
    per line otherwise.  Per-port Z0s are noted in a comment and port 1's
    is written in the option line.  The comment line names the JAX
    package, as its writer does, so the two files are the same bytes."""
    n = res.s.shape[-1]
    with open(path, "w") as fh:
        fh.write("! circuitsimulator_tpu S-parameters "
                 f"({n}-port, {len(res.freqs)} points)\n")
        if not np.allclose(res.z0, res.z0[0]):
            fh.write("! per-port Z0: "
                     + " ".join(f"{z:g}" for z in res.z0)
                     + " (option line carries port 1's)\n")
        fh.write(f"# Hz S MA R {res.z0[0]:g}\n")

        def ma(i, j, k):
            v = res.s[k, i, j]
            return f"{abs(v):.9e} {np.degrees(np.angle(v)):.9e}"

        for k, f in enumerate(res.freqs):
            if n == 1:
                fh.write(f"{f:.9e} {ma(0, 0, k)}\n")
            elif n == 2:
                fh.write(f"{f:.9e} {ma(0, 0, k)} {ma(1, 0, k)} "
                         f"{ma(0, 1, k)} {ma(1, 1, k)}\n")
            else:
                pairs = [(i, j) for i in range(n) for j in range(n)]
                for off in range(0, len(pairs), 4):
                    chunk = " ".join(ma(i, j, k)
                                     for i, j in pairs[off:off + 4])
                    lead = f"{f:.9e} " if off == 0 else "  "
                    fh.write(lead + chunk + "\n")


def write_sparams_csv(path: str, res: SParamResult) -> None:
    """CSV: freq, then Sij magnitude/phase(deg) pairs in row-major port
    order."""
    n = res.s.shape[-1]
    cols = ["freq"]
    for i in range(n):
        for j in range(n):
            cols += [f"|S{i+1}{j+1}|", f"argS{i+1}{j+1}(deg)"]
    with open(path, "w") as fh:
        fh.write(",".join(cols) + "\n")
        for k, f in enumerate(res.freqs):
            row = [f]
            for i in range(n):
                for j in range(n):
                    row += [abs(res.s[k, i, j]),
                            np.degrees(np.angle(res.s[k, i, j]))]
            fh.write(",".join(f"{v:.9e}" for v in row) + "\n")
