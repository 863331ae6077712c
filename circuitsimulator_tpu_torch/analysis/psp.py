"""Periodic (hot) S-parameters: the small-signal scattering of a
periodically driven circuit, frequency translation between sidebands
included (port of ``circuitsimulator_tpu/analysis/psp.py``).

Around the periodic steady state at f0 each (port, sideband m) pair is one
terminal of an extended multiport.  The conversion impedance

    Z[(i, mi), (j, mj)](delta) = the mi-th envelope Fourier coefficient of
                                 port i's voltage when a unit current
                                 e^{j 2 pi (mj f0 + delta) t} is injected
                                 into port j

comes from the forward LPTV solves of ``pac.py`` (every (port, sideband)
injection one right-hand side of the same system, every offset one system
of the batched solve; T-line delays exact), and the scattering matrix from
the bilinear map on the extended port space,

    S = F (Z - Z0) (Z + Z0)^-1 F^-1,  Z0 = diag(z0_i per sideband),
    F = diag(1 / (2 sqrt(z0_i))).

``periodic_s_parameters_batched`` runs B Monte-Carlo lanes' systems in the
same batched solves; the port rows are read and the small P x P maps
formed on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.assemble import Engine
from .pac import (_lanes, _lptv_solve, _over_lanes, lptv_operator,
                  make_lptv_blocks_fn)


def _index(harmonics, z0, port: int, m: int) -> int:
    idx = np.nonzero(harmonics == m)[0]
    if len(idx) == 0:
        raise KeyError(f"sideband {m} not in {harmonics}")
    return int(idx[0]) * len(z0) + port


@dataclasses.dataclass
class PSPResult:
    f0: float
    deltas: np.ndarray        # (F,) offset frequencies
    harmonics: np.ndarray     # (M,) sideband indices (shared in/out)
    s: np.ndarray             # (F, P, P) complex, P = n_ports * len(harmonics)
    z: np.ndarray             # (F, P, P) conversion impedance matrix
    z0: np.ndarray            # (n_ports,) reference impedances

    def index(self, port: int, m: int) -> int:
        """Flat extended-port index of (port, sideband m)."""
        return _index(self.harmonics, self.z0, port, m)

    def s_at(self, port_out: int, m_out: int, port_in: int, m_in: int):
        """S from (port_in, sideband m_in) to (port_out, m_out): (F,)
        complex; s_at(1, 1, 0, 0) is the delta -> f0 + delta up-conversion
        gain from port 0 into port 1."""
        return self.s[:, self.index(port_out, m_out),
                      self.index(port_in, m_in)]


@dataclasses.dataclass
class PSPBatchResult:
    f0: float
    deltas: np.ndarray        # (F,)
    harmonics: np.ndarray     # (M,)
    s: np.ndarray             # (B, F, P, P) complex
    z: np.ndarray             # (B, F, P, P) complex
    z0: np.ndarray            # (n_ports,)

    def index(self, port: int, m: int) -> int:
        return _index(self.harmonics, self.z0, port, m)

    def s_at(self, port_out: int, m_out: int, port_in: int, m_in: int):
        """(B, F) complex S from (port_in, m_in) to (port_out, m_out)."""
        return self.s[:, :, self.index(port_out, m_out),
                      self.index(port_in, m_in)]


def _sidebands(n_sidebands: int, K: int):
    M = int(n_sidebands)
    H = (K - 1) // 2
    if M > H:
        raise ValueError(f"n_sidebands {M} exceeds the PSS harmonic "
                         f"truncation H={H}; raise n_harm")
    return np.arange(-M, M + 1)


def _incidence(port_eqs, N: int) -> np.ndarray:
    """(n, N) unit port-current incidence (ground = the dump slot N)."""
    u = np.zeros((len(port_eqs), N))
    for j, (p, m) in enumerate(port_eqs):
        if p < N:
            u[j, p] += 1.0
        if m < N:
            u[j, m] -= 1.0
    return u


def _injections(u: np.ndarray, harmonics, K: int) -> np.ndarray:
    """(KN, P) envelope samples of every (port j, sideband m) injection,
    column jm * n + j: sample k carries u_j e^{+2 pi i m k/K}."""
    n, N = u.shape
    phase = np.exp(2j * np.pi * np.outer(harmonics, np.arange(K)) / K)
    rhs = np.zeros((K * N, n * len(harmonics)), complex)
    for jm in range(len(harmonics)):
        for j in range(n):
            rhs[:, jm * n + j] = (phase[jm][:, None]
                                  * u[j][None, :]).ravel()
    return rhs


def _scatter(Vp, z0, nh: int):
    """S (..., P, P) from the conversion impedances Vp (..., P, P)."""
    z0e = torch.as_tensor(np.tile(np.asarray(z0, float), nh),
                          dtype=Vp.dtype, device=Vp.device)
    Z0 = torch.diag_embed(z0e)
    Fm = torch.diag_embed(1.0 / (2.0 * torch.sqrt(z0e)))
    Fi = torch.diag_embed(2.0 * torch.sqrt(z0e))
    return Fm @ (Vp - Z0) @ torch.linalg.inv(Vp + Z0) @ Fi


def _port_coeffs(vk, harmonics, K: int):
    """Z (..., P, P) from the port voltages' envelope samples vk (..., K,
    n, P): rows im * n + i hold port i's coefficient at sideband m_i."""
    coeff = torch.fft.fft(vk, dim=-3) / K
    sel = coeff[..., [int(m) % K for m in harmonics], :, :]   # (.., nh, n, P)
    return sel.flatten(-3, -2)


@torch.inference_mode()
def periodic_s_parameters(engine: Engine, params, f0: float, xs_pss,
                          port_eqs: Sequence[Tuple[int, int]],
                          z0s: Sequence[float], deltas,
                          n_sidebands: int = 1) -> PSPResult:
    """port_eqs: (eq_p, eq_m) per port, ground = engine.N (as
    sparams.s_parameters); z0s: per-port reference impedances; deltas:
    offset frequencies (0 < delta < f0 keeps the sideband frequencies
    apart); n_sidebands: the sidebands -M..M kept on the input and the
    output side.  The netlist must not contain the port terminations:
    matched loading at every sideband is implicit in the definition."""
    N = engine.N
    J0, CI, K, tl = lptv_operator(engine, params, f0, xs_pss)
    harmonics = _sidebands(n_sidebands, K)
    u = _incidence(port_eqs, N)
    rhs = torch.as_tensor(_injections(u, harmonics, K),
                          device=engine.device)[None]
    Y = _lptv_solve(*_lanes(J0, CI, tl), deltas, rhs)[0]     # (F, KN, P)
    Pm = torch.as_tensor(u, dtype=Y.dtype, device=engine.device)
    vk = torch.einsum("in,fknp->fkip", Pm, Y.unflatten(1, (K, N)))
    Z = _port_coeffs(vk, harmonics, K)
    S = _scatter(Z, z0s, len(harmonics))
    return PSPResult(f0=f0, deltas=np.asarray(deltas, float),
                     harmonics=harmonics, s=S.cpu().numpy(),
                     z=Z.cpu().numpy(), z0=np.asarray(z0s, float))


def make_psp_batched_fn(engine: Engine, f0: float, K: int,
                        port_eqs, harmonics, deltas):
    """lane(bparams, xs_b) -> (B, F, K, n, P) complex port-voltage
    envelope samples of every lane's forward LPTV solves, every (port,
    sideband) injection a right-hand side (JAX's kernel returns the same
    numbers as a trailing real/imaginary pair); the FFT and the bilinear
    map stay with the caller."""
    N = engine.N
    harmonics = np.asarray(harmonics, int)
    blocks = make_lptv_blocks_fn(engine, f0, K)
    u = _incidence(port_eqs, N)
    rhs_np = _injections(u, harmonics, K)
    deltas = np.asarray(deltas, float)

    def chunk(bp, X):
        J0, CI, tl = blocks(bp, X)
        rhs = torch.as_tensor(rhs_np, device=engine.device)[None]
        Y = _lptv_solve(J0, CI, tl, deltas, rhs)           # (B, F, KN, P)
        Pm = torch.as_tensor(u, dtype=Y.dtype, device=engine.device)
        return torch.einsum("in,bfknp->bfkip", Pm, Y.unflatten(2, (K, N)))

    def lane(bparams, xs_b):
        with torch.inference_mode():
            return _over_lanes(engine, bparams, xs_b, len(deltas),
                               rhs_np.shape[1], chunk)

    return lane


def periodic_s_parameters_batched(engine: Engine, bparams, f0: float,
                                  xs_pss_b,
                                  port_eqs: Sequence[Tuple[int, int]],
                                  z0s: Sequence[float], deltas,
                                  n_sidebands: int = 1) -> PSPBatchResult:
    """Monte-Carlo hot S-parameters: B lanes of perturbed params (leading
    lane axis), each linearised around its own periodic steady state
    xs_pss_b (B, K, N) (e.g. HBBatchResult.xs); every (lane, offset) LPTV
    solve one system of the batched solves.  Conventions as
    periodic_s_parameters."""
    K = int(xs_pss_b.shape[1])
    harmonics = _sidebands(n_sidebands, K)
    vk = make_psp_batched_fn(engine, f0, K, port_eqs, harmonics, deltas)(
        bparams, xs_pss_b)
    with torch.inference_mode():
        Z = _port_coeffs(vk, harmonics, K)
        S = _scatter(Z, z0s, len(harmonics))
    return PSPBatchResult(f0=f0, deltas=np.asarray(deltas, float),
                          harmonics=harmonics, s=S.cpu().numpy(),
                          z=Z.cpu().numpy(), z0=np.asarray(z0s, float))
