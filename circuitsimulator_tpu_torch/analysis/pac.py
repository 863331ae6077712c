"""Periodic small-signal analyses around a periodic steady state (port of
``circuitsimulator_tpu/analysis/pac.py``): periodic AC (PAC), periodic
transfer functions (PXF), periodic noise (PNOISE) and the conversion noise
figure, single lane and batched over Monte-Carlo lanes.

Linearised around the PSS samples x*(t_k) (K = 2H+1 uniform samples of
the period T = 1/f0), a small-signal drive u e^{j 2 pi delta t} answers
with Y(t) e^{j 2 pi delta t}, Y T-periodic, from the LPTV system

    J(delta) = J0 + j 2 pi delta CI [+ sum_i e^{-j 2 pi delta tau_i} B_i]

on the K samples: J0 = blockdiag_t(A(x_t)) + kron(D, C) the conduction
blocks plus the spectral d/dt (under MOSCAP=CHARGE the per-sample
trans-capacitances C + Cq(x_s) in place of C), CI the block-diagonal
capacitance and B_i the delay blocks of the transmission lines.  PAC and
the hot S-parameters (``psp.py``) solve J(delta) forward; PXF, PNOISE, the
mixer noise figure and the envelope noise (``envnoise.py``) solve the
adjoint J(delta)^H psi = 1_K (x) c.

Design for the card:

- A_t, C, Cq_t and the T-line shifts come from the harmonic-balance system
  (``hb.hb_system``: one batched assembly over the samples), so J0 is the
  HB Jacobian without its delay blocks.
- CI is never formed densely: ``lptv_operator`` returns its K diagonal
  blocks (..., K, N, N) (JAX's ``np.kron(np.eye(K), C)``), and J(delta) is
  the real J0 copied into a complex matrix whose K diagonal blocks gain
  j omega CI.
- Every (lane, offset) pair is one system of a batched complex
  ``torch.linalg.lu_factor_ex`` / ``lu_solve`` (adjoint solves with
  ``adjoint=True`` on the LU of J, no transposed copy), the pairs cut into
  chunks that fit half the card's free memory (``_pair_chunk``).  These
  large products run outside any Pallas kernel in JAX too (``np.linalg`` /
  ``jnp.linalg.solve``); the TPU kernel under this family is K2, which the
  PSS's DC point and warm-up transient launch.
- Complex arithmetic throughout: the TPU's real 2KN block form of the
  batched path takes twice the memory of a complex KN solve.
- Results stay on the device until the read-outs are done; a zero pivot
  or a non-finite solution raises (one host check after all the solves).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..ops.assemble import Engine
from .hb import hb_system

@dataclasses.dataclass
class PACResult:
    f0: float
    deltas: np.ndarray        # (F,) offset frequencies
    harmonics: np.ndarray     # (M,) sideband indices m (response at m*f0+delta)
    spectrum: np.ndarray      # (F, M, N) complex envelope coefficients Y_m
    xs_pss: Any               # (K, N) the PSS samples used


@dataclasses.dataclass
class PXFResult:
    f0: float
    deltas: np.ndarray        # (F,) output offset frequencies
    harmonics: np.ndarray     # (M,) input sideband indices m (input at m*f0+delta)
    xf_v: np.ndarray          # (F, M, nV) transfer from each V source (V/V)
    xf_i: np.ndarray          # (F, M, nI) transfer from each I source (V/A)
    xs_pss: Any               # (K, N) the PSS samples used
    v_names: Any = None       # (nV,) source names (filled by Simulator.pxf)
    i_names: Any = None       # (nI,)


@dataclasses.dataclass
class PNoiseResult:
    f0: float
    deltas: np.ndarray        # (F,) offset frequencies
    onoise: np.ndarray        # (F,) output noise PSD, V^2/Hz
    by_kind: dict             # device-kind -> (F,) PSD contribution


@dataclasses.dataclass
class PNoiseBatchResult:
    f0: float
    deltas: np.ndarray        # (F,)
    onoise: np.ndarray        # (B, F) output noise PSD per lane, V^2/Hz
    by_kind: dict             # device-kind -> (B, F) PSD contribution
    converged: Any = None     # (B,) bool: the upstream HB lanes


@dataclasses.dataclass
class PACBatchResult:
    f0: float
    deltas: np.ndarray        # (F,)
    harmonics: np.ndarray     # (M,)
    spectrum: np.ndarray      # (B, F, M, N) complex envelope coefficients
    xs_pss: Any               # (B, K, N)
    converged: Any = None     # (B,) bool: upstream HB lane flags


@dataclasses.dataclass
class PXFBatchResult:
    f0: float
    deltas: np.ndarray        # (F,)
    harmonics: np.ndarray     # (M,)
    xf_v: np.ndarray          # (B, F, M, nV)
    xf_i: np.ndarray          # (B, F, M, nI)
    v_names: Any = None
    i_names: Any = None
    converged: Any = None     # (B,) bool: upstream HB lane flags


def _samples(engine: Engine, xs):
    if not isinstance(xs, torch.Tensor):
        xs = np.array(xs, dtype=np.float64)      # a writable host copy
    return torch.as_tensor(xs, dtype=engine.dtype, device=engine.device)


def _cdtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def lptv_operator(engine: Engine, params, f0: float, xs_pss):
    """(J0, CI, K, tl): the LPTV operator J(delta) = J0 + j 2 pi delta CI
    [+ sum_i e^{-j 2 pi delta tau_i} B_i] built from the PSS samples
    xs_pss (..., K, N); params carry the same lane shape (), or (B,) with
    xs_pss (B, K, N).

    J0 (..., KN, KN) is real.  CI (..., K, N, N) holds the K diagonal
    blocks of the block-diagonal capacitance (C, or C + Cq(x_t) under
    MOSCAP=CHARGE), never the dense (KN)^2 matrix.  tl is None without
    transmission lines, else (taus (..., n_tl), B (..., n_tl, KN, KN)) with
    B the real delay blocks: each line's band-limited HB shift under its
    Branin branch rows (hb._tl_hb_terms), scaled per offset by the
    envelope phase e^{-j 2 pi delta tau}."""
    N = engine.N
    X = _samples(engine, xs_pss)
    K = X.shape[-2]
    system = hb_system(engine, f0, (K - 1) // 2)
    ctx = system.prepare(params)
    _, aux = system.residual_ctx(X, ctx, True)
    lead = X.shape[:-2]
    C = ctx["C"]
    if system.mos_q:
        A_t, Cq_t = aux
        C_t = C[..., None, :, :] + Cq_t
    else:
        A_t = aux
        C_t = C[..., None, :, :].expand(lead + (K, N, N))
    J0 = torch.einsum("ts,...sij->...tisj", system.D, C_t).contiguous()
    J0.diagonal(0, -4, -2).add_(A_t.movedim(-3, -1))
    tl = None
    if engine.n_tl:
        t = engine.topo
        S = ctx["S"].expand(lead + ctx["S"].shape[-3:])
        z0 = params["tl_z0"].expand(lead + params["tl_z0"].shape[-1:])
        B = torch.zeros(lead + (engine.n_tl, K, N, K, N), dtype=engine.dtype,
                        device=engine.device)
        for i in range(engine.n_tl):
            Si = S[..., i, :, :]
            for row, cols in (
                    (int(t.tl_k1[i]), (int(t.tl_ep2[i]), int(t.tl_em2[i]),
                                       int(t.tl_k2[i]))),
                    (int(t.tl_k2[i]), (int(t.tl_ep1[i]), int(t.tl_em1[i]),
                                       int(t.tl_k1[i])))):
                for c, coef in zip(cols, (-1.0, 1.0,
                                          -z0[..., i, None, None])):
                    if c < N:    # the ground column drops out
                        B[..., i, :, row, :, c] += coef * Si
        taus = params["tl_td"].expand(lead + params["tl_td"].shape[-1:])
        tl = (taus, B.reshape(lead + (engine.n_tl, K * N, K * N)))
    return J0.reshape(lead + (K * N, K * N)), C_t, K, tl


def _pair_chunk(KN: int, P: int, n: int, cdtype, device) -> int:
    """(lane, offset) systems per chunk: on the card as many as fit in half
    its free memory (the complex J, its LU and the right-hand sides and
    solutions; raises when one does not fit); on the host one at a time (a
    batched host LU of a few hundred unknowns can hang with several
    threads in some torch builds, and the host runs the systems of a batch
    one after another anyway)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 1
    size = torch.empty((), dtype=cdtype).element_size()
    per = (2 * KN * KN + 2 * KN * P) * size
    free, _ = torch.cuda.mem_get_info(dev)
    c = int(free // 2 // per)
    if c < 1:
        raise MemoryError(
            f"one LPTV system needs ~{per / 2**20:.0f} MiB (KN = {KN}); "
            f"{free / 2**20:.0f} MiB free")
    return min(n, c)


def _lptv_solve(J0, CI, tl, deltas, rhs, adjoint: bool = False):
    """Solutions of J(delta) Y = rhs, or of J(delta)^H Y = rhs with
    ``adjoint``, for every lane of J0 (L, KN, KN) (CI (L, K, N, N), tl with
    the same lane axis) and every offset of ``deltas`` (F,): (L, F, KN, P)
    complex.  rhs (L or 1, KN, P).  Every (lane, offset) pair is one system
    of a batched LU; a zero pivot or a non-finite solution raises after
    the last chunk (one host check)."""
    L, KN = J0.shape[0], J0.shape[-1]
    K, N = CI.shape[-3], CI.shape[-1]
    dev = J0.device
    cdtype = _cdtype(J0.dtype)
    w = torch.as_tensor(2.0 * np.pi * np.asarray(deltas, float),
                        dtype=J0.dtype, device=dev)
    F, P = w.shape[0], rhs.shape[-1]
    rhs = rhs.to(cdtype)
    out = torch.empty((L, F, KN, P), dtype=cdtype, device=dev)
    flat = out.view(L * F, KN, P)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    c = _pair_chunk(KN, P, L * F, cdtype, dev)
    pairs = [(p // F, p % F) for p in range(L * F)]
    for lo in range(0, L * F, c):
        chunk = pairs[lo:lo + c]
        li = torch.as_tensor([l for l, _ in chunk], device=dev)
        fi = torch.as_tensor([f for _, f in chunk], device=dev)
        J = torch.zeros((len(chunk), KN, KN), dtype=cdtype, device=dev)
        Jr = J.real
        for k, (l, _) in enumerate(chunk):
            Jr[k].copy_(J0[l])
        # j w CI on the K diagonal blocks of the imaginary part
        J.imag.unflatten(1, (K, N)).unflatten(-1, (K, N)).diagonal(
            0, 1, 3).add_(w[fi][:, None, None, None]
                          * CI[li].permute(0, 2, 3, 1))
        if tl is not None:
            taus, B = tl
            ph = torch.polar(torch.ones_like(taus[li]),
                             -w[fi][:, None] * taus[li])       # (c, n_tl)
            for k, (l, _) in enumerate(chunk):
                J[k] += torch.tensordot(ph[k], B[l].to(cdtype), 1)
        LU, piv, info = torch.linalg.lu_factor_ex(J)
        del J, Jr
        b = rhs[li] if rhs.shape[0] == L else rhs.expand(len(chunk), KN, P)
        Y = torch.linalg.lu_solve(LU, piv, b, adjoint=adjoint)
        del LU
        flat[lo:lo + len(chunk)] = Y
        bad |= (info != 0).any() | ~torch.isfinite(Y).all()
    if bool(bad):
        raise RuntimeError("LPTV solve failed: J(delta) singular or the "
                           "solution not finite")
    return out


def _lanes(J0, CI, tl):
    """A single lane's operator with a lane axis of one."""
    if tl is not None:
        tl = (tl[0][None], tl[1][None])
    return J0[None], CI[None], tl


def _harmonics(K: int, n_sidebands: Optional[int]):
    """(the sidebands -M..M as numpy, their FFT bins m % K as a list)."""
    H = (K - 1) // 2
    M = int(n_sidebands) if n_sidebands is not None else H
    M = min(M, H)
    harmonics = np.arange(-M, M + 1)
    return harmonics, [int(m) % K for m in harmonics]


def _ac_input(engine: Engine, params):
    """(..., N) complex small-signal input from the sources' AC specs (as
    .AC): V sources on their branch rows, I sources at -ep / +em."""
    t = engine.topo
    deg = np.pi / 180.0
    dev = engine.device
    vv = torch.polar(params["vs_ac_mag"], params["vs_ac_phase"] * deg)
    iv = torch.polar(params["is_ac_mag"], params["is_ac_phase"] * deg)
    lead = torch.broadcast_shapes(vv.shape[:-1], iv.shape[:-1])
    U = torch.zeros(lead + (engine.N + 1,), dtype=vv.dtype, device=dev)
    U = U.index_add(-1, torch.as_tensor(np.asarray(t.vs_k, np.int64),
                                        device=dev), vv.expand(lead + vv.shape[-1:]))
    iv = iv.expand(lead + iv.shape[-1:])
    U = U.index_add(-1, torch.as_tensor(np.asarray(t.is_ep, np.int64),
                                        device=dev), -iv)
    U = U.index_add(-1, torch.as_tensor(np.asarray(t.is_em, np.int64),
                                        device=dev), iv)
    return U[..., :engine.N]


def _selector(engine: Engine, out_eq: int, ref_eq: int = -1):
    """(N,) output selector of V(out[, ref])."""
    c = torch.zeros(engine.N, dtype=engine.dtype, device=engine.device)
    c[out_eq] = 1.0
    if ref_eq >= 0:
        c[ref_eq] -= 1.0
    return c


def _adjoint_rhs(engine: Engine, K: int, out_eq: int, ref_eq: int = -1):
    """(1, KN, 1): 1_K (x) c, the adjoint right-hand side."""
    return _selector(engine, out_eq, ref_eq).repeat(K)[None, :, None]


def _ext(psi):
    """psi (..., N) with the ground slot appended."""
    return torch.cat([psi, torch.zeros_like(psi[..., :1])], -1)


def _noise_intensities(engine: Engine, params, X, lanes: bool = False):
    """(pairs, s_white (..., K, nS), s_flick (..., K, nS), kinds): the
    device noise generators at every sample of X (..., K, N) (analysis/
    noise._device_noise_currents); ``lanes``: params and X carry a leading
    lane axis, taken one lane at a time."""
    from .noise import _device_noise_currents

    def at(p, x):
        # a deck of resistors alone has no sample axis in its intensities
        pairs, sw, sf, kinds = _device_noise_currents(engine, p, x)
        lead = x.shape[:-1]
        return (pairs, sw.expand(lead + sw.shape[-1:]),
                sf.expand(lead + sf.shape[-1:]), kinds)
    if not lanes:
        return at(params, X)
    per = [at({k: v[b] for k, v in params.items()}, X[b])
           for b in range(X.shape[0])]
    return (per[0][0], torch.stack([p[1] for p in per]),
            torch.stack([p[2] for p in per]), per[0][3])


def _adjoint_psd_at(psi, pairs, s_white_t, s_flick_t, deltas):
    """Per-source output-referred PSD contributions (..., F, nS) from the
    adjoint envelopes psi (..., F, K, N): each noise pair's gain at every
    PSS sample, |gain|^2 x S(t) averaged over the period (cyclostationary
    folding), flicker with the 1/delta envelope.  s_* (..., K, nS).  Shared
    by pnoise, mixer_noise_figure and envelope_noise (analysis/
    envnoise.py)."""
    dev = psi.device
    pe = _ext(psi)
    p0 = torch.as_tensor(np.asarray(pairs)[:, 0], device=dev)
    p1 = torch.as_tensor(np.asarray(pairs)[:, 1], device=dev)
    g = pe[..., p0] - pe[..., p1]                          # (..., F, K, nS)
    d = torch.as_tensor(np.asarray(deltas, float), dtype=s_white_t.dtype,
                        device=dev)
    s_t = (s_white_t[..., None, :, :]
           + s_flick_t[..., None, :, :] / d[:, None, None])
    return (g.abs() ** 2 * s_t).mean(-2)


def _by_kind(contrib, kinds):
    """(onoise (..., F), {kind: (..., F)}) from the contributions (..., F,
    nS), on the host."""
    cn = contrib.cpu().numpy()
    by_kind = {k: np.zeros(cn.shape[:-1]) for k in set(kinds)}
    for j, k in enumerate(kinds):
        by_kind[k] += cn[..., j]
    return cn.sum(-1), by_kind


def _check_deltas(deltas, what: str = "pnoise offsets must be > 0 (the "
                                      "flicker 1/delta envelope diverges "
                                      "at DC), like the .NOISE sweep"):
    deltas = np.asarray(deltas, float)
    if np.any(deltas <= 0):
        raise ValueError(what)
    return deltas


@torch.inference_mode()
def pac(engine: Engine, params, f0: float, xs_pss, deltas,
        n_sidebands: Optional[int] = None) -> PACResult:
    """Conversion gains from the sources' AC specs to every sideband m*f0 +
    delta.  xs_pss: (K, N) PSS samples on the uniform grid (K odd = 2H+1,
    e.g. HBResult.xs); deltas: offset frequencies."""
    N = engine.N
    J0, CI, K, tl = lptv_operator(engine, params, f0, xs_pss)
    rhs = _ac_input(engine, params).repeat(K)[None, :, None]
    Y = _lptv_solve(*_lanes(J0, CI, tl), deltas, rhs)[0, ..., 0]
    harmonics, bins = _harmonics(K, n_sidebands)
    coeff = torch.fft.fft(Y.unflatten(-1, (K, N)), dim=-2) / K
    spec = coeff[:, bins]                                   # (F, M, N)
    return PACResult(f0=f0, deltas=np.asarray(deltas, float),
                     harmonics=harmonics, spectrum=spec.cpu().numpy(),
                     xs_pss=xs_pss)


def _pxf_readout(engine: Engine, psi, bins):
    """(xf_v (..., M, nV), xf_i (..., M, nI)) from the adjoint envelopes
    psi (..., K, N) (not conjugated): the V-source branch rows and the
    I-source pairs e_em - e_ep, inverse FFT over the samples."""
    t = engine.topo
    dev = psi.device
    pe = _ext(psi).conj()
    gv = pe[..., torch.as_tensor(np.asarray(t.vs_k, np.int64), device=dev)]
    gi = (pe[..., torch.as_tensor(np.asarray(t.is_em, np.int64), device=dev)]
          - pe[..., torch.as_tensor(np.asarray(t.is_ep, np.int64),
                                    device=dev)])
    def coeffs(g):
        # a deck without sources of one class has nothing to transform
        c = torch.fft.ifft(g, dim=-2) if g.shape[-1] else g
        return c[..., bins, :].cpu().numpy()
    return coeffs(gv), coeffs(gi)


@torch.inference_mode()
def pxf(engine: Engine, params, f0: float, xs_pss, deltas,
        out_eq: int, ref_eq: int = -1,
        n_sidebands: Optional[int] = None) -> PXFResult:
    """Periodic transfer functions, the adjoint of PAC: from every
    independent source, injected at every sideband m*f0 + delta, to V(out[,
    ref]) read at delta, from one adjoint solve J(delta)^H Psi = 1_K (x) c
    per offset:

        H_m(u) = (1/K) sum_t conj(Psi_t) . u e^{2 pi i m t/K}
               = ifft_t[conj(Psi_t) . u][m]

    for the V-source branch rows (u = e_{vs_k}) and the I-source pairs (u =
    e_em - e_ep).  Unit inputs: xf_v in V/V, xf_i in V/A."""
    N = engine.N
    J0, CI, K, tl = lptv_operator(engine, params, f0, xs_pss)
    psi = _lptv_solve(*_lanes(J0, CI, tl), deltas,
                      _adjoint_rhs(engine, K, out_eq, ref_eq),
                      adjoint=True)[0, ..., 0].unflatten(-1, (K, N))
    harmonics, bins = _harmonics(K, n_sidebands)
    xf_v, xf_i = _pxf_readout(engine, psi, bins)
    return PXFResult(f0=f0, deltas=np.asarray(deltas, float),
                     harmonics=harmonics, xf_v=xf_v, xf_i=xf_i,
                     xs_pss=xs_pss)


@torch.inference_mode()
def pnoise(engine: Engine, params, f0: float, xs_pss, deltas,
           out_eq: int, ref_eq: int = -1) -> PNoiseResult:
    """Periodic (cyclostationary) noise at V(out[, ref]) for offsets deltas
    from DC: the time-averaged output PSD of the driven circuit with the
    noise folded from every sideband.  One adjoint solve per offset; a
    white source of intensity s_j(t) contributes (1/K) sum_t |Psi_t .
    u_j|^2 s_j(t), so shot noise follows the instantaneous operating
    point.  Flicker terms are stationary at the averaged intensity with
    the 1/delta envelope (no flicker folding)."""
    deltas = _check_deltas(deltas)
    N = engine.N
    J0, CI, K, tl = lptv_operator(engine, params, f0, xs_pss)
    pairs, s_white, s_flick, kinds = _noise_intensities(
        engine, params, _samples(engine, xs_pss))
    psi = _lptv_solve(*_lanes(J0, CI, tl), deltas,
                      _adjoint_rhs(engine, K, out_eq, ref_eq),
                      adjoint=True)[0, ..., 0].unflatten(-1, (K, N))
    onoise, by_kind = _by_kind(
        _adjoint_psd_at(psi, pairs, s_white, s_flick, deltas), kinds)
    return PNoiseResult(f0=f0, deltas=deltas, onoise=onoise, by_kind=by_kind)


def _nf_parts(psi, pairs, s_white, s_flick, delta: float, src_idx: int,
              sidebands):
    """(onoise (...), sig (...)) of the conversion noise figure from the
    adjoint envelope psi (..., K, N) at IF = delta: the folded total, and
    generator src_idx's share through the given sidebands (Parseval:
    mean|g|^2 = sum_m |c_m|^2), its intensity cycle-averaged."""
    K = psi.shape[-2]
    onoise = _adjoint_psd_at(psi[..., None, :, :], pairs, s_white, s_flick,
                             [delta])[..., 0, :].sum(-1)
    pe = _ext(psi)
    a, b = (int(v) for v in np.asarray(pairs)[src_idx])
    coeff = torch.fft.fft(pe[..., a] - pe[..., b], dim=-1) / K
    s_src = (s_white[..., src_idx] + s_flick[..., src_idx] / delta).mean(-1)
    sig = sum(coeff[..., m % K].abs() ** 2 for m in sidebands) * s_src
    return onoise, sig


def _check_src(pairs, src_idx: int):
    if not (0 <= src_idx < len(pairs)):
        raise ValueError(f"src_idx {src_idx} outside the generator "
                         f"catalog (nS={len(pairs)})")


@torch.inference_mode()
def mixer_noise_figure(engine: Engine, params, f0: float, xs_pss,
                       delta: float, out_eq: int, src_idx: int,
                       sidebands=(1,), ref_eq: int = -1):
    """Conversion noise figure at IF = delta: F = the total output noise
    PSD (pnoise, every sideband folded) over the part that generator
    column src_idx (the reference source, e.g. a source resistor's 4kT/R)
    contributes through the signal sideband(s) only: SSB with
    sidebands=(1,) (input at f0 + delta), DSB with (1, -1).  Returns
    (nf_db, onoise_total, onoise_src_signal)."""
    N = engine.N
    J0, CI, K, tl = lptv_operator(engine, params, f0, xs_pss)
    pairs, s_white, s_flick, _ = _noise_intensities(
        engine, params, _samples(engine, xs_pss))
    _check_src(pairs, src_idx)
    psi = _lptv_solve(*_lanes(J0, CI, tl), [float(delta)],
                      _adjoint_rhs(engine, K, out_eq, ref_eq),
                      adjoint=True)[0, 0, :, 0].unflatten(-1, (K, N))
    onoise, sig = _nf_parts(psi, pairs, s_white, s_flick, float(delta),
                            src_idx, sidebands)
    onoise, sig = float(onoise), float(sig)
    if sig <= 0.0:
        raise ValueError("the reference generator contributes nothing "
                         "through the requested sideband(s)")
    return 10.0 * np.log10(onoise / sig), onoise, sig


# ------------------------------------------------------------------ batched
def make_lptv_blocks_fn(engine: Engine, f0: float, K: int):
    """blocks(bparams, xs_b) -> (J0 (B, KN, KN), CI (B, K, N, N), tl): the
    operator of ``lptv_operator`` for B lanes at once (params with a
    leading lane axis, xs_b (B, K, N)); tl's taus and delay blocks carry
    the lane axis, so tl_td and tl_z0 may vary per lane.  Shared by the
    batched PAC, PXF, PNOISE and hot S-parameters."""
    def blocks(bparams, xs_b):
        J0, CI, K_, tl = lptv_operator(engine, bparams, f0, xs_b)
        if K_ != K:
            raise ValueError(f"PSS samples have K={K_}, expected {K}")
        return J0, CI, tl
    return blocks


def _lane_chunk(KN: int, F: int, P: int, B: int, dtype, device) -> int:
    """Lanes whose operators (J0, CI, delay blocks) and F complex systems
    fit in half the card's free memory at once; all of them on the host.
    ``_lptv_solve`` cuts the systems of a chunk further if it must."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return B
    r = torch.empty((), dtype=dtype).element_size()
    per = (KN * KN * r + F * (2 * KN * KN + 2 * KN * P) * 2 * r)
    free, _ = torch.cuda.mem_get_info(dev)
    return max(1, min(B, int(free // 2 // per)))


def _over_lanes(engine: Engine, bparams, xs_b, F: int, P: int, fn):
    """fn(params chunk, xs chunk) over lane chunks (``_lane_chunk``),
    its tensor results concatenated on the lane axis."""
    X = _samples(engine, xs_b)
    B, K, N = X.shape
    c = _lane_chunk(K * N, F, P, B, engine.dtype, engine.device)
    outs = []
    for lo in range(0, B, c):
        outs.append(fn({k: v[lo:lo + c] for k, v in bparams.items()},
                       X[lo:lo + c]))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def make_pac_batched_fn(engine: Engine, f0: float, K: int, deltas,
                        adjoint_rhs=None):
    """lane(bparams, xs_b) -> (B, F, K, N) complex envelope samples of
    every lane's LPTV solves: forward (adjoint_rhs None: the right-hand
    side from each lane's AC source specs, batched PAC) or adjoint
    (adjoint_rhs the (N,) output selector c: J(d)^H psi = 1_K (x) c,
    batched PXF and mixer noise figure; returned without conjugation, as
    JAX's).  The FFT read-outs stay with the callers."""
    N = engine.N
    blocks = make_lptv_blocks_fn(engine, f0, K)
    deltas = np.asarray(deltas, float)
    adjoint = adjoint_rhs is not None

    def chunk(bp, X):
        J0, CI, tl = blocks(bp, X)
        if adjoint:
            c = torch.as_tensor(np.asarray(adjoint_rhs, float),
                                dtype=engine.dtype, device=engine.device)
            rhs = c.repeat(K)[None, :, None]
        else:
            rhs = _ac_input(engine, bp).repeat(1, K)[..., None]
        Y = _lptv_solve(J0, CI, tl, deltas, rhs, adjoint=adjoint)
        return Y[..., 0].unflatten(-1, (K, N))

    def lane(bparams, xs_b):
        with torch.inference_mode():
            return _over_lanes(engine, bparams, xs_b, len(deltas), 1, chunk)

    return lane


def make_pnoise_batched_fn(engine: Engine, f0: float, K: int,
                           out_eq: int, ref_eq: int, deltas,
                           params_probe):
    """(fn, kinds): fn(bparams, xs_b) -> (B, F, nS) per-source PSD
    contributions of every lane's adjoint LPTV solves (pnoise's math, the
    lane axis added); kinds the generator catalog's device kinds (static
    over the lanes; params_probe is any one lane)."""
    from .noise import _device_noise_currents
    N = engine.N
    deltas = _check_deltas(deltas)
    blocks = make_lptv_blocks_fn(engine, f0, K)
    _, _, _, kinds = _device_noise_currents(
        engine, params_probe, torch.zeros(N, dtype=engine.dtype,
                                   device=engine.device))

    def chunk(bp, X):
        J0, CI, tl = blocks(bp, X)
        pairs, s_white, s_flick, _ = _noise_intensities(engine, bp, X,
                                                        lanes=True)
        psi = _lptv_solve(J0, CI, tl, deltas,
                          _adjoint_rhs(engine, K, out_eq, ref_eq),
                          adjoint=True)[..., 0].unflatten(-1, (K, N))
        return _adjoint_psd_at(psi, pairs, s_white, s_flick, deltas)

    def fn(bparams, xs_b):
        with torch.inference_mode():
            return _over_lanes(engine, bparams, xs_b, len(deltas), 1, chunk)

    return fn, kinds


def pac_batched(engine: Engine, bparams, f0: float, xs_pss_b, deltas,
                n_sidebands: Optional[int] = None) -> PACBatchResult:
    """Monte-Carlo periodic AC: B lanes' conversion gains around their own
    periodic steady states xs_pss_b (B, K, N), every (lane, offset) LPTV
    solve one system of the batched solves."""
    K = int(xs_pss_b.shape[1])
    Y = make_pac_batched_fn(engine, f0, K, deltas)(bparams, xs_pss_b)
    harmonics, bins = _harmonics(K, n_sidebands)
    coeff = torch.fft.fft(Y, dim=2) / K                     # (B, F, K, N)
    return PACBatchResult(f0=f0, deltas=np.asarray(deltas, float),
                          harmonics=harmonics,
                          spectrum=coeff[:, :, bins].cpu().numpy(),
                          xs_pss=xs_pss_b)


def pxf_batched(engine: Engine, bparams, f0: float, xs_pss_b, deltas,
                out_eq: int, ref_eq: int = -1,
                n_sidebands: Optional[int] = None) -> PXFBatchResult:
    """Monte-Carlo periodic transfer functions: every lane's full source x
    sideband -> output table from batched adjoint LPTV solves (see pxf for
    the math)."""
    K = int(xs_pss_b.shape[1])
    c = _selector(engine, out_eq, ref_eq).cpu().numpy()
    Psi = make_pac_batched_fn(engine, f0, K, deltas, adjoint_rhs=c)(
        bparams, xs_pss_b)                                  # (B, F, K, N)
    harmonics, bins = _harmonics(K, n_sidebands)
    with torch.inference_mode():
        xf_v, xf_i = _pxf_readout(engine, Psi, bins)
    return PXFBatchResult(f0=f0, deltas=np.asarray(deltas, float),
                          harmonics=harmonics, xf_v=xf_v, xf_i=xf_i)


def pnoise_batched(engine: Engine, bparams, f0: float, xs_pss_b, deltas,
                   out_eq: int, ref_eq: int = -1) -> PNoiseBatchResult:
    """Monte-Carlo periodic noise: B lanes of perturbed params (leading
    lane axis) each around its own periodic steady state xs_pss_b (B, K, N)
    (e.g. HBBatchResult.xs); every (lane, offset) adjoint solve one system
    of the batched solves, the (B, F, nS) contributions summed by kind on
    the host."""
    deltas = _check_deltas(deltas, "pnoise offsets must be > 0 (the "
                                   "flicker 1/delta envelope diverges at "
                                   "DC)")
    K = int(xs_pss_b.shape[1])
    fn, kinds = make_pnoise_batched_fn(
        engine, f0, K, out_eq, ref_eq, deltas,
        {k: v[0] for k, v in bparams.items()})
    onoise, by_kind = _by_kind(fn(bparams, xs_pss_b), kinds)
    return PNoiseBatchResult(f0=f0, deltas=deltas, onoise=onoise,
                             by_kind=by_kind)


def mixer_noise_figure_batched(engine: Engine, bparams, f0: float,
                               xs_pss_b, delta: float, out_eq: int,
                               src_idx: int, sidebands=(1,),
                               ref_eq: int = -1):
    """Monte-Carlo conversion noise figure: every lane's folded pnoise
    total and reference-generator sideband share from one batched adjoint
    LPTV solve at IF = delta (mixer_noise_figure's math, the lane axis
    added).  A lane whose reference generator contributes nothing gets NaN
    (with a warning) instead of aborting the batch.  Returns (nf_db (B,),
    onoise (B,), sig (B,))."""
    from .noise import _device_noise_currents
    N = engine.N
    K = int(xs_pss_b.shape[1])
    pairs, _, _, _ = _device_noise_currents(
        engine, {k: v[0] for k, v in bparams.items()},
        torch.zeros(N, dtype=engine.dtype, device=engine.device))
    _check_src(pairs, src_idx)
    c = _selector(engine, out_eq, ref_eq).cpu().numpy()
    Psi = make_pac_batched_fn(engine, f0, K, [float(delta)],
                              adjoint_rhs=c)(bparams, xs_pss_b)[:, 0]
    with torch.inference_mode():
        _, s_white, s_flick, _ = _noise_intensities(
            engine, bparams, _samples(engine, xs_pss_b), lanes=True)
        onoise, sig = _nf_parts(Psi, pairs, s_white, s_flick, float(delta),
                                src_idx, sidebands)
    onoise, sig = onoise.cpu().numpy(), sig.cpu().numpy()
    bad = sig <= 0.0
    if np.any(bad):
        import warnings
        warnings.warn(
            f"{int(bad.sum())}/{bad.size} lane(s): the reference "
            f"generator contributes nothing through the requested "
            f"sideband(s); their NF is NaN", stacklevel=2)
        sig = np.where(bad, np.nan, sig)
    with np.errstate(invalid="ignore", divide="ignore"):
        nf_db = 10.0 * np.log10(onoise / sig)
    return nf_db, onoise, sig
