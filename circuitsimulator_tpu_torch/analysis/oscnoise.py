"""Oscillator phase noise by the perturbation projection vector (PPV),
Floquet stability of a driven periodic steady state and the Adler
injection-lock range (port of ``circuitsimulator_tpu/analysis/
oscnoise.py``).

Method (Demir/Mehrotra/Roychowdhury 2000, on the engine's own trapezoidal
step map):

- The converged limit cycle from shooting (``sstate.oscillator_steady_
  state``) gives the K per-step states s_0..s_K = s_0 of the one-step map
  F.  Per-step Jacobians J_k = dF/ds and injection gains B_k = dF/d(i_inj)
  (the next state's response to a current held between a node pair for
  one step) are the exact derivatives of the unrolled 4-iteration Newton
  map (``_step_jacobians``).
- The PPV is the Floquet left eigenvector of the monodromy M = J_{K-1}
  ... J_0 at eigenvalue 1 (host numpy, float64), carried around the cycle
  by v_k = J_k^T v_{k+1} and normalised so v_k . ds/dt = 1 (the spread of
  that invariant is returned as a diagnostic).
- The phase diffuses with c = (1/T) sum_k sum_src (v_{k+1} . B_k e_src)^2
  S_src(x_k) / (2 dt) (seconds), S_src the .NOISE catalog's one-sided
  PSDs along the cycle (``noise._device_noise_currents``); the spectrum
  is the Lorentzian L(df) = 10 log10(f0^2 c / (pi^2 f0^4 c^2 + df^2)),
  flicker entering as c(df) = c + c_flicker / df.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.assemble import Engine
from ..ops.lu import lu_solve
from .noise import _device_noise_currents
from .sensitivity import _jvp
from .sstate import OscillatorResult, _dyn_mask, _join, _split, osc_engine


@dataclasses.dataclass
class OscPhaseNoiseResult:
    f0: Any            # oscillation frequency (Hz)
    c: Any             # white phase-diffusion constant (s): var(jitter) = c t
    c_flicker: Any     # flicker coefficient (c(df) = c + c_flicker / df)
    offsets: Any       # (F,) offset frequencies (Hz)
    L_dbc: Any         # (F,) single-sideband phase noise L(df), dBc/Hz
    period_jitter: Any  # sqrt(c T): one-period rms jitter (s)
    by_class: Any      # dict kind -> share of c (R/M/J/D/Q/X = extra)
    per_source: Any    # (nS,) per-generator contribution to c
    kinds: Any         # (nS,) generator kind labels
    ppv: Any           # (K+1, n_dyn) normalised PPV over the dynamic
                       # shooting coordinates (the first N are x)
    w: Any             # (K, nS) per-step time shift per injected amp (s/A)
    invariance: Any    # relative spread of v_k . ds_k/dt
    floquet_err: Any   # |lambda_phase - 1| of the monodromy
    lambda2: Any       # second-largest |Floquet multiplier|


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _step_with_injection(engine: Engine, params, dt, n_newton: int = 4,
                         dmax: int = 0):
    """One solve step s -> F(s, t, inj): the ``lu`` transient step with an
    extra current vector inj (..., N) added to the Newton right-hand side,
    Newton unrolled (alpha 1, no clamp).  ``dt`` a 0-dim tensor of the
    working dtype; T-line decks pass dmax = max ticks (the ring rides the
    shooting vector)."""
    opts, N = engine.opts, engine.N
    method = opts.tran_method
    static_I = engine.make_tran_static_I(float(dt), method)
    update_state = engine.make_update_state(dt, method)
    G_static = engine.tran_static_G(params, dt, opts.tran_gmin, method)
    inv_dt = 1.0 / dt if engine.mos_charge else None

    def step(s, t, inj):
        x, state = _split(engine, s, dmax, params)
        I_s = static_I(params, state, t)
        qex = None
        if engine.mos_charge:
            qex = ((state["qm"], inv_dt, state["qi"]) if method == "trap"
                   else (state["qm"], inv_dt))
        for _ in range(n_newton):
            G, I = engine.assemble_tran_iter(G_static, I_s, params, x, t, qex)
            x = lu_solve(G[..., :N, :N], I[..., :N] + inj,
                         opts.lu_pivot_floor)
        return _join(x, update_state(params, x, state))

    return step


def _repropagate(engine: Engine, params, s0, dt, K: int, n_newton: int,
                 dmax: int = 0):
    """(K+1, n_full) states of one period of ``_step_with_injection`` from
    s0, and the step times ts (K,)."""
    dtype, dev = engine.dtype, engine.device
    with torch.inference_mode():
        step = _step_with_injection(engine, params, dt, n_newton, dmax)
        ts = torch.arange(1, K + 1, dtype=dtype, device=dev) * dt
        zero = torch.zeros((engine.N,), dtype=dtype, device=dev)
        ss = [s0]
        for k in range(K):
            ss.append(step(ss[-1], ts[k], zero))
        return torch.stack(ss), ts


def _step_jacobians(engine: Engine, params, dt, ss, ts, dyn, n_newton: int,
                    dmax: int = 0, inj: bool = True):
    """The exact derivatives of the unrolled Newton step map at every step
    of the cycle, all K steps at once: Js (K, n_s, n_s) = dF/ds on the
    dynamic coordinates ``dyn`` and, with ``inj``, Bs (K, n_s, N) =
    dF/d(inj).

    The n_s + N tangent directions ride lanes: each step's state is
    repeated once a direction, and each Newton iteration's tangent is
    dx' = G^-1 (dI + d(inj) - dG x') with (dG, dI) the assembly's own
    tangent (``sensitivity._jvp``) and all directions of all K steps on the
    right-hand side of one ``lu_solve`` (K2 on the card: (K, N, n_s + N));
    the iterate itself is a second solve, (K, N, 1).  The split of the
    shooting vector (the charges q(x) of a charge deck) and the state
    update are differentiated the same way."""
    opts, N = engine.opts, engine.N
    method, floor = opts.tran_method, opts.lu_pivot_floor
    dtype, dev = engine.dtype, engine.device
    K, n_full = ss.shape
    dyn_t = torch.as_tensor(dyn, device=dev)
    n_s = len(dyn)
    D = n_s + (N if inj else 0)
    L = K * D
    static_I = engine.make_tran_static_I(float(dt), method)
    update_state = engine.make_update_state(dt, method)
    G_static = engine.tran_static_G(params, dt, opts.tran_gmin, method)
    inv_dt = 1.0 / dt if engine.mos_charge else None
    tl = ts.clone().repeat_interleave(D)                      # (L,)
    s = ss.clone()[:, None].expand(K, D, n_full).reshape(L, n_full)
    ds = torch.zeros((K, D, n_full), dtype=dtype, device=dev)
    ds[:, torch.arange(n_s, device=dev), dyn_t] = 1.0
    dinj = torch.zeros((K, D, N), dtype=dtype, device=dev)
    if inj:
        dinj[:, torch.arange(n_s, D, device=dev),
             torch.arange(N, device=dev)] = 1.0
    dinj = dinj.reshape(L, N)

    def start(s_):
        x_, st_ = _split(engine, s_, dmax, params)
        return x_, st_, static_I(params, st_, tl[:, None])
    (x, st, I_s), (dx, dst, dI_s) = _jvp(start, (s,), (ds.reshape(L, n_full),))

    def system(x_, st_, I_s_):
        qex = None
        if engine.mos_charge:
            qex = ((st_["qm"], inv_dt, st_["qi"]) if method == "trap"
                   else (st_["qm"], inv_dt))
        G, I = engine.assemble_tran_iter(G_static, I_s_, params, x_, tl, qex)
        return G[..., :N, :N], I[..., :N]

    for _ in range(n_newton):
        (G, I), (dG, dI) = _jvp(system, (x, st, I_s), (dx, dst, dI_s))
        Gk = G.reshape(K, D, N, N)[:, 0]
        xk = lu_solve(Gk, I.reshape(K, D, N)[:, 0], floor).clone()
        x = xk[:, None].expand(K, D, N).reshape(L, N)
        rhs = dI + dinj - (dG @ x[..., None])[..., 0]
        dxk = lu_solve(Gk, rhs.reshape(K, D, N).transpose(1, 2),
                       floor).clone()                          # (K, N, D)
        dx = dxk.transpose(1, 2).reshape(L, N)

    def finish(x_, st_):
        return _join(x_, update_state(params, x_, st_))[..., dyn_t]
    _, dout = _jvp(finish, (x, st), (dx, dst))
    J = dout.reshape(K, D, n_s).transpose(1, 2)                 # (K, n_s, D)
    return J[..., :n_s], (J[..., n_s:] if inj else None)


def _monodromy(Js):
    """M = J_{K-1} ... J_0 on the device, then float64 on the host."""
    M = torch.eye(Js.shape[-1], dtype=Js.dtype, device=Js.device)
    for J in Js:
        M = J @ M
    return _host(M).astype(np.float64)


def _pair_matrix(pairs: np.ndarray, N: int, dtype) -> np.ndarray:
    """(nS, N) injection directions: +1 at eq a, -1 at eq b; the extended
    ground slot (index N) and negative indices drop."""
    E = np.zeros((len(pairs), N), np.float64)
    for i, (a, b) in enumerate(np.asarray(pairs)):
        if 0 <= a < N:
            E[i, a] += 1.0
        if 0 <= b < N:
            E[i, b] -= 1.0
    return E.astype(dtype)


def lorentzian(f0, c, c_fl, offsets):
    """L(df) in dBc/Hz with the 1/f^3 skirt c(df) = c + c_fl / df."""
    c_off = c + c_fl / np.maximum(offsets, 1e-30)
    return 10.0 * np.log10(f0 ** 2 * c_off
                           / (np.pi ** 2 * f0 ** 4 * c ** 2 + offsets ** 2))


def by_class(kinds, per_source) -> dict:
    """Per-class shares of c: R, M, J, D, Q and X (extra generators)."""
    kind_arr = np.asarray(kinds)
    out = {}
    for k in ("R", "M", "J", "D", "Q", "X"):
        sel = np.nonzero(kind_arr == k)[0]
        if len(sel):
            out[k] = float(per_source[sel].sum())
    return out


def noise_generators(engine: Engine, params, xs, extra_pairs=None,
                     extra_psd=None):
    """(E (nS, N) numpy, S_w (K, nS), S_f (K, nS), kinds) of the device
    generators along the samples xs (K, N), plus the extra white
    generators (node-equation pairs, b = -1 ground, one-sided PSDs)."""
    N = engine.N
    K = xs.shape[0]
    pairs, S_w, S_f, kinds = _device_noise_currents(engine, params, xs)
    kinds = list(kinds)
    S_w = S_w.expand((K,) + S_w.shape[-1:])
    S_f = S_f.expand((K,) + S_f.shape[-1:])
    E = _pair_matrix(pairs, N, np.float64)
    if extra_pairs is not None:
        ep = np.asarray(extra_pairs, np.int64).reshape(-1, 2)
        E = np.concatenate([E, _pair_matrix(ep, N, np.float64)])
        sx = torch.as_tensor(np.asarray(extra_psd, np.float64),
                             dtype=S_w.dtype, device=S_w.device)
        S_w = torch.cat([S_w, sx.expand(K, len(ep))], -1)
        S_f = torch.cat([S_f, S_f.new_zeros((K, len(ep)))], -1)
        kinds += ["X"] * len(ep)
    if E.shape[0] == 0:
        raise ValueError("no noise generators: the deck has no noisy "
                         "devices and no extra_pairs were given")
    return E, S_w, S_f, kinds


def oscillator_phase_noise(engine: Engine, params, osc: OscillatorResult,
                           offsets,
                           extra_pairs: Optional[Sequence[Tuple[int, int]]]
                           = None,
                           extra_psd: Optional[Sequence[float]] = None,
                           n_newton: int = 4) -> OscPhaseNoiseResult:
    """Phase noise of a converged autonomous limit cycle (an
    ``OscillatorResult`` with its shooting vector ``s``); offsets (Hz) for
    L(df).  extra_pairs / extra_psd: further white current generators,
    node-equation pairs (b = -1 ground) with one-sided PSDs in A^2/Hz
    (a TRNOISE mirror, or a device the catalog has no PSD for)."""
    if osc.s is None:
        raise ValueError("OscillatorResult has no shooting vector; re-run "
                         "oscillator_steady_state (older result object?)")
    engine = osc_engine(engine)          # the stepping the orbit came from
    dtype, dev = engine.dtype, engine.device
    N = engine.N
    T = 1.0 / float(osc.f0)
    K = len(osc.times) - 1
    dt = torch.tensor(T / K, dtype=dtype, device=dev)
    s0 = torch.as_tensor(osc.s, dtype=dtype, device=dev)
    ss, ts = _repropagate(engine, params, s0, dt, K, n_newton)
    # the Floquet algebra runs on the dynamic coordinates only: zero-C
    # slots flip sign every trapezoidal step, a spurious +1 multiplier
    dyn = np.nonzero(_dyn_mask(engine, params))[0]
    n_s = len(dyn)
    closure = float(torch.linalg.vector_norm(ss[K, dyn] - ss[0, dyn]))
    Js, Bs = _step_jacobians(engine, params, dt, ss[:K], ts, dyn, n_newton)

    Mh = _monodromy(Js)
    evals, evecs_left = np.linalg.eig(Mh.T)   # left eigenvectors of M
    order = np.argsort(np.abs(evals - 1.0))
    i1 = order[0]
    floquet_err = float(np.abs(evals[i1] - 1.0))
    rest = np.abs(evals[np.arange(len(evals)) != i1])
    lambda2 = float(rest.max()) if len(rest) else 0.0
    u = np.real(evecs_left[:, i1])
    u = u / np.linalg.norm(u)

    # the adjoint recursion v_k = J_k^T v_{k+1} around the cycle
    v = torch.as_tensor(u, dtype=dtype, device=dev)
    vs = [v]
    for k in range(K - 1, -1, -1):
        v = Js[k].T @ v
        vs.append(v)
    vs = torch.stack(vs[::-1])                                # (K+1, n_s)
    # v_k . (ds/dt)_k = 1: an invariant of the recursion
    d = (ss[1:, dyn] - ss[:-1, dyn]) / dt
    norms = (vs[:K] * d).sum(-1)
    mean_n = norms.mean()
    invariance = float(norms.std(correction=0) / mean_n.abs())
    vs = vs / mean_n

    E, S_w, S_f, kinds = noise_generators(engine, params, ss[:K, :N],
                                          extra_pairs, extra_psd)
    Et = torch.as_tensor(E, dtype=dtype, device=dev)
    # time shift per injected amp (held one step): w[k, s] = v_{k+1} . B_k e_s
    w = ((Bs @ Et.T) * vs[1:, :, None]).sum(-2)               # (K, nS)
    dtf = float(dt)
    per_src_w = (w * w * S_w).sum(0) / (2.0 * dtf * T)
    per_src_f = (w * w * S_f).sum(0) / (2.0 * dtf * T)
    c = float(per_src_w.sum())
    c_fl = float(per_src_f.sum())
    offsets = np.asarray(offsets, np.float64)
    f0 = float(osc.f0)
    per_source = _host(per_src_w)
    # the shooting steps stop at tran_tol while this re-propagation runs
    # n_newton full iterations: ~1e-3 relative closure is that mismatch
    if closure > 3e-3 * float(torch.linalg.vector_norm(ss[0, dyn])):
        print(f"oscnoise: cycle closure residual {closure:.2e} — the "
              "shooting solution may not be converged", file=sys.stderr)
    return OscPhaseNoiseResult(
        f0=f0, c=c, c_flicker=c_fl, offsets=offsets,
        L_dbc=lorentzian(f0, c, c_fl, offsets),
        period_jitter=float(np.sqrt(max(c, 0.0) * T)),
        by_class=by_class(kinds, per_source), per_source=per_source,
        kinds=np.asarray(kinds), ppv=vs, w=w, invariance=invariance,
        floquet_err=floquet_err, lambda2=lambda2)


@dataclasses.dataclass
class PSSFloquetResult:
    f0: float            # drive frequency the period was solved at
    multipliers: Any     # (n_dyn,) complex Floquet multipliers, |.| falling
    stable: bool         # all |multiplier| < threshold
    lambda_max: float    # largest |multiplier|
    closure: float       # re-propagation closure residual


def pss_floquet(engine: Engine, params, ss,
                f0: Optional[float] = None,
                threshold: float = 1.0 - 1e-6,
                n_newton: int = 4) -> PSSFloquetResult:
    """Floquet stability of a driven periodic steady state (a
    ``SteadyStateResult`` with its shooting vector): the eigenvalues of
    the one-period monodromy dPhi/ds around it.  All |lambda| < threshold:
    an attractor of the transient; |lambda| > 1: a repellor no transient
    settles on; lambda -> -1: period doubling.  The per-step Jacobians are
    ``_step_jacobians``' (the drive's time dependence kept); on a T-line
    deck the delay ring's slots are part of the state."""
    if getattr(ss, "s", None) is None:
        raise ValueError("SteadyStateResult has no shooting vector; "
                         "re-run steady_state (older result object?)")
    f0 = float(f0 if f0 is not None else ss.f0)
    if not f0 or f0 <= 0:
        raise ValueError("pss_floquet needs the drive f0")
    engine = osc_engine(engine)
    dtype, dev = engine.dtype, engine.device
    T = 1.0 / f0
    K = len(ss.times) - 1
    dt = torch.tensor(T / K, dtype=dtype, device=dev)
    dmax = int(engine.tl_ticks(float(dt)).max()) if engine.n_tl else 0
    s0 = torch.as_tensor(ss.s, dtype=dtype, device=dev)
    ss_all, ts = _repropagate(engine, params, s0, dt, K, n_newton, dmax)
    dyn = np.nonzero(_dyn_mask(engine, params, dmax))[0]
    n_s = len(dyn)
    closure = float(torch.linalg.vector_norm(ss_all[K, dyn]
                                             - ss_all[0, dyn]))
    Js, _ = _step_jacobians(engine, params, dt, ss_all[:K], ts, dyn,
                            n_newton, dmax, inj=False)
    evals = np.linalg.eigvals(_monodromy(Js))
    evals = evals[np.argsort(-np.abs(evals))]
    lam = float(np.abs(evals[0])) if n_s else 0.0
    return PSSFloquetResult(f0=f0, multipliers=evals,
                            stable=bool(lam < threshold), lambda_max=lam,
                            closure=closure)


@dataclasses.dataclass
class InjectionLockResult:
    f0: float            # free-running frequency (Hz)
    amp: float           # injected current amplitude (A)
    lock_range_hz: float  # one-sided Adler range: locks for
    #                      |f_inj - m f0| <= lock_range_hz
    k_per_amp: float     # lock range per injected amp, m f0 |p_m| (Hz/A)
    p1: complex          # the m-th Fourier coefficient of the PPV
    #                      projected on the injection port
    harmonic: int        # injection harmonic m (lock near m f0)
    pn: Any              # the underlying phase-noise result


def lock_from_ppv(f0: float, amp: float, m: int, p, pn):
    """The Adler range from the projected PPV samples p (K,) (time shift
    rate per amp): lock for |f_inj - m f0| <= m f0 amp |p_m|."""
    K = len(p)
    p_m = np.mean(p * np.exp(-2j * np.pi * m * np.arange(K) / K))
    k_per_amp = m * f0 * abs(p_m)
    return InjectionLockResult(f0=f0, amp=float(amp),
                               lock_range_hz=k_per_amp * float(amp),
                               k_per_amp=k_per_amp, p1=complex(p_m),
                               harmonic=m, pn=pn)


def check_lock_args(amp: float, harmonic: int) -> int:
    if amp <= 0:
        raise ValueError("injection amplitude must be > 0")
    m = int(harmonic)
    if m < 1:
        raise ValueError("harmonic must be >= 1")
    return m


def injection_lock(engine: Engine, params, osc: OscillatorResult,
                   pair: Tuple[int, int], amp: float,
                   harmonic: int = 1,
                   n_newton: int = 4) -> InjectionLockResult:
    """Adler-type injection-locking range from the oscillator PPV: a
    current amp cos(2 pi f_inj t) into the node-equation pair ``pair`` (b
    may be -1, ground) shifts the phase by p(t) = v(t)^T u per amp second;
    averaged near m f0 only p's m-th Fourier coefficient survives, and
    the oscillator locks for |f_inj - m f0| <= m f0 amp |p_m| (the
    generalised Adler equation).  Subharmonic injection (f0 / m) is
    second order and not covered (``hbosc.subharmonic_lock_hb``)."""
    m = check_lock_args(amp, harmonic)
    K_osc = len(osc.times) - 1
    if 2 * m >= K_osc:
        raise ValueError(
            f"harmonic={m} is at/above the Nyquist limit of the K="
            f"{K_osc}-sample PPV grid: p_m would alias. Re-run "
            "oscillator shooting with more samples per period.")
    pn = oscillator_phase_noise(engine, params, osc,
                                offsets=[float(osc.f0) * 1e-3],
                                extra_pairs=[tuple(pair)],
                                extra_psd=[0.0], n_newton=n_newton)
    w = _host(pn.w)                        # (K, nS); the injection port last
    dt = (1.0 / float(osc.f0)) / w.shape[0]
    return lock_from_ppv(float(osc.f0), amp, m, w[:, -1] / dt, pn)
