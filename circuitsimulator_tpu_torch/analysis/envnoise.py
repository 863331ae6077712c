"""Envelope noise: time-resolved cyclostationary noise along a
modulated-carrier (envelope) trajectory (port of
``circuitsimulator_tpu/analysis/envnoise.py``).

At each selected envelope time t1 the circuit is taken as instantaneously
periodic at the envelope state X(t1) (the adiabatic approximation, valid
while |dX/dt1| / |X| << delta), and the output noise PSD at offset delta
comes from pnoise's adjoint LPTV solve (``pac.py``) built around X(t1):

    J(t1, delta)^H Psi = 1_K (x) e_out,
    S_out(t1, delta) = (1/K) sum_k |Psi_k . u_j|^2 s_j(x_k(t1))

with the device noise intensities at the instantaneous envelope samples.
The selected t1 are lanes of one operator build and every (t1, delta)
pair one system of the batched solve.  Flicker terms as in pnoise;
offsets must be > 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.assemble import Engine
from .envelope import EnvelopeResult
from .pac import (_adjoint_psd_at, _adjoint_rhs, _by_kind, _check_deltas,
                  _lptv_solve, _noise_intensities, _samples, lptv_operator)


@dataclasses.dataclass
class EnvelopeNoiseResult:
    f0: float
    t1: np.ndarray            # (T1s,) envelope times analysed
    deltas: np.ndarray        # (F,) offset frequencies
    onoise: np.ndarray        # (T1s, F) output noise PSD, V^2/Hz
    by_kind: dict             # device-kind -> (T1s, F) PSD contribution


@torch.inference_mode()
def envelope_noise(engine: Engine, params, env: EnvelopeResult,
                   deltas, out_eq: int, ref_eq: int = -1,
                   t1_idx=None) -> EnvelopeNoiseResult:
    """Time-resolved output noise PSD at V(out[, ref]) along the envelope
    trajectory ``env`` (analysis/envelope.envelope_transient).  deltas are
    offsets from the carrier grid (as pnoise); t1_idx selects envelope
    steps (default all of them)."""
    deltas = np.atleast_1d(np.asarray(deltas, float))
    deltas = _check_deltas(deltas, "envelope_noise offsets must be > 0 "
                                   "(the flicker 1/delta envelope diverges "
                                   "at DC), like pnoise")
    xs = np.asarray(env.xs)                       # (T1, K, N)
    idx = (np.arange(xs.shape[0]) if t1_idx is None
           else np.atleast_1d(np.asarray(t1_idx, int)))
    N = engine.N
    X = _samples(engine, xs[idx])                 # (T1s, K, N)
    K = X.shape[1]
    J0, CI, _, tl = lptv_operator(engine, params, env.f0, X)
    pairs, s_white, s_flick, kinds = _noise_intensities(engine, params, X)
    psi = _lptv_solve(J0, CI, tl, deltas,
                      _adjoint_rhs(engine, K, out_eq, ref_eq),
                      adjoint=True)[..., 0].unflatten(-1, (K, N))
    onoise, by_kind = _by_kind(
        _adjoint_psd_at(psi, pairs, s_white, s_flick, deltas), kinds)
    return EnvelopeNoiseResult(
        f0=env.f0, t1=np.asarray(env.t1)[idx], deltas=deltas,
        onoise=onoise, by_kind=by_kind)
