"""Vectorized independent-source waveforms (PULSE, SIN, PWL, EXP, SFFM).

Port of ``circuitsimulator_tpu/models/sources.py``, formula for formula
(reference: sim.hpp:75-162).  Parameters are struct-of-arrays over the
sources of a class, with any leading lane axes; ``t`` is a scalar tensor.

  kind : (..., nS) int32   0=NONE 1=PULSE 2=SIN 3=PWL 4=EXP 5=SFFM
  pulse: (..., nS, 7) [v1, v2, td, tr, tf, ton, per]  (EXP: v1 v2 td1 tau1 td2 tau2)
  sin  : (..., nS, 5) [v0, va, freq, td, phi]          (SFFM: vo va fc mdi fs)
  pwl_t, pwl_v: (..., nS, P) padded; pwl_n: (..., nS) valid count
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..netlist import WAVE_PULSE, WAVE_SIN, WAVE_PWL, WAVE_EXP, WAVE_SFFM


def _clamp01(x):
    return torch.clamp(x, 0.0, 1.0)


def _safe_div(num, den):
    """num/den with den == 0 mapped to +/-inf by the sign of num (IEEE x/0,
    like the C++ evaluators) except that 0/0 gives +inf, not NaN."""
    inf = torch.full_like(num, math.inf)
    zero_den = torch.where(num < 0.0, -inf, inf)
    nz = den != 0.0
    return torch.where(nz, num / torch.where(nz, den, 1.0), zero_den)


def eval_pulse(pulse, t):
    v1, v2, td, tr, tf, ton, per = pulse.unbind(-1)
    # single-shot branch (per <= 0), sim.hpp:81-95
    tau1 = t - td
    rise1 = v1 + _clamp01(_safe_div(tau1, tr)) * (v2 - v1)
    tfall1 = tau1 - (tr + ton)
    fall1 = v2 + _clamp01(_safe_div(tfall1, tf)) * (v1 - v2)
    single = torch.where(
        tau1 <= 0.0, v1,
        torch.where(tau1 < tr, rise1,
                    torch.where(tau1 < tr + ton, v2, fall1)))
    # periodic branch (per > 0), sim.hpp:96-114; remainder is in [0, per)
    safe_per = torch.where(per > 0.0, per, 1.0)
    tau2 = torch.remainder(t - td, safe_per)
    rise2 = v1 + (v2 - v1) * _clamp01(_safe_div(tau2, tr))
    tfall2 = tau2 - (tr + ton)
    fall2 = v2 + (v1 - v2) * _clamp01(_safe_div(tfall2, tf))
    periodic = torch.where(
        t < td, v1,
        torch.where(tau2 < tr, rise2,
                    torch.where(tau2 < tr + ton, v2,
                                torch.where(tau2 < tr + ton + tf, fall2, v1))))
    return torch.where(per <= 0.0, single, periodic)


def eval_sin(sin, t):
    v0, va, freq, td, phi = sin.unbind(-1)
    tau = t - td
    w = 2.0 * math.pi * freq
    return torch.where(t < td, v0, v0 + va * torch.sin(w * tau + phi))


def eval_pwl(pwl_t, pwl_v, pwl_n, t):
    P = pwl_t.shape[-1]
    idx = torch.arange(P, device=pwl_t.device)
    n = pwl_n.to(torch.int64)
    valid = idx < n[..., None]
    big = torch.finfo(pwl_t.dtype).max
    tt = torch.where(valid, pwl_t, big)
    # i = (# of breakpoints with tt[i] < t) - 1: the reference's
    # "tt[i] < t <= tt[i+1]" scan (sim.hpp:131-136)
    cnt = ((tt < t) & valid).sum(-1)
    i = torch.clamp(cnt - 1, 0, P - 1)[..., None]
    ip1 = torch.clamp(cnt, 0, P - 1)[..., None]
    t_i = pwl_t.gather(-1, i)[..., 0]
    t_ip1 = pwl_t.gather(-1, ip1)[..., 0]
    v_i = pwl_v.gather(-1, i)[..., 0]
    v_ip1 = pwl_v.gather(-1, ip1)[..., 0]
    k = _safe_div(t - t_i, t_ip1 - t_i)
    mid = v_i + (v_ip1 - v_i) * k
    first_t = pwl_t[..., 0]
    last = torch.clamp(n - 1, 0, P - 1)[..., None]
    last_t = pwl_t.gather(-1, last)[..., 0]
    first_v = pwl_v[..., 0]
    last_v = pwl_v.gather(-1, last)[..., 0]
    out = torch.where(t <= first_t, first_v,
                      torch.where(t >= last_t, last_v, mid))
    return torch.where(n == 0, torch.zeros_like(out), out)


def eval_exp(pulse, t):
    """EXP(v1 v2 td1 tau1 td2 tau2) packed into the PULSE block."""
    v1, v2, td1, tau1, td2, tau2, _ = pulse.unbind(-1)
    dv = v2 - v1

    def seg(td, tau, amp):
        full = torch.where(t > td, amp, 0.0)
        decay = amp * (1.0 - torch.exp(-torch.clamp_min(t - td, 0.0)
                                       / torch.where(tau > 0.0, tau, 1.0)))
        return torch.where(tau > 0.0, torch.where(t > td, decay, 0.0), full)

    return v1 + seg(td1, tau1, dv) + seg(td2, tau2, -dv)


def eval_sffm(sin, t):
    """SFFM(vo va fc mdi fs) packed into the SIN block."""
    vo, va, fc, mdi, fs = sin.unbind(-1)
    two_pi = 2.0 * math.pi
    return vo + va * torch.sin(two_pi * fc * t
                               + mdi * torch.sin(two_pi * fs * t))


def eval_waveform(kind, pulse, sin, pwl_t, pwl_v, pwl_n, t):
    out = torch.zeros(kind.shape, dtype=pulse.dtype, device=pulse.device)
    out = torch.where(kind == WAVE_PULSE, eval_pulse(pulse, t), out)
    out = torch.where(kind == WAVE_SIN, eval_sin(sin, t), out)
    if pwl_t.shape[-1] > 0:
        out = torch.where(kind == WAVE_PWL,
                          eval_pwl(pwl_t, pwl_v, pwl_n, t), out)
    out = torch.where(kind == WAVE_EXP, eval_exp(pulse, t), out)
    out = torch.where(kind == WAVE_SFFM, eval_sffm(sin, t), out)
    return out


def eval_dc(dc, kind, sin, scale, pulse=None):
    """SourceSpec::evalDC (sim.hpp:152-158): SIN folds its v0 offset in;
    EXP folds v1 and SFFM its carrier offset vo."""
    base = dc + torch.where((kind == WAVE_SIN) | (kind == WAVE_SFFM),
                            sin[..., 0], 0.0)
    if pulse is not None:
        base = base + torch.where(kind == WAVE_EXP, pulse[..., 0], 0.0)
    return base * scale


def eval_tran(dc, kind, pulse, sin, pwl_t, pwl_v, pwl_n, t):
    """SourceSpec::evalTran (sim.hpp:160-162)."""
    return dc + eval_waveform(kind, pulse, sin, pwl_t, pwl_v, pwl_n, t)


def kind_masks(kinds_np, device):
    """(wave, (nS,) bool mask on ``device``) for every waveform kind present
    in the static kind vector (built once per engine: no per-step copy)."""
    kinds_np = np.asarray(kinds_np)
    return tuple((w, torch.as_tensor(kinds_np == w, device=device))
                 for w in (WAVE_PULSE, WAVE_SIN, WAVE_PWL, WAVE_EXP, WAVE_SFFM)
                 if (kinds_np == w).any())


def eval_tran_masked(masks, dc, pulse, sin, pwl_t, pwl_v, pwl_n, t):
    """eval_tran specialised on the kinds present (``kind_masks``): kinds
    are structural (Monte-Carlo lanes perturb floats, never the kind), so
    only the formulas of kinds in the circuit run, added in kind order."""
    fns = {WAVE_PULSE: lambda: eval_pulse(pulse, t),
           WAVE_SIN: lambda: eval_sin(sin, t),
           WAVE_PWL: lambda: eval_pwl(pwl_t, pwl_v, pwl_n, t),
           WAVE_EXP: lambda: eval_exp(pulse, t),
           WAVE_SFFM: lambda: eval_sffm(sin, t)}
    out = dc
    for wave, mask in masks:
        if wave == WAVE_PWL and pwl_t.shape[-1] == 0:
            continue
        out = out + torch.where(mask, fns[wave](), 0.0)
    return out


def eval_tran_static_kinds(kinds_np, dc, pulse, sin, pwl_t, pwl_v, pwl_n, t):
    """eval_tran specialised on a static (numpy) kind vector."""
    return eval_tran_masked(kind_masks(kinds_np, dc.device), dc, pulse, sin,
                            pwl_t, pwl_v, pwl_n, t)
