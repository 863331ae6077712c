"""Loop-gain / stability analysis by Bode's return ratio; port of
``circuitsimulator_tpu/analysis/loopgain.py``.

For a loop closed through a VCVS (E source), the return ratio comes without
breaking the loop: null the source (gain -> 0), drive its branch equation
with a unit test voltage and read the control voltage the loop returns,

    T(jw) = -gain (V(cp) - V(cm)) |_(gain = 0, V(p, m) = 1).

The unit right-hand side does not depend on w, so the whole sweep is one K3
launch (``ac.rhs_sweep``; a T-line deck solves on K2 per frequency).  Phase
margin is read at the unity-gain crossover (log-f interpolated), gain
margin at the -180 degree crossing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.assemble import Engine
from .ac import _omegas, rhs_sweep
from .sensitivity import _unit


@torch.inference_mode()
def loop_gain(engine: Engine, params, vcvs_index: int, freqs, x_op):
    """Return ratio of the ``vcvs_index``-th E source over ``freqs``:
    complex (F,) numpy T."""
    t = engine.topo
    k = int(t.vcvs_k[vcvs_index])
    cp = int(t.vcvs_ecp[vcvs_index])
    cm = int(t.vcvs_ecm[vcvs_index])
    gain = float(params["vcvs_gain"][vcvs_index])
    p0 = dict(params)
    p0["vcvs_gain"] = params["vcvs_gain"].clone()
    p0["vcvs_gain"][vcvs_index] = 0.0
    _, om = _omegas(engine, freqs)
    xr, xi = rhs_sweep(engine, p0, x_op, om, _unit(engine, k))
    sel = _unit(engine, cp, cm)           # ground (the dump slot N): 0
    vr, vi = xr @ sel, xi @ sel
    return -gain * (vr.cpu().numpy() + 1j * vi.cpu().numpy())


def margins(freqs, T):
    """Phase margin at |T| = 1, gain margin at phase = -180 deg, both
    log-f interpolated; None when the sweep does not cross."""
    freqs = np.asarray(freqs, float)
    mag = np.abs(T)
    ph = np.unwrap(np.angle(T))
    out = {"f_unity": None, "phase_margin_deg": None,
           "f_180": None, "gain_margin_db": None}
    lm = np.log10(mag)
    lf = np.log10(freqs)
    cross = np.flatnonzero((lm[:-1] > 0) & (lm[1:] <= 0))
    if len(cross):
        i = cross[0]
        w = lm[i] / (lm[i] - lm[i + 1])
        lfu = lf[i] + w * (lf[i + 1] - lf[i])
        phu = ph[i] + w * (ph[i + 1] - ph[i])
        out["f_unity"] = 10.0 ** lfu
        out["phase_margin_deg"] = 180.0 + np.degrees(phu)
    target = -np.pi
    cr = np.flatnonzero((ph[:-1] > target) & (ph[1:] <= target))
    if len(cr):
        i = cr[0]
        w = (ph[i] - target) / (ph[i] - ph[i + 1])
        lmx = lm[i] + w * (lm[i + 1] - lm[i])
        out["f_180"] = 10.0 ** (lf[i] + w * (lf[i + 1] - lf[i]))
        out["gain_margin_db"] = -20.0 * lmx
    return out
