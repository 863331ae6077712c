"""Small-signal noise analysis (``.NOISE``); port of
``circuitsimulator_tpu/analysis/noise.py``.

At the DC operating point every physical noise generator is an independent
current source across a device's terminals with a known PSD:

- resistor thermal:      S = 4kT/R                    (across the R)
- diode shot:            S = 2q|Id|                   (across the junction)
- MOS channel thermal:   S = (8/3)kT*gm               (drain-source)
- JFET channel thermal:  S = (8/3)kT*gm               (drain-source)
- MOS flicker:           S = KF*|Id|^AF / f           (drain-source)
- BJT collector shot:    S = 2q|Ic|                   (collector-emitter)
- BJT base shot:         S = 2q|Ib|                   (base-emitter)

One adjoint solve per frequency gives every transfer at once:

    Y(w)^T y = e_out  =>  the V(out) response to a unit current injected
                          at nodes (a, b) is y[a] - y[b]

so S_out(w) = sum_i S_i |y[a_i] - y[b_i]|^2; the input-referred noise
divides by |H|^2, read off the same y (y[branch] for a V-source input,
y[m] - y[p] for a current source).  Without T-lines Y^T = G1^T + jw B1^T
holds for every frequency, so the whole sweep is one K3 launch
(``ops/ac_sweep.ac_sweep`` on the transposed unit-w assembly); a T-line
deck assembles each frequency and solves the transposed real 2N systems on
K2 (``ac.rhs_sweep``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models.bjt import bjt_linearize
from ..models.diode import diode_linearize
from ..models.mosfet import mos_linearize
from ..ops.assemble import Engine
from .ac import _omegas, rhs_sweep
from .dc import dc_operating_point
from .sensitivity import _unit

K_BOLTZ = 1.380649e-23
Q_ELEM = 1.602176634e-19
# default noise temperature: consistent with the device models' thermal
# voltage (VT_THERMAL = kT/q -> T ~= 300.0 K); the .TEMP card rescales both
T_NOISE = 0.025852 * Q_ELEM / K_BOLTZ


@dataclasses.dataclass
class NoiseResult:
    freqs: Any        # (F,) numpy
    onoise: Any       # (F,) total output noise PSD, V^2/Hz
    by_class: Any     # dict kind -> (F,) PSD contribution (kinds R/M/D/Q)
    gain: Any         # (F,) complex gain from the input source, or None
    inoise: Any       # (F,) input-referred PSD, or None
    s_dev: Any = None    # (F, nS) per-generator PSDs (per_device=True)
    kinds: Any = None    # nS generator kind labels, concatenation order


def _device_noise_currents(engine: Engine, params, x_op):
    """Static per-device PSD terms at the operating point.

    Returns (pairs, S_white, S_flicker, kinds): pairs is an int (nS, 2)
    array of (a, b) extended equation indices, S_* are (nS,) PSDs (flicker
    terms are divided by f at sweep time)."""
    t = engine.topo
    opts = engine.opts
    xe = engine.x_ext(x_op)
    temp = params["vt_thermal"] * Q_ELEM / K_BOLTZ     # .TEMP-aware kelvin
    four_kt = 4.0 * K_BOLTZ * temp
    pairs, s_white, s_flick, kinds = [], [], [], []

    r = params["res_r"]
    if engine.res_tc:
        dt_ = params["temp_delta_c"]
        r = r * (1.0 + params["res_tc1"] * dt_
                 + params["res_tc2"] * dt_ * dt_)
    if r.shape[-1]:
        g = torch.where(r > 0.0, 1.0 / torch.where(r > 0.0, r, 1.0), 0.0)
        pairs.append(np.stack([t.res_e1, t.res_e2], 1))
        s_white.append(four_kt * g)
        s_flick.append(torch.zeros_like(g))
        kinds += ["R"] * len(t.res_e1)

    if len(t.mos_ed):
        vd, vg, vs = xe[..., t.mos_ed], xe[..., t.mos_eg], xe[..., t.mos_es]
        gd, gg, gs, cst = mos_linearize(
            params["mos_vth"], params["mos_k"], params["mos_lam"],
            params["mos_p"], vd, vg, vs, opts.mos_off_gds,
            opts.mos_reverse_region,
            gamma=params["mos_gamma"] if engine.mos_body else None,
            phi=params["mos_phi"] if engine.mos_body else None)
        i_d = gd * vd + gg * vg + gs * vs + cst
        pairs.append(np.stack([t.mos_ed, t.mos_es], 1))
        s_white.append((2.0 / 3.0) * four_kt * torch.abs(gg))
        s_flick.append(params["mos_kf"] * torch.abs(i_d) ** params["mos_af"])
        kinds += ["M"] * len(t.mos_ed)

    if len(t.jf_ed):
        vd, vg, vs = xe[..., t.jf_ed], xe[..., t.jf_eg], xe[..., t.jf_es]
        _, gg, _, _ = mos_linearize(
            params["jf_vto"], 2.0 * params["jf_beta"], params["jf_lam"],
            params["jf_p"], vd, vg, vs, opts.mos_off_gds,
            opts.mos_reverse_region)
        gm = torch.abs(gg)
        pairs.append(np.stack([t.jf_ed, t.jf_es], 1))
        s_white.append((2.0 / 3.0) * four_kt * gm)     # channel thermal
        s_flick.append(torch.zeros_like(gm))
        kinds += ["J"] * len(t.jf_ed)

    if len(t.dio_ep):
        vp, vm = xe[..., t.dio_ep], xe[..., t.dio_em]
        g, cst = diode_linearize(params["dio_is"], params["dio_n"], vp, vm,
                                 vt=params["vt_thermal"])
        i_d = g * (vp - vm) + cst
        pairs.append(np.stack([t.dio_ep, t.dio_em], 1))
        s_white.append(2.0 * Q_ELEM * torch.abs(i_d))
        s_flick.append(torch.zeros_like(g))
        kinds += ["D"] * len(t.dio_ep)

    if len(t.bjt_ec):
        vc, vb, ve = xe[..., t.bjt_ec], xe[..., t.bjt_eb], xe[..., t.bjt_ee]
        # the JAX package linearises without VAF here; so does the port
        rc, rb = bjt_linearize(params["bjt_is"], params["bjt_bf"],
                               params["bjt_br"], params["bjt_p"],
                               vc, vb, ve, vt=params["vt_thermal"])
        i_c = rc[0] * vc + rc[1] * vb + rc[2] * ve + rc[3]
        i_b = rb[0] * vc + rb[1] * vb + rb[2] * ve + rb[3]
        pairs.append(np.stack([t.bjt_ec, t.bjt_ee], 1))
        s_white.append(2.0 * Q_ELEM * torch.abs(i_c))
        s_flick.append(torch.zeros_like(i_c))
        kinds += ["Q"] * len(t.bjt_ec)
        pairs.append(np.stack([t.bjt_eb, t.bjt_ee], 1))
        s_white.append(2.0 * Q_ELEM * torch.abs(i_b))
        s_flick.append(torch.zeros_like(i_b))
        kinds += ["Q"] * len(t.bjt_eb)

    if not pairs:
        z = torch.zeros((0,), dtype=engine.dtype, device=engine.device)
        return np.zeros((0, 2), np.int64), z, z, []
    # x_op may carry sample axes that the resistors' params-only terms
    # lack: broadcast every part to one lead before concatenating
    lead = torch.broadcast_shapes(*(s.shape[:-1] for s in s_white + s_flick))
    return (np.concatenate(pairs).astype(np.int64),
            torch.cat([s.expand(lead + s.shape[-1:]) for s in s_white], -1),
            torch.cat([s.expand(lead + s.shape[-1:]) for s in s_flick], -1),
            kinds)


@torch.inference_mode()
def noise_analysis(engine: Engine, params, freqs, out_eq: int,
                   ref_eq: int = -1,
                   input_ref: Optional[Tuple] = None,
                   x_op: Optional[Any] = None,
                   per_device: bool = False) -> NoiseResult:
    """Output (and optionally input-referred) noise over a frequency sweep.

    out_eq/ref_eq: node equation indices of the output probe V(out, ref);
    ref_eq < 0 means ground.  input_ref identifies the input source for
    gain referral: ("v", branch_eq) or ("i", ep, em), or None."""
    if x_op is None:
        x_op = dc_operating_point(engine, params)
    f, om = _omegas(engine, freqs)
    pairs, s_white, s_flick, kinds = _device_noise_currents(
        engine, params, x_op)
    a_idx = torch.as_tensor(pairs[:, 0], device=engine.device)
    b_idx = torch.as_tensor(pairs[:, 1], device=engine.device)

    # Y^T y = e_out at every frequency: one K3 launch (K2 for T-lines)
    yr, yi = rhs_sweep(engine, params, x_op, om,
                       _unit(engine, out_eq, ref_eq), transpose=True)
    yre, yie = engine.x_ext(yr), engine.x_ext(yi)               # (F, N+1)
    tr2 = ((yre[:, a_idx] - yre[:, b_idx]) ** 2
           + (yie[:, a_idx] - yie[:, b_idx]) ** 2)            # |transfer|^2
    s_dev = (s_white + s_flick / torch.clamp(f, min=1e-30)[:, None]) * tr2
    onoise = s_dev.sum(-1)
    s_np = s_dev.cpu().numpy()
    on_np = onoise.cpu().numpy()
    by_class = {}
    kind_arr = np.asarray(kinds)
    for k in ("R", "M", "D", "Q"):
        sel = np.nonzero(kind_arr == k)[0]
        if len(sel):
            by_class[k] = s_np[:, sel].sum(-1)
    gain = inoise = None
    if input_ref is not None:
        if input_ref[0] == "v":
            g_re, g_im = yre[:, input_ref[1]], yie[:, input_ref[1]]
        else:
            g_re = yre[:, input_ref[2]] - yre[:, input_ref[1]]
            g_im = yie[:, input_ref[2]] - yie[:, input_ref[1]]
        gain = g_re.cpu().numpy() + 1j * g_im.cpu().numpy()
        inoise = on_np / np.maximum(np.abs(gain) ** 2, 1e-300)
    return NoiseResult(freqs=f.cpu().numpy(), onoise=on_np,
                       by_class=by_class, gain=gain, inoise=inoise,
                       s_dev=s_np if per_device else None,
                       kinds=kinds if per_device else None)


def write_noise_csv(path: str, result: NoiseResult) -> None:
    """CSV schema: freq, onoise (V^2/Hz), onoise_sqrt (V/sqrt(Hz)),
    per-class columns, then inoise/gain when an input source was given."""
    freqs = np.asarray(result.freqs)
    on = np.asarray(result.onoise)
    cls = {k: np.asarray(v) for k, v in result.by_class.items()}
    has_in = result.inoise is not None
    cols = ["freq", "onoise", "onoise_sqrt"]
    cols += [f"onoise_{k}" for k in sorted(cls)]
    if has_in:
        cols += ["inoise", "inoise_sqrt", "gain_mag"]
        inoise = np.asarray(result.inoise)
        gmag = np.abs(np.asarray(result.gain))
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for i, fr in enumerate(freqs):
            row = [f"{fr:.9e}", f"{on[i]:.9e}", f"{np.sqrt(on[i]):.9e}"]
            row += [f"{cls[k][i]:.9e}" for k in sorted(cls)]
            if has_in:
                row += [f"{inoise[i]:.9e}", f"{np.sqrt(inoise[i]):.9e}",
                        f"{gmag[i]:.9e}"]
            f.write(",".join(row) + "\n")
