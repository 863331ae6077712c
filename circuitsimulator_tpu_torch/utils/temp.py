"""Temperature scaling of junction saturation currents.

Port of ``circuitsimulator_tpu/utils/temp.py``.  Standard SPICE form in
terms of the thermal voltage, so it batches over temperature lanes:

    IS(T) = IS * (vt/vt0)^(xti/n) * exp( (eg/n) * (1/vt0 - 1/vt) )

with vt = kT/q and vt0 the nominal (27 C) thermal voltage.  Opt-in per
model: EG and XTI default to 0 (no scaling), so ``.TEMP`` without them
changes vt only.  Applied to diodes (per-device EG/XTI) and BJTs
(.MODEL EG/XTI).
"""

from __future__ import annotations

import torch

VT_NOMINAL = 0.025852   # models/diode.py VT_THERMAL
K_B, Q_E = 1.380649e-23, 1.602176634e-19


def thermal_params(temp_c: float, dtype, device):
    """The params at temperature ``temp_c`` (C): the thermal voltage kT/q
    and the offset from 27 C, as ``vt_thermal`` and ``temp_delta_c``."""
    return {"vt_thermal": torch.tensor(K_B * (273.15 + temp_c) / Q_E,
                                       dtype=dtype, device=device),
            "temp_delta_c": torch.tensor(temp_c - 27.0, dtype=dtype,
                                         device=device)}


def has_is_temp(params) -> bool:
    """True when any device opts into IS(T) scaling (static, host side)."""
    return any(bool(torch.any(params[k] != 0))
               for k in ("dio_eg", "dio_xti", "bjt_eg", "bjt_xti"))


def apply_is_temp(params):
    """A params dict with dio_is / bjt_is scaled to the temperature implied
    by params["vt_thermal"] (scalar, or (B,) lanes against (B, n) leaves).
    Call only when ``has_is_temp(params)``."""
    p = dict(params)
    vt = p["vt_thermal"]
    if vt.dim():
        vt = vt[..., None]
    inv_d = 1.0 / VT_NOMINAL - 1.0 / vt

    def scale(i_s, n, eg, xti):
        return i_s * (vt / VT_NOMINAL) ** (xti / n) * torch.exp(eg / n * inv_d)

    if p["dio_is"].shape[-1]:
        p["dio_is"] = scale(p["dio_is"], p["dio_n"], p["dio_eg"],
                            p["dio_xti"])
    if p["bjt_is"].shape[-1]:
        p["bjt_is"] = scale(p["bjt_is"], 1.0, p["bjt_eg"], p["bjt_xti"])
    return p
