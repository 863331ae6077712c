"""Carry parameters across from the JAX package.

``params_from_numpy`` turns the JAX package's params pytree, given as numpy
arrays (optionally with a leading lane axis, e.g. JAX-drawn Monte-Carlo
lanes), into the port's parameter dict: floating leaves in ``dtype``,
integer leaves (waveform kinds, PWL counts) as int32.  Every leaf is
carried, so the junction and switch parameters (``dio_*``, ``bjt_*``,
``jf_*``, ``sw_*``) come across with the rest.  ``state_from_numpy`` does
the same for a JAX transient state (``vc``, ``ic``, ``il``, ``vl``): the
port's cap-like layout is the JAX engine's (explicit C, MOS caps, diode
CJO, BJT CJE/CJC pairs), so ``vc`` carries over as it is.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_numpy(d: Mapping[str, Any], dtype=torch.float64,
                      device="cpu") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        if np.issubdtype(a.dtype, np.floating):
            out[k] = torch.as_tensor(a, dtype=dtype, device=device)
        else:
            out[k] = torch.as_tensor(a.astype(np.int32), device=device)
    return out


def state_from_numpy(d: Mapping[str, Any], dtype=torch.float64,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """The JAX engine's transient state dict as the port's."""
    return {k: torch.as_tensor(np.asarray(d[k]), dtype=dtype, device=device)
            for k in ("vc", "ic", "il", "vl")}
