"""Carry parameters across from the JAX package.

``params_from_numpy`` turns the JAX package's params pytree, given as numpy
arrays (optionally with a leading lane axis, e.g. JAX-drawn Monte-Carlo
lanes), into the port's parameter dict: floating leaves in ``dtype``,
integer leaves (waveform kinds, PWL counts) as int32.
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
