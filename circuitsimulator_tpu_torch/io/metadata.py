"""Structured run metadata (CLI ``--stats``); port of
``circuitsimulator_tpu/io/metadata.py``: the same keys, with ``engine``
naming the port and ``solver.dtype`` the numpy name of the torch dtype
(``float64`` or ``float32``)."""

from __future__ import annotations

import json
import platform
from typing import Any, Dict, Optional

import numpy as np
import torch


def _iter_stats(newton_iters) -> Dict[str, Any]:
    it = (newton_iters.cpu().numpy() if isinstance(newton_iters, torch.Tensor)
          else np.asarray(newton_iters))
    if it.size == 0:
        return {"total": 0}
    flat = it.reshape(-1)
    hist_edges = [1, 2, 3, 5, 8, 13, 21, 34, 50]
    hist = {}
    prev = 0
    for e in hist_edges:
        hist[f"<={e}"] = int(np.sum((flat > prev) & (flat <= e)))
        prev = e
    hist[f">{hist_edges[-1]}"] = int(np.sum(flat > hist_edges[-1]))
    return {
        "total": int(flat.sum()),
        "mean_per_step": float(flat.mean()),
        "max": int(flat.max()),
        "min": int(flat.min()),
        "histogram": hist,
    }


def transient_metadata(sim, result, wall_s: Optional[float] = None,
                       extra: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    topo = sim.topo
    n_steps = getattr(result, "n_steps", len(result.times) - 1)
    meta = {
        "engine": "circuitsimulator_tpu_torch",
        "analysis": "transient_backward_euler",
        "platform": platform.machine(),
        "n_nodes": topo.n_nodes,
        "n_elements": topo.n_elements,
        "n_unknowns": topo.n_unknowns,
        "element_counts": topo.counts,
        "n_steps": n_steps,
        "tstep": sim.config.tran.tstep,
        "tstop": sim.config.tran.tstop,
        "solver": {
            "backend": sim.opts.tran_solver,
            "dtype": str(sim.opts.dtype).replace("torch.", ""),
            "tol": sim.opts.tran_tol,
            "alpha": sim.opts.tran_alpha,
            "gmin": sim.opts.tran_gmin,
            "max_newton_iters": sim.opts.tran_max_newton_iters,
        },
        "newton": _iter_stats(result.newton_iters),
        "failed_lanes": int(torch.as_tensor(result.failed).sum()),
    }
    if wall_s is not None:
        meta["wall_seconds"] = wall_s
        if n_steps:
            meta["timesteps_per_second"] = n_steps / wall_s
    if extra:
        meta.update(extra)
    return meta


def write_metadata(path: str, meta: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
        f.write("\n")
