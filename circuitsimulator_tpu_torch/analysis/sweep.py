"""DC sweep analysis (the ``.DC <source> start stop step`` card); port of
``circuitsimulator_tpu/analysis/sweep.py``.

Sweep the named independent source's DC value over [start, stop] in
``step`` increments and solve the full (nonlinear) operating point at every
value.  A nested card (``.DC s1 ... s2 ...``) sweeps the cartesian grid,
outer-major (s2 slowest), the classic SPICE print order.

The JAX package vmaps ``dc_operating_point`` over the grid.  Here the grid is
one batch of lanes whose ``vs_dc``/``is_dc`` column is set per lane, solved
by the natively batched DC (``parallel/montecarlo.batched_dc_fast``): one
Newton loop whose every iteration solves all the grid's systems at once
(the K2 kernel on the card).  It is the same fixpoint lane by lane: each
lane runs the source ramp and the damped Newton loop of the single-lane DC,
and a lane that is done is frozen by its mask, so extra iterations of the
shared loop do not move it.  Where a lane's iterations may differ is in
rounding only: the batched solve sums in another order than a single-lane
solve, so a point that sits on the convergence threshold can take one
iteration more or less than JAX's vmapped lane (the points then differ by
about that last damped step, within the DC tolerance).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..netlist import KIND_I, KIND_V
from ..ops.assemble import Engine


@dataclasses.dataclass
class DCSweepResult:
    source: str
    values: Any        # (S,) numpy: the inner swept values, grid order
    xs: Any            # (S, N) tensor: the operating points
    # nested sweep: the outer source and its per-row values (rows run
    # outer-major); "" and None for a single sweep
    source2: str = ""
    values2: Any = None


def sweep_values(start: float, stop: float, step: float) -> np.ndarray:
    if step == 0.0:
        raise ValueError(".DC step must be nonzero")
    n = int(np.floor((stop - start) / step + 1e-9)) + 1
    if n <= 0:
        raise ValueError(".DC sweep range is empty")
    return start + step * np.arange(n)


def find_source(circuit, name: str):
    """Locate an independent source by element name (exact match first,
    then case-insensitive).  Returns (kind, index within its class)."""
    for exact in (True, False):
        vi = ii = 0
        for e in circuit.elements:
            if e.kind not in (KIND_V, KIND_I):
                continue
            match = (e.name == name) if exact \
                else (e.name.lower() == name.lower())
            if match:
                return e.kind, (vi if e.kind == KIND_V else ii)
            if e.kind == KIND_V:
                vi += 1
            else:
                ii += 1
    raise KeyError(f"no independent source named {name!r}")


def set_source_lanes(engine: Engine, bparams, circuit, name: str, values):
    """``bparams`` (a leading lane axis) with source ``name``'s DC value set
    to ``values`` (B,) lane by lane."""
    kind, idx = find_source(circuit, name)
    key = "vs_dc" if kind == KIND_V else "is_dc"
    col = bparams[key].clone()
    col[:, idx] = torch.as_tensor(np.asarray(values), dtype=engine.dtype,
                                  device=engine.device)
    return {**bparams, key: col}


def dc_sweep(engine: Engine, params, circuit, source_name: str,
             values, source2: str = "", values2=None) -> DCSweepResult:
    """The operating point at every sweep point, the whole grid as one
    batched DC.  With ``source2``/``values2`` the cartesian grid,
    outer-major."""
    from ..parallel.montecarlo import batched_dc_fast, broadcast_params
    values = np.asarray(values, np.float64)
    nested = bool(source2) and values2 is not None
    if nested:
        values2 = np.asarray(values2, np.float64)
        v2g, v1g = np.meshgrid(values2, values, indexing="ij")
        values, values2 = v1g.ravel(), v2g.ravel()
    bp = broadcast_params(params, len(values))
    bp = set_source_lanes(engine, bp, circuit, source_name, values)
    if nested:
        bp = set_source_lanes(engine, bp, circuit, source2, values2)
    xs = batched_dc_fast(engine, bp)
    # the swept values as the JAX package reports them: in the working dtype
    cast = torch.empty((), dtype=engine.dtype).numpy().dtype
    return DCSweepResult(source=source_name, values=values.astype(cast),
                         xs=xs, source2=source2 if nested else "",
                         values2=values2.astype(cast) if nested else None)


def write_sweep_csv(path: str, topo, result: DCSweepResult) -> None:
    """The transient writer's columns with the swept value (the outer one
    first for a nested sweep) as the first column(s), %.9e."""
    values = np.asarray(result.values)
    xs = result.xs
    xs = xs.cpu().numpy() if isinstance(xs, torch.Tensor) else np.asarray(xs)
    col_eqs = np.concatenate([topo.volt_col_eqs,
                              topo.branch_col_eqs]).astype(int)
    cols = [f"V({n})" for n in topo.volt_col_names]
    cols += [f"I({n})" for n in topo.branch_col_names]
    v2 = np.asarray(result.values2) if result.values2 is not None else None
    with open(path, "w") as f:
        head = f"{result.source}," + ",".join(cols)
        if v2 is not None:
            head = f"{result.source2}," + head
        f.write(head + "\n")
        for i, (v, row) in enumerate(zip(values, xs[:, col_eqs])):
            line = f"{v:.9e}," + ",".join(f"{x:.9e}" for x in row)
            if v2 is not None:
                line = f"{v2[i]:.9e}," + line
            f.write(line + "\n")
