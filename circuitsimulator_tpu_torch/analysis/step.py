"""``.STEP`` parameter sweeps; port of ``circuitsimulator_tpu/analysis/
step.py``.

A ``.STEP`` does not re-run the simulator per value.  The topology is the
same at every step value, so only the parameters differ: each value (each
point of the cartesian grid of several cards) gives one params dict, the
dicts stack along a leading lane axis, and the whole sweep runs as one
batch through the port's batched entries (``parallel/montecarlo.py``): the
batched DC (K2 on the card), the non-fused batched transient, or, for a
waveform-free sweep with ``.MEASURE TRAN`` cards, the streaming measures
(K1 with its probe stream on a float32 CUDA run of a deck in its scope).

``.STEP PARAM name ...`` re-parses the netlist text with the parameter
bound (a parameter can feed any number of element values through
``{...}`` expressions); ``.STEP <source> ...`` sets the source's
``vs_dc``/``is_dc`` entry; ``.STEP TEMP ...`` sets the thermal voltage and
the temperature offset and rescales IS(T) from the nominal saturation
currents (no double scaling of a ``.TEMP`` card's).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class StepResult:
    name: str                 # stepped parameter / source name(s)
    kind: str                 # "param" | "source" | "temp", comma-joined
    values: Any               # (B,) values, or B tuples for several cards
    analysis: str             # "tran" | "op"
    result: Any               # batched TransientResult or (B, N) DC points
    measures: Optional[List] = None   # [(measure_name, (B,) values)]


def _combo_params(sim, cfgs, combo):
    """One unbatched params dict with every .STEP card's value bound."""
    from ..ir.lower import lower
    from ..netlist import KIND_V, parse_netlist_text
    from ..utils.temp import apply_is_temp, has_is_temp, thermal_params
    from .sweep import find_source
    dtype, dev = sim.opts.dtype, sim.device
    overrides = {cfg.name: float(v) for cfg, v in zip(cfgs, combo)
                 if cfg.kind == "param"}
    if overrides:
        if sim.netlist_text is None:
            raise ValueError(".STEP PARAM needs the original netlist text "
                             "(construct via from_file/from_text)")
        ckt2, _ = parse_netlist_text(sim.netlist_text,
                                     param_overrides=overrides)
        ckt2.assign_equation_indices()
        p = dict(lower(ckt2, dtype, dev).params)
        p["vt_thermal"] = sim.params["vt_thermal"]
        p["temp_delta_c"] = sim.params["temp_delta_c"]
        if has_is_temp(p) and not any(c.kind == "temp" for c in cfgs):
            # the .TEMP card's IS(T); with a .STEP TEMP card the temp
            # branch below does the scaling
            p = apply_is_temp(p)
    else:
        p = dict(sim.params)
    for cfg, v in zip(cfgs, combo):
        if cfg.kind == "source":
            kind, idx = find_source(sim.circuit, cfg.name)
            key = "vs_dc" if kind == KIND_V else "is_dc"
            p[key] = p[key].clone()
            p[key][idx] = float(v)
        elif cfg.kind == "temp":
            p.update(thermal_params(float(v), dtype, dev))
            if has_is_temp(p):
                # from the NOMINAL saturation currents: p's may carry a
                # .TEMP card's scaling already
                if not overrides:
                    p["dio_is"] = sim.lowered.params["dio_is"]
                    p["bjt_is"] = sim.lowered.params["bjt_is"]
                p = apply_is_temp(p)
    return p


def run_step(sim, cfgs, save_xs: bool = True) -> StepResult:
    """Run the .STEP card(s) over the deck's primary analysis (.TRAN if
    present, else the DC operating point).  Several cards form a cartesian
    grid, still one batch over the flattened grid."""
    from ..parallel.montecarlo import (batched_dc_fast, batched_transient,
                                       batched_transient_measures)
    from .measure import run_measures
    if not isinstance(cfgs, (list, tuple)):
        cfgs = [cfgs]
    combos = list(itertools.product(*[cfg.values for cfg in cfgs]))
    plist = [_combo_params(sim, cfgs, combo) for combo in combos]
    bparams = {k: torch.stack([p[k] for p in plist]) for k in plist[0]}
    values = [c[0] for c in combos] if len(cfgs) == 1 else combos
    name = ",".join(cfg.name for cfg in cfgs)
    kind = ",".join(cfg.kind for cfg in cfgs)
    tran = sim.config.tran
    if tran.enabled:
        tran_measures = [m for m in sim.config.measures
                         if m.analysis == "tran"]
        if not save_xs and tran_measures:
            # waveform-free: the measures run as streaming accumulators
            res, vals = batched_transient_measures(
                sim.engine, bparams, tran.tstep, tran.tstop, tran_measures,
                sim.topo, bindings=sim.config.param_values)
            measures = [(m.name, np.asarray(
                vals[m.name].cpu() if isinstance(vals[m.name], torch.Tensor)
                else vals[m.name])) for m in tran_measures]
            return StepResult(name=name, kind=kind, values=values,
                              analysis="tran", result=res,
                              measures=measures)
        res = batched_transient(sim.engine, bparams, tran.tstep, tran.tstop,
                                save_xs=save_xs)
        measures = None
        if save_xs and sim.config.measures:
            xs = res.xs.cpu().numpy()             # (T + 1, B, N)
            times = res.times.cpu().numpy()
            per_step = [run_measures(sim.config.measures, sim.topo, times,
                                     xs[:, b],
                                     bindings=sim.config.param_values)
                        for b in range(len(values))]
            if per_step:
                measures = [(nm, np.array([row[i][1] for row in per_step]))
                            for i, (nm, _) in enumerate(per_step[0])]
        return StepResult(name=name, kind=kind, values=values,
                          analysis="tran", result=res, measures=measures)
    hb = sim.config.hb
    if hb.enabled and not hb.extra_tones:
        raise NotImplementedError(
            ".STEP with a .hb card: harmonic balance (HB) is not yet ported")
    xs = batched_dc_fast(sim.engine, bparams)
    return StepResult(name=name, kind=kind, values=values, analysis="op",
                      result=xs)


def write_step_csv(path: str, topo, sres: StepResult) -> None:
    """One row per step point: the stepped value(s) (one column per .STEP
    card), then the .MEASURE results (transient steps with measures) or
    every node voltage and branch current (%.9e, as the reference CSV)."""
    from ..io.csvout import format_header
    name_cols = sres.name.split(",")

    def val_cols(val):
        return list(val) if isinstance(val, tuple) else [val]

    with open(path, "w") as f:
        if sres.analysis == "tran" and sres.measures is not None:
            f.write(",".join(name_cols + [nm for nm, _ in sres.measures])
                    + "\n")
            cols = [np.asarray(v) for _, v in sres.measures]
            for b, val in enumerate(sres.values):
                row = val_cols(val) + [c[b] for c in cols]
                f.write(",".join(f"{v:.9e}" for v in row) + "\n")
            return
        xs = sres.result.x_final if sres.analysis == "tran" else sres.result
        xs = xs.cpu().numpy()
        hdr = format_header(topo).split(",")
        f.write(",".join(name_cols + hdr[1:]) + "\n")
        col_eqs = np.concatenate([topo.volt_col_eqs,
                                  topo.branch_col_eqs]).astype(int)
        for b, val in enumerate(sres.values):
            row = val_cols(val) + list(xs[b][col_eqs])
            f.write(",".join(f"{v:.9e}" for v in row) + "\n")
