"""Streaming `.MEASURE` evaluation (port of
``circuitsimulator_tpu/analysis/measure_stream.py``).

The host evaluator (analysis/measure.py) needs the whole (T, N) waveform;
at Monte-Carlo scale (8192 lanes x 50k steps) that is tens of gigabytes.
Here the same measurements are O(1)-memory accumulators of (B,) tensors:
per-lane min/max/integrals and interpolated crossing times update each
step, and only the (B,) results come home.

Semantics match analysis/measure.py with one documented approximation:
window statistics (FROM/TO on AVG/RMS/INTEG) clip to whole grid segments
instead of interpolating fractional window endpoints, an O(dt/window)
difference.  Crossing times are linearly interpolated as on the host.

Usage:
    sm = StreamingMeasures(measures, topo, dtype, device)
    res, vals = run_transient_streaming(engine, params, tstep, tstop, sm)
    # vals: {measure_name: per-lane value}
Batched lanes (a leading lane axis on params and x0) need no vmap; the
fused chunk kernel feeds ``update_vals`` from its in-kernel probe stream
(parallel.montecarlo.fused_transient_measures).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ir.lower import Topology
from ..netlist.parser import EventSpec, MeasureSpec
from ..ops.assemble import Engine
from ..utils.expr import ExprError, eval_expr


def _probe_pair(topo: Topology, probe) -> Optional[Tuple[int, int, str]]:
    """(a, b, mod) with value = xe[a] - xe[b] then the modifier applied
    (dump slot = N handles ground); None if unresolvable.  Transient data
    is real, so only the "db" modifier acts (as in measure._apply_mod);
    VP/VR/VI pass the raw value through."""
    v_by = dict(zip(topo.volt_col_names, [int(e) for e in topo.volt_col_eqs]))
    i_by = dict(zip(topo.branch_col_names,
                    [int(e) for e in topo.branch_col_eqs]))
    dump = topo.n_unknowns

    def veq(name):
        if name in v_by:
            return v_by[name]
        return dump if name.lower() in ("0", "gnd") else None

    mod = getattr(probe, "mod", "")
    if probe.kind == "nv":
        a = veq(probe.node1)
        return None if a is None else (a, dump, mod)
    if probe.kind == "dv":
        a, b = veq(probe.node1), veq(probe.node2)
        return None if a is None or b is None else (a, b, mod)
    if probe.kind == "br" and probe.ele_name in i_by:
        return (i_by[probe.ele_name], dump, mod)
    return None


def _edge_hit(prev_y, y, ev: EventSpec):
    """(hit, frac): a crossing of ev.val in this segment with the wanted
    edge direction; frac is the linear-interpolation fraction."""
    val = ev.val
    rising = (prev_y < val) & (y >= val)
    falling = (prev_y > val) & (y <= val)
    if ev.edge == "rise":
        hit = rising
    elif ev.edge == "fall":
        hit = falling
    else:
        hit = rising | falling
    denom = torch.where(y == prev_y, 1.0, y - prev_y)
    frac = torch.clamp((val - prev_y) / denom, 0.0, 1.0)
    return hit, frac


class _Crossing:
    """Streaming n-th / LAST crossing tracker for one EventSpec."""

    def __init__(self, ev: EventSpec, pair):
        self.ev = ev
        self.pair = pair

    @staticmethod
    def init(y0):
        nan = torch.full_like(y0, float("nan"))
        return {"prev": y0, "count": torch.zeros_like(y0, dtype=torch.int32),
                "t": nan, "aux": nan}

    def update(self, c, y, t, dt, aux_prev=None, aux=None):
        """aux/aux_prev: a second waveform sampled at the crossing
        (FIND ... WHEN), interpolated with the same fraction."""
        hit, frac = _edge_hit(c["prev"], y, self.ev)
        tc = t - dt + frac * dt
        hit = hit & (tc >= self.ev.td)
        count = c["count"] + hit.to(torch.int32)
        if self.ev.n == -1:      # LAST: keep overwriting
            record = hit
        else:
            record = hit & (count == self.ev.n)
        out = {"prev": y, "count": count,
               "t": torch.where(record, tc, c["t"]), "aux": c["aux"]}
        if aux is not None:
            a_int = aux_prev + frac * (aux - aux_prev)
            out["aux"] = torch.where(record, a_int, c["aux"])
        return out


def _unresolved(entry) -> bool:
    """A measure with a probe that names no node or branch (NaN result)."""
    return (entry.get("p", 0) is None
            or any(entry[c].pair is None for c in ("c1", "c2") if c in entry))


class StreamingMeasures:
    """Accumulator set for a list of TRAN MeasureSpecs.

    Every probe read goes through one (P, N) selection matrix (rows of +1
    and -1 pairs: exact for finite x), so an external stepper (the fused
    chunk kernel, ops/fused_step.py with ``probe_mat=``) reads the raw
    probe values with it and feeds them to ``vals_from_raw`` /
    ``init_vals`` / ``update_vals``; each accumulator reads its value by a
    static index into the (..., P) values."""

    def __init__(self, measures: List[MeasureSpec], topo: Topology, dtype,
                 device="cpu"):
        self.dtype = dtype
        self.device = device = torch.device(device)
        self.specs = []
        self._pairs: List[Tuple[int, int, str]] = []

        def intern(pair):
            if pair is None:
                return None
            if pair not in self._pairs:
                self._pairs.append(pair)
            return self._pairs.index(pair)

        def crossing(ev):
            return _Crossing(ev, intern(_probe_pair(topo, ev.probe)))

        for m in measures:
            if m.analysis != "tran" or m.kind == "param":
                # derived (PARAM=) measures are evaluated on the host from
                # the finished results: apply_derived_measures
                continue
            entry = {"m": m}
            if m.kind in ("stat", "find_at", "find_when"):
                entry["p"] = intern(_probe_pair(topo, m.probe))
            if m.kind in ("when", "trig_targ", "find_when"):
                entry["c1"] = crossing(m.ev1)
            if m.kind == "trig_targ":
                entry["c2"] = crossing(m.ev2)
            self.specs.append(entry)
        N = topo.n_unknowns
        P = np.zeros((max(len(self._pairs), 1), N))
        for j, (a, b, _) in enumerate(self._pairs):
            if a < N:
                P[j, a] += 1.0
            if b < N:
                P[j, b] -= 1.0
        self._P = torch.as_tensor(P, dtype=dtype, device=device)
        self._db = [mod == "db" for (_, _, mod) in self._pairs]
        self._db_mask = torch.as_tensor(self._db, dtype=torch.bool,
                                        device=device)

    @property
    def probe_matrix(self) -> torch.Tensor:
        """(P, N) probe-selection matrix: external steppers read raw probe
        values with it and feed them back through vals_from_raw /
        init_vals / update_vals."""
        return self._P

    def vals_from_raw(self, raw):
        """Apply the probe modifiers (db) to raw (..., P) reads."""
        if any(self._db):
            tiny = torch.finfo(raw.dtype).tiny
            db = 20.0 * torch.log10(torch.clamp_min(raw.abs(), tiny))
            raw = torch.where(self._db_mask, db, raw)
        return raw

    def _probe_vals(self, x):
        """(..., P) probe values of x (..., N)."""
        return self.vals_from_raw(x @ self._P.T)

    def init(self, engine: Engine, x0):
        return self.init_vals(self._probe_vals(x0))

    def init_vals(self, ys):
        """Accumulators from the probe VALUES (..., P) at t = 0."""
        accs = []
        for e in self.specs:
            m = e["m"]
            lane = ys[..., 0] * 0.0       # lane-shaped zeros
            if _unresolved(e):
                accs.append({"bad": lane})
                continue
            if m.kind == "stat":
                y0 = ys[..., e["p"]]
                in_w = m.t_from <= 0.0
                inf = torch.full_like(y0, float("inf"))
                accs.append({
                    "prev": y0,
                    "min": y0 if in_w else inf,
                    "max": y0 if in_w else -inf,
                    "tmin": lane, "tmax": lane,
                    "integ": lane, "integ2": lane, "span": lane,
                })
            elif m.kind == "when":
                accs.append(e["c1"].init(ys[..., e["c1"].pair]))
            elif m.kind == "trig_targ":
                accs.append({"a": e["c1"].init(ys[..., e["c1"].pair]),
                             "b": e["c2"].init(ys[..., e["c2"].pair])})
            elif m.kind == "find_at":
                y0 = ys[..., e["p"]]
                accs.append({"prev": y0, "y": y0 if m.at <= 0.0
                             else torch.full_like(y0, float("nan"))})
            elif m.kind == "find_when":
                accs.append({"c": e["c1"].init(ys[..., e["c1"].pair]),
                             "prev_main": ys[..., e["p"]]})
        return accs

    def update(self, engine: Engine, accs, x, t, dt):
        return self.update_vals(accs, self._probe_vals(x), t, dt)

    def update_vals(self, accs, ys, t, dt):
        """Accumulator update from the probe VALUES (..., P) at time t (a
        0-d tensor), dt the step (a 0-d tensor)."""
        out = []
        for e, a in zip(self.specs, accs):
            m = e["m"]
            if "bad" in a:
                out.append(a)
                continue
            if m.kind == "stat":
                y = ys[..., e["p"]]
                in_pt = (t >= m.t_from) & (t <= m.t_to)
                seg = (t - dt >= m.t_from) & (t <= m.t_to)
                lower = in_pt & (y < a["min"])
                upper = in_pt & (y > a["max"])
                out.append({
                    "prev": y,
                    "min": torch.where(lower, y, a["min"]),
                    "max": torch.where(upper, y, a["max"]),
                    "tmin": torch.where(lower, t, a["tmin"]),
                    "tmax": torch.where(upper, t, a["tmax"]),
                    "integ": a["integ"]
                    + torch.where(seg, 0.5 * (y + a["prev"]) * dt, 0.0),
                    "integ2": a["integ2"]
                    + torch.where(seg,
                                  0.5 * (y * y + a["prev"] * a["prev"]) * dt,
                                  0.0),
                    "span": a["span"] + torch.where(seg, dt, 0.0),
                })
            elif m.kind == "when":
                out.append(e["c1"].update(a, ys[..., e["c1"].pair], t, dt))
            elif m.kind == "trig_targ":
                out.append({
                    "a": e["c1"].update(a["a"], ys[..., e["c1"].pair], t, dt),
                    "b": e["c2"].update(a["b"], ys[..., e["c2"].pair], t, dt),
                })
            elif m.kind == "find_at":
                y = ys[..., e["p"]]
                inside = (t - dt < m.at) & (m.at <= t)
                frac = torch.clamp((m.at - (t - dt)) / dt, 0.0, 1.0)
                y_at = a["prev"] + frac * (y - a["prev"])
                out.append({"prev": y,
                            "y": torch.where(inside, y_at, a["y"])})
            elif m.kind == "find_when":
                y_main = ys[..., e["p"]]
                c = e["c1"].update(a["c"], ys[..., e["c1"].pair], t, dt,
                                   aux_prev=a["prev_main"], aux=y_main)
                out.append({"c": c, "prev_main": y_main})
        return out

    def finalize(self, accs) -> Dict[str, Any]:
        vals = {}
        for e, a in zip(self.specs, accs):
            m = e["m"]
            if "bad" in a:
                vals[m.name] = a["bad"] + float("nan")
                continue
            if m.kind == "stat":
                span = a["span"]
                safe = torch.where(span > 0, span, 1.0)
                if m.stat in ("min", "max", "integ"):
                    v = a[m.stat]
                elif m.stat == "pp":
                    v = a["max"] - a["min"]
                elif m.stat in ("min_at", "max_at"):
                    v = a["t" + m.stat[:3]]
                elif m.stat == "avg":
                    v = torch.where(span > 0, a["integ"] / safe,
                                    float("nan"))
                else:                                   # rms
                    v = torch.where(span > 0, torch.sqrt(a["integ2"] / safe),
                                    float("nan"))
                vals[m.name] = v
            elif m.kind == "when":
                vals[m.name] = a["t"]
            elif m.kind == "trig_targ":
                vals[m.name] = a["b"]["t"] - a["a"]["t"]
            elif m.kind == "find_at":
                vals[m.name] = a["y"]
            elif m.kind == "find_when":
                vals[m.name] = a["c"]["aux"]
        return vals


@torch.inference_mode()
def run_transient_streaming(engine: Engine, params, tstep, tstop,
                            sm: StreamingMeasures, x0: Optional[Any] = None,
                            noise_key=None):
    """Transient with no saved waveforms plus streaming measures, natively
    batched (params and x0 may carry a leading lane axis).  Returns
    (TransientResult with xs None, {name: per-lane value}).  The time grid
    is arange(1, n+1) * dt in the working dtype, as in run_transient;
    noise_key turns on TRNOISE as there."""
    from .dc import dc_operating_point
    from .transient import TransientResult, n_steps_for, transient_step_fn
    dtype, dev = engine.dtype, engine.device
    dt = torch.tensor(tstep, dtype=dtype, device=dev)
    n_steps = n_steps_for(float(tstep), float(tstop))
    if x0 is None:
        x0 = dc_operating_point(engine, params)
    state0 = engine.init_state(x0, params, float(tstep),
                               noise_key=noise_key)
    failed0 = torch.zeros(x0.shape[:-1], dtype=torch.bool, device=dev)
    predictor = engine.opts.tran_predictor
    carry = (x0, x0, state0, failed0) if predictor else (x0, state0, failed0)
    ts = torch.arange(1, n_steps + 1, dtype=dtype, device=dev) * dt
    step = transient_step_fn(engine, params, float(tstep),
                             predictor=predictor)
    acc = sm.init(engine, x0)
    iters = torch.empty((n_steps,) + tuple(failed0.shape), dtype=torch.int32,
                        device=dev)
    for i in range(n_steps):
        carry, (x, it) = step(carry, ts[i])
        acc = sm.update(engine, acc, x, ts[i], dt)
        iters[i] = it
    res = TransientResult(times=ts, xs=None, x_final=carry[0],
                          newton_iters=iters, failed=carry[-1],
                          n_steps=n_steps)
    return res, sm.finalize(acc)


def apply_derived_measures(measures, vals, bindings=None):
    """Evaluate the kind == "param" derived measures on the host over the
    per-lane results (numpy arrays or floats).  Returns vals with the
    derived names added, in card order."""
    derived = [m for m in measures
               if m.analysis == "tran" and m.kind == "param"]
    if not derived:
        return vals
    vals = dict(vals)
    names = [m.name for m in measures if m.analysis == "tran"]
    shape = np.shape(next(iter(vals.values())))
    for m in derived:
        outv = np.empty(shape)
        for idx in (np.ndindex(shape) if shape else [()]):
            env = dict(bindings or {})
            for n in names:
                if n in vals:
                    env[n] = (float(np.asarray(vals[n])[idx]) if shape
                              else float(vals[n]))
            try:
                outv[idx] = eval_expr(m.expr, env)
            except ExprError:
                outv[idx] = np.nan
        vals[m.name] = outv if shape else float(outv)
    return vals
