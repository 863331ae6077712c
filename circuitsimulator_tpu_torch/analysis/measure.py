"""`.MEASURE` post-processing on the host (port of
``circuitsimulator_tpu/analysis/measure.py``; numpy on the host).

Measurements are evaluated over the waveform arrays (times, xs) of a
finished analysis: the transient's saved x, the AC sweep's complex x, a DC
sweep's points.  The device computation stays as it is and `.MEASURE` is
an O(T) numpy pass.

Crossing times are linearly interpolated between samples (the waveform is
piecewise-linear in the BE/trap discretization anyway), matching ngspice's
convention.  Window statistics (AVG/RMS/INTEG) integrate with the
trapezoidal rule over [FROM, TO] with interpolated window endpoints.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from ..ir.lower import Topology
from ..netlist.parser import EventSpec, MeasureSpec, ProbeSpec
from ..utils.expr import ExprError, eval_expr


def _apply_mod(y: np.ndarray, mod: str) -> np.ndarray:
    """Complex data reduces per the probe modifier (default magnitude —
    the standard .MEASURE AC convention); real data only honors db."""
    if np.iscomplexobj(y):
        if mod == "db":
            return 20.0 * np.log10(np.maximum(np.abs(y), 1e-300))
        if mod == "ph":
            return np.degrees(np.angle(y))
        if mod == "re":
            return y.real
        if mod == "im":
            return y.imag
        return np.abs(y)
    if mod == "db":
        return 20.0 * np.log10(np.maximum(np.abs(y), 1e-300))
    return y


def probe_wave(topo: Topology, xs: np.ndarray,
               probe: ProbeSpec) -> Optional[np.ndarray]:
    """Resolve a probe to its waveform column(s): V(a), V(a,b), I(elem),
    with VDB/VP/VR/VI modifiers applied (AC data).  Returns None (not an
    error) for unresolvable probes — consistent with probe_selection in
    io/csvout.py."""
    v_by_name = dict(zip(topo.volt_col_names, topo.volt_col_eqs))
    i_by_name = dict(zip(topo.branch_col_names, topo.branch_col_eqs))
    mod = getattr(probe, "mod", "")

    def veq(name):
        if name in v_by_name:
            return int(v_by_name[name])
        return -1 if name.lower() in ("0", "gnd") else None

    if probe.kind == "nv":
        eq = veq(probe.node1)
        if eq is None:
            return None
        y = xs[:, eq] if eq >= 0 else np.zeros(xs.shape[0])
        return _apply_mod(y, mod)
    if probe.kind == "dv":
        ea, eb = veq(probe.node1), veq(probe.node2)
        if ea is None or eb is None:
            return None
        ya = xs[:, ea] if ea >= 0 else 0.0
        yb = xs[:, eb] if eb >= 0 else 0.0
        return _apply_mod(ya - yb, mod)
    if probe.kind == "br" and probe.ele_name in i_by_name:
        return _apply_mod(xs[:, int(i_by_name[probe.ele_name])], mod)
    return None


def _crossings(t: np.ndarray, y: np.ndarray, val: float,
               edge: str, td: float) -> np.ndarray:
    """All interpolated times where y crosses val with the given edge
    direction, at t >= td."""
    d = y - val
    below = d[:-1] < 0
    above_eq = d[1:] >= 0
    rise = below & above_eq
    fall = (d[:-1] > 0) & (d[1:] <= 0)
    if edge == "rise":
        hits = rise
    elif edge == "fall":
        hits = fall
    else:
        hits = rise | fall
    idx = np.nonzero(hits)[0]
    if idx.size == 0:
        return np.empty(0)
    frac = d[idx] / (d[idx] - d[idx + 1])
    tc = t[idx] + frac * (t[idx + 1] - t[idx])
    return tc[tc >= td]


def _event_time(t: np.ndarray, y: np.ndarray, ev: EventSpec) -> float:
    tc = _crossings(t, y, ev.val, ev.edge, ev.td)
    if tc.size == 0:
        return math.nan
    if ev.n == -1:                      # LAST
        return float(tc[-1])
    if ev.n < 1 or ev.n > tc.size:
        return math.nan
    return float(tc[ev.n - 1])


def _interp_at(t: np.ndarray, y: np.ndarray, when: float) -> float:
    if not (t[0] <= when <= t[-1]):
        return math.nan
    return float(np.interp(when, t, y))


def _window(t: np.ndarray, y: np.ndarray, t0: float,
            t1: float) -> Tuple[np.ndarray, np.ndarray]:
    """Samples inside [t0, t1] with linearly interpolated endpoints."""
    t0 = max(t0, float(t[0]))
    t1 = min(t1, float(t[-1]))
    if t1 <= t0:
        return np.empty(0), np.empty(0)
    inside = (t > t0) & (t < t1)
    tw = np.concatenate([[t0], t[inside], [t1]])
    yw = np.concatenate([[np.interp(t0, t, y)], y[inside],
                         [np.interp(t1, t, y)]])
    return tw, yw


def _eval_stat(m: MeasureSpec, t: np.ndarray, y: np.ndarray) -> float:
    tw, yw = _window(t, y, m.t_from, m.t_to)
    if tw.size == 0:
        return math.nan
    span = tw[-1] - tw[0]
    if m.stat == "avg":
        return float(np.trapezoid(yw, tw) / span) if span > 0 else float(yw[0])
    if m.stat == "rms":
        return (float(np.sqrt(np.trapezoid(yw * yw, tw) / span))
                if span > 0 else float(abs(yw[0])))
    if m.stat == "integ":
        return float(np.trapezoid(yw, tw))
    if m.stat == "min":
        return float(yw.min())
    if m.stat == "max":
        return float(yw.max())
    if m.stat == "pp":
        return float(yw.max() - yw.min())
    if m.stat == "min_at":
        return float(tw[int(np.argmin(yw))])
    if m.stat == "max_at":
        return float(tw[int(np.argmax(yw))])
    return math.nan


def evaluate_measure(m: MeasureSpec, topo: Topology, times, xs) -> float:
    """One measurement over a waveform array; NaN if unresolvable.

    `times` is the sweep axis: time for TRAN, frequency for AC (crossing
    "times" are then frequencies — e.g. a -3 dB bandwidth), the swept
    source/parameter value for DC.  `xs` may be complex (AC) — probes
    reduce it via their modifier (magnitude by default)."""
    t = np.asarray(times, dtype=float)
    xs = np.asarray(xs)
    if not np.iscomplexobj(xs):
        xs = xs.astype(float)
    if m.kind == "stat":
        y = probe_wave(topo, xs, m.probe)
        return _eval_stat(m, t, y) if y is not None else math.nan
    if m.kind == "when":
        y = probe_wave(topo, xs, m.ev1.probe)
        return _event_time(t, y, m.ev1) if y is not None else math.nan
    if m.kind == "trig_targ":
        y1 = probe_wave(topo, xs, m.ev1.probe)
        y2 = probe_wave(topo, xs, m.ev2.probe)
        if y1 is None or y2 is None:
            return math.nan
        t1 = _event_time(t, y1, m.ev1)
        t2 = _event_time(t, y2, m.ev2)
        return t2 - t1
    if m.kind == "find_at":
        y = probe_wave(topo, xs, m.probe)
        return _interp_at(t, y, m.at) if y is not None else math.nan
    if m.kind == "find_when":
        y = probe_wave(topo, xs, m.probe)
        yw = probe_wave(topo, xs, m.ev1.probe)
        if y is None or yw is None:
            return math.nan
        tw = _event_time(t, yw, m.ev1)
        return _interp_at(t, y, tw) if not math.isnan(tw) else math.nan
    return math.nan


def run_measures(measures: List[MeasureSpec], topo: Topology, times, xs,
                 analysis: str = "tran", bindings=None
                 ) -> List[Tuple[str, float]]:
    """Evaluate every .MEASURE of the given analysis ("tran", "ac", "dc")
    over (axis, waveforms).  kind == "param" measures are derived: their
    expression is evaluated over the measures computed so far (plus the
    .PARAM `bindings`), in card order."""
    env = dict(bindings or {})
    out = []
    for m in measures:
        if m.analysis != analysis:
            continue
        if m.kind == "param":
            try:
                val = eval_expr(m.expr, env)
            except ExprError:
                val = math.nan
        else:
            val = evaluate_measure(m, topo, times, xs)
        env[m.name] = val
        out.append((m.name, val))
    return out


def measure_report(results: List[Tuple[str, float]]) -> str:
    lines = ["==== Measurements ===="]
    for name, val in results:
        txt = f"{val: .9e}" if not math.isnan(val) else "FAILED"
        lines.append(f"{name:>20s} = {txt}")
    return "\n".join(lines)
