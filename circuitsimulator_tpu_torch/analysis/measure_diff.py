"""Differentiable ``.MEASURE`` evaluation (port of
``circuitsimulator_tpu/analysis/measure_diff.py``, the torch twin of the
host evaluator ``analysis/measure.py``).

A MeasureSpec compiles to a torch function ``f(times, xs) -> scalar``
whose VALUE matches the host evaluator and whose GRADIENT flows through
the differentiable transient (``analysis/adjoint.diff_transient``), so
FORM worst-case searches, mismatch budgets and calibration can target the
deck's own measure cards, crossing times and TRIG/TARG delays included.

The selections that are not differentiable (which interval brackets the
n-th crossing, which sample is the extremum) are frozen (``detach``); the
measured value (interpolated crossing time, window integral, extremum)
stays differentiable through the frozen selection.

Kinds: stat (AVG/RMS/INTEG/MIN/MAX/PP over FROM/TO), find_at, when,
trig_targ, find_when.  A missing event gives NaN, as on the host.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..ir.lower import Topology


def interp(x, xp, fp):
    """``jnp.interp`` (scalar x, increasing xp): the bracketing interval by
    ``searchsorted`` (side right, clipped to [1, len - 1]), linear inside,
    fp[0] / fp[-1] outside; a zero-width interval gives its left value."""
    x = torch.as_tensor(x, dtype=xp.dtype, device=xp.device)
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True),
                    1, xp.shape[0] - 1)[0]
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.spacing(np.finfo(np.dtype(str(xp.dtype)[6:])).eps)
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _eq_maps(topo: Topology):
    v_by_name = dict(zip(topo.volt_col_names,
                         [int(e) for e in topo.volt_col_eqs]))
    i_by_name = dict(zip(topo.branch_col_names,
                         [int(e) for e in topo.branch_col_eqs]))

    def veq(name):
        if name in v_by_name:
            return v_by_name[name]
        return -1 if name.lower() in ("0", "gnd") else None

    return veq, i_by_name


def _column(xs, eq):
    return xs[:, eq] if eq >= 0 else torch.zeros_like(xs[:, 0])


def diff_probe(topo: Topology, probe) -> Callable:
    """ProbeSpec -> fn(xs) -> (T,) waveform (transient data)."""
    veq, i_by_name = _eq_maps(topo)
    if probe.kind == "nv":
        eq = veq(probe.node1)
        if eq is None:
            raise KeyError(f"unresolvable probe node {probe.node1!r}")
        base = lambda xs: _column(xs, eq)                      # noqa: E731
    elif probe.kind == "dv":
        ea, eb = veq(probe.node1), veq(probe.node2)
        if ea is None or eb is None:
            raise KeyError("unresolvable differential probe")
        base = lambda xs: _column(xs, ea) - _column(xs, eb)    # noqa: E731
    elif probe.kind == "br" and probe.ele_name in i_by_name:
        eq = i_by_name[probe.ele_name]
        base = lambda xs: xs[:, eq]                            # noqa: E731
    else:
        raise KeyError(f"unresolvable probe {probe!r}")
    if getattr(probe, "mod", "") == "db":
        return lambda xs: 20.0 * torch.log10(
            torch.clamp_min(base(xs).abs(), 1e-300))
    return base


def diff_event_time(t, y, val, edge: str, td: float, n: int):
    """Interpolated n-th crossing time (n = -1: the last); NaN if absent.
    Matches the host's ``_event_time``; the selection is frozen."""
    d = y - val
    rise = (d[:-1] < 0) & (d[1:] >= 0)
    fall = (d[:-1] > 0) & (d[1:] <= 0)
    hits = rise if edge == "rise" else fall if edge == "fall" \
        else (rise | fall)
    denom = d[1:] - d[:-1]
    safe = torch.where(denom.abs() > 0, denom, 1.0)
    frac = torch.where(hits, d[:-1] / -safe, 0.0)
    tc = t[:-1] + frac * (t[1:] - t[:-1])
    hits = (hits & (tc >= td)).detach()
    cnt = torch.cumsum(hits.to(torch.int64), 0)
    total = int(cnt[-1]) if cnt.numel() else 0
    want = total if n == -1 else n
    sel = (hits & (cnt == want)).to(y.dtype).detach()
    t_hit = (sel * tc).sum()
    found = total >= max(want, 1) and want >= 1
    return torch.where(torch.tensor(found, device=t_hit.device), t_hit,
                       math.nan)


def diff_interp_at(t, y, when):
    """y at time ``when`` (linear), NaN outside [t0, t_end]."""
    v = interp(when, t, y)
    w = torch.as_tensor(when, dtype=t.dtype, device=t.device)
    inside = (t[0] <= w) & (w <= t[-1])
    return torch.where(inside, v, math.nan)


def _window_weights(t, t0, t1):
    """Per-interval clipped endpoints (a_i, b_i) of [t0, t1] and
    [t_i, t_i+1], and their widths."""
    a = torch.maximum(t[:-1], t0)
    b = torch.minimum(t[1:], t1)
    return a, b, torch.clamp_min(b - a, 0.0)


def diff_stat(stat: str, t_from: float, t_to: float):
    """Windowed statistic fn(t, y): the piecewise-linear integrals equal
    the host's interpolated-endpoint trapezoids."""

    def f(t, y):
        t0 = torch.maximum(torch.as_tensor(t_from, dtype=t.dtype,
                                           device=t.device), t[0])
        t1 = torch.minimum(torch.as_tensor(t_to, dtype=t.dtype,
                                           device=t.device), t[-1])
        dt_ = t[1:] - t[:-1]
        slope = (y[1:] - y[:-1]) / torch.where(dt_ > 0, dt_, 1.0)
        a, b, w = _window_weights(t, t0, t1)
        ya = y[:-1] + slope * (a - t[:-1])
        yb = y[:-1] + slope * (b - t[:-1])
        span = t1 - t0
        if stat == "integ":
            return (w * (ya + yb) / 2.0).sum()
        if stat == "avg":
            integ = (w * (ya + yb) / 2.0).sum()
            return torch.where(span > 0, integ / span, interp(t0, t, y))
        if stat == "rms":
            # the trapezoid of the SQUARED samples, as the host computes it
            integ2 = (w * (ya * ya + yb * yb) / 2.0).sum()
            return torch.where(span > 0, torch.sqrt(integ2 / span),
                               interp(t0, t, y).abs())
        # extrema over the interior samples and the interpolated endpoints
        inside = (t > t0) & (t < t1)
        ybig = torch.where(inside, y, math.inf)
        ysml = torch.where(inside, y, -math.inf)
        ends = torch.stack([interp(t0, t, y), interp(t1, t, y)])
        vmin = torch.minimum(ybig.min(), ends.min())
        vmax = torch.maximum(ysml.max(), ends.max())
        if stat == "min":
            return vmin
        if stat == "max":
            return vmax
        if stat == "pp":
            return vmax - vmin
        raise NotImplementedError(f"stat {stat!r} not differentiable "
                                  "(min_at/max_at: use the host path)")

    return f


def diff_probe_ac(topo: Topology, probe) -> Callable:
    """ProbeSpec -> fn(xr, xi) -> (F,) real AC waveform with the probe
    modifier applied (default magnitude; VDB/VP/VR/VI)."""
    veq, i_by_name = _eq_maps(topo)
    if probe.kind == "nv":
        eq = veq(probe.node1)
        if eq is None:
            raise KeyError(f"unresolvable probe node {probe.node1!r}")
        pair = lambda xr, xi: (_column(xr, eq), _column(xi, eq))  # noqa
    elif probe.kind == "dv":
        ea, eb = veq(probe.node1), veq(probe.node2)
        if ea is None or eb is None:
            raise KeyError("unresolvable differential probe")
        pair = lambda xr, xi: (_column(xr, ea) - _column(xr, eb),  # noqa
                               _column(xi, ea) - _column(xi, eb))
    elif probe.kind == "br" and probe.ele_name in i_by_name:
        eq = i_by_name[probe.ele_name]
        pair = lambda xr, xi: (xr[:, eq], xi[:, eq])               # noqa
    else:
        raise KeyError(f"unresolvable probe {probe!r}")
    mod = getattr(probe, "mod", "")

    def f(xr, xi):
        r, i = pair(xr, xi)
        if mod == "db":
            return 20.0 * torch.log10(
                torch.clamp_min(torch.sqrt(r * r + i * i), 1e-300))
        if mod == "ph":
            return torch.rad2deg(torch.atan2(i, r))
        if mod == "re":
            return r
        if mod == "im":
            return i
        return torch.sqrt(r * r + i * i)

    return f


def _compile(m, probe_of, kind: str) -> Callable:
    """fn(axis, *data) -> scalar of a MeasureSpec, ``probe_of`` mapping a
    ProbeSpec to fn(*data) -> (T,)."""
    if m.kind == "stat":
        probe = probe_of(m.probe)
        stat = diff_stat(m.stat, m.t_from, m.t_to)
        return lambda a, *d: stat(a, probe(*d))
    if m.kind == "find_at":
        probe = probe_of(m.probe)
        return lambda a, *d: diff_interp_at(a, probe(*d), m.at)
    if m.kind == "when":
        probe, ev = probe_of(m.ev1.probe), m.ev1
        return lambda a, *d: diff_event_time(a, probe(*d), ev.val, ev.edge,
                                             ev.td, ev.n)
    if m.kind == "trig_targ":
        p1, p2 = probe_of(m.ev1.probe), probe_of(m.ev2.probe)
        e1, e2 = m.ev1, m.ev2
        return lambda a, *d: (
            diff_event_time(a, p2(*d), e2.val, e2.edge, e2.td, e2.n)
            - diff_event_time(a, p1(*d), e1.val, e1.edge, e1.td, e1.n))
    if m.kind == "find_when":
        probe, pw, ev = probe_of(m.probe), probe_of(m.ev1.probe), m.ev1
        return lambda a, *d: diff_interp_at(
            a, probe(*d),
            diff_event_time(a, pw(*d), ev.val, ev.edge, ev.td, ev.n))
    if kind == "ac":
        raise NotImplementedError(f"AC measure kind {m.kind!r} is not "
                                  "differentiable")
    raise NotImplementedError(f"measure kind {m.kind!r} is not "
                              "differentiable (PARAM: derive on host)")


def diff_measure(m, topo: Topology) -> Callable:
    """MeasureSpec -> differentiable fn(times, xs) -> scalar (transient
    analysis; the value of ``evaluate_measure``)."""
    return _compile(m, lambda p: diff_probe(topo, p), "tran")


def diff_measure_ac(m, topo: Topology) -> Callable:
    """MeasureSpec (analysis == "ac") -> differentiable fn(freqs, xr, xi)
    -> scalar; the sweep axis plays the role of time (a WHEN VDB(out)=-3
    card measures the -3 dB frequency)."""
    return _compile(m, lambda p: diff_probe_ac(topo, p), "ac")
