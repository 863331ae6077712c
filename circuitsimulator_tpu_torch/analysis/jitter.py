"""Timing jitter over TRNOISE transient-noise lanes (port of
``circuitsimulator_tpu/analysis/jitter.py``).

N independent noise realisations of one deck run as one batched transient
(``parallel.montecarlo.batched_transient`` with the waveforms kept: the
non-fused loop, its DC and Woodbury solves on K2 on the card; lane b's
noise key is ``prng.split(key, N)[b]``, so each lane's TRNOISE draws are
the JAX package's), then on the host every lane's interpolated threshold
crossings of a probe give per-edge statistics: the absolute jitter (the
std of each edge's time across lanes) and the period jitter (the std of
the k -> k+1 spacing).

Crossings are ``measure._crossings``' (the edges of ``.MEASURE WHEN``).
``hysteresis=h`` debounces noise that double-crosses the threshold: a
rising edge counts only after the signal has dipped below threshold - h
since the last accepted edge.  Lanes that still disagree on the edge
count are cut to the common prefix, with a warning on stderr.
"""

from __future__ import annotations

import sys

import numpy as np

from ..ops.assemble import Engine
from .measure import _crossings


def _debounced(t: np.ndarray, v: np.ndarray, thr: float, rising: bool,
               h: float, t_min: float) -> np.ndarray:
    """Schmitt-style edge times: a crossing of ``thr`` counts only after
    the waveform visited the release band (thr - h rising, thr + h
    falling) since the previous accepted edge."""
    tc = _crossings(t, v, thr, "rise" if rising else "fall", t_min)
    if h <= 0 or tc.size == 0:
        return tc
    release = _crossings(t, v, thr - h if rising else thr + h,
                         "fall" if rising else "rise", t_min)
    out = []
    armed = True           # armed at t = 0 (the signal starts far side)
    ri = 0
    for time in tc:
        while ri < release.size and release[ri] < time:
            armed = True
            ri += 1
        if armed:
            out.append(time)
            armed = False
    return np.asarray(out)


def jitter_analysis(engine: Engine, params, tstep, tstop,
                    eq_index: int, threshold: float, key,
                    n_lanes: int = 64, rising: bool = True,
                    t_min: float = 0.0, hysteresis: float = 0.0):
    """Per-edge crossing-time statistics over n_lanes noise realisations
    (``key``: a ``utils/prng`` key).  Returns a dict: edge_times
    (n_lanes, K), edge_mean / edge_jitter (K,), n_edges, and with two
    edges or more period_mean / period_jitter (K - 1,), else
    period_jitter None."""
    from ..parallel.montecarlo import batched_transient, broadcast_params
    if not engine.has_trnoise:
        raise ValueError("jitter analysis needs TRNOISE sources")
    bp = broadcast_params(params, n_lanes)
    res = batched_transient(engine, bp, tstep, tstop, save_xs=True,
                            noise_key=key)
    probe = res.xs[:, :, eq_index].T.cpu().numpy()        # (B, T + 1)
    times = res.times.cpu().numpy()
    per_lane = [_debounced(times, probe[b], threshold, rising, hysteresis,
                           t_min) for b in range(n_lanes)]
    counts = np.asarray([len(c) for c in per_lane])
    k = int(counts.min())
    if k == 0:
        raise ValueError("no threshold crossings found on any lane")
    if counts.max() != k:
        print(f"jitter: lanes disagree on the edge count "
              f"(min {k}, max {int(counts.max())}) — noise is "
              "double-crossing the threshold; statistics use the first "
              f"{k} edges per lane.  Pass hysteresis= (a volt-scale "
              "release band) to debounce.", file=sys.stderr)
    edges = np.stack([c[:k] for c in per_lane])          # (B, K)
    out = {"edge_times": edges, "edge_mean": edges.mean(axis=0),
           "edge_jitter": edges.std(axis=0), "n_edges": k}
    if k > 1:
        periods = np.diff(edges, axis=1)                 # (B, K - 1)
        out["period_mean"] = periods.mean(axis=0)
        out["period_jitter"] = periods.std(axis=0)
    else:
        out["period_jitter"] = None
    return out
