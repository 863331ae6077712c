"""Transient CSV writer, byte-compatible with the reference's schema
(src/tanalisis.cpp:182-231):

- header ``time,V(<node>)...,I(<element>)...``: node voltages for eq >= 0 in
  node-creation order, then branch currents of V sources and inductors in
  element order;
- every value (time included) formatted as C++ ``std::scientific <<
  std::setprecision(9)`` == ``%.9e``;
- rows with t < tstart are suppressed.

numpy only.
"""

from __future__ import annotations

import numpy as np

from ..ir.lower import Topology


def format_header(topo: Topology) -> str:
    cols = ["time"]
    cols += [f"V({n})" for n in topo.volt_col_names]
    cols += [f"I({n})" for n in topo.branch_col_names]
    return ",".join(cols)


def write_transient_csv(path: str, topo: Topology, times, xs,
                        tstart: float = 0.0) -> None:
    times = np.asarray(times)
    xs = np.asarray(xs)
    col_eqs = np.concatenate([topo.volt_col_eqs,
                              topo.branch_col_eqs]).astype(int)
    keep = times >= tstart
    out = np.column_stack([times[keep], xs[:, col_eqs][keep]])
    with open(path, "w") as f:
        f.write(format_header(topo) + "\n")
        np.savetxt(f, out, fmt="%.9e", delimiter=",")
