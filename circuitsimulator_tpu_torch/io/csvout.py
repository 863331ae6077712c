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


def probe_selection(topo: Topology, print_commands, analysis=None):
    """Resolve .PLOTNV/.PLOTNC/.PRINT probes to CSV columns.

    Returns [(label, spec)] where spec is an eq index, or an (eq_a, eq_b)
    pair for a differential V(a,b) probe (eq -1 is ground).  Unresolvable
    probes are skipped.  `analysis` (an AN_* string) keeps only the .PRINT
    commands of that analysis plus analysis-less .PLOTNV/.PLOTNC probes."""
    v_by_name = dict(zip(topo.volt_col_names, topo.volt_col_eqs))
    i_by_name = dict(zip(topo.branch_col_names, topo.branch_col_eqs))
    sel = []
    seen = set()

    def add(label, spec):
        if label not in seen:
            seen.add(label)
            sel.append((label, spec))

    def veq(name):
        if name in v_by_name:
            return int(v_by_name[name])
        return -1 if name.lower() in ("0", "gnd") else None

    for pc in print_commands:
        if analysis is not None and pc.analysis not in (analysis, "none", ""):
            continue
        for p in pc.probes:
            if p.kind == "nv":
                eq = veq(p.node1)
                if eq is not None:
                    add(f"V({p.node1})", eq)
            elif p.kind == "dv":
                ea, eb = veq(p.node1), veq(p.node2)
                if ea is not None and eb is not None:
                    # comma-free CSV label
                    add(f"V({p.node1})-V({p.node2})", (ea, eb))
            elif p.kind == "br":
                if p.ele_name in i_by_name:
                    add(f"I({p.ele_name})", int(i_by_name[p.ele_name]))
    return sel


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
