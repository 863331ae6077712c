"""DC result tables in the reference CLI's format (src/main.cpp:36-93):
circuit summary, node voltages (6 decimals, ground rows marked [GND]) and
branch currents of V sources and inductors.  numpy only."""

from __future__ import annotations

import numpy as np

from ..ir.lower import Topology
from ..netlist import KIND_V


def circuit_summary(topo: Topology) -> str:
    lines = [
        "",
        "==== Circuit summary ====",
        f"Node count   : {topo.n_nodes}",
        f"Element count: {topo.n_elements}",
        (f"Unknowns     : {topo.n_unknowns}  "
         f"(nodeEq={topo.n_node_eq}, "
         f"branchEq={topo.n_unknowns - topo.n_node_eq})"),
    ]
    return "\n".join(lines)


def dc_table(topo: Topology, x) -> str:
    x = np.asarray(x)
    lines = ["", "==== DC node voltages ===="]
    for name, eq in topo.node_table:
        if eq >= 0:
            lines.append(f"V({name}) = {x[eq]:.6f} V   [eqIndex={eq}]")
        else:
            lines.append(f"V({name}) = 0.000000 V   [GND]")
    lines.append("")
    lines.append("==== DC branch currents (voltage sources / inductors) ====")
    for kind, name, np_name, nm_name, eq in topo.branch_table:
        cur = x[eq] if 0 <= eq < len(x) else 0.0
        if kind == KIND_V:
            lines.append(f"I({name}, +{np_name} -> -{nm_name}) = {cur:.6f} A"
                         f"   [branchEq={eq}]")
        else:
            lines.append(f"I({name}, {np_name} -> {nm_name}) = {cur:.6f} A"
                         f"   [branchEq={eq}]")
    return "\n".join(lines)
