"""Synthetic stress-circuit generators (the port's copy of
``circuitsimulator_tpu/synthetic.py``): the 10k-node RC ladder with its
diode chain and the 2-D RC grid of ``benchmarks/bench_ladder.py`` and
``bench_grid.py``, which exercise the large-circuit backends."""

from __future__ import annotations


def rc_ladder_netlist(n_nodes: int,
                      r: float = 100.0,
                      c: float = 1e-12,
                      diode_every: int = 10,
                      i_sat: float = 1e-14,
                      vdrive: float = 0.5,
                      drive: str = "pulse",
                      tstep: float = 1e-11,
                      tstop: float = 1e-9) -> str:
    """An n-node RC ladder driven from node 1, with a diode to ground every
    `diode_every`-th node.  Node names are 1..n in chain order, so the MNA
    pattern is bordered-tridiagonal (see ops/banded.py)."""
    lines = [f"* synthetic RC ladder, {n_nodes} nodes"]
    if drive == "pulse":
        lines.append(f"V1 1 0 PULSE(0 {vdrive} 0 {tstep} {tstep} {tstop} 0)")
    elif drive == "sin":
        lines.append(f"V1 1 0 SIN 0 {vdrive} {1.0 / (200 * tstep)}")
    else:
        lines.append(f"V1 1 0 DC {vdrive}")
    for i in range(1, n_nodes):
        lines.append(f"R{i} {i} {i + 1} {r}")
    for i in range(1, n_nodes + 1):
        lines.append(f"C{i} {i} 0 {c}")
    for i in range(diode_every, n_nodes + 1, diode_every):
        lines.append(f"D{i} {i} 0 IS={i_sat} N=1")
    lines.append(f".TRAN {tstep} {tstop}")
    return "\n".join(lines) + "\n"


def rc_grid_netlist(n_rows: int, n_cols: int,
                    r: float = 100.0,
                    c: float = 1e-12,
                    diode_every: int = 10,
                    i_sat: float = 1e-14,
                    vdrive: float = 0.5,
                    rail: bool = False,
                    r_rail: float = 10.0,
                    drive: str = "pulse",
                    tstep: float = 1e-11,
                    tstop: float = 1e-9,
                    mos_every: int = 0,
                    moscap_charge: bool = False) -> str:
    """A 2-D resistor-grid RC mesh — deliberately NOT a ladder: every
    interior node couples to 4 neighbors, so the MNA pattern has
    half-bandwidth ~n_cols and exercises the RCM block-banded backend
    (ops/blockband.py) instead of the tridiagonal one.

    Node (i, j) is named i*n_cols+j+1; the drive hits node 1 (a corner).
    With rail=True an extra global node VDD couples to every grid corner's
    row start through r_rail — a high-degree hub that must be pulled into
    the dense border for the bandwidth to stay ~n_cols."""
    n = n_rows * n_cols

    def node(i, j):
        return i * n_cols + j + 1

    lines = [f"* synthetic RC grid, {n_rows}x{n_cols} nodes"]
    if drive == "pulse":
        lines.append(f"V1 1 0 PULSE(0 {vdrive} 0 {tstep} {tstep} {tstop} 0)")
    else:
        lines.append(f"V1 1 0 DC {vdrive}")
    k = 0
    for i in range(n_rows):
        for j in range(n_cols):
            if j + 1 < n_cols:
                k += 1
                lines.append(f"R{k} {node(i, j)} {node(i, j + 1)} {r}")
            if i + 1 < n_rows:
                k += 1
                lines.append(f"R{k} {node(i, j)} {node(i + 1, j)} {r}")
    for idx in range(1, n + 1):
        lines.append(f"C{idx} {idx} 0 {c}")
    if diode_every:
        for idx in range(diode_every, n + 1, diode_every):
            lines.append(f"D{idx} {idx} 0 IS={i_sat} N=1")
    if mos_every:
        # every mos_every-th node: NMOS to ground, gate on the previous
        # node — drain/gate/source all local so the charge-model
        # injection pattern (engine.mq_*) stays inside the band
        lines.append(".MODEL 1 VT 0.7 MU 350e-4 COX 3.45e-4 "
                     "LAMBDA 0.02 CJ0 2e-14")
        for idx in range(mos_every, n + 1, mos_every):
            lines.append(f"M{idx} {idx} {max(idx - 1, 1)} 0 1 "
                         f"20e-6 1e-6 1")
    if moscap_charge:
        lines.append(".OPTIONS MOSCAP=CHARGE")
    if rail:
        # high-degree hub: node n+1 strapped to every row head
        hub = n + 1
        lines.append(f"Vrail {hub} 0 DC {vdrive}")
        for i in range(n_rows):
            k += 1
            lines.append(f"Rrail{i} {hub} {node(i, 0)} {r_rail}")
    lines.append(f".TRAN {tstep} {tstop}")
    return "\n".join(lines) + "\n"
