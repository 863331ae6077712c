"""ngspice/SPICE3 ASCII rawfile writer; port of
``circuitsimulator_tpu/io/rawfile.py``.

The classic ASCII dialect that SPICE waveform viewers read:

    Title: <title>
    Date: (n/a)
    Plotname: Transient Analysis
    Flags: real
    No. Variables: <nvars>
    No. Points: <npoints>
    Variables:
            0       time    time
            1       v(out)  voltage
            ...
    Values:
    0       <t0>
            <v0>
    ...

AC sweeps use ``Flags: complex`` with ``re,im`` pairs per value.  Column
order mirrors the CSV writer (io/csvout.py): node voltages in creation
order, then branch currents.  A file opened with mode "a" takes further
plots (multi-plot rawfiles are standard).  numpy only.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ir.lower import Topology


def _var_table(topo: Topology) -> List[Tuple[str, str, int]]:
    """[(name, spice type, eq index)] for every output column."""
    out = []
    for n, eq in zip(topo.volt_col_names, topo.volt_col_eqs):
        out.append((f"v({n})", "voltage", int(eq)))
    for n, eq in zip(topo.branch_col_names, topo.branch_col_eqs):
        out.append((f"i({n})", "current", int(eq)))
    return out


def _write_header(f, title: str, plotname: str, flags: str,
                  variables: List[Tuple[str, str]], npoints: int,
                  axis_name: str, axis_type: str) -> None:
    f.write(f"Title: {title}\n")
    f.write("Date: (n/a)\n")
    f.write(f"Plotname: {plotname}\n")
    f.write(f"Flags: {flags}\n")
    f.write(f"No. Variables: {len(variables) + 1}\n")
    f.write(f"No. Points: {npoints}\n")
    f.write("Variables:\n")
    f.write(f"\t0\t{axis_name}\t{axis_type}\n")
    for k, (name, typ) in enumerate(variables):
        f.write(f"\t{k + 1}\t{name}\t{typ}\n")
    f.write("Values:\n")


def write_raw_transient(path: str, topo: Topology, times, xs,
                        title: str = "circuitsimulator_tpu",
                        tstart: float = 0.0, mode: str = "w") -> None:
    """Transient rawfile; rows with t < tstart are suppressed, as the CSV
    writer's .TRAN tstart does."""
    times = np.asarray(times)
    xs = np.asarray(xs)
    keep = times >= tstart - 1e-21
    times, xs = times[keep], xs[keep]
    table = _var_table(topo)
    with open(path, mode) as f:
        _write_header(f, title, "Transient Analysis", "real",
                      [(n, t) for n, t, _ in table], len(times),
                      "time", "time")
        for i, t in enumerate(times):
            f.write(f"{i}\t{t:.15e}\n")
            for _, _, eq in table:
                f.write(f"\t{xs[i, eq]:.15e}\n")


def write_raw_ac(path: str, topo: Topology, freqs, xs,
                 title: str = "circuitsimulator_tpu",
                 mode: str = "w") -> None:
    """AC rawfile: complex values as ``re,im``, frequency axis."""
    freqs = np.asarray(freqs)
    xs = np.asarray(xs)
    table = _var_table(topo)
    with open(path, mode) as f:
        _write_header(f, title, "AC Analysis", "complex",
                      [(n, t) for n, t, _ in table], len(freqs),
                      "frequency", "frequency")
        for i, fr in enumerate(freqs):
            f.write(f"{i}\t{fr:.15e},0.000000000000000e+00\n")
            for _, _, eq in table:
                v = xs[i, eq]
                f.write(f"\t{v.real:.15e},{v.imag:.15e}\n")


def write_raw_dc_sweep(path: str, topo: Topology, values, xs, source: str,
                       title: str = "circuitsimulator_tpu",
                       mode: str = "w") -> None:
    """DC sweep rawfile: the swept source value as the axis."""
    values = np.asarray(values)
    xs = np.asarray(xs)
    table = _var_table(topo)
    with open(path, mode) as f:
        _write_header(f, title, "DC transfer characteristic", "real",
                      [(n, t) for n, t, _ in table], len(values),
                      f"v({source.lower()})", "voltage")
        for i, v in enumerate(values):
            f.write(f"{i}\t{v:.15e}\n")
            for _, _, eq in table:
                f.write(f"\t{xs[i, eq]:.15e}\n")
