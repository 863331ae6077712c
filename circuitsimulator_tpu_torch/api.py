"""High-level simulator API (the main-path subset of
``circuitsimulator_tpu/api.Simulator``):

    sim = Simulator.from_file("tests/netlists/buffer.sp", device="cuda")
    x = sim.dc()                      # DC operating point, (N,)
    res = sim.transient()             # Backward-Euler transient
    sim.write_transient_csv("out.csv", res)
    ac = sim.ac()                     # .AC small-signal sweep (K3)
"""

from __future__ import annotations

import sys
from typing import Any, Optional

import numpy as np
import torch

from .analysis.dc import dc_operating_point
from .analysis.transient import TransientResult, run_transient
from .io.csvout import write_transient_csv
from .io.table import circuit_summary, dc_table
from .ir.lower import LoweredCircuit, lower
from .netlist import (expand_text, parse_netlist_text, parse_spice_number,
                      read_netlist)
from .ops import cuda_lu
from .ops.assemble import Engine
from .utils.options import DEFAULT_OPTIONS, SolverOptions
from .utils.temp import apply_is_temp, has_is_temp

# the JAX package switches to structure-exploiting solvers above this many
# node equations (api.py auto_backend); the port has only the dense path
MAX_DENSE_NODE_EQS = 128


def _apply_netlist_options(opts: SolverOptions, sim_config) -> SolverOptions:
    """.OPTIONS card -> SolverOptions (METHOD, GMIN, VNTOL/ABSTOL, RELTOL,
    ITL1, ITL4, TEMP, MOSSYM, MOSCAP); unknown keys warn and are ignored."""
    kw = {}
    for k, v in (getattr(sim_config, "options", None) or {}).items():
        try:
            if k == "method":
                m = v.lower()
                if m in ("be", "trap"):
                    kw["tran_method"] = m
                else:
                    print(f".OPTIONS: unsupported METHOD={v}; keeping be",
                          file=sys.stderr)
            elif k == "gmin":
                kw["tran_gmin"] = parse_spice_number(v)
            elif k in ("vntol", "abstol"):
                kw["tran_tol"] = parse_spice_number(v)
            elif k == "reltol":
                kw["tran_lte_rtol"] = parse_spice_number(v)
            elif k == "itl1":
                kw["dc_max_newton_iters"] = int(parse_spice_number(v))
            elif k == "itl4":
                kw["tran_max_newton_iters"] = int(parse_spice_number(v))
            elif k == "temp":
                sim_config.temp_c = parse_spice_number(v)
            elif k == "mossym":
                kw["mos_reverse_region"] = bool(int(parse_spice_number(v)))
            elif k == "moscap":
                m = str(v).lower()
                if m in ("fixed", "charge"):
                    kw["mos_cap_model"] = m
                else:
                    print(f".OPTIONS: unsupported MOSCAP={v}; keeping fixed",
                          file=sys.stderr)
            else:
                print(f".OPTIONS: unknown option {k.upper()}; ignored",
                      file=sys.stderr)
        except ValueError as e:
            print(f".OPTIONS: cannot parse {k}={v}: {e}", file=sys.stderr)
    return opts.replace(**kw) if kw else opts


class Simulator:
    def __init__(self, circuit, sim_config,
                 opts: Optional[SolverOptions] = None, device="cuda"):
        self.device = device = torch.device(device)
        if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 is True: the one-hot "
                "assembly and Woodbury matmuls must be exact; set it False")
        opts = opts if opts is not None else DEFAULT_OPTIONS
        self.circuit = circuit
        self.config = sim_config
        circuit.assign_equation_indices()
        self.lowered: LoweredCircuit = lower(circuit, opts.dtype, device)
        self.topo = self.lowered.topo
        self.params = dict(self.lowered.params)
        self.opts = opts = _apply_netlist_options(opts, sim_config)
        if getattr(sim_config, "temp_c", None) is not None:
            # .TEMP: rescale the thermal voltage kT/q and the resistor TC
            # temperature offset; with EG/XTI given, the diode/BJT
            # saturation currents too
            k_b, q_e = 1.380649e-23, 1.602176634e-19
            temp_c = float(sim_config.temp_c)
            self.params["vt_thermal"] = torch.tensor(
                k_b * (273.15 + temp_c) / q_e, dtype=opts.dtype, device=device)
            self.params["temp_delta_c"] = torch.tensor(
                temp_c - 27.0, dtype=opts.dtype, device=device)
            if has_is_temp(self.params):
                self.params = apply_is_temp(self.params)
        if opts.auto_backend and self.topo.n_node_eq > MAX_DENSE_NODE_EQS:
            raise NotImplementedError(
                f"{self.topo.n_node_eq} node equations: the large-circuit "
                f"backends (tridiag/blockband/blockwb) are not yet ported")
        c = self.topo.counts                # Woodbury k x k solve size
        rank = (c["M"] + c["J"] + c["D"] + 2 * c["Q"] + c["S"]
                + len(self.lowered.b_sources))
        if opts.mos_cap_model == "charge":
            rank += 5 * c["M"]              # the charge rows
        if device.type == "cuda" and max(self.topo.n_unknowns,
                                         rank) > cuda_lu.MAX_N:
            raise NotImplementedError(
                f"{self.topo.n_unknowns} unknowns / Woodbury rank {rank}: "
                f"the CUDA LU kernel takes N <= {cuda_lu.MAX_N}")
        self.engine = Engine(self.lowered, opts, device)

    # ---- constructors ----
    @classmethod
    def from_file(cls, path: str, opts: Optional[SolverOptions] = None,
                  device="cuda"):
        try:
            text = read_netlist(path)
        except OSError:
            print(f"cannot open netlist file {path}", file=sys.stderr)
            raise FileNotFoundError(path)
        ckt, sim = parse_netlist_text(text)
        return cls(ckt, sim, opts, device)

    @classmethod
    def from_text(cls, text: str, opts: Optional[SolverOptions] = None,
                  device="cuda"):
        ckt, sim = parse_netlist_text(expand_text(text))
        return cls(ckt, sim, opts, device)

    # ---- analyses ----
    def _nodeset(self):
        """The .NODESET card as (eqs, vals) arrays, or None; unknown and
        ground nodes are skipped with a warning."""
        if not getattr(self.config, "nodesets", None):
            return None
        eqs, vals = [], []
        for node, val in self.config.nodesets:
            nid = self.circuit.node_name_to_id.get(node)
            if nid is None or self.circuit.nodes[nid].eq_index < 0:
                print(f".NODESET: unknown or ground node {node!r}; ignored",
                      file=sys.stderr)
                continue
            eqs.append(self.circuit.nodes[nid].eq_index)
            vals.append(val)
        if not eqs:
            return None
        return (np.asarray(eqs, np.int64),
                torch.as_tensor(vals, dtype=self.opts.dtype,
                                device=self.device))

    def dc(self, params: Optional[Any] = None):
        """DC operating point -> (N,) solution vector.  A .NODESET card
        steers Newton toward the wanted solution branch (hold, then
        release on the last ramp step)."""
        p = params if params is not None else self.params
        return dc_operating_point(self.engine, p, nodeset=self._nodeset())

    def transient(self, params: Optional[Any] = None,
                  tstep: Optional[float] = None,
                  tstop: Optional[float] = None,
                  save_xs: bool = True,
                  x_op: Optional[Any] = None) -> TransientResult:
        """Backward-Euler transient; defaults to the netlist's .TRAN card.
        It starts from ``x_op`` when given (the DC point of ``dc()`` for the
        same params), else it solves the DC point itself."""
        cfg = self.config.tran
        tstep = cfg.tstep if tstep is None else tstep
        tstop = cfg.tstop if tstop is None else tstop
        if tstep is None or tstep <= 0 or tstop is None or tstop <= 0:
            raise ValueError(".TRAN card missing or invalid "
                             "(tstep and tstop must be > 0)")
        if self.config.ics or cfg.uic:
            raise NotImplementedError(".IC / UIC initial conditions: "
                                      "not yet ported")
        p = params if params is not None else self.params
        x0 = self.dc(p) if x_op is None else x_op
        return run_transient(self.engine, p, tstep, tstop, x0=x0,
                             save_xs=save_xs)

    def ac(self, params: Optional[Any] = None, freqs=None,
           x_op: Optional[Any] = None):
        """Small-signal AC sweep (analysis/ac.py).  Defaults to the
        netlist's .AC card; `freqs` overrides with an explicit array."""
        from .analysis.ac import ac_analysis, sweep_frequencies
        if freqs is None:
            cfg = self.config.ac
            if not cfg.enabled:
                raise ValueError(".AC card missing")
            freqs = sweep_frequencies(cfg.sweep_type, cfg.n_points,
                                      cfg.fstart, cfg.fstop)
        p = params if params is not None else self.params
        return ac_analysis(self.engine, p, freqs, x_op=x_op)

    # ---- output ----
    def write_transient_csv(self, path: str, result: TransientResult,
                            tstart: Optional[float] = None) -> None:
        if tstart is None:
            tstart = self.config.tran.tstart or 0.0
        if bool(result.failed):
            raise RuntimeError("Transient: LU produced NaN/Inf.")
        write_transient_csv(path, self.topo, result.times.cpu().numpy(),
                            result.xs.cpu().numpy(), tstart)

    def summary(self) -> str:
        return circuit_summary(self.topo)

    def dc_report(self, x) -> str:
        return dc_table(self.topo, torch.as_tensor(x).cpu().numpy())
