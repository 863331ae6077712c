"""High-level simulator API (the ported subset of
``circuitsimulator_tpu/api.Simulator``):

    sim = Simulator.from_file("tests/netlists/buffer.sp", device="cuda")
    x = sim.dc()                      # DC operating point, (N,)
    res = sim.transient()             # BE or TRAP transient (.IC/UIC)
    res = sim.transient(adaptive=True)  # the dyadic LTE-controlled ladder
    sim.write_transient_csv("out.csv", res)
    ac = sim.ac()                     # .AC small-signal sweep (K3)
    sw = sim.dc_sweep()               # .DC sweep, one batched DC (K2)
    st = sim.step()                   # .STEP grid as one batch
    sim.measure(res)                  # .MEASURE TRAN cards, [(name, value)]
    sim.measure(sw, "dc")             # .MEASURE DC over the swept value
    bp, vals = sim.monte_carlo(8192)  # DEV=/LOT= lanes, per-lane measures
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
from .netlist import (KIND_C, KIND_L, expand_text, parse_netlist_text,
                      parse_spice_number, read_netlist)
from .ops import cuda_lu
from .ops.assemble import Engine
from .utils import prng
from .utils.options import DEFAULT_OPTIONS, SolverOptions
from .utils.temp import apply_is_temp, has_is_temp, thermal_params

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


def _host(a):
    """A tensor or array as numpy on the host."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class Simulator:
    def __init__(self, circuit, sim_config,
                 opts: Optional[SolverOptions] = None, device="cuda"):
        self.device = device = torch.device(device)
        if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 is True: the one-hot "
                "assembly and Woodbury matmuls must be exact; set it False")
        opts = opts if opts is not None else DEFAULT_OPTIONS
        self.netlist_text: Optional[str] = None   # set by from_file/from_text
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
            self.params.update(thermal_params(float(sim_config.temp_c),
                                              opts.dtype, device))
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
        inst = cls(ckt, sim, opts, device)
        inst.netlist_text = text          # .STEP PARAM re-parses it
        return inst

    @classmethod
    def from_text(cls, text: str, opts: Optional[SolverOptions] = None,
                  device="cuda"):
        text = expand_text(text)
        ckt, sim = parse_netlist_text(text)
        inst = cls(ckt, sim, opts, device)
        inst.netlist_text = text
        return inst

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

    def _initial_conditions_x0(self, uic: bool, params=None):
        """The transient's x0 under .IC / UIC: with UIC, zeros with the
        element IC= values of C and L cards set (the cap's terminal
        difference, the inductor's branch current, so ``init_state``
        derives vc / il = IC), then the .IC node voltages; without UIC, the
        DC point with the .IC nodes overridden.  None when neither applies
        (no .IC card, no UIC): the transient starts from the DC point."""
        ics = self.config.ics
        if not ics and not uic:
            return None
        if uic:
            x0 = torch.zeros((self.topo.n_unknowns,), dtype=self.opts.dtype,
                             device=self.device)
            for e in self.circuit.elements:
                if not e.has_ic:
                    continue
                if e.kind == KIND_L and e.branch_eq >= 0:
                    x0[e.branch_eq] = e.ic
                elif e.kind == KIND_C:
                    eqs = [self.circuit.nodes[nid].eq_index
                           for nid in e.node_ids[:2]]
                    if eqs[0] >= 0:
                        base = x0[eqs[1]] if eqs[1] >= 0 else 0.0
                        x0[eqs[0]] = base + e.ic
                    elif eqs[1] >= 0:       # n+ grounded: v(n-) = -IC
                        x0[eqs[1]] = -e.ic
        else:
            x0 = self.dc(params).clone()
        for node, val in ics:
            nid = self.circuit.node_name_to_id.get(node)
            if nid is None or self.circuit.nodes[nid].eq_index < 0:
                print(f".IC: unknown or ground node {node!r}; ignored",
                      file=sys.stderr)
                continue
            x0[self.circuit.nodes[nid].eq_index] = val
        return x0

    def transient(self, params: Optional[Any] = None,
                  tstep: Optional[float] = None,
                  tstop: Optional[float] = None,
                  save_xs: bool = True,
                  x_op: Optional[Any] = None,
                  adaptive: bool = False,
                  uic: Optional[bool] = None,
                  noise_seed: Optional[int] = 0):
        """Backward-Euler or trapezoidal transient (``METHOD``, the
        ``tran_method`` option); defaults to the netlist's .TRAN card.
        It starts from ``x_op`` when given (the DC point of ``dc()`` for the
        same params); else from the .IC / UIC start
        (``_initial_conditions_x0``: ``uic`` overrides the .TRAN card's UIC
        flag); else it solves the DC point itself.

        adaptive=True runs the LTE-controlled dyadic-refinement integrator
        (``analysis/adaptive.py``, an ``AdaptiveTransientResult``): the
        rows stay on the .TRAN grid, the internal dt refines down to
        tstep / 2**``tran_max_refine_levels`` where the local truncation
        error demands it.

        A deck with TRNOISE sources runs with its transient noise on,
        seeded by ``noise_seed`` (default 0, the JAX package's default: the
        same seed draws JAX's realisation, ``utils/prng.py``);
        ``noise_seed=None`` runs it noise-free.  No effect on other
        decks.  The adaptive integrator runs noise-free (the noise draw
        grid depends on dt); it says so on stderr once."""
        cfg = self.config.tran
        tstep = cfg.tstep if tstep is None else tstep
        tstop = cfg.tstop if tstop is None else tstop
        if tstep is None or tstep <= 0 or tstop is None or tstop <= 0:
            raise ValueError(".TRAN card missing or invalid "
                             "(tstep and tstop must be > 0)")
        p = params if params is not None else self.params
        x0 = x_op
        if x0 is None:
            x0 = self._initial_conditions_x0(cfg.uic if uic is None else uic,
                                             p)
        if x0 is None:
            x0 = self.dc(p)
        if adaptive:
            from .analysis.adaptive import run_transient_adaptive
            if (noise_seed is not None and self.engine.has_trnoise
                    and not getattr(self, "_warned_adaptive_noise", False)):
                print("note: the adaptive integrator runs TRNOISE decks "
                      "noise-free (dt-dependent draw grid); use the "
                      "fixed-step transient for noise", file=sys.stderr)
                self._warned_adaptive_noise = True
            return run_transient_adaptive(self.engine, p, tstep, tstop,
                                          x0=x0, save_xs=save_xs)
        key = (prng.key(noise_seed, self.device)
               if noise_seed is not None and self.engine.has_trnoise
               else None)
        return run_transient(self.engine, p, tstep, tstop, x0=x0,
                             save_xs=save_xs, noise_key=key)

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

    def monte_carlo(self, n: int, seed: int = 0,
                    params: Optional[Any] = None, warm_start: bool = True,
                    sampler: str = "mc"):
        """Netlist-driven Monte Carlo from the DEV=/LOT= tolerances on R/C/L
        cards (the value) and M/J/D/Q cards (VT/VTO, IS, BF mismatch),
        drawn by ``perturb_params_netlist`` from a ``torch.Generator``
        seeded with ``seed``.  Runs the deck's primary analysis over n
        lanes in one batched solve: with .TRAN and .MEASURE TRAN cards,
        (bparams, {measure: (n,) values}) from the streaming measures (K1
        with its probe stream on a float32 CUDA run of a deck in its
        scope); with .AC and .MEASURE AC cards, one lanes x frequencies
        sweep (K3) and the measures per lane; otherwise (bparams, (n, N) DC
        operating points).

        warm_start: every lane's DC starts from the nominal operating point
        (``dc()``) and runs only the final Newton stage
        (``batched_dc_warm``); False runs the whole source ramp per lane
        (``batched_dc_fast``)."""
        from .parallel.montecarlo import (batched_ac_measures,
                                          batched_dc_fast, batched_dc_warm,
                                          batched_transient_measures,
                                          perturb_params_netlist)
        if not self.lowered.mc_tols:
            raise ValueError("no DEV=/LOT= tolerances in the netlist")
        p = params if params is not None else self.params
        gen = torch.Generator(device=self.device).manual_seed(seed)
        bp = perturb_params_netlist(p, gen, n, self.lowered.mc_tols,
                                    sampler=sampler)
        warm = warm_start and self.topo.has_nonlinear

        def dc_init():
            if warm:
                return batched_dc_warm(self.engine, bp, self.dc(params=p))
            return batched_dc_fast(self.engine, bp)

        tran = self.config.tran
        ms = self.config.measures
        if tran.enabled and any(m.analysis == "tran" for m in ms):
            # as in the JAX facade, no .PARAM bindings here: a derived
            # PARAM= measure that reads a .PARAM name is NaN
            _, vals = batched_transient_measures(
                self.engine, bp, tran.tstep, tran.tstop,
                [m for m in ms if m.analysis == "tran"], self.topo,
                x0=dc_init())
            return bp, vals
        ac = self.config.ac
        if ac.enabled and any(m.analysis == "ac" for m in ms):
            from .analysis.ac import sweep_frequencies
            freqs = sweep_frequencies(ac.sweep_type, ac.n_points,
                                      ac.fstart, ac.fstop)
            return bp, batched_ac_measures(
                self.engine, self.topo, bp, freqs,
                [m for m in ms if m.analysis == "ac"],
                bindings=self.config.param_values, x_ops=dc_init())
        return bp, dc_init()

    def dc_sweep(self, sweep_index: int = 0, params: Optional[Any] = None,
                 values=None, source: Optional[str] = None):
        """DC sweep (analysis/sweep.py): the whole grid as one batched DC
        (K2 on the card).  Defaults to the netlist's .DC card(s);
        ``source`` + ``values`` override."""
        from .analysis.sweep import dc_sweep, sweep_values
        source2, values2 = "", None
        if source is None:
            if not self.config.dc_sweeps:
                raise ValueError(".DC card missing")
            cfg = self.config.dc_sweeps[sweep_index]
            source = cfg.source_name
            if values is None:
                values = sweep_values(cfg.start, cfg.stop, cfg.step)
                if cfg.source2:
                    source2 = cfg.source2
                    values2 = sweep_values(cfg.start2, cfg.stop2, cfg.step2)
        elif values is None:
            raise ValueError("explicit `source` requires `values`")
        p = params if params is not None else self.params
        return dc_sweep(self.engine, p, self.circuit, source, values,
                        source2=source2, values2=values2)

    def step(self, step_index: Optional[int] = None, save_xs: bool = True):
        """.STEP sweep (analysis/step.py): the step values run as one batch,
        the transient if a .TRAN card is present (with per-step .MEASURE
        results), else the DC operating point.  Several .STEP cards form a
        cartesian grid in the same batch; ``step_index`` selects one card.
        Returns a StepResult."""
        from .analysis.step import run_step
        if not self.config.steps:
            raise ValueError(".STEP card missing")
        cfgs = (self.config.steps if step_index is None
                else self.config.steps[step_index])
        return run_step(self, cfgs, save_xs=save_xs)

    # ---- post-processing ----
    def measure(self, result, analysis: str = "tran"):
        """.MEASURE evaluation on the host (analysis/measure.py): a
        TransientResult ("tran", axis = time), an ACResult ("ac", axis =
        frequency; complex data reduces per the VDB/VP/... modifiers) or a
        DCSweepResult ("dc", axis = the swept value).  Returns [(name,
        value)] with NaN for failed measurements."""
        from .analysis.measure import run_measures
        if result.xs is None:
            raise ValueError(".MEASURE needs saved waveforms "
                             "(save_xs=True)")
        if analysis == "ac":
            axis = result.freqs
        elif analysis == "dc":
            axis = result.values
        else:
            axis = result.times
        return run_measures(self.config.measures, self.topo, _host(axis),
                            _host(result.xs), analysis=analysis,
                            bindings=self.config.param_values)

    def fourier(self, result: TransientResult, f0: Optional[float] = None,
                probes=None, n_harm: int = 9):
        """.FOUR Fourier analysis of a finished transient (analysis/
        fourier.py).  Defaults to the netlist's .FOUR card."""
        from .analysis.fourier import fourier_analysis
        from .io.csvout import probe_selection
        from .netlist.parser import PrintCommand
        cfg = self.config.four
        if f0 is None:
            if not cfg.enabled:
                raise ValueError(".FOUR card missing")
            f0 = cfg.f0
        if probes is None:
            if not cfg.enabled:
                raise ValueError("explicit f0 requires `probes`")
            probes = cfg.probes
        sel = probe_selection(self.topo,
                              [PrintCommand(analysis="none", probes=probes)])
        if not sel:
            raise ValueError(".FOUR: no resolvable output probes")
        if result.xs is None:
            raise ValueError(".FOUR needs a transient run with save_xs=True")
        return fourier_analysis(_host(result.times), _host(result.xs), f0,
                                sel, n_harm=n_harm)

    # ---- output ----
    def write_transient_csv(self, path: str, result,
                            tstart: Optional[float] = None) -> None:
        """The CSV of a TransientResult or an AdaptiveTransientResult (its
        rows: the .TRAN grid)."""
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
