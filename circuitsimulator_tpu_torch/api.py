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
    sim.tf(); sim.sensitivity(); sim.pole_zero()   # .TF, .SENS, .PZ (K2)
    sim.noise(); sim.noise_figure("Rs")            # adjoint sweep (K3)
    sim.loop_gain("E1"); sim.group_delay("out")    # K3, one / two launches
    sim.sparams([("p1", None, 50.0)]); sim.stability(ports)   # K3 lanes
    sim.write_raw("out.raw", res)      # ngspice ASCII rawfile
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
from .netlist import (KIND_C, KIND_E, KIND_L, KIND_R, KIND_V, expand_text,
                      parse_netlist_text, parse_spice_number, read_netlist)
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

    # ---- small-signal analyses ----
    def _ac_freqs(self):
        from .analysis.ac import sweep_frequencies
        ac = self.config.ac
        if not ac.enabled:
            raise ValueError("deck has no .AC card")
        return sweep_frequencies(ac.sweep_type, ac.n_points,
                                 ac.fstart, ac.fstop)

    def _node_eq(self, name: str) -> int:
        nid = self.circuit.node_name_to_id.get(name)
        if nid is None:
            raise KeyError(f"unknown node {name!r}")
        return self.circuit.nodes[nid].eq_index

    def _input_ref(self, source: str):
        """("v", branch_eq) of a V source or ("i", ep, em) of an I source:
        the input of .TF, .NOISE and .PZ."""
        from .analysis.sweep import find_source
        kind, idx = find_source(self.circuit, source)
        if kind == KIND_V:
            return ("v", int(self.topo.vs_k[idx]))
        return ("i", int(self.topo.is_ep[idx]), int(self.topo.is_em[idx]))

    def _noise_freqs(self, missing: str):
        """The .NOISE card's sweep, else the .AC card's."""
        from .analysis.ac import sweep_frequencies
        cfg = self.config.noise
        if cfg.enabled and cfg.sweep_type:
            return sweep_frequencies(cfg.sweep_type, cfg.n_points,
                                     cfg.fstart, cfg.fstop)
        if self.config.ac.enabled:
            ac = self.config.ac
            return sweep_frequencies(ac.sweep_type, ac.n_points,
                                     ac.fstart, ac.fstop)
        raise ValueError(missing)

    def group_delay(self, probe: str, params: Optional[Any] = None,
                    freqs=None, x_op: Optional[Any] = None):
        """Exact group delay tau_g(f) = -d phase / d omega of V(probe) from
        the adjoint of the small-signal solve (analysis/ac.group_delay:
        two K3 sweeps; a T-line deck on K2).  Defaults to the .AC card's
        sweep; returns (freqs, tau_g) numpy arrays."""
        from .analysis.ac import _omegas, group_delay
        if freqs is None:
            freqs = self._ac_freqs()
        eqi = self._node_eq(probe)
        p = params if params is not None else self.params
        if x_op is None:
            x_op = self.dc(params=params)
        _, om = _omegas(self.engine, freqs)
        tau = group_delay(self.engine, p, x_op, om, eqi)
        return np.asarray(freqs), tau.cpu().numpy()

    def loop_gain(self, source: str, params: Optional[Any] = None,
                  freqs=None, x_op: Optional[Any] = None):
        """Bode's return ratio of the named E (VCVS) source
        (analysis/loopgain.py): the source nulled, its branch driven with
        a unit test voltage, one K3 sweep.  Returns a dict: freqs, T
        (complex), f_unity, phase_margin_deg, f_180, gain_margin_db."""
        from .analysis.loopgain import loop_gain, margins
        idx = None
        j = 0
        for e in self.circuit.elements:
            if e.kind == KIND_E:
                if e.name.upper() == source.upper():
                    idx = j
                    break
                j += 1
        if idx is None:
            raise KeyError(f"no VCVS named {source!r}")
        if freqs is None:
            freqs = self._ac_freqs()
        p = params if params is not None else self.params
        if x_op is None:
            x_op = self.dc(params=params)
        T = loop_gain(self.engine, p, idx, freqs, x_op)
        out = {"freqs": freqs, "T": T}
        out.update(margins(freqs, T))
        return out

    def pole_zero(self, params: Optional[Any] = None,
                  out_node: Optional[str] = None,
                  ref_node: Optional[str] = None,
                  input_source: Optional[str] = None,
                  x_op: Optional[Any] = None):
        """.PZ pole-zero analysis (analysis/pz.py) of the circuit
        linearized at the DC operating point; zeros require an input
        source."""
        from .analysis.pz import pole_zero
        cfg = self.config.pz
        if out_node is None:
            if not cfg.enabled:
                raise ValueError(".PZ card missing")
            out_node = cfg.out_node
            ref_node = ref_node or (cfg.ref_node or None)
            input_source = input_source or (cfg.input_source or None)
        out_eq = self._node_eq(out_node)
        if out_eq < 0:
            raise ValueError(f".PZ output node {out_node!r} is ground")
        ref_eq = self._node_eq(ref_node) if ref_node else -1
        input_ref = self._input_ref(input_source) if input_source else None
        p = params if params is not None else self.params
        return pole_zero(self.engine, p, out_eq, ref_eq, input_ref,
                         x_op=x_op)

    def sensitivity(self, params: Optional[Any] = None,
                    out_node: Optional[str] = None,
                    ref_node: Optional[str] = None,
                    x_op: Optional[Any] = None):
        """.SENS DC sensitivity (analysis/sensitivity.py): the gradient of
        V(out[,ref]) with respect to every circuit parameter by implicit
        differentiation at the operating point (one adjoint K2 solve, one
        autograd pass).  Returns (grads, rows): grads matches the params
        dict, rows is the sorted report [(label, dV/dp, p*dV/dp)]."""
        from .analysis.sensitivity import dc_sensitivity, sensitivity_report
        cfg = self.config.sens
        if out_node is None:
            if not cfg.enabled:
                raise ValueError(".SENS card missing")
            out_node = cfg.out_node
            ref_node = ref_node or (cfg.ref_node or None)
        out_eq = self._node_eq(out_node)
        if out_eq < 0:
            raise ValueError(f".SENS output node {out_node!r} is ground")
        ref_eq = self._node_eq(ref_node) if ref_node else -1
        p = params if params is not None else self.params
        grads, _, _ = dc_sensitivity(self.engine, p, out_eq, ref_eq, x=x_op)
        rows = sensitivity_report(self.circuit, grads, normalize_params=p)
        return grads, rows

    def tf(self, params: Optional[Any] = None, x_op: Optional[Any] = None):
        """.TF DC transfer function (analysis/tf.py): small-signal DC gain
        d out/d in, the input resistance seen by the input source and the
        output resistance at the output probe, from one linearization at
        the (polished) operating point."""
        from .analysis.tf import dc_transfer_function
        cfg = self.config.tf
        if not cfg.enabled:
            raise ValueError(".TF card missing")
        input_ref = self._input_ref(cfg.input_source)
        if cfg.out_kind == "v":
            out_a = self._node_eq(cfg.out_node)
            if out_a < 0:
                raise ValueError(f".TF output node {cfg.out_node!r} "
                                 "is ground")
            out_b = self._node_eq(cfg.ref_node) if cfg.ref_node else -1
        else:
            out_a = out_b = -1
            for e in self.circuit.elements:
                if (e.name.lower() == cfg.out_element.lower()
                        and getattr(e, "branch_eq", -1) >= 0):
                    out_a = e.branch_eq
                    break
            if out_a < 0:
                raise ValueError(f".TF current output {cfg.out_element!r}: "
                                 "no such branch-current unknown (only "
                                 "V sources and inductors carry one)")
        p = params if params is not None else self.params
        return dc_transfer_function(self.engine, p, cfg.out_kind,
                                    out_a, out_b, input_ref, x=x_op)

    def noise(self, params: Optional[Any] = None, freqs=None,
              out_node: Optional[str] = None, ref_node: Optional[str] = None,
              input_source: Optional[str] = None,
              x_op: Optional[Any] = None):
        """Small-signal noise analysis (.NOISE card, analysis/noise.py):
        the output PSD at V(out_node[, ref_node]), with input_source also
        the gain-referred input noise.  The sweep defaults to the .NOISE
        card's, or to the .AC card's if the .NOISE card has none."""
        from .analysis.noise import noise_analysis
        cfg = self.config.noise
        if out_node is None:
            if not cfg.enabled:
                raise ValueError(".NOISE card missing")
            out_node = cfg.out_node
            ref_node = ref_node or (cfg.ref_node or None)
            input_source = input_source or (cfg.input_source or None)
        if freqs is None:
            freqs = self._noise_freqs(
                "no frequency sweep: give freqs, a .NOISE sweep, or a .AC "
                "card")
        out_eq = self._node_eq(out_node)
        if out_eq < 0:
            raise ValueError(f".NOISE output node {out_node!r} is ground")
        ref_eq = self._node_eq(ref_node) if ref_node else -1
        input_ref = self._input_ref(input_source) if input_source else None
        p = params if params is not None else self.params
        return noise_analysis(self.engine, p, freqs, out_eq, ref_eq,
                              input_ref, x_op=x_op)

    def noise_figure(self, source_resistor: str,
                     params: Optional[Any] = None, freqs=None,
                     out_node: Optional[str] = None,
                     ref_node: Optional[str] = None,
                     x_op: Optional[Any] = None):
        """Noise figure referred to the named source resistor: F(f) = the
        total output noise PSD over the PSD that ``source_resistor``'s 4kT/R
        generator alone contributes through the same adjoint transfer, NF =
        10 log10 F.  The output node defaults to the .NOISE card's.
        Returns (freqs, nf_db)."""
        from .analysis.noise import noise_analysis
        cfg = self.config.noise
        if out_node is None:
            if not cfg.enabled:
                raise ValueError("give out_node or a .NOISE card")
            out_node = cfg.out_node
            ref_node = ref_node or (cfg.ref_node or None)
        if freqs is None:
            freqs = self._noise_freqs("no frequency sweep available")
        # the source resistor's generator column: resistors lead the
        # concatenation in _device_noise_currents, in element order
        ridx = None
        j = 0
        for e in self.circuit.elements:
            if e.kind == KIND_R:
                if e.name.upper() == source_resistor.upper():
                    ridx = j
                    break
                j += 1
        if ridx is None:
            raise KeyError(f"no resistor named {source_resistor!r}")
        out_eq = self._node_eq(out_node)
        ref_eq = self._node_eq(ref_node) if ref_node else -1
        p = params if params is not None else self.params
        res = noise_analysis(self.engine, p, freqs, out_eq, ref_eq,
                             None, x_op=x_op, per_device=True)
        rs_psd = res.s_dev[:, ridx]
        if not np.all(rs_psd > 0):
            raise ValueError(f"{source_resistor!r} contributes no noise "
                             "at the output (zero transfer or zero R)")
        nf_db = 10.0 * np.log10(res.onoise / rs_psd)
        return np.asarray(freqs), nf_db

    def sparams(self, ports, freqs=None, params: Optional[Any] = None,
                x_op: Optional[Any] = None):
        """N-port S-parameters (analysis/sparams.py) of the circuit
        linearized at the DC operating point: the n port excitations are n
        lanes of one K3 sweep.  ``ports`` is a list of (node_p,
        node_m_or_None, z0) tuples (None = ground); ``freqs`` defaults to
        the .AC card's sweep.  Port terminations must not be in the
        netlist (matched loading is implicit)."""
        from .analysis.ac import sweep_frequencies
        from .analysis.sparams import s_parameters
        if freqs is None:
            ac = self.config.ac
            if not ac.enabled:
                raise ValueError("no frequency sweep: give freqs or a "
                                 ".AC card")
            freqs = sweep_frequencies(ac.sweep_type, ac.n_points,
                                      ac.fstart, ac.fstop)
        dump = self.topo.n_unknowns

        def node_eq(name):
            if name is None or str(name).lower() in ("0", "gnd"):
                return dump
            eqi = self._node_eq(name)
            return eqi if eqi >= 0 else dump
        port_eqs = [(node_eq(p), node_eq(m)) for (p, m, _) in ports]
        z0s = [z for (_, _, z) in ports]
        p = params if params is not None else self.params
        if x_op is None:
            x_op = self.dc(params=params)
        return s_parameters(self.engine, p, port_eqs, z0s, freqs, x_op)

    def stability(self, ports=None, freqs=None, sres=None,
                  params: Optional[Any] = None, x_op: Optional[Any] = None):
        """Two-port stability and gain metrics (analysis/sparams.py
        two_port_metrics): Rollett K, delta, Edwards-Sinsky mu/mu', MSG,
        MAG, Mason's U and the unconditional-stability verdict per
        frequency.  Pass ``ports`` (two (node_p, node_m, z0) tuples, as
        for sparams) to extract S first, or ``sres`` to reuse an
        SParamResult."""
        from .analysis.sparams import two_port_metrics
        if sres is None:
            if ports is None or len(ports) != 2:
                raise ValueError("stability needs two ports (or sres=)")
            sres = self.sparams(ports, freqs=freqs, params=params,
                                x_op=x_op)
        return two_port_metrics(sres)

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
    def write_raw(self, path: str, result, mode: str = "w",
                  title: Optional[str] = None) -> None:
        """ngspice/SPICE3 ASCII rawfile (io/rawfile.py) of a transient, AC
        or DC-sweep result; mode="a" appends a further plot to the same
        file.  The default title is the JAX package's, so both write the
        same file."""
        from .io import rawfile
        t = title if title is not None else "circuitsimulator_tpu"
        if hasattr(result, "times"):
            if bool(result.failed):
                raise RuntimeError("Transient: LU produced NaN/Inf.")
            rawfile.write_raw_transient(
                path, self.topo, _host(result.times), _host(result.xs),
                title=t, tstart=self.config.tran.tstart or 0.0, mode=mode)
        elif hasattr(result, "freqs"):
            rawfile.write_raw_ac(path, self.topo, _host(result.freqs),
                                 _host(result.xs), title=t, mode=mode)
        elif hasattr(result, "values"):
            rawfile.write_raw_dc_sweep(path, self.topo, _host(result.values),
                                       _host(result.xs), result.source,
                                       title=t, mode=mode)
        else:
            raise TypeError(f"cannot write {type(result).__name__} "
                            "as a rawfile")

    def write_transient_csv(self, path: str, result,
                            tstart: Optional[float] = None,
                            probes_only: bool = False) -> None:
        """The CSV of a TransientResult or an AdaptiveTransientResult (its
        rows: the .TRAN grid); ``probes_only`` keeps the columns the
        .PLOTNV/.PLOTNC/.PRINT cards name."""
        if tstart is None:
            tstart = self.config.tran.tstart or 0.0
        if bool(result.failed):
            raise RuntimeError("Transient: LU produced NaN/Inf.")
        selection = None
        if probes_only:
            from .io.csvout import probe_selection
            selection = probe_selection(self.topo, self.config.print_commands)
        write_transient_csv(path, self.topo, result.times.cpu().numpy(),
                            result.xs.cpu().numpy(), tstart,
                            selection=selection)

    def summary(self) -> str:
        return circuit_summary(self.topo)

    def dc_report(self, x) -> str:
        return dc_table(self.topo, torch.as_tensor(x).cpu().numpy())
