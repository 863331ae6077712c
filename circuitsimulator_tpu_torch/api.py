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
    sim.yield_analysis(0, 8192, {"mos_vth": 0.04}, {"vset": (None, 1.27)})
    sim.sobol_indices(0, 1024, {"res_r": 0.05})    # Saltelli, one batch
    form = sim.worst_case(sig, measure="vset", high=1.27)   # FORM, adjoint
    sim.mismatch_budget(sig, measure="vset"); sim.center_design(...)
    sim.calibrate(target, "out", ["res_r"]); sim.fit_measures(...)   # Adam

Above 128 node equations ``Simulator`` picks a large-circuit backend, as
the JAX package does: ``tridiag`` for a ladder (``synthetic.
rc_ladder_netlist``), else the RCM block band (``synthetic.
rc_grid_netlist``), ``blockwb`` when the Woodbury rank is at most N/16 and
``blockband`` above it.
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
from .ops.assemble import Engine
from .utils import prng
from .utils.options import DEFAULT_OPTIONS, SolverOptions
from .utils.temp import apply_is_temp, has_is_temp, thermal_params

# above this many node equations ``auto_backend`` switches to a
# structure-exploiting backend (the JAX package's threshold, api.py)
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
        self.engine = Engine(self.lowered, opts, device)
        if opts.auto_backend and self.topo.n_node_eq > MAX_DENSE_NODE_EQS:
            self._large_circuit_backend()

    def _large_circuit_backend(self):
        """Dense O(N^2) assembly and O(N^3) LU are unusable on a large
        circuit: take bordered cyclic reduction for a strict ladder, else
        the RCM block band when the topology reduces to one (grids, trees,
        meshes), pre-factored under Woodbury rows (``blockwb``) when the
        nonlinear rank is small against the network (k <= N/16: the JAX
        package's measured crossover) and re-eliminated (``blockband``)
        above it.  A circuit that fits neither keeps the dense backends."""
        from .ops.banded import is_ladder
        from .ops.blockband import try_layout
        from .ops.woodbury import WoodburyPlan
        opts = self.opts
        if is_ladder(self.engine):
            opts = opts.replace(tran_solver="tridiag", dc_solver="tridiag")
            layout = None
        else:
            layout = try_layout(self.engine)
            if layout is None:
                return
            k_wb = WoodburyPlan(self.engine).k
            opts = opts.replace(
                tran_solver=("blockwb" if k_wb <= self.topo.n_unknowns // 16
                             else "blockband"),
                dc_solver="blockband")
        self.opts = opts
        self.engine = Engine(self.lowered, opts, self.device)
        self.engine._blockband_layout = layout

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

    def dc(self, params: Optional[Any] = None,
           linear_solver: Optional[str] = None, polish: bool = False):
        """DC operating point -> (N,) solution vector.

        linear_solver: "lu" (the reference's dcSolveLU), "gs"
        (dcSolveGaussSeidel), "tridiag" (ladders) or "blockband" (grids,
        trees, meshes); defaults to the engine's ``dc_solver``.  A .NODESET
        card steers Newton toward the wanted solution branch (hold, then
        release on the last ramp step).  polish=True follows the ramped
        solve with three undamped Newton refinements at gmin = 0 (the step
        .SENS and .TF use), removing the gmin leak of the reference's
        solution: for accuracy, not for parity."""
        p = params if params is not None else self.params
        x = dc_operating_point(self.engine, p, nodeset=self._nodeset(),
                               linear_solver=linear_solver)
        if polish:
            from .analysis.sensitivity import _polish
            x = _polish(self.engine, p, x)
        return x

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
        bp = perturb_params_netlist(p, self._generator(seed), n,
                                    self.lowered.mc_tols, sampler=sampler)
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

    # ---- statistics, worst case and fitting ----
    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _measures_of(self, analysis: str):
        return [m for m in self.config.measures if m.analysis == analysis]

    def _stat_analysis(self, what: str):
        """("tran", measures, tstep, tstop, {}) for a deck with .TRAN and
        .MEASURE TRAN cards, else ("ac", measures, 0, 0, {freqs,
        bindings}) for .AC and .MEASURE AC cards."""
        tran = self.config.tran
        if tran.enabled and self._measures_of("tran"):
            return ("tran", self._measures_of("tran"), tran.tstep,
                    tran.tstop, {})
        if self.config.ac.enabled and self._measures_of("ac"):
            return ("ac", self._measures_of("ac"), 0.0, 0.0,
                    {"freqs": self._ac_freqs(),
                     "bindings": self.config.param_values})
        raise ValueError(f"{what}: the deck needs .TRAN + .MEASURE TRAN "
                         "cards or .AC + .MEASURE AC cards")

    def yield_analysis(self, seed: int, batch: int, rel_sigma, specs,
                       params: Optional[Any] = None, sampler: str = "mc",
                       sigma_scale: float = 1.0, shift=None):
        """Monte-Carlo yield (parallel/montecarlo.yield_analysis): ``batch``
        lognormal lanes of ``rel_sigma`` (relative sigmas by leaf name),
        drawn from a ``torch.Generator`` seeded with ``seed`` under
        ``sampler`` ("mc" | "lhs" | "sobol" | "antithetic"), scored
        against ``specs`` {measure: (low, high)}.  sigma_scale > 1:
        scaled-sigma importance sampling with per-lane likelihood-ratio
        weights; shift= (e.g. worst_case()'s z_star): MPP-centred IS.
        Decks with .TRAN + .MEASURE TRAN cards score on the streaming
        transient (K1 with its probe stream on a float32 CUDA run), else
        .AC + .MEASURE AC cards on the batched sweep (K3)."""
        from .parallel.montecarlo import yield_analysis
        if not self.config.measures:
            raise ValueError("yield analysis needs .MEASURE cards")
        ana, ms, t0, t1, kw = self._stat_analysis("yield analysis")
        p = params if params is not None else self.params
        return yield_analysis(self.engine, self.topo, p,
                              self._generator(seed), batch, rel_sigma, ms,
                              specs, t0, t1, sampler=sampler,
                              sigma_scale=sigma_scale, shift=shift,
                              analysis=ana, **kw)

    def sobol_indices(self, seed: int, n: int, rel_sigma,
                      params: Optional[Any] = None, sampler: str = "lhs"):
        """First-order (S1) and total-effect (ST) Sobol indices of every
        .MEASURE value over the mismatch space
        (parallel/montecarlo.sobol_indices): all (dims + 2) n Saltelli
        lanes as ONE batched solve, on the transient or the AC sweep as
        ``yield_analysis`` chooses."""
        from .parallel.montecarlo import sobol_indices
        ana, ms, t0, t1, kw = self._stat_analysis("Sobol indices")
        p = params if params is not None else self.params
        return sobol_indices(self.engine, self.topo, p,
                             self._generator(seed), n, rel_sigma, ms, t0, t1,
                             sampler=sampler, analysis=ana, **kw)

    def _measure_card(self, name: str, analysis: str):
        ms = [m for m in self._measures_of(analysis) if m.name == name]
        if not ms:
            raise KeyError(f"no .MEASURE {analysis.upper()} card named "
                           f"{name!r}")
        return ms[0]

    def _diff_measure_fn(self, name: str):
        """Differentiable fn(times, xs) of the named .MEASURE TRAN card."""
        from .analysis.measure_diff import diff_measure
        return diff_measure(self._measure_card(name, "tran"), self.topo)

    def _limit_state(self, analysis: str, g_fn=None, probe=None, at=None,
                     low=None, high=None, measure=None):
        """(g_fn, the mpp_search keywords it implies) of the worst_case and
        center_design shorthands."""
        from .analysis import form
        if g_fn is not None:
            return g_fn, {}
        if measure is not None and analysis != "dc":
            mk = (form.limit_state_measure_ac if analysis == "ac"
                  else form.limit_state_measure)
            g = mk(self._measure_card(measure, analysis), self.topo,
                   low=low, high=high)
            return g, ({"freqs": self._ac_freqs()} if analysis == "ac"
                       else {})
        if analysis == "dc":
            if probe is None:
                raise ValueError("pass g_fn or probe/low/high")
            return form.limit_state_dc(self._node_eq(probe), low=low,
                                       high=high), {}
        if probe is None or at is None:
            raise ValueError("pass g_fn, measure=, or probe/at/low/high")
        if analysis == "ac":
            return form.limit_state_ac_mag(self._node_eq(probe), low=low,
                                           high=high), {"freqs": [at]}
        return form.limit_state_find_at(self._node_eq(probe), at, low=low,
                                        high=high), {}

    def worst_case(self, rel_sigma, g_fn=None, probe: str = None,
                   at: float = None, low=None, high=None,
                   params: Optional[Any] = None, analysis: str = "tran",
                   measure: str = None, **kw):
        """FORM worst-case analysis (analysis/form.mpp_search): the most
        probable failure point in the standard-normal mismatch space of
        ``rel_sigma`` by adjoint-gradient HL-RF iterations.  Returns beta,
        the FORM p_fail = Phi(-beta), the worst-case parameters and the
        importance direction alpha.

        analysis="tran" (needs a .TRAN card): ``g_fn(times, xs)`` (g < 0 =
        failure), or ``measure=`` to bound one of the deck's .MEASURE TRAN
        cards, or probe/at/low/high for a FIND V(probe) AT=at window.
        analysis="dc": ``g_fn(x_op)`` or probe/low/high on the polished DC
        point.  analysis="ac": ``g_fn(freqs, xr, xi)`` with ``freqs=`` in
        kw, a .MEASURE AC card, or probe/at/low/high where ``at`` is the
        frequency and the bounds hold |V(probe)|."""
        from .analysis.form import mpp_search
        p = params if params is not None else self.params
        if analysis == "tran" and not self.config.tran.enabled:
            raise ValueError("worst-case analysis needs a .TRAN card")
        g_fn, implied = self._limit_state(analysis, g_fn, probe, at, low,
                                          high, measure)
        for k, v in implied.items():
            kw.setdefault(k, v)
        tran = self.config.tran
        ts = (tran.tstep, tran.tstop) if analysis == "tran" else (0.0, 0.0)
        return mpp_search(self.engine, p, rel_sigma, *ts, g_fn,
                          analysis=analysis, **kw)

    def mismatch_budget(self, rel_sigma, m_fn=None, probe: str = None,
                        at: float = None, params: Optional[Any] = None,
                        analysis: str = "tran", measure: str = None):
        """Linearised mismatch variance budget (analysis/form.
        mismatch_budget): one adjoint pass ranks every mismatch dimension's
        share of the metric's variance.  ``m_fn(times, xs)``, ``measure=``
        (a .MEASURE card of the analysis), or probe/at: V(probe) at time
        ``at`` (.TRAN), |V(probe)| at the frequency ``at`` (analysis="ac";
        an m_fn or a measure there runs over the .AC card's sweep), or
        V(probe) at the DC point (analysis="dc")."""
        from .analysis.form import mismatch_budget
        from .analysis.measure_diff import diff_measure_ac, interp
        p = params if params is not None else self.params
        freqs = None
        if measure is not None and m_fn is None:
            m_fn = (diff_measure_ac(self._measure_card(measure, "ac"),
                                    self.topo) if analysis == "ac"
                    else self._diff_measure_fn(measure))
        if analysis == "ac":
            freqs = self._ac_freqs() if m_fn is not None else [at]
            if m_fn is None:
                if probe is None or at is None:
                    raise ValueError("pass m_fn or probe/at")
                eqi = self._node_eq(probe)

                def m_fn(freqs, xr, xi):
                    return torch.sqrt(xr[0, eqi] ** 2 + xi[0, eqi] ** 2)
            return mismatch_budget(self.engine, p, rel_sigma, 0.0, 0.0,
                                   m_fn, analysis="ac", freqs=freqs)
        if analysis == "dc":
            if m_fn is None:
                if probe is None:
                    raise ValueError("pass m_fn or probe")
                eqi = self._node_eq(probe)
                m_fn = lambda x_op: x_op[eqi]                # noqa: E731
            return mismatch_budget(self.engine, p, rel_sigma, 0.0, 0.0,
                                   m_fn, analysis="dc")
        tran = self.config.tran
        if not tran.enabled:
            raise ValueError("mismatch budget needs a .TRAN card")
        if m_fn is None:
            if probe is None or at is None:
                raise ValueError("pass m_fn or probe/at")
            eqi = self._node_eq(probe)

            def m_fn(times, xs):
                return interp(at, times, xs[:, eqi])
        return mismatch_budget(self.engine, p, rel_sigma, tran.tstep,
                               tran.tstop, m_fn)

    def center_design(self, rel_sigma, specs, design_names,
                      target_beta: float = 4.0, steps: int = 15,
                      lr: float = 0.1, params: Optional[Any] = None,
                      verbose: bool = False):
        """Yield-driven design centering: move the named design leaves until
        every spec's FORM reliability index reaches target_beta.  specs:
        dicts {probe, at, low?, high?} (the worst_case shorthand),
        {measure: name} or {g_fn}, each with an optional analysis
        ("tran" default, "dc", "ac"; an AC spec's ``at`` is the frequency,
        or it gives ``freqs``).  Each iteration runs a FORM search per
        spec with design_grads and steps the WORST spec's beta up in log
        space along p dbeta/dp (a fixed relative step lr).  Returns
        (centered params, history rows {betas, worst, step})."""
        from .analysis.form import mpp_search
        tran = self.config.tran
        entries = []
        for sp in specs:
            ana = sp.get("analysis", "tran")
            kwargs = {"analysis": ana}
            if ana == "ac":
                kwargs["freqs"] = sp.get(
                    "freqs", [sp["at"]] if "at" in sp else self._ac_freqs())
            g, _ = self._limit_state(ana, sp.get("g_fn"), sp.get("probe"),
                                     sp.get("at"), sp.get("low"),
                                     sp.get("high"), sp.get("measure"))
            entries.append((g, kwargs))
        if any(kw["analysis"] == "tran" for _, kw in entries) \
                and not tran.enabled:
            raise ValueError("transient specs need a .TRAN card")
        ts = (tran.tstep, tran.tstop) if tran.enabled else (0.0, 0.0)
        p = dict(params if params is not None else self.params)
        history = []
        for it in range(steps):
            results = [mpp_search(self.engine, p, rel_sigma, *ts, g,
                                  design_grads=design_names, **kw)
                       for g, kw in entries]
            betas = [r["beta"] for r in results]
            worst = int(np.argmin(betas))
            history.append({"betas": betas, "worst": worst, "step": it})
            if verbose:
                print(f"  center step {it}: betas "
                      f"{['%.2f' % b for b in betas]}")
            if betas[worst] >= target_beta:
                break
            db = results[worst]["dbeta"]
            d = {k: p[k] * db[k] for k in design_names}
            norm = float(torch.sqrt(sum((v ** 2).sum() for v in d.values())))
            if norm == 0.0:
                break
            for k in design_names:
                p[k] = p[k] * torch.exp(lr * d[k] / norm)
        return p, history

    def _fit(self, loss_of, param_names, steps, lr, params, verbose, what):
        """Adam (torch.optim.Adam: optax.adam's defaults) on the logs of the
        named leaves; loss_of(times, xs) of the differentiable transient.
        Returns (fitted params, loss history)."""
        from .analysis.adjoint import diff_transient
        tran = self.config.tran
        p0 = dict(params if params is not None else self.params)
        for k in param_names:
            if k not in p0:
                raise KeyError(f"unknown parameter leaf {k!r}")
        theta = {k: torch.log(p0[k]).detach().clone().requires_grad_()
                 for k in param_names}
        rest = {k: v for k, v in p0.items() if k not in param_names}
        opt = torch.optim.Adam(list(theta.values()), lr=lr)
        history = []
        for i in range(steps):
            opt.zero_grad()
            p = {**rest, **{k: torch.exp(v) for k, v in theta.items()}}
            loss = loss_of(*diff_transient(self.engine, p, tran.tstep,
                                           tran.tstop))
            loss.backward()
            history.append(float(loss.detach()))
            opt.step()
            if verbose and i % 20 == 0:
                print(f"  {what} step {i}: loss {history[-1]:.3e}")
        return ({**rest, **{k: torch.exp(v).detach()
                            for k, v in theta.items()}}, history)

    def calibrate(self, target, probe: str, param_names,
                  steps: int = 200, lr: float = 0.05,
                  params: Optional[Any] = None, verbose: bool = False):
        """Fit the named parameter leaves so V(probe)'s transient waveform
        matches ``target`` ((n_steps + 1,) on the .TRAN grid): the mean
        squared error through the reverse-mode adjoint, Adam in log space
        (positivity kept).  Returns (fitted params, loss history); each
        step is one forward transient and one adjoint sweep."""
        if not self.config.tran.enabled:
            raise ValueError("calibration needs a .TRAN card")
        eqi = self._node_eq(probe)
        tgt = torch.as_tensor(_host(target), dtype=self.opts.dtype,
                              device=self.device)
        return self._fit(lambda t, xs: ((xs[:, eqi] - tgt) ** 2).mean(),
                         param_names, steps, lr, params, verbose,
                         "calibrate")

    def fit_measures(self, targets, param_names, steps: int = 150,
                     lr: float = 0.05, params: Optional[Any] = None,
                     verbose: bool = False):
        """Fit the named leaves until each of the deck's .MEASURE TRAN
        values hits its target (``targets`` {measure: value}): the sum of
        squared relative errors through the adjoint and the differentiable
        measure layer, Adam in log space.  Returns (fitted params, loss
        history)."""
        if not self.config.tran.enabled:
            raise ValueError("fit_measures needs a .TRAN card")
        fns = {k: self._diff_measure_fn(k) for k in targets}
        tv = {k: torch.as_tensor(v, dtype=self.opts.dtype,
                                 device=self.device)
              for k, v in targets.items()}

        def loss(t, xs):
            err = 0.0
            for k, f in fns.items():
                scale = torch.clamp_min(tv[k].abs(), 1e-30)
                err = err + ((f(t, xs) - tv[k]) / scale) ** 2
            return err

        return self._fit(loss, param_names, steps, lr, params, verbose,
                         "fit")

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
