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
    pss = sim.steady_state()          # .hb card, Newton shooting (K2)
    hb = sim.harmonic_balance(solver="gmres")   # spectral Newton(-Krylov)
    sim.two_tone_ip3("out", 0.01); sim.p1db("out", "Vin")   # MPDE / HB
    bp, hbs = sim.monte_carlo_hb(64)  # lanes of one batched HB
    env = sim.envelope(5e-6, 1e-7, order=2)  # envelope transient
    sim.pac([1e5]); sim.pxf([1e5], "if"); sim.pnoise([1e5], "if")   # LPTV
    sim.mixer_noise_figure("Rs", 1e5, "if"); sim.envelope_noise(...)
    sim.hot_sparams(ports, [1e5]); sim.lssp(thevenin_ports, 1e-3)
    bp, pn = sim.monte_carlo_pnoise(64, [1e5], "if")   # batched LPTV solves

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

    # ---- periodic steady state and RF ----
    def _hb_f0(self, f0, what: str = ".hb card missing or invalid (f0 must "
                                     "be > 0)"):
        hb = self.config.hb
        f0 = f0 if f0 is not None else (hb.f0 if hb.enabled else None)
        if not f0 or f0 <= 0:
            raise ValueError(what)
        return f0

    def _hb_lanes(self, n: int, seed: int, sampler: str, params=None):
        """n lanes of the netlist's DEV=/LOT= tolerances."""
        from .parallel.montecarlo import perturb_params_netlist
        if not self.lowered.mc_tols:
            raise ValueError("no DEV=/LOT= tolerances in the netlist")
        p = params if params is not None else self.params
        return perturb_params_netlist(p, self._generator(seed), n,
                                      self.lowered.mc_tols, sampler=sampler)

    def _two_tones(self, tones, what: str):
        hb = self.config.hb
        if tones is None:
            if not (hb.enabled and hb.extra_tones):
                raise ValueError(f"{what} needs a multi-tone .hb card or "
                                 "tones=[(f1,H1),(f2,H2)]")
            tones = hb.tones
        if len(tones) != 2:
            raise ValueError(f"{what} needs exactly two tones")
        if tones[0][1] < 2 or tones[1][1] < 1:
            raise ValueError("IM3 (2,-1) needs H1 >= 2 and H2 >= 1")
        return tones

    def steady_state(self, params: Optional[Any] = None,
                     f0: Optional[float] = None,
                     n_harm: Optional[int] = None, **kw):
        """Periodic steady state (.hb card) by Newton shooting
        (analysis/sstate.py).  Defaults to the netlist's .hb card."""
        from .analysis.sstate import steady_state
        f0 = self._hb_f0(f0)
        n_harm = n_harm if n_harm is not None else (self.config.hb.n_harm
                                                    or 8)
        p = params if params is not None else self.params
        return steady_state(self.engine, p, f0, n_harm=n_harm, **kw)

    def harmonic_balance(self, params: Optional[Any] = None,
                         f0: Optional[float] = None,
                         n_harm: Optional[int] = None,
                         tones=None, **kw):
        """Frequency-domain periodic steady state (analysis/hb.py).
        Defaults to the netlist's .hb card; with several tones
        (``tones=[(f, H), ...]`` or a multi-tone ``.hb f0 n0 f1 n1 ...``
        card) the quasi-periodic MPDE grid (analysis/hbmulti.py)."""
        from .analysis.hb import harmonic_balance
        hb = self.config.hb
        p = params if params is not None else self.params
        if tones is None and f0 is None and hb.enabled and hb.extra_tones:
            tones = hb.tones
        if tones is not None:
            from .analysis.hbmulti import harmonic_balance_multi
            return harmonic_balance_multi(self.engine, p, tones, **kw)
        f0 = self._hb_f0(f0)
        n_harm = n_harm if n_harm is not None else (hb.n_harm or 8)
        return harmonic_balance(self.engine, p, f0, n_harm=n_harm, **kw)

    def monte_carlo_hb(self, n: int, seed: int = 0, sampler: str = "mc",
                       params: Optional[Any] = None,
                       f0: Optional[float] = None,
                       n_harm: Optional[int] = None, **kw):
        """RF Monte Carlo: n lanes of the netlist's DEV=/LOT= tolerances
        (drawn from a ``torch.Generator`` seeded with ``seed``) of the .hb
        periodic steady state as one batched HB.  Returns (bparams,
        HBBatchResult); per-lane spectra in result.spectrum[lane]."""
        from .analysis.hb import harmonic_balance_batched
        bp = self._hb_lanes(n, seed, sampler, params)
        f0 = self._hb_f0(f0)
        n_harm = n_harm if n_harm is not None else (self.config.hb.n_harm
                                                    or 8)
        return bp, harmonic_balance_batched(self.engine, bp, f0,
                                            n_harm=n_harm, **kw)

    def two_tone_ip3(self, probe: str, input_amplitude: float,
                     params: Optional[Any] = None, tones=None, **kw):
        """Two-tone intermodulation on the multi-tone HB: the fundamental
        (1, 0) and the lower IM3 (2, -1) of V(probe) and the third-order
        intercept referred to the per-tone drive amplitude A,
        IIP3 = A sqrt(fund / im3).  Returns a dict: fund, im3 (voltage
        magnitudes), im3_dbc, iip3_amplitude, oip3_amplitude, result."""
        from .analysis.hbmulti import coeff
        tones = self._two_tones(tones, "two_tone_ip3")
        res = self.harmonic_balance(params=params, tones=tones, **kw)
        eqi = self._node_eq(probe)
        fund = 2.0 * float(coeff(res, (1, 0))[eqi].abs())
        im3 = 2.0 * float(coeff(res, (2, -1))[eqi].abs())
        a = float(input_amplitude)
        ratio = fund / max(im3, 1e-300)
        return {"fund": fund, "im3": im3,
                "im3_dbc": 20.0 * np.log10(max(im3, 1e-300) / fund),
                "iip3_amplitude": a * np.sqrt(ratio),
                "oip3_amplitude": fund * np.sqrt(ratio), "result": res}

    def monte_carlo_ip3(self, n: int, probe: str, input_amplitude: float,
                        seed: int = 0, sampler: str = "mc",
                        params: Optional[Any] = None, tones=None, **kw):
        """Monte-Carlo two-tone IP3: n lanes of the multi-tone HB
        (analysis/hbmulti.harmonic_balance_multi_batched), each lane's
        (1, 0) and (2, -1) read per lane.  Returns (bparams, dict) with
        (n,) arrays fund, im3, im3_dbc, iip3_amplitude, oip3_amplitude,
        converged and the HBMultiBatchResult under "result"."""
        from .analysis.hbmulti import (coeff_batched,
                                       harmonic_balance_multi_batched)
        bp = self._hb_lanes(n, seed, sampler, params)
        tones = self._two_tones(tones, "monte_carlo_ip3")
        eqi = self._node_eq(probe)
        res = harmonic_balance_multi_batched(self.engine, bp, tones, **kw)
        fund = 2.0 * _host(coeff_batched(res, (1, 0))[:, eqi].abs())
        im3 = 2.0 * _host(coeff_batched(res, (2, -1))[:, eqi].abs())
        a = float(input_amplitude)
        ratio = fund / np.maximum(im3, 1e-300)
        return bp, {
            "fund": fund, "im3": im3,
            "im3_dbc": 20.0 * np.log10(np.maximum(im3, 1e-300) / fund),
            "iip3_amplitude": a * np.sqrt(ratio),
            "oip3_amplitude": fund * np.sqrt(ratio),
            "converged": _host(res.converged), "result": res}

    def p1db(self, probe: str, source: str, params: Optional[Any] = None,
             f0: Optional[float] = None, n_harm: int = 7,
             a_max_scale: float = 100.0, iters: int = 20, **kw):
        """1 dB compression point: bisect the named SIN source's amplitude
        until the fundamental gain of V(probe) (single-tone HB) is 1 dB
        below its small-signal value.  Returns a dict: a_1db, gain_ss,
        gain_1db, n_solves."""
        import math
        from .analysis.hb import harmonic_balance
        from .analysis.sweep import find_source
        f0 = self._hb_f0(f0, "p1db needs f0 (or a .hb card)")
        kind, sidx = find_source(self.circuit, source)
        if kind != KIND_V:
            raise ValueError("p1db sweeps a V source's SIN amplitude")
        p0 = dict(params if params is not None else self.params)
        a0 = float(p0["vs_sin"][sidx, 1])
        if a0 <= 0:
            raise ValueError(f"{source!r} has no SIN amplitude")
        eqi = self._node_eq(probe)
        n_solves = 0

        def gain_at(a):
            nonlocal n_solves
            p = dict(p0)
            p["vs_sin"] = p0["vs_sin"].clone()
            p["vs_sin"][sidx, 1] = a
            res = harmonic_balance(self.engine, p, f0, n_harm=n_harm, **kw)
            n_solves += 1
            # the one-sided spectrum: |c_1| is the cosine amplitude
            return float(res.spectrum[1][eqi].abs()) / a

        g_ss = gain_at(a0 / a_max_scale)      # deep small-signal
        target = g_ss * 10.0 ** (-1.0 / 20.0)
        # walk up in half-octave steps to the first sub-target gain (|gain|
        # is not monotone past a strong-compression null), then bisect
        lo = a0 / a_max_scale
        hi = None
        a = lo * math.sqrt(2.0)
        while a <= a0 * a_max_scale:
            if gain_at(a) <= target:
                hi = a
                break
            lo = a
            a *= math.sqrt(2.0)
        if hi is None:
            raise ValueError("no 1 dB compression within the sweep "
                             "range; widen a_max_scale")
        for _ in range(iters):
            mid = math.sqrt(lo * hi)
            if gain_at(mid) > target:
                lo = mid
            else:
                hi = mid
        a_1db = math.sqrt(lo * hi)
        return {"a_1db": a_1db, "gain_ss": g_ss,
                "gain_1db": gain_at(a_1db), "n_solves": n_solves}

    def envelope(self, t_stop: float, dt_env: float,
                 f0: Optional[float] = None, n_harm: int = 7,
                 params: Optional[Any] = None, **kw):
        """Envelope-following transient (analysis/envelope.py): the
        harmonic envelopes at the carrier f0 stepped on the slow axis; SIN
        sources at >= f0/2 ride the fast axis, every other waveform and
        every DC term the envelope.  Returns an EnvelopeResult."""
        from .analysis.envelope import envelope_transient
        f0 = self._hb_f0(f0, "envelope needs f0 (or a .hb card)")
        p = params if params is not None else self.params
        return envelope_transient(self.engine, p, f0, t_stop, dt_env,
                                  n_harm=n_harm, **kw)

    def monte_carlo_envelope(self, n: int, t_stop: float, dt_env: float,
                             seed: int = 0, sampler: str = "mc",
                             f0: Optional[float] = None,
                             n_harm: int = 7, **kw):
        """Monte-Carlo envelope transient: n lanes of the netlist's
        DEV=/LOT= tolerances of the whole two-timescale run as one batch
        (analysis/envelope.envelope_transient_batched).  Returns (bparams,
        EnvelopeBatchResult)."""
        from .analysis.envelope import envelope_transient_batched
        bp = self._hb_lanes(n, seed, sampler)
        f0 = self._hb_f0(f0, "monte_carlo_envelope needs f0 (or a .hb "
                             "card)")
        return bp, envelope_transient_batched(self.engine, bp, f0, t_stop,
                                              dt_env, n_harm=n_harm, **kw)

    # ---- oscillators ----
    def _anchor_eq(self, anchor_node: str, what: str = "anchor node is "
                                                        "ground") -> int:
        eq = self._node_eq(anchor_node)
        if eq < 0:
            raise ValueError(what)
        return eq

    def _pair_eq(self, name) -> int:
        """A node's equation, -1 for None and ground names."""
        from .utils.numbers import is_ground_name
        if name is None or is_ground_name(name):
            return -1
        return self._node_eq(name)

    def oscillator(self, f0_guess: float, anchor_node: str,
                   params: Optional[Any] = None, **kw):
        """Autonomous-oscillator periodic steady state
        (analysis/sstate.oscillator_steady_state): shooting with the period
        a Newton unknown and a phase anchor on ``anchor_node``.  Returns an
        OscillatorResult with the solved f0."""
        from .analysis.sstate import oscillator_steady_state
        eq = self._anchor_eq(anchor_node)
        p = params if params is not None else self.params
        return oscillator_steady_state(self.engine, p, f0_guess, eq, **kw)

    def oscillator_hb(self, f0_guess: float, anchor_node: str,
                      params: Optional[Any] = None, **kw):
        """Autonomous harmonic balance (analysis/hbosc.oscillator_hb): the
        frequency-domain twin of ``oscillator``, f0 a Newton unknown and a
        spectral phase anchor on ``anchor_node``; the oscillator path of
        transmission-line decks.  Returns an HBOscResult."""
        from .analysis.hbosc import oscillator_hb
        eq = self._anchor_eq(anchor_node)
        p = params if params is not None else self.params
        return oscillator_hb(self.engine, p, f0_guess, eq, **kw)

    def _solved_osc(self, osc, f0_guess, anchor_node, p, hb: bool, what,
                    **osc_kw):
        """``osc`` or a new converged solve (shooting or HB)."""
        if osc is not None:
            return osc
        if f0_guess is None or anchor_node is None:
            raise ValueError("give osc= or f0_guess + anchor_node")
        osc = (self.oscillator_hb if hb else self.oscillator)(
            f0_guess, anchor_node, params=p, **osc_kw)
        if not osc.converged:
            raise RuntimeError(f"{what} did not converge "
                               f"(residual {float(osc.residual):.3e})")
        return osc

    def oscillator_phase_noise_hb(self, offsets, f0_guess: Optional[float]
                                  = None, anchor_node: Optional[str] = None,
                                  osc=None, params: Optional[Any] = None,
                                  extra_pairs=None, extra_psd=None,
                                  **osc_kw):
        """Phase noise by the HB PPV (analysis/hbosc.oscillator_phase_
        noise_hb), the phase-noise path of T-line oscillators; pass a
        converged ``osc`` (HBOscResult) or f0_guess + anchor_node."""
        from .analysis.hbosc import oscillator_phase_noise_hb
        p = params if params is not None else self.params
        osc = self._solved_osc(osc, f0_guess, anchor_node, p, True,
                               "autonomous HB", **osc_kw)
        return oscillator_phase_noise_hb(self.engine, p, osc, offsets,
                                         extra_pairs=extra_pairs,
                                         extra_psd=extra_psd)

    def oscillator_phase_noise(self, offsets, f0_guess: Optional[float]
                               = None, anchor_node: Optional[str] = None,
                               osc=None, params: Optional[Any] = None,
                               extra_sources=None, **osc_kw):
        """Phase noise of a free-running oscillator by the perturbation
        projection vector (analysis/oscnoise.py): Demir's phase-diffusion
        constant from the Floquet adjoint of the shooting limit cycle and
        the .NOISE catalog along it.  Pass a converged ``osc`` or f0_guess
        + anchor_node; extra_sources: (node_p, node_m, psd) with node
        names ('0' ground) and one-sided PSDs in A^2/Hz."""
        from .analysis.oscnoise import oscillator_phase_noise
        p = params if params is not None else self.params
        osc = self._solved_osc(osc, f0_guess, anchor_node, p, False,
                               "oscillator shooting", **osc_kw)
        extra_pairs = extra_psd = None
        if extra_sources:
            extra_pairs = [(self._pair_eq(a), self._pair_eq(b))
                           for a, b, _ in extra_sources]
            extra_psd = [s for _, _, s in extra_sources]
        return oscillator_phase_noise(self.engine, p, osc, offsets,
                                      extra_pairs=extra_pairs,
                                      extra_psd=extra_psd)

    def monte_carlo_oscillator_phase_noise(self, n: int, offsets,
                                           f0_guess: float,
                                           anchor_node: str,
                                           seed: int = 0,
                                           sampler: str = "mc",
                                           n_harm: int = 9, **kw):
        """Monte-Carlo oscillator phase noise: n lanes of the netlist's
        DEV=/LOT= tolerances (drawn from a ``torch.Generator`` seeded with
        ``seed``) each solve their own autonomous-HB limit cycle and
        fundamental in one batch (analysis/hbosc.oscillator_hb_batched),
        then every lane's PPV, phase-diffusion constant, L(df) and period
        jitter in a second (inverse-iteration null vectors).  Returns
        (bparams, HBOscBatchResult)."""
        from .analysis.hbosc import (oscillator_hb_batched,
                                     oscillator_phase_noise_hb_batched)
        if not self.lowered.mc_tols:
            raise ValueError("no DEV=/LOT= tolerances in the netlist")
        anchor_eq = self._anchor_eq(anchor_node, f"anchor node "
                                                 f"{anchor_node!r} is ground")
        bp = self._hb_lanes(n, seed, sampler)
        osc = oscillator_hb_batched(self.engine, bp, f0_guess, anchor_eq,
                                    n_harm=n_harm, **kw)
        return bp, oscillator_phase_noise_hb_batched(self.engine, bp, osc,
                                                     offsets)

    def pss_stability(self, ss=None, f0: Optional[float] = None,
                      params: Optional[Any] = None, **kw):
        """Floquet stability of a driven periodic steady state
        (analysis/oscnoise.pss_floquet): the monodromy multipliers of the
        shooting solution; all |lambda| < 1 is an attractor, |lambda| > 1 a
        repellor.  Pass ss= from steady_state() or let this run it (a .hb
        card or f0)."""
        from .analysis.oscnoise import pss_floquet
        p = params if params is not None else self.params
        if ss is None:
            ss = self.steady_state(params=p, f0=f0, **kw)
            if not bool(ss.converged):
                raise RuntimeError("steady state did not converge "
                                   f"(residual {float(ss.residual):.3e})")
        return pss_floquet(self.engine, p, ss, f0=f0)

    def injection_lock(self, inj_node: str, amp: float,
                       ref_node: Optional[str] = None,
                       f0_guess: Optional[float] = None,
                       anchor_node: Optional[str] = None,
                       osc=None, harmonic: int = 1,
                       method: str = "auto",
                       params: Optional[Any] = None, **osc_kw):
        """Adler injection-locking range from the oscillator PPV: a current
        amp cos(2 pi f_inj t) into inj_node[, ref_node] locks for |f_inj -
        m f0| <= lock_range_hz.  Pass a converged ``osc`` (its type picks
        the path) or f0_guess + anchor_node; method="auto" takes
        autonomous HB on T-line decks and shooting otherwise."""
        from .analysis.hbosc import HBOscResult, injection_lock_hb
        from .analysis.oscnoise import injection_lock
        p = params if params is not None else self.params
        if method not in ("auto", "shooting", "hb"):
            raise ValueError("method must be auto/shooting/hb")
        use_hb = method == "hb" or (method == "auto" and self.engine.n_tl > 0)
        osc = self._solved_osc(osc, f0_guess, anchor_node, p, use_hb,
                               "oscillator solve", **osc_kw)
        pair = (self._pair_eq(inj_node), self._pair_eq(ref_node))
        if isinstance(osc, HBOscResult):
            return injection_lock_hb(self.engine, p, osc, pair, amp,
                                     harmonic=harmonic)
        return injection_lock(self.engine, p, osc, pair, amp,
                              harmonic=harmonic)

    def subharmonic_lock(self, inj_node: str, amp: float, m: int = 2,
                         ref_node: Optional[str] = None,
                         f0_guess: Optional[float] = None,
                         anchor_node: Optional[str] = None,
                         osc=None, params: Optional[Any] = None, **kw):
        """Subharmonic injection-locking range (f_osc = m f_inj, injection
        near f0/m) by the driven-HB fold search (analysis/hbosc.
        subharmonic_lock_hb).  Pass a converged HBOscResult as osc= or
        f0_guess + anchor_node.  Returns a SubharmonicLockResult."""
        from .analysis.hbosc import HBOscResult, subharmonic_lock_hb
        p = params if params is not None else self.params
        osc_kw = {k: kw.pop(k) for k in list(kw)
                  if k in ("n_harm", "warmup_periods", "steps_per_period",
                           "max_newton", "tol", "damping", "kick", "gmin")}
        osc = self._solved_osc(osc, f0_guess, anchor_node, p, True,
                               "autonomous HB", **osc_kw)
        if not isinstance(osc, HBOscResult):
            raise TypeError("subharmonic_lock needs an HBOscResult "
                            "(use oscillator_hb)")
        pair = (self._pair_eq(inj_node), self._pair_eq(ref_node))
        probe = kw.pop("probe_node", None)
        if probe is None:
            probe = pair[0] if pair[0] >= 0 else 0
        return subharmonic_lock_hb(self.engine, p, osc, pair, amp, m=m,
                                   probe_node=probe, **kw)

    def jitter(self, probe: str, threshold: float, n: int = 64,
               seed: int = 0, rising: bool = True, t_min: float = 0.0,
               hysteresis: float = 0.0, params: Optional[Any] = None):
        """Timing jitter of a probe's threshold crossings over n TRNOISE
        realisations (analysis/jitter.py): one batched noisy transient,
        per-edge absolute jitter and period jitter; ``hysteresis`` sets a
        Schmitt release band.  Needs .TRAN and a TRNOISE source; the lanes'
        noise comes from ``prng.key(seed)`` as the JAX package's from
        ``jax.random.key(seed)``."""
        from .analysis.jitter import jitter_analysis
        tran = self.config.tran
        if not tran.enabled:
            raise ValueError("jitter analysis needs a .TRAN card")
        eqi = self._node_eq(probe)
        return jitter_analysis(
            self.engine, params if params is not None else self.params,
            tran.tstep, tran.tstop, eqi, threshold,
            prng.key(seed, self.device), n_lanes=n, rising=rising,
            t_min=t_min, hysteresis=hysteresis)

    # ---- periodic small-signal analyses (PAC family) ----
    def _pss_samples(self, p, f0, n_harm, **hb_kw):
        """Converged single-tone HB samples for the LPTV analyses: an
        unconverged PSS would give plausible-looking wrong gains and
        noise, so it raises."""
        if self.config.hb.extra_tones:
            print("warning: multi-tone .hb card — PAC/PNOISE linearize "
                  "around the single-tone PSS at f0 only", file=sys.stderr)
        hbres = self.harmonic_balance(params=p, f0=f0, n_harm=n_harm,
                                      **hb_kw)
        if not bool(hbres.converged):
            raise RuntimeError(
                "periodic steady state did not converge (residual "
                f"{float(hbres.residual):.3e}); pass pss_xs= from a solver "
                "run you trust, or raise n_harm/warmup_periods")
        return hbres.xs

    def _out_ref(self, out_node: str, ref_node: Optional[str],
                 ground_ok: bool = False):
        """(out_eq, ref_eq) of V(out[, ref]); ref -1 is ground."""
        out_eq = self._node_eq(out_node)
        if out_eq < 0 and not ground_ok:
            raise ValueError(f"output node {out_node!r} is ground")
        return out_eq, (self._node_eq(ref_node) if ref_node else -1)

    def _port_eqs(self, ports):
        """(port_eqs, z0s) of (node_p, node_m_or_None, z0) ports, ground
        the dump slot."""
        dump = self.topo.n_unknowns

        def node_eq(name):
            if name is None or str(name).lower() in ("0", "gnd"):
                return dump
            eqi = self._node_eq(name)
            return eqi if eqi >= 0 else dump
        return ([(node_eq(p), node_eq(m)) for (p, m, _) in ports],
                [z for (_, _, z) in ports])

    def _resistor_column(self, source_resistor: str) -> int:
        """The named resistor's generator column: resistors lead the
        concatenation of noise._device_noise_currents, in element order."""
        j = 0
        for e in self.circuit.elements:
            if e.kind == KIND_R:
                if e.name.upper() == source_resistor.upper():
                    return j
                j += 1
        raise KeyError(f"no resistor named {source_resistor!r}")

    def _source_names(self, res):
        from .netlist import KIND_I
        res.v_names = tuple(e.name for e in self.circuit.elements
                            if e.kind == KIND_V)
        res.i_names = tuple(e.name for e in self.circuit.elements
                            if e.kind == KIND_I)
        return res

    def _mc_pss(self, n, seed, sampler, f0, n_harm, what, **hb_kw):
        """(bparams, HBBatchResult): n lanes of the DEV=/LOT= tolerances
        and their batched-HB steady states."""
        from .analysis.hb import harmonic_balance_batched
        bp = self._hb_lanes(n, seed, sampler)
        f0 = self._hb_f0(f0, f"{what} needs f0 (or a .hb card)")
        n_harm = n_harm if n_harm is not None else (self.config.hb.n_harm
                                                    or 8)
        return bp, f0, harmonic_balance_batched(self.engine, bp, f0,
                                                n_harm=n_harm, **hb_kw)

    def pac(self, deltas, f0: Optional[float] = None,
            n_harm: Optional[int] = None,
            n_sidebands: Optional[int] = None,
            pss_xs=None, params: Optional[Any] = None, **hb_kw):
        """Periodic AC (analysis/pac.py): conversion gains from the
        sources' AC specs to every sideband m*f0 + delta around the
        periodic steady state (the .hb card's HB unless pss_xs (K, N)
        gives one)."""
        from .analysis.pac import pac
        f0 = self._hb_f0(f0, "pac needs f0 (or a .hb card)")
        p = params if params is not None else self.params
        if pss_xs is None:
            pss_xs = self._pss_samples(p, f0, n_harm, **hb_kw)
        return pac(self.engine, p, f0, pss_xs, deltas,
                   n_sidebands=n_sidebands)

    def pxf(self, deltas, out_node: str, ref_node: Optional[str] = None,
            f0: Optional[float] = None, n_harm: Optional[int] = None,
            n_sidebands: Optional[int] = None,
            pss_xs=None, params: Optional[Any] = None, **hb_kw):
        """Periodic transfer functions (analysis/pac.py pxf), the adjoint
        of PAC: one adjoint solve per offset gives the transfer from every
        V/I source, injected at every sideband m*f0 + delta, to V(out[,
        ref]) read at delta."""
        from .analysis.pac import pxf
        f0 = self._hb_f0(f0, "pxf needs f0 (or a .hb card)")
        p = params if params is not None else self.params
        out_eq, ref_eq = self._out_ref(out_node, ref_node)
        if pss_xs is None:
            pss_xs = self._pss_samples(p, f0, n_harm, **hb_kw)
        return self._source_names(pxf(self.engine, p, f0, pss_xs, deltas,
                                      out_eq, ref_eq,
                                      n_sidebands=n_sidebands))

    def pnoise(self, deltas, out_node: str, ref_node: Optional[str] = None,
               f0: Optional[float] = None, n_harm: Optional[int] = None,
               pss_xs=None, params: Optional[Any] = None, **hb_kw):
        """Periodic (cyclostationary) noise at V(out[, ref]) around the
        periodic steady state (analysis/pac.py pnoise): the time-averaged
        output PSD with sideband folding; shot noise follows the
        instantaneous operating point."""
        from .analysis.pac import pnoise
        f0 = self._hb_f0(f0, "pnoise needs f0 (or a .hb card)")
        p = params if params is not None else self.params
        out_eq, ref_eq = self._out_ref(out_node, ref_node)
        if pss_xs is None:
            pss_xs = self._pss_samples(p, f0, n_harm, **hb_kw)
        return pnoise(self.engine, p, f0, pss_xs, deltas, out_eq, ref_eq)

    def envelope_noise(self, deltas, out_node: str,
                       t_stop: Optional[float] = None,
                       dt_env: Optional[float] = None,
                       ref_node: Optional[str] = None,
                       f0: Optional[float] = None, n_harm: int = 7,
                       t1_idx=None, env=None,
                       params: Optional[Any] = None, **env_kw):
        """Time-resolved envelope noise (analysis/envnoise.py): pnoise's
        adjoint LPTV solve rebuilt at each selected envelope time t1, the
        device noise intensities tracking the envelope.  Pass an
        EnvelopeResult as env, or t_stop and dt_env to run the envelope
        here.  Returns an EnvelopeNoiseResult with onoise (T1s, F)."""
        from .analysis.envnoise import envelope_noise
        f0 = self._hb_f0(f0, "envelope_noise needs f0 (or a .hb card)")
        p = params if params is not None else self.params
        out_eq, ref_eq = self._out_ref(out_node, ref_node)
        if env is None:
            if t_stop is None or dt_env is None:
                raise ValueError("envelope_noise needs an EnvelopeResult "
                                 "(env=...) or t_stop and dt_env")
            env = self.envelope(t_stop, dt_env, f0=f0, n_harm=n_harm,
                                params=p, **env_kw)
        return envelope_noise(self.engine, p, env, deltas, out_eq, ref_eq,
                              t1_idx=t1_idx)

    def mixer_noise_figure(self, source_resistor: str, delta: float,
                           out_node: str, ref_node: Optional[str] = None,
                           sidebands=(1,),
                           f0: Optional[float] = None,
                           n_harm: Optional[int] = None,
                           pss_xs=None, params: Optional[Any] = None,
                           **hb_kw):
        """Conversion (mixer) noise figure at IF = delta referred to
        source_resistor (analysis/pac.py mixer_noise_figure): the folded
        periodic output noise over the source resistor's share through the
        signal sideband(s); SSB by default (sidebands=(1,): input at f0 +
        delta), DSB with (1, -1).  Returns NF in dB."""
        from .analysis.pac import mixer_noise_figure
        f0 = self._hb_f0(f0, "mixer_noise_figure needs f0 (or a .hb card)")
        p = params if params is not None else self.params
        ridx = self._resistor_column(source_resistor)
        out_eq, ref_eq = self._out_ref(out_node, ref_node, ground_ok=True)
        if pss_xs is None:
            pss_xs = self._pss_samples(p, f0, n_harm, **hb_kw)
        nf_db, _, _ = mixer_noise_figure(self.engine, p, f0, pss_xs, delta,
                                         out_eq, ridx, sidebands=sidebands,
                                         ref_eq=ref_eq)
        return nf_db

    def monte_carlo_mixer_noise_figure(self, n: int,
                                       source_resistor: str, delta: float,
                                       out_node: str,
                                       ref_node: Optional[str] = None,
                                       sidebands=(1,), seed: int = 0,
                                       sampler: str = "mc",
                                       f0: Optional[float] = None,
                                       n_harm: Optional[int] = None,
                                       **hb_kw):
        """Monte-Carlo conversion noise figure: n lanes' folded-pnoise NF
        at IF = delta from one batched adjoint LPTV solve around their
        batched-HB steady states (analysis/pac.py
        mixer_noise_figure_batched); unconverged lanes are NaN.  Returns
        (bparams, nf_db (n,))."""
        from .analysis.pac import mixer_noise_figure_batched
        ridx = self._resistor_column(source_resistor)
        out_eq, ref_eq = self._out_ref(out_node, ref_node, ground_ok=True)
        bp, f0, pss = self._mc_pss(n, seed, sampler, f0, n_harm,
                                   "monte_carlo_mixer_noise_figure",
                                   **hb_kw)
        nf_db, _, _ = mixer_noise_figure_batched(
            self.engine, bp, f0, pss.xs, delta, out_eq, ridx,
            sidebands=sidebands, ref_eq=ref_eq)
        conv = _host(pss.converged)
        self._warn_unconverged_lanes(conv, "monte_carlo_mixer_noise_figure")
        return bp, np.where(conv, nf_db, np.nan)

    def hot_sparams(self, ports, deltas, f0: Optional[float] = None,
                    n_sidebands: int = 1, n_harm: Optional[int] = None,
                    pss_xs=None, params: Optional[Any] = None, **hb_kw):
        """Periodic (hot) S-parameters (analysis/psp.py): the
        frequency-translating scattering matrix around the periodic steady
        state at f0, every (port, sideband m in -M..M) pair a terminal of
        an extended multiport (a mixer's delta -> f0 + delta conversion
        gain is res.s_at(1, 1, 0, 0)).  ports as for sparams(); the port
        terminations must not be in the netlist."""
        from .analysis.psp import periodic_s_parameters
        f0 = self._hb_f0(f0, "hot_sparams needs f0 (or a .hb card)")
        port_eqs, z0s = self._port_eqs(ports)
        p = params if params is not None else self.params
        if pss_xs is None:
            pss_xs = self._pss_samples(p, f0, n_harm, **hb_kw)
        return periodic_s_parameters(self.engine, p, f0, pss_xs, port_eqs,
                                     z0s, deltas, n_sidebands=n_sidebands)

    def lssp(self, ports, power, f0: Optional[float] = None,
             n_harm: int = 7, params: Optional[Any] = None, **hb_kw):
        """Large-signal S-parameters at the available drive power `power`
        (W).  The port terminations live in the netlist: each port is a
        grounded Thevenin pair, a V source with a SIN at f0 behind a z0
        resistor, and ports lists (source_name, port_node, z0), port_node
        the terminal after the resistor.  One harmonic balance per driven
        port j (its amplitude sqrt(8 z0_j P), every other port source at
        0); the fundamental waves a_j = Vs_j / (2 sqrt z0_j) and b_i = (2
        V_i - Vs_i) / (2 sqrt z0_i) from the HB spectrum (e^{+jwt}
        phasors).  Returns a dict: s (n, n) complex, amps (n,) and the
        per-port HBResults."""
        from .analysis.hb import harmonic_balance
        f0 = self._hb_f0(f0, "lssp needs f0 (or a .hb card)")
        n = len(ports)
        src_idx, node_eqs, vs_ep, z0 = self._lssp_ports(ports)
        p0 = dict(params if params is not None else self.params)
        amps = np.sqrt(8.0 * z0 * float(power))
        S = np.zeros((n, n), complex)
        results = []
        for j in range(n):
            vs_sin = p0["vs_sin"].clone()
            for i, si in enumerate(src_idx):
                vs_sin[si, 1] = amps[j] if i == j else 0.0
            p = dict(p0)
            p["vs_sin"] = vs_sin
            res = harmonic_balance(self.engine, p, f0, n_harm=n_harm,
                                   **hb_kw)
            if not bool(res.converged):
                raise RuntimeError(f"lssp HB did not converge driving "
                                   f"port {j} (residual "
                                   f"{float(res.residual):.3e})")
            results.append(res)
            c1 = np.concatenate([_host(res.spectrum[1]), [0.0]])
            vs = c1[vs_ep]
            vp = c1[node_eqs]
            a_j = vs[j] / (2.0 * np.sqrt(z0[j]))
            S[:, j] = (2.0 * vp - vs) / (2.0 * np.sqrt(z0)) / a_j
        return {"s": S, "amps": amps, "results": results}

    def _lssp_ports(self, ports):
        """Validate lssp-style (source, node, z0) ports; returns (src_idx,
        node_eqs, vs_ep, z0).  A port source must be grounded: Vs = V(ep)
        holds only with em = ground."""
        from .analysis.sweep import find_source
        src_idx, node_eqs, z0 = [], [], []
        for (src, node, z) in ports:
            kind, sidx = find_source(self.circuit, src)
            if kind != KIND_V:
                raise ValueError(f"lssp port source {src!r} must be a "
                                 "V source")
            src_idx.append(sidx)
            eqi = self._node_eq(node)
            if eqi < 0:
                raise ValueError(f"port node {node!r} is ground")
            node_eqs.append(eqi)
            z0.append(float(z))
        dump = self.engine.N
        for i, (src, _, _) in zip(src_idx, ports):
            if int(self.topo.vs_em[i]) != dump:
                raise ValueError(
                    f"lssp port source {src!r} is floating (negative "
                    "terminal not ground): S-parameter ports must be "
                    "grounded Thevenin sources (Vsrc + series Z0 to "
                    "ground)")
        vs_ep = [int(self.topo.vs_ep[i]) for i in src_idx]
        return src_idx, node_eqs, vs_ep, np.asarray(z0)

    def lssp_batched(self, ports, powers, f0: Optional[float] = None,
                     n_harm: int = 7, bparams: Optional[Any] = None,
                     **hb_kw):
        """Batched large-signal S-parameters: every (Monte-Carlo lane,
        drive power, driven port) triple is one lane of a single batched
        harmonic balance (a whole compression curve and parameter spread
        at once).  ports and f0 as lssp(); powers (Pw,) in W; bparams
        optional lanes (leading axis), the nominal params as one lane when
        omitted.  Returns a dict: s (B, Pw, n, n) complex, amps (Pw, n),
        converged (B, Pw, n) and the HBBatchResult as result (lane order b,
        power, driven port)."""
        from .analysis.hb import harmonic_balance_batched
        f0 = self._hb_f0(f0, "lssp needs f0 (or a .hb card)")
        n = len(ports)
        src_idx, node_eqs, vs_ep, z0 = self._lssp_ports(ports)
        powers = np.asarray(powers, float).ravel()
        Pw = len(powers)
        if bparams is None:
            bparams = {k: v[None] for k, v in self.params.items()}
        B = int(next(iter(bparams.values())).shape[0])
        L = B * Pw * n
        amps = np.sqrt(8.0 * z0[None, :] * powers[:, None])   # (Pw, n)
        tiled = {k: torch.as_tensor(v).repeat_interleave(Pw * n, dim=0)
                 for k, v in bparams.items()}
        # port j's source at amps[ip, j] on its own drive lane, 0 elsewhere
        lane_amp = np.zeros((B, Pw, n, len(src_idx)))
        for j in range(n):
            lane_amp[:, :, j, j] = amps[:, j][None, :]
        vs_sin = tiled["vs_sin"].clone()
        for i, si in enumerate(src_idx):
            vs_sin[:, si, 1] = torch.as_tensor(
                lane_amp[..., i].reshape(L), dtype=vs_sin.dtype,
                device=vs_sin.device)
        tiled["vs_sin"] = vs_sin
        res = harmonic_balance_batched(self.engine, tiled, f0, n_harm=n_harm,
                                       **hb_kw)
        c1 = np.concatenate([_host(res.spectrum[:, 1]),
                             np.zeros((L, 1), complex)], axis=1)
        vs = c1[:, vs_ep].reshape(B, Pw, n, n)     # (.., drive j, port i)
        vp = c1[:, node_eqs].reshape(B, Pw, n, n)
        a = vs.diagonal(axis1=-2, axis2=-1) / (2.0 * np.sqrt(z0))
        b_w = (2.0 * vp - vs) / (2.0 * np.sqrt(z0)[None, None, None, :])
        S = np.moveaxis(b_w / a[..., :, None], -2, -1)   # (B, Pw, i, j)
        conv = _host(res.converged).reshape(B, Pw, n)
        return {"s": S, "amps": amps, "converged": conv, "result": res}

    def monte_carlo_lssp(self, n: int, ports, powers, seed: int = 0,
                         sampler: str = "mc", **kw):
        """Monte-Carlo large-signal S-parameters: n lanes of the DEV=/LOT=
        tolerances x len(powers) drive levels x len(ports) driven ports as
        one batched HB.  Returns (bparams, the lssp_batched dict with s (n,
        Pw, p, p))."""
        bp = self._hb_lanes(n, seed, sampler)
        return bp, self.lssp_batched(ports, powers, bparams=bp, **kw)

    def monte_carlo_psp(self, n: int, ports, deltas, seed: int = 0,
                        sampler: str = "mc", f0: Optional[float] = None,
                        n_sidebands: int = 1,
                        n_harm: Optional[int] = None, **hb_kw):
        """Monte-Carlo hot S-parameters: n lanes each linearised around its
        own batched-HB steady state, every (lane, offset) LPTV solve in
        the batched solves (analysis/psp.periodic_s_parameters_batched).
        ports as hot_sparams.  Returns (bparams, PSPBatchResult)."""
        from .analysis.psp import periodic_s_parameters_batched
        bp, f0, pss = self._mc_pss(n, seed, sampler, f0, n_harm,
                                   "monte_carlo_psp", **hb_kw)
        port_eqs, z0s = self._port_eqs(ports)
        return bp, periodic_s_parameters_batched(
            self.engine, bp, f0, pss.xs, port_eqs, z0s, deltas,
            n_sidebands=n_sidebands)

    def monte_carlo_pnoise(self, n: int, deltas, out_node: str,
                           ref_node: Optional[str] = None, seed: int = 0,
                           sampler: str = "mc", f0: Optional[float] = None,
                           n_harm: Optional[int] = None, **hb_kw):
        """Monte-Carlo periodic noise: n lanes' cyclostationary output PSD,
        each around its own batched-HB steady state
        (analysis/pac.pnoise_batched).  Returns (bparams,
        PNoiseBatchResult) with onoise (n, F) and the kind breakdown."""
        from .analysis.pac import pnoise_batched
        out_eq, ref_eq = self._out_ref(out_node, ref_node)
        bp, f0, pss = self._mc_pss(n, seed, sampler, f0, n_harm,
                                   "monte_carlo_pnoise", **hb_kw)
        res = pnoise_batched(self.engine, bp, f0, pss.xs, deltas, out_eq,
                             ref_eq)
        res.converged = _host(pss.converged)
        self._warn_unconverged_lanes(res.converged, "monte_carlo_pnoise")
        return bp, res

    def monte_carlo_pac(self, n: int, deltas, seed: int = 0,
                        sampler: str = "mc", f0: Optional[float] = None,
                        n_sidebands: Optional[int] = None,
                        n_harm: Optional[int] = None, **hb_kw):
        """Monte-Carlo periodic AC: n lanes' conversion gains around their
        own batched-HB steady states (analysis/pac.pac_batched).  Returns
        (bparams, PACBatchResult) with spectrum (n, F, M, N)."""
        from .analysis.pac import pac_batched
        bp, f0, pss = self._mc_pss(n, seed, sampler, f0, n_harm,
                                   "monte_carlo_pac", **hb_kw)
        res = pac_batched(self.engine, bp, f0, pss.xs, deltas,
                          n_sidebands=n_sidebands)
        res.converged = _host(pss.converged)
        self._warn_unconverged_lanes(res.converged, "monte_carlo_pac")
        return bp, res

    def monte_carlo_pxf(self, n: int, deltas, out_node: str,
                        ref_node: Optional[str] = None, seed: int = 0,
                        sampler: str = "mc", f0: Optional[float] = None,
                        n_sidebands: Optional[int] = None,
                        n_harm: Optional[int] = None, **hb_kw):
        """Monte-Carlo periodic transfer functions: every lane's source x
        input-sideband -> output table from batched adjoint LPTV solves
        (analysis/pac.pxf_batched).  Returns (bparams, PXFBatchResult)
        with xf_v (n, F, M, nV) and xf_i (n, F, M, nI)."""
        from .analysis.pac import pxf_batched
        out_eq, ref_eq = self._out_ref(out_node, ref_node)
        bp, f0, pss = self._mc_pss(n, seed, sampler, f0, n_harm,
                                   "monte_carlo_pxf", **hb_kw)
        res = self._source_names(pxf_batched(
            self.engine, bp, f0, pss.xs, deltas, out_eq, ref_eq,
            n_sidebands=n_sidebands))
        res.converged = _host(pss.converged)
        self._warn_unconverged_lanes(res.converged, "monte_carlo_pxf")
        return bp, res

    @staticmethod
    def _warn_unconverged_lanes(converged, what: str):
        """Batched-HB lanes that did not converge feed every later LPTV
        stage a wrong steady state: warn instead of returning
        plausible-looking per-lane numbers."""
        import warnings
        bad = int(np.size(converged) - np.count_nonzero(converged))
        if bad:
            warnings.warn(
                f"{what}: {bad}/{np.size(converged)} HB lane(s) did not "
                f"converge; mask those lanes via the result's .converged "
                f"field before trusting their numbers", stacklevel=3)

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
        ridx = self._resistor_column(source_resistor)
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
        port_eqs, z0s = self._port_eqs(ports)
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
