"""Command-line entry point mirroring the reference CLI (src/main.cpp):

    python -m circuitsimulator_tpu_torch <netlist.sp> [tran_out.csv]
        [--device cuda|cpu] [--dtype f64|f32] [--no-tran] [--adaptive]
        [--method be|trap] [--probes-only] [--connectivity] [--raw RAW]
        [--stats JSON] [--profile DIR] [--run-ac [CSV]]
        [--run-dc-sweep [CSV]] [--run-noise [CSV]]
        [--run-loop-gain E] [--run-noise-figure R] [--run-group-delay NODE]
        [--run-mc N [--run-mc-out CSV] [--mc-sampler mc|lhs|sobol|antithetic]]
        [--run-step [CSV]]
        [--run-hb [CSV] [--hb-method shooting|hb] [--hb-solver dense|gmres]]
        [--run-sparams PORTS [--sparams-out FILE]]
        [--run-envelope TSTOP:DT[:CSV] [--env-order 1|2] [--mc-rf N]]
        [--run-hot-sparams PORTS --psp-deltas D1,... [--psp-sidebands M]
         [--hot-sparams-out CSV] [--mc-rf N]]
        [--run-lssp PORTS [--lssp-power P | --lssp-powers P1,...]
         [--mc-rf N]]

prints the circuit summary and the DC node-voltage/branch-current tables,
then runs the transient if a .TRAN card is present (Backward Euler, or
trapezoidal with ``--method trap``; on the adaptive dyadic ladder with
``--adaptive``; from the .IC / UIC start when the deck has one; the
banner says "Backward Euler" either way, as the JAX CLI's does) and
writes its CSV (default
tran_out.csv; a deck with TRNOISE sources runs its noise with seed 0, the
JAX CLI's realisation), then its .MEASURE TRAN results and the .FOUR
table; ``--run-ac`` also runs the .AC sweep, writes its magnitude/phase CSV
(default ac_out.csv) and prints the .MEASURE AC results;
``--run-dc-sweep`` runs the .DC sweep card(s) as one batched DC, writes
the CSV (default dcsweep_out.csv) and prints the .MEASURE DC results;
``--run-mc N`` runs N Monte-Carlo lanes of the deck's DEV=/LOT=
tolerances in one batched solve (per-lane measures with .MEASURE cards,
else DC points) and writes them to a CSV (default mc_out.csv);
``--run-step`` runs the .STEP card(s) as one batch and writes one row per
step value (default step_out.csv).  With ``--dtype f32`` on cuda the
Monte-Carlo transient takes the fused chunk kernel and its probe stream.
After the AC sweep come the .PZ, .SENS and .TF cards' reports, then
``--run-noise`` (the .NOISE sweep's PSD CSV, default noise_out.csv);
after the DC sweep ``--run-loop-gain`` (margins, loopgain.csv),
``--run-noise-figure`` (nf.csv) and ``--run-group-delay``
(groupdelay.csv); ``--run-hb`` runs the .hb steady state after the .STEP
sweep (Newton shooting, or ``--hb-method hb`` harmonic balance with the
dense or the GMRES solver; a multi-tone card takes the MPDE grid), writes
one period (default hb_out.csv) and prints the harmonic table;
``--run-sparams`` (Touchstone .sNp) follows, then ``--run-envelope`` (the
envelope transient's fundamental envelopes, default env_out.csv; with
``--mc-rf N`` the Monte-Carlo spread of N lanes), then
``--run-hot-sparams`` (the periodic S-parameters' magnitude and phase per
offset, default hot_sparams.csv; with ``--mc-rf N`` the spread of the
widest entry) and ``--run-lssp`` (the large-signal S matrix, or with
``--lssp-powers`` / ``--mc-rf N`` |Sij| per power from one batched HB).
``--probes-only`` keeps the .PLOTNV/.PLOTNC/.PRINT columns in the CSVs,
``--raw`` writes every plot into one ngspice rawfile, ``--stats`` the
transient's run metadata as JSON, ``--profile`` a torch.profiler Chrome
trace of the transient into a directory, ``--connectivity`` the node table.
The words and the order are the JAX CLI's, so stdout is byte-identical.
``--device`` defaults to cuda; on a machine without a GPU the run stops
with an error instead of moving to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m circuitsimulator_tpu_torch",
        description="SPICE-class circuit simulator (PyTorch/CUDA port)")
    p.add_argument("netlist", help="SPICE netlist file (.sp)")
    p.add_argument("tran_out", nargs="?", default="tran_out.csv",
                   help="transient CSV output path (default: tran_out.csv)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("--dtype", choices=["f64", "f32"], default="f64",
                   help="working precision (default f64, reference parity)")
    p.add_argument("--no-tran", action="store_true",
                   help="skip the transient analysis even if .TRAN present")
    p.add_argument("--probes-only", action="store_true",
                   help="restrict the transient CSV to the columns named by "
                        ".PLOTNV/.PLOTNC/.PRINT cards (the reference parses "
                        "these cards but always writes every column)")
    p.add_argument("--connectivity", action="store_true",
                   help="print the node connectivity table")
    p.add_argument("--adaptive", action="store_true",
                   help="LTE-controlled adaptive timestep refinement "
                        "(dyadic dt ladder; output stays on the .TRAN grid)")
    p.add_argument("--method", choices=["be", "trap"], default="be",
                   help="transient integration: Backward Euler (reference "
                        "behavior, default) or trapezoidal (2nd order)")
    p.add_argument("--raw", metavar="RAWFILE", default=None,
                   help="also write results as an ngspice ASCII rawfile "
                        "(transient/AC/DC-sweep plots appended in order)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of the transient "
                        "into DIR (a Chrome trace, view with Perfetto)")
    p.add_argument("--stats", metavar="JSON", default=None,
                   help="write structured run metadata (Newton iteration "
                        "histogram, timings) to a JSON file")
    p.add_argument("--run-ac", metavar="CSV", nargs="?", const="ac_out.csv",
                   help="run the .AC small-signal sweep, write mag/phase CSV")
    p.add_argument("--run-dc-sweep", metavar="CSV", nargs="?",
                   const="dcsweep_out.csv",
                   help="run the .DC sweep card(s), write CSV")
    p.add_argument("--run-noise", metavar="CSV", nargs="?",
                   const="noise_out.csv", default=None,
                   help="run the .NOISE small-signal noise sweep and write "
                        "PSD columns to CSV")
    p.add_argument("--run-step", metavar="CSV", nargs="?",
                   const="step_out.csv",
                   help="run the .STEP sweep as one batch; CSV has one row "
                        "per step value (.MEASURE columns for transient "
                        "steps, node voltages for .OP steps)")
    p.add_argument("--run-loop-gain", metavar="E_SOURCE", default=None,
                   help="loop-gain (Bode return ratio) of the named "
                        "VCVS over the .AC sweep: prints phase/gain "
                        "margins, writes loopgain.csv (f, |T| dB, deg)")
    p.add_argument("--run-noise-figure", metavar="RESISTOR", default=None,
                   help="noise figure referred to the named source "
                        "resistor over the .NOISE/.AC sweep: prints the "
                        "flat-band NF, writes nf.csv")
    p.add_argument("--run-group-delay", metavar="NODE", default=None,
                   help="exact group delay of V(NODE) over the .AC "
                        "sweep (adjoint of the solve), writes "
                        "groupdelay.csv")
    p.add_argument("--run-sparams", metavar="PORTS", default=None,
                   help="S-parameter extraction over the .AC sweep: "
                        "comma-separated ports 'p[:m][@z0]', e.g. "
                        "'in,out' or 'in:0@50,out:0@75' (m defaults to "
                        "ground, z0 to 50); writes Touchstone .sNp")
    p.add_argument("--sparams-out", metavar="FILE", default=None,
                   help="Touchstone output path (default sparams.s<N>p)")
    p.add_argument("--run-mc", metavar="N", type=int, default=None,
                   help="Monte-Carlo over the netlist's DEV=/LOT= "
                        "tolerances: N lanes, one batched solve")
    p.add_argument("--run-mc-out", metavar="CSV", default="mc_out.csv",
                   help="per-lane Monte-Carlo results CSV "
                        "(default mc_out.csv)")
    p.add_argument("--run-hb", metavar="CSV", nargs="?", const="hb_out.csv",
                   help="run .hb periodic steady state, write one period "
                        "CSV and print the harmonic table")
    p.add_argument("--hb-method", choices=["shooting", "hb"],
                   default="shooting",
                   help="steady-state algorithm: time-domain Newton "
                        "shooting or frequency-domain harmonic balance")
    p.add_argument("--hb-solver", choices=["dense", "gmres"],
                   default="dense",
                   help="HB linear solver (--hb-method hb, single tone): "
                        "dense (K·N)² Jacobian, or matrix-free "
                        "preconditioned GMRES for large harmonic-count × "
                        "node-count products")
    p.add_argument("--run-osc", metavar="F0:NODE[:CSV]", default=None,
                   help="free-running oscillator steady state: guess "
                        "frequency + anchor node, e.g. '5e6:a' or "
                        "'5e6:a:osc.csv'; prints the solved f0 and the "
                        "harmonic table, writes one period "
                        "(default osc_out.csv)")
    p.add_argument("--osc-method", choices=["auto", "shooting", "hb"],
                   default="auto",
                   help="oscillator solver: time-domain shooting or "
                        "autonomous harmonic balance (auto = hb when the "
                        "deck has transmission lines, else shooting)")
    p.add_argument("--pss-stability", action="store_true",
                   help="with --run-hb (shooting method): also compute "
                        "the Floquet multipliers of the periodic "
                        "solution and report attractor/repellor")
    p.add_argument("--run-lock", metavar="F0:ANCHOR:INJ:AMP",
                   default=None,
                   help="oscillator injection-locking range: shooting "
                        "guess frequency, anchor node, injection node, "
                        "injected current amplitude (A), e.g. "
                        "'5e6:a:a:1e-3'; prints the solved f0 and the "
                        "one-sided Adler lock range")
    p.add_argument("--run-subharmonic-lock", metavar="F0:ANCHOR:INJ:AMP:M",
                   default=None,
                   help="subharmonic injection-locking window "
                        "(f_osc = M*f_inj, injection near f0/M) by "
                        "driven-HB fold search, e.g. '5e6:a:a:10m:2'; "
                        "prints the locked frequency window")
    p.add_argument("--run-envelope", metavar="TSTOP:DT[:CSV]", default=None,
                   help="envelope-following transient at the .hb carrier: "
                        "slow-axis step DT to TSTOP, e.g. '5e-6:1e-7' or "
                        "'5e-6:1e-7:env.csv'; writes per-node fundamental-"
                        "envelope magnitude/phase columns "
                        "(default env_out.csv)")
    p.add_argument("--env-order", type=int, choices=[1, 2], default=1,
                   help="envelope integrator: 1 = backward Euler, "
                        "2 = trapezoidal")
    p.add_argument("--run-hot-sparams", metavar="PORTS", default=None,
                   help="periodic (hot) S-parameters around the .hb PSS: "
                        "same port grammar as --run-sparams; offset "
                        "frequencies from --psp-deltas; writes the "
                        "conversion scattering entries "
                        "(default hot_sparams.csv)")
    p.add_argument("--psp-deltas", metavar="D1,D2,...", default=None,
                   help="offset frequencies for --run-hot-sparams")
    p.add_argument("--psp-sidebands", type=int, default=1,
                   help="sidebands -M..M kept in --run-hot-sparams")
    p.add_argument("--hot-sparams-out", metavar="CSV", default=None,
                   help="CSV path for --run-hot-sparams "
                        "(default hot_sparams.csv)")
    p.add_argument("--run-lssp", metavar="PORTS", default=None,
                   help="large-signal S-parameters on the .hb carrier: "
                        "comma-separated Thevenin ports 'SRC:NODE[@z0]' "
                        "(V source + series z0 resistor in the deck), "
                        "driven at --lssp-power; prints the S matrix")
    p.add_argument("--lssp-power", type=float, default=1e-3,
                   help="available drive power in watts for --run-lssp")
    p.add_argument("--lssp-powers", metavar="P1,P2,...", default=None,
                   help="power sweep for --run-lssp: comma-separated "
                        "available powers in watts, the whole "
                        "compression curve solved as one batched HB "
                        "(Simulator.lssp_batched); prints |Sij| per power")
    p.add_argument("--mc-rf", metavar="N", type=int, default=None,
                   help="Monte-Carlo lanes for the RF analyses: with "
                        "--run-hot-sparams runs monte_carlo_psp, with "
                        "--run-lssp runs monte_carlo_lssp (honors "
                        "--lssp-powers), with --run-envelope runs "
                        "monte_carlo_envelope, each as one batched "
                        "program over the netlist's DEV=/LOT= "
                        "tolerances; prints mean/std summaries "
                        "(--mc-sampler selects the sampling plan)")
    p.add_argument("--mc-sampler", default="mc",
                   choices=["mc", "lhs", "sobol", "antithetic"],
                   help="Monte-Carlo sampling plan: independent draws "
                        "(mc, default), Latin hypercube, scrambled "
                        "Sobol, or antithetic pairs; the stratified "
                        "plans cut estimator variance at the same N")
    return p


def _raw_mode(args) -> str:
    """First --raw write truncates, later plots append (multi-plot
    rawfiles are standard ngspice)."""
    mode = "a" if getattr(args, "_raw_written", False) else "w"
    args._raw_written = True
    return mode


def _profiler(args, device):
    """torch.profiler over the transient for --profile (a Chrome trace in
    the directory), else a null context."""
    import contextlib
    if not args.profile:
        return contextlib.nullcontext()
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=lambda prof: prof.export_chrome_trace(
            os.path.join(args.profile, "trace.json")))


def _small_signal_cards(sim, x) -> None:
    """The .PZ, .SENS and .TF reports (a failure is named on stderr and
    the run goes on, as in the JAX CLI)."""
    cfg = sim.config
    if cfg.pz.enabled:
        try:
            from .analysis.pz import pz_table
            print()
            print(pz_table(sim.pole_zero(x_op=x)))
        except Exception as e:  # noqa: BLE001
            print(f".PZ failed: {e}", file=sys.stderr)
    if cfg.sens.enabled:
        try:
            _, rows = sim.sensitivity(x_op=x)
            out, ref = cfg.sens.out_node, cfg.sens.ref_node
            probe = f"V({out},{ref})" if ref else f"V({out})"
            print(f"\n==== DC sensitivities of {probe} ====")
            for label, g, gn in rows[:15]:
                print(f"{label:>24s} = {g: .6e}   (p*dV/dp = {gn: .6e})")
        except Exception as e:  # noqa: BLE001
            print(f".SENS failed: {e}", file=sys.stderr)
    if cfg.tf.enabled:
        try:
            from .analysis.tf import tf_report
            tf = cfg.tf
            if tf.out_kind == "v":
                out_label = (f"V({tf.out_node},{tf.ref_node})"
                             if tf.ref_node else f"V({tf.out_node})")
            else:
                out_label = f"I({tf.out_element})"
            print()
            print(tf_report(sim.tf(x_op=x), out_label, tf.input_source))
        except Exception as e:  # noqa: BLE001
            print(f".TF failed: {e}", file=sys.stderr)


def _loop_gain_nf_group_delay(sim, args) -> int:
    """--run-loop-gain, --run-noise-figure and --run-group-delay."""
    import numpy as np
    if args.run_loop_gain:
        try:
            lg = sim.loop_gain(args.run_loop_gain)
            T = lg["T"]
            with open("loopgain.csv", "w") as f:
                f.write("freq,mag_db,phase_deg\n")
                for fr, t in zip(np.asarray(lg["freqs"]), T):
                    f.write(f"{fr:.9e},{20 * np.log10(abs(t)):.6f},"
                            f"{np.degrees(np.angle(t)):.6f}\n")
            pm = lg["phase_margin_deg"]
            gm = lg["gain_margin_db"]
            print(f"\nLoop gain of {args.run_loop_gain}: "
                  f"|T(0)| = {20 * np.log10(abs(T[0])):.2f} dB")
            print("  unity crossover: "
                  + (f"{lg['f_unity']:.4g} Hz, phase margin {pm:.2f} deg"
                     if pm is not None else "not reached in sweep"))
            print("  gain margin: "
                  + (f"{gm:.2f} dB at {lg['f_180']:.4g} Hz"
                     if gm is not None else "no -180 deg crossing"))
            print("  written to 'loopgain.csv'.")
        except Exception as e:  # noqa: BLE001
            print(f"loop-gain analysis failed: {e}", file=sys.stderr)
            return 1
    if args.run_noise_figure:
        try:
            fr, nf = sim.noise_figure(args.run_noise_figure)
            with open("nf.csv", "w") as f:
                f.write("freq,nf_db\n")
                for a, b in zip(fr, nf):
                    f.write(f"{a:.9e},{b:.6f}\n")
            print(f"\nNoise figure (ref {args.run_noise_figure}): "
                  f"{nf.min():.3f} .. {nf.max():.3f} dB; "
                  "written to 'nf.csv'.")
        except Exception as e:  # noqa: BLE001
            print(f"noise-figure analysis failed: {e}", file=sys.stderr)
            return 1
    if args.run_group_delay:
        try:
            fr, tau = sim.group_delay(args.run_group_delay)
            with open("groupdelay.csv", "w") as f:
                f.write("freq,tau_s\n")
                for a, b in zip(fr, tau):
                    f.write(f"{a:.9e},{b:.9e}\n")
            print(f"\nGroup delay of V({args.run_group_delay}): "
                  f"{tau.max() * 1e9:.4g} ns max; "
                  "written to 'groupdelay.csv'.")
        except Exception as e:  # noqa: BLE001
            print(f"group-delay analysis failed: {e}", file=sys.stderr)
            return 1
    return 0


def _run_sparams(sim, args, x) -> int:
    """--run-sparams: ports 'p[:m][@z0]', a Touchstone file."""
    from .analysis.sparams import write_touchstone
    print("\nRunning S-parameter extraction...")
    try:
        ports = _ports(args.run_sparams, thevenin=False)
        sres = sim.sparams(ports, x_op=x)
        out = args.sparams_out or f"sparams.s{len(ports)}p"
        write_touchstone(out, sres)
        print(f"S-parameters ({len(ports)} ports, "
              f"{len(sres.freqs)} points) written to '{out}'.")
    except Exception as e:  # noqa: BLE001
        print(f"S-parameter extraction failed: {e}", file=sys.stderr)
        return 1
    return 0


def _run_mc(sim, args) -> int:
    """--run-mc: per-lane results CSV and the statistics block."""
    import numpy as np
    from .api import _host
    n = args.run_mc
    print(f"\nRunning Monte-Carlo ({n} lanes, one batched solve)...")
    try:
        _, out = sim.monte_carlo(n, sampler=args.mc_sampler)
        if isinstance(out, dict):
            names = list(out)
            cols = [_host(out[k]).ravel() for k in names]
            with open(args.run_mc_out, "w") as f:
                f.write("lane," + ",".join(names) + "\n")
                for i in range(n):
                    f.write(f"{i}," + ",".join(f"{c[i]:.9e}"
                                               for c in cols) + "\n")
            print("\n==== Monte-Carlo measure statistics ====")
            for k, c in zip(names, cols):
                print(f"  {k:>16s}: mean={c.mean():.6g} "
                      f"std={c.std():.6g} min={c.min():.6g} "
                      f"max={c.max():.6g}")
        else:
            xs = _host(out)
            eqs = np.asarray(sim.topo.volt_col_eqs, int)
            names = [f"V({nm})" for nm in sim.topo.volt_col_names]
            with open(args.run_mc_out, "w") as f:
                f.write("lane," + ",".join(names) + "\n")
                for i in range(n):
                    f.write(f"{i}," + ",".join(
                        f"{v:.9e}" for v in xs[i, eqs]) + "\n")
            print("\n==== Monte-Carlo DC statistics ====")
            for j, nm in enumerate(names):
                c = xs[:, eqs[j]]
                print(f"  {nm:>16s}: mean={c.mean():.6g} "
                      f"std={c.std():.6g}")
        print(f"Monte-Carlo finished. Per-lane results written to "
              f"'{args.run_mc_out}'.")
    except Exception as e:  # noqa: BLE001
        print(f"Monte-Carlo failed: {e}", file=sys.stderr)
        return 1
    return 0


def _run_hb(sim, args) -> int:
    """--run-hb: the .hb steady state (shooting, or HB dense/GMRES; a
    multi-tone card always takes the MPDE grid), its one-period CSV and
    the harmonic table."""
    import numpy as np
    from .analysis.hbmulti import HBMultiResult, evaluate
    from .analysis.sstate import harmonic_table
    from .io.csvout import write_transient_csv
    print(f"\nRunning periodic steady state ({args.hb_method})...")
    try:
        multi_card = bool(sim.config.hb.extra_tones)
        if multi_card and args.hb_method != "hb":
            print("multi-tone .hb card: using the MPDE harmonic-balance "
                  "solver (shooting is single-tone only)")
        if multi_card:
            hbres = sim.harmonic_balance()
        elif args.hb_method == "hb":
            hbres = sim.harmonic_balance(solver=args.hb_solver)
        else:
            hbres = sim.steady_state()
        if isinstance(hbres, HBMultiResult):
            # the quasi-periodic waveform over one period of the slowest
            # tone
            f_min = min(f for f, _ in hbres.tones)
            ts = np.linspace(0.0, 1.0 / f_min, 512, endpoint=False)
            write_transient_csv(args.run_hb, sim.topo, ts,
                                evaluate(hbres, ts))
            print(f"multi-tone steady state: tones={hbres.tones}, "
                  f"residual={float(hbres.residual):.3e}, "
                  f"converged={bool(hbres.converged)}")
        else:
            write_transient_csv(args.run_hb, sim.topo,
                                hbres.times.cpu().numpy(),
                                hbres.xs.cpu().numpy())
            print(f"steady state: residual={float(hbres.residual):.3e}, "
                  f"newton_iters={hbres.newton_iters}, "
                  f"converged={bool(hbres.converged)}")
            print(harmonic_table(sim.topo, hbres))
            if args.pss_stability and getattr(hbres, "s", None) is None:
                print("--pss-stability needs the shooting method "
                      "(--hb-method shooting); skipped", file=sys.stderr)
            elif args.pss_stability:
                st = sim.pss_stability(ss=hbres)
                tag = ("stable (attractor)" if st.stable else
                       "UNSTABLE — the transient flow cannot settle "
                       "on this solution")
                print(f"Floquet: |lambda|_max = {st.lambda_max:.6f} "
                      f"-> {tag}")
        print(f"One period written to '{args.run_hb}'.")
    except Exception as e:  # noqa: BLE001
        print(f"Steady state failed: {e}", file=sys.stderr)
        return 1
    return 0


def _run_osc(sim, args) -> int:
    """--run-osc F0:NODE[:CSV] (--osc-method): the oscillator's solved f0,
    its one-period CSV and harmonic table (a shooting result's spectrum
    from its uniform period samples, up to the 10th harmonic)."""
    import numpy as np
    from .analysis.sstate import harmonic_table
    from .io.csvout import write_transient_csv
    from .utils.numbers import parse_spice_number
    try:
        parts = args.run_osc.split(":")
        if len(parts) < 2:
            raise ValueError("--run-osc needs F0:NODE[:CSV]")
        f0g = float(parse_spice_number(parts[0]))
        node = parts[1]
        out = parts[2] if len(parts) > 2 else "osc_out.csv"
        method = args.osc_method
        if method == "auto":
            method = "hb" if sim.engine.n_tl else "shooting"
        print(f"\nRunning oscillator steady state ({method})...")
        osc = (sim.oscillator_hb(f0g, node, solver=args.hb_solver)
               if method == "hb" else sim.oscillator(f0g, node))
        print(f"oscillator: f0={float(osc.f0):.9e} Hz, "
              f"residual={float(osc.residual):.3e}, "
              f"newton_iters={osc.newton_iters}, "
              f"converged={bool(osc.converged)}")
        write_transient_csv(out, sim.topo, osc.times.cpu().numpy(),
                            osc.xs.cpu().numpy())
        if hasattr(osc, "spectrum"):
            print(harmonic_table(sim.topo, osc))
        else:
            # the shooting result: the last row repeats the first
            xs_p = osc.xs.cpu().numpy()[:-1]
            K = xs_p.shape[0]
            co = np.fft.rfft(xs_p, axis=0) / K * 2.0
            co[0] /= 2.0
            co = co[:11]
            tbl = type("S", (), {})()
            tbl.spectrum = co
            tbl.freqs = np.arange(co.shape[0]) * float(osc.f0)
            print(harmonic_table(sim.topo, tbl))
        print(f"One period written to '{out}'.")
    except Exception as e:  # noqa: BLE001
        print(f"Oscillator failed: {e}", file=sys.stderr)
        return 1
    return 0


def _run_lock(sim, args) -> int:
    """--run-lock F0:ANCHOR:INJ:AMP: the free-running f0 and the one-sided
    Adler lock range."""
    from .utils.numbers import parse_spice_number
    print("\nRunning injection-lock analysis...")
    try:
        parts = args.run_lock.split(":")
        if len(parts) != 4:
            raise ValueError("--run-lock wants F0:ANCHOR:INJ:AMP")
        f0g = parse_spice_number(parts[0])
        amp = parse_spice_number(parts[3])
        il = sim.injection_lock(parts[2], amp, f0_guess=f0g,
                                anchor_node=parts[1])
        print(f"Free-running f0 = {il.f0:.6e} Hz")
        print(f"Injection {amp:g} A at '{parts[2]}': one-sided lock "
              f"range = {il.lock_range_hz:.4e} Hz "
              f"({il.k_per_amp:.4e} Hz/A)")
    except Exception as e:  # noqa: BLE001
        print(f"Injection-lock analysis failed: {e}", file=sys.stderr)
        return 1
    return 0


def _run_subharmonic_lock(sim, args) -> int:
    """--run-subharmonic-lock F0:ANCHOR:INJ:AMP:M: the locked f_inj
    window of the driven-HB fold search."""
    from .utils.numbers import parse_spice_number
    print("\nRunning subharmonic injection-lock analysis...")
    try:
        parts = args.run_subharmonic_lock.split(":")
        if len(parts) != 5:
            raise ValueError("--run-subharmonic-lock wants "
                             "F0:ANCHOR:INJ:AMP:M")
        f0g = parse_spice_number(parts[0])
        amp = parse_spice_number(parts[3])
        m = int(parts[4])
        sl = sim.subharmonic_lock(parts[2], amp, m=m, f0_guess=f0g,
                                  anchor_node=parts[1])
        print(f"Free-running f0 = {sl.f0:.6e} Hz")
        print(f"Injection {amp:g} A at '{parts[2]}', order m={m}: "
              f"locked for f_inj in [{sl.f_lo:.6e}, {sl.f_hi:.6e}] "
              f"Hz (one-sided {sl.lock_range_hz:.4e} Hz)")
    except Exception as e:  # noqa: BLE001
        print(f"Subharmonic-lock analysis failed: {e}", file=sys.stderr)
        return 1
    return 0


def _run_envelope(sim, args) -> int:
    """--run-envelope TSTOP:DT[:CSV] (and --mc-rf N): the fundamental
    envelopes' magnitude and phase per node, then the Monte-Carlo
    spread."""
    import numpy as np
    print("\nRunning envelope transient...")
    try:
        parts = args.run_envelope.split(":")
        if len(parts) < 2:
            raise ValueError("--run-envelope wants TSTOP:DT[:CSV]")
        t_stop, dt_env = float(parts[0]), float(parts[1])
        out = parts[2] if len(parts) > 2 else "env_out.csv"
        env = sim.envelope(t_stop, dt_env, order=args.env_order)
        names = list(sim.topo.volt_col_names)
        eqs = list(sim.topo.volt_col_eqs)
        with open(out, "w") as fh:
            cols = ["time"]
            for n in names:
                cols += [f"|V({n})@f0|", f"argV({n})@f0(deg)"]
            fh.write(",".join(cols) + "\n")
            for i, t in enumerate(env.t1):
                row = [t]
                for eq in eqs:
                    c = env.coeffs[i, 1, eq]
                    row += [abs(c), np.degrees(np.angle(c))]
                fh.write(",".join(f"{v:.9e}" for v in row) + "\n")
        ok = int(env.converged.sum())
        print(f"Envelope: {len(env.t1)} steps ({ok} converged), "
              f"fundamental envelopes written to '{out}'.")
        if ok < len(env.t1):
            print(f"warning: {len(env.t1) - ok} envelope steps did "
                  "not converge", file=sys.stderr)
        if args.mc_rf:
            _, benv = sim.monte_carlo_envelope(
                args.mc_rf, t_stop, dt_env, sampler=args.mc_sampler)
            fin = np.abs(benv.coeffs[:, -1, 1, :])   # (B, N)
            print(f"==== Monte-Carlo envelope spread "
                  f"({args.mc_rf} lanes, {args.mc_sampler}; "
                  f"|Y1| at t1={benv.t1[-1]:g}) ====")
            for nm, eq in zip(names, eqs):
                print(f"  V({nm}): {fin[:, eq].mean():.6e} "
                      f"+/- {fin[:, eq].std():.3e}")
    except Exception as e:  # noqa: BLE001
        print(f"Envelope transient failed: {e}", file=sys.stderr)
        return 1
    return 0


def _ports(spec_list: str, thevenin: bool):
    """Comma-separated ports 'P[:M][@z0]' (--run-hot-sparams) or
    'SRC:NODE[@z0]' (--run-lssp), z0 50 ohm by default."""
    ports = []
    for spec in spec_list.split(","):
        spec = spec.strip()
        z0 = 50.0
        if "@" in spec:
            spec, z0txt = spec.split("@", 1)
            z0 = float(z0txt)
        parts = spec.split(":", 1)
        if thevenin:
            if len(parts) != 2:
                raise ValueError("--run-lssp port wants 'SRC:NODE[@z0]'")
            ports.append((parts[0], parts[1], z0))
        else:
            ports.append((parts[0], parts[1] if len(parts) > 1 else None,
                          z0))
    return ports


def _run_hot_sparams(sim, args) -> int:
    """--run-hot-sparams PORTS --psp-deltas D1,...: the conversion
    scattering entries' magnitude and phase per offset in a CSV, then
    (--mc-rf N) the Monte-Carlo spread of the widest entry."""
    import numpy as np
    print("\nRunning periodic (hot) S-parameter extraction...")
    try:
        if not args.psp_deltas:
            raise ValueError("--run-hot-sparams needs --psp-deltas")
        deltas = [float(v) for v in args.psp_deltas.split(",")]
        ports = _ports(args.run_hot_sparams, thevenin=False)
        res = sim.hot_sparams(ports, deltas, n_sidebands=args.psp_sidebands)
        out = args.hot_sparams_out or "hot_sparams.csv"
        n = len(ports)
        hs = list(res.harmonics)
        terms = [(mi, i, mj, j) for mi in hs for i in range(n)
                 for mj in hs for j in range(n)]
        with open(out, "w") as fh:
            cols = ["delta"]
            for mi, i, mj, j in terms:
                tag = f"{i + 1}@{mi:+d};{j + 1}@{mj:+d}"
                cols += [f"|S({tag})|", f"argS({tag})deg"]
            fh.write(",".join(cols) + "\n")
            for k, d in enumerate(res.deltas):
                row = [d]
                for mi, i, mj, j in terms:
                    s = res.s[k, res.index(i, mi), res.index(j, mj)]
                    row += [abs(s), np.degrees(np.angle(s))]
                fh.write(",".join(f"{v:.9e}" for v in row) + "\n")
        print(f"Hot S-parameters ({n} ports x sidebands "
              f"{hs[0]}..{hs[-1]}, {len(res.deltas)} offsets) "
              f"written to '{out}'.")
        if args.mc_rf:
            _, bres = sim.monte_carlo_psp(args.mc_rf, ports, deltas=deltas,
                                          n_sidebands=args.psp_sidebands,
                                          sampler=args.mc_sampler)
            mag = np.abs(bres.s)                   # (B, F, P, P)
            print(f"==== Monte-Carlo hot-S spread "
                  f"({args.mc_rf} lanes, {args.mc_sampler}) ====")
            for k, d in enumerate(bres.deltas):
                st = mag[:, k].std(axis=0)
                mn = mag[:, k].mean(axis=0)
                ij = np.unravel_index(np.argmax(st), st.shape)
                print(f"  delta={d:g}: widest entry "
                      f"S[{ij[0]},{ij[1]}] = {mn[ij]:.6f} "
                      f"+/- {st[ij]:.3e}")
    except Exception as e:  # noqa: BLE001
        print(f"Hot S-parameter extraction failed: {e}", file=sys.stderr)
        return 1
    return 0


def _run_lssp(sim, args) -> int:
    """--run-lssp PORTS: the large-signal S matrix at --lssp-power, or
    (--lssp-powers, --mc-rf N) |Sij| per power from one batched HB."""
    import numpy as np
    print("\nRunning large-signal S-parameter extraction...")
    try:
        ports = _ports(args.run_lssp, thevenin=True)
        n = len(ports)
        powers = ([float(v) for v in args.lssp_powers.split(",")]
                  if args.lssp_powers else [args.lssp_power])
        if args.mc_rf or len(powers) > 1:
            if args.mc_rf:
                _, out = sim.monte_carlo_lssp(args.mc_rf, ports,
                                              powers=powers,
                                              sampler=args.mc_sampler)
            else:
                out = sim.lssp_batched(ports, powers=powers)
            S = np.abs(out["s"])                   # (B, Pw, n, n)
            tag = f"{S.shape[0]} MC lanes, " if args.mc_rf else ""
            print(f"==== Large-signal S-parameters "
                  f"({tag}{len(powers)} powers, one dispatch) ====")
            for ip, pw in enumerate(powers):
                cells = [f"P={pw:g}W"]
                for i in range(n):
                    for j in range(n):
                        m = S[:, ip, i, j].mean()
                        sd = S[:, ip, i, j].std()
                        cells.append(f"|S{i + 1}{j + 1}|={m:.6f}"
                                     + (f"+/-{sd:.2e}" if args.mc_rf
                                        else ""))
                print("  ".join(cells))
        else:
            res = sim.lssp(ports, power=args.lssp_power)
            print(f"==== Large-signal S-parameters "
                  f"(P = {args.lssp_power:g} W) ====")
            for i in range(n):
                cells = []
                for j in range(n):
                    s = res["s"][i, j]
                    cells.append(f"S{i + 1}{j + 1} = {abs(s):.6f} "
                                 f"/{np.degrees(np.angle(s)):7.2f}deg")
                print("  ".join(cells))
    except Exception as e:  # noqa: BLE001
        print(f"Large-signal S-parameter extraction failed: {e}",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import time
    import torch
    from .analysis.measure import measure_report
    from .analysis.transient import n_steps_for
    from .api import Simulator
    from .utils.options import DEFAULT_OPTIONS

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda requested but no CUDA device is "
              "available (use --device cpu)", file=sys.stderr)
        return 2
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    opts = DEFAULT_OPTIONS.replace(dtype=dtype, tran_method=args.method)

    print(f"Reading netlist: {args.netlist}")
    try:
        sim = Simulator.from_file(args.netlist, opts=opts, device=args.device)
    except FileNotFoundError:
        print("parseNetlist() failed.", file=sys.stderr)
        return 1

    print(sim.summary())
    if args.connectivity:
        print()
        print(sim.circuit.connectivity_report())
    print("\nRunning DC operating point...")
    try:
        x = sim.dc()
    except Exception as e:  # noqa: BLE001 — mirrors the reference's catch-all
        print(f"DC solve failed: {e}", file=sys.stderr)
        return 1
    print(sim.dc_report(x))
    print("\nDC analysis finished.")

    cfg = sim.config
    tran = cfg.tran
    if tran.enabled and not args.no_tran:
        print("\nRunning transient analysis (Backward Euler)...")
        print(f"  .TRAN: tstep={tran.tstep:.6e}, tstop={tran.tstop:.6e}, "
              f"tstart={tran.tstart:.6e}")
        print(f"  output file: {args.tran_out}")
        print(f"[TRAN] tstep={tran.tstep:.6e}, tstop={tran.tstop:.6e}, "
              f"tstart={tran.tstart:.6e}")
        print(f"[TRAN] total steps = {n_steps_for(tran.tstep, tran.tstop)}")
        try:
            t0 = time.time()
            with _profiler(args, args.device):
                # a deck with .IC / UIC starts from its initial conditions
                res = sim.transient(x_op=None if cfg.ics or tran.uic else x,
                                    adaptive=args.adaptive)
                if args.device == "cuda":
                    torch.cuda.synchronize()
            wall = time.time() - t0
            if args.profile:
                print(f"Profiler trace written to '{args.profile}'.")
            sim.write_transient_csv(args.tran_out, res,
                                    probes_only=args.probes_only)
            if args.raw:
                sim.write_raw(args.raw, res, mode=_raw_mode(args))
        except Exception as e:  # noqa: BLE001
            print(f"Transient failed: {e}", file=sys.stderr)
            return 1
        print("Transient analysis (Backward Euler) finished. "
              f"Results written to '{args.tran_out}'.")
        if any(m.analysis == "tran" for m in sim.config.measures):
            try:
                print()
                print(measure_report(sim.measure(res)))
            except Exception as e:  # noqa: BLE001
                print(f".MEASURE failed: {e}", file=sys.stderr)
        if sim.config.four.enabled:
            from .analysis.fourier import fourier_table
            try:
                print()
                print(fourier_table(sim.fourier(res)))
            except Exception as e:  # noqa: BLE001
                print(f".FOUR analysis failed: {e}", file=sys.stderr)
        if args.stats:
            from .io.metadata import transient_metadata, write_metadata
            write_metadata(args.stats,
                           transient_metadata(sim, res, wall_s=wall,
                                              extra={"netlist": args.netlist}))
            print(f"Run metadata written to '{args.stats}'.")
    else:
        print("\nNo .TRAN card; transient analysis skipped.")

    if args.run_ac:
        from .analysis.ac import write_ac_csv
        print("\nRunning AC small-signal sweep...")
        try:
            acres = sim.ac(x_op=x)
            ac_sel = None
            if args.probes_only:
                from .io.csvout import probe_selection
                ac_sel = probe_selection(sim.topo, cfg.print_commands,
                                         analysis="ac") or None
            write_ac_csv(args.run_ac, sim.topo, acres, selection=ac_sel)
            if args.raw:
                sim.write_raw(args.raw, acres, mode=_raw_mode(args))
            print(f"AC sweep finished ({len(acres.freqs)} points). "
                  f"Results written to '{args.run_ac}'.")
            if any(m.analysis == "ac" for m in sim.config.measures):
                print()
                print(measure_report(sim.measure(acres, analysis="ac")))
        except Exception as e:  # noqa: BLE001
            print(f"AC failed: {e}", file=sys.stderr)
            return 1
    _small_signal_cards(sim, x)
    if args.run_noise:
        from .analysis.noise import write_noise_csv
        print("\nRunning noise analysis...")
        try:
            nres = sim.noise(x_op=x)
            write_noise_csv(args.run_noise, nres)
            print(f"noise sweep finished ({len(nres.freqs)} points). "
                  f"Results written to '{args.run_noise}'.")
        except Exception as e:  # noqa: BLE001
            print(f"noise analysis failed: {e}", file=sys.stderr)
            return 1
    if args.run_dc_sweep:
        from .analysis.sweep import write_sweep_csv
        print("\nRunning DC sweep...")
        try:
            swres = sim.dc_sweep()
            write_sweep_csv(args.run_dc_sweep, sim.topo, swres)
            if args.raw:
                sim.write_raw(args.raw, swres, mode=_raw_mode(args))
            print(f"DC sweep of {swres.source} finished "
                  f"({len(swres.values)} points). "
                  f"Results written to '{args.run_dc_sweep}'.")
            if any(m.analysis == "dc" for m in cfg.measures):
                print()
                print(measure_report(sim.measure(swres, analysis="dc")))
        except Exception as e:  # noqa: BLE001
            print(f"DC sweep failed: {e}", file=sys.stderr)
            return 1
    rc = _loop_gain_nf_group_delay(sim, args)
    if rc:
        return rc
    if args.run_mc:
        rc = _run_mc(sim, args)
        if rc:
            return rc
    if args.run_step:
        from .analysis.step import write_step_csv
        # the JAX CLI's words, stdout byte-identical
        print("\nRunning .STEP sweep (vmapped batch)...")
        try:
            sres = sim.step()
            write_step_csv(args.run_step, sim.topo, sres)
            print(f".STEP {sres.kind} {sres.name} finished "
                  f"({len(sres.values)} values, analysis={sres.analysis}). "
                  f"Results written to '{args.run_step}'.")
        except Exception as e:  # noqa: BLE001
            print(f".STEP failed: {e}", file=sys.stderr)
            return 1
    for flag, run in ((args.run_hb, _run_hb), (args.run_osc, _run_osc)):
        if flag:
            rc = run(sim, args)
            if rc:
                return rc
    if args.run_sparams:
        rc = _run_sparams(sim, args, x)
        if rc:
            return rc
    for flag, run in ((args.run_envelope, _run_envelope),
                      (args.run_hot_sparams, _run_hot_sparams),
                      (args.run_lock, _run_lock),
                      (args.run_subharmonic_lock, _run_subharmonic_lock),
                      (args.run_lssp, _run_lssp)):
        if flag:
            rc = run(sim, args)
            if rc:
                return rc
    return 0
