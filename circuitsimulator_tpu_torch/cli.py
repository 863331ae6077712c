"""Command-line entry point mirroring the reference CLI (src/main.cpp):

    python -m circuitsimulator_tpu_torch <netlist.sp> [tran_out.csv]
        [--device cuda|cpu] [--dtype f64|f32] [--no-tran] [--adaptive]
        [--method be|trap] [--run-ac [CSV]] [--run-dc-sweep [CSV]]
        [--run-mc N [--run-mc-out CSV] [--mc-sampler mc]] [--run-step [CSV]]

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
.PZ, .SENS and .TF are not yet ported: each is named on stderr and
skipped.
``--device`` defaults to cuda; on a machine without a GPU the run stops
with an error instead of moving to the CPU.
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--adaptive", action="store_true",
                   help="LTE-controlled adaptive timestep refinement "
                        "(dyadic dt ladder; output stays on the .TRAN grid)")
    p.add_argument("--method", choices=["be", "trap"], default="be",
                   help="transient integration: Backward Euler (reference "
                        "behavior, default) or trapezoidal (2nd order)")
    p.add_argument("--run-ac", metavar="CSV", nargs="?", const="ac_out.csv",
                   help="run the .AC small-signal sweep, write mag/phase CSV")
    p.add_argument("--run-dc-sweep", metavar="CSV", nargs="?",
                   const="dcsweep_out.csv",
                   help="run the .DC sweep card(s), write CSV")
    p.add_argument("--run-step", metavar="CSV", nargs="?",
                   const="step_out.csv",
                   help="run the .STEP sweep as one batch; CSV has one row "
                        "per step value (.MEASURE columns for transient "
                        "steps, node voltages for .OP steps)")
    p.add_argument("--run-mc", metavar="N", type=int, default=None,
                   help="Monte-Carlo over the netlist's DEV=/LOT= "
                        "tolerances: N lanes, one batched solve")
    p.add_argument("--run-mc-out", metavar="CSV", default="mc_out.csv",
                   help="per-lane Monte-Carlo results CSV "
                        "(default mc_out.csv)")
    p.add_argument("--mc-sampler", default="mc", choices=["mc"],
                   help="Monte-Carlo sampling plan: mc, independent draws "
                        "(the stratified lhs, sobol and antithetic plans "
                        "are not yet ported)")
    return p


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


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
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
            # a deck with .IC / UIC starts from its initial conditions
            res = sim.transient(x_op=None if cfg.ics or tran.uic else x,
                                adaptive=args.adaptive)
            sim.write_transient_csv(args.tran_out, res)
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
    else:
        print("\nNo .TRAN card; transient analysis skipped.")

    if args.run_ac:
        from .analysis.ac import write_ac_csv
        print("\nRunning AC small-signal sweep...")
        try:
            acres = sim.ac(x_op=x)
            write_ac_csv(args.run_ac, sim.topo, acres)
            print(f"AC sweep finished ({len(acres.freqs)} points). "
                  f"Results written to '{args.run_ac}'.")
            if any(m.analysis == "ac" for m in sim.config.measures):
                print()
                print(measure_report(sim.measure(acres, analysis="ac")))
        except Exception as e:  # noqa: BLE001
            print(f"AC failed: {e}", file=sys.stderr)
            return 1
    for card, on in ((".PZ", cfg.pz.enabled), (".SENS", cfg.sens.enabled),
                     (".TF", cfg.tf.enabled)):
        if on:
            print(f"note: {card} is not yet ported; skipped", file=sys.stderr)
    if args.run_dc_sweep:
        from .analysis.sweep import write_sweep_csv
        print("\nRunning DC sweep...")
        try:
            swres = sim.dc_sweep()
            write_sweep_csv(args.run_dc_sweep, sim.topo, swres)
            print(f"DC sweep of {swres.source} finished "
                  f"({len(swres.values)} points). "
                  f"Results written to '{args.run_dc_sweep}'.")
            if any(m.analysis == "dc" for m in cfg.measures):
                print()
                print(measure_report(sim.measure(swres, analysis="dc")))
        except Exception as e:  # noqa: BLE001
            print(f"DC sweep failed: {e}", file=sys.stderr)
            return 1
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
    return 0
