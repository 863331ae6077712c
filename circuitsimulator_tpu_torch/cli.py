"""Command-line entry point mirroring the reference CLI (src/main.cpp):

    python -m circuitsimulator_tpu_torch <netlist.sp> [tran_out.csv]
        [--device cuda|cpu] [--dtype f64|f32] [--no-tran] [--run-ac [CSV]]

prints the circuit summary and the DC node-voltage/branch-current tables,
then runs the Backward-Euler transient if a .TRAN card is present and
writes its CSV (default tran_out.csv); ``--run-ac`` also runs the .AC
sweep and writes its magnitude/phase CSV (default ac_out.csv).
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
    p.add_argument("--run-ac", metavar="CSV", nargs="?", const="ac_out.csv",
                   help="run the .AC small-signal sweep, write mag/phase CSV")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import torch
    from .analysis.transient import n_steps_for
    from .api import Simulator
    from .utils.options import DEFAULT_OPTIONS

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda requested but no CUDA device is "
              "available (use --device cpu)", file=sys.stderr)
        return 2
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    opts = DEFAULT_OPTIONS.replace(dtype=dtype)

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

    tran = sim.config.tran
    if tran.enabled and not args.no_tran:
        print("\nRunning transient analysis (Backward Euler)...")
        print(f"  .TRAN: tstep={tran.tstep:.6e}, tstop={tran.tstop:.6e}, "
              f"tstart={tran.tstart:.6e}")
        print(f"  output file: {args.tran_out}")
        print(f"[TRAN] tstep={tran.tstep:.6e}, tstop={tran.tstop:.6e}, "
              f"tstart={tran.tstart:.6e}")
        print(f"[TRAN] total steps = {n_steps_for(tran.tstep, tran.tstop)}")
        try:
            res = sim.transient(x_op=x)
            sim.write_transient_csv(args.tran_out, res)
        except Exception as e:  # noqa: BLE001
            print(f"Transient failed: {e}", file=sys.stderr)
            return 1
        print("Transient analysis (Backward Euler) finished. "
              f"Results written to '{args.tran_out}'.")
    else:
        print("\nNo .TRAN card; transient analysis skipped.")

    if args.run_ac:
        from .analysis.ac import write_ac_csv
        print("\nRunning AC small-signal sweep...")
        try:
            acres = sim.ac(x_op=x)
            write_ac_csv(args.run_ac, sim.topo, acres)
        except Exception as e:  # noqa: BLE001
            print(f"AC failed: {e}", file=sys.stderr)
            return 1
        print(f"AC sweep finished ({len(acres.freqs)} points). "
              f"Results written to '{args.run_ac}'.")
    if sim.config.measures or sim.config.four.enabled:
        print("note: .MEASURE/.FOUR are not yet ported; skipped",
              file=sys.stderr)
    return 0
