#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one JSON line each):
  1. device: card, power limit, torch/CUDA versions, TF32 flags; builds the
     CUDA kernels from circuitsimulator_tpu_torch/csrc with nvcc;
  2. K2 (batched pivoted LU, csrc/lu_batched.cu) against its plain PyTorch
     version on the card at the main path's shapes and at each team
     capacity's edges (N = 9, 17, 33, 64) and B = 1, f32 and f64, with
     planted pivoting, singular, below-floor and NaN lanes; kernel, plain,
     torch.linalg.solve_ex and bound times at (8192, 31, 1), (8192, 6, 1),
     (8192, 31, 31), (1, 31, 1), the T-line AC's 2N shape of phase 25 and
     the adaptive ladder's stacked G0 inverses at (9216, 31, 31) of phase
     35 (their device times are phase 28's);
  3. single lane, f64: buffer.sp through the CLI (stdout byte-identical to
     the golden, CSV within 1e-9 V), dbmixer.sp DC table and its first 500
     transient steps within 1e-9 V of the golden;
  4. the batched Monte-Carlo main path: dbmixer.sp, B = 8192 lanes, f32 fast
     configuration, batched DC then 2,000 Backward-Euler Woodbury steps in
     chunks of 500 (lane 0 nominal, held to the golden within 1e-3 V); then
     B = 1024 in f64 with the damped reference configuration;
  5. the same 64 lanes through CUDA (the kernel) and the CPU (the plain
     version), 125 f64 steps, trajectories within 1e-9 V;
  6. K1 (fused transient chunk, csrc/fused_step.cu) against its plain
     PyTorch version on the card: dbmixer 256 lanes f32 fast from x = 0
     (200 steps, 2e-4 V) and f64 damped from the DC point (100 steps,
     1e-9 V), buffer.sp and two waveform/linear decks in f64 (1e-9 V);
     failed masks identical, unrolled iteration counts equal per lane;
  7. the fused Monte-Carlo main path: dbmixer, B = 8192, f32 fast
     configuration, batched DC then 2,000 steps of K1 in chunks of 250
     (lane 0 held to the golden at every chunk boundary, final state
     against phase 4's non-fused run on the same lanes; K1 at the chunk
     shape also timed writing a (4, N) probe stream, and on every team
     and route its launch plan can take; the k1_plan line: the plan of
     that launch, its registers and shared bytes); then B = 1024 in f64,
     damped, 500 steps, within 1e-9 V of phase 4's f64 run;
  8. the AC Monte-Carlo main path (bench_ac_mc's workload): dbmixer,
     B = 4096 lanes x F = 64 frequencies (1 MHz .. 10 GHz), batched DC (K2)
     then the fused AC sweep (K3, csrc/ac_sweep.cu), f32 and f64: AC
     solves/s, one K3 launch per sweep call, no failed lane, f32 within
     1e-3 of f64, f64 within 1e-9 of the real 2N reference route on 64
     lanes; then the CLI's --run-ac on examples/cs_amp.sp and
     examples/feedback_loop.sp against the committed JAX goldens (1e-9;
     one K3 launch each);
  9. K3 against its plain PyTorch version on the card (k3_vs_plain): random
     lanes at every team capacity's edges (N = 1, 8, 9, 16, 17, 31, 32, 33,
     64; B x F = 1 x 1, 7 x 3, 300 x 8), MNA-style lanes of small integers
     and +-1 source rows where ties in |a|^2 decide the pivots (N = 4, 7,
     10, 17, 31, 40), every team capacity forced on N = 5, 9, 17, 31, and
     phase 8's dbmixer systems, f32 and f64, with a singular
     and a NaN lane (fail masks identical, lane-relative error <= 1e-12 in
     f64, <= 1e-4 in f32).  Its timings (k3_timings) run after phase 27,
     once every AC path has kept its systems: at each main-path shape
     (dbmixer 4096 x 64 x 31 of phase 8, bjt_amp 4096 x 71 x 7 of phase
     13, the charge stage 4096 x 64 x 5 of phase 16, opamp_filter 4096 x
     201 x 10 of phase 22, cs_amp's --run-ac lane 1 x 121 x 5) and on
     random lanes at N = 64: the plan (with its kernel's registers from
     the library), the plan's launch and PR 3's warp-per-system code (the
     wide route forced), both through cuda_ac.ac_sweep_cuda, plain,
     torch.linalg.solve_ex and bound times, the launches on its path;
 10. K1's junction and switch rows (K1b) against the plain version on the
     card, from each lane's batched DC point: a diode rectifier with a
     zener, an NPN + PNP deck with Early voltage, a MOS + JFET + BJT +
     diode deck and a switch + MOS + diode deck (W = 4), 256 lanes, 6-12
     steps, damped configuration, f32 (1e-4 V) and f64 (1e-9 V, per-lane
     iteration counts equal); failed masks identical; kernel and plain
     times of the mixed deck at B = 8192 x 100 steps (plain: 25 steps),
     held to its plain version over 50 steps;
 11. the fused Monte-Carlo path on a BJT deck: examples/bjt_amp.sp over its
     own .TRAN (dt 2 us, 250 steps), B = 8192 lanes f32 (resistors, bjt_is
     and bjt_bf perturbed), batched DC on K2 then one K1 chunk: lane-steps
     per second, K1 ms per chunk against plain and bound, failed lanes;
     then B = 1024 in f64 against the non-fused f64 run (1e-9 V, 125
     steps);
 12. the same on switches and a diode: examples/chopper.sp (S and W
     switches, dt 5 ns, 600 steps in chunks of 200) and examples/
     mixer_rf.sp (dt 1 ns, 2,000 steps in chunks of 500), B = 8192 f32;
 13. AC of the BJT deck: Simulator.ac and the batched sweep on bjt_amp.sp
     over its .AC card at B = 4096, f32 and f64: K3 launches, failed
     lanes, f64 against the real 2N route (1e-9) and the single lane
     against the nominal lane;
 14. K1d-i against the plain version on the card (k1d_vs_plain): the 2-MOS
     stage under MOSCAP=CHARGE (k = 12, elimination with charge rows) and
     inamp.sp (k = 22, Gauss-Jordan) from each lane's f64 DC point, and
     buffer.sp under MOSCAP=CHARGE (k = 24, Gauss-Jordan with charge rows),
     256 lanes x 8 steps, damped configuration: f32 within 1e-4 V, f64
     within 1e-10 V with equal per-lane iteration counts and failed masks.
     buffer.sp's output sits at ~1e-16 V at its DC point, where the
     model's triode charges lose every digit to cancellation (in the JAX
     package too: q_G comes out 0 there, and its Jacobian 223 F): from
     there two correct implementations differ by ~1e-3 V, so its cases
     start from x = 0, and its f64 case runs at tran_tol 1e-13 (100
     iterations; iteration counts reported, not held);
 15. the fused Monte-Carlo path on inamp.sp (22 MOS, N = 28, k = 22): B =
     8192 f32, fast configuration, f64 batched DC, its .TRAN (1 ns, 2,000
     steps) in chunks of 250: lane-steps/s, K1 ms per chunk against plain
     and bound, failed lanes; then B = 1024 in f64, damped, one chunk of
     125 steps against the non-fused loop (1e-9 V);
 16. the fused Monte-Carlo path on the charge decks: the 2-MOS stage (1 ns,
     1,000 steps in chunks of 250) and buffer.sp under MOSCAP=CHARGE (its
     .TRAN, 300 steps in chunks of 100, from x = 0: the power-up
     transient; its failed lanes are counted, not held to zero, see phase
     14), B = 8192 f32 damped; then B = 1024 in f64 against the non-fused
     loop (1e-9 V; the 2-MOS stage 30 steps from its DC point, buffer.sp
     15 steps from x = 0 at tran_tol 1e-13); then
     the AC of the 2-MOS stage at B = 4096 x F = 64 (its charge trans-caps
     in B1), f32 and f64, f64 against the real 2N route (1e-9);
 17. K1d-ii, the B-source rows, against the plain version on the card
     (k1d_ii_vs_plain): the B deck of tests/test_pallas_step.py (an I-form
     source with a .PARAM, a V-form source with a time term, a diode),
     examples/behavioral.sp (W = 4) and examples/sdomain_filter.sp
     (POLY(3) sources, W = 6), 256 lanes x 10 steps from each lane's f64
     DC point, damped configuration, resistors and b_consts perturbed: f32
     within 1e-4 V, f64 within 1e-9 V with equal per-lane iteration counts;
 18. the fused Monte-Carlo path on behavioral.sp over its own .TRAN (2 ns,
     5,000 steps in chunks of 250), B = 8192 f32 damped from an f64 DC:
     lane-steps/s, K1 ms per chunk against plain (25 steps) and bound,
     failed lanes; then B = 1024 in f64 against the non-fused loop (1e-9 V,
     100 steps);
 19. the CLI on B-source decks (cli_bsource): behavioral.sp in f64 on the
     card, its DC table byte-identical to the JAX CLI's
     (tests/goldens/behavioral_stdout_jax.txt) and its CSV within 1e-9 V of
     the first 501 rows of tests/goldens/behavioral_tran_jax.csv (its
     .TRAN cut to 500 of its 5,000 steps in a staged copy); then
     --no-tran --run-ac on sdomain_filter.sp against
     tests/goldens/sdomain_filter_ac_jax.csv
     (1e-9);
 20. .NODESET (nodeset): inamp.sp's f64 CLI DC (--no-tran) runs to its end
     on the card.  Phase 15's float32 lanes start as
     benchmarks/bench_inamp.py does: the nominal f64 DC with the deck's
     .NODESET card, then the warm batched DC (batched_dc_warm);
 21. K1c-i, K1's probe stream, against the plain version on the card
     (k1c_i_vs_plain): a (4, N) probe matrix of +1/-1 pairs on one deck per
     instantiation family (dbmixer, bjt_amp, inamp, behavioral.sp), 256
     lanes x 8 steps from each lane's f64 DC point, damped configuration:
     f64 within 1e-9 V with equal per-lane iteration counts, f32 within
     1e-4 V, the last probe tile bit-equal to probe_mat @ x_out, and the
     same carry as the kernel without probes;
 22. the Monte-Carlo measurement path (monte_carlo_measures_*):
     Simulator.monte_carlo(8192) on examples/mc_filter.sp in f32 (K1 with
     its probe stream, then the streaming accumulators): K1 launches,
     failed lanes, lane-steps/s, K1 (with and without probes), accumulator,
     plain and bound ms per chunk, and at each deck's chunk shape K1 with
     its probe stream against the plain version (1e-4 V over the carry and
     the probe block, the same failed lanes, the last probe tile bit-equal
     to probe_mat @ x_out); fused against the non-fused loop on
     1,024 lanes in f32 (rtol 2e-4, atol 2e-6) and f64 (rtol 1e-9);
     bjt_amp's vout_pp at B = 8192 from an f64 DC; rc_step's WHEN
     crossings at B = 8192 over 2,000 steps; batched_ac_measures on
     examples/opamp_filter.sp at B = 4096 (K3); and the CLI's --run-mc
     8192 --dtype f32 on mc_filter;
 23. the CLI's .MEASURE output on the card (cli_measures): rc_step.sp,
     mc_filter.sp and bjt_amp.sp with --run-ac (its .MEASURE TRAN, AC and
     .TF blocks) byte-identical to the JAX CLI's stdout
     (tests/goldens/{rc_step,mc_filter,bjt_amp_run_ac}_stdout_jax.txt);
 24. K1c-ii, K1's delay ring, against the plain version on the card
     (k1c_ii_vs_plain): the diode-clamp T-line deck of
     tests/test_pallas_step.py (K1b), examples/tline_reflect.sp (k = 0),
     examples/delay_osc.sp with a .TRAN 0.1n 40n card (the B
     instantiation, each lane kicked off its rest point) and the charge
     stage with a 50-ohm line at its output (K1d-i), 256 lanes from each
     lane's f64 DC point, Rs and Z0 perturbed, two launches in a row so
     the ring crosses a launch boundary: f64 within 1e-9 V over x and
     the ring with equal per-lane iteration counts, f32 within 1e-4 V,
     the ring at launch exit in the Engine's layout (slots 0 and 1 the
     waves of x and x_prev, bit for bit);
 25. the T-line main paths (monte_carlo_tline_*, ac_tline_*):
     batched_transient on benchmarks/bench_tline_fused.py's workload at
     B = 8192 in f32 (4,000 steps of 0.25 ns, the damped configuration:
     the benchmark's fast one is recorded beside it, K1 against its plain
     version after 100 steps and K1's ms, and not held, since on the
     diode clamp two correct implementations part by volts): K1
     launches, failed lanes, lane-steps/s, K1 kernel, plain and bound ms
     per 2,000-step chunk; fused against non-fused on 1,024 lanes over
     400 steps (f32 damped atol 5e-5, f64 1e-9);
     batched_transient_measures on tline_reflect.sp at B = 8192, Rs
     perturbed 2% (K1 with its probe stream and its ring; lane 0 held to
     the JAX CLI's measures within 1e-4); the matched line's AC at
     B = 1024 x F = 64 through K2 (K3 launched 0 times), lane 0 against
     the exact line (f32 1e-4, f64 1e-9);
 26. the CLI on tline_reflect.sp on the card (cli_tline): stdout
     byte-identical to tests/goldens/tline_reflect_stdout_jax.txt, CSV
     within 1e-9 V of tests/goldens/tline_reflect_tran_jax.csv;
 27. TRNOISE (trnoise_*, k1c_iii_vs_plain): the torch threefry on the card
     against the JAX-made tests/goldens/trnoise_stream_jax.csv (lanes 0-3
     of split(key(123), 8192), white + flicker, 64 steps: hold indices and
     bits equal, normals within 2 ulp, the stream within 1e-5 of its
     largest value); K1c-iii (the noise block) against the plain version
     on benchmarks/bench_trnoise.py's noisy dbmixer from each lane's DC
     point with the run's own noise block, B = 8192: f64 damped 25 steps
     (1e-12 V, per-lane iteration counts equal), f32 fast 250 steps, the
     benchmark's configuration (2e-4 V, phase 7's bar, the noise-free
     twin's error beside; K1 with and without noise, plain, stream and
     bound ms), and the white V + I noise deck of
     tests/test_trnoise_fused.py in f32 damped, 100 steps (5e-5 V);
     failed masks equal; fused against non-fused noisy runs on 1,024
     lanes with the same keys over 200 steps on the white V + I noise
     deck
     of tests/test_trnoise_fused.py (f32 damped 5e-5 V, f64 1e-9 V) and
     on the noisy dbmixer (f64 1e-9 V; f32 over 100 steps recorded beside
     the noise-free gap, which part by the same 2e-4 V at 400 steps on the
     H100); the
     noisy dbmixer at B = 8192, f32 fast, 10,000 steps against its
     noise-free twin: lane-steps/s, K1 and stream ms per 2,000-step chunk,
     K1's bound at the chunk's Newton iterations, no failed lane;
 28. K2's and torch.linalg.solve_ex's device time at phase 2's timed
     shapes, from a torch.profiler trace (k2_device_times), then K1's at
     dbmixer's main shape, phase 7's launch (k1_device_time), then K3's and
     PR 3's code's at every shape of k3_timings and solve_ex's at the main
     one (k3_device_times).  It runs last: a profiler session leaves every
     later launch in the process slower (on the H100 a K2 call's host time
     went from 25 to 48 us).
 29. mutual inductance (K1e, mutual_*, monte_carlo_fused_{xfmr,rectifier}_*,
     k1e_vs_plain, ac_xfmr_*): examples/xfmr.sp's single lane in f64 on
     the card (DC, 500 transient steps, its .AC sweep on K3) within 1e-9
     V of the port on the CPU; the fused Monte-Carlo main path
     (batched_transient, f32 damped from an f64 batched DC) at B = 8192
     over the deck's whole .TRAN (5,000 steps, chunks of 2,000) on xfmr
     (k = 0) and on a transformer-coupled half-wave rectifier (the
     secondary with a diode and an RC load, k = 1), inductors, couplings
     and resistors perturbed from a numpy seed: lane-steps/s, K1 launches,
     failed lanes, K1 at the chunk shape against its plain version (2e-4
     V over 250 steps on xfmr, 100 on the rectifier) with its times and
     bound; K1e against its plain version at 256 lanes (f32 2e-4 V over
     100 steps, f64 1e-9 V over 200 with equal iteration counts); the f64
     fused run within 1e-9 V of the non-fused loop on 1,024 lanes x 300
     steps; xfmr's AC Monte-Carlo at 4096 x 41 on K3, f32 within 1e-3 of
     f64 (its shape joins k3_timings);
 30. the .DC sweep (dc_sweep_*): --run-dc-sweep on mos_family.sp (the
     nested grid) and on diode_temp.sp (with --run-step, as the golden was
     made) against the JAX CLI's stdout and CSVs (1e-9); dbmixer's Vdd over
     8,192 points from 0 to 3.3 V through Simulator.dc_sweep, one batched
     DC on K2 at (8192, 31, 1) in f64: points/s, Newton iterations (one K2
     launch each), K2's share of the wall, failed points, every 64th point
     within 1e-9 V of the port's f64 sweep on the CPU with equal fail
     masks;
 31. .STEP (step_*): --run-step on rc_step.sp against the JAX CLI's stdout
     and CSV (1e-9), and the same sweep waveform-free in f32
     (Simulator.step(save_xs=False): K1 with its probe stream) against the
     CSV (rtol 1e-4);
 32. .IC / UIC (ic_transients_f64): the UIC and .IC decks of
     tests/test_torch_ic.py (tests/test_ic.py's decks but the adaptive
     one) in f64 on the card, within 1e-12 V of the port on the CPU.
 33. METHOD=TRAP (trap_*): buffer.sp through the CLI with --method trap in
     f64 against the JAX CLI's goldens (stdout byte-identical, CSV within
     1e-9 V); dbmixer at B = 8192, f32 damped, trapezoidal: the batched DC
     (K2) then 500 non-fused Woodbury steps in chunks of 250
     (ChunkedTransient's loop): lane-steps/s, K2 launches, failed lanes,
     and the Backward-Euler rate of the same lanes over 125 steps before
     and after it; B =
     1024 in f64 over 100 steps, 64 of the lanes within 1e-9 V of the
     CPU at every 50th step; tests/test_trap.py's MOS + L + C deck under
     MOSCAP=CHARGE (the trapezoidal charge currents) within 1e-9 V of the
     CPU over 50 steps;
 34. the dense lu transient solver (lu_solver_*): dbmixer at B = 8192 f32
     damped, BE and TRAP, 200 steps, K2 at (8192, 31, 1) on every Newton
     iteration (launches and ms per step); B = 1024 f64 TRAP, lu within
     1e-9 V of woodbury on the same lanes, the mixed refinement (f32 K2
     around an f64 residual) within 1e-6 V of the f64 lu run (its gap);
 35. the adaptive dyadic-LTE integrator (adaptive_*): dbmixer's single
     lane in f64, Simulator.transient(adaptive=True) over 500 output
     intervals, on the card and on the CPU (equal substep, rejection and
     Newton counts, rows within 1e-9 V); B = 1024 perturbed f64 lanes over
     200 intervals (the 9 levels' G0 inverses as one K2 launch at (9216,
     31, 31), timed in phase 2), lanes 0 and 1 within 1e-12 V of their own
     single-lane runs with equal counts;
 36. checkpoint/resume (checkpoint_*): phase 33's dbmixer run and the noisy
     dbmixer (TRNOISE, one key per lane; its uninterrupted run here), 500
     steps each, each run again stopped after the first 250-step chunk,
     written to .npz and resumed by a new ChunkedTransient: torch.equal on
     x, failed and every state entry; file size, save and load times.
 37. the small-signal stack (small_signal_*): the JAX CLI's three
     small-signal runs on the card (bjt_amp.sp --no-tran --run-ac
     --run-noise --run-noise-figure Rs --run-group-delay c --raw;
     cs_amp.sp --run-ac --connectivity --run-sparams d@50, its .TF and
     .SENS blocks; feedback_loop.sp --run-loop-gain E1 --run-group-delay
     out) with stdout byte-identical to the goldens and every CSV, the
     rawfile and the Touchstone file within 1e-9 of each column's peak
     (1e-8 for the group delay); every API analysis in f64 on the card
     against the port on the CPU, 1e-9 relative (1e-8 for the group
     delay): noise, noise figure, loop gain, group delay, S-parameters
     (the 10 dB pad's two ports as two K3 lanes, cs_amp's one port),
     the stability metrics, .TF, .SENS (the adjoint on K2 and autograd
     on CUDA tensors), .PZ, and noise, loop gain and group delay on
     T-line decks (K2; dY/dw by forward-mode AD on the card); K3 launches
     per analysis held (noise 1, loop gain 1, S-parameters 1, group delay
     2, none on T-line decks) and K2's counted; K3 against its plain
     version at the adjoint (1, F, N) and n-port (2, F, N) shapes (fail
     masks identical, f64 lane-relative error <= 1e-12), their timings in
     k3_timings and phase 28.
 38. the statistical and differentiation stacks (statistics_*), through
     Simulator's entry points: examples/mc_filter.sp's yield (R 5%, C 10%,
     specs on settle and vfinal, about 70% passing) under the four
     sampling plans in f32 at B = 8192 (K1 with its probe stream) and
     under "mc" in f64 (the non-fused loop), each held against the port's
     f64 CPU run of its first 256 lanes (f64: measures 1e-9 relative and
     pass masks equal; f32: rtol 2e-4, atol 2e-6 against f64 in the same
     configuration); examples/high_sigma.py's flow on its inverter: LHS
     yield, scaled-sigma IS (s = 2.5) and IS centred on z* in f32 on K1,
     FORM on the f64 adjoint (K2), beta within 1e-8 of the CPU's; Sobol
     indices of mc_filter at n = 1024 (6,144 lanes on K1) and of
     bjt_amp's .MEASURE AC f3db at n = 512 (K3; the lanes' sweep and the
     host's per-lane measures timed apart); inamp.sp's DC worst case
     (VT of its 22 MOSFETs, output within 1.0-1.9 V) and bjt_amp's AC one
     (f3db above 134.5 MHz; the differentiable 2N solve on K2 at (71, 14,
     1)) with their mismatch budgets, beta within 1e-8 of the CPU's and
     the top five contributions equal; three Adam steps of calibrate and
     fit_measures on mc_filter (a 250-step adjoint each), the loss history
     within 1e-8 of the CPU's; the adjoint's ms a step forward and
     backward; K2 against its plain version at (1, 28, 1) transposed and
     (71, 14, 1) forward and backward, with per call, plain, solve_ex and
     bound times.  The CPU references run in worker processes beside the
     card's work.
     Phases 29-38 run after phase 27 and before k3_timings and phase 28;
     the total line gives each phase's wall seconds.
 39. large_circuit: the large-circuit backends through Simulator's entry
     points in bench_ladder.py's fast f32 configuration: the 10,000-node
     RC ladder with 1,000 diodes (tridiag, PCR) single lane for 500 steps
     and over 256 Monte-Carlo lanes for 100 (the batched DC on the ladder's
     CR, the non-fused batched transient: K1 refuses N > 64), the 100 x
     100 grid through blockband and blockwb (Woodbury rank 500, its k x k
     solve on the large-N route) for 100 steps each: steps/s, Newton
     iterations a step, K2 launches and large-N route calls; a 2,000-node
     ladder and a 30 x 30 grid (blockband and blockwb) in f64 within 1e-9
     V of the port's CPU runs (worker processes); the large-N route
     (lu_solve_large) against lu_solve_plain at (64, 130, 1) and (1, 500,
     1) with a singular lane; K2 at the Schur corner's shapes.

Every error of K3 and of the AC path is lane-relative: for each lane
max|x - ref| / max|ref| over its frequencies and unknowns, then the worst
lane.  Kernel launch counts are reset just before each main-path run
(phases 4, 7, 8, 11, 12, 13, 15, 16, 18, 22, 25, 27 and 29-39) and read
just after it.  The
junction decks run the damped while-loop Newton configuration at f32
tolerances: the fast configuration (alpha 1, predictor, two unrolled
iterations) was tuned on dbmixer and is not held to anything on
exponential devices.  The last lines are the
kernels JSON, the card's name and power limit, and {"ok": true,
"device": {...}}.  There is no fallback: without a GPU, or if any build,
launch or check fails, the script exits non-zero without the last line.
"""

import contextlib
import concurrent.futures
import copy
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
NETLISTS = os.path.join(REPO, "tests", "netlists")
GOLDENS = os.path.join(REPO, "tests", "goldens")
SIGMAS = {"res_r": 0.01, "mos_vth": 0.02, "cap_c": 0.02}
# the junction and switch decks also vary their devices
JUNCTION_SIGMAS = {**SIGMAS, "bjt_is": 0.05, "bjt_bf": 0.05, "dio_is": 0.05,
                   "sw_ron": 0.02}
EXAMPLES = os.path.join(REPO, "examples")
FLOOR = 1e-15
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

# every waveform kind with a MOS load, and a linear RLC deck (k = 0); the
# decks of tests/test_pallas_step.py
WAVEFORM_DECK = """* all source kinds
.MODEL 2 VT 0.386 MU 3.0238e-2 COX 6.058e-3 LAMBDA 0.05 CJ0 4.0e-14
VDD 1 0 DC 3
Vp 2 0 PULSE(0 1.5 10n 5n 5n 40n 100n)
Vw 3 0 PWL(0 0 20n 1 50n 0.4 80n 1.2)
Ve 4 0 EXP(0 2 5n 10n 60n 15n)
Rp 2 5 1k
Rw 3 5 2k
Re 4 5 2k
Is 0 5 SFFM(1m 0.5m 2e7 2 3e6)
Ip 0 6 PULSE(0 1m 0 0 0 50n 120n)
R6 6 0 1k
M1 7 5 0 n 10e-6 0.35e-6 2
RL 1 7 2k
C1 7 0 1p
.op
"""

# every linear controlled source around a MOS stage (K1a scope, k = 1);
# the deck of tests/test_torch_ctrl.py
MOS_CTRL_DECK = """* MOS stage with E/G/F/H
.MODEL 2 VT 0.386 MU 3.0238e-2 COX 6.058e-3 LAMBDA 0.05 CJ0 4.0e-14
VDD 1 0 DC 3
Vin 2 0 SIN 0.6 0.2 5e6
R1 2 3 1k
C3 3 0 0.2p
E1 4 0 3 0 1.5
M1 5 4 0 n 10e-6 0.35e-6 2
RL 1 5 5k
C1 5 0 1p
G1 0 6 5 0 1m
R6 6 0 2k
C6 6 0 0.5p
Vs 6 7 DC 0
R7 7 0 1k
F1 0 8 Vs 2
R8 8 0 1k
L8 8 0 10u
H1 9 0 Vs 100
R9 9 0 1k
.op
"""

LINEAR_DECK = """* linear RLC filter
V1 in 0 SIN 0 1 2e6
I1 0 mid PULSE(0 1m 0 0 0 100n 250n)
R1 in a 1k
L1 a mid 10u
C1 mid 0 100p
R2 mid out 2k
C2 out 0 50p
RL out 0 10k
.op
"""


# the junction and switch decks of tests/test_pallas_step.py, with the
# timestep each is run at
DIODE_DECK = """* diode rectifier + zener
V1 in 0 SIN 0 4 5e6
R1 in a 100
D1 a out
C1 out 0 1n
R2 out 0 10k
RBD in bd 500
D2 0 bd BV=3 IBV=1e-3
.op
"""

BJT_DECK = """* npn + pnp stages
.MODEL qn NPN IS=1e-15 BF=120 BR=2 VAF=50
.MODEL qp PNP IS=1e-15 BF=80 BR=1
VCC 1 0 5
Vin 2 0 SIN 0.65 0.01 1e6
RB 2 3 10k
RC 1 4 2k
Q1 4 3 0 qn
VB2 5 0 DC 4.3
RB2 5 6 10k
RC2 7 0 2k
Q2 7 6 1 qp
CL 4 0 1p
.op
"""

MIXED_DECK = """* mixed nonlinear classes
.MODEL 2 VT 0.386 MU 3.0238e-2 COX 6.058e-3 LAMBDA 0.05 CJ0 4.0e-14
.MODEL j1 NJF VTO=-2 BETA=1e-3 LAMBDA=0.01
.MODEL qn NPN IS=1e-15 BF=120 BR=2
VDD 1 0 DC 3
Vin 2 0 SIN 0.8 0.2 5e6
M1 3 2 0 n 10e-6 0.35e-6 2
RL1 1 3 2k
J1 4 2 0 j1
RL2 1 4 2k
RB 2 7 20k
Q1 5 7 0 qn
RL3 1 5 2k
D1 6 0
RD 1 6 1k
C1 3 0 1p
.op
"""

SWITCH_DECK = """* switch chopper + mixed classes
.MODEL swm SW RON=10 ROFF=1e8 VT=0.5 VH=0.1
.MODEL mn VT 0.6 MU 2e-2 COX 1e-3
VCTL c 0 PULSE 0 1 0 1u 1u 8u 20u
VIN in 0 SIN 0 2 5e4
S1 in mid c 0 swm
RL mid 0 1k
C1 mid 0 100n
M1 mid g 0 b mn W=5u L=1u
VG g 0 0.8
D1 mid 0
.op
"""

# the 2-MOS stage under the charge model (tests/test_pallas_step.py): k = 12
CHARGE_DECK = """* charge-model CMOS stage
.OPTIONS MOSCAP=CHARGE
.MODEL 1 VT -0.75 MU 5e-2 COX 0.3e-4 LAMBDA 0.05 CJ0 4.0e-14
.MODEL 2 VT 0.83 MU 1.5e-1 COX 0.3e-4 LAMBDA 0.05 CJ0 4.0e-14
VDD 1 0 3
Vin 2 0 SIN 1.5 0.5 5e6
M1 3 2 1 p 30e-6 0.35e-6 1
M2 3 2 0 n 10e-6 0.35e-6 2
C1 3 0 0.5p
RL 3 0 10k
.op
"""
# the same stage with its input as the AC source
CHARGE_AC_DECK = CHARGE_DECK.replace("Vin 2 0 SIN 1.5 0.5 5e6",
                                     "Vin 2 0 DC 1.4 AC 1")

# the B-source deck of tests/test_pallas_step.py: an I-form source with a
# .PARAM, a V-form source with a time term, and a diode
B_DECK = """* behavioral multiplier + limiter + diode
.PARAM gain=1m
V1 a 0 SIN 0 1 1e4
V2 b 0 SIN 0 1 1.3e4
R1 a 0 1k
R2 b 0 1k
B1 p 0 I=v(a)*v(b)*gain
RP p 0 1k
B2 q 0 V=tanh(v(p)*2)+0.1*sin(6.28e4*time)
RQ q 0 2k
C1 q 0 10n
D1 q 0 IS=1e-14
.op
"""
# B-source decks vary their resistors and the .PARAM values the
# expressions read
B_SIGMAS = {"res_r": 0.01, "b_consts": 0.05}

# transmission lines (K1c-ii): the diode-clamp deck of tests/test_pallas_step
# .py, and with a 14 ns pulse period the workload of
# benchmarks/bench_tline_fused.py; the matched line of tests/test_tline.py
# with an AC source; the charge stage with a 50-ohm line at its output
TL_DECK = """* T-line reflections + diode clamp at the far end
V1 in 0 PULSE(0 1 1n 0.2n 0.2n 6n 0)
RS in a 50
T1 a 0 b 0 Z0=50 TD=2n
RL b 0 200
D1 b 0
.op
"""
TL_BENCH_DECK = TL_DECK.replace("6n 0)", "6n 14n)")
TL_AC_DECK = """* ac matched line
V1 src 0 DC 0 AC 1
Rs src in 50
T1 in 0 out 0 Z0=50 TD=10n
Rl out 0 50
.AC lin 5 1e6 9e6
"""
CHARGE_TL_DECK = CHARGE_DECK.replace(".op", """T1 3 0 4 0 Z0=50 TD=5n
RT 4 0 1meg
.op""")
TL_SIGMAS = {"res_r": 0.02, "tl_z0": 0.02, "dio_is": 0.05}

K1B_DECKS = (("diode + zener", DIODE_DECK, 1e-9, 6),
             ("npn + pnp", BJT_DECK, 1e-9, 6),
             ("mos + jfet + bjt + diode", MIXED_DECK, 1e-9, 6),
             ("switch + mos + diode", SWITCH_DECK, 1e-7, 12))


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"check failed: {what}")


def golden_rows(name, rows):
    import numpy as np
    return np.loadtxt(os.path.join(GOLDENS, name), delimiter=",",
                      skiprows=1, max_rows=rows)


def read_golden(name):
    with open(os.path.join(GOLDENS, name)) as f:
        return f.read()


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def fast_f32_options():
    """bench.py's Monte-Carlo fast configuration."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    return DEFAULT_OPTIONS.replace(
        dtype=torch.float32, tran_tol=1e-5, dc_tol=1e-5, tran_alpha=1.0,
        tran_predictor=True, tran_max_newton_iters=6, tran_unrolled_iters=2)


def damped_f32_options():
    """The damped while-loop Newton configuration at f32 tolerances."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    return DEFAULT_OPTIONS.replace(dtype=torch.float32, tran_tol=1e-5,
                                   dc_tol=1e-5)


def ref_f32_options():
    """The reference configuration (damped Newton, tran_tol 1e-6) in f32:
    its nominal lane can be held to the JAX CLI's f64 numbers."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    return DEFAULT_OPTIONS.replace(dtype=torch.float32)


def bound_ms(nbytes, flops, dtype):
    """Least time on the card: bytes over HBM rate, operations over the
    non-tensor peak of the type; returns (ms, "bytes" | "operations")."""
    tb, to = nbytes / HBM_BPS, flops / PEAK_FLOPS[str(dtype)[6:]]
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def cuda_ms(fn, reps=20, warmup=3):
    """Median of `reps` CUDA-event timings of fn(), after synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=10):
    """Device time per call of fn(): the kernels it launches, summed from a
    torch.profiler (CUPTI) trace of `reps` calls; None if the trace shows
    no device time.  Beside cuda_ms it tells the kernels' time from the
    host's launch overhead.  Call it only after every other timing: the
    session leaves the process's later launches slower."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a session now and then reports no events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages())
        if us > 0:
            return us / reps / 1e3
    return None


# ---------------------------------------------------------------- phase 1
def phase_device():
    import torch
    from circuitsimulator_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    names = ("lu_batched", "fused_step", "ac_sweep")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(_build.load, names)))
    build_wall = time.perf_counter() - t0
    # per kernel (and per instantiation of K1: float32 and float64 with
    # G0^-1 in shared memory and float32 with it in registers, each for the
    # K1a/K1b rows, the charge rows and the B rows): its properties line
    # and registers line
    ptxas = {n: [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "stack frame" in ln
                 or "Function properties for" in ln]
             for n, b in built.items()}
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32,
         build_seconds={n: b.seconds for n, b in built.items()},
         build_wall_seconds=build_wall, ptxas=ptxas)
    return card


# ---------------------------------------------------------------- phase 2
def _systems(B, N, R, dtype, seed):
    """Well-conditioned lanes, rows permuted so every lane must pivot; with
    B > 4 lane 1 is singular, lane 2 below the floor, lane 3 holds a NaN."""
    import torch
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, N, N, generator=g, dtype=torch.float64) / N ** 0.5
    A += 2.0 * torch.eye(N, dtype=torch.float64)
    perm = torch.argsort(torch.rand(B, N, generator=g), dim=1)
    A = A.gather(1, perm[:, :, None].expand(B, N, N))
    b = torch.randn(B, N, R, generator=g, dtype=torch.float64)
    if B > 4:
        A[1] = 0.0
        A[2] *= 1e-17
        A[3, N // 2, 1] = float("nan")
    return A.to(dtype).cuda(), b.to(dtype).cuda()


def _lane_masks(x):
    flat = x.reshape(x.shape[0], -1)
    return (flat == 0).all(1), flat.isnan().any(1)


def _lane_rel_err(x, ref, good=None):
    """Worst lane of max|x - ref| / max|ref| over all but the lane axis,
    among the lanes in `good` (all by default)."""
    import torch
    d = (x - ref).abs().amax(dim=(1, 2))
    s = ref.abs().amax(dim=(1, 2)).clamp_min(1e-30)
    if good is None:
        return float((d / s).max())
    return float(torch.where(good, d / s, 0.0).max())


def phase_k2():
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.analysis import ac as tac
    from circuitsimulator_tpu_torch.ops import cuda_lu, lu
    # the main path's shapes, then each team capacity's edges (N = 9: 16
    # threads, 17: a warp, 33 and 64: two warps), the single-lane DC and
    # the adaptive ladder's stacked G0 inverses
    cases = [(8192, 31, 1), (8192, 6, 1), (1024, 31, 31), (1, 4, 1),
             (2048, 9, 9), (2048, 17, 3), (1024, 33, 33), (512, 64, 64),
             (1, 31, 1), (9216, 31, 31)]
    results = []
    max_abs = 0.0
    for B, N, R in cases:
        for dtype in (torch.float64, torch.float32):
            A, b = _systems(B, N, R, dtype, seed=B + N + R)
            x = lu.lu_solve(A, b, FLOOR)
            ref = lu.lu_solve_plain(A, b, FLOOR)
            torch.cuda.synchronize()
            zk, nk = _lane_masks(x)
            zp, nz = _lane_masks(ref)
            check(torch.equal(zk, zp), f"zero-lane mask B={B} N={N}")
            check(torch.equal(nk, nz), f"NaN-lane mask B={B} N={N}")
            if B > 4:
                check(bool(zk[1] and zk[2] and nk[3]), "planted lanes")
            good = ~(zp | nz)
            max_abs = max(max_abs, float((x - ref).abs()[good].max()))
            row = {"B": B, "N": N, "R": R, "dtype": str(dtype)[6:]}
            if dtype == torch.float64:
                rel = _lane_rel_err(x, ref, good)
                check(rel <= 1e-12, f"f64 rel err {rel} B={B} N={N} R={R}")
                row["max_rel_err_vs_plain"] = rel
            else:
                A64, b64 = A.double(), b.double()
                exact = lu.lu_solve_plain(A64, b64, FLOOR)
                ek = _lane_rel_err(x.double(), exact, good)
                ep = _lane_rel_err(ref.double(), exact, good)
                check(ek <= 4.0 * ep, f"f32 kernel err {ek} > 4x plain {ep}")
                row["err_vs_f64"] = ek
                row["plain_err_vs_f64"] = ep
            if R > 1:
                one = lu.lu_solve(A, b[..., -1:].contiguous(), FLOOR)
                last = x[..., -1:]
                same = (one == last) | (one.isnan() & last.isnan())
                check(bool(same.all()), "column bitwise == single-RHS solve")
            results.append(row)
    # times at the main path's shapes: batched DC (N=31), Woodbury k x k
    # (k=6), the per-chunk G0 inverse (R=N=31), all B=8192; the single-lane
    # DC (B=1); the T-line AC's real 2N systems as phase 25 launches them
    # (1,024 lanes x the frequencies of one block, analysis/ac._tline_sweep)
    # torch.linalg.solve_ex computes the same function (without the pivot
    # floor's fail contract; _ex: the planted singular lanes do not raise):
    # timed as a yardstick only
    n_tl = _sim(DEFAULT_OPTIONS, TL_AC_DECK).engine.N
    tl_lanes = 1024 * min(64, max(1, tac._TL_BLOCK_ELEMS
                                  // (4 * n_tl * n_tl * 1024)))
    # (9216, 31, 31): the adaptive ladder's 9 levels x 1,024 lanes of G0
    # inverses in one launch (phase 35)
    timings = []
    for B, N, R in [(8192, 31, 1), (8192, 6, 1), (8192, 31, 31), (1, 31, 1),
                    (tl_lanes, 2 * n_tl, 1), (9216, 31, 31)]:
        for dtype in (torch.float32, torch.float64):
            A, b = _systems(B, N, R, dtype, seed=7)
            size = A.element_size()
            pl = cuda_lu.plan(N, R, size)     # the launch's block shape
            # read A and b once, write x once; LU with R right-hand sides
            nbytes = B * (N * N + 2 * N * R) * size
            flops = B * sum(m + 2 * m * m + 2 * m * R + (2 * m + 1) * R
                            for m in range(N))
            bms, by = bound_ms(nbytes, flops, dtype)
            timings.append({
                "B": B, "N": N, "R": R, "dtype": str(dtype)[6:],
                "kernel_ms": cuda_ms(lambda: lu.lu_solve(A, b, FLOOR)),
                "plain_ms": cuda_ms(lambda: lu.lu_solve_plain(A, b, FLOOR)),
                "library_ms": cuda_ms(lambda: torch.linalg.solve_ex(A, b)),
                "bound_ms": bms, "bound_by": by,
                "launch": {"cap": pl.cap, "threads": pl.threads,
                           "smem_bytes": pl.smem}})
    emit("k2_vs_plain", cases=results, timings=timings, max_abs_err=max_abs)
    return max_abs, timings


def phase_k2_device(timings, k1):
    """Phase 28: device times of K2 and of the library call at phase 2's
    timed shapes, on the same inputs; then K1's at dbmixer's main shape
    (B = 8192, 250 steps, f32 fast, phase 7's runner and carry)."""
    import torch
    from circuitsimulator_tpu_torch.ops import lu
    rows = []
    for row in timings:
        dtype = getattr(torch, row["dtype"])
        A, b = _systems(row["B"], row["N"], row["R"], dtype, seed=7)
        rows.append({**{k: row[k] for k in ("B", "N", "R", "dtype")},
                     "kernel_device_ms": device_ms(
                         lambda: lu.lu_solve(A, b, FLOOR)),
                     "library_device_ms": device_ms(
                         lambda: torch.linalg.solve_ex(A, b))})
    emit("k2_device_times", timings=rows)
    runner, carry = k1
    k1_ms = device_ms(lambda: runner.run_chunk(*carry, 2000, 250), reps=3)
    emit("k1_device_time", deck="dbmixer",
         shape="B=8192 x 250 steps f32 fast", kernel_device_ms=k1_ms,
         plan=k1_plan_row(runner))
    return rows, k1_ms


def phase_k3_device(k3_rows):
    """Phase 28, last: K3's device time at every shape of k3_timings, PR
    3's code's (the wide route forced) where the plan takes a team, and
    torch.linalg.solve_ex's at the main one."""
    import torch
    from circuitsimulator_tpu_torch.ops import cuda_ac
    t0 = time.perf_counter()
    out = []
    for row in k3_rows:
        G, B1, br, bi, om = K3_SHAPES[row["shape"]]["inputs"]
        d = {"kernel_device_ms": device_ms(
            lambda: cuda_ac.ac_sweep_cuda(G, B1, br, bi, om, FLOOR))}
        if row["plan"]["cap"] < 64:
            d["pr3_warp_per_system_device_ms"] = device_ms(
                lambda: cuda_ac.ac_sweep_cuda(G, B1, br, bi, om, FLOOR,
                                              team=64))
        if row["shape"] == K3_MAIN:
            B, n, F = G.shape[0], G.shape[1], om.shape[0]
            A = torch.complex(G[:, None].expand(B, F, n, n),
                              om[None, :, None, None] * B1[:, None]).reshape(
                                  B * F, n, n)
            rhs = torch.complex(br, bi)[:, None].expand(B, F, n).reshape(
                B * F, n, 1)
            d["library_device_ms"] = device_ms(
                lambda: torch.linalg.solve_ex(A, rhs))
            del A, rhs
        out.append(d)
    emit("k3_device_times", shapes=[{"shape": r["shape"], **d}
                                    for r, d in zip(k3_rows, out)],
         seconds=time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------- phase 3
def phase_single_lane():
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import Simulator, cli
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    here = os.getcwd()
    try:
        # the goldens name the deck and the CSV relative to the cwd
        os.makedirs(os.path.join(tmp, "tests", "netlists"))
        for deck in ("buffer", "dbmixer"):
            shutil.copy(os.path.join(NETLISTS, f"{deck}.sp"),
                        os.path.join(tmp, "tests", "netlists"))
        os.chdir(tmp)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["tests/netlists/buffer.sp", "buffer_tran.csv",
                           "--device", "cuda"])
        out["buffer_cli_s"] = time.perf_counter() - t0
        check(rc == 0, "buffer CLI exit code")
        check(buf.getvalue() == read_golden("buffer_stdout.txt"),
              "buffer stdout byte-identical to the golden")
        got = np.loadtxt("buffer_tran.csv", delimiter=",", skiprows=1)
        ref = golden_rows("buffer_tran.csv", None)
        check(got.shape == ref.shape, "buffer CSV shape")
        out["buffer_csv_max_abs"] = float(np.abs(got - ref).max())
        check(out["buffer_csv_max_abs"] <= 1e-9, "buffer CSV within 1e-9 V")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["tests/netlists/dbmixer.sp", "--device", "cuda",
                           "--no-tran"])
        check(rc == 0, "dbmixer CLI exit code")
        gold = read_golden("dbmixer_stdout.txt")
        cut = gold.index("DC analysis finished.\n") + len(
            "DC analysis finished.\n")
        check(buf.getvalue() == gold[:cut] + "\nNo .TRAN card; transient "
              "analysis skipped.\n", "dbmixer DC table byte-identical")
    finally:
        os.chdir(here)
        shutil.rmtree(tmp)
    sim = Simulator.from_file(os.path.join(NETLISTS, "dbmixer.sp"),
                              device="cuda")
    n = 500
    t0 = time.perf_counter()
    res = sim.transient(tstop=n * sim.config.tran.tstep)
    torch.cuda.synchronize()
    out["dbmixer_steps"] = n
    out["dbmixer_steps_s"] = time.perf_counter() - t0
    check(not bool(res.failed), "dbmixer single lane failed")
    cols = np.concatenate([sim.topo.volt_col_eqs, sim.topo.branch_col_eqs])
    ref = golden_rows("dbmixer_tran.csv", n + 1)
    out["dbmixer_max_abs"] = float(
        np.abs(res.xs.cpu().numpy()[:, cols] - ref[:, 1:]).max())
    check(out["dbmixer_max_abs"] <= 1e-9, f"dbmixer {n} steps within 1e-9 V")
    out["dbmixer_mean_newton_iters"] = float(res.newton_iters.float().mean())
    emit("single_lane_f64", **out)


# ---------------------------------------------------------------- phase 4
def _sim(opts, deck):
    """A simulator on the card for a deck file or a deck's text."""
    from circuitsimulator_tpu_torch import Simulator
    if "\n" in deck:
        return Simulator.from_text(deck, opts=opts, device="cuda")
    return Simulator.from_file(deck, opts=opts, device="cuda")


def _mc_lanes(opts, B, seed, deck=None, sigmas=SIGMAS):
    """A deck (dbmixer by default; a file or a deck's text) on the card and
    B lanes drawn from `seed` (lane 0 nominal)."""
    import torch
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    sim = _sim(opts, deck or os.path.join(NETLISTS, "dbmixer.sp"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bp = mc.perturb_params(sim.params, gen, B, sigmas)
    for k in sigmas:
        if sim.params[k].numel():
            bp[k][0] = sim.params[k]
    return sim, bp


def _mc_run(opts, B, n_steps, chunk, seed):
    """batched DC + n_steps BE steps of dbmixer at B lanes (lane 0 nominal);
    returns the measurements, K2 launches, lane 0's trajectory, the
    topology and the final x."""
    import torch
    from circuitsimulator_tpu_torch.ops import cuda_lu
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    sim, bp = _mc_lanes(opts, B, seed)
    eng = sim.engine
    dt = sim.config.tran.tstep
    torch.cuda.synchronize()
    cuda_lu.LAUNCHES = 0
    t0 = time.perf_counter()
    x0 = mc.batched_dc_fast(eng, bp)
    torch.cuda.synchronize()
    dc_s = time.perf_counter() - t0
    dc_launches = cuda_lu.LAUNCHES
    carry = mc.init_carry(eng, x0, bp, dt)
    walls, lane0, iters = [], [], 0
    for c in range(n_steps // chunk):
        ts = torch.arange(c * chunk + 1, (c + 1) * chunk + 1,
                          dtype=opts.dtype, device="cuda") * dt
        t0 = time.perf_counter()
        carry, it, rec = mc.batched_transient_chunk(eng, bp, carry, ts, dt,
                                                    record_lane=0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        lane0.append(rec)
        iters = iters + it
    launches = cuda_lu.LAUNCHES
    rates = [B * chunk / w for w in walls]
    m = {"B": B, "dtype": str(opts.dtype)[6:], "steps": n_steps,
         "dc_s": dc_s, "dc_k2_launches": dc_launches,
         "tran_k2_launches": launches - dc_launches,
         "steps_per_s": B * n_steps / sum(walls),
         "chunk_steps_per_s": rates,
         "chunk_spread": (max(rates) - min(rates)) / statistics.median(rates),
         "failed_lanes": int(carry[-1].sum()),
         "mean_newton_iters": float(iters.float().mean()) / n_steps}
    return m, launches, torch.cat([x0[:1], *lane0]), sim.topo, carry[0]


def phase_monte_carlo():
    import numpy as np
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    m, launches, lane0, topo, x32 = _mc_run(fast_f32_options(), 8192, 2000,
                                            500, seed=42)
    cols = np.concatenate([topo.volt_col_eqs, topo.branch_col_eqs])
    ref = golden_rows("dbmixer_tran.csv", 2001)
    m["lane0_max_abs_vs_golden"] = float(
        np.abs(lane0.double().cpu().numpy()[:, cols] - ref[:, 1:]).max())
    check(m["dc_k2_launches"] > 0 and m["tran_k2_launches"] > 0,
          "main path ran through K2")
    check(m["failed_lanes"] == 0, "no failed lanes")
    check(m["lane0_max_abs_vs_golden"] <= 1e-3, "lane 0 within 1e-3 V")
    emit("monte_carlo_f32_fast", **m)
    m64, _, _, _, x64 = _mc_run(DEFAULT_OPTIONS, 1024, 500, 250, seed=43)
    check(m64["failed_lanes"] == 0, "no failed f64 lanes")
    emit("monte_carlo_f64_reference", **m64)
    return launches, x32, x64


# ---------------------------------------------------------------- phase 5
def phase_cuda_vs_cpu():
    import torch
    from circuitsimulator_tpu_torch import Simulator
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    path = os.path.join(NETLISTS, "dbmixer.sp")
    runs = {}
    gen = torch.Generator().manual_seed(5)
    cpu_sim = Simulator.from_file(path, device="cpu")
    bp = mc.perturb_params(cpu_sim.params, gen, 64, SIGMAS)
    dt = cpu_sim.config.tran.tstep
    for dev in ("cuda", "cpu"):
        sim = Simulator.from_file(path, device=dev)
        p = {k: v.to(dev) for k, v in bp.items()}
        t0 = time.perf_counter()
        x0 = mc.batched_dc_fast(sim.engine, p)
        carry = mc.init_carry(sim.engine, x0, p, dt)
        finals = [x0]
        for c in range(5):
            ts = torch.arange(c * 25 + 1, c * 25 + 26, dtype=torch.float64,
                              device=dev) * dt
            carry, _ = mc.batched_transient_chunk(sim.engine, p, carry, ts, dt)
            finals.append(carry[0])
        runs[dev] = (torch.stack(finals).cpu(), time.perf_counter() - t0)
    err = float((runs["cuda"][0] - runs["cpu"][0]).abs().max())
    check(err <= 1e-9, f"CUDA vs CPU trajectories {err}")
    emit("cuda_vs_cpu_f64", lanes=64, steps=125, checkpoints=6,
         max_abs=err, cuda_s=runs["cuda"][1], cpu_s=runs["cpu"][1])


# ---------------------------------------------------------------- phase 6
def _dc_f64(sim64, bp):
    """The lanes' DC operating points from the float64 simulator of the same
    deck (K2 in f64).  The float32 lanes of a junction deck start there: the
    reference's damped DC Newton with gmin stepping leaves about 1% of a BJT
    deck's lanes unconverged in float32, and a transient from such a point
    is chaotic."""
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    bp64 = {k: (v.double() if v.is_floating_point() else v)
            for k, v in bp.items()}
    return mc.batched_dc_fast(sim64.engine, bp64), bp64


def _k1_case(name, sim, B, steps, from_dc, tol, seed=11, sigmas=SIGMAS,
             dt=None, sim64=None):
    """K1 and its plain version on the same lanes of `sim` (on the card);
    with `sim64` the lanes start from its float64 DC points."""
    import torch
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bp = mc.perturb_params(sim.params, gen, B, sigmas)
    dt = dt or sim.config.tran.tstep or 2e-9
    x0 = _dc_f64(sim64, bp)[0] if sim64 is not None else None
    carry, _, meta = mc.make_fused_transient_fn(sim.engine, bp, dt, x0=x0)
    runner = meta["runner"]
    if not from_dc:
        x = torch.zeros_like(carry[0])
        st = sim.engine.init_state(x, bp, dt)
        carry = (x, x, st["vc"], st["il"], carry[4])
    got = runner.run_chunk(*carry, 0, steps)
    ref = runner.run_chunk_plain(*carry, 0, steps)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got[:4], ref[:4])
              if a.numel())
    row = {"case": name, "B": B, "steps": steps,
           "dtype": str(sim.engine.dtype)[6:], "N": runner.N, "k": runner.k,
           "W": runner.W, "max_abs_err": err, "tol": tol,
           "failed_equal": bool(torch.equal(got[4], ref[4])),
           "iters_equal": bool(torch.equal(got[5], ref[5])),
           "failed_lanes": int(got[4].sum()),
           "mean_newton_iters": float(got[5].float().mean()) / steps}
    check(err <= tol, f"K1 {name}: {err} > {tol}")
    check(row["failed_equal"], f"K1 {name}: failed masks differ")
    check(bool(torch.isfinite(got[0]).all()), f"K1 {name}: non-finite x")
    if runner.unrolled:
        check(row["iters_equal"], f"K1 {name}: iteration counts differ")
    return row, runner, carry


def phase_k1():
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
    f32 = fast_f32_options()
    db = os.path.join(NETLISTS, "dbmixer.sp")
    rows = []
    row, runner, carry = _k1_case(
        "dbmixer f32 fast from x=0",
        Simulator.from_file(db, opts=f32, device="cuda"), 256, 200, False,
        2e-4)
    rows.append(row)
    timing = {"B": 256, "steps": 200, "dtype": "float32",
              "kernel_ms": cuda_ms(lambda: runner.run_chunk(*carry, 0, 200),
                                   reps=5, warmup=1),
              "plain_ms": cuda_ms(
                  lambda: runner.run_chunk_plain(*carry, 0, 200),
                  reps=3, warmup=1)}
    rows.append(_k1_case(
        "dbmixer f64 damped from DC",
        Simulator.from_file(db, device="cuda"), 256, 100, True, 1e-9)[0])
    rows.append(_k1_case(
        "buffer f64 damped from DC",
        Simulator.from_file(os.path.join(NETLISTS, "buffer.sp"),
                            device="cuda"), 64, 100, True, 1e-9)[0])
    for name, text in (("waveform deck", WAVEFORM_DECK),
                       ("linear deck (k=0)", LINEAR_DECK),
                       ("MOS + E/G/F/H deck", MOS_CTRL_DECK)):
        rows.append(_k1_case(
            f"{name} f64 damped from DC",
            Simulator.from_text(text, device="cuda"), 64, 50, True, 1e-9)[0])
    emit("k1_vs_plain", cases=rows, timing_per_chunk=timing)
    return max(r["max_abs_err"] for r in rows)


# ---------------------------------------------------------------- phase 7
# operations of one MOS's five charges (models/moscap.py): the Ward-Dutton
# gate charges (~70 with the powers of the triode rows) and the two
# depletion junctions (~20 each); on dual numbers each product, quotient and
# power carries three tangents too (~4x)
CHARGE_OPS = 110
CHARGE_DUAL_OPS = 4 * CHARGE_OPS


def k_solve_ops(k):
    """Operations of K1's k x k solve: the pivoted elimination with back
    substitution for k <= 16, column-pivoted Gauss-Jordan above (per
    column: |col| of every row, k factors, the k x k update of A and the
    update of bb; then k divisions)."""
    if k <= 16:
        return sum(m + 2 * m * m + 2 * m for m in range(k)) + k * k + k
    return k * (2 * k + k + 2 * k * k + 2 * k) + k


def k1_work(runner, n_steps, n_iters):
    """(bytes, operations) of one K1 launch of n_steps whose lanes ran
    n_iters Newton iterations in all.  Bytes: each input read once and each
    output written once (the constants, the carry in and out, the failed
    flags and iteration counts; with a probe matrix (K1c-i) the matrix
    once and the P values of every lane-step).  Operations per lane-step:
    sources (~20 each) and their scatter, inductor and cap history terms,
    z0, the predictor, the history update, under the charge model q_prev
    (one charge evaluation per MOS), and the probe stream's P x N
    multiply-adds; per Newton iteration: the device
    linearisations (MOS/JFET ~25, diode ~20 or ~32 with breakdown, BJT
    ~75, switch ~35, an exp or log counted as one; per charge-model MOS its
    charges on dual numbers and five rows of ~9; per B source each tape
    instruction on its value and its m partials, 1 + m operations, and ~4
    per probe pair for the row), z, S, vz, the k x k solve
    (``k_solve_ops``), x_raw, accept.  The B tapes are read once (every
    lane reads the same ones), their constants once per lane.  The delay
    ring of a T-line deck (K1c-ii) is read once and written once (Dmax x
    2 nT words per lane), with Z0 per lane and the read slots and index
    plan once; per lane-step each of the 2 nT waves takes about four
    operations (the voltage difference, Z0 i, their sum, the EMF's add
    into b0).  A noisy run (K1c-iii) reads its noise block once, nN words
    per lane-step, with the per-source rows once, and adds each word to
    its source's value (one operation).  A deck with mutual inductance
    (K1e) reads gm once per lane and the K plan once, and per lane-step
    forms and adds its 2 nK history terms (two operations each)."""
    B, N, k, P, W = runner.B, runner.N, runner.k, runner.P, runner.W
    size = runner.G0inv.element_size()
    nc = runner.bconsts.shape[0] if runner.nB else 0
    nbytes = size * B * (N * N + k * N + W * k * k + 4 * runner.nMJ
                         + 5 * runner.nD + 6 * runner.nQ + 4 * runner.nSw
                         + 4 * runner.nMq + nc
                         + runner.nS * (1 + 7 + 5 + 2 * P) + runner.nCap
                         + runner.nL + 2 * (2 * N + runner.nCap + runner.nL))
    nbytes += 4 * B * (runner.nS + 3)
    if runner.nB:
        nbytes += (4 * (runner.b_ops.numel() + runner.b_meta.numel())
                   + size * runner.b_lits.numel())
    b_ops = sum(len(bs.tape.ops) * (1 + len(bs.pairs)) + 4 * len(bs.pairs)
                + 2 for bs in runner.b_sources)
    n_probe = 0 if runner.probe_mat is None else runner.probe_mat.shape[0]
    nbytes += size * (n_probe * N + n_steps * n_probe * B)
    nT = runner.nT
    nbytes += size * B * (2 * runner.Dmax * 2 * nT + nT) + 4 * 7 * nT
    nbytes += size * n_steps * runner.nN * B + 4 * runner.nS * bool(runner.nN)
    nbytes += size * B * runner.nK + 4 * 2 * runner.nK
    per_step = (22 * runner.nS + 2 * runner.nL + 4 * runner.nCap
                + 2 * N * N + 2 * N + CHARGE_OPS * runner.nMq
                + 2 * n_probe * N + 4 * 2 * nT + runner.nN
                + 2 * 2 * runner.nK)
    dio = 32 if runner.flags["dio_bv"] else 20
    per_iter = (25 * runner.nMJ + dio * runner.nD + 75 * runner.nQ
                + 35 * runner.nSw + (CHARGE_DUAL_OPS + 45) * runner.nMq
                + b_ops
                + 2 * k * N + 2 * W * k * k + 2 * W * k + k_solve_ops(k)
                + 2 * k * N + 7 * N)
    return nbytes, B * n_steps * per_step + n_iters * per_iter


def k1_plan_row(runner, route=None, team=None):
    """K1's launch plan for `runner` (ops/cuda_step.plan: threads per lane,
    rows of x a thread, lanes per block, the route of G0^-1, shared bytes)
    with the registers and local bytes per thread of the instantiation it
    launches."""
    from circuitsimulator_tpu_torch.ops import cuda_step
    p = cuda_step.runner_plan(runner, route, team=team)
    mode = 2 if runner.nB else (1 if runner.nMq else 0)
    regs, local = cuda_step.attrs(runner.dtype, p.route, mode)
    return {"team": p.team, "rows": p.rows,
            "lanes_per_block": p.lanes_per_block, "route": p.route,
            "shared_bytes_per_block": p.smem, "team_bytes": p.team_bytes,
            "blocks": p.blocks(runner.B), "registers": regs,
            "local_bytes": local}


def _dc_fail_mask(engine, bp, x0, bar):
    """(mask, move): the lanes whose batched DC point is not one
    (non-finite, or one more undamped Newton solve at the final gmin moves
    it by more than `bar` volts), and that move per lane."""
    import torch
    from circuitsimulator_tpu_torch.ops import lu
    N, opts = engine.N, engine.opts
    G_s, I_s = engine.dc_static(bp, engine._scalar(1.0))
    G, I = engine.assemble_dc_iter(G_s, I_s, bp, x0, opts.gmin_low_base)
    x_raw = lu.lu_solve(G[..., :N, :N], I[..., :N], opts.lu_pivot_floor)
    move = (x_raw - x0).abs().amax(-1)
    return ~torch.isfinite(x0).all(-1) | ~(move <= bar), move


def _dc_failed_lanes(engine, bp, x0, bar):
    """(count, largest move of the good lanes) of ``_dc_fail_mask``."""
    bad, move = _dc_fail_mask(engine, bp, x0, bar)
    return int(bad.sum()), float(move[~bad].max()) if (~bad).any() else None


def _fused_run(opts, B, n_steps, chunk, seed, deck=None, sigmas=SIGMAS,
               dt=None, dc64=False, x_zero=False, allow_failed=False,
               warm=False):
    """The fused main path: batched DC (K2; in float64 with dc64; with warm
    the nominal float64 DC with the deck's .NODESET card, then the warm
    batched DC from it), or x = 0 with x_zero (a power-up transient), then
    K1 chunks.  Counts are reset just before and read just after.  Every
    lane must finish unless allow_failed (then the failed lanes are counted
    and the others must be finite)."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_lu, cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    sim, bp = _mc_lanes(opts, B, seed, deck, sigmas)
    dt = dt or sim.config.tran.tstep
    sim64 = (_sim(DEFAULT_OPTIONS.replace(mos_cap_model=opts.mos_cap_model),
                  deck) if dc64 else None)
    torch.cuda.synchronize()
    cuda_lu.LAUNCHES = 0
    cuda_step.LAUNCHES = 0
    t0 = time.perf_counter()
    x0 = None
    if warm:
        bp64 = {k: (v.double() if v.is_floating_point() else v)
                for k, v in bp.items()}
        x0 = mc.batched_dc_warm(sim64.engine, bp64, sim64.dc())
    elif dc64:
        x0 = _dc_f64(sim64, bp)[0]
    if x_zero:
        x0 = torch.zeros((B, sim.engine.N), dtype=opts.dtype, device="cuda")
    carry, advance, meta = mc.make_fused_transient_fn(sim.engine, bp, dt,
                                                      chunk=chunk, x0=x0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    k2_setup = cuda_lu.LAUNCHES
    walls, lane0, iters = [], [], 0
    for c in range(n_steps // chunk):
        t0 = time.perf_counter()
        carry, it = advance(carry, c * chunk)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        lane0.append(carry[0][0].double().cpu())
        iters = iters + it
    rates = [B * chunk / w for w in walls]
    m = {"B": B, "dtype": str(opts.dtype)[6:], "steps": n_steps, "dt": dt,
         "chunk": chunk, "setup_s": setup_s, "setup_k2_launches": k2_setup,
         "tran_k2_launches": cuda_lu.LAUNCHES - k2_setup,
         "k1_launches": cuda_step.LAUNCHES,
         "steps_per_s": B * n_steps / sum(walls),
         "chunk_steps_per_s": rates,
         "chunk_spread": (max(rates) - min(rates)) / statistics.median(rates),
         "failed_lanes": int(carry[4].sum()),
         "mean_newton_iters": float(iters.float().mean()) / n_steps}
    check(m["k1_launches"] == n_steps // chunk, "one K1 launch per chunk")
    check(m["tran_k2_launches"] == 0, "no K2 launch during the transient")
    check(m["setup_k2_launches"] > 0,
          "set-up (batched DC, the runner's G0 inverse) ran through K2")
    if allow_failed:
        alive = ~carry[4]
        check(bool(torch.isfinite(carry[0][alive]).all()),
              "the lanes that did not fail are finite")
    else:
        check(m["failed_lanes"] == 0, "no failed lanes")
    return m, carry, meta["runner"], lane0, sim.topo, (sim, bp)


def phase_monte_carlo_fused(x32_nonfused, x64_nonfused):
    import numpy as np
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step
    m, carry, runner, lane0, topo, _ = _fused_run(fast_f32_options(), 8192,
                                                  2000, 250, seed=42)
    launches = m["k1_launches"]
    cols = np.concatenate([topo.volt_col_eqs, topo.branch_col_eqs])
    gold = golden_rows("dbmixer_tran.csv", 2001)
    errs = [float(np.abs(x.numpy()[cols] - gold[(c + 1) * 250, 1:]).max())
            for c, x in enumerate(lane0)]
    m["lane0_abs_err_at_chunk_ends"] = errs
    check(max(errs) <= 1e-3, "fused lane 0 within 1e-3 V at chunk ends")
    m["final_max_abs_vs_nonfused"] = float(
        (carry[0] - x32_nonfused).abs().max())
    # the kernels line: K1 at the main path's shape (B = 8192, one chunk of
    # 250 steps, f32) against its plain version from the same carry
    got = runner.run_chunk(*carry, 2000, 250)
    ref = runner.run_chunk_plain(*carry, 2000, 250)
    err = max(float((a - b).abs().max()) for a, b in zip(got[:4], ref[:4])
              if a.numel())
    check(err <= 2e-4, f"K1 main shape vs plain {err}")
    B = runner.B
    nbytes, flops = k1_work(runner, 250, int(got[5].sum()))
    bms, by = bound_ms(nbytes, flops, runner.dtype)
    main = {"B": B, "steps": 250, "dtype": "float32", "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: runner.run_chunk(*carry, 2000, 250),
                                 reps=5, warmup=1),
            "plain_ms": cuda_ms(
                lambda: runner.run_chunk_plain(*carry, 2000, 250),
                reps=3, warmup=1),
            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
            "flops": flops}
    # the plan of this launch, and the same launch on every team and route
    # the plan can take (a measurement for later tuning; the path keeps
    # the plan's choice)
    main["plan"] = k1_plan_row(runner)
    emit("k1_plan", deck="dbmixer", shape="B=8192 x 250 steps f32 fast",
         N=runner.N, k=runner.k, W=runner.W, **main["plan"])
    by_plan = {}
    for team in cuda_step.TEAMS:
        for route in cuda_step.ROUTES:
            try:
                cuda_step.runner_plan(runner, route, team=team)
            except ValueError:
                continue
            by_plan[f"team {team} {route}"] = cuda_ms(
                lambda: cuda_step.run_chunk_cuda(runner, *carry, 2000, 250,
                                                 route=route, team=team),
                reps=5, warmup=1)
    main["kernel_ms_by_plan"] = by_plan
    # the same launch writing a (4, N) probe stream (K1c-i): what the
    # stream costs at this shape, timed beside the launch without it
    probed = copy.copy(runner)
    probed.probe_mat = _probe_mat(runner.N, runner.dtype)
    main["kernel_ms_with_4_probes"] = cuda_ms(
        lambda: probed.run_chunk(*carry, 2000, 250), reps=5, warmup=1)
    m["kernel_at_main_shape"] = main
    emit("monte_carlo_fused_f32_fast", **m)
    m64, carry64 = _fused_run(DEFAULT_OPTIONS, 1024, 500, 250, seed=43)[:2]
    m64["final_max_abs_vs_nonfused"] = float(
        (carry64[0] - x64_nonfused).abs().max())
    check(m64["final_max_abs_vs_nonfused"] <= 1e-9,
          "fused f64 within 1e-9 V of the non-fused run")
    emit("monte_carlo_fused_f64_reference", **m64)
    return launches, main, (runner, carry)

# ------------------------------------------------------------ phases 8, 9
AC_FREQS = (6.0, 10.0, 64)          # np.logspace(6, 10, 64): 1 MHz .. 10 GHz
# K3's inputs at each main path's shape, kept by _k3_shape for the
# timings after phase 27 and the device times of phase 28
K3_SHAPES = {}
K3_MAIN = "dbmixer float32"         # B = 4096, F = 64, N = 31: the bench shape


def _zero_lanes(xr, xi):
    import torch
    return _lane_masks(torch.complex(xr, xi))[0]


def ac_flops(B, F, n):
    """Operations of K3 (and its plain version) for B x F systems of size
    n: forming w B1, |a|^2 of each pivot column, |pivot|^2, the complex
    factors (two divisions each), the trailing and right-hand-side updates
    (8 per complex multiply-subtract), then back substitution."""
    per = n * n
    for k in range(n):
        m = n - k - 1
        per += 3 * (n - k) + 3 + 8 * m + 8 * m * m + 8 * m
    per += sum(8 * (n - j - 1) + 11 for j in range(n))
    return B * F * per


def ac_bytes(B, F, n, size):
    """G, B1, br, bi and the omegas read once, xr and xi written once."""
    return size * (2 * B * n * n + 2 * B * n + F + 2 * B * F * n)


def _ac_csv_err(path, gold):
    """(error, print flips) of a --run-ac CSV against a golden: phasors
    rebuilt from VM/VP, |x - x_gold| over the probe's largest |x_gold|.  An
    entry whose printed VM and VP each differ from the golden's by at most
    one unit in their tenth significant digit is a rounding flip of %.9e
    (both files print 10 digits); it is counted, not measured."""
    import numpy as np
    with open(path) as f, open(gold) as g:
        check(f.readline() == g.readline(), f"{path}: CSV header")
    a = np.loadtxt(path, delimiter=",", skiprows=1)
    b = np.loadtxt(gold, delimiter=",", skiprows=1)
    check(a.shape == b.shape and np.array_equal(a[:, 0], b[:, 0]),
          f"{path}: CSV frequencies")

    def unit(u, v):
        m = np.maximum(np.abs(u), np.abs(v))
        return np.where(m > 0, 10.0 ** (np.floor(np.log10(
            np.where(m > 0, m, 1.0))) - 9), 0.0)

    ma, pa, mb, pb = a[:, 1::2], a[:, 2::2], b[:, 1::2], b[:, 2::2]
    xa = ma * np.exp(1j * np.radians(pa))
    xb = mb * np.exp(1j * np.radians(pb))
    rel = np.abs(xa - xb) / np.maximum(np.abs(xb).max(axis=0), 1e-300)
    flip = ((np.abs(ma - mb) <= 1.5 * unit(ma, mb))
            & (np.abs(pa - pb) <= 1.5 * unit(pa, pb)) & (rel > 0))
    return float(np.where(flip, 0.0, rel).max()), int(flip.sum())


def _ac_mc_lanes(B, seed):
    """dbmixer lanes drawn once in f64 (lane 0 nominal; source 0 drives the
    AC RHS, as bench_ac_mc.py does) and the same lanes in f32: the two
    simulators and their parameter dicts."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
    sim64, bp64 = _mc_lanes(DEFAULT_OPTIONS, B, seed)
    bp64["vs_ac_mag"] = bp64["vs_ac_mag"].clone()
    bp64["vs_ac_mag"][:, 0] = 1.0
    sim32 = Simulator.from_file(os.path.join(NETLISTS, "dbmixer.sp"),
                                opts=fast_f32_options(), device="cuda")
    bp32 = {k: (v.float() if v.is_floating_point() else v)
            for k, v in bp64.items()}
    return (sim32, bp32), (sim64, bp64)


def _ac_run(sim, bp, freqs, x_ops=None):
    """The AC Monte-Carlo main path: batched DC (unless the operating
    points are given), then the warm batched sweep (one call to warm up,
    five timed).  Counts are reset just before and read just after."""
    import torch
    from circuitsimulator_tpu_torch.analysis.ac import make_ac_batched_fn
    from circuitsimulator_tpu_torch.ops import cuda_ac, cuda_lu
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    eng = sim.engine
    B, F = mc.lane_count(bp), len(freqs)
    torch.cuda.synchronize()
    cuda_lu.LAUNCHES = 0
    cuda_ac.LAUNCHES = 0
    t0 = time.perf_counter()
    given = x_ops is not None
    if not given:
        x_ops = mc.batched_dc_fast(eng, bp)
    torch.cuda.synchronize()
    dc_s = time.perf_counter() - t0
    fn = make_ac_batched_fn(eng, freqs)
    xr, xi = fn(bp, x_ops)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        xr, xi = fn(bp, x_ops)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    k3, k2 = cuda_ac.LAUNCHES, cuda_lu.LAUNCHES
    bad = _zero_lanes(xr, xi) | ~(torch.isfinite(xr) & torch.isfinite(xi)
                                  ).reshape(B, -1).all(1)
    m = {"B": B, "F": F, "N": eng.N, "dtype": str(eng.dtype)[6:],
         "dc_s": dc_s, "dc_k2_launches": k2, "sweep_calls": 6,
         "k3_launches": k3, "k3_launches_per_sweep_call": k3 / 6,
         "sweep_wall_s": walls,
         "ac_solves_per_s": B * F / statistics.median(walls),
         "failed_lanes": int(bad.sum())}
    check(k3 == 6, f"one K3 launch per sweep call ({k3} in 6 calls)")
    check(given or k2 > 0, "batched DC ran through K2")
    check(m["failed_lanes"] == 0, f"{m['failed_lanes']} failed AC lanes")
    return m, x_ops, xr, xi


def phase_ac_monte_carlo():
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import cli
    from circuitsimulator_tpu_torch.analysis.ac import (ac_system_real,
                                                        solve_ac_real)
    from circuitsimulator_tpu_torch.ops import cuda_ac
    freqs = np.logspace(*AC_FREQS)
    (sim32, bp32), (sim64, bp64) = _ac_mc_lanes(4096, seed=44)
    m32, x32, xr32, xi32 = _ac_run(sim32, bp32, freqs)
    emit("ac_monte_carlo_f32", **m32)
    m64, x64, xr64, xi64 = _ac_run(sim64, bp64, freqs)
    m64["f32_vs_f64_lane_rel"] = _lane_rel_err(
        torch.complex(xr32.double(), xi32.double()),
        torch.complex(xr64, xi64))
    check(m64["f32_vs_f64_lane_rel"] <= 1e-3, "f32 within 1e-3 of f64")
    # the real 2N reference route (K2) on 64 lanes x all 64 frequencies
    eng, n, L = sim64.engine, sim64.engine.N, min(64, m64["B"])
    G, B1, br, bi = ac_system_real(eng, {k: v[:L] for k, v in bp64.items()},
                                   x64[:L], 1.0)
    om = 2.0 * np.pi * torch.as_tensor(freqs, dtype=torch.float64,
                                       device="cuda")
    F = len(freqs)
    rr, ri = solve_ac_real(eng, G[:, None].expand(L, F, n, n),
                           om[None, :, None, None] * B1[:, None],
                           br[:, None].expand(L, F, n),
                           bi[:, None].expand(L, F, n))
    m64["vs_2n_route_lane_rel"] = _lane_rel_err(
        torch.complex(xr64[:L], xi64[:L]), torch.complex(rr, ri))
    check(m64["vs_2n_route_lane_rel"] <= 1e-9, "f64 K3 within 1e-9 of 2N")
    emit("ac_monte_carlo_f64", **m64)
    # the CLI on the card against the committed JAX goldens
    cli_rows = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ac_")
    try:
        for deck in ("cs_amp", "feedback_loop"):
            out = os.path.join(tmp, f"{deck}_ac.csv")
            buf = io.StringIO()
            t0 = time.perf_counter()
            cuda_ac.LAUNCHES = 0
            with contextlib.redirect_stdout(buf):
                rc = cli.main([os.path.join(REPO, "examples", f"{deck}.sp"),
                               "--no-tran", "--run-ac", out])
            k3 = cuda_ac.LAUNCHES
            check(rc == 0, f"{deck} --run-ac exit code")
            check(k3 == 1, f"{deck} --run-ac: one K3 launch ({k3})")
            check(f"Results written to '{out}'." in buf.getvalue(),
                  f"{deck} --run-ac stdout")
            err, flips = _ac_csv_err(
                out, os.path.join(GOLDENS, f"{deck}_ac_jax.csv"))
            cli_rows[deck] = {"rel_err_vs_jax_golden": err,
                              "print_flips": flips, "k3_launches": k3,
                              "cli_s": time.perf_counter() - t0}
            check(err <= 1e-9, f"{deck} --run-ac CSV within 1e-9: {err}")
    finally:
        shutil.rmtree(tmp)
    emit("ac_cli_vs_jax_goldens", decks=cli_rows)
    return m32, {"float32": (sim32, bp32, x32, m32["k3_launches"]),
                 "float64": (sim64, bp64, x64, m64["k3_launches"])}, \
        cli_rows["cs_amp"]["k3_launches"]


def _ac_random(B, n, dtype, seed):
    """Diagonally dominant lanes (tests/test_pallas_ac.py); with B > 2 lane
    1 exactly singular, lane 2 holds a NaN."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, n, n)) + n * np.eye(n),
              rng.standard_normal((B, n, n)), rng.standard_normal((B, n)),
              rng.standard_normal((B, n))]
    if B > 2:
        arrays[0][1] = 0.0
        arrays[1][1] = 0.0
        arrays[0][2, n // 2, min(1, n - 1)] = np.nan
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in arrays]


def _ac_mna(B, n, dtype, seed):
    """MNA-style lanes of small integers (tests/test_torch_cuda.py's
    mna_lanes): a grounded chain of integer conductances, random branches
    and capacitances, voltage-source rows of +-1 with a zero diagonal, the
    equations in a random order per lane, so that exact ties in |a|^2
    decide pivots; lane 1 singular, lane 2 holds a NaN."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    m = n // 4
    nv = n - m
    G = np.zeros((B, n, n))
    C = np.zeros((B, n, n))

    def branch(M, b, a, c, v):
        M[b, a, a] += v
        if c is not None:
            M[b, c, c] += v
            M[b, a, c] -= v
            M[b, c, a] -= v

    for b in range(B):
        branch(G, b, 0, None, 1.0)
        for a in range(nv - 1):
            branch(G, b, a, a + 1, float(rng.integers(1, 4)))
        for _ in range(nv // 2):
            a, c = rng.choice(nv, 2, replace=False)
            branch(G, b, a, c, float(rng.integers(1, 3)))
            branch(C, b, a, c, float(rng.integers(0, 3)))
        for k in range(m):
            r, a, c = nv + k, 2 * k, 2 * k + 1
            G[b, a, r] = G[b, r, a] = 1.0
            if c < nv:
                G[b, c, r] = G[b, r, c] = -1.0
        perm = rng.permutation(n)
        G[b], C[b] = G[b, perm], C[b, perm]
    br = rng.integers(-2, 3, (B, n)).astype(float)
    bi = rng.integers(-2, 3, (B, n)).astype(float)
    G[1] = 0.0
    C[1] = 0.0
    G[2, n // 2, min(1, n - 1)] = np.nan
    return [torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in (G, C, br, bi)]


def _k3_vs_plain(arrays, om, dtype, what, **override):
    """K3 (the dispatch, or cuda_ac.ac_sweep_cuda with a team override)
    against its plain version: identical fail masks, the
    planted lanes zeroed, lane-relative error <= 1e-12 (f64), <= 1e-4
    (f32).  Returns (lane-relative error, max abs error, zero lanes)."""
    import torch
    from circuitsimulator_tpu_torch.ops import ac_sweep, cuda_ac
    G, B1, br, bi = arrays
    if override:
        xr, xi = cuda_ac.ac_sweep_cuda(G, B1, br, bi, om, FLOOR, **override)
    else:
        xr, xi = ac_sweep.ac_sweep(G, B1, br, bi, om, FLOOR)
    pr, pi = ac_sweep.ac_sweep_plain(G, B1, br, bi, om, FLOOR)
    torch.cuda.synchronize()
    zk, zp = _zero_lanes(xr, xi), _zero_lanes(pr, pi)
    check(torch.equal(zk, zp), f"K3 fail masks {what}")
    if G.shape[0] > 2 and bool(G[1].eq(0).all()):
        check(bool(zk[1] and zk[2]), f"singular and NaN lanes zeroed {what}")
    good = ~zp
    rel = _lane_rel_err(torch.complex(xr, xi), torch.complex(pr, pi), good)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    check(rel <= tol, f"K3 vs plain {what}: {rel} > {tol}")
    err = max(float((xr - pr).abs()[good].max()),
              float((xi - pi).abs()[good].max())) if bool(good.any()) else 0.0
    return rel, err, int(zk.sum())


def _k3_shape(name, sim, bp, x_ops, freqs, launches, path):
    """Keep a main path's K3 inputs, the unit-omega systems and omegas its
    sweep call passes, for the timings after phase 27 (k3_timings) and
    phase 28."""
    from circuitsimulator_tpu_torch.analysis.ac import (_omegas,
                                                        ac_system_real)
    G, B1, br, bi = ac_system_real(sim.engine, bp, x_ops, 1.0)
    if G.dim() == 2:      # a single lane, as ac_analysis passes it
        G, B1, br, bi = G[None], B1[None], br[None], bi[None]
    K3_SHAPES[name] = {
        "inputs": [a.contiguous() for a in (G, B1, br, bi)]
        + [_omegas(sim.engine, freqs)[1].contiguous()],
        "launches": launches, "path": path}


def phase_k3(lanes, cli_k3):
    """K3 against its plain version at every team capacity's edges, on
    random and MNA lanes, on each team capacity, and on phase 8's dbmixer
    systems; keeps the main paths' shapes for k3_timings."""
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import Simulator
    from circuitsimulator_tpu_torch.analysis.ac import sweep_frequencies
    from circuitsimulator_tpu_torch.ops import cuda_ac
    t0 = time.perf_counter()
    rows, max_abs = [], 0.0

    def held(case, arrays, om, dtype, **override):
        nonlocal max_abs
        B, n = arrays[0].shape[:2]
        what = f"{case} B={B} F={om.shape[0]} N={n} {dtype} {override}"
        rel, err, zeros = _k3_vs_plain(arrays, om, dtype, what, **override)
        max_abs = max(max_abs, err)
        rows.append({"case": case, "B": B, "F": om.shape[0], "N": n,
                     "dtype": str(dtype)[6:], **override,
                     "lane_rel_err": rel, "zero_lanes": zeros})

    for dtype in (torch.float64, torch.float32):
        # every team capacity's edges (8, 16, 32 threads; 33 and 64 the
        # wide route); omega <= 1 keeps the random lanes dominant
        for n in (1, 8, 9, 16, 17, 31, 32, 33, 64):
            for B, F in ((1, 1), (7, 3), (300, 8)):
                om = torch.logspace(-1, 0, F, dtype=dtype, device="cuda")
                held("random", _ac_random(B, n, dtype, seed=n + F), om,
                     dtype)
        # ties in |a|^2 decide the pivots: omegas powers of two
        om2 = 2.0 ** torch.arange(-3, 5, dtype=dtype, device="cuda")
        for n in (4, 7, 10, 17, 31, 40):
            held("mna", _ac_mna(300, n, dtype, seed=n), om2, dtype)
        # every team capacity that holds N
        for n in (5, 9, 17, 31):
            for cap in (c for c in cuda_ac.CAPACITIES if c >= n):
                held("mna", _ac_mna(40, n, dtype, seed=n), om2[:5], dtype,
                     team=cap)
    freqs = np.logspace(*AC_FREQS)
    for name, (sim, bp, x_ops, launches) in lanes.items():
        _k3_shape(f"dbmixer {name}", sim, bp, x_ops, freqs, launches,
                  f"ac_monte_carlo_f{name[5:]}")
        G, B1, br, bi, om = K3_SHAPES[f"dbmixer {name}"]["inputs"]
        held("dbmixer unit-omega systems", [G, B1, br, bi], om,
             sim.engine.dtype)
        check(rows[-1]["zero_lanes"] == 0, f"dbmixer {name}: no zero lane")
    # one --run-ac lane as the CLI runs it (f64, Simulator.ac)
    sim = Simulator.from_file(os.path.join(EXAMPLES, "cs_amp.sp"),
                              device="cuda")
    cfg = sim.config.ac
    _k3_shape("cs_amp --run-ac float64", sim, sim.params, sim.dc(),
              sweep_frequencies(cfg.sweep_type, cfg.n_points, cfg.fstart,
                                cfg.fstop), cli_k3, "ac_cli_vs_jax_goldens")
    emit("k3_vs_plain", cases=rows, max_abs_err=max_abs,
         seconds=time.perf_counter() - t0)
    return max_abs


def phase_k3_timings():
    """K3 at every main-path shape kept by _k3_shape, and at N = 64 on
    random lanes: the plan, its launch and PR 3's warp-per-system code
    (the wide route forced by team=64), both through cuda_ac.ac_sweep_cuda,
    the plain version, torch.linalg.solve_ex on the pre-formed complex
    systems (timed only: its fail semantics differ) and the bound."""
    import torch
    from circuitsimulator_tpu_torch.ops import ac_sweep, cuda_ac
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        G, B1, br, bi = _ac_random(1024, 64, dtype, seed=65)
        om = torch.logspace(-1, 0, 64, dtype=dtype, device="cuda")
        K3_SHAPES[f"random N=64 {str(dtype)[6:]}"] = {
            "inputs": [G, B1, br, bi, om], "launches": 0, "path": None}
    rows = []
    for name, case in K3_SHAPES.items():
        G, B1, br, bi, om = case["inputs"]
        B, n = G.shape[:2]
        F = om.shape[0]
        size = G.element_size()
        pl = cuda_ac.plan(n, size)
        teams, chunks = cuda_ac.launch_shape(pl, F)
        bms, by = bound_ms(ac_bytes(B, F, n, size), ac_flops(B, F, n),
                           G.dtype)
        row = {"shape": name, "B": B, "F": F, "N": n,
               "dtype": str(G.dtype)[6:], "k3_launches": case["launches"],
               "path": case["path"],
               "plan": {"team": pl.team, "cap": pl.cap, "rows": pl.rows,
                        "systems_per_block": pl.spb,
                        "teams_per_block": teams, "blocks_per_lane": chunks,
                        "threads": teams * pl.team, "smem_bytes": pl.smem,
                        "registers": pl.regs,
                        "local_bytes": cuda_ac.attrs(size, pl.cap)[1],
                        "resident_per_sm": pl.resident},
               "kernel_ms": cuda_ms(lambda: cuda_ac.ac_sweep_cuda(
                   G, B1, br, bi, om, FLOOR))}
        if pl.cap < 64:
            row["pr3_warp_per_system_ms"] = cuda_ms(
                lambda: cuda_ac.ac_sweep_cuda(G, B1, br, bi, om, FLOOR,
                                              team=64), reps=10, warmup=2)
        row["plain_ms"] = cuda_ms(lambda: ac_sweep.ac_sweep_plain(
            G, B1, br, bi, om, FLOOR), reps=3, warmup=1)
        A = torch.complex(G[:, None].expand(B, F, n, n),
                          om[None, :, None, None] * B1[:, None]).reshape(
                              B * F, n, n)
        rhs = torch.complex(br, bi)[:, None].expand(B, F, n).reshape(
            B * F, n, 1)
        row["library_ms"] = cuda_ms(lambda: torch.linalg.solve_ex(A, rhs),
                                    reps=10, warmup=2)
        del A, rhs
        row.update(bound_ms=bms, bound_by=by, flops=ac_flops(B, F, n),
                   bytes=ac_bytes(B, F, n, size))
        rows.append(row)
    emit("k3_timings", card=card_line(), shapes=rows,
         seconds=time.perf_counter() - t0)
    return rows


# ------------------------------------------------------------- phase 10
def phase_k1b():
    """K1's junction and switch rows against the plain version."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
    rows = []
    for name, text, dt, steps in K1B_DECKS:
        sim64 = Simulator.from_text(text, device="cuda")
        for opts, tol in ((damped_f32_options(), 1e-4),
                          (DEFAULT_OPTIONS, 1e-9)):
            sim = Simulator.from_text(text, opts=opts, device="cuda")
            row = _k1_case(f"{name} {str(opts.dtype)[6:]} damped from DC",
                           sim, 256, steps, True, tol,
                           sigmas=JUNCTION_SIGMAS, dt=dt, sim64=sim64)[0]
            check(row["failed_lanes"] == 0, f"K1b {name}: failed lanes")
            if opts.dtype == torch.float64:
                check(row["iters_equal"], f"K1b {name}: iteration counts")
            rows.append(row)
    # the mixed deck (every K1b segment but the switch) at the main width
    sim = Simulator.from_text(MIXED_DECK, opts=damped_f32_options(),
                              device="cuda")
    row, runner, carry = _k1_case(
        "mixed deck f32 damped, main width", sim, 8192, 50, True, 1e-4,
        sigmas=JUNCTION_SIGMAS, dt=1e-9,
        sim64=Simulator.from_text(MIXED_DECK, device="cuda"))
    rows.append(row)
    got = runner.run_chunk(*carry, 0, 100)
    nbytes, flops = k1_work(runner, 100, int(got[5].sum()))
    bms, by = bound_ms(nbytes, flops, runner.dtype)
    timing = {"case": "mixed deck", "B": 8192, "steps": 100,
              "dtype": "float32", "N": runner.N, "k": runner.k,
              "kernel_ms": cuda_ms(lambda: runner.run_chunk(*carry, 0, 100),
                                   reps=5, warmup=1),
              "plain_ms": cuda_ms(
                  lambda: runner.run_chunk_plain(*carry, 0, 25),
                  reps=1, warmup=0),
              "plain_steps": 25,
              "bound_ms": bms, "bound_by": by, "bytes": nbytes,
              "flops": flops}
    emit("k1b_vs_plain", cases=rows, timing_per_chunk=timing)
    return max(r["max_abs_err"] for r in rows)


# -------------------------------------------------------- phases 11, 12
def _junction_fused(name, deck, B, n_steps, chunk, dt=None):
    """A junction or switch deck on the fused path at B lanes in f32
    (damped configuration): the run, its DC check, K1 at the chunk's shape
    from the DC point against its plain version, bound and times."""
    import torch
    opts = damped_f32_options()
    m, carry, runner, _, _, (sim, bp) = _fused_run(
        opts, B, n_steps, chunk, seed=45, deck=deck,
        sigmas=JUNCTION_SIGMAS, dt=dt, dc64=True)
    m["deck"], m["N"], m["k"], m["W"] = name, runner.N, runner.k, runner.W
    m["dc_dtype"] = "float64"
    check(bool(torch.isfinite(carry[0]).all()), f"{name}: non-finite x")
    from circuitsimulator_tpu_torch import Simulator
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    sim64 = Simulator.from_file(deck, device="cuda")
    x64, bp64 = _dc_f64(sim64, bp)
    m["dc_failed_lanes"], m["dc_newton_move_max"] = _dc_failed_lanes(
        sim64.engine, bp64, x64, 1e-6)
    check(m["dc_failed_lanes"] == 0, f"{name}: DC failed lanes")
    # for the record: the same lanes through the float32 DC
    m["f32_dc_failed_lanes"] = _dc_failed_lanes(
        sim.engine, bp, mc.batched_dc_fast(sim.engine, bp), 1e-3)[0]
    x0 = x64.to(opts.dtype)
    st = sim.engine.init_state(x0, bp, runner.dt)
    start = (x0, x0, st["vc"], st["il"], torch.zeros_like(carry[4]))
    main = _k1_at_main_shape(runner, start, 0, chunk, 1e-3)
    m["kernel_at_main_shape"] = main
    return m, main


def phase_monte_carlo_fused_bjt():
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_lu
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    deck = os.path.join(EXAMPLES, "bjt_amp.sp")
    m, main = _junction_fused("bjt_amp", deck, 8192, 250, 250)
    emit("monte_carlo_fused_bjt_f32", **m)
    # f64, B = 1024: the fused run against the non-fused loop, same lanes
    m64, carry64, _, _, _, (sim, bp) = _fused_run(
        DEFAULT_OPTIONS, 1024, 125, 125, seed=46, deck=deck,
        sigmas=JUNCTION_SIGMAS)
    cfg = sim.config.tran
    t0 = time.perf_counter()
    ref = mc.batched_transient(sim.engine, bp, cfg.tstep, 125 * cfg.tstep,
                               fused=False)
    torch.cuda.synchronize()
    m64["nonfused_s"] = time.perf_counter() - t0
    m64["final_max_abs_vs_nonfused"] = float(
        (carry64[0] - ref.x_final).abs().max())
    check(not bool(ref.failed.any()), "bjt_amp non-fused f64 failed lanes")
    check(m64["final_max_abs_vs_nonfused"] <= 1e-9,
          "bjt_amp fused f64 within 1e-9 V of the non-fused run")
    emit("monte_carlo_fused_bjt_f64", **m64)
    return m, main


def phase_monte_carlo_fused_switch():
    rows = {}
    for name, n_steps, chunk, dt in (("chopper", 600, 200, None),
                                     ("mixer_rf", 2000, 500, 1e-9)):
        m, _ = _junction_fused(name, os.path.join(EXAMPLES, f"{name}.sp"),
                               8192, n_steps, chunk, dt=dt)
        emit(f"monte_carlo_fused_{name}_f32", **m)
        rows[name] = m
    return rows


# ------------------------------------------------------------- phase 13
def phase_ac_bjt():
    """Simulator.ac and the batched AC sweep on bjt_amp.sp's .AC card."""
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
    from circuitsimulator_tpu_torch.analysis.ac import (ac_system_real,
                                                        solve_ac_real,
                                                        sweep_frequencies)
    from circuitsimulator_tpu_torch.ops import cuda_ac
    deck = os.path.join(EXAMPLES, "bjt_amp.sp")
    sim64, bp64 = _mc_lanes(DEFAULT_OPTIONS, 4096, 47, deck, JUNCTION_SIGMAS)
    sim32 = Simulator.from_file(deck, opts=damped_f32_options(),
                                device="cuda")
    bp32 = {k: (v.float() if v.is_floating_point() else v)
            for k, v in bp64.items()}
    cfg = sim64.config.ac
    freqs = sweep_frequencies(cfg.sweep_type, cfg.n_points, cfg.fstart,
                              cfg.fstop)
    m64, x64, xr64, xi64 = _ac_run(sim64, bp64, freqs)
    m64["dc_failed_lanes"] = _dc_failed_lanes(sim64.engine, bp64, x64,
                                              1e-6)[0]
    check(m64["dc_failed_lanes"] == 0, "bjt_amp AC: DC failed lanes")
    # the f32 lanes are linearised at the f64 operating points (see _dc_f64)
    m32, _, xr32, xi32 = _ac_run(sim32, bp32, freqs, x_ops=x64.float())
    m32["dc_dtype"] = "float64"
    emit("ac_bjt_f32", deck="bjt_amp", **m32)
    _k3_shape("bjt_amp float32", sim32, bp32, x64.float(), freqs,
              m32["k3_launches"], "ac_bjt_f32")
    _k3_shape("bjt_amp float64", sim64, bp64, x64, freqs,
              m64["k3_launches"], "ac_bjt_f64")
    x64c = torch.complex(xr64, xi64)
    m64["f32_vs_f64_lane_rel"] = _lane_rel_err(
        torch.complex(xr32.double(), xi32.double()), x64c)
    check(m64["f32_vs_f64_lane_rel"] <= 1e-3, "bjt_amp f32 within 1e-3")
    eng, n, F, L = sim64.engine, sim64.engine.N, len(freqs), 64
    G, B1, br, bi = ac_system_real(eng, {k: v[:L] for k, v in bp64.items()},
                                   x64[:L], 1.0)
    om = 2.0 * np.pi * torch.as_tensor(freqs, dtype=torch.float64,
                                       device="cuda")
    rr, ri = solve_ac_real(eng, G[:, None].expand(L, F, n, n),
                           om[None, :, None, None] * B1[:, None],
                           br[:, None].expand(L, F, n),
                           bi[:, None].expand(L, F, n))
    m64["vs_2n_route_lane_rel"] = _lane_rel_err(x64c[:L],
                                                torch.complex(rr, ri))
    check(m64["vs_2n_route_lane_rel"] <= 1e-9, "bjt_amp K3 within 1e-9 of 2N")
    # the single lane through Simulator.ac: one K3 launch, the nominal lane
    before = cuda_ac.LAUNCHES
    one = sim64.ac()
    m64["single_lane_k3_launches"] = cuda_ac.LAUNCHES - before
    check(m64["single_lane_k3_launches"] == 1, "Simulator.ac ran K3 once")
    lane0 = x64c[0].cpu().numpy()
    m64["single_lane_vs_lane0_rel"] = float(
        np.abs(one.xs - lane0).max() / np.abs(lane0).max())
    check(m64["single_lane_vs_lane0_rel"] <= 1e-9, "Simulator.ac vs lane 0")
    m64["gain_db_at_1khz"] = float(20 * np.log10(np.abs(
        one.xs[np.argmin(np.abs(freqs - 1e3)),
               sim64.topo.volt_col_eqs[sim64.topo.volt_col_names.index("c")]])))
    emit("ac_bjt_f64", deck="bjt_amp", **m64)
    m32["dc_k2_launches_f64"] = m64["dc_k2_launches"]
    return m32


# ------------------------------------------------------------- phase 14
def phase_k1d():
    """K1d-i (the Gauss-Jordan solve, the charge rows) against the plain
    version."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    inamp = os.path.join(NETLISTS, "inamp.sp")
    buf = os.path.join(NETLISTS, "buffer.sp")
    rows = []
    for name, deck, cap in (("charge stage (k=12)", CHARGE_DECK, "charge"),
                            ("inamp (k=22)", inamp, "fixed"),
                            ("buffer charge (k=24)", buf, "charge")):
        sim64 = _sim(DEFAULT_OPTIONS.replace(mos_cap_model=cap), deck)
        for opts, tol in ((damped_f32_options(), 1e-4),
                          (DEFAULT_OPTIONS, 1e-10)):
            opts = opts.replace(mos_cap_model=cap)
            f64 = opts.dtype == torch.float64
            from_dc, label = True, "damped from DC"
            tight = name.startswith("buffer") and f64
            if name.startswith("buffer"):
                from_dc, label = False, "damped from x=0"
            if tight:
                opts = opts.replace(tran_tol=1e-13, tran_max_newton_iters=100)
                label = "tran_tol 1e-13 from x=0"
            row, runner, _ = _k1_case(
                f"{name} {str(opts.dtype)[6:]} {label}", _sim(opts, deck),
                256, 8, from_dc, tol, dt=1e-9, sim64=sim64)
            row["gauss_jordan"] = runner.k > 16
            row["charge_rows"] = runner.nCq
            check(row["failed_lanes"] == 0, f"K1d {name}: failed lanes")
            if f64 and not tight:
                check(row["iters_equal"], f"K1d {name}: iteration counts")
            rows.append(row)
    emit("k1d_vs_plain", cases=rows)
    return max(r["max_abs_err"] for r in rows)


def _launch(runner, carry, step0, n, plain=False):
    """K1 (or, with plain, its plain version) on a fused carry: five
    tensors, plus the delay ring of a T-line deck (returned advanced as
    the last output)."""
    run = runner.run_chunk_plain if plain else runner.run_chunk
    return run(*carry[:5], step0, n, tlw=carry[5] if runner.nT else None)


def _k1_at_main_shape(runner, carry, step0, chunk, tol, plain_steps=None,
                      masks_equal=True):
    """K1 at a main path's chunk shape from `carry`: its time and bound,
    and its agreement with the plain version over `plain_steps` (the whole
    chunk by default) from the same carry, error within `tol` on the lanes
    alive in both, failed masks equal unless not `masks_equal` (then the
    differing lanes are counted).  The plain version is timed once, on that
    comparison run: on the charge decks a 250-step chunk of it is about a
    million small launches (50 s), so there it runs 25 steps."""
    import torch
    plain_steps = plain_steps or chunk
    got = _launch(runner, carry, step0, plain_steps)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ref = _launch(runner, carry, step0, plain_steps, plain=True)
    b.record()
    torch.cuda.synchronize()
    alive = ~(got[4] | ref[4])
    check(bool(alive.any()), "main shape: every lane failed")
    ring = [(got[-1], ref[-1])] if runner.nT else []
    err = max(float((a[alive] - b[alive]).abs().max())
              for a, b in list(zip(got[:4], ref[:4])) + ring if a.numel())
    check(err <= tol, f"K1 at the main shape vs plain {err} > {tol}")
    mask_diff = int((got[4] != ref[4]).sum())
    if masks_equal:
        check(mask_diff == 0, "main shape: failed masks")
    full = (got if plain_steps == chunk
            else _launch(runner, carry, step0, chunk))
    nbytes, flops = k1_work(runner, chunk, int(full[5].sum()))
    bms, by = bound_ms(nbytes, flops, runner.dtype)
    return {"B": runner.B, "steps": chunk, "dtype": str(runner.dtype)[6:],
            "N": runner.N, "k": runner.k, "W": runner.W,
            "charge_rows": runner.nCq, "max_abs_err": err, "tol": tol,
            "failed_mask_diff": mask_diff,
            "newton_iters_per_step": float(full[5].float().mean()) / chunk,
            "kernel_ms": cuda_ms(lambda: _launch(runner, carry, step0,
                                                 chunk),
                                 reps=5, warmup=1),
            "plain_ms": a.elapsed_time(b), "plain_steps": plain_steps,
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "flops": flops,
            "plan": k1_plan_row(runner)}


# ------------------------------------------------------------- phase 15
def phase_monte_carlo_fused_inamp():
    """inamp.sp (k = 22, the Gauss-Jordan branch) on the fused path."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    deck = os.path.join(NETLISTS, "inamp.sp")
    m, carry, runner, _, _, _ = _fused_run(fast_f32_options(), 8192, 2000,
                                           250, seed=48, deck=deck,
                                           dc64=True, warm=True)
    m["deck"], m["N"], m["k"], m["W"] = "inamp", runner.N, runner.k, runner.W
    m["dc_dtype"] = "float64"
    m["dc_start"] = "nominal DC with its .NODESET card, then batched_dc_warm"
    check(bool(torch.isfinite(carry[0]).all()), "inamp: non-finite x")
    main = _k1_at_main_shape(runner, carry, 2000, 250, 1e-3)
    m["kernel_at_main_shape"] = main
    m["ms_per_chunk"] = main["kernel_ms"]
    emit("monte_carlo_fused_inamp_f32", **m)
    m64, carry64, _, _, _, (sim, bp) = _fused_run(
        DEFAULT_OPTIONS, 1024, 125, 125, seed=49, deck=deck)
    t0 = time.perf_counter()
    ref = mc.batched_transient(sim.engine, bp, 1e-9, 125e-9, fused=False)
    torch.cuda.synchronize()
    m64["nonfused_s"] = time.perf_counter() - t0
    m64["final_max_abs_vs_nonfused"] = float(
        (carry64[0] - ref.x_final).abs().max())
    check(not bool(ref.failed.any()), "inamp non-fused f64 failed lanes")
    check(m64["final_max_abs_vs_nonfused"] <= 1e-9,
          "inamp fused f64 within 1e-9 V of the non-fused run")
    emit("monte_carlo_fused_inamp_f64", **m64)
    return m, main


# ------------------------------------------------------------- phase 16
def phase_monte_carlo_fused_charge():
    """The charge decks on the fused path, then the charge stage's AC."""
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.analysis.ac import (ac_system_real,
                                                        solve_ac_real)
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    buf = os.path.join(NETLISTS, "buffer.sp")
    f32 = damped_f32_options().replace(mos_cap_model="charge")
    f64 = DEFAULT_OPTIONS.replace(mos_cap_model="charge")
    out = {}
    # buffer.sp in f32: lanes whose output settles near 0 V meet the
    # model's cancellation (phase 14) and can fail; they are counted
    for name, deck, n_steps, chunk, dt, kw in (
            ("charge_stage", CHARGE_DECK, 1000, 250, 1e-9, {"dc64": True}),
            ("buffer_charge", buf, 300, 100, None,
             {"x_zero": True, "allow_failed": True})):
        m, carry, runner, _, _, (sim, bp) = _fused_run(
            f32, 8192, n_steps, chunk, seed=50, deck=deck, dt=dt, **kw)
        m["deck"], m["N"], m["k"], m["W"] = name, runner.N, runner.k, runner.W
        m["start"] = "f64 DC" if "dc64" in kw else "x = 0"
        step0 = n_steps
        if "x_zero" in kw:
            # from the power-up state: later, lanes whose output has settled
            # near 0 V take rounding-dependent paths (phase 14)
            x = torch.zeros_like(carry[0])
            st = sim.engine.init_state(x, bp, runner.dt)
            carry, step0 = (x, x, st["vc"], st["il"],
                            torch.zeros_like(carry[4])), 0
        main = _k1_at_main_shape(runner, carry, step0, chunk, 1e-3,
                                 plain_steps=25,
                                 masks_equal="allow_failed" not in kw)
        m["kernel_at_main_shape"] = main
        m["ms_per_chunk"] = main["kernel_ms"]
        emit(f"monte_carlo_fused_{name}_f32", **m)
        out[name] = (m, main)
    # f64 against the non-fused loop on the same lanes: the charge stage
    # from the DC point, buffer.sp from x = 0 at tran_tol 1e-13 (see phase
    # 14)
    for name, deck, n_steps, opts, x_zero in (
            ("charge_stage", CHARGE_DECK, 30, f64, False),
            ("buffer_charge", buf, 15,
             f64.replace(tran_tol=1e-13, tran_max_newton_iters=100), True)):
        m64, carry64, _, _, _, (sim, bp) = _fused_run(
            opts, 1024, n_steps, n_steps, seed=51, deck=deck, dt=1e-9,
            x_zero=x_zero)
        t0 = time.perf_counter()
        x0 = torch.zeros_like(carry64[0]) if x_zero else None
        ref = mc.batched_transient(sim.engine, bp, 1e-9, n_steps * 1e-9,
                                   fused=False, x0=x0)
        torch.cuda.synchronize()
        m64["deck"], m64["tran_tol"] = name, opts.tran_tol
        m64["nonfused_s"] = time.perf_counter() - t0
        m64["final_max_abs_vs_nonfused"] = float(
            (carry64[0] - ref.x_final).abs().max())
        check(not bool(ref.failed.any()), f"{name} non-fused f64 failed")
        check(m64["final_max_abs_vs_nonfused"] <= 1e-9,
              f"{name} fused f64 within 1e-9 V of the non-fused run")
        emit(f"monte_carlo_fused_{name}_f64", **m64)
    # AC of the charge stage: the charge trans-caps in B1, K3 sweep
    freqs = np.logspace(3, 10, 64)
    sim64, bp64 = _mc_lanes(f64, 4096, 52, CHARGE_AC_DECK)
    sim32 = _sim(f32, CHARGE_AC_DECK)
    bp32 = {k: (v.float() if v.is_floating_point() else v)
            for k, v in bp64.items()}
    m64, x64, xr64, xi64 = _ac_run(sim64, bp64, freqs)
    m32, _, xr32, xi32 = _ac_run(sim32, bp32, freqs, x_ops=x64.float())
    m32["dc_dtype"] = "float64"
    emit("ac_charge_f32", deck="charge stage", **m32)
    _k3_shape("charge stage float32", sim32, bp32, x64.float(), freqs,
              m32["k3_launches"], "ac_charge_f32")
    _k3_shape("charge stage float64", sim64, bp64, x64, freqs,
              m64["k3_launches"], "ac_charge_f64")
    x64c = torch.complex(xr64, xi64)
    m64["f32_vs_f64_lane_rel"] = _lane_rel_err(
        torch.complex(xr32.double(), xi32.double()), x64c)
    check(m64["f32_vs_f64_lane_rel"] <= 1e-3, "charge AC f32 within 1e-3")
    eng, n, F, L = sim64.engine, sim64.engine.N, len(freqs), 64
    G, B1, br, bi = ac_system_real(eng, {k: v[:L] for k, v in bp64.items()},
                                   x64[:L], 1.0)
    om = 2.0 * np.pi * torch.as_tensor(freqs, dtype=torch.float64,
                                       device="cuda")
    rr, ri = solve_ac_real(eng, G[:, None].expand(L, F, n, n),
                           om[None, :, None, None] * B1[:, None],
                           br[:, None].expand(L, F, n),
                           bi[:, None].expand(L, F, n))
    m64["vs_2n_route_lane_rel"] = _lane_rel_err(x64c[:L],
                                                torch.complex(rr, ri))
    check(m64["vs_2n_route_lane_rel"] <= 1e-9,
          "charge AC K3 within 1e-9 of 2N")
    emit("ac_charge_f64", deck="charge stage", **m64)
    out["ac_f32"] = m32
    return out


# ------------------------------------------------------------- phase 17
def phase_k1d_ii():
    """K1d-ii (the B-source rows) against the plain version."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    rows = []
    for name, deck, dt, W in (
            ("B deck", B_DECK, 1e-6, 4),
            ("behavioral", os.path.join(EXAMPLES, "behavioral.sp"), None, 4),
            ("sdomain_filter", os.path.join(EXAMPLES, "sdomain_filter.sp"),
             None, 6)):
        sim64 = _sim(DEFAULT_OPTIONS, deck)
        for opts, tol in ((damped_f32_options(), 1e-4),
                          (DEFAULT_OPTIONS, 1e-9)):
            row, runner, _ = _k1_case(
                f"{name} {str(opts.dtype)[6:]} damped from DC",
                _sim(opts, deck), 256, 10, True, tol, sigmas=B_SIGMAS, dt=dt,
                sim64=sim64)
            row["b_sources"] = runner.nB
            check(runner.W == W and runner.nB > 0, f"K1d-ii {name}: W, nB")
            check(row["failed_lanes"] == 0, f"K1d-ii {name}: failed lanes")
            if opts.dtype == torch.float64:
                check(row["iters_equal"], f"K1d-ii {name}: iteration counts")
            rows.append(row)
    # sdomain_filter (POLY(3) rows, W = 6) at the main width over its own
    # .TRAN (250 steps of 20 us) from the f64 DC: time, plain and bound
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    deck = os.path.join(EXAMPLES, "sdomain_filter.sp")
    sim, bp = _mc_lanes(damped_f32_options(), 8192, 55, deck, B_SIGMAS)
    x0 = _dc_f64(_sim(DEFAULT_OPTIONS, deck), bp)[0]
    carry, _, meta = mc.make_fused_transient_fn(
        sim.engine, bp, sim.config.tran.tstep, x0=x0)
    timing = _k1_at_main_shape(meta["runner"], carry, 0, 250, 1e-3,
                               plain_steps=25)
    timing["case"] = "sdomain_filter f32 damped, main width"
    emit("k1d_ii_vs_plain", cases=rows, timing_per_chunk=timing)
    return max([r["max_abs_err"] for r in rows] + [timing["max_abs_err"]])


# ------------------------------------------------------------- phase 18
def phase_monte_carlo_fused_behavioral():
    """behavioral.sp (three B sources) on the fused path."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    deck = os.path.join(EXAMPLES, "behavioral.sp")
    m, carry, runner, _, _, _ = _fused_run(
        damped_f32_options(), 8192, 5000, 250, seed=53, deck=deck,
        sigmas=B_SIGMAS, dc64=True)
    m["deck"], m["N"], m["k"], m["W"] = ("behavioral", runner.N, runner.k,
                                         runner.W)
    m["b_sources"], m["dc_dtype"] = runner.nB, "float64"
    check(bool(torch.isfinite(carry[0]).all()), "behavioral: non-finite x")
    main = _k1_at_main_shape(runner, carry, 5000, 250, 1e-3, plain_steps=25)
    m["kernel_at_main_shape"] = main
    m["ms_per_chunk"] = main["kernel_ms"]
    emit("monte_carlo_fused_behavioral_f32", **m)
    n = 100
    m64, carry64, _, _, _, (sim, bp) = _fused_run(
        DEFAULT_OPTIONS, 1024, n, n, seed=54, deck=deck, sigmas=B_SIGMAS)
    dt = sim.config.tran.tstep
    t0 = time.perf_counter()
    ref = mc.batched_transient(sim.engine, bp, dt, n * dt, fused=False)
    torch.cuda.synchronize()
    m64["nonfused_s"] = time.perf_counter() - t0
    m64["final_max_abs_vs_nonfused"] = float(
        (carry64[0] - ref.x_final).abs().max())
    check(not bool(ref.failed.any()), "behavioral non-fused f64 failed")
    check(m64["final_max_abs_vs_nonfused"] <= 1e-9,
          "behavioral fused f64 within 1e-9 V of the non-fused run")
    emit("monte_carlo_fused_behavioral_f64", **m64)
    return m, main


# ------------------------------------------------------- phases 19, 20
# behavioral.sp's .TRAN card: 5,000 steps of 2 ns
BEHAVIORAL_TRAN = ".TRAN 2n 10u"


def _cli(args):
    """(exit code, stdout, seconds) of the port's CLI run in-process."""
    from circuitsimulator_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue(), time.perf_counter() - t0


def phase_cli_bsource():
    """The CLI on behavioral.sp (transient) and sdomain_filter.sp (AC) in
    f64 on the card against the JAX CLI's goldens.  behavioral.sp runs
    with its .TRAN cut to the first 500 of its 5,000 steps (a staged
    copy; the DC table it prints does not depend on the card), its CSV
    held to the golden's first 501 rows."""
    import numpy as np
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_b_")
    here = os.getcwd()
    try:
        # the golden names the deck relative to the cwd
        os.makedirs(os.path.join(tmp, "examples"))
        for deck in ("behavioral", "sdomain_filter"):
            shutil.copy(os.path.join(EXAMPLES, f"{deck}.sp"),
                        os.path.join(tmp, "examples"))
        beh = os.path.join(tmp, "examples", "behavioral.sp")
        with open(beh) as f:
            text = f.read()
        check(BEHAVIORAL_TRAN in text, "behavioral.sp's .TRAN card")
        with open(beh, "w") as f:
            f.write(text.replace(BEHAVIORAL_TRAN, ".TRAN 2n 1u"))
        os.chdir(tmp)
        rc, text, out["behavioral_cli_s"] = _cli(
            ["examples/behavioral.sp", "behavioral_tran.csv", "--device",
             "cuda"])
        check(rc == 0, "behavioral CLI exit code")
        gold = read_golden("behavioral_stdout_jax.txt")
        check(text[:len(gold)] == gold,
              "behavioral DC table byte-identical to the JAX CLI's")
        got = np.loadtxt("behavioral_tran.csv", delimiter=",", skiprows=1)
        ref = golden_rows("behavioral_tran_jax.csv", 501)
        check(got.shape == ref.shape, "behavioral CSV shape")
        out["behavioral_csv_max_abs"] = float(np.abs(got - ref).max())
        check(out["behavioral_csv_max_abs"] <= 1e-9,
              "behavioral CSV within 1e-9 V of the JAX golden")
        rc, text, out["sdomain_filter_ac_cli_s"] = _cli(
            ["examples/sdomain_filter.sp", "--no-tran", "--run-ac",
             "sdomain_ac.csv", "--device", "cuda"])
        check(rc == 0, "sdomain_filter --run-ac exit code")
        err, flips = _ac_csv_err("sdomain_ac.csv", os.path.join(
            GOLDENS, "sdomain_filter_ac_jax.csv"))
        out["sdomain_filter_ac_rel_err"] = err
        out["sdomain_filter_ac_print_flips"] = flips
        check(err <= 1e-9, f"sdomain_filter --run-ac within 1e-9: {err}")
    finally:
        os.chdir(here)
        shutil.rmtree(tmp)
    emit("cli_bsource", **out)


def phase_nodeset():
    """inamp.sp's .NODESET DC through the CLI on the card (f64)."""
    from circuitsimulator_tpu_torch.ops import cuda_lu
    cuda_lu.LAUNCHES = 0
    rc, text, secs = _cli([os.path.join(NETLISTS, "inamp.sp"), "--no-tran",
                           "--device", "cuda"])
    check(rc == 0, "inamp CLI DC exit code")
    check("DC analysis finished." in text, "inamp CLI DC table")
    emit("nodeset", deck="inamp", cli_s=secs, k2_launches=cuda_lu.LAUNCHES)

# ------------------------------------------------------------- phase 21
def _probe_mat(N, dtype):
    """A (4, N) probe matrix of +1/-1 pairs, the form StreamingMeasures
    builds: two node voltages, a differential pair, the last unknown."""
    import torch
    pm = torch.zeros((4, N), dtype=dtype, device="cuda")
    pm[0, 0] = 1.0
    pm[1, N // 2] = 1.0
    pm[2, 1] = 1.0
    pm[2, N - 2] -= 1.0
    pm[3, N - 1] = 1.0
    return pm


def phase_k1c_i():
    """K1c-i (the probe stream) against the plain version, on one deck per
    instantiation family, from each lane's f64 DC point."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import fused_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    rows = []
    B, steps = 256, 8
    for name, deck, sigmas in (
            ("dbmixer (K1a)", os.path.join(NETLISTS, "dbmixer.sp"), SIGMAS),
            ("bjt_amp (K1b)", os.path.join(EXAMPLES, "bjt_amp.sp"),
             JUNCTION_SIGMAS),
            ("inamp (K1d-i)", os.path.join(NETLISTS, "inamp.sp"), SIGMAS),
            ("behavioral (K1d-ii)", os.path.join(EXAMPLES, "behavioral.sp"),
             B_SIGMAS)):
        sim64 = _sim(DEFAULT_OPTIONS, deck)
        gen = torch.Generator(device="cuda").manual_seed(61)
        bp64 = mc.perturb_params(sim64.params, gen, B, sigmas)
        x64 = mc.batched_dc_fast(sim64.engine, bp64)
        for opts, tol in ((damped_f32_options(), 1e-4),
                          (DEFAULT_OPTIONS, 1e-9)):
            sim = _sim(opts, deck)
            dt = sim.config.tran.tstep
            bp = {k: (v.to(opts.dtype) if v.is_floating_point() else v)
                  for k, v in bp64.items()}
            x0 = x64.to(opts.dtype)
            pm = _probe_mat(sim.engine.N, opts.dtype)
            runner = fused_step.FusedStepRunner(sim.engine, bp, dt,
                                                probe_mat=pm)
            bare = copy.copy(runner)        # the same constants, no probes
            bare.probe_mat = None
            st = sim.engine.init_state(x0, bp, dt)
            carry = (x0, x0, st["vc"], st["il"],
                     torch.zeros((B,), dtype=torch.bool, device="cuda"))
            got = runner.run_chunk(*carry, 0, steps)
            ref = runner.run_chunk_plain(*carry, 0, steps)
            nop = bare.run_chunk(*carry, 0, steps)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in
                      zip(got[:4] + got[6:], ref[:4] + ref[6:]) if a.numel())
            f64 = opts.dtype == torch.float64
            row = {"case": f"{name} {str(opts.dtype)[6:]} damped from DC",
                   "B": B, "steps": steps, "N": runner.N, "k": runner.k,
                   "W": runner.W, "P": pm.shape[0], "max_abs_err": err,
                   "tol": tol,
                   "ys_max_abs_err": float((got[6] - ref[6]).abs().max()),
                   "last_tile_bitwise": bool(torch.equal(
                       got[6][-1], pm @ got[0].T)),
                   "same_carry_without_probes": all(
                       bool(torch.equal(a, b))
                       for a, b in zip(got[:6], nop[:6])),
                   "failed_equal": bool(torch.equal(got[4], ref[4])),
                   "iters_equal": bool(torch.equal(got[5], ref[5])),
                   "failed_lanes": int(got[4].sum()),
                   "mean_newton_iters": float(got[5].float().mean()) / steps}
            check(err <= tol, f"K1c-i {row['case']}: {err} > {tol}")
            check(row["last_tile_bitwise"], f"K1c-i {row['case']}: the last "
                  "probe tile is not probe_mat @ x_out bit for bit")
            check(row["same_carry_without_probes"],
                  f"K1c-i {row['case']}: probes changed the carry")
            check(row["failed_equal"] and row["failed_lanes"] == 0,
                  f"K1c-i {row['case']}: failed lanes")
            if f64:
                check(row["iters_equal"],
                      f"K1c-i {row['case']}: iteration counts differ")
            rows.append(row)
    emit("k1c_i_vs_plain", cases=rows)
    return max(r["max_abs_err"] for r in rows)


# ------------------------------------------------------------- phase 22
def _measures_run(sim, bp, x0=None, fused="auto"):
    """batched_transient_measures on the card; the counts are reset just
    before and read just after."""
    import torch
    from circuitsimulator_tpu_torch.ops import cuda_ac, cuda_lu, cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    tran = sim.config.tran
    torch.cuda.synchronize()
    cuda_step.LAUNCHES = cuda_lu.LAUNCHES = cuda_ac.LAUNCHES = 0
    t0 = time.perf_counter()
    res, vals = mc.batched_transient_measures(
        sim.engine, bp, tran.tstep, tran.tstop, sim.config.measures,
        sim.topo, fused=fused, x0=x0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    B = mc.lane_count(bp)
    m = {"B": B, "dtype": str(sim.engine.dtype)[6:], "steps": res.n_steps,
         "wall_s": wall, "k1_launches": cuda_step.LAUNCHES,
         "k2_launches": cuda_lu.LAUNCHES,
         "lane_steps_per_s": B * res.n_steps / wall,
         "failed_lanes": int(res.failed.sum())}
    return vals, m


def _measure_chunk(sim, bp, x0, n, plain_steps=None, tol=1e-4):
    """One fused chunk of n steps at the main width: K1 with its probe
    stream and without it, the streaming accumulators over the chunk's
    probe block, the plain version (over plain_steps, all by default) and
    the bound, in ms.  K1 holds the plain version within `tol` V over the
    carry and the probe block, with the same failed lanes, and the chunk's
    last probe tile is probe_mat @ x_out bit for bit."""
    import torch
    from circuitsimulator_tpu_torch.analysis.measure_stream import (
        StreamingMeasures)
    from circuitsimulator_tpu_torch.ops import fused_step
    eng = sim.engine
    dt = sim.config.tran.tstep
    sm = StreamingMeasures(sim.config.measures, sim.topo, eng.dtype,
                           eng.device)
    runner = fused_step.FusedStepRunner(eng, bp, dt,
                                        probe_mat=sm.probe_matrix)
    bare = copy.copy(runner)                # the same constants, no probes
    bare.probe_mat = None
    x0 = x0.to(eng.dtype)
    st = eng.init_state(x0, bp, dt)
    carry = (x0, x0, st["vc"], st["il"],
             torch.zeros((runner.B,), dtype=torch.bool, device="cuda"))
    if runner.nT:
        carry += (st["tlw"],)
    got = _launch(runner, carry, 0, n)
    ys = sm.vals_from_raw(got[6].transpose(1, 2))
    ts = torch.arange(1, n + 1, dtype=eng.dtype, device="cuda") * dt
    dt_t = torch.tensor(dt, dtype=eng.dtype, device="cuda")
    acc0 = sm.init(eng, x0)

    def accumulate():
        acc = acc0
        for i in range(n):
            acc = sm.update_vals(acc, ys[i], ts[i], dt_t)
        return acc

    plain_steps = plain_steps or n
    part = _launch(runner, carry, 0, plain_steps)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ref = _launch(runner, carry, 0, plain_steps, plain=True)
    b.record()
    torch.cuda.synchronize()
    err = max(float((u - v).abs().max()) for u, v in
              zip(part[:4] + part[6:], ref[:4] + ref[6:]) if u.numel())
    check(err <= tol, f"K1c-i at the main shape vs plain {err} > {tol}")
    check(bool(torch.equal(part[4], ref[4])), "K1c-i at the main shape: "
          "failed lanes differ from the plain version's")
    check(bool(torch.equal(got[6][-1], sm.probe_matrix @ got[0].T)),
          "K1c-i at the main shape: the last probe tile is not "
          "probe_mat @ x_out bit for bit")
    nbytes, flops = k1_work(runner, n, int(got[5].sum()))
    bms, by = bound_ms(nbytes, flops, eng.dtype)
    return {"B": runner.B, "steps": n, "dtype": str(eng.dtype)[6:],
            "N": runner.N, "k": runner.k, "P": sm.probe_matrix.shape[0],
            "max_abs_err": err, "tol": tol, "plain_steps": plain_steps,
            "newton_iters_per_step": float(got[5].float().mean()) / n,
            "kernel_ms": cuda_ms(lambda: _launch(runner, carry, 0, n),
                                 reps=5, warmup=1),
            "kernel_ms_without_probes": cuda_ms(
                lambda: _launch(bare, carry, 0, n), reps=5, warmup=1),
            "accumulator_ms": cuda_ms(accumulate, reps=3, warmup=1),
            "plain_ms": a.elapsed_time(b), "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "flops": flops}


def _rel_close(got, want, rtol, atol=0.0):
    """max |got - want| / (atol + rtol |want|) over the lanes (<= 1 holds)."""
    import torch
    w = torch.as_tensor(want).double().cpu()
    g = torch.as_tensor(got).double().cpu()
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


def phase_monte_carlo_measures():
    """The Monte-Carlo measurement path: Simulator.monte_carlo and
    batched_transient_measures on the fused path (K1c-i), against the
    non-fused loop, on three transient decks; batched_ac_measures on K3;
    the CLI's --run-mc."""
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
    from circuitsimulator_tpu_torch.ops import cuda_ac, cuda_lu, cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    out = {}
    mcf = os.path.join(EXAMPLES, "mc_filter.sp")
    # Simulator.monte_carlo(8192) on mc_filter, f32: the fused path
    sim = _sim(damped_f32_options(), mcf)
    torch.cuda.synchronize()
    cuda_step.LAUNCHES = cuda_lu.LAUNCHES = 0
    t0 = time.perf_counter()
    bp, vals = sim.monte_carlo(8192, seed=7)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_steps = 250
    m = {"deck": "mc_filter", "B": 8192, "dtype": "float32",
         "steps": n_steps, "wall_s": wall,
         "k1_launches": cuda_step.LAUNCHES, "k2_launches": cuda_lu.LAUNCHES,
         "lane_steps_per_s": 8192 * n_steps / wall}
    check(m["k1_launches"] > 0, "Simulator.monte_carlo ran through K1")
    # the same lanes again on the fused path: its failed lanes, and the
    # values within f32 rounding (the CUDA assembly's index_add sums in
    # no fixed order, so two runners of the same lanes differ in the last
    # bits of G0^-1)
    again, m2 = _measures_run(sim, bp, fused=True)
    m["failed_lanes"] = m2["failed_lanes"]
    m["rerun_worst_ratio"] = max(_rel_close(vals[k], again[k], 2e-4, 2e-6)
                                 for k in vals)
    check(m["failed_lanes"] == 0, "mc_filter: failed lanes")
    check(m["rerun_worst_ratio"] <= 1.0,
          "Simulator.monte_carlo agrees with the fused path")
    check(all(bool(torch.isfinite(v).all()) for v in vals.values()),
          "mc_filter: non-finite measures")
    m["measures"] = {k: {"mean": float(v.double().mean()),
                         "std": float(v.double().std())}
                     for k, v in vals.items()}
    m["chunk"] = _measure_chunk(sim, bp, mc.batched_dc_fast(sim.engine, bp),
                                n_steps)
    emit("monte_carlo_measures_mc_filter_f32", **m)
    out["mc_filter"] = m
    # fused against the non-fused loop on 1,024 lanes, f32 and f64
    for opts, rtol, atol in ((damped_f32_options(), 2e-4, 2e-6),
                             (DEFAULT_OPTIONS, 1e-9, 0.0)):
        s2 = _sim(opts, mcf)
        bp2 = mc.perturb_params_netlist(
            s2.params, torch.Generator(device="cuda").manual_seed(8), 1024,
            s2.lowered.mc_tols)
        fv, fm = _measures_run(s2, bp2, fused=True)
        nv, nm = _measures_run(s2, bp2, fused=False)
        r = {"B": 1024, "dtype": fm["dtype"], "fused": fm, "nonfused": nm,
             "rtol": rtol, "atol": atol,
             "worst_ratio": max(_rel_close(fv[k], nv[k], rtol, atol)
                                for k in nv)}
        check(fm["k1_launches"] > 0 and nm["k1_launches"] == 0,
              "fused vs non-fused: the paths")
        check(fm["failed_lanes"] == 0 and nm["failed_lanes"] == 0,
              "fused vs non-fused: failed lanes")
        check(r["worst_ratio"] <= 1.0,
              f"mc_filter fused vs non-fused {fm['dtype']}: "
              f"{r['worst_ratio']}")
        emit(f"monte_carlo_measures_mc_filter_vs_nonfused_{fm['dtype']}",
             **r)
    # bjt_amp's vout_pp at B = 8192 from an f64 DC (phase 11's lanes)
    deck = os.path.join(EXAMPLES, "bjt_amp.sp")
    sim, bp = _mc_lanes(ref_f32_options(), 8192, 45, deck, JUNCTION_SIGMAS)
    x64 = _dc_f64(_sim(DEFAULT_OPTIONS, deck), bp)[0]
    vals, m = _measures_run(sim, bp, x0=x64)
    pp = vals["vout_pp"]
    m["deck"] = "bjt_amp"
    m["vout_pp_lane0"] = float(pp[0])
    m["vout_pp_lane0_rel_vs_jax_cli"] = abs(float(pp[0]) / 7.398583977e-02
                                            - 1.0)
    m["vout_pp_mean"], m["vout_pp_std"] = (float(pp.double().mean()),
                                           float(pp.double().std()))
    check(m["k1_launches"] > 0 and m["failed_lanes"] == 0,
          "bjt_amp measures: K1, failed lanes")
    check(bool(torch.isfinite(pp).all() & (pp > 0).all()), "bjt_amp vout_pp")
    check(m["vout_pp_lane0_rel_vs_jax_cli"] <= 1e-3,
          "bjt_amp nominal vout_pp within 1e-3 of the JAX CLI's")
    m["chunk"] = _measure_chunk(sim, bp, x64, 250, plain_steps=25)
    emit("monte_carlo_measures_bjt_amp_f32", **m)
    out["bjt_amp"] = m
    # rc_step's WHEN crossings at B = 8192 over 2,000 steps
    deck = os.path.join(EXAMPLES, "rc_step.sp")
    sim, bp = _mc_lanes(ref_f32_options(), 8192, 47, deck,
                        {"res_r": 0.05, "cap_c": 0.05})
    vals, m = _measures_run(sim, bp)
    tau = (bp["res_r"][:, 0] * bp["cap_c"][:, 0]).double()
    m["deck"] = "rc_step"
    m["t63_vs_tau_rel_max"] = float((vals["t63"].double()
                                     / (tau * -np.log(1 - 0.632)) - 1).abs()
                                    .max())
    m["t63_lane0_rel_vs_jax_cli"] = abs(float(vals["t63"][0])
                                        / 1.005565901e-06 - 1.0)
    m["t90_lane0_rel_vs_jax_cli"] = abs(float(vals["t90"][0])
                                        / 2.321706292e-06 - 1.0)
    check(m["k1_launches"] == 4 and m["failed_lanes"] == 0,
          "rc_step measures: four K1 chunks, no failed lane")
    check(all(bool(torch.isfinite(v).all()) for v in vals.values()),
          "rc_step: every lane crosses")
    check(m["t63_vs_tau_rel_max"] <= 2e-2, "rc_step t63 tracks R C")
    check(max(m["t63_lane0_rel_vs_jax_cli"],
              m["t90_lane0_rel_vs_jax_cli"]) <= 1e-4,
          "rc_step nominal crossings within 1e-4 of the JAX CLI's")
    m["chunk"] = _measure_chunk(
        sim, bp, mc.batched_dc_fast(sim.engine, bp), 512, plain_steps=50)
    emit("monte_carlo_measures_rc_step_f32", **m)
    out["rc_step"] = m
    # batched_ac_measures on opamp_filter at B = 4096 (K3)
    deck = os.path.join(EXAMPLES, "opamp_filter.sp")
    from circuitsimulator_tpu_torch.analysis.ac import sweep_frequencies
    sim, bp = _mc_lanes(ref_f32_options(), 4096, 49, deck,
                        {"res_r": 0.02, "cap_c": 0.02})
    ac = sim.config.ac
    freqs = sweep_frequencies(ac.sweep_type, ac.n_points, ac.fstart,
                              ac.fstop)
    torch.cuda.synchronize()
    cuda_ac.LAUNCHES = cuda_lu.LAUNCHES = 0
    t0 = time.perf_counter()
    avals = mc.batched_ac_measures(sim.engine, sim.topo, bp, freqs,
                                   sim.config.measures)
    wall = time.perf_counter() - t0
    k3, k2 = cuda_ac.LAUNCHES, cuda_lu.LAUNCHES
    sim64 = _sim(DEFAULT_OPTIONS, deck)
    nominal = dict(sim64.measure(sim64.ac(), analysis="ac"))
    m = {"deck": "opamp_filter", "B": 4096, "F": len(freqs),
         "dtype": "float32", "wall_s": wall, "k3_launches": k3,
         "k2_launches": k2,
         "f3db_lane0": float(avals["f3db"][0]),
         "f3db_nominal_f64": nominal["f3db"],
         "f3db_mean": float(np.mean(avals["f3db"])),
         "f3db_std": float(np.std(avals["f3db"]))}
    m["f3db_lane0_rel"] = abs(m["f3db_lane0"] / nominal["f3db"] - 1.0)
    check(m["k3_launches"] > 0, "batched_ac_measures ran through K3")
    check(all(np.isfinite(v).all() for v in avals.values()),
          "opamp_filter AC measures finite")
    check(m["f3db_lane0_rel"] <= 1e-3, "opamp_filter nominal f3db")
    emit("monte_carlo_measures_ac_opamp_filter_f32", **m)
    out["ac"] = m
    _k3_shape("opamp_filter float32", sim, bp,
              mc.batched_dc_fast(sim.engine, bp), freqs, k3,
              "monte_carlo_measures_ac_opamp_filter_f32")
    # the CLI's --run-mc 8192 on mc_filter, f32 (the fused path)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mc_")
    try:
        csv = os.path.join(tmp, "mc.csv")
        cuda_step.LAUNCHES = 0
        rc, text, secs = _cli([mcf, os.path.join(tmp, "t.csv"), "--device",
                               "cuda", "--dtype", "f32", "--run-mc", "8192",
                               "--run-mc-out", csv])
        with open(csv) as f:
            rows = f.read().splitlines()
        m = {"cli_s": secs, "k1_launches": cuda_step.LAUNCHES,
             "csv_rows": len(rows) - 1, "header": rows[0]}
        check(rc == 0 and "==== Monte-Carlo measure statistics ====" in text,
              "--run-mc exit code and statistics block")
        check(rows[0] == "lane,settle,vfinal" and m["csv_rows"] == 8192,
              "--run-mc CSV")
        check(m["k1_launches"] > 0, "--run-mc --dtype f32 ran through K1")
    finally:
        shutil.rmtree(tmp)
    emit("monte_carlo_measures_cli_run_mc", **m)
    out["cli"] = m
    return out


# ------------------------------------------------------------- phase 23
def phase_cli_measures():
    """The CLI's .MEASURE output on the card (f64) against the JAX CLI's
    stdout."""
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_m_")
    here = os.getcwd()
    try:
        # the goldens name the deck and the CSV relative to the cwd
        os.makedirs(os.path.join(tmp, "examples"))
        for deck in ("rc_step", "mc_filter", "bjt_amp"):
            shutil.copy(os.path.join(EXAMPLES, f"{deck}.sp"),
                        os.path.join(tmp, "examples"))
        os.chdir(tmp)
        for deck in ("rc_step", "mc_filter"):
            rc, text, out[f"{deck}_cli_s"] = _cli(
                [f"examples/{deck}.sp", f"{deck}_tran.csv", "--device",
                 "cuda"])
            check(rc == 0 and text == read_golden(f"{deck}_stdout_jax.txt"),
                  f"{deck} stdout byte-identical to the JAX CLI's")
        rc, text, out["bjt_amp_run_ac_cli_s"] = _cli(
            ["examples/bjt_amp.sp", "bjt_amp_tran.csv", "--device", "cuda",
             "--run-ac", "bjt_amp_ac.csv"])
        check(rc == 0 and text == read_golden(
            "bjt_amp_run_ac_stdout_jax.txt"),
              "bjt_amp --run-ac stdout byte-identical to the JAX CLI's, its "
              ".TF block included")
    finally:
        os.chdir(here)
        shutil.rmtree(tmp)
    emit("cli_measures", **out)


# ------------------------------------------------------------- phase 24
def phase_k1c_ii():
    """K1c-ii (the delay ring) against the plain version on one deck per
    instantiation family, 256 lanes from each lane's f64 DC point, two
    launches in a row so the ring crosses a launch boundary and its head
    wraps (except tline_reflect's 100 slots, which the two launches of 60
    steps cross once)."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import fused_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    with open(os.path.join(EXAMPLES, "delay_osc.sp")) as f:
        osc = f.read() + ".TRAN 0.1n 40n\n"
    rows = []
    B = 256
    for name, deck, dt, chunks, kick in (
            ("TL_DECK (K1b)", TL_DECK, 0.25e-9, (13, 11), None),
            ("tline_reflect (k = 0)", os.path.join(EXAMPLES,
                                                   "tline_reflect.sp"),
             1e-10, (60, 60), None),
            ("delay_osc (B)", osc, 1e-10, (30, 30), "a"),
            ("charge stage + line (K1d-i)", CHARGE_TL_DECK, 1e-9, (7, 6),
             None)):
        sim64 = _sim(DEFAULT_OPTIONS, deck)
        gen = torch.Generator(device="cuda").manual_seed(71)
        bp64 = mc.perturb_params(sim64.params, gen, B, TL_SIGMAS)
        x64 = mc.batched_dc_fast(sim64.engine, bp64).clone()
        if kick:
            # the oscillator rests at 0 V: start every lane from a kick
            # of 0.05-0.2 V at its amplifier input
            e = sim64.circuit.nodes[
                sim64.circuit.node_name_to_id[kick]].eq_index
            x64[:, e] += 0.05 + 0.15 * torch.rand(
                B, generator=gen, dtype=torch.float64, device="cuda")
        for opts, tol in ((damped_f32_options(), 1e-4),
                          (DEFAULT_OPTIONS, 1e-9)):
            sim = _sim(opts, deck)
            bp = {k: (v.to(opts.dtype) if v.is_floating_point() else v)
                  for k, v in bp64.items()}
            x0 = x64.to(opts.dtype)
            runner = fused_step.FusedStepRunner(sim.engine, bp, dt)
            st = sim.engine.init_state(x0, bp, dt)
            carry = (x0, x0, st["vc"], st["il"],
                     torch.zeros((B,), dtype=torch.bool, device="cuda"),
                     st["tlw"])
            kc, pc, step0, iters_equal = carry, carry, 0, True
            for n in chunks:
                got = _launch(runner, kc, step0, n)
                ref = _launch(runner, pc, step0, n, plain=True)
                iters_equal &= bool(torch.equal(got[5], ref[5]))
                kc, pc = got[:5] + got[-1:], ref[:5] + ref[-1:]
                step0 += n
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max())
                      for a, b in zip(kc[:4], pc[:4]) if a.numel())
            ring_err = float((kc[5] - pc[5]).abs().max())
            row = {"case": f"{name} {str(opts.dtype)[6:]} damped",
                   "B": B, "chunks": list(chunks), "N": runner.N,
                   "k": runner.k, "W": runner.W, "nT": runner.nT,
                   "b_sources": runner.nB, "charge_rows": runner.nCq,
                   "Dmax": runner.Dmax,
                   "read_slots": runner.tl_read.tolist(),
                   "max_abs_err": max(err, ring_err), "x_max_abs_err": err,
                   "ring_max_abs_err": ring_err, "tol": tol,
                   # the Engine's layout: slot 0 holds the wave of the last
                   # x, slot 1 that of the x before it
                   "ring_slots_0_1_bitwise": all(
                       bool(torch.equal(kc[5][:, q], sim.engine._tl_wave_now(
                           bp, kc[q]))) for q in (0, 1)),
                   "failed_equal": bool(torch.equal(kc[4], pc[4])),
                   "iters_equal": iters_equal,
                   "failed_lanes": int(kc[4].sum()),
                   "x_final_max_abs": float(kc[0].abs().max())}
            c = row["case"]
            check(max(err, ring_err) <= tol, f"K1c-ii {c}: {err}, "
                  f"{ring_err} > {tol}")
            check(row["ring_slots_0_1_bitwise"],
                  f"K1c-ii {c}: the ring is not in the Engine's layout")
            check(row["failed_equal"] and row["failed_lanes"] == 0,
                  f"K1c-ii {c}: failed lanes")
            if opts.dtype == torch.float64:
                check(iters_equal, f"K1c-ii {c}: iteration counts differ")
            rows.append(row)
    check(rows[4]["b_sources"] == 1 and rows[6]["charge_rows"] > 0,
          "delay_osc ran the B instantiation, the charge stage its rows")
    emit("k1c_ii_vs_plain", cases=rows)
    return max(r["max_abs_err"] for r in rows)


# ------------------------------------------------------------- phase 25
def phase_monte_carlo_tline():
    """The T-line main paths: batched_transient on the bench workload at
    B = 8192 (K1 with its delay ring), fused against non-fused on 1,024
    lanes, batched_transient_measures on tline_reflect.sp at B = 8192 (the
    probe stream and the ring together), and the matched line's AC at
    B = 1024 x F = 64 (K2, never K3)."""
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.analysis.ac import ac_analysis_batched
    from circuitsimulator_tpu_torch.ops import cuda_ac, cuda_lu, cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    out = {}
    dt, n_steps, B = 0.25e-9, 4000, 8192
    sim, bp = _mc_lanes(damped_f32_options(), B, 73, TL_BENCH_DECK,
                        TL_SIGMAS)
    torch.cuda.synchronize()
    cuda_step.LAUNCHES = cuda_lu.LAUNCHES = 0
    t0 = time.perf_counter()
    res = mc.batched_transient(sim.engine, bp, dt, n_steps * dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = {"deck": "TL_BENCH_DECK", "B": B, "dtype": "float32",
         "configuration": "damped", "steps": n_steps, "dt": dt,
         "wall_s": wall,
         "k1_launches": cuda_step.LAUNCHES, "k2_launches": cuda_lu.LAUNCHES,
         "lane_steps_per_s": B * n_steps / wall,
         "failed_lanes": int(res.failed.sum()),
         "newton_iters_per_step": float(res.newton_iters.float().mean())
         / n_steps}
    check(m["k1_launches"] > 0, "batched_transient ran through K1")
    check(m["failed_lanes"] == 0, "TL deck: failed lanes")
    check(bool(torch.isfinite(res.x_final).all()), "TL deck: finite x")
    # the run's set-up alone (batched DC on K2, the runner's constants),
    # then K1 at the run's chunk shape (2,000 steps) from the DC point
    t0 = time.perf_counter()
    carry, _, meta = mc.make_fused_transient_fn(sim.engine, bp, dt)
    torch.cuda.synchronize()
    m["setup_s"] = time.perf_counter() - t0
    main = _k1_at_main_shape(meta["runner"], carry, 0, 2000, 1e-3,
                             plain_steps=100)
    main["case"] = "TL_BENCH_DECK f32 damped"
    m["kernel_at_main_shape"] = main
    # the benchmark's own fast configuration (alpha 1, predictor, two
    # unrolled iterations), recorded and not held: on the diode clamp it is
    # chaotic, and the JAX package's own Pallas kernel (interpret mode) and
    # XLA loop, bit-equal through step 12, part by 0.46 V at step 14 and
    # 1.31 V within 100 steps on 128 lanes (ROADMAP queue 3)
    fsim, fbp = _mc_lanes(fast_f32_options(), B, 73, TL_BENCH_DECK,
                          TL_SIGMAS)
    fcarry, _, fmeta = mc.make_fused_transient_fn(fsim.engine, fbp, dt)
    got = _launch(fmeta["runner"], fcarry, 0, 100)
    ref = _launch(fmeta["runner"], fcarry, 0, 100, plain=True)
    # its bound at two Newton iterations per lane-step (the unrolled count)
    fbytes, fflops = k1_work(fmeta["runner"], 2000, 2 * B * 2000)
    fbms, fby = bound_ms(fbytes, fflops, torch.float32)
    m["fast_configuration"] = {
        "kernel_vs_plain_max_abs_after_100_steps": float(
            (got[0] - ref[0]).abs().max()),
        "kernel_ms_per_2000_steps": cuda_ms(
            lambda: _launch(fmeta["runner"], fcarry, 0, 2000), reps=3,
            warmup=1),
        "bound_ms": fbms, "bound_by": fby, "bytes": fbytes, "flops": fflops,
        "not_held": "chaotic configuration: the JAX package's Pallas kernel "
                    "and XLA loop part by 1.31 V on the same lanes"}
    emit("monte_carlo_tline_f32", **m)
    out["bench"], out["bench_main"] = m, main
    # fused against non-fused on 1,024 lanes over 400 steps (the damped
    # configuration of tests/test_pallas_step.py in f32, atol 5e-5; f64
    # within 1e-9)
    for opts, tol in ((damped_f32_options(), 5e-5), (DEFAULT_OPTIONS, 1e-9)):
        s2, bp2 = _mc_lanes(opts, 1024, 74, TL_BENCH_DECK, TL_SIGMAS)
        cuda_step.LAUNCHES = 0
        fr = mc.batched_transient(s2.engine, bp2, dt, 400 * dt, fused=True)
        k1 = cuda_step.LAUNCHES
        nr = mc.batched_transient(s2.engine, bp2, dt, 400 * dt, fused=False)
        torch.cuda.synchronize()
        r = {"B": 1024, "dtype": str(opts.dtype)[6:], "steps": 400,
             "k1_launches": k1, "tol": tol,
             "failed_lanes": int(fr.failed.sum() + nr.failed.sum()),
             "final_max_abs_vs_nonfused": float(
                 (fr.x_final - nr.x_final).abs().max())}
        check(k1 > 0 and r["failed_lanes"] == 0,
              "T-line fused vs non-fused: K1, failed lanes")
        check(r["final_max_abs_vs_nonfused"] <= tol,
              f"T-line fused vs non-fused {r['dtype']}: "
              f"{r['final_max_abs_vs_nonfused']} > {tol}")
        emit(f"monte_carlo_tline_vs_nonfused_{r['dtype']}", **r)
    # tline_reflect's WHEN and MAX measures at B = 8192, Rs 2% (lane 0
    # nominal), in the reference configuration: K1 with its probe stream
    # and the ring
    deck = os.path.join(EXAMPLES, "tline_reflect.sp")
    sim = _sim(ref_f32_options(), deck)
    bp = mc.broadcast_params(sim.params, B)
    gen = torch.Generator(device="cuda").manual_seed(75)
    rs = sim.params["res_r"][0] * torch.exp(0.02 * torch.randn(
        B, generator=gen, device="cuda"))
    rs[0] = sim.params["res_r"][0]
    bp["res_r"] = bp["res_r"].clone()
    bp["res_r"][:, 0] = rs
    vals, m = _measures_run(sim, bp)
    m["deck"] = "tline_reflect"
    m["arrival_lane0_rel_vs_jax_cli"] = abs(float(vals["arrival"][0])
                                            / 1.005000386e-08 - 1.0)
    m["vpeak_lane0_rel_vs_jax_cli"] = abs(float(vals["vpeak"][0])
                                          / 9.999249544e-01 - 1.0)
    m["measures"] = {k: {"mean": float(v.double().mean()),
                         "std": float(v.double().std())}
                     for k, v in vals.items()}
    check(m["k1_launches"] > 0 and m["failed_lanes"] == 0,
          "tline_reflect measures: K1, failed lanes")
    check(all(bool(torch.isfinite(v).all()) for v in vals.values()),
          "tline_reflect measures finite")
    check(max(m["arrival_lane0_rel_vs_jax_cli"],
              m["vpeak_lane0_rel_vs_jax_cli"]) <= 1e-4,
          "tline_reflect nominal measures within 1e-4 of the JAX CLI's")
    m["chunk"] = _measure_chunk(sim, bp, mc.batched_dc_fast(sim.engine, bp),
                                512, plain_steps=100)
    emit("monte_carlo_tline_measures_f32", **m)
    out["measures"] = m
    # the matched line's AC at B = 1024 x F = 64 (1 MHz .. 1 GHz): the
    # per-frequency route on K2; lane 0 (nominal) against the exact line,
    # |V(in)| = 0.5 and V(out) = V(in) e^{-j w TD}
    freqs = np.logspace(6, 9, 64)
    for opts, tol in ((ref_f32_options(), 1e-4), (DEFAULT_OPTIONS, 1e-9)):
        sim, bp = _mc_lanes(opts, 1024, 76, TL_AC_DECK,
                            {"res_r": 0.02, "tl_z0": 0.02})
        torch.cuda.synchronize()
        cuda_lu.LAUNCHES = cuda_ac.LAUNCHES = 0
        t0 = time.perf_counter()
        acres = ac_analysis_batched(sim.engine, bp, freqs)
        wall = time.perf_counter() - t0
        xs = acres.xs
        ein, eout = (sim.circuit.nodes[sim.circuit.node_name_to_id[n]]
                     .eq_index for n in ("in", "out"))
        want_in = 0.5 * np.ones(len(freqs))
        want_out = 0.5 * np.exp(-2j * np.pi * freqs * 10e-9)
        err = max(float(np.abs(np.abs(xs[0, :, ein]) - want_in).max()),
                  float(np.abs(xs[0, :, eout] / xs[0, :, ein] * 0.5
                               - want_out).max()))
        a = {"deck": "matched line", "B": 1024, "F": len(freqs),
             "dtype": str(opts.dtype)[6:], "wall_s": wall,
             "solves_per_s": 1024 * len(freqs) / wall,
             "k2_launches": cuda_lu.LAUNCHES,
             "k3_launches": cuda_ac.LAUNCHES, "lane0_vs_exact": err,
             "tol": tol, "finite": bool(np.isfinite(xs).all())}
        check(a["k2_launches"] > 0 and a["k3_launches"] == 0,
              "T-line AC: K2, never K3")
        check(a["finite"] and err <= tol, f"T-line AC lane 0: {err}")
        emit(f"ac_tline_{a['dtype']}", **a)
        out[f"ac_{a['dtype']}"] = a
    return out


# ------------------------------------------------------------- phase 26
def phase_cli_tline():
    """The CLI on tline_reflect.sp in f64 on the card against the JAX
    CLI's stdout and CSV."""
    import numpy as np
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_t_")
    here = os.getcwd()
    try:
        # the golden names the deck and the CSV relative to the cwd
        os.makedirs(os.path.join(tmp, "examples"))
        shutil.copy(os.path.join(EXAMPLES, "tline_reflect.sp"),
                    os.path.join(tmp, "examples"))
        os.chdir(tmp)
        rc, text, out["cli_s"] = _cli(
            ["examples/tline_reflect.sp", "tline_reflect_tran.csv",
             "--device", "cuda"])
        check(rc == 0 and text == read_golden(
            "tline_reflect_stdout_jax.txt"),
            "tline_reflect stdout byte-identical to the JAX CLI's")
        got = np.loadtxt("tline_reflect_tran.csv", delimiter=",",
                         skiprows=1)
        ref = golden_rows("tline_reflect_tran_jax.csv", None)
        check(got.shape == ref.shape, "tline_reflect CSV shape")
        out["csv_max_abs"] = float(np.abs(got - ref).max())
        check(out["csv_max_abs"] <= 1e-9,
              "tline_reflect CSV within 1e-9 V of the JAX golden")
    finally:
        os.chdir(here)
        shutil.rmtree(tmp)
    emit("cli_tline", **out)


# ------------------------------------------------------------- phase 27
# TRNOISE (K1c-iii): benchmarks/bench_trnoise.py's noisy dbmixer (white
# noise on the LO+ source, 1 mV RMS per step) and the white + flicker deck
# of tests/test_trnoise_fused.py, whose draws tests/goldens/
# trnoise_stream_jax.csv holds as the JAX package makes them
NOISY_DBMIXER_FROM = "Vlo+ 154 0 SIN 1 0.6 900e6 0"
WHITE_NOISE_DECK = """* white noise, V and I sources, diode load
V1 in 0 DC 1 TRNOISE(5m 0)
I1 0 out 1m TRNOISE(2u 2.5e-7)
R1 in out 1k
R2 out 0 1k
C1 out 0 1n
D1 out 0
.TRAN 1e-7 4e-6
"""
FLICKER_DECK = """* white + flicker, sample-hold window
V1 in 0 DC 1 TRNOISE(2m 3e-7 1.0 1m)
R1 in out 1k
R2 out 0 1k
C1 out 0 1n
.TRAN 1e-7 3e-6
.MEASURE TRAN vavg AVG V(out) FROM=0 TO=3e-6
"""


def _noisy_dbmixer():
    with open(os.path.join(NETLISTS, "dbmixer.sp")) as f:
        deck = f.read()
    check(NOISY_DBMIXER_FROM in deck, "dbmixer's LO+ card")
    return deck.replace(NOISY_DBMIXER_FROM,
                        NOISY_DBMIXER_FROM + " TRNOISE(1m 0)")


def _ulps32(a, b):
    import numpy as np
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _stream_golden_check():
    """The torch threefry on the card against the JAX-made golden: lanes
    0-3 of split(key(123), 8192) on FLICKER_DECK in f32, 64 steps (the
    computation of tests/test_torch_trnoise.py port_stream_table)."""
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    from circuitsimulator_tpu_torch.utils import prng
    gold = np.loadtxt(os.path.join(GOLDENS, "trnoise_stream_jax.csv"),
                      delimiter=",", skiprows=1)
    with open(os.path.join(GOLDENS, "trnoise_stream_jax.csv")) as f:
        cols = f.readline().strip().split(",")
    g = {c: gold[:, i] for i, c in enumerate(cols)}
    lanes, n, dt = 4, 64, 1e-7
    sim = _sim(DEFAULT_OPTIONS.replace(dtype=torch.float32), FLICKER_DECK)
    keys = prng.split(prng.key(123, "cuda"), 8192)[:lanes]
    steps = torch.arange(1, n + 1, device="cuda")
    j = torch.floor(steps.float() * torch.tensor(dt, device="cuda")
                    / torch.clamp_min(sim.params["vs_tn"][0, 1], 1e-30)).long()
    wk = prng.fold_in(prng.fold_in(prng.fold_in(keys, 0), 0)[:, None], j)
    base = prng.fold_in(keys, 4)
    fk = prng.fold_in(base[:, None], steps)
    fk[:, 0] = base
    tnv = sim.engine.trnoise_stream(mc.broadcast_params(sim.params, lanes),
                                    keys, 0, n, dt)[0][:, :, 0].T
    got = {"j": j.expand(lanes, -1), "white_bits": prng.bits(wk),
           "white_z": prng.normal(wk, (), torch.float32),
           "flicker_bits": prng.bits(fk, (1, 16))[:, :, 0],
           "flicker_z": prng.normal(fk, (1, 16), torch.float32)[:, :, 0],
           "tn_v": tnv}
    got = {k: v.cpu().numpy().reshape(lanes * n, -1).squeeze(-1)
           if v.dim() == 2 else v.cpu().numpy().reshape(lanes * n, 16)
           for k, v in got.items()}
    fb = np.stack([g[f"flicker_bits_{m}"] for m in range(16)], 1)
    fz = np.stack([g[f"flicker_z_{m}"] for m in range(16)], 1)
    r = {"lanes": lanes, "steps": n,
         "hold_index_equal": bool(np.array_equal(got["j"], g["j"])),
         "white_bits_equal": bool(np.array_equal(got["white_bits"],
                                                 g["white_bits"])),
         "flicker_bits_equal": bool(np.array_equal(got["flicker_bits"], fb)),
         "white_z_max_ulps": int(_ulps32(got["white_z"], g["white_z"]).max()),
         "flicker_z_max_ulps": int(_ulps32(got["flicker_z"], fz).max()),
         "white_z_bitwise_share": float(
             (_ulps32(got["white_z"], g["white_z"]) == 0).mean()),
         "tn_v_max_abs_rel": float(np.abs(got["tn_v"] - g["tn_v"]).max()
                                   / np.abs(g["tn_v"]).max())}
    check(r["hold_index_equal"] and r["white_bits_equal"]
          and r["flicker_bits_equal"], "threefry bits on the card vs JAX")
    check(max(r["white_z_max_ulps"], r["flicker_z_max_ulps"]) <= 2,
          "normals on the card within 2 ulp of JAX's")
    check(r["tn_v_max_abs_rel"] <= 1e-5, "the stream on the card vs JAX's")
    return r


def _noisy_k1_vs_plain(opts, B, steps, tol, seed, deck=None,
                       sigmas=SIGMAS):
    """K1c-iii against its plain version on a noisy deck (the noisy dbmixer
    by default) from each lane's DC point, the noise block of the run's
    own stream (key 123)."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    from circuitsimulator_tpu_torch.utils import prng
    sim, bp = _mc_lanes(opts, B, seed, deck or _noisy_dbmixer(), sigmas)
    dt = sim.config.tran.tstep
    x0 = None
    if deck:    # a diode deck starts from an f64 DC point (phase 10)
        x0 = _dc_f64(_sim(DEFAULT_OPTIONS, deck), bp)[0]
    carry, _, meta = mc.make_fused_transient_fn(
        sim.engine, bp, dt, chunk=steps, x0=x0, noise_key=prng.key(123))
    runner, feed = meta["runner"], meta["feed"]
    nz, _ = feed.block(carry[-1], 0, steps)
    got = runner.run_chunk(*carry[:5], 0, steps, noise=nz)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ref = runner.run_chunk_plain(*carry[:5], 0, steps, noise=nz)
    b.record()
    torch.cuda.synchronize()
    err = max(float((x - y).abs().max()) for x, y in zip(got[:4], ref[:4])
              if x.numel())
    row = {"deck": "white" if deck else "dbmixer",
           "dtype": str(opts.dtype)[6:], "B": B, "steps": steps,
           "nN": runner.nN, "noise_idx": runner.noise_idx.tolist(),
           "max_abs_err": err, "tol": tol,
           "iters_equal": bool(torch.equal(got[5], ref[5])),
           "failed_equal": bool(torch.equal(got[4], ref[4])),
           "failed_lanes": int(got[4].sum()),
           "noise_rms": float(nz.double().pow(2).mean().sqrt()),
           "plain_ms": a.elapsed_time(b)}
    check(err <= tol, f"K1c-iii {row['deck']} {row['dtype']}: {err} > {tol}")
    check(row["failed_equal"] and row["failed_lanes"] == 0,
          f"K1c-iii {row['deck']} {row['dtype']}: failed lanes")
    if opts.dtype == torch.float64:
        check(row["iters_equal"], "K1c-iii f64: iteration counts differ")
    return row, (runner, feed, carry, nz, got)


def phase_trnoise():
    """TRNOISE on the card: the threefry against the JAX golden, K1c-iii
    against its plain version, fused against non-fused noisy runs, and
    the noisy dbmixer main path against its noise-free twin."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_lu, cuda_step, fused_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    from circuitsimulator_tpu_torch.utils import prng
    t_phase = time.perf_counter()
    out = {"golden": _stream_golden_check()}
    emit("trnoise_threefry_vs_jax_golden", **out["golden"])
    # (1) K1c-iii against its plain version at the main chunk shape
    # (B = 8192): in f64 on the noisy dbmixer, damped (1e-12 V, equal
    # iteration counts); in f32 on the white V + I noise deck, damped
    # (5e-5 V), and on the noisy dbmixer in the benchmark's fast
    # configuration, held to phase 7's 2e-4 V: on dbmixer K1 and its plain
    # version part by about 9e-5 V in f32 over 250 steps with or without
    # noise (rounding the mixer amplifies; the noise-free twin's error is
    # recorded beside)
    rows = [_noisy_k1_vs_plain(DEFAULT_OPTIONS, 8192, 25, 1e-12, 82)[0],
            _noisy_k1_vs_plain(damped_f32_options(), 8192, 100, 5e-5, 84,
                               WHITE_NOISE_DECK, {"res_r": 0.01})[0]]
    row, (runner, feed, carry, nz, got) = _noisy_k1_vs_plain(
        fast_f32_options(), 8192, 250, 2e-4, 81)
    n = row["steps"]
    quiet = fused_step.FusedStepRunner(feed.engine, feed.bparams, runner.dt)
    qk = quiet.run_chunk(*carry[:5], 0, n)
    qp = quiet.run_chunk_plain(*carry[:5], 0, n)
    nbytes, flops = k1_work(runner, n, int(got[5].sum()))
    bms, by = bound_ms(nbytes, flops, runner.dtype)
    main = {"case": "noisy dbmixer f32 fast", "B": runner.B, "steps": n,
            "dtype": "float32", "N": runner.N, "k": runner.k,
            "nN": runner.nN, "max_abs_err": row["max_abs_err"],
            "tol": row["tol"],
            "noise_free_max_abs_err": max(
                float((x - y).abs().max())
                for x, y in zip(qk[:4], qp[:4]) if x.numel()),
            "newton_iters_per_step": float(got[5].float().mean()) / n,
            "kernel_ms": cuda_ms(lambda: runner.run_chunk(
                *carry[:5], 0, n, noise=nz), reps=5, warmup=1),
            "kernel_ms_noise_free": cuda_ms(lambda: quiet.run_chunk(
                *carry[:5], 0, n), reps=5, warmup=1),
            "plain_ms": row["plain_ms"],
            "stream_ms": cuda_ms(lambda: feed.block(carry[-1], 0, n),
                                 reps=5, warmup=1),
            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
            "flops": flops}
    emit("k1c_iii_vs_plain", cases=rows, main_shape=main)
    out["k1_main"] = main
    out["k1_err"] = max(r["max_abs_err"] for r in rows)
    # (2) fused against non-fused noisy runs, 1,024 lanes, the same keys,
    # 200 steps, from the same DC points: the white V + I noise deck of
    # tests/test_trnoise_fused.py (its diode damped; f32 5e-5 V, f64 1e-9
    # V) and the noisy dbmixer (f64 1e-9 V; in f32 the two paths part by
    # about 2e-4 V over 400 damped steps with or without noise, f32
    # rounding the mixer amplifies, so there both gaps are recorded, over
    # 100 steps)
    for name, deck, sig in (("white", WHITE_NOISE_DECK, {"res_r": 0.01}),
                            ("dbmixer", _noisy_dbmixer(), SIGMAS)):
        for opts, tol in ((damped_f32_options(), 5e-5),
                          (DEFAULT_OPTIONS, 1e-9)):
            held = name == "white" or opts.dtype == torch.float64
            steps = 200 if held else 100
            sim, bp = _mc_lanes(opts, 1024, 83, deck, sig)
            dt = sim.config.tran.tstep

            def run(fused, key):
                return mc.batched_transient(sim.engine, bp, dt, steps * dt,
                                            fused=fused, x0=x0,
                                            noise_key=key)

            x0 = mc.batched_dc_fast(sim.engine, bp)
            cuda_step.LAUNCHES = 0
            fr = run(True, prng.key(7))
            k1 = cuda_step.LAUNCHES
            nr, qr = run(False, prng.key(7)), run(True, None)
            torch.cuda.synchronize()
            r = {"deck": name, "B": 1024, "dtype": str(opts.dtype)[6:],
                 "steps": steps, "k1_launches": k1,
                 "tol": tol if held else None,
                 "failed_lanes": int(fr.failed.sum() + nr.failed.sum()),
                 "final_max_abs_vs_nonfused": float(
                     (fr.x_final - nr.x_final).abs().max()),
                 "final_max_abs_noisy_vs_noise_free": float(
                     (fr.x_final - qr.x_final).abs().max())}
            if not held:
                qn = run(False, None)
                r["noise_free_final_max_abs_vs_nonfused"] = float(
                    (qr.x_final - qn.x_final).abs().max())
            check(k1 > 0 and r["failed_lanes"] == 0,
                  f"noisy fused vs non-fused {name}: K1, failed lanes")
            if held:
                check(r["final_max_abs_vs_nonfused"] <= tol,
                      f"noisy fused vs non-fused {name} {r['dtype']}: "
                      f"{r['final_max_abs_vs_nonfused']} > {tol}")
                check(r["final_max_abs_noisy_vs_noise_free"]
                      > 100 * r["final_max_abs_vs_nonfused"],
                      f"the noise moves the {name} run")
            emit(f"trnoise_fused_vs_nonfused_{name}_{r['dtype']}", **r)
    # (4) the noisy main path against its noise-free twin: B = 8192, f32
    # fast, 10,000 steps of 1e-13 s in 2,000-step chunks, warm (set-up
    # outside the timed window, as benchmarks/bench_trnoise.py times it)
    sim, bp = _mc_lanes(fast_f32_options(), 8192, 42, _noisy_dbmixer())
    dt, n_steps = 1e-13, 10000
    runs = {}
    for name, key in (("noise_free", None), ("noisy", prng.key(123))):
        torch.cuda.synchronize()
        cuda_step.LAUNCHES = cuda_lu.LAUNCHES = 0
        t0 = time.perf_counter()
        carry, advance, meta = mc.make_fused_transient_fn(
            sim.engine, bp, dt, noise_key=key)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        chunk = meta["chunk"]
        t0 = time.perf_counter()
        for s in range(0, n_steps, chunk):
            carry = advance(carry, s, min(chunk, n_steps - s))[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = {"B": 8192, "steps": n_steps, "dt": dt, "chunk": chunk,
             "setup_s": setup, "wall_s": wall,
             "lane_steps_per_s": 8192 * n_steps / wall,
             "k1_launches": cuda_step.LAUNCHES,
             "k2_launches": cuda_lu.LAUNCHES,
             "failed_lanes": int(carry[4].sum())}
        check(m["k1_launches"] == -(-n_steps // chunk) and
              m["failed_lanes"] == 0, f"trnoise {name}: launches, failed")
        check(bool(torch.isfinite(carry[0]).all()), f"trnoise {name}: x")
        runner, feed = meta["runner"], meta["feed"]
        c0 = carry if feed is None else carry[:5]
        nz = None
        if feed is None:
            m["k1_ms_per_chunk"] = cuda_ms(lambda: runner.run_chunk(
                *c0, 0, chunk), reps=2, warmup=0)
        else:
            nz, _ = feed.block(carry[-1], n_steps, chunk)
            m["k1_ms_per_chunk"] = cuda_ms(lambda: runner.run_chunk(
                *c0, n_steps, chunk, noise=nz), reps=2, warmup=0)
            m["stream_ms_per_chunk"] = cuda_ms(lambda: feed.block(
                carry[-1], n_steps, chunk), reps=3, warmup=0)
            m["noise_block_mb"] = nz.numel() * nz.element_size() / 1e6
        # the chunk's bound at the Newton iterations its lanes ran
        iters = int(runner.run_chunk(*c0, n_steps, chunk, noise=nz)[5].sum())
        m["k1_bytes"], m["k1_flops"] = k1_work(runner, chunk, iters)
        m["k1_bound_ms"], m["k1_bound_by"] = bound_ms(
            m["k1_bytes"], m["k1_flops"], runner.dtype)
        m["newton_iters_per_step"] = iters / (8192 * chunk)
        runs[name] = m
    runs["noisy_over_noise_free_lane_steps"] = (
        runs["noisy"]["lane_steps_per_s"]
        / runs["noise_free"]["lane_steps_per_s"])
    runs["noisy_over_noise_free_k1"] = (runs["noisy"]["k1_ms_per_chunk"]
                                        / runs["noise_free"]["k1_ms_per_chunk"])
    runs["phase_seconds"] = time.perf_counter() - t_phase
    emit("trnoise_dbmixer_f32", **runs)
    out["main"] = runs
    return out


# ------------------------------------------------------------- phase 29
# mutual inductance (K1e): examples/xfmr.sp (k = 0) and its secondary with
# a diode and an RC load (k = 1), the decks of tests/test_torch_mutual.py;
# their lanes vary the inductors, the couplings and the resistors
RECTIFIER_DECK = """* transformer-coupled half-wave rectifier
V1 src 0 SIN 0 1 1e5
Rs src p 10
L1 p 0 1m
L2 s 0 4m
K1 L1 L2 0.98
D1 s out
Rl out 0 1k
Cl out 0 100n
.TRAN 1e-8 5e-5
"""
K_SIGMAS = (("ind_l", 0.05), ("mut_k", 0.01), ("res_r", 0.02))


def _as64(bp):
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in bp.items()}


def _k_lanes(sim, B, seed):
    """B lanes of a K deck drawn from a numpy seed: lognormal factors on
    K_SIGMAS' leaves, lane 0 nominal, every coupling at most 0.999."""
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    rng = np.random.default_rng(seed)
    bp = dict(mc.broadcast_params(sim.params, B))
    for key, sigma in K_SIGMAS:
        p = sim.params[key]
        f = np.exp(sigma * rng.standard_normal((B,) + tuple(p.shape)))
        f[0] = 1.0
        bp[key] = p[None] * torch.as_tensor(f, dtype=p.dtype,
                                            device=p.device)
    bp["mut_k"] = bp["mut_k"].clamp(max=0.999)
    return bp


def _k1e_deck(name, deck, seed):
    """One K deck: the fused Monte-Carlo main path at B = 8192 in f32
    (batched_transient from an f64 batched DC; counts reset just before
    and read just after), K1 at its 2,000-step chunk against the plain
    version, K1e against the plain version at B = 256 in f32 and f64, and
    the f64 fused run against the non-fused loop at B = 1024."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.analysis.transient import n_steps_for
    from circuitsimulator_tpu_torch.ops import cuda_lu, cuda_step, fused_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    opts = damped_f32_options()
    sim32, sim64 = _sim(opts, deck), _sim(DEFAULT_OPTIONS, deck)
    cfg = sim32.config.tran
    dt, n_steps, chunk = cfg.tstep, n_steps_for(cfg.tstep, cfg.tstop), 2000
    bp = _k_lanes(sim32, 8192, seed)
    torch.cuda.synchronize()
    cuda_lu.LAUNCHES = 0
    cuda_step.LAUNCHES = 0
    t0 = time.perf_counter()
    x0 = mc.batched_dc_fast(sim64.engine, _as64(bp))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = mc.batched_transient(sim32.engine, bp, dt, cfg.tstop, x0=x0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = {"deck": name, "B": 8192, "steps": n_steps, "dt": dt,
         "chunk": chunk, "dc_dtype": "float64", "setup_s": setup_s,
         "transient_s": wall, "k2_launches": cuda_lu.LAUNCHES,
         "k1_launches": cuda_step.LAUNCHES,
         "lane_steps_per_s": 8192 * n_steps / wall,
         "failed_lanes": int(res.failed.sum()),
         "newton_iters_per_step": float(res.newton_iters.float().mean())
         / n_steps}
    check(m["k1_launches"] == -(-n_steps // chunk),
          f"{name}: one K1 launch per chunk")
    check(m["k2_launches"] > 0, f"{name}: DC and G0 inverse on K2")
    check(m["failed_lanes"] == 0, f"{name}: failed lanes")
    check(bool(torch.isfinite(res.x_final).all()), f"{name}: non-finite x")
    runner = fused_step.FusedStepRunner(sim32.engine, bp, dt)
    check(runner.nK == 1, f"{name}: one K element in the runner")
    x = x0.float()
    st = sim32.engine.init_state(x, bp, dt)
    start = (x, x, st["vc"], st["il"], torch.zeros_like(res.failed))
    main = _k1_at_main_shape(runner, start, 0, chunk, 2e-4,
                             plain_steps=250 if name == "xfmr" else 100)
    main["deck"], main["nK"] = name, runner.nK
    m["kernel_at_main_shape"] = main
    emit(f"monte_carlo_fused_{name}_f32", **m)
    # K1e against its plain version, 256 lanes from the f64 DC: 100 steps
    # in f32 (the decks' branch rows cancel L/dt i terms of about 1e3 V to
    # volts, so two correct summation orders drift apart once the
    # rectifier's diode conducts: 3e-5 V after 100 steps, 3e-4 V after
    # 250), 200 in f64
    rows = []
    for o, tol, steps in ((opts, 2e-4, 100), (DEFAULT_OPTIONS, 1e-9, 200)):
        sim = _sim(o, deck)
        lanes = _k_lanes(sim, 256, seed + 1)
        x = mc.batched_dc_fast(sim64.engine, _as64(lanes)).to(o.dtype)
        r = fused_step.FusedStepRunner(sim.engine, lanes, dt)
        st = sim.engine.init_state(x, lanes, dt)
        carry = (x, x, st["vc"], st["il"],
                 torch.zeros((256,), dtype=torch.bool, device="cuda"))
        got = r.run_chunk(*carry, 0, steps)
        ref = r.run_chunk_plain(*carry, 0, steps)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got[:4],
                                                              ref[:4])
                  if a.numel())
        row = {"deck": name, "dtype": str(o.dtype)[6:], "B": 256,
               "steps": steps, "N": r.N, "k": r.k, "nK": r.nK,
               "max_abs_err": err, "tol": tol,
               "failed_lanes": int(got[4].sum()),
               "failed_equal": bool(torch.equal(got[4], ref[4])),
               "iters_equal": bool(torch.equal(got[5], ref[5]))}
        check(err <= tol, f"K1e {name} {row['dtype']}: {err} > {tol}")
        check(row["failed_equal"] and not row["failed_lanes"],
              f"K1e {name}: failed lanes")
        if o.dtype == torch.float64:
            check(row["iters_equal"], f"K1e {name}: iteration counts")
        rows.append(row)
    # the f64 fused run against the non-fused loop, 1,024 lanes x 300 steps
    lanes = _k_lanes(sim64, 1024, seed + 2)
    x = mc.batched_dc_fast(sim64.engine, lanes)
    t0 = time.perf_counter()
    fz = mc.batched_transient(sim64.engine, lanes, dt, 300 * dt, x0=x,
                              fused=True)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nf = mc.batched_transient(sim64.engine, lanes, dt, 300 * dt, x0=x,
                              fused=False)
    torch.cuda.synchronize()
    f64 = {"deck": name, "B": 1024, "steps": 300, "fused_s": fused_s,
           "nonfused_s": time.perf_counter() - t0,
           "final_max_abs_vs_nonfused": float(
               (fz.x_final - nf.x_final).abs().max())}
    check(not bool(fz.failed.any() or nf.failed.any()),
          f"{name} f64: failed lanes")
    check(f64["final_max_abs_vs_nonfused"] <= 1e-9,
          f"{name}: fused f64 within 1e-9 V of the non-fused loop")
    emit(f"monte_carlo_fused_{name}_f64", **f64)
    return m, main, rows


def phase_mutual():
    """Mutual inductance on the card: xfmr.sp's single lane in f64 (DC,
    500 transient steps, the .AC sweep) against the port on the CPU; the
    K1e decks (``_k1e_deck``); xfmr's AC Monte-Carlo at 4096 x 41 on K3
    (the -wM entries in B1), f32 against f64 on the same lanes."""
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
    from circuitsimulator_tpu_torch.analysis.ac import sweep_frequencies
    from circuitsimulator_tpu_torch.ops import cuda_ac
    t_phase = time.perf_counter()
    xfmr = os.path.join(EXAMPLES, "xfmr.sp")
    gpu = Simulator.from_file(xfmr, device="cuda")
    cpu = Simulator.from_file(xfmr, device="cpu")
    n = 500
    xg, xc = gpu.dc(), cpu.dc()
    row = {"dc_max_abs": float((xg.cpu() - xc).abs().max()), "steps": n}
    t0 = time.perf_counter()
    rg = gpu.transient(tstop=n * gpu.config.tran.tstep, x_op=xg)
    torch.cuda.synchronize()
    row["transient_s"] = time.perf_counter() - t0
    rc = cpu.transient(tstop=n * cpu.config.tran.tstep, x_op=xc)
    row["transient_max_abs"] = float((rg.xs.cpu() - rc.xs).abs().max())
    s_eq = gpu.circuit.nodes[gpu.circuit.node_name_to_id["s"]].eq_index
    row["secondary_peak_v"] = float(rg.xs[:, s_eq].abs().max())
    cuda_ac.LAUNCHES = 0
    ag = gpu.ac(x_op=xg)
    row["ac_k3_launches"] = cuda_ac.LAUNCHES
    row["ac_max_abs"] = float(np.abs(ag.xs - cpu.ac(x_op=xc).xs).max())
    for key in ("dc_max_abs", "transient_max_abs", "ac_max_abs"):
        check(row[key] <= 1e-9, f"xfmr single lane {key} {row[key]}")
    check(row["ac_k3_launches"] == 1, "xfmr .AC: one K3 launch")
    emit("mutual_single_lane_f64", **row)
    decks = {name: _k1e_deck(name, deck, seed) for name, deck, seed in (
        ("xfmr", xfmr, 91), ("rectifier", RECTIFIER_DECK, 94))}
    emit("k1e_vs_plain", cases=[r for d in decks.values() for r in d[2]])
    # xfmr's AC Monte-Carlo: its .AC card's 41 points at 4096 lanes
    cfg = gpu.config.ac
    freqs = sweep_frequencies(cfg.sweep_type, cfg.n_points, cfg.fstart,
                              cfg.fstop)
    sim32 = _sim(damped_f32_options(), xfmr)
    bp = _k_lanes(sim32, 4096, 97)
    m32, x32, xr32, xi32 = _ac_run(sim32, bp, freqs)
    _k3_shape("xfmr float32", sim32, bp, x32, freqs, m32["k3_launches"],
              "ac_xfmr_f32")
    emit("ac_xfmr_f32", **m32)
    m64, _, xr64, xi64 = _ac_run(_sim(DEFAULT_OPTIONS, xfmr), _as64(bp),
                                 freqs)
    m64["f32_vs_f64_lane_rel"] = _lane_rel_err(
        torch.complex(xr32.double(), xi32.double()),
        torch.complex(xr64, xi64))
    check(m64["f32_vs_f64_lane_rel"] <= 1e-3, "xfmr AC f32 within 1e-3")
    m64["phase_seconds"] = time.perf_counter() - t_phase
    emit("ac_xfmr_f64", **m64)
    return {"single": row, "decks": decks, "ac": m32}


# ------------------------------------------------------- phases 30, 31
def _cli_vs_goldens(deck, args, stdout_golden, csvs, where="examples"):
    """The CLI on <where>/<deck>.sp (examples/ or tests/netlists/) on the
    card, run from a directory holding <where>/ (the goldens name the deck
    and the CSVs relative to it): stdout byte-identical to the JAX CLI's,
    each CSV's header equal and its values within 1e-9.  K1 and K2 counts
    are reset just before and read just after."""
    import numpy as np
    from circuitsimulator_tpu_torch.ops import cuda_lu, cuda_step
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_s_")
    here = os.getcwd()
    try:
        os.makedirs(os.path.join(tmp, where))
        shutil.copy(os.path.join(REPO, where, f"{deck}.sp"),
                    os.path.join(tmp, where))
        os.chdir(tmp)
        cuda_lu.LAUNCHES = 0
        cuda_step.LAUNCHES = 0
        rc, text, out["cli_s"] = _cli([f"{where}/{deck}.sp", *args,
                                       "--device", "cuda"])
        out["k2_launches"] = cuda_lu.LAUNCHES
        out["k1_launches"] = cuda_step.LAUNCHES
        check(rc == 0 and text == read_golden(stdout_golden),
              f"{deck} stdout byte-identical to the JAX CLI's")
        for got_name, gold in csvs:
            with open(got_name) as f:
                check(f.readline() == read_golden(gold).splitlines(True)[0],
                      f"{got_name}: CSV header")
            got = np.loadtxt(got_name, delimiter=",", skiprows=1, ndmin=2)
            ref = np.loadtxt(os.path.join(GOLDENS, gold), delimiter=",",
                             skiprows=1, ndmin=2)
            check(got.shape == ref.shape, f"{got_name}: CSV shape")
            out[f"{got_name}_max_abs"] = float(np.abs(got - ref).max())
            check(out[f"{got_name}_max_abs"] <= 1e-9,
                  f"{got_name} within 1e-9 of the JAX CLI's")
    finally:
        os.chdir(here)
        shutil.rmtree(tmp)
    return out


def phase_dc_sweep():
    """The .DC sweep on the card: --run-dc-sweep on mos_family.sp (the
    nested grid) and diode_temp.sp (with its .MEASURE DC and --run-step, the
    golden's command) against the JAX CLI's goldens; dbmixer's Vdd over
    8,192 points from 0 to 3.3 V through Simulator.dc_sweep, one batched
    DC (K2 at (8192, 31, 1) in f64): points/s, the shared loop's Newton
    iterations (one K2 launch each), K2's share of the wall at its timed
    cost, failed points; every 64th point against the port's f64 sweep on
    the CPU (1e-9 V, equal fail masks)."""
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import Simulator
    from circuitsimulator_tpu_torch.analysis.sweep import set_source_lanes
    from circuitsimulator_tpu_torch.ops import cuda_lu, lu
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    t_phase = time.perf_counter()
    cli = {"mos_family": _cli_vs_goldens(
        "mos_family", ["--run-dc-sweep", "mos_family_dcsweep.csv"],
        "mos_family_dcsweep_stdout_jax.txt",
        [("mos_family_dcsweep.csv", "mos_family_dcsweep_jax.csv")]),
        "diode_temp": _cli_vs_goldens(
        "diode_temp", ["--run-dc-sweep", "diode_temp_dcsweep.csv",
                       "--run-step", "diode_temp_step.csv"],
        "diode_temp_stdout_jax.txt",
        [("diode_temp_dcsweep.csv", "diode_temp_dcsweep_jax.csv"),
         ("diode_temp_step.csv", "diode_temp_step_jax.csv")])}
    for deck, row in cli.items():
        check(row["k2_launches"] > 0, f"{deck} sweep on K2")
    emit("dc_sweep_cli", decks=cli)
    dbmixer = os.path.join(NETLISTS, "dbmixer.sp")
    sim = Simulator.from_file(dbmixer, device="cuda")
    values = np.linspace(0.0, 3.3, 8192)
    torch.cuda.synchronize()
    cuda_lu.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sim.dc_sweep(source="Vdd", values=values)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = cuda_lu.LAUNCHES
    A, b = _systems(8192, sim.engine.N, 1, torch.float64, seed=9)
    k2_ms = cuda_ms(lambda: lu.lu_solve(A, b, FLOOR))
    bp = set_source_lanes(sim.engine, mc.broadcast_params(sim.params, 8192),
                          sim.circuit, "Vdd", values)
    fail, move = _dc_fail_mask(sim.engine, bp, res.xs, 1e-6)
    m = {"points": 8192, "N": sim.engine.N, "dtype": "float64",
         "wall_s": wall, "points_per_s": 8192 / wall, "k2_launches": k2,
         "newton_iterations": k2, "k2_ms_per_launch": k2_ms,
         "k2_share": k2 * k2_ms / (1e3 * wall),
         "failed_points": int(fail.sum()),
         "newton_move_max": float(move[~fail].max())}
    check(k2 > 0, "dbmixer sweep on K2")
    # every 64th point through the port on the CPU
    cpu = Simulator.from_file(dbmixer, device="cpu")
    t0 = time.perf_counter()
    ref = cpu.dc_sweep(source="Vdd", values=values[::64])
    m["cpu_points"], m["cpu_s"] = len(values[::64]), time.perf_counter() - t0
    bpc = set_source_lanes(cpu.engine, mc.broadcast_params(cpu.params,
                                                           m["cpu_points"]),
                           cpu.circuit, "Vdd", values[::64])
    fail_c = _dc_fail_mask(cpu.engine, bpc, ref.xs, 1e-6)[0]
    check(torch.equal(fail[::64].cpu(), fail_c), "sweep fail masks equal")
    good = ~fail_c
    m["max_abs_vs_cpu"] = float(
        (res.xs[::64].cpu()[good] - ref.xs[good]).abs().max())
    check(m["max_abs_vs_cpu"] <= 1e-9, "sweep within 1e-9 V of the CPU")
    m["phase_seconds"] = time.perf_counter() - t_phase
    emit("dc_sweep_dbmixer_f64", **m)
    return {"cli": cli, "dbmixer": m}


def phase_step():
    """.STEP on the card: --run-step on rc_step.sp (.STEP PARAM with its
    .MEASURE TRAN cards, the non-fused f64 loop) against the JAX CLI's
    goldens; then the same sweep waveform-free in f32 (Simulator.step(
    save_xs=False): the streaming measures, K1 with its probe stream),
    its measures against the golden CSV (rtol 1e-4)."""
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import Simulator
    from circuitsimulator_tpu_torch.ops import cuda_step
    t_phase = time.perf_counter()
    cli = _cli_vs_goldens("rc_step", ["--no-tran", "--run-step",
                                      "rc_step_step.csv"],
                          "rc_step_run_step_stdout_jax.txt",
                          [("rc_step_step.csv", "rc_step_step_jax.csv")])
    emit("step_cli", **cli)
    sim = Simulator.from_file(os.path.join(EXAMPLES, "rc_step.sp"),
                              opts=ref_f32_options(), device="cuda")
    torch.cuda.synchronize()
    cuda_step.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sim.step(save_xs=False)
    torch.cuda.synchronize()
    m = {"lanes": len(res.values), "wall_s": time.perf_counter() - t0,
         "k1_launches": cuda_step.LAUNCHES}
    gold = golden_rows("rc_step_step_jax.csv", None)
    got = np.stack([np.asarray(res.values)]
                   + [np.asarray(v, np.float64) for _, v in res.measures], 1)
    m["max_rel_vs_golden"] = float(np.abs(got / gold - 1.0).max())
    check(m["k1_launches"] > 0, "rc_step .STEP ran K1")
    check(m["max_rel_vs_golden"] <= 1e-4, "rc_step f32 .STEP measures")
    m["phase_seconds"] = time.perf_counter() - t_phase
    emit("step_rc_step_f32", **m)
    return {"cli": cli, "f32": m}


# ------------------------------------------------------------- phase 32
# the decks of tests/test_torch_ic.py: tests/test_ic.py's UIC, .IC and
# element IC= decks merged into one under UIC and one without
IC_UIC_DECK = """* UIC starts
R1 a 0 1k
C1 a 0 1u
C2 b 0 1u IC=2
R2 b 0 1k
L1 c 0 1m IC=3m
R3 c 0 1
C3 d e 1u IC=1.5
R4 d 0 1k
R5 e 0 1k
C4 f 0 1u IC=0.7
R6 f 0 1k
.IC V(a)=2 V(f)=0.9
.IC V(zzz)=5
.TRAN 10u 2m UIC
"""
IC_DECK = """* .IC over the DC point
V1 in 0 1
R1 in a 1k
C1 a 0 1u
R2 in b 1k
C2 b 0 1u IC=0.25
R3 in c 1k
C3 c 0 1u
.IC V(a)=3
.TRAN 1e-4 4e-3
"""


def phase_ic():
    """.IC / UIC on the card in f64: the UIC deck, the .IC deck and the
    .IC deck with uic=True, each within 1e-12 V of the port on the CPU."""
    import contextlib as cl
    import torch
    from circuitsimulator_tpu_torch import Simulator
    from circuitsimulator_tpu_torch.ops import cuda_lu
    rows = {}
    torch.cuda.synchronize()
    cuda_lu.LAUNCHES = 0
    for name, deck, kw in (("uic", IC_UIC_DECK, {}), ("ic", IC_DECK, {}),
                           ("ic_uic_override", IC_DECK, {"uic": True})):
        # the UIC deck's .IC V(zzz) warns on stderr, on both devices
        with cl.redirect_stderr(io.StringIO()):
            g = Simulator.from_text(deck, device="cuda").transient(**kw)
            c = Simulator.from_text(deck, device="cpu").transient(**kw)
        rows[name] = {"steps": int(g.n_steps),
                      "max_abs_vs_cpu": float((g.xs.cpu() - c.xs).abs().max()),
                      "x0_v": float(g.xs[0].abs().max())}
        check(not bool(g.failed), f"IC {name}: failed")
        check(rows[name]["max_abs_vs_cpu"] <= 1e-12,
              f"IC {name} within 1e-12 V of the CPU")
    k2 = cuda_lu.LAUNCHES
    check(k2 > 0, "the IC transients' solves on K2")
    emit("ic_transients_f64", decks=rows, k2_launches=k2)
    return k2


# ------------------------------------------------------- phases 33-36
# tests/test_trap.py's MOS + L + C deck under MOSCAP=CHARGE: the charge
# currents qi of the trapezoidal state
TRAP_CHARGE_DECK = """* MOS + L + C, charge model
.MODEL 2 VT 0.4 MU 1e-2 COX 1e-3 LAMBDA 0.05 CJ0 1e-13
VDD 1 0 3
Vin 2 0 SIN 1 0.5 1e8
RD 1 3 1k
M1 3 2 0 n 10e-6 1e-6 2
C1 3 0 2e-13
L1 3 4 1e-9
C2 4 0 1e-13
.OPTIONS MOSCAP=CHARGE
.TRAN 1e-11 2e-8
"""


def _lanes_of(bp):
    """The lane count of batched params."""
    return int(bp["vt_thermal"].shape[0])


def _chunked_run(sim, bp, n_steps, chunk, noise_key=None):
    """ChunkedTransient's run without a file, timed: the batched DC (K2),
    then the non-fused steps chunk by chunk (``_run_chunk``, what ``run``
    calls).  K2 counts are reset just before and read just after.
    Returns (measurements, final carry)."""
    import torch
    from circuitsimulator_tpu_torch.ops import cuda_lu
    from circuitsimulator_tpu_torch.parallel.checkpoint import \
        ChunkedTransient
    eng = sim.engine
    dt = sim.config.tran.tstep
    B = _lanes_of(bp)
    ck = ChunkedTransient(eng, bp, dt, n_steps * dt, chunk_steps=chunk,
                          noise_key=noise_key)
    torch.cuda.synchronize()
    cuda_lu.LAUNCHES = 0
    t0 = time.perf_counter()
    carry = ck.initial_carry()
    torch.cuda.synchronize()
    dc_s = time.perf_counter() - t0
    dc_k2 = cuda_lu.LAUNCHES
    walls, iters = [], 0
    for c in range(n_steps // chunk):
        ts = (torch.arange(c * chunk + 1, (c + 1) * chunk + 1,
                           dtype=eng.dtype, device="cuda")
              * torch.tensor(dt, dtype=eng.dtype, device="cuda"))
        t0 = time.perf_counter()
        carry, it = ck._run_chunk(carry, ts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        iters = iters + it.sum(0)
    m = {"B": B, "dtype": str(eng.dtype)[6:], "method": eng.opts.tran_method,
         "solver": eng.opts.tran_solver, "steps": n_steps, "chunk": chunk,
         "dc_s": dc_s, "dc_k2_launches": dc_k2,
         "tran_k2_launches": cuda_lu.LAUNCHES - dc_k2,
         "k2_launches": cuda_lu.LAUNCHES,
         "steps_per_s": B * n_steps / sum(walls),
         "ms_per_step": 1e3 * sum(walls) / n_steps,
         "chunk_seconds": walls,
         "failed_lanes": int(carry[2].sum()),
         "mean_newton_iters": float(iters.float().mean()) / n_steps}
    return m, carry


TRAP_STEPS = 250      # phase 33's TRAP dbmixer run, phase 36's resume


def phase_trap():
    """Phase 33: METHOD=TRAP on the card.  buffer.sp through the CLI with
    --method trap in f64 against the JAX CLI's goldens; dbmixer at B =
    8192, f32 damped, trapezoidal: batched DC then TRAP_STEPS non-fused
    Woodbury steps (ChunkedTransient's loop, two chunks), and the same
    lanes' Backward-Euler rate over a quarter of that before and after it;
    B = 1024 in f64 over 100 trapezoidal steps, 64 of the lanes against
    the CPU (the plain version) within 1e-9 V at every 50th step;
    tests/test_trap.py's MOS + L + C deck under MOSCAP=CHARGE, single lane
    f64, 50 steps, against the CPU within 1e-9 V (the run lengths keep
    the script inside its time limit)."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
    from circuitsimulator_tpu_torch.ops import cuda_lu
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    t_phase = time.perf_counter()
    cli = _cli_vs_goldens(
        "buffer", ["buffer_trap_tran.csv", "--method", "trap"],
        "buffer_trap_stdout_jax.txt",
        [("buffer_trap_tran.csv", "buffer_trap_tran_jax.csv")],
        where=os.path.join("tests", "netlists"))
    check(cli["k2_launches"] > 0, "buffer --method trap on K2")
    emit("trap_cli_buffer_f64", **cli)
    opts = damped_f32_options().replace(tran_method="trap")
    sim, bp = _mc_lanes(opts, 8192, seed=61)
    sim_be = _sim(damped_f32_options(), os.path.join(NETLISTS, "dbmixer.sp"))
    # in turns: BE, TRAP, BE (host-bound rates drift within a call)
    quarter = TRAP_STEPS // 4
    be = [_chunked_run(sim_be, bp, quarter, quarter)[0]]
    main, carry = _chunked_run(sim, bp, TRAP_STEPS, TRAP_STEPS // 2)
    be.append(_chunked_run(sim_be, bp, quarter, quarter)[0])
    check(main["failed_lanes"] == 0, "TRAP dbmixer: no failed lanes")
    check(main["tran_k2_launches"] > 0, "TRAP dbmixer's steps on K2")
    main["k2_launches_per_step"] = main["tran_k2_launches"] / TRAP_STEPS
    main["be_same_lanes"] = [
        {k: r[k] for k in ("steps_per_s", "mean_newton_iters",
                           "tran_k2_launches", "failed_lanes")} for r in be]
    main["trap_over_be_rate"] = main["steps_per_s"] / statistics.mean(
        r["steps_per_s"] for r in be)
    emit("trap_dbmixer_f32", **main)
    # f64, 1024 lanes on the card, 64 of them on the CPU
    sim64, bp64 = _mc_lanes(DEFAULT_OPTIONS.replace(tran_method="trap"),
                            1024, seed=62)
    cpu = Simulator.from_file(os.path.join(NETLISTS, "dbmixer.sp"),
                              opts=sim64.opts, device="cpu")
    dt = sim64.config.tran.tstep
    runs = {}
    bp_cpu = {k: v[:64].cpu() for k, v in bp64.items()}
    for dev, s, p in (("cuda", sim64, bp64), ("cpu", cpu, bp_cpu)):
        t0 = time.perf_counter()
        x0 = mc.batched_dc_fast(s.engine, p)
        carry64 = mc.init_carry(s.engine, x0, p, dt)
        marks = [x0[:64].cpu()]
        for c in range(2):
            ts = torch.arange(c * 50 + 1, c * 50 + 51,
                              dtype=torch.float64, device=dev) * dt
            carry64, _ = mc.batched_transient_chunk(s.engine, p, carry64, ts,
                                                    dt)
            marks.append(carry64[0][:64].cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (torch.stack(marks), time.perf_counter() - t0,
                     int(carry64[-1].sum()))
    m64 = {"B": 1024, "steps": 100, "cuda_s": runs["cuda"][1],
           "cpu_lanes": 64, "cpu_s": runs["cpu"][1],
           "failed_lanes": runs["cuda"][2],
           "max_abs_vs_cpu": float((runs["cuda"][0]
                                    - runs["cpu"][0]).abs().max())}
    check(m64["failed_lanes"] == 0, "TRAP f64: no failed lanes")
    check(m64["max_abs_vs_cpu"] <= 1e-9, "TRAP f64 CUDA within 1e-9 V of CPU")
    emit("trap_dbmixer_f64_vs_cpu", **m64)
    # the charge model's trapezoidal currents
    torch.cuda.synchronize()
    cuda_lu.LAUNCHES = 0
    g = Simulator.from_text(TRAP_CHARGE_DECK, device="cuda",
                            opts=DEFAULT_OPTIONS.replace(tran_method="trap"))
    t0 = time.perf_counter()
    rg = g.transient(tstop=50e-11)
    torch.cuda.synchronize()
    mq = {"steps": 50, "cuda_s": time.perf_counter() - t0,
          "k2_launches": cuda_lu.LAUNCHES}
    c = Simulator.from_text(TRAP_CHARGE_DECK, device="cpu",
                            opts=DEFAULT_OPTIONS.replace(tran_method="trap"))
    rc = c.transient(tstop=50e-11)
    mq["max_abs_vs_cpu"] = float((rg.xs.cpu() - rc.xs).abs().max())
    check(not bool(rg.failed), "TRAP charge deck failed")
    check(mq["max_abs_vs_cpu"] <= 1e-9, "TRAP charge deck within 1e-9 V")
    mq["phase_seconds"] = time.perf_counter() - t_phase
    emit("trap_charge_f64_vs_cpu", **mq)
    return {"cli": cli, "main": main, "be": be, "carry": carry, "bp": bp,
            "sim": sim, "charge": mq}


def phase_lu_solver():
    """Phase 34: the dense ``lu`` transient solver on the card.  dbmixer at
    B = 8192, f32 damped, BE and TRAP, 200 steps: every Newton iteration
    assembles the (B, 32, 32) system and solves it with K2 at (8192, 31,
    1): K2 launches, ms per step, failed lanes; B = 1024 f64 TRAP, 200
    steps, lu against woodbury on the same lanes within 1e-9 V; the mixed
    refinement (f64 residual, f32 K2 correction) against the f64 lu run:
    the gap."""
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    t_phase = time.perf_counter()
    rows = {}
    for method in ("be", "trap"):
        opts = damped_f32_options().replace(tran_solver="lu",
                                            tran_method=method)
        sim, bp = _mc_lanes(opts, 8192, seed=63)
        m, _ = _chunked_run(sim, bp, 200, 200)
        check(m["failed_lanes"] == 0, f"lu {method}: no failed lanes")
        check(m["tran_k2_launches"] >= 200, f"lu {method}: K2 every iteration")
        m["k2_launches_per_step"] = m["tran_k2_launches"] / 200
        rows[method] = m
        emit(f"lu_solver_dbmixer_{method}_f32", **m)
    finals = {}
    for name, kw in (("woodbury", {}), ("lu", {"tran_solver": "lu"}),
                     ("lu_mixed", {"tran_solver": "lu",
                                   "tran_mixed_refine": True})):
        opts = DEFAULT_OPTIONS.replace(tran_method="trap", **kw)
        sim, bp = _mc_lanes(opts, 1024, seed=64)
        m, carry = _chunked_run(sim, bp, 200, 200)
        check(m["failed_lanes"] == 0, f"f64 {name}: no failed lanes")
        finals[name] = (carry[0], m)
    gap = {"lu_vs_woodbury_max_abs": float(
        (finals["lu"][0] - finals["woodbury"][0]).abs().max()),
        "mixed_vs_lu_max_abs": float(
        (finals["lu_mixed"][0] - finals["lu"][0]).abs().max()),
        "ms_per_step": {k: v[1]["ms_per_step"] for k, v in finals.items()},
        "mean_newton_iters": {k: v[1]["mean_newton_iters"]
                              for k, v in finals.items()}}
    check(gap["lu_vs_woodbury_max_abs"] <= 1e-9, "f64 lu within 1e-9 V of "
          "woodbury")
    check(gap["mixed_vs_lu_max_abs"] <= 1e-6, "mixed refinement within "
          "1e-6 V of f64 lu")
    gap["phase_seconds"] = time.perf_counter() - t_phase
    emit("lu_solver_dbmixer_f64", B=1024, steps=200, **gap)
    return rows


def phase_adaptive():
    """Phase 35: the adaptive dyadic-LTE integrator on the card.  dbmixer's
    single lane in f64 through Simulator.transient(adaptive=True) over 500
    output intervals (tstop 5e-11): substeps, rejections, Newton
    iterations, wall, against the same run on the CPU (equal counts, rows
    within 1e-9 V); then B = 1024 perturbed f64 lanes through
    run_transient_adaptive over 200 intervals: the L + 1 = 9 G0 inverses
    as one K2 launch at (9216, 31, 31), then the k x k solves; lanes 0
    and 1 against their own single-lane runs within 1e-12 V with equal
    counts."""
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
    from circuitsimulator_tpu_torch.analysis.adaptive import \
        run_transient_adaptive
    from circuitsimulator_tpu_torch.ops import cuda_lu
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    t_phase = time.perf_counter()
    path = os.path.join(NETLISTS, "dbmixer.sp")
    out = {}
    x_op = Simulator.from_file(path, device="cpu").dc()
    for dev in ("cuda", "cpu"):
        sim = Simulator.from_file(path, device=dev)
        x0 = x_op.to(dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            cuda_lu.LAUNCHES = 0
        t0 = time.perf_counter()
        r = sim.transient(tstop=5e-11, x_op=x0, adaptive=True)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (r, time.perf_counter() - t0, cuda_lu.LAUNCHES)
    rg, rc = out["cuda"][0], out["cpu"][0]
    single = {"intervals": rg.n_steps, "n_substeps": int(rg.n_substeps),
              "n_rejected": int(rg.n_rejected),
              "newton_iters": int(rg.newton_iters),
              "substeps_per_interval": int(rg.n_substeps) / rg.n_steps,
              "cuda_s": out["cuda"][1], "cpu_s": out["cpu"][1],
              "k2_launches": out["cuda"][2],
              "lte_exceeded": bool(rg.lte_exceeded),
              "max_abs_vs_cpu": float((rg.xs.cpu() - rc.xs).abs().max())}
    for key in ("n_substeps", "n_rejected", "newton_iters"):
        check(int(getattr(rg, key)) == int(getattr(rc, key)),
              f"adaptive {key} equal on CUDA and CPU")
    check(not bool(rg.failed), "adaptive dbmixer failed")
    check(single["max_abs_vs_cpu"] <= 1e-9, "adaptive within 1e-9 V of CPU")
    check(single["k2_launches"] > 0, "adaptive single lane on K2")
    emit("adaptive_dbmixer_single_f64", **single)
    sim, bp = _mc_lanes(DEFAULT_OPTIONS, 1024, seed=65)
    x0 = mc.batched_dc_fast(sim.engine, bp)
    torch.cuda.synchronize()
    cuda_lu.LAUNCHES = 0
    t0 = time.perf_counter()
    rb = run_transient_adaptive(sim.engine, bp, 1e-13, 2e-11, x0=x0)
    torch.cuda.synchronize()
    batch = {"B": 1024, "intervals": rb.n_steps,
             "wall_s": time.perf_counter() - t0,
             "k2_launches": cuda_lu.LAUNCHES,
             "n_substeps_mean": float(rb.n_substeps.float().mean()),
             "n_substeps_max": int(rb.n_substeps.max()),
             "n_rejected_mean": float(rb.n_rejected.float().mean()),
             "newton_iters_mean": float(rb.newton_iters.float().mean()),
             "failed_lanes": int(rb.failed.sum()),
             "lte_exceeded_lanes": int(rb.lte_exceeded.sum())}
    batch["lane_substeps_per_s"] = (float(rb.n_substeps.sum())
                                    / batch["wall_s"])
    # the stacked inverse is the first launch; each later one a k x k
    # solve of a Newton iteration of the shared loop
    batch["k2_stacked_inverse_launches"] = 1
    batch["k2_kxk_launches"] = batch["k2_launches"] - 1
    check(batch["failed_lanes"] == 0, "batched adaptive: no failed lanes")
    errs = []
    for lane in (0, 1):
        r = run_transient_adaptive(sim.engine, {k: v[lane]
                                                for k, v in bp.items()},
                                   1e-13, 2e-11, x0=x0[lane])
        errs.append(float((rb.xs[:, lane] - r.xs).abs().max()))
        for key in ("n_substeps", "n_rejected", "newton_iters"):
            check(int(getattr(rb, key)[lane]) == int(getattr(r, key)),
                  f"batched adaptive lane {lane} {key}")
    batch["lanes01_max_abs_vs_single"] = max(errs)
    check(max(errs) <= 1e-12, "batched adaptive lanes within 1e-12 V")
    batch["phase_seconds"] = time.perf_counter() - t_phase
    emit("adaptive_dbmixer_batched_f64", **batch)
    return {"single": single, "batch": batch}


def phase_checkpoint(trap):
    """Phase 36: ChunkedTransient's checkpoint/resume on the card.  Phase
    33's dbmixer run (B = 8192, f32 damped TRAP, TRAP_STEPS in two chunks)
    is the uninterrupted run; the same lanes run again stopped
    after the first chunk (the .npz written) and resumed from the file by
    a new object: torch.equal on x, failed and every state entry.  Then the
    noisy dbmixer (TRNOISE state, one key per lane) the same way, its
    uninterrupted run here.  File size, save and load times."""
    import torch
    from circuitsimulator_tpu_torch.ops import cuda_lu
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    from circuitsimulator_tpu_torch.parallel.checkpoint import (
        ChunkedTransient, load_carry, save_carry)
    from circuitsimulator_tpu_torch.utils import prng
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    rows = {}
    try:
        cases = [("dbmixer", trap["sim"], trap["bp"], None, trap["carry"])]
        opts = damped_f32_options().replace(tran_method="trap")
        nsim, nbp = _mc_lanes(opts, 8192, seed=61, deck=_noisy_dbmixer())
        key = mc.lane_keys(nsim.engine, nbp, prng.key(3, "cuda"))
        n, half = TRAP_STEPS, TRAP_STEPS // 2
        nm, ncarry = _chunked_run(nsim, nbp, n, half, noise_key=key)
        check(nm["failed_lanes"] == 0, "noisy TRAP dbmixer: no failed lanes")
        emit("checkpoint_noisy_dbmixer_uninterrupted_f32", **nm)
        cases.append(("noisy_dbmixer", nsim, nbp, key, ncarry))
        for name, sim, bp, nkey, full in cases:
            eng = sim.engine
            dt = sim.config.tran.tstep
            path = os.path.join(tmp, f"{name}.npz")
            torch.cuda.synchronize()
            cuda_lu.LAUNCHES = 0
            t0 = time.perf_counter()
            ChunkedTransient(eng, bp, dt, half * dt, ckpt_path=path,
                             chunk_steps=half, noise_key=nkey).run()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            resumed, iters = ChunkedTransient(
                eng, bp, dt, n * dt, ckpt_path=path, chunk_steps=half,
                noise_key=nkey).run()
            torch.cuda.synchronize()
            m = {"B": _lanes_of(bp), "steps": n, "chunk": half,
                 "first_chunk_s": first_s,
                 "resume_s": time.perf_counter() - t0,
                 "k2_launches": cuda_lu.LAUNCHES,
                 "file_bytes": os.path.getsize(path),
                 "state_keys": sorted(resumed[1])}
            same = (torch.equal(resumed[0], full[0])
                    and torch.equal(resumed[2], full[2])
                    and set(resumed[1]) == set(full[1])
                    and all(resumed[1][k] == full[1][k]
                            if isinstance(full[1][k], int)
                            else torch.equal(resumed[1][k], full[1][k])
                            for k in full[1]))
            check(same, f"{name}: resumed carry bit-equal to the "
                  "uninterrupted run")
            m["bitwise_equal"] = same
            # save and load of the final carry, each timed alone
            t0 = time.perf_counter()
            save_carry(path, resumed, n)
            m["save_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            back, step = load_carry(path, eng)
            torch.cuda.synchronize()
            m["load_s"] = time.perf_counter() - t0
            check(step == n and torch.equal(back[0], resumed[0]),
                  f"{name}: load_carry round trip")
            rows[name] = m
            emit(f"checkpoint_{name}_f32", **m)
    finally:
        shutil.rmtree(tmp)
    rows["phase_seconds"] = time.perf_counter() - t_phase
    return rows

# ------------------------------------------------------------- phase 37
# (deck, arguments, stdout golden, [(file written, its JAX-made golden,
# bar over each column's peak)]): the JAX CLI's small-signal runs
SMALL_SIGNAL_CLI = {
    "bjt_amp": (["bjt_amp_tran.csv", "--no-tran", "--run-ac",
                 "bjt_amp_ac.csv", "--run-noise", "bjt_amp_noise.csv",
                 "--run-noise-figure", "Rs", "--run-group-delay", "c",
                 "--raw", "bjt_amp.raw"],
                "bjt_amp_smallsig_stdout_jax.txt",
                [("bjt_amp_ac.csv", "bjt_amp_smallsig_ac_jax.csv", 1e-9),
                 ("bjt_amp_noise.csv", "bjt_amp_noise_jax.csv", 1e-9),
                 ("nf.csv", "bjt_amp_nf_jax.csv", 1e-9),
                 ("groupdelay.csv", "bjt_amp_groupdelay_jax.csv", 1e-8),
                 ("bjt_amp.raw", "bjt_amp_smallsig_jax.raw", 1e-9)]),
    "cs_amp": (["cs_amp_tran.csv", "--run-ac", "cs_amp_ac.csv",
                "--connectivity", "--run-sparams", "d@50", "--sparams-out",
                "cs_amp.s1p"],
               "cs_amp_smallsig_stdout_jax.txt",
               [("cs_amp_ac.csv", "cs_amp_ac_jax.csv", 1e-9),
                ("cs_amp.s1p", "cs_amp_jax.s1p", 1e-9)]),
    "feedback_loop": (["feedback_loop_tran.csv", "--run-loop-gain", "E1",
                       "--run-group-delay", "out"],
                      "feedback_loop_smallsig_stdout_jax.txt",
                      [("loopgain.csv", "feedback_loop_loopgain_jax.csv",
                        1e-9),
                       ("groupdelay.csv", "feedback_loop_groupdelay_jax.csv",
                        1e-8)]),
}

# the 10 dB pi pad of tests/test_sparams.py; T-line decks of
# tests/test_torch_smallsig.py for the K2 routes
PAD_DECK = "R1 p1 0 96.2478\nR2 p1 p2 71.1512\nR3 p2 0 96.2478\n.op\n"
TLINE_NOISE_DECK = """* T-line noise deck
V1 in 0 DC 1 AC 1
Iin 0 a DC 0 AC 0
R1 in a 50
T1 a 0 b 0 Z0=50 TD=1n
R2 b 0 75
C1 b 0 1p
.NOISE V(b) Iin lin 7 1e6 1e9
"""
TLINE_LOOP_DECK = """* loop through a line
Vref in 0 DC 0 AC 1
E1 a 0 in out 20
R1 a b 50
T1 b 0 c 0 Z0=50 TD=100n
R2 c out 10
C1 out 0 1n
Rl out 0 1k
.AC DEC 5 1e4 1e7
.end
"""


def _peak_rel(got, ref):
    """Largest |got - ref| over each column's peak |ref| (a column of
    zeros is held absolutely)."""
    import numpy as np
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.ndim < 2:
        got, ref = got.reshape(-1, 1), ref.reshape(-1, 1)
    got, ref = got.reshape(len(ref), -1), ref.reshape(len(ref), -1)
    peak = np.abs(ref).max(axis=0)
    peak = np.where(peak > 0, peak, 1.0)
    return float((np.abs(got - ref) / peak).max()) if ref.size else 0.0


def _file_err(path, gold):
    """(text lines equal, largest error over each column's peak) of a CSV,
    a Touchstone file or a rawfile against its golden."""
    import numpy as np

    def table(p):
        text, rows = [], []
        with open(p) as f:
            lines = f.read().splitlines()
        if p.endswith(".raw"):
            # headers as text; every value (re, im) in file order
            i = 0
            while i < len(lines):
                nvars = int(lines[i + 4].split(": ", 1)[1])
                npts = int(lines[i + 5].split(": ", 1)[1])
                text += lines[i:i + 8 + nvars]
                i += 8 + nvars
                for _ in range(npts):
                    row = []
                    for k in range(nvars):
                        v = lines[i + k].split("\t")[-1].split(",")
                        row += [float(v[0]), float(v[1]) if len(v) > 1
                                else 0.0]
                    rows.append(row)
                    i += nvars
            return text, rows
        for line in lines:
            try:
                rows.append([float(v) for v in
                             line.replace(",", " ").split()])
            except ValueError:
                text.append(line)
        return text, rows

    t1, r1 = table(path)
    t2, r2 = table(os.path.join(GOLDENS, gold))
    same = t1 == t2 and [len(r) for r in r1] == [len(r) for r in r2]
    if not same:
        return False, float("inf")
    if path.endswith(".raw"):
        # each plot's rows may differ in width: compare plot by plot
        errs, start = [], 0
        for k in range(1, len(r2) + 1):
            if k == len(r2) or len(r2[k]) != len(r2[start]):
                errs.append(_peak_rel(np.array(r1[start:k]),
                                      np.array(r2[start:k])))
                start = k
        return True, max(errs)
    return True, _peak_rel(np.array(r1), np.array(r2))


def _small_signal_cli():
    """The three JAX CLI small-signal runs on the card."""
    from circuitsimulator_tpu_torch.ops import cuda_ac, cuda_lu
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ss_")
    here = os.getcwd()
    try:
        for deck, (args, stdout, files) in SMALL_SIGNAL_CLI.items():
            d = os.path.join(tmp, deck)
            os.makedirs(os.path.join(d, "examples"))
            shutil.copy(os.path.join(EXAMPLES, f"{deck}.sp"),
                        os.path.join(d, "examples"))
            os.chdir(d)
            cuda_ac.LAUNCHES = cuda_lu.LAUNCHES = 0
            rc, text, secs = _cli([f"examples/{deck}.sp", *args, "--device",
                                   "cuda"])
            m = {"cli_s": secs, "k3_launches": cuda_ac.LAUNCHES,
                 "k2_launches": cuda_lu.LAUNCHES}
            check(rc == 0 and text == read_golden(stdout),
                  f"{deck} small-signal stdout byte-identical to the JAX "
                  "CLI's")
            for got, gold, bar in files:
                same, err = _file_err(got, gold)
                m[f"{got}_peak_rel"] = err
                check(same and err <= bar,
                      f"{deck}: {got} within {bar} of {gold}: {err}")
            out[deck] = m
            emit(f"small_signal_cli_{deck}", **m)
            os.chdir(here)
    finally:
        os.chdir(here)
        shutil.rmtree(tmp)
    return out


def _as_arrays(res):
    """The numbers of a small-signal result as a dict of numpy arrays."""
    import numpy as np
    import torch
    if isinstance(res, tuple) and len(res) == 2 and isinstance(res[1], list):
        return {r[0]: np.array(r[1:]) for r in res[1]}      # .SENS rows
    if isinstance(res, tuple):
        return {f"out{i}": np.asarray(v) for i, v in enumerate(res)}
    if isinstance(res, dict):
        return {k: np.asarray(v, dtype=complex) for k, v in res.items()
                if v is not None and k != "freqs"}
    out = {}
    for k, v in vars(res).items():
        if k == "x_op":       # the operating point is held by phase 3
            continue
        if isinstance(v, dict):
            out.update({f"{k}_{c}": np.asarray(a) for c, a in v.items()})
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        elif v is not None and not isinstance(v, (str, list, float)):
            out[k] = np.asarray(v)
    return out


def phase_small_signal():
    """Phase 37: the CLI runs, every API analysis on the card against the
    port on the CPU with its K3 and K2 launches, K3 against its plain
    version at the new shapes (their timings join k3_timings)."""
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import Simulator
    from circuitsimulator_tpu_torch.analysis.ac import (_omegas,
                                                        ac_system_real)
    from circuitsimulator_tpu_torch.ops import cuda_ac, cuda_lu
    t_phase = time.perf_counter()
    out = {"cli": _small_signal_cli(), "api": {}}
    pad_ports = [("p1", None, 50.0), ("p2", None, 50.0)]
    pad_freqs = np.logspace(6, 9, 31)
    # (name, deck, analysis, K3 launches per call (None: not held), bar)
    cases = [
        ("noise_bjt_amp", "bjt_amp", lambda s, x: s.noise(x_op=x), 1, 1e-9),
        ("noise_figure_bjt_amp", "bjt_amp",
         lambda s, x: s.noise_figure("Rs", x_op=x), 1, 1e-9),
        ("tf_bjt_amp", "bjt_amp", lambda s, x: s.tf(x_op=x), 0, 1e-9),
        ("loop_gain_feedback_loop", "feedback_loop",
         lambda s, x: s.loop_gain("E1", x_op=x), 1, 1e-9),
        ("group_delay_feedback_loop", "feedback_loop",
         lambda s, x: s.group_delay("out", x_op=x), 2, 1e-8),
        ("sparams_pad", PAD_DECK,
         lambda s, x: s.sparams(pad_ports, freqs=pad_freqs, x_op=x), 1,
         1e-9),
        ("stability_pad", PAD_DECK,
         lambda s, x: s.stability(pad_ports, freqs=pad_freqs, x_op=x), 1,
         1e-9),
        ("sparams_cs_amp", "cs_amp",
         lambda s, x: s.sparams([("d", None, 50.0)], x_op=x), 1, 1e-9),
        ("tf_cs_amp", "cs_amp", lambda s, x: s.tf(x_op=x), 0, 1e-9),
        ("sensitivity_cs_amp", "cs_amp",
         lambda s, x: s.sensitivity(x_op=x), 0, 1e-9),
        ("pole_zero_cs_amp", "cs_amp",
         lambda s, x: s.pole_zero(out_node="d", input_source="Vin", x_op=x),
         0, 1e-9),
        ("noise_tline", TLINE_NOISE_DECK, lambda s, x: s.noise(x_op=x), 0,
         1e-9),
        ("loop_gain_tline", TLINE_LOOP_DECK,
         lambda s, x: s.loop_gain("E1", x_op=x), 0, 1e-9),
        ("group_delay_tline", TLINE_LOOP_DECK,
         lambda s, x: s.group_delay("out", x_op=x), 0, 1e-8),
    ]
    sims = {}

    def sim_pair(deck):
        if deck not in sims:
            if "\n" in deck:
                mk = [Simulator.from_text(deck, device=d)
                      for d in ("cuda", "cpu")]
            else:
                path = os.path.join(EXAMPLES, f"{deck}.sp")
                mk = [Simulator.from_file(path, device=d)
                      for d in ("cuda", "cpu")]
            sims[deck] = [(s, s.dc()) for s in mk]
        return sims[deck]

    for name, deck, fn, k3_want, bar in cases:
        (gs, gx), (cs, cx) = sim_pair(deck)
        torch.cuda.synchronize()
        cuda_ac.LAUNCHES = cuda_lu.LAUNCHES = 0
        t0 = time.perf_counter()
        got = fn(gs, gx)
        torch.cuda.synchronize()
        m = {"deck": deck if "\n" not in deck else name.split("_")[-1],
             "wall_s": time.perf_counter() - t0,
             "k3_launches": cuda_ac.LAUNCHES,
             "k2_launches": cuda_lu.LAUNCHES}
        want = fn(cs, cx)
        g, w = _as_arrays(got), _as_arrays(want)
        check(set(g) == set(w), f"{name}: the same outputs on both devices")
        if name.startswith("sensitivity"):
            # p dV/dp in volts; a row zero in exact arithmetic may come out
            # at roundoff
            floor = 1e-13 * max(abs(v[1]) for v in w.values())
            m["rows"] = len(w)
            m["max_rel_err"] = max(
                float(abs(g[k][0] - v[0]) / abs(v[0])) for k, v in w.items()
                if abs(v[1]) > floor)
            check(all(abs(g[k][1] - v[1]) <= bar * abs(v[1]) + floor
                      for k, v in w.items()), f"{name}: rows within {bar}")
        else:
            errs = {}
            for k in w:
                a, b = np.asarray(g[k]), np.asarray(w[k])
                if b.dtype == bool:
                    check(np.array_equal(a, b), f"{name}: {k} equal")
                    continue
                if name.startswith("pole_zero"):
                    a, b = np.sort_complex(a), np.sort_complex(b)
                fin = np.isfinite(b)
                check(np.array_equal(fin, np.isfinite(a)),
                      f"{name}: {k} finite where the CPU's is")
                a, b = a[fin], b[fin]
                if not b.size:
                    errs[k] = 0.0
                elif name.startswith(("sparams", "stability")):
                    peak = float(np.abs(b).max())    # 0: held absolutely
                    errs[k] = float(np.abs(a - b).max()) / (peak or 1.0)
                else:
                    errs[k] = float(np.max(np.abs(a - b) / np.maximum(
                        np.abs(b), 1e-300)))
            m["max_rel_err"] = max(errs.values()) if errs else 0.0
            m["errors"] = errs
            check(m["max_rel_err"] <= bar,
                  f"{name}: card vs CPU {m['max_rel_err']} > {bar}")
        if k3_want is not None:
            check(m["k3_launches"] == k3_want,
                  f"{name}: {m['k3_launches']} K3 launches, not {k3_want}")
        if name.startswith(("tf", "sensitivity", "pole_zero")) \
                or "tline" in name:
            check(m["k2_launches"] > 0, f"{name}: K2 launched")
        out["api"][name] = m
        emit(f"small_signal_{name}", **m)

    # K3 against its plain version at the adjoint and n-port shapes; kept
    # for k3_timings and phase 28
    (gs, gx), _ = sim_pair("bjt_amp")
    cfg = gs.config.noise
    om = _omegas(gs.engine, gs._noise_freqs(""))[1].contiguous()
    G, B1, _, _ = ac_system_real(gs.engine, gs.params, gx, 1.0)
    e = torch.zeros((1, gs.engine.N), dtype=G.dtype, device="cuda")
    e[0, gs._node_eq(cfg.out_node)] = 1.0
    adj = [G.mT[None].contiguous(), B1.mT[None].contiguous(), e,
           torch.zeros_like(e)]
    (ps, px), _ = sim_pair(PAD_DECK)
    Gp, Bp, _, _ = ac_system_real(ps.engine, ps.params, px, 1.0)
    n = ps.engine.N
    rhs = torch.zeros((2, n), dtype=Gp.dtype, device="cuda")
    rhs[0, ps._node_eq("p1")] = rhs[1, ps._node_eq("p2")] = 1.0
    nport = [Gp.expand(2, n, n).contiguous(), Bp.expand(2, n, n).contiguous(),
             rhs, torch.zeros_like(rhs)]
    om_pad = _omegas(ps.engine, pad_freqs)[1].contiguous()
    rows = []
    for shape, arrays, omg, launches, path in (
            ("bjt_amp noise adjoint float64", adj, om, 1,
             "small_signal_noise_bjt_amp"),
            ("pad 2-port float64", nport, om_pad, 1,
             "small_signal_sparams_pad")):
        rel, err, zeros = _k3_vs_plain(arrays, omg, torch.float64, shape)
        check(zeros == 0, f"{shape}: no zero lane")
        rows.append({"shape": shape, "B": arrays[0].shape[0],
                     "F": omg.shape[0], "N": arrays[0].shape[1],
                     "lane_rel_err": rel, "max_abs_err": err})
        K3_SHAPES[shape] = {"inputs": arrays + [omg], "launches": launches,
                            "path": path}
    emit("small_signal_k3_vs_plain", cases=rows, card=card_line())
    out["k3_max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit("small_signal", seconds=out["phase_seconds"])
    return out


# --------------------------------------------------------------- phase 38
# examples/high_sigma.py's inverter: V(out) at 3.5 ns must stay below 1.27
# V; 30 mV of VT mismatch (4.3% lognormal)
HIGH_SIGMA_DECK = """* inverter settle-time yield
.MODEL mn VT 0.7 MU 5e-2 COX 2e-3
VDD vdd 0 3
VIN in 0 PULSE(0 3 1n 0.8n 0.8n 20n 40n)
RD vdd out 20k
M1 out in 0 0 mn W=0.8u L=1u
CL out 0 150f
.TRAN 5e-11 8e-9
.MEASURE TRAN vset FIND V(out) AT=3.5e-9
.end
"""
HIGH_SIGMA = {"mos_vth": 0.043}
HIGH_SIGMA_SPECS = {"vset": (None, 1.27)}
# mc_filter.sp's settle time and final level: about 70% of the lanes pass
MC_FILTER_SIGMA = {"res_r": 0.05, "cap_c": 0.10}
MC_FILTER_SPECS = {"settle": (None, 1.18e-3), "vfinal": (0.9948, None)}
# bjt_amp.sp's -3 dB frequency: 153.8 MHz nominal, 6.45 MHz of sigma
BJT_AC_SIGMA = {"res_r": 0.05, "bjt_bf": 0.10, "bjt_is": 0.10}
BJT_F3DB_LOW = 1.345e8
# inamp.sp's output (node 54, 1.5 V) within 1.0-1.9 V under 2% of VT
INAMP_SIGMA = {"mos_vth": 0.02}
INAMP_WINDOW = (1.0, 1.9)
# fit_measures' targets on mc_filter: a settle time 15% over the nominal
# 1.065 ms, the nominal final level
FIT_TARGETS = {"settle": 1.225e-3, "vfinal": 0.9951}


def _statistics_cpu(task, lanes=None, f32_config=False):
    """One CPU reference of phase 38, run in a worker process beside the
    card's work (the same deck, options and inputs as the card's run);
    "yield_lanes": mc_filter's measures and failed mask of the given
    lanes, f64, in the f32 runs' configuration if ``f32_config``."""
    import torch
    sys.path.insert(0, REPO)
    torch.set_num_threads(2)
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
    from circuitsimulator_tpu_torch.parallel import montecarlo as tmc
    mcf = os.path.join(EXAMPLES, "mc_filter.sp")
    if task == "yield_lanes":
        opts = (damped_f32_options().replace(dtype=torch.float64)
                if f32_config else DEFAULT_OPTIONS)
        sim = Simulator.from_file(mcf, opts=opts, device="cpu")
        tran = sim.config.tran
        vals, failed = tmc._lane_measures(
            sim.engine, sim.topo, lanes, sim.config.measures, tran.tstep,
            tran.tstop, "tran", None, None)
        return {"measures": vals, "failed": failed}
    if task == "high_sigma_form":
        r = Simulator.from_text(HIGH_SIGMA_DECK, device="cpu").worst_case(
            HIGH_SIGMA, measure="vset", high=1.27)
        return {"beta": r["beta"]}
    if task == "inamp_dc":
        sim = Simulator.from_file(os.path.join(REPO, "tests", "netlists",
                                               "inamp.sp"), device="cpu")
        r = sim.worst_case(INAMP_SIGMA, analysis="dc", probe="54",
                           low=INAMP_WINDOW[0], high=INAMP_WINDOW[1])
        b = sim.mismatch_budget(INAMP_SIGMA, analysis="dc", probe="54")
        return {"beta": r["beta"], "contributions": b["contributions"],
                "sigma_m": b["sigma_m"]}
    if task == "bjt_ac":
        sim = Simulator.from_file(os.path.join(EXAMPLES, "bjt_amp.sp"),
                                  device="cpu")
        r = sim.worst_case(BJT_AC_SIGMA, analysis="ac", measure="f3db",
                           low=BJT_F3DB_LOW)
        b = sim.mismatch_budget(BJT_AC_SIGMA, analysis="ac", measure="f3db")
        return {"beta": r["beta"], "contributions": b["contributions"],
                "sigma_m": b["sigma_m"]}
    sim = Simulator.from_file(mcf, device="cpu")
    if task == "calibrate":
        target, p0 = _calibrate_inputs(sim)
        _, hist = sim.calibrate(target, "out", ["res_r", "cap_c"], steps=3,
                                lr=0.05, params=p0)
        return {"history": hist, "target": target}
    if task == "fit_measures":
        _, hist = sim.fit_measures(FIT_TARGETS, ["res_r", "cap_c"],
                                   steps=3, lr=0.05)
        return {"history": hist}
    raise ValueError(task)


def _calibrate_inputs(sim):
    """calibrate's target (V(out) of mc_filter's nominal run on the CPU)
    and its start from sim's parameters (R 20% high, C 15% low)."""
    from circuitsimulator_tpu_torch import Simulator
    cpu = Simulator.from_file(os.path.join(EXAMPLES, "mc_filter.sp"),
                              device="cpu")
    target = cpu.transient().xs[:, cpu._node_eq("out")].numpy()
    p0 = dict(sim.params)
    p0["res_r"] = sim.params["res_r"] * 1.2
    p0["cap_c"] = sim.params["cap_c"] * 0.85
    return target, p0


def _counted(fn):
    """fn() on the card with the kernel counts set to 0 just before and
    read just after: (result, {wall_s, k1/k2/k3_launches})."""
    import torch
    from circuitsimulator_tpu_torch.ops import cuda_ac, cuda_lu, cuda_step
    torch.cuda.synchronize()
    cuda_step.LAUNCHES = cuda_lu.LAUNCHES = cuda_ac.LAUNCHES = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t0,
                 "k1_launches": cuda_step.LAUNCHES,
                 "k2_launches": cuda_lu.LAUNCHES,
                 "k3_launches": cuda_ac.LAUNCHES}


def _lanes_cpu(bp, n):
    """The first n lanes of a lane dict, float64 on the CPU."""
    import torch
    return {k: (v[:n].cpu().double() if v.is_floating_point()
                else v[:n].cpu()) for k, v in bp.items()}


def _yield_vs_cpu(ref, out, n, rtol, atol):
    """The worst ratio |card - cpu| / (atol + rtol |cpu|) over the measures
    of the first n lanes of a card yield run against the CPU's run of
    them (``ref``), and whether the pass masks agree."""
    import numpy as np
    vals = ref["measures"]
    ratio = max(float(np.max(np.abs(out["measures"][k][:n] - v)
                             / (atol + rtol * np.abs(v))))
                for k, v in vals.items())
    ok = np.ones(n, dtype=bool)
    for name, (low, high) in MC_FILTER_SPECS.items():
        v = vals[name]
        m = np.isfinite(v)
        if low is not None:
            m &= v >= low
        if high is not None:
            m &= v <= high
        ok &= m
    ok &= ~ref["failed"]
    return ratio, bool(np.array_equal(ok, out["pass"][:n]))


def _k2_slice_timings():
    """K2 at the slice's shapes, f64 (the adjoint's dtype): the inamp DC
    adjoint's transposed solve (1, 28, 1) and bjt_amp's differentiable 2N
    AC solve (71, 14, 1), forward and backward (lu_solve_diff): the kernel
    against its plain version (max abs error), per call, plain, solve_ex
    and bound."""
    import torch
    from circuitsimulator_tpu_torch.ops import lu
    rows = []
    for B, N, what in ((1, 28, "inamp DC adjoint, transposed"),
                       (71, 14, "bjt_amp 2N AC solve, forward"),
                       (71, 14, "bjt_amp 2N AC solve, backward")):
        A, b = _systems(B, N, 1, torch.float64, seed=B + N)
        A[1:4], b[1:4] = A[0], b[0]       # no planted lanes: all regular
        b = b[..., 0].contiguous()
        nbytes = B * (N * N + 2 * N) * 8
        flops = B * sum(m + 2 * m * m + 2 * m + (2 * m + 1)
                        for m in range(N))
        if what.endswith("backward"):
            At = A.clone().requires_grad_()
            x = lu.lu_solve_diff(At, b)
            xbar = torch.ones_like(x)

            def kern():
                return torch.autograd.grad(x, At, xbar,
                                           retain_graph=True)[0]

            def plain():
                lam = lu.lu_solve_plain(A.mT, xbar, FLOOR)
                return -(lam[..., None] @ x.detach()[..., None, :])

            def lib():
                return torch.linalg.solve_ex(A.mT, xbar)
            nbytes += B * N * (N + 2) * 8    # x read, Abar and bbar written
            flops += B * N * N               # the outer product
        else:
            M = A.mT if what.endswith("transposed") else A

            def kern():
                return lu.lu_solve(M, b, FLOOR)

            def plain():
                return lu.lu_solve_plain(M, b, FLOOR)

            def lib():
                return torch.linalg.solve_ex(M, b)
        err = float((kern() - plain()).abs().max())
        check(err <= 1e-12, f"K2 at {what} vs plain: {err}")
        bms, by = bound_ms(nbytes, flops, torch.float64)
        rows.append({"shape": what, "B": B, "N": N, "R": 1,
                     "dtype": "float64", "max_abs_err": err,
                     "kernel_ms": cuda_ms(kern),
                     "plain_ms": cuda_ms(plain, reps=5),
                     "library_ms": cuda_ms(lib), "bound_ms": bms,
                     "bound_by": by})
    return rows


def phase_statistics():
    """Phase 38: the statistical and differentiation stacks on the card,
    through Simulator's entry points: mc_filter's yield under the four
    sampling plans (f32, K1 with its probe stream) and in f64 (the
    non-fused loop), each against the port's f64 CPU run of its first 256
    lanes; the four stages of examples/high_sigma.py (LHS yield, scaled-
    sigma IS, FORM on the f64 adjoint, IS centred on z*), beta against the
    CPU's; Sobol indices of mc_filter (6,144 lanes on K1) and of bjt_amp's
    f3db (K3); inamp.sp's DC worst case and budget over its 22 MOSFETs
    and bjt_amp's AC ones (the 2N solve on K2), against the CPU; three Adam
    steps of calibrate and fit_measures (the loss history against the
    CPU's, 1e-8); K2 at the slice's shapes.  The CPU references run in
    worker processes beside the card's work."""
    import multiprocessing
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import Simulator
    from circuitsimulator_tpu_torch.analysis.adjoint import diff_transient
    from circuitsimulator_tpu_torch.analysis.ac import ac_analysis_batched
    from circuitsimulator_tpu_torch.analysis.measure import run_measures
    from circuitsimulator_tpu_torch.parallel import montecarlo as tmc
    t_phase = time.perf_counter()
    mcf = os.path.join(EXAMPLES, "mc_filter.sp")
    bjt = os.path.join(EXAMPLES, "bjt_amp.sp")
    out = {"runs": {}}
    runs = out["runs"]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(4, mp_context=ctx) as pool:
        refs = {t: pool.submit(_statistics_cpu, t)
                for t in ("high_sigma_form", "inamp_dc", "bjt_ac",
                          "calibrate", "fit_measures")}
        # 1. mc_filter's yield: four plans in f32 on K1, mc in f64; each
        # against the CPU's f64 run of its first 256 lanes in the same
        # configuration (the f32 lanes' tran_tol is 1e-5), run by the pool
        sim32 = _sim(damped_f32_options(), mcf)
        sim64 = Simulator.from_file(mcf, device="cuda")
        yields = {}
        for sampler in ("mc", "lhs", "sobol", "antithetic"):
            r, m = _counted(lambda: sim32.yield_analysis(
                38, 8192, MC_FILTER_SIGMA, MC_FILTER_SPECS, sampler=sampler))
            check(m["k1_launches"] > 0, f"yield {sampler}: K1 launched")
            m["yield"], m["ci95"] = r["yield"], r["ci95"]
            m["failing_lanes"] = int((~r["pass"]).sum())
            check(0.5 <= r["yield"] <= 0.99, f"yield {sampler} {r['yield']}")
            yields[f"{sampler}_f32"] = (r, m, pool.submit(
                _statistics_cpu, "yield_lanes", _lanes_cpu(r["params"], 256),
                True))
        r, m = _counted(lambda: sim64.yield_analysis(
            38, 8192, MC_FILTER_SIGMA, MC_FILTER_SPECS))
        check(m["k1_launches"] == 0 and m["k2_launches"] > 0,
              "yield f64: the non-fused loop")
        m["yield"] = r["yield"]
        yields["mc_f64"] = (r, m, pool.submit(
            _statistics_cpu, "yield_lanes", _lanes_cpu(r["params"], 256)))
        # 2. the high-sigma flow on the inverter
        inv32 = _sim(damped_f32_options(), HIGH_SIGMA_DECK)
        inv64 = Simulator.from_text(HIGH_SIGMA_DECK, device="cuda")
        hs = {}
        r, m = _counted(lambda: inv32.yield_analysis(
            0, 8192, HIGH_SIGMA, HIGH_SIGMA_SPECS, sampler="lhs"))
        m["yield"], m["ci95"] = r["yield"], r["ci95"]
        hs["lhs"] = m
        r, m = _counted(lambda: inv32.yield_analysis(
            1, 8192, HIGH_SIGMA, HIGH_SIGMA_SPECS, sigma_scale=2.5))
        m.update({k: r[k] for k in ("p_fail", "p_fail_se", "n_eff")})
        hs["scaled_is"] = m
        form, m = _counted(lambda: inv64.worst_case(HIGH_SIGMA,
                                                     measure="vset",
                                                     high=1.27))
        m.update({"beta": form["beta"], "p_fail": form["p_fail"],
                  "n_iter": form["n_iter"], "converged": form["converged"]})
        hs["form"] = m
        r, m = _counted(lambda: inv32.yield_analysis(
            2, 8192, HIGH_SIGMA, HIGH_SIGMA_SPECS, shift=form["z_star"]))
        m.update({k: r[k] for k in ("p_fail", "p_fail_se", "n_eff")})
        hs["mpp_is"] = m
        for k in ("lhs", "scaled_is", "mpp_is"):
            check(hs[k]["k1_launches"] > 0, f"high sigma {k}: K1")
        check(hs["form"]["k2_launches"] > 0 and form["converged"],
              "high sigma FORM on K2, converged")
        ref = refs["high_sigma_form"].result()
        hs["form"]["beta_vs_cpu_rel"] = abs(form["beta"] / ref["beta"] - 1)
        check(hs["form"]["beta_vs_cpu_rel"] <= 1e-8, "FORM beta vs CPU")
        check(hs["mpp_is"]["n_eff"] > 0 and hs["mpp_is"]["p_fail"] > 0,
              "MPP-centred IS saw failures")
        out["high_sigma"] = hs
        emit("statistics_high_sigma", card=card_line(), **hs)
        # 3. Sobol: mc_filter on K1, bjt_amp's f3db on K3
        so, m = _counted(lambda: sim32.sobol_indices(3, 1024,
                                                     MC_FILTER_SIGMA))
        m["lanes"] = (len(so["settle"]["S1"]) + 2) * 1024
        check(m["k1_launches"] > 0 and m["lanes"] == 6144, "Sobol on K1")
        m["indices"] = {k: {"S1": v["S1"].tolist(), "ST": v["ST"].tolist()}
                        for k, v in so.items()}
        runs["sobol_mc_filter_f32"] = m
        emit("statistics_sobol_mc_filter_f32", **m)
        # (Simulator.sobol_indices would score bjt_amp's .MEASURE TRAN
        # card: the deck has a .TRAN card too)
        bsim = Simulator.from_file(bjt, device="cuda")
        so, m = _counted(lambda: tmc.sobol_indices(
            bsim.engine, bsim.topo, bsim.params,
            torch.Generator(device="cuda").manual_seed(4), 512, BJT_AC_SIGMA,
            [x for x in bsim.config.measures if x.analysis == "ac"], 0.0,
            0.0, analysis="ac", freqs=bsim._ac_freqs(),
            bindings=bsim.config.param_values))
        check(m["k3_launches"] > 0, "AC Sobol on K3")
        dims = len(so["f3db"]["S1"])
        m["lanes"] = (dims + 2) * 512
        m["indices"] = {"S1": so["f3db"]["S1"].tolist(),
                        "ST": so["f3db"]["ST"].tolist()}
        # the host's share: the lanes' sweep alone, then the measures
        bp = tmc._params_from_Z(bsim.params, BJT_AC_SIGMA, torch.zeros(
            (m["lanes"], dims), dtype=torch.float64, device="cuda"))
        freqs = bsim._ac_freqs()
        res, ma = _counted(lambda: ac_analysis_batched(bsim.engine, bp,
                                                       freqs))
        ms = [x for x in bsim.config.measures if x.analysis == "ac"]
        t0 = time.perf_counter()
        for lane_xs in res.xs:
            run_measures(ms, bsim.topo, np.asarray(freqs), lane_xs, "ac")
        m["sweep_wall_s"], m["host_measures_s"] = (
            ma["wall_s"], time.perf_counter() - t0)
        runs["sobol_bjt_amp_ac_f64"] = m
        emit("statistics_sobol_bjt_amp_ac_f64", **m)
        # 4. inamp's DC worst case and budget; 5. bjt_amp's AC ones
        isim = Simulator.from_file(os.path.join(REPO, "tests", "netlists",
                                                "inamp.sp"), device="cuda")
        for name, sim, kw, bkw in (
                ("inamp_dc", isim,
                 dict(rel_sigma=INAMP_SIGMA, analysis="dc", probe="54",
                      low=INAMP_WINDOW[0], high=INAMP_WINDOW[1]),
                 dict(rel_sigma=INAMP_SIGMA, analysis="dc", probe="54")),
                ("bjt_ac", bsim,
                 dict(rel_sigma=BJT_AC_SIGMA, analysis="ac", measure="f3db",
                      low=BJT_F3DB_LOW),
                 dict(rel_sigma=BJT_AC_SIGMA, analysis="ac",
                      measure="f3db"))):
            wc, m = _counted(lambda: sim.worst_case(**kw))
            b, mb = _counted(lambda: sim.mismatch_budget(**bkw))
            ref = refs[name].result()
            m.update({"beta": wc["beta"], "n_iter": wc["n_iter"],
                      "beta_vs_cpu_rel": abs(wc["beta"] / ref["beta"] - 1),
                      "budget": mb, "sigma_m": b["sigma_m"],
                      "top5": [c[:2] for c in b["contributions"][:5]]})
            check(m["k2_launches"] > 0 and mb["k2_launches"] > 0,
                  f"{name}: K2 launched")
            check(2.0 <= wc["beta"] <= 6.0 and wc["converged"],
                  f"{name}: beta {wc['beta']} in [2, 6], converged")
            check(m["beta_vs_cpu_rel"] <= 1e-8, f"{name}: beta vs CPU")
            check(m["top5"] == [tuple(c[:2]) for c in
                                ref["contributions"][:5]],
                  f"{name}: the top 5 contributions equal the CPU's")
            runs[f"worst_case_{name}_f64"] = m
            emit(f"statistics_worst_case_{name}_f64", **m)
        # the yields' lanes against the CPU: f64 1e-9 with equal pass
        # masks, f32 the fused-measure bar (its masks reported)
        for name, (r, m, ref) in yields.items():
            f64 = name.endswith("f64")
            ratio, same = _yield_vs_cpu(ref.result(), r, 256,
                                        1e-9 if f64 else 2e-4,
                                        0.0 if f64 else 2e-6)
            m["vs_cpu_ratio"], m["pass_equal_256"] = ratio, same
            check(ratio <= 1.0 and (same or not f64),
                  f"yield {name} vs the CPU's f64 lanes: {ratio}, {same}")
            runs[f"yield_mc_filter_{name}"] = m
            emit(f"statistics_yield_mc_filter_{name}", **m)
        # 6. the optimisers, and the adjoint's ms a step
        target, p0 = _calibrate_inputs(sim64)
        (_, hist), m = _counted(lambda: sim64.calibrate(
            target, "out", ["res_r", "cap_c"], steps=3, lr=0.05,
            params=p0))
        ref = refs["calibrate"].result()
        check(np.array_equal(ref["target"], target), "calibrate: target")
        m["history"] = hist
        m["vs_cpu_rel"] = float(np.max(np.abs(np.asarray(hist)
                                              / ref["history"] - 1)))
        check(m["vs_cpu_rel"] <= 1e-8 and m["k2_launches"] > 0,
              "calibrate: loss history vs CPU, K2")
        runs["calibrate_mc_filter_f64"] = m
        emit("statistics_calibrate_mc_filter_f64", **m)
        (_, hist), m = _counted(lambda: sim64.fit_measures(
            FIT_TARGETS, ["res_r", "cap_c"], steps=3, lr=0.05))
        ref = refs["fit_measures"].result()
        m["history"] = hist
        m["vs_cpu_rel"] = float(np.max(np.abs(np.asarray(hist)
                                              / ref["history"] - 1)))
        check(m["vs_cpu_rel"] <= 1e-8 and m["k2_launches"] > 0,
              "fit_measures: loss history vs CPU, K2")
        runs["fit_measures_mc_filter_f64"] = m
        emit("statistics_fit_measures_mc_filter_f64", **m)
    leaves = {k: sim64.params[k].clone().requires_grad_()
              for k in ("res_r", "cap_c")}
    tran = sim64.config.tran
    (t, xs), mf = _counted(lambda: diff_transient(
        sim64.engine, {**sim64.params, **leaves}, tran.tstep, tran.tstop))
    _, mbk = _counted(lambda: torch.autograd.grad(
        xs[:, sim64._node_eq("out")].sum(), list(leaves.values())))
    n = xs.shape[0] - 1
    out["adjoint"] = {"deck": "mc_filter", "steps": n,
                      "forward_ms_per_step": 1e3 * mf["wall_s"] / n,
                      "backward_ms_per_step": 1e3 * mbk["wall_s"] / n,
                      "forward_k2_launches": mf["k2_launches"],
                      "backward_k2_launches": mbk["k2_launches"]}
    emit("statistics_adjoint_ms_per_step", card=card_line(),
         **out["adjoint"])
    out["k2_shapes"] = _k2_slice_timings()
    emit("statistics_k2_shapes", rows=out["k2_shapes"], card=card_line())
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit("statistics", seconds=out["phase_seconds"],
         walls={k: v["wall_s"] for k, v in runs.items()})
    return out


# ---------------------------------------------------------------- phase 39
# the synthetic large circuits' f64 checks against the CPU: a 2,000-node
# ladder (tridiag) and a 30 x 30 grid through blockband (a diode every 10
# nodes: rank 90 > N/16) and blockwb (every 20: rank 45 <= 56)
LARGE_CHECKS = {"ladder2000": ("ladder", 2000, 10),
                "grid30_blockband": ("grid", 30, 10),
                "grid30_blockwb": ("grid", 30, 20)}
LARGE_CHECK_STEPS = 20


def _large_deck(kind, n, diode_every, steps, tstep=1e-11):
    from circuitsimulator_tpu_torch.synthetic import (rc_grid_netlist,
                                                      rc_ladder_netlist)
    if kind == "ladder":
        return rc_ladder_netlist(n, diode_every=diode_every, tstep=tstep,
                                 tstop=steps * tstep)
    return rc_grid_netlist(n, n, diode_every=diode_every, tstep=tstep,
                           tstop=steps * tstep)


def _large_run(name, device):
    """One f64 check run of phase 39 (the CPU's in a worker process): the
    DC point and the transient's final state, as numpy."""
    import torch
    sys.path.insert(0, REPO)
    torch.set_num_threads(2)
    from circuitsimulator_tpu_torch import Simulator
    sim = Simulator.from_text(_large_deck(*LARGE_CHECKS[name],
                                          LARGE_CHECK_STEPS), device=device)
    x = sim.dc()
    res = sim.transient(x_op=x, save_xs=False)
    return {"solver": sim.opts.tran_solver, "dc": x.cpu().numpy(),
            "final": res.x_final.cpu().numpy(),
            "failed": bool(res.failed)}


def _large_route_rows():
    """The large-N route (lu_solve_large, above K2's 64 unknowns) against
    lu_solve_plain on the card at (64, 130, 1) and (1, 500, 1), f32 and
    f64, with a singular lane: the zeroed lanes equal, lane-relative error
    (1e-10 in f64, 1e-3 in f32), per call, plain, solve_ex and bound."""
    import torch
    from circuitsimulator_tpu_torch.ops import lu
    rows = []
    for B, N in ((64, 130), (1, 500)):
        for dtype in (torch.float32, torch.float64):
            A, b = _systems(B, N, 1, torch.float64, seed=B + N)
            if B > 4:
                A[2:4], b[2:4] = A[0], b[0]   # lane 1 singular, no others
            A, b = A.to(dtype), b[..., 0].to(dtype).contiguous()
            got = lu.lu_solve_large(A, b, FLOOR)
            want = lu.lu_solve_plain(A, b, FLOOR)
            zg, zw = (got == 0).all(-1), (want == 0).all(-1)
            check(torch.equal(zg, zw), f"large route {B, N}: zeroed lanes")
            if B > 4:
                check(bool(zg[1]), "large route: the singular lane is zero")
            err = _lane_rel_err(got[..., None], want[..., None], ~zw)
            tol = 1e-10 if dtype == torch.float64 else 1e-3
            check(err <= tol, f"large route {B, N} {dtype}: {err}")
            size = A.element_size()
            nbytes = B * (N * N + 2 * N) * size
            flops = B * sum(m + 2 * m * m + 2 * m + (2 * m + 1)
                            for m in range(N))
            bms, by = bound_ms(nbytes, flops, dtype)
            rows.append({
                "B": B, "N": N, "R": 1, "dtype": str(dtype)[6:],
                "lane_rel_err": err,
                "ms": cuda_ms(lambda: lu.lu_solve_large(A, b, FLOOR)),
                "plain_ms": cuda_ms(lambda: lu.lu_solve_plain(A, b, FLOOR),
                                    reps=3, warmup=1),
                "library_ms": cuda_ms(lambda: torch.linalg.solve_ex(A, b)),
                "bound_ms": bms, "bound_by": by})
    return rows


def _k2_large_timings(shapes):
    """K2 at the slice's Schur shapes (the bordered solves' m x m corner,
    one per Newton iteration): kernel against plain (max abs error), per
    call, plain, solve_ex and bound."""
    import torch
    from circuitsimulator_tpu_torch.ops import lu
    rows = []
    for (B, N, dtype), what in shapes.items():
        g = torch.Generator().manual_seed(7 + B)
        A = (torch.randn(B, N, N, generator=g, dtype=torch.float64)
             + 2.0 * torch.eye(N, dtype=torch.float64)).to(dtype).cuda()
        b = torch.randn(B, N, generator=g, dtype=torch.float64).to(
            dtype).cuda()
        err = float((lu.lu_solve(A, b, FLOOR)
                     - lu.lu_solve_plain(A, b, FLOOR)).abs().max())
        check(err <= (1e-12 if dtype == torch.float64 else 1e-5),
              f"K2 at {what}: {err}")
        size = A.element_size()
        bms, by = bound_ms(B * (N * N + 2 * N) * size,
                           B * sum(m + 2 * m * m + 2 * m + (2 * m + 1)
                                   for m in range(N)), dtype)
        rows.append({"shape": what, "B": B, "N": N, "R": 1,
                     "dtype": str(dtype)[6:], "max_abs_err": err,
                     "kernel_ms": cuda_ms(lambda: lu.lu_solve(A, b, FLOOR)),
                     "plain_ms": cuda_ms(lambda: lu.lu_solve_plain(A, b,
                                                                   FLOOR)),
                     "library_ms": cuda_ms(lambda: torch.linalg.solve_ex(A,
                                                                         b)),
                     "bound_ms": bms, "bound_by": by})
    return rows


def phase_large_circuit():
    """Phase 39: the large-circuit stack on the card through Simulator's
    entry points, in bench_ladder.py's and bench_grid.py's fast f32
    configuration (alpha 1, the predictor, one unrolled iteration): the
    10,000-node RC ladder with 1,000 diodes (tridiag, PCR) single lane,
    500 steps, and over 256 Monte-Carlo lanes (the batched DC, then the
    non-fused batched transient: K1's gate refuses N > 64), 100 steps; the
    100 x 100 grid through blockband (a diode every 10 nodes) and blockwb
    (every 20: Woodbury rank 500, its k x k solve on the large-N route),
    100 steps each.  Each run: steps/s, Newton iterations a step, K2
    launches and large-N route calls, counts reset just before it.  Then
    the f64 checks against the port's CPU runs (worker processes), the
    large-N route against lu_solve_plain, and K2 at the Schur shapes."""
    import multiprocessing
    import torch
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
    from circuitsimulator_tpu_torch.ops import cuda_lu, lu
    from circuitsimulator_tpu_torch.parallel import montecarlo as tmc
    t_phase = time.perf_counter()
    fast = DEFAULT_OPTIONS.replace(dtype=torch.float32, dc_tol=1e-5,
                                   tran_tol=1e-4, tran_alpha=1.0,
                                   tran_predictor=True, tran_unrolled_iters=1)
    tstep = 1e-11
    out = {"runs": {}}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(3, mp_context=ctx) as pool:
        cpu = {n: pool.submit(_large_run, n, "cpu") for n in LARGE_CHECKS}
        runs = (("ladder10k_f32", "ladder", 10000, 10, 500, 0, "tridiag"),
                ("ladder10k_lanes256_f32", "ladder", 10000, 10, 100, 256,
                 "tridiag"),
                ("grid100_blockband_f32", "grid", 100, 10, 100, 0,
                 "blockband"),
                ("grid100_blockwb_f32", "grid", 100, 20, 100, 0, "blockwb"))
        for name, kind, n, every, steps, lanes, solver in runs:
            sim = Simulator.from_text(_large_deck(kind, n, every, steps),
                                      opts=fast, device="cuda")
            check(sim.opts.tran_solver == solver,
                  f"{name}: backend {sim.opts.tran_solver}")
            bp = (tmc.perturb_params(sim.params, torch.Generator(
                      device="cuda").manual_seed(39),
                                     lanes, {"res_r": 0.01, "cap_c": 0.02})
                  if lanes else None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_lu.LAUNCHES = lu.LARGE_CALLS = 0
            t0 = time.perf_counter()
            x0 = tmc.batched_dc_fast(sim.engine, bp) if lanes else sim.dc()
            torch.cuda.synchronize()
            dc_s = time.perf_counter() - t0
            k2_dc = cuda_lu.LAUNCHES
            t0 = time.perf_counter()
            res = (tmc.batched_transient(sim.engine, bp, tstep, steps * tstep,
                                         x0=x0) if lanes
                   else sim.transient(x_op=x0, save_xs=False))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            iters = float(res.newton_iters.double().sum()) / steps \
                / max(lanes, 1)
            check(bool(torch.isfinite(res.x_final).all()),
                  f"{name}: finite")
            check(not bool(res.failed.any()), f"{name}: no failed lane")
            lay = sim.engine._blockband_layout
            m = {"N": sim.topo.n_unknowns, "lanes": max(lanes, 1),
                 "steps": steps, "solver": solver,
                 "layout": None if lay is None else {
                     "h": lay.h, "k": lay.k, "nb": lay.nb, "mb": lay.mb},
                 "dc_seconds": dc_s, "tran_seconds": wall,
                 "steps_per_s": steps / wall,
                 "lane_steps_per_s": steps * max(lanes, 1) / wall,
                 "newton_iters_per_step": iters,
                 "k2_launches": cuda_lu.LAUNCHES, "k2_launches_dc": k2_dc,
                 "large_route_calls": lu.LARGE_CALLS,
                 "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
            check(m["k2_launches"] > 0, f"{name}: K2 launched")
            out["runs"][name] = m
            emit(f"large_circuit_{name}", **m)
            del sim, bp, x0, res
            torch.cuda.empty_cache()
        checks = {}
        for name in LARGE_CHECKS:
            card = _large_run(name, "cuda")
            ref = cpu[name].result()
            check(card["solver"] == ref["solver"], f"{name}: backend")
            check(not card["failed"] and not ref["failed"], f"{name}: failed")
            checks[name] = {
                "solver": card["solver"],
                "dc_max_abs": float(abs(card["dc"] - ref["dc"]).max()),
                "final_max_abs": float(abs(card["final"]
                                           - ref["final"]).max())}
            check(max(checks[name]["dc_max_abs"],
                      checks[name]["final_max_abs"]) <= 1e-9,
                  f"{name}: card within 1e-9 V of the CPU")
        out["f64_vs_cpu"] = checks
        emit("large_circuit_f64_vs_cpu", steps=LARGE_CHECK_STEPS, **checks)
    out["large_route"] = _large_route_rows()
    emit("large_circuit_large_route", rows=out["large_route"])
    out["k2_shapes"] = _k2_large_timings({
        (1, 1, torch.float32): "the ladder's and the grids' Schur corner "
                               "(m = 1), single lane",
        (256, 1, torch.float32): "the ladder's Schur corner, 256 lanes"})
    emit("large_circuit_k2_shapes", rows=out["k2_shapes"])
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit("large_circuit", phase_seconds=out["phase_seconds"])
    return out



def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    walls = {}

    def timed(fn, *args):
        """fn(*args), its wall seconds kept under its name."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[fn.__name__] = time.perf_counter() - t0
        return out

    card = timed(phase_device)
    max_abs, timings = timed(phase_k2)
    timed(phase_single_lane)
    launches, x32, x64 = timed(phase_monte_carlo)
    timed(phase_cuda_vs_cpu)
    k1_err = timed(phase_k1)
    k1_launches, k1_main, k1_main_run = timed(phase_monte_carlo_fused,
                                              x32, x64)
    ac_main, ac_lanes, cli_k3 = timed(phase_ac_monte_carlo)
    k3_err = timed(phase_k3, ac_lanes, cli_k3)
    k1b_err = timed(phase_k1b)
    bjt, bjt_main = timed(phase_monte_carlo_fused_bjt)
    switch = timed(phase_monte_carlo_fused_switch)
    ac_bjt = timed(phase_ac_bjt)
    k1d_err = timed(phase_k1d)
    inamp, inamp_main = timed(phase_monte_carlo_fused_inamp)
    charge = timed(phase_monte_carlo_fused_charge)
    k1d_ii_err = timed(phase_k1d_ii)
    beh, beh_main = timed(phase_monte_carlo_fused_behavioral)
    timed(phase_cli_bsource)
    timed(phase_nodeset)
    k1c_err = timed(phase_k1c_i)
    meas = timed(phase_monte_carlo_measures)
    timed(phase_cli_measures)
    k1c_ii_err = timed(phase_k1c_ii)
    tline = timed(phase_monte_carlo_tline)
    timed(phase_cli_tline)
    tn = timed(phase_trnoise)
    mut = timed(phase_mutual)
    sweep = timed(phase_dc_sweep)
    step = timed(phase_step)
    ic_k2 = timed(phase_ic)
    trap = timed(phase_trap)
    lu_rows = timed(phase_lu_solver)
    adap = timed(phase_adaptive)
    ckpt = timed(phase_checkpoint, trap)
    ss = timed(phase_small_signal)
    stats = timed(phase_statistics)
    large = timed(phase_large_circuit)
    k3_rows = timed(phase_k3_timings)
    k2_device, k1_device_ms = timed(phase_k2_device, timings, k1_main_run)
    k3_device = timed(phase_k3_device, k3_rows)
    k3_shapes = [{**t, **d} for t, d in zip(k3_rows, k3_device)]
    k3_main = next(r for r in k3_shapes if r["shape"] == K3_MAIN)
    k2_main = timings[0]             # B=8192, N=31, R=1, f32: batched DC
    # launches: read just after each main path's run, counts set to 0 just
    # before it; every path of every kernel must have launched it
    paths = {
        "lu_batched": {"monte_carlo_f32_fast": launches,
                       "monte_carlo_fused_bjt_f32": bjt["setup_k2_launches"],
                       "ac_bjt_f32_dc_f64": ac_bjt["dc_k2_launches_f64"],
                       "monte_carlo_fused_inamp_f32":
                           inamp["setup_k2_launches"],
                       **{f"monte_carlo_fused_{n}_f32":
                          charge[n][0]["setup_k2_launches"]
                          for n in ("charge_stage", "buffer_charge")},
                       "monte_carlo_fused_behavioral_f32":
                           beh["setup_k2_launches"],
                       "monte_carlo_measures_mc_filter_f32":
                           meas["mc_filter"]["k2_launches"],
                       "monte_carlo_tline_f32":
                           tline["bench"]["k2_launches"],
                       "ac_tline_f32": tline["ac_float32"]["k2_launches"],
                       **{f"monte_carlo_fused_{n}_f32": d[0]["k2_launches"]
                          for n, d in mut["decks"].items()},
                       **{f"dc_sweep_cli_{n}_f64": r["k2_launches"]
                          for n, r in sweep["cli"].items()},
                       "dc_sweep_dbmixer_f64": sweep["dbmixer"]["k2_launches"],
                       "ic_transients_f64": ic_k2,
                       "trap_cli_buffer_f64": trap["cli"]["k2_launches"],
                       "trap_dbmixer_f32": trap["main"]["k2_launches"],
                       "trap_charge_f64": trap["charge"]["k2_launches"],
                       **{f"lu_solver_dbmixer_{m}_f32": r["k2_launches"]
                          for m, r in lu_rows.items()},
                       **{f"adaptive_dbmixer_{n}_f64": adap[n]["k2_launches"]
                          for n in ("single", "batch")},
                       **{f"checkpoint_{n}_f32": ckpt[n]["k2_launches"]
                          for n in ("dbmixer", "noisy_dbmixer")},
                       **{f"small_signal_{n}_f64": ss["api"][n]["k2_launches"]
                          for n in ("tf_bjt_amp", "tf_cs_amp",
                                    "sensitivity_cs_amp", "pole_zero_cs_amp",
                                    "noise_tline", "loop_gain_tline",
                                    "group_delay_tline")},
                       **{f"statistics_{n}": stats["runs"][n]["k2_launches"]
                          for n in ("yield_mc_filter_mc_f64",
                                    "sobol_bjt_amp_ac_f64",
                                    "worst_case_inamp_dc_f64",
                                    "worst_case_bjt_ac_f64",
                                    "calibrate_mc_filter_f64",
                                    "fit_measures_mc_filter_f64")},
                       **{f"statistics_high_sigma_{n}":
                          stats["high_sigma"][n]["k2_launches"]
                          for n in ("lhs", "scaled_is", "form", "mpp_is")},
                       **{f"statistics_budget_{n}":
                          stats["runs"][f"worst_case_{n}_f64"]["budget"][
                              "k2_launches"] for n in ("inamp_dc", "bjt_ac")},
                       "statistics_adjoint_forward_mc_filter_f64":
                           stats["adjoint"]["forward_k2_launches"],
                       "statistics_adjoint_backward_mc_filter_f64":
                           stats["adjoint"]["backward_k2_launches"],
                       **{f"large_circuit_{n}": r["k2_launches"]
                          for n, r in large["runs"].items()}},
        "fused_step": {"monte_carlo_fused_f32_fast": k1_launches,
                       "monte_carlo_fused_bjt_f32": bjt["k1_launches"],
                       **{f"monte_carlo_fused_{n}_f32": m["k1_launches"]
                          for n, m in switch.items()},
                       "monte_carlo_fused_inamp_f32": inamp["k1_launches"],
                       **{f"monte_carlo_fused_{n}_f32":
                          charge[n][0]["k1_launches"]
                          for n in ("charge_stage", "buffer_charge")},
                       "monte_carlo_fused_behavioral_f32":
                           beh["k1_launches"],
                       **{f"monte_carlo_measures_{n}_f32":
                          meas[n]["k1_launches"]
                          for n in ("mc_filter", "bjt_amp", "rc_step")},
                       "monte_carlo_measures_cli_run_mc":
                           meas["cli"]["k1_launches"],
                       "monte_carlo_tline_f32":
                           tline["bench"]["k1_launches"],
                       "monte_carlo_tline_measures_f32":
                           tline["measures"]["k1_launches"],
                       "trnoise_dbmixer_f32":
                           tn["main"]["noisy"]["k1_launches"],
                       **{f"monte_carlo_fused_{n}_f32": d[0]["k1_launches"]
                          for n, d in mut["decks"].items()},
                       "step_rc_step_f32": step["f32"]["k1_launches"],
                       **{f"statistics_yield_mc_filter_{n}_f32":
                          stats["runs"][f"yield_mc_filter_{n}_f32"][
                              "k1_launches"]
                          for n in ("mc", "lhs", "sobol", "antithetic")},
                       **{f"statistics_high_sigma_{n}":
                          stats["high_sigma"][n]["k1_launches"]
                          for n in ("lhs", "scaled_is", "mpp_is")},
                       "statistics_sobol_mc_filter_f32":
                           stats["runs"]["sobol_mc_filter_f32"][
                               "k1_launches"]},
        "ac_sweep": {"ac_monte_carlo_f32": ac_main["k3_launches"],
                     "ac_bjt_f32": ac_bjt["k3_launches"],
                     "ac_charge_f32": charge["ac_f32"]["k3_launches"],
                     "monte_carlo_measures_ac_opamp_filter_f32":
                         meas["ac"]["k3_launches"],
                     "ac_xfmr_single_f64": mut["single"]["ac_k3_launches"],
                     **{f"small_signal_{n}": ss["api"][n]["k3_launches"]
                        for n in ("noise_bjt_amp", "noise_figure_bjt_amp",
                                  "loop_gain_feedback_loop",
                                  "group_delay_feedback_loop", "sparams_pad",
                                  "sparams_cs_amp")},
                     **{f"small_signal_cli_{n}": ss["cli"][n]["k3_launches"]
                        for n in SMALL_SIGNAL_CLI},
                     "statistics_sobol_bjt_amp_ac_f64":
                         stats["runs"]["sobol_bjt_amp_ac_f64"]["k3_launches"],
                     **{c["path"]: c["launches"] for c in K3_SHAPES.values()
                        if c["path"]}}}
    for kernel, by_path in paths.items():
        for path, n in by_path.items():
            check(n > 0, f"{kernel} launched on {path}")
    print(json.dumps({"kernels": [{
        "name": "lu_batched", "route": "cuda",
        "source": "circuitsimulator_tpu_torch/csrc/lu_batched.cu",
        "replaces": "circuitsimulator_tpu/ops/pallas_lu.py:35",
        "launches": sum(paths["lu_batched"].values()),
        "launches_by_path": paths["lu_batched"],
        "max_abs_err": max(max_abs, *(r["max_abs_err"]
                                      for r in stats["k2_shapes"])),
        "ms": k2_main["kernel_ms"], "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"],
        "shape": "B=8192 N=31 R=1 f32 (one batched-DC Newton solve)",
        "shapes": [{**t, **d} for t, d in zip(timings, k2_device)],
        "slice_shapes": stats["k2_shapes"] + large["k2_shapes"],
        "large_route": {
            "what": "lu_solve_large (torch.linalg.lu_factor_ex + lu_solve "
                    "with the fail contract) above N = 64 on CUDA: a "
                    "library call in place of XLA's looped LU, no kernel",
            "calls_by_path": {n: r["large_route_calls"]
                              for n, r in large["runs"].items()},
            "rows": large["large_route"]}}, {
        "name": "fused_step", "route": "cuda",
        "scope": "K1a + K1b + K1c-i + K1c-ii + K1c-iii + K1d-i + K1d-ii"
                 " + K1e",
        "source": "circuitsimulator_tpu_torch/csrc/fused_step.cu",
        "replaces": "circuitsimulator_tpu/ops/pallas_step.py:582",
        "launches": sum(paths["fused_step"].values()),
        "launches_by_path": paths["fused_step"],
        "max_abs_err": max(k1_err, k1_main["max_abs_err"], k1b_err,
                           bjt_main["max_abs_err"], k1d_err,
                           inamp_main["max_abs_err"],
                           *(charge[n][1]["max_abs_err"]
                             for n in ("charge_stage", "buffer_charge")),
                           k1d_ii_err, beh_main["max_abs_err"], k1c_err,
                           *(meas[n]["chunk"]["max_abs_err"]
                             for n in ("mc_filter", "bjt_amp", "rc_step")),
                           k1c_ii_err, tline["bench_main"]["max_abs_err"],
                           tline["measures"]["chunk"]["max_abs_err"],
                           tn["k1_err"], tn["k1_main"]["max_abs_err"],
                           *(d[1]["max_abs_err"]
                             for d in mut["decks"].values()),
                           *(r["max_abs_err"] for d in mut["decks"].values()
                             for r in d[2])),
        "ms": k1_main["kernel_ms"], "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": None, "device_ms": k1_device_ms,
        "plan": k1_main["plan"],
        "shape": "dbmixer B=8192 x 250 steps f32 fast (K1a)",
        "scopes": {
            "K1b bjt_amp B=8192 x 250 steps f32 damped": bjt_main,
            "K1d-i inamp B=8192 x 250 steps f32 fast": inamp_main,
            **{f"K1d-i {n} B=8192 x {charge[n][1]['steps']} steps f32 "
               "damped": charge[n][1]
               for n in ("charge_stage", "buffer_charge")},
            "K1d-ii behavioral B=8192 x 250 steps f32 damped": beh_main,
            **{f"K1c-i {n} B=8192 x {meas[n]['chunk']['steps']} steps f32 "
               "with its probe stream": meas[n]["chunk"]
               for n in ("mc_filter", "bjt_amp", "rc_step")},
            "K1c-ii TL_BENCH_DECK B=8192 x 2000 steps f32 damped":
                tline["bench_main"],
            "K1c-ii + K1c-i tline_reflect B=8192 x 512 steps f32 with its "
            "probe stream and delay ring": tline["measures"]["chunk"],
            "K1c-iii noisy dbmixer B=8192 x 250 steps f32 fast with its "
            "noise block": tn["k1_main"],
            **{f"K1e {n} B=8192 x 2000 steps f32 damped": d[1]
               for n, d in mut["decks"].items()}}}, {
        "name": "ac_sweep", "route": "cuda",
        "source": "circuitsimulator_tpu_torch/csrc/ac_sweep.cu",
        "replaces": "circuitsimulator_tpu/ops/pallas_ac.py:49",
        "launches": sum(paths["ac_sweep"].values()),
        "launches_by_path": paths["ac_sweep"],
        "max_abs_err": max(k3_err, ss["k3_max_abs_err"]),
        "ms": k3_main["kernel_ms"], "plain_ms": k3_main["plain_ms"],
        "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
        "library_ms": k3_main["library_ms"],
        "device_ms": k3_main["kernel_device_ms"], "plan": k3_main["plan"],
        "shape": "dbmixer B=4096 F=64 N=31 f32 (one AC Monte-Carlo sweep)",
        "shapes": k3_shapes}]}), flush=True)
    emit("total", seconds=time.perf_counter() - t_start, phases=walls)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
