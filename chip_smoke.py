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
     (8192, 31, 31), (1, 31, 1) and the T-line AC's 2N shape of phase 25
     (their device times are phase 28's);
  3. single lane, f64: buffer.sp through the CLI (stdout byte-identical to
     the golden, CSV within 1e-9 V), dbmixer.sp DC table and its first 2,000
     transient steps within 1e-9 V of the golden;
  4. the batched Monte-Carlo main path: dbmixer.sp, B = 8192 lanes, f32 fast
     configuration, batched DC then 2,000 Backward-Euler Woodbury steps in
     chunks of 500 (lane 0 nominal, held to the golden within 1e-3 V); then
     B = 1024 in f64 with the damped reference configuration;
  5. the same 64 lanes through CUDA (the kernel) and the CPU (the plain
     version), 500 f64 steps, trajectories within 1e-9 V;
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
     times of the mixed deck at B = 8192 x 100 steps;
 11. the fused Monte-Carlo path on a BJT deck: examples/bjt_amp.sp over its
     own .TRAN (dt 2 us, 250 steps), B = 8192 lanes f32 (resistors, bjt_is
     and bjt_bf perturbed), batched DC on K2 then one K1 chunk: lane-steps
     per second, K1 ms per chunk against plain and bound, failed lanes;
     then B = 1024 in f64 against the non-fused f64 run (1e-9 V);
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
     and bound, failed lanes; then B = 1024 in f64, damped, one chunk
     against the non-fused loop (1e-9 V);
 16. the fused Monte-Carlo path on the charge decks: the 2-MOS stage (1 ns,
     1,000 steps in chunks of 250) and buffer.sp under MOSCAP=CHARGE (its
     .TRAN, 300 steps in chunks of 100, from x = 0: the power-up
     transient; its failed lanes are counted, not held to zero, see phase
     14), B = 8192 f32 damped; then B = 1024 in f64 against the non-fused
     loop (1e-9 V; the 2-MOS stage 120 steps from its DC point, buffer.sp
     60 steps from x = 0 at tran_tol 1e-13); then the AC of the 2-MOS
     stage at B = 4096 x F = 64 (its charge trans-caps in B1), f32 and
     f64, f64 against the real 2N route (1e-9);
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
     failed lanes; then B = 1024 in f64 against the non-fused loop (1e-9 V);
 19. the CLI on B-source decks (cli_bsource): behavioral.sp in f64 on the
     card, its DC table byte-identical to the JAX CLI's
     (tests/goldens/behavioral_stdout_jax.txt) and its CSV within 1e-9 V of
     tests/goldens/behavioral_tran_jax.csv; then --no-tran --run-ac on
     sdomain_filter.sp against tests/goldens/sdomain_filter_ac_jax.csv
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
 23. the CLI's .MEASURE output on the card (cli_measures): rc_step.sp and
     mc_filter.sp byte-identical to the JAX CLI's stdout
     (tests/goldens/{rc_step,mc_filter}_stdout_jax.txt), bjt_amp.sp with
     --run-ac through its .MEASURE AC block
     (tests/goldens/bjt_amp_run_ac_stdout_jax.txt, whose .TF block the
     port does not print yet);
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
     lanes with the same keys over 400 steps on the white V + I noise deck
     of tests/test_trnoise_fused.py (f32 damped 5e-5 V, f64 1e-9 V) and
     on the noisy dbmixer (f64 1e-9 V; f32 over 200 steps recorded beside
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

Every error of K3 and of the AC path is lane-relative: for each lane
max|x - ref| / max|ref| over its frequencies and unknowns, then the worst
lane.  Kernel launch counts are reset just before each main-path run
(phases 4, 7, 8, 11, 12, 13, 15, 16, 18, 22, 25 and 27) and read just
after it.  The
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
    # threads, 17: a warp, 33 and 64: two warps) and the single-lane DC
    cases = [(8192, 31, 1), (8192, 6, 1), (1024, 31, 31), (1, 4, 1),
             (2048, 9, 9), (2048, 17, 3), (1024, 33, 33), (512, 64, 64),
             (1, 31, 1)]
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
    timings = []
    for B, N, R in [(8192, 31, 1), (8192, 6, 1), (8192, 31, 31), (1, 31, 1),
                    (tl_lanes, 2 * n_tl, 1)]:
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
    n = 2000
    t0 = time.perf_counter()
    res = sim.transient(tstop=n * sim.config.tran.tstep)
    torch.cuda.synchronize()
    out["dbmixer_2000_steps_s"] = time.perf_counter() - t0
    check(not bool(res.failed), "dbmixer single lane failed")
    cols = np.concatenate([sim.topo.volt_col_eqs, sim.topo.branch_col_eqs])
    ref = golden_rows("dbmixer_tran.csv", n + 1)
    out["dbmixer_max_abs"] = float(
        np.abs(res.xs.cpu().numpy()[:, cols] - ref[:, 1:]).max())
    check(out["dbmixer_max_abs"] <= 1e-9, "dbmixer 2000 steps within 1e-9 V")
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
        for c in range(10):
            ts = torch.arange(c * 50 + 1, c * 50 + 51, dtype=torch.float64,
                              device=dev) * dt
            carry, _ = mc.batched_transient_chunk(sim.engine, p, carry, ts, dt)
            finals.append(carry[0])
        runs[dev] = (torch.stack(finals).cpu(), time.perf_counter() - t0)
    err = float((runs["cuda"][0] - runs["cpu"][0]).abs().max())
    check(err <= 1e-9, f"CUDA vs CPU trajectories {err}")
    emit("cuda_vs_cpu_f64", lanes=64, steps=500, checkpoints=11,
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
    its source's value (one operation)."""
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
    per_step = (22 * runner.nS + 2 * runner.nL + 4 * runner.nCap
                + 2 * N * N + 2 * N + CHARGE_OPS * runner.nMq
                + 2 * n_probe * N + 4 * 2 * nT + runner.nN)
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


def _dc_failed_lanes(engine, bp, x0, bar):
    """Lanes whose batched DC point is not one: non-finite, or one more
    undamped Newton solve at the final gmin moves it by more than `bar`
    volts."""
    import torch
    from circuitsimulator_tpu_torch.ops import lu
    N, opts = engine.N, engine.opts
    G_s, I_s = engine.dc_static(bp, engine._scalar(1.0))
    G, I = engine.assemble_dc_iter(G_s, I_s, bp, x0, opts.gmin_low_base)
    x_raw = lu.lu_solve(G[..., :N, :N], I[..., :N], opts.lu_pivot_floor)
    move = (x_raw - x0).abs().amax(-1)
    bad = ~torch.isfinite(x0).all(-1) | ~(move <= bar)
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
        "mixed deck f32 damped, main width", sim, 8192, 100, True, 1e-4,
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
                  lambda: runner.run_chunk_plain(*carry, 0, 100),
                  reps=1, warmup=0),
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
        DEFAULT_OPTIONS, 1024, 250, 250, seed=46, deck=deck,
        sigmas=JUNCTION_SIGMAS)
    cfg = sim.config.tran
    t0 = time.perf_counter()
    ref = mc.batched_transient(sim.engine, bp, cfg.tstep, cfg.tstop,
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
        DEFAULT_OPTIONS, 1024, 250, 250, seed=49, deck=deck)
    t0 = time.perf_counter()
    ref = mc.batched_transient(sim.engine, bp, 1e-9, 250e-9, fused=False)
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
            ("charge_stage", CHARGE_DECK, 120, f64, False),
            ("buffer_charge", buf, 60,
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
    n = 200
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
    f64 on the card against the JAX CLI's goldens."""
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
        os.chdir(tmp)
        rc, text, out["behavioral_cli_s"] = _cli(
            ["examples/behavioral.sp", "behavioral_tran.csv", "--device",
             "cuda"])
        check(rc == 0, "behavioral CLI exit code")
        gold = read_golden("behavioral_stdout_jax.txt")
        check(text[:len(gold)] == gold,
              "behavioral DC table byte-identical to the JAX CLI's")
        got = np.loadtxt("behavioral_tran.csv", delimiter=",", skiprows=1)
        ref = golden_rows("behavioral_tran_jax.csv", None)
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
        gold = read_golden("bjt_amp_run_ac_stdout_jax.txt")
        check(rc == 0 and gold.startswith(text) and gold[len(text):]
              .startswith("\n==== Transfer function ===="),
              "bjt_amp --run-ac stdout byte-identical to the JAX CLI's "
              "through its .MEASURE AC block")
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
    # 400 steps, from the same DC points: the white V + I noise deck of
    # tests/test_trnoise_fused.py (its diode damped; f32 5e-5 V, f64 1e-9
    # V) and the noisy dbmixer (f64 1e-9 V; in f32 the two paths part by
    # about 2e-4 V over 400 damped steps with or without noise, f32
    # rounding the mixer amplifies, so there both gaps are recorded, over
    # 200 steps)
    for name, deck, sig in (("white", WHITE_NOISE_DECK, {"res_r": 0.01}),
                            ("dbmixer", _noisy_dbmixer(), SIGMAS)):
        for opts, tol in ((damped_f32_options(), 5e-5),
                          (DEFAULT_OPTIONS, 1e-9)):
            held = name == "white" or opts.dtype == torch.float64
            steps = 400 if held else 200
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    card = phase_device()
    max_abs, timings = phase_k2()
    phase_single_lane()
    launches, x32, x64 = phase_monte_carlo()
    phase_cuda_vs_cpu()
    k1_err = phase_k1()
    k1_launches, k1_main, k1_main_run = phase_monte_carlo_fused(x32, x64)
    ac_main, ac_lanes, cli_k3 = phase_ac_monte_carlo()
    k3_err = phase_k3(ac_lanes, cli_k3)
    k1b_err = phase_k1b()
    bjt, bjt_main = phase_monte_carlo_fused_bjt()
    switch = phase_monte_carlo_fused_switch()
    ac_bjt = phase_ac_bjt()
    k1d_err = phase_k1d()
    inamp, inamp_main = phase_monte_carlo_fused_inamp()
    charge = phase_monte_carlo_fused_charge()
    k1d_ii_err = phase_k1d_ii()
    beh, beh_main = phase_monte_carlo_fused_behavioral()
    phase_cli_bsource()
    phase_nodeset()
    k1c_err = phase_k1c_i()
    meas = phase_monte_carlo_measures()
    phase_cli_measures()
    k1c_ii_err = phase_k1c_ii()
    tline = phase_monte_carlo_tline()
    phase_cli_tline()
    tn = phase_trnoise()
    k3_rows = phase_k3_timings()
    k2_device, k1_device_ms = phase_k2_device(timings, k1_main_run)
    k3_device = phase_k3_device(k3_rows)
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
                       "ac_tline_f32": tline["ac_float32"]["k2_launches"]},
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
                           tn["main"]["noisy"]["k1_launches"]},
        "ac_sweep": {"ac_monte_carlo_f32": ac_main["k3_launches"],
                     "ac_bjt_f32": ac_bjt["k3_launches"],
                     "ac_charge_f32": charge["ac_f32"]["k3_launches"],
                     "monte_carlo_measures_ac_opamp_filter_f32":
                         meas["ac"]["k3_launches"],
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
        "launches_by_path": paths["lu_batched"], "max_abs_err": max_abs,
        "ms": k2_main["kernel_ms"], "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"],
        "shape": "B=8192 N=31 R=1 f32 (one batched-DC Newton solve)",
        "shapes": [{**t, **d} for t, d in zip(timings, k2_device)]}, {
        "name": "fused_step", "route": "cuda",
        "scope": "K1a + K1b + K1c-i + K1c-ii + K1c-iii + K1d-i + K1d-ii",
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
                           tn["k1_err"], tn["k1_main"]["max_abs_err"]),
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
            "noise block": tn["k1_main"]}}, {
        "name": "ac_sweep", "route": "cuda",
        "source": "circuitsimulator_tpu_torch/csrc/ac_sweep.cu",
        "replaces": "circuitsimulator_tpu/ops/pallas_ac.py:49",
        "launches": sum(paths["ac_sweep"].values()),
        "launches_by_path": paths["ac_sweep"], "max_abs_err": k3_err,
        "ms": k3_main["kernel_ms"], "plain_ms": k3_main["plain_ms"],
        "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
        "library_ms": k3_main["library_ms"],
        "device_ms": k3_main["kernel_device_ms"], "plan": k3_main["plan"],
        "shape": "dbmixer B=4096 F=64 N=31 f32 (one AC Monte-Carlo sweep)",
        "shapes": k3_shapes}]}), flush=True)
    emit("total", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
