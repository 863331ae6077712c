#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one JSON line each):
  1. device: card, power limit, torch/CUDA versions, TF32 flags; builds the
     CUDA kernels from circuitsimulator_tpu_torch/csrc with nvcc;
  2. K2 (batched pivoted LU, csrc/lu_batched.cu) against its plain PyTorch
     version on the card at the main path's shapes, f32 and f64, with planted
     pivoting, singular, below-floor and NaN lanes; kernel and plain times;
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
     against phase 4's non-fused run on the same lanes); then B = 1024 in
     f64, damped, 500 steps, within 1e-9 V of phase 4's f64 run;
  8. the AC Monte-Carlo main path (bench_ac_mc's workload): dbmixer,
     B = 4096 lanes x F = 64 frequencies (1 MHz .. 10 GHz), batched DC (K2)
     then the fused AC sweep (K3, csrc/ac_sweep.cu), f32 and f64: AC
     solves/s, one K3 launch per sweep call, no failed lane, f32 within
     1e-3 of f64, f64 within 1e-9 of the real 2N reference route on 64
     lanes; then the CLI's --run-ac on examples/cs_amp.sp and
     examples/feedback_loop.sp against the committed JAX goldens (1e-9);
  9. K3 against its plain PyTorch version on the card: random lanes at
     N = 5, 31, 64 in f32 and f64 with a singular and a NaN lane (fail
     masks identical, lane-relative error <= 1e-12 in f64, <= 1e-4 in
     f32), and phase 8's dbmixer systems; kernel, plain,
     torch.linalg.solve_ex and bound times at the main shape.

Every error of K3 and of the AC path is lane-relative: for each lane
max|x - ref| / max|ref| over its frequencies and unknowns, then the worst
lane.  Kernel launch counts are reset just before each main-path run
(phases 4, 7 and 8) and read just after it.  The last lines are the
kernels JSON, the card's name and power limit, and {"ok": true,
"device": {...}}.  There is no fallback: without a GPU, or if any build,
launch or check fails, the script exits non-zero without the last line.
"""

import contextlib
import concurrent.futures
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
    ptxas = {n: [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "stack frame" in ln]
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
    from circuitsimulator_tpu_torch.ops import lu
    cases = [(8192, 31, 1), (8192, 6, 1), (1024, 31, 31), (1, 4, 1)]
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
    # (k=6), the per-chunk G0 inverse (R=N=31); all B=8192
    # torch.linalg.solve_ex computes the same function (without the pivot
    # floor's fail contract; _ex: the planted singular lanes do not raise):
    # timed as a yardstick only
    timings = []
    for B, N, R in [(8192, 31, 1), (8192, 6, 1), (8192, 31, 31)]:
        for dtype in (torch.float32, torch.float64):
            A, b = _systems(B, N, R, dtype, seed=7)
            size = A.element_size()
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
                "bound_ms": bms, "bound_by": by})
    emit("k2_vs_plain", cases=results, timings=timings, max_abs_err=max_abs)
    return max_abs, timings


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
def _mc_lanes(opts, B, seed):
    """dbmixer on the card and B lanes drawn from `seed` (lane 0 nominal)."""
    import torch
    from circuitsimulator_tpu_torch import Simulator
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    sim = Simulator.from_file(os.path.join(NETLISTS, "dbmixer.sp"),
                              opts=opts, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bp = mc.perturb_params(sim.params, gen, B, SIGMAS)
    for k in SIGMAS:
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
    carry = mc.init_carry(eng, x0)
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
        carry = mc.init_carry(sim.engine, x0)
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
def _k1_case(name, sim, B, steps, from_dc, tol, seed=11):
    """K1 and its plain version on the same lanes of `sim` (on the card)."""
    import torch
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bp = mc.perturb_params(sim.params, gen, B, SIGMAS)
    dt = sim.config.tran.tstep or 2e-9
    carry, _, meta = mc.make_fused_transient_fn(sim.engine, bp, dt)
    runner = meta["runner"]
    if not from_dc:
        x = torch.zeros_like(carry[0])
        st = sim.engine.init_state(x)
        carry = (x, x, st["vc"], st["il"], carry[4])
    got = runner.run_chunk(*carry, 0, steps)
    ref = runner.run_chunk_plain(*carry, 0, steps)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got[:4], ref[:4])
              if a.numel())
    row = {"case": name, "B": B, "steps": steps,
           "dtype": str(sim.engine.dtype)[6:], "N": runner.N, "k": runner.k,
           "max_abs_err": err, "tol": tol,
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
def _fused_run(opts, B, n_steps, chunk, seed):
    """The fused main path: batched DC (K2), then K1 chunks.  Counts are
    reset just before and read just after."""
    import torch
    from circuitsimulator_tpu_torch.ops import cuda_lu, cuda_step
    from circuitsimulator_tpu_torch.parallel import montecarlo as mc
    sim, bp = _mc_lanes(opts, B, seed)
    dt = sim.config.tran.tstep
    torch.cuda.synchronize()
    cuda_lu.LAUNCHES = 0
    cuda_step.LAUNCHES = 0
    t0 = time.perf_counter()
    carry, advance, meta = mc.make_fused_transient_fn(sim.engine, bp, dt,
                                                      chunk=chunk)
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
    m = {"B": B, "dtype": str(opts.dtype)[6:], "steps": n_steps,
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
    check(m["setup_k2_launches"] > 0, "batched DC ran through K2")
    check(m["failed_lanes"] == 0, "no failed lanes")
    return m, carry, meta["runner"], lane0, sim.topo


def phase_monte_carlo_fused(x32_nonfused, x64_nonfused):
    import numpy as np
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    from circuitsimulator_tpu_torch.ops import cuda_step
    m, carry, runner, lane0, topo = _fused_run(fast_f32_options(), 8192,
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
    n_iters = int(got[5].sum())
    B, N, k, P = runner.B, runner.N, runner.k, runner.P
    size = runner.G0invT.element_size()
    # each input read once, each output written once: the constants, the
    # carry in and out, the failed flags and iteration counts
    nbytes = size * B * (N * N + k * N + 3 * k * k + 4 * k
                         + runner.nS * (1 + 7 + 5 + 2 * P) + runner.nCap
                         + runner.nL + 2 * (2 * N + runner.nCap + runner.nL))
    nbytes += 4 * B * (runner.nS + 3)
    # per lane-step: sources (~20 each) and their scatter, inductor and cap
    # history terms, z0, predictor, history update; per Newton iteration:
    # MOS linearisation (~25 per device), z, S, vz, the k x k elimination
    # and back substitution, x_raw, accept
    per_step = (22 * runner.nS + 2 * runner.nL + 4 * runner.nCap
                + 2 * N * N + 2 * N)
    per_iter = (25 * k + 2 * k * N + 6 * k * k + 6 * k
                + sum(m_ + 2 * m_ * m_ + 2 * m_ for m_ in range(k))
                + k * k + k + 2 * k * N + 7 * N)
    flops = B * 250 * per_step + n_iters * per_iter
    bms, by = bound_ms(nbytes, flops, runner.dtype)
    main = {"B": B, "steps": 250, "dtype": "float32", "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: runner.run_chunk(*carry, 2000, 250),
                                 reps=5, warmup=1),
            "plain_ms": cuda_ms(
                lambda: runner.run_chunk_plain(*carry, 2000, 250),
                reps=3, warmup=1),
            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
            "flops": flops}
    # the same launch at narrower blocks (more SMs busy at B = 8192): a
    # measurement for later tuning, the path keeps cuda_step.THREADS
    main["kernel_ms_by_threads"] = {
        th: cuda_ms(lambda: cuda_step.run_chunk_cuda(runner, *carry, 2000,
                                                     250, threads=th),
                    reps=5, warmup=1) for th in (128, 64, 32)}
    m["kernel_at_main_shape"] = main
    emit("monte_carlo_fused_f32_fast", **m)
    m64, carry64, _, _, _ = _fused_run(DEFAULT_OPTIONS, 1024, 500, 250,
                                       seed=43)
    m64["final_max_abs_vs_nonfused"] = float(
        (carry64[0] - x64_nonfused).abs().max())
    check(m64["final_max_abs_vs_nonfused"] <= 1e-9,
          "fused f64 within 1e-9 V of the non-fused run")
    emit("monte_carlo_fused_f64_reference", **m64)
    return launches, main

# ------------------------------------------------------------ phases 8, 9
AC_FREQS = (6.0, 10.0, 64)          # np.logspace(6, 10, 64): 1 MHz .. 10 GHz


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


def _ac_run(sim, bp, freqs):
    """The AC Monte-Carlo main path: batched DC, then the warm batched
    sweep (one call to warm up, five timed).  Counts are reset just before
    and read just after."""
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
    check(k2 > 0, "batched DC ran through K2")
    check(m["failed_lanes"] == 0, f"{m['failed_lanes']} failed AC lanes")
    return m, x_ops, xr, xi


def phase_ac_monte_carlo():
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch import cli
    from circuitsimulator_tpu_torch.analysis.ac import (ac_system_real,
                                                        solve_ac_real)
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
            with contextlib.redirect_stdout(buf):
                rc = cli.main([os.path.join(REPO, "examples", f"{deck}.sp"),
                               "--no-tran", "--run-ac", out])
            check(rc == 0, f"{deck} --run-ac exit code")
            check(f"Results written to '{out}'." in buf.getvalue(),
                  f"{deck} --run-ac stdout")
            err, flips = _ac_csv_err(
                out, os.path.join(GOLDENS, f"{deck}_ac_jax.csv"))
            cli_rows[deck] = {"rel_err_vs_jax_golden": err,
                              "print_flips": flips,
                              "cli_s": time.perf_counter() - t0}
            check(err <= 1e-9, f"{deck} --run-ac CSV within 1e-9: {err}")
    finally:
        shutil.rmtree(tmp)
    emit("ac_cli_vs_jax_goldens", decks=cli_rows)
    return m32, {"float32": (sim32, bp32, x32), "float64": (sim64, bp64, x64)}


def _ac_random(B, n, dtype, seed):
    """Diagonally dominant lanes (tests/test_pallas_ac.py); lane 1 exactly
    singular, lane 2 holds a NaN."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, n, n)) + n * np.eye(n),
              rng.standard_normal((B, n, n)), rng.standard_normal((B, n)),
              rng.standard_normal((B, n))]
    arrays[0][1] = 0.0
    arrays[1][1] = 0.0
    arrays[0][2, n // 2, 1] = np.nan
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in arrays]


def phase_k3(lanes):
    import numpy as np
    import torch
    from circuitsimulator_tpu_torch.analysis.ac import ac_system_real
    from circuitsimulator_tpu_torch.ops import ac_sweep
    rows, max_abs = [], 0.0
    for n in (5, 31, 64):
        for dtype in (torch.float64, torch.float32):
            G, B1, br, bi = _ac_random(300, n, dtype, seed=n)
            # omega <= 1 keeps G + n I dominant (at omega = 100 the random
            # w B1 sets the conditioning, and f32 rounding with it)
            om = torch.logspace(-1, 0, 8, dtype=dtype, device="cuda")
            xr, xi = ac_sweep.ac_sweep(G, B1, br, bi, om, FLOOR)
            pr, pi = ac_sweep.ac_sweep_plain(G, B1, br, bi, om, FLOOR)
            torch.cuda.synchronize()
            zk, zp = _zero_lanes(xr, xi), _zero_lanes(pr, pi)
            check(torch.equal(zk, zp), f"K3 fail masks N={n} {dtype}")
            check(bool(zk[1] and zk[2]), "singular and NaN lanes zeroed")
            rel = _lane_rel_err(torch.complex(xr, xi), torch.complex(pr, pi),
                            ~zp)
            tol = 1e-12 if dtype == torch.float64 else 1e-4
            check(rel <= tol, f"K3 vs plain N={n} {dtype}: {rel} > {tol}")
            good = ~zp
            max_abs = max(max_abs, float((xr - pr).abs()[good].max()),
                          float((xi - pi).abs()[good].max()))
            rows.append({"case": "random", "B": 300, "F": 8, "N": n,
                         "dtype": str(dtype)[6:], "lane_rel_err": rel,
                         "tol": tol, "zero_lanes": int(zk.sum())})
    freqs = np.logspace(*AC_FREQS)
    timings = {}
    for name, (sim, bp, x_ops) in lanes.items():
        eng = sim.engine
        G, B1, br, bi = ac_system_real(eng, bp, x_ops, 1.0)
        om = 2.0 * np.pi * torch.as_tensor(freqs, dtype=eng.dtype,
                                           device="cuda")
        xr, xi = ac_sweep.ac_sweep(G, B1, br, bi, om, FLOOR)
        pr, pi = ac_sweep.ac_sweep_plain(G, B1, br, bi, om, FLOOR)
        torch.cuda.synchronize()
        zk, zp = _zero_lanes(xr, xi), _zero_lanes(pr, pi)
        check(torch.equal(zk, zp) and not bool(zp.any()),
              f"dbmixer K3 fail masks {name}")
        rel = _lane_rel_err(torch.complex(xr, xi), torch.complex(pr, pi))
        tol = 1e-12 if eng.dtype == torch.float64 else 1e-4
        check(rel <= tol, f"dbmixer K3 vs plain {name}: {rel} > {tol}")
        max_abs = max(max_abs, float((xr - pr).abs().max()),
                      float((xi - pi).abs().max()))
        B, n = G.shape[0], G.shape[-1]
        F = len(freqs)
        rows.append({"case": "dbmixer unit-omega systems", "B": B, "F": F,
                     "N": n, "dtype": name, "lane_rel_err": rel,
                     "tol": tol, "zero_lanes": int(zk.sum())})
        # the library yardstick: one complex solve of the pre-formed
        # (B * F, N, N) systems (formation excluded; its fail semantics
        # differ, so it is timed only)
        A = torch.complex(G[:, None].expand(B, F, n, n),
                          om[None, :, None, None] * B1[:, None])
        A = A.reshape(B * F, n, n)
        rhs = torch.complex(br, bi)[:, None].expand(B, F, n).reshape(
            B * F, n, 1)
        bms, by = bound_ms(ac_bytes(B, F, n, G.element_size()),
                           ac_flops(B, F, n), eng.dtype)
        timings[name] = {
            "B": B, "F": F, "N": n,
            "kernel_ms": cuda_ms(lambda: ac_sweep.ac_sweep(
                G, B1, br, bi, om, FLOOR)),
            "plain_ms": cuda_ms(lambda: ac_sweep.ac_sweep_plain(
                G, B1, br, bi, om, FLOOR), reps=3, warmup=1),
            "library_ms": cuda_ms(lambda: torch.linalg.solve_ex(A, rhs)),
            "bound_ms": bms, "bound_by": by,
            "flops": ac_flops(B, F, n),
            "bytes": ac_bytes(B, F, n, G.element_size())}
        del A, rhs
    # N = 64, the kernel's largest size: random lanes, B = 1024 x F = 64
    for dtype in (torch.float32, torch.float64):
        G, B1, br, bi = _ac_random(1024, 64, dtype, seed=65)
        om = torch.logspace(-1, 0, 64, dtype=dtype, device="cuda")
        bms, by = bound_ms(ac_bytes(1024, 64, 64, G.element_size()),
                           ac_flops(1024, 64, 64), dtype)
        A = torch.complex(G[:, None].expand(1024, 64, 64, 64),
                          om[None, :, None, None] * B1[:, None]).reshape(
                              -1, 64, 64)
        rhs = torch.complex(br, bi)[:, None].expand(1024, 64, 64).reshape(
            -1, 64, 1)
        timings[f"{str(dtype)[6:]} N=64"] = {
            "library_ms": cuda_ms(lambda: torch.linalg.solve_ex(A, rhs)),
            "B": 1024, "F": 64, "N": 64,
            "kernel_ms": cuda_ms(lambda: ac_sweep.ac_sweep(
                G, B1, br, bi, om, FLOOR)),
            "plain_ms": cuda_ms(lambda: ac_sweep.ac_sweep_plain(
                G, B1, br, bi, om, FLOOR), reps=3, warmup=1),
            "bound_ms": bms, "bound_by": by}
        del A, rhs
    emit("k3_vs_plain", cases=rows, timings=timings, max_abs_err=max_abs)
    return max_abs, timings


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    card = phase_device()
    max_abs, timings = phase_k2()
    phase_single_lane()
    launches, x32, x64 = phase_monte_carlo()
    phase_cuda_vs_cpu()
    k1_err = phase_k1()
    k1_launches, k1_main = phase_monte_carlo_fused(x32, x64)
    ac_main, ac_lanes = phase_ac_monte_carlo()
    k3_err, k3_timings = phase_k3(ac_lanes)
    k3_main = k3_timings["float32"]  # B=4096, F=64, N=31: the bench shape
    k2_main = timings[0]             # B=8192, N=31, R=1, f32: batched DC
    print(json.dumps({"kernels": [{
        "name": "lu_batched", "route": "cuda",
        "source": "circuitsimulator_tpu_torch/csrc/lu_batched.cu",
        "replaces": "circuitsimulator_tpu/ops/pallas_lu.py:35",
        "launches": launches, "max_abs_err": max_abs,
        "ms": k2_main["kernel_ms"], "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"]}, {
        "name": "fused_step", "route": "cuda",
        "source": "circuitsimulator_tpu_torch/csrc/fused_step.cu",
        "replaces": "circuitsimulator_tpu/ops/pallas_step.py:582",
        "launches": k1_launches,
        "max_abs_err": max(k1_err, k1_main["max_abs_err"]),
        "ms": k1_main["kernel_ms"], "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": None}, {
        "name": "ac_sweep", "route": "cuda",
        "source": "circuitsimulator_tpu_torch/csrc/ac_sweep.cu",
        "replaces": "circuitsimulator_tpu/ops/pallas_ac.py:49",
        "launches": ac_main["k3_launches"], "max_abs_err": k3_err,
        "ms": k3_main["kernel_ms"], "plain_ms": k3_main["plain_ms"],
        "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
        "library_ms": k3_main["library_ms"]}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
