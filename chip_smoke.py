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
     f64, damped, 500 steps, within 1e-9 V of phase 4's f64 run.

Kernel launch counts are reset just before each main-path run (phases 4
and 7) and read just after it.  The last lines are the kernels JSON, the
card's name and power limit, and {"ok": true, "device": {...}}.  There is
no fallback: without a GPU, or if any build, launch or check fails, the
script exits non-zero without the last line.
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
    names = ("lu_batched", "fused_step")
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


def _lane_rel_err(x, ref, good):
    import torch
    d = (x - ref).abs().amax(dim=(1, 2))
    s = ref.abs().amax(dim=(1, 2)).clamp_min(1e-30)
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
        check(buf.getvalue() == gold[:cut], "dbmixer DC table byte-identical")
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
                       ("linear deck (k=0)", LINEAR_DECK)):
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
        "library_ms": None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
