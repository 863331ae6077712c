#!/usr/bin/env python3
"""Where K1's time goes, on one NVIDIA GPU: per deck, the share of each
phase of a lane-step, and the chunk's time on every team and route its
launch plan can take.

    python3 k1_phases.py

It builds a copy of csrc/fused_step.cu with clock64() read by thread 0 of
one lane in 256 at the end of each phase of a step and of a Newton
iteration (devices, z, S, the solve, x_raw, accept; the step's terms,
b0, z0 and the tail: probes, history, ring), summed with atomicAdd into a
device array, and runs one chunk of each deck on it: the shares are
cycles on the SM's clock, waits for other warps included.  Then, on the
library the port builds (no clocks), it times the chunk (CUDA events,
median of three) on each team and route.  The decks and lanes are
chip_smoke.py's (dbmixer f32 fast and f64 damped, bjt_amp, behavioral.sp,
the charge stage, inamp.sp).  One JSON line per deck, the card's name and
power limit, then {"ok": true}.  Needs nvcc; exits 1 without a GPU.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("devices", "z", "S", "solve", "x_raw", "accept", "terms", "b0",
          "z0", "tail")
SAMPLE = 256          # one lane in SAMPLE is clocked

# (anchor in the source, text inserted after it): the counter of each phase
# at the end of that phase, the start mark after the staging
PROBES = (
    ("#include <math.h>\n",
     "__device__ unsigned long long k1_clk[16];\n"
     "__device__ unsigned long long k1_last[1 << 20];\n"
     f"#define CLK(ph) if (tm.t == 0 && lane % {SAMPLE} == 0) {{ "
     "const unsigned long long c_ = clock64(); "
     "atomicAdd(&k1_clk[ph], c_ - k1_last[lane]); k1_last[lane] = c_; }\n"),
    ("qprev, tt);\n    __syncwarp();\n", "    CLK(0)\n"),
    ("        s.Z[n] = zr[r];\n      }\n    }\n    __syncwarp();\n",
     "    CLK(1)\n"),
    ("      Aj[k] = acc;\n    }\n    __syncwarp();\n", "    CLK(2)\n"),
    ("    team_solve(tm, k, s.A, s.sA, s.W);\n", "    CLK(3)\n"),
    ("xraw[r] = row_dot<true>(zr[r], s.Y + n * s.sY, s.W, k);\n    }\n",
     "    CLK(4)\n"),
    ("  fl = fl || (!finite && active);\n  __syncwarp();\n", "  CLK(5)\n"),
    ("  cp_async_wait_all();\n  __syncwarp();\n",
     f"  if (t == 0 && lane % {SAMPLE} == 0) k1_last[lane] = clock64();\n"),
    ("((q & 1) ? j : nT + j)) * B + lane];\n      }\n    }\n    __syncwarp();\n",
     "    CLK(6)\n"),
    ("        s.Z[n] = acc;\n      }\n    }\n    __syncwarp();\n",
     "    CLK(7)\n"),
    ("    __syncwarp();  // also orders the z0 reads of Z before z is written\n",
     "    CLK(8)\n"),
    ("      xr[r] = xx[r];\n    }\n", "    CLK(9)\n"),
)
READERS = """
extern "C" int k1_clk_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k1_clk, sizeof(k1_clk));
}
extern "C" int k1_clk_zero() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(k1_clk, z, sizeof(z));
}
"""


def clocked_source() -> str:
    """csrc/fused_step.cu with the phase counters; fails on a missing
    anchor (the source moved under it)."""
    path = os.path.join(REPO, "circuitsimulator_tpu_torch", "csrc",
                        "fused_step.cu")
    with open(path) as f:
        src = f.read()
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"k1_phases: anchor found {src.count(anchor)} "
                             f"times: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + READERS


def build_clocked():
    from circuitsimulator_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "fused_step_clocked.cu")
    lib = os.path.join(_build.BUILD_DIR, "libfused_step_clocked.so")
    with open(src, "w") as f:
        f.write(clocked_source())
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"k1_phases: nvcc failed\n{r.stdout}{r.stderr}")
    return _build.Built(lib=ctypes.CDLL(lib), path=lib, seconds=0.0,
                        log=r.stdout + r.stderr)


def use(built):
    """Route cuda_step's launches to `built` (its caches cleared)."""
    from circuitsimulator_tpu_torch.ops import _build, cuda_step
    _build._LOADED["fused_step"] = built
    cuda_step._fn.cache_clear()
    cuda_step.attrs.cache_clear()
    cuda_step.plan.cache_clear()


def decks(cs):
    from circuitsimulator_tpu_torch import DEFAULT_OPTIONS
    fast, damp = cs.fast_f32_options(), cs.damped_f32_options()
    ex, nl = cs.EXAMPLES, cs.NETLISTS
    return (
        ("dbmixer f32 fast", dict(opts=fast, B=8192, seed=42)),
        ("dbmixer f64 damped", dict(opts=DEFAULT_OPTIONS, B=1024, seed=43)),
        ("bjt_amp f32 damped", dict(
            opts=damp, B=8192, seed=45, deck=os.path.join(ex, "bjt_amp.sp"),
            sigmas=cs.JUNCTION_SIGMAS, dc64=True)),
        ("behavioral f32 damped", dict(
            opts=damp, B=8192, seed=53,
            deck=os.path.join(ex, "behavioral.sp"), sigmas=cs.B_SIGMAS,
            dc64=True)),
        ("charge stage f32 damped", dict(
            opts=damp.replace(mos_cap_model="charge"), B=8192, seed=50,
            deck=cs.CHARGE_DECK, dt=1e-9, dc64=True)),
        ("inamp f32 fast", dict(
            opts=fast, B=8192, seed=48, deck=os.path.join(nl, "inamp.sp"),
            dc64=True, warm=True)),
    )


def main():
    import torch
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from circuitsimulator_tpu_torch.ops import _build, cuda_step
    plain = _build.load("fused_step")
    clocked = build_clocked()
    steps = 250
    for name, kw in decks(cs):
        kw = dict(kw)
        opts, B, seed = kw.pop("opts"), kw.pop("B"), kw.pop("seed")
        use(plain)
        _, carry, runner, *_ = cs._fused_run(opts, B, steps, steps, seed,
                                             **kw)
        use(clocked)
        lib = clocked.lib
        lib.k1_clk_zero()
        out = runner.run_chunk(*carry, steps, steps)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        lib.k1_clk_read(buf)
        total = sum(buf[:len(PHASES)])
        use(plain)
        by_plan = {}
        for team in cuda_step.TEAMS:
            for route in cuda_step.ROUTES:
                try:
                    cuda_step.runner_plan(runner, route, team=team)
                except ValueError:
                    continue
                by_plan[f"team {team} {route}"] = cs.cuda_ms(
                    lambda: cuda_step.run_chunk_cuda(
                        runner, *carry, steps, steps, route=route,
                        team=team), reps=3, warmup=1)
        print(json.dumps({
            "deck": name, "B": B, "steps": steps, "N": runner.N,
            "k": runner.k, "plan": cs.k1_plan_row(runner),
            "newton_iters_per_step": float(out[5].float().mean()) / steps,
            "clocked_cycles_per_lane_step":
                total / (-(-B // SAMPLE)) / steps,
            "phase_share": {p: buf[i] / total for i, p in enumerate(PHASES)},
            "kernel_ms_by_plan": by_plan}), flush=True)
    print(cs.card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
