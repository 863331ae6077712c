"""Wrapper of the K3 CUDA kernel (``csrc/ac_sweep.cu``): the fused batched
AC frequency sweep on the GPU.

The kernel replaces the TPU kernel ``circuitsimulator_tpu/ops/pallas_ac.py:
_ac_kernel``; its plain PyTorch version is ``ops/ac_sweep.ac_sweep_plain``.
A team of threads solves each (lane, frequency) system with its rows in
registers (``plan``); a block stages one lane's G and B1 once for the
frequencies its teams take (``launch_shape``).  The kernel reads G, B1
(B, N, N) and br, bi (B, N) as they are and writes xr, xi (B, F, N); the
wrapper only checks and allocates, launches on the current stream and
never falls back to the plain version.  ``LAUNCHES`` counts successful
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build

MAX_N = 64
LAUNCHES = 0

CAPACITIES = (8, 16, 32, 64)   # team kernels hold N <= 8, 16, 32; 64 is wide
ROWS = {8: 2, 16: 2, 32: 1, 64: 1}  # rows a thread (csrc/ac_sweep.cu rows_at)
SMEM_PER_BLOCK = 232448         # 227 KB: the H100's dynamic shared memory per block
SMEM_PER_SM = 233472            # 228 KB per SM, of which each block reserves 1 KB
BLOCK_RESERVE = 1024
REGS_PER_SM = 65536
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
MAX_BLOCK_THREADS = 256         # the team kernel's __launch_bounds__
SPB_SIZES = (1, 2, 4, 8, 16, 32)  # teams a block: powers of two, so that a
                                # lane's 2^k or 2^k + 1 frequencies leave
                                # few idle teams
WIDE_MAX_WARPS = 4              # the wide kernel's __launch_bounds__ / 32
WIDE_SMEM_TARGET = 96 * 1024    # the wide route's shared memory per block


def _round16(n: int) -> int:
    return -(-n // 16) * 16


@dataclasses.dataclass(frozen=True)
class Plan:
    cap: int    # 8, 16, 32: a team of cap / rows threads, its rows in
                # registers; 64: the wide route (a warp per system, its
                # rows in shared memory)
    rows: int   # rows a thread
    spb: int    # systems per block: teams, or warps on the wide route
    smem: int   # dynamic shared bytes a block: the lane's G and B1 staged
                # once (team), or each warp's matrix slice (wide)
    regs: int   # registers per thread of the kernel, from the library

    @property
    def team(self) -> int:
        """Threads per system."""
        return 32 if self.cap == 64 else self.cap // self.rows

    @property
    def threads(self) -> int:
        return self.spb * self.team

    @property
    def resident(self) -> int:
        """Systems resident on one SM under the card's limits."""
        return _blocks_per_sm(self.threads, self.smem, self.regs) * self.spb


def _blocks_per_sm(threads: int, smem: int, regs: int) -> int:
    warps = -(-threads // 32)
    warp_regs = -(-regs // 8) * 8 * 32      # allocated 256 at a time
    return min(SMEM_PER_SM // (smem + BLOCK_RESERVE), BLOCKS_PER_SM,
               THREADS_PER_SM // threads, REGS_PER_SM // (warps * warp_regs))


@functools.lru_cache(maxsize=None)
def plan(N: int, itemsize: int, team: int | None = None,
         regs: int | None = None) -> Plan:
    """The launch of the sweep's N x N complex systems of `itemsize`-byte
    reals: the team capacity (the smallest of 8, 16, 32 that holds N; 33 <=
    N <= 64 takes the wide route) and with it the rows a thread, and the
    systems per block: the largest power of two that keeps the systems
    resident on one SM within a warp of the most any block size allows.
    ``team`` forces a capacity that holds N (64: the wide route); ``regs``
    (registers a thread) None asks the built library (on the card only)."""
    if not 0 < N <= MAX_N:
        raise ValueError(f"ac_sweep_cuda: N={N} outside 1..{MAX_N}")
    if itemsize not in (4, 8):
        raise ValueError(f"ac_sweep_cuda: itemsize {itemsize} is not 4 or 8")
    cap = next(c for c in CAPACITIES if N <= c) if team is None else team
    if cap not in CAPACITIES or cap < N:
        raise ValueError(f"ac_sweep_cuda: team {team} does not hold N={N} "
                         f"(capacities {CAPACITIES})")
    if regs is None:
        regs = attrs(itemsize, cap)[0]
    if cap == 64:
        # PR 3's sizing: as many warps as fit 96 KB, at most four
        warp_bytes = itemsize * (2 * N * (N | 1) + 2 * N)
        spb = max(1, min(WIDE_MAX_WARPS, WIDE_SMEM_TARGET // warp_bytes))
        return Plan(cap=64, rows=1, spb=spb, smem=spb * warp_bytes,
                    regs=regs)
    size = Plan(cap=cap, rows=ROWS[cap], spb=1,
                smem=_round16(2 * N * (N | 1) * itemsize), regs=regs)
    step = 32 // size.team              # teams a warp: whole-warp blocks
    plans = [dataclasses.replace(size, spb=s) for s in SPB_SIZES
             if step <= s <= MAX_BLOCK_THREADS // size.team]
    # the largest block (fewest stagings of a lane a system) among those
    # within a warp's systems of the most resident: finer than the
    # register model's grain, residency did not order the card's times
    most = max(p.resident for p in plans)
    return max((p for p in plans if p.resident >= most - step),
               key=lambda p: p.spb)


def launch_shape(p: Plan, F: int) -> tuple[int, int]:
    """(teams per block, blocks per lane) of a sweep over F frequencies:
    a lane's frequencies in as few blocks of at most ``p.spb`` teams as
    hold them, the teams trimmed (in whole warps) to share them evenly.
    The wide route grid-strides over systems: (p.spb, 0)."""
    if p.cap == 64:
        return p.spb, 0
    chunks = -(-F // p.spb)
    step = 32 // p.team
    teams = -(-(-(-F // chunks)) // step) * step
    return min(p.spb, teams), chunks


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    built = _build.load("ac_sweep")
    fn = getattr(built.lib, "csim_ac_sweep_f32" if dtype == torch.float32
                 else "csim_ac_sweep_f64")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_double, ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def attrs(itemsize: int, cap: int) -> tuple:
    """(registers, local bytes) per thread of the kernel that a launch of
    ``itemsize``-byte reals at team capacity ``cap`` (64: the wide route)
    takes, from the built library."""
    fn = _build.load("ac_sweep").lib.csim_ac_sweep_attrs
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    regs, local = ctypes.c_int(), ctypes.c_int()
    rc = fn(int(itemsize == 8), cap, ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"ac_sweep: cudaFuncGetAttributes failed: {rc}")
    return regs.value, local.value


def ac_sweep_cuda(G: torch.Tensor, B1: torch.Tensor, br: torch.Tensor,
                  bi: torch.Tensor, omegas: torch.Tensor,
                  pivot_floor: float = 1e-15, team: int | None = None):
    """G, B1 (B, N, N), br, bi (B, N), omegas (F,): contiguous CUDA tensors
    of one type (f32 or f64) -> (xr, xi) each (B, F, N).  ``team`` overrides
    the plan's capacity (measurement and tests)."""
    global LAUNCHES
    arrays = (G, B1, br, bi, omegas)
    if G.device.type != "cuda" or any(a.device != G.device for a in arrays):
        raise ValueError("ac_sweep_cuda: tensors must share one CUDA device "
                         f"(got {[str(a.device) for a in arrays]})")
    if G.dtype not in (torch.float32, torch.float64) or any(
            a.dtype != G.dtype for a in arrays):
        raise TypeError(f"ac_sweep_cuda: f32 or f64 required, one type "
                        f"(got {[a.dtype for a in arrays]})")
    if G.dim() != 3 or G.shape[1] != G.shape[2] or omegas.dim() != 1:
        raise ValueError(f"ac_sweep_cuda: G {tuple(G.shape)}, omegas "
                         f"{tuple(omegas.shape)} are not (B, N, N), (F,)")
    Bn, N, _ = G.shape
    F = omegas.shape[0]
    if tuple(B1.shape) != (Bn, N, N) or tuple(br.shape) != (Bn, N) \
            or tuple(bi.shape) != (Bn, N):
        raise ValueError(f"ac_sweep_cuda: B1 {tuple(B1.shape)}, br "
                         f"{tuple(br.shape)}, bi {tuple(bi.shape)} do not "
                         f"match G {tuple(G.shape)}")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("ac_sweep_cuda: inputs must be contiguous")
    if not 0 < N <= MAX_N:
        raise ValueError(f"ac_sweep_cuda: N={N} outside 1..{MAX_N}")
    xr = torch.empty((Bn, F, N), dtype=G.dtype, device=G.device)
    xi = torch.empty_like(xr)
    if Bn == 0 or F == 0:
        return xr, xi
    p = plan(N, G.element_size(), team)
    teams, chunks = launch_shape(p, F)
    fn = _fn(G.dtype)
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(*(a.data_ptr() for a in arrays), xr.data_ptr(),
                xi.data_ptr(), Bn, F, N, p.cap, p.rows, teams, chunks,
                p.smem, float(pivot_floor), stream)
    if rc != 0:
        raise RuntimeError(f"ac_sweep kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return xr, xi
