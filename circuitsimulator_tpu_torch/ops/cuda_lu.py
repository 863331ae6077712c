"""Wrapper of the K2 CUDA kernel (``csrc/lu_batched.cu``): batched pivoted
LU solves on the GPU.

The kernel replaces the TPU kernel ``circuitsimulator_tpu/ops/pallas_lu.py:
_lu_kernel``; its plain PyTorch version is ``ops/lu.lu_solve_plain``.  A team
of threads solves each system (``plan``); the kernel reads A (B, N, N) and
b (B, N, R) where they lie, writes neither, and writes x (B, N, R).  The
wrapper launches on the current stream and never falls back to the plain
version.  ``LAUNCHES`` counts successful launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build

MAX_N = 64
LAUNCHES = 0

CAPACITIES = (8, 16, 32, 64)   # template capacities = team sizes
SMEM_PER_BLOCK = 232448         # 227 KB: the H100's dynamic shared memory per block
SMEM_PER_SM = 233472            # 228 KB per SM, of which each block reserves 1 KB
BLOCK_RESERVE = 1024
MAX_BLOCK_THREADS = 256         # the kernel's __launch_bounds__ below CAP = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    cap: int          # template capacity: the smallest of CAPACITIES >= N
    spb: int          # systems per block
    rt: int           # right-hand-side columns staged per tile
    team_bytes: int   # shared memory per system, a multiple of 16

    @property
    def team(self) -> int:
        """Threads per system: the capacity."""
        return self.cap

    @property
    def threads(self) -> int:
        return self.spb * self.team

    @property
    def smem(self) -> int:
        return self.spb * self.team_bytes


@functools.lru_cache(maxsize=None)
def plan(N: int, R: int, itemsize: int) -> Plan:
    """The launch of an N x N solve with R right-hand sides of `itemsize`
    bytes: the team, the RHS tile (at most 2 x cap columns) and the shared
    memory layout of ``team_bytes_needed`` in ``csrc/lu_batched.cu``; the
    systems per block maximise the systems resident on one SM."""
    if not 0 < N <= MAX_N:
        raise ValueError(f"lu_solve_cuda: N={N} outside 1..{MAX_N}")
    if R < 1:
        raise ValueError(f"lu_solve_cuda: R={R} < 1")
    cap = next(c for c in CAPACITIES if N <= c)
    rt = min(R, 2 * cap)
    words = N * (cap + 1) + N * rt + (4 if cap == 64 else 0)
    ints = cap + (4 if cap == 64 else 0)
    team_bytes = -(-(itemsize * words + 4 * ints) // 16) * 16
    max_spb = 1 if cap == 64 else MAX_BLOCK_THREADS // cap

    def resident(spb):
        blocks = min(SMEM_PER_SM // (spb * team_bytes + BLOCK_RESERVE), 32,
                     2048 // (spb * cap))
        return blocks * spb

    # blocks of whole warps: teams of 8 or 16 come four or two to a warp
    step = max(1, 32 // cap)
    fits = [s for s in range(step, max_spb + 1, step)
            if s * team_bytes <= SMEM_PER_BLOCK]
    if not fits:
        raise ValueError(f"lu_solve_cuda: N={N}, {rt} columns need "
                         f"{team_bytes} bytes of shared memory per system")
    spb = max(fits, key=lambda s: (resident(s), s))
    return Plan(cap=cap, spb=spb, rt=rt, team_bytes=team_bytes)


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    built = _build.load("lu_batched")
    fn = getattr(built.lib, "csim_lu_solve_f32" if dtype == torch.float32
                 else "csim_lu_solve_f64")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   *[ctypes.c_int] * 7, ctypes.c_double, ctypes.c_void_p]
    return fn


def lu_solve_cuda(A: torch.Tensor, b: torch.Tensor,
                  pivot_floor: float = 1e-15) -> torch.Tensor:
    """A (B, N, N), b (B, N, R), both contiguous CUDA f32/f64 -> x (B, N, R)."""
    global LAUNCHES
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"lu_solve_cuda: tensors must share one CUDA device "
                         f"(got {A.device}, {b.device})")
    if A.dtype not in (torch.float32, torch.float64) or b.dtype != A.dtype:
        raise TypeError(f"lu_solve_cuda: f32 or f64 required "
                        f"(got {A.dtype}, {b.dtype})")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or b.dim() != 3 \
            or b.shape[:2] != A.shape[:2]:
        raise ValueError(f"lu_solve_cuda: shapes {tuple(A.shape)} x "
                         f"{tuple(b.shape)} are not (B,N,N) x (B,N,R)")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("lu_solve_cuda: inputs must be contiguous")
    Bn, N, R = b.shape
    if not 0 < N <= MAX_N:
        raise ValueError(f"lu_solve_cuda: N={N} outside 1..{MAX_N}")
    x = torch.empty((Bn, N, R), dtype=A.dtype, device=A.device)
    if Bn == 0 or R == 0:
        return x
    p = plan(N, R, A.element_size())
    fn = _fn(A.dtype)

    def launch():
        return fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), Bn, N, R, p.cap,
                  p.spb, p.rt, p.team_bytes, float(pivot_floor),
                  torch.cuda.current_stream().cuda_stream)
    if A.device.index == torch.cuda.current_device():
        rc = launch()
    else:
        with torch.cuda.device(A.device):
            rc = launch()
    if rc != 0:
        raise RuntimeError(f"lu_batched kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return x
