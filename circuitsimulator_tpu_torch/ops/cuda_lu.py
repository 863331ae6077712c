"""Wrapper of the K2 CUDA kernel (``csrc/lu_batched.cu``): batched pivoted
LU solves on the GPU.

The kernel replaces the TPU kernel ``circuitsimulator_tpu/ops/pallas_lu.py:
_lu_kernel``; its plain PyTorch version is ``ops/lu.lu_solve_plain``.  The
wrapper lays the batch out lane-minor ((N, N, B) and (N, R, B) scratch
copies) with torch ops, launches on the current stream and never falls back
to the plain version.  ``LAUNCHES`` counts successful launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_N = 64
LAUNCHES = 0


def _fn(dtype):
    built = _build.load("lu_batched")
    fn = getattr(built.lib, "csim_lu_solve_f32" if dtype == torch.float32
                 else "csim_lu_solve_f64")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_double, ctypes.c_void_p]
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
    if Bn == 0 or R == 0:
        return torch.empty_like(b)
    fn = _fn(A.dtype)
    # the kernel overwrites its inputs: always fresh lane-minor copies
    # (.contiguous() would alias A itself when B == 1)
    At = A.permute(1, 2, 0).clone(memory_format=torch.contiguous_format)
    bt = b.permute(1, 2, 0).clone(memory_format=torch.contiguous_format)
    xt = torch.empty((N, R, Bn), dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(At.data_ptr(), bt.data_ptr(), xt.data_ptr(), Bn, N, R,
                float(pivot_floor), stream)
    if rc != 0:
        raise RuntimeError(f"lu_batched kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return xt.permute(2, 0, 1)
