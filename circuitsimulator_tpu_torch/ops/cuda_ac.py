"""Wrapper of the K3 CUDA kernel (``csrc/ac_sweep.cu``): the fused batched
AC frequency sweep on the GPU.

The kernel replaces the TPU kernel ``circuitsimulator_tpu/ops/pallas_ac.py:
_ac_kernel``; its plain PyTorch version is ``ops/ac_sweep.ac_sweep_plain``.
The kernel reads G, B1 (B, N, N) and br, bi (B, N) as they are and writes
xr, xi (B, F, N); the wrapper only checks and allocates, launches on the
current stream and never falls back to the plain version.  ``LAUNCHES``
counts successful launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_N = 64
LAUNCHES = 0


def _fn(dtype):
    built = _build.load("ac_sweep")
    fn = getattr(built.lib, "csim_ac_sweep_f32" if dtype == torch.float32
                 else "csim_ac_sweep_f64")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_double, ctypes.c_void_p]
    return fn


def ac_sweep_cuda(G: torch.Tensor, B1: torch.Tensor, br: torch.Tensor,
                  bi: torch.Tensor, omegas: torch.Tensor,
                  pivot_floor: float = 1e-15):
    """G, B1 (B, N, N), br, bi (B, N), omegas (F,): contiguous CUDA tensors
    of one type (f32 or f64) -> (xr, xi) each (B, F, N)."""
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
    fn = _fn(G.dtype)
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(*(a.data_ptr() for a in arrays), xr.data_ptr(),
                xi.data_ptr(), Bn, F, N, float(pivot_floor), stream)
    if rc != 0:
        raise RuntimeError(f"ac_sweep kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return xr, xi
