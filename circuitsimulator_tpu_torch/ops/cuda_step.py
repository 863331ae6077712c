"""Wrapper of the K1 CUDA kernel (``csrc/fused_step.cu``): the fused
Monte-Carlo transient chunk on the GPU.

The kernel replaces the TPU kernel ``circuitsimulator_tpu/ops/pallas_step.py:
PallasStepRunner._kernel`` (scopes K1a, K1b, K1c-i, K1c-ii, K1c-iii, K1d-i
and K1d-ii); its plain
PyTorch version is ``ops/fused_step.FusedStepRunner.run_chunk_plain``.  The
runner holds the lane-minor constants; the wrapper lays the carry out
lane-minor in fresh copies (the kernel updates them in place), launches on
the current stream and never falls back to the plain version.  The library
holds five instantiations per type: rank capacity 16 (pivoted elimination)
or 32 (Gauss-Jordan, 16 < k), each with or without the charge rows, and
rank capacity 16 with the B-source rows (row width capacity 8, the others
4); the C entry point picks one from k, the charge-row count and the
B-source count.  A runner with a probe matrix (K1c-i) passes it and an
(n_steps, P, B) output block; without one both pointers are null and the
kernel writes no probe stream.  A T-line deck (K1c-ii) passes its delay
ring as a fresh lane-minor (Dmax, 2 nT, B) copy that the kernel updates in
place around a head index; one ``torch.roll`` by n_steps mod Dmax slots
brings it back to the Engine's layout (slot 0 the newest wave) at chunk
exit.  A noisy runner (K1c-iii) passes its noise block (n_steps, nN, B),
lane-minor as ``Engine.trnoise_stream`` lays it out for the chunk, and per
source the row of the block that it adds (-1: none); without noise both
pointers are null.  ``LAUNCHES`` counts successful launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_N = 64        # csrc/fused_step.cu MAXN
MAX_K = 32        # csrc/fused_step.cu: the Gauss-Jordan instantiation
UNROLL_K_MAX = 16 # csrc/fused_step.cu: the elimination instantiation
MAX_W = 8         # csrc/fused_step.cu: row width of the B instantiation
MAX_STACK = 16    # csrc/fused_step.cu BSTACK: a B expression's stack
MAX_PROBES = 64   # csrc/fused_step.cu MAXPROBES: rows of the probe matrix
MAX_TL = 8        # csrc/fused_step.cu MAXTL: transmission lines
MAX_RING = 1024   # csrc/fused_step.cu MAXRING: Dmax x 2 nT ring waves
THREADS = 128     # lanes per block
LAUNCHES = 0


def _fn(dtype):
    built = _build.load("fused_step")
    fn = getattr(built.lib, "csim_fused_step_f32" if dtype == torch.float32
                 else "csim_fused_step_f64")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def _lane_minor(a: torch.Tensor) -> torch.Tensor:
    """(B, n) -> a fresh contiguous (n, B) copy (never an alias)."""
    return a.t().clone(memory_format=torch.contiguous_format)


def run_chunk_cuda(runner, x, x_prev, vc, il, failed, step0: int,
                   n_steps: int, threads: int = THREADS, tlw=None,
                   noise=None):
    """One launch: advance every lane of ``runner`` n_steps from the carry
    (x, x_prev (B, N), vc (B, nCap), il (B, nL), failed (B,) bool, and for
    a T-line deck the ring tlw (B, Dmax, 2 nT); for a noisy runner the
    noise block (n_steps, nN, B)), all on the runner's CUDA device in its
    dtype.  Returns (x, x_prev, vc, il, failed, iters)
    lane-major; iters (B,) int32; with the runner's probe matrix also ys
    (n_steps, P, B), the probe values of each step; last, for a T-line
    deck, the advanced ring (B, Dmax, 2 nT)."""
    global LAUNCHES
    dev, dtype = runner.G0invT.device, runner.dtype   # cuda:<index>
    B, N, k = runner.B, runner.N, runner.k
    if dev.type != "cuda":
        raise ValueError(f"run_chunk_cuda: the runner lives on {dev}, not CUDA")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"run_chunk_cuda: f32 or f64 required (got {dtype})")
    want = {"x": (x, (B, N)), "x_prev": (x_prev, (B, N)),
            "vc": (vc, (B, runner.nCap)), "il": (il, (B, runner.nL))}
    for name, (a, shape) in want.items():
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(f"run_chunk_cuda: {name} is {tuple(a.shape)} "
                             f"{a.dtype} on {a.device}, want {shape} {dtype} "
                             f"on {dev}")
    if failed.device != dev or tuple(failed.shape) != (B,):
        raise ValueError(f"run_chunk_cuda: failed must be ({B},) on {dev}")
    if not (0 < N <= MAX_N and 0 <= k <= MAX_K):
        raise ValueError(f"run_chunk_cuda: N={N}, k={k} outside "
                         f"1..{MAX_N}, 0..{MAX_K}")
    nB = runner.nB
    if nB and (k > UNROLL_K_MAX or runner.nMq or runner.W > MAX_W
               or runner.b_meta.shape != (nB, 6)):
        raise ValueError(f"run_chunk_cuda: {nB} B sources need k <= "
                         f"{UNROLL_K_MAX}, no charge rows and W <= {MAX_W} "
                         f"(k={k}, charge MOS {runner.nMq}, W={runner.W})")
    if nB and max(bs.tape.depth for bs in runner.b_sources) > MAX_STACK:
        raise ValueError(f"run_chunk_cuda: a B expression needs a stack "
                         f"deeper than {MAX_STACK}")
    if n_steps < 0 or not 0 < threads <= THREADS:
        raise ValueError(f"run_chunk_cuda: n_steps={n_steps}, "
                         f"threads={threads}")
    pm = runner.probe_mat
    if pm is not None and (pm.device != dev or pm.dtype != dtype
                           or pm.ndim != 2 or pm.shape[1] != N
                           or not 0 < pm.shape[0] <= MAX_PROBES):
        raise ValueError(f"run_chunk_cuda: probe_mat is {tuple(pm.shape)} "
                         f"{pm.dtype} on {pm.device}, want (P <= "
                         f"{MAX_PROBES}, {N}) {dtype} on {dev}")
    runner.check_ring(tlw)
    runner.check_noise(noise, n_steps)
    nT, Dmax = runner.nT, runner.Dmax
    if nT and not (nT <= MAX_TL and Dmax * 2 * nT <= MAX_RING):
        raise ValueError(f"run_chunk_cuda: {nT} lines x a ring of {Dmax} "
                         f"steps outside {MAX_TL} lines, {MAX_RING} waves")
    fn = _fn(dtype)
    xt, xpt = _lane_minor(x), _lane_minor(x_prev)
    vct, ilt = _lane_minor(vc), _lane_minor(il)
    ft = failed.to(torch.int32).clone()
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    arrays = [runner.G0invT, runner.YT, runner.Yc3, runner.mosp,
              runner.diop, runner.bjtp, runner.swp,
              *runner.src, runner.gc, runner.gl,
              runner.kinds, runner.src_pos, runner.src_neg, runner.ind_k,
              runner.cap_a, runner.cap_b, runner.row_cols,
              xt, xpt, vct, ilt, ft, iters, runner.mqp,
              runner.b_ops, runner.b_lits, runner.b_meta, runner.bconsts]
    ys = None
    if pm is not None:
        ys = torch.empty((n_steps, pm.shape[0], B), dtype=dtype, device=dev)
    # the ring lane-minor (Dmax, 2 nT, B), a fresh copy the kernel updates
    ring = (tlw.permute(1, 2, 0).clone(memory_format=torch.contiguous_format)
            if nT else None)
    tl = [runner.tl_read, runner.tl_plan, runner.tl_z0]
    for a in arrays + tl + [t for t in (pm, ys, ring, noise) if t is not None]:
        if not a.is_contiguous() or a.device != dev:
            raise ValueError("run_chunk_cuda: runner constants must be "
                             "contiguous on the runner's device")
    nN = runner.nN
    ptrs = ([a.data_ptr() for a in arrays]
            + [None if a is None else a.data_ptr() for a in (pm, ys)]
            + [a.data_ptr() for a in tl]
            + [None if ring is None else ring.data_ptr()]
            + ([runner.noise_col.data_ptr(), noise.data_ptr()] if nN
               else [None, None]))
    ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    ints = (ctypes.c_longlong * 24)(
        B, N, k, runner.nS, runner.P, runner.nL, runner.nCap,
        runner.unrolled, runner.max_nr, int(runner.predictor), n_steps,
        int(step0), threads, runner.nMJ, runner.nD, runner.nQ, runner.nSw,
        runner.W, runner.nMq, nB, 0 if pm is None else pm.shape[0], nT,
        Dmax, nN)
    reals = (ctypes.c_double * 6)(runner.dt, runner.tol2, runner.alpha,
                                  runner.clamp, runner.off_gds,
                                  runner.inv_dt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptrs, ints, reals, stream)
    if rc != 0:
        raise RuntimeError(f"fused_step kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    out = (xt.t(), xpt.t(), vct.t(), ilt.t(), ft.bool(), iters)
    if ys is not None:
        out += (ys,)
    if nT:      # physical slot p holds the wave of Engine slot p + n_steps
        out += (torch.roll(ring, n_steps % Dmax, 0).permute(2, 0, 1),)
    return out
