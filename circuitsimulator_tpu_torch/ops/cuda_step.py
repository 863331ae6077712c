"""Wrapper of the K1 CUDA kernel (``csrc/fused_step.cu``): the fused
Monte-Carlo transient chunk on the GPU.

The kernel replaces the TPU kernel ``circuitsimulator_tpu/ops/pallas_step.py:
PallasStepRunner._kernel`` (scopes K1a, K1b, K1c-i, K1c-ii, K1c-iii, K1d-i,
K1d-ii and K1e); its plain PyTorch version is
``ops/fused_step.FusedStepRunner.run_chunk_plain``.  A team of 4, 8, 16 or
32 threads owns each lane for the whole launch (``plan``): it stages the lane's
Y and Yc3, and on the shared route G0^-1, into shared memory once, or on
the registers route holds row n of G0^-1 in thread n's registers.  The
runner holds the constants lane-major ((B, N, N), (B, N, k), (B, k, W, k));
the wrapper passes the carry lane-major in fresh copies (the kernel updates
them in place), launches on the current stream and never falls back to the
plain version.  The library holds nine instantiations: float32 and float64
on the shared route and float32 on the registers route, each for the
K1a/K1b rows, with the charge rows and with the B-source rows; the k x k
solve (elimination for k <= 16, Gauss-Jordan above) is picked at run time.
A runner with a probe matrix (K1c-i) passes it and an (n_steps, P, B)
output block; without one both pointers are null.  A T-line deck (K1c-ii)
passes its delay ring as a fresh lane-minor (Dmax, 2 nT, B) copy that the
kernel updates in place around a head index; one ``torch.roll`` by n_steps
mod Dmax slots brings it back to the Engine's layout (slot 0 the newest
wave) at chunk exit.  A noisy runner (K1c-iii) passes its noise block
(n_steps, nN, B), lane-minor as ``Engine.trnoise_stream`` lays it out for
the chunk, and per source the row of the block that it adds (-1: none).
A deck with mutual inductance (K1e) passes the coupled inductors of each K
element (2, nK) and gm = M / dt lane-minor (nK, B); the kernel adds their
2 nK history terms to b0.  ``LAUNCHES`` counts successful launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build

MAX_N = 64        # csrc/fused_step.cu MAXN
MAX_K = 32        # csrc/fused_step.cu MAXK
UNROLL_K_MAX = 16 # csrc/fused_step.cu UNROLL_K: elimination up to here
MAX_W = 8         # row width of the B rows (the others 3 or 4)
MAX_STACK = 16    # csrc/fused_step.cu BSTACK: a B expression's stack
MAX_PROBES = 64   # csrc/fused_step.cu MAXPROBES: rows of the probe matrix
MAX_TL = 8        # csrc/fused_step.cu MAXTL: transmission lines
MAX_RING = 1024   # csrc/fused_step.cu MAXRING: Dmax x 2 nT ring waves
GREG_CAP = 32     # csrc/fused_step.cu GREG_CAP: the registers route's row
MAX_ROWS = 4      # csrc/fused_step.cu MAXROWS: rows of x a thread owns
LAUNCHES = 0

TEAMS = (4, 8, 16, 32)          # threads per lane
ROW_TARGET = 3                  # rows of x a thread owns by default
MAX_BLOCK_THREADS = 256         # the kernel's __launch_bounds__
SMEM_PER_BLOCK = 232448         # 227 KB: the H100's dynamic shared memory per block
SMEM_PER_SM = 233472            # 228 KB per SM, of which each block reserves 1 KB
BLOCK_RESERVE = 1024
REGS_PER_SM = 65536
MAX_THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
# a team's shared memory, in this order (csrc/fused_step.cu enum Lay): G0^-1
# (shared route), Y, Yc3, the augmented k x (k + 1) solve, the iterate x
# (N + 1, ground last), b0 then z (N + 1), the damped step d, c, the V^T
# coefficients (W, k), w, the step's terms (sources, inductors, capacitors,
# EMFs), vc, il, each 16-byte aligned; then the row strides of G0^-1, Y,
# Yc3 (odd: a word a thread is conflict-free) and the solve (an odd number
# of 16-byte units: 16 bytes a thread is)
LAYOUT = ("G", "Y", "Yc", "A", "x", "z", "d", "c", "v", "w", "tv", "vc", "il")
ROUTES = ("shared", "registers")


@dataclasses.dataclass(frozen=True)
class Plan:
    team: int         # threads per lane: 4, 8, 16 or 32
    rows: int         # rows of x per thread: 1 to MAX_ROWS
    lanes_per_block: int
    route: str        # "registers": G0^-1 rows in registers; "shared"
    team_words: int   # words of the dtype per team, a multiple of 16 bytes
    itemsize: int
    layout: tuple     # the region offsets (LAYOUT order), then 4 strides

    @property
    def threads(self) -> int:
        return self.lanes_per_block * self.team

    @property
    def team_bytes(self) -> int:
        return self.team_words * self.itemsize

    @property
    def smem(self) -> int:
        """Dynamic shared memory per block, bytes."""
        return self.lanes_per_block * self.team_bytes

    def blocks(self, B: int) -> int:
        return -(-B // self.lanes_per_block)


def _odd(n: int) -> int:
    return n | 1


def _vec_stride(n: int, align: int) -> int:
    """A row stride of at least n words, an odd number of 16-byte units
    (`align` words each): 16-byte row accesses are conflict-free across
    the team.  Only the solve's short rows take it: G0^-1 and Y rows keep
    an odd word stride, which keeps more lanes resident."""
    units = -(-n // align)
    return (units | 1) * align


def default_team(N: int, k: int) -> int:
    """The smallest team that holds the k rows of the solve (one a
    thread) and N rows of x at most ROW_TARGET a thread.  Measured on the
    card (PERF.md): a fourth row a thread lengthens the serial row
    loops more than the steps the team shares save, and on junction and B
    decks of k <= 4 a team of 4 beats one of 8 (more lanes a warp run the
    device code side by side)."""
    return next(s for s in TEAMS if s >= max(k, -(-N // ROW_TARGET)))


def default_route(N: int, itemsize: int, team: int) -> str:
    """G0^-1 rows in registers where each thread owns one row and a row
    fits the 32 registers of the float32 instantiation; shared memory
    otherwise (float64, or several rows a thread)."""
    return ("registers" if itemsize == 4 and N <= min(team, GREG_CAP)
            else "shared")


@functools.lru_cache(maxsize=None)
def plan(N: int, k: int, W: int, n_terms: int, nCap: int, nL: int,
         itemsize: int, route: str | None = None, regs: int = 128,
         team: int | None = None) -> Plan:
    """The launch of K1 for a lane of N unknowns, Woodbury rank k at row
    width W, n_terms b0 terms a step (sources, inductors, capacitors, 2 nT
    EMFs, 2 nK mutual terms), nCap capacitors and nL inductors, in a dtype of `itemsize`
    bytes, at `regs` registers a thread: the team (``default_team`` unless
    given) and the rows of x each thread owns, the route
    (``default_route`` unless given), the team's shared memory and the
    lanes per block that keep the most lanes resident on one SM (the
    fewest lanes per block among equals: small batches spread over more
    SMs)."""
    if not (0 < N <= MAX_N and 0 <= k <= MAX_K):
        raise ValueError(f"fused_step: N={N}, k={k} outside 1..{MAX_N}, "
                         f"0..{MAX_K}")
    if not 3 <= W <= MAX_W:
        raise ValueError(f"fused_step: row width W={W} outside 3..{MAX_W}")
    team = team or default_team(N, k)
    rows = -(-N // team)
    if team not in TEAMS or team < k or rows > MAX_ROWS:
        raise ValueError(f"fused_step: a team of {team} cannot hold k={k} "
                         f"rows of the solve and N={N} rows of x "
                         f"({MAX_ROWS} a thread)")
    route = route or default_route(N, itemsize, team)
    if route not in ROUTES:
        raise ValueError(f"fused_step: route {route!r} not in {ROUTES}")
    if route == "registers" and (itemsize != 4 or rows != 1
                                 or N > GREG_CAP):
        raise ValueError(f"fused_step: the registers route takes float32 "
                         f"and one row of N <= {GREG_CAP} a thread (N={N}, "
                         f"team {team}, {itemsize}-byte words)")
    align = 16 // itemsize
    sG, sY, sYc = _odd(N), _odd(k), _odd(W * k)
    sA = _vec_stride(k + 1, align)
    sizes = (N * sG if route == "shared" else 0, N * sY if k else 0,
             k * sYc, k * sA, N + 1, N + 1, N, k, W * k, k, n_terms, nCap,
             nL)
    offs, words = [], 0
    for size in sizes:            # each region 16-byte aligned
        words = -(-words // align) * align
        offs.append(words)
        words += size
    team_words = max(align, -(-words // align) * align)
    team_bytes = team_words * itemsize

    def resident(lpb):
        threads = lpb * team
        blocks = min(SMEM_PER_SM // (lpb * team_bytes + BLOCK_RESERVE),
                     MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // threads,
                     REGS_PER_SM // (threads * regs))
        return blocks * lpb

    step = 32 // team                   # blocks of whole warps
    fits = [s for s in range(step, MAX_BLOCK_THREADS // team + 1, step)
            if s * team_bytes <= SMEM_PER_BLOCK]
    if not fits:
        raise ValueError(f"fused_step: a team needs {team_bytes} bytes of "
                         f"shared memory")
    lpb = max(fits, key=lambda s: (resident(s), -s))
    return Plan(team=team, rows=rows, lanes_per_block=lpb, route=route,
                team_words=team_words, itemsize=itemsize,
                layout=tuple(offs) + (sG, sY, sYc, sA))


def runner_plan(runner, route: str | None = None, regs: int | None = None,
                team: int | None = None) -> Plan:
    """``plan`` for one runner's shapes; regs None asks the built library
    for the instantiation's registers (on the card only)."""
    itemsize = torch.empty((), dtype=runner.dtype).element_size()
    team = team or default_team(runner.N, runner.k)
    route = route or default_route(runner.N, itemsize, team)
    if regs is None:
        mode = 2 if runner.nB else (1 if runner.nMq else 0)
        regs = attrs(runner.dtype, route, mode)[0]
    return plan(runner.N, runner.k, runner.W, runner.n_terms, runner.nCap,
                runner.nL, itemsize, route, regs, team)


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    built = _build.load("fused_step")
    fn = getattr(built.lib, "csim_fused_step_f32" if dtype == torch.float32
                 else "csim_fused_step_f64")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def attrs(dtype, route: str, mode: int) -> tuple:
    """(registers, local bytes) per thread of the instantiation a launch of
    this dtype, route and mode (0 K1a/K1b, 1 charge rows, 2 B rows) takes,
    from the built library."""
    fn = _build.load("fused_step").lib.csim_fused_step_attrs
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    regs, local = ctypes.c_int(), ctypes.c_int()
    rc = fn(int(dtype == torch.float64), int(route == "registers"), mode,
            ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"fused_step: cudaFuncGetAttributes failed: {rc}")
    return regs.value, local.value


def run_chunk_cuda(runner, x, x_prev, vc, il, failed, step0: int,
                   n_steps: int, tlw=None, noise=None,
                   route: str | None = None, team: int | None = None):
    """One launch: advance every lane of ``runner`` n_steps from the carry
    (x, x_prev (B, N), vc (B, nCap), il (B, nL), failed (B,) bool, and for
    a T-line deck the ring tlw (B, Dmax, 2 nT); for a noisy runner the
    noise block (n_steps, nN, B)), all on the runner's CUDA device in its
    dtype; ``route`` and ``team`` override the plan's.  Returns (x, x_prev, vc, il,
    failed, iters) lane-major; iters (B,) int32; with the runner's probe
    matrix also ys (n_steps, P, B), the probe values of each step; last,
    for a T-line deck, the advanced ring (B, Dmax, 2 nT)."""
    global LAUNCHES
    dev, dtype = runner.G0inv.device, runner.dtype   # cuda:<index>
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
    if n_steps < 0:
        raise ValueError(f"run_chunk_cuda: n_steps={n_steps}")
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
    p = runner_plan(runner, route, team=team)
    fn = _fn(dtype)
    xt = x.clone(memory_format=torch.contiguous_format)
    xpt = x_prev.clone(memory_format=torch.contiguous_format)
    vct = vc.clone(memory_format=torch.contiguous_format)
    ilt = il.clone(memory_format=torch.contiguous_format)
    ft = failed.to(torch.int32).clone()
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    arrays = [runner.G0inv, runner.Y, runner.Yc3, runner.mosp,
              runner.diop, runner.bjtp, runner.swp,
              *runner.src, runner.gc, runner.gl,
              runner.kinds, runner.ind_k, runner.cap_a, runner.cap_b,
              runner.row_cols, runner.rhs_ptr, runner.rhs_idx,
              xt, xpt, vct, ilt, ft, iters, runner.mqp,
              runner.b_ops, runner.b_lits, runner.b_meta, runner.bconsts]
    ys = None
    if pm is not None:
        ys = torch.empty((n_steps, pm.shape[0], B), dtype=dtype, device=dev)
    # the ring lane-minor (Dmax, 2 nT, B), a fresh copy the kernel updates
    ring = (tlw.permute(1, 2, 0).clone(memory_format=torch.contiguous_format)
            if nT else None)
    tl = [runner.tl_read, runner.tl_plan, runner.tl_z0]
    mut = [runner.mut_plan, runner.gm] if runner.nK else []
    for a in arrays + tl + mut + [t for t in (pm, ys, ring, noise)
                                  if t is not None]:
        if not a.is_contiguous() or a.device != dev:
            raise ValueError("run_chunk_cuda: runner constants must be "
                             "contiguous on the runner's device")
    nN = runner.nN
    ptrs = ([a.data_ptr() for a in arrays]
            + [None if a is None else a.data_ptr() for a in (pm, ys)]
            + [a.data_ptr() for a in tl]
            + [None if ring is None else ring.data_ptr()]
            + ([runner.noise_col.data_ptr(), noise.data_ptr()] if nN
               else [None, None])
            + ([runner.mut_plan.data_ptr(), runner.gm.data_ptr()]
               if runner.nK else [None, None]))
    ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    ints = [B, N, k, runner.nS, runner.P, runner.nL, runner.nCap,
            runner.unrolled, runner.max_nr, int(runner.predictor), n_steps,
            int(step0), int(p.route == "registers"), runner.nMJ, runner.nD,
            runner.nQ, runner.nSw, runner.W, runner.nMq, nB,
            0 if pm is None else pm.shape[0], nT, Dmax, nN,
            p.team, p.rows, p.lanes_per_block, p.team_words, *p.layout,
            runner.nK]
    ints = (ctypes.c_longlong * len(ints))(*ints)
    reals = (ctypes.c_double * 6)(runner.dt, runner.tol2, runner.alpha,
                                  runner.clamp, runner.off_gds,
                                  runner.inv_dt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptrs, ints, reals, stream)
    if rc != 0:
        raise RuntimeError(f"fused_step kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    out = (xt, xpt, vct, ilt, ft.bool(), iters)
    if ys is not None:
        out += (ys,)
    if nT:      # physical slot p holds the wave of Engine slot p + n_steps
        out += (torch.roll(ring, n_steps % Dmax, 0).permute(2, 0, 1),)
    return out
