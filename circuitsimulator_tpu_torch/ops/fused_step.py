"""Fused Monte-Carlo transient chunk (K1, scopes K1a, K1b, K1c-i, K1c-ii,
K1c-iii, K1d-i, K1d-ii and K1e): whole Backward-Euler timesteps per lane in
one launch.

Port of ``circuitsimulator_tpu/ops/pallas_step.py`` (``PallasStepRunner``)
for R/C/L, V and I sources with every waveform kind (PULSE/SIN/PWL/EXP/SFFM,
PWL with at most 8 breakpoints), the linear controlled sources E/G/F/H
(their stamps live in G0 only), Level-1 MOS without body effect or reverse
region (K1a), JFETs, diodes with reverse breakdown, Ebers-Moll BJTs with
Early voltage and the S/W switches (K1b), the charge rows of
``MOSCAP=CHARGE`` with Woodbury ranks past 16 (K1d-i), and the behavioral
B sources (K1d-ii: at most 4 probe pairs and an expression stack of at most
16, at rank k <= 16 and without charge rows) and the lossless transmission
lines (K1c-ii: at most 8 lines, a delay ring of Dmax x 2 nT <= 1024 waves,
Dmax the longest delay in steps), the TRNOISE sources (K1c-iii), with
or without their noise, and mutual inductance (K1e: the -M/dt cross terms
live in G0, their history currents in b0); rank
0 <= k = nM + nJ + nD + 2 nQ + nS + nB (+ 5 nM under the charge model)
<= 32 (k = 0 is a linear deck: each Newton iteration accepts
z0 = G0^{-1} b).

Per step and lane (what the kernel and ``run_chunk_plain`` compute):

- sources at t = (step0 + i + 1) dt in the working type (never t += dt),
  plus, on a noisy run, the step's noise value of each noisy source;
- b0 = [sources, -gl il, gc vc, E1, E2, -gm il_b, -gm il_a] scattered to
  their rows, the T-line EMFs E1_j = ring[ticks_j - 1, nT + j] (the far
  port's wave ticks_j steps ago) on row k1_j and E2_j = ring[ticks_j - 1,
  j] on row k2_j, and per K element m (K1e) with gm_m = M_m / dt the
  mutual history -(gm_m il[b_m]) on inductor a_m's branch row and
  -(gm_m il[a_m]) on b_m's; z0 = G0^{-1} b0;
- under the charge model, q_prev = q(x) of the incoming x (q is a function
  of x, so this is the non-fused state's qm; no extra carry);
- Newton from x (or 2x - x_prev with the predictor): the device
  linearisations in Woodbury row order (MOS then JFET rows from one pack,
  diode rows, two rows per BJT, switch rows, B rows, then five charge rows
  per MOS, device-major: g = (dq/dv)/dt, cst = (q(v) - q_prev)/dt - g v),
  z = z0 - Y c, S = I + V^T Y, vz = V^T z, the k x k solve S w = vz,
  x_raw = z - Y w, then the damped accept (clamp, alpha, err^2 < tol^2, a
  non-finite x_raw freezes the lane and raises ``failed``);
- vc and il from the accepted x; with T-lines the waves
  w = V(p) - V(n) + Z0 i of both ports of the accepted x pushed into slot
  0 of the ring, the other slots one step older.

The k x k solve is the JAX kernel's: for k <= 16 pivoted elimination with
back substitution (first index of max |col|, a zero pivot and a zero
diagonal replaced by 1, no pivot floor); for 16 < k <= 32 column-pivoted
Gauss-Jordan (for each column c the pivot is the first maximum of |col| over
the rows not used yet, every other row is eliminated, a zero pivot is
replaced by 1; at the end w[c(p)] = bb[p] / A[p, c(p)], a zero A[p, c(p)]
replaced by 1).  A NaN counts as the largest |col| in both.  The pivot
order differs from the non-fused loop's LU, so the Gauss-Jordan branch
agrees with it to rounding, not bitwise.

The Newton loop runs ``tran_unrolled_iters`` fixed iterations, or per lane
until done or ``tran_max_newton_iters``.  A per-lane loop gives the x of the
JAX kernel's block-wide while loop, because accept freezes lanes that are
done; it differs only in that a done lane never again raises ``failed``
(the masked semantics of the non-fused loop, analysis/transient.py).

A B row evaluates its compiled expression (``utils/expr.compile_tape``) at
the probe values vals_i = x[a_i] - x[b_i] and t: value e0 and gradient g
(``eval_tape``'s forward-mode rules, which are JAX's), the row
sig (g_0, -g_0, g_1, -g_1, ...) zero-padded to W and c = sig (e0 - g.vals),
sig = -1 for a V=expr source (its row is the branch row) and +1 for I=expr.
The kernel interprets the same opcodes (one build serves every deck); the
JAX kernel traces the expression's vjp instead.

G0^-1, Y and Yc3 are lane-major, a lane's block contiguous (the kernel's
teams stage one lane's block each): G0inv (B, N, N), Y (B, N, k), Yc3
(B, k, W, k) [lane, j, q, l] = Y[lane, col_q(j), l], with W = 4 when a
switch is present, else 3, widened to 2 max(m) by B sources of m probe
pairs; the device packs, sources and companions are lane-minor (rows, B).
The one-hot selection matmuls of the TPU kernel are index plans here
(source rows, inductor rows, cap terminal pairs, the (W, k) column plan of
the V^T rows, which is also where each row's device reads its terminal
voltages, and the kernel's b0 row plan ``rhs_ptr``/``rhs_idx``); index N
is the ground dump slot and reads 0.  Exponential-device decks must start
from the DC operating point: from x = 0 a junction at 1e5 S amplifies a
rounding difference to volts.

K1c-i, the probe stream (JAX kernel ``pallas_step.py:1242-1244``): a
runner built with ``probe_mat`` (P, N) also writes, after each step's
accept, the P values probe_mat @ x of every lane into an (n_steps, P, B)
block that ``run_chunk`` returns as a seventh output.  The rows of
``StreamingMeasures.probe_matrix`` are +1/-1 pairs, so for a finite x each
value is exactly x[a] - x[b] in any summation order, and the kernel and
the plain version agree bit for bit on the same x.

K1c-ii, the delay ring (JAX kernel ``pallas_step.py:1181-1190``,
``:1236-1241``): ``run_chunk(..., tlw=)`` takes the ring (B, Dmax, 2 nT) in
the Engine's layout (``Engine.init_state``: slot 0 the newest wave) and
returns it advanced as its last output.  The plain version shifts the ring
every step, as the Engine does; the kernel keeps it in place and moves a
head index (at step i of a chunk the slot d steps old is (d - i) mod Dmax;
each step reads its EMFs before its push, so at ticks = Dmax the oldest
wave is read before it is overwritten), and the wrapper rolls the ring
back to the Engine's layout at chunk exit.  The kernel forms each wave
without FMA contraction, (V(p) - V(n)) + Z0 i rounded twice as PyTorch
does, so for the same x the two rings agree bit for bit.

K1c-iii, the TRNOISE input block (JAX kernel ``pallas_step.py:1174-1179``,
row scatter ``:567-575``): a runner built with ``noise_idx`` (the noisy
sources' rows in the V-then-I source order) takes ``run_chunk(...,
noise=)``, an (n_steps, nN, B) block whose row c at step i is added to the
value of source ``noise_idx[c]`` at step i before it is scattered.  The
values come from ``Engine.trnoise_stream`` outside the kernel (the JAX
package's own threefry draws, ``utils/prng.py``), so a noisy fused run
follows the non-fused realisation; the flicker banks ride the caller's
carry (``parallel/montecarlo.py``).  The block is lane-minor: a step's
read of it is one coalesced word per lane.  The JAX package sizes the
chunk so the block fits in VMEM (``noise_block_ok``); here it lies in
HBM, and a chunk's block is kept under ``NOISE_BLOCK_BYTES``
(``noise_chunk``).

``FusedStepRunner.run_chunk`` launches the CUDA kernel (``ops/cuda_step``,
``csrc/fused_step.cu``) on CUDA tensors and runs ``run_chunk_plain``, the
plain PyTorch version, on CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import sources as srcmod
from ..models.bjt import bjt_linearize
from ..models.diode import diode_linearize
from ..models.moscap import charge_jacobian, charges_of_x
from ..models.mosfet import mos_linearize
from ..models.switch import switch_linearize
from ..netlist import WAVE_PWL
from ..utils.expr import eval_tape
from . import cuda_step
from .lu import lu_solve_plain
from .woodbury import WoodburySolver

MAX_N = cuda_step.MAX_N      # unknowns per lane
MAX_K = cuda_step.MAX_K      # Woodbury rank (the JAX kernel's MAX_K)
UNROLL_K_MAX = cuda_step.UNROLL_K_MAX  # elimination up to here, then GJ
MAX_PWL = 8                  # PWL breakpoints (the JAX kernel unrolls <= 8)
MAX_B_PAIRS = cuda_step.MAX_W // 2   # probe pairs per B source
MAX_STACK = cuda_step.MAX_STACK      # expression stack of a B source
MAX_PROBES = cuda_step.MAX_PROBES    # rows of the probe matrix (K1c-i)
MAX_TL = cuda_step.MAX_TL            # transmission lines (K1c-ii)
MAX_RING = cuda_step.MAX_RING        # Dmax x 2 nT waves of the delay ring
IN_SCOPE = "RCLVIMEGFHDQJSBTK"  # device classes of K1a, K1b, K1c-ii, K1d, K1e
# HBM budget of one chunk's noise block (n_steps, nN, B) (K1c-iii): 256 MiB,
# about 1/300 of the card's memory.  Drawing it takes int64 temporaries of
# about ten times its words (utils/prng.py), a few GiB at the budget.  At
# B = 8192 and nN = 1 in float32 it holds 8,192 steps, so the 2,000-step
# chunk of the fused transient is kept (a 65.5 MB block)
NOISE_BLOCK_BYTES = 1 << 28


def unsupported_reason(engine, dt=None) -> Optional[str]:
    """Why ``engine`` at timestep ``dt`` is outside the K1a + K1b + K1c-ii
    + K1d-i + K1d-ii + K1e scope, or None when it is in.

    In scope is a subset of ``circuitsimulator_tpu/ops/pallas_step.py:
    supported``: every condition refused there is refused here (T-lines
    without dt, more than 8 lines, a ring of more than 1024 waves), plus
    N > 64, and for B sources an expression stack deeper than 16, charge
    rows, or a rank above 16 (no kernel instantiation has them together).
    TRNOISE decks are in scope, noisy or not (K1c-iii): the kernel adds a
    noise block of any number of noisy sources, so nothing of it is
    refused.  Mutual inductance is in scope (K1e): its cross terms are
    part of G0 and its history currents are 2 nK more b0 terms.  The JAX
    kernel admits K too but leaves the history out of its right-hand side
    (``pallas_step.py:1180``), so on K decks K1e is held to the non-fused
    loop, not to that kernel."""
    t = engine.topo
    opts = engine.opts
    c = t.counts
    others = sorted(cls for cls, n in c.items() if n and cls not in IN_SCOPE)
    if others:
        return f"device classes {', '.join(others)}"
    nT = engine.n_tl
    if nT:
        if dt is None:
            return "transmission lines need dt (the delay ring's length)"
        if nT > MAX_TL:
            return f"{nT} transmission lines > {MAX_TL}"
        dmax = int(engine.tl_ticks(dt).max())
        if dmax * 2 * nT > MAX_RING:
            return (f"T-line delay ring of {dmax} steps x {2 * nT} waves > "
                    f"{MAX_RING}")
    for bs in engine.b_sources:
        if len(bs.pairs) > MAX_B_PAIRS:
            return (f"B source {bs.name}: {len(bs.pairs)} probe pairs > "
                    f"{MAX_B_PAIRS}")
        if bs.tape.depth > MAX_STACK:
            return (f"B source {bs.name}: expression stack depth "
                    f"{bs.tape.depth} > {MAX_STACK}")
    if engine.mos_body:
        return "MOS body effect (GAMMA)"
    if opts.mos_reverse_region:
        return "MOS reverse region (MOSSYM)"
    if opts.tran_method != "be":
        return f"METHOD={opts.tran_method.upper()} (Backward Euler only)"
    if engine.dtype not in (torch.float32, torch.float64):
        return f"dtype {engine.dtype}"
    kinds = np.concatenate([engine.vs_kinds, engine.is_kinds])
    if np.any(kinds == WAVE_PWL) and engine.pwl_width > MAX_PWL:
        return f"PWL source with {engine.pwl_width} > {MAX_PWL} breakpoints"
    if engine.N > MAX_N:
        return f"N = {engine.N} > {MAX_N} unknowns"
    nB = len(engine.b_sources)
    k = c["M"] + c["J"] + c["D"] + 2 * c["Q"] + c["S"] + nB
    if engine.mos_charge:
        k += 5 * c["M"]                         # the charge rows
    if k > MAX_K:
        return f"Woodbury rank k = {k} > {MAX_K}"
    if nB and engine.mos_charge:
        return "B sources with MOSCAP=CHARGE rows"
    if nB and k > UNROLL_K_MAX:
        return f"B sources at Woodbury rank k = {k} > {UNROLL_K_MAX}"
    return None


def supported(engine, dt=None) -> bool:
    """The K1 gate (T-line decks need ``dt``: the ring's length)."""
    return unsupported_reason(engine, dt) is None


def noise_chunk(chunk: int, n_noisy: int, B: int, dtype) -> int:
    """The chunk length of a noisy fused run: at most ``chunk`` steps, and
    its (n, n_noisy, B) noise block within ``NOISE_BLOCK_BYTES``."""
    size = torch.empty((), dtype=dtype).element_size()
    return max(1, min(chunk, NOISE_BLOCK_BYTES // (n_noisy * B * size)))


def _lm(a: torch.Tensor) -> torch.Tensor:
    """Lane axis 0 -> last axis, contiguous."""
    return a.movedim(0, -1).contiguous()


class FusedStepRunner:
    """Per-lane constants of the fused chunk for one batch of parameters;
    with ``probe_mat`` (P, N) every chunk also returns its probe stream,
    with T-lines it advances their delay ring, with ``noise_idx`` (the
    rows of the noisy sources in the V-then-I source order) every chunk
    takes a noise block."""

    def __init__(self, engine, bparams, dt: float, probe_mat=None,
                 noise_idx=None):
        reason = unsupported_reason(engine, dt)
        if reason is not None:
            raise NotImplementedError(f"fused transient chunk (K1): {reason}")
        t = engine.topo
        opts = engine.opts
        self.N = N = engine.N
        self.dtype = dtype = engine.dtype
        dev = engine.device
        self.dt = float(dt)
        self.inv_dt = 1.0 / self.dt           # the charge rows' 1/dt
        self.max_nr = int(opts.tran_max_newton_iters)
        self.tol2 = float(opts.tran_tol) ** 2
        self.alpha = float(opts.tran_alpha)
        self.clamp = float(opts.tran_newton_clamp)
        self.predictor = bool(opts.tran_predictor)
        self.unrolled = int(opts.tran_unrolled_iters)
        self.off_gds = float(opts.mos_off_gds)
        self.flags = {"dio_bv": engine.dio_bv,
                      "bjt_early": engine.bjt_early}
        self.B = B = next(iter(bparams.values())).shape[0]
        self.dt_t = dt_t = torch.tensor(self.dt, dtype=dtype, device=dev)
        self.probe_mat = None
        if probe_mat is not None:
            pm = torch.as_tensor(probe_mat, dtype=dtype, device=dev)
            if pm.ndim != 2 or pm.shape[1] != N:
                raise ValueError(f"probe_mat is {tuple(pm.shape)}, want "
                                 f"(P, {N})")
            if pm.shape[0] > MAX_PROBES:
                raise NotImplementedError(
                    f"fused transient chunk (K1): {pm.shape[0]} probes > "
                    f"{MAX_PROBES}")
            self.probe_mat = pm.contiguous()

        G = engine.tran_static_G(bparams, dt_t, opts.tran_gmin)
        wb = WoodburySolver(engine, bparams, G[..., :N, :N])
        plan = wb.plan
        self.k = k = plan.k
        self.W = W = plan.W
        self.nMJ = plan.nM + plan.nJ
        self.nD, self.nQ, self.nSw = plan.nD, plan.nQ, plan.nS
        self.nCq = plan.nCq
        self.nMq = plan.nCq // 5                # MOS with charge rows
        self.nB = plan.nB
        self.G0inv = wb.G0inv.expand(B, N, N).contiguous()      # (B, N, N)
        self.Y = wb.Y.expand(B, N, k).contiguous()              # (B, N, k)
        self.Yc3 = wb.Y_cols.expand(B, k, W, k).contiguous()    # (B, k, W, k)

        def pack(*leaves):
            """(B, n) leaves -> lane-minor (len(leaves), n, B)."""
            return torch.stack([a.expand(B, a.shape[-1]) for a in leaves],
                               0).permute(0, 2, 1).contiguous()

        def lanes(name, n):
            """A per-lane (B,) or scalar leaf as (B, n)."""
            return bparams[name].reshape(-1, 1).expand(B, n)

        def both(mos, jf, scale=1.0):
            return torch.cat([bparams[mos], scale * bparams[jf]], -1)

        # nonlinear-row parameters in Woodbury plan order.  MOS and JFET
        # rows share the Level-1 linearisation (vth = VTO, k = 2 BETA)
        self.mosp = pack(both("mos_vth", "jf_vto"),
                         both("mos_k", "jf_beta", 2.0),
                         both("mos_lam", "jf_lam"),
                         both("mos_p", "jf_p"))                # (4, nMJ, B)
        vt_d = lanes("vt_thermal", self.nD)
        self.diop = pack(bparams["dio_is"], bparams["dio_n"] * vt_d,
                         bparams["dio_bv"], bparams["dio_ibv"],
                         vt_d)                                 # (5, nD, B)
        self.bjtp = pack(bparams["bjt_is"], bparams["bjt_bf"],
                         bparams["bjt_br"], bparams["bjt_p"],
                         bparams["bjt_vaf"],
                         lanes("vt_thermal", self.nQ))         # (6, nQ, B)
        self.swp = pack(bparams["sw_ron"], bparams["sw_roff"],
                        bparams["sw_vt"], bparams["sw_vh"])    # (4, nSw, B)
        # the charge model's parameters (models/moscap.py), empty unless
        # the deck runs MOSCAP=CHARGE
        nq = self.nMq
        self.mqp = pack(*(bparams[key][..., :nq] for key in (
            "mos_vth", "mos_coxwl", "mos_cj0", "mos_p")))      # (4, nMq, B)

        # B sources: every tape's instructions and literals concatenated,
        # per source (instruction offset, count, literal offset, probe
        # pairs, V form, constant offset); their .PARAM values lane-minor
        tapes = [bs.tape for bs in plan.b_sources]
        offs = np.cumsum([0] + [len(tp.ops) for tp in tapes])
        loffs = np.cumsum([0] + [len(tp.lits) for tp in tapes])
        self.b_meta = torch.as_tensor(np.asarray(
            [[offs[i], len(tp.ops), loffs[i], len(bs.pairs), int(bs.is_v),
              bs.const_off] for i, (bs, tp) in enumerate(
                  zip(plan.b_sources, tapes))], np.int32).reshape(-1, 6),
            device=dev)
        self.b_ops = torch.as_tensor(np.concatenate(
            [tp.ops for tp in tapes] + [np.zeros(1, np.int32)]), device=dev)
        self.b_lits = torch.as_tensor(np.concatenate(
            [tp.lits for tp in tapes] + [np.zeros(1)]), dtype=dtype,
            device=dev)
        bc = bparams["b_consts"]
        self.bconsts = (_lm(bc.expand(B, bc.shape[-1])) if bc.shape[-1]
                        else torch.zeros((1, B), dtype=dtype, device=dev))
        self.b_sources = plan.b_sources

        # independent sources, V then I, lane-minor: dc (nS, B), pulse
        # (7, nS, B), sin (5, nS, B), pwl_t and pwl_v (P, nS, B), pwl_n
        def cat(key, pad_to=None):
            a, b = bparams["vs_" + key], bparams["is_" + key]
            if pad_to is not None:
                a = torch.nn.functional.pad(a, (0, pad_to - a.shape[-1]))
                b = torch.nn.functional.pad(b, (0, pad_to - b.shape[-1]))
            return _lm(torch.cat([a, b], dim=1).transpose(1, -1))

        P = max(bparams["vs_pwl_t"].shape[-1], bparams["is_pwl_t"].shape[-1],
                1)
        self.P = P
        self.src = (cat("dc"), cat("pulse"), cat("sin"), cat("pwl_t", P),
                    cat("pwl_v", P), cat("pwl_n").to(torch.int32))
        self.nS = self.src[0].shape[0]
        kinds = np.concatenate([engine.vs_kinds, engine.is_kinds]).astype(
            np.int32)
        self.src_masks = srcmod.kind_masks(kinds, dev)

        # companion conductances of the cap-like class and the inductors,
        # lane-minor (nCap, B), (nL, B)
        C = engine._caplike_C(bparams)
        L = bparams["ind_l"]
        self.gc = _lm(torch.where(C > 0.0, C / dt_t, 0.0))
        self.gl = _lm(torch.where(L > 0.0, L / dt_t, 0.0))
        self.nCap, self.nL = self.gc.shape[0], self.gl.shape[0]
        # mutual inductance (K1e): gm = M / dt lane-minor (nK, B) and the
        # coupled inductors (a, b) of each K element; one dummy entry each
        # without K, never read
        self.nK = nK = len(t.mut_a)
        if nK:
            M = engine._mutual_M(bparams)
            self.gm = _lm((M / dt_t).expand(B, nK))
            self.mut_plan = torch.as_tensor(np.stack(
                [t.mut_a, t.mut_b]).astype(np.int32), device=dev)
        else:
            self.gm = torch.zeros((1, B), dtype=dtype, device=dev)
            self.mut_plan = torch.zeros((2, 1), dtype=torch.int32,
                                        device=dev)

        # index plans shared by all lanes (N = ground dump slot): a source
        # adds its value at src_pos and subtracts it at src_neg
        nV = len(t.vs_ep)
        pos = np.concatenate([t.vs_k, t.is_em])
        neg = np.concatenate([np.full(nV, N), t.is_ep])

        def i32(a):
            return torch.as_tensor(
                np.ascontiguousarray(a, dtype=np.int32), device=dev)

        self.kinds = i32(kinds)
        self.src_pos, self.src_neg = i32(pos), i32(neg)
        self.ind_k = i32(t.ind_k)
        self.cap_a, self.cap_b = i32(engine.cap_a), i32(engine.cap_b)
        self.row_cols = i32(plan.col_idx().T.reshape(W, k))     # (W, k)

        # transmission lines (K1c-ii): per line its read slot ticks - 1, the
        # index plan (ep1, em1, k1, ep2, em2, k2) and Z0 lane-minor (nT, B);
        # without lines one dummy entry each, never read
        self.nT = nT = engine.n_tl
        if nT:
            ticks = engine.tl_ticks(self.dt)
            self.Dmax = int(ticks.max())
            self.tl_read = i32(ticks - 1)
            self.tl_plan = i32(np.stack([t.tl_ep1, t.tl_em1, t.tl_k1,
                                         t.tl_ep2, t.tl_em2, t.tl_k2]))
            self.tl_z0 = _lm(bparams["tl_z0"].expand(B, nT))
        else:
            self.Dmax = 0
            self.tl_read, self.tl_plan = i32([0]), i32(np.zeros((6, 1)))
            self.tl_z0 = torch.zeros((1, B), dtype=dtype, device=dev)
        # TRNOISE (K1c-iii): the noisy sources' rows, and per source its row
        # of the noise block (-1 for a source without noise)
        self.nN = 0
        self.noise_idx = self.noise_col = None
        if noise_idx is not None:
            ni = np.asarray(noise_idx, np.int64).reshape(-1)
            if (not ni.size or (ni < 0).any() or (ni >= self.nS).any()
                    or len(set(ni.tolist())) != ni.size):
                raise ValueError(f"noise_idx {ni.tolist()}: distinct source "
                                 f"rows in 0..{self.nS - 1} required")
            col = np.full(self.nS, -1)
            col[ni] = np.arange(ni.size)
            self.nN = int(ni.size)
            self.noise_idx = i32(ni)
            self.noise_col = i32(col)
        # one scatter for the whole RHS in the plain version
        ka, kb = t.ind_k[t.mut_a], t.ind_k[t.mut_b]
        self._rhs_rows = torch.cat([self.src_pos, self.src_neg, self.ind_k,
                                    self.cap_a, self.cap_b]
                                   + ([self.tl_plan[2], self.tl_plan[5]]
                                      if nT else [])
                                   + ([i32(ka), i32(kb)] if nK else [])
                                   ).long()
        # the kernel's b0 row plan (the same sums, row by row)
        self.n_terms = self.nS + self.nL + self.nCap + 2 * nT + 2 * nK
        rp, ri = rhs_plan(N, pos, neg, t.ind_k, engine.cap_a, engine.cap_b,
                          (t.tl_k1, t.tl_k2) if nT else None,
                          (ka, kb) if nK else None)
        self.rhs_ptr, self.rhs_idx = i32(rp), i32(ri)

    # ------------------------------------------------------------------
    def run_chunk(self, x, x_prev, vc, il, failed, step0: int, n_steps: int,
                  tlw=None, noise=None):
        """Advance every lane n_steps: x, x_prev (B, N), vc (B, nCap),
        il (B, nL), failed (B,) bool -> (x, x_prev, vc, il, failed, iters),
        plus ys (n_steps, P, B) when the runner has a probe matrix, plus,
        last, the advanced delay ring when the deck has T-lines (``tlw``
        (B, Dmax, 2 nT) in the Engine's layout, required then).  A runner
        built with ``noise_idx`` needs ``noise`` (n_steps, nN, B), the
        noise values of its steps (``Engine.trnoise_stream``).
        iters is the per-lane (B,) int32 total of Newton iterations over
        the chunk (the JAX kernel reports per-128-lane-block totals).  CUDA
        tensors launch the kernel, CPU tensors take ``run_chunk_plain``."""
        if x.device.type == "cpu":
            return self.run_chunk_plain(x, x_prev, vc, il, failed, step0,
                                        n_steps, tlw=tlw, noise=noise)
        if x.device.type != "cuda":
            raise ValueError(f"run_chunk: unsupported device {x.device}")
        return cuda_step.run_chunk_cuda(self, x, x_prev, vc, il, failed,
                                        step0, n_steps, tlw=tlw, noise=noise)

    def check_noise(self, noise, n_steps: int):
        """The noise block a noisy runner needs (and no other takes):
        (n_steps, nN, B) in the runner's dtype, on its device."""
        if not self.nN:
            if noise is not None:
                raise ValueError("run_chunk: noise given to a runner built "
                                 "without noise_idx")
            return
        want = (n_steps, self.nN, self.B)
        if noise is None:
            raise ValueError("run_chunk: a runner built with noise_idx needs "
                             "the noise block (noise=, Engine.trnoise_stream)")
        if (tuple(noise.shape) != want or noise.dtype != self.dtype
                or noise.device != self.G0inv.device):
            raise ValueError(f"run_chunk: noise is {tuple(noise.shape)} "
                             f"{noise.dtype} on {noise.device}, want {want} "
                             f"{self.dtype} on {self.G0inv.device}")

    def check_ring(self, tlw):
        """The ring a T-line deck needs (and no other takes): (B, Dmax,
        2 nT) in the runner's dtype, on the device of its constants."""
        if not self.nT:
            if tlw is not None:
                raise ValueError("run_chunk: tlw given for a deck without "
                                 "transmission lines")
            return
        want = (self.B, self.Dmax, 2 * self.nT)
        if tlw is None:
            raise ValueError("run_chunk: a T-line deck needs its delay ring "
                             "(tlw=, Engine.init_state)")
        if (tuple(tlw.shape) != want or tlw.dtype != self.dtype
                or tlw.device != self.G0inv.device):
            raise ValueError(f"run_chunk: tlw is {tuple(tlw.shape)} "
                             f"{tlw.dtype} on {tlw.device}, want {want} "
                             f"{self.dtype} on {self.G0inv.device}")

    @torch.inference_mode()
    def run_chunk_plain(self, x, x_prev, vc, il, failed, step0: int,
                        n_steps: int, tlw=None, noise=None):
        """The plain PyTorch version of the kernel, on the runner's device
        (the lane-minor packs read through transposed views)."""
        self.check_ring(tlw)
        self.check_noise(noise, n_steps)
        N, k, B = self.N, self.k, self.B
        dtype, dev = self.dtype, x.device
        zcol = torch.zeros((B, 1), dtype=dtype, device=dev)
        gc, gl = self.gc.T, self.gl.T                          # (B, n)
        gm = self.gm.T                                         # (B, nK)
        mut_a, mut_b = self.mut_plan.long()
        dc, pwl_n = self.src[0].T, self.src[5].T               # (B, nS)
        pulse, sin, pwl_t, pwl_v = (a.permute(2, 1, 0)         # (B, nS, q)
                                    for a in self.src[1:5])
        iters = torch.zeros((B,), dtype=torch.int32, device=dev)
        pm = self.probe_mat
        ys = (None if pm is None else
              torch.empty((n_steps, pm.shape[0], B), dtype=dtype, device=dev))
        eye = torch.eye(k, dtype=dtype, device=dev)
        cols = self.row_cols.long()                            # (W, k)
        W = self.W
        flags = self.flags
        mosp, diop, bjtp, swp = ([q.T for q in p] for p in (   # (B, n) each
            self.mosp, self.diop, self.bjtp, self.swp))
        o_d = self.nMJ
        o_q = o_d + self.nD
        o_s = o_q + 2 * self.nQ
        o_b = o_s + self.nSw
        o_c = o_b + self.nB
        bconsts = self.bconsts.T                               # (B, nc)
        inv_dt = self.inv_dt
        qpar = dict(zip(("mos_vth", "mos_coxwl", "mos_cj0", "mos_p"),
                        (q.T for q in self.mqp)))              # (B, nMq) each
        nT = self.nT
        if nT:
            ring = tlw
            tp = self.tl_plan.long()
            tl_read = self.tl_read.long()
            w_pos = torch.cat([tp[0], tp[3]])                  # (2 nT,)
            w_neg = torch.cat([tp[1], tp[4]])
            w_k = torch.cat([tp[2], tp[5]])
            z0w = self.tl_z0.T.repeat(1, 2)                    # (B, 2 nT)
            e_cols = torch.cat([torch.arange(nT, 2 * nT),      # E1 <- w2
                                torch.arange(nT)]).to(dev)     # E2 <- w1
            e_slots = tl_read.repeat(2)

        def vdgs_of(xx):
            """(B, nMq, 3) terminal voltages of the charge rows' MOS (the
            first of each device's five rows carries its columns)."""
            xm = torch.cat([xx, zcol], 1)[:, cols[:3, o_c::5]]
            return xm.permute(0, 2, 1)

        def nl_rows(xx, qprev, t):
            """V^T rows (W, B, k) and Newton constants (B, k) at xx and time
            t, the segments in Woodbury row order; qprev (B, nMq, 5) are
            the charges of the incoming x."""
            xe = torch.cat([xx, zcol], 1)
            xm = xe[:, cols]                                   # (B, W, k)
            vparts, cparts = [], []

            def rows(*coef):
                coef = list(coef) + [torch.zeros_like(coef[0])] * (
                    W - len(coef))
                return torch.stack(coef)

            if self.nMJ:
                vd, vg, vs = (xm[:, q, :o_d] for q in range(3))
                gd, gg, gs, cst = mos_linearize(*mosp, vd, vg, vs,
                                                self.off_gds)
                vparts.append(rows(gd, gg, gs))
                cparts.append(cst)
            if self.nD:
                isat, nvt, bv, ibv, vt = diop
                g, cst = diode_linearize(
                    isat, None, xm[:, 0, o_d:o_q], xm[:, 1, o_d:o_q], vt=vt,
                    bv=bv if flags["dio_bv"] else None,
                    ibv=ibv if flags["dio_bv"] else None, nvt=nvt)
                vparts.append(rows(g, -g))
                cparts.append(cst)
            if self.nQ:
                isat, bf, br, pq, vaf, vt = bjtp
                # each device is read at its Ic row (even rows of the pair)
                vc, vb, ve = (xm[:, q, o_q:o_s:2] for q in range(3))
                rc, rb = bjt_linearize(isat, bf, br, pq, vc, vb, ve, vt=vt,
                                       vaf=vaf if flags["bjt_early"] else None)
                vparts.append(torch.stack([rows(*rc[:3]), rows(*rb[:3])],
                                          dim=-1).flatten(-2))
                cparts.append(torch.stack([rc[3], rb[3]], dim=-1).flatten(-2))
            if self.nSw:
                gd, gc, cst = switch_linearize(
                    *swp, *(xm[:, q, o_s:o_b] for q in range(4)))
                vparts.append(rows(gd, -gd, gc, -gc))
                cparts.append(cst)
            for i, bs in enumerate(self.b_sources):
                # B rows: sig (g_0, -g_0, ...) and c = sig (e0 - g.vals)
                j, m = o_b + i, len(bs.pairs)
                vals = torch.stack([xm[:, 2 * q, j] - xm[:, 2 * q + 1, j]
                                    for q in range(m)], -1) if m else \
                    xm[:, 0, :0]
                e0, g = eval_tape(bs.tape, vals, t, bconsts[
                    :, bs.const_off:bs.const_off + bs.n_consts])
                cst = e0 - (g * vals).sum(-1)
                sig = -1.0 if bs.is_v else 1.0
                coef = [c for q in range(m)
                        for c in (sig * g[:, q], -sig * g[:, q])]
                vparts.append(rows(*(coef or [torch.zeros_like(e0)]))[
                    ..., None])
                cparts.append((sig * cst)[:, None])
            if self.nCq:
                # charge rows (JAX kernel :997-1019), device-major: five
                # rows per MOS over its (vd, vg, vs)
                vd, vg, vs = (xm[:, q, o_c::5] for q in range(3))
                q, J = charge_jacobian(torch.stack([vd, vg, vs], -1), qpar)
                gd, gg, gs = (J[..., j].flatten(1) * inv_dt for j in range(3))
                cst = ((q.flatten(1) - qprev.flatten(1)) * inv_dt
                       - gd * vd.repeat_interleave(5, 1)
                       - gg * vg.repeat_interleave(5, 1)
                       - gs * vs.repeat_interleave(5, 1))
                vparts.append(rows(gd, gg, gs))
                cparts.append(cst)
            return torch.cat(vparts, -1), torch.cat(cparts, -1)

        def newton(xx, done, fl, z0, active, qprev, t):
            """One iteration; ``active`` masks the failed update and the
            count (the per-lane while loop), None runs it ungated."""
            if k:
                v, cst = nl_rows(xx, qprev, t)                 # (W, B, k)
                z = z0 - torch.einsum("bnj,bj->bn", self.Y, cst)
                S = eye + torch.einsum("sbj,bjsl->bjl", v, self.Yc3)
                ze = torch.cat([z, zcol], 1)
                vz = (v * ze[:, cols].movedim(1, 0)).sum(0)
                w = (lu_solve_plain(S, vz, 0.0) if k <= UNROLL_K_MAX
                     else gauss_jordan_plain(S, vz))
                x_raw = z - torch.einsum("bnj,bj->bn", self.Y, w)
            else:
                x_raw = z0
            finite = torch.isfinite(x_raw).all(1)
            u = x_raw - xx
            if self.clamp > 0.0:
                u = torch.clamp(u, -self.clamp, self.clamp)
            x_new = xx + self.alpha * u
            err2 = ((x_new - xx) ** 2).sum(1)
            upd = finite & ~done
            xx = torch.where(upd[:, None], x_new, xx)
            done = done | (upd & (err2 < self.tol2)) | ~finite
            bad = ~finite if active is None else ~finite & active
            return xx, done, fl | bad

        for i in range(n_steps):
            t = torch.tensor(float(step0 + i + 1), dtype=dtype,
                             device=dev) * self.dt_t
            sv = srcmod.eval_tran_masked(self.src_masks, dc, pulse, sin,
                                         pwl_t, pwl_v, pwl_n, t)
            if self.nN:     # the step's noise onto the noisy sources' values
                sv = sv.index_add(1, self.noise_idx.long(), noise[i].T)
            h = gc * vc
            parts = [sv, -sv, -(gl * il), h, -h]
            if nT:          # the delayed waves E1 at rows k1, E2 at rows k2
                parts.append(ring[:, e_slots, e_cols])
            if self.nK:     # K1e: row k_a gets -gm il_b, row k_b -gm il_a
                parts += [-(gm * il[:, mut_b]), -(gm * il[:, mut_a])]
            vals = torch.cat(parts, 1)
            b = torch.zeros((B, N + 1), dtype=dtype, device=dev)
            b.index_add_(1, self._rhs_rows, vals)
            z0 = torch.einsum("bnm,bm->bn", self.G0inv, b[:, :N])
            xx = 2.0 * x - x_prev if self.predictor else x
            # q_prev = q(x of the previous step): the state's qm
            qprev = charges_of_x(vdgs_of(x), qpar) if self.nCq else None
            done, fl = failed, failed
            if self.unrolled > 0:
                for _ in range(self.unrolled):
                    xx, done, fl = newton(xx, done, fl, z0, None, qprev, t)
                iters += self.unrolled
            else:
                for _ in range(self.max_nr):
                    active = ~done
                    if not bool(active.any()):
                        break
                    xx, done, fl = newton(xx, done, fl, z0, active, qprev,
                                          t)
                    iters += active.to(torch.int32)
            if ys is not None:          # the probe stream of the accepted x
                ys[i] = pm @ xx.T
            xe = torch.cat([xx, zcol], 1)
            vc = xe[:, self.cap_a.long()] - xe[:, self.cap_b.long()]
            il = xe[:, self.ind_k.long()]
            if nT:          # this step's waves into slot 0
                w = xe[:, w_pos] - xe[:, w_neg] + z0w * xe[:, w_k]
                ring = torch.cat([w[:, None], ring[:, :-1]], 1)
            x_prev, x, failed = x, xx, fl
        out = (x, x_prev, vc, il, failed, iters)
        if ys is not None:
            out += (ys,)
        return out + ((ring,) if nT else ())


def rhs_plan(N, pos, neg, ind_k, cap_a, cap_b, tl_rows=None, mut_rows=None):
    """The kernel's b0 row plan: row n of b0 is the sum of its terms
    rhs_idx[rhs_ptr[n]:rhs_ptr[n + 1]], each term << 1 | negated, in the
    order of the plain version's one scatter (``_rhs_rows``: +value of
    every source at its pos row, -value at its neg row, -gl il of every
    inductor, +gc vc of every capacitor at a, -gc vc at b, E1 of every line
    at k1, E2 at k2, then the mutual history of every K element at k_a and
    at k_b), so that each row sums its terms in the order a sequential
    scatter adds them.  Terms: the sources (nS), inductors, capacitors,
    the 2 nT EMFs (E1_j = 2 j, E2_j = 2 j + 1), then the 2 nK mutual terms
    (-gm_m il[b_m] = 2 m at row k_a[m], -gm_m il[a_m] = 2 m + 1 at row
    k_b[m]); ``tl_rows`` is (k1, k2), ``mut_rows`` (k_a, k_b) the branch
    rows of each K element's inductors, or None.  Rows >= N (ground) are
    dropped."""
    nS, nL = len(pos), len(ind_k)
    o_c, o_e = nS + nL, nS + nL + len(cap_a)
    adds = ([(pos[s], s, 0) for s in range(nS)]      # (row, term, negated)
            + [(neg[s], s, 1) for s in range(nS)]
            + [(r, nS + j, 0) for j, r in enumerate(ind_k)]
            + [(r, o_c + j, 0) for j, r in enumerate(cap_a)]
            + [(r, o_c + j, 1) for j, r in enumerate(cap_b)])
    if tl_rows is not None:
        k1, k2 = tl_rows
        adds += ([(r, o_e + 2 * j, 0) for j, r in enumerate(k1)]
                 + [(r, o_e + 2 * j + 1, 0) for j, r in enumerate(k2)])
    if mut_rows is not None:
        o_m = o_e + 2 * (0 if tl_rows is None else len(tl_rows[0]))
        ka, kb = mut_rows
        adds += ([(r, o_m + 2 * m, 0) for m, r in enumerate(ka)]
                 + [(r, o_m + 2 * m + 1, 0) for m, r in enumerate(kb)])
    rows = [[] for _ in range(N)]
    for r, term, negated in adds:
        if int(r) < N:
            rows[int(r)].append(term << 1 | negated)
    ptr = np.cumsum([0] + [len(r) for r in rows])
    idx = np.asarray([c for r in rows for c in r] or [0], np.int64)
    return ptr.astype(np.int32), idx.astype(np.int32)


def gauss_jordan_plain(A, b):
    """Column-pivoted Gauss-Jordan of the JAX kernel's 16 < k branch
    (``pallas_step.py:1126-1160``) on (B, k, k) x (B, k): for each column
    c the pivot row p is the first maximum of |A[:, c]| over the rows not
    used yet (a NaN counts as largest), every other row subtracts
    A[i, c] / A[p, c] times row p (a zero pivot divides by 1), and at the
    end w[c(p)] = b[p] / A[p, c(p)] (a zero divides by 1)."""
    B, k = b.shape
    rows = torch.arange(k, device=b.device)
    used = torch.zeros((B, k), dtype=torch.bool, device=b.device)
    colof = torch.zeros((B, k), dtype=torch.long, device=b.device)
    for c in range(k):
        col = A[:, :, c]
        p = torch.where(used, -1.0, col.abs()).max(1).indices     # (B,)
        onep = rows == p[:, None]                                  # (B, k)
        rowp = A.gather(1, p[:, None, None].expand(B, 1, k))[:, 0]
        bp = b.gather(1, p[:, None])
        piv = rowp[:, c:c + 1]
        fac = torch.where(onep, 0.0, col / torch.where(piv != 0.0, piv, 1.0))
        A = A - fac[:, :, None] * rowp[:, None, :]
        b = b - fac * bp
        used = used | onep
        colof = colof + onep * c
    pivd = A.gather(2, colof[:, :, None])[:, :, 0]
    wrow = b / torch.where(pivd != 0.0, pivd, 1.0)
    return torch.zeros_like(b).scatter_(1, colof, wrow)
