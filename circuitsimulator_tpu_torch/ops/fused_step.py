"""Fused Monte-Carlo transient chunk (K1a): whole Backward-Euler timesteps
per lane in one launch.

Port of ``circuitsimulator_tpu/ops/pallas_step.py`` (``PallasStepRunner``)
for its K1a scope: R/C/L, V and I sources with every waveform kind
(PULSE/SIN/PWL/EXP/SFFM, PWL with at most 8 breakpoints), the linear
controlled sources E/G/F/H (their stamps live in G0 only) and Level-1 MOS
without body effect or reverse region, Woodbury rank 0 <= k <= 16 (k = 0
is a linear deck: each Newton iteration accepts z0 = G0^{-1} b).

Per step and lane (what the kernel and ``run_chunk_plain`` compute):

- sources at t = (step0 + i + 1) dt in the working type (never t += dt);
- b0 = [sources, -gl il, gc vc] scattered to their rows; z0 = G0^{-1} b0;
- Newton from x (or 2x - x_prev with the predictor): MOS linearisation,
  z = z0 - Y c, S = I + V^T Y, vz = V^T z, the pivoted k x k solve
  S w = vz (first index of max |col|, a zero pivot and a zero diagonal
  replaced by 1, no pivot floor), x_raw = z - Y w, then the damped accept
  (clamp, alpha, err^2 < tol^2, a non-finite x_raw freezes the lane and
  raises ``failed``);
- vc and il from the accepted x.

The Newton loop runs ``tran_unrolled_iters`` fixed iterations, or per lane
until done or ``tran_max_newton_iters``.  A per-lane loop gives the x of the
JAX kernel's block-wide while loop, because accept freezes lanes that are
done; it differs only in that a done lane never again raises ``failed``
(the masked semantics of the non-fused loop, analysis/transient.py).

Constants are lane-minor and contraction-major, as in the JAX kernel:
G0invT (N, N, B) [m, n, lane] = G0inv[lane, n, m], YT (k, N, B), Yc3
(3, k, k, B).  The one-hot selection matmuls of the TPU kernel are index
plans here (source rows, inductor rows, cap terminal pairs, MOS (d, g, s)
columns); index N is the ground dump slot and reads 0.

``FusedStepRunner.run_chunk`` launches the CUDA kernel (``ops/cuda_step``,
``csrc/fused_step.cu``) on CUDA tensors and runs ``run_chunk_plain``, the
plain PyTorch version, on CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import sources as srcmod
from ..models.mosfet import mos_linearize
from ..netlist import WAVE_PWL
from . import cuda_step
from .lu import lu_solve_plain
from .woodbury import WoodburySolver

MAX_N = cuda_step.MAX_N      # unknowns per lane (the kernel's local arrays)
MAX_K = cuda_step.MAX_K      # Woodbury rank; 16 < k <= 32 is K1d
MAX_PWL = 8                  # PWL breakpoints (the JAX kernel unrolls <= 8)


def unsupported_reason(engine, dt=None) -> Optional[str]:
    """Why ``engine`` is outside the K1a scope, or None when it is in.

    In scope is a subset of ``circuitsimulator_tpu/ops/pallas_step.py:
    supported``: every condition refused there is refused here, plus
    16 < k (K1d) and N > 64."""
    t = engine.topo
    opts = engine.opts
    others = sorted(c for c, n in t.counts.items()
                    if n and c not in "RCLVIMEGFH")
    if others:
        return f"device classes {', '.join(others)} (K1b/K1c)"
    if engine.mos_body:
        return "MOS body effect (GAMMA)"
    if opts.mos_reverse_region:
        return "MOS reverse region (MOSSYM)"
    if opts.mos_cap_model != "fixed":
        return "MOSCAP=CHARGE (K1d)"
    if opts.tran_method != "be":
        return f"METHOD={opts.tran_method.upper()} (Backward Euler only)"
    if engine.dtype not in (torch.float32, torch.float64):
        return f"dtype {engine.dtype}"
    kinds = np.concatenate([engine.vs_kinds, engine.is_kinds])
    if np.any(kinds == WAVE_PWL) and engine.pwl_width > MAX_PWL:
        return f"PWL source with {engine.pwl_width} > {MAX_PWL} breakpoints"
    if engine.N > MAX_N:
        return f"N = {engine.N} > {MAX_N} unknowns"
    k = len(t.mos_ed)
    if k > MAX_K:
        return f"Woodbury rank k = {k} > {MAX_K} (K1d)"
    return None


def supported(engine, dt=None) -> bool:
    """The K1a gate (``dt`` is accepted for the JAX signature; K1a has no
    dt-dependent device)."""
    return unsupported_reason(engine, dt) is None


def _lm(a: torch.Tensor) -> torch.Tensor:
    """Lane axis 0 -> last axis, contiguous."""
    return a.movedim(0, -1).contiguous()


class FusedStepRunner:
    """Per-lane constants of the fused chunk for one batch of parameters."""

    def __init__(self, engine, bparams, dt: float):
        reason = unsupported_reason(engine, dt)
        if reason is not None:
            raise NotImplementedError(f"fused transient chunk (K1a): {reason}")
        t = engine.topo
        opts = engine.opts
        self.N = N = engine.N
        self.dtype = dtype = engine.dtype
        dev = engine.device
        self.dt = float(dt)
        self.max_nr = int(opts.tran_max_newton_iters)
        self.tol2 = float(opts.tran_tol) ** 2
        self.alpha = float(opts.tran_alpha)
        self.clamp = float(opts.tran_newton_clamp)
        self.predictor = bool(opts.tran_predictor)
        self.unrolled = int(opts.tran_unrolled_iters)
        self.off_gds = float(opts.mos_off_gds)
        self.B = B = next(iter(bparams.values())).shape[0]
        self.dt_t = dt_t = torch.tensor(self.dt, dtype=dtype, device=dev)

        G = engine.tran_static_G(bparams, dt_t, opts.tran_gmin)
        wb = WoodburySolver(engine, bparams, G[..., :N, :N])
        self.k = k = wb.plan.k
        self.G0invT = wb.G0inv.permute(2, 1, 0).contiguous()   # (N, N, B)
        self.YT = wb.Y.permute(2, 1, 0).contiguous()           # (k, N, B)
        self.Yc3 = wb.Y_cols.permute(2, 1, 3, 0).contiguous()  # (3, k, k, B)
        self.mosp = torch.stack([bparams["mos_vth"], bparams["mos_k"],
                                 bparams["mos_lam"], bparams["mos_p"]],
                                0).permute(0, 2, 1).contiguous()  # (4, k, B)

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

        # index plans shared by all lanes (N = ground dump slot): a source
        # adds its value at src_pos and subtracts it at src_neg
        nV = len(t.vs_ep)
        pos = np.concatenate([t.vs_k, t.is_em])
        neg = np.concatenate([np.full(nV, N), t.is_ep])

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int64).astype(np.int32),
                                   device=dev)

        self.kinds = i32(kinds)
        self.src_pos, self.src_neg = i32(pos), i32(neg)
        self.ind_k = i32(t.ind_k)
        self.cap_a, self.cap_b = i32(engine.cap_a), i32(engine.cap_b)
        self.mos_cols = i32(np.stack([t.mos_ed, t.mos_eg, t.mos_es], 0)
                            .reshape(3, k))                     # (3, k)
        # one scatter for the whole RHS in the plain version
        self._rhs_rows = torch.cat([self.src_pos, self.src_neg, self.ind_k,
                                    self.cap_a, self.cap_b]).long()

    # ------------------------------------------------------------------
    def run_chunk(self, x, x_prev, vc, il, failed, step0: int, n_steps: int):
        """Advance every lane n_steps: x, x_prev (B, N), vc (B, nCap),
        il (B, nL), failed (B,) bool -> (x, x_prev, vc, il, failed, iters).
        iters is the per-lane (B,) int32 total of Newton iterations over
        the chunk (the JAX kernel reports per-128-lane-block totals).  CUDA
        tensors launch the kernel, CPU tensors take ``run_chunk_plain``."""
        if x.device.type == "cpu":
            return self.run_chunk_plain(x, x_prev, vc, il, failed, step0,
                                        n_steps)
        if x.device.type != "cuda":
            raise ValueError(f"run_chunk: unsupported device {x.device}")
        return cuda_step.run_chunk_cuda(self, x, x_prev, vc, il, failed,
                                        step0, n_steps)

    @torch.inference_mode()
    def run_chunk_plain(self, x, x_prev, vc, il, failed, step0: int,
                        n_steps: int):
        """The plain PyTorch version of the kernel, on the runner's device
        (the lane-minor constants read through transposed views)."""
        N, k, B = self.N, self.k, self.B
        dtype, dev = self.dtype, x.device
        zcol = torch.zeros((B, 1), dtype=dtype, device=dev)
        gc, gl = self.gc.T, self.gl.T                          # (B, n)
        dc, pwl_n = self.src[0].T, self.src[5].T               # (B, nS)
        pulse, sin, pwl_t, pwl_v = (a.permute(2, 1, 0)         # (B, nS, q)
                                    for a in self.src[1:5])
        iters = torch.zeros((B,), dtype=torch.int32, device=dev)
        vth, kk, lam, pp = (p.T for p in self.mosp)            # (B, k) each
        eye = torch.eye(k, dtype=dtype, device=dev)
        cols = self.mos_cols.long()

        def newton(xx, done, fl, z0, active):
            """One iteration; ``active`` masks the failed update and the
            count (the per-lane while loop), None runs it ungated."""
            if k:
                xe = torch.cat([xx, zcol], 1)
                gd, gg, gs, cst = mos_linearize(
                    vth, kk, lam, pp, xe[:, cols[0]], xe[:, cols[1]],
                    xe[:, cols[2]], self.off_gds)
                z = z0 - torch.einsum("jnb,bj->bn", self.YT, cst)
                v = torch.stack([gd, gg, gs])                  # (3, B, k)
                S = eye + torch.einsum("sbj,sjlb->bjl", v, self.Yc3)
                ze = torch.cat([z, zcol], 1)
                vz = (v * torch.stack([ze[:, c] for c in cols])).sum(0)
                w = lu_solve_plain(S, vz, 0.0)
                x_raw = z - torch.einsum("jnb,bj->bn", self.YT, w)
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
            h = gc * vc
            vals = torch.cat([sv, -sv, -(gl * il), h, -h], 1)
            b = torch.zeros((B, N + 1), dtype=dtype, device=dev)
            b.index_add_(1, self._rhs_rows, vals)
            z0 = torch.einsum("mnb,bm->bn", self.G0invT, b[:, :N])
            xx = 2.0 * x - x_prev if self.predictor else x
            done, fl = failed, failed
            if self.unrolled > 0:
                for _ in range(self.unrolled):
                    xx, done, fl = newton(xx, done, fl, z0, None)
                iters += self.unrolled
            else:
                for _ in range(self.max_nr):
                    active = ~done
                    if not bool(active.any()):
                        break
                    xx, done, fl = newton(xx, done, fl, z0, active)
                    iters += active.to(torch.int32)
            xe = torch.cat([xx, zcol], 1)
            vc = xe[:, self.cap_a.long()] - xe[:, self.cap_b.long()]
            il = xe[:, self.ind_k.long()]
            x_prev, x, failed = x, xx, fl
        return x, x_prev, vc, il, failed, iters
