"""Fused batched AC frequency sweep (K3): for every (lane, omega) solve
(G + j omega B1)(xr + j xi) = br + j bi.

Behavioral contract (the TPU kernel ``circuitsimulator_tpu/ops/pallas_ac.py:
_ac_kernel``):

- A = G + j omega B1 is formed per (lane, omega) from the lane's
  frequency-independent G and unit-omega susceptance B1;
- complex Gaussian elimination, pivoting on the first index of the largest
  |a|^2 = re^2 + im^2 among the rows i >= k of column k;
- ``ok`` holds while every column maximum is >= pivot_floor^2.  A NaN
  column maximum fails that test, so a lane holding a NaN comes back all
  zeros (the Pallas kernel's choice; the port's real LU, ``ops/lu.py``,
  follows the XLA path instead and lets the NaN through);
- a zero pivot is replaced by 1 in the factor division; back substitution
  zeroes a component whose diagonal |d|^2 is below pivot_floor^2;
- a lane whose ``ok`` failed returns zeros at that frequency.

Pivoting by |a|^2 may pick another row than the real 2N route
(``analysis/ac.solve_ac_real``), so the two agree to dtype resolution, not
bitwise.  ``ac_sweep_plain`` is the plain PyTorch version (real split, any
device); ``ac_sweep`` dispatches a CPU tensor to it and a CUDA tensor to the
hand-written kernel (``ops/cuda_ac.py``), or raises.
"""

from __future__ import annotations

import torch

from . import cuda_ac

N_MAX = cuda_ac.MAX_N


def _check(G, B1, br, bi, omegas):
    """Shapes and types of the gate: G, B1 (B, N, N), br, bi (B, N),
    omegas (F,), one floating type, 0 < N <= N_MAX."""
    if G.dim() != 3 or G.shape[1] != G.shape[2]:
        raise ValueError(f"ac_sweep: G is {tuple(G.shape)}, not (B, N, N)")
    Bn, n, _ = G.shape
    if tuple(B1.shape) != (Bn, n, n) or tuple(br.shape) != (Bn, n) \
            or tuple(bi.shape) != (Bn, n) or omegas.dim() != 1:
        raise ValueError(f"ac_sweep: shapes G {tuple(G.shape)}, B1 "
                         f"{tuple(B1.shape)}, br {tuple(br.shape)}, bi "
                         f"{tuple(bi.shape)}, omegas {tuple(omegas.shape)}")
    if G.dtype not in (torch.float32, torch.float64) or any(
            a.dtype != G.dtype for a in (B1, br, bi)):
        raise TypeError(f"ac_sweep: f32 or f64 required, one type for G, "
                        f"B1, br, bi (got {G.dtype}, {B1.dtype}, "
                        f"{br.dtype}, {bi.dtype})")
    if not 0 < n <= N_MAX:
        raise ValueError(f"ac_sweep: N={n} outside 1..{N_MAX}")


@torch.inference_mode()
def ac_sweep_plain(G, B1, br, bi, omegas, pivot_floor: float = 1e-15):
    """Plain version: (xr, xi) each (B, F, N) in G's dtype, every (lane,
    frequency) system eliminated at once on (B, F, N, N) tensors."""
    _check(G, B1, br, bi, omegas)
    Bn, n, _ = G.shape
    F = omegas.shape[0]
    w = omegas.to(G.dtype)[None, :, None, None]
    Ar = G[:, None].expand(Bn, F, n, n).clone()
    Ai = w * B1[:, None]
    Br = br[:, None].expand(Bn, F, n).clone()
    Bi = bi[:, None].expand(Bn, F, n).clone()
    floor2 = float(pivot_floor) ** 2
    ok = torch.ones((Bn, F), dtype=torch.bool, device=G.device)
    for k in range(n):
        cr, ci = Ar[..., k:, k], Ai[..., k:, k]
        # first largest |a|^2; a NaN is the maximum and fails the floor
        best, p = (cr * cr + ci * ci).max(-1, keepdim=True)
        ok &= best.squeeze(-1) >= floor2
        # swap rows k <-> p over columns k.. (row k is written last, so
        # p == k is a no-op); columns < k are never read again
        ip = (p + k).unsqueeze(-1).expand(Bn, F, 1, n - k)
        for A in (Ar, Ai):
            tail = A[..., k:]
            rowp = tail.gather(-2, ip)
            tail.scatter_(-2, ip, tail[..., k:k + 1, :].clone())
            tail[..., k:k + 1, :] = rowp
        for b in (Br, Bi):
            bp = b.gather(-1, p + k)
            b.scatter_(-1, p + k, b[..., k:k + 1].clone())
            b[..., k:k + 1] = bp
        pr, pi = Ar[..., k:k + 1, k], Ai[..., k:k + 1, k]       # (B, F, 1)
        den = pr * pr + pi * pi
        safe = torch.where(den != 0.0, den, torch.ones_like(den))
        ar, ai = Ar[..., k + 1:, k], Ai[..., k + 1:, k]         # (B, F, m)
        fr = (ar * pr + ai * pi) / safe
        fi = (ai * pr - ar * pi) / safe
        akr, aki = Ar[..., k:k + 1, k + 1:], Ai[..., k:k + 1, k + 1:]
        frc, fic = fr[..., None], fi[..., None]
        Ar[..., k + 1:, k + 1:] -= frc * akr - fic * aki
        Ai[..., k + 1:, k + 1:] -= frc * aki + fic * akr
        bkr, bki = Br[..., k:k + 1], Bi[..., k:k + 1]
        Br[..., k + 1:] -= fr * bkr - fi * bki
        Bi[..., k + 1:] -= fr * bki + fi * bkr
    xr = torch.zeros_like(Br)
    xi = torch.zeros_like(Bi)
    for j in range(n - 1, -1, -1):
        arj, aij = Ar[..., j, j + 1:], Ai[..., j, j + 1:]
        xrt, xit = xr[..., j + 1:], xi[..., j + 1:]
        sr = Br[..., j] - (arj * xrt - aij * xit).sum(-1)
        si = Bi[..., j] - (arj * xit + aij * xrt).sum(-1)
        dr, di = Ar[..., j, j], Ai[..., j, j]
        den = dr * dr + di * di
        safe = torch.where(den != 0.0, den, torch.ones_like(den))
        good = den >= floor2
        zero = torch.zeros_like(sr)
        xr[..., j] = torch.where(good, (sr * dr + si * di) / safe, zero)
        xi[..., j] = torch.where(good, (si * dr - sr * di) / safe, zero)
    okc = ok[..., None]
    return (torch.where(okc, xr, torch.zeros_like(xr)),
            torch.where(okc, xi, torch.zeros_like(xi)))


def ac_sweep(G, B1, br, bi, omegas, pivot_floor: float = 1e-15):
    """(xr, xi) each (B, F, N).  CPU tensors take the plain version, CUDA
    tensors the K3 kernel; a shape or type outside the gate raises."""
    _check(G, B1, br, bi, omegas)
    devs = {a.device for a in (G, B1, br, bi, omegas)}
    if all(d.type == "cpu" for d in devs):
        return ac_sweep_plain(G, B1, br, bi, omegas, pivot_floor)
    if len(devs) != 1 or G.device.type != "cuda":
        raise ValueError(f"ac_sweep: unsupported devices "
                         f"{sorted(map(str, devs))}")
    return cuda_ac.ac_sweep_cuda(G.contiguous(), B1.contiguous(),
                                 br.contiguous(), bi.contiguous(),
                                 omegas.to(G.dtype).contiguous(), pivot_floor)
