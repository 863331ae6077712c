"""Small-signal AC analysis (the ``.AC lin|dec|oct n fstart fstop`` card);
port of ``circuitsimulator_tpu/analysis/ac.py``.

1. solve the DC operating point;
2. linearize every nonlinear device there (the conductances of the Newton
   stamp, ``Engine._nl_vals``);
3. for each frequency solve Y(w) X = J with
     R: 1/R          C (and the MOS junction caps): jwC
     L: branch rows +/-1 with Y[k,k] = -jwL
     K: Y[k_a, k_b] = Y[k_b, k_a] = -jwM, M = k sqrt(L_a L_b)
     V: branch rows +/-1, J[k] = acMag e^{j phase}
     I: J[p] -= Iac, J[m] += Iac
     E/G/F/H: their static stamps;    MOS: DC-point conductances;
     B: the V form's branch couplings, and the expression's gradient at
     the operating point (part of the linearisation);
     MOSCAP=CHARGE: jw C_tj with C_tj = dq_t/dv_j at the operating point
     (``models/moscap.charge_jacobian``) at the charge rows' entries;
     T: the exact lossless line, the Branin branch rows with the delay as
     the phase factor e^{-jwTD}, split into cos and sin parts.

Without T-lines every reactive entry is linear in w, so G, the unit-w
susceptance B1 and the RHS are assembled once per lane and the K3 sweep
(``ops/ac_sweep.ac_sweep``: the CUDA kernel on the card, its plain version
on the CPU) forms and solves every (lane, w) system.  One lane and many take
the same route, in every dtype.  A T-line deck's G and B are not linear in
w: as in the JAX package, each frequency is assembled on its own and the
(lanes x frequencies) systems are solved as the real 2N system
[[G, -B], [B, G]] (``solve_ac_real``: the pivoted LU, K2 on CUDA tensors,
2N <= 64 there), never by K3.  ``solve_ac_real`` is also the reference
route of the other decks.

Sweep conventions: lin = n points total; dec = n points per decade; oct =
n points per octave (endpoints included).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..models.moscap import charge_jacobian
from ..ops.ac_sweep import ac_sweep
from ..ops.assemble import Engine, _two_terminal_vals
from ..ops.lu import lu_solve
from .dc import dc_operating_point
from ..utils.shapes import broadcast_shapes

# entries of the (lanes x frequencies) real 2N systems of a T-line sweep
# that are assembled and solved at once
_TL_BLOCK_ELEMS = 1 << 25


@dataclasses.dataclass
class ACResult:
    freqs: Any    # (F,) numpy, the engine's dtype
    xs: Any       # (F, N) or (B, F, N) complex numpy


def sweep_frequencies(sweep_type: str, n_points: int,
                      fstart: float, fstop: float) -> np.ndarray:
    if n_points <= 0 or fstart <= 0 or fstop < fstart:
        raise ValueError("invalid .AC sweep parameters")
    if sweep_type == "lin":
        return np.linspace(fstart, fstop, max(n_points, 1))
    per = np.log10(fstop / fstart) if sweep_type == "dec" \
        else np.log2(fstop / fstart)
    total = int(np.floor(n_points * per + 1e-9)) + 1
    total = max(total, 1)
    return np.asarray(
        fstart * (fstop / fstart) ** (np.arange(total) / max(total - 1, 1)))


def _scatter(engine: Engine, rows, cols, vals, lead):
    """(..., N+1, N+1) matrix of the COO entries (rows, cols, vals)."""
    N1 = engine.N + 1
    flat = torch.as_tensor(np.asarray(rows, np.int64) * N1
                           + np.asarray(cols, np.int64), device=engine.device)
    M = torch.zeros(lead + (N1 * N1,), dtype=engine.dtype,
                    device=engine.device)
    M.index_add_(-1, flat, vals.expand(lead + vals.shape[-1:]))
    return M.reshape(lead + (N1, N1))


def ac_system_real(engine: Engine, params, x_op, omega):
    """Real/imaginary split of the AC MNA system at angular frequency
    omega: Y = G + jB, J = Jr + jJi, returned as (G, B, Jr, Ji) of shapes
    (..., N, N) and (..., N); params and x_op may carry leading lane axes."""
    t = engine.topo
    N = engine.N
    dtype, dev = engine.dtype, engine.device
    omega = torch.as_tensor(omega, dtype=dtype, device=dev)
    gvals, _ = engine._nl_vals(params, x_op)
    # the B V-form branch couplings are static; the expression part is in
    # the linearisation at the operating point (gvals)
    parts = [engine._res_vals(params), engine.dc_const_vals,
             engine._ctrl_vals(params), engine.b_static_vals, gvals]
    lead = broadcast_shapes(*(p.shape[:-1] for p in parts))
    gv = torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], -1)
    G = _scatter(engine,
                 np.concatenate([engine.res_rows, engine.dc_const_rows,
                                 engine.ctrl_rows, engine.b_static_rows,
                                 engine.nl_rows]),
                 np.concatenate([engine.res_cols, engine.dc_const_cols,
                                 engine.ctrl_cols, engine.b_static_cols,
                                 engine.nl_cols]), gv, lead)
    C = engine._caplike_C(params)
    L = params["ind_l"]
    M = engine._mutual_M(params)
    bparts = [_two_terminal_vals(omega * C), -omega * L,
              -omega * torch.cat([M, M], -1)]
    brows = [engine.cap_rows, t.ind_k, engine.mut_rows]
    bcols = [engine.cap_cols, t.ind_k, engine.mut_cols]
    if engine.mos_charge:
        # charge model: the trans-capacitances dq_t/dv_j at the operating
        # point (bias-dependent and non-reciprocal; _caplike_C zeroes the
        # fixed lumps under this model)
        _, Jq = charge_jacobian(engine.mos_vdgs(x_op), params)
        bparts.append(omega * Jq.flatten(-3))
        brows.append(engine.mq_rows)
        bcols.append(engine.mq_cols)
    if engine.n_tl:
        # the exact line: k1: V(p1) - V(n1) - Z0 I1
        #   - e^{-jwTD} (V(p2) - V(n2) + Z0 I2) = 0, and k2 likewise; the
        # own-port part +1, -1, -Z0 is real, the delayed other-port part
        # -e^{-j th} = -cos th + j sin th (th = w TD)
        z0 = params["tl_z0"]
        th = omega * params["tl_td"]
        cth, sth, one = torch.cos(th), torch.sin(th), torch.ones_like(z0)
        G = G + _scatter(
            engine,
            np.concatenate([engine.tl_kcl_rows, engine.tl_tran_rows,
                            engine.tl_tran_rows]),
            np.concatenate([engine.tl_kcl_cols, engine.tl_tran_cols,
                            engine._tl_other_cols]),
            torch.cat([engine.tl_kcl_vals.expand(z0.shape[:-1] + (-1,)),
                       torch.stack([one, -one, -z0, one, -one, -z0],
                                   -1).flatten(-2),
                       torch.stack([-cth, cth, -z0 * cth, -cth, cth,
                                    -z0 * cth], -1).flatten(-2)], -1),
            broadcast_shapes(lead, z0.shape[:-1], th.shape[:-1]))
        bparts.append(torch.stack([sth, -sth, z0 * sth, sth, -sth, z0 * sth],
                                  -1).flatten(-2))
        brows.append(engine.tl_tran_rows)
        bcols.append(engine._tl_other_cols)
    blead = broadcast_shapes(lead, *(p.shape[:-1] for p in bparts))
    bv = torch.cat([p.expand(blead + p.shape[-1:]) for p in bparts], -1)
    B = _scatter(engine, np.concatenate(brows), np.concatenate(bcols), bv,
                 blead)

    deg = math.pi / 180.0
    vph = params["vs_ac_phase"] * deg
    iph = params["is_ac_phase"] * deg
    vmag, imag_ = params["vs_ac_mag"], params["is_ac_mag"]
    ir, ii = imag_ * torch.cos(iph), imag_ * torch.sin(iph)
    rows = torch.as_tensor(np.concatenate([t.vs_k, engine.is_rhs_rows])
                           .astype(np.int64), device=dev)
    J = []
    for v, i in ((vmag * torch.cos(vph), ir), (vmag * torch.sin(vph), ii)):
        vals = torch.cat([v, torch.stack([-i, i], -1).flatten(-2)], -1)
        jlead = broadcast_shapes(blead, vals.shape[:-1])
        Jp = torch.zeros(jlead + (N + 1,), dtype=dtype, device=dev)
        Jp.index_add_(-1, rows, vals.expand(jlead + vals.shape[-1:]))
        J.append(Jp[..., :N])
    return G[..., :N, :N], B[..., :N, :N], J[0], J[1]


def ac_system(engine: Engine, params, x_op, omega):
    """Complex (Y, J) at angular frequency omega."""
    G, B, Jr, Ji = ac_system_real(engine, params, x_op, omega)
    return torch.complex(G, B), torch.complex(Jr, Ji)


def solve_ac_real(engine: Engine, G, B, br, bi):
    """Solve (G + jB)(xr + jxi) = br + jbi as the real 2N system
    [[G, -B], [B, G]] [xr; xi] = [br; bi] (the reference route; the pivoted
    real LU, K2 on CUDA tensors).  Returns (xr, xi)."""
    M = torch.cat([torch.cat([G, -B], -1), torch.cat([B, G], -1)], -2)
    x = lu_solve(M, torch.cat([br, bi], -1), engine.opts.lu_pivot_floor)
    N = G.shape[-1]
    return x[..., :N], x[..., N:]


def _make_solve_sweep(engine: Engine, params, x_op):
    """Per-frequency solver closure of the reference route.  Without
    T-lines the assembly is hoisted: every susceptance entry is linear in
    omega, so G, B1 and the RHS are built once and each frequency solves
    [[G, -wB1], [wB1, G]]; a T-line deck is assembled at each frequency
    (e^{-jwTD} is not linear in omega)."""
    if engine.n_tl:
        def solve_at(f):
            return solve_ac_real(engine, *ac_system_real(
                engine, params, x_op, 2.0 * math.pi * f))
        return solve_at
    G, B1, br, bi = ac_system_real(engine, params, x_op, 1.0)

    def solve_one(f):
        return solve_ac_real(engine, G, (2.0 * math.pi * f) * B1, br, bi)
    return solve_one


def _omegas(engine: Engine, freqs):
    f = torch.as_tensor(np.asarray(freqs, np.float64), dtype=engine.dtype,
                        device=engine.device)
    return f, 2.0 * math.pi * f


def _tline_sweep(engine: Engine, params, x_op, om, rhs=None,
                 transpose: bool = False):
    """The sweep of a T-line deck: (xr, xi), each lead + (F, N), where lead
    is the lanes' shape.  Every frequency is assembled on its own
    (``ac_system_real`` at omega) and the real 2N systems of a block of
    frequencies times every lane go to one ``solve_ac_real`` (K2 on CUDA
    tensors, ``lu_solve_large`` above its 64 unknowns); K3's hoisted
    G + wB1 does not hold for them.  ``rhs`` = (br,
    bi), each lead + (N,), replaces the assembled sources at every
    frequency; ``transpose`` solves Y^T instead of Y (the adjoint)."""
    N = engine.N
    first = ac_system_real(engine, params, x_op, om[0])
    lanes = first[0].numel() // (N * N)
    if rhs is not None:
        lanes = max(lanes, rhs[0].numel() // N)
    blk = max(1, _TL_BLOCK_ELEMS // (4 * N * N * lanes))
    xr, xi = [], []
    for f0 in range(0, len(om), blk):
        systems = [first if f == 0 else
                   ac_system_real(engine, params, x_op, om[f])
                   for f in range(f0, min(f0 + blk, len(om)))]
        G, B, br, bi = (torch.stack([sy[q] for sy in systems], -3 + (q > 1))
                        for q in range(4))
        if rhs is not None:
            lead = broadcast_shapes(G.shape[:-2], rhs[0].shape[:-1] + (1,))
            G, B = G.expand(lead + (N, N)), B.expand(lead + (N, N))
            br, bi = (b.unsqueeze(-2).expand(lead + (N,)) for b in rhs)
        if transpose:
            G, B = G.mT, B.mT
        r, i = solve_ac_real(engine, G, B, br, bi)
        xr.append(r)
        xi.append(i)
    return torch.cat(xr, -2), torch.cat(xi, -2)


@torch.inference_mode()
def rhs_sweep(engine: Engine, params, x_op, om, b, transpose: bool = False):
    """Y(w) x = b (or Y(w)^T x = b, ``transpose``) over every omega of
    ``om`` for one lane's params and operating point, with real right-hand
    sides that do not depend on w: b (..., N), each leading index one
    system.  Returns (xr, xi), each (..., F, N).  Without T-lines this is
    one K3 launch (every right-hand side a lane of the unit-w G and B1); a
    T-line deck takes ``_tline_sweep`` (K2)."""
    N = engine.N
    zero = torch.zeros_like(b)
    if engine.n_tl:
        return _tline_sweep(engine, params, x_op, om, rhs=(b, zero),
                            transpose=transpose)
    G, B1, _, _ = ac_system_real(engine, params, x_op, 1.0)
    if transpose:
        G, B1 = G.mT, B1.mT
    n = b.numel() // N
    xr, xi = ac_sweep(G.expand(n, N, N), B1.expand(n, N, N),
                      b.reshape(n, N), zero.reshape(n, N), om,
                      engine.opts.lu_pivot_floor)
    lead = b.shape[:-1]
    return (xr.reshape(lead + xr.shape[-2:]),
            xi.reshape(lead + xi.shape[-2:]))


def _d_omega(engine: Engine, params, x_op, om):
    """(dG/dw, dB/dw) of a T-line deck at every omega of ``om``, each
    (F, N, N): forward-mode AD (``torch.func.jvp``) of the per-frequency
    assembly in omega."""
    def gb(w):
        G, B, _, _ = ac_system_real(engine, params, x_op, w)
        return G, B

    one = torch.ones((), dtype=engine.dtype, device=engine.device)
    ds = [torch.func.jvp(gb, (w,), (one,))[1] for w in om]
    return (torch.stack([d[0] for d in ds]), torch.stack([d[1] for d in ds]))


def group_delay(engine: Engine, params, x_op, om, eq: int):
    """Exact group delay tau(w) = -d arg x_eq / dw, (F,) on the engine's
    device.  With Y x = b and Y^T z = e_eq (b does not depend on w),
    dx_eq/dw = -z^T (dY/dw) x, and tau = -Im((dx_eq/dw) / x_eq).  Without
    T-lines dY/dw = j B1: the forward and the adjoint sweep are two K3
    launches.  A T-line deck takes dY/dw from forward-mode AD of its
    per-frequency assembly and solves both systems on K2."""
    e = torch.zeros((engine.N,), dtype=engine.dtype, device=engine.device)
    e[eq] = 1.0
    with torch.inference_mode():
        if engine.n_tl:
            xr, xi = _tline_sweep(engine, params, x_op, om)
            zr, zi = _tline_sweep(engine, params, x_op, om,
                                  rhs=(e, torch.zeros_like(e)),
                                  transpose=True)
        else:
            floor = engine.opts.lu_pivot_floor
            G, B1, br, bi = ac_system_real(engine, params, x_op, 1.0)
            (xr,), (xi,) = ac_sweep(G[None], B1[None], br[None], bi[None],
                                    om, floor)
            (zr,), (zi,) = ac_sweep(G.mT[None], B1.mT[None], e[None],
                                    torch.zeros_like(e)[None], om, floor)
    if engine.n_tl:
        # outside inference mode: forward-mode AD records tangents
        dG, dB = _d_omega(engine, params, x_op, om)
    else:
        dG, dB = torch.zeros_like(B1), B1

    def mv(M, v):
        return (M @ v.unsqueeze(-1)).squeeze(-1)

    # w = (dY/dw) x with dY/dw = dG + j dB; s = z^T w = -dx_eq/dw
    wr, wi = mv(dG, xr) - mv(dB, xi), mv(dG, xi) + mv(dB, xr)
    sr = (zr * wr - zi * wi).sum(-1)
    si = (zr * wi + zi * wr).sum(-1)
    x_r, x_i = xr[:, eq], xi[:, eq]
    return (si * x_r - sr * x_i) / (x_r * x_r + x_i * x_i)      # Im(s/x)


def make_ac_batched_fn(engine: Engine, freqs):
    """fn(bparams, x_ops) -> (xr, xi), each (B, F, N) on the engine's
    device: the unit-omega (G, B1, br, bi) of every lane assembled once,
    then one K3 sweep over all (lane, frequency) systems; a T-line deck
    takes the per-frequency route (``_tline_sweep``, K2)."""
    _, om = _omegas(engine, freqs)

    @torch.inference_mode()
    def fn(bparams, x_ops):
        if engine.n_tl:
            return _tline_sweep(engine, bparams, x_ops, om)
        G, B1, br, bi = ac_system_real(engine, bparams, x_ops, 1.0)
        return ac_sweep(G, B1, br, bi, om, engine.opts.lu_pivot_floor)

    return fn


def ac_analysis(engine: Engine, params, freqs,
                x_op: Optional[Any] = None) -> ACResult:
    """Run the AC sweep of one lane (K3, or the per-frequency route of a
    T-line deck); returns ACResult with complex (F, N) solutions, composed
    on the host."""
    if x_op is None:
        x_op = dc_operating_point(engine, params)
    f, om = _omegas(engine, freqs)
    with torch.inference_mode():
        if engine.n_tl:
            xr, xi = (a[None] for a in _tline_sweep(engine, params, x_op, om))
        else:
            G, B1, br, bi = ac_system_real(engine, params, x_op, 1.0)
            xr, xi = ac_sweep(G[None], B1[None], br[None], bi[None], om,
                              engine.opts.lu_pivot_floor)
    xs = xr[0].cpu().numpy() + 1j * xi[0].cpu().numpy()
    return ACResult(freqs=f.cpu().numpy(), xs=xs)


def ac_analysis_batched(engine: Engine, bparams, freqs,
                        x_ops: Optional[Any] = None) -> ACResult:
    """Monte-Carlo AC: the whole (lanes x frequencies) sweep as one K3
    call.  ``bparams`` carries a leading lane axis; x_ops (B, N) defaults
    to the natively batched DC operating points.  Returns ACResult with xs
    of shape (B, F, N)."""
    if x_ops is None:
        from ..parallel.montecarlo import batched_dc_fast
        x_ops = batched_dc_fast(engine, bparams)
    f, _ = _omegas(engine, freqs)
    xr, xi = make_ac_batched_fn(engine, freqs)(bparams, x_ops)
    xs = xr.cpu().numpy() + 1j * xi.cpu().numpy()
    return ACResult(freqs=f.cpu().numpy(), xs=xs)


def write_ac_csv(path: str, topo, result: ACResult, selection=None) -> None:
    """CSV schema: freq, then VM(node)/VP(node) (magnitude, phase in deg) for
    every node-voltage column, then IM/IP for branch currents.  `selection`
    (e.g. the .PRINT AC probes) restricts and orders the columns;
    differential V(a,b) probes subtract the complex phasors before taking
    magnitude/phase."""
    freqs = np.asarray(result.freqs)
    xs = np.asarray(result.xs)
    if selection is None:
        selection = [(f"V({n})", int(e)) for n, e in
                     zip(topo.volt_col_names, topo.volt_col_eqs)]
        selection += [(f"I({n})", int(e)) for n, e in
                      zip(topo.branch_col_names, topo.branch_col_eqs)]

    def phasor(row, spec):
        if isinstance(spec, tuple):
            a = row[spec[0]] if spec[0] >= 0 else 0.0
            b = row[spec[1]] if spec[1] >= 0 else 0.0
            return a - b
        return row[spec] if spec >= 0 else 0.0

    cols = []
    for label, _ in selection:
        inner = label[label.find("(") + 1:label.rfind(")")] \
            if "(" in label else label
        kind = "I" if label.startswith("I(") else "V"
        cols += [f"{kind}M({inner})", f"{kind}P({inner})"]
    with open(path, "w") as f:
        f.write("freq," + ",".join(cols) + "\n")
        for fi, row in zip(freqs, xs):
            vals = []
            for _, spec in selection:
                v = phasor(row, spec)
                vals += [f"{abs(v):.9e}", f"{np.degrees(np.angle(v)):.9e}"]
            f.write(f"{fi:.9e}," + ",".join(vals) + "\n")
