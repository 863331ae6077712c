"""Small-signal AC analysis (the ``.AC lin|dec|oct n fstart fstop`` card);
port of ``circuitsimulator_tpu/analysis/ac.py``.

1. solve the DC operating point;
2. linearize every nonlinear device there (the conductances of the Newton
   stamp, ``Engine._nl_vals``);
3. for each frequency solve Y(w) X = J with
     R: 1/R          C (and the MOS junction caps): jwC
     L: branch rows +/-1 with Y[k,k] = -jwL
     V: branch rows +/-1, J[k] = acMag e^{j phase}
     I: J[p] -= Iac, J[m] += Iac
     E/G/F/H: their static stamps;    MOS: DC-point conductances.

Every reactive entry is linear in w, so G, the unit-w susceptance B1 and
the RHS are assembled once per lane and the K3 sweep
(``ops/ac_sweep.ac_sweep``: the CUDA kernel on the card, its plain version
on the CPU) forms and solves every (lane, w) system.  One lane and many take
the same route, in every dtype.  ``solve_ac_real`` keeps the JAX CPU route,
the real 2N system [[G, -B], [B, G]], as a reference.

Devices whose AC stamps the port has not ported raise NotImplementedError:
transmission lines, mutual inductance, MOSCAP=CHARGE (B sources are refused
at lowering).  Sweep conventions: lin = n points total; dec = n points per
decade; oct = n points per octave (endpoints included).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..ops.ac_sweep import ac_sweep
from ..ops.assemble import Engine, _two_terminal_vals
from ..ops.lu import lu_solve
from .dc import dc_operating_point


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


def _check_ac_scope(engine: Engine) -> None:
    """Refuse, by name, devices whose AC stamps are not ported, so that an
    Engine that admits them (a later transient slice) cannot have them
    silently dropped here."""
    counts = engine.topo.counts
    if counts["T"]:
        raise NotImplementedError("transmission line (T) in AC: not yet "
                                  "ported")
    if counts["K"]:
        raise NotImplementedError("mutual inductance (K) in AC: not yet "
                                  "ported")
    if engine.opts.mos_cap_model != "fixed":
        raise NotImplementedError("MOSCAP=CHARGE in AC: not yet ported")


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
    _check_ac_scope(engine)
    t = engine.topo
    N = engine.N
    dtype, dev = engine.dtype, engine.device
    omega = torch.as_tensor(omega, dtype=dtype, device=dev)
    gvals, _ = engine._nl_vals(params, x_op)
    parts = [engine._res_vals(params), engine.dc_const_vals,
             engine._ctrl_vals(params), gvals]
    lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    gv = torch.cat([p.expand(lead + p.shape[-1:]) for p in parts], -1)
    G = _scatter(engine,
                 np.concatenate([engine.res_rows, engine.dc_const_rows,
                                 engine.ctrl_rows, engine.nl_rows]),
                 np.concatenate([engine.res_cols, engine.dc_const_cols,
                                 engine.ctrl_cols, engine.nl_cols]), gv, lead)
    C = engine._caplike_C(params)
    L = params["ind_l"]
    bparts = [_two_terminal_vals(omega * C), -omega * L]
    blead = torch.broadcast_shapes(lead, *(p.shape[:-1] for p in bparts))
    bv = torch.cat([p.expand(blead + p.shape[-1:]) for p in bparts], -1)
    B = _scatter(engine, np.concatenate([engine.cap_rows, t.ind_k]),
                 np.concatenate([engine.cap_cols, t.ind_k]), bv, blead)

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
        jlead = torch.broadcast_shapes(blead, vals.shape[:-1])
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
    """Per-frequency solver closure of the reference route, with the
    assembly hoisted: every susceptance entry is linear in omega, so G,
    B1 and the RHS are built once and each frequency solves
    [[G, -wB1], [wB1, G]]."""
    G, B1, br, bi = ac_system_real(engine, params, x_op, 1.0)

    def solve_one(f):
        return solve_ac_real(engine, G, (2.0 * math.pi * f) * B1, br, bi)
    return solve_one


def _omegas(engine: Engine, freqs):
    f = torch.as_tensor(np.asarray(freqs, np.float64), dtype=engine.dtype,
                        device=engine.device)
    return f, 2.0 * math.pi * f


def make_ac_batched_fn(engine: Engine, freqs):
    """fn(bparams, x_ops) -> (xr, xi), each (B, F, N) on the engine's
    device: the unit-omega (G, B1, br, bi) of every lane assembled once,
    then one K3 sweep over all (lane, frequency) systems."""
    _, om = _omegas(engine, freqs)

    @torch.inference_mode()
    def fn(bparams, x_ops):
        G, B1, br, bi = ac_system_real(engine, bparams, x_ops, 1.0)
        return ac_sweep(G, B1, br, bi, om, engine.opts.lu_pivot_floor)

    return fn


def ac_analysis(engine: Engine, params, freqs,
                x_op: Optional[Any] = None) -> ACResult:
    """Run the AC sweep of one lane; returns ACResult with complex (F, N)
    solutions, composed on the host."""
    if x_op is None:
        x_op = dc_operating_point(engine, params)
    f, om = _omegas(engine, freqs)
    with torch.inference_mode():
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
