"""Monte-Carlo batching: thousands of parameter lanes of one topology.

Port of the batched main path of ``circuitsimulator_tpu/parallel/
montecarlo.py`` and of the transient loop of ``bench.py``: parameters carry
a leading lane axis written out (no vmap); the DC Newton loop and every
dense solve run over all lanes at once (the K2 kernel on CUDA).  A
waveform-free f32 transient on CUDA takes the fused chunk kernel (K1,
``ops/fused_step.py``) when the deck is in its scope (R/C/L, sources, E/G/F/H,
Level-1 MOS with the fixed or the charge-conserving caps, JFET, diode, BJT,
S/W switch, B sources, transmission lines; Woodbury rank <= 32, so inamp.sp
and MOSCAP=CHARGE decks up to five MOSFETs run fused).  Under MOSCAP=CHARGE
the non-fused carry's state holds the MOS charges qm; with T-lines the
state holds their delay ring tlw, and the fused carry takes it as a sixth
element, threaded through every K1 launch (K1c-ii).  On a TRNOISE deck a
``noise_key`` turns the noise on: it is split into one key per lane (as the
JAX package splits it), the non-fused loop draws each step's values in the
state, and the fused path feeds every K1 launch the chunk's noise block from
``Engine.trnoise_stream`` (K1c-iii), its flicker banks the last element of
the fused carry.  A deck with a .NODESET card starts
its lanes as ``benchmarks/bench_inamp.py`` does: the nominal DC with the
card (``Simulator.dc``), then ``batched_dc_warm``; ``batched_dc_fast`` takes
the card too (``nodeset=``).

The measurement entries (``batched_transient_measures``,
``batched_ac_measures``) give per-lane ``.MEASURE`` results without a
(B, T, N) waveform: on the fused path K1 streams the probe values of every
step (K1c-i) into the accumulators of ``analysis/measure_stream.py``.
``perturb_params_netlist`` draws the lanes of the deck's DEV=/LOT=
tolerances.  ``normal_draws`` holds the sampling plans (mc, lhs, sobol,
antithetic) and ``_z_layout`` the joint z-space of a ``rel_sigma`` map,
which ``yield_analysis`` (plain and importance-sampled yield),
``sobol_indices`` and ``analysis/form.py`` share.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..analysis.dc import dc_newton, dc_operating_point
from ..analysis.transient import (TransientResult, n_steps_for, run_transient,
                                  transient_step_fn)
from ..ops import fused_step
from ..ops.assemble import Engine
from ..utils import prng


def broadcast_params(params: Dict[str, torch.Tensor],
                     batch: int) -> Dict[str, torch.Tensor]:
    """Tile every parameter leaf to a leading lane axis."""
    return {k: v.expand((batch,) + v.shape) for k, v in params.items()}


def sobol_normals(seed: int, batch: int, dims: int) -> np.ndarray:
    """(batch, dims) float32 normals of a scrambled Sobol sequence seeded
    with the integer ``seed`` (scipy.stats.qmc on the host): the inverse
    CDF in float64 of u clipped to [1e-12, 1 - 1e-12] (the Sobol grid is
    2^-30-spaced, so u can sit within float32 rounding of 1.0), then the
    cast."""
    import warnings
    from scipy.special import ndtri
    from scipy.stats import qmc
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")             # non-2^k batch note
        u = qmc.Sobol(d=dims, scramble=True, seed=seed).random(batch)
    return ndtri(np.clip(u, 1e-12, 1.0 - 1e-12)).astype(np.float32)


def normal_draws(generator: torch.Generator, batch: int, dims: int,
                 sampler: str = "mc") -> torch.Tensor:
    """(batch, dims) standard-normal draws under a sampling plan, on the
    generator's device:

      "mc"         independent draws (float64);
      "antithetic" mirrored pairs: lane i and lane (batch + 1) // 2 + i
                   carry z and -z (float64);
      "lhs"        Latin hypercube (float32): each column's values fall in
                   distinct equiprobable strata (a random permutation of
                   the strata, from the argsort of uniforms, jittered
                   uniformly inside each), mapped through the normal
                   inverse CDF of p clipped to [1e-6, 1 - 1e-6] (float32
                   rounding can land p on 0 or 1);
      "sobol"      scrambled Sobol low-discrepancy points (float32,
                   ``sobol_normals``), seeded with an integer drawn from
                   the generator; best balanced at a power-of-two batch.

    Every plan has N(0, 1) marginals; only the joint layout across the
    batch differs."""
    dev = generator.device
    if sampler == "mc":
        return torch.randn((batch, dims), generator=generator,
                           dtype=torch.float64, device=dev)
    if sampler == "antithetic":
        half = (batch + 1) // 2
        z = torch.randn((half, dims), generator=generator,
                        dtype=torch.float64, device=dev)
        return torch.cat([z, -z], 0)[:batch]
    if sampler == "lhs":
        perm = torch.argsort(torch.rand((dims, batch), generator=generator,
                                        device=dev), dim=1)
        u = torch.rand((dims, batch), generator=generator, device=dev)
        p = (perm.to(torch.float32) + u) / batch
        return torch.special.ndtri(p.clamp(1e-6, 1.0 - 1e-6)).T
    if sampler == "sobol":
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=dev))
        return torch.as_tensor(sobol_normals(seed, batch, dims), device=dev)
    raise ValueError(f"unknown sampler {sampler!r}; expected "
                     "'mc' | 'lhs' | 'sobol' | 'antithetic'")


def _z_layout(params, rel_sigma):
    """Column layout of the joint z-space: the perturbable names in sorted
    order, one column per scalar of each leaf.  Returns (names, sizes,
    dims)."""
    names = [n for n in sorted(rel_sigma)
             if n in params and params[n].is_floating_point()
             and params[n].numel()]
    sizes = [int(params[n].numel()) for n in names]
    return names, sizes, sum(sizes)


def _z_columns(params, names, sizes, Z, off: int = 0):
    """{name: its block of Z's columns from ``off`` on, shaped (batch,) +
    the leaf's shape}, in the _z_layout order."""
    cols = {}
    for n, sz in zip(names, sizes):
        cols[n] = Z[:, off:off + sz].reshape((Z.shape[0],) + params[n].shape)
        off += sz
    return cols


def _params_from_Z(params, rel_sigma, Z):
    """The lognormal mismatch map p * exp(sigma z) of a (batch, dims) z
    matrix in the _z_layout column order; other leaves are broadcast."""
    names, sizes, _ = _z_layout(params, rel_sigma)
    cols = _z_columns(params, names, sizes, Z)
    out = broadcast_params(params, Z.shape[0])
    for name, col in cols.items():
        arr = params[name]
        out[name] = arr[None] * torch.exp(rel_sigma[name]
                                          * col.to(arr.dtype))
    return out


def perturb_params(params: Dict[str, torch.Tensor], generator: torch.Generator,
                   batch: int, rel_sigma: Mapping[str, float],
                   sampler: str = "mc") -> Dict[str, torch.Tensor]:
    """Lognormal lanes p * exp(sigma * z); parameters not in ``rel_sigma``
    are broadcast unperturbed.  "mc" draws z ~ N(0, 1) from ``generator``
    (on the parameters' device) leaf by leaf in sorted-name order, in the
    leaf's dtype; the other plans (``normal_draws``) make every scalar of
    every named leaf one column of a joint (batch, dims) draw in the
    _z_layout order."""
    if sampler != "mc":
        _, _, dims = _z_layout(params, rel_sigma)
        Z = normal_draws(generator, batch, max(dims, 1), sampler)[:, :dims]
        return _params_from_Z(params, rel_sigma, Z)
    out = broadcast_params(params, batch)
    for name in sorted(rel_sigma):
        arr = params.get(name)
        if arr is None or not (arr.is_floating_point() and arr.numel()):
            continue
        z = torch.randn((batch,) + arr.shape, generator=generator,
                        dtype=arr.dtype, device=arr.device)
        out[name] = arr[None] * torch.exp(rel_sigma[name] * z)
    return out


def perturb_params_netlist(params: Dict[str, torch.Tensor],
                           generator: torch.Generator, batch: int,
                           mc_tols: Mapping[str, Any],
                           sampler: str = "mc") -> Dict[str, torch.Tensor]:
    """Lanes from the netlist's DEV=/LOT= tolerances
    (``LoweredCircuit.mc_tols``): value * exp(dev * z_dev + lot * z_lot),
    z_dev drawn per device per lane and z_lot ONE draw per lane shared by
    every element with a LOT tolerance (same production lot).  "mc" draws
    from ``generator`` (on the parameters' device) z_lot (batch, 1) in
    float64, then z_dev per leaf in sorted-name order in the leaf's dtype.
    The other plans stratify one joint draw (``normal_draws``): the shared
    lot dimension is column 0, the per-device columns follow in the
    _z_layout order."""
    out = broadcast_params(params, batch)
    if sampler != "mc":
        names, sizes, ndev = _z_layout(params, mc_tols)
        Z = normal_draws(generator, batch, 1 + ndev, sampler)
        lot_z = Z[:, :1]
        cols = _z_columns(params, names, sizes, Z, off=1)
    else:
        dev = next(iter(params.values())).device
        lot_z = torch.randn((batch, 1), generator=generator,
                            dtype=torch.float64, device=dev)
        cols = {}
        for name in sorted(mc_tols):
            arr = params[name]
            if arr.is_floating_point() and arr.numel():
                cols[name] = torch.randn((batch,) + arr.shape,
                                         generator=generator,
                                         dtype=arr.dtype, device=arr.device)
    for name, z in cols.items():
        arr = params[name]
        dtol, ltol = (torch.as_tensor(np.asarray(v), dtype=arr.dtype,
                                      device=arr.device)
                      for v in mc_tols[name])
        out[name] = arr[None] * torch.exp(dtol * z.to(arr.dtype)
                                          + ltol * lot_z.to(arr.dtype))
    return out


def lane_count(bparams: Dict[str, torch.Tensor]) -> int:
    return next(iter(bparams.values())).shape[0]


def batched_dc_fast(engine: Engine, bparams, nodeset=None):
    """Natively batched DC operating point (B, N): one Newton loop with
    per-lane masks, every iteration's solve batched over all lanes, by the
    engine's ``dc_solver`` (a large circuit's sparse solve takes the lanes
    too; the JAX function always takes the dense LU).
    nodeset: the (eqs, vals) Newton aid of ``Simulator._nodeset()``."""
    return dc_operating_point(engine, bparams, nodeset=nodeset,
                              batch=lane_count(bparams))


def batched_dc_warm(engine: Engine, bparams, x_nom):
    """Monte-Carlo DC from the nominal operating point ``x_nom``: every
    lane warm-starts there and runs only the final (scale = 1) Newton
    step, not the whole source ramp.  Same tolerance and gmin schedule at
    scale 1 as ``batched_dc_fast``; the trajectories differ."""
    if not engine.topo.has_nonlinear:
        return dc_operating_point(engine, bparams, batch=lane_count(bparams))
    return dc_newton(engine, bparams, batch=lane_count(bparams),
                     x_init=x_nom, final_only=True)


def init_carry(engine: Engine, x0, bparams=None, dt=None):
    """Transient carry of the batched loop from a (B, N) DC solution (the
    charge model needs ``bparams`` for the charges at x0, T-lines
    ``bparams`` and the timestep ``dt`` for their delay ring)."""
    failed = torch.zeros(x0.shape[:-1], dtype=torch.bool, device=x0.device)
    state = engine.init_state(x0, bparams, dt)
    if engine.opts.tran_predictor:
        return (x0, x0, state, failed)
    return (x0, state, failed)


@torch.inference_mode()
def batched_transient_chunk(engine: Engine, bparams, carry, ts, dt,
                            record_lane: Optional[int] = None):
    """Advance every lane through the times ``ts`` (the bench.py chunk loop).

    Keeps no waveform memory: returns (carry, iters) with iters the (B,)
    Newton iterations summed over the chunk, plus, when ``record_lane`` is
    given, that one lane's (len(ts), N) trajectory."""
    step = transient_step_fn(engine, bparams, dt,
                             predictor=engine.opts.tran_predictor)
    iters = torch.zeros(carry[-1].shape, dtype=torch.int32,
                        device=carry[-1].device)
    rec = None
    if record_lane is not None:
        rec = torch.empty((len(ts), engine.N), dtype=engine.dtype,
                          device=carry[0].device)
    for i in range(len(ts)):
        carry, (x, it) = step(carry, ts[i])
        iters += it
        if rec is not None:
            rec[i] = x[record_lane]
    if rec is not None:
        return carry, iters, rec
    return carry, iters


class NoiseFeed:
    """The TRNOISE input of the fused chunks (K1c-iii): one key per lane,
    split from ``noise_key`` as JAX's ``jax.random.split(noise_key, B)``,
    the rows of the noisy sources (V then I, the kernel's source order),
    and for each chunk its (n, nN, B) noise block from
    ``Engine.trnoise_stream``.  The flicker banks (fv, fi) of the step
    before a chunk are the last element of the fused carry (None without
    flicker)."""

    def __init__(self, engine: Engine, bparams, noise_key, dt: float):
        self.engine, self.bparams, self.dt = engine, bparams, dt
        self.keys = lane_keys(engine, bparams, noise_key)
        nV = len(engine.topo.vs_ep)
        self.idx = np.concatenate([engine.vs_noisy, nV + engine.is_noisy])
        self.nv = torch.as_tensor(engine.vs_noisy, device=engine.device)
        self.ni = torch.as_tensor(engine.is_noisy, device=engine.device)
        self.banks0 = (None, None)

    def block(self, banks, step0: int, n: int):
        """(noise (n, nN, B), the banks after the chunk)."""
        tnv, tni, fv, fi = self.engine.trnoise_stream(
            self.bparams, self.keys, step0, n, self.dt, *banks)
        nz = torch.cat([tnv[..., self.nv], tni[..., self.ni]], -1)
        return nz.transpose(1, 2).contiguous(), (fv, fi)


def make_fused_transient_fn(engine: Engine, bparams, tstep, chunk: int = 2000,
                            x0=None, noise_key=None):
    """Set up the fused-kernel batched transient: the per-lane constants
    of the chunk kernel (NotImplementedError, naming the cause, for a deck
    outside its scope), the batched DC (K2 on CUDA) unless the (B, N)
    operating points ``x0`` are given, and
    ``advance(carry, step0, n=chunk) -> (carry, iters)``, which runs one
    chunk of n steps from step index step0 (iters (B,) int32).
    Returns (carry0, advance, meta); carry = (x, x_prev, vc, il, failed),
    and for a T-line deck its delay ring (B, Dmax, 2 nT) as a sixth
    element.  ``noise_key`` on a TRNOISE deck makes the run noisy
    (``NoiseFeed``; the carry's last element is then the flicker banks,
    and the chunk is cut to the noise block's budget,
    ``fused_step.noise_chunk``)."""
    dt = float(tstep)
    feed = None
    if noise_key is not None and engine.has_trnoise:
        feed = NoiseFeed(engine, bparams, noise_key, dt)
        chunk = fused_step.noise_chunk(chunk, len(feed.idx),
                                       lane_count(bparams), engine.dtype)
    runner = fused_step.FusedStepRunner(
        engine, bparams, dt, noise_idx=None if feed is None else feed.idx)
    if x0 is None:
        x0 = batched_dc_fast(engine, bparams)
    x0 = x0.to(engine.dtype)
    state0 = engine.init_state(x0, bparams, dt)

    def advance(carry, step0: int, n: int = chunk):
        out = run_fused_chunk(runner, carry, step0, n, feed)
        return out[0], out[1]

    failed0 = torch.zeros((runner.B,), dtype=torch.bool, device=x0.device)
    carry0 = (x0, x0, state0["vc"], state0["il"], failed0)
    if runner.nT:
        carry0 += (state0["tlw"],)
    if feed is not None:
        carry0 += (feed.banks0,)
    return carry0, advance, {"chunk": chunk, "runner": runner, "feed": feed}


def run_fused_chunk(runner, carry, step0: int, n: int, feed=None):
    """One K1 launch on a fused carry (five tensors, plus the delay ring
    of a T-line deck, plus the flicker banks of a noisy run, whose noise
    block ``feed`` draws): (carry, iters, ys or None)."""
    tlw = carry[5] if runner.nT else None
    nz = banks = None
    if feed is not None:
        nz, banks = feed.block(carry[-1], step0, n)
    out = runner.run_chunk(*carry[:5], step0, n, tlw=tlw, noise=nz)
    ys = out[6] if runner.probe_mat is not None else None
    new = out[:5] + ((out[-1],) if runner.nT else ())
    if feed is not None:
        new += (banks,)
    return new, out[5], ys


def _fused_batched_transient(engine: Engine, bparams, tstep, tstop,
                             x0=None, noise_key=None) -> TransientResult:
    """Waveform-free batched transient on the fused chunk kernel:
    newton_iters is the per-lane (B,) total over the run."""
    n_steps = n_steps_for(float(tstep), float(tstop))
    carry, advance, meta = make_fused_transient_fn(engine, bparams, tstep,
                                                   x0=x0,
                                                   noise_key=noise_key)
    chunk = meta["chunk"]
    total = torch.zeros_like(carry[4], dtype=torch.int32)
    for s in range(0, n_steps, chunk):
        carry, iters = advance(carry, s, min(chunk, n_steps - s))
        total += iters
    dt = torch.tensor(float(tstep), dtype=engine.dtype, device=engine.device)
    ts = torch.arange(1, n_steps + 1, dtype=engine.dtype,
                      device=engine.device) * dt
    return TransientResult(times=ts, xs=None, x_final=carry[0],
                           newton_iters=total, failed=carry[4],
                           n_steps=n_steps)


def batched_transient(engine: Engine, bparams, tstep, tstop,
                      save_xs: bool = False, fused="auto",
                      x0=None, noise_key=None) -> TransientResult:
    """Transient of every lane (Backward Euler or trapezoidal, on the
    engine's ``tran_solver``: Woodbury, dense LU, or a large circuit's
    tridiag, blockband or blockwb with the lanes on the leading axis),
    from the batched DC point
    (or from the (B, N) operating points ``x0``, e.g. a float64 DC for a
    float32 run: the reference's damped DC Newton with its gmin stepping
    leaves about 1% of the lanes of a BJT deck unconverged in float32).

    fused="auto" takes the fused chunk kernel (K1) for a waveform-free
    (save_xs=False) float32 run on CUDA whose deck is in the kernel's
    scope (``fused_step.supported``: Backward Euler only, so a trapezoidal
    deck runs non-fused); anything else runs the non-fused
    loop, which keeps xs (n_steps + 1, B, N) when save_xs is set.
    fused=True forces the fused path: on CPU tensors it runs the kernel's
    plain version; an out-of-scope deck raises NotImplementedError naming
    what is out of scope.

    noise_key (a ``utils/prng`` key, (2,)): on a TRNOISE deck each lane
    gets its own realisation, lane b the key ``prng.split(noise_key,
    B)[b]``, as in the JAX package; omitted, the batch runs noise-free."""
    dt = float(tstep)
    if fused == "auto":
        fused = (not save_xs and engine.dtype == torch.float32
                 and engine.device.type == "cuda"
                 and fused_step.supported(engine, dt))
    if fused:
        if save_xs:
            raise ValueError("fused=True keeps no waveforms: save_xs=False")
        return _fused_batched_transient(engine, bparams, tstep, tstop, x0,
                                        noise_key=noise_key)
    if x0 is None:
        x0 = batched_dc_fast(engine, bparams)
    return run_transient(engine, bparams, tstep, tstop,
                         x0=x0.to(engine.dtype), save_xs=save_xs,
                         noise_key=lane_keys(engine, bparams, noise_key))


def lane_keys(engine: Engine, bparams, noise_key):
    """One noise key per lane (B, 2) from ``noise_key`` on a TRNOISE deck,
    else None."""
    if noise_key is None or not engine.has_trnoise:
        return None
    return prng.split(engine._key(noise_key), lane_count(bparams))


@torch.inference_mode()
def fused_transient_measures(engine: Engine, bparams, tstep, tstop, sm,
                             x0=None, chunk: int = 512, noise_key=None):
    """Streaming-measures transient stepped by the fused chunk kernel: each
    K1 launch also writes the (chunk, P, B) probe values of its steps
    (K1c-i, ``sm.probe_matrix``), which the accumulators of ``sm`` (a
    ``StreamingMeasures``) consume on the device; no (B, T, N) state
    history is ever kept.  The time axis is (step0 + arange(1, n + 1)) dt
    in the working dtype, as the JAX fused path builds it in float32.
    Failed lanes keep feeding their frozen x to the accumulators.  The
    deck must be in K1's scope (``fused_step.supported``; else
    NotImplementedError naming the cause); a T-line deck's delay ring
    rides the carry (K1c-ii); with ``noise_key`` a TRNOISE deck's lanes
    measure independent noise realisations (K1c-iii, ``NoiseFeed``; the
    chunk is cut to the noise block's budget).  Returns (TransientResult
    with xs None, {name: (B,)})."""
    dtype, dev = engine.dtype, engine.device
    dt = float(tstep)
    n_steps = n_steps_for(dt, float(tstop))
    feed = None
    if noise_key is not None and engine.has_trnoise:
        feed = NoiseFeed(engine, bparams, noise_key, dt)
        chunk = fused_step.noise_chunk(chunk, len(feed.idx),
                                       lane_count(bparams), dtype)
    runner = fused_step.FusedStepRunner(
        engine, bparams, dt, probe_mat=sm.probe_matrix,
        noise_idx=None if feed is None else feed.idx)
    if x0 is None:
        x0 = batched_dc_fast(engine, bparams)
    x0 = x0.to(dtype)
    state0 = engine.init_state(x0, bparams, dt)
    carry = (x0, x0, state0["vc"], state0["il"],
             torch.zeros((runner.B,), dtype=torch.bool, device=dev))
    if runner.nT:
        carry += (state0["tlw"],)
    if feed is not None:
        carry += (feed.banks0,)
    acc = sm.init(engine, x0)
    dt_t = torch.tensor(dt, dtype=dtype, device=dev)
    total = torch.zeros((runner.B,), dtype=torch.int32, device=dev)
    for s in range(0, n_steps, chunk):
        n = min(chunk, n_steps - s)
        carry, iters, raw = run_fused_chunk(runner, carry, s, n, feed)
        total += iters
        ys = sm.vals_from_raw(raw.transpose(1, 2))          # (n, B, P)
        ts = (float(s) + torch.arange(1, n + 1, dtype=dtype, device=dev)) * dt
        for i in range(n):
            acc = sm.update_vals(acc, ys[i], ts[i], dt_t)
    ts_all = torch.arange(1, n_steps + 1, dtype=dtype, device=dev) * dt
    res = TransientResult(times=ts_all, xs=None, x_final=carry[0],
                          newton_iters=total, failed=carry[4],
                          n_steps=n_steps)
    return res, sm.finalize(acc)


def batched_transient_measures(engine: Engine, bparams, tstep, tstop,
                               measures, topo, bindings=None, fused="auto",
                               x0=None, noise_key=None):
    """Batched transient with STREAMING .MEASURE evaluation: per-lane
    results with O(1) waveform memory (analysis/measure_stream.py).
    Returns (TransientResult with xs None, {measure_name: (B,) values}):
    tensors for the streamed measures, numpy for the derived PARAM= ones,
    which are evaluated on the host.

    fused="auto" takes the fused chunk kernel (K1 with its probe stream)
    under the conditions of ``batched_transient``: float32, CUDA, and a
    deck in its scope, with at most ``fused_step.MAX_PROBES`` distinct
    probes; True forces it (on CPU tensors K1's plain version; more probes
    raise NotImplementedError by name), False keeps the non-fused loop.  x0: the (B, N) operating
    points (default: the batched DC).  noise_key: on a TRNOISE deck every
    lane measures its own noise realisation (``batched_transient``)."""
    from ..analysis.measure_stream import (StreamingMeasures,
                                           apply_derived_measures,
                                           run_transient_streaming)
    sm = StreamingMeasures(measures, topo, engine.dtype, engine.device)
    if x0 is None:
        x0 = batched_dc_fast(engine, bparams)
    if fused == "auto":
        fused = (engine.dtype == torch.float32
                 and engine.device.type == "cuda"
                 and fused_step.supported(engine, float(tstep))
                 and sm.probe_matrix.shape[0] <= fused_step.MAX_PROBES)
    if fused:
        res, vals = fused_transient_measures(engine, bparams, tstep, tstop,
                                             sm, x0=x0, noise_key=noise_key)
    else:
        res, vals = run_transient_streaming(
            engine, bparams, tstep, tstop, sm, x0=x0.to(engine.dtype),
            noise_key=lane_keys(engine, bparams, noise_key))
    derived = [m for m in measures
               if m.analysis == "tran" and m.kind == "param"]
    if derived:
        host = apply_derived_measures(
            measures, {k: v.cpu().numpy() for k, v in vals.items()},
            bindings=bindings)
        vals = {**vals, **{m.name: host[m.name] for m in derived}}
    return res, vals


def batched_ac_measures(engine: Engine, topo, bparams, freqs, measures,
                        bindings=None, x_ops=None):
    """``.MEASURE AC`` cards per lane over one batched lanes x frequencies
    sweep (K3 on CUDA), evaluated on the host.  Returns {name: (B,) numpy}
    for the AC measures."""
    from ..analysis.ac import ac_analysis_batched
    from ..analysis.measure import run_measures
    res = ac_analysis_batched(engine, bparams, freqs, x_ops=x_ops)
    fr = np.asarray(freqs)
    rows = [dict(run_measures(measures, topo, fr, lane_xs, "ac",
                              bindings=bindings)) for lane_xs in res.xs]
    return {m.name: np.asarray([r[m.name] for r in rows])
            for m in measures if m.analysis == "ac"}


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _lane_measures(engine: Engine, topo, bparams, measures, tstep, tstop,
                   analysis: str, freqs, bindings):
    """Per-lane measures {name: (B,) numpy} and the failed mask (B,): the
    streaming transient (K1 with its probe stream on a float32 CUDA run of
    a deck in its scope), or for analysis="ac" one lanes x frequencies
    sweep (K3) with the ``.MEASURE AC`` cards evaluated per lane on the
    host (no lane fails there)."""
    B = lane_count(bparams)
    if analysis == "ac":
        if freqs is None:
            raise ValueError("analysis='ac' needs freqs")
        vals = batched_ac_measures(engine, topo, bparams, freqs, measures,
                                   bindings=bindings)
        return vals, np.zeros(B, dtype=bool)
    res, vals = batched_transient_measures(engine, bparams, tstep, tstop,
                                           measures, topo)
    return {k: _host(v) for k, v in vals.items()}, _host(res.failed)


def yield_analysis(engine: Engine, topo, params, generator: torch.Generator,
                   batch: int, rel_sigma: Mapping[str, float], measures,
                   specs, tstep, tstop, sampler: str = "mc",
                   sigma_scale: float = 1.0, shift=None,
                   analysis: str = "tran", freqs=None, bindings=None):
    """Monte-Carlo yield, waveform-free: ``batch`` lognormal lanes
    (``rel_sigma``, drawn from ``generator`` under ``sampler``), the
    streaming ``.MEASURE`` run, and each lane scored against ``specs``
    {measure: (low, high)} (either bound None; a NaN measure fails, and
    so does a failed lane).  Returns a dict: pass (B,), measures, n,
    params (the lanes), failed, yield and its 95% Wilson interval ci95.

    sigma_scale > 1 (scaled-sigma importance sampling) draws z ~ N(shift,
    sigma_scale^2) (shift: a dims-long vector in the _z_layout order,
    e.g. ``form.mpp_search``'s z_star, for MPP-centred IS) and weights
    each lane by the likelihood ratio of N(0, 1)^dims over the sampling
    density, computed on the host in float64; p_fail is then the weighted
    mean of the failures, with p_fail_se, the normal-approximation ci95,
    the weights and n_eff = (sum of the failing weights)^2 / (sum of their
    squares).  analysis="ac" scores ``.MEASURE AC`` cards on the batched
    small-signal sweep at ``freqs`` (tstep, tstop ignored)."""
    if sigma_scale != 1.0 or shift is not None:
        _, _, dims = _z_layout(params, rel_sigma)
        Z = normal_draws(generator, batch, max(dims, 1), sampler)[:, :dims]
        mu = (torch.zeros((dims,), dtype=Z.dtype, device=Z.device)
              if shift is None else
              torch.as_tensor(_host(shift), dtype=Z.dtype,
                              device=Z.device).reshape(dims))
        Y = mu[None, :] + sigma_scale * Z
        bparams = _params_from_Z(params, rel_sigma, Y)
        # log-likelihood ratio of N(0, 1)^dims over N(mu, s^2)^dims at y:
        # sum_j [log s - y_j^2 / 2 + (y_j - mu_j)^2 / (2 s^2)]
        s = sigma_scale
        Yn, mun = _host(Y), _host(mu)
        logw = (dims * math.log(s) - (Yn ** 2).sum(axis=1) / 2.0
                + ((Yn - mun[None, :]) ** 2).sum(axis=1) / (2.0 * s * s))
        weights = np.exp(logw)
    else:
        bparams = perturb_params(params, generator, batch, rel_sigma,
                                 sampler=sampler)
        weights = None
    vals, failed = _lane_measures(engine, topo, bparams, measures, tstep,
                                  tstop, analysis, freqs, bindings)
    ok = np.ones(batch, dtype=bool)
    for name, (low, high) in specs.items():
        v = np.asarray(vals[name])
        m = np.isfinite(v)
        if low is not None:
            m &= v >= low
        if high is not None:
            m &= v <= high
        ok &= m
    ok &= ~failed
    n = batch
    z = 1.959963984540054          # 95%
    out = {"pass": ok, "measures": vals, "n": n, "params": bparams,
           "failed": failed}
    if weights is None:
        p = float(ok.mean())
        den = 1 + z * z / n
        center = (p + z * z / (2 * n)) / den
        half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
        out["yield"] = p
        out["ci95"] = (max(0.0, center - half), min(1.0, center + half))
        return out
    wf = weights * (~ok)                           # weighted failures
    p_fail = float(wf.mean())
    se = float(wf.std(ddof=1)) / math.sqrt(n)
    out["yield"] = 1.0 - p_fail
    out["p_fail"] = p_fail
    out["p_fail_se"] = se
    out["ci95"] = (max(0.0, 1.0 - (p_fail + z * se)),
                   min(1.0, 1.0 - max(0.0, p_fail - z * se)))
    out["weights"] = weights
    # the effective number of FAILURE samples: only failing lanes' weights
    # enter the estimator
    wsum = float(wf.sum())
    w2sum = float((wf ** 2).sum())
    out["n_eff"] = wsum * wsum / w2sum if w2sum > 0 else 0.0
    return out


def sobol_indices(engine: Engine, topo, params, generator: torch.Generator,
                  n: int, rel_sigma: Mapping[str, float], measures, tstep,
                  tstop, sampler: str = "lhs", analysis: str = "tran",
                  freqs=None, bindings=None):
    """First-order and total-effect Sobol indices of every measure over the
    mismatch space (Saltelli's scheme): ``generator`` draws A, then B
    (n x dims each, under ``sampler``); the d hybrids AB_j are A with
    column j from B; all (d + 2) n lanes run as ONE batched solve, and the
    estimators finish on the host:

        S_j = mean(f_B (f_ABj - f_A)) / Var(f)      (Saltelli 2010)
        T_j = mean((f_A - f_ABj)^2) / (2 Var(f))    (Jansen)

    Returns {measure: {"S1": (dims,), "ST": (dims,), "dims": [(name,
    index), ...], "var": float}}."""
    names, sizes, dims = _z_layout(params, rel_sigma)
    if dims == 0:
        raise ValueError("rel_sigma names no perturbable parameter")
    A = normal_draws(generator, n, dims, sampler)
    Bm = normal_draws(generator, n, dims, sampler)
    blocks = [A, Bm]
    for j in range(dims):
        ABj = A.clone()
        ABj[:, j] = Bm[:, j]
        blocks.append(ABj)
    bparams = _params_from_Z(params, rel_sigma, torch.cat(blocks, 0))
    vals, _ = _lane_measures(engine, topo, bparams, measures, tstep, tstop,
                             analysis, freqs, bindings)
    labels = [(nm, i) for nm, sz in zip(names, sizes) for i in range(sz)]
    out = {}
    for name, v in vals.items():
        f = np.asarray(v).reshape(dims + 2, n)
        fA, fB = f[0], f[1]
        var = float(np.concatenate([fA, fB]).var())
        S1 = np.zeros(dims)
        ST = np.zeros(dims)
        if var > 0.0:            # a mismatch-independent measure gets 0s
            for j in range(dims):
                fABj = f[2 + j]
                S1[j] = float((fB * (fABj - fA)).mean()) / var
                ST[j] = float(((fA - fABj) ** 2).mean()) / (2 * var)
        out[name] = {"S1": S1, "ST": ST, "dims": labels, "var": var}
    return out
