"""Monte-Carlo batching: thousands of parameter lanes of one topology.

Port of the batched main path of ``circuitsimulator_tpu/parallel/
montecarlo.py`` and of the transient loop of ``bench.py``: parameters carry
a leading lane axis written out (no vmap); the DC Newton loop and every
dense solve run over all lanes at once (the K2 kernel on CUDA).  A
waveform-free f32 transient on CUDA takes the fused chunk kernel (K1,
``ops/fused_step.py``) when the deck is in its scope.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..analysis.dc import dc_linear, dc_newton
from ..analysis.transient import (TransientResult, n_steps_for, run_transient,
                                  transient_step_fn)
from ..ops import fused_step
from ..ops.assemble import Engine


def broadcast_params(params: Dict[str, torch.Tensor],
                     batch: int) -> Dict[str, torch.Tensor]:
    """Tile every parameter leaf to a leading lane axis."""
    return {k: v.expand((batch,) + v.shape) for k, v in params.items()}


def perturb_params(params: Dict[str, torch.Tensor], generator: torch.Generator,
                   batch: int,
                   rel_sigma: Mapping[str, float]) -> Dict[str, torch.Tensor]:
    """Lognormal lanes p * exp(sigma * z), z ~ N(0, 1) drawn from
    ``generator`` (on the parameters' device) in sorted-name order;
    parameters not in ``rel_sigma`` are broadcast unperturbed."""
    out = broadcast_params(params, batch)
    for name in sorted(rel_sigma):
        arr = params[name]
        if not (arr.is_floating_point() and arr.numel()):
            continue
        z = torch.randn((batch,) + arr.shape, generator=generator,
                        dtype=arr.dtype, device=arr.device)
        out[name] = arr[None] * torch.exp(rel_sigma[name] * z)
    return out


def lane_count(bparams: Dict[str, torch.Tensor]) -> int:
    return next(iter(bparams.values())).shape[0]


def batched_dc_fast(engine: Engine, bparams):
    """Natively batched DC operating point (B, N): one Newton loop with
    per-lane masks, every iteration's solve batched over all lanes."""
    if not engine.topo.has_nonlinear:
        return dc_linear(engine, bparams)
    return dc_newton(engine, bparams, batch=lane_count(bparams))


def init_carry(engine: Engine, x0):
    """Transient carry of the batched loop from a (B, N) DC solution."""
    failed = torch.zeros(x0.shape[:-1], dtype=torch.bool, device=x0.device)
    state = engine.init_state(x0)
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


def make_fused_transient_fn(engine: Engine, bparams, tstep, chunk: int = 2000):
    """Set up the fused-kernel batched transient: the per-lane constants
    of the chunk kernel (NotImplementedError, naming the cause, for a deck
    outside its scope), the batched DC (K2 on CUDA), and
    ``advance(carry, step0, n=chunk) -> (carry, iters)``, which runs one
    chunk of n steps from step index step0 (iters (B,) int32).
    Returns (carry0, advance, meta); carry = (x, x_prev, vc, il, failed)."""
    runner = fused_step.FusedStepRunner(engine, bparams, float(tstep))
    x0 = batched_dc_fast(engine, bparams)
    state0 = engine.init_state(x0)

    def advance(carry, step0: int, n: int = chunk):
        out = runner.run_chunk(*carry, step0, n)
        return out[:5], out[5]

    failed0 = torch.zeros((runner.B,), dtype=torch.bool, device=x0.device)
    carry0 = (x0, x0, state0["vc"], state0["il"], failed0)
    return carry0, advance, {"chunk": chunk, "runner": runner}


def _fused_batched_transient(engine: Engine, bparams, tstep,
                             tstop) -> TransientResult:
    """Waveform-free batched transient on the fused chunk kernel:
    newton_iters is the per-lane (B,) total over the run."""
    n_steps = n_steps_for(float(tstep), float(tstop))
    carry, advance, meta = make_fused_transient_fn(engine, bparams, tstep)
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
                      save_xs: bool = False, fused="auto") -> TransientResult:
    """Backward-Euler transient of every lane, from the batched DC point.

    fused="auto" takes the fused chunk kernel (K1) for a waveform-free
    (save_xs=False) float32 run on CUDA whose deck is in the kernel's
    scope (``fused_step.supported``); anything else runs the non-fused
    loop, which keeps xs (n_steps + 1, B, N) when save_xs is set.
    fused=True forces the fused path: on CPU tensors it runs the kernel's
    plain version; an out-of-scope deck raises NotImplementedError naming
    what is out of scope."""
    dt = float(tstep)
    if fused == "auto":
        fused = (not save_xs and engine.dtype == torch.float32
                 and engine.device.type == "cuda"
                 and fused_step.supported(engine, dt))
    if fused:
        if save_xs:
            raise ValueError("fused=True keeps no waveforms: save_xs=False")
        return _fused_batched_transient(engine, bparams, tstep, tstop)
    return run_transient(engine, bparams, tstep, tstop,
                         x0=batched_dc_fast(engine, bparams), save_xs=save_xs)
