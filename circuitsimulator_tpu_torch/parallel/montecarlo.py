"""Monte-Carlo batching: thousands of parameter lanes of one topology.

Port of the batched main path of ``circuitsimulator_tpu/parallel/
montecarlo.py`` and of the transient loop of ``bench.py``: parameters carry
a leading lane axis written out (no vmap); the DC Newton loop and every
dense solve run over all lanes at once (the K2 kernel on CUDA).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..analysis.dc import dc_linear, dc_newton
from ..analysis.transient import transient_step_fn
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
