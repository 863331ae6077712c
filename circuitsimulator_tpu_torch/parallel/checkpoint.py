"""Checkpoint / resume for long transients (port of
``circuitsimulator_tpu/parallel/checkpoint.py``).

The transient carry (x, the state dict, the failed flags) is a flat set of
tensors, so a resumable transient runs the step loop in chunks and writes
the carry after each one:

    runner = ChunkedTransient(engine, params, tstep=1e-13, tstop=5e-9,
                              ckpt_path="run.npz", chunk_steps=5000)
    carry, iters = runner.run()     # picks up from run.npz if present

The file is JAX's ``.npz`` layout: ``x``, ``failed``, ``step_done``,
``s_<key>`` for each state entry and ``k_<key>`` for PRNG key data (the
TRNOISE key as uint32 words, as ``jax.random.key_data`` gives them), so a
file written by either package loads in the other.  The port's state holds
keys derived from the TRNOISE key (``Engine._noise_keys``) that JAX's does
not; they are left out of the file and derived again on load, and the step
counter is stored as JAX's int32.  Writes are atomic: a ``.tmp.npz`` file,
then ``os.replace``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..analysis.dc import dc_operating_point
from ..analysis.transient import n_steps_for, transient_step_fn
from ..ops.assemble import Engine

# state entries derived from tn_key on load, never written
_DERIVED = ("tn_kv", "tn_ki", "tn_bv", "tn_bi")


def save_carry(path: str, carry, step_done: int) -> None:
    """Write carry = (x, state, failed) after ``step_done`` steps."""
    x, state, failed = carry
    arrs = {"x": x.cpu().numpy(), "failed": failed.cpu().numpy(),
            "step_done": np.asarray(step_done)}
    for k, v in state.items():
        if k in _DERIVED:
            continue
        if k == "tn_key":
            arrs["k_tn_key"] = v.cpu().numpy().astype(np.uint32)
        elif k == "tn_step":
            arrs["s_tn_step"] = np.asarray(v, np.int32)
        else:
            arrs[f"s_{k}"] = v.cpu().numpy()
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def load_carry(path: str, engine: Engine):
    """(carry, step_done) from a file of ``save_carry`` (or of the JAX
    package's), the tensors on ``engine.device``."""
    dev = engine.device
    with np.load(path) as z:
        state = {k[2:]: torch.as_tensor(z[k], device=dev) for k in z.files
                 if k.startswith("s_")}
        if "k_tn_key" in z.files:
            state.update(engine._noise_keys(torch.as_tensor(
                z["k_tn_key"].astype(np.int64), device=dev)))
            state["tn_step"] = int(z["s_tn_step"])
        carry = (torch.as_tensor(z["x"], device=dev), state,
                 torch.as_tensor(z["failed"], device=dev))
        return carry, int(z["step_done"])


class ChunkedTransient:
    """A fixed-step transient run ``chunk_steps`` steps at a time, its carry
    written to ``ckpt_path`` after each chunk (none without a path).
    params may carry a leading lane axis: a whole Monte-Carlo batch is one
    carry.  noise_key turns on a TRNOISE deck's noise: one key (2,) gives
    every lane the same realisation (JAX's ChunkedTransient), keys (B, 2)
    one each (``montecarlo.lane_keys``)."""

    def __init__(self, engine: Engine, params, tstep: float, tstop: float,
                 ckpt_path: Optional[str] = None, chunk_steps: int = 10000,
                 noise_key=None):
        self.engine = engine
        self.params = params
        self.tstep = float(tstep)
        self.n_steps = n_steps_for(tstep, tstop)
        self.ckpt_path = ckpt_path
        self.chunk_steps = int(chunk_steps)
        self.noise_key = noise_key
        self._step = transient_step_fn(engine, params, self.tstep)

    @torch.inference_mode()
    def _run_chunk(self, carry, ts):
        """Advance carry through the times ts: (carry, (len(ts), ...)
        Newton iterations)."""
        iters = []
        for t in ts:
            carry, (_, it) = self._step(carry, t)
            iters.append(it)
        return carry, torch.stack(iters)

    @torch.inference_mode()
    def initial_carry(self):
        """The DC point (batched over the lanes of batched params) and the
        state the transient starts from."""
        eng, p = self.engine, self.params
        lanes = tuple(p["vt_thermal"].shape)
        x0 = dc_operating_point(eng, p, batch=lanes[0] if lanes else 0)
        state = eng.init_state(x0, p, self.tstep, noise_key=self.noise_key)
        failed = torch.zeros(x0.shape[:-1], dtype=torch.bool,
                             device=x0.device)
        return (x0, state, failed)

    def run(self):
        """Run to the end, writing the carry after every chunk; resumes from
        ``ckpt_path`` when the file exists.  Returns (final carry, total
        Newton iterations)."""
        start = 0
        if self.ckpt_path and os.path.exists(self.ckpt_path):
            carry, start = load_carry(self.ckpt_path, self.engine)
        else:
            carry = self.initial_carry()
        total_iters = 0
        dtype, dev = self.engine.dtype, self.engine.device
        while start < self.n_steps:
            hi = min(start + self.chunk_steps, self.n_steps)
            ts = (torch.arange(start + 1, hi + 1, dtype=dtype, device=dev)
                  * torch.tensor(self.tstep, dtype=dtype, device=dev))
            carry, iters = self._run_chunk(carry, ts)
            total_iters += int(iters.sum())
            start = hi
            if self.ckpt_path:
                save_carry(self.ckpt_path, carry, start)
        return carry, total_iters
