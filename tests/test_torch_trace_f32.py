"""Three float32 traces of the port against the JAX package, run as a
script (they take minutes, so they hold no Tier-1 test):

    JAX_PLATFORMS=cpu python tests/test_torch_trace_f32.py tline
    JAX_PLATFORMS=cpu python tests/test_torch_trace_f32.py dc [seeds...]
    JAX_PLATFORMS=cpu python tests/test_torch_trace_f32.py xfmr [steps]

``tline``: benchmarks/bench_tline_fused.py's diode clamp in the fast
configuration (alpha 1, the predictor, two unrolled iterations, tol 1e-5),
128 lanes with Rs perturbed 2% (numpy), all three runs from one float64
batched-DC point cast to float32, one step a call for 100 steps: the
port's ``FusedStepRunner.run_chunk_plain``, the JAX ``PallasStepRunner``
in interpret mode, and the JAX package's XLA Woodbury loop.  Prints each
pair's largest gap per step and the step where they first part.

``dc``: the float32 batched DC (strict mode, dc_tol 1e-5) on the NPN + PNP
deck of tests/test_pallas_step.py, B = 512, ``res_r`` 1% and ``bjt_is``,
``bjt_bf`` 5% drawn with numpy and given to both packages; a lane counts
when it ends more than 1e-3 V from the port's float64 point.  Per draw: the
JAX package, the port, the port with its assembly computed in float64 and
rounded to float32, the port with only the exponential taken in float64,
and (on the first draw) the port with JAX's LU solve.

``xfmr``: examples/xfmr.sp (K = 0.98, dt = 10 ns) over its first ``steps``
steps (default 2,000), 64 lanes with L1, L2 and the resistors perturbed 2%
(numpy), in the default damped configuration: the port's non-fused loop
and the JAX package's XLA loop, each in float32 and float64 from its own
DC point.  Prints, per package, the largest |V(s)_f32 - V(s)_f64| over the
lanes and steps, over the peak |V(s)|, and the digits that leaves.
"""

import json
import math
import os
import sys

import jax

if __name__ == "__main__":      # the repo root, and JAX as conftest.py sets it
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.analysis.transient import transient_step_fn
from circuitsimulator_tpu.ops import lu as jlu
from circuitsimulator_tpu.parallel import montecarlo as jmc
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.analysis import dc as tdc
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.models import bjt as tbjt
from circuitsimulator_tpu_torch.models import diode as tdio
from circuitsimulator_tpu_torch.ops import fused_step
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_fused_step import (dc_points, draw_lanes, fast,  # noqa: E402
                                   jax_runner)

torch.set_num_threads(1)

CLAMP_DECK = """* T-line reflections + diode clamp at the far end
V1 in 0 PULSE(0 1 1n 0.2n 0.2n 6n 14n)
RS in a 50
T1 a 0 b 0 Z0=50 TD=2n
RL b 0 200
D1 b 0
.op
"""

BJT_DECK = """* npn + pnp stages
.MODEL qn NPN IS=1e-15 BF=120 BR=2 VAF=50
.MODEL qp PNP IS=1e-15 BF=80 BR=1
VCC 1 0 5
Vin 2 0 SIN 0.65 0.01 1e6
RB 2 3 10k
RC 1 4 2k
Q1 4 3 0 qn
VB2 5 0 DC 4.3
RB2 5 6 10k
RC2 7 0 2k
Q2 7 6 1 qp
CL 4 0 1p
.op
"""


def trace_tline(B=128, steps=100, dt=0.25e-9):
    js = JaxSimulator.from_text(CLAMP_DECK,
                                opts=fast(JAX_OPTIONS, jnp.float32))
    je = js.engine
    jp = draw_lanes(js.params, B, sigmas=(("res_r", 0.02),))
    x0n = dc_points(CLAMP_DECK, jp)
    ts = Simulator.from_text(CLAMP_DECK, device="cpu",
                             opts=fast(DEFAULT_OPTIONS, torch.float32))
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()},
                           dtype=torch.float32)
    xt = torch.as_tensor(x0n)
    st = ts.engine.init_state(xt, tp, dt)
    runner = fused_step.FusedStepRunner(ts.engine, tp, dt)
    c = (xt, xt, st["vc"], st["il"], torch.zeros((B,), dtype=torch.bool),
         st["tlw"])
    port = []
    for i in range(steps):
        out = runner.run_chunk_plain(*c[:5], i, 1, tlw=c[5])
        c = out[:5] + (out[-1],)
        port.append(out[0].numpy().copy())
    x0 = jnp.asarray(x0n)
    jr = jax_runner(je, jp, dt)
    cj = (x0, x0, jnp.asarray(st["vc"].numpy()),
          jnp.asarray(st["il"].numpy()), jnp.zeros((B,), bool),
          jnp.asarray(st["tlw"].numpy()))
    pallas = []
    for i in range(steps):
        out = jr.run_chunk(*cj[:5], i, 1, interpret=True, tlw=cj[5])
        cj = tuple(out[:5]) + (out[-1],)
        pallas.append(np.asarray(out[0]))
    state0 = jax.vmap(lambda xx, p: je.init_state(xx, p, dt))(x0, jp)

    def lane(p, carry, t):
        return transient_step_fn(je, p, dt, predictor=True)(carry, t)[0]

    step = jax.jit(jax.vmap(lane, in_axes=(0, 0, None)))
    cx = (x0, x0, state0, jnp.zeros((B,), bool))
    xla = []
    for i in range(steps):
        cx = step(jp, cx, jnp.asarray((i + 1) * dt, jnp.float32))
        xla.append(np.asarray(cx[0]))
    runs = {"port": np.stack(port), "pallas": np.stack(pallas),
            "xla": np.stack(xla)}
    for a, b in (("port", "pallas"), ("pallas", "xla"), ("port", "xla")):
        gap = np.abs(runs[a] - runs[b])
        per_step = gap.max(axis=(1, 2))
        parted = np.nonzero(per_step > 1e-3)[0]
        print(json.dumps({
            "pair": f"{a} - {b}", "max_abs": float(per_step.max()),
            "first_step_over_1mV": int(parted[0]) + 1 if parted.size else None,
            "lanes_over_1mV_at_end": int((gap[-1].max(1) > 1e-3).sum()),
            "gap_steps_1_16": [float(v) for v in per_step[:16]],
            "gap_at_end": float(per_step[-1])}))


def _exp_lim64(u, u_max=tdio.EXP_LIMIT):
    """models/diode.exp_lim with the exponential in float64, rounded."""
    e = torch.exp(torch.clamp_max(u.double(), u_max)).to(u.dtype)
    top = math.exp(u_max)
    below = u <= u_max
    return (torch.where(below, e, top * (1.0 + (u - u_max))),
            torch.where(below, e, top))


class _Asm64:
    """The port's f32 engine with its DC assembly computed by the float64
    engine and rounded to float32."""

    def __init__(self, e32, e64, params64):
        self.e32, self.e64, self.p64 = e32, e64, params64

    def __getattr__(self, name):
        return getattr(self.e32, name)

    def dc_static(self, params, scale):
        return self.e64.dc_static(self.p64, scale.double())

    def assemble_dc_iter(self, G_s, I_s, params, x, gmin):
        G, I = self.e64.assemble_dc_iter(G_s, I_s, self.p64, x.double(),
                                         gmin.double())
        return G.float(), I.float()


def trace_dc(seeds=(7, 1, 2, 3, 4), B=512):
    js = JaxSimulator.from_text(BJT_DECK, opts=JAX_OPTIONS.replace(
        dtype=jnp.float32, dc_tol=1e-5))
    t32 = Simulator.from_text(BJT_DECK, device="cpu", opts=DEFAULT_OPTIONS
                              .replace(dtype=torch.float32, dc_tol=1e-5))
    t64 = Simulator.from_text(BJT_DECK, device="cpu")
    for n, seed in enumerate(seeds):
        jp = draw_lanes(js.params, B, seed=seed, sigmas=(
            ("res_r", 0.01), ("bjt_is", 0.05), ("bjt_bf", 0.05)))
        npp = {k: np.array(v) for k, v in jp.items()}
        p64, p32 = params_from_numpy(npp), params_from_numpy(
            npp, dtype=torch.float32)
        x64 = tmc.batched_dc_fast(t64.engine, p64).numpy()

        def off(x):
            d = np.abs(np.asarray(x, np.float64) - x64).max(1)
            return int((~(d <= 1e-3)).sum())

        row = {"seed": seed,
               "jax": off(jmc.batched_dc_fast(js.engine, jp)),
               "port": off(tmc.batched_dc_fast(t32.engine, p32).numpy()),
               "port_f64_assembly": off(tdc.dc_newton(
                   _Asm64(t32.engine, t64.engine, p64), p32,
                   batch=B).numpy())}
        orig = tdio.exp_lim
        tbjt.exp_lim = tdio.exp_lim = _exp_lim64
        try:
            row["port_f64_exp"] = off(tmc.batched_dc_fast(t32.engine,
                                                          p32).numpy())
        finally:
            tbjt.exp_lim = tdio.exp_lim = orig
        if n == 0:
            lu = tdc.lu_solve
            tdc.lu_solve = lambda A, b, floor: torch.as_tensor(np.array(
                jlu.lu_solve_batched(jnp.asarray(A.numpy()),
                                     jnp.asarray(b.numpy()), floor)))
            try:
                row["port_jax_lu"] = off(tmc.batched_dc_fast(
                    t32.engine, p32).numpy())
            finally:
                tdc.lu_solve = lu
        print(json.dumps(row), flush=True)


def trace_xfmr(steps=2000, B=64):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "xfmr.sp")
    with open(path) as f:
        text = f.read()
    dt = 1e-8
    js64 = JaxSimulator.from_text(text, opts=JAX_OPTIONS.replace(
        dtype=jnp.float64))
    jp = draw_lanes(js64.params, B, sigmas=(("ind_l", 0.02),
                                            ("res_r", 0.02)))
    node = js64.circuit.nodes[js64.circuit.node_name_to_id["s"]].eq_index
    runs = {}
    for name, jdt, tdt in (("f64", jnp.float64, torch.float64),
                           ("f32", jnp.float32, torch.float32)):
        js = JaxSimulator.from_text(text, opts=JAX_OPTIONS.replace(dtype=jdt))
        lanes = {k: (v.astype(jdt) if jnp.issubdtype(v.dtype, jnp.floating)
                     else v) for k, v in jp.items()}
        res = jmc.batched_transient(js.engine, lanes, dt, steps * dt,
                                    save_xs=True, fused=False)
        runs[("jax", name)] = np.asarray(res.xs)[:, :, node].T   # (T, B)
        ts = Simulator.from_text(text, device="cpu",
                                 opts=DEFAULT_OPTIONS.replace(dtype=tdt))
        tp = params_from_numpy({k: np.array(v) for k, v in jp.items()},
                               dtype=tdt)
        res = tmc.batched_transient(ts.engine, tp, dt, steps * dt,
                                    save_xs=True, fused=False)
        runs[("port", name)] = res.xs[:, :, node].numpy()
    for pkg in ("port", "jax"):
        ref = runs[(pkg, "f64")]
        gap = np.abs(runs[(pkg, "f32")].astype(np.float64) - ref)
        rel = float(gap.max() / np.abs(ref).max())
        print(json.dumps({
            "package": pkg, "steps": steps, "lanes": B,
            "max_abs_V": float(gap.max()), "peak_V": float(np.abs(ref).max()),
            "max_rel_of_peak": rel, "digits_kept": -math.log10(rel),
            "step_of_max": int(np.unravel_index(gap.argmax(),
                                                gap.shape)[0])}))
    d = np.abs(runs[("port", "f64")] - runs[("jax", "f64")]).max()
    print(json.dumps({"port_f64_vs_jax_f64_max_abs_V": float(d)}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["tline"]:
        trace_tline()
    elif sys.argv[1:2] == ["xfmr"]:
        trace_xfmr(*(int(s) for s in sys.argv[2:3]))
    elif sys.argv[1:2] == ["dc"]:
        trace_dc(tuple(int(s) for s in sys.argv[2:]) or (7, 1, 2, 3, 4))
    else:
        sys.exit(__doc__)
