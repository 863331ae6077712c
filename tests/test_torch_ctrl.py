"""The linear controlled sources E/G/F/H in the PyTorch port's assembly on
the CPU: G, I and state against the JAX Engine (f64, rtol 1e-12), the DC
table text against the JAX package's, a 200-step f64 transient within
1e-9 V of JAX, and the fused chunk (K1a) gate and plain version on a MOS
deck with E/G/F/H."""

import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.ops import pallas_step
from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.ops import fused_step
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's summaries, DC reports and mos_ctrl's 200-step
# transient (about 10 s of compiles on the CPU); ``PYTHONPATH=.
# JAX_PLATFORMS=cpu python tests/test_torch_ctrl.py`` remakes the file
GOLDEN = os.path.join(REPO, "tests", "goldens", "ctrl_jax.json")
RTOL = 1e-12

# every linear controlled source, a reactive load on each, and a MOS stage
# driven through E1: K1a's scope (k = 1) with E/G/F/H stamps in G0
MOS_CTRL_DECK = """* MOS stage with E/G/F/H
.MODEL 2 VT 0.386 MU 3.0238e-2 COX 6.058e-3 LAMBDA 0.05 CJ0 4.0e-14
VDD 1 0 DC 3
Vin 2 0 SIN 0.6 0.2 5e6
R1 2 3 1k
C3 3 0 0.2p
E1 4 0 3 0 1.5
M1 5 4 0 n 10e-6 0.35e-6 2
RL 1 5 5k
C1 5 0 1p
G1 0 6 5 0 1m
R6 6 0 2k
C6 6 0 0.5p
Vs 6 7 DC 0
R7 7 0 1k
F1 0 8 Vs 2
R8 8 0 1k
L8 8 0 10u
H1 9 0 Vs 100
R9 9 0 1k
.op
"""

DECKS = {"mos_ctrl": MOS_CTRL_DECK,
         "feedback_loop": os.path.join(REPO, "examples", "feedback_loop.sp"),
         "opamp_filter": os.path.join(REPO, "examples", "opamp_filter.sp")}


@functools.lru_cache(maxsize=None)
def simulators(deck):
    """(JAX, port) simulators of one deck, shared by the tests of this
    module so that JAX compiles each analysis once."""
    src = DECKS[deck]
    if src.endswith(".sp"):
        return (JaxSimulator.from_file(src),
                Simulator.from_file(src, device="cpu"))
    return JaxSimulator.from_text(src), Simulator.from_text(src, device="cpu")


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(initial=1e-30))


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_assembly_and_state_match_jax(deck):
    js, ts = simulators(deck)
    je, te = js.engine, ts.engine
    assert sum(te.topo.counts[c] for c in "EGFH") > 0
    jp = js.params
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()})
    x = np.random.default_rng(7).uniform(-1.0, 3.0, te.N)
    dt, t = 1e-9, 3.7e-8

    @jax.jit
    def ref(p, x):
        G, I = je.dc_static(p, jnp.asarray(0.3))
        d = jnp.asarray(dt)
        s = je.init_state(x)
        return ((G, I) + je.assemble_dc_iter(G, I, p, x, 2.5e-6)
                + (je.tran_static_G(p, d, 1e-6),
                   je.make_tran_static_I(d)(p, s, jnp.asarray(t)),
                   s["vc"], s["il"]))

    want = ref(jp, jnp.asarray(x))
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    G, I = te.dc_static(tp, f64(0.3))
    s = te.init_state(torch.as_tensor(x))
    got = ((G, I) + te.assemble_dc_iter(G, I, tp, torch.as_tensor(x), 2.5e-6)
           + (te.tran_static_G(tp, f64(dt), 1e-6),
              te.make_tran_static_I(f64(dt))(tp, s, f64(t)),
              s["vc"], s["il"]))
    for g, w in zip(got, want):
        close(g, w)


TRAN_N, TRAN_DT = 200, 2e-11


def jax_results():
    """Each deck's JAX summary and DC report (the DC point of a nonlinear
    deck is its transient's first row, one Newton compile for both), and
    mos_ctrl's f64 transient of TRAN_N steps."""
    out = {}
    for deck in sorted(DECKS):
        js = simulators(deck)[0]
        r = {"summary": js.summary()}
        if js.topo.has_nonlinear:
            res = js.transient(tstep=TRAN_DT, tstop=TRAN_N * TRAN_DT)
            r.update(xs=np.asarray(res.xs).tolist(),
                     newton_iters=np.asarray(res.newton_iters).tolist())
            r["dc_report"] = js.dc_report(res.xs[0])
        else:
            r["dc_report"] = js.dc_report(js.dc())
        out[deck] = r
    return out


@functools.lru_cache(maxsize=None)
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def port_transient(deck):
    return simulators(deck)[1].transient(tstep=TRAN_DT,
                                         tstop=TRAN_N * TRAN_DT)


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_dc_table_text_matches_jax(deck):
    ts = simulators(deck)[1]
    want = golden()[deck]
    assert ts.summary() == want["summary"]
    if ts.topo.has_nonlinear:
        # the transient's first row is the DC point
        tx = port_transient(deck).xs[0]
        np.testing.assert_array_equal(tx.numpy(), ts.dc().numpy())
    else:
        tx = ts.dc()
    assert ts.dc_report(tx) == want["dc_report"]


def test_transient_200_steps_match_jax():
    want = golden()["mos_ctrl"]
    tres = port_transient("mos_ctrl")
    assert not bool(tres.failed)
    np.testing.assert_allclose(tres.xs.numpy(), want["xs"], rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(tres.newton_iters.numpy(),
                                  want["newton_iters"])


def test_fused_gate_admits_ctrl_and_plain_matches_nonfused():
    """K1a admits E/G/F/H (as JAX's gate does); its plain version holds the
    port's non-fused loop within 1e-9 V in f64 on 8 lanes x 50 steps."""
    js, ts = simulators("mos_ctrl")
    dt, steps = 1e-10, 50
    assert fused_step.supported(ts.engine, dt)
    assert pallas_step.supported(js.engine, dt)
    bp = tmc.perturb_params(ts.params, torch.Generator().manual_seed(3), 8,
                            {"res_r": 0.01, "mos_vth": 0.02, "cap_c": 0.02,
                             "vcvs_gain": 0.02, "vccs_g": 0.02})
    carry, advance, _ = tmc.make_fused_transient_fn(ts.engine, bp, dt,
                                                    chunk=steps)
    (x, _, vc, il, failed), iters = advance(carry, 0, steps)
    ref = tmc.init_carry(ts.engine, carry[0])
    tgrid = torch.arange(1, steps + 1, dtype=torch.float64) * dt
    ref, ref_iters = tmc.batched_transient_chunk(ts.engine, bp, ref, tgrid,
                                                 dt)
    np.testing.assert_allclose(x.numpy(), ref[0].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(vc.numpy(), ref[-2]["vc"].numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(il.numpy(), ref[-2]["il"].numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(failed.numpy(), ref[-1].numpy())
    np.testing.assert_array_equal(iters.numpy(), ref_iters.numpy())


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    with open(GOLDEN, "w") as fh:
        json.dump(jax_results(), fh)
