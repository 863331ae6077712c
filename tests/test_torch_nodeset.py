"""`.NODESET` in the PyTorch port against the JAX package (CPU, f64): the
single-lane DC with its hold-then-release, the batched DC with a nodeset,
the warm-started Monte-Carlo DC, and the CLI on inamp.sp."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.parallel import montecarlo as jmc
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.cli import main as port_cli_main
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INAMP = os.path.join(REPO, "tests", "netlists", "inamp.sp")
J64 = JAX_OPTIONS.replace(dtype=jnp.float64)

# the cross-coupled NMOS latch of tests/test_nodeset.py: two stable states
LATCH = """VDD vdd 0 5
RL1 vdd q 10k
RL2 vdd qb 10k
M1 q qb 0 n 10u 1u 1
M2 qb q 0 n 10u 1u 1
.MODEL 1 VT 1.0 MU 5e-2 COX 2e-3 LAMBDA 0.0
"""


def veq(sim, name):
    return sim.circuit.nodes[sim.circuit.node_name_to_id[name]].eq_index


def draw_lanes(params, B, seed):
    """B lanes of the JAX params, resistors and thresholds perturbed with
    numpy (an eager ``jmc.perturb_params`` costs a second of compiles)."""
    rng = np.random.default_rng(seed)
    out = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
           for k, v in params.items()}
    for key, sigma in (("res_r", 0.01), ("mos_vth", 0.02)):
        out[key] = out[key] * np.exp(sigma * rng.standard_normal(
            out[key].shape))
    return out


@pytest.mark.parametrize("card,high", [
    (".NODESET V(q)=5 V(qb)=0\n", "q"),
    (".NODESET V(q)=0 V(qb)=5 V(zzz)=1\n", "qb"),
])
def test_latch_nodeset_dc_matches_jax(card, high, capsys):
    """Each nodeset picks its latch state, at JAX Simulator.dc()'s point
    within 1e-12 V; an unknown node is skipped with JAX's warning."""
    js = JaxSimulator.from_text(LATCH + card, opts=J64)
    ts = Simulator.from_text(LATCH + card, device="cpu")
    want = np.asarray(js.dc())
    got = ts.dc().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[veq(ts, high)] > 4.0
    if "zzz" in card:
        assert (".NODESET: unknown or ground node 'zzz'; ignored"
                in capsys.readouterr().err)


def test_inamp_nodeset_dc_matches_jax_at_one_iteration_per_step():
    """inamp.sp's 20 .NODESET values with ITL1 = 1 (one Newton iteration
    per ramp step): the seed, the nine held steps and the release, within
    1e-12 V of JAX Simulator.dc().  At the default ITL1 = 50 the release
    step ends unconverged in both packages and the two points are 3.1e-10 V
    apart: they agree within 4.4e-16 V through the held steps and 1.6e-14 V
    after the release step's first iteration, and the gap grows from its
    second (9.0e-12 V) as the unconverged Newton amplifies rounding
    (``parting_table`` below; run this file as a script)."""
    js = JaxSimulator.from_file(INAMP, opts=J64.replace(dc_max_newton_iters=1))
    ts = Simulator.from_file(INAMP, device="cpu",
                             opts=DEFAULT_OPTIONS.replace(
                                 dc_max_newton_iters=1))
    assert len(ts._nodeset()[0]) == 20
    np.testing.assert_allclose(ts.dc().numpy(), np.asarray(js.dc()), rtol=0,
                               atol=1e-12)


def test_batched_dc_fast_nodeset_matches_jax():
    """batched_dc_fast(nodeset=) on 8 JAX-drawn latch lanes: every lane in
    the state the nodeset picks, within 1e-12 V of JAX's."""
    text = LATCH + ".NODESET V(q)=0 V(qb)=5\n"
    js = JaxSimulator.from_text(text, opts=J64)
    ts = Simulator.from_text(text, device="cpu")
    lanes = draw_lanes(js.params, 8, seed=4)
    want = np.asarray(jax.jit(lambda p: jmc.batched_dc_fast(
        js.engine, p, nodeset=js._nodeset()))(
            {k: jnp.asarray(v) for k, v in lanes.items()}))
    got = tmc.batched_dc_fast(ts.engine, params_from_numpy(lanes),
                              nodeset=ts._nodeset()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert (got[:, veq(ts, "qb")] > 4.0).all()


def test_batched_dc_warm_matches_jax():
    """The Monte-Carlo start of benchmarks/bench_inamp.py: the nominal DC
    with the .NODESET card, then batched_dc_warm on 8 JAX-drawn lanes,
    within 1e-12 V of JAX's (both start from JAX's nominal point)."""
    js = JaxSimulator.from_file(INAMP, opts=J64)
    ts = Simulator.from_file(INAMP, device="cpu")
    x_nom = js.dc()
    lanes = draw_lanes(js.params, 8, seed=5)
    want = np.asarray(jax.jit(lambda p, x: jmc.batched_dc_warm(
        js.engine, p, x))({k: jnp.asarray(v) for k, v in lanes.items()},
                          x_nom))
    got = tmc.batched_dc_warm(ts.engine, params_from_numpy(lanes),
                              torch.as_tensor(np.array(x_nom))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_cli_runs_inamp_with_its_nodeset(capsys):
    """The CLI's DC on inamp.sp (``python -m circuitsimulator_tpu_torch
    tests/netlists/inamp.sp --no-tran --device cpu``, run in-process) runs
    to its end: it stopped on the card before."""
    assert port_cli_main([INAMP, "--no-tran", "--device", "cpu"]) == 0
    assert "DC analysis finished." in capsys.readouterr().out


def parting_table():
    """Where the port's and JAX's inamp nodeset DC part: (ramp step,
    Newton iteration, max |x_port - x_jax|) after every iteration of the
    default DC.  Both dc_newton loops run from copies of their sources
    with one line added after the iteration count, which records x (a
    debug callback in JAX's loop)."""
    import types
    import circuitsimulator_tpu.analysis.dc as jdc
    import circuitsimulator_tpu_torch.analysis.dc as tdc
    rec = {"jax": [], "port": []}

    def patched(mod, anchor, line, name):
        src = open(mod.__file__).read()
        assert anchor in src
        copy = types.ModuleType(mod.__name__ + "_rec")
        copy.__package__ = mod.__package__
        copy.REC = rec[name]
        exec(compile(src.replace(anchor, anchor + line), mod.__file__,
                     "exec"), copy.__dict__)
        return copy

    jm = patched(jdc, '            c["iter"] = c["iter"] + 1\n',
                 '            __import__("jax").debug.callback(lambda s, i, '
                 'v: REC.append((int(s), int(i), __import__("numpy").array('
                 'v))), step, c["iter"], c["x"])\n', "jax")
    tm = patched(tdc, '            it += 1\n',
                 '            REC.append((step, it, x.clone().numpy()))\n',
                 "port")
    js = JaxSimulator.from_file(INAMP, opts=J64)
    ts = Simulator.from_file(INAMP, device="cpu")
    jax.block_until_ready(jax.jit(lambda p: jm.dc_operating_point(
        js.engine, p, nodeset=js._nodeset()))(js.params))
    tm.dc_operating_point(ts.engine, ts.params, nodeset=ts._nodeset())
    return [(s, i, float(np.abs(a - b).max()))
            for (s, i, a), (_, _, b) in zip(rec["jax"], rec["port"])]


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_nodeset.py
    jax.config.update("jax_enable_x64", True)
    rows = parting_table()
    held = max(d for s, _, d in rows if s < 9)
    print(f"held ramp steps 1-9: at most {held:.2e} V")
    for s, i, d in rows:
        if s == 9 and (i <= 3 or i == max(r[1] for r in rows if r[0] == 9)):
            print(f"release step, iteration {i}: {d:.2e} V")
