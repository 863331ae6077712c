"""The Monte-Carlo measurement path of the PyTorch port on the CPU:
``batched_transient_measures`` on examples/mc_filter.sp with lanes drawn by
the JAX package (the non-fused loop and K1's plain version against JAX's
loop in f64), K1's probe stream (K1c-i: the plain version against the JAX
Pallas kernel in interpret mode with ``probe_mat``), ``batched_ac_measures``
and ``Simulator.monte_carlo``'s three branches."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.analysis import measure_stream as jstream
from circuitsimulator_tpu.parallel import montecarlo as jmc
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.analysis import measure_stream as tstream
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.ops import fused_step
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

from test_torch_fused_step import START_DC, damped, jax_runner
from test_torch_measure import DEVICE_DECK, jax_parse

# one intra-op thread, as in every port test file (pytest-xdist shares
# the cores between workers)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MC_FILTER = os.path.join(REPO, "examples", "mc_filter.sp")
# the JAX side of the batched-measures and probe-stream cases;
# ``PYTHONPATH=.:tests JAX_PLATFORMS=cpu python
# tests/test_torch_measure_mc.py`` remakes it with the JAX package
GOLDEN = os.path.join(REPO, "tests", "goldens", "measure_mc_jax.npz")

# a small MOS deck with transient measures: an inverter driven by a sine,
# its output's statistics and crossings (K1c-i against the JAX kernel)
MOS_MEASURE_DECK = """* MOS inverter with measures
.MODEL 2 VT 0.386 MU 3.0238e-2 COX 6.058e-3 LAMBDA 0.05 CJ0 4.0e-14
VDD 1 0 DC 3
Vin 2 0 SIN 1.0 0.6 2e7
M1 3 2 0 n 10e-6 0.35e-6 2
RL 1 3 5k
C1 3 0 0.2p
.TRAN 1n 60n
.MEASURE TRAN vmax MAX V(3)
.MEASURE TRAN vmin MIN V(3)
.MEASURE TRAN vavg AVG V(3) FROM=10n TO=60n
.MEASURE TRAN tfall WHEN V(3)=1.5 FALL=1
.MEASURE TRAN trise WHEN V(3)=1.5 RISE=1
.MEASURE TRAN vat FIND V(3) AT=30n
.MEASURE TRAN irms RMS I(VDD) FROM=0 TO=60n
"""


def jax_lanes(js, B, seed):
    """B lanes of the deck's DEV=/LOT= tolerances drawn by the JAX package
    (jitted), as numpy."""
    draw = jax.jit(lambda p, k: jmc.perturb_params_netlist(
        p, k, B, js.lowered.mc_tols))
    return {k: np.array(v) for k, v in
            draw(js.params, jax.random.key(seed)).items()}


def jax_tran16():
    """16 JAX-drawn lanes of mc_filter.sp and JAX's f64 measures of them
    (its loop, fused=False), recorded into the golden."""
    js = JaxSimulator.from_file(MC_FILTER)
    jp = jax_lanes(js, 16, 0)
    tran, ms = js.config.tran, js.config.measures
    _, want = jax.jit(lambda bp: jmc.batched_transient_measures(
        js.engine, bp, tran.tstep, tran.tstop, ms, js.topo,
        fused=False))({k: jnp.asarray(v) for k, v in jp.items()})
    return {**{f"tran16/lanes/{k}": v for k, v in jp.items()},
            **{f"tran16/want/{k}": np.asarray(v) for k, v in want.items()}}


@pytest.fixture(scope="module")
def jax_golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def sub(golden, prefix):
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in golden.items() if k.startswith(pre)}


def test_batched_transient_measures_match_jax_f64(jax_golden):
    """mc_filter.sp, 16 JAX-drawn lanes, its whole .TRAN in f64: the port's
    non-fused loop (fused=False) and K1's plain version with its probe
    stream (fused=True on CPU tensors) against JAX's loop (fused=False),
    within 1e-9 relative (the lanes and JAX's measures from the
    golden)."""
    jp = sub(jax_golden, "tran16/lanes")
    want = sub(jax_golden, "tran16/want")
    ts = Simulator.from_file(MC_FILTER, device="cpu")
    tran = ts.config.tran
    bp = params_from_numpy(jp)
    for fused in (False, True):
        res, got = tmc.batched_transient_measures(
            ts.engine, bp, tran.tstep, tran.tstop, ts.config.measures,
            ts.topo, fused=fused)
        assert res.xs is None and not bool(res.failed.any())
        assert set(got) == set(want) == {"settle", "vfinal"}
        for name, w in want.items():
            assert np.isfinite(w).all()
            np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-9,
                                       atol=0, err_msg=f"{name} {fused}")
    assert np.ptp(want["settle"]) > 1e-5          # the lanes differ


def _jax_measures(jsm, ys, y0, ts, dt):
    """JAX's accumulators over a raw (n, P, B) probe block (one jitted
    scan, as fused_transient_measures runs them)."""
    def run(ys, y0, ts):
        acc = jsm.init_vals(jsm.vals_from_raw(y0))
        raw = jnp.moveaxis(ys, 1, 2)

        def body(a, inp):
            y, t = inp
            return jsm.update_vals(a, y, t, jnp.asarray(dt, jnp.float32)), None

        acc, _ = lax.scan(body, acc, (jsm.vals_from_raw(raw), ts))
        return jsm.finalize(acc)

    return {k: np.asarray(v) for k, v in jax.jit(run)(ys, y0, ts).items()}


PROBE_B, PROBE_DT, PROBE_STEPS = 128, 1e-9, 60


def probe_inputs(params):
    """The probe-stream case's lanes (numpy, from the deck's f32 params:
    R and VT lognormal) and each lane's f32 start from the port's f64
    batched DC."""
    rng = np.random.default_rng(2)
    jp = {k: np.broadcast_to(np.asarray(v), (PROBE_B,) + np.shape(v)).copy()
          for k, v in params.items()}
    for key, sigma in (("res_r", 0.05), ("mos_vth", 0.03)):
        jp[key] = jp[key] * np.exp(sigma * rng.standard_normal(
            jp[key].shape)).astype(jp[key].dtype)
    x64 = Simulator.from_text(MOS_MEASURE_DECK, device="cpu",
                              opts=DEFAULT_OPTIONS.replace(**START_DC))
    return jp, tmc.batched_dc_fast(x64.engine,
                                   params_from_numpy(jp)).float()


def jax_probe():
    """The JAX kernel's probe block (interpret mode, PallasStepRunner with
    probe_mat) and the JAX accumulators' measures of it, recorded into the
    golden."""
    B, dt, steps = PROBE_B, PROBE_DT, PROBE_STEPS
    js = JaxSimulator.from_text(MOS_MEASURE_DECK,
                                opts=damped(JAX_OPTIONS, jnp.float32))
    jp, x0 = probe_inputs(js.params)
    jsm = jstream.StreamingMeasures(js.config.measures, js.topo, jnp.float32)
    je = js.engine
    runner = jax_runner(je, {k: jnp.asarray(v) for k, v in jp.items()}, dt,
                        probe_mat=jsm.probe_matrix)
    jx0 = jnp.asarray(x0.numpy())
    st0 = jax.jit(jax.vmap(je.init_state))(jx0)
    want = runner.run_chunk(jx0, jx0, st0["vc"], st0["il"],
                            jnp.zeros((B,), bool), 0, steps, interpret=True)
    jys = np.asarray(want[6])
    t_axis = np.arange(1, steps + 1, dtype=np.float32) * np.float32(dt)
    jvals = _jax_measures(jsm, jnp.asarray(jys), jnp.asarray(
        x0.numpy() @ np.asarray(jsm.probe_matrix).T), jnp.asarray(t_axis),
        dt)
    return {"probe/ys": jys, "probe/failed": np.asarray(want[4]),
            "probe/probe_mat": np.asarray(jsm.probe_matrix),
            "probe/res_r": jp["res_r"], "probe/mos_vth": jp["mos_vth"],
            **{f"probe/vals/{k}": v for k, v in jvals.items()}}


def test_probe_stream_plain_matches_jax_pallas_kernel(jax_golden):
    """K1c-i on a small MOS deck in f32, B = 128, 60 steps of 1 ns from each
    lane's DC point (the port's f64 batched DC): the plain version's probe
    block against the JAX kernel's (interpret mode, PallasStepRunner with
    probe_mat; tests/goldens/measure_mc_jax.npz) within 1e-4 V, the K1
    tolerance of the MOS, junction and
    charge-model interpret cases of tests/test_torch_fused_step.py (f32
    rounding in another summation order: about 7e-6 V after 60 steps), and
    the measures the accumulators make of each block within
    rtol 2e-4, atol 2e-6 (the bar of tests/test_pallas_step.py's fused
    streaming case).  The last tile of the block is probe_mat @ x_out bit
    for bit."""
    B, dt, steps = PROBE_B, PROBE_DT, PROBE_STEPS
    g = sub(jax_golden, "probe")
    ts = Simulator.from_text(MOS_MEASURE_DECK, device="cpu",
                             opts=damped(DEFAULT_OPTIONS, torch.float32))
    jp, x0 = probe_inputs({k: v.numpy() for k, v in ts.params.items()})
    for key in ("res_r", "mos_vth"):
        np.testing.assert_array_equal(jp[key], g[key])
    jys = g["ys"]
    sm = tstream.StreamingMeasures(ts.config.measures, ts.topo,
                                   torch.float32)
    np.testing.assert_array_equal(sm.probe_matrix.numpy(), g["probe_mat"])
    tp = params_from_numpy(jp, dtype=torch.float32)
    tr = fused_step.FusedStepRunner(ts.engine, tp, dt,
                                    probe_mat=sm.probe_matrix)
    st = ts.engine.init_state(x0)
    got = tr.run_chunk(x0, x0, st["vc"], st["il"],
                       torch.zeros((B,), dtype=torch.bool), 0, steps)
    assert len(got) == 7 and got[6].shape == (steps, sm.probe_matrix.shape[0],
                                              B)
    assert not bool(got[4].any()) and not g["failed"].any()
    np.testing.assert_allclose(got[6].numpy(), jys, rtol=0, atol=1e-4)
    assert torch.equal(got[6][-1], sm.probe_matrix @ got[0].T)

    t_axis = np.arange(1, steps + 1, dtype=np.float32) * np.float32(dt)
    jvals = sub(g, "vals")
    acc = sm.init(ts.engine, x0)
    ys = sm.vals_from_raw(got[6].transpose(1, 2))
    dt_t = torch.tensor(dt, dtype=torch.float32)
    for i, t in enumerate(torch.as_tensor(t_axis)):
        acc = sm.update_vals(acc, ys[i], t, dt_t)
    tvals = sm.finalize(acc)
    for name, w in jvals.items():
        assert np.isfinite(w).all(), name
        np.testing.assert_allclose(tvals[name].numpy(), w, rtol=2e-4,
                                   atol=2e-6, err_msg=name)
    with pytest.raises(NotImplementedError, match="probes > 64"):
        fused_step.FusedStepRunner(ts.engine, tp, dt,
                                   probe_mat=torch.zeros((65, ts.engine.N)))


def test_monte_carlo_branches():
    """Simulator.monte_carlo on the CPU: the transient branch on
    mc_filter.sp (per-lane settle and vfinal, lanes that differ), the AC
    branch (tests/test_mc_netlist.py's deck: the -3 dB corner of each lane
    and a derived measure), the DC branch with LOT-only tolerances (a
    matched divider that never moves), the DC branch of a nonlinear deck
    (warm-started lanes on the batched DC's fixpoint within 1e-6 V), and a
    derived transient measure over a .PARAM name (NaN, as in JAX)."""
    sim = Simulator.from_file(MC_FILTER, device="cpu")
    bp, vals = sim.monte_carlo(8, seed=1)
    assert set(vals) == {"settle", "vfinal"}
    assert bp["res_r"].shape == (8, 2) and float(vals["settle"].std()) > 0
    np.testing.assert_allclose(vals["vfinal"].numpy(), 0.995, atol=5e-3)
    ac = Simulator.from_text("""* mc ac
V1 in 0 DC 0 AC 1
R1 in out 1k DEV=5%
C1 out 0 159.155n DEV=5%
.AC DEC 20 10 100k
.MEASURE AC bw WHEN VDB(out)=-3 FALL=1
.MEASURE AC g0 FIND VM(out) AT=10
.MEASURE AC margin PARAM='bw/1000'
""", device="cpu")
    _, av = ac.monte_carlo(32, seed=5)
    assert av["bw"].shape == (32,) and abs(av["bw"].mean() - 1000) < 150
    np.testing.assert_allclose(av["g0"], 1.0, atol=1e-3)
    np.testing.assert_allclose(av["margin"], av["bw"] / 1000, rtol=1e-12)
    lot = Simulator.from_text("""* lot only
V1 in 0 DC 1
R1 in out 1k LOT=10%
R2 out 0 1k LOT=10%
.op
""", device="cpu")
    bp, xs = lot.monte_carlo(16, seed=2)
    r = bp["res_r"]
    assert float((r[:, 0] - r[:, 1]).abs().max()) < 1e-9
    assert float(r[:, 0].std()) > 10.0
    out = lot.circuit.nodes[lot.circuit.node_name_to_id["out"]].eq_index
    assert float((xs[:, out] - 0.5).abs().max()) < 1e-6
    # a nonlinear deck's DC branch: every lane warm-starts from the
    # nominal DC (batched_dc_warm) and lands on the batched DC's fixpoint
    dev = Simulator.from_text(DEVICE_DECK, device="cpu")
    bp, xs = dev.monte_carlo(16, seed=3)
    assert xs.shape == (16, dev.engine.N) and bool(torch.isfinite(xs).all())
    assert float(bp["mos_vth"].std()) > 0 and float(bp["bjt_bf"].std()) > 0
    np.testing.assert_allclose(xs.numpy(), tmc.batched_dc_fast(
        dev.engine, bp).numpy(), rtol=0, atol=1e-6)
    # a derived transient measure over a .PARAM name: the JAX facade
    # hands its transient branch no .PARAM bindings (api.py:1777-1780), so
    # the JAX evaluator gives NaN on those lanes, and so does the port
    text = """* mc rc derived
.PARAM k=2
V1 in 0 PULSE(0 1 0 1n 1n 1 1)
R1 in out 1k DEV=10%
C1 out 0 1u
.TRAN 5e-5 1e-3
.MEASURE TRAN vend FIND V(out) AT=5e-4
.MEASURE TRAN twice PARAM='k*vend'
"""
    _, rv = Simulator.from_text(text, device="cpu").monte_carlo(8, seed=3)
    want = jstream.apply_derived_measures(
        jax_parse(text)[1].measures, {"vend": rv["vend"].numpy()})
    assert bool(torch.isfinite(rv["vend"]).all())
    assert np.isnan(want["twice"]).all() and np.isnan(rv["twice"]).all()
    with pytest.raises(ValueError, match="DEV=/LOT="):
        Simulator.from_text("V1 a 0 DC 1\nR1 a 0 1k\n.op\n",
                            device="cpu").monte_carlo(4)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(GOLDEN, **jax_tran16(), **jax_probe())
