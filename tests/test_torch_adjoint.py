"""The port's differentiation stack on the CPU, f64, against the JAX
package: ``ops/lu.lu_solve_diff`` (against ``jax.grad`` through JAX's
``lu_solve``, live), ``analysis/adjoint`` (``diff_transient``,
``transient_adjoint_gradient``), ``analysis/sensitivity.
transient_sensitivity`` and ``analysis/measure_diff`` (values against
JAX's and against the port's host evaluator; gradients through the
adjoint).  The JAX transients, adjoints, tangents and measures are
``tests/goldens/adjoint_jax.json`` (each compiles for 4-15 s on the CPU,
and JAX's eager measure layer takes 8 s); ``JAX_PLATFORMS=cpu python
tests/test_torch_adjoint.py`` remakes it with the JAX package.

Decks: a diode + sine + time-dependent B-source deck (tests/test_adjoint.py's
two decks merged, 12 steps), tests/test_adjoint.py's T-line deck (100
steps) and tests/test_measure_diff.py's measure deck (every
differentiable kind; 100 steps).  Bars: xs within 1e-9 V; adjoint
gradients and measure gradients within 1e-6 of each leaf's largest entry;
``transient_sensitivity`` within 1e-6 of the peak |dx|; measure values
1e-9 relative; ``lu_solve_diff``'s gradients 1e-10 of the largest."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitsimulator_tpu.ops.lu import lu_solve as jax_lu_solve
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.analysis import measure as tmeas
from circuitsimulator_tpu_torch.analysis.adjoint import (
    diff_transient, transient_adjoint_gradient)
from circuitsimulator_tpu_torch.analysis.measure_diff import (
    diff_measure, diff_measure_ac)
from circuitsimulator_tpu_torch.analysis.sensitivity import (
    transient_sensitivity, unit_tangent)
from circuitsimulator_tpu_torch.ops.lu import lu_solve_diff

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "adjoint_jax.json")
F64 = DEFAULT_OPTIONS.replace(dtype=torch.float64, tran_solver="lu")

MERGED = """* diode, sine and a time-dependent B source
V1 in 0 SIN 0.4 0.3 2e6
R1 in a 1k
C1 a 0 100p
D1 a 0 IS=1e-13 N=1
RL a 0 5k
B1 a 0 I=0.1m*v(a)*sin(6.283e6*time)
.TRAN 5e-9 6e-8
"""

TLINE = """* matched line
V1 in 0 SIN 0 1 5e6
RS in a 50
T1 a 0 b 0 Z0=50 TD=5e-9
RL b 0 75
.TRAN 1e-9 1e-7
"""

MEASURES = """* measure zoo
V1 in 0 PULSE(0 1 1e-5 1e-5 1e-5 2e-4 5e-4)
R1 in out 1k
C1 out 0 20n
RL out 0 10k
.TRAN 5e-6 5e-4
.MEASURE TRAN m_avg AVG V(out) FROM=1e-4 TO=6e-4
.MEASURE TRAN m_rms RMS V(out) FROM=5e-5 TO=9e-4
.MEASURE TRAN m_min MIN V(out) FROM=0 TO=1e-3
.MEASURE TRAN m_max MAX V(out)
.MEASURE TRAN m_pp PP V(out) FROM=1e-5 TO=9e-4
.MEASURE TRAN m_integ INTEG V(out) FROM=0 TO=5e-4
.MEASURE TRAN m_when WHEN V(out)=0.4 RISE=1
.MEASURE TRAN m_when2 WHEN V(out)=0.3 FALL=1 TD=2e-4
.MEASURE TRAN m_find FIND V(out) AT=3e-4
.MEASURE TRAN m_delay TRIG V(in) VAL=0.5 RISE=1 TARG V(out) VAL=0.5 RISE=1
.MEASURE TRAN m_fw FIND V(in) WHEN V(out)=0.35 RISE=1
.end
"""

LOWPASS = """* rf lowpass
V1 in 0 DC 0 AC 1
R1 in out 1k
C1 out 0 159.15494n
.AC DEC 20 10 100k
.MEASURE AC bw WHEN VDB(out)=-3 FALL=1
.MEASURE AC gmax MAX VDB(out)
.MEASURE AC ph1k FIND VP(out) AT=1e3
.MEASURE AC f_ph WHEN VP(out)=-60 FALL=1
.end
"""

DECKS = {"merged": MERGED, "tline": TLINE, "measures": MEASURES}
# the loss node of each adjoint deck
LOSS_NODE = {"merged": "a", "tline": "b"}
SENS_DIRS = [("dio_is", 0), ("res_r", 1)]
GRAD_MEASURES = ["m_avg", "m_pp", "m_when", "m_delay", "m_fw"]
GRAD_LEAVES = ["cap_c", "res_r"]


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _sim(name):
    return Simulator.from_text(DECKS[name], opts=F64, device="cpu")


def _leaf_err(got, want):
    """max |got - want| over max |want| (0 when both are 0)."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    peak = float(np.abs(want).max()) if want.size else 0.0
    diff = float(np.abs(got - want).max()) if want.size else 0.0
    return diff / peak if peak > 0 else diff


def test_lu_solve_diff_against_jax_grad():
    """Reverse-mode through the plain version against jax.grad through
    JAX's unrolled LU on the same batch, a lane zeroed by the fail
    contract included (its cotangents are zero), and A broadcast over the
    right-hand sides (its cotangent summed)."""
    rng = np.random.default_rng(0)
    F, N = 4, 4
    A = rng.normal(size=(F, N, N)) + 3.0 * np.eye(N)
    b = rng.normal(size=(F, N))
    w = rng.normal(size=(F, N))
    A[2] = 0.0
    A[2, 0, 0] = 1e-20                       # below the pivot floor

    def jloss(A_, b_):
        return jnp.sum(jax.vmap(jax_lu_solve)(A_, b_) * w)

    gA, gb = jax.jit(jax.grad(jloss, (0, 1)))(A, b)
    At = torch.tensor(A, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    (lu_solve_diff(At, bt) * torch.tensor(w)).sum().backward()
    assert _leaf_err(At.grad.numpy(), gA) <= 1e-10
    assert _leaf_err(bt.grad.numpy(), gb) <= 1e-10
    assert not At.grad[2].any() and not bt.grad[2].any()
    # one matrix broadcast over the right-hand sides: its cotangent is
    # the sum of the lanes' cotangents of F copies
    A1 = torch.tensor(A[0], requires_grad=True)
    copies = torch.tensor(A[0]).expand(F, N, N).clone().requires_grad_()
    for a in (A1.expand(F, N, N), copies):
        (lu_solve_diff(a, torch.tensor(b)) * torch.tensor(w)).sum().backward()
    assert A1.grad.shape == (N, N)
    assert _leaf_err(A1.grad.numpy(), copies.grad.sum(0).numpy()) <= 1e-14


@pytest.mark.parametrize("deck", ["merged", "tline"])
def test_diff_transient_and_adjoint_gradient(golden, deck):
    """diff_transient's xs within 1e-9 V of JAX's; the loss sum(V(node)^2)
    and its gradient with respect to every float leaf within 1e-6 of each
    leaf's largest entry; integer leaves get zeros."""
    g = golden[deck]
    sim = _sim(deck)
    eq = sim._node_eq(LOSS_NODE[deck])
    tr = sim.config.tran
    times, xs = diff_transient(sim.engine, sim.params, tr.tstep, tr.tstop)
    assert np.abs(xs.numpy() - np.asarray(g["xs"])).max() <= 1e-9
    assert np.abs(times.numpy() - np.asarray(g["times"])).max() <= 1e-20
    val, grads = transient_adjoint_gradient(
        sim.engine, sim.params, tr.tstep, tr.tstop,
        lambda t, x: (x[:, eq] ** 2).sum() * 1e3)
    assert abs(float(val) - g["loss"]) <= 1e-12 * abs(g["loss"])
    assert set(g["grads"]) <= set(grads)
    moved = 0
    for k, want in g["grads"].items():
        err = _leaf_err(grads[k].numpy(), want)
        assert err <= 1e-6, (k, err)
        moved += bool(np.any(np.asarray(want) != 0))
    assert moved >= 4
    for k, v in sim.params.items():
        if not v.is_floating_point():
            assert not grads[k].any() and grads[k].dtype == torch.float64


@pytest.mark.parametrize("key,idx", SENS_DIRS)
def test_transient_sensitivity(golden, key, idx):
    """The forward tangent through the DC and every Newton iteration:
    within 1e-6 of the peak |dx| of JAX's jax.jvp through run_transient,
    its xs within 1e-9 V."""
    g = golden["sensitivity"][f"{key}[{idx}]"]
    sim = _sim("merged")
    tr = sim.config.tran
    xs, dxs = transient_sensitivity(sim.engine, sim.params,
                                    unit_tangent(sim.params, key, idx),
                                    tr.tstep, tr.tstop)
    assert np.abs(xs.numpy() - np.asarray(g["xs"])).max() <= 1e-9
    assert _leaf_err(dxs.numpy(), g["dxs"]) <= 1e-6


def test_unit_tangent():
    p = _sim("merged").params
    t = unit_tangent(p, "res_r", 1)
    assert float(t["res_r"][1]) == 1.0 and float(t["res_r"].sum()) == 1.0
    assert all(not v.any() for k, v in t.items() if k != "res_r")
    assert bool((unit_tangent(p, "vs_sin")["vs_sin"] == 1.0).all())


def test_diff_measure_values(golden):
    """Every differentiable kind on the port's own transient: the value of
    the port's host evaluator on the same waveform and of JAX's
    diff_measure on JAX's transient, 1e-9 relative; the AC kinds on the
    lowpass's sweep likewise."""
    sim = _sim("measures")
    res = sim.transient()
    t, xs = res.times, res.xs
    host = dict(tmeas.run_measures(sim.config.measures, sim.topo,
                                   t.numpy(), xs.numpy()))
    assert set(golden["measure_values"]) == set(host)
    for m in sim.config.measures:
        v = float(diff_measure(m, sim.topo)(t, xs))
        assert math.isfinite(v), m.name
        for want in (host[m.name], golden["measure_values"][m.name]):
            assert v == pytest.approx(want, rel=1e-9, abs=1e-15), m.name
    ac_sim = Simulator.from_text(LOWPASS, opts=F64, device="cpu")
    ac = ac_sim.ac()
    f = torch.as_tensor(ac.freqs)
    xr = torch.as_tensor(ac.xs.real.copy())
    xi = torch.as_tensor(ac.xs.imag.copy())
    host = dict(tmeas.run_measures(ac_sim.config.measures, ac_sim.topo,
                                   ac.freqs, ac.xs, "ac"))
    for m in ac_sim.config.measures:
        v = float(diff_measure_ac(m, ac_sim.topo)(f, xr, xi))
        for want in (host[m.name], golden["measure_values_ac"][m.name]):
            assert v == pytest.approx(want, rel=1e-9), m.name


def test_diff_measure_gradients(golden):
    """d measure / d (cap_c, res_r) through the adjoint: within 1e-6 of
    each measure's largest entry of JAX's; one forward transient, one
    backward sweep per measure."""
    g = golden["measure_grads"]
    sim = _sim("measures")
    tr = sim.config.tran
    leaves = {k: sim.params[k].detach().clone().requires_grad_()
              for k in GRAD_LEAVES}
    t, xs = diff_transient(sim.engine, {**sim.params, **leaves}, tr.tstep,
                           tr.tstop)
    ms = {m.name: m for m in sim.config.measures}
    for name in GRAD_MEASURES:
        v = diff_measure(ms[name], sim.topo)(t, xs)
        got = torch.autograd.grad(v, list(leaves.values()),
                                  retain_graph=True)
        assert float(v.detach()) == pytest.approx(g[name]["value"],
                                                  rel=1e-9), name
        flat = np.concatenate([x.numpy().ravel() for x in got])
        want = np.concatenate([np.ravel(g[name]["grad"][k])
                               for k in GRAD_LEAVES])
        assert _leaf_err(flat, want) <= 1e-6, name
    assert float(g["m_delay"]["grad"]["cap_c"][0]) > 0


def test_diff_measure_errors():
    sim = _sim("measures")
    ms = {m.name: m for m in sim.config.measures}
    bad = ms["m_max"].__class__(**{**vars(ms["m_max"]), "stat": "max_at"})
    with pytest.raises(NotImplementedError, match="max_at"):
        diff_measure(bad, sim.topo)(torch.zeros(3), torch.zeros(3, 3))
    derived = ms["m_max"].__class__(**{**vars(ms["m_max"]), "kind": "param"})
    with pytest.raises(NotImplementedError, match="not differentiable"):
        diff_measure(derived, sim.topo)
    probe = ms["m_max"].probe.__class__(kind="nv", node1="nowhere")
    with pytest.raises(KeyError, match="nowhere"):
        diff_measure(ms["m_max"].__class__(**{**vars(ms["m_max"]),
                                              "probe": probe}), sim.topo)


def make_golden():
    """The JAX package's transients, adjoint gradients, tangents and measure
    gradients (float64 on the CPU) into tests/goldens/adjoint_jax.json."""
    jax.config.update("jax_enable_x64", True)
    from circuitsimulator_tpu import Simulator as JaxSimulator
    from circuitsimulator_tpu.analysis.adjoint import diff_transient as jdt
    from circuitsimulator_tpu.analysis.measure_diff import (
        diff_measure as jax_diff_measure,
        diff_measure_ac as jax_diff_measure_ac)
    from circuitsimulator_tpu.analysis.sensitivity import (
        transient_sensitivity as jts, unit_tangent as jut)
    from circuitsimulator_tpu.utils.options import DEFAULT_OPTIONS as JOPTS
    opts = JOPTS.replace(dtype=jnp.float64, tran_solver="lu")

    def host(a):
        return np.asarray(a).tolist()

    def jsim(name):
        return JaxSimulator.from_text(DECKS[name], opts=opts)

    out = {}
    for deck in ("merged", "tline"):
        s = jsim(deck)
        tr = s.config.tran
        eq = s.circuit.nodes[s.circuit.node_name_to_id[
            LOSS_NODE[deck]]].eq_index
        fk = [k for k, v in s.params.items()
              if jnp.issubdtype(v.dtype, jnp.floating)]
        rest = {k: v for k, v in s.params.items() if k not in fk}

        def obj(pf, s=s, tr=tr, eq=eq, rest=rest):
            t, xs = jdt(s.engine, {**pf, **rest}, tr.tstep, tr.tstop)
            return jnp.sum(xs[:, eq] ** 2) * 1e3, (t, xs)

        (val, (t, xs)), g = jax.jit(jax.value_and_grad(obj, has_aux=True))(
            {k: s.params[k] for k in fk})
        out[deck] = {"times": host(t), "xs": host(xs), "loss": float(val),
                     "grads": {k: host(v) for k, v in g.items()}}
    s = jsim("merged")
    tr = s.config.tran
    sens = jax.jit(lambda p, tan: jts(s.engine, p, tan, tr.tstep, tr.tstop))
    out["sensitivity"] = {}
    for key, idx in SENS_DIRS:
        xs, dxs = sens(s.params, jut(s.params, key, idx))
        out["sensitivity"][f"{key}[{idx}]"] = {"xs": host(xs),
                                              "dxs": host(dxs)}
    s = jsim("measures")
    tr = s.config.tran
    res = s.transient()
    out["measure_values"] = {m.name: float(jax_diff_measure(m, s.topo)(
        res.times, res.xs)) for m in s.config.measures}
    a = JaxSimulator.from_text(LOWPASS, opts=opts)
    ac = a.ac()
    xr, xi = jnp.real(jnp.asarray(ac.xs)), jnp.imag(jnp.asarray(ac.xs))
    out["measure_values_ac"] = {m.name: float(jax_diff_measure_ac(
        m, a.topo)(jnp.asarray(ac.freqs), xr, xi))
        for m in a.config.measures}
    ms = {m.name: m for m in s.config.measures}
    out["measure_grads"] = {}
    for name in GRAD_MEASURES:
        f = jax_diff_measure(ms[name], s.topo)

        def value(pd, f=f):
            t, xs = jdt(s.engine, {**s.params, **pd}, tr.tstep, tr.tstop)
            return f(t, xs)

        v, gd = jax.jit(jax.value_and_grad(value))(
            {k: s.params[k] for k in GRAD_LEAVES})
        out["measure_grads"][name] = {
            "value": float(v), "grad": {k: host(x) for k, x in gd.items()}}
    with open(GOLDEN, "w") as fh:
        json.dump(out, fh)


if __name__ == "__main__":
    make_golden()
