"""Mutual inductance (K) in the PyTorch port on the CPU, f64: examples/
xfmr.sp's DC, transient and AC against the JAX package; the cases of
tests/test_mutual.py on the port; K1e (the fused chunk's mutual history)
in its plain version against the port's non-fused loop and JAX's
``batched_transient(fused=False)`` on xfmr and on a transformer-coupled
half-wave rectifier; the K1 gate; the b0 row plan's mutual terms.  The
JAX computations (about 20 s of compiles on the CPU) are
``tests/goldens/mutual_jax.json``; ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_mutual.py`` remakes it with the JAX package.

JAX's Pallas kernel admits K but leaves the mutual history out of its
right-hand side, so K1e is held to the loops that keep it, not to that
kernel."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.ops import pallas_step
from circuitsimulator_tpu.parallel import montecarlo as jmc
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.ops import fused_step
from circuitsimulator_tpu_torch.ops.fused_step import rhs_plan
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

# one intra-op thread, as in every port test file (pytest-xdist shares
# the cores between workers)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XFMR = os.path.join(REPO, "examples", "xfmr.sp")
GOLDEN = os.path.join(REPO, "tests", "goldens", "mutual_jax.json")
J64 = JAX_OPTIONS.replace(dtype=jnp.float64)
TOL = 1e-9
B, STEPS, DT = 8, 100, 1e-8

# xfmr.sp's secondary with a diode and an RC load: the K terms inside
# K1's Newton loop (k = 1)
RECTIFIER = """* transformer-coupled half-wave rectifier
V1 src 0 SIN 0 1 1e5
Rs src p 10
L1 p 0 1m
L2 s 0 4m
K1 L1 L2 0.98
D1 s out
Rl out 0 1k
Cl out 0 100n
.TRAN 1e-8 5e-5
"""


def xfmr_net(k="0.8", extra=""):
    """tests/test_mutual.py's open-secondary transformer on a 100-points-a-
    period grid (the voltage ratio is grid-independent: both windings see
    the same BE difference of i1)."""
    return f"""* transformer
V1 in 0 SIN 0 1 1e5
R1 in p 10
L1 p 0 1m
L2 s 0 4m
R2 s 0 1e6
K1 L1 L2 {k}
{extra}.TRAN 1e-7 5e-5
"""


def node_eq(sim, name):
    return sim.circuit.nodes[sim.circuit.node_name_to_id[name]].eq_index


def k_lanes(params, seed):
    """B lanes of a K deck with ind_l (5%), mut_k (1%, at most 0.999) and
    res_r (2%) perturbed, drawn with numpy; lane 0 nominal."""
    rng = np.random.default_rng(seed)
    out = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
           for k, v in params.items()}
    for key, sigma in (("ind_l", 0.05), ("mut_k", 0.01), ("res_r", 0.02)):
        f = np.exp(sigma * rng.standard_normal(out[key].shape))
        f[0] = 1.0
        out[key] = out[key] * f
    out["mut_k"] = np.minimum(out["mut_k"], 0.999)
    return out


def jax_batched(js, lanes):
    """JAX's non-fused batched transient of the lanes, STEPS steps, under
    one jit (a vmap run eagerly costs seconds of small compiles)."""
    fn = jax.jit(lambda p: jmc.batched_transient(
        js.engine, p, DT, STEPS * DT, fused=False).x_final)
    return np.asarray(fn({k: jnp.asarray(v) for k, v in lanes.items()}))


def jax_results():
    """xfmr.sp in JAX: DC, 200 transient steps, its .AC sweep, and the
    batched transients of K1e's lanes on xfmr and the rectifier."""
    js = JaxSimulator.from_file(XFMR, opts=J64)
    res = js.transient(tstop=200 * DT)
    ac = js.ac()
    xs = np.asarray(ac.xs)
    jr = JaxSimulator.from_text(RECTIFIER, opts=J64)
    out = {"xfmr": {"dc": js.dc(), "xs": res.xs, "times": res.times,
                    "ac_re": xs.real, "ac_im": xs.imag, "freqs": ac.freqs,
                    "batched": jax_batched(js, port_lanes(XFMR, 3))},
           "rectifier": {"batched": jax_batched(
               jr, port_lanes(RECTIFIER, 4))}}
    return {d: {k: np.asarray(v).tolist() for k, v in r.items()}
            for d, r in out.items()}


def port_lanes(deck, seed):
    """K1e's lanes (``k_lanes``) from the port's params of the deck."""
    sim = (Simulator.from_file(deck, device="cpu") if deck == XFMR
           else Simulator.from_text(deck, device="cpu"))
    return k_lanes({k: v.numpy() for k, v in sim.params.items()}, seed)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return {d: {k: np.asarray(v) for k, v in r.items()}
                for d, r in json.load(f).items()}


@pytest.fixture(scope="module")
def jax_xfmr(golden):
    g = dict(golden["xfmr"])
    g["ac"] = g.pop("ac_re") + 1j * g.pop("ac_im")
    g["lanes"] = port_lanes(XFMR, 3)
    return g


@pytest.fixture(scope="module")
def jax_rectifier(golden):
    return {"lanes": port_lanes(RECTIFIER, 4),
            "batched": golden["rectifier"]["batched"]}


@pytest.fixture(scope="module")
def port_xfmr():
    return Simulator.from_file(XFMR, device="cpu")


# ---------------------------------------------------------------- xfmr
def test_xfmr_dc_matches_jax(jax_xfmr, port_xfmr):
    x = port_xfmr.dc().numpy()
    np.testing.assert_allclose(x, jax_xfmr["dc"], rtol=0, atol=TOL)


def test_xfmr_transient_matches_jax(jax_xfmr, port_xfmr):
    res = port_xfmr.transient(tstop=200 * DT)
    assert res.xs.shape == jax_xfmr["xs"].shape == (201, 6)
    np.testing.assert_allclose(res.times.numpy(), jax_xfmr["times"],
                               rtol=1e-15, atol=0)
    np.testing.assert_allclose(res.xs.numpy(), jax_xfmr["xs"], rtol=0,
                               atol=TOL)
    # the coupling is live: the secondary carries about 2x the primary
    assert np.abs(res.xs.numpy()[:, node_eq(port_xfmr, "s")]).max() > 1.0


def test_xfmr_ac_matches_jax(jax_xfmr, port_xfmr):
    res = port_xfmr.ac()
    np.testing.assert_array_equal(res.freqs, jax_xfmr["freqs"])
    np.testing.assert_allclose(res.xs, jax_xfmr["ac"], rtol=0, atol=TOL)


def test_ac_stamps_mutual_entries(port_xfmr):
    """B1's cross entries of the two branch rows are -M = -k sqrt(L1 L2)."""
    from circuitsimulator_tpu_torch.analysis.ac import ac_system_real
    eng = port_xfmr.engine
    _, B1, _, _ = ac_system_real(eng, port_xfmr.params, port_xfmr.dc(), 1.0)
    ka, kb = eng.mut_rows
    m = 0.98 * np.sqrt(1e-3 * 4e-3)
    assert float(B1[ka, kb]) == pytest.approx(-m, rel=1e-15)
    assert float(B1[kb, ka]) == pytest.approx(-m, rel=1e-15)


# ------------------------------------------- tests/test_mutual.py's cases
def _xs(text):
    return Simulator.from_text(text, device="cpu").transient().xs.numpy()


def _ratio(sim, xs):
    vp, vs = xs[:, node_eq(sim, "p")], xs[:, node_eq(sim, "s")]
    half = len(vp) // 2
    return np.linalg.norm(vs[half:]) / np.linalg.norm(vp[half:])


SUBCKT = """* subckt transformer
.SUBCKT xfmr a b
L1 a 0 1m
L2 b 0 4m
K1 L1 L2 0.8
.ENDS
V1 in 0 SIN 0 1 1e5
R1 in p 10
X1 p s xfmr
R2 s 0 1e6
.TRAN 1e-7 5e-5
"""


@pytest.mark.parametrize("case", ["k0_uncoupled", "symmetric",
                                  "secondary_ratio", "subckt",
                                  "unknown_inductor"])
def test_mutual_cases(case, capsys):
    if case == "k0_uncoupled":
        np.testing.assert_allclose(
            _xs(xfmr_net(k="0")),
            _xs(xfmr_net().replace("K1 L1 L2 0.8\n", "")), rtol=0,
            atol=1e-12)
    elif case == "symmetric":
        np.testing.assert_allclose(
            _xs(xfmr_net()),
            _xs(xfmr_net().replace("K1 L1 L2 0.8", "K1 L2 L1 0.8")),
            rtol=0, atol=1e-12)
    elif case in ("secondary_ratio", "subckt"):
        # secondary ~open: v2 / vL1 = M / L1 = k sqrt(L2 / L1) = 1.6
        sim = Simulator.from_text(xfmr_net() if case == "secondary_ratio"
                                  else SUBCKT, device="cpu")
        assert sim.topo.counts["K"] == 1
        assert _ratio(sim, sim.transient().xs.numpy()) == pytest.approx(
            1.6, rel=2e-2)
    else:
        sim = Simulator.from_text(
            "V1 a 0 DC 1\nR1 a b 1\nL1 b 0 1m\nK1 L1 Lzz 0.5\n.op\n",
            device="cpu")
        assert sim.topo.counts["K"] == 0
        assert "K element skipped" in capsys.readouterr().err
        assert np.isfinite(sim.dc().numpy()).all()


def test_ideal_transformer_input_impedance():
    """tests/test_mutual.py's loaded transformer through K3: the exact
    coupled-coil input impedance jwL1 + (wM)^2 / (R2 + jwL2)."""
    sim = Simulator.from_text("""* loaded transformer
V1 in 0 DC 0 AC 1
Vam in p 0
L1 p 0 1
L2 s 0 4
R2 s 0 100
K1 L1 L2 0.99999
.AC lin 1 1e5 1e5
""", device="cpu")
    (br,) = [e.branch_eq for e in sim.circuit.elements if e.name == "Vam"]
    z_in = 1.0 / sim.ac().xs[0, br]
    w, m = 2 * np.pi * 1e5, 0.99999 * 2.0
    assert z_in == pytest.approx(1j * w + (w * m) ** 2 / (100 + 4j * w),
                                 rel=1e-6)


# ---------------------------------------------------------------- K1e
def _k1e(sim, lanes):
    bp = params_from_numpy(lanes)
    fused = tmc.batched_transient(sim.engine, bp, DT, STEPS * DT, fused=True)
    loop = tmc.batched_transient(sim.engine, bp, DT, STEPS * DT,
                                 fused=False)
    assert not bool(fused.failed.any()) and not bool(loop.failed.any())
    return fused.x_final.numpy(), loop.x_final.numpy()


@pytest.mark.parametrize("deck", ["xfmr", "rectifier"])
def test_k1e_plain_matches_nonfused_and_jax(deck, jax_xfmr, jax_rectifier):
    """K1e's plain version (fused=True on CPU tensors) within 1e-9 V of the
    port's non-fused loop and of JAX's non-fused batched transient, on the
    same numpy-drawn lanes (inductors, couplings and resistors
    perturbed)."""
    ref = jax_xfmr if deck == "xfmr" else jax_rectifier
    sim = (Simulator.from_file(XFMR, device="cpu") if deck == "xfmr"
           else Simulator.from_text(RECTIFIER, device="cpu"))
    r = fused_step.FusedStepRunner(sim.engine,
                                   params_from_numpy(ref["lanes"]), DT)
    assert r.nK == 1 and r.k == (0 if deck == "xfmr" else 1)
    fused, loop = _k1e(sim, ref["lanes"])
    np.testing.assert_allclose(fused, loop, rtol=0, atol=TOL)
    np.testing.assert_allclose(fused, ref["batched"], rtol=0, atol=TOL)
    # the history term matters: without it the run lands elsewhere
    assert np.abs(fused[:, node_eq(sim, "s")]).max() > 0.05


def test_gate_admits_k(port_xfmr):
    """K is in K1's scope (K1e); the JAX gate admits it too."""
    assert "K" in fused_step.IN_SCOPE
    assert fused_step.unsupported_reason(port_xfmr.engine, DT) is None
    js = JaxSimulator.from_file(XFMR, opts=J64)
    assert pallas_step.supported(js.engine, DT)


def test_rhs_plan_carries_mutual_terms_in_scatter_order(port_xfmr):
    """The 2 nK mutual terms follow the EMFs, -gm il_b at row k_a (term
    2 m), -gm il_a at row k_b (term 2 m + 1); row n of b0 summed through the
    plan equals the sequential scatter bit for bit."""
    rng = np.random.default_rng(1)
    N, nS, nL, nC, nT, nK = 9, 3, 3, 4, 1, 2
    pos, neg = rng.integers(0, N + 1, nS), rng.integers(0, N + 1, nS)
    ind = rng.integers(0, N, nL)
    ca, cb = rng.integers(0, N + 1, nC), rng.integers(0, N + 1, nC)
    k1, k2 = rng.integers(0, N, nT), rng.integers(0, N, nT)
    ka, kb = ind[[0, 1]], ind[[2, 0]]
    n = nS + nL + nC + 2 * nT + 2 * nK
    terms = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)
    o_e, o_m = nS + nL + nC, nS + nL + nC + 2 * nT
    em, mt = terms[o_e:o_m], terms[o_m:]
    rows = np.concatenate([pos, neg, ind, ca, cb, k1, k2, ka, kb])
    vals = np.concatenate([terms[:nS], -terms[:nS], terms[nS:nS + nL],
                           terms[nS + nL:o_e], -terms[nS + nL:o_e],
                           em[0::2], em[1::2], mt[0::2], mt[1::2]])
    want = np.zeros(N + 1)
    for r, v in zip(rows, vals):            # the sequential scatter
        want[r] += v
    ptr, idx = rhs_plan(N, pos, neg, ind, ca, cb, (k1, k2), (ka, kb))
    got = np.zeros(N)
    for row in range(N):
        acc = 0.0
        for c in idx[ptr[row]:ptr[row + 1]]:
            acc = acc - terms[c >> 1] if c & 1 else acc + terms[c >> 1]
        got[row] = acc
    np.testing.assert_array_equal(got, want[:N])
    # xfmr's runner: two more b0 terms, on the two branch rows
    r = fused_step.FusedStepRunner(
        port_xfmr.engine, tmc.broadcast_params(port_xfmr.params, 2), DT)
    t = port_xfmr.topo
    assert r.n_terms == r.nS + r.nL + r.nCap + 2
    o_m = r.nS + r.nL + r.nCap
    ptr, idx = r.rhs_ptr.numpy(), r.rhs_idx.numpy()
    for term, row in ((o_m, t.ind_k[0]), (o_m + 1, t.ind_k[1])):
        assert term << 1 in idx[ptr[row]:ptr[row + 1]]
    np.testing.assert_array_equal(r.mut_plan.numpy(), [[0], [1]])
    m = 0.98 * np.sqrt(1e-3 * 4e-3)
    np.testing.assert_allclose(r.gm.numpy(), m / DT, rtol=1e-15)


THREE_WINDINGS = """* three coupled windings
V1 src 0 SIN 0 1 1e5
Rs src p 10
L1 p 0 1m
L2 s 0 4m
L3 t 0 2m
K1 L1 L2 0.8
K2 L2 L3 0.5
Rl s 0 1k
R3 t 0 500
.TRAN 1e-8 5e-5
"""


def test_k1e_two_k_cards_share_an_inductor():
    """Two K elements on three windings (L2 in both): K1e's plain version
    within 1e-9 V of the port's non-fused loop (the scatter sums both
    couplings into L2's row)."""
    sim = Simulator.from_text(THREE_WINDINGS, device="cpu")
    lanes = k_lanes({k: v.numpy() for k, v in sim.params.items()}, 5)
    assert fused_step.FusedStepRunner(
        sim.engine, params_from_numpy(lanes), DT).nK == 2
    fused, loop = _k1e(sim, lanes)
    np.testing.assert_allclose(fused, loop, rtol=0, atol=TOL)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    with open(GOLDEN, "w") as fh:
        json.dump(jax_results(), fh)
