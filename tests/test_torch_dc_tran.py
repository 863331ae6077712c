"""The DC + Backward-Euler slice of the PyTorch port against the goldens and
the JAX package (CPU): single-lane dbmixer, the batched Monte-Carlo DC and
the batched fast-Newton transient on lanes drawn with numpy, plus the
guarantee that the port never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.analysis.transient import transient_step_fn
from circuitsimulator_tpu.parallel import montecarlo as jmc
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DBMIXER = os.path.join(REPO, "tests", "netlists", "dbmixer.sp")
SIGMAS = {"res_r": 0.01, "mos_vth": 0.02, "cap_c": 0.02}


def draw_lanes(params, B, seed):
    """B lanes of the JAX params with lognormal factors on SIGMAS' leaves,
    drawn with numpy (``jmc.perturb_params`` run eagerly dispatches its
    operations one by one: about a second and a half per call)."""
    rng = np.random.default_rng(seed)
    out = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
           for k, v in params.items()}
    for key, sigma in SIGMAS.items():
        out[key] = out[key] * np.exp(sigma * rng.standard_normal(
            out[key].shape)).astype(out[key].dtype)
    return {k: jnp.asarray(v) for k, v in out.items()}


def golden(name, rows):
    return np.loadtxt(os.path.join(REPO, "tests", "goldens", name),
                      delimiter=",", skiprows=1, max_rows=rows)


def csv_columns(topo):
    return np.concatenate([topo.volt_col_eqs, topo.branch_col_eqs])


def fast_options(dtype, opts):
    """bench.py's Monte-Carlo fast configuration (f32 tolerances)."""
    return opts.replace(dtype=dtype, tran_tol=1e-5, dc_tol=1e-5,
                        tran_alpha=1.0, tran_predictor=True,
                        tran_max_newton_iters=6, tran_unrolled_iters=2)


@pytest.fixture(scope="module")
def dbmixer_200():
    sim = Simulator.from_file(DBMIXER, device="cpu")
    return sim, sim.transient(tstop=200 * 1e-13)


def test_dbmixer_200_steps_match_golden(dbmixer_200):
    sim, res = dbmixer_200
    assert not bool(res.failed)
    ref = golden("dbmixer_tran.csv", 201)
    np.testing.assert_allclose(res.times.numpy(), ref[:, 0], rtol=1e-9)
    err = np.abs(res.xs.numpy()[:, csv_columns(sim.topo)] - ref[:, 1:]).max()
    assert err <= 1e-9, err


def test_dbmixer_200_steps_match_jax(dbmixer_200):
    sim, res = dbmixer_200
    jres = JaxSimulator.from_file(DBMIXER).transient(tstop=200 * 1e-13)
    np.testing.assert_allclose(res.xs.numpy(), np.asarray(jres.xs),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(res.newton_iters.numpy(),
                                  np.asarray(jres.newton_iters))


def test_batched_dc_fast_matches_jax():
    js = JaxSimulator.from_file(DBMIXER)
    jp = draw_lanes(js.params, 4, seed=11)
    want = np.asarray(jax.jit(lambda p: jmc.batched_dc_fast(js.engine, p))(jp))
    ts = Simulator.from_file(DBMIXER, device="cpu")
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()})
    got = tmc.batched_dc_fast(ts.engine, tp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_batched_fast_transient_f32_matches_jax():
    B, n = 4, 20
    js = JaxSimulator.from_file(
        DBMIXER, opts=fast_options(jnp.float32, JAX_OPTIONS))
    je = js.engine
    jp = draw_lanes(js.params, B, seed=42)
    dt = float(js.config.tran.tstep)

    @jax.jit
    def ref(bp):
        x0 = jmc.batched_dc_fast(je, bp)
        carry = (x0, x0, je.init_state(x0), jnp.zeros((B,), bool))
        ts = jnp.arange(1, n + 1, dtype=jnp.float32) * jnp.float32(dt)

        def lane(p, c):
            step = transient_step_fn(je, p, jnp.asarray(dt, jnp.float32),
                                     predictor=True)
            c, (xs, _) = lax.scan(step, c, ts)
            return c[-1], xs

        failed, xs = jax.vmap(lane)(bp, carry)
        return x0, failed, xs

    jx0, jfailed, jxs = (np.asarray(a) for a in ref(jp))

    ts_ = Simulator.from_file(
        DBMIXER, device="cpu", opts=fast_options(torch.float32,
                                                 DEFAULT_OPTIONS))
    te = ts_.engine
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()},
                           dtype=torch.float32)
    x0 = tmc.batched_dc_fast(te, tp)
    np.testing.assert_allclose(x0.numpy(), jx0, rtol=0, atol=1e-4)
    carry = tmc.init_carry(te, x0)
    tgrid = torch.arange(1, n + 1, dtype=torch.float32) * torch.tensor(
        dt, dtype=torch.float32)
    carry, _, lane0 = tmc.batched_transient_chunk(te, tp, carry, tgrid[:10],
                                                  dt, record_lane=0)
    np.testing.assert_allclose(carry[0].numpy(), jxs[:, 9], rtol=0,
                               atol=1e-4)
    carry, _ = tmc.batched_transient_chunk(te, tp, carry, tgrid[10:], dt)
    np.testing.assert_allclose(carry[0].numpy(), jxs[:, -1], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(lane0.numpy(), jxs[0, :10], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(carry[-1].numpy(), jfailed)


def test_perturb_params_draws_lognormal_lanes():
    sim = Simulator.from_file(DBMIXER, device="cpu")
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    bp = tmc.perturb_params(sim.params, g1, 4096, {"res_r": 0.05})
    again = tmc.perturb_params(sim.params, g2, 4096, {"res_r": 0.05})
    torch.testing.assert_close(bp["res_r"], again["res_r"], rtol=0, atol=0)
    z = torch.log(bp["res_r"] / sim.params["res_r"]) / 0.05
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02
    assert torch.equal(bp["cap_c"][5], sim.params["cap_c"])


@pytest.mark.parametrize("card,what", [
    # mutual inductance (K) was refused here until the port stamped it; a
    # ladder past 128 node equations runs on the large-circuit backends,
    # and the fused chunk (K1) refuses it by its size
    ("\n".join(f"RL{i} {i} {i + 1} 1" for i in range(1, 131)),
     r"N = 132 > 64 unknowns"),
    # METHOD=TRAP runs since the trapezoidal companions were ported; the
    # fused chunk (K1) stays Backward Euler only, as JAX's kernel does
    (".OPTIONS METHOD=TRAP", "METHOD=TRAP"),
])
def test_unported_features_raise_by_name(card, what):
    deck = f"* t\nV1 1 0 DC 1\nR1 1 0 1k\n{card}\n.TRAN 1n 10n\n.end\n"
    with pytest.raises(NotImplementedError, match=what):
        sim = Simulator.from_text(deck, device="cpu")
        tmc.batched_transient(sim.engine, tmc.broadcast_params(sim.params, 2),
                              1e-9, 1e-8, fused=True)


@pytest.mark.parametrize("card,noisy", [
    ("I2 0 2 DC 0 TRNOISE(1m 1n)\nR2 2 0 1k", ([], [0])),
    ("V2 2 0 DC 0 TRNOISE(1m 1n)\nR2 2 0 1k", ([1], [])),
])
def test_trnoise_cards_construct(card, noisy):
    """The two TRNOISE cards that were refused before the port had noise:
    the decks now construct, report has_trnoise and the noisy source
    (V2 is the second V source, I2 the only I source), and run noisy with
    a seed and noise-free without one."""
    deck = f"* t\nV1 1 0 DC 1\nR1 1 0 1k\n{card}\n.TRAN 1n 10n\n.end\n"
    sim = Simulator.from_text(deck, device="cpu")
    eng = sim.engine
    assert eng.has_trnoise and not (eng.vs_flicker or eng.is_flicker)
    assert (list(eng.vs_noisy), list(eng.is_noisy)) == noisy
    x = sim.dc()
    noisy_v2 = sim.transient(x_op=x, tstop=3e-9).xs[1:, 1]
    quiet_v2 = sim.transient(x_op=x, tstop=3e-9, noise_seed=None).xs[1:, 1]
    assert bool((quiet_v2 == 0).all()) and bool((noisy_v2 != 0).all())


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import circuitsimulator_tpu_torch\n"
            "from circuitsimulator_tpu_torch.analysis import ac\n"
            "from circuitsimulator_tpu_torch.ops import ac_sweep, cuda_ac\n"
            "from circuitsimulator_tpu_torch.utils import prng\n"
            "from circuitsimulator_tpu_torch.netlist import "
            "parse_netlist_text, read_netlist\n"
            f"ckt, _ = parse_netlist_text(read_netlist({DBMIXER!r}))\n"
            "assert len(ckt.elements) == 26, len(ckt.elements)\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'circuitsimulator_tpu' not in sys.modules\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
