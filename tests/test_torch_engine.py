"""MNA assembly and the Woodbury solve of the PyTorch port against the JAX
Engine on the same numpy inputs (f64, CPU, rtol 1e-12), single-lane and
with a leading lane axis of JAX-drawn Monte-Carlo parameters."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.ops.woodbury import WoodburySolver as JaxWoodbury
from circuitsimulator_tpu.parallel.montecarlo import perturb_params
from circuitsimulator_tpu_torch import Simulator
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.ops.woodbury import WoodburySolver

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

RTOL = 1e-12
SIGMAS = {"res_r": 0.01, "mos_vth": 0.02, "cap_c": 0.02}


@pytest.fixture(scope="module", params=["buffer", "dbmixer", "dbmixer-lanes"])
def pair(request):
    deck = request.param.split("-")[0]
    js = JaxSimulator.from_file(f"tests/netlists/{deck}.sp")
    ts = Simulator.from_file(f"tests/netlists/{deck}.sp", device="cpu")
    jp = js.params
    lanes = ()
    if request.param.endswith("lanes"):
        jp = perturb_params(jp, jax.random.key(3), 3, SIGMAS)
        lanes = (3,)
    tp = params_from_numpy({k: np.array(v) for k, v in jp.items()})
    rng = np.random.default_rng(17)
    x = rng.uniform(-1.0, 3.0, lanes + (ts.engine.N,))
    return js.engine, jp, ts.engine, tp, x


def close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


def f64(v):
    return torch.tensor(v, dtype=torch.float64)


def test_dc_assembly_matches_jax(pair):
    je, jp, te, tp, x = pair

    @jax.jit
    def ref(p, x):
        G, I = je.dc_static(p, jnp.asarray(0.3))
        return (G, I) + je.assemble_dc_iter(G, I, p, x, 2.5e-6)

    want = ref(jp, jnp.asarray(x))
    tG, tI = te.dc_static(tp, f64(0.3))
    got = (tG, tI) + te.assemble_dc_iter(tG, tI, tp, torch.as_tensor(x),
                                         2.5e-6)
    for g, w in zip(got, want):
        close(g, w)


def test_nl_vals_match_jax(pair):
    je, jp, te, tp, x = pair
    want = jax.jit(je._nl_vals)(jp, jnp.asarray(x))
    for got, w in zip(te._nl_vals(tp, torch.as_tensor(x)), want):
        close(got, w)


def test_tran_assembly_and_state_match_jax(pair):
    je, jp, te, tp, x = pair
    dt, t = 1e-12, 3.7e-10
    x2 = x[..., ::-1].copy()

    @jax.jit
    def ref(p, x, x2):
        d = jnp.asarray(dt)
        s = je.init_state(x)
        return (je.tran_static_G(p, d, 1e-6), s,
                je.make_tran_static_I(d)(p, s, jnp.asarray(t)),
                je.make_update_state(d)(p, x2, s))

    jG, js, jI, ju = ref(jp, jnp.asarray(x), jnp.asarray(x2))
    close(te.tran_static_G(tp, f64(dt), 1e-6), jG)
    ts = te.init_state(torch.as_tensor(x))
    close(te.make_tran_static_I(f64(dt))(tp, ts, f64(t)), jI)
    tu = te.make_update_state(f64(dt))(tp, torch.as_tensor(x2), ts)
    for key in ("vc", "ic", "il", "vl"):
        close(ts[key], js[key])
        close(tu[key], ju[key])


def test_woodbury_solve_matches_jax(pair):
    je, jp, te, tp, x = pair
    N, dt = je.N, 1e-12
    b0 = np.random.default_rng(5).standard_normal(x.shape)

    def ref(p, x, b0):
        G0 = je.tran_static_G(p, jnp.asarray(dt), 1e-6)[:N, :N]
        w = JaxWoodbury(je, p, G0)
        z0 = w.z0(b0)
        return w.G0inv, z0, w.solve(p, x, z0)

    ref = jax.vmap(ref) if x.ndim == 2 else ref
    want = jax.jit(ref)(jp, jnp.asarray(x), jnp.asarray(b0))
    tw = WoodburySolver(te, tp, te.tran_static_G(tp, f64(dt),
                                                 1e-6)[..., :N, :N])
    tz0 = tw.z0(torch.as_tensor(b0))
    for g, w in zip((tw.G0inv, tz0, tw.solve(tp, torch.as_tensor(x), tz0)),
                    want):
        close(g, w)
