"""The adaptive dyadic-LTE transient in the PyTorch port on the CPU, against
the JAX package (f64): tests/test_adaptive.py's RC_NET under BE and TRAP on
the ``lu`` and ``woodbury`` solvers (equal substep, rejection and Newton
counts, xs within 1e-10 V), the two-lane batch against its single lanes,
and JAX's limits (the T-line refusal, MOSCAP=CHARGE, TRNOISE noise-free).
One jitted JAX run per method: JAX's two solvers give the same run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.analysis.adaptive import (
    run_transient_adaptive as jax_adaptive)
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.analysis.adaptive import (
    TLINE_MESSAGE, run_transient_adaptive)

# one intra-op thread, as in every port test file (pytest-xdist shares
# the cores between workers)
torch.set_num_threads(1)

RC_NET = """\
V1 1 0 PULSE 0 1 0 1e-12 1e-12 1 2
R1 1 2 1k
C1 2 0 1u
.TRAN 2e-4 4e-3
"""


def rc_sim(**kw):
    return Simulator.from_text(RC_NET, opts=DEFAULT_OPTIONS.replace(**kw),
                               device="cpu")


@pytest.fixture(scope="module", params=["be", "trap"])
def jax_run(request):
    """JAX's adaptive run of RC_NET on its lu solver, one jit per method."""
    m = request.param
    js = JaxSimulator.from_text(RC_NET, opts=JAX_OPTIONS.replace(
        dtype=jnp.float64, tran_solver="lu", tran_method=m))
    res = jax.jit(lambda p: jax_adaptive(js.engine, p, 2e-4, 4e-3))(
        js.params)
    return m, res


@pytest.mark.parametrize("solver", ["lu", "woodbury"])
def test_adaptive_rc_matches_jax(jax_run, solver):
    """Counts equal to JAX's (no accept/reject decision flips), every row
    within 1e-10 V, on the .TRAN grid."""
    method, want = jax_run
    got = rc_sim(tran_method=method, tran_solver=solver).transient(
        adaptive=True)
    assert not bool(got.failed)
    assert bool(got.lte_exceeded) == bool(want.lte_exceeded)
    for key in ("n_substeps", "n_rejected", "newton_iters"):
        assert int(getattr(got, key)) == int(getattr(want, key)), key
    assert int(got.n_substeps) > got.n_steps        # it really refined
    np.testing.assert_allclose(got.times.numpy(), np.asarray(want.times),
                               rtol=1e-15)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), rtol=0,
                               atol=1e-10)


def test_adaptive_batch_matches_single_lanes():
    """Two lanes, the second with C x 1.5 (another time constant, another
    refinement path), against their own single-lane runs within JAX's vmap
    bar (tests/test_adaptive.py:127-130)."""
    sim = rc_sim(tran_solver="lu")
    p = sim.params
    p1 = dict(p, cap_c=p["cap_c"] * 1.5)
    bp = {k: torch.stack([p[k], p1[k]]) for k in p}
    rb = run_transient_adaptive(sim.engine, bp, 2e-4, 4e-3)
    assert rb.xs.shape == (21, 2, 3) and rb.n_substeps.shape == (2,)
    for lane, params in enumerate((p, p1)):
        r = run_transient_adaptive(sim.engine, params, 2e-4, 4e-3)
        np.testing.assert_allclose(rb.xs[:, lane].numpy(), r.xs.numpy(),
                                   rtol=0, atol=1e-12)
        for key in ("n_substeps", "n_rejected", "newton_iters"):
            assert int(getattr(rb, key)[lane]) == int(getattr(r, key)), key
    assert int(rb.n_substeps[0]) != int(rb.n_substeps[1])


def test_adaptive_limits_are_jax_limits(capsys):
    """T-lines raise JAX's NotImplementedError word for word; MOSCAP=CHARGE
    fails as JAX's init_state(x0) does; a TRNOISE deck runs noise-free with
    JAX's stderr note, once per simulator; levels outside [0, 20]
    raise."""
    tline = ("V1 in 0 PULSE(0 1 1n 0.2n 0.2n 6n 0)\nRS in a 50\n"
             "T1 a 0 b 0 Z0=50 TD=2n\nRL b 0 200\n.TRAN 0.1n 10n\n")
    js = JaxSimulator.from_text(tline, opts=JAX_OPTIONS.replace(
        dtype=jnp.float64))
    with pytest.raises(NotImplementedError) as jerr:
        jax_adaptive(js.engine, js.params, 1e-10, 1e-8)
    assert str(jerr.value) == TLINE_MESSAGE
    ts = Simulator.from_text(tline, device="cpu")
    with pytest.raises(NotImplementedError) as terr:
        ts.transient(adaptive=True)
    assert str(terr.value) == TLINE_MESSAGE

    charge = (".MODEL 2 VT 0.4 MU 1e-2 COX 1e-3 LAMBDA 0.05 CJ0 1e-13\n"
              "VDD 1 0 3\nRD 1 3 1k\nM1 3 1 0 n 10e-6 1e-6 2\n"
              ".OPTIONS MOSCAP=CHARGE\n.TRAN 1e-11 1e-10\n")
    with pytest.raises(ValueError, match=r"needs init_state\(x, params\)"):
        Simulator.from_text(charge, device="cpu").transient(adaptive=True)

    with pytest.raises(ValueError, match="must be in"):
        rc_sim(tran_max_refine_levels=21).transient(adaptive=True)

    noisy = Simulator.from_text(
        RC_NET.replace("R1 1 2 1k", "R1 1 2 1k\nI1 0 2 DC 0 TRNOISE(1m 0)"),
        device="cpu")
    capsys.readouterr()
    r1 = noisy.transient(adaptive=True, tstop=1e-3)
    r2 = noisy.transient(adaptive=True, tstop=1e-3)
    quiet = noisy.transient(adaptive=True, tstop=1e-3, noise_seed=None)
    err = capsys.readouterr().err
    assert err.count("note: the adaptive integrator runs TRNOISE decks "
                     "noise-free") == 1
    assert torch.equal(r1.xs, quiet.xs) and torch.equal(r2.xs, quiet.xs)
