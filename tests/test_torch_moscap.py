"""The charge-conserving MOS cap model (``MOSCAP=CHARGE``) of the PyTorch
port on the CPU, against the JAX package: the charge functions and their
forward-mode Jacobian, the engine's charge patterns and state, the Woodbury
charge rows, and the non-fused charge transient.  Inputs are drawn with
numpy; everything runs in float64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import jvp

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.models import moscap as jmq
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.models import moscap
from circuitsimulator_tpu_torch.ops.woodbury import WoodburySolver

torch.set_num_threads(1)

# 2-MOS CMOS stage under the charge model (tests/test_pallas_step.py): rank
# 2 conduction + 10 charge rows = 12
CHARGE_DECK = """* charge-model CMOS stage
.OPTIONS MOSCAP=CHARGE
.MODEL 1 VT -0.75 MU 5e-2 COX 0.3e-4 LAMBDA 0.05 CJ0 4.0e-14
.MODEL 2 VT 0.83 MU 1.5e-1 COX 0.3e-4 LAMBDA 0.05 CJ0 4.0e-14
VDD 1 0 3
Vin 2 0 SIN 1.5 0.5 5e6
M1 3 2 1 p 30e-6 0.35e-6 1
M2 3 2 0 n 10e-6 0.35e-6 2
C1 3 0 0.5p
RL 3 0 10k
.op
"""


def biases(n=400, seed=0):
    """(n, 3) (vd, vg, vs) and per-row device parameters: random biases over
    +-3 V (cutoff, triode, saturation, vds < 0, junctions forward past
    FC PB) plus exact ties: vgt = 0, vds = vgt (triode/saturation edge),
    vds = 0, and a junction at exactly FC PB = 0.4 V."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-3.0, 3.0, (n, 3))
    p = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
    vth = np.where(p > 0, 0.5, -0.5)
    ties = [[1.25, 1.5, 1.0],    # vgs - vth = 0 (NMOS)
            [1.5, 2.5, 1.0],     # vds = vgs - vth = 1 (sat edge)
            [1.0, 2.5, 1.0],     # vds = 0
            [0.0, 1.0, -0.4],    # -p vs = 0.4: junction breakpoint
            [-0.4, 1.0, 0.0]]
    v[:len(ties)] = ties
    p[:len(ties)] = 1.0
    vth[:len(ties)] = 0.5
    params = {"mos_vth": vth, "mos_coxwl": rng.uniform(0.5, 2.0, n) * 1e-14,
              "mos_cj0": rng.uniform(0.5, 2.0, n) * 4e-14, "mos_p": p}
    return v, params


def test_charges_and_jacobian_match_jax():
    """charges_of_x and charge_jacobian against the JAX functions, float64:
    charges within 1e-12 relative, the Jacobian within 1e-12 relative of its
    largest entry per device (entries that cancel to ~0 carry the absolute
    part)."""
    v, p = biases()
    jq, jJ = jax.jit(jmq.charge_jacobian)(
        jnp.asarray(v), {k: jnp.asarray(a) for k, a in p.items()})
    tp = {k: torch.as_tensor(a) for k, a in p.items()}
    tq = moscap.charges_of_x(torch.as_tensor(v), tp)
    q, J = moscap.charge_jacobian(torch.as_tensor(v), tp)
    assert torch.equal(q, tq)
    jq, jJ = np.asarray(jq), np.asarray(jJ)
    qs = np.abs(jq).max(1, keepdims=True)
    np.testing.assert_allclose(q.numpy(), jq, rtol=1e-12, atol=0)
    np.testing.assert_allclose(q.numpy() / qs, jq / qs, rtol=0, atol=1e-12)
    Js = np.abs(jJ).reshape(len(v), -1).max(1)[:, None, None]
    np.testing.assert_allclose(J.numpy() / Js, jJ / Js, rtol=0, atol=1e-12)
    # the tie rule shows at the junction breakpoint: min(v, FC PB) at
    # v = 0.4 exactly passes half the tangent, so dq_sb/dvs is half of
    # C_dep(0.4) = CJ0 / sqrt(1 - 0.4/0.8)
    half = 0.5 * p["mos_cj0"][3] / np.sqrt(0.5)
    np.testing.assert_allclose(float(J[3, 3, 2]), half, rtol=1e-12)


def test_dual_rules_equal_torch_forward_mode():
    """The Dual rules are torch.func.jvp's on the same functions (three
    passes), ties included: torch.maximum/torch.minimum split the tangent
    evenly at an exact tie, as jax.jvp does."""
    x = torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64)
    one = torch.ones_like(x)
    _, t = jvp(lambda a: torch.maximum(a, torch.zeros_like(a)), (x,), (one,))
    assert t.tolist() == [0.5, 1.0, 1.0]
    _, t = jax.jvp(lambda a: jnp.maximum(a, 0.0), (jnp.asarray(x.numpy()),),
                   (jnp.ones(3),))
    assert np.asarray(t).tolist() == [0.5, 1.0, 1.0]
    v, p = biases(16, seed=1)
    tv = torch.as_tensor(v)
    tp = {k: torch.as_tensor(a) for k, a in p.items()}

    def qfun(a):   # the charge functions on plain tensors under torch.func
        q = moscap.mos_all_charges(
            a[..., 0], a[..., 1], a[..., 2], tp["mos_vth"],
            tp["mos_coxwl"], tp["mos_cj0"], tp["mos_p"])
        return torch.stack(q, -1)

    eye = torch.eye(3, dtype=torch.float64)
    ref = torch.stack([jvp(qfun, (tv,), (eye[j].expand(tv.shape),))[1]
                       for j in range(3)], -1)
    _, J = moscap.charge_jacobian(tv, tp)
    scale = ref.abs().flatten(1).amax(1)[:, None, None]
    np.testing.assert_allclose((J / scale).numpy(), (ref / scale).numpy(),
                               rtol=0, atol=1e-12)


def draw_lanes(params, B, seed=0):
    """B lanes of the JAX params, res_r and mos_vth perturbed, drawn with
    numpy."""
    rng = np.random.default_rng(seed)
    out = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
           for k, v in params.items()}
    for key, sigma in (("res_r", 0.01), ("mos_vth", 0.02)):
        out[key] = out[key] * np.exp(sigma * rng.standard_normal(
            out[key].shape))
    return out


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def test_engine_and_woodbury_charge_rows_match_jax():
    """The charge stage, three lanes: the engine's mq patterns, the zeroed
    MOS lumps of _caplike_C, qm of init_state and of the state update and
    the dense BE iteration with the charge entries (assemble_tran_iter)
    within 1e-12 of the JAX engine; the Woodbury solve with the charge rows
    equals the dense solve of that iteration (1e-12).  (Tracing JAX's
    Woodbury solve with the charge rows as well would add its jvp trace
    and compile, about 3 s, for a solve the dense one already pins.)"""
    js = JaxSimulator.from_text(CHARGE_DECK)
    ts = Simulator.from_text(CHARGE_DECK, device="cpu")
    je, te = js.engine, ts.engine
    assert je.mos_charge and te.mos_charge
    for key in ("mq_rows", "mq_cols", "mq_rhs_rows"):
        np.testing.assert_array_equal(getattr(te, key), getattr(je, key))
    B, N, dt, t = 3, je.N, 1e-9, 3e-9
    p = draw_lanes(js.params, B)
    rng = np.random.default_rng(7)
    x, x2 = rng.uniform(-0.5, 3.5, (2, B, N))

    @jax.jit
    def ref(p, x, x2):
        def one(p, x, x2):
            d = jnp.asarray(dt)
            s = je.init_state(x, p)
            G0 = je.tran_static_G(p, d, 1e-6)
            I0 = je.make_tran_static_I(d)(p, s, jnp.asarray(t))
            qex = (s["qm"], 1.0 / d)
            G, I = je.assemble_tran_iter(G0, I0, p, x2, t, qex)
            up = je.make_update_state(d)(p, x2, s)
            return je._caplike_C(p), s["qm"], up["qm"], G, I
        return jax.vmap(one)(p, x, x2)

    want = ref({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
               jnp.asarray(x2))
    tp = params_from_numpy(p)
    d = torch.tensor(dt, dtype=torch.float64)
    tx, tx2 = torch.as_tensor(x), torch.as_tensor(x2)
    s = te.init_state(tx, tp)
    G0 = te.tran_static_G(tp, d, 1e-6)
    I0 = te.make_tran_static_I(d)(tp, s, torch.tensor(t, dtype=torch.float64))
    qex = (s["qm"], 1.0 / d)
    G, I = te.assemble_tran_iter(G0, I0, tp, tx2, t, qex)
    w = WoodburySolver(te, tp, G0[..., :N, :N])
    assert w.plan.k == 12 and w.plan.nCq == 10
    xr = w.solve(tp, tx2, w.z0(I0[..., :N]), qex)
    up = te.make_update_state(d)(tp, tx2, s)
    caps = te._caplike_C(tp)
    assert not caps[:, 2:10].any()         # the MOS lumps carry C = 0
    # no solve reads the RHS's ground slot I[N], which the port leaves 0
    for g, wnt in zip((caps, s["qm"], up["qm"], G, I[..., :N]),
                      want[:4] + (want[4][..., :N],)):
        close(g, wnt)
    close(xr, torch.linalg.solve(G[:, :N, :N], I[:, :N]))


def test_charge_transient_matches_jax():
    """The non-fused BE transient of the charge stage (Woodbury path with
    the charge rows, qm carried in the state) against the JAX package's
    (``Simulator.transient``: run_transient from its jitted DC point; given
    no x0, run_transient solves the DC point eagerly, 10 s more): f64, 5
    steps, within 1e-9 V, equal Newton iteration counts."""
    js = JaxSimulator.from_text(CHARGE_DECK)
    ts = Simulator.from_text(CHARGE_DECK, device="cpu")
    want = js.transient(tstep=1e-9, tstop=5e-9)
    got = ts.transient(tstep=1e-9, tstop=5e-9)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(got.newton_iters.numpy(),
                                  np.asarray(want.newton_iters))
    assert not bool(got.failed)
