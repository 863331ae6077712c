"""Behavioral B sources in the PyTorch port against the JAX package (CPU):
the compiled expressions (``utils/expr.compile_tape``/``eval_tape``) against
``jax.value_and_grad(compile_jax(...))``, the B-source decks through DC,
transient and AC, and K1d-ii, the B rows of the fused chunk: its plain
version against the JAX kernel in interpret mode and against the port's
non-fused loop, and its gate against the JAX gate.  The example decks'
JAX DC, transient and AC matrices (about 30 s of compiles on the CPU)
are ``tests/goldens/bsource_jax.json``; ``PYTHONPATH=. JAX_PLATFORMS=cpu
python tests/test_torch_bsource.py`` remakes it with the JAX package."""

import functools
import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from circuitsimulator_tpu import DEFAULT_OPTIONS as JAX_OPTIONS
from circuitsimulator_tpu import Simulator as JaxSimulator
from circuitsimulator_tpu.ops import pallas_step
from circuitsimulator_tpu.utils import expr as jexpr
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.analysis.ac import ac_system_real
from circuitsimulator_tpu_torch.convert import params_from_numpy
from circuitsimulator_tpu_torch.ops import fused_step
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc
from circuitsimulator_tpu_torch.utils import expr as texpr
from test_torch_fused_step import RECORD, jax_chunk, kernel_chunk, outputs

# one intra-op thread: the tensors are small, and under pytest-xdist
# several workers and JAX's own threads share the cores, where torch's
# spinning OpenMP workers slow everything on the machine many-fold
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
GOLDEN = os.path.join(REPO, "tests", "goldens", "bsource_jax.json")
# K1d-ii's chunk of the JAX kernel in interpret mode (test_torch_fused_step
# .jax_chunk; the same ``__main__`` remakes it)
K1_GOLDEN = os.path.join(REPO, "tests", "goldens", "bsource_k1_jax.npz")
J64 = JAX_OPTIONS.replace(dtype=jnp.float64)

# every operator and function of the expression language
EXPRS = [
    "v(a)+v(b)*2-v(c)/3", "-v(a)**3.0", "v(a)**v(b)", "pow(v(a),2.5)",
    "2**v(a)", "v(a)%v(b)", "sin(v(a))+cos(v(b))+tan(v(c))",
    "asin(v(a)/2)+acos(v(b)/2)+atan(v(c))",
    "sinh(v(a))*cosh(v(b))+tanh(v(c))",
    "exp(v(a))+ln(abs(v(b)))+log(abs(v(c))+1)+log10(abs(v(a))+2)",
    "sqrt(abs(v(a)))+abs(v(b))", "floor(v(a))*v(b)+ceil(v(c))",
    "atan2(v(a),v(b))", "min(v(a),v(b))+max(v(b),v(c))",
    "gain*v(a)*time+2*pi*e-1/3", "v(a,b)*i(V1)+v(c)/(1+v(d)*v(d))",
]

# (expression, probe values in first-appearance order): the points where
# JAX's derivative rules decide (jax/_src/lax/lax.py)
EDGES = [
    ("abs(v(a))", [0.0]), ("min(v(a),v(b))", [1.0, 1.0]),
    ("max(v(a),v(b))", [1.0, 1.0]), ("sqrt(v(a))", [0.0]),
    ("floor(v(a))", [1.5]), ("ceil(v(a))", [1.5]),
    ("v(a)%v(b)", [5.5, 2.0]), ("v(a)**3.0", [-2.0]),
    ("v(a)**v(b)", [-2.0, 1.5]), ("v(a)**v(b)", [0.0, 1.5]),
    ("v(a)**v(b)", [-2.0, 2.0]), ("atan2(v(a),v(b))", [0.0, 0.0]),
    ("sqrt(v(a))+v(b)", [0.0, 1.0]), ("v(b)/v(a)", [2.0, 0.0]),
    ("0*sqrt(v(a))", [0.0]),
]


def _compile(src):
    """(compile_jax fn, Tape, probe count, constant count) of one source."""
    ast = jexpr.parse_expr(src, probes=True)
    refs = [r for r in jexpr.probe_refs(ast) if r[0] != "time"]
    ri = {r: j for j, r in enumerate(refs)}
    ci = {n: j for j, n in enumerate(jexpr.free_names(ast))}
    tape = texpr.compile_tape(texpr.parse_expr(src, probes=True), ri, ci)
    return jexpr.compile_jax(ast, ri, ci), tape, len(refs), len(ci)


@functools.lru_cache(maxsize=None)
def _jax_values(which):
    """JAX value_and_grad of every expression of EXPRS on seeded random
    lanes, or of every edge point of EDGES, in one jitted computation."""
    rng = np.random.default_rng(1)
    if which == "random":
        cases = [(src, rng.uniform(-1.5, 1.5, (64, 4))) for src in EXPRS]
        consts = rng.uniform(0.5, 2.0, (64, 2))
    else:
        cases = []
        for src, pt in EDGES:
            v = np.zeros((1, 4))
            v[0, :len(pt)] = pt
            cases.append((src, v))
        consts = np.zeros((1, 2))
    fns = [_compile(src) for src, _ in cases]

    def run(vals, c):
        out = []
        for (fn, _, m, nc), v in zip(fns, vals):
            vg = jax.vmap(jax.value_and_grad(fn), in_axes=(0, None, 0))
            out.append(vg(v[:, :m], jnp.asarray(0.37), c[:, :nc]))
        return out

    want = jax.jit(run)([jnp.asarray(v) for _, v in cases],
                        jnp.asarray(consts))
    return cases, consts, fns, [(np.asarray(e), np.asarray(g))
                                for e, g in want]


@pytest.mark.parametrize("i", range(len(EXPRS)))
def test_eval_tape_matches_jax_value_and_grad(i):
    """Value and gradient within 1e-14 (relative above 1) of JAX's on 64
    seeded random lanes, with the same NaN pattern."""
    cases, consts, fns, want = _jax_values("random")
    (src, v), (_, tape, m, nc), (e0, g) = cases[i], fns[i], want[i]
    got_e, got_g = texpr.eval_tape(tape, torch.as_tensor(v[:, :m]), 0.37,
                                   torch.as_tensor(consts[:, :nc]))
    for got, ref in ((got_e.numpy(), e0), (got_g.numpy(), g)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        ok = ~np.isnan(ref)
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-14,
                                   atol=1e-14, err_msg=src)


@pytest.mark.parametrize("i", range(len(EDGES)))
def test_eval_tape_edge_points_match_jax_exactly(i):
    """At the derivative rules' edge points the value and gradient equal
    JAX's exactly, inf and NaN included: abs' = 1 at 0, a 0.5/0.5 min/max
    tie, sqrt'(0) = inf, floor' = ceil' = 0, fmod's x-partial 1,
    d(x**3.0)/dx = 12 at -2, a probed exponent's partial NaN for x < 0 and
    0 at x = 0, atan2(0, 0)'s NaN partials, and symbolic zeros (the
    v2-partial of sqrt(v1) + v2 at v1 = 0 is 1)."""
    cases, consts, fns, want = _jax_values("edges")
    (src, v), (_, tape, m, nc), (e0, g) = cases[i], fns[i], want[i]
    got_e, got_g = texpr.eval_tape(tape, torch.as_tensor(v[:, :m]), 0.37,
                                   torch.as_tensor(consts[:, :nc]))
    np.testing.assert_array_equal(got_e.numpy(), e0, err_msg=src)
    np.testing.assert_array_equal(got_g.numpy(), g, err_msg=src)


def test_tape_opcodes_match_the_kernel():
    """The CUDA interpreter's opcode enum lists utils/expr.py OPS in order,
    and its stack and probe capacities are the gate's."""
    src = open(os.path.join(REPO, "circuitsimulator_tpu_torch", "csrc",
                            "fused_step.cu")).read()
    body = re.search(r"enum BOp \{([^}]*)\}", src).group(1)
    names = [n.strip()[2:] for n in body.replace("\n", " ").split(",")
             if n.strip()]
    assert names == list(texpr.OPS)
    assert f"#define BSTACK {fused_step.MAX_STACK}" in src
    assert f"#define BPROBES {fused_step.MAX_B_PAIRS}" in src
    assert _compile("v(a)*(v(b)+(v(c)-1))")[1].depth == 4


# the B-source deck of tests/test_pallas_step.py: an I-form source with a
# .PARAM, a V-form source with a time term, and a diode
B_DECK = """* behavioral multiplier + limiter + diode
.PARAM gain=1m
V1 a 0 SIN 0 1 1e4
V2 b 0 SIN 0 1 1.3e4
R1 a 0 1k
R2 b 0 1k
B1 p 0 I=v(a)*v(b)*gain
RP p 0 1k
B2 q 0 V=tanh(v(p)*2)+0.1*sin(6.28e4*time)
RQ q 0 2k
C1 q 0 10n
D1 q 0 IS=1e-14
.op
"""


DECK_STEPS = {"behavioral": 200, "sdomain_filter": 200, "am_envelope": 50}


def jax_deck_runs(deck):
    """The JAX package's DC, transient and (but for am_envelope) AC
    matrices of one example deck, f64.  JAX's transient solves its DC
    point inside its one jitted run and keeps it as the t = 0 row: the DC
    is compared there."""
    js = JaxSimulator.from_file(os.path.join(EXAMPLES, f"{deck}.sp"),
                                opts=J64)
    rj = js.transient(tstop=DECK_STEPS[deck] * js.config.tran.tstep)
    xj = rj.xs[0]
    out = {"dc": np.asarray(xj), "tran": np.asarray(rj.xs)}
    if deck != "am_envelope":
        from circuitsimulator_tpu.analysis.ac import ac_system_real as jac
        Gj = jax.jit(lambda p, x: jac(js.engine, p, x, 1.0))(js.params, xj)
        out["ac_system"] = np.concatenate([np.asarray(a).ravel()
                                           for a in Gj])
    return out


@functools.lru_cache(maxsize=None)
def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def _deck_runs(deck):
    """DC, a transient and (but for am_envelope) the AC matrices of one
    example deck, f64: (jax, port) result pairs."""
    path = os.path.join(EXAMPLES, f"{deck}.sp")
    ts = Simulator.from_file(path, device="cpu")
    tstop = DECK_STEPS[deck] * ts.config.tran.tstep
    xt = ts.dc()
    rt = ts.transient(tstop=tstop, x_op=xt)
    want = {k: np.asarray(v) for k, v in _golden()[deck].items()}
    out = {"dc": (want["dc"], xt.numpy()),
           "tran": (want["tran"], rt.xs.numpy())}
    if deck != "am_envelope":
        Gt = ac_system_real(ts.engine, ts.params, xt, 1.0)
        out["ac_system"] = (want["ac_system"], np.concatenate(
            [a.numpy().ravel() for a in Gt]))
    return out


@pytest.mark.parametrize("deck,what", [
    ("behavioral", "dc"), ("behavioral", "tran"), ("behavioral", "ac_system"),
    ("sdomain_filter", "dc"), ("sdomain_filter", "tran"),
    ("sdomain_filter", "ac_system"),
    ("am_envelope", "dc"), ("am_envelope", "tran"),
])
def test_bsource_decks_match_jax(deck, what):
    """The B-source example decks in f64 within 1e-9 of JAX: the DC point,
    the transient (200 steps; am_envelope 50) and the AC system (G, B, J)
    at the operating point (sdomain_filter's LAPLACE filters end in POLY E
    sources, which the parser lowers onto B sources; its .AC sweep is held
    to JAX in tests/test_torch_ac.py)."""
    want, got = _deck_runs(deck)[what]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def jax_runner(engine, bparams, dt):
    """``PallasStepRunner`` built under one ``jax.jit`` trace (see
    tests/test_torch_fused_step.py: eagerly its constructor costs 10-15 s
    of small compiles per deck)."""
    made = []

    def build(p):
        made.append(pallas_step.PallasStepRunner(engine, p, dt))
        return {k: v for k, v in vars(made[-1]).items()
                if isinstance(v, jax.Array)}

    arrays = jax.jit(build)(bparams)
    vars(made[-1]).update(arrays)
    return made[-1]


def test_plain_matches_jax_pallas_kernel_k1d_ii():
    """B_DECK, B = 128, 10 steps of 1 us, f32 damped from each lane's DC
    point (the port's f64 batched DC): the plain K1 chunk against the JAX
    kernel in interpret mode on the same lanes, within 1e-4 V (the bar of
    tests/test_pallas_step.py for this deck), failed masks equal."""
    B, steps, dt = 128, 10, 1e-6
    jo = JAX_OPTIONS.replace(dtype=jnp.float32, tran_tol=1e-5, dc_tol=1e-5)
    to = DEFAULT_OPTIONS.replace(dtype=torch.float32, tran_tol=1e-5,
                                 dc_tol=1e-5)
    js = JaxSimulator.from_text(B_DECK, opts=jo)
    rng = np.random.default_rng(7)
    lanes = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
             for k, v in js.params.items()}
    for key in ("res_r", "b_consts"):
        lanes[key] = (lanes[key] * np.exp(0.02 * rng.standard_normal(
            lanes[key].shape))).astype(np.float32)
    sim64 = Simulator.from_text(B_DECK, device="cpu",
                                opts=DEFAULT_OPTIONS.replace(ramp_steps=3,
                                                             dc_tol=1e-7))
    x0 = tmc.batched_dc_fast(sim64.engine, params_from_numpy(lanes)).float()
    ts = Simulator.from_text(B_DECK, opts=to, device="cpu")
    tp = params_from_numpy(lanes, dtype=torch.float32)
    st = ts.engine.init_state(x0)
    xj = jnp.asarray(x0.numpy())
    rec = jax_chunk("k1d_ii", lambda: kernel_chunk(
        jax_runner(js.engine, {k: jnp.asarray(v) for k, v in lanes.items()},
                   dt), xj, xj, jnp.asarray(st["vc"].numpy()),
        jnp.asarray(st["il"].numpy()), jnp.zeros((B,), bool), 0, steps),
        K1_GOLDEN)
    want = outputs(rec)
    tr = fused_step.FusedStepRunner(ts.engine, tp, dt)
    assert (tr.k, tr.W, tr.nB) == (rec["k"], rec["W"], 2)
    got = tr.run_chunk_plain(x0, x0, st["vc"], st["il"],
                             torch.zeros((B,), dtype=torch.bool), 0, steps)
    xo, _, vco, ilo, fo, iters = (a.numpy() for a in got)
    np.testing.assert_allclose(xo, want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(vco, want[2], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(fo, want[4])
    assert not fo.any() and iters.min() > 0


@pytest.mark.parametrize("deck,dt,W", [("sdomain_filter", 2e-5, 6),
                                       ("behavioral", 2e-9, 4)])
def test_plain_matches_nonfused_f64_k1d_ii(deck, dt, W):
    """f64, 4 lanes (resistors and b_consts perturbed), 10 steps from the
    batched DC point: the plain K1 chunk against the port's non-fused loop
    within 1e-9 V with equal failed masks and per-lane Newton iteration
    counts; sdomain_filter's POLY(3) sources make W = 6."""
    sim = Simulator.from_file(os.path.join(EXAMPLES, f"{deck}.sp"),
                              device="cpu",
                              opts=DEFAULT_OPTIONS.replace(ramp_steps=3,
                                                           dc_tol=1e-7))
    assert fused_step.supported(sim.engine, dt)
    bp = tmc.perturb_params(sim.params, torch.Generator().manual_seed(3), 4,
                            {"res_r": 0.01, "b_consts": 0.05})
    carry, advance, meta = tmc.make_fused_transient_fn(sim.engine, bp, dt,
                                                       chunk=10)
    assert meta["runner"].W == W
    (x, _, vc, il, failed), iters = advance(carry, 0, 10)
    ref = tmc.init_carry(sim.engine, carry[0], bp)
    ts = torch.arange(1, 11, dtype=torch.float64) * dt
    ref, ref_iters = tmc.batched_transient_chunk(sim.engine, bp, ref, ts, dt)
    np.testing.assert_allclose(x.numpy(), ref[0].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(vc.numpy(), ref[-2]["vc"].numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(failed.numpy(), ref[-1].numpy())
    np.testing.assert_array_equal(iters.numpy(), ref_iters.numpy())


DEEP = "v(a)*(" * 17 + "v(a)" + ")" * 17
PROBES5 = "v(a)+v(b)+v(c)+v(d)+v(e)"
GATE_DECKS = {
    "bdeck": (B_DECK, None),
    "deep": ("V1 a 0 SIN 0 1 1e6\nR1 a 0 1k\n"
             f"B1 q 0 V={DEEP}\nRQ q 0 1k\n", "stack depth 18 > 16"),
    "five_probes": ("V1 a 0 1\nR1 a b 1k\nR2 b c 1k\nR3 c d 1k\nR4 d e 1k\n"
                    "R5 e 0 1k\n"
                    f"B1 q 0 I={PROBES5}\nRQ q 0 1k\n", "5 probe pairs > 4"),
    "charge": (".OPTIONS MOSCAP=CHARGE\n"
               ".MODEL 2 VT 0.83 MU 1.5e-1 COX 0.3e-4 CJ0 4.0e-14\n"
               "VDD 1 0 3\nM1 3 1 0 n 10e-6 0.35e-6 2\nRL 1 3 10k\n"
               "B1 q 0 V=v(3)*2\nRQ q 0 1k\n", "MOSCAP=CHARGE"),
    "rank17": ("V1 a 0 SIN 0 1 1e6\n"
               + "".join(f"R{i} a n{i} 1k\nD{i} n{i} 0\n" for i in range(16))
               + "B1 q 0 V=v(a)*2\nRQ q 0 1k\n", "rank k = 17 > 16"),
}


@pytest.mark.parametrize("deck", ["behavioral", "sdomain_filter",
                                  "am_envelope", *GATE_DECKS])
def test_gate_implies_jax_gate_k1d_ii(deck):
    """The port's K1 gate on B-source decks is a subset of
    pallas_step.supported: the example decks and B_DECK are in; an
    expression deeper than the kernel's stack, B with MOSCAP=CHARGE rows
    and B at rank 17 are refused by name (JAX admits them), and five probe
    pairs by both."""
    if deck in GATE_DECKS:
        text, why = GATE_DECKS[deck]
        js = JaxSimulator.from_text(text + ".op\n")
        ts = Simulator.from_text(text + ".op\n", device="cpu")
    else:
        why = None
        path = os.path.join(EXAMPLES, f"{deck}.sp")
        js = JaxSimulator.from_file(path)
        ts = Simulator.from_file(path, device="cpu")
    reason = fused_step.unsupported_reason(ts.engine, 1e-9)
    if why is None:
        assert reason is None and pallas_step.supported(js.engine, 1e-9)
    else:
        assert why in reason
        assert pallas_step.supported(js.engine, 1e-9) == (
            deck != "five_probes")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    RECORD["on"] = True
    test_plain_matches_jax_pallas_kernel_k1d_ii()
    np.savez_compressed(K1_GOLDEN, **RECORD[K1_GOLDEN])
    with open(GOLDEN, "w") as fh:
        json.dump({d: {k: v.tolist() for k, v in jax_deck_runs(d).items()}
                   for d in DECK_STEPS}, fh)
