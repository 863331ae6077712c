"""The port's large-circuit stack on the CPU, f64, against the JAX package:
the primitives of ``ops/tridiag``, ``ops/blockcr`` and ``ops/gauss_seidel``
(eager JAX calls, within 1e-12 relative), the static layouts of
``ops/banded`` and ``ops/blockband`` and the backend ``Simulator`` picks
(identical), and the DC and transient of the synthetic ladder and grids on
the ``tridiag``, ``blockband`` and ``blockwb`` backends, the batched
ladder, the Gauss-Seidel DC, ``dc_refine``, ``dc_residual``, the polished
DC, the adaptive ladder and the CLI on a 300-node ladder (within 1e-9 V of
the JAX package's results).  The JAX results are
``tests/goldens/large_jax.json`` and the CLI's
``tests/goldens/ladder300_{stdout_jax.txt,tran_jax.csv}`` (each JAX
transient compiles for 10-30 s on the CPU); ``PYTHONPATH=. JAX_PLATFORMS=cpu
python tests/test_torch_large.py``, from the repository's root, remakes
them with the JAX package.  The
structured backends are also held to the port's own dense run of the same
deck at the JAX package's bars (tests/test_ladder.py, test_blockwb.py)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circuitsimulator_tpu.ops import banded as jbanded
from circuitsimulator_tpu.ops import blockband as jblockband
from circuitsimulator_tpu.ops import blockcr as jblockcr
from circuitsimulator_tpu.ops import tridiag as jtridiag
from circuitsimulator_tpu.ops.gauss_seidel import gauss_seidel_solve as jgs
from circuitsimulator_tpu_torch import DEFAULT_OPTIONS, Simulator
from circuitsimulator_tpu_torch.analysis.dc import dc_refine, dc_residual
from circuitsimulator_tpu_torch.cli import main
from circuitsimulator_tpu_torch.ops import (assemble, banded, blockband,
                                            blockcr, tridiag)
from circuitsimulator_tpu_torch.ops.gauss_seidel import gauss_seidel_solve
from circuitsimulator_tpu_torch.parallel import montecarlo as tmc
from circuitsimulator_tpu_torch.synthetic import (rc_grid_netlist,
                                                  rc_ladder_netlist)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
GOLDEN = os.path.join(GOLDENS, "large_jax.json")
TOL_V = 1e-9

# every deck 10 steps of 10 ps from its DC point
DECKS = {
    "ladder200": rc_ladder_netlist(200, tstop=1e-10),
    "grid_blockband": rc_grid_netlist(12, 12, tstop=1e-10),
    "grid_blockwb": rc_grid_netlist(12, 12, diode_every=20, tstop=1e-10),
    "grid_rail": rc_grid_netlist(12, 12, rail=True, tstop=1e-10),
    "grid_charge": rc_grid_netlist(12, 12, mos_every=16, moscap_charge=True,
                                   tstop=1e-10),
}
BACKENDS = {"ladder200": ("tridiag", "tridiag"),
            "grid_blockband": ("blockband", "blockband"),
            "grid_blockwb": ("blockwb", "blockband"),
            "grid_rail": ("blockband", "blockband"),
            "grid_charge": ("blockband", "blockband")}
SMALL_LADDER = rc_ladder_netlist(30, diode_every=3)   # dense backends
LANES = 4


def lane_scale(n_res):
    """The batched ladder's per-lane resistor factors, from a seed."""
    return np.exp(0.05 * np.random.default_rng(11).standard_normal(
        (LANES, n_res)))


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def f64(a):
    return torch.as_tensor(a, dtype=torch.float64)


def close(got, want, tol=TOL_V):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, err


# ---------------------------------------------------------------- primitives
# Each case draws its inputs from a seed and returns the arrays the JAX
# function gives (``jax_fn``) or the port's (``torch_fn``); the JAX side's
# are in the golden (eager JAX compiles every op at every new shape, 3-15 s
# a case on the CPU).
def tridiag_system(rng, lead, n):
    a = rng.standard_normal(lead + (n,))
    c = rng.standard_normal(lead + (n,))
    a[..., 0] = c[..., -1] = 0.0
    b = 4.0 + np.abs(a) + np.abs(c) + rng.random(lead + (n,))
    return a, b, c, rng.standard_normal(lead + (n,))


def block_system(rng, nb, k, mb, lead=()):
    D = rng.standard_normal(lead + (nb, k, k)) + 6.0 * np.eye(k)
    L = 0.3 * rng.standard_normal(lead + (nb, k, k))
    U = 0.3 * rng.standard_normal(lead + (nb, k, k))
    L[..., 0, :, :] = 0.0
    U[..., -1, :, :] = 0.0
    n_pad = nb * k
    Ub = rng.standard_normal(lead + (n_pad, mb))
    Wb = rng.standard_normal(lead + (mb, n_pad))
    Db = rng.standard_normal(lead + (mb, mb)) + 4.0 * np.eye(mb)
    return L, D, U, Ub, Wb, Db


def case_tridiag(n, lead, side):
    a, b, c, d = tridiag_system(np.random.default_rng(n), lead, n)
    if side == "jax":
        m = jtridiag
    else:
        m = tridiag
        a, b, c, d = (torch.as_tensor(v) for v in (a, b, c, d))
    return [m.cr_solve(a, b, c, d), m.pcr_solve(a, b, c, d)]


def case_bordered(algo, side):
    rng = np.random.default_rng(3)
    n, m = 45, 3
    a, b, c, f = tridiag_system(rng, (2,), n)
    U, W = rng.standard_normal((2, n, m)), rng.standard_normal((2, m, n))
    D = rng.standard_normal((2, m, m)) + 3 * np.eye(m)
    g = rng.standard_normal((2, m))
    if side == "torch":
        # lanes on every operand: each lane as JAX solves it alone
        return list(tridiag.bordered_solve(
            *(torch.as_tensor(v) for v in (a, b, c, U, W, D, f, g)),
            algo=algo))
    out = [jtridiag.bordered_solve(a[i], b[i], c[i], U[i], W[i], D[i], f[i],
                                   g[i], algo=algo) for i in range(2)]
    return [np.stack([o[j] for o in out]) for j in range(2)]


def case_block(nb, k, mb, side):
    rng = np.random.default_rng(nb * 10 + k)
    L, D, U, Ub, Wb, Db = block_system(rng, nb, k, mb)
    F = rng.standard_normal((nb, k, 2))
    f, g = rng.standard_normal(nb * k), rng.standard_normal(mb)
    m = jblockcr
    if side == "torch":
        m = blockcr
        L, D, U, Ub, Wb, Db, F, f, g = (torch.as_tensor(v) for v in
                                        (L, D, U, Ub, Wb, Db, F, f, g))
    # the solve, the bordered solve and the pre-factored pairs
    return [m.block_cr_solve(L, D, U, F),
            *m.bordered_block_solve(L, D, U, Ub, Wb, Db, f, g),
            m.block_cr_apply(m.block_cr_factor(L, D, U), F),
            *m.bordered_block_apply(
                m.bordered_block_factor(L, D, U, Ub, Wb, Db), f, g)]


def case_block_lanes(side):
    rng = np.random.default_rng(5)
    L, D, U, Ub, Wb, Db = block_system(rng, 5, 3, 2, lead=(3,))
    f, g = rng.standard_normal((3, 15)), rng.standard_normal((3, 2))
    if side == "torch":
        return list(blockcr.bordered_block_solve(
            *(torch.as_tensor(v) for v in (L, D, U, Ub, Wb, Db, f, g))))
    out = [jblockcr.bordered_block_solve(L[i], D[i], U[i], Ub[i], Wb[i],
                                         Db[i], f[i], g[i]) for i in range(3)]
    return [np.stack([o[j] for o in out]) for j in range(2)]


def case_gs(case, side):
    rng = np.random.default_rng(9)
    n = 24
    A = rng.standard_normal((n, n)) + 2.0 * n * np.eye(n)
    b = rng.standard_normal(n)
    A[3], b[3] = 0.0, 0.0           # a zero diagonal, regularised
    x0 = rng.standard_normal(n) if case == "warm" else None
    iters, tol = (3, 0.0) if case == "capped" else (1000, 1e-10)
    if side == "jax":
        return [jgs(jnp.asarray(A), jnp.asarray(b),
                    None if x0 is None else jnp.asarray(x0), iters, tol)]
    return [gauss_seidel_solve(torch.as_tensor(A), torch.as_tensor(b),
                               None if x0 is None else torch.as_tensor(x0),
                               iters, tol)]


PRIMITIVES = {
    **{f"tridiag_{n}_{len(lead)}": (case_tridiag, (n, lead))
       for n, lead in [(1, ()), (37, ()), (64, (3,)), (13, (2, 2))]},
    "bordered_cr": (case_bordered, ("cr",)),
    "bordered_pcr": (case_bordered, ("pcr",)),
    **{f"block_{nb}_{k}_{mb}": (case_block, (nb, k, mb))
       for nb, k, mb in [(6, 4, 3), (8, 3, 0), (1, 5, 2)]},
    "block_lanes": (case_block_lanes, ()),
    **{f"gs_{c}": (case_gs, (c,)) for c in ["converged", "capped", "warm"]},
}


@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_primitives_match_jax(golden, name):
    """``cr_solve``, ``pcr_solve``, ``bordered_solve``, ``block_cr_solve``,
    ``bordered_block_solve``, the factor/apply pairs and
    ``gauss_seidel_solve`` within 1e-12 relative of the JAX package's."""
    fn, args = PRIMITIVES[name]
    got = fn(*args, "torch")
    want = golden["primitives"][name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w, np.float64)
        assert g.shape == w.shape and np.isfinite(w).all()
        if w.size:
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-300)
            assert err <= 1e-12, err


# ------------------------------------------------------------ layouts, pick
def jax_sim(deck):
    from circuitsimulator_tpu import Simulator as JSim
    return JSim.from_text(deck)


@pytest.mark.parametrize("name", ["ladder200", "ladder20", "grid_blockband",
                                  "grid_blockwb", "grid_rail"])
def test_layouts_and_backend_match_jax(name):
    deck = rc_ladder_netlist(20) if name == "ladder20" else DECKS[name]
    js = jax_sim(deck)
    ts = Simulator.from_text(deck, device="cpu")
    assert (ts.opts.tran_solver, ts.opts.dc_solver) == (
        js.opts.tran_solver, js.opts.dc_solver)
    if name in BACKENDS:
        assert (ts.opts.tran_solver, ts.opts.dc_solver) == BACKENDS[name]
    else:
        assert ts.opts.tran_solver == "woodbury"
    assert banded.is_ladder(ts.engine) == jbanded.is_ladder(js.engine)
    tl, jl = blockband.try_layout(ts.engine), jblockband.try_layout(js.engine)
    assert (tl is None) == (jl is None)
    if tl is not None:
        for key in ("h", "k", "nb", "mb", "n_pad", "ok"):
            assert getattr(tl, key) == getattr(jl, key), key
        for key in ("slot_of", "f_idx", "g_idx", "sol_idx", "hubs"):
            np.testing.assert_array_equal(getattr(tl, key), getattr(jl, key))
    rows, cols = blockband.union_pattern(ts.engine)
    jrows, jcols = jblockband.union_pattern(js.engine)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(cols, jcols)


# ------------------------------------------------------ DC and transient
@pytest.mark.parametrize("name", list(DECKS))
def test_dc_and_transient_match_jax(golden, name):
    sim = Simulator.from_text(DECKS[name], device="cpu")
    assert (sim.opts.tran_solver, sim.opts.dc_solver) == BACKENDS[name]
    x = sim.dc()
    close(x, golden[name]["dc"])
    res = sim.transient(x_op=x)
    assert not bool(res.failed)
    close(res.xs, golden[name]["xs"])
    if name == "grid_charge":
        return
    # the port's own dense run of the deck, at the JAX package's bars
    # (the railed grid's transient only, as tests/test_blockwb.py holds it:
    # its ramped DC takes seconds on the dense path)
    dense = Simulator.from_text(DECKS[name], device="cpu",
                                opts=DEFAULT_OPTIONS.replace(
                                    auto_backend=False))
    if name != "grid_rail":
        np.testing.assert_allclose(x.numpy(), dense.dc().numpy(), rtol=1e-8,
                                   atol=1e-10)
    rd = dense.transient(x_op=x)
    if name == "ladder200":
        np.testing.assert_allclose(res.xs.numpy(), rd.xs.numpy(), rtol=1e-7,
                                   atol=1e-9)
    else:
        np.testing.assert_allclose(res.xs.numpy(), rd.xs.numpy(), atol=5e-13)


# every RHS term and state part, each sign and ground row: current sources
# both ways, inductors grounded and floating, K, a T-line, caps
TERMS_DECK = """* scatter hot path terms
V1 1 0 SIN 0 1 1e8
I1 0 2 DC 1m
I2 3 0 SIN 0 1m 1e8
R1 1 2 50
L1 2 3 1u
L2 4 0 2u
K1 L1 L2 0.5
C1 3 0 1p
C2 3 4 2p
T1 3 0 5 0 Z0=50 TD=1n
R2 5 0 50
R3 4 0 100
D1 5 0 IS=1e-14 N=1
.TRAN 1e-10 1e-8
"""


@pytest.mark.parametrize("name", ["ladder200", "grid_blockband",
                                  "grid_charge", "terms"])
def test_scatter_hotpath_matches_matmul_and_jax(golden, monkeypatch, name):
    """Above ``MATMUL_HOTPATH_BAR`` (the 10k ladder, the 100 x 100 grid)
    the Engine scatters the step's RHS terms and gathers the state.  With
    the bar at 0 the step RHS (BE and TRAP) and the state parts equal the
    matmul path's on the same params and state (1e-12 relative), and the
    golden decks' DC and transient are within 1e-9 V of the JAX
    package's."""
    deck = TERMS_DECK if name == "terms" else DECKS[name]
    mat = Simulator.from_text(deck, device="cpu").engine
    monkeypatch.setattr(assemble, "MATMUL_HOTPATH_BAR", 0)
    sim = Simulator.from_text(deck, device="cpu")
    eng = sim.engine
    assert mat.use_matmul_hotpath and not eng.use_matmul_hotpath
    rng = np.random.default_rng(23)
    x, x2 = f64(rng.uniform(-1.0, 1.0, (2, LANES, eng.N)))
    p = sim.params
    ic = f64(rng.uniform(-1e-3, 1e-3, (LANES, eng.n_caplike)))
    t = f64(3.7e-9)
    for method in ("be", "trap"):
        got, want = ({**e.init_state(x, p, 1e-10), "ic": ic}
                     for e in (eng, mat))
        I, Im = (e.make_tran_static_I(1e-10, method)(p, st, t)
                 for e, st in ((eng, got), (mat, want)))
        np.testing.assert_allclose(I.numpy(), Im.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(Im.abs().max()))
    for a, b in zip(eng._state_parts(x2), mat._state_parts(x2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)
    if name == "terms":
        return
    xdc = sim.dc()
    close(xdc, golden[name]["dc"])
    res = sim.transient(x_op=xdc)
    assert not bool(res.failed)
    close(res.xs, golden[name]["xs"])


def test_tridiag_cr_and_trap_match_jax(golden):
    """The transient's other CR algorithm under the trapezoidal method."""
    opts = DEFAULT_OPTIONS.replace(tridiag_algo="cr", tran_method="trap")
    sim = Simulator.from_text(DECKS["ladder200"], device="cpu", opts=opts)
    assert sim.opts.tran_solver == "tridiag"
    res = sim.transient(x_op=f64(golden["ladder200"]["dc"]))
    close(res.xs, golden["ladder200_cr_trap"]["xs"])


def test_batched_ladder_lanes_match_jax(golden):
    """Lanes through the batched DC and the non-fused batched transient on
    the tridiag backend, each lane as JAX's vmapped run."""
    sim = Simulator.from_text(DECKS["ladder200"], device="cpu")
    bp = tmc.broadcast_params(sim.params, LANES)
    bp["res_r"] = bp["res_r"] * torch.as_tensor(
        lane_scale(bp["res_r"].shape[-1]))
    res = tmc.batched_transient(sim.engine, bp, 1e-11, 1e-10, save_xs=True)
    assert not bool(res.failed.any())
    close(res.xs.transpose(0, 1), golden["ladder_lanes"]["xs"])


def test_adaptive_ladder_matches_jax(golden):
    sim = Simulator.from_text(rc_ladder_netlist(200, tstop=3e-11),
                              device="cpu")
    res = sim.transient(adaptive=True, x_op=f64(golden["ladder200"]["dc"]))
    g = golden["adaptive"]
    close(res.xs, g["xs"])
    assert int(res.n_substeps) == g["n_substeps"]
    assert int(res.n_rejected) == g["n_rejected"]


def test_gauss_seidel_dc_matches_jax(golden):
    sim = Simulator.from_text(SMALL_LADDER, device="cpu")
    close(sim.dc(linear_solver="gs"), golden["gs"]["newton"])
    lin = Simulator.from_text(rc_ladder_netlist(30, diode_every=10**9),
                              device="cpu")
    close(lin.dc(linear_solver="gs"), golden["gs"]["linear"])


def test_dc_refine_residual_and_polish_match_jax(golden):
    g = golden["refine"]
    sim = Simulator.from_text(SMALL_LADDER, device="cpu")
    x = f64(g["x"])
    close(dc_refine(sim.engine, sim.params, x), g["refined"])
    close(dc_residual(sim.engine, sim.params, x), g["residual"], 1e-12)
    close(sim.dc(polish=True), g["polished"])
    bp = tmc.broadcast_params(sim.params, LANES)
    bp["res_r"] = bp["res_r"] * torch.as_tensor(
        lane_scale(bp["res_r"].shape[-1]))
    xb = f64(g["x_lanes"])
    close(dc_refine(sim.engine, bp, xb, batch=LANES), g["refined_lanes"])


def test_cli_on_a_300_node_ladder_matches_jax(tmp_path, monkeypatch,
                                              capsys):
    (tmp_path / "ladder300.sp").write_text(rc_ladder_netlist(300))
    monkeypatch.chdir(tmp_path)
    assert main(["ladder300.sp", "ladder300_tran.csv", "--device", "cpu"]) \
        == 0
    with open(os.path.join(GOLDENS, "ladder300_stdout_jax.txt")) as f:
        assert capsys.readouterr().out == f.read()
    got = np.loadtxt(tmp_path / "ladder300_tran.csv", delimiter=",",
                     skiprows=1)
    ref = np.loadtxt(os.path.join(GOLDENS, "ladder300_tran_jax.csv"),
                     delimiter=",", skiprows=1)
    close(got, ref)


# ------------------------------------------------------------------ goldens
def make_golden():
    """Write the JAX package's results (float64 on the CPU) into
    tests/goldens/large_jax.json, and the JAX CLI's stdout and CSV on the
    300-node ladder into tests/goldens/ladder300_*_jax.*."""
    import tempfile

    from circuitsimulator_tpu import Simulator as JSim
    from circuitsimulator_tpu.analysis.dc import dc_refine as jrefine
    from circuitsimulator_tpu.analysis.dc import dc_residual as jresidual
    from circuitsimulator_tpu.parallel import montecarlo as jmc

    def lst(a):
        return np.asarray(a, np.float64).tolist()

    out = {"primitives": {
        name: [lst(v) for v in fn(*args, "jax")]
        for name, (fn, args) in PRIMITIVES.items()}}
    for name, deck in DECKS.items():
        sim = JSim.from_text(deck)
        x = sim.dc()
        out[name] = {"dc": lst(x), "xs": lst(sim.transient().xs)}
    from circuitsimulator_tpu.utils.options import DEFAULT_OPTIONS as JOPTS
    sim = JSim.from_text(DECKS["ladder200"], opts=JOPTS.replace(
        dtype=jnp.float64, tridiag_algo="cr", tran_method="trap"))
    out["ladder200_cr_trap"] = {"xs": lst(sim.transient().xs)}
    sim = JSim.from_text(DECKS["ladder200"])
    bp = jmc.broadcast_params(sim.params, LANES)
    bp["res_r"] = bp["res_r"] * lane_scale(bp["res_r"].shape[-1])
    out["ladder_lanes"] = {"xs": lst(jmc.batched_transient(
        sim.engine, bp, 1e-11, 1e-10, save_xs=True, fused=False).xs)}
    sim = JSim.from_text(rc_ladder_netlist(200, tstop=3e-11))
    res = sim.transient(adaptive=True)
    out["adaptive"] = {"xs": lst(res.xs),
                       "n_substeps": int(res.n_substeps),
                       "n_rejected": int(res.n_rejected)}
    sim = JSim.from_text(SMALL_LADDER)
    lin = JSim.from_text(rc_ladder_netlist(30, diode_every=10**9))
    out["gs"] = {"newton": lst(sim.dc(linear_solver="gs")),
                 "linear": lst(lin.dc(linear_solver="gs"))}
    x = sim.dc()
    bp = jmc.broadcast_params(sim.params, LANES)
    bp["res_r"] = bp["res_r"] * lane_scale(bp["res_r"].shape[-1])
    xb = jmc.batched_dc_fast(sim.engine, bp)
    out["refine"] = {
        "x": lst(x), "refined": lst(jrefine(sim.engine, sim.params, x)),
        "residual": lst(jresidual(sim.engine, sim.params, x)),
        "polished": lst(sim.dc(polish=True)), "x_lanes": lst(xb),
        "refined_lanes": lst(jrefine(sim.engine, bp, xb, batch=LANES))}
    with open(GOLDEN, "w") as fh:
        json.dump(out, fh)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "ladder300.sp"), "w") as f:
            f.write(rc_ladder_netlist(300))
        env = dict(os.environ, JAX_PLATFORMS="cpu", CSIM_CACHE="0",
                   PYTHONPATH=REPO)
        stdout = subprocess.run(
            [sys.executable, "-m", "circuitsimulator_tpu", "ladder300.sp",
             "ladder300_tran.csv", "--engine", "jax"], cwd=d, env=env,
            check=True, capture_output=True, text=True).stdout
        with open(os.path.join(GOLDENS, "ladder300_stdout_jax.txt"),
                  "w") as f:
            f.write(stdout)
        with open(os.path.join(d, "ladder300_tran.csv")) as f, \
                open(os.path.join(GOLDENS, "ladder300_tran_jax.csv"),
                     "w") as g:
            g.write(f.read())


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    make_golden()
