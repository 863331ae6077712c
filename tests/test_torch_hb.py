"""The port's driven harmonic stack on the CPU, f64, against the JAX
package: harmonic balance (dense and GMRES, single lane and batched), the
GMRES solver itself, shooting, the multi-tone grid with two-tone IP3 and
P1dB, the envelope transient (both orders, single lane and batched), the
HB sensitivities, ``.STEP`` x ``.hb``, ``Simulator.monte_carlo_hb`` and
``monte_carlo_ip3``, and the CLI's ``--run-hb`` and ``--run-envelope``
(with ``--mc-rf``: ``monte_carlo_envelope``).

The JAX results are ``tests/goldens/hb_jax.npz`` and the JAX CLI's
``tests/goldens/hb_cli_*_jax.*`` (each JAX solve compiles for seconds on
the CPU); ``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_hb.py
[case ...]``, from the repository's root, remakes them with the JAX
package (the named cases only: a ``CASES`` key, ``mc_hb``, ``mc_ip3``,
``step`` or ``cli_<name>``).  Each case
function runs one package (``pkg`` "jax" or "torch") with the same
settings; the warm-up transients are shortened (``warmup_periods``, and
for the CLI cases partials of the solvers' defaults applied to both
packages alike) to keep the port's CPU time small.

Bars: X within 1e-9 V of JAX and Newton counts equal; GMRES within
1e-9 V of the port's dense run; J v without forming J within 1e-12
relative of the dense J v; scalars (IP3, P1dB, gradients) within 1e-9
relative (gradients 1e-7 of the largest entry)."""

import contextlib
import functools
import importlib
import io
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
GOLDEN = os.path.join(GOLDENS, "hb_jax.npz")
ROOT = {"jax": "circuitsimulator_tpu", "torch": "circuitsimulator_tpu_torch"}
TOL_V = 1e-9

INV = (".MODEL 2 VT 0.4 MU 1e-2 COX 1e-3 LAMBDA 0.05 CJ0 1e-13\n"
       "VDD 1 0 3\nVin 2 0 SIN 1 0.5 1e8\nRD 1 3 1k\n"
       "M1 3 2 0 n 10e-6 1e-6 2\nC1 3 0 2e-13\nL1 3 4 1e-8\nR4 4 0 1k\n"
       ".hb 1e8 6\n")
TL = ("V1 1 0 SIN 0 1 1e8\nR1 1 2 50\nT1 2 0 3 0 Z0=50 TD=2.5e-9\n"
      "D1 3 0 1\n.MODEL 1 IS 1e-12\nRL 3 0 120\n.hb 1e8 5\n")
RECT = ("* diode rectifier with a toleranced series R\n"
        "V1 in 0 SIN 0 1 1e6\nR1 in out 1k DEV=10%\nD1 out 0 1\n"
        ".MODEL 1 IS 1e-12\nRL out 0 1k\n.hb 1e6 7\n")
STEP = (".PARAM amp=1\nV1 in 0 SIN 0 {amp} 1e6\nR1 in out 1k\nD1 out 0 1\n"
        ".MODEL 1 IS 1e-12\nRL out 0 1k\n.hb 1e6 7\n"
        ".STEP PARAM amp 0.5 1.5 0.5\n")
CUBIC2 = ("* two-tone cubic\n.PARAM a3=0.1\nV1 m 0 SIN 0 0.1 1.0e6\n"
          "V2 x m SIN 0 0.1 1.3e6\nB1 out 0 V=v(x) + a3*v(x)^3\n"
          "RO out 0 1k\n.hb 1.0e6 3 1.3e6 3\n.end\n")
MC_IP3 = ("* two-tone cubic behind a toleranced divider\n"
          "V1 m 0 SIN 0 0.2 1.0e6\nV2 x m SIN 0 0.2 1.3e6\n"
          "R1 x y 1k DEV=5%\nR2 y 0 1k DEV=5%\n"
          "B1 out 0 V=v(y) + 0.1*v(y)^3\nRO out 0 1k\n"
          ".hb 1.0e6 3 1.3e6 3\n.end\n")
COMP = ("* compressor\n.PARAM a3=0.1\nV1 x 0 SIN 0 0.2 1.0e6\n"
        "B1 out 0 V=v(x) - a3*v(x)^3\nRO out 0 1k\n.hb 1.0e6 5\n.end\n")
P1DB = ("* compressor\nV1 x 0 SIN 0 0.3 1.0e6\n"
        "B1 out 0 V=v(x) - v(x)^3\nRO out 0 1k\n.hb 1.0e6 5\n.end\n")
AM_RC = ("* AM step into RC\nVc carr 0 SIN 0 1 1e6\nRc carr 0 1k\n"
         "Vb base 0 PULSE(0.5 1 0 1e-9 1e-9 1 1)\nRb base 0 1k\n"
         "Bm m 0 V=v(base)*v(carr)\nRr m out 1k\n"
         "Cc out 0 1.5915494309189535e-10 DEV=10%\n.op\n")


def _read(path):
    with open(os.path.join(REPO, path)) as f:
        return f.read()


def mod(pkg, name):
    return importlib.import_module(f"{ROOT[pkg]}.{name}")


def _make_sim(pkg, text, charge):
    Sim = mod(pkg, "api").Simulator
    opts = mod(pkg, "utils.options").DEFAULT_OPTIONS
    if charge:
        opts = opts.replace(mos_cap_model="charge")
    if pkg == "jax":
        return Sim.from_text(text, opts=opts)
    return Sim.from_text(text, opts=opts, device="cpu")


@functools.lru_cache(maxsize=None)
def _port_sim(text, charge):
    return _make_sim("torch", text, charge)


def sim_of(pkg, text, charge=False):
    """A Simulator of either package; the port's are shared between cases
    (so are their warm-ups, ``shared_runs``)."""
    if pkg == "torch":
        return _port_sim(text, charge)
    return _make_sim(pkg, text, charge)


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def lanes(pkg, params, B, scale):
    """params broadcast to B lanes, the leaves of ``scale`` multiplied by
    its (B, n) numpy factors."""
    if pkg == "jax":
        import jax.numpy as jnp
        bp = {k: jnp.broadcast_to(v, (B,) + jnp.shape(v))
              for k, v in params.items()}
        for k, f in scale.items():
            bp[k] = bp[k] * jnp.asarray(f)
        return bp
    bp = {k: v.expand((B,) + v.shape) for k, v in params.items()}
    for k, f in scale.items():
        bp[k] = bp[k] * torch.as_tensor(f)
    return bp


def factors(B, n, seed):
    return np.exp(0.05 * np.random.default_rng(seed).standard_normal((B, n)))


def eq_of(sim, node):
    return sim.circuit.nodes[sim.circuit.node_name_to_id[node]].eq_index


def hb_out(r):
    return {"xs": host(r.xs), "iters": np.asarray(r.newton_iters),
            "residual": np.asarray(float(r.residual))}


# ------------------------------------------------------------ case functions
# Each returns a dict of numpy arrays; the JAX side's are in the golden.
HB_DECKS = {"buffer": (lambda: _read("tests/netlists/buffer.sp"), False, 1e7,
                       8, 1),
            "inv_charge": (lambda: INV, True, 1e8, 6, 1),
            "dbmixer": (lambda: _read("tests/netlists/dbmixer.sp"), False,
                        1e8, 3, 1),
            "tline": (lambda: TL, False, 1e8, 5, 2)}


def case_hb(pkg, deck, solver):
    text, charge, f0, H, wp = HB_DECKS[deck]
    s = sim_of(pkg, text(), charge)
    r = mod(pkg, "analysis.hb").harmonic_balance(
        s.engine, s.params, f0, n_harm=H, warmup_periods=wp, solver=solver)
    return hb_out(r)


def case_shooting(pkg):
    s = sim_of(pkg, _read("examples/mixer_rf.sp"))
    r = s.steady_state(steps_per_period=64, warmup_periods=1)
    return {"xs": host(r.xs), "iters": np.asarray(r.newton_iters),
            "spectrum": host(r.spectrum), "s": host(r.s)}


def case_ip3(pkg):
    s = sim_of(pkg, CUBIC2)
    out = s.two_tone_ip3("out", input_amplitude=0.1, warmup_periods=1)
    return {k: np.asarray(out[k]) for k in ("fund", "im3", "im3_dbc",
                                            "iip3_amplitude",
                                            "oip3_amplitude")} | {
        "xs": host(out["result"].xs),
        "iters": np.asarray(out["result"].newton_iters)}


def case_p1db(pkg):
    s = sim_of(pkg, P1DB)
    out = s.p1db("out", "V1", a_max_scale=2.0, iters=3, warmup_periods=1)
    return {k: np.asarray(v) for k, v in out.items()}


def case_envelope(pkg, order):
    s = sim_of(pkg, _read("examples/am_envelope.sp"))
    r = s.envelope(3e-7, 1e-7, n_harm=5, order=order, warmup_periods=1)
    return {"coeffs": r.coeffs, "residuals": np.asarray(r.residuals),
            "xs": np.asarray(r.xs)}


def case_hb_batched(pkg, solver):
    s = sim_of(pkg, RECT)
    bp = lanes(pkg, s.params, 4, {"res_r": factors(4, 2, 5)})
    r = mod(pkg, "analysis.hb").harmonic_balance_batched(
        s.engine, bp, 1e6, n_harm=7, warmup_periods=1, solver=solver)
    return {"xs": host(r.xs), "residual": host(r.residual)}


def case_envelope_batched(pkg):
    s = sim_of(pkg, AM_RC)
    bp = lanes(pkg, s.params, 4, {"cap_c": factors(4, 1, 6)})
    r = mod(pkg, "analysis.envelope").envelope_transient_batched(
        s.engine, bp, 1e6, 3e-7, 1e-7, n_harm=3, warmup_periods=1)
    return {"xs": host(r.xs), "coeffs": host(r.coeffs),
            "residuals": host(r.residuals)}


def case_mc_hb(pkg, draws=None):
    """Simulator.monte_carlo_hb(4); the port's lanes are JAX's draws
    (``draws``: the perturbed res_r), fed through its
    perturb_params_netlist."""
    s = sim_of(pkg, RECT)
    if pkg == "torch":
        mc = mod(pkg, "parallel.montecarlo")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mc, "perturb_params_netlist", functools.partial(
                _fixed_draws, {"res_r": draws}))
            bp, r = s.monte_carlo_hb(4, seed=3, warmup_periods=1)
    else:
        bp, r = s.monte_carlo_hb(4, seed=3, warmup_periods=1)
    return {"res_r": host(bp["res_r"]), "xs": host(r.xs),
            "converged": host(r.converged)}


def case_mc_ip3(pkg, draws=None):
    """Simulator.monte_carlo_ip3(4) on the divider deck (the port's lanes:
    JAX's draws of res_r, as in case_mc_hb)."""
    s = sim_of(pkg, MC_IP3)
    kw = dict(seed=1, n_newton=6, warmup_n_newton=6)
    if pkg == "torch":
        mc = mod(pkg, "parallel.montecarlo")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mc, "perturb_params_netlist", functools.partial(
                _fixed_draws, {"res_r": draws}))
            bp, out = s.monte_carlo_ip3(4, "out", 0.1, **kw)
    else:
        bp, out = s.monte_carlo_ip3(4, "out", 0.1, **kw)
    return {"res_r": host(bp["res_r"]), "xs": host(out["result"].xs),
            **{k: host(out[k]) for k in ("fund", "im3", "iip3_amplitude",
                                         "converged")}}


def _fixed_draws(arrays, params, generator, batch, mc_tols, sampler="mc"):
    """perturb_params_netlist's signature, returning given lanes."""
    out = {k: v.expand((batch,) + v.shape) for k, v in params.items()}
    for k, a in arrays.items():
        out[k] = torch.as_tensor(a, dtype=params[k].dtype)
    return out


def case_step(pkg, path):
    s = sim_of(pkg, STEP)
    a = mod(pkg, "analysis.hb")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(a, "harmonic_balance_batched", functools.partial(
            a.harmonic_balance_batched, warmup_periods=1))
        sres = s.step()
    mod(pkg, "analysis.step").write_step_csv(path, s.topo, sres)
    return {"xs": host(sres.result.xs),
            "csv": np.loadtxt(path, delimiter=",", skiprows=1),
            "analysis": np.asarray(sres.analysis)}


def case_hb_gradient(pkg):
    s = sim_of(pkg, COMP)
    d = mod(pkg, "analysis.hb_diff")
    val, g = d.hb_gradient(s.engine, s.params, 1e6, 5,
                           d.fundamental_metric(eq_of(s, "out")),
                           warmup_periods=1)
    return {"value": np.asarray(val)} | {f"g_{k}": host(v)
                                          for k, v in g.items()}


def case_hbmulti_gradient(pkg):
    s = sim_of(pkg, CUBIC2)
    d = mod(pkg, "analysis.hb_diff")
    val, g = d.hbmulti_gradient(
        s.engine, s.params, s.config.hb.tones,
        d.mixed_harmonic_metric(eq_of(s, "out"), (2, -1)), warmup_periods=1)
    return {"value": np.asarray(val)} | {f"g_{k}": host(v)
                                          for k, v in g.items()}


def gmres_systems():
    """(A, b, P, restart, maxiter, tol) of random preconditioned systems,
    then a batch of three without a preconditioner."""
    rng = np.random.default_rng(0)
    out = []
    for n, restart, maxiter, tol in ((30, 10, 3, 1e-8), (20, 25, 2, 1e-12)):
        A = rng.standard_normal((n, n)) + np.sqrt(n) * np.eye(n)
        b = rng.standard_normal(n)
        P = np.linalg.inv(A + 0.3 * rng.standard_normal((n, n)))
        out.append((A, b, P, restart, maxiter, tol))
    out.append((rng.standard_normal((3, 20, 20)) + 5.0 * np.eye(20),
                rng.standard_normal((3, 20)), None, 7, 3, 1e-6))
    return out


def case_gmres(pkg):
    """ops/gmres and jax.scipy.sparse.linalg.gmres(solve_method=
    "batched") on the same systems (the batch: JAX's vmap, the port's
    lane axis), restarts and early stops included."""
    res = {}
    for i, (A, b, P, restart, maxiter, tol) in enumerate(gmres_systems()):
        kw = dict(tol=tol, restart=restart, maxiter=maxiter)
        if pkg == "jax":
            import jax
            import jax.numpy as jnp
            from jax.scipy.sparse.linalg import gmres as jgmres
            if P is None:
                x = jax.vmap(lambda A, b: jgmres(
                    lambda v: A @ v, b, solve_method="batched", **kw)[0])(
                    jnp.asarray(A), jnp.asarray(b))
            else:
                x, _ = jgmres(lambda v: A @ v, jnp.asarray(b),
                              M=lambda v: P @ v, atol=0.0,
                              solve_method="batched", **kw)
        else:
            from circuitsimulator_tpu_torch.ops.gmres import gmres
            At = torch.as_tensor(A)
            M = (None if P is None else
                 (lambda v, Pt=torch.as_tensor(P): v @ Pt.T))
            x = gmres(lambda v: (At @ v[..., None])[..., 0],
                      torch.as_tensor(b), M=M, sync=P is not None, **kw)
        res[f"x{i}"] = host(x)
    return res


CASES = {
    "gmres": (case_gmres, ()),
    **{f"hb_{d}_{s}": (case_hb, (d, s)) for d in HB_DECKS
       for s in ("dense", "gmres")},
    "shooting": (case_shooting, ()),
    "ip3": (case_ip3, ()),
    "p1db": (case_p1db, ()),
    "envelope_1": (case_envelope, (1,)),
    "envelope_2": (case_envelope, (2,)),
    "hb_batched_dense": (case_hb_batched, ("dense",)),
    "hb_batched_gmres": (case_hb_batched, ("gmres",)),
    "envelope_batched": (case_envelope_batched, ()),
    "hb_gradient": (case_hb_gradient, ()),
    "hbmulti_gradient": (case_hbmulti_gradient, ()),
}

# ---------------------------------------------------------------- CLI cases
# (deck, argv after the deck, CSV names); the solvers' defaults are
# shortened alike in both packages (``_short_defaults``)
CLI = {"shooting": ("examples/mixer_rf.sp", ["--run-hb", "hb.csv"],
                    ["hb.csv"]),
       "hb_dense": ("examples/mixer_rf.sp",
                    ["--run-hb", "hb.csv", "--hb-method", "hb"], ["hb.csv"]),
       "hb_gmres": ("examples/mixer_rf.sp",
                    ["--run-hb", "hb.csv", "--hb-method", "hb",
                     "--hb-solver", "gmres"], ["hb.csv"]),
       "envelope": ("examples/am_envelope.sp",
                    ["--no-tran", "--run-envelope", "3e-7:1e-7:env.csv",
                     "--env-order", "2"], ["env.csv"]),
       "envelope_mc": ("am_rc.sp",
                       ["--run-envelope", "3e-7:1e-7:env.csv", "--mc-rf",
                        "4"], ["env.csv"])}


@contextlib.contextmanager
def _short_defaults(pkg):
    """The solvers the CLI calls with shorter warm-ups (and shooting at 64
    steps a period), the same in both packages."""
    a = mod(pkg, "analysis.hb")
    ss = mod(pkg, "analysis.sstate")
    env = mod(pkg, "analysis.envelope")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(a, "harmonic_balance", functools.partial(
            a.harmonic_balance, warmup_periods=2))
        mp.setattr(ss, "steady_state", functools.partial(
            ss.steady_state, steps_per_period=64, warmup_periods=1))
        mp.setattr(env, "envelope_transient", functools.partial(
            env.envelope_transient, warmup_periods=1))
        mp.setattr(env, "envelope_transient_batched", functools.partial(
            env.envelope_transient_batched, warmup_periods=1))
        yield mp


def run_cli(pkg, name, workdir, draws=None):
    """Run the CLI case in ``workdir``; returns (rc, stdout)."""
    deck, args, _ = CLI[name]
    os.makedirs(os.path.join(workdir, os.path.dirname(deck)), exist_ok=True)
    text = AM_RC.replace(".op", ".hb 1e6 3") if deck == "am_rc.sp" \
        else _read(deck)
    with open(os.path.join(workdir, deck), "w") as f:
        f.write(text)
    argv = [deck, "tran.csv", *args]
    if pkg == "jax":
        argv += ["--engine", "jax"]
    else:
        argv += ["--device", "cpu"]
    cwd = os.getcwd()
    out = io.StringIO()
    try:
        os.chdir(workdir)
        with _short_defaults(pkg) as mp, contextlib.redirect_stdout(out):
            if draws is not None:
                mp.setattr(mod(pkg, "parallel.montecarlo"),
                           "perturb_params_netlist",
                           functools.partial(_fixed_draws, draws))
            rc = mod(pkg, "cli").main(argv)
    finally:
        os.chdir(cwd)
    return rc, out.getvalue()


# --------------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _fingerprint(engine, params, *more):
    """A key of a deterministic solver call: the engine's options and
    size, every parameter leaf's bytes and the other arguments."""
    leaves = tuple((k, v.shape, v.detach().cpu().numpy().tobytes())
                   for k, v in sorted(params.items()))
    extra = tuple(m.detach().cpu().numpy().tobytes()
                  if isinstance(m, torch.Tensor) else m for m in more)
    return (repr(engine.opts), engine.N, leaves, extra)


@pytest.fixture(scope="module", autouse=True)
def shared_runs():
    """The port's warm-up transients and shooting solves computed once per
    distinct input (parameters, start, grid; cached by their contents):
    the dense and GMRES solves of a deck start from the same samples, and
    the CLI's shooting run on mixer_rf.sp is the API case's."""
    hb = mod("torch", "analysis.hb")
    ss = mod("torch", "analysis.sstate")
    real_w, real_s = hb.warmup_samples, ss.steady_state
    cache = {}

    def warmup(engine, params, x0, T, K, wp):
        key = ("w",) + _fingerprint(engine, params, x0, T, K, wp)
        if key not in cache:
            cache[key] = real_w(engine, params, x0, T, K, wp)
        return cache[key].clone()

    def steady(engine, params, f0, **kw):
        key = ("s",) + _fingerprint(engine, params, f0,
                                    tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = real_s(engine, params, f0, **kw)
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hb, "warmup_samples", warmup)
        mp.setattr(ss, "steady_state", steady)
        yield


_sims = {}


def _port(name):
    """The port's result of a case, computed once per module (the dense
    and GMRES comparisons share them)."""
    if name not in _sims:
        fn, args = CASES[name]
        _sims[name] = fn("torch", *args)
    return _sims[name]


def want(golden, name):
    pre = name + "/"
    return {k[len(pre):]: v for k, v in golden.items() if k.startswith(pre)}


def close(got, ref, tol=TOL_V):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= tol, err


def rel_close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300) if ref.size else 1.0
    err = float(np.abs(got - ref).max()) / scale if ref.size else 0.0
    assert err <= rtol, err


def test_spectral_operators_equal_jax():
    jhb = mod("jax", "analysis.hb")
    jmt = mod("jax", "analysis.hbmulti")
    thb = mod("torch", "analysis.hb")
    tmt = mod("torch", "analysis.hbmulti")
    for K, T in ((7, 1e-6), (15, 2.0), (101, 1e-8)):
        np.testing.assert_array_equal(thb.spectral_diff_matrix(K, T),
                                      jhb.spectral_diff_matrix(K, T))
        for a, b in zip(thb._hb_trig_mats(K, (K - 1) // 2, T),
                        jhb._hb_trig_mats(K, (K - 1) // 2, T)):
            np.testing.assert_array_equal(a, b)
    for Ks, fs in (([7, 5], [1e6, 1.3e6]), ([5, 3, 3], [1e7, 2.3e7, 3e6])):
        for a, b in zip(tmt._mt_basis(Ks, fs), jmt._mt_basis(Ks, fs)):
            np.testing.assert_array_equal(a, b)


def test_gmres_matches_jax_gmres(golden):
    got, ref = _port("gmres"), want(golden, "gmres")
    for k in ref:
        rel_close(got[k], ref[k], 1e-12)


@pytest.mark.parametrize("deck", list(HB_DECKS))
def test_harmonic_balance_dense_and_gmres_match_jax(deck, golden):
    for solver in ("dense", "gmres"):
        got, ref = _port(f"hb_{deck}_{solver}"), want(golden,
                                                      f"hb_{deck}_{solver}")
        close(got["xs"], ref["xs"])
        assert int(got["iters"]) == int(ref["iters"]), solver
        assert float(got["residual"]) < 1e-9
    close(_port(f"hb_{deck}_gmres")["xs"], _port(f"hb_{deck}_dense")["xs"])


@pytest.mark.parametrize("deck", ["tline", "inv_charge"])
def test_jv_matches_dense_jacobian(deck):
    """HarmonicSystem.jv (J v without J: A_t, the spectral reactive term,
    the charge blocks, the T-line delays) against the dense J @ v, at a
    random grid state and direction; and GMRES's Newton step against the
    dense one at that state."""
    text, charge, f0, H, _ = HB_DECKS[deck]
    s = sim_of("torch", text(), charge)
    hb = mod("torch", "analysis.hb")
    sys_ = hb.hb_system(s.engine, f0, H)
    ctx = sys_.prepare(s.params)
    K, N = 2 * H + 1, s.engine.N
    rng = np.random.default_rng(3)
    X = torch.as_tensor(0.3 * rng.standard_normal((K, N)) + 0.5)
    V = torch.as_tensor(rng.standard_normal((K, N)))
    _, aux = sys_.residual_ctx(X, ctx, True)
    J = sys_.jacobian_ctx(aux, ctx)
    rel_close(sys_.jv(aux, ctx, V).reshape(-1).numpy(),
              (J @ V.reshape(-1)).numpy(), 1e-12)


def test_shooting_matches_jax(golden):
    got, ref = _port("shooting"), want(golden, "shooting")
    close(got["xs"], ref["xs"], 1e-8)
    close(got["s"], ref["s"], 1e-8)
    assert int(got["iters"]) == int(ref["iters"])
    close(got["spectrum"], ref["spectrum"], 1e-8)


def test_two_tone_ip3_and_p1db_match_jax(golden):
    got, ref = _port("ip3"), want(golden, "ip3")
    close(got["xs"], ref["xs"])
    assert int(got["iters"]) == int(ref["iters"])
    for k in ("fund", "im3", "iip3_amplitude", "oip3_amplitude"):
        rel_close(got[k], ref[k], 1e-9)
    close(got["im3_dbc"], ref["im3_dbc"], 1e-7)
    got, ref = _port("p1db"), want(golden, "p1db")
    assert int(got["n_solves"]) == int(ref["n_solves"])
    for k in ("a_1db", "gain_ss", "gain_1db"):
        rel_close(got[k], ref[k], 1e-9)


@pytest.mark.parametrize("order", [1, 2])
def test_envelope_matches_jax(order, golden):
    got, ref = _port(f"envelope_{order}"), want(golden, f"envelope_{order}")
    close(got["xs"], ref["xs"])
    close(got["coeffs"], ref["coeffs"])
    assert (got["residuals"] < 1e-9).all()


@pytest.mark.parametrize("solver", ["dense", "gmres"])
def test_batched_hb_and_envelope_match_jax(solver, golden):
    got = _port(f"hb_batched_{solver}")
    close(got["xs"], want(golden, f"hb_batched_{solver}")["xs"])
    assert (got["residual"] < 1e-9).all()
    if solver == "dense":
        close(_port("hb_batched_gmres")["xs"], got["xs"])
        got, ref = _port("envelope_batched"), want(golden, "envelope_batched")
        close(got["xs"], ref["xs"])
        close(got["coeffs"], ref["coeffs"])


def test_monte_carlo_hb_ip3_and_step_hb_match_jax(golden, tmp_path):
    ref = want(golden, "mc_hb")
    got = case_mc_hb("torch", ref["res_r"])
    close(got["xs"], ref["xs"])
    assert got["converged"].all() and ref["converged"].all()
    ref = want(golden, "mc_ip3")
    got = case_mc_ip3("torch", ref["res_r"])
    close(got["xs"], ref["xs"])
    assert got["converged"].all() and ref["converged"].all()
    for k in ("fund", "im3", "iip3_amplitude"):
        rel_close(got[k], ref[k], 1e-9)
    ref = want(golden, "step")
    got = case_step("torch", str(tmp_path / "step.csv"))
    assert str(got["analysis"]) == "hb"
    close(got["xs"], ref["xs"])
    rel_close(got["csv"], ref["csv"], 1e-9)


@pytest.mark.parametrize("name", ["hb_gradient", "hbmulti_gradient"])
def test_hb_gradients_match_jax(name, golden):
    got, ref = _port(name), want(golden, name)
    assert set(got) == set(ref)
    rel_close(got["value"], ref["value"], 1e-9)
    scale = max(float(np.abs(ref[k]).max()) for k in ref
                if k.startswith("g_") and ref[k].size)
    for k in ref:
        if k.startswith("g_"):
            close(got[k], ref[k], 1e-7 * scale)


def _numbers(line):
    out = []
    for w in line.replace(",", " ").replace("=", " ").split():
        try:
            out.append(float(w))
        except ValueError:
            pass
    return out


@pytest.mark.parametrize("name", list(CLI))
def test_cli_run_hb_and_envelope_match_jax_goldens(name, tmp_path, golden):
    draws = ({"cap_c": golden["cli_envelope_mc/cap_c"]}
             if name == "envelope_mc" else None)
    rc, out = run_cli("torch", name, str(tmp_path), draws)
    assert rc == 0
    with open(os.path.join(GOLDENS, f"hb_cli_{name}_stdout_jax.txt")) as f:
        ref = f.read().splitlines()
    got = out.splitlines()
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if "residual=" in r:
            # the residual figures differ; both below tolerance
            assert _numbers(g.split("residual=")[1])[0] < 1e-9
            assert _numbers(r.split("residual=")[1])[0] < 1e-9
            continue
        if g != r:
            # a table row: the same words, numbers within 1e-9 V
            assert [w for w in g.split() if not _numbers(w)] == \
                [w for w in r.split() if not _numbers(w)], (g, r)
            np.testing.assert_allclose(_numbers(g), _numbers(r), rtol=0,
                                       atol=TOL_V)
    for csv in CLI[name][2]:
        a = np.loadtxt(tmp_path / csv, delimiter=",", skiprows=1)
        b = np.loadtxt(os.path.join(GOLDENS, f"hb_cli_{name}_{csv[:-4]}"
                                    f"_jax.csv"), delimiter=",", skiprows=1)
        if name.startswith("envelope"):
            # magnitude and phase columns: the phase in degrees
            close(a[:, 1::2], b[:, 1::2])
            close(a[:, 2::2], b[:, 2::2], 1e-6)
        else:
            close(a, b)


def make_golden():
    """Write the JAX package's results (float64 on the CPU) into
    tests/goldens/hb_jax.npz and the JAX CLI's stdout and CSVs into
    tests/goldens/hb_cli_*_jax.*."""
    import tempfile
    only = set(sys.argv[1:])
    out = {}
    if only and os.path.exists(GOLDEN):
        with np.load(GOLDEN) as z:
            out = {k: z[k] for k in z.files
                   if k.split("/")[0] not in only}
    for name, (fn, args) in CASES.items():
        if only and name not in only:
            continue
        for k, v in fn("jax", *args).items():
            out[f"{name}/{k}"] = np.asarray(v)
        print(name, flush=True)
    if not only or "mc_hb" in only:
        for k, v in case_mc_hb("jax").items():
            out[f"mc_hb/{k}"] = v
    if not only or "mc_ip3" in only:
        for k, v in case_mc_ip3("jax").items():
            out[f"mc_ip3/{k}"] = v
    if not only or "step" in only:
        with tempfile.TemporaryDirectory() as d:
            for k, v in case_step("jax", os.path.join(d, "s.csv")).items():
                out[f"step/{k}"] = v
    s = sim_of("jax", AM_RC.replace(".op", ".hb 1e6 3"))
    bp = mod("jax", "parallel.montecarlo").perturb_params_netlist(
        s.params, __import__("jax").random.key(0), 4, s.lowered.mc_tols)
    out["cli_envelope_mc/cap_c"] = np.asarray(bp["cap_c"])
    np.savez_compressed(GOLDEN, **out)
    for name, (_, _, csvs) in CLI.items():
        if only and f"cli_{name}" not in only:
            continue
        with tempfile.TemporaryDirectory() as d:
            rc, stdout = run_cli("jax", name, d)
            assert rc == 0, (name, stdout)
            with open(os.path.join(
                    GOLDENS, f"hb_cli_{name}_stdout_jax.txt"), "w") as f:
                f.write(stdout)
            for csv in csvs:
                with open(os.path.join(d, csv)) as src, open(os.path.join(
                        GOLDENS, f"hb_cli_{name}_{csv[:-4]}_jax.csv"),
                        "w") as dst:
                    dst.write(src.read())
        print("cli", name, flush=True)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, REPO)
    make_golden()
