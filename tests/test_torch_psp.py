"""The port's hot and large-signal S-parameters on the CPU, f64, against
the JAX package: ``periodic_s_parameters`` (tests/test_psp.py's
up-converter, an LTI two-port around a zero PSS, a T-line deck), the
batched form over numpy-drawn lanes (each lane also against the port's
single-lane result), ``Simulator.lssp`` and ``lssp_batched`` on
test_psp.py's linear and compressive decks, ``monte_carlo_psp`` and
``monte_carlo_lssp`` (the port fed JAX's draws), and the CLI's
``--run-hot-sparams`` and ``--run-lssp`` (with ``--lssp-powers`` and
``--mc-rf``) against the JAX CLI's goldens.

The JAX side is ``tests/goldens/psp_jax.npz`` and the JAX CLI's
``tests/goldens/psp_cli_*_jax.*``: ``PYTHONPATH=. JAX_PLATFORMS=cpu
python tests/test_torch_psp.py``, from the repository's root, remakes
them with the JAX package.  The S-parameter cases take JAX's periodic
steady state from the golden (``pss_xs``); every harmonic balance runs
with one warm-up period in both packages, and the port's identical HB
solves are shared between the API and CLI cases (``shared_hb``).

Bars: S, Z and the CSVs within 1e-9 of their largest magnitude; stdout
line for line, numbers within 1e-9 relative."""

import contextlib
import functools
import importlib
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
GOLDEN = os.path.join(GOLDENS, "psp_jax.npz")
ROOT = {"jax": "circuitsimulator_tpu", "torch": "circuitsimulator_tpu_torch"}
RTOL = 1e-9
WARMUP = 1
F0 = 10e6

MIXER = f"""* up-converter
VLO lo 0 SIN 0 0.4 {F0}
RLO lo 0 1k
R1 rf 0 100
R2 if 0 130
B1 0 if I=v(rf)*v(lo)
.hb {F0} 5
"""
MIXER_MC = MIXER.replace("R1 rf 0 100", "R1 rf 0 100 DEV=5%").replace(
    "R2 if 0 130", "R2 if 0 130 DEV=5%")
LTI = """* lti two-port
R1 a b 1k
C1 b 0 1n
R2 a 0 500
.op
"""
TL = """* T-line LPTV deck
Vlo lo 0 SIN 0 0.5 20e6
Rlo lo 0 1k
V1 src 0 DC 1 AC 1
Rs src in 10
T1 in 0 out 0 Z0=50 TD=7n
RL out 0 200
.hb 20e6 4
"""
INNER = """R3 p1 p2 100
RL p2 0 200
C2 p2 0 1n
"""
LSSP_LINEAR = f"""* lssp linear
V1 s1 0 SIN 0 1 {F0}
RS1 s1 p1 50
V2 s2 0 SIN 0 1 {F0}
RS2 s2 p2 50
{INNER}.hb {F0} 4
"""
LSSP_COMP = f"""* lssp compressive
V1 s1 0 SIN 0 1 {F0}
RS1 s1 p1 50
V2 s2 0 SIN 0 1 {F0}
RS2 s2 p2 50
{INNER}B1 p2 0 I=0.5*v(p2)^3
.hb {F0} 6
"""
LSSP_COMP_MC = LSSP_COMP.replace("RL p2 0 200", "RL p2 0 200 DEV=5%")
DECKS = {"mixer": MIXER, "mixer_mc": MIXER_MC, "lti": LTI, "tl": TL,
         "lssp_linear": LSSP_LINEAR, "lssp_comp": LSSP_COMP,
         "lssp_comp_mc": LSSP_COMP_MC}
PORTS = {"mixer": [("rf", None, 50.0), ("if", None, 50.0)],
         "lti": [("a", None, 50.0), ("b", None, 75.0)],
         "tl": [("in", None, 50.0), ("out", None, 50.0)]}
LSSP_PORTS = [("V1", "p1", 50.0), ("V2", "p2", 50.0)]
DELTAS = [1.3e5, 3.1e5]


def mod(pkg, name):
    return importlib.import_module(f"{ROOT[pkg]}.{name}")


@functools.lru_cache(maxsize=None)
def sim_of(pkg, deck):
    Sim = mod(pkg, "api").Simulator
    if pkg == "jax":
        return Sim.from_text(DECKS[deck])
    return Sim.from_text(DECKS[deck], device="cpu")


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def lanes(pkg, params, B, scale):
    """params broadcast to B lanes, the leaves of ``scale`` multiplied by
    their (B, n) numpy factors."""
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


def _fixed_draws(arrays, params, generator, batch, mc_tols, sampler="mc"):
    """perturb_params_netlist's signature, returning given lanes."""
    out = {k: v.expand((batch,) + v.shape) for k, v in params.items()}
    for k, a in arrays.items():
        out[k] = torch.as_tensor(a, dtype=params[k].dtype)
    return out


@contextlib.contextmanager
def draws_of(pkg, draws):
    """The port's perturb_params_netlist returning JAX's lanes."""
    if pkg == "jax" or draws is None:
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod(pkg, "parallel.montecarlo"), "perturb_params_netlist",
                   functools.partial(_fixed_draws, draws))
        yield


# ------------------------------------------------------------ case functions
def case_psp(pkg, deck, pss):
    s = sim_of(pkg, deck)
    f0 = F0 if deck == "lti" else s.config.hb.f0
    res = s.hot_sparams(PORTS[deck], DELTAS, f0=f0, n_sidebands=1,
                        pss_xs=pss)
    return {"s": res.s, "z": res.z}


BATCHED = {"mixer": {"res_r": (3, 4)}, "tl": {"res_r": (3, 5),
                                              "tl_td": (1, 6)}}


def _port_eqs(s, deck):
    """(port_eqs, z0s) of a deck's grounded ports, ground the dump slot."""
    return ([(s.circuit.nodes[s.circuit.node_name_to_id[p]].eq_index,
              s.topo.n_unknowns) for p, _, _ in PORTS[deck]],
            [z for _, _, z in PORTS[deck]])


def case_psp_batched(pkg, deck, pss_b):
    s = sim_of(pkg, deck)
    bp = lanes(pkg, s.params, 4, {k: factors(4, n, seed) for k, (n, seed)
                                  in BATCHED[deck].items()})
    eqs, z0s = _port_eqs(s, deck)
    res = mod(pkg, "analysis.psp").periodic_s_parameters_batched(
        s.engine, bp, s.config.hb.f0, pss_b, eqs, z0s, DELTAS)
    return {"s": res.s, "z": res.z}


def case_psp_single_lanes(deck, pss_b):
    s = sim_of("torch", deck)
    bp = lanes("torch", s.params, 4, {k: factors(4, n, seed)
                                      for k, (n, seed)
                                      in BATCHED[deck].items()})
    eqs, z0s = _port_eqs(s, deck)
    psp = mod("torch", "analysis.psp")
    rs = [psp.periodic_s_parameters(s.engine, {k: v[b] for k, v in
                                               bp.items()},
                                    s.config.hb.f0, pss_b[b], eqs, z0s,
                                    DELTAS) for b in range(4)]
    return {"s": np.stack([r.s for r in rs]),
            "z": np.stack([r.z for r in rs])}


def case_lssp(pkg):
    lin = sim_of(pkg, "lssp_linear").lssp(LSSP_PORTS, power=1e-3,
                                          warmup_periods=WARMUP)
    comp = sim_of(pkg, "lssp_comp")
    hi = comp.lssp(LSSP_PORTS, power=3e-2, warmup_periods=WARMUP)
    b = comp.lssp_batched(LSSP_PORTS, [1e-7, 3e-2], warmup_periods=WARMUP)
    return {"linear": lin["s"], "comp": hi["s"], "amps": hi["amps"],
            "batched": b["s"], "batched_amps": b["amps"],
            "batched_conv": b["converged"]}


def case_mc(pkg, draws=None):
    """monte_carlo_psp on the toleranced up-converter and monte_carlo_lssp
    on the toleranced compressor (4 lanes, seed 0, as the CLI's --mc-rf
    runs them)."""
    with draws_of(pkg, None if draws is None else {"res_r": draws[0]}):
        bp, r = sim_of(pkg, "mixer_mc").monte_carlo_psp(
            4, PORTS["mixer"], [2.3e5], warmup_periods=WARMUP)
    out = {"psp_res_r": host(bp["res_r"]), "psp_s": r.s}
    with draws_of(pkg, None if draws is None else {"res_r": draws[1]}):
        bp, r = sim_of(pkg, "lssp_comp_mc").monte_carlo_lssp(
            4, LSSP_PORTS, [1e-5, 1e-2], warmup_periods=WARMUP)
    out.update({"lssp_res_r": host(bp["res_r"]), "lssp_s": r["s"],
                "lssp_conv": r["converged"]})
    return out


# ---------------------------------------------------------------- CLI cases
# (deck, argv after the deck, CSVs written, draws key or None)
CLI = {"hot_mc": ("mixer_mc.sp", ["--run-hot-sparams", "rf,if",
                                  "--psp-deltas", "2.3e5",
                                  "--hot-sparams-out", "hot.csv",
                                  "--mc-rf", "4"], ["hot.csv"], "psp_res_r"),
       "hot_am_envelope": ("examples/am_envelope.sp",
                           ["--run-hot-sparams", "m", "--psp-deltas",
                            "1e5"], ["hot_sparams.csv"], None),
       "hot_no_deltas": ("mixer_mc.sp", ["--run-hot-sparams", "rf,if"], [],
                         None),
       "lssp": ("lssp_linear.sp", ["--run-lssp", "V1:p1@50,V2:p2@50"], [],
                None),
       "lssp_powers_mc": ("lssp_comp_mc.sp",
                          ["--run-lssp", "V1:p1@50,V2:p2@50",
                           "--lssp-powers", "1e-5,1e-2", "--mc-rf", "4"],
                          [], "lssp_res_r")}


@contextlib.contextmanager
def _short_defaults(pkg):
    """The CLI's harmonic balances with one warm-up period, both packages
    alike."""
    a = mod(pkg, "analysis.hb")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(a, "harmonic_balance", functools.partial(
            a.harmonic_balance, warmup_periods=WARMUP))
        mp.setattr(a, "harmonic_balance_batched", functools.partial(
            a.harmonic_balance_batched, warmup_periods=WARMUP))
        yield


def run_cli(pkg, name, workdir, draws=None):
    """Run the CLI case in ``workdir``; returns (rc, stdout)."""
    deck, args, _, _ = CLI[name]
    os.makedirs(os.path.join(workdir, os.path.dirname(deck)), exist_ok=True)
    if deck.startswith("examples/"):
        with open(os.path.join(REPO, deck)) as f:
            text = f.read()
    else:
        text = DECKS[deck[:-3]]
    with open(os.path.join(workdir, deck), "w") as f:
        f.write(text)
    argv = [deck, "tran.csv", "--no-tran", *args]
    argv += ["--engine", "jax"] if pkg == "jax" else ["--device", "cpu"]
    cwd = os.getcwd()
    out = io.StringIO()
    try:
        os.chdir(workdir)
        with _short_defaults(pkg), draws_of(pkg, draws), \
                contextlib.redirect_stdout(out):
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
    leaves = tuple((k, tuple(v.shape), v.detach().cpu().numpy().tobytes())
                   for k, v in sorted(params.items()))
    return (repr(engine.opts), engine.N, leaves, more)


@pytest.fixture(scope="module", autouse=True)
def shared_hb():
    """The port's harmonic balances computed once per distinct input (the
    engine's options and size, the parameters, f0 and the keywords): the
    CLI's --run-lssp and --mc-rf runs repeat the API cases' solves."""
    hb = mod("torch", "analysis.hb")
    cache = {}

    def shared(real):
        def run(engine, params, f0, **kw):
            key = (real.__name__,) + _fingerprint(
                engine, params, f0, tuple(sorted(kw.items())))
            if key not in cache:
                cache[key] = real(engine, params, f0, **kw)
            return cache[key]
        return run

    with pytest.MonkeyPatch.context() as mp:
        for name in ("harmonic_balance", "harmonic_balance_batched"):
            mp.setattr(hb, name, shared(getattr(hb, name)))
        yield


def want(golden, name):
    pre = name + "/"
    return {k[len(pre):]: v for k, v in golden.items() if k.startswith(pre)}


def rel_close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if not ref.size or ref.dtype == bool:
        np.testing.assert_array_equal(got, ref)
        return
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= rtol, err


def held(got, ref, rtol=RTOL):
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k in ref:
        rel_close(got[k], ref[k], rtol)


@pytest.mark.parametrize("deck", list(PORTS))
def test_periodic_s_parameters_match_jax(deck, golden):
    held(case_psp("torch", deck, golden[f"pss/{deck}"]),
         want(golden, f"psp_{deck}"))


@pytest.mark.parametrize("deck", list(BATCHED))
def test_batched_psp_matches_jax_and_single_lanes(deck, golden):
    pss_b = golden[f"pss_b/{deck}"]
    got = case_psp_batched("torch", deck, pss_b)
    held(got, want(golden, f"psp_batched_{deck}"))
    held(got, case_psp_single_lanes(deck, pss_b))


def test_lssp_and_lssp_batched_match_jax(golden):
    got = case_lssp("torch")
    held(got, want(golden, "lssp"))
    assert got["batched_conv"].all()
    # the batched sweep's 3e-2 W lane is the single-lane solve
    rel_close(got["batched"][0, 1], got["comp"])


def test_monte_carlo_psp_and_lssp_match_jax(golden):
    ref = want(golden, "mc")
    got = case_mc("torch", (ref["psp_res_r"], ref["lssp_res_r"]))
    assert got["lssp_conv"].all()
    held(got, ref)


def _numbers(line):
    out = []
    for w in line.replace(",", " ").replace("=", " ").replace(
            "+/-", " ").replace("/", " ").split():
        try:
            out.append(float(w.rstrip("deg")))
        except ValueError:
            pass
    return out


@pytest.mark.parametrize("name", list(CLI))
def test_cli_hot_sparams_and_lssp_match_jax_goldens(name, tmp_path, golden):
    key = CLI[name][3]
    rc, out = run_cli("torch", name, str(tmp_path),
                      {"res_r": golden[f"mc/{key}"]} if key else None)
    assert rc == (1 if name == "hot_no_deltas" else 0)
    with open(os.path.join(GOLDENS, f"psp_cli_{name}_stdout_jax.txt")) as f:
        ref = f.read().splitlines()
    got = out.splitlines()
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if "widest entry" in r:
            # entries that tie on their spread (the up- and down-converted
            # sidebands of a symmetric mixer) are told apart by the last
            # bit: the entry's name may differ, its mean and spread not
            g, r = (re.sub(r"S\[\d+,\d+\]", "S[i,j]", v) for v in (g, r))
        if g != r:
            # the same words, the numbers within 1e-9 relative
            assert [w for w in g.split() if not _numbers(w)] == \
                [w for w in r.split() if not _numbers(w)], (g, r)
            np.testing.assert_allclose(_numbers(g), _numbers(r), rtol=RTOL,
                                       atol=1e-12)
    for csv in CLI[name][2]:
        with open(tmp_path / csv) as f:
            head = f.readline()
        ref_path = os.path.join(GOLDENS, f"psp_cli_{name}_{csv[:-4]}_jax.csv")
        with open(ref_path) as f:
            assert head == f.readline()
        a = np.loadtxt(tmp_path / csv, delimiter=",", skiprows=1, ndmin=2)
        b = np.loadtxt(ref_path, delimiter=",", skiprows=1, ndmin=2)
        # the complex entries from magnitude and phase (a vanishing
        # entry's phase is noise), relative to the largest magnitude
        rel_close(a[:, 0], b[:, 0])
        rel_close(a[:, 1::2] * np.exp(1j * np.radians(a[:, 2::2])),
                  b[:, 1::2] * np.exp(1j * np.radians(b[:, 2::2])))


def make_golden():
    """Write the JAX package's results (float64 on the CPU) into
    tests/goldens/psp_jax.npz and the JAX CLI's stdout and CSVs into
    tests/goldens/psp_cli_*_jax.*."""
    import tempfile
    import jax.numpy as jnp
    out = {}
    for deck in PORTS:
        s = sim_of("jax", deck)
        out[f"pss/{deck}"] = (np.zeros((7, s.engine.N)) if deck == "lti"
                              else np.asarray(s._pss_samples(
                                  s.params, s.config.hb.f0, None)))
        for k, v in case_psp("jax", deck, out[f"pss/{deck}"]).items():
            out[f"psp_{deck}/{k}"] = np.asarray(v)
    hb = mod("jax", "analysis.hb")
    for deck, scale in BATCHED.items():
        s = sim_of("jax", deck)
        bp = lanes("jax", s.params, 4, {k: factors(4, n, seed)
                                        for k, (n, seed) in scale.items()})
        r = hb.harmonic_balance_batched(s.engine, bp, s.config.hb.f0,
                                        n_harm=s.config.hb.n_harm)
        assert bool(np.asarray(r.converged).all())
        out[f"pss_b/{deck}"] = np.asarray(r.xs)
        for k, v in case_psp_batched("jax", deck,
                                     jnp.asarray(r.xs)).items():
            out[f"psp_batched_{deck}/{k}"] = np.asarray(v)
    for name, fn in (("lssp", case_lssp), ("mc", case_mc)):
        for k, v in fn("jax").items():
            out[f"{name}/{k}"] = np.asarray(v)
    np.savez_compressed(GOLDEN, **out)
    for name, (_, _, csvs, _) in CLI.items():
        with tempfile.TemporaryDirectory() as d:
            rc, stdout = run_cli("jax", name, d)
            assert rc == (1 if name == "hot_no_deltas" else 0), stdout
            with open(os.path.join(
                    GOLDENS, f"psp_cli_{name}_stdout_jax.txt"), "w") as f:
                f.write(stdout)
            for csv in csvs:
                with open(os.path.join(d, csv)) as src, open(os.path.join(
                        GOLDENS, f"psp_cli_{name}_{csv[:-4]}_jax.csv"),
                        "w") as dst:
                    dst.write(src.read())
        print("cli", name, flush=True)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, REPO)
    make_golden()
