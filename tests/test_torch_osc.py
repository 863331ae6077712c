"""The port's time-domain oscillator stack on the CPU, f64, against the
JAX package: autonomous shooting (``sstate.oscillator_steady_state``),
the shooting PPV phase noise (``oscnoise.oscillator_phase_noise``), PSS
Floquet stability (``pss_floquet``), the Adler injection-lock range
(``injection_lock``), timing jitter over TRNOISE lanes
(``jitter.jitter_analysis``), their ``Simulator`` methods and errors, and
the CLI's ``--run-osc`` (shooting), ``--run-lock`` and ``--run-hb
--pss-stability``.

The JAX results are ``tests/goldens/osc_jax.npz`` and the JAX CLI's
``tests/goldens/osc_cli_*_jax.*`` (each JAX solve compiles for seconds);
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_osc.py``, from
the repository's root, remakes them with the JAX package.  The damped
per-step Newton of the trapezoidal warm-ups makes every step cost tens of
iterations, so the settings are short and alike in both packages: the
shooting runs at 16 steps a period after 2 warm-up periods from a 1.8 V
kick (near the limit cycle), and the phase-noise, lock and Floquet cases
start from JAX's converged shooting vectors in the golden.

Bars: f0 1e-8 relative, the period waveform 1e-6 V, Newton counts equal;
c, c_flicker, period jitter and lock ranges 1e-6 relative, L(df) 1e-4 dB,
Floquet multipliers 1e-8 absolute; jitter: equal edge counts, edge times
within 1e-6 of a time step, statistics 1e-6 relative."""

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
GOLDEN = os.path.join(GOLDENS, "osc_jax.npz")
ROOT = {"jax": "circuitsimulator_tpu", "torch": "circuitsimulator_tpu_torch"}

VDP = """* van der pol lc oscillator
L1 a 0 1u
C1 a 0 1n
Rl a 0 2k
Bneg a 0 I=-2m*v(a) + 0.5m*v(a)**3
.op
"""
MEISSNER = """* meissner (transformer-feedback) mos oscillator, class A
.MODEL 1 VT 0.7 MU 5e-2 COX 2e-3 LAMBDA 0.01 KF 1e-15 AF 1
VDD 1 0 3
VG gb 0 1.2
L1 g gb 100u
C1 g 0 100p
Rl g 0 5k
Blim g 0 I=100m*(v(g)-1.2)**3
L2 1 d 10u
K1 L1 L2 0.5
M1 d g 0 n 60e-6 1e-6 1
.op
"""
F_PSS = 5e6
PSS_DECKS = {
    "rc": (f"* driven rc\nI1 0 a SIN 0 1m {F_PSS}\nR1 a 0 1k\nC1 a 0 1e-10\n"
           f".hb {F_PSS} 5\n", F_PSS, 64),
    "neg": (f"* negative-g tank\nI1 0 a SIN 0 1u {F_PSS}\nR1 a 0 10k\n"
            f"Bneg a 0 I=-0.5m*v(a)\nC1 a 0 0.1n\n.hb {F_PSS} 5\n",
            F_PSS, 64),
    "tline": ("V1 src 0 SIN 0 1 20e6\nRs src in 10\n"
              "T1 in 0 out 0 Z0=50 TD=7n\nRL out 0 200\nC1 out 0 30p\n"
              ".hb 20e6 4\n", 20e6, 64)}
JIT_EDGES = """* noisy edges
V1 in 0 PULSE(0 1 2e-5 4e-5 4e-5 6e-5 2e-4) TRNOISE(5m 4e-6)
R1 in out 1k
R2 out 0 1k
.TRAN 2e-6 6e-4
.end
"""
JIT_SLOW = """* noisy slow edges
V1 in 0 PULSE(0 1 0 2e-4 2e-4 1e-4 5e-4) TRNOISE(50m 2e-6)
R1 in 0 1k
.TRAN 2e-6 6e-4
.end
"""
# the shortened oscillator solves of every case (the API's defaults are
# 256 steps a period after 30 warm-up periods from a 0.5 V kick): shooting
# at 16 steps a period, the HB warm-ups at 32
SHOOT = dict(steps_per_period=16, warmup_periods=2, kick=1.8)
HB_WARM = dict(steps_per_period=32, warmup_periods=2, kick=1.8)
SHOOT_MEISSNER = dict(steps_per_period=32, warmup_periods=3, kick=2.0)
OFFSETS = [1e3, 1e4, 1e5]


def mod(pkg, name):
    return importlib.import_module(f"{ROOT[pkg]}.{name}")


def sim_of(pkg, text, f32=False):
    Sim = mod(pkg, "api").Simulator
    opts = mod(pkg, "utils.options").DEFAULT_OPTIONS
    if f32:
        if pkg == "jax":
            import jax.numpy as jnp
            opts = opts.replace(dtype=jnp.float32)
        else:
            opts = opts.replace(dtype=torch.float32)
    if pkg == "jax":
        return Sim.from_text(text, opts=opts)
    return Sim.from_text(text, opts=opts, device="cpu")


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def eq_of(sim, node):
    return sim.circuit.nodes[sim.circuit.node_name_to_id[node]].eq_index


def osc_out(r):
    return {"f0": np.asarray(float(r.f0)), "times": host(r.times),
            "xs": host(r.xs), "s": host(r.s),
            "iters": np.asarray(r.newton_iters),
            "residual": np.asarray(float(r.residual)),
            "converged": np.asarray(bool(r.converged))}


def osc_from(pkg, g):
    """An OscillatorResult of ``pkg`` from the golden arrays."""
    cls = mod(pkg, "analysis.sstate").OscillatorResult
    if pkg == "torch":
        t = torch.as_tensor
        return cls(f0=float(g["f0"]), times=t(g["times"]), xs=t(g["xs"]),
                   residual=float(g["residual"]), newton_iters=int(g["iters"]),
                   converged=bool(g["converged"]), s=t(g["s"]))
    import jax.numpy as jnp
    return cls(f0=float(g["f0"]), times=jnp.asarray(g["times"]),
               xs=jnp.asarray(g["xs"]), residual=float(g["residual"]),
               newton_iters=int(g["iters"]), converged=bool(g["converged"]),
               s=jnp.asarray(g["s"]))


def pn_out(p):
    return {"c": np.asarray(p.c), "c_flicker": np.asarray(p.c_flicker),
            "L_dbc": np.asarray(p.L_dbc),
            "period_jitter": np.asarray(p.period_jitter),
            "per_source": np.asarray(p.per_source), "w": host(p.w),
            "ppv": host(p.ppv), "invariance": np.asarray(p.invariance),
            "floquet_err": np.asarray(p.floquet_err),
            "lambda2": np.asarray(p.lambda2)}


# ------------------------------------------------------------ case functions
# Each returns a dict of numpy arrays; the JAX side's are in the golden,
# ``g`` the golden of the case's inputs (JAX's converged shooting).
def case_shoot_vdp(pkg, g=None):
    return osc_out(sim_of(pkg, VDP).oscillator(5e6, "a", **SHOOT))


def case_shoot_meissner(pkg, g=None):
    return osc_out(sim_of(pkg, MEISSNER).oscillator(1.6e6, "g",
                                                    **SHOOT_MEISSNER))


def case_pn_vdp(pkg, g):
    s = sim_of(pkg, VDP)
    return pn_out(s.oscillator_phase_noise(
        OFFSETS, osc=osc_from(pkg, g["shoot_vdp"]),
        extra_sources=[("a", "0", 1e-20)]))


def case_pn_meissner(pkg, g):
    s = sim_of(pkg, MEISSNER)
    return pn_out(s.oscillator_phase_noise(
        OFFSETS, osc=osc_from(pkg, g["shoot_meissner"])))


def case_lock(pkg, g):
    s = sim_of(pkg, VDP)
    osc = osc_from(pkg, g["shoot_vdp"])
    out = {}
    for m in (1, 3):      # the odd harmonics: an even one's p_m is ~0
        il = s.injection_lock("a", 1e-3, osc=osc, harmonic=m)
        out[f"m{m}"] = np.asarray([il.lock_range_hz, il.k_per_amp,
                                   il.p1.real, il.p1.imag, il.f0])
    return out


def case_pss(pkg, g, deck):
    """JAX's driven shooting (the golden) of a PSS deck."""
    text, f0, spp = PSS_DECKS[deck]
    r = sim_of(pkg, text).steady_state(steps_per_period=spp,
                                       warmup_periods=2, max_newton=8)
    return {"s": host(r.s), "times": host(r.times),
            "converged": np.asarray(bool(r.converged))}


def ss_from(pkg, g, f0):
    cls = mod(pkg, "analysis.sstate").SteadyStateResult
    conv = (torch.as_tensor if pkg == "torch"
            else importlib.import_module("jax.numpy").asarray)
    return cls(times=conv(g["times"]), xs=None, residual=0.0,
               newton_iters=0, freqs=None, spectrum=None, converged=True,
               s=conv(g["s"]), f0=f0)


def case_floquet(pkg, g, deck):
    text, f0, _ = PSS_DECKS.get(deck, (VDP, None, None))
    s = sim_of(pkg, text)
    if deck == "vdp":
        ss = osc_from(pkg, g["shoot_vdp"])
        st = s.pss_stability(ss=ss, f0=ss.f0)
    else:
        st = s.pss_stability(ss=ss_from(pkg, g[f"pss_{deck}"], f0))
    return {"multipliers": np.asarray(st.multipliers),
            "lambda_max": np.asarray(st.lambda_max),
            "stable": np.asarray(st.stable),
            "closure": np.asarray(st.closure)}


def jit_out(out):
    res = {k: np.asarray(out[k]) for k in ("edge_times", "edge_mean",
                                           "edge_jitter", "n_edges")}
    if out["period_jitter"] is not None:
        res["period_mean"] = np.asarray(out["period_mean"])
        res["period_jitter"] = np.asarray(out["period_jitter"])
    return res


JITTER = {"rise": (JIT_EDGES, dict(threshold=0.5, n=8)),
          "fall": (JIT_EDGES, dict(threshold=0.5, n=8, rising=False,
                                   t_min=3e-4)),
          "raw": (JIT_SLOW, dict(threshold=0.5, n=8)),
          "hyst": (JIT_SLOW, dict(threshold=0.5, n=8, hysteresis=0.2))}


def case_jitter(pkg, g, name):
    text, kw = JITTER[name]
    return jit_out(sim_of(pkg, text).jitter("in", **kw))


CASES = {"shoot_vdp": (case_shoot_vdp, ()),
         "shoot_meissner": (case_shoot_meissner, ()),
         **{f"pss_{d}": (case_pss, (d,)) for d in PSS_DECKS},
         "pn_vdp": (case_pn_vdp, ()),
         "pn_meissner": (case_pn_meissner, ()),
         "lock": (case_lock, ()),
         **{f"floquet_{d}": (case_floquet, (d,))
            for d in ("rc", "neg", "tline", "vdp")},
         **{f"jitter_{n}": (case_jitter, (n,)) for n in JITTER}}

# ---------------------------------------------------------------- CLI cases
# (deck text, argv after the deck, CSV names); the solvers' defaults are
# shortened alike in both packages (``short_defaults``)
CLI = {"osc": (VDP, ["--run-osc", "5meg:a:osc.csv"], ["osc.csv"]),
       "lock": (VDP, ["--run-lock", "5e6:a:a:1e-3"], []),
       "pss": (PSS_DECKS["rc"][0], ["--no-tran", "--run-hb", "hb.csv",
                                    "--pss-stability"], ["hb.csv"]),
       "pss_hb": (PSS_DECKS["rc"][0], ["--no-tran", "--run-hb", "hb.csv",
                                       "--hb-method", "hb",
                                       "--pss-stability"], ["hb.csv"])}


@contextlib.contextmanager
def short_defaults(pkg, hb_kw=HB_WARM):
    """The CLI's solvers at the cases' depth, the same in both packages:
    oscillator shooting with SHOOT, autonomous HB with ``hb_kw`` (HB_WARM;
    None: its defaults), the driven shooting at 32 steps a period after 1
    warm-up period and the driven HB after 2."""
    ss = mod(pkg, "analysis.sstate")
    osc = mod(pkg, "analysis.hbosc")
    hb = mod(pkg, "analysis.hb")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ss, "oscillator_steady_state", functools.partial(
            ss.oscillator_steady_state, **SHOOT))
        if hb_kw is not None:
            mp.setattr(osc, "oscillator_hb", functools.partial(
                osc.oscillator_hb, **hb_kw))
        mp.setattr(ss, "steady_state", functools.partial(
            ss.steady_state, steps_per_period=32, warmup_periods=1))
        mp.setattr(hb, "harmonic_balance", functools.partial(
            hb.harmonic_balance, warmup_periods=2))
        yield mp


def run_cli(pkg, name, workdir, table=None, hb_kw=HB_WARM):
    """Run CLI case ``name`` of ``table`` (default CLI) in ``workdir``;
    returns (rc, stdout, stderr)."""
    text, args, _ = (table or CLI)[name]
    with open(os.path.join(workdir, "deck.sp"), "w") as f:
        f.write(text)
    argv = ["deck.sp", "tran.csv", *args]
    argv += ["--engine", "jax"] if pkg == "jax" else ["--device", "cpu"]
    cwd = os.getcwd()
    out, err = io.StringIO(), io.StringIO()
    try:
        os.chdir(workdir)
        with short_defaults(pkg, hb_kw), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = mod(pkg, "cli").main(argv)
    finally:
        os.chdir(cwd)
    return rc, out.getvalue(), err.getvalue()


# --------------------------------------------------------------------- tests
def load_golden(path):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    out = {}
    for k, v in flat.items():
        case, key = k.split("/", 1)
        out.setdefault(case, {})[key] = v
    return out


@pytest.fixture(scope="module")
def golden():
    return load_golden(GOLDEN)


def fingerprint(engine, params, *more):
    """A key of a deterministic solver call: the engine's options and
    size, every parameter leaf's bytes and the other arguments."""
    def key(m):
        if isinstance(m, torch.Tensor):
            return m.shape, m.detach().cpu().numpy().tobytes()
        return tuple(map(key, m)) if isinstance(m, tuple) else m
    leaves = tuple((k, key(v)) for k, v in sorted(params.items()))
    return (repr(engine.opts), engine.N, leaves, key(more))


def memo(mp, module, name, cache):
    """Patch module.name with a version computed once per distinct input
    (fingerprinted): the API and CLI cases share their solves."""
    real = getattr(module, name)

    def cached(engine, params, *args, **kw):
        key = (name,) + fingerprint(engine, params, *args,
                                    *sorted(kw.items()))
        if key not in cache:
            cache[key] = real(engine, params, *args, **kw)
        return cache[key]
    mp.setattr(module, name, cached)


@pytest.fixture(scope="module", autouse=True)
def shared_runs():
    """The port's solves computed once per distinct input (the API and
    CLI cases share them)."""
    ss = mod("torch", "analysis.sstate")
    cache = {}
    with pytest.MonkeyPatch.context() as mp:
        memo(mp, ss, "oscillator_steady_state", cache)
        memo(mp, ss, "steady_state", cache)
        # the rising and falling edges of a deck (and the raw and
        # debounced ones) read one noisy transient
        memo(mp, mod("torch", "parallel.montecarlo"), "batched_transient",
             cache)
        yield


_runs = {}


def port(name, golden):
    """The port's result of a case, computed once per module."""
    if name not in _runs:
        fn, args = CASES[name]
        _runs[name] = fn("torch", golden, *args)
    return _runs[name]


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300) if ref.size else 1.0
    return float(np.abs(got - ref).max()) / scale if ref.size else 0.0


def test_shooting_matches_jax(golden):
    got, ref = port("shoot_vdp", golden), golden["shoot_vdp"]
    assert bool(got["converged"]) and bool(ref["converged"])
    assert int(got["iters"]) == int(ref["iters"])
    assert rel_err(got["f0"], ref["f0"]) <= 1e-8
    assert float(np.abs(got["xs"] - ref["xs"]).max()) <= 1e-6
    assert float(np.abs(got["s"] - ref["s"]).max()) <= 1e-6
    assert rel_err(got["times"], ref["times"]) <= 1e-8


def test_shooting_refuses_tline_and_bad_nodes():
    s = sim_of("torch", open(os.path.join(REPO, "examples",
                                          "delay_osc.sp")).read())
    with pytest.raises(NotImplementedError, match="transmission lines"):
        s.oscillator(1e8, "a")
    v = sim_of("torch", VDP)
    with pytest.raises(KeyError, match="unknown node"):
        v.oscillator(5e6, "nope")
    with pytest.raises(ValueError, match="ground"):
        v.oscillator(5e6, "0")
    with pytest.raises(ValueError, match="osc= or f0_guess"):
        v.oscillator_phase_noise(OFFSETS)
    with pytest.raises(ValueError, match="method must be"):
        v.injection_lock("a", 1e-3, method="newton")
    with pytest.raises(ValueError, match="TRNOISE"):
        sim_of("torch", JIT_EDGES.replace(" TRNOISE(5m 4e-6)", "")).jitter(
            "in", 0.5, n=2)
    with pytest.raises(ValueError, match=r"\.TRAN"):
        v.jitter("a", 0.5)
    with pytest.raises(KeyError, match="unknown node"):
        sim_of("torch", JIT_EDGES).jitter("nope", 0.5)


@pytest.mark.parametrize("deck", ["vdp", "meissner"])
def test_phase_noise_matches_jax(deck, golden):
    got, ref = port(f"pn_{deck}", golden), golden[f"pn_{deck}"]
    for k in ("c", "c_flicker", "period_jitter", "per_source"):
        assert rel_err(got[k], ref[k]) <= 1e-6, k
    assert float(np.abs(got["L_dbc"] - ref["L_dbc"]).max()) <= 1e-4
    for k in ("w", "ppv"):
        assert rel_err(got[k], ref[k]) <= 1e-6, k
    for k in ("invariance", "floquet_err", "lambda2"):
        assert float(np.abs(got[k] - ref[k])) <= 1e-8, k


def test_injection_lock_matches_jax(golden):
    got, ref = port("lock", golden), golden["lock"]
    for m in ("m1", "m3"):
        assert rel_err(got[m][:2], ref[m][:2]) <= 1e-6, m
        assert rel_err(got[m][2:4], ref[m][2:4]) <= 1e-6, m
        assert got[m][4] == ref[m][4]
    s = sim_of("torch", VDP)
    osc = osc_from("torch", golden["shoot_vdp"])
    with pytest.raises(ValueError, match="amplitude"):
        s.injection_lock("a", 0.0, osc=osc)
    with pytest.raises(ValueError, match="harmonic must be"):
        s.injection_lock("a", 1e-3, osc=osc, harmonic=0)
    with pytest.raises(ValueError, match="Nyquist"):
        s.injection_lock("a", 1e-3, osc=osc, harmonic=16)


@pytest.mark.parametrize("deck", ["rc", "neg", "tline", "vdp"])
def test_pss_floquet_matches_jax(deck, golden):
    got, ref = port(f"floquet_{deck}", golden), golden[f"floquet_{deck}"]
    assert got["multipliers"].shape == ref["multipliers"].shape
    # a conjugate pair's order within one |lambda| is the eigensolver's
    assert float(np.abs(np.sort_complex(got["multipliers"])
                        - np.sort_complex(ref["multipliers"])).max()) <= 1e-8
    assert abs(float(got["lambda_max"]) - float(ref["lambda_max"])) <= 1e-8
    assert bool(got["stable"]) == bool(ref["stable"])
    assert abs(float(got["closure"]) - float(ref["closure"])) <= 1e-8
    if deck == "rc":
        s = sim_of("torch", PSS_DECKS["rc"][0])
        ss = ss_from("torch", golden["pss_rc"], F_PSS)
        ss.s = None
        with pytest.raises(ValueError, match="shooting vector"):
            s.pss_stability(ss=ss)


@pytest.mark.parametrize("name", list(JITTER))
def test_jitter_matches_jax(name, golden, capsys):
    got, ref = port(f"jitter_{name}", golden), golden[f"jitter_{name}"]
    assert set(got) == set(ref)
    assert int(got["n_edges"]) == int(ref["n_edges"])
    tstep = 2e-6
    assert float(np.abs(got["edge_times"] - ref["edge_times"]).max()) \
        <= 1e-6 * tstep
    for k in ("edge_mean", "edge_jitter", "period_mean", "period_jitter"):
        if k in ref:
            assert rel_err(got[k], ref[k]) <= 1e-6, k


def _numbers(line):
    out = []
    for w in line.replace(",", " ").replace("=", " ").replace("[", " ") \
            .replace("]", " ").replace("(", " ").split():
        try:
            out.append(float(w))
        except ValueError:
            pass
    return out


def words(line):
    return [w for w in line.split() if not _numbers(w)]


def check_stdout(got, ref, rtol):
    """Line by line: equal, or the same words with numbers within rtol
    (residual figures: both below 1e-9)."""
    got, ref = got.splitlines(), ref.splitlines()
    assert len(got) == len(ref), (got, ref)
    for g, r in zip(got, ref):
        if g == r:
            continue
        if "residual=" in r:
            assert _numbers(g.split("residual=")[1])[0] < 1e-9, g
            assert _numbers(r.split("residual=")[1])[0] < 1e-9, r
            g = g.split("residual=")[0] + g.split("newton_iters")[1]
            r = r.split("residual=")[0] + r.split("newton_iters")[1]
        assert words(g) == words(r), (g, r)
        np.testing.assert_allclose(_numbers(g), _numbers(r), rtol=rtol,
                                   atol=1e-12)


def check_cli(name, tmp_path, table, prefix, rtol, hb_kw=HB_WARM):
    rc, out, err = run_cli("torch", name, str(tmp_path), table, hb_kw)
    assert rc == 0, err
    with open(os.path.join(GOLDENS, f"{prefix}_{name}_stdout_jax.txt")) as f:
        check_stdout(out, f.read(), rtol)
    for csv in table[name][2]:
        a = np.loadtxt(tmp_path / csv, delimiter=",", skiprows=1)
        b = np.loadtxt(os.path.join(GOLDENS, f"{prefix}_{name}_"
                                    f"{csv[:-4]}_jax.csv"),
                       delimiter=",", skiprows=1)
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= 1e-6
    return err


@pytest.mark.parametrize("name", list(CLI))
def test_cli_matches_jax_goldens(name, tmp_path):
    err = check_cli(name, tmp_path, CLI, "osc_cli", 1e-6)
    if name == "pss_hb":
        assert "needs the shooting method" in err


def make_golden(path=GOLDEN, cases=CASES, cli=CLI, prefix="osc_cli",
                extra=None):
    """Write the JAX package's results (float64 on the CPU) into ``path``
    and the JAX CLI's stdout and CSVs into tests/goldens/<prefix>_*."""
    import tempfile
    out = {}
    g = {}
    for name, (fn, args) in cases.items():
        res = fn("jax", g, *args)
        g[name] = res
        for k, v in res.items():
            out[f"{name}/{k}"] = np.asarray(v)
        print(name, flush=True)
    for k, v in (extra or {}).items():
        out[k] = np.asarray(v)
    np.savez_compressed(path, **out)
    for name, (_, _, csvs) in cli.items():
        with tempfile.TemporaryDirectory() as d:
            rc, stdout, stderr = run_cli("jax", name, d, cli)
            assert rc == 0, (name, stdout, stderr)
            with open(os.path.join(
                    GOLDENS, f"{prefix}_{name}_stdout_jax.txt"), "w") as f:
                f.write(stdout)
            for csv in csvs:
                with open(os.path.join(d, csv)) as src, open(os.path.join(
                        GOLDENS, f"{prefix}_{name}_{csv[:-4]}_jax.csv"),
                        "w") as dst:
                    dst.write(src.read())
        print("cli", name, flush=True)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, REPO)
    make_golden()
