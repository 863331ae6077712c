"""The port's periodic small-signal analyses (analysis/pac.py and
envnoise.py) on the CPU, f64, against the JAX package: the LPTV operator
(plain, T-line and MOSCAP=CHARGE), PAC, PXF, PNOISE, the mixer noise
figure, the envelope noise, their batched forms over numpy-drawn lanes
(each lane also against the port's own single-lane result) and the
Simulator's ``monte_carlo_*`` entries (the port fed JAX's draws).

The JAX side is ``tests/goldens/pac_jax.npz``: ``PYTHONPATH=.
JAX_PLATFORMS=cpu python tests/test_torch_pac.py``, from the repository's
root, remakes it with the JAX package.  Every LPTV case runs both
packages on JAX's periodic steady state (recorded in the golden, passed as
``pss_xs``), so no case reruns a harmonic balance to test an LPTV solve;
``pss_path`` runs the port's own ``_pss_samples`` end to end, and the
Monte-Carlo entries their batched HB (both with one warm-up period, the
JAX golden alike).

Bars: J0 and CI within 1e-12 of the largest entry; every analysis within
1e-9 of its largest magnitude."""

import functools
import importlib
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "pac_jax.npz")
ROOT = {"jax": "circuitsimulator_tpu", "torch": "circuitsimulator_tpu_torch"}
RTOL = 1e-9
WARMUP = 1

# tests/test_pac.py, test_pxf.py, test_pnoise.py and test_envnoise.py's
# decks, tests/test_pac_tline_batched.py's T-line deck and a
# MOSCAP=CHARGE inverter
RC = """* rc lowpass
V1 in 0 DC 0 AC 1
Vlo lo 0 SIN 0 0 1e6
Rlo lo 0 1k
R1 in out 1k
C1 out 0 1n
.hb 1e6 4
"""
MULT = """* b-source mixer
Vlo lo 0 SIN 0 1 1e6
Rlo lo 0 1k
Vrf rf 0 DC 0 AC 1
Rrf rf 0 1k
Bmix out 0 V=v(lo)*v(rf)
Rout out 0 1k
.hb 1e6 6
"""
CHOP = """* switching mixer
.MODEL swm SW RON=0.001 ROFF=1e9 VT=0 VH=0.01
Vlo lo 0 SIN 0 1 1e6
Rlo lo 0 1k
Vrf rf 0 DC 0 AC 1
Rs rf a 50
S1 a out lo 0 swm
Rout out 0 1e4
.hb 1e6 16
"""
NF = """* multiplier mixer NF
Vlo lo 0 SIN 0 1 1e6
Rlo lo 0 0.001
Vrf rfs 0 DC 0
Rs rfs rf 1k
Bmix out 0 V=v(rf)*v(lo)
Rout out 0 0.001
.hb 1e6 6
"""
TANK = """* current-driven tank
I1 0 out DC 0 AC 1
Vlo lo 0 SIN 0 0 1e6
Rlo lo 0 1k
R1 out 0 1k
C1 out 0 1n
.hb 1e6 4
"""
DIODE = """* driven diode rectifier
Vin in 0 SIN 0 0.8 1e6
Rs in a 100
D1 a out DMOD
Cl out 0 10n
Rl out 0 10k
.model DMOD D IS=1e-14
.hb 1e6 8
"""
DIV = """* divider noise
Vlo lo 0 SIN 0 0 1e6
Rlo lo 0 1k
V1 in 0 DC 1
R1 in out 10k
R2 out 0 10k
C1 out 0 1n
.hb 1e6 4
"""
CHOPN = """* chopped noise
.MODEL swm SW RON=1e-6 ROFF=1e12 VT=0 VH=0.001
Vlo lo 0 SIN 0 1 1e6
Rlo lo 0 1k
Rs a 0 1k
S1 a out lo 0 swm
Rl out 0 1k
.hb 1e6 24
"""
DCHOP = """* diode chopper
Vlo lo 0 SIN 0.4 0.3 1e6
Rlo lo a 100
D1 a out IS=1e-12
Rl out 0 1k
.hb 1e6 12
"""
ENV_DIODE = """* diode chopper
Vlo lo 0 SIN 0.4 0.3 1e6
Rlo lo a 100
D1 a out IS=1e-12
Rl out 0 1k
C1 out 0 100p
.hb 1e6 6
"""
ENV_SWITCH = """* switched diode noise
Vc c 0 SIN 0 0.05 1e6
Rc c a 1k
Vb b 0 PULSE 0 0.75 2.5e-6 1e-6 1e-6 1e-5 1e-4
Rb b a 1k
D1 a 0 IS=1e-12
.hb 1e6 6
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
INV = (".MODEL 2 VT 0.4 MU 1e-2 COX 1e-3 LAMBDA 0.05 CJ0 1e-13\n"
       "VDD 1 0 3\nVin 2 0 SIN 1 0.5 1e8\nRD 1 3 1k\n"
       "M1 3 2 0 n 10e-6 1e-6 2\nC1 3 0 2e-13\nL1 3 4 1e-8\nR4 4 0 1k\n"
       "Vac 5 0 DC 0 AC 1\nR5 5 3 10k\n.hb 1e8 6\n")
DIODE_MC = DIODE.replace("Rs in a 100", "Rs in a 100 DEV=5%").replace(
    "Rl out 0 10k", "Rl out 0 10k DEV=5%").replace(
    "Vin in 0 SIN 0 0.8 1e6", "Vin in 0 SIN 0 0.8 1e6 AC 1")

DECKS = {"rc": RC, "mult": MULT, "chop": CHOP, "nf": NF, "tank": TANK,
         "diode": DIODE, "div": DIV, "chopn": CHOPN, "dchop": DCHOP,
         "env_diode": ENV_DIODE, "env_switch": ENV_SWITCH, "tl": TL,
         "inv": INV, "diode_mc": DIODE_MC}
CHARGE = {"inv"}
DELTAS = [2.5e4, 1e5]
OUT = {"inv": "3"}


def mod(pkg, name):
    return importlib.import_module(f"{ROOT[pkg]}.{name}")


@functools.lru_cache(maxsize=None)
def sim_of(pkg, deck):
    Sim = mod(pkg, "api").Simulator
    opts = mod(pkg, "utils.options").DEFAULT_OPTIONS
    if deck in CHARGE:
        opts = opts.replace(mos_cap_model="charge")
    if pkg == "jax":
        return Sim.from_text(DECKS[deck], opts=opts)
    return Sim.from_text(DECKS[deck], opts=opts, device="cpu")


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def eq_of(sim, node):
    return sim.circuit.nodes[sim.circuit.node_name_to_id[node]].eq_index


def f0_of(sim):
    return sim.config.hb.f0


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


def dense_ci(CI):
    """The port's (K, N, N) diagonal blocks as JAX's dense (KN, KN)."""
    K, N = CI.shape[-3], CI.shape[-1]
    out = np.zeros((K, N, K, N))
    kk = np.arange(K)
    out[kk, :, kk, :] = host(CI)
    return out.reshape(K * N, K * N)


def kinds_out(res, pre="by_kind_"):
    return {pre + k: np.asarray(v) for k, v in res.by_kind.items()}


# ------------------------------------------------------------ case functions
# Each runs one package on JAX's PSS ``pss`` and returns numpy arrays.
def case_lptv(pkg, deck, pss):
    s = sim_of(pkg, deck)
    J0, CI, K, tl = mod(pkg, "analysis.pac").lptv_operator(
        s.engine, s.params, f0_of(s), pss)
    out = {"J0": host(J0).real, "CI": host(CI) if pkg == "jax"
           else dense_ci(CI)}
    if tl is not None:
        out["taus"], out["B"] = host(tl[0]), host(tl[1]).real
    return out


def case_pac(pkg, deck, pss, n_sidebands=None):
    res = sim_of(pkg, deck).pac(DELTAS, n_sidebands=n_sidebands,
                                pss_xs=pss)
    return {"spectrum": res.spectrum, "harmonics": res.harmonics}


def case_pxf(pkg, deck, pss, n_sidebands=None):
    res = sim_of(pkg, deck).pxf(DELTAS, "out", n_sidebands=n_sidebands,
                                pss_xs=pss)
    return {"xf_v": res.xf_v, "xf_i": res.xf_i,
            "harmonics": res.harmonics}


def case_pnoise(pkg, deck, pss):
    res = sim_of(pkg, deck).pnoise(DELTAS, OUT.get(deck, "out"), pss_xs=pss)
    return {"onoise": res.onoise, **kinds_out(res)}


def case_nf(pkg, deck, pss):
    s = sim_of(pkg, deck)
    return {"ssb": np.asarray(s.mixer_noise_figure(
                "Rs", 25e3, "out", pss_xs=pss)),
            "dsb": np.asarray(s.mixer_noise_figure(
                "Rs", 25e3, "out", sidebands=(1, -1), pss_xs=pss))}


ENV = {"env_diode": (2e-6, 1e-6, "out", [1e3, 30e3], None),
       "env_switch": (6e-6, 1e-6, "a", [10e3], [0, 1, 2, 4, 5, 6])}


def case_envnoise(pkg, deck, env_xs):
    """envelope_noise on JAX's envelope trajectory (its samples recorded:
    the port's envelope is tests/test_torch_hb.py's)."""
    s = sim_of(pkg, deck)
    t_stop, dt, out, deltas, t1_idx = ENV[deck]
    env = mod(pkg, "analysis.envelope").EnvelopeResult(
        f0=f0_of(s), t1=np.arange(env_xs.shape[0]) * dt, xs=env_xs,
        freqs=None, coeffs=None, converged=None, residuals=None)
    res = s.envelope_noise(deltas, out, env=env, t1_idx=t1_idx)
    return {"onoise": res.onoise, "t1": res.t1, **kinds_out(res)}


BATCHED = {"diode": {"res_r": (2, 7)}, "tl": {"res_r": (3, 8),
                                              "tl_td": (1, 9)}}


def case_batched(pkg, deck, pss_b):
    """pac_batched, pxf_batched, pnoise_batched and (the diode deck)
    mixer_noise_figure_batched over four numpy-drawn lanes, each around
    its own PSS (JAX's batched HB, recorded)."""
    s = sim_of(pkg, deck)
    p = mod(pkg, "analysis.pac")
    bp = lanes(pkg, s.params, 4, {k: factors(4, n, seed) for k, (n, seed)
                                  in BATCHED[deck].items()})
    f0, out_eq = f0_of(s), eq_of(s, "out")
    res = {"pac": p.pac_batched(s.engine, bp, f0, pss_b, DELTAS).spectrum}
    x = p.pxf_batched(s.engine, bp, f0, pss_b, DELTAS, out_eq)
    res["pxf_v"], res["pxf_i"] = x.xf_v, x.xf_i
    n = p.pnoise_batched(s.engine, bp, f0, pss_b, DELTAS, out_eq)
    res["pnoise"] = n.onoise
    res.update(kinds_out(n, "pnoise_"))
    if deck == "diode":
        res["nf"] = np.asarray(p.mixer_noise_figure_batched(
            s.engine, bp, f0, pss_b, 3e4, out_eq, 0)[0])
    return res


def case_single_lanes(deck, pss_b):
    """The port's single-lane pac, pxf, pnoise and mixer NF per lane of
    case_batched, stacked like the batched results."""
    s = sim_of("torch", deck)
    p = mod("torch", "analysis.pac")
    bp = lanes("torch", s.params, 4, {k: factors(4, n, seed) for k, (n, seed)
                                      in BATCHED[deck].items()})
    f0, out_eq = f0_of(s), eq_of(s, "out")
    out = {}
    for b in range(4):
        pb = {k: v[b] for k, v in bp.items()}
        one = {"pac": p.pac(s.engine, pb, f0, pss_b[b], DELTAS).spectrum}
        x = p.pxf(s.engine, pb, f0, pss_b[b], DELTAS, out_eq)
        one["pxf_v"], one["pxf_i"] = x.xf_v, x.xf_i
        n = p.pnoise(s.engine, pb, f0, pss_b[b], DELTAS, out_eq)
        one["pnoise"] = n.onoise
        one.update(kinds_out(n, "pnoise_"))
        if deck == "diode":
            one["nf"] = np.asarray(p.mixer_noise_figure(
                s.engine, pb, f0, pss_b[b], 3e4, out_eq, 0)[0])
        for k, v in one.items():
            out.setdefault(k, []).append(v)
    return {k: np.stack(v) for k, v in out.items()}


def case_pss_path(pkg):
    """Simulator.pac through the port's own _pss_samples (HB on the .hb
    card, one warm-up period)."""
    res = sim_of(pkg, "mult").pac([1e4], warmup_periods=WARMUP)
    return {"pss": host(res.xs_pss), "spectrum": res.spectrum}


def case_mc(pkg, draws=None):
    """monte_carlo_pac, _pxf, _pnoise and _mixer_noise_figure (4 lanes,
    seed 2) on the toleranced diode deck; the port's lanes are JAX's
    draws of res_r, and one batched HB serves the four entries."""
    s = sim_of(pkg, "diode_mc")
    kw = dict(seed=2, warmup_periods=WARMUP)

    def run():
        bp, r = s.monte_carlo_pac(4, DELTAS, **kw)
        out = {"res_r": host(bp["res_r"]), "pac": r.spectrum,
               "pac_conv": np.asarray(r.converged)}
        _, r = s.monte_carlo_pxf(4, DELTAS, "out", **kw)
        out["pxf_v"], out["pxf_i"] = r.xf_v, r.xf_i
        _, r = s.monte_carlo_pnoise(4, DELTAS, "out", **kw)
        out["pnoise"] = r.onoise
        out.update(kinds_out(r, "pnoise_"))
        _, out["nf"] = s.monte_carlo_mixer_noise_figure(4, "Rs", 3e4,
                                                         "out", **kw)
        return out

    if pkg == "jax":
        return run()
    mc = mod(pkg, "parallel.montecarlo")
    hb = mod(pkg, "analysis.hb")
    real, cache = hb.harmonic_balance_batched, {}

    def once(engine, bparams, f0, **k):
        if "r" not in cache:
            cache["r"] = real(engine, bparams, f0, **k)
        return cache["r"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mc, "perturb_params_netlist", functools.partial(
            _fixed_draws, {"res_r": draws}))
        mp.setattr(hb, "harmonic_balance_batched", once)
        return run()


LPTV = ("diode", "tl", "inv")
PAC = {"rc": None, "mult": None, "chop": 5, "tl": None, "inv": None}
PXF = {"rc": None, "tank": None, "mult": None, "diode": 2, "tl": None}
PNOISE = ("div", "chopn", "dchop", "tl", "inv")


def cases():
    """name -> (function, args but the PSS, the deck whose PSS it takes)."""
    out = {}
    for d in LPTV:
        out[f"lptv_{d}"] = (case_lptv, (d,), d)
    for d, m in PAC.items():
        out[f"pac_{d}"] = (case_pac, (d,), d, m)
    for d, m in PXF.items():
        out[f"pxf_{d}"] = (case_pxf, (d,), d, m)
    for d in PNOISE:
        out[f"pnoise_{d}"] = (case_pnoise, (d,), d)
    out["nf"] = (case_nf, ("nf",), "nf")
    return out


CASES = cases()


def run_case(pkg, name, golden):
    fn, args, deck, *extra = CASES[name]
    return fn(pkg, *args, golden[f"pss/{deck}"], *extra)


# --------------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


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


@pytest.mark.parametrize("deck", LPTV)
def test_lptv_operator_matches_jax(deck, golden):
    got = run_case("torch", f"lptv_{deck}", golden)
    held(got, want(golden, f"lptv_{deck}"), 1e-12)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith("lptv")])
def test_pac_pxf_pnoise_and_nf_match_jax(name, golden):
    held(run_case("torch", name, golden), want(golden, name))


@pytest.mark.parametrize("deck", list(ENV))
def test_envelope_noise_matches_jax(deck, golden):
    got = case_envnoise("torch", deck, golden[f"env/{deck}"])
    held(got, want(golden, f"envnoise_{deck}"))


@pytest.mark.parametrize("deck", list(BATCHED))
def test_batched_match_jax_and_single_lanes(deck, golden):
    pss_b = golden[f"pss_b/{deck}"]
    got = case_batched("torch", deck, pss_b)
    held(got, want(golden, f"batched_{deck}"))
    held(got, case_single_lanes(deck, pss_b))


def test_pss_path_matches_jax(golden):
    ref = want(golden, "pss_path")
    got = case_pss_path("torch")
    assert np.abs(got["pss"] - ref["pss"]).max() <= 1e-9
    rel_close(got["spectrum"], ref["spectrum"])


def test_monte_carlo_entries_match_jax(golden):
    ref = want(golden, "mc")
    got = case_mc("torch", ref["res_r"])
    assert got["pac_conv"].all() and ref["pac_conv"].all()
    held(got, ref)


def test_failures_raise():
    """No quiet path: offsets <= 0, an unconverged PSS and a singular LPTV
    system raise, and without a GPU the default (card) entry raises
    instead of running on the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            mod("torch", "api").Simulator.from_text(DIV).pnoise([1e3], "out")
    s = sim_of("torch", "div")
    K, N = 9, s.engine.N
    pss = np.zeros((K, N))
    p = mod("torch", "analysis.pac")
    with pytest.raises(ValueError, match="> 0"):
        s.pnoise([0.0], "out", pss_xs=pss)
    bp = {k: v[None] for k, v in s.params.items()}
    with pytest.raises(ValueError, match="> 0"):
        p.pnoise_batched(s.engine, bp, 1e6, pss[None], [-1.0], 1)
    env = mod("torch", "analysis.envelope").EnvelopeResult(
        f0=1e6, t1=np.zeros(1), xs=pss[None], freqs=None, coeffs=None,
        converged=None, residuals=None)
    with pytest.raises(ValueError, match="> 0"):
        mod("torch", "analysis.envnoise").envelope_noise(
            s.engine, s.params, env, [0.0], 1)
    with pytest.raises(RuntimeError, match="did not converge"):
        sim_of("torch", "dchop").pnoise([1e3], "out", max_newton=0,
                                        warmup_periods=WARMUP)
    floating = sim_of("torch", "rc")
    J0, CI, _, _ = p.lptv_operator(floating.engine, floating.params, 1e6,
                                   np.zeros((K, floating.engine.N)))
    with pytest.raises(RuntimeError, match="singular"):
        p._lptv_solve(torch.zeros_like(J0)[None], CI[None], None, [1e3],
                      torch.ones((1, J0.shape[0], 1)))


def make_golden():
    """Write the JAX package's results (float64 on the CPU) into
    tests/goldens/pac_jax.npz."""
    import jax.numpy as jnp
    out = {}
    for deck in sorted({c[2] for c in CASES.values()}):
        s = sim_of("jax", deck)
        out[f"pss/{deck}"] = np.asarray(s._pss_samples(s.params, f0_of(s),
                                                       None))
    for name in CASES:
        for k, v in run_case("jax", name, out).items():
            out[f"{name}/{k}"] = np.asarray(v)
        print(name, flush=True)
    for deck, (t_stop, dt, *_rest) in ENV.items():
        s = sim_of("jax", deck)
        env = s.envelope(t_stop, dt, n_harm=6)
        assert bool(np.asarray(env.converged).all())
        out[f"env/{deck}"] = np.asarray(env.xs)
        for k, v in case_envnoise("jax", deck, out[f"env/{deck}"]).items():
            out[f"envnoise_{deck}/{k}"] = np.asarray(v)
    hb = mod("jax", "analysis.hb")
    for deck, scale in BATCHED.items():
        s = sim_of("jax", deck)
        bp = lanes("jax", s.params, 4, {k: factors(4, n, seed)
                                        for k, (n, seed) in scale.items()})
        r = hb.harmonic_balance_batched(s.engine, bp, f0_of(s),
                                        n_harm=s.config.hb.n_harm)
        assert bool(np.asarray(r.converged).all())
        out[f"pss_b/{deck}"] = np.asarray(r.xs)
        for k, v in case_batched("jax", deck, jnp.asarray(r.xs)).items():
            out[f"batched_{deck}/{k}"] = np.asarray(v)
    for k, v in case_pss_path("jax").items():
        out[f"pss_path/{k}"] = np.asarray(v)
    for k, v in case_mc("jax").items():
        out[f"mc/{k}"] = np.asarray(v)
    np.savez_compressed(GOLDEN, **out)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, REPO)
    make_golden()
